"""The port's entry point (the counterpart of the JAX package's
``__graft_entry__.py entry``).

entry() -> (fn, example_args): the flagship encoder classifier's forward
at the JAX entry's sizes (batch 8, seq 64, hidden 256, 2 layers, 4 heads,
16 classes), compiled for training with SGD as the JAX one is;
``fn(*example_args)`` returns the logits. It runs on the card unless
``device="cpu"`` is passed.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import LossType, MetricsType
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.models.transformer import build_encoder_classifier
from flexflow_tpu_torch.runtime.optimizer import SGDOptimizer

BATCH, SEQ, HIDDEN, LAYERS, HEADS = 8, 64, 256, 2, 4


def entry(device: Optional[Union[str, torch.device]] = None):
    """Forward fn + example args on the flagship transformer:
    ``fn(params, batch)`` with params ``{op: {weight: tensor}}`` and batch
    ``{"input": (8, 64, 256) f32}`` -> (8, 16) logits."""
    ff = FFModel(FFConfig(batch_size=BATCH), device=device)
    _, out = build_encoder_classifier(ff, BATCH, SEQ, HIDDEN, LAYERS, HEADS,
                                      num_classes=16)
    ff.compile(SGDOptimizer(lr=0.01),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY], final_tensor=out)

    def fn(params, batch_data):
        return ff.executor.forward(params, batch_data, [out])[0]

    example_args = (ff.params, {"input": torch.zeros(
        (BATCH, SEQ, HIDDEN), dtype=torch.float32, device=ff.device)})
    return fn, example_args
