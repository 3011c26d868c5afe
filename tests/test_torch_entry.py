"""``FFModel.predict`` and the port's entry point
(``flexflow_tpu_torch/entry.py``) against the JAX package's ``predict`` and
``__graft_entry__.entry()``, the JAX-initialised weights carried in; f32
on the CPU, outputs within 1e-5 (sums of products in other orders)."""

import os
import sys

import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import LossType as JLoss
from flexflow_tpu import MetricsType as JMetrics
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.models.transformer import \
    build_encoder_classifier as j_build
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import build_encoder_classifier

B, S, HIDDEN, LAYERS, HEADS, CLASSES = 4, 16, 64, 1, 4, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(params):
    return {op: {w: np.asarray(a) for w, a in ws.items()}
            for op, ws in params.items()}


def _input(seed: int):
    return np.random.RandomState(seed).randn(B, S, HIDDEN).astype(np.float32)


def test_predict_matches_jax():
    """Label-free forward of a training-compiled model, and of a
    serving-compiled one (no optimizer)."""
    jff = JModel(JConfig(batch_size=B, mesh_shape={"data": 1}, seed=1))
    _, jout = j_build(jff, B, S, HIDDEN, LAYERS, HEADS, num_classes=CLASSES)
    jff.compile(JSGD(lr=0.05), JLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                [JMetrics.METRICS_ACCURACY], final_tensor=jout)
    tff = FFModel(FFConfig(batch_size=B, seed=1), device="cpu")
    _, tout = build_encoder_classifier(tff, B, S, HIDDEN, LAYERS, HEADS,
                                       num_classes=CLASSES)
    tff.compile(SGDOptimizer(lr=0.05), final_tensor=tout)
    tff.params = params_from_jax(_np_tree(jff.params), "cpu", torch.float32,
                                 model=tff)
    x = _input(80)
    got = tff.predict({"input": x})
    assert got.shape == (B, CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jff.predict({"input": x})), **TOL)
    ff = FFModel(FFConfig(batch_size=B), device="cpu")
    _, out = build_encoder_classifier(ff, B, S, HIDDEN, LAYERS, HEADS,
                                      num_classes=CLASSES)
    with pytest.raises(RuntimeError, match="compile"):
        ff.predict({"input": x})
    ff.compile(final_tensor=out)
    assert ff.predict({"input": x}).shape == (B, CLASSES)


def test_entry_matches_the_jax_entry():
    """The port's entry() against __graft_entry__.entry() at its sizes
    (8, 64, 256, 2 layers, 4 heads), the JAX weights carried in, on a
    random input: logits within 1e-5."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__

    from flexflow_tpu_torch.entry import entry

    jfn, (jparams, jstate, jbatch) = __graft_entry__.entry()
    tfn, (tparams, tbatch) = entry(device="cpu")
    assert tbatch["input"].shape == jbatch["input"].shape
    assert {op: set(ws) for op, ws in tparams.items()} == \
        {op: set(ws) for op, ws in jparams.items()}
    x = np.random.RandomState(81).randn(*jbatch["input"].shape).astype(
        np.float32)
    want = np.asarray(jfn(jparams, jstate, {"input": x}))
    got = tfn(params_from_jax(_np_tree(jparams), "cpu", torch.float32),
              {"input": torch.from_numpy(x)})
    assert got.shape == want.shape == (8, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
