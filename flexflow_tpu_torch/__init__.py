"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu for NVIDIA
Hopper (H100).

The JAX package ``flexflow_tpu`` stays the reference; this package grows
beside it slice by slice and imports nothing of it (nor of JAX).

  * Serving: ``FFModel`` builds a decoder LM (``models.llama_lm``),
    ``compile(final_tensor=...)`` initialises it on the card, and
    ``FFModel.serve`` runs it through the continuous-batching
    ``ServingEngine`` over a paged KV cache.
  * Training: a model of ``models`` (the encoder classifier, the CNN
    zoo with BatchNorm's running state, BERT / GPT, ViT, DLRM) built on
    ``FFModel``,
    ``compile(SGDOptimizer(...) or AdamOptimizer(...), loss, metrics)``
    (lr schedules from ``runtime/schedule.py``), ``SingleDataLoader``s
    for the input and ``ff.label_tensor``, then ``fit()`` / ``evaluate`` /
    ``predict``; ``FFConfig`` selects gradient accumulation, the
    divergence guard, scanned steps (a CUDA graph replayed) and the fused
    optimizer update. ``entry.entry()`` is the flagship's forward.

Where the JAX package ran a Pallas kernel, the port runs a CUDA C++ kernel
written for ``sm_90a`` (``ops/kernels.py``, sources in ``csrc/``).

Entry points run on ``cuda``; pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels on the CPU.
"""

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import (ActiMode, AggrMode, CompMode, DataType,
                                        LossType, MetricsType, OperatorType,
                                        PoolType)
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader
from flexflow_tpu_torch.runtime.initializer import (ConstantInitializer,
                                                    GlorotUniformInitializer,
                                                    NormInitializer,
                                                    OneInitializer,
                                                    UniformInitializer,
                                                    ZeroInitializer)
from flexflow_tpu_torch.runtime.optimizer import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.runtime.schedule import (ConstantSchedule,
                                                 ExponentialDecay, StepDecay,
                                                 WarmupCosine, WarmupLinear)
from flexflow_tpu_torch.tensor import Tensor

__all__ = ["ActiMode", "AdamOptimizer", "AggrMode", "CompMode",
           "ConstantInitializer", "ConstantSchedule", "DataType",
           "ExponentialDecay", "FFConfig", "FFModel",
           "GlorotUniformInitializer", "LossType", "MetricsType",
           "NormInitializer", "OneInitializer", "OperatorType", "PoolType",
           "SGDOptimizer", "SingleDataLoader", "StepDecay", "Tensor",
           "UniformInitializer", "WarmupCosine", "WarmupLinear",
           "ZeroInitializer"]
