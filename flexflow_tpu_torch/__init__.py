"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu for NVIDIA
Hopper (H100).

The JAX package ``flexflow_tpu`` stays the reference; this package grows
beside it slice by slice and imports nothing of it (nor of JAX). The first
slice is serving: ``FFModel`` builds a decoder LM (``models.llama_lm``),
``compile`` initialises it on the card, and ``FFModel.serve`` runs it
through the continuous-batching ``ServingEngine`` over a paged KV cache.
Where the JAX package ran a Pallas kernel, the port runs a CUDA C++ kernel
written for ``sm_90a`` (``ops/kernels.py``, sources in ``csrc/``).

Entry points run on ``cuda``; pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels on the CPU.
"""

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import ActiMode, AggrMode, DataType, OperatorType
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.tensor import Tensor

__all__ = ["ActiMode", "AggrMode", "DataType", "FFConfig", "FFModel",
           "OperatorType", "Tensor"]
