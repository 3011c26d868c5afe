"""RMSNorm (the JAX package's ``ops/norm.py`` RMSNorm)."""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import Op, WeightSpec


class RMSNorm(Op):
    op_type = OperatorType.OP_RMSNORM

    def __init__(self, model, name, inputs, eps: float = 1e-6):
        super().__init__(model, name, inputs)
        self.eps = eps
        self.dim = inputs[0].dims[-1]
        self.finalize()

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def weights(self):
        return [WeightSpec("scale", (self.dim,), init="one")]

    def forward(self, params, xs):
        # the JAX formula: mean(square(x)) in the compute dtype (a bf16
        # input keeps a bf16 mean, accumulated in f32 by both frameworks)
        x = xs[0]
        ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return [x * torch.rsqrt(ms + self.eps) * params["scale"]]
