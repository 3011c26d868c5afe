"""Softmax, Dropout, LayerNorm, AddLayerNorm and RMSNorm (the JAX
package's ``ops/norm.py``).

``AddLayerNorm`` runs the ``fused_add_layernorm`` kernel (ops/kernels.py)
on the card, where the JAX package ran its Pallas kernel on the TPU.
Softmax and Dropout are torch calls, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.base import Op, WeightSpec


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Keep each element with probability ``1 - rate`` and scale it by
    ``1 / keep``, else 0 (the JAX ``jnp.where(bernoulli(rng, keep, shape),
    x / keep, 0)``): the mask is ``uniform < keep`` drawn from ``gen`` on
    ``x``'s device, and a kept value is exactly ``x / keep`` with keep in
    ``x``'s dtype, an IEEE division as in JAX (a python divisor would let
    the CUDA path multiply by the reciprocal). The identity at rate 0 or
    without a generator."""
    if rate <= 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / torch.full((), keep, dtype=x.dtype,
                                            device=x.device), 0.0)


class Softmax(Op):
    op_type = OperatorType.OP_SOFTMAX

    def __init__(self, model, name, inputs, axis: int = -1):
        super().__init__(model, name, inputs)
        self.axis = axis
        self.finalize()

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        return [torch.softmax(xs[0], dim=self.axis)]


class Dropout(Op):
    """The identity at inference and at rate 0; in training ``dropout``
    with the generator the executor derives for this op."""

    op_type = OperatorType.OP_DROPOUT

    def __init__(self, model, name, inputs, rate: float, seed: int = 0):
        super().__init__(model, name, inputs)
        self.rate = rate
        self.needs_rng = rate > 0
        self.seed = seed
        self.finalize()

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False, gen=None):
        if not training:
            return [xs[0]]
        return [dropout(xs[0], self.rate, gen)]


class LayerNorm(Op):
    op_type = OperatorType.OP_LAYERNORM

    def __init__(self, model, name, inputs, eps: float = 1e-5,
                 elementwise_affine: bool = True):
        super().__init__(model, name, inputs)
        self.eps = eps
        self.affine = elementwise_affine
        self.dim = inputs[0].dims[-1]
        self.finalize()

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def weights(self):
        if not self.affine:
            return []
        return [WeightSpec("scale", (self.dim,), init="one"),
                WeightSpec("bias", (self.dim,), init="zero")]

    def forward(self, params, xs, *, training=False):
        # the JAX formula, statistics in the input's dtype
        x = xs[0]
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * params["scale"] + params["bias"]
        return [y]


class AddLayerNorm(Op):
    """Fused residual add + LayerNorm: (s, y) = (x + r, LN(x + r)), two
    outputs. Rows the kernel takes (``kernels.fused_add_layernorm_takes``)
    go through the ``fused_add_layernorm`` wrapper: on the card its kernel
    (one pass: the sum never round-trips device memory before the norm
    reads it), on the CPU its plain version. Rows it does not take (a
    width not a multiple of 8, or too wide for one block) run the JAX
    op's plain branch (norm.py:189-197) in torch ops, as the JAX op routes
    the rows its ``_fused_ok`` refuses."""

    op_type = OperatorType.OP_LAYERNORM

    def __init__(self, model, name, inputs, eps: float = 1e-5):
        super().__init__(model, name, inputs)
        self.eps = eps
        self.dim = inputs[0].dims[-1]
        if inputs[0].dims != inputs[1].dims:
            raise ValueError(f"{name}: add_layer_norm inputs must agree, got "
                             f"{inputs[0].dims} vs {inputs[1].dims}")
        self.finalize()

    def output_shapes(self):
        d = self.inputs[0].dims
        t = self.inputs[0].dtype
        return [d, d], [t, t]

    def weights(self):
        return [WeightSpec("scale", (self.dim,), init="one"),
                WeightSpec("bias", (self.dim,), init="zero")]

    def forward(self, params, xs, *, training=False):
        x, r = xs[0], xs[1]
        scale, bias = params["scale"], params["bias"]
        x2 = x.reshape(-1, self.dim).contiguous()
        r2 = r.reshape(-1, self.dim).contiguous()
        if kernels.fused_add_layernorm_takes(x2, r2, scale, bias):
            s2, y2 = kernels.fused_add_layernorm(x2, r2, scale, bias,
                                                 self.eps)
            return [s2.reshape(x.shape), y2.reshape(x.shape)]
        # the JAX plain branch: the sum in the input dtype, f32 statistics
        s = x + r
        sf = s.float()
        mean = sf.mean(dim=-1, keepdim=True)
        var = sf.var(dim=-1, keepdim=True, correction=0)
        y = ((sf - mean) * torch.rsqrt(var + self.eps) * scale.float()
             + bias.float())
        return [s, y.to(s.dtype)]


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

    def forward(self, params, xs, *, training=False):
        # the JAX formula: mean(square(x)) in the compute dtype (a bf16
        # input keeps a bf16 mean, accumulated in f32 by both frameworks)
        x = xs[0]
        ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return [x * torch.rsqrt(ms + self.eps) * params["scale"]]
