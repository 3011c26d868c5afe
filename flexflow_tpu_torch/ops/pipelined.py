"""The pipelined transformer layer stack (the JAX package's
``ops/pipelined.py``), its serial path.

All L identical pre-LN blocks live in one op whose weights carry a leading
layer dim: ``wq`` (L, D, D), ``w1`` (L, D, F), ``ln1_scale`` (L, D), ...
Without a pipe axis the JAX op scans the blocks over the stacked weights;
the port loops over them, taking each layer's views with one ``unbind`` a
weight a forward, so every layer's gradient lands in the one stacked leaf
(which the optimizers treat as any other leaf). The GPipe path under a
'pipe' mesh axis needs a mesh, which the port does not have yet (ROADMAP
queue 1, item 9).

A block's attention takes the flash autograd Function
(``kernels.flash_attention``) under the MultiHeadAttention op's rule: the
shapes the kernels take (``kernels.flash_attention_takes``), unless
``FFConfig.use_flash_attention`` is off; otherwise the JAX block's einsum
route, causal masking with -1e30 below the diagonal. The block's
LayerNorms are its own unfused ones, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import DataType, OperatorType
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.base import Op, WeightSpec


def _layer_norm(h, scale, bias, eps: float = 1e-5):
    """The JAX ``_layer_norm``: population variance, ``rsqrt``."""
    mu = h.mean(dim=-1, keepdim=True)
    var = h.var(dim=-1, keepdim=True, correction=0)
    return (h - mu) * torch.rsqrt(var + eps) * scale + bias


def _block(p: Dict[str, torch.Tensor], h: torch.Tensor, num_heads: int,
           causal: bool, use_flash: bool = True) -> torch.Tensor:
    """Pre-LN transformer block: MHA + residual, FFN (tanh GELU) +
    residual."""
    B, S, D = h.shape
    hd = D // num_heads
    a = _layer_norm(h, p["ln1_scale"], p["ln1_bias"])
    q, k, v = ((a @ p[w] + p[b]).reshape(B, S, num_heads, hd)
               for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    if use_flash and kernels.flash_attention_takes(q, k, v, causal):
        ctx = kernels.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal,
                                      1.0 / math.sqrt(hd))
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if causal:
            mask = torch.ones((S, S), dtype=torch.bool,
                              device=h.device).tril()
            logits = torch.where(mask, logits, -1e30)
        ctx = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1),
                           v)
    h = h + ctx.reshape(B, S, D) @ p["wo"] + p["bo"]
    f = _layer_norm(h, p["ln2_scale"], p["ln2_bias"])
    f = F.gelu(f @ p["w1"] + p["b1"], approximate="tanh")
    return h + f @ p["w2"] + p["b2"]


class TransformerPipelineStack(Op):
    """L identical transformer blocks with stacked weights [L, ...]."""

    op_type = OperatorType.OP_MULTIHEAD_ATTENTION

    def __init__(self, model, name, inputs, num_layers: int, num_heads: int,
                 ffn_mult: int = 4, causal: bool = False,
                 num_microbatches: Optional[int] = None):
        super().__init__(model, name, inputs)
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_mult = ffn_mult
        self.causal = causal
        # the GPipe path's microbatch count, kept for the mesh slice
        self.num_microbatches = num_microbatches
        d = inputs[0].dims[-1]
        if d % num_heads:
            raise ValueError(f"{name}: hidden {d} % heads {num_heads}")
        self.finalize()

    def output_shapes(self):
        return [self.inputs[0].dims], [DataType.DT_FLOAT]

    def weights(self) -> List[WeightSpec]:
        L = self.num_layers
        D = self.inputs[0].dims[-1]
        F_ = D * self.ffn_mult
        specs = [WeightSpec(nm, (L, D, D), fan=(D, D))
                 for nm in ("wq", "wk", "wv", "wo")]
        specs += [WeightSpec(nm, (L, D), init="zero")
                  for nm in ("bq", "bk", "bv", "bo")]
        specs += [
            WeightSpec("w1", (L, D, F_), fan=(D, F_)),
            WeightSpec("b1", (L, F_), init="zero"),
            WeightSpec("w2", (L, F_, D), fan=(F_, D)),
            WeightSpec("b2", (L, D), init="zero"),
            WeightSpec("ln1_scale", (L, D), init="one"),
            WeightSpec("ln1_bias", (L, D), init="zero"),
            WeightSpec("ln2_scale", (L, D), init="one"),
            WeightSpec("ln2_bias", (L, D), init="zero"),
        ]
        return specs

    def forward(self, params, xs, *, training=False):
        use_flash = getattr(self.model.config, "use_flash_attention", True)
        layers = {k: v.unbind(0) for k, v in params.items()}
        h = xs[0]
        for i in range(self.num_layers):
            h = _block({k: v[i] for k, v in layers.items()}, h,
                       self.num_heads, self.causal, use_flash)
        return [h]

    def pipeline_stages(self) -> int:
        return self.num_layers

    def weight_partition(self, axis_map):
        """A STAGE axis (else a mesh axis named 'pipe' that divides the
        layers) shards every stacked weight's layer dim (the JAX hook;
        running the pipeline is item 9)."""
        from flexflow_tpu_torch.parallel.pconfig import STAGE

        ax = next((a for a, d in (axis_map or {}).items() if d == STAGE),
                  None)
        if ax is None:
            shape = self.model.mesh_shape or {}
            s = shape.get("pipe", 1)
            if s <= 1 or self.num_layers % s:
                return super().weight_partition(axis_map)
            ax = "pipe"
        return {w.name: (ax,) + (None,) * (len(w.shape) - 1)
                for w in self.weight_specs()}

    def partitionable_output_dims(self):
        return [0, 1]

    def single_axis_dims(self):
        return [1]
