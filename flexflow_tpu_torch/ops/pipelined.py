"""The pipelined transformer layer stack (the JAX package's
``ops/pipelined.py``).

All L identical pre-LN blocks live in one op whose weights carry a leading
layer dim: ``wq`` (L, D, D), ``w1`` (L, D, F), ``ln1_scale`` (L, D), ...
Without a stage axis the JAX op scans the blocks over the stacked weights;
the port loops over them, taking each layer's views with one ``unbind`` a
weight a forward, so every layer's gradient lands in the one stacked leaf
(which the optimizers treat as any other leaf).

Under a mesh, as in JAX:

  * a STAGE axis in the op's axis map (any mesh axis name; else a mesh
    axis named "pipe") of S devices that divides L: every stacked weight
    is split on its layer dim over it (``weight_partition``), each rank
    holds its stage's L / S layers, and the forward runs GPipe over the
    axis (``parallel.pipeline.gpipe``) on ``num_microbatches``
    microbatches of the rank's rows — the batch also split over the axis
    map's batch axis, when it has one (dp x pp);
  * a sharded sequence dim: the blocks run on the rank's positions, and
    each block's attention gathers the sequence around itself (JAX lowers
    it by GSPMD's all-gather there), attends on the rank's batch rows, and
    hands back the rank's positions.

A block's attention takes the flash autograd Function
(``kernels.flash_attention``) under the MultiHeadAttention op's rule: the
shapes the kernels take (``kernels.flash_attention_takes``), unless
``FFConfig.use_flash_attention`` is off; otherwise the JAX block's einsum
route, causal masking with -1e30 below the diagonal. The block's
LayerNorms are its own unfused ones, as in the JAX package.
"""

from __future__ import annotations

import math
import logging
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import DataType, OperatorType
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.base import Op, WeightSpec
from flexflow_tpu_torch.parallel import (is_dtensor, keep_shards,
                                         local_shard, mesh_shape_dict,
                                         note_local_call, rows_matmul)
from flexflow_tpu_torch.parallel.pconfig import STAGE

log = logging.getLogger(__name__)


def _layer_norm(h, scale, bias, eps: float = 1e-5):
    """The JAX ``_layer_norm``: population variance, ``rsqrt``."""
    mu = h.mean(dim=-1, keepdim=True)
    var = h.var(dim=-1, keepdim=True, correction=0)
    return (h - mu) * torch.rsqrt(var + eps) * scale + bias


def _attend(q, k, v, causal: bool, use_flash: bool) -> torch.Tensor:
    """A block's attention on plain (B, S, H, hd) q / k / v."""
    hd = q.shape[-1]
    if use_flash and kernels.flash_attention_takes(q, k, v, causal):
        return kernels.flash_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal,
                                       1.0 / math.sqrt(hd))
    S = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(mask, logits, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)


def _block(p: Dict[str, torch.Tensor], h: torch.Tensor, num_heads: int,
           causal: bool, use_flash: bool = True) -> torch.Tensor:
    """Pre-LN transformer block: MHA + residual, FFN (tanh GELU) +
    residual. On a DTensor ``h`` the attention runs on each rank's batch
    rows over the whole sequence (``parallel.local_shard``), ``h``'s
    layout restored after it."""
    B, S, D = h.shape
    hd = D // num_heads
    a = _layer_norm(h, p["ln1_scale"], p["ln1_bias"])
    q, k, v = ((rows_matmul(a, p[w]) + p[b]).reshape(B, S, num_heads, hd)
               for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    if is_dtensor(q):
        pl = keep_shards(q.placements, (0,))
        ctx = local_shard(lambda *t: _attend(*t, causal, use_flash),
                          (q, k, v), (pl, pl, pl), "flash_attention")
        ctx = ctx.reshape(B, S, D)
        if list(ctx.placements) != list(h.placements):
            ctx = ctx.redistribute(h.device_mesh, h.placements)
    else:
        ctx = _attend(q, k, v, causal, use_flash).reshape(B, S, D)
    h = h + rows_matmul(ctx, p["wo"]) + p["bo"]
    f = _layer_norm(h, p["ln2_scale"], p["ln2_bias"])
    f = F.gelu(rows_matmul(f, p["w1"]) + p["b1"], approximate="tanh")
    return h + rows_matmul(f, p["w2"]) + p["b2"]


def _layers(params: Dict[str, torch.Tensor], h: torch.Tensor,
            num_heads: int, causal: bool, use_flash: bool) -> torch.Tensor:
    """The blocks of stacked ``params`` (n, ...) applied in order."""
    layers = {k: v.unbind(0) for k, v in params.items()}
    for i in range(next(iter(params.values())).shape[0]):
        h = _block({k: v[i] for k, v in layers.items()}, h, num_heads,
                   causal, use_flash)
    return h


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
        # the GPipe path's microbatch count (default: the stages)
        self.num_microbatches = num_microbatches
        self._warned_stages = False
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
        x = xs[0]
        if is_dtensor(x):
            am = self.model.executor.op_axis_map(self)
            axis, stages = self._stage_axis(am, mesh_shape_dict(
                x.device_mesh))
            if stages > 1:
                return [self._pipelined(params, x, am, axis, use_flash)]
        return [_layers(params, x, self.num_heads, self.causal, use_flash)]

    def _stage_axis(self, axis_map, mesh_shape) -> Tuple[Optional[str], int]:
        """(axis, stages) the stack pipelines over (the JAX
        ``_stage_axis``, pipelined.py:122): a STAGE assignment in the axis
        map, else a mesh axis named "pipe"; (None, 1) runs serially, as
        does an axis whose size does not divide the layers (warned
        once)."""
        ax = next((a for a, d in (axis_map or {}).items() if d == STAGE),
                  None)
        if ax is None and mesh_shape.get("pipe", 1) > 1:
            ax = "pipe"
        s = mesh_shape.get(ax, 1) if ax is not None else 1
        if s > 1 and self.num_layers % s:
            if not self._warned_stages:
                self._warned_stages = True
                log.warning(
                    "%s: num_layers=%d not divisible by stage axis %r size "
                    "%d — pipeline parallelism DISABLED, running serial on "
                    "replicated weights (the %d devices stay idle)",
                    self.name, self.num_layers, ax, s, s)
            return None, 1
        return (ax, s) if s > 1 else (None, 1)

    def _pipelined(self, params, x, axis_map, axis: str, use_flash: bool):
        """GPipe over ``axis`` (the JAX forward's pipe branch,
        pipelined.py:204-230): the rank's layers (its shards of the
        stacked weights) as one stage, ``num_microbatches`` (default: the
        stages) microbatches of the rank's rows, which stay split over the
        axis map's batch axis where it has one and is not the stage
        axis."""
        from torch.distributed.tensor import Replicate, Shard

        from flexflow_tpu_torch.parallel.pipeline import gpipe_sharded

        mesh = x.device_mesh
        sizes = mesh_shape_dict(mesh)
        data = next((a for a, d in axis_map.items()
                     if d == 0 and a != axis and sizes.get(a, 1) > 1), None)
        if data is not None and x.shape[0] % sizes[data]:
            data = None
        want = [Shard(0) if n == data else Replicate()
                for n in mesh.mesh_dim_names]
        if list(x.placements) != want:
            x = x.redistribute(mesh, want)
        out = gpipe_sharded(
            lambda p, h: _layers(p, h, self.num_heads, self.causal,
                                 use_flash),
            params, x, axis, self.num_microbatches or sizes[axis])
        note_local_call("gpipe")
        return out

    def pipeline_stages(self) -> int:
        return self.num_layers

    def weight_partition(self, axis_map):
        """A STAGE axis (else a mesh axis named 'pipe' that divides the
        layers) shards every stacked weight's layer dim (the JAX hook,
        pipelined.py:156): each stage holds its layers' weights."""
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
