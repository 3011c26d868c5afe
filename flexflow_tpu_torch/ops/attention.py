"""MultiHeadAttention, the serving half (the JAX package's
``ops/attention.py``).

Layouts are the JAX package's: weights ``wq`` (D, H, Hd), ``wk``/``wv``
(D, KVH, Hd), ``wo`` (H, Hd, D); activations (B, S, H, Hd); the paged pool
(pages, page_size, KVH, Hd). The three places where the JAX package runs a
Pallas kernel on the serving path call the wrappers of ``ops/kernels.py``:

  * ``prefill_forward`` -> ``flash_attention_fwd`` (the dense prompt pass),
  * ``paged_prefill_write`` -> ``paged_prefill_write`` (prompt k/v into
    the pool),
  * ``_paged_attention_ctx`` -> ``paged_attention_fwd`` (decode).

The pool is updated in place (the JAX package returned new arrays).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.base import Op, WeightSpec


def rope_tables(theta: float, s: int, d: int,
                offset: Union[int, torch.Tensor], device: torch.device):
    """cos/sin of the rotary angles, (1 or B, S, 1, d/2) f32, from absolute
    positions ``offset + arange(S)``: a python int offsets every row, a
    (B,) tensor gives per-row offsets."""
    half = d // 2
    f32 = dict(dtype=torch.float32, device=device)
    freqs = theta ** (-torch.arange(0, half, **f32) / half)
    pos = torch.arange(s, **f32)
    if isinstance(offset, torch.Tensor):
        pos = offset.to(torch.float32)[..., None] + pos    # (B, S)
    else:
        pos = pos + float(offset)                          # (S,)
    ang = pos[..., None] * freqs                           # (..., S, half)
    if ang.dim() == 2:
        ang = ang[None]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _apply_rope(x: torch.Tensor, theta: float,
                offset: Union[int, torch.Tensor] = 0,
                tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """Rotary position embedding (rotate-half) on (B, S, H, Hd). Angles
    from absolute positions and the rotation itself are computed in f32
    whatever the compute dtype. ``offset`` shifts the positions: a python
    int applies to every row, a (B,) tensor gives per-row offsets.
    ``tables``: the ``rope_tables`` of these positions, where the caller
    already holds them."""
    half = x.shape[-1] // 2
    if tables is None:
        tables = rope_tables(theta, x.shape[1], x.shape[-1], offset,
                             x.device)
    cos, sin = tables
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def paged_slot(page_table: torch.Tensor, write_pos: torch.Tensor,
               page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pool row each slot's decode token is written to: (page id,
    row in page), both (B,) int64, from the (B, pages_per_slot) page table
    and the (B,) write positions."""
    wp = write_pos.long()
    page_ids = torch.gather(page_table.long(), 1,
                            (wp // page_size)[:, None])[:, 0]
    return page_ids, wp % page_size


def _head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) x (D, H, Hd) -> (B, S, H, Hd): one matrix product (the
    einsum "bsd,dhk->bshk")."""
    y = torch.matmul(x, w.reshape(w.shape[0], -1))
    return y.view(*x.shape[:-1], w.shape[1], w.shape[2])


class MultiHeadAttention(Op):
    op_type = OperatorType.OP_MULTIHEAD_ATTENTION

    def __init__(self, model, name, inputs, embed_dim: int, num_heads: int,
                 kdim: int = 0, vdim: int = 0, dropout: float = 0.0,
                 bias: bool = True, add_bias_kv: bool = False,
                 add_zero_attn: bool = False, causal: bool = False,
                 num_kv_heads: int = 0, rope: bool = False,
                 rope_theta: float = 10000.0):
        super().__init__(model, name, inputs)
        if add_bias_kv or add_zero_attn:
            raise NotImplementedError(
                "add_bias_kv/add_zero_attn are not supported (the JAX "
                "package lacks them too)")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {num_heads} must be a multiple of "
                             f"num_kv_heads {self.num_kv_heads}")
        self.rope = rope
        self.rope_theta = rope_theta
        self.kdim = kdim if kdim > 0 else embed_dim
        self.vdim = vdim if vdim > 0 else embed_dim
        # attention dropout is the identity at inference, the only mode
        # this slice runs
        self.dropout = dropout
        self.bias = bias
        self.causal = causal
        if embed_dim % num_heads or self.kdim % num_heads \
                or self.vdim % num_heads:
            raise ValueError(f"{name}: embed/k/v dims must divide by the "
                             f"head count {num_heads}")
        self.qk_head_dim = self.kdim // num_heads
        self.v_head_dim = self.vdim // num_heads
        if rope and self.qk_head_dim % 2:
            raise ValueError(f"{name}: RoPE needs an even head dim")
        self.q_in = inputs[0].dims[-1]
        self.k_in = inputs[1].dims[-1]
        self.v_in = inputs[2].dims[-1]
        self.scale = 1.0 / math.sqrt(self.qk_head_dim)
        self.finalize()

    def output_shapes(self):
        q = self.inputs[0].dims
        return [tuple(q[:-1]) + (self.embed_dim,)], [self.inputs[0].dtype]

    def weights(self) -> List[WeightSpec]:
        kvh, h = self.num_kv_heads, self.num_heads
        ws = [
            WeightSpec("wq", (self.q_in, h, self.qk_head_dim),
                       fan=(self.q_in, self.kdim)),
            WeightSpec("wk", (self.k_in, kvh, self.qk_head_dim),
                       fan=(self.k_in, kvh * self.qk_head_dim)),
            WeightSpec("wv", (self.v_in, kvh, self.v_head_dim),
                       fan=(self.v_in, kvh * self.v_head_dim)),
            WeightSpec("wo", (h, self.v_head_dim, self.embed_dim),
                       fan=(self.vdim, self.embed_dim)),
        ]
        if self.bias:
            ws += [WeightSpec("bias_q", (h, self.qk_head_dim), init="zero"),
                   WeightSpec("bias_k", (kvh, self.qk_head_dim), init="zero"),
                   WeightSpec("bias_v", (kvh, self.v_head_dim), init="zero"),
                   WeightSpec("bias_o", (self.embed_dim,), init="zero")]
        return ws

    def _project_qkv(self, params, q, k, v, rope_offset=0, rope=None):
        """(B, S, D) x (D, H, Hd) -> (B, S, H, Hd) for q and (B, S, KVH, Hd)
        for k/v, bias and RoPE applied; k/v stay un-broadcast (the cache
        layout). ``rope``: the ``rope_tables`` of these positions, where
        the caller holds them (a graph walk derives them once for all its
        layers)."""
        qh = _head_proj(q, params["wq"])
        kh = _head_proj(k, params["wk"])
        vh = _head_proj(v, params["wv"])
        if self.bias:
            qh = qh + params["bias_q"]
            kh = kh + params["bias_k"]
            vh = vh + params["bias_v"]
        if self.rope:
            if rope is None:
                rope = rope_tables(self.rope_theta, qh.shape[1],
                                   self.qk_head_dim, rope_offset, qh.device)
            qh = _apply_rope(qh, self.rope_theta, tables=rope)
            kh = _apply_rope(kh, self.rope_theta, tables=rope)
        return qh, kh, vh

    def _out_proj(self, params, ctx):
        """(B, S, H, Hd) x (H, Hd, D) -> (B, S, D) (the einsum
        "bqhk,hkd->bqd")."""
        wo = params["wo"]
        out = torch.matmul(ctx.reshape(*ctx.shape[:2], -1),
                           wo.reshape(-1, wo.shape[-1]))
        if self.bias:
            out = out + params["bias_o"]
        return out

    # ---- contiguous per-request cache (prefill) ---------------------------

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                   device: torch.device):
        return {
            "k": torch.zeros((batch, max_len, self.num_kv_heads,
                              self.qk_head_dim), dtype=dtype, device=device),
            "v": torch.zeros((batch, max_len, self.num_kv_heads,
                              self.v_head_dim), dtype=dtype, device=device),
        }

    def prefill_forward(self, params, xs, cache, rope=None):
        """Whole-prompt forward that also fills ``cache[:, :S]`` (in
        place). The prompt attends itself through the flash kernel; grouped
        kv heads go to the kernel un-broadcast. ``rope``: the
        ``rope_tables`` of positions 0..S-1, if the caller holds them."""
        qh, kh, vh = self._project_qkv(params, xs[0], xs[1], xs[2],
                                       rope=rope)
        s = qh.shape[1]
        cache["k"][:, :s] = kh
        cache["v"][:, :s] = vh
        ctx = kernels.flash_attention_fwd(
            qh.contiguous(), kh.contiguous(), vh.contiguous(), self.causal,
            self.scale)
        return self._out_proj(params, ctx), cache

    # ---- paged KV pool (runtime/serving.py) --------------------------------

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype: torch.dtype, device: torch.device):
        """A pool of ``num_pages`` KV pages in the compute dtype (native
        storage only in this slice). Page 0 is the serving engine's
        scratch page."""
        return {
            "k": torch.zeros((num_pages, page_size, self.num_kv_heads,
                              self.qk_head_dim), dtype=dtype, device=device),
            "v": torch.zeros((num_pages, page_size, self.num_kv_heads,
                              self.v_head_dim), dtype=dtype, device=device),
        }

    def paged_prefill_write(self, cache, kh, vh, pages):
        """Scatter a slot's contiguous prefill k/v (1, L, KVH, Hd) into pool
        pages ``pages`` ((ceil(L / page_size),) int32), in place; the last
        page's tail past L is zeroed."""
        kernels.paged_prefill_write(cache["k"], cache["v"], kh, vh, pages)
        return cache

    def _paged_append(self, cache, kh, vh, page_ids, offs):
        """Write one token per slot at ``(page_ids[b], offs[b])``, in place
        (the native-pool branch of the JAX ``_paged_append``)."""
        cache["k"][page_ids, offs] = kh.to(cache["k"].dtype)
        cache["v"][page_ids, offs] = vh.to(cache["v"].dtype)
        return cache

    def _paged_attention_ctx(self, qh, cache, page_table, write_pos,
                             row_len, prompt_pad):
        """q (B, S, H, Hd) against the pool through the per-slot page
        tables; write_pos (B, S) per-position frontiers."""
        return kernels.paged_attention_fwd(
            qh.contiguous(), cache["k"], cache["v"], page_table, write_pos,
            row_len, prompt_pad, self.scale)

    def paged_decode_forward(self, params, xs, cache, page_table, write_pos,
                             rope_pos, row_len, prompt_pad, rope=None,
                             slot=None):
        """One continuous-batching decode step over the paged pool. xs[0]
        is (B_slots, 1, D); per-slot (B,) int32 ``write_pos`` (the logical
        cache position of this token), ``rope_pos`` (its logical sequence
        position), ``row_len`` (true prompt length) and ``prompt_pad``
        (bucket width). Live rule: j < row_len or prompt_pad <= j <=
        write_pos. Every layer of one step rotates the same positions and
        writes the same pool rows, so a graph walk passes them in, derived
        once: ``rope`` (``rope_tables`` at ``rope_pos``) and ``slot``
        (``paged_slot``)."""
        qh, kh, vh = self._project_qkv(params, xs[0], xs[1], xs[2],
                                       rope_offset=rope_pos, rope=rope)
        if slot is None:
            slot = paged_slot(page_table, write_pos, cache["k"].shape[1])
        cache = self._paged_append(cache, kh[:, 0], vh[:, 0], *slot)
        ctx = self._paged_attention_ctx(qh, cache, page_table,
                                        write_pos[:, None], row_len,
                                        prompt_pad)
        return self._out_proj(params, ctx), cache
