"""Ring attention and Ulysses attention: sequence parallelism over one mesh
axis (the JAX package's ``parallel/ring_attention.py``).

Each rank holds one shard of the sequence: q, k, v (B, S/P, H, D), kv
heads already broadcast to the query heads. Both functions run on those
local tensors, with the axis's process group (``parallel.MeshAxis``)
where the JAX functions run inside ``shard_map`` with an axis name.

  * ``ring_attention``: k / v shards rotate around the axis
    (``parallel.ppermute``) while each rank's q shard attends every
    visiting shard. Without attention dropout it is
    ``ring_attention_flash``: per ring step kernel 1 with its lse on the
    local q against the visiting k / v (causal on the rank's own shard,
    full on past shards, no launch on future ones), the partials merged by
    their lse; the backward runs kernel 2 a step against the GLOBAL lse
    with a precomputed delta, its dk / dv buffers counter-rotating home.
    On the card a shape the kernels refuse raises there. Only under
    attention dropout, or with the config's ``use_flash_attention`` off,
    does the online-softmax recurrence run in torch ops, its gradient
    through autograd.
  * ``ulysses_attention``: an all-to-all swaps the sequence shard for a
    head shard (``parallel.all_to_all``), attention runs over the whole
    sequence on H/P heads — kernel 1 and kernel 2 through
    ``kernels.flash_attention`` where they apply, else the blockwise scan
    — and a second all-to-all swaps back.

``blockwise_attention`` and the accumulation step ``_block_attend`` live
in ``ops/attention.py`` (the dense path's long-sequence route) and are
imported here, one copy of each.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.attention import (NEG_INF, _GOLDEN,
                                              _block_attend, _i64,
                                              blockwise_attention)
from flexflow_tpu_torch.parallel import (MeshAxis, all_to_all, permute,
                                         ppermute)


def _merge_blocks(o, lse, o_s, lse_s):
    """Two normalised attention partials (B, Sq, H, D) f32 combined by
    their (B, H, Sq) logsumexps (the JAX ``_merge_blocks``). A partial
    that attended nothing carries lse NEG_INF, whose weight underflows to
    exactly 0."""
    new = torch.logaddexp(lse, lse_s)
    return (o * torch.exp(lse - new).transpose(1, 2)[..., None]
            + o_s * torch.exp(lse_s - new).transpose(1, 2)[..., None]), new


def _ring_perm(size: int):
    """Each index sends to the one before it: after step s a rank holds
    the k / v shard of index (its own + s) mod size."""
    return [(i, (i - 1) % size) for i in range(size)]


def _step_kind(causal: bool, step: int, src: int, me: int) -> str:
    """What ring step ``step`` computes on the rank at index ``me`` whose
    visiting shard came from ``src``: "causal" (its own shard), "full" (a
    shard of earlier positions, or any shard without a mask) or "skip" (a
    causal ring's shard of later positions: all masked, no launch)."""
    if not causal:
        return "full"
    if step == 0:
        return "causal"
    return "skip" if src > me else "full"


class _RingFlash(torch.autograd.Function):
    """The custom VJP of the JAX ``ring_attention_flash``
    (ring_attention.py:97-222). Only q, k, v, the output and the lse are
    kept for the backward (O(S/P) a rank)."""

    @staticmethod
    def forward(ctx, q, k, v, axis: MeshAxis, causal: bool, scale: float):
        p_size, me = axis.size, axis.index
        b, sq, h, d = q.shape
        o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                         device=q.device)
        perm = _ring_perm(p_size)
        k_cur, v_cur = k, v
        for step in range(p_size):
            kind = _step_kind(causal, step, (me + step) % p_size, me)
            if kind != "skip":
                o_s, lse_s = kernels.flash_attention_fwd(
                    q, k_cur, v_cur, kind == "causal", scale, need_lse=True)
                o, lse = _merge_blocks(o, lse, o_s.float(), lse_s)
            if step < p_size - 1:
                k_cur, v_cur = permute((k_cur, v_cur), axis, perm)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (axis, causal, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        axis, causal, scale = ctx.args
        p_size, me = axis.size, axis.index
        do = do.contiguous().to(q.dtype)
        # loop-invariant: rowsum(dO * O) of the final output, (B, H, Sq)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        f32 = dict(dtype=torch.float32, device=q.device)
        dq = torch.zeros(q.shape, **f32)
        dk_buf = torch.zeros(k.shape, **f32)
        dv_buf = torch.zeros(v.shape, **f32)
        perm = _ring_perm(p_size)
        k_cur, v_cur = k, v
        for step in range(p_size):
            kind = _step_kind(causal, step, (me + step) % p_size, me)
            if kind != "skip":
                dq_s, dk_s, dv_s = kernels.flash_attention_bwd(
                    q, k_cur, v_cur, o, lse, do, kind == "causal", scale,
                    delta=delta)
                dq += dq_s.float()
                dk_buf += dk_s.float()
                dv_buf += dv_s.float()
            # dk / dv travel with the shard they belong to and are home
            # after size rotations; k / v need one fewer
            if step < p_size - 1:
                k_cur, v_cur, dk_buf, dv_buf = permute(
                    (k_cur, v_cur, dk_buf, dv_buf), axis, perm)
            else:
                dk_buf, dv_buf = permute((dk_buf, dv_buf), axis, perm)
        return (dq.to(q.dtype), dk_buf.to(k.dtype), dv_buf.to(v.dtype),
                None, None, None)


def ring_attention_flash(q, k, v, axis: MeshAxis, causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention with kernels 1 and 2 as each step's block compute
    (the JAX ``ring_attention_flash``); q / k / v (B, S/P, H, D) on this
    rank, kv heads equal to heads."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            axis, causal, s)


def ring_attention(q, k, v, axis: MeshAxis, causal: bool = False,
                   scale: Optional[float] = None, dropout_rate: float = 0.0,
                   seed: Optional[torch.Tensor] = None,
                   use_flash: Optional[bool] = None) -> torch.Tensor:
    """Ring self-attention over ``axis`` on this rank's sequence shard
    (the JAX ``ring_attention``). ``use_flash`` None: the kernels
    (``ring_attention_flash``) unless ``dropout_rate`` is set; False: the
    torch-op ring.
    Attention dropout (``dropout_rate`` with a 0-dim int64 ``seed``,
    drawn from the rank's shard generator) masks each ring step's block
    with ``hashed_keep_mask`` of the seed folded with the step."""
    if use_flash and dropout_rate > 0.0:
        raise ValueError(
            "use_flash=True is incompatible with attention dropout (the "
            "flash kernels have no dropout path); drop the flag to use the "
            "torch-op ring")
    if use_flash is None:
        # the JAX rule without its TPU and environment clauses: the kernels
        # unless dropout; a shape they refuse raises in their wrappers
        use_flash = dropout_rate == 0.0
    if use_flash:
        return ring_attention_flash(q, k, v, axis, causal, scale)
    p_size, me = axis.size, axis.index
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    o = torch.zeros((b, sq, h, v.shape[-1]), dtype=torch.float32, device=dev)
    q_pos = me * sq + torch.arange(sq, device=dev)
    perm = _ring_perm(p_size)
    k_cur, v_cur = k, v
    for step in range(p_size):
        src = (me + step) % p_size
        mask = None
        if causal:
            k_pos = src * sk + torch.arange(sk, device=dev)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        step_seed = None
        if seed is not None and dropout_rate > 0.0:
            step_seed = seed + _i64((step + 1) * _GOLDEN)
        m, l, o = _block_attend(q, k_cur, v_cur, m, l, o, scale, mask,
                                dropout_rate, step_seed)
        if step < p_size - 1:
            k_cur, v_cur = ppermute((k_cur, v_cur), axis, perm)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, axis: MeshAxis, causal: bool = False,
                      scale: Optional[float] = None,
                      dropout_rate: float = 0.0,
                      seed: Optional[torch.Tensor] = None,
                      use_flash: Optional[bool] = None) -> torch.Tensor:
    """Ulysses sequence parallelism over ``axis`` (the JAX
    ``ulysses_attention``): seq -> heads all-to-all, attention over the
    whole sequence on H/P heads, heads -> seq. Needs heads divisible by
    the axis size. The local attention is ``kernels.flash_attention``
    where the kernels apply (``use_flash`` None), else the blockwise scan
    (512-key blocks), which carries attention dropout."""
    p_size = axis.size
    h = q.shape[2]
    if h % p_size:
        raise ValueError(f"heads {h} not divisible by seq-parallel {p_size}")
    qf, kf, vf = (all_to_all(t, axis, 2, 1) for t in (q, k, v))
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if use_flash and dropout_rate > 0.0:
        raise ValueError("use_flash=True is incompatible with attention "
                         "dropout")
    if use_flash is None:
        use_flash = dropout_rate == 0.0 and kernels.flash_attention_takes(
            qf, kf, vf, causal)
    if use_flash:
        out = kernels.flash_attention(qf.contiguous(), kf.contiguous(),
                                      vf.contiguous(), causal, scale)
    else:
        out = blockwise_attention(qf, kf, vf, causal, scale, 512,
                                  dropout_rate, seed)
    return all_to_all(out, axis, 1, 2)
