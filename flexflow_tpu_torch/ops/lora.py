"""Paged LoRA adapter pool, device side (the JAX package's
``ops/lora.py``).

Adapter weights live in a fixed-geometry device pool and the adapter a
slot applies is data: a per-slot page index gathered inside the decode
program, like the KV page table. For every LoRA-targeted Linear op the
pool holds

    a: (pages, in_dim, rank)    b: (pages, rank, out_dim)

plus one shared ``"_scale"`` array (pages,) holding each adapter's
``alpha / rank``. Page 0 is the null adapter (all zeros, scale 0): a
request with no adapter reads page 0 and its delta is exactly zero.

The pool is written in place (``write_adapter_page``) and never
reallocated: the captured decode programs hold its addresses.

The gathered LoRA product, with x (B, S, in) and per-slot pages (B,):

    delta[b] = (x[b] @ a[pages[b]]) @ b[pages[b]] * scale[pages[b]]

two thin batched products through the rank, in f32, cast to the base
dtype and added to ``x @ W`` before the bias (ops/dense.py).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def init_lora_pool(targets: List, pages: int, rank: int,
                   device) -> Dict:
    """Zero-filled adapter pool for ``targets`` (Linear ops): ``pages``
    usable pages plus the null page 0, f32."""
    pool = {
        op.name: {
            "a": torch.zeros((pages + 1, op.in_dim, rank),
                             dtype=torch.float32, device=device),
            "b": torch.zeros((pages + 1, rank, op.out_dim),
                             dtype=torch.float32, device=device),
        }
        for op in targets}
    pool["_scale"] = torch.zeros((pages + 1,), dtype=torch.float32,
                                 device=device)
    return pool


def write_adapter_page(pool: Dict, page: int, payload: Dict,
                       scale: float) -> None:
    """Write one adapter's weights into ``page`` of every target's pool
    arrays, in place. ``payload`` maps op name -> {"a", "b"} (numpy or
    tensors); every target must be present (zeros for the ops the adapter
    does not target)."""
    for name, arrs in pool.items():
        if name == "_scale":
            continue
        sub = payload[name]
        for w in ("a", "b"):
            arrs[w][page].copy_(torch.as_tensor(np.asarray(sub[w],
                                                           np.float32)))
    pool["_scale"][page] = float(np.float32(scale))


def gather_op_lora(pool: Dict, op_name: str, pages: torch.Tensor):
    """Per-slot operands of one op's gathered LoRA product: (a (B, in, r),
    b (B, r, out), scale (B,)), or None when the op is not targeted."""
    arrs = pool.get(op_name)
    if arrs is None:
        return None
    idx = pages.long()
    return (arrs["a"].index_select(0, idx), arrs["b"].index_select(0, idx),
            pool["_scale"].index_select(0, idx))


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """The per-row LoRA delta: x (B, ..., in) with a (B, in, r), b (B, r,
    out), scale (B,) -> (B, ..., out) in x's dtype; f32 through the rank.
    Each row only reads its own adapter, so mixed tenants share one
    dispatch."""
    lead = x.shape[:-1]
    xf = x.float().reshape(x.shape[0], -1, x.shape[-1])
    d = torch.bmm(torch.bmm(xf, a), b)
    d = d * scale.reshape(-1, 1, 1)
    return d.reshape(*lead, b.shape[-1]).to(x.dtype)


def zero_payload(targets: List, rank: int) -> Dict:
    """Host-side all-zero payload (numpy) for the writer."""
    return {op.name: {"a": np.zeros((op.in_dim, rank), np.float32),
                      "b": np.zeros((rank, op.out_dim), np.float32)}
            for op in targets}
