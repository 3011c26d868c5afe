"""Carry weights and op state from the JAX package into the port.

The port keeps the JAX package's weight names and layouts (``Linear.kernel``
(in, out), ``wq`` (D, H, Hd), ``wo`` (H, Hd, D), the pipelined stack's
(L, ...) stacked weights, a MoE's ``w_in`` (E, D, F) and ``w_out`` (E, F,
D), a fused group's weights under its leader's name, ...), so moving a
model's ``ff.params`` across is a cast and a copy; a paged KV pool
(``k``/``v`` pages and, quantized, ``k_scale``/``v_scale``) moves bit for
bit. The JAX
arrays arrive as numpy (``np.asarray`` of each leaf) — this module imports
nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch


def params_from_jax(params: Dict[str, Dict[str, np.ndarray]],
                    device: Union[str, torch.device],
                    dtype: torch.dtype, model=None
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{op: {weight: array}} -> the same tree of ``dtype`` tensors on
    ``device``. With ``model`` (a port FFModel) the names and shapes are
    checked against its graph first: a missing, extra or misshapen weight
    raises ``ValueError``. A tied model's destination weight has no leaf in
    either package (``FFModel.tie_weights``). A ``model`` under a mesh
    gets DTensors under its weights' placements: each rank keeps its
    slice of JAX's whole arrays."""
    if model is not None:
        _check_against(params, model.weight_shapes())
    tree = {op: {w: torch.tensor(np.asarray(a), dtype=dtype, device=device)
                 for w, a in ws.items()}
            for op, ws in params.items()}
    if model is not None and getattr(model, "mesh", None) is not None:
        tree = model.executor.distribute_params(tree)
    return tree


def state_from_jax(state: Dict[str, Dict[str, np.ndarray]],
                   device: Union[str, torch.device], model=None
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX model's op state (``ff.bn_state``: BatchNorm's f32 ``mean`` /
    ``var`` per op) -> the port's, f32 on ``device``. With ``model`` the
    ops and shapes are checked against its own initial state."""
    if model is not None:
        _check_against(state, {op: {k: tuple(v.shape) for k, v in ws.items()}
                                for op, ws in model.bn_state.items()})
    return {op: {k: torch.tensor(np.asarray(a), dtype=torch.float32,
                                 device=device)
                 for k, a in ws.items()}
            for op, ws in state.items()}


#: numpy dtypes of the JAX package that torch cannot take directly (they
#: come from ml_dtypes), by name -> (same-width integer view, torch dtype)
_BIT_VIEWS = {"float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
              "bfloat16": (np.int16, torch.bfloat16)}


def _tensor_from_np(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype and bits; fp8 and bf16
    arrays travel through an integer view of their bytes."""
    a = np.array(a)     # a contiguous, writable copy
    if a.dtype.name in _BIT_VIEWS:
        view, dtype = _BIT_VIEWS[a.dtype.name]
        return torch.from_numpy(a.view(view)).view(dtype).to(device)
    return torch.from_numpy(a).to(device)


def pool_from_jax(pool: Dict[str, Dict[str, np.ndarray]],
                  device: Union[str, torch.device], model=None
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX serving engine's paged pool ({op: {"k", "v"[, "k_scale",
    "v_scale"]: array}}, or one op's dict) -> the port's, bitwise: int8,
    f32 and bf16 payloads and f32 scales keep their dtype, fp8
    (float8_e4m3fn) crosses through a uint8 view of its bytes. With a
    ``model`` under a mesh (the whole pool's dict by op) each op's pool
    keeps this rank's kv heads (``MultiHeadAttention.head_layout``: its
    slice, or the group-1 layout's one kv head a local q head) — the kv
    head axis of the pages and of the scales."""
    if any(isinstance(v, dict) for v in pool.values()):
        ops = ({op.name: op for op in model.ops}
               if model is not None and getattr(model, "mesh", None)
               is not None else {})
        out = {op: pool_from_jax(c, device) for op, c in pool.items()}
        for name, op in ops.items():
            if name in out:
                sel = list(op.head_layout().kv_heads)
                out[name] = {k: _kv_heads(t, sel) for k, t in
                             out[name].items()}
        return out
    return {name: _tensor_from_np(np.asarray(a), device)
            for name, a in pool.items()}


def _kv_heads(t: torch.Tensor, sel) -> torch.Tensor:
    """The kv heads ``sel`` of a pool array: axis 2 of (pages, page_size,
    KVH, D) pages, axis 1 of (pages, KVH) scales (through a byte view:
    fp8 pages have no index kernel everywhere)."""
    axis = 2 if t.dim() == 4 else 1
    idx = torch.tensor(sel, device=t.device)
    if t.element_size() == 1:
        return t.view(torch.uint8).index_select(axis, idx).view(t.dtype)
    return t.index_select(axis, idx)


def _check_against(params, expected: Dict[str, Dict[str, tuple]]):
    problems = []
    for op in sorted(set(expected) | set(params)):
        if op not in params:
            problems.append(f"missing op {op!r}")
            continue
        if op not in expected:
            problems.append(f"unexpected op {op!r}")
            continue
        for w in sorted(set(expected[op]) | set(params[op])):
            got: Optional[tuple] = (tuple(np.shape(params[op][w]))
                                    if w in params[op] else None)
            want = expected[op].get(w)
            if got != want:
                problems.append(f"{op}.{w}: expected {want}, got {got}")
    if problems:
        raise ValueError("params do not match the model: "
                         + "; ".join(problems))
