"""Carry weights from the JAX package into the port.

The port keeps the JAX package's weight names and layouts (``Linear.kernel``
(in, out), ``wq`` (D, H, Hd), ``wo`` (H, Hd, D), ...), so moving a model's
``ff.params`` across is a cast and a copy. The JAX arrays arrive as numpy
(``np.asarray`` of each leaf) — this module imports nothing of JAX.
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
    raises ``ValueError``."""
    if model is not None:
        _check_against(params, model.weight_shapes())
    return {op: {w: torch.tensor(np.asarray(a), dtype=dtype, device=device)
                 for w, a in ws.items()}
            for op, ws in params.items()}


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
