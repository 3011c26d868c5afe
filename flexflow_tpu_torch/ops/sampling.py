"""Token sampling for the serving engine (the JAX package's
``ops/sampling.py``), greedy half.

Greedy is ``argmax(f32(logits))``, which takes the first maximum like
``jnp.argmax``. Sampled streams (temperature > 0) are a later slice: the
JAX package draws them from threefry keys, whose bits torch cannot
reproduce, so they need their own counter-based generator and a
distribution-level test.
"""

from __future__ import annotations

import torch


def validate_sampling(temperature, top_p, top_k, where: str = "sampling"):
    """Host-side validation: temperature >= 0 (0 = greedy), 0 < top_p <= 1
    (1 = off), top_k >= 0 (0 = off)."""
    t = float(temperature)
    p = float(top_p)
    k = int(top_k)
    if not t >= 0.0:        # catches NaN too
        raise ValueError(
            f"{where}: temperature={temperature}: must be >= 0 "
            f"(0 = greedy argmax)")
    if not (0.0 < p <= 1.0):
        raise ValueError(
            f"{where}: top_p={top_p}: must be in (0, 1] "
            f"(1 = no nucleus filter)")
    if k < 0:
        raise ValueError(
            f"{where}: top_k={top_k}: must be >= 0 (0 = no top-k filter)")
    return t, p, k


def sample_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy: (B, V) logits -> (B,) int64, the first maximum of the f32
    logits (the temperature-0 rows of the JAX ``sample_tokens``). The
    serving engine refuses temperature > 0 at construction and submit."""
    return torch.argmax(logits.float(), dim=-1)
