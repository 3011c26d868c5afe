"""Per-slot token sampling for the serving engine (the JAX package's
``ops/sampling.py``).

Sampling is data, not a program: temperature / top-p / top-k / seed ride
every dispatch as per-slot arrays beside ``write_pos``, and every function
here is shape-stable in the slot dimension, so one decode program (a CUDA
graph on the card) serves any mix of sampling configs.

Counter-based draws: a request's stream is a pure function of (seed,
stream tag, draw index), never of the slot, the engine instance or the
device. The JAX package folds these into threefry keys; the port hashes
them with splitmix64 in int64 tensor arithmetic (``_mix``, the finalizer
``ops/attention.py hashed_keep_mask`` uses), whose bits torch computes the
same on the CPU and on the card, and which a CUDA graph captures (no
generator state). JAX's threefry bits are not reproduced: sampled streams
are checked by distribution. The draw index is the position of the token
being sampled (the prefill's first token is draw 0). Four streams:

  TAG_TARGET   — the non-speculative sampler's token draws
  TAG_DRAFT    — the draft model's proposal draws under speculation
  TAG_ACCEPT   — the rejection-sampling accept uniforms (host rule)
  TAG_RESAMPLE — the residual re-draw after a rejection

Greedy is the ``temperature == 0`` case of the same functions: those rows
return ``argmax(f32(logits))``, bitwise the greedy-only decode (the first
maximum, like ``jnp.argmax``).

Warping (shared by the sampler and ``sampling_probs``; the accept rule
depends on the two agreeing): logits are divided by the temperature, the
top-k and top-p keep-sets are computed on that warped distribution and
intersected, and rank 0 always survives. Categorical draws are Gumbel-max
over the masked warped logits, as ``jax.random.categorical`` draws.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ops.attention import _GOLDEN, _MIX1, _MIX2, _i64, _srl

TAG_TARGET = 1
TAG_DRAFT = 2
TAG_ACCEPT = 3
TAG_RESAMPLE = 4

#: domain separators of the hash's three fields (odd int64 constants)
_TAG_MUL = _i64(0xD1B54A32D192ED03)
_CTR_MUL = _i64(0xAEF17502108EF2D9)


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


def _mix(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 (wrapping arithmetic)."""
    z = (z ^ _srl(z, 30)) * _MIX1
    z = (z ^ _srl(z, 27)) * _MIX2
    return z ^ _srl(z, 31)


def slot_keys(seeds: torch.Tensor, counters: torch.Tensor,
              tag: int) -> torch.Tensor:
    """(B,) seeds + (B,) draw indices -> (B,) int64 keys on the ``tag``
    stream; row b's key depends only on (seeds[b], tag, counters[b])."""
    z = _mix(seeds.long() * _GOLDEN + _i64(tag * _TAG_MUL))
    return _mix(z + counters.long() * _CTR_MUL)


def uniforms(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B,) keys -> (B, n) f32 uniforms in (0, 1), element j a hash of
    (key, j): the top 24 bits of the mix, centred in their cell, so every
    value is exact in f32 and never 0 or 1."""
    j = torch.arange(1, n + 1, dtype=torch.int64, device=keys.device)
    z = _mix(keys[:, None] + j[None, :] * _GOLDEN)
    return (_srl(z, 40).float() + 0.5) * 2.0 ** -24


def _categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits) by Gumbel-max: argmax of
    logits + (-log(-log(u))), u one uniform a vocab position."""
    g = -torch.log(-torch.log(uniforms(keys, logits.shape[-1])))
    return torch.argmax(logits + g, dim=-1)


def _masked_warped(logits, temps, top_ps, top_ks):
    """(B, V) f32 masked warped logits for the temperature > 0 rows (rows
    at temperature 0 are resolved by the callers' argmax). The survivors
    are (top-k keep) AND (top-p keep), computed on the warped
    distribution; rank 0 always survives."""
    logits = logits.float()
    temps = temps.float()
    safe_t = torch.where(temps > 0.0, temps, torch.ones_like(temps))
    warped = logits / safe_t[:, None]
    # rank every vocab position by warped value; the stable sort breaks
    # ties by vocab index, as jnp.argsort(-warped) does
    order = torch.sort(-warped, dim=-1, stable=True).indices
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(order.shape[-1], device=order.device)
        .expand_as(order))
    keep_k = (top_ks[:, None] <= 0) | (ranks < top_ks[:, None].long())
    probs = torch.softmax(warped, dim=-1)
    sorted_probs = torch.gather(probs, -1, order)
    csum = torch.cumsum(sorted_probs, dim=-1)
    # keep sorted position j iff the mass strictly before it is < top_p:
    # the smallest prefix reaching top_p survives, rank 0 always does
    keep_sorted = (csum - sorted_probs) < top_ps.float()[:, None]
    keep_p = torch.gather(keep_sorted, -1, ranks)
    return torch.where(keep_k & keep_p, warped,
                       torch.full_like(warped, -torch.inf))


def _probs(logits, masked, temps):
    """Softmax of the masked warped rows; the one-hot at argmax for the
    rows at temperature 0."""
    greedy = torch.zeros_like(logits).scatter_(
        -1, torch.argmax(logits, dim=-1, keepdim=True), 1.0)
    return torch.where((temps > 0.0)[:, None],
                       torch.softmax(masked, dim=-1), greedy)


def _draw(logits, masked, temps, seeds, counters, tag):
    """Gumbel-max draws of the masked warped rows; argmax for the rows at
    temperature 0."""
    sampled = _categorical(slot_keys(seeds, counters, tag), masked)
    return torch.where(temps > 0.0, sampled, torch.argmax(logits, dim=-1))


def sampling_probs(logits, temps, top_ps, top_ks):
    """The per-row sampling distribution, (B, V) f32: the operand of the
    rejection-sampling accept rule (``p`` for the target, ``q`` for the
    draft). Rows at temperature 0 are the one-hot at argmax."""
    logits = logits.float()
    return _probs(logits, _masked_warped(logits, temps, top_ps, top_ks),
                  temps)


def sample_tokens(logits, temps=None, top_ps=None, top_ks=None, seeds=None,
                  counters=None, tag: int = TAG_TARGET):
    """One token per row from the warped distribution, (B,) int64. Rows at
    temperature 0 take ``argmax(f32(logits))`` (every row does when no
    sampling arrays are given); draw b is a pure function of (seeds[b],
    tag, counters[b])."""
    logits = logits.float()
    if temps is None:
        return torch.argmax(logits, dim=-1)
    return _draw(logits, _masked_warped(logits, temps, top_ps, top_ks),
                 temps, seeds, counters, tag)


def sample_with_probs(logits, temps, top_ps, top_ks, seeds, counters,
                      tag: int = TAG_TARGET):
    """``sample_tokens`` and ``sampling_probs`` of the same rows from one
    warp (the draft's proposal step needs both)."""
    logits = logits.float()
    masked = _masked_warped(logits, temps, top_ps, top_ks)
    return (_draw(logits, masked, temps, seeds, counters, tag),
            _probs(logits, masked, temps))


def accept_uniforms(seeds, counters, k: int):
    """(B, k) f32 accept-rule uniforms: row b, proposal i draws from the
    ACCEPT stream at index counters[b] + i. The host accepts proposal d
    when ``u * q(d) < p(d)``."""
    i = torch.arange(k, dtype=torch.int64, device=seeds.device)
    keys = slot_keys(seeds.long()[:, None].expand(-1, k).reshape(-1),
                     (counters.long()[:, None] + i).reshape(-1), TAG_ACCEPT)
    return uniforms(keys, 1).reshape(-1, k)


def residual_sample(p, q, seeds, counters):
    """The rejection re-draw: one token per row from the residual
    ``norm(max(p - q, 0))`` — what makes accept / resample speculation
    distribution-identical to sampling ``p`` directly. ``p`` / ``q`` are
    (B, V) sampling distributions (``q`` all zeros for the bonus draw after
    a fully accepted window, so the residual is ``p``). A numerically empty
    residual (q >= p everywhere) falls back to ``p``. Draws ride the
    RESAMPLE stream at the emitted token's index."""
    p = p.float()
    r = torch.clamp_min(p - q.float(), 0.0)
    norm = r.sum(dim=-1, keepdim=True)
    dist = torch.where(norm > 1e-12, r / torch.clamp_min(norm, 1e-12), p)
    logits = torch.log(torch.clamp_min(dist, 1e-38))
    return _categorical(slot_keys(seeds, counters, TAG_RESAMPLE), logits)
