"""Learning-rate schedules (the JAX package's ``runtime/schedule.py``).

Each schedule maps the optimizer's step counter t (0-based) to a
multiplicative scale on its base learning rate. Here t is a device int32
tensor and the scale a 0-dim f32 tensor on the same device: a schedule
never reads a value back to the host, so a step captured as a CUDA graph
(``FFModel.train_scanned``) replays it with the counter's current value.

    SGDOptimizer(lr=0.1, schedule=WarmupCosine(warmup_steps=100,
                                               total_steps=10_000))
"""

from __future__ import annotations

import math

import torch


def _full(t: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-dim f32 constant on t's device (a fill, which a CUDA graph can
    capture, where ``torch.tensor`` would copy from the host)."""
    return torch.full((), value, dtype=torch.float32, device=t.device)


class Schedule:
    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class ConstantSchedule(Schedule):
    def __call__(self, t):
        return _full(t, 1.0)


class _WarmupDecay(Schedule):
    """Linear warmup 0->1 over `warmup_steps`, then `_decay(frac)` from 1
    to `final_scale` as frac runs 0->1 at `total_steps` (held after)."""

    def __init__(self, warmup_steps: int, total_steps: int,
                 final_scale: float = 0.0):
        assert total_steps > warmup_steps >= 0, \
            f"need total_steps > warmup_steps >= 0, got " \
            f"{total_steps} / {warmup_steps}"
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps
        self.final_scale = final_scale

    def _decay(self, frac):
        raise NotImplementedError

    def __call__(self, t):
        t = t.float()
        warm = t / max(self.warmup_steps, 1)
        frac = (t - self.warmup_steps) / (self.total_steps -
                                          self.warmup_steps)
        frac = frac.clamp(0.0, 1.0)
        return torch.where(t < self.warmup_steps, warm, self._decay(frac))


class WarmupCosine(_WarmupDecay):
    """Linear warmup, cosine decay to `final_scale`."""

    def _decay(self, frac):
        return self.final_scale + (1.0 - self.final_scale) \
            * 0.5 * (1.0 + torch.cos(math.pi * frac))


class WarmupLinear(_WarmupDecay):
    """Linear warmup, linear decay to `final_scale`."""

    def _decay(self, frac):
        return 1.0 + (self.final_scale - 1.0) * frac


class StepDecay(Schedule):
    """scale = gamma^(t // step_size) — the classic ResNet 0.1x drops."""

    def __init__(self, step_size: int, gamma: float = 0.1):
        assert step_size > 0
        self.step_size = step_size
        self.gamma = gamma

    def __call__(self, t):
        k = torch.div(t, self.step_size, rounding_mode="floor")
        return torch.pow(_full(t, self.gamma), k.float())


class ExponentialDecay(Schedule):
    """scale = gamma^t."""

    def __init__(self, gamma: float):
        self.gamma = gamma

    def __call__(self, t):
        return torch.pow(_full(t, self.gamma), t.float())


def resolve(schedule) -> Schedule:
    """None -> constant; a Schedule instance or any callable passes
    through. Rejects an uninstantiated class (a forgotten-parens
    `schedule=WarmupCosine` would otherwise fail at the first step with an
    unrelated-looking message)."""
    if schedule is None:
        return ConstantSchedule()
    if isinstance(schedule, type):
        raise TypeError(
            f"schedule must be an instance, got the class {schedule.__name__}"
            f" — did you mean {schedule.__name__}(...)?")
    if callable(schedule):
        return schedule
    raise TypeError(f"schedule must be callable or None, got {schedule!r}")
