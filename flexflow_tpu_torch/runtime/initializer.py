"""Weight initializers (the JAX package's ``runtime/initializer.py``).

Reference: include/initializer.h:28-101 and src/runtime/
initializer_kernel.cu (Glorot-uniform, zero, uniform, normal, constant).
Each draws from an explicit ``torch.Generator`` on the weight's device —
the model's, seeded with ``FFConfig.seed``. The bits differ from the JAX
package's (its threefry keys are not torch's generator); the
distributions do not.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


class Initializer:
    def __call__(self, gen: torch.Generator, shape, dtype=torch.float32,
                 device=None, **kw) -> torch.Tensor:
        raise NotImplementedError


def _empty(gen, shape, dtype, device):
    return torch.empty(tuple(shape), dtype=dtype,
                       device=gen.device if device is None else device)


class GlorotUniformInitializer(Initializer):
    """uniform(-a, a), a = sqrt(6 / (fan_in + fan_out)); fan from ``fan``
    or the shape (first and last dims)."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def __call__(self, gen, shape, dtype=torch.float32, device=None,
                 fan: Optional[Tuple[int, int]] = None):
        fan_in, fan_out = fan or (shape[0], shape[-1])
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return _empty(gen, shape, dtype, device).uniform_(-limit, limit,
                                                          generator=gen)


class ZeroInitializer(Initializer):
    def __call__(self, gen, shape, dtype=torch.float32, device=None, **kw):
        return _empty(gen, shape, dtype, device).zero_()


class OneInitializer(Initializer):
    def __call__(self, gen, shape, dtype=torch.float32, device=None, **kw):
        return _empty(gen, shape, dtype, device).fill_(1.0)


class UniformInitializer(Initializer):
    def __init__(self, seed: int = 0, low: float = -0.05, high: float = 0.05):
        self.low, self.high = low, high

    def __call__(self, gen, shape, dtype=torch.float32, device=None, **kw):
        return _empty(gen, shape, dtype, device).uniform_(
            self.low, self.high, generator=gen)


class NormInitializer(Initializer):
    def __init__(self, seed: int = 0, mean: float = 0.0, stddev: float = 1.0):
        self.mean, self.stddev = mean, stddev

    def __call__(self, gen, shape, dtype=torch.float32, device=None, **kw):
        return _empty(gen, shape, dtype, device).normal_(
            self.mean, self.stddev, generator=gen)


class ConstantInitializer(Initializer):
    def __init__(self, value: float):
        self.value = value

    def __call__(self, gen, shape, dtype=torch.float32, device=None, **kw):
        return _empty(gen, shape, dtype, device).fill_(self.value)


def init_weight(spec, gen: torch.Generator, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Initialize one weight from its ``ops.base.WeightSpec`` (``init``
    glorot | zero | one | uniform | normal | constant, with ``init_args``
    (low, high), (mean, std) or (value,)), drawn from ``gen``."""
    kind, args = spec.init, spec.init_args
    if kind == "glorot":
        return GlorotUniformInitializer()(gen, spec.shape, dtype, device,
                                          fan=spec.fan)
    if kind == "zero":
        return ZeroInitializer()(gen, spec.shape, dtype, device)
    if kind == "one":
        return OneInitializer()(gen, spec.shape, dtype, device)
    if kind == "uniform":
        low, high = args if args else (-0.05, 0.05)
        return UniformInitializer(low=low, high=high)(gen, spec.shape, dtype,
                                                      device)
    if kind == "normal":
        mean, std = args if args else (0.0, 1.0)
        return NormInitializer(mean=mean, stddev=std)(gen, spec.shape, dtype,
                                                      device)
    if kind == "constant":
        (v,) = args
        return ConstantInitializer(v)(gen, spec.shape, dtype, device)
    raise ValueError(f"{spec.name}: unknown init kind {kind!r}")
