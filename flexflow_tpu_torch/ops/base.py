"""Op base class and weight specs (the JAX package's ``ops/base.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.ffconst import DataType, OperatorType
from flexflow_tpu_torch.tensor import Tensor


@dataclasses.dataclass
class WeightSpec:
    """Metadata for one weight of an op: its name, shape (the JAX
    package's layout, so weights carry across unchanged) and init rule."""

    name: str
    shape: Tuple[int, ...]
    init: str = "glorot"  # glorot | zero | one
    # fan dims for glorot: (fan_in, fan_out); default from the shape
    fan: Optional[Tuple[int, int]] = None

    def initialize(self, dtype: torch.dtype, device: torch.device,
                   gen: torch.Generator) -> torch.Tensor:
        """A fresh weight on ``device``, drawn from ``gen`` (the model's
        seeded generator). Glorot is uniform(-a, a), a = sqrt(6 / (fan_in +
        fan_out)), as in the JAX package — the bits differ (torch's
        generator is not threefry), the distribution does not."""
        w = torch.empty(self.shape, dtype=dtype, device=device)
        if self.init == "zero":
            return w.zero_()
        if self.init == "one":
            return w.fill_(1.0)
        if self.init != "glorot":
            raise ValueError(f"{self.name}: unknown init {self.init!r}")
        fan_in, fan_out = self.fan or (self.shape[0], self.shape[-1])
        a = (6.0 / (fan_in + fan_out)) ** 0.5
        return w.uniform_(-a, a, generator=gen)


class Op:
    """Graph-node base. Subclasses set ``op_type`` and implement
    ``output_shapes`` and ``forward``, and ``weights`` when they own any."""

    op_type: OperatorType = OperatorType.OP_NOOP

    def __init__(self, model, name: str, inputs: Sequence[Tensor]):
        self.model = model
        self.name = name
        self.inputs: List[Tensor] = list(inputs)
        self.outputs: List[Tensor] = []
        self._weight_specs: Optional[List[WeightSpec]] = None

    def finalize(self) -> None:
        """Infer the output handles."""
        shapes, dtypes = self.output_shapes()
        self.outputs = [
            Tensor(dims=tuple(s), dtype=dt, owner_op=self, owner_idx=i,
                   name=f"{self.name}:out{i}")
            for i, (s, dt) in enumerate(zip(shapes, dtypes))
        ]

    def output_shapes(self) -> Tuple[List[Tuple[int, ...]], List[DataType]]:
        raise NotImplementedError

    def weights(self) -> List[WeightSpec]:
        return []

    def weight_specs(self) -> List[WeightSpec]:
        if self._weight_specs is None:
            self._weight_specs = self.weights()
        return self._weight_specs

    def forward(self, params: Dict[str, Any],
                xs: List[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


class InputOp(Op):
    """Placeholder op owning a graph input tensor."""

    op_type = OperatorType.OP_INPUT

    def __init__(self, model, name: str, dims: Tuple[int, ...],
                 dtype: DataType):
        super().__init__(model, name, [])
        self._dims = tuple(dims)
        self._dtype = dtype

    def output_shapes(self):
        return [self._dims], [self._dtype]

    def forward(self, params, xs):
        raise RuntimeError("InputOp is fed by the graph walk, never executed")
