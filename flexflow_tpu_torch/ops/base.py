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
    package's layout, so weights carry across unchanged) and init rule
    (``runtime/initializer.py init_weight``)."""

    name: str
    shape: Tuple[int, ...]
    # glorot | zero | one | uniform | normal | constant
    init: str = "glorot"
    # fan dims for glorot: (fan_in, fan_out); default from the shape
    fan: Optional[Tuple[int, int]] = None
    # uniform: (low, high); normal: (mean, std); constant: (value,)
    init_args: Optional[Tuple[float, ...]] = None


class Op:
    """Graph-node base. Subclasses set ``op_type`` and implement
    ``output_shapes`` and ``forward``, and ``weights`` when they own any.

    A ``stateful`` op (BatchNorm's running statistics) implements
    ``forward_stateful`` and ``init_state`` instead of ``forward``: the
    executor keeps its state beside the weights, never casts it, never
    takes its gradient, and commits each new state in place. An op that
    ``needs_rng`` (Dropout, attention dropout, each at a rate above 0)
    takes ``gen``, a ``torch.Generator`` on the op's device that the
    executor derives from ``FFConfig.seed``, the op's index and its own
    ``seed``, in its ``forward``; its draws advance it, step by step."""

    op_type: OperatorType = OperatorType.OP_NOOP
    stateful: bool = False
    needs_rng: bool = False

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

    def forward(self, params: Dict[str, Any], xs: List[torch.Tensor], *,
                training: bool = False) -> List[torch.Tensor]:
        """Output values of ``xs``; ``training`` selects the training
        behaviour where an op has one (the JAX package's flag). An op that
        ``needs_rng`` also takes ``gen`` (None: no randomness, as the JAX
        ops do without an rng)."""
        raise NotImplementedError

    def forward_stateful(self, params: Dict[str, Any],
                         state: Dict[str, torch.Tensor],
                         xs: List[torch.Tensor], *, training: bool = False,
                         gen: Optional[torch.Generator] = None
                         ) -> Tuple[List[torch.Tensor],
                                    Dict[str, torch.Tensor]]:
        """(outputs, new state) of a ``stateful`` op; ``state`` is read,
        never written (the executor commits the new state)."""
        raise NotImplementedError

    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        """The initial state of a ``stateful`` op, on ``device``."""
        return {}

    def init_state_for_shapes(self, in_shapes, device=None
                              ) -> Dict[str, torch.Tensor]:
        """State sized for the given input shapes (the JAX package sizes a
        shard's state this way). Default: the full-size state."""
        return self.init_state(device)

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

    def forward(self, params, xs, *, training=False):
        raise RuntimeError("InputOp is fed by the graph walk, never executed")
