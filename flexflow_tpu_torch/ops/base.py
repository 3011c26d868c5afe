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

    # -- parallelization metadata (the JAX ``ops/base.py`` hooks) -----------
    #
    # A weight's partition is a SPEC: a tuple with one entry a weight dim —
    # None, a mesh-axis name, or a tuple of names (the JAX PartitionSpec's
    # entries; ``parallel.spec_placements`` turns it into placements).

    def partitionable_output_dims(self) -> List[int]:
        """Output dims a strategy may partition. Default: the sample dim
        only (the reference's conservative default)."""
        return [0]

    def single_axis_dims(self) -> List[int]:
        """Output dims shardable over at most ONE mesh axis (attention's
        sequence dim: the ring / Ulysses lowering names one axis)."""
        return []

    def contract_size(self) -> Optional[int]:
        """The size of the op's weight-contraction dim when the op takes
        CONTRACT (row-parallel) sharding, else None."""
        return None

    def expert_parallel_size(self) -> Optional[int]:
        """The number of shardable experts when the op takes EXPERT
        sharding, else None."""
        return None

    def pipeline_stages(self) -> int:
        """Stacked layers the op can split into pipeline stages (STAGE);
        0 = not pipelineable."""
        return 0

    def output_axis_map(self, axis_map: Dict[str, Optional[int]]
                        ) -> Dict[str, Optional[int]]:
        """The sharding the op's output has under ``axis_map``: sentinel
        axes (CONTRACT / STAGE / EXPERT) deliver it replicated."""
        return {ax: (d if d is not None and d >= 0 else None)
                for ax, d in (axis_map or {}).items()}

    def weight_partition(self, axis_map: Dict[str, Optional[int]]
                         ) -> Dict[str, tuple]:
        """{weight name: spec} under the op's output ``axis_map``.
        Default: every weight replicated (the reference's weights under
        data parallelism)."""
        return {w.name: (None,) * len(w.shape) for w in self.weight_specs()}

    @staticmethod
    def axes_for_dim(axis_map: Dict[str, Optional[int]], dim: int):
        """The mesh axes mapped to output dim ``dim``, as a spec entry:
        None, one axis name, or a tuple."""
        axes = [ax for ax, d in (axis_map or {}).items() if d == dim]
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else tuple(axes)

    # output dims produced by a weight contraction (an out-channel dim):
    # their sharding does not propagate to the inputs
    _contracted_output_dims: Tuple[int, ...] = ()

    def contract_input_dim(self, input_idx: int) -> Optional[int]:
        """The input dim a CONTRACT axis shards for ``input_idx`` (the last
        dim for Linear, the channel dim for Conv2D); None leaves the input
        replicated over it."""
        return None

    def input_axis_map(self, axis_map: Dict[str, Optional[int]],
                       input_idx: int) -> Dict[str, Optional[int]]:
        """The sharding the op's output ``axis_map`` implies for input
        ``input_idx``: the map truncated to the input's rank, weight-
        contracted dims dropped, CONTRACT axes sent to
        ``contract_input_dim``."""
        from flexflow_tpu_torch.parallel.pconfig import CONTRACT

        ndims = self.inputs[input_idx].num_dims
        nd_out = self.outputs[0].num_dims
        contracted = {(d % nd_out) for d in self._contracted_output_dims}
        cdim = self.contract_input_dim(input_idx)
        out = {}
        for ax, d in axis_map.items():
            if d == CONTRACT and cdim is not None:
                out[ax] = cdim
            else:
                out[ax] = (d if d is not None and 0 <= d < ndims
                           and d not in contracted else None)
        return out

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
