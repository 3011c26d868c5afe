"""Tensor handles for the op graph.

A ``Tensor`` is a symbolic handle — static dims, dtype and owner op — the
same as in the JAX package: the graph is built from handles, and
``torch.Tensor`` values are bound to them only while a graph walk runs.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

from flexflow_tpu_torch.ffconst import DataType

if TYPE_CHECKING:
    from flexflow_tpu_torch.ops.base import Op


@dataclasses.dataclass
class Tensor:
    dims: Tuple[int, ...]
    dtype: DataType
    owner_op: Optional["Op"] = None
    owner_idx: int = 0
    name: str = ""

    @property
    def num_dims(self) -> int:
        return len(self.dims)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        owner = self.owner_op.name if self.owner_op is not None else "input"
        return f"Tensor(dims={self.dims}, dtype={self.dtype.name}, owner={owner})"
