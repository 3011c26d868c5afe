"""Shape and layout ops: Reshape, Transpose, Reverse, Concat, Split, TopK,
Gather and Pad (the JAX package's ``ops/tensor_ops.py``): one torch call
each, as the JAX package leaves each to one XLA op."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import DataType, OperatorType
from flexflow_tpu_torch.ops.base import Op


def _volume(dims) -> int:
    return math.prod(dims)


class Reshape(Op):
    op_type = OperatorType.OP_RESHAPE

    def __init__(self, model, name, inputs, shape: Sequence[int]):
        super().__init__(model, name, inputs)
        shape = list(shape)
        vol = _volume(inputs[0].dims)
        if -1 in shape:
            known = _volume([s for s in shape if s != -1])
            shape[shape.index(-1)] = vol // known
        self.shape = tuple(shape)
        if _volume(self.shape) != vol:
            raise ValueError(f"{name}: reshape {inputs[0].dims} -> "
                             f"{self.shape}")
        self.finalize()

    def output_shapes(self):
        return [self.shape], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        return [xs[0].reshape(self.shape)]


class Transpose(Op):
    op_type = OperatorType.OP_TRANSPOSE

    def __init__(self, model, name, inputs, perm: Sequence[int]):
        super().__init__(model, name, inputs)
        self.perm = tuple(perm)
        self.finalize()

    def output_shapes(self):
        d = self.inputs[0].dims
        return [tuple(d[p] for p in self.perm)], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        return [xs[0].permute(self.perm)]

    def partitionable_output_dims(self):
        return list(range(self.outputs[0].num_dims))


class Reverse(Op):
    op_type = OperatorType.OP_REVERSE

    def __init__(self, model, name, inputs, axis: int):
        super().__init__(model, name, inputs)
        self.axis = axis
        self.finalize()

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        return [torch.flip(xs[0], (self.axis,))]


class Concat(Op):
    """``torch.cat``, which promotes mixed dtypes as ``jnp.concatenate``
    does (an f32 embedding bag beside bf16 activations, DLRM's
    interaction, comes out f32)."""

    op_type = OperatorType.OP_CONCAT

    def __init__(self, model, name, inputs, axis: int):
        super().__init__(model, name, inputs)
        self.axis = axis if axis >= 0 else len(inputs[0].dims) + axis
        self.finalize()

    def output_shapes(self):
        d = list(self.inputs[0].dims)
        d[self.axis] = sum(t.dims[self.axis] for t in self.inputs)
        return [tuple(d)], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        return [torch.cat(xs, dim=self.axis)]

    def partitionable_output_dims(self):
        return [i for i in range(self.outputs[0].num_dims) if i != self.axis]


class Split(Op):
    op_type = OperatorType.OP_SPLIT

    def __init__(self, model, name, inputs, sizes: Sequence[int], axis: int):
        super().__init__(model, name, inputs)
        self.sizes = tuple(sizes)
        self.axis = axis
        if sum(self.sizes) != inputs[0].dims[axis]:
            raise ValueError(f"{name}: split sizes {self.sizes} do not sum "
                             f"to dim {axis} of {inputs[0].dims}")
        self.finalize()

    def output_shapes(self):
        shapes = []
        for s in self.sizes:
            d = list(self.inputs[0].dims)
            d[self.axis] = s
            shapes.append(tuple(d))
        return shapes, [self.inputs[0].dtype] * len(self.sizes)

    def forward(self, params, xs, *, training=False):
        return list(torch.split(xs[0], self.sizes, dim=self.axis))

    def partitionable_output_dims(self):
        return [i for i in range(self.outputs[0].num_dims) if i != self.axis]


class TopK(Op):
    """The ``k`` largest values along the last dim and their int32
    indices. ``lax.top_k`` returns them sorted whatever ``sorted`` says,
    so the port always asks ``torch.topk`` for sorted values; the order of
    equal values may differ from JAX's."""

    op_type = OperatorType.OP_TOPK

    def __init__(self, model, name, inputs, k: int, sorted: bool = True):
        super().__init__(model, name, inputs)
        self.k = k
        self.sorted = sorted
        self.finalize()

    def output_shapes(self):
        d = list(self.inputs[0].dims)
        d[-1] = self.k
        return [tuple(d), tuple(d)], [self.inputs[0].dtype, DataType.DT_INT32]

    def forward(self, params, xs, *, training=False):
        vals, idxs = torch.topk(xs[0], self.k, dim=-1, sorted=True)
        return [vals, idxs.to(torch.int32)]


class Gather(Op):
    """``take_along_axis``: ``torch.gather`` along ``axis`` with the index
    input's shape."""

    op_type = OperatorType.OP_GATHER

    def __init__(self, model, name, inputs, axis: int):
        super().__init__(model, name, inputs)
        self.axis = axis
        self.finalize()

    def output_shapes(self):
        return [self.inputs[1].dims], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        return [torch.gather(xs[0], self.axis, xs[1].long())]


class Pad(Op):
    op_type = OperatorType.OP_PAD

    def __init__(self, model, name, inputs, pads: Sequence[Tuple[int, int]],
                 value: float = 0.0):
        super().__init__(model, name, inputs)
        self.pads = tuple(tuple(p) for p in pads)
        self.value = value
        self.finalize()

    def output_shapes(self):
        d = [s + lo + hi for s, (lo, hi) in zip(self.inputs[0].dims,
                                                 self.pads)]
        return [tuple(d)], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        # F.pad lists (low, high) from the last dim backwards
        flat = [p for lo_hi in reversed(self.pads) for p in lo_hi]
        return [F.pad(xs[0], flat, value=self.value)]
