"""Elementwise unary and binary ops and Mean (the JAX package's
``ops/elementwise.py``): single torch calls, graph nodes only so the
builder and the graph walk can name them. The ported ones are those the
Llama decoder and the encoder classifier use (sigmoid, add, multiply,
mean)."""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import Op

_UNARY_FNS = {
    OperatorType.OP_SIGMOID: torch.sigmoid,
}

_BINARY_FNS = {
    OperatorType.OP_EW_ADD: torch.add,
    OperatorType.OP_EW_MUL: torch.multiply,
}


def _check(table, name, op_type):
    if op_type not in table:
        raise NotImplementedError(
            f"{name}: {op_type.name} is not ported yet (ROADMAP.md queue 1, "
            f"item 2)")


class ElementUnary(Op):
    def __init__(self, model, name, inputs, op_type: OperatorType):
        _check(_UNARY_FNS, name, op_type)
        self.op_type = op_type
        super().__init__(model, name, inputs)
        self.finalize()

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        return [_UNARY_FNS[self.op_type](xs[0])]


class ElementBinary(Op):
    def __init__(self, model, name, inputs, op_type: OperatorType):
        _check(_BINARY_FNS, name, op_type)
        self.op_type = op_type
        super().__init__(model, name, inputs)
        self.finalize()

    def output_shapes(self):
        shape = torch.broadcast_shapes(self.inputs[0].dims,
                                       self.inputs[1].dims)
        return [tuple(shape)], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        return [_BINARY_FNS[self.op_type](xs[0], xs[1])]


class Mean(Op):
    op_type = OperatorType.OP_MEAN

    def __init__(self, model, name, inputs, dims, keepdims=False):
        super().__init__(model, name, inputs)
        self.reduce_dims = tuple(dims)
        self.keepdims = keepdims
        self.finalize()

    def output_shapes(self):
        d = list(self.inputs[0].dims)
        if self.keepdims:
            for i in self.reduce_dims:
                d[i] = 1
        else:
            d = [v for i, v in enumerate(d) if i not in self.reduce_dims]
        return [tuple(d)], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        return [torch.mean(xs[0], dim=self.reduce_dims,
                           keepdim=self.keepdims)]
