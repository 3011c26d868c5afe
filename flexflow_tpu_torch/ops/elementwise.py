"""Elementwise unary and binary ops (the JAX package's
``ops/elementwise.py``): single torch calls, graph nodes only so the
builder and the graph walk can name them. This slice ports the ones the
Llama decoder uses (sigmoid, add, multiply)."""

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

    def forward(self, params, xs):
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

    def forward(self, params, xs):
        return [_BINARY_FNS[self.op_type](xs[0], xs[1])]
