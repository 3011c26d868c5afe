"""Elementwise unary and binary ops, Cast and Mean (the JAX package's
``ops/elementwise.py``): single torch calls, graph nodes only so the
builder and the graph walk can name them, as the JAX package leaves them
to XLA's fusion."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import TORCH_DTYPES, OperatorType
from flexflow_tpu_torch.ops.base import Op

_UNARY_FNS = {
    OperatorType.OP_RELU: torch.relu,
    OperatorType.OP_SIGMOID: torch.sigmoid,
    OperatorType.OP_TANH: torch.tanh,
    OperatorType.OP_ELU: F.elu,
    # jax.nn.gelu defaults to the tanh approximation
    OperatorType.OP_GELU: lambda x: F.gelu(x, approximate="tanh"),
    OperatorType.OP_EXP: torch.exp,
    OperatorType.OP_SIN: torch.sin,
    OperatorType.OP_COS: torch.cos,
    OperatorType.OP_RSQRT: torch.rsqrt,
    OperatorType.OP_IDENTITY: lambda x: x,
}

#: unary ops that take the op's ``scalar``
_SCALAR_FNS = {
    OperatorType.OP_SCALAR_MULTIPLY: lambda x, s: x * s,
    OperatorType.OP_POW: torch.pow,
}

_BINARY_FNS = {
    OperatorType.OP_EW_ADD: torch.add,
    # the ops themselves, not their aliases: DTensor caches the sharding of
    # aten.sub / mul / div, and re-propagated the aliases at every call
    OperatorType.OP_EW_SUB: torch.sub,
    OperatorType.OP_EW_MUL: torch.mul,
    OperatorType.OP_EW_DIV: torch.div,
    OperatorType.OP_EW_MAX: torch.maximum,
    OperatorType.OP_EW_MIN: torch.minimum,
}


class ElementUnary(Op):
    def __init__(self, model, name, inputs, op_type: OperatorType,
                 scalar: float = None):
        if op_type not in _UNARY_FNS and op_type not in _SCALAR_FNS:
            raise ValueError(f"{name}: {op_type.name} is not a unary op")
        self.op_type = op_type
        super().__init__(model, name, inputs)
        self.scalar = scalar
        self.finalize()

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        if self.op_type in _SCALAR_FNS:
            return [_SCALAR_FNS[self.op_type](xs[0], self.scalar)]
        return [_UNARY_FNS[self.op_type](xs[0])]

    def partitionable_output_dims(self):
        return list(range(self.outputs[0].num_dims))


class ElementBinary(Op):
    def __init__(self, model, name, inputs, op_type: OperatorType):
        if op_type not in _BINARY_FNS:
            raise ValueError(f"{name}: {op_type.name} is not a binary op")
        self.op_type = op_type
        super().__init__(model, name, inputs)
        self.finalize()

    def output_shapes(self):
        shape = torch.broadcast_shapes(self.inputs[0].dims,
                                       self.inputs[1].dims)
        return [tuple(shape)], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        return [_BINARY_FNS[self.op_type](xs[0], xs[1])]

    def partitionable_output_dims(self):
        return list(range(self.outputs[0].num_dims))


class Cast(Op):
    """A cast to ``dtype`` (``ffconst.TORCH_DTYPES``: the width the graph
    names; the JAX package, without ``jax_enable_x64``, narrows
    DT_DOUBLE / DT_INT64 to 32 bits, the same values)."""

    op_type = OperatorType.OP_CAST

    def __init__(self, model, name, inputs, dtype):
        super().__init__(model, name, inputs)
        self.target_dtype = dtype
        self.finalize()

    def output_shapes(self):
        return [self.inputs[0].dims], [self.target_dtype]

    def forward(self, params, xs, *, training=False):
        return [xs[0].to(TORCH_DTYPES[self.target_dtype])]


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
