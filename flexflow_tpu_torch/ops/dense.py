"""Linear (dense), Embedding and BatchMatmul (the JAX package's
``ops/dense.py``).

A plain matrix product goes to ``torch.matmul`` (cuBLAS on the card), as
the JAX package left it to XLA. The kernel keeps the JAX layout (in, out).
An embedding bag (``AGGR_MODE_SUM`` / ``AVG`` over the last input dim)
is ``F.embedding_bag``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import ActiMode, AggrMode, DataType, OperatorType
from flexflow_tpu_torch.ops.base import Op, WeightSpec
from flexflow_tpu_torch.ops.lora import lora_delta


def apply_activation(x: torch.Tensor, acti: ActiMode) -> torch.Tensor:
    if acti == ActiMode.AC_MODE_NONE:
        return x
    if acti == ActiMode.AC_MODE_RELU:
        return torch.relu(x)
    if acti == ActiMode.AC_MODE_SIGMOID:
        return torch.sigmoid(x)
    if acti == ActiMode.AC_MODE_TANH:
        return torch.tanh(x)
    if acti == ActiMode.AC_MODE_GELU:
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {acti}")


class Linear(Op):
    op_type = OperatorType.OP_LINEAR

    def __init__(self, model, name, inputs, out_dim: int,
                 activation: ActiMode = ActiMode.AC_MODE_NONE,
                 use_bias: bool = True):
        super().__init__(model, name, inputs)
        self.out_dim = out_dim
        self.activation = activation
        self.use_bias = use_bias
        self.in_dim = inputs[0].dims[-1]
        self.finalize()

    def output_shapes(self):
        ishape = self.inputs[0].dims
        return [tuple(ishape[:-1]) + (self.out_dim,)], [self.inputs[0].dtype]

    def weights(self) -> List[WeightSpec]:
        ws = [WeightSpec("kernel", (self.in_dim, self.out_dim), init="glorot",
                         fan=(self.in_dim, self.out_dim))]
        if self.use_bias:
            ws.append(WeightSpec("bias", (self.out_dim,), init="zero"))
        return ws

    def forward(self, params, xs, *, training=False, lora=None):
        y = torch.matmul(xs[0], params["kernel"])
        if lora is not None:
            # the gathered per-row LoRA delta (ops/lora.py), added before
            # the bias as a merged W + a @ b * scale kernel would be
            y = y + lora_delta(xs[0], *lora)
        if self.use_bias:
            y = y + params["bias"]
        return [apply_activation(y, self.activation)]


class Embedding(Op):
    op_type = OperatorType.OP_EMBEDDING

    def __init__(self, model, name, inputs, num_entries: int, out_dim: int,
                 aggr: AggrMode = AggrMode.AGGR_MODE_NONE):
        super().__init__(model, name, inputs)
        self.num_entries = num_entries
        self.out_dim = out_dim
        self.aggr = aggr
        self.finalize()

    def output_shapes(self):
        ishape = tuple(self.inputs[0].dims)
        if self.aggr != AggrMode.AGGR_MODE_NONE:
            # a bag over the last input dim (the reference's AGGR_MODE_SUM
            # / AVG)
            ishape = ishape[:-1]
        return [ishape + (self.out_dim,)], [DataType.DT_FLOAT]

    def weights(self):
        return [WeightSpec("kernel", (self.num_entries, self.out_dim),
                           init="glorot", fan=(self.num_entries, self.out_dim))]

    def forward(self, params, xs, *, training=False):
        idx = xs[0].long()
        if self.aggr == AggrMode.AGGR_MODE_NONE:
            return [F.embedding(idx, params["kernel"])]
        mode = "sum" if self.aggr == AggrMode.AGGR_MODE_SUM else "mean"
        bags = F.embedding_bag(idx.reshape(-1, idx.shape[-1]),
                               params["kernel"], mode=mode)
        return [bags.reshape(*idx.shape[:-1], self.out_dim)]


class BatchMatmul(Op):
    op_type = OperatorType.OP_BATCHMATMUL

    def __init__(self, model, name, inputs):
        super().__init__(model, name, inputs)
        self.finalize()

    def output_shapes(self):
        a, b = self.inputs[0].dims, self.inputs[1].dims
        if a[:-2] != b[:-2] or a[-1] != b[-2]:
            raise ValueError(f"{self.name}: batch_matmul {a} @ {b}: batch "
                             f"dims or the contraction do not match")
        return [tuple(a[:-1]) + (b[-1],)], [self.inputs[0].dtype]

    def forward(self, params, xs, *, training=False):
        return [torch.matmul(xs[0], xs[1])]
