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
from flexflow_tpu_torch.parallel import reduce_partial, rows_matmul


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
        y = rows_matmul(xs[0], params["kernel"])
        if lora is not None:
            # the gathered per-row LoRA delta (ops/lora.py), added before
            # the bias as a merged W + a @ b * scale kernel would be
            y = y + lora_delta(xs[0], *lora)
        if self.use_bias:
            # under CONTRACT the product is a partial sum a rank: the bias
            # adds after the reduction, once (dense.py:106-110 in JAX)
            y = reduce_partial(y) + params["bias"]
        return [apply_activation(y, self.activation)]

    @property
    def _contracted_output_dims(self):
        return (self.outputs[0].num_dims - 1,)

    def partitionable_output_dims(self):
        # sample dim(s) and the out-channel (the reference's
        # parameter-parallel dim, linear.cu:144-269)
        return list(range(self.outputs[0].num_dims))

    def contract_size(self):
        # row-parallel: kernel sharded on in_dim, the input on its last
        # dim (a column-parallel producer's layout), the output reduced
        return self.in_dim

    def weight_partition(self, axis_map):
        from flexflow_tpu_torch.parallel.pconfig import CONTRACT

        ax = self.axes_for_dim(axis_map, self.outputs[0].num_dims - 1)
        cax = self.axes_for_dim(axis_map, CONTRACT)
        out = {"kernel": (cax, ax)}
        if self.use_bias:
            # the bias adds after the reduction: replicated over contract
            # axes
            out["bias"] = (ax,)
        return out

    def contract_input_dim(self, input_idx):
        return self.inputs[input_idx].num_dims - 1


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

    @property
    def _contracted_output_dims(self):
        return (self.outputs[0].num_dims - 1,)

    def partitionable_output_dims(self):
        nd = self.outputs[0].num_dims
        return [0, nd - 1]  # sample + embedding channel (a column-split table)

    def weight_partition(self, axis_map):
        ax = self.axes_for_dim(axis_map, self.outputs[0].num_dims - 1)
        return {"kernel": (None, ax)}

    def input_axis_map(self, axis_map, input_idx):
        # the index input has no channel dim: only sample-dim mappings
        ndims = self.inputs[input_idx].num_dims
        return {ax: (d if d is not None and d < ndims else None)
                for ax, d in (axis_map or {}).items()}

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

    def partitionable_output_dims(self):
        return list(range(self.outputs[0].num_dims - 2))
