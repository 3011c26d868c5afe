"""Recurrent ops: LSTM, GRU (the JAX package's ``ops/recurrent.py``).

The JAX package's formula, eagerly: one input GEMM over all timesteps
(x @ wx + bias, (B, S, G·H)), then a loop over the S steps of h @ wh and
the gate arithmetic, the carry in the input's dtype. Gate order i, f, g, o
for the LSTM and r, z, n for the GRU, whose r * hn takes no bias (the JAX
cell). On the card each step is a handful of launches (cuBLAS for h @ wh,
elementwise kernels for the gates): the loop is host-launch-bound at small
batch, which a CUDA-graph replay of the training step
(``FFConfig.scan_steps``) takes off the host.
"""

from __future__ import annotations

from typing import List

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import Op, WeightSpec


class _Recurrent(Op):
    #: gate blocks of the fused weights (4 for the LSTM, 3 for the GRU)
    gates = 0

    def __init__(self, model, name, inputs, hidden_size: int,
                 return_sequences: bool = True):
        super().__init__(model, name, inputs)
        self.hidden_size = hidden_size
        self.return_sequences = return_sequences
        self.in_dim = inputs[0].dims[-1]
        self.finalize()

    def output_shapes(self):
        b, s = self.inputs[0].dims[0], self.inputs[0].dims[1]
        h = self.hidden_size
        shape = (b, s, h) if self.return_sequences else (b, h)
        return [shape], [self.inputs[0].dtype]

    def weights(self) -> List[WeightSpec]:
        d, h, g = self.in_dim, self.hidden_size, self.gates
        return [
            WeightSpec("wx", (d, g * h), init="glorot", fan=(d, g * h)),
            WeightSpec("wh", (h, g * h), init="glorot", fan=(h, g * h)),
            WeightSpec("bias", (g * h,), init="zero"),
        ]

    def _cell(self, carry, xg_t, wh):
        """(new carry, h_t) of one step."""
        raise NotImplementedError

    def _init_carry(self, h0):
        return h0

    def forward(self, params, xs, *, training=False):
        x = xs[0]                                             # (B, S, D)
        # the input contributions of every timestep in one GEMM
        xg = torch.matmul(x, params["wx"]) + params["bias"]   # (B, S, G·H)
        carry = self._init_carry(x.new_zeros((x.shape[0], self.hidden_size)))
        hs = []
        for xg_t in xg.unbind(1):
            carry, h = self._cell(carry, xg_t, params["wh"])
            hs.append(h)
        if not self.return_sequences:
            return [hs[-1]]
        return [torch.stack(hs, dim=1)]

    def partitionable_output_dims(self):
        return [0]  # batch only: seq is the recurrence


class LSTM(_Recurrent):
    op_type = OperatorType.OP_LSTM
    gates = 4

    def _init_carry(self, h0):
        return h0, torch.zeros_like(h0)

    def _cell(self, carry, xg_t, wh):
        h_prev, c_prev = carry
        i, f, g, o = (xg_t + h_prev @ wh).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h


class GRU(_Recurrent):
    op_type = OperatorType.OP_GRU
    gates = 3

    def _cell(self, h_prev, xg_t, wh):
        xr, xz, xn = xg_t.chunk(3, dim=-1)
        hr, hz, hn = (h_prev @ wh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * h_prev
        return h, h
