"""Graph walks for KV-cache generation (the JAX package's
``runtime/generation.py`` ``Generator``, the parts serving runs).

The JAX package jits one program per shape; the port runs the same walk
eagerly. ``_walk`` interprets the op graph on a (B, S) token slab:
whole-prompt prefill into a contiguous per-request cache, or one
continuous-batching decode step over the paged pool (``paged=``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from flexflow_tpu_torch.ffconst import DataType, OperatorType
from flexflow_tpu_torch.ops.attention import (MultiHeadAttention,
                                              paged_slot, rope_tables)
from flexflow_tpu_torch.ops.base import InputOp

# ops whose forward treats every (batch, position) independently — safe to
# run on a (B, 1) decode slab exactly as on the full sequence
_DECODE_SAFE = {
    OperatorType.OP_LINEAR,
    OperatorType.OP_EMBEDDING,
    OperatorType.OP_RMSNORM,
    OperatorType.OP_SIGMOID,
    OperatorType.OP_EW_ADD,
    OperatorType.OP_EW_MUL,
}


class Generator:
    """Graph walks of a decoder-only LM built on FFModel (after
    compile()): validation of the graph, prefill and paged decode."""

    def __init__(self, model):
        self.model = model
        input_ops = [op for op in model.ops if isinstance(op, InputOp)]
        tok_inputs = [op for op in input_ops
                      if op.outputs[0].dtype in (DataType.DT_INT32,
                                                 DataType.DT_INT64)]
        if len(input_ops) != 1 or not tok_inputs:
            kinds = ", ".join(
                f"{op.name}:{op.outputs[0].dtype.name}" for op in input_ops)
            raise ValueError(
                "generation needs a decoder-only LM with exactly one integer "
                f"token input; this graph has [{kinds}]")
        self.token_input = tok_inputs[0]
        self.attn_ops = []
        for op in model.ops:
            if isinstance(op, InputOp):
                continue
            if isinstance(op, MultiHeadAttention):
                if not op.causal:
                    raise ValueError(
                        f"{op.name}: generation requires causal attention")
                if not (op.inputs[0] is op.inputs[1] is op.inputs[2]):
                    raise ValueError(
                        f"{op.name}: generation supports self-attention "
                        "only (q, k, v must be the same tensor)")
                self.attn_ops.append(op)
            elif op.op_type not in _DECODE_SAFE:
                raise ValueError(
                    f"{op.name} ({op.op_type.name}) is not supported in the "
                    "KV-cache decode path")
        if not self.attn_ops:
            raise ValueError("graph has no attention ops; nothing to cache")
        # past the last attention op every op is per-position, so the
        # prefill tail (lm_head included) runs on each row's last position
        self._last_attn_idx = max(i for i, op in enumerate(model.ops)
                                  if op in self.attn_ops)

    def _compute_dtype(self) -> torch.dtype:
        if self.model.config.compute_dtype == "bfloat16":
            return torch.bfloat16
        return torch.float32

    def _walk(self, params, tokens, caches, last_only=False,
              row_lengths=None, paged: Optional[Dict] = None):
        """Interpret the graph on a (B, S) token slab. Without ``paged``
        this is the whole-prompt prefill (positions 0..S-1, fills
        ``caches``); with it, a (B, 1) decode step over the paged pool.
        ``last_only`` narrows the prefill tail: past the last attention op
        only each row's last valid position (``row_lengths`` - 1, or column
        -1) flows through, so the lm_head never sees the pad positions and
        no (B, S, V) logits are made."""
        s_full = tokens.shape[1]
        vals = {self.token_input.outputs[0]: tokens}
        new_caches = {}
        # every attention op of one walk rotates the same positions and
        # (decoding) writes the same pool rows: derive those once, here
        first = self.attn_ops[0]
        rope_key = (first.rope_theta, first.qk_head_dim)
        rope = slot = None
        if first.rope:
            rope = rope_tables(first.rope_theta, s_full, first.qk_head_dim,
                               0 if paged is None else paged["rope_pos"],
                               tokens.device)
        if paged is not None:
            slot = paged_slot(paged["page_table"], paged["write_pos"],
                              caches[first.name]["k"].shape[1])
        for idx, op in enumerate(self.model.ops):
            if isinstance(op, InputOp):
                continue
            xs = [vals[t] for t in op.inputs]
            if (last_only and paged is None and idx > self._last_attn_idx
                    and s_full > 1):
                if row_lengths is None:
                    xs = [x[:, -1:] if (x.dim() >= 2
                                        and x.shape[1] == s_full) else x
                          for x in xs]
                else:
                    last = (row_lengths.long() - 1)

                    def take_last(x):
                        if not (x.dim() >= 2 and x.shape[1] == s_full):
                            return x
                        return x[torch.arange(x.shape[0], device=x.device),
                                 last][:, None]

                    xs = [take_last(x) for x in xs]
            p = params.get(op.name, {})
            if isinstance(op, MultiHeadAttention):
                cache = caches[op.name]
                # an op rotating other angles derives its own tables
                r = rope if (op.rope_theta, op.qk_head_dim) == rope_key \
                    else None
                if paged is not None:
                    out, nc = op.paged_decode_forward(
                        p, xs, cache, paged["page_table"],
                        paged["write_pos"], paged["rope_pos"],
                        paged["row_len"], paged["prompt_pad"], rope=r,
                        slot=slot)
                else:
                    out, nc = op.prefill_forward(p, xs, cache, rope=r)
                new_caches[op.name] = nc
                outs = [out]
            else:
                outs = op.forward(p, xs)
            for i, t in enumerate(op.outputs):
                vals[t] = outs[i]
        return vals[self.model._final_tensor], new_caches

    def _prefill(self, params, tokens, caches, row_lengths):
        """Whole-prompt prefill (the JAX ``_prefill`` with
        ``prefill_chunk=0``): logits (B, 1, V) at each row's last valid
        position, and the filled caches."""
        return self._walk(params, tokens, caches, last_only=True,
                          row_lengths=row_lengths)
