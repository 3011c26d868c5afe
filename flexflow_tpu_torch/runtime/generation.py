"""Graph walks for KV-cache generation (the JAX package's
``runtime/generation.py`` ``Generator``, the parts serving runs).

The JAX package jits one program per shape; the port runs the same walk
eagerly. ``_walk`` interprets the op graph on a (B, S) token slab:
whole-prompt prefill into a contiguous per-request cache, a prompt chunk
behind a cached prefix (``chunk_start=``) and the read-only query of the
prompt's last token (``gather_last=``) — a prefix-cache hit's two passes —
or one continuous-batching decode step over the paged pool (``paged=``).
A MoE layer runs at capacity = the slab's token count, as in the JAX walk:
no token drops, so each row's output is its own.

Weight-only quantization (``quantize='int8'`` / ``'fp8'``): every float
weight with two or more dims is stored once as a quantized payload with
per-output-channel f32 scales (``_quantized_params``) and dequantized per
use (``_deq``), as the JAX package does; the matrix products stay
``torch.matmul``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from flexflow_tpu_torch.ffconst import DataType, OperatorType
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.attention import (MultiHeadAttention, _divide,
                                              paged_slot, rope_tables,
                                              storage_qmax)
from flexflow_tpu_torch.ops.base import InputOp
from flexflow_tpu_torch.runtime.executor import resolve_tied_params

# ops whose forward treats every (batch, position) independently — safe to
# run on a (B, 1) decode slab exactly as on the full sequence (the JAX set)
_DECODE_SAFE = {
    OperatorType.OP_LINEAR,
    OperatorType.OP_EMBEDDING,
    OperatorType.OP_LAYERNORM,
    OperatorType.OP_RMSNORM,
    OperatorType.OP_DROPOUT,   # inference: identity
    OperatorType.OP_CAST,
    OperatorType.OP_SCALAR_MULTIPLY,
    OperatorType.OP_IDENTITY,
    OperatorType.OP_EXP,
    OperatorType.OP_SIN,
    OperatorType.OP_COS,
    OperatorType.OP_POW,
    OperatorType.OP_RSQRT,
    OperatorType.OP_RELU,
    OperatorType.OP_SIGMOID,
    OperatorType.OP_TANH,
    OperatorType.OP_ELU,
    OperatorType.OP_GELU,
    OperatorType.OP_EW_ADD,
    OperatorType.OP_EW_MUL,
    OperatorType.OP_EW_SUB,
    OperatorType.OP_EW_DIV,
    OperatorType.OP_EW_MAX,
    OperatorType.OP_EW_MIN,
    # MoE routes each token independently; the walk overrides its capacity
    # to the slab's token count, so no assignment drops and rows stay
    # independent (the JAX walk, generation.py:364-369)
    OperatorType.OP_MOE,
}


class Generator:
    """Graph walks of a decoder-only LM built on FFModel (after
    compile()): validation of the graph, prefill and paged decode."""

    def __init__(self, model, quantize: Optional[str] = None):
        if quantize not in (None, "int8", "fp8"):
            raise ValueError(f"quantize={quantize!r}: must be 'int8' or "
                             f"'fp8' (or None)")
        self.model = model
        self.quantize = quantize
        self._qparams = None
        self._qparams_key = None
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

    # ---- weight-only quantization (int8 / fp8) -----------------------------

    def _quantized_params(self):
        """The JAX ``Generator._quantized_params`` (generation.py:169-235):
        every float weight with >= 2 dims becomes {"q": int8 | float8_e4m3fn
        payload, "s": f32 scale per OUTPUT channel} — amax over the leading
        (contraction) axis only, over qmax, floored at 1e-12; the quotient
        is clipped to +-qmax before the cast and rounded half to even for
        int8. 1-D weights (norm scales, biases) stay exact. Built once per
        params tree (keyed by the identity of its tensors)."""
        src = self.model.params
        key = tuple(id(t) for ws in src.values() for t in ws.values())
        if self._qparams is not None and self._qparams_key == key:
            return self._qparams
        qdtype = torch.float8_e4m3fn if self.quantize == "fp8" else torch.int8
        qmax = storage_qmax(qdtype)
        out = {}
        for op_name, ws in src.items():
            q_ws = {}
            for w_name, w in ws.items():
                if w.dim() >= 2 and w.dtype.is_floating_point:
                    wf = w.float()
                    scale = torch.clamp_min(_divide(
                        wf.abs().amax(dim=0, keepdim=True), qmax), 1e-12)
                    q = torch.clamp(wf / scale, -qmax, qmax)
                    if qdtype == torch.int8:
                        q = torch.round(q)
                    q_ws[w_name] = {"q": q.to(qdtype), "s": scale}
                else:
                    q_ws[w_name] = w
            out[op_name] = q_ws
        self._qparams, self._qparams_key = out, key
        return out

    @staticmethod
    def _deq(v, cdtype: torch.dtype):
        """A quantized weight back in the compute dtype (f32 product, then
        the cast: the JAX ``_deq``); anything else as it is."""
        if isinstance(v, dict) and "q" in v:
            return (v["q"].float() * v["s"]).to(cdtype)
        return v

    def params(self):
        """The tree the walks read: the model's weights, or their quantized
        form."""
        return self._quantized_params() if self.quantize \
            else self.model.params

    def _op_params(self, op, params, xs, cdtype):
        """``op``'s weights for one use, dequantized where quantized, tied
        ones taken from their source (the JAX walk, generation.py:
        298-306: a quantized source is dequantized, then transformed). An
        embedding lookup gathers the quantized rows first and dequantizes
        only those (elementwise, so the values are those of the dequantized
        table) instead of the whole table: the walk then computes it here,
        and the op is skipped (the second value is its output)."""
        p = params.get(op.name, {})
        if not self.quantize:
            return resolve_tied_params(self.model, params, op.name, p), None
        w = p.get("kernel")
        if op.op_type == OperatorType.OP_EMBEDDING and isinstance(w, dict):
            rows = kernels.take_pages(w["q"], xs[0].long())
            return p, (rows.float() * w["s"][0]).to(cdtype)
        deq = lambda v: self._deq(v, cdtype)  # noqa: E731
        return resolve_tied_params(self.model, params, op.name,
                                   {k: deq(v) for k, v in p.items()},
                                   leaf=deq), None

    # ---- graph walks -------------------------------------------------------

    def _walk(self, params, tokens, caches, last_only=False,
              row_lengths=None, paged: Optional[Dict] = None,
              chunk_start: Optional[int] = None, skip_tail: bool = False,
              gather_last: bool = False):
        """Interpret the graph on a (B, S) token slab. By default this is
        the whole-prompt prefill (positions 0..S-1, fills ``caches``);
        ``chunk_start`` prefills positions chunk_start.. behind what the
        caches already hold; ``gather_last`` queries each row's last prompt
        token (a (B, 1) slab at position ``row_lengths`` - 1) read-only
        against the caches; with ``paged``, a (B, 1) decode step over the
        paged pool. ``skip_tail`` stops after the last attention op (a
        cache-only pass; no logits). ``last_only`` narrows the prefill
        tail: past the last attention op only each row's last valid
        position (``row_lengths`` - 1, or column -1) flows through, so the
        lm_head never sees the pad positions and no (B, S, V) logits are
        made."""
        s_full = tokens.shape[1]
        vals = {self.token_input.outputs[0]: tokens}
        new_caches = {}
        cdtype = self._compute_dtype()
        # every attention op of one walk rotates the same positions and
        # (decoding) writes the same pool rows: derive those once, here
        first = self.attn_ops[0]
        rope_key = (first.rope_theta, first.qk_head_dim)
        rope = slot = None
        if paged is not None:
            offset = paged["rope_pos"]
        elif gather_last:
            offset = row_lengths - 1
        else:
            offset = chunk_start or 0
        if first.rope:
            rope = rope_tables(first.rope_theta, s_full, first.qk_head_dim,
                               offset, tokens.device)
        if paged is not None:
            slot = paged_slot(paged["page_table"], paged["write_pos"],
                              caches[first.name]["k"].shape[1])
        for idx, op in enumerate(self.model.ops):
            if isinstance(op, InputOp):
                continue
            if skip_tail and idx > self._last_attn_idx:
                return None, new_caches
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
            p, looked_up = self._op_params(op, params, xs, cdtype)
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
                elif gather_last:
                    out, nc = op.query_forward(p, xs, cache, row_lengths - 1,
                                               row_lengths, rope=r)
                elif chunk_start is not None:
                    out, nc = op.chunk_forward(p, xs, cache, chunk_start,
                                               rope=r)
                else:
                    out, nc = op.prefill_forward(p, xs, cache, rope=r)
                new_caches[op.name] = nc
                outs = [out]
            elif looked_up is not None:
                outs = [looked_up]
            elif op.op_type == OperatorType.OP_MOE:
                outs = op.forward(p, xs,
                                  capacity=math.prod(xs[0].shape[:-1]))
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
