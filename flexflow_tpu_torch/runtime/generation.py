"""Graph walks for KV-cache generation (the JAX package's
``runtime/generation.py`` ``Generator``, the parts serving runs).

The JAX package jits one program per shape; the port runs the same walk
eagerly. ``_walk`` interprets the op graph on a (B, S) token slab:
whole-prompt prefill into a contiguous per-request cache, a prompt chunk
behind a cached prefix (``chunk_start=``) and the read-only query of the
prompt's last token (``gather_last=``) — a prefix-cache hit's two passes —
one continuous-batching decode step over the paged pool (``paged=``), or
a speculative verify slab of K + 1 positions a slot over it.
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
import weakref
from typing import Dict, Optional

import torch

from flexflow_tpu_torch.ffconst import DataType, OperatorType
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.attention import (MultiHeadAttention, _divide,
                                              paged_slot, rope_tables,
                                              storage_qmax)
from flexflow_tpu_torch.ops.base import InputOp
from flexflow_tpu_torch.ops.lora import gather_op_lora
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


class ServedWeights:
    """What a model's own weight tensors hold for the engines built on it.
    The captured decode programs read model.params at fixed addresses, so
    a native-width weight swap writes into them: the swap is the model's,
    not one engine's. Kept here: the version the tensors hold (None for
    the construction weights), the construction weights a standing swap
    displaced (host memory), and every Generator reading the tensors
    (weakly: a released engine drops out)."""

    def __init__(self):
        self.version = None
        self.backup = None
        self.readers = weakref.WeakSet()


def served_weights(model) -> ServedWeights:
    """``model``'s ServedWeights, made on first use."""
    sw = getattr(model, "_served_weights", None)
    if sw is None:
        sw = model._served_weights = ServedWeights()
    return sw


def _host_copy(tree):
    return {op: {w: t.to("cpu", copy=True) for w, t in ws.items()}
            for op, ws in tree.items()}


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
        # a quantized tier's weight swap (set_params): the tree its buffers
        # are quantized from instead of model.params
        self._params_override = None
        self._override_version = 0
        self.served = served_weights(model)
        self.served.readers.add(self)
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
        int8. 1-D weights (norm scales, biases) stay exact, as copies.

        The tree is built once and then only ever rewritten in place: the
        captured decode programs hold its tensors' addresses. When the
        source changes — ``set_params`` (a weight swap), or tensors of
        model.params rebound — the same buffers are re-quantized from it."""
        src = self._source_params()
        key = (self._override_version,
               tuple(id(t) for ws in src.values() for t in ws.values()))
        if self._qparams is not None and self._qparams_key == key:
            return self._qparams
        with torch.no_grad():
            self._qparams = self._quantize_into(src, self._qparams)
        self._qparams_key = key
        return self._qparams

    def _quantize_into(self, src, out):
        """Quantize ``src`` into the tree ``out`` in place, or into a new
        tree when ``out`` is None."""
        qdtype = torch.float8_e4m3fn if self.quantize == "fp8" else torch.int8
        qmax = storage_qmax(qdtype)
        build = out is None
        out = {} if build else out
        dev = self.model.device
        for op_name, ws in src.items():
            q_ws = out.setdefault(op_name, {})
            for w_name, w in ws.items():
                w = w.to(dev)   # a source in host memory: the backup
                if w.dim() >= 2 and w.dtype.is_floating_point:
                    wf = w.float()
                    scale = torch.clamp_min(_divide(
                        wf.abs().amax(dim=0, keepdim=True), qmax), 1e-12)
                    q = torch.clamp(wf / scale, -qmax, qmax)
                    if qdtype == torch.int8:
                        q = torch.round(q)
                    new = {"q": q.to(qdtype), "s": scale}
                    if build:
                        q_ws[w_name] = new
                    else:
                        for part in ("q", "s"):
                            q_ws[w_name][part].copy_(new[part])
                elif build:
                    q_ws[w_name] = w.clone() if w is ws[w_name] else w
                else:
                    q_ws[w_name].copy_(w)
        return out

    def _source_params(self):
        """The weights a quantized tier is built from: its swapped-in tree,
        else model.params."""
        if self._params_override is not None:
            return self._params_override
        return self.model.params

    def restore_point(self):
        """What ``set_params`` takes to put back the weights served now:
        a quantized tier's source tree; at native width None (the
        construction weights) or, while a swap stands, a host copy of
        model.params."""
        if self.quantize:
            return self._params_override
        if self.served.backup is None:
            return None
        with torch.no_grad():
            return _host_copy(self.model.params)

    def set_params(self, tree):
        """Install (or, with ``tree=None``, clear) a weight swap: ``tree``
        must match model.params op by op, shapes and dtypes included. The
        decode programs are CUDA graphs holding the served tensors'
        addresses, so the swap writes in place. A quantized tier re-
        quantizes its own buffers from ``tree`` (``None``: from the
        construction weights). At native width the served tensors are
        model.params's own (a private copy would double the weights'
        memory): the new weights are copied into them, the construction
        weights wait in host memory (``served``, the model's) until
        ``set_params(None)`` writes them back, and no reference to
        ``tree`` is kept. Every Generator on the model then serves them:
        the engine refuses such a swap while another one reads them."""
        ref = self.model.params
        if tree is not None:
            if set(tree) != set(ref) or any(
                    set(tree[op]) != set(ref[op]) for op in ref):
                raise ValueError(
                    "set_params: tree structure differs from model.params "
                    "— a weight swap must be same-geometry")
            for op, ws in ref.items():
                for w, t in ws.items():
                    new = tree[op][w]
                    if tuple(new.shape) != tuple(t.shape) \
                            or new.dtype != t.dtype:
                        raise ValueError(
                            f"set_params: leaf geometry mismatch {op}.{w}: "
                            f"{tuple(t.shape)}/{t.dtype} vs "
                            f"{tuple(new.shape)}/{new.dtype}")
        self._override_version += 1
        if self.quantize:
            self._params_override = (tree if tree is not None
                                     else self.served.backup)
            return
        sw = self.served
        with torch.no_grad():
            if tree is not None and sw.backup is None:
                sw.backup = _host_copy(ref)
            src = tree if tree is not None else sw.backup
            if src is not None:
                for op, ws in ref.items():
                    for w, t in ws.items():
                        t.copy_(src[op][w])
        if tree is None:
            sw.backup = None

    @staticmethod
    def _deq(v, cdtype: torch.dtype):
        """A quantized weight back in the compute dtype (f32 product, then
        the cast: the JAX ``_deq``); anything else as it is."""
        if isinstance(v, dict) and "q" in v:
            return (v["q"].float() * v["s"]).to(cdtype)
        return v

    def params(self):
        """The tree the walks read: the model's weights (a native swap
        writes into them), or their quantized form."""
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
              gather_last: bool = False, lora: Optional[Dict] = None):
        """Interpret the graph on a (B, S) token slab. By default this is
        the whole-prompt prefill (positions 0..S-1, fills ``caches``);
        ``chunk_start`` prefills positions chunk_start.. behind what the
        caches already hold; ``gather_last`` queries each row's last prompt
        token (a (B, 1) slab at position ``row_lengths`` - 1) read-only
        against the caches; with ``paged``, a (B, 1) decode step over the
        paged pool, or a (B, S) verify slab (``paged["write_pos"]`` (B, S)).
        ``skip_tail`` stops after the last attention op (a
        cache-only pass; no logits). ``last_only`` narrows the prefill
        tail: past the last attention op only each row's last valid
        position (``row_lengths`` - 1, or column -1) flows through, so the
        lm_head never sees the pad positions and no (B, S, V) logits are
        made. ``lora`` ({"pool", "pages"}: the adapter pool and each row's
        page) adds each row's gathered LoRA delta to every targeted Linear
        (the JAX walk, generation.py:356-365)."""
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
                    # a (B, S > 1) slab is the speculative verify pass:
                    # write_pos is (B, S), a frontier a position
                    fwd = (op.paged_verify_forward if s_full > 1
                           else op.paged_decode_forward)
                    out, nc = fwd(
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
            elif (lora is not None and op.op_type == OperatorType.OP_LINEAR
                  and op.name in lora["pool"]):
                outs = op.forward(p, xs, lora=gather_op_lora(
                    lora["pool"], op.name, lora["pages"]))
            else:
                outs = op.forward(p, xs)
            for i, t in enumerate(op.outputs):
                vals[t] = outs[i]
        return vals[self.model._final_tensor], new_caches

    def _prefill(self, params, tokens, caches, row_lengths,
                 prefill_chunk: int = 0, lora: Optional[Dict] = None):
        """Prefill (the JAX ``_prefill``, generation.py:383-420): logits
        (B, 1, V) at each row's last valid position, and the filled
        caches. Whole-prompt through the flash kernel, or, with
        ``prefill_chunk`` > 0 and a longer prompt, chunked: every chunk
        runs cache-only through ``chunk_forward`` (a ragged row's last
        position may fall in any chunk), then a read-only query of each
        row's last prompt token scores it (``query_forward``)."""
        s0 = tokens.shape[1]
        if not prefill_chunk or s0 <= prefill_chunk:
            return self._walk(params, tokens, caches, last_only=True,
                              row_lengths=row_lengths, lora=lora)
        for st in range(0, s0, prefill_chunk):
            _, caches = self._walk(params, tokens[:, st:st + prefill_chunk],
                                   caches, chunk_start=st, skip_tail=True,
                                   lora=lora)
        tok_last = torch.gather(tokens, 1, (row_lengths.long() - 1)[:, None])
        return self._walk(params, tok_last, caches, last_only=True,
                          row_lengths=row_lengths, gather_last=True,
                          lora=lora)
