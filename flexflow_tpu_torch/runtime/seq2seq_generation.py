"""Encoder-decoder (seq2seq) generation with a KV-cached decoder (the JAX
package's ``runtime/seq2seq_generation.py``).

The encoder runs once on the source, each cross-attention's k/v are
projected once from the encoder states (``MultiHeadAttention.encode_kv``),
and the decoder runs the decoder-only path's loop (``runtime/
generation.py``): an eager prefill of the target prompt, then one (B, 1)
decode step — a KV cache on the decoder's self-attention, the static k/v
on its cross-attention — captured as a CUDA graph on the card and replayed
``max_new_tokens - 1`` times. A token costs attention reads of the target
prefix and the source, never a re-encode.

Scope (the JAX package's): greedy and temperature / top-k sampling with
eos / pad handling; uniform-length source batches; no beam, no quantized
weights.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Optional

import numpy as np
import torch

from flexflow_tpu_torch.ffconst import DataType, OperatorType
from flexflow_tpu_torch.ops.attention import MultiHeadAttention
from flexflow_tpu_torch.ops.base import InputOp
from flexflow_tpu_torch.runtime.executor import resolve_tied_params
from flexflow_tpu_torch.runtime.generation import (_DECODE_SAFE, Generator,
                                                   _leaf_addresses, _Loop,
                                                   _to_compute)


class Seq2SeqGenerator:
    """Generate programs for an encoder-decoder graph.

    Graph contract (the JAX package's): exactly two inputs — a source and
    an int32 / int64 target-token input; the target stream's
    self-attentions are causal; a cross-attention takes q from the decoder
    stream and k = v = an encoder-side tensor, non-causal and rope-free
    (``models.transformer.seq2seq_lm``'s layout). Encoder ops may be
    anything the forward path runs; the decoder's other ops must be
    per-position (``_DECODE_SAFE``)."""

    #: on the card the decode step is always a CUDA graph
    capture = True

    def __init__(self, model, temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None, pad_id: int = 0):
        self.model = model
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.eos_id = eos_id
        self.pad_id = pad_id
        self._programs: Dict = collections.OrderedDict()
        self.last_decode_steps = 0
        inputs = [op for op in model.ops if isinstance(op, InputOp)]
        if len(inputs) != 2:
            raise ValueError(
                f"generate_seq2seq() needs exactly two graph inputs "
                f"(source, target tokens); this graph has {len(inputs)}")
        # the decoder stream is whatever depends on the target input; try
        # each int input as the target and keep the first partition whose
        # decoder self-attentions are all causal
        int_inputs = [op for op in inputs
                      if op.outputs[0].dtype in (DataType.DT_INT32,
                                                 DataType.DT_INT64)]
        if not int_inputs:
            raise ValueError(
                "generate_seq2seq() needs an integer target-token input")
        chosen = None
        for tgt in int_inputs:
            part = self._partition(model, tgt)
            if part is not None:
                chosen = (tgt, part)
                break
        if chosen is None:
            raise ValueError(
                "no input yields a decodable decoder stream (causal "
                "self-attention downstream of an int token input)")
        self.tgt_input, (self.enc_ops, self.dec_ops, self.self_ops,
                         self.cross_ops) = chosen
        self.src_input = next(op for op in inputs
                              if op is not self.tgt_input)
        # encoder tensors the decoder reads (the cross k/v sources and any
        # other boundary value)
        dec_set = set(self.dec_ops)
        self.boundary = []
        for op in self.dec_ops:
            for t in op.inputs:
                if (t.owner_op is not None and t.owner_op not in dec_set
                        and not isinstance(t.owner_op, InputOp)
                        and t not in self.boundary):
                    self.boundary.append(t)

    @staticmethod
    def _partition(model, tgt_input):
        """(encoder ops, decoder ops, self-attentions, cross-attentions)
        with ``tgt_input`` as the decoder's token stream; None when the
        split breaks the decode contract."""
        dec_tensors = {tgt_input.outputs[0]}
        enc_ops, dec_ops, self_ops, cross_ops = [], [], [], []
        for op in model.ops:
            if isinstance(op, InputOp):
                continue
            if not any(t in dec_tensors for t in op.inputs):
                enc_ops.append(op)
                continue
            dec_ops.append(op)
            dec_tensors.update(op.outputs)
            if isinstance(op, MultiHeadAttention):
                if op.inputs[0] is op.inputs[1] is op.inputs[2]:
                    if not op.causal:
                        return None   # bidirectional self-attention
                    self_ops.append(op)
                else:
                    # cross: q from the decoder, k = v an encoder tensor
                    if op.inputs[1] is not op.inputs[2]:
                        return None
                    if op.inputs[1] in dec_tensors or op.causal or op.rope:
                        return None
                    cross_ops.append(op)
            elif op.op_type not in _DECODE_SAFE:
                return None
        if not self_ops:
            return None
        return enc_ops, dec_ops, self_ops, cross_ops

    # ---- walks -------------------------------------------------------------

    def _params_for(self, params, op):
        p = resolve_tied_params(self.model, params, op.name,
                                params.get(op.name, {}))
        cdtype = self._compute_dtype()
        return p if cdtype == torch.float32 else _to_compute(p, cdtype)

    def _run_op(self, op, p, xs):
        if op.stateful:
            outs, _ = op.forward_stateful(p, self.model.bn_state[op.name], xs)
            return outs
        if op.op_type == OperatorType.OP_MOE:
            return op.forward(p, xs, capacity=math.prod(xs[0].shape[:-1]))
        return op.forward(p, xs)

    def _encode(self, params, src):
        """One forward over the encoder ops: {tensor: value} of the
        boundary tensors the decoder reads."""
        cdtype = self._compute_dtype()
        if src.is_floating_point() and src.dtype != cdtype:
            src = src.to(cdtype)
        vals = {self.src_input.outputs[0]: src}
        for op in self.enc_ops:
            outs = self._run_op(op, self._params_for(params, op),
                                [vals[t] for t in op.inputs])
            for t, v in zip(op.outputs, outs):
                vals[t] = v
        return {t: vals[t] for t in self.boundary}

    def _dec_walk(self, params, toks, enc_vals, self_caches, cross_kvs,
                  pos: Optional[torch.Tensor]):
        """The decoder ops on a (B, C) token slab: ``pos`` None is the
        prefill (fills the self-attention caches causally), else C == 1 and
        ``pos`` (a 0-dim device tensor) is the cache slot. Cross-attention
        always reads the static k/v."""
        vals = dict(enc_vals)
        vals[self.tgt_input.outputs[0]] = toks
        for op in self.dec_ops:
            p = self._params_for(params, op)
            xs = [vals[t] for t in op.inputs]
            if op in self.self_ops:
                cache = self_caches[op.name]
                if pos is None:
                    out, _ = op.prefill_forward(p, xs, cache)
                else:
                    out, _ = op.decode_forward(p, xs, cache, pos)
                outs = [out]
            elif op in self.cross_ops:
                outs = [op.cross_forward_cached(p, xs, cross_kvs[op.name])]
            else:
                outs = self._run_op(op, p, xs)
            for t, v in zip(op.outputs, outs):
                vals[t] = v
        return vals[self.model._final_tensor]

    # ---- sampling, dtype, key streams and the program LRU: the decoder-
    # only Generator's, so the two paths cannot drift (as in JAX)
    _sample = Generator._sample
    _warp = Generator._warp
    _compute_dtype = Generator._compute_dtype
    _cached_program = Generator._cached_program
    _program = Generator._program
    _row_keys = Generator._row_keys
    _draw_keys = staticmethod(Generator._draw_keys)

    # ---- the program -------------------------------------------------------

    def _build(self, src_shape, tgt_shape, max_new_tokens: int,
               params) -> _Loop:
        """The program of one key (the JAX ``_build``): static self-
        attention caches for t0 + max_new_tokens positions, static encoder
        values and cross k/v (filled by each call's eager encode), the
        decode step and ``run``."""
        dev = self.model.device
        cdtype = self._compute_dtype()
        b, t0 = tgt_shape
        i64 = dict(dtype=torch.int64, device=dev)
        caches = {op.name: op.init_cache(b, t0 + max_new_tokens, cdtype, dev)
                  for op in self.self_ops}
        st = dict(tok=torch.zeros(b, **i64),
                  done=torch.zeros(b, dtype=torch.bool, device=dev),
                  i=torch.zeros((), **i64), rows=torch.zeros(b, **i64),
                  buf=torch.zeros((b, max_new_tokens), **i64))
        static = {}     # the encoder values and cross k/v, made by run
        eos, pad = self.eos_id, self.pad_id
        sampled = self.temperature > 0.0

        def step():
            i = st["i"]
            logits = self._dec_walk(self.model.params, st["tok"][:, None],
                                    static["enc"], caches, static["kv"],
                                    t0 + i)
            nxt, _ = self._sample(logits[:, 0], self._draw_keys(
                st["rows"] if sampled else None, i + 1))
            if eos is not None:
                done = st["done"]
                nxt = torch.where(done, pad, nxt)
                done |= nxt == eos
            st["buf"].index_copy_(1, (i + 1).reshape(1), nxt[:, None])
            st["tok"].copy_(nxt)
            i.add_(1)

        loop = _Loop(self, step, st, _leaf_addresses(params))
        prog = loop.step

        def run(params, src, tgt, seed):
            enc = self._encode(params, src)
            kv = {op.name: op.encode_kv(self._params_for(params, op),
                                        enc[op.inputs[1]])
                  for op in self.cross_ops}
            if not static:
                static["enc"] = {t: v.clone() for t, v in enc.items()}
                static["kv"] = {n: {k: x.clone() for k, x in d.items()}
                                for n, d in kv.items()}
            else:
                for t, v in enc.items():
                    static["enc"][t].copy_(v)
                for n, d in kv.items():
                    for k, x in d.items():
                        static["kv"][n][k].copy_(x)
            logits = self._dec_walk(params, tgt, static["enc"], caches,
                                    static["kv"], None)
            rows = self._row_keys(seed, b)
            tok, _ = self._sample(logits[:, -1], self._draw_keys(rows, 0))
            if rows is not None:
                st["rows"].copy_(rows)
            st["tok"].copy_(tok)
            st["done"].copy_(tok == eos if eos is not None
                             else torch.zeros_like(st["done"]))
            st["i"].zero_()
            st["buf"].fill_(pad)
            st["buf"][:, 0] = tok
            for _ in range(max_new_tokens - 1):
                prog()
            self.last_decode_steps = max_new_tokens - 1
            return torch.cat([tgt, st["buf"]], dim=1)

        loop.run = run
        return loop

    @torch.inference_mode()
    def __call__(self, src_tokens, tgt_prompt, max_new_tokens: int,
                 seed: int = 0):
        """(B, S_src) source and (B, T0) target prompt -> (B, T0 +
        max_new_tokens) int32."""
        dev = self.model.device
        src = torch.as_tensor(np.asarray(src_tokens), device=dev)
        if not src.is_floating_point():
            src = src.long()
        tgt = torch.as_tensor(np.asarray(tgt_prompt, np.int32),
                              dtype=torch.int64, device=dev)
        params = self.model.params
        key = ("s2s", max_new_tokens, tuple(src.shape), tuple(tgt.shape))
        loop = self._program(key, lambda: self._build(
            tuple(src.shape), tuple(tgt.shape), max_new_tokens, params),
            params)
        out = loop.run(params, src, tgt, seed)
        return out.to(torch.int32).cpu().numpy()
