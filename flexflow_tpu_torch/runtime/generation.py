"""KV-cache generation (the JAX package's ``runtime/generation.py``
``Generator``): ``FFModel.generate``'s static-cache decode loop and beam
search, and the graph walks the serving engine runs.

``_walk`` interprets the op graph on a (B, S) token slab: whole-prompt
prefill into a contiguous per-request cache, a prompt chunk behind a
cached prefix (``chunk_start=``) and the read-only query of the prompt's
last token (``gather_last=``) — a prefix-cache hit's two passes —, one
``generate`` decode step over the static cache (``pos=``), one
continuous-batching decode step over the paged pool (``paged=``), or a
speculative verify slab of K + 1 positions a slot over it. A MoE layer
runs at capacity = the slab's token count, as in the JAX walk: no token
drops, so each row's output is its own.

``generate`` (``__call__`` and ``beam_search``): the JAX package jits one
program per key, prefill then a ``lax.scan`` / ``while_loop`` of decode
steps. Here a program (``_Loop``) owns its static caches and loop state;
the prefill runs eagerly into them, and one (B, 1) decode step — the
cache write at ``pos``, the mask, the sampler, the token buffers — reads
every position from device tensors, so on the card it is captured once as
a CUDA graph and replayed ``max_new_tokens - 1`` times (on the CPU the
same step runs eagerly). Beam search reorders the caches in place by
beam parent under the graph. Programs are kept in an LRU bounded by
``FF_GEN_PROGRAM_CACHE`` (default 8); an evicted program's graph and
buffers are freed.

Sampling draws with the serving engine's counter-based Gumbel-max
(``ops/sampling.py``): draw n of row b is a pure function of (seed, b,
n), the same bits on the CPU and the card, and a graph captures it with
no generator state. JAX's threefry stream is not reproduced; sampled
tokens are checked by distribution.

Weight-only quantization (``quantize='int8'`` / ``'fp8'``): every float
weight with two or more dims is stored once as a quantized payload with
per-output-channel f32 scales (``_quantized_params``) and dequantized per
use (``_deq``), as the JAX package does; the matrix products stay
``torch.matmul``.
"""

from __future__ import annotations

import collections
import itertools
import logging
import math
import os
import weakref
from typing import Dict, Optional

import numpy as np

import torch

from flexflow_tpu_torch.ffconst import DataType, OperatorType
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops import sampling
from flexflow_tpu_torch.ops.attention import (MultiHeadAttention, _divide,
                                              paged_slot, rope_tables,
                                              storage_qmax)
from flexflow_tpu_torch.ops.base import InputOp
from flexflow_tpu_torch.ops.lora import gather_op_lora
from flexflow_tpu_torch.runtime.executor import resolve_tied_params

log = logging.getLogger(__name__)

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


class WeightSet:
    """One weight version's device tensors, allocated once and shared by
    every engine swapped to that version (the JAX deployer's one committed
    tree): ``tree`` mirrors model.params, ``readers`` are the Generators
    serving it (weakly), and ``serial`` — never reused — keys the programs
    captured against its addresses."""

    _serials = itertools.count(1)

    def __init__(self, version: str, tree):
        self.version = version
        self.tree = tree
        self.serial = next(WeightSet._serials)
        self.readers = weakref.WeakSet()

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for ws in self.tree.values() for t in ws.values())


class ServedWeights:
    """What a model's weights are for the engines built on it. Kept here:
    the version model.params holds (None for the construction weights),
    the construction weights a standing in-place swap displaced (host
    memory), every Generator reading the model (weakly: a released engine
    drops out), and the per-version ``WeightSet``s a native swap installs
    on an engine whose model other readers share. A set is freed when its
    last reader leaves it (``sweep``)."""

    def __init__(self):
        self.version = None
        self.backup = None
        self.readers = weakref.WeakSet()
        self.sets: Dict[str, WeightSet] = {}

    def acquire(self, version: str, tree, model) -> WeightSet:
        """The live set of ``version`` (``tree`` is then not read: a
        version names one set of weights), or a new one copied from
        ``tree`` onto the model's device in model.params' dtypes."""
        self.sweep()
        ws = self.sets.get(version)
        if ws is None:
            with torch.no_grad():
                dev = {op: {w: torch.empty_like(t)
                            for w, t in wts.items()}
                       for op, wts in model.params.items()}
                for op, wts in dev.items():
                    for w, t in wts.items():
                        t.copy_(tree[op][w])
            ws = self.sets[version] = WeightSet(version, dev)
        return ws

    def sweep(self):
        """Free every set no Generator reads any more."""
        for v in [v for v, ws in self.sets.items() if not len(ws.readers)]:
            del self.sets[v]

    def live_sets(self) -> Dict[str, WeightSet]:
        self.sweep()
        return dict(self.sets)


def served_weights(model) -> ServedWeights:
    """``model``'s ServedWeights, made on first use."""
    sw = getattr(model, "_served_weights", None)
    if sw is None:
        sw = model._served_weights = ServedWeights()
    return sw


def _host_copy(tree):
    return {op: {w: t.to("cpu", copy=True) for w, t in ws.items()}
            for op, ws in tree.items()}


def _to_compute(p, cdtype: torch.dtype):
    """An op's weights with f32 tensors cast to the 16-bit compute dtype
    (a model compiled for training keeps f32 master weights; the JAX walk
    casts them per use the same way). ``p`` itself when none is f32."""
    if not any(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               for v in p.values()):
        return p
    return {k: v.to(cdtype) if isinstance(v, torch.Tensor)
            and v.dtype == torch.float32 else v for k, v in p.items()}


def _leaf_addresses(tree) -> tuple:
    """The data pointers of a weight tree's tensors (quantized leaves'
    payloads and scales too): what a captured decode step reads."""
    out = []
    todo = [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, dict):
            todo.extend(x[k] for k in sorted(x))
        elif isinstance(x, torch.Tensor):
            out.append(x.data_ptr())
    return tuple(out)


def _top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, ties broken
    towards the lower index as ``jax.lax.top_k`` breaks them (a stable
    descending sort; ``torch.topk`` leaves the order of ties open)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


#: the side stream generate()'s programs capture on, one a device for the
#: process (not one a program or a model): cuBLAS keeps a workspace for
#: every stream it ran on for the process's life
_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(dev: torch.device) -> "torch.cuda.Stream":
    if dev not in _STREAMS:
        _STREAMS[dev] = kernels.private_stream(dev)
    return _STREAMS[dev]


class _Clock:
    """Time on the device's current stream from construction to ``stop``:
    CUDA events on the card (``ms`` waits for the end event), nothing on
    the CPU (``ms`` is None)."""

    def __init__(self, dev: torch.device):
        self.events = None
        if dev.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()

    def stop(self) -> "_Clock":
        if self.events is not None:
            self.events[1].record()
        return self

    def ms(self) -> Optional[float]:
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


class _Loop:
    """One cached ``generate`` program: the static tensors it owns
    (``state``: caches, loop state, token buffers), its decode step and
    ``run`` (set by ``_build`` / ``_build_beam``: prefill, then the
    steps). On the card the
    step is a CUDA graph, captured at its first use on the device's side
    stream and replayed after (the serving engine's ``_Program``); on the
    CPU, and under ``capture=False``, it runs eagerly. ``addresses``: the
    weight tensors' addresses the capture holds (a weight tree rebound
    since makes the program stale)."""

    def __init__(self, generator, step, state: Dict, addresses: tuple):
        from flexflow_tpu_torch.runtime.serving import _Program

        dev = generator.model.device
        stream = (_side_stream(dev)
                  if dev.type == "cuda" and generator.capture else None)
        self.state = state
        self.step = _Program(step, state, stream)
        self.addresses = addresses
        self.run = None


class Generator:
    """Graph walks of a decoder-only LM built on FFModel (after
    compile()): validation of the graph, prefill, paged decode for the
    serving engine, and ``generate``'s programs (``__call__``,
    ``beam_search``). ``temperature`` 0 is greedy; ``top_k`` > 0 keeps
    exactly k candidates; after ``eos_id`` a row emits ``pad_id``.

    ``capture=False`` is for comparisons only: on the card generate()'s
    decode step then runs its body uncaptured, launched from the host each
    step, as the reference a test holds the CUDA graph against."""

    def __init__(self, model, temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 quantize: Optional[str] = None, capture: bool = True):
        if quantize not in (None, "int8", "fp8"):
            raise ValueError(f"quantize={quantize!r}: must be 'int8' or "
                             f"'fp8' (or None)")
        self.model = model
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.quantize = quantize
        self.capture = capture
        self._qparams = None
        self._qparams_key = None
        # a quantized tier's weight swap (set_params): the tree its buffers
        # are quantized from instead of model.params
        self._params_override = None
        self._override_version = 0
        # a native swap on a shared model: the version's WeightSet served
        # instead of model.params (None: model.params)
        self._weight_set: Optional[WeightSet] = None
        # generate()'s programs, LRU-bounded (FF_GEN_PROGRAM_CACHE)
        self._programs: Dict = collections.OrderedDict()
        # decode steps the last generate() call ran (early_exit stops short)
        # and the clock of its decode loop (last_decode_ms)
        self.last_decode_steps = 0
        self._decode_clock: Optional[_Clock] = None
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
            elif op.op_type == OperatorType.OP_SOFTMAX:
                nd = len(op.outputs[0].dims)
                if op.axis % nd != nd - 1:
                    raise ValueError(
                        f"{op.name}: softmax over a non-feature axis mixes "
                        "positions; not decodable")
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

    def _check_geometry(self, tree):
        """Refuse a tree that does not match model.params op by op, shapes
        and dtypes included."""
        ref = self.model.params
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

    def set_params(self, tree):
        """Install (or, with ``tree=None``, clear) a weight swap in place:
        ``tree`` must match model.params op by op, shapes and dtypes
        included. The decode programs are CUDA graphs holding the served
        tensors' addresses, so the swap writes into them. A quantized tier
        re-quantizes its own buffers from ``tree`` (``None``: from the
        construction weights). At native width the served tensors are
        model.params's own: the new weights are copied into them, the
        construction weights wait in host memory (``served``, the model's)
        until ``set_params(None)`` writes them back, and every Generator
        reading model.params serves them — the engine takes this path only
        as model.params' sole reader (``use_weight_set`` otherwise)."""
        ref = self.model.params
        if tree is not None:
            self._check_geometry(tree)
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

    @property
    def weights_serial(self) -> int:
        """Identity of the weights the walks read at native width: the
        WeightSet's serial, 0 for model.params."""
        return 0 if self._weight_set is None else self._weight_set.serial

    def use_weight_set(self, tree, version: str) -> Optional[WeightSet]:
        """Serve ``version``'s WeightSet (``tree=None``: model.params again,
        or — while an in-place swap stands there — a set of the
        construction weights). The set is shared with every Generator on
        ``version`` and allocated on first use. Returns the set served
        before, which this Generator still reads until
        ``leave_weight_set(prior)``; model.params is never written."""
        sw = self.served
        if tree is None and sw.version is not None:
            tree = sw.backup
        if tree is None:
            ws = None
        else:
            self._check_geometry(tree)
            ws = sw.acquire(str(version), tree, self.model)
            ws.readers.add(self)
        prior = self._weight_set
        self._weight_set = ws
        return prior

    def leave_weight_set(self, ws: Optional[WeightSet]):
        """Stop reading ``ws`` (unless it is the set served now); the set
        is freed when no Generator reads it."""
        if ws is not None and ws is not self._weight_set:
            ws.readers.discard(self)
            self.served.sweep()

    @staticmethod
    def _deq(v, cdtype: torch.dtype):
        """A quantized weight back in the compute dtype (f32 product, then
        the cast: the JAX ``_deq``); anything else as it is."""
        if isinstance(v, dict) and "q" in v:
            return (v["q"].float() * v["s"]).to(cdtype)
        return v

    @property
    def last_decode_ms(self) -> Optional[float]:
        """Device time of the last generate() call's decode loop, its
        steps alone (CUDA events on the stream around them: the graph's
        replays, or the eager body's launches and the gaps between them);
        None on the CPU and before a call."""
        return None if self._decode_clock is None \
            else self._decode_clock.ms()

    def params(self):
        """The tree the walks read: the model's weights (an in-place swap
        writes into them), a swapped-in WeightSet's, or their quantized
        form."""
        if self.quantize:
            return self._quantized_params()
        if self._weight_set is not None:
            return self._weight_set.tree
        return self.model.params

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
              gather_last: bool = False, lora: Optional[Dict] = None,
              pos: Optional[torch.Tensor] = None,
              rope_pos: Optional[torch.Tensor] = None,
              prompt_len: Optional[int] = None):
        """Interpret the graph on a (B, S) token slab. By default this is
        the whole-prompt prefill (positions 0..S-1, fills ``caches``);
        ``chunk_start`` prefills positions chunk_start.. behind what the
        caches already hold; ``gather_last`` queries each row's last prompt
        token (a (B, 1) slab at position ``row_lengths`` - 1) read-only
        against the caches; with ``pos`` (a 0-dim device tensor), a (B, 1)
        ``generate`` decode step writing slot ``pos`` of the static caches
        (``decode_forward``: RoPE at ``rope_pos`` (B,) if given, ragged rows
        masked by ``row_lengths`` and the padded width ``prompt_len``);
        with ``paged``, a (B, 1) decode step over the
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
        elif pos is not None:
            offset = pos if rope_pos is None else rope_pos
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
            if (last_only and paged is None and pos is None
                    and idx > self._last_attn_idx and s_full > 1):
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
            if cdtype != torch.float32:
                p = _to_compute(p, cdtype)
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
                elif pos is not None:
                    out, nc = op.decode_forward(
                        p, xs, cache, pos, rope_pos=rope_pos,
                        row_lengths=row_lengths, prompt_len=prompt_len,
                        rope=r)
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
        """Prefill (the JAX ``_prefill``, generation.py:383-422): logits
        (B, 1, V) at each row's last valid position, and the filled
        caches. Whole-prompt through the flash kernel, or, with
        ``prefill_chunk`` > 0 and a longer prompt, chunked. Ragged rows
        (``row_lengths`` given): every chunk runs cache-only through
        ``chunk_forward`` (a row's last position may fall in any chunk),
        then a read-only query of each row's last prompt token scores it
        (``query_forward``). Uniform rows: the last chunk runs the tail on
        its final position (``last_only``)."""
        s0 = tokens.shape[1]
        if not prefill_chunk or s0 <= prefill_chunk:
            return self._walk(params, tokens, caches, last_only=True,
                              row_lengths=row_lengths, lora=lora)
        starts = list(range(0, s0, prefill_chunk))
        ragged = row_lengths is not None
        for st in (starts if ragged else starts[:-1]):
            _, caches = self._walk(params, tokens[:, st:st + prefill_chunk],
                                   caches, chunk_start=st, skip_tail=True,
                                   lora=lora)
        if not ragged:
            return self._walk(params, tokens[:, starts[-1]:], caches,
                              last_only=True, chunk_start=starts[-1],
                              lora=lora)
        tok_last = torch.gather(tokens, 1, (row_lengths.long() - 1)[:, None])
        return self._walk(params, tok_last, caches, last_only=True,
                          row_lengths=row_lengths, gather_last=True,
                          lora=lora)

    # ---- sampling ----------------------------------------------------------

    def _row_keys(self, seed: int, b: int) -> Optional[torch.Tensor]:
        """(B,) int64 stream keys of a sampled call: row b's is a hash of
        (seed, b), so rows draw independently. None when greedy."""
        if self.temperature <= 0.0:
            return None
        dev = self.model.device
        return sampling.slot_keys(
            torch.full((b,), int(seed), dtype=torch.int64, device=dev),
            torch.arange(b, dtype=torch.int64, device=dev),
            sampling.TAG_TARGET)

    @staticmethod
    def _draw_keys(rows: Optional[torch.Tensor], n) -> Optional[torch.Tensor]:
        """The (B,) keys of draw ``n`` (the new token's index: 0 for the
        prefill's token; an int or a device tensor) of each row's stream."""
        if rows is None:
            return None
        return sampling.slot_keys(rows, torch.as_tensor(n, device=rows.device)
                                  .expand(rows.shape[0]),
                                  sampling.TAG_TARGET)

    def _warp(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, V) f32 logits -> the sampled distribution's logits: over the
        temperature, and with ``top_k`` > 0 exactly k of them kept, the
        rest -inf. The keep-set is the serving sampler's
        (``sampling._masked_warped`` at top_p above 1, which keeps every
        token): the k first of a stable descending sort, as JAX scatters
        ``lax.top_k``'s indices, which break ties towards the lower index,
        never the threshold compare that keeps every tie.
        ``top_k >= vocab`` is a no-op that warns once."""
        vocab = logits.shape[-1]
        top_k = self.top_k
        if top_k >= vocab:
            if not getattr(self, "_warned_topk", False):
                log.warning("top_k=%d >= vocab %d; treating as top_k=0 "
                            "(full-distribution sampling)", top_k, vocab)
                self._warned_topk = True
            top_k = 0
        rows = logits.shape[0]

        def per_row(x, dtype):
            return torch.full((rows,), x, dtype=dtype, device=logits.device)

        return sampling._masked_warped(
            logits, per_row(self.temperature, torch.float32),
            per_row(2.0, torch.float32), per_row(top_k, torch.int64))

    def _sample(self, logits, key, with_score: bool = False):
        """logits (B, V) -> (token (B,) int64, logp (B,) f32 or None) — the
        JAX ``_sample`` (generation.py:426). Greedy at temperature 0
        (``argmax`` of f32, the first maximum); otherwise one Gumbel-max
        draw a row from ``_warp``'s logits with the (B,) ``key``s
        (``_draw_keys``). The score is the model's log-probability of the
        token, ``log_softmax`` of the raw f32 logits whatever the warp,
        computed only when asked for."""
        logits = logits.float()
        if self.temperature <= 0.0:
            tok = torch.argmax(logits, dim=-1)
        else:
            tok = sampling._categorical(key, self._warp(logits))
        if not with_score:
            return tok, None
        logp = torch.log_softmax(logits, dim=-1)
        return tok, torch.gather(logp, -1, tok[:, None])[:, 0]

    # ---- generate()'s programs ---------------------------------------------

    def _build(self, b: int, s0: int, max_new_tokens: int, ragged: bool,
               prefill_chunk: int, with_scores: bool, early_exit: bool,
               params) -> _Loop:
        """The program of one key (the JAX ``_build``, generation.py:468):
        static caches for s0 + max_new_tokens positions, the decode step
        (``step``: one (B, 1) walk at ``pos = s0 + i``, the sampler, the
        eos rule — a done row emits ``pad_id`` at score 0 —, the token
        written into column i + 1 of the buffers, i advanced; every
        position a device tensor) and ``run``: the eager prefill and first
        token, then the step max_new_tokens - 1 times, or with
        ``early_exit`` until every row is done (``done`` is read on the
        host before each step: the skipped steps would only append pads,
        so the tokens are the full loop's)."""
        dev = self.model.device
        cdtype = self._compute_dtype()
        i64 = dict(dtype=torch.int64, device=dev)
        caches = {op.name: op.init_cache(b, s0 + max_new_tokens, cdtype, dev)
                  for op in self.attn_ops}
        st = dict(tok=torch.zeros(b, **i64),
                  done=torch.zeros(b, dtype=torch.bool, device=dev),
                  i=torch.zeros((), **i64), lengths=torch.zeros(b, **i64),
                  rows=torch.zeros(b, **i64),
                  buf=torch.zeros((b, max_new_tokens), **i64),
                  sbuf=torch.zeros((b, max_new_tokens), dtype=torch.float32,
                                   device=dev))
        eos, pad = self.eos_id, self.pad_id
        sampled = self.temperature > 0.0

        def step():
            i = st["i"]
            rl = st["lengths"] if ragged else None
            logits, _ = self._walk(
                self.params(), st["tok"][:, None], caches, pos=s0 + i,
                rope_pos=(rl + i) if ragged else None, row_lengths=rl,
                prompt_len=s0)
            nxt, sc = self._sample(
                logits[:, 0], self._draw_keys(st["rows"] if sampled
                                              else None, i + 1),
                with_score=with_scores)
            if eos is not None:
                done = st["done"]
                nxt = torch.where(done, pad, nxt)
                if with_scores:
                    sc = torch.where(done, 0.0, sc)
                done |= nxt == eos
            col = (i + 1).reshape(1)
            st["buf"].index_copy_(1, col, nxt[:, None])
            if with_scores:
                st["sbuf"].index_copy_(1, col, sc[:, None])
            st["tok"].copy_(nxt)
            i.add_(1)

        loop = _Loop(self, step, st, _leaf_addresses(params))
        prog = loop.step

        def run(params, tokens, lengths, seed):
            logits, _ = self._prefill(params, tokens, caches,
                                      lengths if ragged else None,
                                      prefill_chunk)
            rows = self._row_keys(seed, b)
            tok, score = self._sample(logits[:, -1],
                                      self._draw_keys(rows, 0),
                                      with_score=with_scores)
            if rows is not None:
                st["rows"].copy_(rows)
            st["lengths"].copy_(lengths)
            st["tok"].copy_(tok)
            st["done"].copy_(tok == eos if eos is not None
                             else torch.zeros_like(st["done"]))
            st["i"].zero_()
            st["buf"].fill_(pad)
            st["buf"][:, 0] = tok
            st["sbuf"].zero_()
            if with_scores:
                st["sbuf"][:, 0] = score
            steps = 0
            clock = _Clock(dev)
            for _ in range(max_new_tokens - 1):
                if early_exit and eos is not None and bool(st["done"].all()):
                    break
                prog()
                steps += 1
            self._decode_clock = clock.stop()
            self.last_decode_steps = steps
            out = torch.cat([tokens, st["buf"]], dim=1)
            return out, (st["sbuf"] if with_scores else None)

        loop.run = run
        return loop

    def _build_beam(self, b: int, s0: int, max_new_tokens: int,
                    num_beams: int, length_penalty: float,
                    prefill_chunk: int, ragged: bool, params) -> _Loop:
        """Beam search's program (the JAX ``_build_beam``, generation.py:
        564): beams flattened on the batch (row b * K + k is beam k of row
        b). The prefill fills B rows' caches, its top K tokens start the
        beams, and the caches are repeated into the program's (B * K) beam
        caches. Each step: log-softmax of the (B * K, 1) walk's f32 logits;
        a frozen beam (one that emitted eos) continues with pad only, at
        logp 0; the K best of the K * V candidates (ties to the lower
        index, as ``lax.top_k``); done, lengths and token buffers gathered
        by parent and the caches reordered in place by ``rows = b * K +
        parent`` (a gather into a temporary, copied back: the captured
        graph keeps its addresses). The pick divides each beam's score by
        its emitted length ** ``length_penalty``. Ragged rows repeat their
        lengths per beam."""
        dev = self.model.device
        cdtype = self._compute_dtype()
        K = num_beams
        bk = b * K
        i64 = dict(dtype=torch.int64, device=dev)
        caches = {op.name: op.init_cache(bk, s0 + max_new_tokens, cdtype,
                                         dev)
                  for op in self.attn_ops}
        st = dict(tok=torch.zeros((b, K), **i64),
                  scores=torch.zeros((b, K), dtype=torch.float32, device=dev),
                  done=torch.zeros((b, K), dtype=torch.bool, device=dev),
                  new_len=torch.zeros((b, K), **i64),
                  buf=torch.zeros((b, K, max_new_tokens), **i64),
                  i=torch.zeros((), **i64), lengths=torch.zeros(bk, **i64))
        base = (torch.arange(b, **i64) * K)[:, None]
        eos, pad = self.eos_id, self.pad_id
        # a frozen beam's next-token logp: pad at 0, everything else -inf
        vocab = self.model._final_tensor.dims[-1]
        frozen = torch.full((vocab,), -torch.inf, device=dev)
        frozen[pad] = 0.0

        def step():
            i = st["i"]
            rl = st["lengths"] if ragged else None
            logits, _ = self._walk(
                self.params(), st["tok"].reshape(bk, 1), caches, pos=s0 + i,
                rope_pos=(rl + i) if ragged else None, row_lengths=rl,
                prompt_len=s0)
            logp = torch.log_softmax(logits[:, 0].float(), dim=-1)
            logp = logp.reshape(b, K, vocab)
            logp = torch.where(st["done"][..., None], frozen, logp)
            cand = (st["scores"][..., None] + logp).reshape(b, K * vocab)
            scores, flat = _top_k_stable(cand, K)
            parent = flat // vocab
            tok = flat % vocab
            done = torch.gather(st["done"], 1, parent)
            new_len = torch.gather(st["new_len"], 1, parent)
            buf = torch.gather(st["buf"], 1, parent[:, :, None].expand(
                -1, -1, max_new_tokens))
            buf.index_copy_(2, (i + 1).reshape(1), tok[:, :, None])
            rows = (base + parent).reshape(-1)
            for c in caches.values():
                for t in c.values():
                    t.copy_(t.index_select(0, rows))
            if eos is not None:
                new_len = torch.where(done, new_len, new_len + 1)
                done = done | (tok == eos)
            else:
                new_len = new_len + 1
            for name, v in (("tok", tok), ("scores", scores), ("done", done),
                            ("new_len", new_len), ("buf", buf)):
                st[name].copy_(v)
            i.add_(1)

        loop = _Loop(self, step, st, _leaf_addresses(params))
        prog = loop.step

        def run(params, tokens, lengths, seed):
            pre = {op.name: op.init_cache(b, s0 + max_new_tokens, cdtype,
                                          dev) for op in self.attn_ops}
            logits, pre = self._prefill(params, tokens, pre,
                                        lengths if ragged else None,
                                        prefill_chunk)
            logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
            scores, tok = _top_k_stable(logp, K)
            for name, c in caches.items():
                for part, t in c.items():
                    t.view(b, K, *t.shape[1:]).copy_(pre[name][part][:, None])
            del pre
            st["lengths"].copy_(lengths.repeat_interleave(K))
            st["tok"].copy_(tok)
            st["scores"].copy_(scores)
            st["done"].copy_(tok == eos if eos is not None
                             else torch.zeros_like(st["done"]))
            st["new_len"].fill_(1)
            st["buf"].fill_(pad)
            st["buf"][:, :, 0] = tok
            st["i"].zero_()
            clock = _Clock(dev)
            for _ in range(max_new_tokens - 1):
                prog()
            self._decode_clock = clock.stop()
            self.last_decode_steps = max_new_tokens - 1
            norm = st["scores"] / torch.clamp_min(
                st["new_len"], 1).float() ** length_penalty
            best = torch.argmax(norm, dim=1)
            picked = st["buf"][torch.arange(b, device=dev), best]
            best_score = torch.gather(norm, 1, best[:, None])[:, 0]
            return torch.cat([tokens, picked], dim=1), best_score

        loop.run = run
        return loop

    def _cached_program(self, key, build):
        """LRU lookup / insert of generate()'s programs (the JAX
        ``_cached_program``, generation.py:696): at most
        ``FF_GEN_PROGRAM_CACHE`` (default 8; 0 or less keeps every one)
        programs, the least recently used evicted first — dropping the
        last reference to its graph and static buffers, which frees
        them."""
        fn = self._programs.get(key)
        if fn is not None:
            self._programs.move_to_end(key)
            return fn
        fn = self._programs[key] = build()
        try:
            cap = int(os.environ.get("FF_GEN_PROGRAM_CACHE", "8") or 8)
        except ValueError:
            cap = 8
        while cap > 0 and len(self._programs) > cap:
            self._programs.popitem(last=False)
        return fn

    def _program(self, key, build, params) -> _Loop:
        """``_cached_program``, rebuilding a program whose captured weight
        addresses are no longer those of ``params`` (a tree rebound)."""
        loop = self._cached_program(key, build)
        if loop.addresses != _leaf_addresses(params):
            del self._programs[key]
            loop = self._cached_program(key, build)
        return loop

    def _check_lengths(self, tokens: torch.Tensor, prompt_lengths):
        """(B,) prompt lengths checked against the prompt slab (the JAX
        ``_check_lengths``, generation.py:739): (int64 device tensor,
        ragged). Uniform prompts pass zeros, which the program ignores."""
        if prompt_lengths is None:
            return torch.zeros(tokens.shape[0], dtype=torch.int64,
                               device=tokens.device), False
        lengths = np.asarray(prompt_lengths, np.int32)
        if lengths.shape != (tokens.shape[0],):
            raise ValueError(
                f"prompt_lengths shape {lengths.shape} != "
                f"({tokens.shape[0]},)")
        if (lengths < 1).any() or (lengths > tokens.shape[1]).any():
            raise ValueError(
                f"prompt_lengths must be in [1, {tokens.shape[1]}], "
                f"got {lengths.tolist()}")
        return torch.as_tensor(lengths, dtype=torch.int64,
                               device=tokens.device), True

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int32),
                               dtype=torch.int64, device=self.model.device)

    @torch.inference_mode()
    def beam_search(self, tokens, max_new_tokens: int, num_beams: int,
                    length_penalty: float = 0.0, prefill_chunk: int = 0,
                    return_scores: bool = False, prompt_lengths=None):
        """Beam search (the JAX ``beam_search``, generation.py:713): (B, S0
        + max_new_tokens) int32 with the best beam's tokens, and with
        ``return_scores`` its (B,) length-normalized total logp."""
        if prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {prefill_chunk}")
        tokens = self._tokens(tokens)
        lengths, ragged = self._check_lengths(tokens, prompt_lengths)
        b, s0 = tokens.shape
        params = self.params()
        key = ("beam", max_new_tokens, num_beams, length_penalty,
               prefill_chunk, ragged, (b, s0))
        loop = self._program(key, lambda: self._build_beam(
            b, s0, max_new_tokens, num_beams, length_penalty, prefill_chunk,
            ragged, params), params)
        out, score = loop.run(params, tokens, lengths, 0)
        out = out.to(torch.int32).cpu().numpy()
        if return_scores:
            return out, score.cpu().numpy()
        return out

    @torch.inference_mode()
    def __call__(self, tokens, max_new_tokens: int, seed: int = 0,
                 prompt_lengths=None, prefill_chunk: int = 0,
                 return_scores: bool = False, early_exit: bool = False):
        """tokens (B, S0) int prompts -> (B, S0 + max_new_tokens) int32 with
        the generated tokens in columns S0 onward (the JAX ``__call__``,
        generation.py:757); with ``return_scores`` also the (B,
        max_new_tokens) f32 log-probabilities (pads after eos 0).
        ``prompt_lengths`` (B,): ragged right-padded prompts;
        ``prefill_chunk`` > 0: chunked prefill; ``early_exit``: stop once
        every row has emitted eos (the same tokens)."""
        tokens = self._tokens(tokens)
        lengths, ragged = self._check_lengths(tokens, prompt_lengths)
        if prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {prefill_chunk}")
        b, s0 = tokens.shape
        params = self.params()
        key = (max_new_tokens, ragged, prefill_chunk, return_scores,
               early_exit, (b, s0))
        loop = self._program(key, lambda: self._build(
            b, s0, max_new_tokens, ragged, prefill_chunk, return_scores,
            early_exit, params), params)
        out, scores = loop.run(params, tokens, lengths, seed)
        out = out.to(torch.int32).cpu().numpy()
        if return_scores:
            return out, scores.cpu().numpy()
        return out
