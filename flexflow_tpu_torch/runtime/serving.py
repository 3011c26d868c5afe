"""Continuous-batching serving over a paged KV cache (the JAX package's
``runtime/serving.py`` ``ServingEngine`` and its ``RadixPrefixCache``).

  * ``serve_slots`` decode slots run as one (slots, 1) batch per decode
    step; the HOST scheduler admits queued prompts into free slots and
    retires rows on eos or length.
  * The KV cache is a POOL of ``(kv_pages, kv_page_size, KVH, Hd)`` pages
    with a per-slot page table. Pages are allocated at admission and freed
    at retirement; page 0 is a scratch page that inactive slots write.
  * RADIX PREFIX CACHE (``prefix_cache``, default on as in the JAX
    package; the HBM tier): a page-granular trie over prompt prefixes. An
    admission mounts the longest cached page-aligned prefix of its prompt
    read-only and prefills only its tail; a finished prefill publishes its
    full-prompt pages; retirement decrefs them (they stay cached, warm,
    until pool pressure evicts them LRU-first). Copy-on-write lives in the
    allocator: every tail and decode write goes to the request's own fresh
    pages, never to a published one.
  * Cold admission prefills the whole bucket-padded prompt (prompt lengths
    round up to powers of two, or to ``decode_buckets``) through the flash
    kernel into a contiguous per-request cache — or, past
    ``prefill_chunk``, chunk by chunk through the grouped einsum attention
    and a query of the prompt's last token; a hit gathers its prefix
    pages into the cache's front (dequantized from a quantized pool),
    prefills the tail with the grouped einsum attention and queries the
    prompt's last token. Either way the new k/v scatters into the slot's
    fresh pages with the prefill-write kernel. With
    ``prefill_interleave_chunks`` a long cold prompt's chunks run a few a
    tick between decode dispatches instead of at admission.
  * QUANTIZED TIER (``kv_cache_dtype``, ``weight_dtype``): the pool stores
    bf16, or int8 / fp8 with one f32 scale per (page, kv head) — the
    paged-attention and prefill-write kernels dequantize and quantize —
    and the served weights may be int8 / fp8 with per-output-channel
    scales, quantized once at engine init.
  * SAMPLING (``temperature``, ``top_p``, ``top_k``, ``seed``, per request):
    slot-resident arrays beside ``write_pos``; a request's stream is a pure
    function of (seed, token index) (``ops/sampling.py``). Temperature 0
    is greedy, bitwise the greedy-only decode.
  * SPECULATIVE DECODING (``draft_model``, ``speculate_k``): the draft
    proposes K tokens a slot from its own pool (mirroring the target's page
    ids), the target scores the K + 1 positions in one verify pass through
    the paged-attention kernel, and the host accepts: the longest
    argmax-matching prefix for greedy slots, rejection sampling for
    sampled ones.
  * Decode runs ``decode_chunk`` steps per host round trip. The decode
    chunk, the draft's proposals and the verify pass are programs keyed as
    the JAX engine keys its compiled ones; on the card each is a CUDA graph
    captured at its first use and replayed after (``_Program``), on the
    CPU the same body runs as a plain loop. Each attention layer reads the
    pool through the paged-attention kernel (``paged_attention_impl``
    "einsum", the page gather and grouped einsum attention, is the CPU's
    route and is refused on the card).
    Tokens a slot computes past its own eos/length are truncated by the
    host, so outputs do not depend on the chunk.

Per-slot cache layout: logical positions ``[0, row_len)`` hold the true
prompt, ``[row_len, prompt_pad)`` masked bucket padding, and decode tokens
append from ``prompt_pad``; RoPE positions stay logical
(``row_len + emitted``).

The prefix cache's host tier and LoRA adapters are later slices: their
knobs raise ``NotImplementedError`` rather than being ignored.
"""

from __future__ import annotations

import collections
import heapq
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from flexflow_tpu_torch.config import not_ported
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops import sampling as sampling_ops
from flexflow_tpu_torch.ops.attention import (kv_storage_dtype,
                                              resolve_paged_attention_impl)
from flexflow_tpu_torch.runtime.generation import Generator


@dataclass
class Request:
    """One serving request and its lifecycle record."""

    rid: int
    prompt: np.ndarray              # (S,) int32, true (unpadded) prompt
    max_new_tokens: int
    state: str = "queued"           # queued | running | done | failed
    tokens: List[int] = field(default_factory=list)  # emitted tokens
    slot: int = -1
    bucket: int = 0
    pages: List[int] = field(default_factory=list)   # full logical table
    # prefix-cache bookkeeping: trie nodes whose refcount this request
    # holds (shared prefix pages + pages it published), and the pages it
    # owns outright (freed at retirement; trie pages are only decref'd)
    trie_nodes: List = field(default_factory=list)
    private_pages: List[int] = field(default_factory=list)
    prefix_tokens: int = 0          # prefill positions served from cache
    temperature: float = 0.0        # sampling config (0 = greedy)
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0                   # the stream's seed (ops/sampling.py)
    t_submit: float = 0.0
    ttft: float = 0.0               # submit -> first emitted token (s)
    t_done: float = 0.0
    error: str = ""

    @property
    def output(self) -> np.ndarray:
        """prompt + emitted tokens."""
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])


def _pow2_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class _TrieNode:
    """One cached KV page: the page_size-token chunk it encodes (its edge
    label from the parent), the pool page id holding its k/v, and the
    refcount of live requests whose page tables reference it."""

    __slots__ = ("chunk", "page", "parent", "children", "ref", "last_use",
                 "dead")

    def __init__(self, chunk, page, parent):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children = {}
        self.ref = 0
        self.last_use = 0
        self.dead = False


class RadixPrefixCache:
    """Radix trie over prompt token prefixes at PAGE granularity (the JAX
    package's ``RadixPrefixCache``, its HBM tier).

    Each trie edge is exactly ``page_size`` tokens, so a path of depth d
    names a d-page prompt prefix and maps it to the d pool pages holding
    its KV. A page's KV at position j depends only on tokens [0..j]
    (causal attention), so any request whose prompt starts with the same
    ``d * page_size`` tokens can mount those pages read-only and prefill
    just its tail.

    Ownership protocol (the copy-on-write rule lives HERE, not in the
    kernels): a page in the trie is never written again — its producer
    published it after its prefill, and every borrower's tail and decode
    writes land in freshly allocated pages past the matched prefix.
    ``ref`` counts live requests mounting the page; retirement decrefs. A
    refcount-0 page stays cached until ``evict()`` reclaims it under pool
    pressure, LRU-first and leaves only (an interior page must outlive its
    children, since a match walks through it). All host-side."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self.root = _TrieNode(None, -1, None)
        self.pages = 0          # nodes (pool pages) currently cached
        self.lookups = 0
        self.hits = 0
        self.tokens_saved = 0   # prefill positions served from cache
        self.evictions = 0      # PRESSURE evictions only (flushes don't
        #                         count — they are not a pool signal)
        self._tick = 0          # monotonic LRU clock (bumped per lookup)
        # incremental mirrors of the trie's refcount state, so stats()
        # never walks the trie
        self._live_refs = 0     # sum of node.ref
        self._shared = 0        # nodes with ref > 1 right now

    def _chunk(self, prompt, i: int):
        ps = self.page_size
        return tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])

    def match(self, prompt, max_pages: int) -> List[_TrieNode]:
        """Longest cached page-aligned prefix of ``prompt``, capped at
        ``max_pages``; returns the node path root-down (possibly empty).
        Takes no references and counts no hit: the caller commits with
        acquire() / note_admitted() once the admission is certain (a
        request that stays queued on pool pressure re-matches every tick
        and must leave refcounts and counters untouched)."""
        self._tick += 1
        node, path = self.root, []
        limit = min(int(max_pages), len(prompt) // self.page_size)
        for i in range(limit):
            child = node.children.get(self._chunk(prompt, i))
            if child is None:
                break
            path.append(child)
            node = child
        for n in path:
            n.last_use = self._tick
        return path

    def note_admitted(self, matched_pages: int):
        """Commit one admission's lookup to the hit statistics — called
        exactly once per admitted request."""
        self.lookups += 1
        if matched_pages:
            self.hits += 1
            self.tokens_saved += matched_pages * self.page_size

    def acquire(self, nodes):
        for n in nodes:
            n.ref += 1
            self._live_refs += 1
            if n.ref == 2:
                self._shared += 1

    def release(self, nodes):
        for n in nodes:
            n.ref -= 1
            self._live_refs -= 1
            if n.ref == 1:
                self._shared -= 1
            if n.ref < 0:  # accounting bug, not a recoverable state
                raise AssertionError(
                    f"prefix-cache refcount underflow on page {n.page}")

    def insert(self, prompt, matched, start: int,
               pages: List[int]) -> List[_TrieNode]:
        """Publish a finished prefill's full-prompt pages: ``pages[j]``
        holds chunk ``start + j`` of ``prompt``, appended under the
        ``matched`` path. Each created node starts at ref 1 (the
        publishing request still mounts it). Stops at the first chunk
        that already exists — the caller's duplicate page for it stays
        private (only possible when the match was capped below an
        existing deeper path)."""
        node = matched[-1] if matched else self.root
        created = []
        for j, page in enumerate(pages):
            chunk = self._chunk(prompt, start + j)
            if chunk in node.children:
                break
            child = _TrieNode(chunk, page, node)
            child.ref = 1
            self._live_refs += 1
            child.last_use = self._tick
            node.children[chunk] = child
            node = child
            created.append(child)
            self.pages += 1
        return created

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def evict(self, need: int, protect=(), pressure: bool = True) \
            -> List[int]:
        """Reclaim up to ``need`` pages from refcount-0 LEAVES, oldest
        last_use first; returns the freed page ids. ``protect`` excludes a
        just-matched path the caller is about to acquire. Reclaiming a leaf
        may expose its parent — the sweep cascades. ``pressure=False``
        (flush, leak accounting) reclaims every refcount-0 leaf whatever
        ``need`` is and stays out of the ``evictions`` pool-pressure
        signal."""
        keep = set(id(n) for n in protect)

        def reclaimable(n):
            return (n.ref == 0 and id(n) not in keep and not n.dead
                    and not n.children)

        heap = [(n.last_use, id(n), n) for n in self._iter_nodes()
                if reclaimable(n)]
        heapq.heapify(heap)
        freed: List[int] = []
        while heap and (len(freed) < need or not pressure):
            _, _, n = heapq.heappop(heap)
            if not reclaimable(n):
                continue
            parent = n.parent
            freed.extend(self._kill_subtree(n))
            if pressure:
                self.evictions += 1
            if parent is not self.root and reclaimable(parent):
                heapq.heappush(heap, (parent.last_use, id(parent), parent))
        return freed

    def _kill_subtree(self, node) -> List[int]:
        """Remove ``node`` and its descendants from the trie; returns the
        pool pages freed."""
        if node.dead:
            return []
        if node.parent is not None \
                and node.parent.children.get(node.chunk) is node:
            del node.parent.children[node.chunk]
        freed: List[int] = []
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.children = {}
            if n.ref:
                raise AssertionError(
                    f"killing a mounted prefix page (ref={n.ref})")
            freed.append(n.page)
            self.pages -= 1
            n.dead = True
            n.page = -1
        return freed

    def forget(self, prompt) -> List[int]:
        """Kill the deepest unmounted, childless tail of ``prompt``'s
        cached path; returns the freed pages."""
        path = self.match(prompt, len(prompt) // self.page_size)
        freed: List[int] = []
        for n in reversed(path):
            if n.children or n.ref:
                break
            freed.extend(self._kill_subtree(n))
        return freed

    def live_refs(self) -> int:
        return self._live_refs

    def shared_pages(self) -> int:
        """Pages mounted by more than one live request right now."""
        return self._shared


def _refuse_later_slices(cfg, host_kv_pages, adapter_pool_pages):
    """Knobs of later slices: a non-default value raises, it is never
    silently served as the default."""
    hp = host_kv_pages if host_kv_pages is not None else cfg.host_kv_pages
    if hp:
        raise not_ported(f"the prefix cache's host tier (host_kv_pages="
                         f"{hp})", "the trie keeps its pages in the pool "
                         "(host_kv_pages=0)")
    if adapter_pool_pages:
        raise not_ported("LoRA adapter serving (adapter_pool_pages)")


class _Program:
    """One decode-side program of the engine, the counterpart of one of the
    JAX engine's compiled programs: ``body()`` reads the static input
    tensors ``inputs`` (the host fills them before each call, ``load``)
    and returns its output tensors; the pools it writes are updated in
    place.

    On the card the program is a CUDA graph. Its first call runs the body
    eagerly on the engine's side stream — that call's real dispatch, which
    also builds the kernels and sizes the split-KV scratch cached for the
    stream — then captures the body on that stream without running it;
    every later call replays the graph. The graph holds the addresses of
    the inputs, the pools, the weights and the stream's scratch, so the
    program keeps the scratch alive (``kernels.stream_scratch``). Launch
    counters do not tick on a replay: each replay adds the launches its
    capture recorded (the capture, which launches nothing, takes back what
    it counted). A failed capture raises; the eager body never runs in a
    graph's place. On the CPU the body runs as it is."""

    def __init__(self, body, inputs: Dict[str, torch.Tensor],
                 stream: Optional["torch.cuda.Stream"]):
        self.body = body
        self.inputs = inputs
        self.stream = stream
        self.graph = None
        self.outs = None
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self._scratch: list = []

    def load(self, **arrays):
        """Copy host arrays into the static inputs of the same names."""
        for name, a in arrays.items():
            self.inputs[name].copy_(torch.from_numpy(np.ascontiguousarray(a)))

    def __call__(self):
        if self.stream is None:
            return self.body()
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            kernels.add_launches(self.launches)
            return self.outs
        side = self.stream
        cur = torch.cuda.current_stream(side.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            outs = self.body()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        self.outs, self.launches = kernels.capture(graph, side, self.body)
        self._scratch = kernels.stream_scratch(side.device, side.cuda_stream)
        self.graph = graph
        return outs


class ServingEngine:
    """Continuous-batching engine over a compiled FFModel decoder LM.

    Build once (after model.compile()); ``submit()`` requests and drive
    ``step()`` yourself, or hand ``run()`` a list of prompts. Knobs default
    to the model's FFConfig (serve_slots, kv_page_size, kv_pages,
    decode_buckets, serve_prefix_cache, kv_cache_dtype,
    serve_weight_dtype, serve_temperature / serve_top_p / serve_top_k,
    serve_speculate_k, draft_model, prefill_interleave_chunks,
    paged_attention_impl).

    ``capture=False`` is for comparisons only: on the card the decode-side
    programs then run their bodies uncaptured — the same kernels, launched
    from the host each step — as the reference a test holds the CUDA
    graphs against. Serving leaves it on."""

    def __init__(self, model, serve_slots: Optional[int] = None,
                 kv_page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 decode_buckets: Optional[List[int]] = None,
                 max_seq_len: int = 1024,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 prefill_chunk: int = 0,
                 decode_chunk: int = 8, seed: int = 0,
                 prefix_cache: Optional[bool] = None,
                 host_kv_pages: Optional[int] = None,
                 draft_model=None, speculate_k: Optional[int] = None,
                 paged_attention_impl: Optional[str] = None,
                 kv_cache_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 adapter_pool_pages: Optional[int] = None,
                 prefill_interleave_chunks: Optional[int] = None,
                 capture: bool = True):
        cfg = model.config
        if model.params is None:
            raise ValueError("ServingEngine needs a compiled model "
                             "(FFModel.compile)")
        _refuse_later_slices(cfg, host_kv_pages, adapter_pool_pages)
        self.model = model
        self.device = model.device
        # ---- per-request sampling defaults: requests carry their own
        # temperature / top_p / top_k / seed as slot-resident state; the
        # engine's values are submit()'s defaults (temperature 0 = greedy)
        self.default_temperature, self.default_top_p, self.default_top_k \
            = sampling_ops.validate_sampling(
                temperature if temperature is not None
                else cfg.serve_temperature,
                top_p if top_p is not None else cfg.serve_top_p,
                top_k if top_k is not None else cfg.serve_top_k,
                "ServingEngine")
        # a submit() without a seed gets one derived from the engine seed
        # and its request id
        self._seed_base = (int(seed) * 1000003) & 0x7FFFFFFF
        self.slots = int(serve_slots or cfg.serve_slots)
        self.decode_chunk = max(1, int(decode_chunk))
        self.page_size = int(kv_page_size or cfg.kv_page_size)
        buckets = (decode_buckets if decode_buckets is not None
                   else cfg.decode_buckets)
        self.buckets = sorted(int(b) for b in buckets) if buckets else None
        self.max_seq_len = int(max_seq_len)
        self.prefill_chunk = int(prefill_chunk)
        # chunk-interleaved admission: > 0 makes each cold prompt's prefill
        # chunks schedulable quanta, at most this many a tick between
        # decode dispatches; the chunk is the quantum
        self.prefill_interleave_chunks = int(
            prefill_interleave_chunks if prefill_interleave_chunks is not None
            else cfg.prefill_interleave_chunks)
        if self.prefill_interleave_chunks < 0:
            raise ValueError(
                f"prefill_interleave_chunks="
                f"{self.prefill_interleave_chunks}: must be >= 0")
        if self.prefill_interleave_chunks and self.prefill_chunk <= 0:
            raise ValueError(
                "prefill_interleave_chunks > 0 needs prefill_chunk > 0: "
                "the chunk is the interleave quantum")
        if self.slots < 1 or self.page_size < 1 or self.max_seq_len < 2:
            raise ValueError(
                f"serve_slots={self.slots}, kv_page_size={self.page_size},"
                f" max_seq_len={self.max_seq_len}: all must be positive "
                f"(max_seq_len >= 2)")
        self.pages_per_slot = math.ceil(self.max_seq_len / self.page_size)
        enable_prefix = (prefix_cache if prefix_cache is not None
                         else cfg.serve_prefix_cache)
        # kv_pages = 0 derive: scratch page + one slot's worth of pages per
        # slot + prefix-cache slack (half the slot pages, at least one
        # slot's worth), so a full house still leaves room for refcount-0
        # cached prefixes — without it every retirement's pages are taken
        # by the next admission and the cache goes cold (the JAX derive)
        slot_pages = self.slots * self.pages_per_slot
        cache_slack = (max(self.pages_per_slot, slot_pages // 2)
                       if enable_prefix else 0)
        want_pages = 1 + slot_pages + cache_slack
        self.num_pages = int(kv_pages or cfg.kv_pages or 0) or want_pages
        if self.num_pages < 1 + self.pages_per_slot:
            raise ValueError(
                f"kv_pages={self.num_pages} cannot hold even one "
                f"max_seq_len={self.max_seq_len} request "
                f"(needs {1 + self.pages_per_slot} incl. scratch page 0)")
        self.paged_attention_impl = resolve_paged_attention_impl(
            paged_attention_impl, cfg, self.device)

        # ---- quantized serving tier ----
        wd = (weight_dtype if weight_dtype is not None
              else cfg.serve_weight_dtype)
        if wd not in ("native", "int8", "fp8"):
            raise ValueError(
                f"weight_dtype={wd!r}: must be 'native', 'int8' or 'fp8'")
        self.weight_dtype = wd
        kv_raw = (kv_cache_dtype if kv_cache_dtype is not None
                  else cfg.kv_cache_dtype)
        kv_storage_dtype(kv_raw)  # validate early
        self._kv_dtype_arg = (None if kv_raw in (None, "", "native")
                              else kv_raw)
        quantize = None if wd == "native" else wd

        self.gen = Generator(model, quantize=quantize)
        self.eos_id = eos_id
        self.pad_id = pad_id
        self._cdtype = self.gen._compute_dtype()
        if self._kv_dtype_arg is None:
            self.kv_cache_dtype = str(self._cdtype).replace("torch.", "")
        elif kv_raw == "bf16":
            self.kv_cache_dtype = "bfloat16"
        else:
            self.kv_cache_dtype = kv_raw
        if self.gen.quantize:
            # quantize once at engine init: admission and decode never pay
            # the quantization pass
            self.gen.params()
        self.pool = self._init_pool(self.gen)
        self._free_pages = list(range(self.num_pages - 1, 0, -1))
        self._vocab = int(model._final_tensor.dims[-1])
        # pool-capacity observability, fixed for the engine's life: what a
        # token of KV costs (scales included) and the capacity multiplier
        # against a bf16 pool of the same geometry
        self._pool_bytes = sum(t.numel() * t.element_size()
                               for c in self.pool.values()
                               for t in c.values())
        self._kv_bytes_per_token = (
            self._pool_bytes / (self.num_pages * self.page_size))
        self._bf16_bytes_per_token = sum(
            op.num_kv_heads * (op.qk_head_dim + op.v_head_dim) * 2
            for op in self.gen.attn_ops)
        self.prefix_cache = (RadixPrefixCache(self.page_size)
                             if enable_prefix else None)

        # ---- speculative decoding: a draft model proposes K tokens a slot,
        # one verify pass of the target scores all K + 1 positions
        self.speculate_k = int(speculate_k if speculate_k is not None
                               else cfg.serve_speculate_k)
        self.draft_model = (draft_model if draft_model is not None
                            else cfg.draft_model)
        if self.speculate_k < 0:
            raise ValueError(
                f"speculate_k={self.speculate_k}: must be >= 0")
        self.draft_gen = None
        self.draft_pool = None
        if self.speculate_k > 0:
            self._init_draft(quantize)

        # per-slot scheduler state (host side, shipped to the device each
        # decode dispatch)
        n = self.slots
        self.page_tables = np.zeros((n, self.pages_per_slot), np.int32)
        self.row_len = np.zeros((n,), np.int32)
        self.prompt_pad = np.zeros((n,), np.int32)
        self.emitted = np.zeros((n,), np.int32)
        self.last_tok = np.zeros((n,), np.int32)
        self.active = np.zeros((n,), bool)
        self.slot_req: List[Optional[Request]] = [None] * n
        # slot-resident sampling state: idle slots sit at the greedy
        # defaults and their draws are discarded with the scratch writes
        self.temps = np.zeros((n,), np.float32)
        self.top_ps = np.ones((n,), np.float32)
        self.top_ks = np.zeros((n,), np.int32)
        self.seeds = np.zeros((n,), np.int32)

        self._queue: List[Request] = []
        # mid-prefill slots of chunk-interleaved admission: slot -> the
        # request, its chunk caches so far, the next chunk start and the
        # padded prompt. The slot is held (slot_req set) but inactive, so
        # decode dispatches see it as idle until _finish_prefill
        self._partial: Dict[int, dict] = {}
        self._prefill_rr = 0
        # the decode-side programs by key (CUDA graphs on the card), their
        # side stream, and how many were built (JAX's recompile_count)
        self._programs: Dict[tuple, _Program] = {}
        self._stream = (torch.cuda.Stream(self.device)
                        if capture and self.device.type == "cuda" else None)
        self.recompile_count = 0
        self._next_rid = 0
        self.decode_steps = 0
        self._decode_seconds = 0.0
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._tokens_emitted = 0
        self._sampled_requests = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_dispatches = 0
        self._prefill_chunks_interleaved = 0
        self._prefill_preempted_ticks = 0
        self._ttfts = collections.deque(maxlen=4096)
        # kernel launches are counted process-wide by the wrappers;
        # stats() reports them since this engine was built
        self._launch_base = kernels.launch_counts()

    def _init_pool(self, gen):
        return {op.name: op.init_paged_cache(self.num_pages, self.page_size,
                                             gen._compute_dtype(),
                                             self.device,
                                             kv_dtype=self._kv_dtype_arg)
                for op in gen.attn_ops}

    def _init_draft(self, quantize):
        """The draft's Generator and its pool. The pool mirrors the target
        pool's page geometry, page ids and storage dtype (with the draft's
        own kv heads and head dim): one allocator, one page table and one
        radix trie govern both, so a shared prefix page id holds the
        target's and the draft's KV."""
        dm = self.draft_model
        if dm is None:
            raise ValueError(
                "speculate_k > 0 needs a draft model (FFConfig.draft_model "
                "or the draft_model argument): speculative decoding "
                "verifies a DRAFT's proposals")
        if dm.params is None:
            raise ValueError("the draft model must be compiled "
                             "(FFModel.compile)")
        if dm.device != self.device:
            raise ValueError(f"the draft model lives on {dm.device}, the "
                             f"target on {self.device}")
        tgt_v = self._vocab
        dft_v = int(dm._final_tensor.dims[-1])
        if tgt_v != dft_v:
            raise ValueError(
                f"draft/target vocab mismatch: draft emits {dft_v} logits, "
                f"target {tgt_v} — the accept rule compares token ids, so "
                f"the vocabularies must be identical")
        self.draft_gen = Generator(dm, quantize=quantize)
        if self.draft_gen.quantize:
            self.draft_gen.params()
        self.draft_pool = self._init_pool(self.draft_gen)

    # ---- scheduling ----------------------------------------------------------

    def _bucket(self, prompt_len: int) -> int:
        if self.buckets:
            for b in self.buckets:
                if b >= prompt_len:
                    return b
            raise ValueError(
                f"prompt length {prompt_len} exceeds the largest decode "
                f"bucket {self.buckets[-1]}")
        return _pow2_bucket(prompt_len)

    def submit(self, prompt, max_new_tokens: int,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               top_k: Optional[int] = None,
               seed: Optional[int] = None) -> Request:
        """Queue one request. Sampling knobs default to the engine's; the
        request's stream is a pure function of its seed (by default one
        derived from the engine seed and the request id)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens}: must be >= 1")
        if prompt.min() < 0 or prompt.max() >= self._vocab:
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self._vocab})")
        bucket = self._bucket(prompt.size)
        if bucket + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"bucketed prompt ({bucket}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len {self.max_seq_len}")
        t, p, k = sampling_ops.validate_sampling(
            temperature if temperature is not None
            else self.default_temperature,
            top_p if top_p is not None else self.default_top_p,
            top_k if top_k is not None else self.default_top_k, "submit")
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens), bucket=bucket,
                      t_submit=time.perf_counter(), temperature=t, top_p=p,
                      top_k=k,
                      seed=(int(seed) if seed is not None
                            else (self._seed_base + self._next_rid)
                            & 0x7FFFFFFF))
        self._next_rid += 1
        self._submitted += 1
        if t > 0.0:
            self._sampled_requests += 1
        self._queue.append(req)
        return req

    def pending(self) -> bool:
        return (bool(self._queue) or bool(self.active.any())
                or bool(self._partial))

    def _retire(self, slot: int, state: str, error: str = ""):
        req = self.slot_req[slot]
        req.state = state
        req.error = error
        req.t_done = time.perf_counter()
        if state == "done":
            self._completed += 1
        else:
            self._failed += 1
        self._partial.pop(slot, None)
        if req.ttft:
            self._ttfts.append(req.ttft)
        # copy-on-write teardown: pages the trie owns (the matched prefix
        # and the pages this request published) are decref'd and stay
        # cached; only the request's private pages return to the free list
        if req.trie_nodes:
            self.prefix_cache.release(req.trie_nodes)
            req.trie_nodes = []
        self._free_pages.extend(req.private_pages)
        req.private_pages = []
        req.slot = -1
        self.slot_req[slot] = None
        self.active[slot] = False
        self.page_tables[slot, :] = 0   # scratch page: dead writes land there
        self.row_len[slot] = 0
        self.prompt_pad[slot] = 0
        self.emitted[slot] = 0
        self.temps[slot] = 0.0
        self.top_ps[slot] = 1.0
        self.top_ks[slot] = 0
        self.seeds[slot] = 0

    def _record_token(self, slot: int, tok: int, ok: bool):
        """Append a sampled token to the slot's request and retire on
        non-finite logits, eos, or length — shared by prefill/decode."""
        req = self.slot_req[slot]
        if not ok:
            self._retire(slot, "failed", "non-finite logits")
            return
        req.tokens.append(int(tok))
        self._tokens_emitted += 1
        if not req.ttft:
            req.ttft = time.perf_counter() - req.t_submit
        self.emitted[slot] += 1
        self.last_tok[slot] = tok
        if (self.eos_id is not None and tok == self.eos_id) \
                or len(req.tokens) >= req.max_new_tokens:
            self._retire(slot, "done")

    # ---- prefill -------------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A copy of host state on the device (never a view of it: the host
        arrays change while the tensors are in use)."""
        return torch.tensor(a, device=self.device)

    def _seed_prefix_caches(self, gen, pool, bucket: int, p0: int,
                            prefix_pages: torch.Tensor):
        """Fresh contiguous per-request caches with ``p0`` positions of
        cached prefix KV gathered READ-ONLY into their front (dequantized
        from a quantized pool, then in the compute dtype) — the shared half
        of every hit prefill; the target and the draft use this one helper,
        so their two pools (which share page ids) cannot drift apart."""
        caches = {}
        for op in gen.attn_ops:
            c = op.init_cache(1, bucket, gen._compute_dtype(), self.device)
            g = op.gather_paged_kv(pool[op.name], prefix_pages)
            for name in ("k", "v"):
                c[name][:, :p0] = g[name]
            caches[op.name] = c
        return caches

    def _scatter_tail(self, gen, pool, caches, pages: torch.Tensor,
                      p0: int = 0):
        """Copy-on-write scatter: write each attention op's contiguous
        cache past position ``p0`` into ``pages`` — the request's own fresh
        pages, never shared ones. Every layer's cache is ready, so one
        prefill-write launch writes them all. ``p0 = 0`` is the cold
        (whole-bucket) case."""
        ops = gen.attn_ops
        pools = [pool[op.name] for op in ops]
        scales = {n: [p[n] for p in pools] if n in pools[0] else None
                  for n in ("k_scale", "v_scale")}
        kernels.paged_prefill_write_layers(
            [p["k"] for p in pools], [p["v"] for p in pools],
            [caches[op.name]["k"][:, p0:] for op in ops],
            [caches[op.name]["v"][:, p0:] for op in ops], pages,
            scales["k_scale"], scales["v_scale"])

    def _new_caches(self, gen, bucket: int):
        return {op.name: op.init_cache(1, bucket, gen._compute_dtype(),
                                       self.device)
                for op in gen.attn_ops}

    def _padded(self, req: Request) -> np.ndarray:
        padded = np.full((1, req.bucket), self.pad_id, np.int32)
        padded[0, :req.prompt.size] = req.prompt
        return padded

    def _first_token(self, logits, req: Request):
        """The request's first token from the prefill's (1, 1, V) logits:
        TARGET-stream draw 0 under its sampling config. Returns (token,
        logits finite)."""
        logits = logits[:, -1]                             # (1, V)
        ok = torch.isfinite(logits).all(dim=-1)
        dev = self._dev
        tok = sampling_ops.sample_tokens(
            logits, dev(np.float32([req.temperature])),
            dev(np.float32([req.top_p])), dev(np.int32([req.top_k])),
            dev(np.int32([req.seed])), dev(np.int32([0])))
        return int(tok[0]), bool(ok[0])

    def _build_prefill(self, req: Request, pages: List[int]):
        """Cold prefill of one request: walk the graph over the whole
        bucket-padded prompt (chunked past ``prefill_chunk``), take the
        first token from the logits at the prompt's last position, scatter
        the k/v into the request's pages. Returns (token, logits finite)."""
        logits, caches = self.gen._prefill(
            self.gen.params(), self._dev(self._padded(req)),
            self._new_caches(self.gen, req.bucket),
            self._dev(np.asarray([req.prompt.size], np.int32)),
            self.prefill_chunk)
        out = self._first_token(logits, req)
        self._scatter_tail(self.gen, self.pool, caches,
                           self._dev(np.asarray(pages, np.int32)))
        return out

    def _hit_caches(self, gen, pool, req: Request, full: int,
                    prefix_pages: List[int]):
        """A hit prefill's cache pass for ``gen`` over ``pool``: ``full``
        cached pages gathered read-only into the front of a contiguous
        cache, the tail slab [full * page_size, bucket) run as one
        ``chunk_forward`` pass."""
        p0 = full * self.page_size
        caches = self._seed_prefix_caches(
            gen, pool, req.bucket, p0,
            self._dev(np.asarray(prefix_pages, np.int64)))
        tail = np.full((1, req.bucket - p0), self.pad_id, np.int32)
        tail[0, :req.prompt.size - p0] = req.prompt[p0:]
        _, caches = gen._walk(gen.params(), self._dev(tail), caches,
                              chunk_start=p0, skip_tail=True)
        return caches

    def _build_prefill_hit(self, req: Request, full: int,
                           prefix_pages: List[int], tail_pages: List[int]):
        """Prefix-hit prefill (the JAX ``_build_prefill_hit``): the tail's
        cache pass (``_hit_caches``), a gather-last query scoring the
        prompt's true last position, and only the tail k/v scattered out —
        into the request's fresh pages (the matched prefix's partial last
        page is re-materialized there too)."""
        gen = self.gen
        caches = self._hit_caches(gen, self.pool, req, full, prefix_pages)
        tok_last = self._dev(np.asarray([[req.prompt[-1]]], np.int32))
        logits, _ = gen._walk(
            gen.params(), tok_last, caches, last_only=True,
            row_lengths=self._dev(np.asarray([req.prompt.size], np.int32)),
            gather_last=True)
        out = self._first_token(logits, req)
        self._scatter_tail(gen, self.pool, caches,
                           self._dev(np.asarray(tail_pages, np.int32)),
                           full * self.page_size)
        return out

    def _draft_prefill(self, req: Request, full: int):
        """The draft's prefill into its pool (the JAX
        ``_build_draft_prefill`` / ``_build_draft_prefill_hit``), mirroring
        the target's hit / cold split on the same page ids. Cache-only: the
        draft's first proposal comes from its decode, so its prefill
        logits are never needed."""
        gen = self.draft_gen
        n_prefill = math.ceil(req.bucket / self.page_size)
        if full:
            caches = self._hit_caches(gen, self.draft_pool, req, full,
                                      req.pages[:full])
            pages, p0 = req.pages[full:n_prefill], full * self.page_size
        else:
            _, caches = gen._walk(gen.params(), self._dev(self._padded(req)),
                                  self._new_caches(gen, req.bucket),
                                  skip_tail=True)
            pages, p0 = req.pages[:n_prefill], 0
        self._scatter_tail(gen, self.draft_pool, caches,
                           self._dev(np.asarray(pages, np.int32)), p0)

    def _seed_slot(self, slot: int, req: Request):
        """The slot's decode-state arrays for an admitted request: from
        here on every decode dispatch serves it."""
        self.temps[slot] = req.temperature
        self.top_ps[slot] = req.top_p
        self.top_ks[slot] = req.top_k
        self.seeds[slot] = req.seed
        n_total = math.ceil((req.bucket + req.max_new_tokens)
                            / self.page_size)
        table = np.zeros((self.pages_per_slot,), np.int32)
        table[:n_total] = req.pages
        self.page_tables[slot] = table
        self.row_len[slot] = req.prompt.size
        self.prompt_pad[slot] = req.bucket
        self.emitted[slot] = 0

    def _publish(self, req: Request, matched, full: int, ok: bool):
        """Publish the prompt's FULL pages past the matched prefix (a
        non-finite prefill never publishes); published pages move from
        private to trie-owned."""
        pc = self.prefix_cache
        if pc is None or not ok:
            return
        last = req.prompt.size // self.page_size
        if last > full:
            created = pc.insert(req.prompt, matched, full,
                                req.pages[full:last])
            if created:
                adopted = {n.page for n in created}
                req.trie_nodes.extend(created)
                req.private_pages = [p for p in req.private_pages
                                     if p not in adopted]

    def _admit(self):
        """Move queued requests into free slots: look up the longest cached
        prompt prefix, allocate fresh pages for everything past it
        (copy-on-write — shared pages are never written), prefill the tail
        (or park a long cold prompt mid-prefill under chunk-interleaved
        admission) and seed the slot; publish the prompt's new full
        pages."""
        pc = self.prefix_cache
        while self._queue:
            # a mid-prefill slot is inactive but held (slot_req set)
            free = [i for i in range(self.slots)
                    if not self.active[i] and self.slot_req[i] is None]
            if not free:
                return
            slot = free[0]
            req = self._queue[0]
            n_total = math.ceil((req.bucket + req.max_new_tokens)
                                / self.page_size)
            # longest cached page-aligned prefix, capped so the prompt's
            # LAST token is always prefilled (its logits seed the first
            # token); no refcounts move until the admission is certain
            matched = (pc.match(req.prompt,
                                (req.prompt.size - 1) // self.page_size)
                       if pc is not None else [])
            full = len(matched)
            need = n_total - full
            if len(self._free_pages) < need and pc is not None:
                # pool pressure: reclaim cold cached pages (LRU, refcount 0
                # only; the just-matched path is about to be mounted)
                self._free_pages.extend(pc.evict(
                    need - len(self._free_pages), protect=matched))
            if len(self._free_pages) < need:
                # wait for a retirement to free pages (FIFO admission;
                # submit() guarantees a request fits an empty pool, and the
                # trie is fully evictable once its users retire)
                return
            self._queue.pop(0)
            fresh = [self._free_pages.pop() for _ in range(need)]
            if pc is not None:
                pc.note_admitted(full)
            if matched:
                pc.acquire(matched)
                req.trie_nodes = list(matched)
                req.prefix_tokens = full * self.page_size
            req.private_pages = list(fresh)
            req.pages = [n.page for n in matched] + fresh
            req.slot = slot
            req.state = "running"
            self.slot_req[slot] = req
            if (self.prefill_interleave_chunks > 0 and full == 0
                    and req.bucket > self.prefill_chunk):
                # chunk-interleaved admission: park the slot mid-prefill;
                # _prefill_tick spends the per-tick chunk budget on it.
                # Its decode-state arrays stay zeroed (idle to the decode
                # programs) until _finish_prefill. Prefix hits keep the
                # run-to-completion path
                self._partial[slot] = {"req": req, "caches": None,
                                       "next": 0,
                                       "padded": self._dev(
                                           self._padded(req))}
                continue
            self._seed_slot(slot, req)
            n_prefill = math.ceil(req.bucket / self.page_size)
            if full:
                tok, ok = self._build_prefill_hit(
                    req, full, req.pages[:full], req.pages[full:n_prefill])
            else:
                tok, ok = self._build_prefill(req, req.pages[:n_prefill])
            if self.draft_gen is not None:
                self._draft_prefill(req, full)
            self._publish(req, matched, full, ok)
            self.active[slot] = True
            self._record_token(slot, tok, ok)

    # ---- chunk-interleaved prefill ---------------------------------------

    def _prefill_tick(self):
        """Spend up to ``prefill_interleave_chunks`` prefill chunks this
        tick, round-robin across mid-prefill slots so concurrent long
        prompts make equal progress; a slot whose last chunk lands is
        finished (sampled and activated) inline."""
        budget = self.prefill_interleave_chunks
        while budget > 0 and self._partial:
            slots = sorted(self._partial)
            slot = slots[self._prefill_rr % len(slots)]
            self._prefill_rr += 1
            try:
                self._run_prefill_chunk(slot)
            except Exception as e:
                # the slot's pages go back and its request fails; the
                # error still reaches the caller
                self._retire(slot, "failed", f"{type(e).__name__}: {e}")
                raise
            budget -= 1
        if self._partial:
            # chunks remained when the tick's budget ran out: the decode
            # streams get the device back
            self._prefill_preempted_ticks += 1

    def _run_prefill_chunk(self, slot: int):
        """One prefill quantum: the slot's next chunk, cache-only — exactly
        one iteration of ``Generator._prefill``'s chunked loop, so the
        chunk sequence is the run-to-completion prefill's."""
        ps = self._partial[slot]
        req = ps["req"]
        st = ps["next"]
        chunk = self.prefill_chunk
        if st == 0:
            ps["caches"] = self._new_caches(self.gen, req.bucket)
        _, ps["caches"] = self.gen._walk(
            self.gen.params(), ps["padded"][:, st:st + chunk], ps["caches"],
            chunk_start=st, skip_tail=True)
        ps["next"] = st + chunk
        self._prefill_chunks_interleaved += 1
        if ps["next"] >= req.bucket:
            self._finish_prefill(slot)

    def _finish_prefill(self, slot: int):
        """The last interleaved quantum: the gather-last query of the
        prompt's true last position, the first token, the scatter of the
        bucket's k/v into the request's pages, the draft's prefill; then
        seed and activate the slot — from here on the request is a
        run-to-completion admission's (same pages, same first token, same
        published prefix)."""
        ps = self._partial.pop(slot)
        req = ps["req"]
        gen = self.gen
        length = self._dev(np.asarray([req.prompt.size], np.int32))
        tok_last = ps["padded"][:, req.prompt.size - 1:req.prompt.size]
        logits, caches = gen._walk(gen.params(), tok_last, ps["caches"],
                                   last_only=True, row_lengths=length,
                                   gather_last=True)
        tok, ok = self._first_token(logits, req)
        n_prefill = math.ceil(req.bucket / self.page_size)
        self._scatter_tail(gen, self.pool, caches,
                           self._dev(np.asarray(req.pages[:n_prefill],
                                                np.int32)))
        if self.draft_gen is not None:
            self._draft_prefill(req, 0)
        self._seed_slot(slot, req)
        self._publish(req, [], 0, ok)
        self.active[slot] = True
        self._record_token(slot, tok, ok)

    # ---- decode-side programs ------------------------------------------------

    def _program(self, key: tuple, build) -> _Program:
        """The decode-side program for ``key`` (("decode", n),
        ("draft_propose", k), ("verify", k)), built on first use — each
        build is a capture on the card, counted in ``recompiles``."""
        prog = self._programs.get(key)
        if prog is None:
            body, inputs = build()
            prog = self._programs[key] = _Program(body, inputs, self._stream)
            self.recompile_count += 1
        return prog

    def _static(self, **spec) -> Dict[str, torch.Tensor]:
        """Static input buffers on the device: name -> (shape, dtype)."""
        return {name: torch.zeros(shape, dtype=dtype, device=self.device)
                for name, (shape, dtype) in spec.items()}

    def _slot_inputs(self, **extra) -> Dict[str, torch.Tensor]:
        b, i32, f32 = self.slots, torch.int32, torch.float32
        spec = dict(page_table=((b, self.pages_per_slot), i32),
                    row_len=((b,), i32), prompt_pad=((b,), i32),
                    temps=((b,), f32), top_ps=((b,), f32),
                    top_ks=((b,), i32))
        spec.update(extra)
        return self._static(**spec)

    def _decode_inputs(self):
        b, i32 = self.slots, torch.int32
        return self._slot_inputs(
            last_tok=((b,), i32), write_pos0=((b,), i32),
            rope_pos0=((b,), i32), budget=((b,), i32), seeds=((b,), i32),
            ctr0=((b,), i32))

    def _decode_loop(self, gen, pool, x, n_steps: int, tag: int,
                     with_probs: bool):
        """``n_steps`` slot-decode steps of ``gen`` over ``pool`` from the
        static inputs ``x`` (the body of the JAX ``_build_decode`` /
        ``_build_draft_propose`` scans). Past a slot's own budget (its
        bucket + max_new_tokens) the write position and RoPE clamp to the
        final allocated position: those steps only produce tokens the host
        truncates, and the repeated overwrite stays in the slot's own
        pages. Step i samples draw ctr0 + i of the ``tag`` stream under
        each slot's own config. Returns (n_steps, slots) tokens and
        finiteness flags, or with ``with_probs`` tokens and the (n_steps,
        slots, V) sampling distributions."""
        params = gen.params()
        last_pos = x["budget"] - 1
        rope_cap = x["budget"] - x["prompt_pad"] + x["row_len"] - 1
        tok = x["last_tok"].long()
        toks, extra = [], []
        for i in range(n_steps):
            paged = {
                "page_table": x["page_table"],
                "write_pos": torch.minimum(x["write_pos0"] + i, last_pos),
                "rope_pos": torch.minimum(x["rope_pos0"] + i, rope_cap),
                "row_len": x["row_len"], "prompt_pad": x["prompt_pad"]}
            logits, _ = gen._walk(params, tok[:, None], pool, paged=paged)
            logits = logits[:, 0].float()                  # (slots, V)
            args = (logits, x["temps"], x["top_ps"], x["top_ks"],
                    x["seeds"], x["ctr0"] + i, tag)
            if with_probs:
                tok, probs = sampling_ops.sample_with_probs(*args)
                extra.append(probs)
            else:
                extra.append(torch.isfinite(logits).all(dim=-1))
                tok = sampling_ops.sample_tokens(*args)
            toks.append(tok)
        return torch.stack(toks), torch.stack(extra)

    def _build_decode(self, n_steps: int):
        """The decode chunk (the JAX ``_build_decode``): ``n_steps`` steps
        of the target on the TARGET stream; (n_steps, slots) tokens and
        finiteness flags."""
        x = self._decode_inputs()
        return (lambda: self._decode_loop(self.gen, self.pool, x, n_steps,
                                          sampling_ops.TAG_TARGET, False),
                x)

    def _build_draft_propose(self, k: int):
        """The draft's proposals (the JAX ``_build_draft_propose``): its
        own K-step decode over its pool on the DRAFT stream under each
        request's sampling config; the (k, slots) proposals and the draft's
        (k, slots, V) sampling distributions ``q``."""
        x = self._decode_inputs()
        return (lambda: self._decode_loop(self.draft_gen, self.draft_pool, x,
                                          k, sampling_ops.TAG_DRAFT, True),
                x)

    def _build_verify(self, k: int):
        """The verify pass (the JAX ``_build_verify``): the slab [last_tok,
        d_1 .. d_K] through the target, each position writing its k/v at
        its own host-clamped position and attending at its own frontier.
        Returns the target's argmax at every position (B, K + 1), its
        warped sampling distributions ``p`` (B, K + 1, V) and per-position
        finiteness."""
        b, s, i32 = self.slots, k + 1, torch.int32
        x = self._slot_inputs(slab=((b, s), i32), write_pos=((b, s), i32),
                              rope_pos0=((b,), i32))

        def body():
            paged = {"page_table": x["page_table"],
                     "write_pos": x["write_pos"], "rope_pos": x["rope_pos0"],
                     "row_len": x["row_len"], "prompt_pad": x["prompt_pad"]}
            logits, _ = self.gen._walk(self.gen.params(), x["slab"].long(),
                                       self.pool, paged=paged)
            logits = logits.float()                        # (B, K + 1, V)
            v = logits.shape[-1]
            probs = sampling_ops.sampling_probs(
                logits.reshape(b * s, v), x["temps"].repeat_interleave(s),
                x["top_ps"].repeat_interleave(s),
                x["top_ks"].repeat_interleave(s)).reshape(b, s, v)
            return (torch.argmax(logits, dim=-1), probs,
                    torch.isfinite(logits).all(dim=-1))

        return body, x

    # ---- decode ----------------------------------------------------------

    def _slot_decode_state(self):
        """(write_pos, rope_pos, budget) for one decode dispatch. Inactive
        slots: state arrays are zeroed, so write_pos = -1 would index page
        -1 — clamp to 0 (the write lands in scratch page 0) and give them
        budget 1, clamping every later step there too. Mid-prefill slots
        keep budget 1 likewise. Budget is the last legal write position + 1
        (bucket + the request's max_new_tokens)."""
        write_pos = np.maximum(self.prompt_pad + self.emitted - 1,
                               0).astype(np.int32)
        rope_pos = np.maximum(self.row_len + self.emitted - 1,
                              0).astype(np.int32)
        budget = np.ones((self.slots,), np.int32)
        for slot in range(self.slots):
            req = self.slot_req[slot]
            if req is not None and self.active[slot]:
                budget[slot] = req.bucket + req.max_new_tokens
        return write_pos, rope_pos, budget

    def _load_decode(self, prog: _Program, write_pos, rope_pos, budget):
        prog.load(page_table=self.page_tables, last_tok=self.last_tok,
                  write_pos0=write_pos, rope_pos0=rope_pos,
                  row_len=self.row_len, prompt_pad=self.prompt_pad,
                  budget=budget, temps=self.temps, top_ps=self.top_ps,
                  top_ks=self.top_ks, seeds=self.seeds, ctr0=self.emitted)

    def _decode_step(self):
        k = self.decode_chunk
        t0 = time.perf_counter()
        prog = self._program(("decode", k), lambda: self._build_decode(k))
        # the draw counter of a slot's next token is the count it has
        # emitted: slot- and engine-invariant
        self._load_decode(prog, *self._slot_decode_state())
        toks, oks = prog()
        toks, oks = toks.cpu().numpy(), oks.cpu().numpy()
        self._decode_seconds += time.perf_counter() - t0
        self.decode_steps += k
        for slot in range(self.slots):
            for t in range(k):
                if not self.active[slot]:
                    break  # retired mid-chunk: later tokens are truncated
                self._record_token(slot, int(toks[t, slot]),
                                   bool(oks[t, slot]))

    def _spec_step(self):
        """One speculative iteration (the JAX ``_spec_step``): the draft
        proposes K tokens a slot from its own distribution ``q`` (greedy
        slots: argmax), the target scores all K + 1 positions in one
        verify pass (argmax and the warped distribution ``p``), and the
        host applies the accept rule a slot:

          * greedy (temperature 0): the longest proposal prefix matching
            the target's argmax, plus the target's own next token — every
            emitted token is the target's argmax, so the stream is the
            non-speculative one at any K;
          * sampled: proposal i is accepted when ``u * q_i(d_i) <
            p_i(d_i)`` (strict; u an ACCEPT-stream uniform); the first
            rejection re-draws from the residual norm(max(p - q, 0)), and
            a fully accepted window draws its bonus token from ``p_K``.
            Emitted tokens are then distributed exactly as the
            non-speculative sampler's.

        k/v written for rejected positions sit past the slot's new write
        frontier and are overwritten before anything attends them. The
        probabilities stay on the device: only the proposals' p(d) and
        q(d) come to the host, and only when a sampled slot is live."""
        k = self.speculate_k
        t0 = time.perf_counter()
        write_pos, rope_pos, budget = self._slot_decode_state()
        ctr0 = self.emitted.astype(np.int32)
        sampled_live = bool(np.any(self.temps[self.active] > 0.0))
        prop = self._program(("draft_propose", k),
                             lambda: self._build_draft_propose(k))
        self._load_decode(prop, write_pos, rope_pos, budget)
        d_dev, d_probs = prop()
        d_toks = d_dev.cpu().numpy()                       # (k, slots)
        slab = np.concatenate([self.last_tok[:, None], d_toks.T],
                              axis=1).astype(np.int32)
        # per-position write slots clamped to each request's budget
        # (positions an emitted token attends never reach the clamp)
        pos = np.minimum(write_pos[:, None] + np.arange(k + 1)[None, :],
                         (budget - 1)[:, None]).astype(np.int32)
        ver = self._program(("verify", k), lambda: self._build_verify(k))
        ver.load(page_table=self.page_tables, slab=slab, write_pos=pos,
                 rope_pos0=rope_pos, row_len=self.row_len,
                 prompt_pad=self.prompt_pad, temps=self.temps,
                 top_ps=self.top_ps, top_ks=self.top_ks)
        t_dev, t_probs, t_oks = ver()
        t_toks, t_oks = t_dev.cpu().numpy(), t_oks.cpu().numpy()
        self.decode_steps += k + 1
        self._spec_dispatches += 1
        u = pd = qd = None
        if sampled_live:
            u = sampling_ops.accept_uniforms(
                torch.from_numpy(self.seeds), torch.from_numpy(ctr0),
                k).numpy()                                 # (slots, k)
            d_idx = d_dev.long()
            rows = torch.arange(self.slots, device=d_idx.device)[None, :]
            steps = torch.arange(k, device=d_idx.device)[:, None]
            pd = t_probs[rows, steps, d_idx].cpu().numpy()   # (k, slots)
            qd = d_probs[steps, rows, d_idx].cpu().numpy()
        # ---- the host-side accept rule
        accepts = np.zeros((self.slots,), np.int32)
        for slot in range(self.slots):
            if not self.active[slot]:
                continue
            accepted = 0
            if self.temps[slot] <= 0.0:
                while accepted < k \
                        and d_toks[accepted, slot] == t_toks[slot, accepted]:
                    accepted += 1
            else:
                # accept w.p. min(1, p/q): u * q < p, strict, so a proposal
                # outside the target's keep-set (p == 0) is always rejected
                while accepted < k and (u[slot, accepted]
                                        * float(qd[accepted, slot])
                                        < float(pd[accepted, slot])):
                    accepted += 1
            accepts[slot] = accepted
        res = None
        if sampled_live:
            # the residual re-draw, one pass for every sampled slot's
            # rejection or bonus draw, at the emitted token's index
            dev = t_probs.device
            acc = torch.from_numpy(accepts).to(dev).long()
            ar = torch.arange(self.slots, device=dev)
            p_rows = t_probs[ar, acc]
            q_rows = d_probs[torch.clamp(acc, max=k - 1), ar] \
                * (acc < k)[:, None]
            res = sampling_ops.residual_sample(
                p_rows, q_rows, torch.from_numpy(self.seeds).to(dev),
                torch.from_numpy(ctr0 + accepts).to(dev)).cpu().numpy()
        self._decode_seconds += time.perf_counter() - t0
        # ---- emit
        for slot in range(self.slots):
            if not self.active[slot]:
                continue
            accepted = int(accepts[slot])
            self._spec_proposed += k
            self._spec_accepted += accepted
            sampled = self.temps[slot] > 0.0
            for m in range(accepted + 1):
                if not self.active[slot]:
                    break  # retired mid-window: the rest is truncated
                if sampled:
                    tok = (int(d_toks[m, slot]) if m < accepted
                           else int(res[slot]))
                else:
                    tok = int(t_toks[slot, m])
                self._record_token(slot, tok, bool(t_oks[slot, m]))

    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduler tick: admit what fits, spend the tick's prefill
        chunks on mid-prefill slots, then one decode dispatch (a decode
        chunk, or a speculative iteration) if any slot is live. Returns
        whether work remains."""
        self._admit()
        self._prefill_tick()
        if self.active.any():
            if self.draft_gen is not None:
                self._spec_step()
            else:
                self._decode_step()
        return self.pending()

    def run(self, prompts=None, max_new_tokens: int = 32,
            **submit_kw) -> List[Request]:
        """Submit ``prompts`` (1-D int token arrays; ``submit_kw``:
        temperature / top_p / top_k / seed, forwarded to submit()) and
        drive the scheduler until the engine is idle; returns this call's
        requests in submission order (with prompts=None: whatever was
        pending)."""
        if prompts is not None:
            batch = [self.submit(p, max_new_tokens, **submit_kw)
                     for p in prompts]
        else:
            batch = [r for r in self.slot_req if r is not None] \
                + list(self._queue)
        while self.step():
            pass
        return batch

    # ---- observability -------------------------------------------------------

    def flush_prefix_cache(self) -> int:
        """Evict EVERY refcount-0 cached page back to the free list;
        returns the number reclaimed. For page-leak accounting: after the
        engine is idle and flushed, free_pages equals kv_pages - 1. Pages
        still mounted by live requests survive (and stay cached)."""
        if self.prefix_cache is None:
            return 0
        freed = self.prefix_cache.evict(self.num_pages, pressure=False)
        self._free_pages.extend(freed)
        return len(freed)

    def stats(self) -> Dict:
        ttfts = sorted(self._ttfts)

        def pct(p):
            if not ttfts:
                return 0.0
            return ttfts[min(len(ttfts) - 1, int(p * len(ttfts)))]

        now = kernels.launch_counts()
        pc = self.prefix_cache
        return {
            "requests": self._submitted,
            "completed": self._completed,
            "failed": self._failed,
            "tokens_generated": self._tokens_emitted,
            "decode_steps": self.decode_steps,
            # decode-side programs built (CUDA-graph captures on the card),
            # JAX's recompile count: flat once the keys are warm
            "recompiles": self.recompile_count,
            "graph_replays": sum(p.replays for p in self._programs.values()),
            # host time per decode step (each dispatch ends in a
            # device->host copy of its tokens, so this includes the device
            # work)
            "decode_step_ms": (1e3 * self._decode_seconds
                               / max(1, self.decode_steps)),
            "ttft_p50_ms": pct(0.50) * 1e3,
            "ttft_p99_ms": pct(0.99) * 1e3,
            "free_pages": len(self._free_pages),
            "kv_pages": self.num_pages,
            "kv_page_size": self.page_size,
            "serve_slots": self.slots,
            "paged_attention_impl": self.paged_attention_impl,
            # the quantized tier: what the pool and the weights are stored
            # as, what a token of KV costs (scales included), how many
            # tokens a GB of pool holds, and the capacity multiplier against
            # a bf16 pool of the same geometry
            "kv_cache_dtype": self.kv_cache_dtype,
            "weight_dtype": self.weight_dtype,
            "kv_pool_bytes": self._pool_bytes,
            "kv_bytes_per_token": round(self._kv_bytes_per_token, 3),
            "tokens_per_pool_gb": int((1 << 30) / self._kv_bytes_per_token),
            "kv_capacity_vs_bf16": round(
                self._bf16_bytes_per_token / self._kv_bytes_per_token, 3),
            # the prefix cache: pages the trie holds (warm, reclaimable at
            # refcount 0), pages mounted by more than one live request, and
            # the lookup ledger; prefix_refs_live must be 0 when idle
            "prefix_cache": pc is not None,
            "kv_pages_cached": pc.pages if pc else 0,
            "kv_pages_shared": pc.shared_pages() if pc else 0,
            "prefix_lookups": pc.lookups if pc else 0,
            "prefix_hits": pc.hits if pc else 0,
            "prefix_hit_rate": (round(pc.hits / max(1, pc.lookups), 4)
                                if pc else 0.0),
            "prefill_tokens_saved": pc.tokens_saved if pc else 0,
            "prefix_evictions": pc.evictions if pc else 0,
            "prefix_refs_live": pc.live_refs() if pc else 0,
            # chunk-interleaved admission: chunks run between decode
            # ticks, ticks a long prefill was preempted by the budget,
            # slots mid-prefill now
            "prefill_interleave_chunks": self.prefill_interleave_chunks,
            "prefill_chunks_interleaved": self._prefill_chunks_interleaved,
            "prefill_preempted_ticks": self._prefill_preempted_ticks,
            "prefill_partial_slots": len(self._partial),
            # speculation and sampling
            "speculate_k": self.speculate_k,
            "spec_proposed": self._spec_proposed,
            "spec_accepted": self._spec_accepted,
            "spec_accept_rate": round(
                self._spec_accepted / max(1, self._spec_proposed), 4),
            "spec_dispatches": self._spec_dispatches,
            "sampled_requests": self._sampled_requests,
            "serve_temperature": self.default_temperature,
            "serve_top_p": self.default_top_p,
            "serve_top_k": self.default_top_k,
            "kernel_launches": {k: now[k] - self._launch_base[k]
                                for k in now},
        }
