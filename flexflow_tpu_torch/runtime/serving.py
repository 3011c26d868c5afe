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
    kernel into a contiguous per-request cache; a hit gathers its prefix
    pages into the cache's front (dequantized from a quantized pool),
    prefills the tail with the grouped einsum attention and queries the
    prompt's last token. Either way the new k/v scatters into the slot's
    fresh pages with the prefill-write kernel.
  * QUANTIZED TIER (``kv_cache_dtype``, ``weight_dtype``): the pool stores
    bf16, or int8 / fp8 with one f32 scale per (page, kv head) — the
    paged-attention and prefill-write kernels dequantize and quantize —
    and the served weights may be int8 / fp8 with per-output-channel
    scales, quantized once at engine init.
  * Decode runs ``decode_chunk`` steps per host round trip as a Python
    loop; each attention layer reads the pool through the paged-attention
    kernel. Tokens a slot computes past its own eos/length are truncated
    by the host, so outputs do not depend on the chunk.

Per-slot cache layout: logical positions ``[0, row_len)`` hold the true
prompt, ``[row_len, prompt_pad)`` masked bucket padding, and decode tokens
append from ``prompt_pad``; RoPE positions stay logical
(``row_len + emitted``).

Greedy decoding only. The features of later slices (the prefix cache's
host tier, speculation, sampled streams, LoRA, chunked prefill) are
refused with ``NotImplementedError`` rather than ignored.
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
from flexflow_tpu_torch.ops.attention import kv_storage_dtype
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


def _refuse_later_slices(cfg, host_kv_pages, draft_model, speculate_k,
                         temperature, paged_attention_impl,
                         adapter_pool_pages, prefill_chunk,
                         prefill_interleave_chunks):
    """Knobs of later slices: a non-default value raises, it is never
    silently served as the default."""
    hp = host_kv_pages if host_kv_pages is not None else cfg.host_kv_pages
    if hp:
        raise not_ported(f"the prefix cache's host tier (host_kv_pages="
                         f"{hp})", "the trie keeps its pages in the pool "
                         "(host_kv_pages=0)")
    if draft_model is not None or (speculate_k or 0) > 0:
        raise not_ported("speculative decoding (draft_model/speculate_k)")
    if temperature is not None and temperature > 0:
        raise not_ported("sampling with temperature > 0",
                         "greedy decoding (temperature 0) only")
    impl = paged_attention_impl or cfg.paged_attention_impl
    if impl != "auto":
        raise not_ported(f"paged_attention_impl={impl!r}",
                         "'auto' (the CUDA kernel on the card, its plain "
                         "version on the CPU) is the only route")
    if adapter_pool_pages:
        raise not_ported("LoRA adapter serving (adapter_pool_pages)")
    if prefill_chunk:
        raise not_ported("chunked prefill (prefill_chunk)",
                         "prompts prefill whole")
    if prefill_interleave_chunks:
        raise not_ported("chunk-interleaved admission "
                         "(prefill_interleave_chunks)",
                         "prompts prefill whole at admission")


class ServingEngine:
    """Continuous-batching engine over a compiled FFModel decoder LM.

    Build once (after model.compile()); ``submit()`` requests and drive
    ``step()`` yourself, or hand ``run()`` a list of prompts. Knobs default
    to the model's FFConfig (serve_slots, kv_page_size, kv_pages,
    decode_buckets, serve_prefix_cache, kv_cache_dtype,
    serve_weight_dtype)."""

    def __init__(self, model, serve_slots: Optional[int] = None,
                 kv_page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 decode_buckets: Optional[List[int]] = None,
                 max_seq_len: int = 1024,
                 temperature: Optional[float] = None,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 decode_chunk: int = 8,
                 prefix_cache: Optional[bool] = None,
                 host_kv_pages: Optional[int] = None,
                 draft_model=None, speculate_k: Optional[int] = None,
                 paged_attention_impl: Optional[str] = None,
                 kv_cache_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 adapter_pool_pages: Optional[int] = None,
                 prefill_chunk: int = 0,
                 prefill_interleave_chunks: Optional[int] = None):
        cfg = model.config
        if model.params is None:
            raise ValueError("ServingEngine needs a compiled model "
                             "(FFModel.compile)")
        _refuse_later_slices(cfg, host_kv_pages, draft_model, speculate_k,
                             temperature, paged_attention_impl,
                             adapter_pool_pages, prefill_chunk,
                             prefill_interleave_chunks)
        self.model = model
        self.device = model.device
        self.slots = int(serve_slots or cfg.serve_slots)
        self.decode_chunk = max(1, int(decode_chunk))
        self.page_size = int(kv_page_size or cfg.kv_page_size)
        buckets = (decode_buckets if decode_buckets is not None
                   else cfg.decode_buckets)
        self.buckets = sorted(int(b) for b in buckets) if buckets else None
        self.max_seq_len = int(max_seq_len)
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

        self.gen = Generator(model, quantize=None if wd == "native" else wd)
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
        self.pool = {
            op.name: op.init_paged_cache(self.num_pages, self.page_size,
                                         self._cdtype, self.device,
                                         kv_dtype=self._kv_dtype_arg)
            for op in self.gen.attn_ops}
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

        self._queue: List[Request] = []
        self._next_rid = 0
        self.decode_steps = 0
        self._decode_seconds = 0.0
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._tokens_emitted = 0
        self._ttfts = collections.deque(maxlen=4096)
        # kernel launches are counted process-wide by the wrappers;
        # stats() reports them since this engine was built
        self._launch_base = kernels.launch_counts()

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
               temperature: Optional[float] = None) -> Request:
        """Queue one request (greedy: ``temperature`` must be 0)."""
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
        t, _, _ = sampling_ops.validate_sampling(
            temperature if temperature is not None else 0.0, 1.0, 0,
            "submit")
        if t > 0.0:
            raise not_ported("sampling with temperature > 0",
                             "greedy decoding (temperature 0) only")
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens), bucket=bucket,
                      t_submit=time.perf_counter())
        self._next_rid += 1
        self._submitted += 1
        self._queue.append(req)
        return req

    def pending(self) -> bool:
        return bool(self._queue) or bool(self.active.any())

    def _retire(self, slot: int, state: str, error: str = ""):
        req = self.slot_req[slot]
        req.state = state
        req.error = error
        req.t_done = time.perf_counter()
        if state == "done":
            self._completed += 1
        else:
            self._failed += 1
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

    # ---- device work ---------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A copy of host state on the device (never a view of it: the host
        arrays change while the tensors are in use)."""
        return torch.tensor(a, device=self.device)

    def _seed_prefix_caches(self, bucket: int, p0: int,
                            prefix_pages: torch.Tensor):
        """Fresh contiguous per-request caches with ``p0`` positions of
        cached prefix KV gathered READ-ONLY into their front (dequantized
        from a quantized pool, then in the compute dtype) — the shared half
        of every hit prefill."""
        caches = {}
        for op in self.gen.attn_ops:
            c = op.init_cache(1, bucket, self._cdtype, self.device)
            g = op.gather_paged_kv(self.pool[op.name], prefix_pages)
            for name in ("k", "v"):
                c[name][:, :p0] = g[name]
            caches[op.name] = c
        return caches

    def _scatter_tail(self, caches, pages: torch.Tensor, p0: int = 0):
        """Copy-on-write scatter: write each attention op's contiguous
        cache past position ``p0`` into ``pages`` — the request's own fresh
        pages, never shared ones. Every layer's cache is ready, so one
        prefill-write launch writes them all. ``p0 = 0`` is the cold
        (whole-bucket) case."""
        ops = self.gen.attn_ops
        pools = [self.pool[op.name] for op in ops]
        scales = {n: [p[n] for p in pools] if n in pools[0] else None
                  for n in ("k_scale", "v_scale")}
        kernels.paged_prefill_write_layers(
            [p["k"] for p in pools], [p["v"] for p in pools],
            [caches[op.name]["k"][:, p0:] for op in ops],
            [caches[op.name]["v"][:, p0:] for op in ops], pages,
            scales["k_scale"], scales["v_scale"])

    def _first_token(self, logits):
        logits = logits[:, -1]                             # (1, V)
        ok = torch.isfinite(logits).all(dim=-1)
        tok = sampling_ops.sample_tokens(logits)
        return int(tok[0]), bool(ok[0])

    def _build_prefill(self, req: Request, pages: List[int]):
        """Cold prefill of one request: walk the graph over the whole
        bucket-padded prompt, take the first token from the logits at the
        prompt's last position, scatter the k/v into the request's pages.
        Returns (token, logits finite)."""
        padded = np.full((1, req.bucket), self.pad_id, np.int32)
        padded[0, :req.prompt.size] = req.prompt
        caches = {op.name: op.init_cache(1, req.bucket, self._cdtype,
                                         self.device)
                  for op in self.gen.attn_ops}
        logits, caches = self.gen._prefill(
            self.gen.params(), self._dev(padded), caches,
            self._dev(np.asarray([req.prompt.size], np.int32)))
        out = self._first_token(logits)
        self._scatter_tail(caches, self._dev(np.asarray(pages, np.int32)))
        return out

    def _build_prefill_hit(self, req: Request, full: int,
                           prefix_pages: List[int], tail_pages: List[int]):
        """Prefix-hit prefill (the JAX ``_build_prefill_hit``): ``full``
        cached pages are gathered read-only into the front of a contiguous
        per-request cache, the tail slab [full * page_size, bucket) runs as
        one ``chunk_forward`` pass, a gather-last query scores the prompt's
        true last position, and only the tail k/v scatters out — into the
        request's fresh pages (the matched prefix's partial last page is
        re-materialized there too)."""
        gen = self.gen
        p0 = full * self.page_size
        params = gen.params()
        caches = self._seed_prefix_caches(
            req.bucket, p0, self._dev(np.asarray(prefix_pages, np.int64)))
        tail = np.full((1, req.bucket - p0), self.pad_id, np.int32)
        tail[0, :req.prompt.size - p0] = req.prompt[p0:]
        _, caches = gen._walk(params, self._dev(tail), caches,
                              chunk_start=p0, skip_tail=True)
        tok_last = self._dev(np.asarray([[req.prompt[-1]]], np.int32))
        logits, _ = gen._walk(
            params, tok_last, caches, last_only=True,
            row_lengths=self._dev(np.asarray([req.prompt.size], np.int32)),
            gather_last=True)
        out = self._first_token(logits)
        self._scatter_tail(caches,
                           self._dev(np.asarray(tail_pages, np.int32)), p0)
        return out

    def _admit(self):
        """Move queued requests into free slots: look up the longest cached
        prompt prefix, allocate fresh pages for everything past it
        (copy-on-write — shared pages are never written), prefill the tail
        and seed the slot; publish the prompt's new full pages."""
        pc = self.prefix_cache
        while self._queue:
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
            table = np.zeros((self.pages_per_slot,), np.int32)
            table[:n_total] = req.pages
            self.page_tables[slot] = table
            self.row_len[slot] = req.prompt.size
            self.prompt_pad[slot] = req.bucket
            self.emitted[slot] = 0
            n_prefill = math.ceil(req.bucket / self.page_size)
            if full:
                tok, ok = self._build_prefill_hit(
                    req, full, req.pages[:full], req.pages[full:n_prefill])
            else:
                tok, ok = self._build_prefill(req, req.pages[:n_prefill])
            if pc is not None and ok:
                # publish this prompt's FULL pages past the matched prefix
                # (a non-finite prefill never publishes); published pages
                # move from private to trie-owned
                last = req.prompt.size // self.page_size
                if last > full:
                    created = pc.insert(req.prompt, matched, full,
                                        req.pages[full:last])
                    if created:
                        adopted = {n.page for n in created}
                        req.trie_nodes.extend(created)
                        req.private_pages = [p for p in req.private_pages
                                             if p not in adopted]
            self.active[slot] = True
            self._record_token(slot, tok, ok)

    def _slot_decode_state(self):
        """(write_pos, rope_pos, budget) for one decode dispatch. Inactive
        slots: state arrays are zeroed, so write_pos = -1 would index page
        -1 — clamp to 0 (the write lands in scratch page 0) and give them
        budget 1, clamping every later step there too. Budget is the last
        legal write position + 1 (bucket + the request's max_new_tokens)."""
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

    def _build_decode(self, n_steps: int):
        """``n_steps`` slot-decode steps from the current slot state.
        Past a slot's own budget (prompt_pad + its max_new_tokens) the
        write position and RoPE clamp to the final allocated position —
        those steps only produce tokens the host truncates, and the
        repeated overwrite stays inside the slot's own pages. Returns the
        (n_steps, slots) tokens and finiteness flags on the host."""
        write_pos, rope_pos, budget = self._slot_decode_state()
        dev = self._dev
        page_table = dev(self.page_tables)
        row_len, prompt_pad = dev(self.row_len), dev(self.prompt_pad)
        wp0, rp0 = dev(write_pos), dev(rope_pos)
        last_pos = dev(budget - 1)
        rope_cap = dev(budget - self.prompt_pad + self.row_len - 1)
        tok = dev(self.last_tok).long()
        params = self.gen.params()
        toks, oks = [], []
        for i in range(n_steps):
            paged = {
                "page_table": page_table,
                "write_pos": torch.minimum(wp0 + i, last_pos),
                "rope_pos": torch.minimum(rp0 + i, rope_cap),
                "row_len": row_len, "prompt_pad": prompt_pad}
            logits, self.pool = self.gen._walk(params, tok[:, None],
                                               self.pool, paged=paged)
            logits = logits[:, 0]                          # (slots, V)
            oks.append(torch.isfinite(logits).all(dim=-1))
            tok = sampling_ops.sample_tokens(logits)
            toks.append(tok)
        return (torch.stack(toks).cpu().numpy(),
                torch.stack(oks).cpu().numpy())

    def _decode_step(self):
        k = self.decode_chunk
        t0 = time.perf_counter()
        toks, oks = self._build_decode(k)     # ends in a device->host copy
        self._decode_seconds += time.perf_counter() - t0
        self.decode_steps += k
        for slot in range(self.slots):
            for t in range(k):
                if not self.active[slot]:
                    break  # retired mid-chunk: later tokens are truncated
                self._record_token(slot, int(toks[t, slot]),
                                   bool(oks[t, slot]))

    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduler tick: admit what fits, then one decode chunk if
        any slot is live. Returns whether work remains."""
        self._admit()
        if self.active.any():
            self._decode_step()
        return self.pending()

    def run(self, prompts=None, max_new_tokens: int = 32) -> List[Request]:
        """Submit ``prompts`` (1-D int token arrays) and drive the
        scheduler until the engine is idle; returns this call's requests
        in submission order (with prompts=None: whatever was pending)."""
        if prompts is not None:
            batch = [self.submit(p, max_new_tokens) for p in prompts]
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
            # host time per decode step (each chunk ends in a device->host
            # copy of its tokens, so this includes the device work)
            "decode_step_ms": (1e3 * self._decode_seconds
                               / max(1, self.decode_steps)),
            "ttft_p50_ms": pct(0.50) * 1e3,
            "ttft_p99_ms": pct(0.99) * 1e3,
            "free_pages": len(self._free_pages),
            "kv_pages": self.num_pages,
            "kv_page_size": self.page_size,
            "serve_slots": self.slots,
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
            "kernel_launches": {k: now[k] - self._launch_base[k]
                                for k in now},
        }
