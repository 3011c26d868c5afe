"""Continuous-batching serving over a paged KV cache (the JAX package's
``runtime/serving.py`` ``ServingEngine`` and its ``RadixPrefixCache``).

  * ``serve_slots`` decode slots run as one (slots, 1) batch per decode
    step; the HOST scheduler admits queued prompts into free slots and
    retires rows on eos or length.
  * The KV cache is a POOL of ``(kv_pages, kv_page_size, KVH, Hd)`` pages
    with a per-slot page table. Pages are allocated at admission and freed
    at retirement; page 0 is a scratch page that inactive slots write.
  * RADIX PREFIX CACHE (``prefix_cache``, default on as in the JAX
    package): a page-granular trie over prompt prefixes. An admission
    mounts the longest cached page-aligned prefix of its prompt read-only
    and prefills only its tail; a finished prefill publishes its
    full-prompt pages; retirement decrefs them (they stay cached, warm,
    until pool pressure evicts them LRU-first). Copy-on-write lives in the
    allocator: every tail and decode write goes to the request's own fresh
    pages, never to a published one. The trie is namespaced by LoRA
    adapter and weight version (``version_ns``).
  * HOST TIER (``host_kv_pages``): pages evicted under pool pressure
    demote to pinned host memory (the snapshot is enqueued on the stream
    every later prefill write and graph replay runs on, an ordered
    publisher thread waits for it) and a match through a host-resident
    edge promotes the payload back bitwise before the admission mounts it.
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
  * LoRA ADAPTERS (``adapter_pool_pages``, ``lora_rank``,
    ``lora_targets``): registered adapters fault into a fixed device pool
    (``runtime/lora.py`` decides residency, ``ops/lora.py`` holds the
    pages); each slot's adapter page is data the programs gather, so
    tenants mix in one batch. Page 0 is the null adapter.
  * LIFECYCLE: one engine lock around ``step`` / ``submit`` / ``stats``;
    ``submit(deadline=)`` expires queued requests as "timeout";
    ``drain`` / ``reclaim_queued`` / ``reopen``; ``swap_weights`` (in
    place for a model's sole reader, nothing captured again; else onto the
    version's shared weight set, captured inside the swap); ``health`` and
    the lock-free ``load``;
    the prefix-slab handoff (``prefill_into_cache``,
    ``export_prefix_slab``, ``import_prefix_slab``: numpy page payloads in
    the JAX package's layout); ``warmup``.
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

Telemetry (``runtime/telemetry.py``, ``runtime/flightrec.py``): the TTFT,
inter-token and queue-wait histograms and per-request spans (queue_wait,
prefill, decode, decode_chunk) under the JAX engine's names, a
scrape-time collector exporting ``stats()`` as ``ff_serving_<key>``
gauges, and the flight recorder's bundle, HBM-ledger, SLO and health
sources, labeled (replica, role) — ``set_telemetry_identity`` sets the
fleet identity. Every value reported is a host value the engine already
holds: the plane adds no device synchronisation and nothing to a captured
program; ``FFConfig.telemetry="off"`` skips every emit.
"""

from __future__ import annotations

import collections
import gc
import heapq
import logging
import math
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops import lora as lora_ops
from flexflow_tpu_torch.ops import sampling as sampling_ops
from flexflow_tpu_torch.ops.attention import (MultiHeadAttention,
                                              kv_storage_dtype,
                                              resolve_paged_attention_impl)
from flexflow_tpu_torch.runtime import faultinject, flightrec, locks, telemetry
from flexflow_tpu_torch.runtime.generation import Generator
from flexflow_tpu_torch.runtime.lora import LoraAdapterPool

log = logging.getLogger(__name__)

# process-wide engine ids: the default telemetry `replica` label when no
# router assigns a fleet identity (set_telemetry_identity)
_ENGINE_IDS = iter(range(1 << 30))

#: the weight version every engine serves until ``swap_weights``; it salts
#: nothing, so cache keys and slab namespaces stay those of an engine that
#: never swapped
DEFAULT_WEIGHT_VERSION = "v0"


def version_ns(version, adapter=None):
    """The prefix-cache namespace of (weight version, LoRA adapter): KV
    depends on the weights that produced it, so cached prefixes never cross
    versions or adapters. The default version maps to the bare adapter
    (None for none), as in the JAX package."""
    if version in (None, "", DEFAULT_WEIGHT_VERSION):
        return adapter
    return (version, adapter)


#: numpy's names for the pool dtypes numpy has no type of its own for, and
#: how their bits travel: (numpy view torch shares, torch view, unsigned
#: numpy type the raw bits are written as)
_NUMPY_NAMES = {torch.bfloat16: "bfloat16",
                torch.float8_e4m3fn: "float8_e4m3fn"}
_RAW_BITS = {2: (np.int16, torch.int16, np.uint16),
             1: (np.uint8, torch.uint8, np.uint8)}


def payload_numpy(t: torch.Tensor) -> np.ndarray:
    """A page payload tensor as numpy in the JAX package's dtypes (bf16 and
    fp8 through ``ml_dtypes``, where it is installed; otherwise their raw
    bits as unsigned integers, which ``payload_tensor`` reads back)."""
    t = t.detach().cpu()
    name = _NUMPY_NAMES.get(t.dtype)
    if name is None:
        return t.numpy().copy()
    _, raw_t, raw_u = _RAW_BITS[t.element_size()]
    bits = t.view(raw_t).numpy().view(raw_u).copy()
    try:
        import ml_dtypes
    except ImportError:
        return bits
    return bits.view(getattr(ml_dtypes, name))


def payload_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A page payload (numpy in the JAX package's dtypes, or a tensor) as a
    tensor of the pool's ``dtype`` with the same bits; raises if it is
    stored as another dtype."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:
            a = a.copy()
        name = _NUMPY_NAMES.get(dtype)
        if name is None:
            t = torch.from_numpy(a)
        else:
            size = torch.empty((), dtype=dtype, device="cpu").element_size()
            raw_np, raw_t, raw_u = _RAW_BITS[size]
            if a.dtype.name not in (name, np.dtype(raw_u).name):
                raise ValueError(f"page payload stored as {a.dtype}, the "
                                 f"pool as {dtype}")
            t = torch.from_numpy(a.view(raw_np)).view(raw_t).view(dtype)
    if t.dtype != dtype:
        raise ValueError(f"page payload stored as {t.dtype}, the pool as "
                         f"{dtype}")
    return t


@dataclass
class Request:
    """One serving request and its lifecycle record."""

    rid: int
    prompt: np.ndarray              # (S,) int32, true (unpadded) prompt
    max_new_tokens: int
    state: str = "queued"       # queued | running | done | failed | timeout
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
    # the registered LoRA adapter (None = base model, null page 0) and the
    # adapter-pool page pinned for it while its slot is live
    adapter: Optional[str] = None
    adapter_page: int = 0
    # absolute time.perf_counter() deadline: a request still queued past
    # it retires "timeout" without prefilling; an admitted one runs on
    deadline: Optional[float] = None
    # telemetry: the trace id every span of this request carries (a
    # router passes its fleet id, so failover and handoff keep one tree);
    # t_last_tok clocks the inter-token histogram; decode_span is the open
    # decode span's handle (0 = none)
    trace_id: str = ""
    t_submit: float = 0.0
    t_last_tok: float = 0.0
    decode_span: int = 0
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
    refcount of live requests whose page tables reference it.

    ``tier`` is "hbm" (``page`` is a live pool page), "host" (demoted:
    ``page`` is -1 once the snapshot is enqueued and ``hostdata`` holds the
    pinned host copy, None while the publish is in flight), "dead" (a
    failed publish marked it for lazy reaping) or "reaped" (removed).
    ``gen`` is the migration generation: every demote / kill / promote
    bumps it, so a late publish of an abandoned migration is dropped."""

    __slots__ = ("chunk", "page", "parent", "children", "ref", "last_use",
                 "tier", "hostdata", "gen")

    def __init__(self, chunk, page, parent):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children = {}
        self.ref = 0
        self.last_use = 0
        self.tier = "hbm"
        self.hostdata = None
        self.gen = 0


def _publisher_main(cache_ref, cv, pending):
    """The host tier's publisher thread: publish demoted pages host-ward
    in submission order. It holds the cache only while it publishes, so a
    cache nobody else references (and the engine whose copies it calls)
    can be collected; the thread then ends."""
    while True:
        with cv:
            while not pending:
                if cache_ref() is None:
                    return
                cv.wait(1.0)
            item = pending.popleft()
        cache = cache_ref()
        if cache is None:
            return
        cache._publish(*item)
        del cache


class RadixPrefixCache:
    """Radix trie over prompt token prefixes at PAGE granularity (the JAX
    package's ``RadixPrefixCache``).

    Each trie edge is exactly ``page_size`` tokens, so a path of depth d
    names a d-page prompt prefix and maps it to the d pool pages holding
    its KV. A page's KV at position j depends only on tokens [0..j]
    (causal attention), so any request whose prompt starts with the same
    ``d * page_size`` tokens can mount those pages read-only and prefill
    just its tail. The first edge of a path may carry a namespace salt
    (``ns``: the LoRA adapter and the weight version the KV was computed
    under), so prefixes never cross tenants or weight versions.

    Ownership protocol (the copy-on-write rule lives HERE, not in the
    kernels): a page in the trie is never written again — its producer
    published it after its prefill, and every borrower's tail and decode
    writes land in freshly allocated pages past the matched prefix.
    ``ref`` counts live requests mounting the page; retirement decrefs. A
    refcount-0 page stays cached until ``evict()`` reclaims it under pool
    pressure, LRU-first.

    HOST TIER (``host_pages > 0``): a refcount-0 page reclaimed under
    pressure DEMOTES to host memory instead of dying — the node stays in
    the trie host-resident, its pool page frees at once, and the payload
    (target and draft pools, quantized scales included) publishes
    host-ward on ONE ordered publisher thread, which commits a payload
    only if the node's generation still matches. A match through a
    host-resident edge PROMOTES it back (``promote_path``: a fresh pool
    page, the payload written back bitwise). On every root-to-node path
    the tiers read ``hbm* host*``: demotion picks nodes with no HBM child,
    promotion walks root-down. The host tier is itself LRU-bounded at
    ``host_pages``. Failure policy (FF_FAULT ``d2h_fail@migrate:<n>`` /
    ``h2d_fail@promote:<n>``, or a copy that raises): a failed demotion
    kills the page as if there were no tier, a failed promotion kills the
    host copy and the admission prefills cold past it; each counts in
    ``demote_failures`` / ``promote_failures``. ``d2h`` / ``h2d`` are
    injected (the engine's device copies, or a test's fakes): the state
    machine itself never touches a device. All host-side."""

    def __init__(self, page_size: int, host_pages: int = 0,
                 d2h=None, h2d=None):
        self.page_size = int(page_size)
        self.root = _TrieNode(None, -1, None)
        self.pages = 0          # HBM-page-holding nodes currently cached
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
        # ---- host tier ----
        # d2h(pages) -> resolver() -> [payload, ...]: starts the copy of a
        # list of pool pages host-ward and returns what the publisher
        # calls for the payloads; h2d(pages, payloads) writes payloads
        # into fresh pool pages
        self.host_pages = int(host_pages)
        if self.host_pages < 0:
            raise ValueError(f"host_pages={host_pages}: must be >= 0")
        if self.host_pages and (d2h is None or h2d is None):
            raise ValueError("host_pages > 0 needs d2h and h2d callables")
        self.d2h = d2h
        self.h2d = h2d
        self.host_used = 0      # host-resident pages (pending included)
        self.demotions = 0
        self.promotions = 0
        self.demote_failures = 0
        self.promote_failures = 0
        self.host_evictions = 0  # host-LRU overflow kills (pages died)
        # the ordered publisher: _cv guards hostdata / gen / the queue
        # between that thread and the engine-lock holder; structural trie
        # changes happen under the engine lock only
        self._cv = locks.make_condition("prefix-cache")
        self._pending = collections.deque()
        self._inflight = 0
        self._publisher: Optional[threading.Thread] = None
        # depth-1 tier transitions (first-page chunk, "host" | "hbm" |
        # None): a router's tier-aware affinity feed
        self.tier_events = collections.deque(maxlen=4096)

    def _chunk(self, prompt, i: int, ns=None):
        ps = self.page_size
        tup = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
        if ns is not None and i == 0:
            # the namespace salts the FIRST edge, which partitions the
            # whole trie per (adapter, weight version)
            return ("ns", ns) + tup
        return tup

    @staticmethod
    def first_chunk(tokens, ns=None):
        """The trie's first-edge key for ``tokens`` (one page of prompt)
        under namespace ``ns``."""
        tup = tuple(int(t) for t in tokens)
        return (("ns", ns) + tup) if ns is not None else tup

    def match(self, prompt, max_pages: int, ns=None) -> List[_TrieNode]:
        """Longest cached page-aligned prefix of ``prompt``, capped at
        ``max_pages``; returns the node path root-down (possibly empty,
        host-resident nodes included). Takes no references and counts no
        hit: the caller commits with acquire() / note_admitted() once the
        admission is certain (a request that stays queued on pool pressure
        re-matches every tick and must leave refcounts and counters
        untouched)."""
        self._tick += 1
        node, path = self.root, []
        limit = min(int(max_pages), len(prompt) // self.page_size)
        for i in range(limit):
            child = node.children.get(self._chunk(prompt, i, ns))
            if child is None:
                break
            if child.tier == "dead":
                # a publish failed on the publisher thread, which only
                # marked the node: reap it here
                self._kill_subtree(child)
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
            if n.tier != "hbm":
                raise AssertionError(
                    f"acquire on a {n.tier}-tier page: host-resident "
                    f"prefix pages must be promoted before mounting")
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
               pages: List[int], ns=None) -> List[_TrieNode]:
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
            chunk = self._chunk(prompt, start + j, ns)
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

    def cached_paths(self) -> List[Tuple[np.ndarray, object, int]]:
        """Every root-to-leaf cached prefix, hottest first, as ``(tokens,
        ns, last_use)``: tokens rebuilt from the edge chunks (the first
        edge's salt peeled back into ``ns``). Leaves only — a leaf's path
        carries every interior page. Dead nodes prune their subtrees."""
        out = []
        for first, child in self.root.children.items():
            if first and first[0] == "ns":
                ns, toks0 = first[1], first[2:]
            else:
                ns, toks0 = None, first
            stack = [(child, toks0)]
            while stack:
                node, toks = stack.pop()
                if node.tier == "dead":
                    continue
                kids = [(c.chunk, c) for c in node.children.values()
                        if c.tier != "dead"]
                if not kids:
                    out.append((np.asarray(toks, np.int32), ns,
                                node.last_use))
                    continue
                for chunk, c in kids:
                    stack.append((c, toks + chunk))
        out.sort(key=lambda e: -e[2])
        return out

    def evict(self, need: int, protect=(), pressure: bool = True) \
            -> List[int]:
        """Reclaim up to ``need`` pool pages, oldest last_use first;
        returns the freed page ids. Without a host tier refcount-0 LEAVES
        die; with one and ``pressure=True`` a refcount-0 node with no HBM
        child DEMOTES instead (it stays in the trie host-resident). ``protect``
        excludes a just-matched path the caller is about to mount.
        Reclaiming a node may expose its parent — the sweep cascades.
        ``pressure=False`` (flush, leak accounting) kills every refcount-0
        leaf outright, host copies included, whatever ``need`` is, and
        stays out of the ``evictions`` pool-pressure signal."""
        keep = set(id(n) for n in protect)
        demote = pressure and self.host_pages > 0

        def reclaimable(n):
            if n.ref != 0 or id(n) in keep or n.tier == "reaped":
                return False
            if not pressure:
                return not n.children
            if n.tier != "hbm":
                return False
            if demote:
                # children need only be non-HBM: the path stays hbm* host*
                return all(c.tier != "hbm" for c in n.children.values())
            return not n.children

        heap = [(n.last_use, id(n), n) for n in self._iter_nodes()
                if reclaimable(n)]
        heapq.heapify(heap)
        freed: List[int] = []
        selected: List[_TrieNode] = []
        while heap and (len(freed) + len(selected) < need
                        or not pressure):
            _, _, n = heapq.heappop(heap)
            if not reclaimable(n):
                continue
            parent = n.parent
            if demote and n.tier == "hbm":
                if faultinject.active_plan().fire("d2h_fail", "migrate"):
                    # a failed demotion: the page dies as without a tier
                    self.demote_failures += 1
                    freed.extend(self._kill_subtree(n))
                else:
                    # mark now (the cascade must see a non-HBM child); the
                    # one batched snapshot below runs before any freed page
                    # can be reused
                    n.tier = "host"
                    n.hostdata = None
                    n.gen += 1
                    self.pages -= 1
                    self.host_used += 1
                    self.demotions += 1
                    self._tier_event(n, "host")
                    selected.append(n)
                self.evictions += 1
            else:
                freed.extend(self._kill_subtree(n))
                if pressure:
                    self.evictions += 1
            if parent is not self.root and reclaimable(parent):
                heapq.heappush(heap, (parent.last_use, id(parent), parent))
        # a failed demotion of a parent may have reaped an already selected
        # child, whose page that kill freed: it must not reach the snapshot
        selected = [n for n in selected if n.tier == "host"]
        if selected:
            freed.extend(self._demote_sweep(selected))
            # the host tier's capacity is enforced per sweep, once every
            # selected node's snapshot is enqueued
            self._make_host_room()
        return freed

    # ---- the HBM -> host tier state machine ---------------------------------

    def _tier_event(self, node, tier):
        if node.parent is self.root:
            self.tier_events.append((node.chunk, tier))

    def _kill_subtree(self, node) -> List[int]:
        """Remove ``node`` and its descendants (all non-HBM by the path
        invariant when a migration kills an interior node) from the trie;
        bumps every generation so late publishes are dropped. Returns the
        pool pages freed."""
        if node.tier == "reaped":
            return []
        if node.parent is not None \
                and node.parent.children.get(node.chunk) is node:
            del node.parent.children[node.chunk]
        self._tier_event(node, None)
        freed: List[int] = []
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.children = {}
            if n.ref:
                raise AssertionError(
                    f"killing a mounted prefix page (ref={n.ref})")
            if n.tier == "hbm":
                freed.append(n.page)
                self.pages -= 1
            elif n.tier in ("host", "dead"):
                self.host_used -= 1
                if n.page >= 0:
                    # selected for demotion, snapshot not yet enqueued: its
                    # pool page is still allocated
                    freed.append(n.page)
            n.tier = "reaped"
            n.page = -1
            n.hostdata = None
            n.gen += 1
        with self._cv:
            self._cv.notify_all()   # wake promoters waiting on this node
        return freed

    def _demote_sweep(self, nodes) -> List[int]:
        """One batched snapshot of a sweep's demotions, enqueued before the
        freed pages can be reused; the ordered publisher resolves it off
        the hot path. Returns the freed pool pages."""
        pages = [n.page for n in nodes]
        handle = self.d2h(list(pages))
        gens = []
        for n in nodes:
            n.page = -1
            gens.append(n.gen)
        with self._cv:
            self._pending.append((list(nodes), gens, handle))
            self._inflight += len(nodes)
            self._cv.notify_all()
        self._ensure_publisher()
        return pages

    def _make_host_room(self):
        """LRU within the host tier: past ``host_pages`` the oldest host
        LEAVES die for real (dead nodes first). Nodes whose snapshot is not
        enqueued yet (page still >= 0) are never victims."""
        while self.host_used > self.host_pages:
            cands = [n for n in self._iter_nodes()
                     if n.tier in ("host", "dead") and not n.children
                     and n.page < 0]
            if not cands:
                return
            cands.sort(key=lambda n: (0 if n.tier == "dead" else 1,
                                      n.last_use))
            for n in cands:
                if self.host_used <= self.host_pages:
                    break
                if n.tier == "reaped" or n.children:
                    continue
                self._kill_subtree(n)
                self.host_evictions += 1

    def promote(self, node, page) -> bool:
        """Write one host-resident node back into fresh pool ``page``; True
        on success (see promote_path)."""
        if node.tier == "hbm":
            return True
        return self.promote_path([node], [page]) == 1

    def promote_path(self, nodes, pages) -> int:
        """Promote host-resident ``nodes`` (a matched path's host tail,
        root-down) into ``pages``: a node whose promotion is injected to
        fail, or whose publish never landed, truncates the run and is
        killed (the caller prefills cold past it); then one batched
        ``h2d`` writes the rest back bitwise. Returns the number promoted;
        unused pages are the caller's."""
        ok_nodes, payloads = [], []
        for node in nodes:
            if node.tier != "host":
                break
            if faultinject.active_plan().fire("h2d_fail", "promote"):
                self.promote_failures += 1
                self._kill_subtree(node)
                break
            payload = self.host_payload(node)
            if payload is None:
                self.promote_failures += 1
                self._kill_subtree(node)
                break
            ok_nodes.append(node)
            payloads.append(payload)
        if not ok_nodes:
            return 0
        use = list(pages[:len(ok_nodes)])
        try:
            self.h2d(use, payloads)
        except Exception:   # noqa: BLE001 — a lost copy falls back cold
            self.promote_failures += 1
            for node in ok_nodes:
                self._kill_subtree(node)
            return 0
        for node, page in zip(ok_nodes, use):
            node.page = int(page)
            node.tier = "hbm"
            node.hostdata = None
            node.gen += 1   # drop any stale pending publish
            self.pages += 1
            self.host_used -= 1
            self.promotions += 1
            self._tier_event(node, "hbm")
        return len(ok_nodes)

    def host_payload(self, node, timeout: float = 60.0):
        """The node's host payload, waiting (bounded) for an in-flight
        publish; None if the node died or the publish never lands."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while node.tier == "host" and node.hostdata is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self._cv.wait(left)
            return node.hostdata if node.tier == "host" else None

    def _ensure_publisher(self):
        if self._publisher is None or not self._publisher.is_alive():
            self._publisher = threading.Thread(
                target=_publisher_main,
                args=(weakref.ref(self), self._cv, self._pending),
                daemon=True, name="ff-prefix-tier-publisher")
            self._publisher.start()

    def _publish(self, nodes, gens, handle):
        """Resolve one batch's snapshot (a wait, nothing launched), then
        commit each payload only if its node's generation still matches —
        an abandoned migration is dropped, never resurrected."""
        payloads, err = None, None
        try:
            payloads = handle()
        except Exception as e:  # noqa: BLE001 — a failed copy is a
            #   failed demotion: the pages die, serving continues
            err = e
        with self._cv:
            self._inflight -= len(nodes)
            for i, (node, gen) in enumerate(zip(nodes, gens)):
                if node.gen != gen or node.tier != "host":
                    continue
                if err is not None:
                    # removal needs the engine lock: mark for reaping
                    node.tier = "dead"
                    node.hostdata = None
                    self.demote_failures += 1
                else:
                    node.hostdata = payloads[i]
            self._cv.notify_all()

    def pending_migrations(self) -> int:
        with self._cv:
            return self._inflight

    def wait_migrations(self, timeout: float = 60.0) -> bool:
        """Quiesce the publisher: True when every submitted demotion has
        published or been dropped."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return True

    def forget(self, prompt, ns=None) -> List[int]:
        """Kill the deepest unmounted, childless tail of ``prompt``'s
        cached path (any tier); returns the freed pool pages."""
        path = self.match(prompt, len(prompt) // self.page_size, ns)
        freed: List[int] = []
        for n in reversed(path):
            if n.children or n.ref:
                break
            freed.extend(self._kill_subtree(n))
        return freed

    def flush_namespace(self, ns) -> List[int]:
        """Kill every cached page under namespace ``ns``, both tiers (an
        adapter is being replaced: KV of its old weights must never serve
        a hit for the new ones). Refuses while any of them is mounted.
        Returns the freed pool pages."""
        roots = [c for c in self.root.children.values()
                 if isinstance(c.chunk, tuple) and len(c.chunk) >= 2
                 and c.chunk[0] == "ns" and c.chunk[1] == ns]
        for node in roots:
            stack = [node]
            while stack:
                n = stack.pop()
                if n.ref:
                    raise ValueError(
                        f"adapter namespace {ns!r} has a mounted cached "
                        f"page (ref={n.ref}): drain its requests before "
                        f"replacing the adapter")
                stack.extend(n.children.values())
        freed: List[int] = []
        for node in roots:
            freed.extend(self._kill_subtree(node))
        return freed

    def drain_tier_events(self) -> List:
        """Pop the recorded depth-1 tier transitions."""
        out = []
        while self.tier_events:
            out.append(self.tier_events.popleft())
        return out

    def live_refs(self) -> int:
        return self._live_refs

    def shared_pages(self) -> int:
        """Pages mounted by more than one live request right now."""
        return self._shared


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
    decode_buckets, serve_prefix_cache, host_kv_pages, kv_cache_dtype,
    serve_weight_dtype, serve_temperature / serve_top_p / serve_top_k,
    serve_speculate_k, draft_model, prefill_interleave_chunks,
    paged_attention_impl, serve_adapter_pool_pages, serve_lora_rank).

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
                 lora_rank: Optional[int] = None,
                 lora_targets: Optional[List[str]] = None,
                 prefill_interleave_chunks: Optional[int] = None,
                 capture: bool = True):
        cfg = model.config
        if model.params is None:
            raise ValueError("ServingEngine needs a compiled model "
                             "(FFModel.compile)")
        # the sanitizer mode is read at lock creation: adopt
        # FFConfig.sanitize before this engine or its pools make a lock
        locks.configure(cfg)
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
        # ---- the prefix cache and its host tier: host_kv_pages > 0 demotes
        # pages evicted under pool pressure to pinned host memory, and a
        # match through a host-resident edge promotes them back
        hp = int(host_kv_pages if host_kv_pages is not None
                 else cfg.host_kv_pages)
        if hp < 0:
            raise ValueError(f"host_kv_pages={hp}: must be >= 0")
        if hp and not enable_prefix:
            raise ValueError(
                "host_kv_pages > 0 needs the radix prefix cache: the "
                "host tier lives UNDER the trie (prefix_cache=False "
                "engines have nothing to demote)")
        self.host_kv_pages = hp
        self.prefix_cache = (RadixPrefixCache(
            self.page_size, host_pages=hp, d2h=self._page_d2h,
            h2d=self._page_h2d) if enable_prefix else None)
        # pinned sources of H2D copies still in flight, with the event
        # that marks their end
        self._h2d_inflight: List[tuple] = []

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

        # ---- the paged LoRA adapter pool: a host allocator / LRU
        # (runtime/lora.py) decides residency, the device pool
        # (ops/lora.py) is written in place on a fault-in, and every
        # program gathers each slot's page (0 = the null adapter)
        app = int(adapter_pool_pages if adapter_pool_pages is not None
                  else cfg.serve_adapter_pool_pages)
        if app < 0:
            raise ValueError(
                f"adapter_pool_pages={app}: must be >= 0 (0 = no "
                f"adapter pool)")
        self.adapter_pool_pages = app
        self.lora = None
        self.lora_pool = None
        self.lora_rank = int(lora_rank if lora_rank is not None
                             else cfg.serve_lora_rank)
        if app > 0:
            targets = [op for op in model.ops
                       if op.op_type == OperatorType.OP_LINEAR]
            if lora_targets is not None:
                want = set(lora_targets)
                unknown = want - {op.name for op in targets}
                if unknown:
                    raise ValueError(
                        f"lora_targets {sorted(unknown)} are not Linear "
                        f"ops of this graph (Linear ops: "
                        f"{sorted(op.name for op in targets)})")
                targets = [op for op in targets if op.name in want]
            if not targets:
                raise ValueError(
                    "adapter_pool_pages > 0 but the graph has no "
                    "LoRA-targetable Linear ops")
            self._lora_targets = targets
            self.lora = LoraAdapterPool(app, self.lora_rank, targets)
            self.lora_pool = lora_ops.init_lora_pool(targets, app,
                                                     self.lora_rank,
                                                     self.device)
            self._zero_payload = lora_ops.zero_payload(targets,
                                                       self.lora_rank)

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
        # per-slot adapter-pool page (0 = the null adapter)
        self.lora_pages = np.zeros((n,), np.int32)

        self._queue: List[Request] = []
        self._draining = False
        # mid-prefill slots of chunk-interleaved admission: slot -> the
        # request, its chunk caches so far, the next chunk start and the
        # padded prompt. The slot is held (slot_req set) but inactive, so
        # decode dispatches see it as idle until _finish_prefill
        self._partial: Dict[int, dict] = {}
        self._prefill_rr = 0
        # the weight version served (salts the prefix-cache namespace): the
        # one model.params holds (another engine's native swap may stand),
        # and where the engine stands in a deploy: serving | swapping
        self.weight_version = (self.gen.served.version
                               or DEFAULT_WEIGHT_VERSION)
        self.deploy_state = "serving"
        self._weight_swaps = 0
        # the decode-side programs by key (CUDA graphs on the card), their
        # side stream, and how many were built (JAX's recompile_count);
        # warmup() arms the retrace sentinel: a new key after it is a
        # program built mid-traffic (runtime/locks.py)
        self._programs: Dict[tuple, _Program] = {}
        # the programs of every weight identity this engine served (the
        # WeightSet serial, 0 for model.params): ``_programs`` is the
        # current one's, so a swap back finds its programs again; and the
        # programs a shared-model swap captured inside its drained window
        self._program_sets: Dict[int, Dict[tuple, _Program]] = {
            0: self._programs}
        self._swap_captures = 0
        self._stream = (kernels.private_stream(self.device, self)
                        if capture and self.device.type == "cuda" else None)
        self.recompile_count = 0
        self._retrace = locks.RetraceSentinel()
        # ONE engine lock around every queue / slot / counter mutation, so
        # a router may drive the engine from one thread while others
        # submit, probe health() or read stats(); reentrant: step() holds
        # it across the tick
        self._lock = locks.make_rlock("engine")
        self._next_rid = 0
        self.decode_steps = 0
        self._decode_seconds = 0.0
        self._occupancy_sum = 0
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._timeouts = 0
        self._tokens_emitted = 0
        self._sampled_requests = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_dispatches = 0
        self._prefill_chunks_interleaved = 0
        self._prefill_preempted_ticks = 0
        # the slab handoff's ledger: prefill-only admissions, slabs
        # exported / imported and the pages imported
        self._prefill_only = 0
        self._slab_exports = 0
        self._slab_imports = 0
        self._import_pages = 0
        self._partial_slab_imports = 0
        self._adapter_requests: Dict[str, int] = {}
        self._adapter_spec: Dict[str, List[int]] = {}
        self._ttfts = collections.deque(maxlen=4096)
        # kernel launches are counted process-wide by the wrappers;
        # stats() reports them since this engine was built
        self._launch_base = kernels.launch_counts()

        # ---- the telemetry plane: the latency histograms are observed at
        # the event sites; everything stats() counts is exported by the
        # scrape-time collector (_tm_collect). telemetry="off" skips every
        # emit at one predicate
        self._tm_on = cfg.telemetry != "off"
        self._tm_labels = {"replica": f"engine{next(_ENGINE_IDS)}",
                           "role": "solo"}
        self._retrace.owner = self._tm_labels["replica"]
        self._tm_ch: Dict = {}
        # unconditional: configure() is how telemetry="off" reaches the
        # recorder's own gate
        flightrec.configure(cfg)
        if self._tm_on:
            if cfg.metrics_port:
                telemetry.start_http_server(cfg.metrics_port)
            self._tm_bind_children()
            telemetry.registry().add_collector(self._tm_collect)
            # bundle, HBM-ledger, SLO and health sources, all weakly held
            flightrec.recorder().attach_source(self._flightrec_source)
            flightrec.hbm_ledger().add_source(self._hbm_source)
            flightrec.slo_monitor().add_source(self._slo_source)
            flightrec.register_health_source(self._health_probe)

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

    # ---- telemetry -----------------------------------------------------------

    def set_telemetry_identity(self, replica, role: str):
        """Fleet identity for this engine's metric labels and trace track
        (a router stamps the replica index and role; a standalone engine
        keeps its process-unique engine id)."""
        self._tm_labels = {"replica": str(replica), "role": str(role)}
        self._retrace.owner = self._tm_labels["replica"]
        if self._tm_on:
            self._tm_bind_children()

    def _tm_bind_children(self):
        """Resolve the hot-path histogram children once an identity: a
        token's emit is then one predicate and one observe."""
        reg = telemetry.registry()
        lab = (self._tm_labels["replica"], self._tm_labels["role"])
        self._tm_ch = {
            "ttft": reg.histogram(
                "ff_serving_ttft_seconds",
                "engine submit -> first token",
                labels=("replica", "role")).labels(*lab),
            "itl": reg.histogram(
                "ff_serving_intertoken_seconds",
                "gap between consecutive emitted tokens",
                labels=("replica", "role")).labels(*lab),
            "queue": reg.histogram(
                "ff_serving_queue_wait_seconds",
                "engine queue wait: submit -> admission",
                labels=("replica", "role")).labels(*lab),
        }
        # per-adapter families: children resolved lazily an adapter label
        self._tm_fam_req = reg.counter(
            "ff_serving_requests_total",
            "requests submitted, labeled by LoRA adapter "
            "('none' = base model)",
            labels=("replica", "role", "adapter"))
        self._tm_fam_attft = reg.histogram(
            "ff_serving_adapter_ttft_seconds",
            "engine submit -> first token, labeled by LoRA adapter",
            labels=("replica", "role", "adapter"))
        self._tm_adapter_ch = {}

    def _tm_adapter(self, adapter: Optional[str]):
        key = adapter or "none"
        ch = self._tm_adapter_ch.get(key)
        if ch is None:
            lab = (self._tm_labels["replica"], self._tm_labels["role"],
                   key)
            ch = self._tm_adapter_ch[key] = (
                self._tm_fam_req.labels(*lab),
                self._tm_fam_attft.labels(*lab))
        return ch

    @property
    def _tm_track(self) -> str:
        return f"replica{self._tm_labels['replica']}"

    def _tm_collect(self, reg):
        """Scrape-time collector: every numeric stats() key as a
        ``ff_serving_<key>`` gauge labeled (replica, role), plus the
        engine's identity and weight version as info series."""
        st = self.stats()
        lab = (self._tm_labels["replica"], self._tm_labels["role"])
        for k, v in st.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            reg.gauge(f"ff_serving_{k}",
                      f"ServingEngine stats()['{k}']",
                      labels=("replica", "role")).labels(*lab).set(v)
        reg.gauge("ff_serving_engine_info",
                  "engine identity (value is always 1)",
                  labels=("replica", "role", "kv_cache_dtype",
                          "weight_dtype", "impl")).labels(
            *lab, st["kv_cache_dtype"], st["weight_dtype"],
            st["paged_attention_impl"]).set(1)
        reg.gauge("ff_replica_weight_version",
                  "weight version + deploy state per replica "
                  "(value is always 1)",
                  labels=("replica", "role", "version", "state")).labels(
            *lab, st["weight_version"], st["deploy_state"]).set(1)
        if self._adapter_spec:
            fam = reg.gauge(
                "ff_serving_spec_accept_rate_by_adapter",
                "speculative accept rate, labeled by LoRA adapter",
                labels=("replica", "role", "adapter"))
            with self._lock:
                rows = {k: (v[0], v[1])
                        for k, v in self._adapter_spec.items()}
            for name, (prop, acc) in rows.items():
                fam.labels(*lab, name).set(
                    round(acc / max(1, prop), 4))

    def _flightrec_source(self):
        """Post-mortem bundle payload: the stats / health snapshot (the
        recorder bounds a source that blocks behind a wedged tick)."""
        return (f"engine-{self._tm_labels['replica']}",
                {"stats": self.stats(), "health": self.health()})

    def _slo_source(self):
        """Lock-free counter reads for the ratio-floor SLOs."""
        pc = self.prefix_cache
        return (self._tm_labels["replica"], {
            "prefix_hits": pc.hits if pc else 0,
            "prefix_lookups": pc.lookups if pc else 0,
            "spec_accepted": self._spec_accepted,
            "spec_proposed": self._spec_proposed})

    def _hbm_source(self):
        """HBM-ledger row: the bytes this engine holds on the device (and
        in pinned host memory), per subsystem — sizes fixed for the
        engine's life."""
        def _nbytes(tree):
            if isinstance(tree, torch.Tensor):
                return tree.numel() * tree.element_size()
            vals = tree.values() if isinstance(tree, dict) else tree
            return sum(_nbytes(v) for v in vals)

        subs = {"kv_pool": self._pool_bytes}
        pc = self.prefix_cache
        if pc is not None and pc.host_pages:
            page_bytes = self._pool_bytes / max(1, self.num_pages)
            subs["kv_host_tier"] = int(pc.host_used * page_bytes)
        if self.draft_pool is not None:
            subs["kv_draft_pool"] = _nbytes(self.draft_pool)
        if self.lora_pool is not None:
            subs["adapter_pool"] = _nbytes(self.lora_pool)
        if self.gen.quantize:
            # a quantized serving copy is a separate device allocation
            subs["serve_weights"] = _nbytes(self.gen.params())
        dg = self.draft_gen
        if dg is not None and dg.quantize:
            subs["draft_weights"] = _nbytes(dg.params())
        return (f"engine-{self._tm_labels['replica']}", subs)

    def _health_probe(self):
        """Lock-free /healthz row (the load() discipline)."""
        return {"kind": "engine",
                "replica": self._tm_labels["replica"],
                "role": self._tm_labels["role"],
                "status": "draining" if self._draining else "up",
                "weight_version": self.weight_version,
                "deploy_state": self.deploy_state,
                **self.load()}

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
               deadline: Optional[float] = None,
               trace_id: Optional[str] = None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               top_k: Optional[int] = None,
               seed: Optional[int] = None,
               adapter: Optional[str] = None) -> Request:
        """Queue one request. Sampling knobs default to the engine's; the
        request's stream is a pure function of its seed (by default one
        derived from the engine seed and the request id). ``deadline`` is
        an absolute ``time.perf_counter()`` instant: a request still queued
        past it retires "timeout" without prefilling. ``adapter`` names a
        registered LoRA adapter. ``trace_id`` threads an existing fleet
        trace through this engine's spans (None mints an engine-local
        id)."""
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
        if adapter is not None:
            if self.lora is None:
                raise ValueError(
                    f"adapter={adapter!r}: this engine has no adapter "
                    f"pool (build with adapter_pool_pages > 0)")
            if adapter not in self.lora.registry:
                raise ValueError(
                    f"adapter {adapter!r} is not registered (known: "
                    f"{sorted(self.lora.registry)}) — register_adapter"
                    f" first")
        with self._lock:
            if self._draining:
                raise RuntimeError(
                    "ServingEngine is draining: new requests are not "
                    "admitted (health()['status'] says so)")
            req = Request(rid=self._next_rid, prompt=prompt,
                          max_new_tokens=int(max_new_tokens), bucket=bucket,
                          t_submit=time.perf_counter(), temperature=t,
                          top_p=p, top_k=k, deadline=deadline,
                          adapter=adapter,
                          seed=(int(seed) if seed is not None
                                else (self._seed_base + self._next_rid)
                                & 0x7FFFFFFF))
            req.trace_id = trace_id or (
                f"{self._tm_labels['replica']}-r{req.rid}")
            self._next_rid += 1
            self._submitted += 1
            if t > 0.0:
                self._sampled_requests += 1
            akey = adapter or "none"
            self._adapter_requests[akey] = \
                self._adapter_requests.get(akey, 0) + 1
            if self._tm_on:
                self._tm_adapter(adapter)[0].inc()
            self._queue.append(req)
        return req

    def pending(self) -> bool:
        with self._lock:
            return (bool(self._queue) or bool(self.active.any())
                    or bool(self._partial))

    def _retire(self, slot: int, state: str, error: str = ""):
        req = self.slot_req[slot]
        req.state = state
        req.error = error
        req.t_done = time.perf_counter()
        if state == "done":
            self._completed += 1
        elif state == "timeout":
            self._timeouts += 1
        else:
            self._failed += 1
        self._partial.pop(slot, None)
        if req.ttft:
            self._ttfts.append(req.ttft)
        # close the decode span (handle 0 = telemetry off or none open)
        telemetry.tracer().end(req.decode_span, state=state,
                               tokens=len(req.tokens),
                               **({"error": error} if error else {}))
        req.decode_span = 0
        # copy-on-write teardown: pages the trie owns (the matched prefix
        # and the pages this request published) are decref'd and stay
        # cached; only the request's private pages return to the free list
        if req.trie_nodes:
            self.prefix_cache.release(req.trie_nodes)
            req.trie_nodes = []
        self._free_pages.extend(req.private_pages)
        req.private_pages = []
        # unpin the adapter page (it stays resident, warm for the tenant's
        # next request, until adapter-pool pressure evicts it)
        if req.adapter is not None and self.lora is not None:
            self.lora.release(req.adapter)
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
        self.lora_pages[slot] = 0

    def _record_token(self, slot: int, tok: int, ok: bool):
        """Append a sampled token to the slot's request and retire on
        non-finite logits, eos, or length — shared by prefill/decode."""
        req = self.slot_req[slot]
        if not ok:
            self._retire(slot, "failed", "non-finite logits")
            return
        req.tokens.append(int(tok))
        self._tokens_emitted += 1
        now = time.perf_counter()
        if not req.ttft:
            req.ttft = now - req.t_submit
            if self._tm_on:
                self._tm_ch["ttft"].observe(req.ttft)
                self._tm_adapter(req.adapter)[1].observe(req.ttft)
        elif self._tm_on:
            # host-observed inter-token latency: a decode chunk's tokens
            # arrive together, so the chunk boundary carries the dispatch
            self._tm_ch["itl"].observe(now - req.t_last_tok)
        req.t_last_tok = now
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

    def _lora_1(self, adapter_page: int) -> Optional[Dict]:
        """The LoRA operand of a one-row prefill walk (None without a
        pool)."""
        if self.lora_pool is None:
            return None
        return {"pool": self.lora_pool,
                "pages": self._dev(np.asarray([adapter_page], np.int32))}

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
            self.prefill_chunk, lora=self._lora_1(req.adapter_page))
        out = self._first_token(logits, req)
        self._scatter_tail(self.gen, self.pool, caches,
                           self._dev(np.asarray(pages, np.int32)))
        return out

    def _hit_caches(self, gen, pool, req: Request, full: int,
                    prefix_pages: List[int], lora: Optional[Dict] = None):
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
                              chunk_start=p0, skip_tail=True, lora=lora)
        return caches

    def _build_prefill_hit(self, req: Request, full: int,
                           prefix_pages: List[int], tail_pages: List[int]):
        """Prefix-hit prefill (the JAX ``_build_prefill_hit``): the tail's
        cache pass (``_hit_caches``), a gather-last query scoring the
        prompt's true last position, and only the tail k/v scattered out —
        into the request's fresh pages (the matched prefix's partial last
        page is re-materialized there too)."""
        gen = self.gen
        lora = self._lora_1(req.adapter_page)
        caches = self._hit_caches(gen, self.pool, req, full, prefix_pages,
                                  lora)
        tok_last = self._dev(np.asarray([[req.prompt[-1]]], np.int32))
        logits, _ = gen._walk(
            gen.params(), tok_last, caches, last_only=True,
            row_lengths=self._dev(np.asarray([req.prompt.size], np.int32)),
            gather_last=True, lora=lora)
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
        self.lora_pages[slot] = req.adapter_page
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
        non-finite prefill never publishes) under the request's namespace;
        published pages move from private to trie-owned."""
        pc = self.prefix_cache
        if pc is None or not ok:
            return
        last = req.prompt.size // self.page_size
        if last > full:
            created = pc.insert(req.prompt, matched, full,
                                req.pages[full:last],
                                ns=self._cache_ns(req.adapter))
            if created:
                adopted = {n.page for n in created}
                req.trie_nodes.extend(created)
                req.private_pages = [p for p in req.private_pages
                                     if p not in adopted]

    def _cache_ns(self, adapter):
        """The trie namespace of this engine's prefixes under ``adapter``:
        the adapter and the weight version (``version_ns``)."""
        return version_ns(self.weight_version, adapter)

    def _expire_queued(self):
        """Retire queued requests whose deadline has passed as "timeout":
        they never prefill, hold no pages and cost no dispatch."""
        now = time.perf_counter()
        kept: List[Request] = []
        for req in self._queue:
            if req.deadline is not None and now >= req.deadline:
                req.state = "timeout"
                req.error = "deadline expired while queued"
                req.t_done = now
                self._timeouts += 1
                if self._tm_on:
                    telemetry.tracer().instant(
                        "timeout", trace_id=req.trace_id,
                        track=self._tm_track, where="engine_queue")
            else:
                kept.append(req)
        self._queue = kept

    def _admit(self):
        """Move queued requests into free slots: look up the longest cached
        prompt prefix (promoting its host-resident part), allocate fresh
        pages for everything past it (copy-on-write — shared pages are
        never written), pin the request's adapter page (faulting it in),
        prefill the tail (or park a long cold prompt mid-prefill under
        chunk-interleaved admission) and seed the slot; publish the
        prompt's new full pages."""
        self._expire_queued()
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
                                (req.prompt.size - 1) // self.page_size,
                                ns=self._cache_ns(req.adapter))
                       if pc is not None else [])
            full = len(matched)
            # each host-resident matched page needs a fresh pool page to
            # be promoted into before it can be mounted
            n_host = sum(1 for n in matched if n.tier != "hbm")
            need = n_total - full + n_host
            if len(self._free_pages) < need and pc is not None:
                # pool pressure: reclaim cold cached pages (LRU, refcount 0
                # only; they demote with a host tier; the just-matched path
                # is about to be mounted)
                self._free_pages.extend(pc.evict(
                    need - len(self._free_pages), protect=matched))
            if len(self._free_pages) < need:
                # wait for a retirement to free pages (FIFO admission;
                # submit() guarantees a request fits an empty pool, and the
                # trie is fully evictable once its users retire)
                return
            if n_host:
                # a failed promotion truncates the path: cold past it
                matched = self._promote_matched(matched)
                full = len(matched)
                need = n_total - full
                if len(self._free_pages) < need:
                    return
            adapter_page = 0
            if req.adapter is not None:
                # pin the tenant's adapter page, faulting it in on a miss;
                # a pool full of pinned pages leaves the request queued
                got = self.lora.checkout(req.adapter)
                if got is None:
                    return
                adapter_page, ent = got
                if ent is not None:
                    self._write_adapter_page(adapter_page, ent["payload"],
                                             ent["scale"])
            self._queue.pop(0)
            # the engine queue wait ends here; the prefill span opens here
            # and closes after the dispatch, tagged cold / hit
            tm = self._tm_on and telemetry.enabled()
            t_adm = time.perf_counter() if tm else 0.0
            if tm:
                wait = t_adm - req.t_submit
                self._tm_ch["queue"].observe(wait)
                telemetry.tracer().complete(
                    "queue_wait", req.t_submit, wait,
                    trace_id=req.trace_id, track=self._tm_track)
            # FF_FAULT=slow(<ms>)@serve:<n> stalls the n-th admission on
            # the host — the slow-replica drill (a deadline tighter than
            # <ms> expires while this request is in flight)
            if faultinject.active_plan().fire("slow", "serve"):
                # ffsan: allow(lock-across-blocking) — stalling this
                # replica's tick IS the slow() drill's point
                time.sleep((faultinject.active_plan().last_value or 0)
                           / 1e3)
            # FF_FAULT=slow(<ms>)@canary:<n>: the same stall, consumed only
            # while this engine is a deploy's canary — the canary SLO-
            # breach drill the RollingDeployer's soak must roll back
            if (self.deploy_state == "canary"
                    and faultinject.active_plan().fire("slow", "canary")):
                # ffsan: allow(lock-across-blocking) — the stall is the
                # injected breach itself
                time.sleep((faultinject.active_plan().last_value or 0)
                           / 1e3)
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
            req.adapter_page = adapter_page
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
                                           self._padded(req)),
                                       "tm": tm, "t_adm": t_adm}
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
            if tm:
                telemetry.tracer().complete(
                    "prefill", t_adm, time.perf_counter() - t_adm,
                    trace_id=req.trace_id, track=self._tm_track,
                    kind="hit" if full else "cold", bucket=req.bucket,
                    matched_pages=full, ok=bool(ok))
                req.decode_span = telemetry.tracer().begin(
                    "decode", trace_id=req.trace_id,
                    track=self._tm_track)
            self._publish(req, matched, full, ok)
            self.active[slot] = True
            self._record_token(slot, tok, ok)

    # ---- chunk-interleaved prefill ---------------------------------------

    def _prefill_tick(self):
        """Spend up to ``prefill_interleave_chunks`` prefill chunks this
        tick, round-robin across mid-prefill slots so concurrent long
        prompts make equal progress; a slot whose last chunk lands is
        finished (sampled and activated) inline. Deadlines are swept
        first: an expired mid-prefill request retires "timeout"."""
        if not self._partial:
            return
        now = time.perf_counter()
        for slot in sorted(self._partial):
            req = self._partial[slot]["req"]
            if req.deadline is not None and now >= req.deadline:
                self._abort_partial(slot, "timeout",
                                    "deadline expired mid-prefill")
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
                self._abort_partial(slot, "failed",
                                    f"{type(e).__name__}: {e}")
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
            chunk_start=st, skip_tail=True,
            lora=self._lora_1(req.adapter_page))
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
                                   gather_last=True,
                                   lora=self._lora_1(req.adapter_page))
        tok, ok = self._first_token(logits, req)
        n_prefill = math.ceil(req.bucket / self.page_size)
        self._scatter_tail(gen, self.pool, caches,
                           self._dev(np.asarray(req.pages[:n_prefill],
                                                np.int32)))
        if self.draft_gen is not None:
            self._draft_prefill(req, 0)
        self._seed_slot(slot, req)
        if ps["tm"]:
            telemetry.tracer().complete(
                "prefill", ps["t_adm"], time.perf_counter() - ps["t_adm"],
                trace_id=req.trace_id, track=self._tm_track,
                kind="interleaved", bucket=req.bucket, matched_pages=0,
                ok=bool(ok))
            req.decode_span = telemetry.tracer().begin(
                "decode", trace_id=req.trace_id, track=self._tm_track)
        self._publish(req, [], 0, ok)
        self.active[slot] = True
        self._record_token(slot, tok, ok)

    def _abort_partial(self, slot: int, state: str, error: str):
        """Retire a mid-prefill slot (deadline or failure): its chunk
        caches are dropped, its pages freed, and the request retires
        without decoding."""
        ps = self._partial[slot]
        if ps["tm"]:
            telemetry.tracer().complete(
                "prefill", ps["t_adm"], time.perf_counter() - ps["t_adm"],
                trace_id=ps["req"].trace_id, track=self._tm_track,
                kind="interleaved", aborted=state)
        self._retire(slot, state, error)

    # ---- the host tier's page copies ----------------------------------------

    def _tier_pools(self):
        """(payload key, pool) of every attention op's pool: the target's
        ("t", name) and the draft's ("d", name), which share page ids —
        the JAX engine's payload keys."""
        out = [(("t", op.name), self.pool[op.name])
               for op in self.gen.attn_ops]
        if self.draft_pool is not None:
            out += [(("d", op.name), self.draft_pool[op.name])
                    for op in self.draft_gen.attn_ops]
        return out

    def _page_d2h(self, pages):
        """Start the snapshot of pool ``pages`` host-ward (the JAX
        ``_page_d2h``): one ``index_select`` a pool array (target and
        draft, scales included) and its copy into pinned host memory,
        enqueued on the current stream — where every later prefill write
        and graph replay runs, so a freed page is read before it is
        reused — then an event. Returns the resolver the ordered publisher
        calls: it waits on the event (launching nothing) and hands back one
        payload dict a page."""
        idx = self._dev(np.asarray(pages, np.int64))
        cuda = self.device.type == "cuda"
        host = {}
        for key, cache in self._tier_pools():
            sub = {}
            for name, g in MultiHeadAttention.export_page(cache,
                                                          idx).items():
                if cuda:
                    h = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                    h.copy_(g, non_blocking=True)
                else:
                    h = g
                sub[name] = h
            host[key] = sub
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        n = len(pages)

        def resolve():
            if event is not None:
                event.synchronize()
            return [{key: {name: h[i] for name, h in sub.items()}
                     for key, sub in host.items()} for i in range(n)]

        return resolve

    def _page_h2d(self, pages, payloads):
        """Write page payloads (host tensors or the JAX package's numpy)
        into pool ``pages`` — the H2D of a promotion and of a slab import:
        each page's rows copied to the device (asynchronously from pinned
        memory) and written with ``import_page`` (``index_copy_``), bytes
        verbatim. The pinned sources stay referenced until an event after
        the copies has passed, whatever the host tier drops meanwhile."""
        self._h2d_inflight = [(e, p) for e, p in self._h2d_inflight
                              if not e.query()]
        idx = self._dev(np.asarray(pages, np.int64))
        for key, cache in self._tier_pools():
            stacked = {}
            for name in payloads[0][key]:
                pool = cache[name]
                dst = torch.empty((len(pages),) + tuple(pool.shape[1:]),
                                  dtype=pool.dtype, device=self.device)
                for i, p in enumerate(payloads):
                    dst[i].copy_(payload_tensor(p[key][name], pool.dtype),
                                 non_blocking=True)
                stacked[name] = dst
            MultiHeadAttention.import_page(cache, idx, stacked)
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self._h2d_inflight.append((event, payloads))

    def _promote_matched(self, matched):
        """Promote the host-resident tail of a matched path root-down
        (parents first keeps the hbm* host* invariant) through one batched
        H2D. The caller has reserved the free pages. A failed promotion
        truncates the path there — the admission prefills cold past it —
        and unused pages return to the free list."""
        host = [n for n in matched if n.tier != "hbm"]
        if not host:
            return matched
        n_hbm = len(matched) - len(host)
        pages = [self._free_pages.pop() for _ in host]
        k = self.prefix_cache.promote_path(host, pages)
        self._free_pages.extend(pages[k:])
        return matched[:n_hbm + k]

    # ---- LoRA adapters -------------------------------------------------------

    def register_adapter(self, name: str, weights: Dict,
                         alpha: Optional[float] = None) -> None:
        """Register a LoRA adapter: host weights ({Linear op name -> {"a":
        (in, rank), "b": (rank, out)}}, ops omitted get a zero delta;
        scale = alpha / rank, alpha defaulting to rank). It faults into a
        device page on its first ``submit(adapter=name)`` and stays
        resident (LRU at refcount 0). Re-registering replaces it (refused
        while live slots are pinned to it) and flushes its prefix-cache
        namespace: KV of the old weights must never serve the new ones."""
        if self.lora is None:
            raise RuntimeError(
                "this engine has no adapter pool: build with "
                "adapter_pool_pages > 0")
        with self._lock, kernels.device_section():
            replacing = name in self.lora.registry
            self.lora.register(name, weights, alpha)
            if replacing and self.prefix_cache is not None:
                self._free_pages.extend(
                    self.prefix_cache.flush_namespace(name))

    def _write_adapter_page(self, page: int, payload: Dict, scale: float):
        """Fault an adapter into pool ``page``, in place (the programs hold
        the pool's addresses); ops the adapter does not target get
        zeros."""
        buf = {op.name: payload.get(op.name, self._zero_payload[op.name])
               for op in self._lora_targets}
        lora_ops.write_adapter_page(self.lora_pool, page, buf, scale)

    # ---- decode-side programs ------------------------------------------------

    def _program(self, key: tuple, build) -> _Program:
        """The decode-side program for ``key`` (("decode", n),
        ("draft_propose", k), ("verify", k)), built on first use — each
        build is a capture on the card, counted in ``recompiles``. After
        ``warmup()`` the retrace sentinel records a new key (a variant the
        warmup did not reach; strict sanitizing raises)."""
        prog = self._programs.get(key)
        if prog is None:
            self._retrace.note_miss(key)
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
        if self.lora_pool is not None:
            spec["lora_pages"] = ((b,), i32)
        spec.update(extra)
        return self._static(**spec)

    def _decode_inputs(self):
        b, i32 = self.slots, torch.int32
        return self._slot_inputs(
            last_tok=((b,), i32), write_pos0=((b,), i32),
            rope_pos0=((b,), i32), budget=((b,), i32), seeds=((b,), i32),
            ctr0=((b,), i32))

    def _slot_lora(self, x) -> Optional[Dict]:
        """The LoRA operand of a slot program reading its ``lora_pages``
        input (None without a pool)."""
        if self.lora_pool is None:
            return None
        return {"pool": self.lora_pool, "pages": x["lora_pages"]}

    def _decode_loop(self, gen, pool, x, n_steps: int, tag: int,
                     with_probs: bool, lora: Optional[Dict] = None):
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
            logits, _ = gen._walk(params, tok[:, None], pool, paged=paged,
                                  lora=lora)
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
        of the target on the TARGET stream, each slot under its adapter;
        (n_steps, slots) tokens and finiteness flags."""
        x = self._decode_inputs()
        return (lambda: self._decode_loop(self.gen, self.pool, x, n_steps,
                                          sampling_ops.TAG_TARGET, False,
                                          self._slot_lora(x)),
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
                                       self.pool, paged=paged,
                                       lora=self._slot_lora(x))
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

    def _load_slots(self, prog: _Program, **arrays):
        """Load a slot program's inputs (the adapter pages where it reads
        them)."""
        if "lora_pages" in prog.inputs:
            arrays["lora_pages"] = self.lora_pages
        prog.load(**arrays)

    def _load_decode(self, prog: _Program, write_pos, rope_pos, budget):
        self._load_slots(prog, page_table=self.page_tables,
                         last_tok=self.last_tok, write_pos0=write_pos,
                         rope_pos0=rope_pos, row_len=self.row_len,
                         prompt_pad=self.prompt_pad, budget=budget,
                         temps=self.temps, top_ps=self.top_ps,
                         top_ks=self.top_ks, seeds=self.seeds,
                         ctr0=self.emitted)

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
                # occupancy counts useful slot-steps only
                self._occupancy_sum += 1
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
        self._load_slots(ver, page_table=self.page_tables, slab=slab,
                         write_pos=pos, rope_pos0=rope_pos,
                         row_len=self.row_len, prompt_pad=self.prompt_pad,
                         temps=self.temps, top_ps=self.top_ps,
                         top_ks=self.top_ks)
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
            req = self.slot_req[slot]
            arow = self._adapter_spec.setdefault(req.adapter or "none",
                                                 [0, 0])
            accepted = int(accepts[slot])
            self._spec_proposed += k
            self._spec_accepted += accepted
            arow[0] += k
            arow[1] += accepted
            sampled = self.temps[slot] > 0.0
            for m in range(accepted + 1):
                if not self.active[slot]:
                    break  # retired mid-window: the rest is truncated
                self._occupancy_sum += 1
                if sampled:
                    tok = (int(d_toks[m, slot]) if m < accepted
                           else int(res[slot]))
                else:
                    tok = int(t_toks[slot, m])
                self._record_token(slot, tok, bool(t_oks[slot, m]))

    def _decode_tick(self):
        tm = self._tm_on and telemetry.enabled()
        if tm:
            t0 = time.perf_counter()
            slots = int(self.active.sum())
            toks0 = self._tokens_emitted
        if self.draft_gen is not None:
            self._spec_step()
        else:
            self._decode_step()
        if tm:
            # one span a decode dispatch on the replica's track
            telemetry.tracer().complete(
                "decode_chunk", t0, time.perf_counter() - t0,
                track=self._tm_track, slots=slots,
                tokens=self._tokens_emitted - toks0)

    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduler tick under the engine lock: admit what fits
        (unless draining), spend the tick's prefill chunks on mid-prefill
        slots, then one decode dispatch (a decode chunk, or a speculative
        iteration) if any slot is live. Returns whether progressable work
        remains — on a draining engine only live and mid-prefill slots
        count, so a while-step loop always ends. An exception trips the
        flight recorder (after the lock is released) and propagates."""
        try:
            with self._lock, kernels.device_section():
                if not self._draining:
                    self._admit()
                self._prefill_tick()
                if self.active.any():
                    self._decode_tick()
                if self._draining:
                    out = bool(self.active.any()) or bool(self._partial)
                else:
                    out = self.pending()
        except Exception as e:
            if self._tm_on:
                flightrec.trip(
                    "engine_exception", exc=e,
                    replica=self._tm_labels["replica"],
                    error=f"{type(e).__name__}: {e}")
            raise
        if self._tm_on:
            # the SLO tick: one time compare until a window has elapsed
            flightrec.slo_monitor().maybe_evaluate()
        return out

    def run(self, prompts=None, max_new_tokens: int = 32,
            **submit_kw) -> List[Request]:
        """Submit ``prompts`` (1-D int token arrays; ``submit_kw``:
        temperature / top_p / top_k / seed / adapter / deadline, forwarded
        to submit()) and drive the scheduler until the engine is idle;
        returns this call's requests in submission order (with
        prompts=None: whatever was pending)."""
        if prompts is not None:
            batch = [self.submit(p, max_new_tokens, **submit_kw)
                     for p in prompts]
        else:
            batch = [r for r in self.slot_req if r is not None] \
                + list(self._queue)
        while self.step():
            pass
        return batch

    # ---- the prefix-slab handoff -----------------------------------------

    @torch.inference_mode()
    def prefill_into_cache(self, prompt,
                           adapter: Optional[str] = None) -> Optional[int]:
        """Prefill-only admission (the prefill half of a disaggregated
        fleet): the prompt's cold or prefix-hit prefill, its full pages
        published into the trie at refcount 0 — no slot held, no token
        emitted. The pages are then ``export_prefix_slab()``'s payload, or
        a warm local cache. Returns the number of full pages now cached
        for the prompt, or None when pool pressure or a non-finite prefill
        kept it from publishing."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if self.prefix_cache is None:
            raise RuntimeError(
                "prefill_into_cache needs the radix prefix cache "
                "(prefix_cache=False engines cannot publish pages)")
        bucket = self._bucket(prompt.size)
        if bucket > self.max_seq_len:
            raise ValueError(
                f"bucketed prompt ({bucket}) exceeds max_seq_len "
                f"{self.max_seq_len}")
        with self._lock, kernels.device_section():
            apage = 0
            if adapter is not None:
                if self.lora is None or adapter not in self.lora.registry:
                    raise ValueError(
                        f"adapter {adapter!r} is not registered on this "
                        f"engine")
                got = self.lora.checkout(adapter)
                if got is None:
                    return None     # adapter-pool pressure: fall back
                apage, ent = got
                if ent is not None:
                    self._write_adapter_page(apage, ent["payload"],
                                             ent["scale"])
            try:
                # the adapter is pinned only for the prefill
                return self._prefill_into_cache_locked(prompt, bucket,
                                                       adapter, apage)
            finally:
                if adapter is not None:
                    self.lora.release(adapter)

    def _prefill_into_cache_locked(self, prompt, bucket: int,
                                   adapter: Optional[str], apage: int):
        pc = self.prefix_cache
        ps = self.page_size
        last = prompt.size // ps        # publishable full pages
        ns = self._cache_ns(adapter)
        matched = pc.match(prompt, (prompt.size - 1) // ps, ns=ns)
        full = len(matched)
        if last <= full:
            return last                 # already fully published
        n_prefill = math.ceil(bucket / ps)
        n_host = sum(1 for n in matched if n.tier != "hbm")
        need = n_prefill - full + n_host
        if len(self._free_pages) < need:
            self._free_pages.extend(pc.evict(
                need - len(self._free_pages), protect=matched))
            if len(self._free_pages) < need:
                return None
        if n_host:
            matched = self._promote_matched(matched)
            full = len(matched)
            if last <= full:
                return last
            if len(self._free_pages) < n_prefill - full:
                return None
        fresh = [self._free_pages.pop() for _ in range(n_prefill - full)]
        # a greedy stand-in request carries the prompt through the same
        # prefill paths as an admission; its token is discarded
        req = Request(rid=-1, prompt=prompt, max_new_tokens=1, bucket=bucket,
                      adapter=adapter, adapter_page=apage,
                      pages=[n.page for n in matched] + fresh)
        if full:
            _, ok = self._build_prefill_hit(req, full, req.pages[:full],
                                            fresh)
        else:
            _, ok = self._build_prefill(req, fresh)
        if self.draft_gen is not None:
            # the slab must carry the draft pool's prefix KV too
            self._draft_prefill(req, full)
        if not ok:
            # a non-finite prefill never publishes
            self._free_pages.extend(fresh)
            return None
        created = pc.insert(prompt, matched, full, req.pages[full:last],
                            ns=ns)
        # the publisher holds no mount: the pages sit warm at refcount 0
        pc.release(created)
        adopted = {n.page for n in created}
        self._free_pages.extend(p for p in fresh if p not in adopted)
        self._prefill_only += 1
        return last

    def export_prefix_slab(self, prompt, adapter: Optional[str] = None,
                           start_page: int = 0) -> Optional[Dict]:
        """The prompt's cached full-page prefix as a host page slab — what
        a prefill -> decode handoff moves: {"page_size", "tokens", "ns",
        "start_page", "payload": [one dict a page: {("t" | "d", op name):
        {"k", "v"[, "k_scale", "v_scale"]}}]}, numpy in the JAX package's
        layout and dtypes, bytes verbatim (target and draft pools,
        quantized scales). Host-tier pages export from their host copies.
        None when the prefix is not fully cached. ``start_page`` > 0
        exports only pages [start_page, last) (a partial-prefix slab);
        ``tokens`` still names the whole prefix."""
        return self._export_slab_ns(prompt, self._cache_ns(adapter),
                                    start_page)

    def _export_slab_ns(self, prompt, ns, start_page: int = 0) \
            -> Optional[Dict]:
        """export_prefix_slab under an explicit namespace."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock, kernels.device_section():
            if self.prefix_cache is None:
                return None
            last = prompt.size // self.page_size
            if start_page < 0 or start_page >= last:
                if start_page == 0:
                    return None     # last < 1: nothing page-aligned
                raise ValueError(
                    f"start_page={start_page}: must be in [0, {last}) "
                    f"for this prompt's {last} full prefix pages")
            path = self.prefix_cache.match(prompt, last, ns=ns)
            if len(path) < last:
                return None
            tail = path[start_page:]
            hbm = [n for n in tail if n.tier == "hbm"]
            with torch.inference_mode():
                got = (self._page_d2h([n.page for n in hbm])()
                       if hbm else [])
            by_node = {id(n): p for n, p in zip(hbm, got)}
            payloads = []
            for node in tail:
                if node.tier == "host":
                    payload = self.prefix_cache.host_payload(node)
                    if payload is None:
                        return None
                else:
                    payload = by_node[id(node)]
                payloads.append({key: {name: payload_numpy(t)
                                       for name, t in sub.items()}
                                 for key, sub in payload.items()})
            self._slab_exports += 1
            return {"page_size": self.page_size,
                    "tokens": prompt[:last * self.page_size].copy(),
                    "ns": ns,
                    "start_page": int(start_page),
                    "payload": payloads}

    def import_prefix_slab(self, slab) -> int:
        """Decode-side handoff: write a peer's page slab (this package's or
        the JAX package's) into this engine's pools and publish its chunks
        into the trie at refcount 0, so a later ``submit()`` of the prompt
        admits as a prefix hit. Chunks already cached are skipped; returns
        the number of pages written. A partial-prefix slab (``start_page``
        > 0) extends an already imported path, and is refused (0) before
        its predecessors are in."""
        with self._lock, kernels.device_section():
            if self.prefix_cache is None:
                return 0
            if int(slab["page_size"]) != self.page_size:
                raise ValueError(
                    f"slab page_size {slab['page_size']} != engine "
                    f"page_size {self.page_size}: fleet replicas must "
                    f"share the pool geometry")
            if not slab["payload"]:
                return 0
            have_draft = any(k[0] == "d" for k in slab["payload"][0])
            if have_draft != (self.draft_pool is not None):
                raise ValueError(
                    "slab draft-pool payload mismatch: exporter and "
                    "importer must agree on speculation")
            # the payload must be stored exactly as this pool is: a
            # mismatch would publish garbage served as a prefix hit
            p0 = slab["payload"][0]
            for op in self.gen.attn_ops:
                sub = p0.get(("t", op.name))
                if sub is None:
                    raise ValueError(
                        f"slab payload missing attention op {op.name!r}:"
                        f" exporter and importer must run the same "
                        f"model")
                pool = self.pool[op.name]
                try:
                    pk = payload_tensor(sub["k"], pool["k"].dtype)
                except ValueError:
                    pk = None
                if pk is None or tuple(pk.shape) != tuple(pool["k"].shape[1:]):
                    raise ValueError(
                        f"slab payload for {op.name!r} is "
                        f"{np.asarray(sub['k']).dtype}"
                        f"{tuple(np.shape(sub['k']))} but this engine's "
                        f"pool stores {pool['k'].dtype}"
                        f"{tuple(pool['k'].shape[1:])}: fleet replicas must "
                        f"share kv_cache_dtype and pool geometry")
                if ("k_scale" in pool) != ("k_scale" in sub):
                    raise ValueError(
                        f"slab scale presence mismatch for {op.name!r}: "
                        f"quantized and full-width pools cannot exchange"
                        f" pages")
            tokens = np.asarray(slab["tokens"], np.int32).reshape(-1)
            ns = slab.get("ns")
            sp = int(slab.get("start_page", 0))
            n = sp + len(slab["payload"])
            pc = self.prefix_cache
            path = pc.match(tokens, n, ns=ns)
            if len(path) < sp:
                return 0    # a gap before this partial slab
            # extend only a fully HBM-resident path (hbm* host*): a
            # host-resident tail means the prefix is cached already
            if any(nd.tier != "hbm" for nd in path):
                return 0
            start = len(path)
            missing = n - start
            if missing <= 0:
                return 0
            if len(self._free_pages) < missing:
                self._free_pages.extend(pc.evict(
                    missing - len(self._free_pages), protect=path))
            take = min(missing, len(self._free_pages))
            if take <= 0:
                return 0
            pages = [self._free_pages.pop() for _ in range(take)]
            with torch.inference_mode():
                self._page_h2d(pages, slab["payload"][start - sp:
                                                      start - sp + take])
            imported = 0
            node_path = list(path)
            for j, page in enumerate(pages, start=start):
                created = pc.insert(tokens, node_path, j, [page], ns=ns)
                if not created:
                    break
                pc.release(created)
                node_path.extend(created)
                imported += 1
            self._free_pages.extend(pages[imported:])
            if imported:
                self._slab_imports += 1
                self._import_pages += imported
                if sp > 0:
                    self._partial_slab_imports += 1
            return imported

    def cached_prefix_manifest(self) -> List[Tuple[np.ndarray, object]]:
        """``(tokens, ns)`` of every cached root-to-leaf prefix, hottest
        first, each under its namespace (an evacuating replica re-exports
        them with ``export_prefix_path``)."""
        with self._lock:
            if self.prefix_cache is None:
                return []
            return [(t, ns) for t, ns, _ in
                    self.prefix_cache.cached_paths()]

    def export_prefix_path(self, tokens, ns) -> Optional[Dict]:
        """One manifest entry re-exported under its namespace; None when
        its pages were evicted since."""
        return self._export_slab_ns(tokens, ns)

    def warm_page_import(self, prompt) -> bool:
        """Run the page-import path once (host-tier promotion and slab
        import share it): publish the prompt's prefix, export it, forget
        it, import it back — the trie ends as it started. Exempt from the
        retrace sentinel (a deliberate warm-path build)."""
        with self._lock, self._retrace.suspended(), \
                kernels.device_section():
            if self.prefix_cache is None:
                return False
            prompt = np.asarray(prompt, np.int32).reshape(-1)
            if prompt.size < self.page_size:
                return False
            if self.prefill_into_cache(prompt) is None:
                return False
            slab = self.export_prefix_slab(prompt)
            if slab is None:
                return False
            self._free_pages.extend(self.prefix_cache.forget(prompt))
            return self.import_prefix_slab(slab) > 0

    def warmup(self, prompts, max_new_tokens: int = 4) -> Dict:
        """Drive every program this prompt set reaches: pass 1 runs every
        prompt (cold prefills, the hits submission order reaches, the
        decode / proposal / verify programs), pass 2 repeats them against
        the published trie; with speculation the sampled-speculation
        helpers run once, with a host tier the page-import path. Then the
        program set is closed: a program built later counts in
        ``stats()["sanitizer_retraces"]``. Returns {"programs": programs
        built (CUDA-graph captures on the card), "requests", "variants":
        the program keys}."""
        plist = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        self._retrace.armed = False
        before = self.recompile_count
        req0 = self._submitted
        self.run(list(plist), max_new_tokens=max_new_tokens)
        if self.speculate_k > 0 and self.draft_gen is not None:
            # the sampled accept rule's helpers run only while a sampled
            # slot is live: run them once (pure functions)
            with torch.inference_mode():
                sampling_ops.accept_uniforms(
                    torch.from_numpy(self.seeds),
                    torch.from_numpy(self.emitted.astype(np.int32)),
                    self.speculate_k)
                uni = torch.full((self.slots, self._vocab),
                                 1.0 / self._vocab, device=self.device)
                sampling_ops.residual_sample(
                    uni, torch.zeros_like(uni),
                    self._dev(self.seeds), self._dev(self.emitted))
        if self.prefix_cache is not None:
            self.run(list(plist), max_new_tokens=max_new_tokens)
            if self.host_kv_pages:
                cand = max((p for p in plist if p.size >= self.page_size),
                           key=lambda p: p.size, default=None)
                if cand is None or not self.warm_page_import(cand):
                    log.warning(
                        "serving: warmup could not run the page-import "
                        "path (no full-page prompt, pool pressure, or "
                        "nothing to re-import)")
        if self._tm_on:
            # restart the SLO window clock past the warmup: a warmup's
            # capture-inflated TTFT is never judged as a breach
            flightrec.slo_monitor().rebaseline()
        self._retrace.arm()
        return {"programs": self.recompile_count - before,
                "requests": self._submitted - req0,
                "variants": sorted(self._programs.keys(), key=repr)}

    def drain_tier_events(self) -> List:
        """Pop the trie's depth-1 tier transitions."""
        if self.prefix_cache is None:
            return []
        with self._lock:
            return self.prefix_cache.drain_tier_events()

    # ---- the lifecycle -------------------------------------------------------

    def drain(self) -> Dict:
        """Graceful shutdown: stop admitting, run the decode loop until
        every in-flight slot (mid-prefill ones included) retires, quiesce
        the host tier's publisher, and return a final stats snapshot.
        Queued requests stay queued (``reclaim_queued`` hands them back).
        Idempotent."""
        with self._lock:
            self._draining = True
        while True:
            # the lock a tick at a time: submit() callers get a prompt
            # RuntimeError instead of waiting out the drain
            with self._lock, torch.inference_mode(), \
                    kernels.device_section():
                if not self.active.any() and not self._partial:
                    break
                self._prefill_tick()
                if self.active.any():
                    self._decode_tick()
        if self.prefix_cache is not None:
            self.prefix_cache.wait_migrations()
        with self._lock:
            snap = self.stats()
            snap["drained"] = True
            snap["queued"] = len(self._queue)
        return snap

    def reclaim_queued(self) -> List[Request]:
        """Take every queued, never admitted request out of the engine and
        return it, untouched, for the caller to submit elsewhere."""
        with self._lock:
            out = list(self._queue)
            del self._queue[:]
            return out

    def reopen(self):
        """Admit again after a drain(); idempotent."""
        with self._lock:
            self._draining = False
            if self.deploy_state == "draining":
                self.deploy_state = "serving"

    def swap_weights(self, params, version: str) -> Dict:
        """Hot-swap the served weights (the JAX ``swap_weights``):
        ``params`` ({op: {weight: tensor}} matching model.params, or None
        for the construction weights) becomes what this engine serves, and
        the prefix cache is flushed (its KV is stale). The engine must hold
        no live or mid-prefill slot. Three ways, by who else reads the
        weights:

          * a quantized tier re-quantizes into its own buffers (private);
          * this engine is model.params' sole reader (and no engine serves
            ``version`` from a weight set): the weights are written into
            model.params in place, so every captured program serves them
            and nothing is captured (``Generator.set_params``);
          * others read model.params (another engine, a draft user,
            ``FFModel.generate``), or this engine already serves a weight
            set, or others serve ``version`` from one: it moves to ``version``'s
            per-version WeightSet, allocated once and shared with every
            engine swapped to that version, freed with its last reader.
            model.params is untouched. The engine re-captures its decode
            and verify programs against the set's addresses here, inside
            the drained window — ``stats()["swap_captures"]`` — and keeps
            each weight identity's programs, so a swap back to weights it
            served (``params=None``, or a version still live) captures
            nothing.

        FF_FAULT ``swap_fail@deploy:<n>`` fails after the install: the
        prior weights are restored and the error raised."""
        with self._lock, kernels.device_section():
            if self.active.any() or self._partial:
                raise RuntimeError(
                    "swap_weights: engine has live slots — drain() first "
                    "(a mid-stream weight change corrupts in-flight "
                    "decodes)")
            self.deploy_state = "swapping"
            try:
                if not self.gen.quantize and (
                        self.gen._weight_set is not None
                        or str(version) in
                        self.gen.served.live_sets()
                        or self._shares_model_params()):
                    captures = self._swap_weight_set(params, version)
                else:
                    captures = 0
                    self._swap_in_place(params)
            except BaseException:
                self.deploy_state = "serving"
                raise
            self.weight_version = str(version)
            if not self.gen.quantize and self.gen._weight_set is None:
                self.gen.served.version = (
                    None if params is None else self.weight_version)
            self._weight_swaps += 1
            flushed = self.flush_prefix_cache()
            self.deploy_state = "serving"
        return {"version": self.weight_version, "flushed_pages": flushed,
                "swaps": self._weight_swaps, "captures": captures}

    def _swap_in_place(self, params):
        """The quantized tier's private swap, or the sole reader's write
        into model.params; restores the prior weights on a failure."""
        prev = self.gen.restore_point()
        try:
            self.gen.set_params(params)
            if self.gen.quantize:
                self.gen.params()   # re-quantize once, now
            faultinject.maybe_fail("swap_fail", "deploy")
        except BaseException:
            self.gen.set_params(prev)
            if self.gen.quantize:
                self.gen.params()
            raise

    def _shares_model_params(self) -> bool:
        """Does any Generator but this engine's own (target and draft)
        read model.params? Engines released by their callers are
        collected first."""
        own = {id(self.gen), id(self.draft_gen)}
        readers = self.gen.served.readers

        def others() -> int:   # counts, holding no reference
            return sum(id(g) not in own and g._weight_set is None
                       for g in list(readers))

        if others():
            gc.collect()
        return others() > 0

    def _swap_weight_set(self, params, version: str) -> int:
        """Move the target Generator to ``version``'s WeightSet (None:
        model.params) and capture its decode and verify programs against
        it; returns the captures. A failure before the commit puts the
        prior weights back and frees what it allocated."""
        gen = self.gen
        prior = gen.use_weight_set(params, version)
        try:
            faultinject.maybe_fail("swap_fail", "deploy")
        except BaseException:
            new = gen._weight_set
            gen._weight_set = prior
            gen.leave_weight_set(new)
            raise
        gen.leave_weight_set(prior)
        old = self._programs
        self._purge_program_sets()
        self._programs = self._program_sets.setdefault(gen.weights_serial,
                                                       {})
        captures = 0
        with self._retrace.suspended(), torch.inference_mode():
            for key, prog in old.items():
                if key in self._programs:
                    continue
                if key[0] == "draft_propose":
                    # the draft's weights did not change: same program
                    self._programs[key] = prog
                    continue
                self._capture_for_swap(key)
                captures += 1
        self._swap_captures += captures
        return captures

    def _purge_program_sets(self):
        """Drop the programs of weight sets that were freed (their graphs
        hold addresses nothing owns any more)."""
        live = {ws.serial for ws in self.gen.served.live_sets().values()}
        for serial in [k for k in self._program_sets
                       if k and k not in live
                       and k != self.gen.weights_serial]:
            del self._program_sets[serial]

    def _capture_for_swap(self, key: tuple):
        """Build ``key``'s program against the weights served now and run
        it once on the idle slots (their writes land in scratch page 0):
        on the card that first call is the CUDA-graph capture."""
        kind, k = key
        if kind == "decode":
            body, inputs = self._build_decode(k)
        else:
            body, inputs = self._build_verify(k)
        prog = self._programs[key] = _Program(body, inputs, self._stream)
        write_pos, rope_pos, budget = self._slot_decode_state()
        if kind == "decode":
            self._load_decode(prog, write_pos, rope_pos, budget)
        else:
            pos = np.minimum(write_pos[:, None] + np.arange(k + 1)[None, :],
                             (budget - 1)[:, None]).astype(np.int32)
            self._load_slots(prog, page_table=self.page_tables,
                             slab=np.zeros((self.slots, k + 1), np.int32),
                             write_pos=pos, rope_pos0=rope_pos,
                             row_len=self.row_len,
                             prompt_pad=self.prompt_pad, temps=self.temps,
                             top_ps=self.top_ps, top_ks=self.top_ks)
        prog()

    def release_weights(self):
        """Leave a swapped-in WeightSet (the engine serves model.params
        again, unflushed: call it on a retired engine) so the set is freed
        with its last reader; drops that set's programs."""
        with self._lock:
            ws = self.gen._weight_set
            if ws is None:
                return
            self.gen._weight_set = None
            self.gen.leave_weight_set(ws)
            self._programs = self._program_sets[0]
            self._purge_program_sets()

    def health(self) -> Dict:
        """Liveness / readiness probe for a router: admission status and
        the load counters a balancer steers by, from one ``stats()``
        snapshot (the JAX engine's keys). Never touches the device;
        serializes behind a running tick — ``load()`` does not."""
        with self._lock:
            active = int(self.active.sum())
            if self._draining:
                status = "draining" if active else "drained"
            else:
                status = "busy" if (active or self._queue) else "idle"
            snap = self.stats()
            return {
                "status": status,
                "admitting": not self._draining,
                "active_slots": active,
                "queued": len(self._queue),
                "weight_version": self.weight_version,
                "deploy_state": self.deploy_state,
                **{k: snap[k] for k in ("serve_slots", "free_pages",
                                        "completed", "failed", "timeouts",
                                        "occupancy", "recompiles",
                                        "pages_in_use", "kv_pages_shared",
                                        "prefix_hit_rate",
                                        "spec_accept_rate",
                                        "kv_cache_dtype", "weight_dtype",
                                        "kv_bytes_per_token",
                                        "tokens_per_pool_gb")},
            }

    def load(self) -> Dict:
        """Lock-free load snapshot for a dispatcher: active slots and queue
        depth, read racing the engine's thread by design."""
        return {"active_slots": int(self.active.sum()),
                "queued": len(self._queue)}

    # ---- observability -------------------------------------------------------

    def flush_prefix_cache(self) -> int:
        """Evict EVERY refcount-0 cached page (both tiers) back to the free
        list; returns the number of pool pages reclaimed. After an idle,
        drained engine is flushed, free_pages equals kv_pages - 1 and the
        host tier is empty. Pages still mounted by live requests survive."""
        if self.prefix_cache is None:
            return 0
        with self._lock:
            freed = self.prefix_cache.evict(self.num_pages, pressure=False)
            self._free_pages.extend(freed)
            return len(freed)

    def stats(self) -> Dict:
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> Dict:
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
            "timeouts": self._timeouts,
            # the weight version served, the deploy state and the swaps
            "weight_version": self.weight_version,
            "deploy_state": self.deploy_state,
            "weight_swaps": self._weight_swaps,
            "tokens_generated": self._tokens_emitted,
            "decode_steps": self.decode_steps,
            # decode-side programs built (CUDA-graph captures on the card),
            # JAX's recompile count: flat once the keys are warm
            "recompiles": self.recompile_count,
            "sanitizer_retraces": self._retrace.hits,
            "graph_replays": sum(p.replays for p in {
                id(p): p for ps in self._program_sets.values()
                for p in ps.values()}.values()),
            "swap_captures": self._swap_captures,
            # useful slot-steps over computed ones (JAX's formula)
            "occupancy": (self._occupancy_sum
                          / max(1, self.decode_steps) / self.slots),
            "occupied_slot_steps": self._occupancy_sum,
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
            # every non-free page (live-private + cached)
            "pages_in_use": self.num_pages - 1 - len(self._free_pages),
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
            # the host tier: pages by tier (host includes publishes in
            # flight), the migration ledger, and the slab handoff's
            "host_kv_pages": pc.host_pages if pc else 0,
            "kv_pages_hbm": pc.pages if pc else 0,
            "kv_pages_host": pc.host_used if pc else 0,
            "tier_demotions": pc.demotions if pc else 0,
            "tier_promotions": pc.promotions if pc else 0,
            "tier_demote_failures": pc.demote_failures if pc else 0,
            "tier_promote_failures": pc.promote_failures if pc else 0,
            "tier_host_evictions": pc.host_evictions if pc else 0,
            "tier_pending_migrations": (pc.pending_migrations()
                                        if pc else 0),
            "prefill_only_requests": self._prefill_only,
            "prefix_slab_exports": self._slab_exports,
            "prefix_slab_imports": self._slab_imports,
            "prefix_pages_imported": self._import_pages,
            "partial_slab_imports": self._partial_slab_imports,
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
            # the adapter pool's occupancy / fault / eviction ledger (zeros
            # without a pool: the keys are pinned either way)
            "lora_rank": self.lora_rank,
            **(self.lora.stats() if self.lora is not None else {
                "adapter_pool_pages": 0, "adapters_registered": 0,
                "adapters_resident": 0, "adapter_pages_in_use": 0,
                "adapter_pool_occupancy": 0.0, "adapter_lookups": 0,
                "adapter_hits": 0, "adapter_faults": 0,
                "adapter_evictions": 0, "adapter_refs_live": 0}),
            "spec_accept_by_adapter": {
                name: round(v[1] / max(1, v[0]), 4)
                for name, v in self._adapter_spec.items()},
            "requests_by_adapter": dict(self._adapter_requests),
            "kernel_launches": {k: now[k] - self._launch_base[k]
                                for k in now},
        }
