"""Paged LoRA adapter pool, host side (the JAX package's
``runtime/lora.py``): which adapter lives in which device page.

  * a REGISTRY of adapters (host-RAM weights, the fault-in source) that
    can be far larger than the device pool;
  * a page ALLOCATOR with per-page refcounts of the live slots applying
    the adapter: a referenced page is pinned;
  * refcount-0 pages stay resident (warm for the tenant's next request)
    until pool pressure evicts them LRU-first;
  * ``checkout`` of a non-resident adapter FAULTS it in: the caller
    (ServingEngine) writes the registry payload into the page; a pool full
    of pinned pages returns None and the request waits queued, as under
    KV-pool pressure.

Pure host state; the engine owns the device writes (ops/lora.py)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from flexflow_tpu_torch.runtime import locks


class _Resident:
    __slots__ = ("page", "ref", "last_use")

    def __init__(self, page: int):
        self.page = page
        self.ref = 0
        self.last_use = 0


class LoraAdapterPool:
    """Host allocator for ``pages`` usable adapter pages (device page 0
    is the reserved null adapter and never allocated here)."""

    def __init__(self, pages: int, rank: int, targets: List):
        if pages < 1:
            raise ValueError(f"adapter pool pages={pages}: must be >= 1")
        if rank < 1:
            raise ValueError(f"lora rank={rank}: must be >= 1")
        self.pages = int(pages)
        self.rank = int(rank)
        # the engine lock already serializes its callers; the pool keeps
        # its own so several engines may share one
        self._lock = locks.make_rlock("adapter-pool")
        # op name -> (in_dim, out_dim): the fixed page geometry every
        # registered adapter must match
        self.geometry = {op.name: (op.in_dim, op.out_dim)
                         for op in targets}
        self.registry: Dict[str, Dict] = {}   # name -> {"payload","scale"}
        self.resident: Dict[str, _Resident] = {}
        self._free = list(range(self.pages, 0, -1))   # pages N..1
        self._tick = 0
        # counters (stats()/telemetry): lookups = checkouts, hits =
        # checkouts served without a device write, faults = pool writes
        # (first load AND every re-fault after an eviction), evictions =
        # resident ref-0 adapters displaced under pool pressure
        self.lookups = 0
        self.hits = 0
        self.faults = 0
        self.evictions = 0
        self._live_refs = 0

    # ---- registry -----------------------------------------------------------

    def register(self, name: str, weights: Dict, alpha: Optional[float]
                 = None) -> None:
        """Validate + store an adapter's host weights. ``weights`` maps
        target-op name -> {"a": (in, rank), "b": (rank, out)}; ops not
        named get a zero delta. ``alpha`` defaults to the rank (scale
        1.0); the applied scale is alpha / rank. Re-registering
        REPLACES the weights: a resident-but-unpinned device copy is
        dropped (its page frees — the next checkout re-faults the NEW
        weights), while a PINNED name (live slots decoding under it) is
        rejected, since swapping weights under a running request would
        corrupt its stream. The caller (ServingEngine.register_adapter)
        also flushes the adapter's prefix-cache namespace — cached KV
        was computed under the old weights."""
        with self._lock:
            if not name:
                raise ValueError("adapter name must be non-empty")
            res = self.resident.get(name)
            if res is not None:
                if res.ref > 0:
                    raise ValueError(
                        f"adapter {name!r} is pinned by {res.ref} live "
                        f"slot(s): re-registering would swap weights under "
                        f"a running request — drain its users first")
                # unpinned resident copy: drop it so the next checkout
                # faults the NEW weights (not counted as a pressure
                # eviction — that counter is a pool signal)
                del self.resident[name]
                self._free.append(res.page)
            if not isinstance(weights, dict) or not weights:
                raise ValueError(
                    f"adapter {name!r}: weights must be a non-empty dict of "
                    f"op name -> {{'a', 'b'}}")
            clean = {}
            for op_name, sub in weights.items():
                geo = self.geometry.get(op_name)
                if geo is None:
                    raise ValueError(
                        f"adapter {name!r} targets op {op_name!r}, which is "
                        f"not a LoRA-targeted Linear op (targets: "
                        f"{sorted(self.geometry)})")
                a = np.asarray(sub["a"], np.float32)
                b = np.asarray(sub["b"], np.float32)
                want_a = (geo[0], self.rank)
                want_b = (self.rank, geo[1])
                if a.shape != want_a or b.shape != want_b:
                    raise ValueError(
                        f"adapter {name!r} op {op_name!r}: a{a.shape}/"
                        f"b{b.shape} do not match the pool geometry "
                        f"a{want_a}/b{want_b} (rank is fixed per pool)")
                clean[op_name] = {"a": a, "b": b}
            scale = (float(alpha) if alpha is not None else float(self.rank)) \
                / float(self.rank)
            self.registry[name] = {"payload": clean, "scale": scale}

    # ---- checkout / release -------------------------------------------------

    def checkout(self, name: str):
        """Pin ``name`` into a page for one more live slot. Returns
        (page, payload_or_None): payload is None on a residency HIT
        (no device write needed) and the registry entry on a FAULT (the
        caller must run the writer before dispatching the slot). Returns
        None when the pool is full of pinned pages — the caller leaves
        the request queued (KV-pool-pressure semantics)."""
        with self._lock:
            ent = self.registry.get(name)
            if ent is None:
                raise KeyError(
                    f"adapter {name!r} is not registered "
                    f"(known: {sorted(self.registry)})")
            self._tick += 1
            self.lookups += 1
            res = self.resident.get(name)
            if res is not None:
                res.ref += 1
                res.last_use = self._tick
                self._live_refs += 1
                self.hits += 1
                return res.page, None
            page = self._allocate()
            if page is None:
                self.lookups -= 1   # an un-placeable checkout retries every
                #                     tick — it must not skew the hit rate
                return None
            res = _Resident(page)
            res.ref = 1
            res.last_use = self._tick
            self.resident[name] = res
            self._live_refs += 1
            self.faults += 1
            return page, ent

    def release(self, name: str) -> None:
        with self._lock:
            res = self.resident.get(name)
            if res is None or res.ref <= 0:
                raise AssertionError(
                    f"adapter refcount underflow on {name!r}")
            res.ref -= 1
            self._live_refs -= 1

    def _allocate(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        # LRU among refcount-0 residents; every page pinned -> None
        victim = None
        for name, res in self.resident.items():
            if res.ref == 0 and (victim is None
                                 or res.last_use < victim[1].last_use):
                victim = (name, res)
        if victim is None:
            return None
        del self.resident[victim[0]]
        self.evictions += 1
        return victim[1].page

    # ---- observability ------------------------------------------------------

    def lookup_page(self, name: str) -> Optional[int]:
        res = self.resident.get(name)
        return res.page if res is not None else None

    def live_refs(self) -> int:
        return self._live_refs

    def pages_in_use(self) -> int:
        """Pages pinned by live slots right now (ref > 0)."""
        return sum(1 for r in self.resident.values() if r.ref > 0)

    def stats(self) -> Dict:
        return {
            "adapter_pool_pages": self.pages,
            "adapters_registered": len(self.registry),
            "adapters_resident": len(self.resident),
            "adapter_pages_in_use": self.pages_in_use(),
            "adapter_pool_occupancy": round(
                len(self.resident) / max(1, self.pages), 4),
            "adapter_lookups": self.lookups,
            "adapter_hits": self.hits,
            "adapter_faults": self.faults,
            "adapter_evictions": self.evictions,
            "adapter_refs_live": self._live_refs,
        }
