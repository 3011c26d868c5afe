"""The runtime plane's named-lock hierarchy and its sanitizer (the port's
copy of the JAX package's ``runtime/locks.py``; the same names, ranks,
modes and evidence records, so one post-mortem reader serves both).

Every lock of ``flexflow_tpu_torch/runtime`` is created through this
module's factories with a NAME from the declared hierarchy below — the
lock order ("router -> engine -> prefix-cache -> ...") is one table:

  * the factories here (which rank a lock carries);
  * the runtime sanitizer (``FF_SANITIZE=1`` / ``FFConfig.sanitize``),
    which wraps the factories' output in order-asserting proxies and
    catches what reading the code cannot see (dynamic call paths,
    callbacks, two objects of the same class).

Rank semantics: a thread may only acquire a lock whose rank is STRICTLY
GREATER than every ranked lock it already holds (outer-to-inner =
ascending rank). Re-acquiring the same object (RLock reentrancy) is
always legal. Two DIFFERENT objects at the same rank may not nest — two
engine locks held by one thread is exactly the A->B/B->A fleet deadlock
the hierarchy exists to prevent.

With the sanitizer OFF (the default) the factories return the raw
``threading`` primitives — identical behavior and zero overhead. The
mode is read at LOCK CREATION time: enable via env ``FF_SANITIZE`` for
process-wide coverage (module-level telemetry locks are created at
import), or via ``FFConfig.sanitize`` for every lock created after the
config exists (engines, routers, pools — the serving plane).

The RETRACE SENTINEL is the second sanitizer layer: after an engine's
``warmup()`` the program set is closed. The port's engine keeps its
decode-side programs (CUDA graphs on the card) in a dict keyed as the JAX
engine keys its compiled programs; a NEW key after warmup is a program
built mid-traffic (an unwarmed variant: on the card a capture, seconds of
stall). ``note_miss`` records it in every mode (strict: raises) with
the program key.

Violations and retraces are routed to the flight recorder as
``sanitizer_lock_order`` / ``sanitizer_retrace`` incident triggers, and
``lock_graph_snapshot()`` rides every post-mortem bundle
(sanitizer.json).
"""

from __future__ import annotations

import collections
import logging
import contextlib
import os
import threading
import traceback
import weakref
from typing import Dict, List, Optional, Tuple

__all__ = [
    "LOCK_RANKS", "make_lock", "make_rlock", "make_condition",
    "configure", "set_mode", "mode", "violations", "retrace_log",
    "reset", "lock_graph_snapshot", "RetraceSentinel",
    "LockOrderViolation", "RetraceViolation",
]

# ---------------------------------------------------------------- hierarchy

# The declared lock order, outermost (lowest rank) first. A thread
# holding rank R may only acquire ranks > R. Gaps are deliberate —
# future locks slot in without renumbering.
#
#   deploy > autoscale > router > engine > prefix-cache > adapter-pool >
#   loader/saver > watchdog > flightrec/slo/hbm > telemetry > native-loader
#
LOCK_RANKS: Dict[str, int] = {
    "deploy": 5,             # RollingDeployer roll state (outermost: a
    #                          deploy step acquires router + engine
    #                          locks beneath it)
    "autoscale": 7,          # AutoscalePolicy decision state (a scale
    #                          step acquires router + engine locks
    #                          beneath it, never the deploy lock)
    "router": 10,            # ServingRouter fleet ledger (RLock)
    "engine": 20,            # ServingEngine tick/queue/slots (RLock)
    "prefix-cache": 30,      # RadixPrefixCache tiered-migration publisher cv
    "adapter-pool": 40,      # LoraAdapterPool host allocator
    "pipeline-loader": 45,   # PipelineLoader prefetch cv
    "checkpoint-saver": 48,  # _AsyncSaver publisher cv
    "watchdog": 52,          # resilience Watchdog arm/fire handshake
    "flightrec": 60,         # FlightRecorder pending/trigger state (RLock)
    "slo-monitor": 62,       # SLOMonitor window state (RLock)
    "hbm-ledger": 64,        # HBMLedger source/estimate state
    "weak-callables": 66,    # _WeakCallables ref lists (flightrec substrate)
    "telemetry-registry": 70,  # metrics Registry family table
    "telemetry-family": 72,    # one metric family's children
    "telemetry-tracer": 74,    # trace ring
    "telemetry-server": 76,    # scrape-server start latch
    "native-loader": 80,     # native loader build/dlopen latch
}

_VALID_MODES = ("off", "on", "strict")

_env = os.environ.get("FF_SANITIZE", "").strip().lower()
_MODE = ("strict" if _env == "strict"
         else "on" if _env in ("1", "on", "true", "yes")
         else "off")


class LockOrderViolation(RuntimeError):
    """Strict-mode sanitizer: a lock was acquired against the declared
    hierarchy (the violating pair + both acquisition stacks are in the
    message and in ``violations()``)."""


class RetraceViolation(RuntimeError):
    """Strict-mode sanitizer: a warm program retraced after warmup()."""


def mode() -> str:
    return _MODE


def set_mode(new: str) -> str:
    """Set the sanitizer mode ('off' | 'on' | 'strict'); returns the
    previous mode. Lock PROXYING is decided at creation time — this
    gates the retrace sentinel and any proxies already created."""
    global _MODE
    if new not in _VALID_MODES:
        raise ValueError(f"sanitize mode {new!r}: must be one of "
                         f"{_VALID_MODES}")
    prev = _MODE
    _MODE = new
    return prev


def configure(cfg) -> None:
    """Adopt FFConfig.sanitize (engines/routers call this before
    creating their locks, the flightrec.configure pattern). An empty
    value means 'leave the env-derived mode alone'."""
    val = getattr(cfg, "sanitize", "") or ""
    if val:
        set_mode(val)


# ------------------------------------------------------------ held tracking

_tls = threading.local()

# bounded evidence rings: a violation storm must not grow memory
_violations: collections.deque = collections.deque(maxlen=256)
_violation_pairs: Dict[Tuple[str, str], int] = {}
_retraces: collections.deque = collections.deque(maxlen=256)
_evidence_lock = threading.Lock()   # ffsan: allow(raw-lock) — the
#   sanitizer's own evidence ring cannot be a ranked lock (it is taken
#   while an arbitrary ranked lock is being acquired)
_registry: List[weakref.ref] = []   # live proxies, for the snapshot


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


class _Held:
    __slots__ = ("name", "rank", "obj", "count", "stack")

    def __init__(self, name, rank, obj, stack):
        self.name, self.rank, self.obj = name, rank, obj
        self.count = 1
        self.stack = stack


def _capture() -> str:
    return "".join(traceback.format_stack(limit=18)[:-2])


def _check_order(name: str, rank: int, obj) -> None:
    """Called BEFORE the inner acquire: report (strict: raise) when any
    held ranked lock's rank is >= the one being acquired."""
    if getattr(_tls, "reporting", False):
        # the violation handler itself takes ranked locks (logger,
        # flight recorder) while the violating stack is still held —
        # checking those would record sanitizer self-noise
        return
    held = _held()
    for e in held:
        if e.obj is obj:
            return              # reentrant re-acquire: always legal
    for e in held:
        if e.rank >= rank:
            _report_order(e, name, rank)
            return              # one report per acquisition is enough


def _note_acquired(name: str, rank: int, obj) -> None:
    held = _held()
    for e in held:
        if e.obj is obj:
            e.count += 1
            return
    held.append(_Held(name, rank, obj, _capture()))


def _note_released(obj, all_levels: bool = False) -> int:
    """Pop one recursion level (or all, for RLock._release_save);
    returns the count released so _acquire_restore can re-note it."""
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        e = held[i]
        if e.obj is obj:
            if all_levels:
                n = e.count
                del held[i]
                return n
            e.count -= 1
            if e.count == 0:
                del held[i]
            return 1
    return 0    # acquired before sanitize was enabled: ignore


def _note_restored(name, rank, obj, count: int) -> None:
    if count <= 0:
        return
    held = _held()
    e = _Held(name, rank, obj, _capture())
    e.count = count
    held.append(e)


def _report_order(outer: "_Held", inner_name: str, inner_rank: int) -> None:
    rec = {
        "kind": "lock-order",
        "outer": outer.name, "outer_rank": outer.rank,
        "inner": inner_name, "inner_rank": inner_rank,
        "thread": threading.current_thread().name,
        "outer_stack": outer.stack,
        "inner_stack": _capture(),
    }
    pair = (outer.name, inner_name)
    with _evidence_lock:
        first = pair not in _violation_pairs
        _violation_pairs[pair] = _violation_pairs.get(pair, 0) + 1
        if first:
            _violations.append(rec)
    if first:
        fflogger = logging.getLogger("flexflow_tpu_torch")

        _tls.reporting = True
        try:
            fflogger.error(
                "ffsan: LOCK ORDER VIOLATION — acquiring %r(rank %d) "
                "while holding %r(rank %d) on thread %s\n"
                "outer acquired at:\n%sinner acquisition:\n%s",
                inner_name, inner_rank, outer.name, outer.rank,
                rec["thread"], outer.stack, rec["inner_stack"])
            _trip("sanitizer_lock_order", outer=outer.name,
                  inner=inner_name, outer_rank=outer.rank,
                  inner_rank=inner_rank, thread=rec["thread"])
        finally:
            _tls.reporting = False
    if _MODE == "strict":
        raise LockOrderViolation(
            f"lock order violation: acquiring {inner_name!r}"
            f"(rank {inner_rank}) while holding {outer.name!r}"
            f"(rank {outer.rank})\nouter acquired at:\n{outer.stack}")


def _trip(cause: str, **args) -> None:
    # lazy: locks.py must stay importable from everywhere in runtime/
    # without dragging the telemetry plane in (flightrec -> telemetry
    # both import THIS module for their own locks)
    try:
        from flexflow_tpu_torch.runtime import flightrec

        flightrec.trip(cause, **args)
    except Exception:
        pass    # forensics must never take the locking path down


# ----------------------------------------------------------------- proxies


class _SanLock:
    """Order-asserting proxy over one threading primitive. Supports the
    Lock/RLock surface plus the private hooks threading.Condition uses
    (_is_owned/_release_save/_acquire_restore), so ``make_condition``
    can wrap a tracked lock."""

    def __init__(self, name: str, rank: int, inner):
        self.name = name
        self.rank = rank
        self._inner = inner
        with _evidence_lock:
            _registry.append(weakref.ref(self))

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if _MODE != "off":
            _check_order(self.name, self.rank, self)
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquired(self.name, self.rank, self)
        return got

    def release(self):
        self._inner.release()
        _note_released(self)

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._inner.locked()

    # -- threading.Condition integration hooks --
    def _is_owned(self):
        owned = getattr(self._inner, "_is_owned", None)
        if owned is not None:
            return owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        save = getattr(self._inner, "_release_save", None)
        state = save() if save is not None else self._inner.release()
        n = _note_released(self, all_levels=True)
        return (state, n)

    def _acquire_restore(self, saved):
        state, n = saved
        restore = getattr(self._inner, "_acquire_restore", None)
        if restore is not None:
            restore(state)
        else:
            self._inner.acquire()
        _note_restored(self.name, self.rank, self, max(n, 1))

    def __repr__(self):
        return f"<ffsan {type(self._inner).__name__} {self.name!r} " \
               f"rank={self.rank}>"


def _rank_of(name: str) -> int:
    try:
        return LOCK_RANKS[name]
    except KeyError:
        raise ValueError(
            f"unknown lock name {name!r}: every runtime lock must be "
            f"declared in locks.LOCK_RANKS (known: "
            f"{sorted(LOCK_RANKS)})") from None


def make_lock(name: str):
    """A named lock at the declared rank. Sanitizer off: a raw
    ``threading.Lock`` (zero overhead, byte-identical behavior)."""
    rank = _rank_of(name)
    inner = threading.Lock()        # ffsan: allow(raw-lock) — factory
    if _MODE == "off":
        return inner
    return _SanLock(name, rank, inner)


def make_rlock(name: str):
    rank = _rank_of(name)
    inner = threading.RLock()       # ffsan: allow(raw-lock) — factory
    if _MODE == "off":
        return inner
    return _SanLock(name, rank, inner)


def make_condition(name: str):
    """A Condition over a tracked RLock at the declared rank. The
    proxy's _release_save/_acquire_restore keep the held-stack exact
    across ``wait()`` (the thread genuinely does not hold the lock
    while waiting)."""
    rank = _rank_of(name)
    if _MODE == "off":
        return threading.Condition()    # ffsan: allow(raw-lock) — factory
    return threading.Condition(         # ffsan: allow(raw-lock) — factory
        lock=_SanLock(name, rank,
                      threading.RLock()))  # ffsan: allow(raw-lock)


# ---------------------------------------------------------- retrace sentinel


def _arg_signature(args) -> List[str]:
    """Compact per-argument signature — the datum a new program diverged
    on. For tensors and arrays: type, shape and dtype."""
    out = []
    for a in args:
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is not None and dtype is not None:
            out.append(f"{type(a).__name__}{tuple(shape)}:{dtype}")
        else:
            out.append(type(a).__name__)
    return out


class RetraceSentinel:
    """Per-engine watch over the program dict. ``note_miss`` is called
    where the engine builds a program it does not hold: unarmed it is one
    attribute read; armed, the new key is recorded as a program built
    after warmup (strict: ``RetraceViolation``). ``hits`` counts the
    records."""

    def __init__(self, owner: str = ""):
        self.owner = owner
        self.armed = False
        self.hits = 0

    @contextlib.contextmanager
    def suspended(self):
        """Exempt a deliberate warm-path build (e.g.
        warm_page_import after warmup) from the closed-set
        check."""
        prev = self.armed
        self.armed = False
        try:
            yield
        finally:
            self.armed = prev

    def arm(self) -> None:
        """Close the program set — warmup is done; every later miss is
        a violation. Arming is unconditional; the mode gates at call
        time so the sentinel can be toggled without rebuilding."""
        self.armed = True

    def note_miss(self, key, args=()) -> None:
        # recorded in every mode, unlike the JAX sentinel's jit-cache
        # watch: a program built on the card is a CUDA-graph capture
        # (seconds of stall), and the engine's stats()["sanitizer_retraces"]
        # counts it whether or not the sanitizer is on; strict raises
        if self.armed:
            self._record("new-program", key, args)

    def _record(self, kind: str, key, args) -> None:
        self.hits += 1
        rec = {"kind": kind, "owner": self.owner, "program": repr(key),
               "signature": _arg_signature(args),
               "thread": threading.current_thread().name,
               "stack": _capture()}
        with _evidence_lock:
            _retraces.append(rec)
        fflogger = logging.getLogger("flexflow_tpu_torch")

        # see _check_order: reporting takes ranked locks (logger,
        # recorder) under whatever the caller already holds
        _tls.reporting = True
        try:
            fflogger.error(
                "ffsan: RETRACE after warmup — %s program %r (%s) "
                "signature=%s", kind, rec["program"], self.owner,
                rec["signature"])
            _trip("sanitizer_retrace", program=rec["program"], kind=kind,
                  owner=self.owner, signature=rec["signature"])
        finally:
            _tls.reporting = False
        if _MODE == "strict":
            raise RetraceViolation(
                f"new program {rec['program']} after warmup "
                f"({kind}, owner={self.owner}): signature "
                f"{rec['signature']}")


# --------------------------------------------------------------- inspection


def violations() -> List[Dict]:
    with _evidence_lock:
        return list(_violations)


def retrace_log() -> List[Dict]:
    with _evidence_lock:
        return list(_retraces)


def reset() -> None:
    """Drop recorded evidence (tests); live locks stay tracked."""
    with _evidence_lock:
        _violations.clear()
        _violation_pairs.clear()
        _retraces.clear()


def lock_graph_snapshot() -> Dict:
    """The sanitizer's state for post-mortem bundles (sanitizer.json):
    declared hierarchy, live tracked locks, and the evidence rings."""
    with _evidence_lock:
        live = [r() for r in _registry]
        _registry[:] = [r for r, o in zip(list(_registry), live)
                        if o is not None]
        locks = [{"name": o.name, "rank": o.rank} for o in live
                 if o is not None]
        pairs = {f"{a}->{b}": n for (a, b), n in _violation_pairs.items()}
        return {"mode": _MODE, "ranks": dict(LOCK_RANKS),
                "tracked_locks": locks,
                "violation_pairs": pairs,
                "violations": list(_violations),
                "retraces": list(_retraces)}
