"""Unified telemetry plane: metrics registry + per-request tracing (the
port's copy of the JAX package's ``runtime/telemetry.py``: the same
family names, labels, span names, exposition text and JSON, so one
dashboard and one trace reader serve both packages). Host code only: it
never reads a device tensor, so it adds no device synchronisation.

Three pieces, one process-wide substrate:

  * **Metrics registry** — thread-safe counters, gauges and fixed-memory
    log-bucket histograms with labeled series (replica, role, tier,
    dtype, impl). Export as Prometheus text exposition
    (``registry().to_prometheus()``, served by ``start_http_server`` /
    ``FFConfig.metrics_port`` on ``/metrics``) or a JSON snapshot
    (``registry().snapshot()``, ``/metrics.json``). Engines and routers
    register *collectors* — weakly-referenced
    callbacks that publish their ``stats()`` dicts as gauges at scrape
    time — so every counter the ad-hoc dicts already carried (hit rates,
    handoffs, demotions/promotions, fenced/resubmitted/timeouts/rejected,
    recompile_count) is a first-class series without a
    second bookkeeping path: the dict IS the collector's source, the
    registry is the export plane both share.

  * **Per-request tracing** — ``span()`` / ``begin()``+``end()`` /
    ``complete()`` record into one bounded in-memory ring (fixed memory:
    old events fall off; ``TRACE_RING_CAP`` events). Every event carries
    a ``trace_id`` that rides the request across threads, replicas,
    resubmission and the prefill->decode page handoff, so the span tree
    for one request is reconstructible fleet-wide
    (``trace_tree(trace_id)``, ``ServingRouter.recent_traces()``).
    Export as Chrome trace-event JSON (``export_chrome_trace`` —
    perfetto-loadable: pid = replica/subsystem track, tid = thread).

  * **Fault annotations** — ``runtime/faultinject.py`` reports every
    fired FF_FAULT event here (``annotate("fault", ...)``), so a fault
    drill's trace shows exactly where the fault landed
    (``fault_events()``).

Overhead discipline: every hot-path emit is one lock-cheap
dict/deque op and a ``perf_counter()`` call; histograms are fixed arrays
(no per-observation allocation); ``set_enabled(False)`` (or
``FFConfig.telemetry="off"``) turns ``span()`` into a shared no-op and
short-circuits ``observe``/``inc``/``emit`` at one predicate.
"""

from __future__ import annotations

import bisect
import collections
import logging
import json
import math
import threading
import time
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from flexflow_tpu_torch.runtime import locks

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "Tracer",
    "registry", "tracer", "reset", "set_enabled", "enabled",
    "annotate", "fault_events", "export_chrome_trace", "trace_tree",
    "start_http_server", "stop_http_server", "current_trace_id",
    "DEFAULT_LATENCY_BOUNDS", "log_bounds", "now_us", "bucket_quantile",
]

# ---------------------------------------------------------------- switch

_enabled = True


def set_enabled(on: bool) -> bool:
    """Flip the process-wide telemetry switch; returns the previous
    value. Off = ``span()`` yields a shared no-op, ``observe``/``inc``
    return at one predicate, the trace ring stops growing. Registered
    series keep their accumulated values (they just stop moving)."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    return prev


def enabled() -> bool:
    return _enabled


# ---------------------------------------------------------------- metrics


def log_bounds(lo: float, hi: float, growth: float = 2.0) -> Tuple[float, ...]:
    """Geometric bucket bounds ``lo, lo*growth, ... >= hi`` — fixed
    memory whatever the value range, resolution a constant factor."""
    if lo <= 0 or hi <= lo or growth <= 1:
        raise ValueError(f"log_bounds({lo}, {hi}, {growth}): need "
                         f"0 < lo < hi and growth > 1")
    out = []
    b = float(lo)
    while b < hi:
        out.append(b)
        b *= growth
    out.append(b)
    return tuple(out)


# 100us .. ~210s in x2 steps: wide enough for TTFT on a cold CPU compile
# and tight enough for inter-token latency — 22 buckets, fixed memory
DEFAULT_LATENCY_BOUNDS = log_bounds(1e-4, 200.0)


def bucket_quantile(bounds: Tuple[float, ...], counts, q: float) -> float:
    """The one bucket-interpolated quantile estimator — shared by live
    histogram children and the SLO monitor's window deltas, so the
    windowed p99 an SLO judges can never diverge from the exported p99
    operators compare it against. ``counts`` has ``len(bounds) + 1``
    entries (the +Inf bucket last); 0.0 when empty; values past the
    last bound clamp to it (the +Inf bucket has no upper edge to
    interpolate against)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = q * total
    seen = 0.0
    for i, c in enumerate(counts):
        if seen + c >= rank and c > 0:
            if i >= len(bounds):            # +Inf bucket
                return bounds[-1]
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (rank - seen) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        seen += c
    return bounds[-1]


class _Series:
    """One labeled child of a family. All mutation under the family
    lock (increments are nanoseconds; contention is the registry's
    problem, not the caller's)."""

    __slots__ = ("labels", "value", "_lock")

    def __init__(self, labels: Tuple[Tuple[str, str], ...],
                 lock: threading.Lock):
        self.labels = labels
        self.value = 0.0
        self._lock = lock

    def inc(self, n: float = 1.0):
        if not _enabled:
            return
        with self._lock:
            self.value += n

    def set(self, v: float):
        if not _enabled:
            return
        with self._lock:
            self.value = float(v)

    def get(self) -> float:
        return self.value


class _HistSeries:
    """Fixed-memory log-bucket histogram child: one count per bucket
    (cumulative at export, per-bucket in storage), running sum, count.
    Quantiles are estimated by linear interpolation inside the owning
    bucket — exact to a bucket width, which log buckets keep to a
    constant relative error."""

    __slots__ = ("labels", "bounds", "counts", "sum", "count", "_lock")

    def __init__(self, labels, bounds: Tuple[float, ...],
                 lock: threading.Lock):
        self.labels = labels
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self._lock = lock

    def observe(self, v: float):
        if not _enabled:
            return
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0..1) from the buckets (the shared
        ``bucket_quantile`` estimator)."""
        with self._lock:
            counts = list(self.counts)
        return bucket_quantile(self.bounds, counts, q)


class _Family:
    """One named metric family: children keyed by label values."""

    def __init__(self, name: str, help_: str, kind: str,
                 labelnames: Tuple[str, ...],
                 bounds: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.help = help_
        self.kind = kind                    # counter | gauge | histogram
        self.labelnames = labelnames
        self.bounds = bounds
        self._lock = locks.make_lock("telemetry-family")
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, *values, **kv):
        if kv:
            values = tuple(str(kv[k]) for k in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: got {len(values)} label values for "
                f"labels {self.labelnames}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    pairs = tuple(zip(self.labelnames, values))
                    child = (_HistSeries(pairs, self.bounds, self._lock)
                             if self.kind == "histogram"
                             else _Series(pairs, self._lock))
                    self._children[values] = child
        return child

    # label-free families act as their own single child
    def _solo(self):
        return self.labels()

    def inc(self, n: float = 1.0):
        self._solo().inc(n)

    def set(self, v: float):
        self._solo().set(v)

    def observe(self, v: float):
        self._solo().observe(v)

    def children(self):
        with self._lock:
            return list(self._children.values())


def _fmt_labels(pairs) -> str:
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Registry:
    """Process-wide metric registry. ``counter``/``gauge``/``histogram``
    get-or-create a family (idempotent by name; kind/labels must match —
    two subsystems registering the same name differently is a bug worth
    raising on). ``add_collector`` registers a weakly-referenced callback
    run before every export so live objects (engines, routers, the
    kernel-tune table) can publish their stats dicts as gauges exactly
    when someone is looking."""

    def __init__(self):
        self._lock = locks.make_lock("telemetry-registry")
        self._families: "collections.OrderedDict[str, _Family]" = \
            collections.OrderedDict()
        self._collectors: List[weakref.ref] = []

    # ---- family constructors -------------------------------------------

    def _family(self, name, help_, kind, labelnames, bounds=None):
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames \
                        or (kind == "histogram"
                            and fam.bounds != tuple(bounds or ())):
                    raise ValueError(
                        f"metric {name!r} re-registered as {kind} "
                        f"{labelnames} bounds={bounds} but exists as "
                        f"{fam.kind} {fam.labelnames} "
                        f"bounds={fam.bounds}")
                return fam
            fam = _Family(name, help_, kind, labelnames, bounds)
            self._families[name] = fam
            return fam

    def family(self, name: str) -> Optional[_Family]:
        """Look up an existing family by name (None when absent) — the
        SLO monitor windows registered histograms without creating
        them."""
        with self._lock:
            return self._families.get(name)

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> _Family:
        return self._family(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> _Family:
        return self._family(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  bounds: Tuple[float, ...] = DEFAULT_LATENCY_BOUNDS
                  ) -> _Family:
        return self._family(name, help, "histogram", labels,
                            bounds=tuple(bounds))

    # ---- collectors -----------------------------------------------------

    def add_collector(self, fn: Callable[["Registry"], None]):
        """``fn(registry)`` runs before every export. Bound methods are
        held via WeakMethod so registering an engine's collector never
        keeps the engine alive; dead refs are pruned at export."""
        ref = (weakref.WeakMethod(fn) if hasattr(fn, "__self__")
               else weakref.ref(fn))
        with self._lock:
            self._collectors.append(ref)

    def _run_collectors(self):
        with self._lock:
            refs = list(self._collectors)
        dead = []
        for ref in refs:
            fn = ref()
            if fn is None:
                dead.append(ref)
                continue
            try:
                fn(self)
            except Exception:   # a sick collector must not kill a scrape
                pass
        if dead:
            with self._lock:
                self._collectors = [r for r in self._collectors
                                    if r not in dead]

    # ---- export ---------------------------------------------------------

    def describe(self) -> Dict[str, int]:
        """Registry shape: how many families /
        labeled series / histogram series exist right now."""
        with self._lock:
            fams = list(self._families.values())
        series = sum(len(f.children()) for f in fams)
        hists = sum(len(f.children()) for f in fams
                    if f.kind == "histogram")
        return {"families": len(fams), "series": series,
                "histograms": hists}

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        self._run_collectors()
        with self._lock:
            fams = list(self._families.values())
        out: List[str] = []
        for fam in fams:
            children = fam.children()
            if not children:
                continue
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for ch in children:
                if fam.kind == "histogram":
                    cum = 0
                    for bound, c in zip(ch.bounds, ch.counts):
                        cum += c
                        pairs = ch.labels + (("le", _fmt_value(bound)),)
                        out.append(f"{fam.name}_bucket"
                                   f"{_fmt_labels(pairs)} {cum}")
                    pairs = ch.labels + (("le", "+Inf"),)
                    out.append(f"{fam.name}_bucket{_fmt_labels(pairs)} "
                               f"{ch.count}")
                    out.append(f"{fam.name}_sum{_fmt_labels(ch.labels)} "
                               f"{_fmt_value(ch.sum)}")
                    out.append(f"{fam.name}_count"
                               f"{_fmt_labels(ch.labels)} {ch.count}")
                else:
                    out.append(f"{fam.name}{_fmt_labels(ch.labels)} "
                               f"{_fmt_value(ch.value)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict:
        """JSON-ready snapshot of every family and series (the API
        ``stats()``-style callers consume programmatically)."""
        self._run_collectors()
        with self._lock:
            fams = list(self._families.values())
        snap: Dict[str, Dict] = {}
        for fam in fams:
            rows = []
            for ch in fam.children():
                labels = dict(ch.labels)
                if fam.kind == "histogram":
                    rows.append({
                        "labels": labels, "count": ch.count,
                        "sum": round(ch.sum, 9),
                        "buckets": {_fmt_value(b): c for b, c
                                    in zip(ch.bounds, ch.counts)},
                        "inf": ch.counts[-1],
                        "p50": round(ch.quantile(0.50), 9),
                        "p99": round(ch.quantile(0.99), 9),
                    })
                else:
                    rows.append({"labels": labels, "value": ch.value})
            snap[fam.name] = {"type": fam.kind, "help": fam.help,
                              "series": rows}
        return snap


# ---------------------------------------------------------------- tracing

TRACE_RING_CAP = 16384      # events; fixed memory, old spans fall off

# perf_counter origin shared by every event so cross-thread timestamps
# are comparable; exported as microseconds since this epoch
_EPOCH = time.perf_counter()


def _now_us() -> float:
    return (time.perf_counter() - _EPOCH) * 1e6


def now_us() -> float:
    """Microseconds since the trace epoch — the ``ts`` clock every ring
    event carries (the flight recorder windows the ring against it)."""
    return _now_us()


_tls = threading.local()


def current_trace_id() -> Optional[str]:
    """The innermost active span's trace id on THIS thread (for log
    correlation — logger.py's JSON format stamps it on every line)."""
    stack = getattr(_tls, "trace_stack", None)
    return stack[-1] if stack else None


class _NullSpan:
    """Shared no-op span: telemetry off, or tracing not wanted here."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kv):
        return self


NULL_SPAN = _NullSpan()


class _Span:
    """Context-manager span: records one Chrome "X" (complete) event at
    exit. Pushes its trace id on the thread-local stack so nested spans
    and log lines inherit it."""

    __slots__ = ("tracer", "name", "trace_id", "track", "args", "_t0")

    def __init__(self, tracer, name, trace_id, track, args):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.track = track
        self.args = args
        self._t0 = 0.0

    def annotate(self, **kv):
        self.args.update(kv)
        return self

    def __enter__(self):
        self._t0 = _now_us()
        stack = getattr(_tls, "trace_stack", None)
        if stack is None:
            stack = _tls.trace_stack = []
        stack.append(self.trace_id)
        return self

    def __exit__(self, etype, evalue, tb):
        stack = getattr(_tls, "trace_stack", None)
        if stack:
            stack.pop()
        if etype is not None:
            self.args.setdefault("error", f"{etype.__name__}: {evalue}")
        t1 = _now_us()
        self.tracer._emit(self.name, "X", self._t0, t1 - self._t0,
                          self.trace_id, self.track, self.args)
        return False


class Tracer:
    """Bounded-ring trace recorder. Events are plain dicts in Chrome
    trace-event shape: ``ph`` "X" (complete, with ``dur``) or "i"
    (instant). ``pid`` is a logical track ("replica0", "train",
    "router"); ``tid`` the OS thread id; ``args`` always carries
    ``trace_id`` when the event belongs to a request."""

    def __init__(self, cap: int = TRACE_RING_CAP):
        self._lock = locks.make_lock("telemetry-tracer")
        self._ring: collections.deque = collections.deque(maxlen=cap)
        self._open: Dict[int, Dict] = {}    # begin() handles awaiting end()
        self._next_handle = 0

    # ---- recording ------------------------------------------------------

    def _emit(self, name, ph, ts, dur, trace_id, track, args):
        ev = {"name": name, "ph": ph, "ts": round(ts, 1),
              "pid": track or "proc",
              "tid": threading.get_ident() & 0xffff}
        if ph == "X":
            ev["dur"] = round(dur, 1)
        a = dict(args) if args else {}
        if trace_id is not None:
            a["trace_id"] = trace_id
        if a:
            ev["args"] = a
        with self._lock:
            self._ring.append(ev)
        return ev

    def span(self, name: str, trace_id: Optional[str] = None,
             track: Optional[str] = None, **args):
        """Context-manager span (same-thread begin/end). Returns the
        shared no-op span when telemetry is off."""
        if not _enabled:
            return NULL_SPAN
        if trace_id is None:
            trace_id = current_trace_id()
        return _Span(self, name, trace_id, track, args)

    def begin(self, name: str, trace_id: Optional[str] = None,
              track: Optional[str] = None, **args) -> int:
        """Explicit span open for lifecycles that cross threads (a
        request decodes on a different thread than it was submitted
        from). Returns a handle for ``end()``; handle 0 = telemetry was
        off (end() ignores it)."""
        if not _enabled:
            return 0
        with self._lock:
            self._next_handle += 1
            h = self._next_handle
            self._open[h] = {"name": name, "t0": _now_us(),
                             "trace_id": trace_id, "track": track,
                             "args": dict(args)}
            # fixed memory even when spans are abandoned (a fenced
            # replica never end()s its open decode spans): drop the
            # oldest open record past the cap — its end() becomes a
            # no-op, exactly like a span that fell off the ring
            while len(self._open) > 8192:
                self._open.pop(next(iter(self._open)))
        return h

    def end(self, handle: int, track: Optional[str] = None, **args):
        """Close a ``begin()`` span; extra args merge in (the retire
        state, the token count). Unknown/zero handles are ignored —
        telemetry may have been off, or the ring may have been reset
        mid-request. A span closed while telemetry is OFF is dropped
        without emitting (the off contract: the ring stops growing —
        a request straddling the toggle loses its span, deliberately)."""
        if not handle:
            return
        with self._lock:
            rec = self._open.pop(handle, None)
        if rec is None or not _enabled:
            return
        rec["args"].update(args)
        self._emit(rec["name"], "X", rec["t0"], _now_us() - rec["t0"],
                   rec["trace_id"], track or rec["track"], rec["args"])

    def complete(self, name: str, t0_s: float, dur_s: float,
                 trace_id: Optional[str] = None,
                 track: Optional[str] = None, **args):
        """Record a span retrospectively from perf_counter() instants —
        for phases measured anyway (fit's host_wait/h2d/dispatch) where
        a live span would double the clock reads."""
        if not _enabled:
            return
        self._emit(name, "X", (t0_s - _EPOCH) * 1e6, dur_s * 1e6,
                   trace_id, track, args)

    def instant(self, name: str, trace_id: Optional[str] = None,
                track: Optional[str] = None, **args):
        """Zero-duration annotation (fault landed, replica fenced,
        checkpoint published, watchdog fired)."""
        if not _enabled:
            return
        if trace_id is None:
            trace_id = current_trace_id()
        self._emit(name, "i", _now_us(), 0.0, trace_id, track, args)

    # ---- query ----------------------------------------------------------

    def events(self, name: Optional[str] = None,
               trace_id: Optional[str] = None) -> List[Dict]:
        """Ring contents (oldest first), optionally filtered."""
        with self._lock:
            evs = list(self._ring)
        if name is not None:
            evs = [e for e in evs if e["name"] == name]
        if trace_id is not None:
            evs = [e for e in evs
                   if e.get("args", {}).get("trace_id") == trace_id]
        return evs

    def trace_ids(self) -> List[str]:
        """Distinct request trace ids present in the ring, oldest
        first."""
        seen: "collections.OrderedDict[str, None]" = collections.OrderedDict()
        for e in self.events():
            tid = e.get("args", {}).get("trace_id")
            if tid is not None:
                seen.setdefault(tid, None)
        return list(seen)

    def trace_tree(self, trace_id: str) -> Dict:
        """Everything the ring holds for one request, as a span tree
        summary: the root span (the widest), children sorted by start,
        the tracks (replicas/subsystems) it crossed, and the instant
        annotations (faults, resubmissions) that fired under it."""
        evs = self.events(trace_id=trace_id)
        spans = [e for e in evs if e["ph"] == "X"]
        marks = [e for e in evs if e["ph"] == "i"]
        spans.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        root = max(spans, key=lambda e: e.get("dur", 0.0), default=None)
        return {
            "trace_id": trace_id,
            "root": root,
            "spans": spans,
            "annotations": marks,
            "names": [e["name"] for e in spans],
            "tracks": sorted({e["pid"] for e in evs}),
            "complete": _tree_complete(root, spans),
        }

    def reset(self):
        with self._lock:
            self._ring.clear()
            self._open.clear()

    def __len__(self):
        with self._lock:
            return len(self._ring)


def _tree_complete(root, spans) -> bool:
    """A request's span tree is COMPLETE when a root exists and every
    other span nests inside it (start within [root, root+dur] — end may
    trail by scheduler granularity; a span from a replica fenced
    mid-request still STARTED inside its request)."""
    if root is None:
        return False
    t0 = root["ts"]
    t1 = t0 + root.get("dur", 0.0)
    slack = 1.0  # us: perf_counter rounding at export
    return all(t0 - slack <= e["ts"] <= t1 + slack
               for e in spans if e is not root)


# ------------------------------------------------------------- process-wide

_registry = Registry()
_tracer = Tracer()
_lock = locks.make_lock("telemetry-server")


def registry() -> Registry:
    return _registry


def tracer() -> Tracer:
    return _tracer


def reset():
    """Fresh process-wide registry + tracer (tests). Collectors, series
    and cached histogram children registered against the OLD registry
    are dropped — live engines/routers created BEFORE a reset stop
    exporting (they hold handles into the old registry). Construct
    engines after reset, or don't reset mid-fleet."""
    global _registry, _tracer
    with _lock:
        _registry = Registry()
        _tracer = Tracer()


def trace_tree(trace_id: str) -> Dict:
    return _tracer.trace_tree(trace_id)


# ------------------------------------------------------------ fault marks


def annotate(name: str, trace_id: Optional[str] = None,
             track: Optional[str] = None, **args):
    """Instant annotation + a counter bump when it is a fault mark.
    runtime/faultinject.py calls this at every fired FF_FAULT event so
    the drill's trace shows exactly where the fault landed."""
    _tracer.instant(name, trace_id=trace_id, track=track, **args)
    if name == "fault":
        _registry.counter(
            "ff_fault_fired_total",
            "FF_FAULT injections fired, by kind and site",
            labels=("kind", "site")).labels(
                args.get("kind", "?"), args.get("site", "?")).inc()


def fault_events() -> List[Dict]:
    """Every FF_FAULT annotation currently in the trace ring (the
    router/disagg smoke assertion surface)."""
    return _tracer.events(name="fault")


# ------------------------------------------------------- chrome trace file


def export_chrome_trace(path: str, extra: Optional[List[Dict]] = None
                        ) -> int:
    """Write the trace ring as Chrome trace-event JSON (perfetto /
    chrome://tracing loadable). Returns the event count written."""
    evs = _tracer.events()
    if extra:
        evs = evs + list(extra)
    doc = {"traceEvents": evs, "displayTimeUnit": "ms"}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return len(evs)


# --------------------------------------------------------- scrape endpoint

_server = None
_server_thread = None


def start_http_server(port: int) -> int:
    """Serve ``/metrics`` (Prometheus text), ``/metrics.json`` (registry
    snapshot) and ``/trace.json`` (the ring, Chrome format) on a stdlib
    http.server daemon thread. Idempotent — one server per process; the
    ACTUAL bound port is returned (pass 0 for an ephemeral port).
    Loopback only: this is an operator scrape endpoint, not an API."""
    global _server, _server_thread
    import http.server

    with _lock:
        if _server is not None:
            return _server.server_address[1]

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                code = 200
                if self.path.startswith("/metrics.json"):
                    body = json.dumps(_registry.snapshot()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    body = _registry.to_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.startswith("/trace.json"):
                    body = json.dumps(
                        {"traceEvents": _tracer.events()}).encode()
                    ctype = "application/json"
                elif self.path.startswith("/healthz"):
                    # fleet health rollup (ok|degraded|breach with
                    # per-SLO reasons) from the lock-free probes —
                    # never compiles, never blocks behind a mid-tick
                    # replica (runtime/flightrec.py; deferred import:
                    # flightrec imports this module at top)
                    from flexflow_tpu_torch.runtime import flightrec

                    roll = flightrec.health_rollup()
                    body = json.dumps(roll).encode()
                    ctype = "application/json"
                    # an alerting scraper keys on the status code: only
                    # a BREACH is load-shed-worthy; degraded still
                    # serves
                    code = 503 if roll["status"] == "breach" else 200
                elif self.path.startswith("/slo.json"):
                    from flexflow_tpu_torch.runtime import flightrec

                    body = json.dumps(
                        flightrec.slo_monitor().describe()).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):    # stderr chatter is not telemetry
                pass

        _server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", int(port)), Handler)
        _server.daemon_threads = True
        _server_thread = threading.Thread(
            target=_server.serve_forever, daemon=True,
            name="ff-metrics-http")
        _server_thread.start()
        fflogger = logging.getLogger("flexflow_tpu_torch")

        fflogger.info("telemetry: /metrics on 127.0.0.1:%d",
                      _server.server_address[1])
        return _server.server_address[1]


def stop_http_server():
    global _server, _server_thread
    with _lock:
        if _server is None:
            return
        _server.shutdown()
        _server.server_close()
        _server = None
        _server_thread = None
