"""Flight recorder + SLO health plane + HBM accounting ledger (the port's
copy of the JAX package's ``runtime/flightrec.py``: the same bundle
layout, manifest, metric families and ``health()`` rollup; the
environment fingerprint and the device memory stats read torch).

The telemetry plane (runtime/telemetry.py) gives the fleet live series
and traces — but when a replica is fenced, a watchdog fires or a
nonfinite rewind triggers, that evidence evaporates with the process.
This module turns the telemetry substrate into operable production
forensics, three pieces on one switch:

  * **Flight recorder** — the always-on in-memory window is the
    telemetry trace ring + the metrics registry + a bounded ring of
    recent log records (``LogRing``, a logging handler on ``fflogger``).
    A *trigger* (watchdog fire, replica fence, nonfinite rewind, uncaught
    engine/driver exception, SIGTERM preempt, any fired FF_FAULT, an SLO
    breach, or a manual ``FFModel.dump_flight_record()`` /
    ``ServingRouter.dump_flight_record()``) snapshots that window into an
    atomic, content-hash-manifested **post-mortem bundle** directory:
    a perfetto-loadable trace of the window, the metrics snapshot, recent
    logs as JSON lines, the trigger cause + stack, an FFConfig/strategy/
    env fingerprint, per-engine ``stats()``/``health()``, and the HBM
    ledger. Triggers are *debounced* (a crash storm merges into the
    pending bundle) and *cooled down* (one bundle per ``cooldown_s``, the
    rest counted as suppressed), retention keeps the newest K bundles,
    and publication is tmp-dir + ``write_manifest`` + ``os.replace`` —
    the checkpoint layer's torn-write discipline, so a bundle either
    verifies intact or is invisible.

  * **Declarative SLO monitor** — ``FFConfig.slo_*`` ceilings/floors
    (p99 TTFT, engine queue wait, prefix-hit-rate floor, speculative
    accept floor, train step-time and checkpoint-stall budgets) evaluated
    over *sliding windows*: each evaluation diffs the registry's
    cumulative histograms (and the engines' hit/accept counters) against
    the previous window's snapshot, so the judged value is the last
    window's traffic only — warmup compiles never leak into a breach. A
    breach fires only after a full window, emits
    ``ff_slo_breach_total{slo,replica}`` + a margin gauge + a structured
    alert log + a trace annotation (and optionally trips the recorder),
    and clears with hysteresis (``slo_clear_windows`` consecutive healthy
    windows).

  * **HBM accounting ledger** — per-subsystem device-memory gauges
    (``ff_hbm_bytes{source,subsystem}``: KV pool incl. the host tier,
    adapter pool, serving weights, params, optimizer state) published by
    weakly-referenced sources at scrape time, cross-checked against
    a lint footprint estimate (``ff_hbm_lint_estimated_bytes``) where
    one is set, and included in every bundle.

``FFConfig.telemetry="off"`` (or ``telemetry.set_enabled(False)``, or
this module's own ``set_enabled(False)`` — the overhead control arm) short-circuits every piece at the same single predicate as every
other telemetry emit: the log ring stops growing, ``trip()`` returns at
one check, the SLO evaluator never judges.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import shutil
import sys
import threading
import time
import traceback
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from flexflow_tpu_torch.runtime import locks, telemetry
from flexflow_tpu_torch.runtime.manifest import (verify_dir_manifest,
                                                 write_manifest)

# the port's package logger: every module logs under it, so the log ring
# hangs its handler here
fflogger = logging.getLogger("flexflow_tpu_torch")

__all__ = [
    "FlightRecorder", "SLOMonitor", "HBMLedger", "LogRing",
    "recorder", "slo_monitor", "hbm_ledger", "log_ring", "reset",
    "configure", "trip", "dump", "verify_bundle", "list_bundles",
    "register_health_source", "health_rollup", "set_enabled", "enabled",
    "BUNDLE_PREFIX",
]

BUNDLE_PREFIX = "bundle_"
_TMP_PREFIX = "tmp-bundle-"
LOG_RING_CAP = 2048

# module gate (the recorder-off control arm): AND'ed with the
# process-wide telemetry switch and the configured FFConfig.telemetry —
# one predicate guards every emit in this module
_enabled = True


def set_enabled(on: bool) -> bool:
    """Flip the recorder/SLO/ledger gate; returns the previous value.
    Telemetry itself keeps running — this is the marginal-overhead
    control arm."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    return prev


def enabled() -> bool:
    return _enabled


def _on() -> bool:
    """THE predicate (satellite: ``telemetry="off"`` short-circuits the
    recorder and SLO evaluator at the same single check as every other
    emit)."""
    return _enabled and telemetry.enabled() and _recorder._cfg_on


def _jsonable(obj, depth: int = 0):
    """Best-effort JSON projection of a stats()-style dict (numpy
    scalars, nested dicts, the odd object repr)."""
    if depth > 6:
        return str(obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, dict):
        return {str(k): _jsonable(v, depth + 1) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [_jsonable(v, depth + 1) for v in obj]
    try:
        return float(obj)       # numpy scalars
    except Exception:
        return str(obj)


class _WeakCallables:
    """One weakly-held callable list (the pattern the recorder's bundle
    sources, the SLO monitor's ratio sources, the HBM ledger and the
    health rollup all need): ``register()`` wraps bound methods in
    WeakMethod so holding a source never keeps an engine alive;
    ``live()`` returns the currently-live callables and prunes dead
    refs."""

    def __init__(self):
        self._lock = locks.make_lock("weak-callables")
        self._refs: List[weakref.ref] = []

    def register(self, fn: Callable):
        ref = (weakref.WeakMethod(fn) if hasattr(fn, "__self__")
               else weakref.ref(fn))
        with self._lock:
            self._refs.append(ref)

    def live(self) -> List[Callable]:
        with self._lock:
            refs = list(self._refs)
        out = [fn for fn in (r() for r in refs) if fn is not None]
        if len(out) != len(refs):
            with self._lock:
                self._refs = [r for r in self._refs if r() is not None]
        return out


# ---------------------------------------------------------------- log ring


class LogRing:
    """Bounded in-memory window of recent log records, as JSON-ready
    rows (ts/level/logger/msg + the active telemetry ``trace_id`` so
    lines join per-request traces). Fixed memory: old records fall off.
    Fed by a ``logging.Handler`` installed on ``fflogger`` at first
    ``configure()``; writes are one deque append (thread-safe by the
    GIL's deque atomicity), gated by the module predicate."""

    def __init__(self, cap: int = LOG_RING_CAP):
        self._ring: collections.deque = collections.deque(maxlen=cap)

    def record(self, rec: logging.LogRecord):
        if not _on():
            return
        try:
            row = {"ts": round(rec.created, 6),
                   "level": rec.levelname.lower(),
                   "logger": rec.name,
                   "msg": rec.getMessage()}
            tid = telemetry.current_trace_id()
            if tid is not None:
                row["trace_id"] = tid
            self._ring.append(row)
        except Exception:       # a sick log line must not kill the caller
            pass

    def recent(self, n: Optional[int] = None) -> List[Dict]:
        rows = list(self._ring)
        return rows if n is None else rows[-n:]

    def __len__(self):
        return len(self._ring)


class _RingHandler(logging.Handler):
    """Thin forwarder so ``reset()`` can swap the ring without touching
    the logger's handler list."""

    def emit(self, record):
        _log_ring.record(record)


_ring_handler_installed = False


def _ensure_log_handler():
    global _ring_handler_installed
    if _ring_handler_installed:
        return
    h = _RingHandler(level=logging.DEBUG)
    fflogger.addHandler(h)
    _ring_handler_installed = True


# ------------------------------------------------------------- the recorder


class FlightRecorder:
    """Trigger -> post-mortem bundle. ``trip()`` is asynchronous: the
    first trigger opens a *pending* record and arms a debounce timer;
    further triggers merge into it (a crash storm is ONE bundle whose
    ``trigger.json`` lists the storm); the timer — or an explicit
    ``flush()`` — writes the bundle. After a write, ``cooldown_s``
    suppresses new triggers (counted). ``dump()`` is the synchronous
    manual path: it always writes (merging any pending record) and never
    starts or consumes a cooldown — an operator's explicit request must
    not be rate-limited, nor mask the next real incident."""

    def __init__(self):
        self._lock = locks.make_rlock("flightrec")
        self._cfg_on = True           # FFConfig.telemetry != "off"
        self.directory = os.environ.get("FF_FLIGHT_DIR", "")
        self.keep = 4
        self.cooldown_s = 30.0
        self.debounce_s = 1.0
        self.window_s = 120.0
        self._fingerprint: Dict = {}
        self._seq = 0
        self._sources = _WeakCallables()
        self._pending: Optional[Dict] = None
        self._timer: Optional[threading.Timer] = None
        self._last_bundle_t = -float("inf")
        self.last_bundle_path: Optional[str] = None
        self.bundles_written = 0
        self.triggers_seen = 0
        self.triggers_merged = 0
        self.triggers_suppressed = 0
        self._suppressed_at_last_bundle = 0
        self._write_done = threading.Event()
        self._write_done.set()

    # ---- configuration ----------------------------------------------------

    def configure(self, cfg):
        """Adopt the FFConfig knobs (last configure wins — engines,
        routers and supervisors all pass their model's config, which is
        one object per process in practice). Captures the config/env
        fingerprint every bundle embeds."""
        with self._lock:
            self._cfg_on = getattr(cfg, "telemetry", "on") != "off"
            self.directory = (getattr(cfg, "flight_recorder_dir", "")
                              or os.environ.get("FF_FLIGHT_DIR", ""))
            self.keep = int(getattr(cfg, "flight_keep", self.keep))
            self.cooldown_s = float(
                getattr(cfg, "flight_cooldown_s", self.cooldown_s))
            self.debounce_s = float(
                getattr(cfg, "flight_debounce_s", self.debounce_s))
            self.window_s = float(
                getattr(cfg, "flight_window_s", self.window_s))
            self._fingerprint = _fingerprint(cfg)
            if self.directory:
                os.makedirs(self.directory, exist_ok=True)
                self._seq = max([_bundle_seq(d) for d in
                                 list_bundles(self.directory)] + [self._seq])

    def attach_source(self, fn: Callable[[], Tuple[str, Dict]]):
        """Register a bundle source: ``fn() -> (name, payload_dict)``.
        Weakly referenced (an engine's bound method never keeps the
        engine alive); collected at bundle-write time against a shared
        deadline so a wedged replica cannot hang the post-mortem of its
        own incident."""
        self._sources.register(fn)

    # ---- triggering -------------------------------------------------------

    def trip(self, cause: str, exc: Optional[BaseException] = None,
             **args):
        """Asynchronous trigger. No-op unless the module predicate holds
        AND a bundle directory is configured (the in-memory window is
        always on; *writing* needs a destination)."""
        if not _on():
            return
        with self._lock:
            if not self.directory:
                return
            self.triggers_seen += 1
            now = time.monotonic()
            ev = {"cause": cause, "args": _jsonable(args),
                  "wall_time": time.time()}
            if self._pending is not None:
                self.triggers_merged += 1
                self._pending["merged"].append(ev)
                return
            if not self._write_done.is_set():
                # a bundle write is in flight: this trigger is part of
                # the same storm (the cooldown stamp lands only when
                # the write finishes — without this check the storm's
                # tail would open a second bundle)
                self.triggers_suppressed += 1
                return
            if now - self._last_bundle_t < self.cooldown_s:
                self.triggers_suppressed += 1
                return
            ev["stack"] = self._capture_stack(exc)
            ev["merged"] = []
            self._pending = ev
            self._write_done.clear()
            self._timer = threading.Timer(max(self.debounce_s, 0.0),
                                          self._flush_pending)
            self._timer.daemon = True
            self._timer.start()

    @staticmethod
    def _capture_stack(exc: Optional[BaseException]) -> str:
        if exc is not None:
            return "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__))
        live = sys.exc_info()
        if live[0] is not None:
            return "".join(traceback.format_exception(*live))
        return "".join(traceback.format_stack())

    def flush(self, timeout: float = 30.0) -> Optional[str]:
        """Write any pending (debounced) bundle NOW; returns its path
        (or the just-finished path when an in-flight timer write is what
        we waited on; None when this call caused no write — a stale
        previous bundle's path is never returned as if it were this
        incident's)."""
        with self._lock:
            t = self._timer
            before = self.bundles_written
        if t is not None:
            t.cancel()
        self._flush_pending()
        self._write_done.wait(timeout)
        with self._lock:
            return (self.last_bundle_path
                    if self.bundles_written > before else None)

    def wait_pending(self, timeout: float = 30.0) -> bool:
        """Block until no bundle write is pending/in flight."""
        return self._write_done.wait(timeout)

    def _flush_pending(self):
        with self._lock:
            rec = self._pending
            self._pending = None
            self._timer = None
            directory = self.directory
        if rec is None:
            return
        try:
            self._write_bundle(rec, directory)
        except Exception as e:  # noqa: BLE001 — forensics must not
            #   crash the system they observe
            fflogger.warning("flight recorder: bundle write failed "
                             "(%s: %s)", type(e).__name__, e)
        finally:
            self._write_done.set()

    def dump(self, cause: str = "manual",
             directory: Optional[str] = None, **args) -> Optional[str]:
        """Synchronous manual bundle (the ``FFModel.dump_flight_record``
        / router API). Returns the bundle path, or None when telemetry
        is off (the off contract covers manual dumps too). Raises when
        no directory is configured and none is passed."""
        if not _on():
            return None
        with self._lock:
            d = directory or self.directory
            if not d:
                raise ValueError(
                    "dump_flight_record: no bundle directory — set "
                    "FFConfig.flight_recorder_dir (or FF_FLIGHT_DIR) or "
                    "pass directory=")
            # absorb a pending debounced record into this write
            rec = self._pending
            self._pending = None
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        merged = []
        if rec is not None:
            merged = [dict(rec, merged=None)] + rec["merged"]
            for m in merged:
                m.pop("merged", None)
        ev = {"cause": cause, "args": _jsonable(args),
              "wall_time": time.time(),
              "stack": self._capture_stack(None), "merged": merged}
        try:
            return self._write_bundle(ev, d, manual=True)
        finally:
            if rec is not None:
                # only the dump that ABSORBED the pending record owns
                # its completion flag — a concurrent timer-initiated
                # write (pending already popped, still publishing) must
                # not be marked done by an unrelated manual dump
                self._write_done.set()

    # ---- bundle writing ---------------------------------------------------

    def _collect_sources(self, timeout_s: float = 5.0) -> Dict[str, Dict]:
        """Run every live source on its own thread against ONE shared
        deadline: a source blocked behind a wedged engine lock (the very
        incident being recorded) yields an error row, and N wedged
        sources cost one timeout, not N — the bundle write stays well
        inside flush()'s wait."""
        out: Dict[str, Dict] = {}
        boxes: List[Tuple[threading.Thread, Dict]] = []
        for fn in self._sources.live():
            box: Dict = {}

            def _run(fn=fn, box=box):
                try:
                    name, payload = fn()
                    box["name"] = str(name)
                    box["payload"] = _jsonable(payload)
                except Exception as e:  # noqa: BLE001
                    box["error"] = f"{type(e).__name__}: {e}"

            t = threading.Thread(target=_run, daemon=True,
                                 name="ff-flightrec-source")
            t.start()
            boxes.append((t, box))
        deadline = time.monotonic() + timeout_s
        for t, box in boxes:
            t.join(max(deadline - time.monotonic(), 0.0))
            if "name" in box:
                out[box["name"]] = box["payload"]
            elif "error" in box:
                out[f"source-error-{len(out)}"] = {"error": box["error"]}
            else:
                out[f"source-timeout-{len(out)}"] = {
                    "error": f"source did not answer in {timeout_s}s"}
        return out

    def _window_events(self) -> List[Dict]:
        """The trace ring's last ``window_s`` (a complete span whose END
        falls inside the window stays — it is part of the story)."""
        cut = telemetry.now_us() - self.window_s * 1e6
        return [e for e in telemetry.tracer().events()
                if e["ts"] + e.get("dur", 0.0) >= cut]

    def _write_bundle(self, rec: Dict, directory: str,
                      manual: bool = False) -> str:
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            self._seq += 1
            seq = self._seq
        slug = "".join(c if c.isalnum() else "_"
                       for c in rec["cause"])[:40] or "trigger"
        name = f"{BUNDLE_PREFIX}{seq:05d}_{slug}"
        final = os.path.join(directory, name)
        tmp = os.path.join(directory, _TMP_PREFIX + name)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)

        trigger = {
            "cause": rec["cause"], "args": rec.get("args", {}),
            "wall_time": rec["wall_time"],
            "iso_time": time.strftime("%Y-%m-%dT%H:%M:%S",
                                      time.localtime(rec["wall_time"])),
            "stack": rec.get("stack", ""),
            "merged_triggers": rec.get("merged", []),
            # suppressed since the PREVIOUS bundle — the count this
            # incident's cooldown/in-flight window swallowed, not the
            # recorder's lifetime total
            "suppressed_in_cooldown": (self.triggers_suppressed
                                       - self._suppressed_at_last_bundle),
            "manual": manual, "pid": os.getpid(),
        }
        _write_json(tmp, "trigger.json", trigger)
        _write_json(tmp, "trace.json",
                    {"traceEvents": self._window_events(),
                     "displayTimeUnit": "ms"})
        _write_json(tmp, "metrics.json", telemetry.registry().snapshot())
        with open(os.path.join(tmp, "logs.jsonl"), "w",
                  encoding="utf-8") as f:
            for row in _log_ring.recent():
                f.write(json.dumps(row, ensure_ascii=False) + "\n")
        _write_json(tmp, "fingerprint.json", self._fingerprint
                    or _fingerprint(None))
        _write_json(tmp, "engines.json", self._collect_sources())
        _write_json(tmp, "hbm.json", _hbm.snapshot())
        _write_json(tmp, "slo.json", _slo.describe())
        # ffsan state: the declared lock hierarchy, the
        # live tracked locks, and the violation/retrace evidence
        # rings — for sanitizer_lock_order / sanitizer_retrace
        # incidents this IS the post-mortem; for every other cause
        # it answers "was the sanitizer watching, and was it clean"
        _write_json(tmp, "sanitizer.json",
                    locks.lock_graph_snapshot())
        # the manifest is the LAST write into tmp (it covers every other
        # file), then the publish rename — the checkpoint layer's
        # torn-write discipline: a bundle either verifies or never
        # appears under BUNDLE_PREFIX
        write_manifest(tmp)
        os.replace(tmp, final)
        with self._lock:
            self.bundles_written += 1
            self.last_bundle_path = final
            self._suppressed_at_last_bundle = self.triggers_suppressed
            if not manual:
                self._last_bundle_t = time.monotonic()
        self._retention(directory)
        fflogger.warning(
            "flight recorder: post-mortem bundle %s (cause=%s, "
            "%d merged trigger(s))", final, rec["cause"],
            len(rec.get("merged", [])))
        telemetry.annotate("flight_record", cause=rec["cause"], path=final)
        return final

    def _retention(self, directory: str):
        bundles = list_bundles(directory)
        for d in bundles[:-max(self.keep, 1)]:
            shutil.rmtree(d, ignore_errors=True)

    def stats(self) -> Dict:
        with self._lock:
            return {"directory": self.directory,
                    "bundles_written": self.bundles_written,
                    "triggers_seen": self.triggers_seen,
                    "triggers_merged": self.triggers_merged,
                    "triggers_suppressed": self.triggers_suppressed,
                    "last_bundle": self.last_bundle_path,
                    "pending": self._pending is not None}


def _write_json(d: str, name: str, obj):
    with open(os.path.join(d, name), "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False)


def _bundle_seq(path: str) -> int:
    base = os.path.basename(path)[len(BUNDLE_PREFIX):]
    digits = base.split("_", 1)[0]
    return int(digits) if digits.isdigit() else 0


def list_bundles(directory: str) -> List[str]:
    """Published bundle dirs, oldest first (tmp dirs from a torn write
    are invisible — publication is atomic)."""
    if not directory or not os.path.isdir(directory):
        return []
    out = [os.path.join(directory, n) for n in os.listdir(directory)
           if n.startswith(BUNDLE_PREFIX)
           and os.path.isdir(os.path.join(directory, n))]
    return sorted(out, key=_bundle_seq)


def verify_bundle(path: str):
    """Recompute the bundle's content-hash manifest; raises
    ``manifest.CheckpointCorruptError`` on any mismatch (the
    checkpoint layer's verifier)."""
    verify_dir_manifest(path, label=f"flight bundle {path}", require=True)


def _fingerprint(cfg) -> Dict:
    """FFConfig (primitive fields), strategy summary and environment —
    enough to reproduce the process that wrote the bundle."""
    out: Dict = {"env": {}, "config": {}, "strategies": {}}
    try:
        import platform

        out["env"]["python"] = platform.python_version()
        out["env"]["platform"] = platform.platform()
    except Exception:
        pass
    try:
        import torch

        out["env"]["torch"] = torch.__version__
        out["env"]["cuda"] = torch.version.cuda or ""
        # is_available() initializes nothing; the device name is read only
        # where a card is up
        gpu = torch.cuda.is_available()
        out["env"]["backend"] = "gpu" if gpu else "cpu"
        out["env"]["device_kind"] = (torch.cuda.get_device_name(0)
                                     if gpu else "cpu")
        out["env"]["local_devices"] = torch.cuda.device_count() if gpu \
            else 1
    except Exception:
        pass
    out["env"]["vars"] = {k: v for k, v in os.environ.items()
                          if k.startswith(("FF_", "FLEXFLOW_"))}
    if cfg is not None:
        for k, v in vars(cfg).items():
            if isinstance(v, (str, int, float, bool)) or v is None:
                out["config"][k] = v
        strategies = getattr(cfg, "strategies", None) or {}
        out["strategies"] = {str(k): str(v)
                             for k, v in list(strategies.items())[:256]}
        out["strategy_count"] = len(strategies)
    return out


# ------------------------------------------------------------- SLO monitor

# (name, FFConfig knob, direction, kind, keys)
#   hist_p99: keys = histogram family names; the judged value is the
#             window-delta p99 per labeled child series
#   ratio:    keys = (numerator, denominator) counter names read from
#             registered engine sources; judged per source over the
#             window's delta
_SLO_SPECS: Tuple[Tuple[str, str, str, str, Tuple[str, ...]], ...] = (
    ("ttft_p99", "slo_ttft_p99_s", "ceiling", "hist_p99",
     ("ff_serving_ttft_seconds", "ff_router_ttft_seconds")),
    ("queue_wait_p99", "slo_queue_wait_p99_s", "ceiling", "hist_p99",
     ("ff_serving_queue_wait_seconds",)),
    ("step_time_p99", "slo_step_time_p99_s", "ceiling", "hist_p99",
     ("ff_train_step_seconds",)),
    ("checkpoint_stall_p99", "slo_checkpoint_stall_s", "ceiling",
     "hist_p99", ("ff_checkpoint_stall_seconds",)),
    ("prefix_hit_rate", "slo_prefix_hit_rate_min", "floor", "ratio",
     ("prefix_hits", "prefix_lookups")),
    ("spec_accept", "slo_spec_accept_min", "floor", "ratio",
     ("spec_accepted", "spec_proposed")),
)


class _SeriesState:
    __slots__ = ("snapshot", "replica", "breached", "ok_streak",
                 "windows", "last_value")

    def __init__(self, snapshot, replica: str = "?"):
        self.snapshot = snapshot
        # the replica LABEL this series is judged/exported under — the
        # same string ff_slo_breach_total/margin carry, so /healthz and
        # /slo.json join against the metric labels exactly
        self.replica = replica
        self.breached = False
        self.ok_streak = 0
        self.windows = 0
        self.last_value: Optional[float] = None


# quantile over a window's bucket-count deltas: the ONE shared
# estimator (telemetry.bucket_quantile), applied to the difference of
# two cumulative snapshots — the windowed p99 an SLO judges can never
# diverge from the exported histogram p99 operators compare it against
_delta_quantile = telemetry.bucket_quantile


class SLOMonitor:
    """Sliding-window SLO evaluation over the live registry.

    ``maybe_evaluate()`` is the tick — called from the router driver
    loop, the engine scheduler, the supervisor step boundary and the
    ``/healthz`` handler; it returns at one time-compare until a full
    window has elapsed, then judges every active spec's series against
    the window's *delta*. A series first seen mid-stream is baselined
    and judged from the NEXT window (a breach can only fire on a full
    window of its own traffic); an empty window leaves a series' state
    untouched (no data neither confirms nor clears). Breached series
    clear after ``clear_windows`` consecutive healthy windows — the
    hysteresis that keeps a flapping metric from strobing alerts."""

    def __init__(self):
        self._lock = locks.make_rlock("slo-monitor")
        self._cfg_on = True
        self.window_s = 10.0
        self.clear_windows = 2
        self.trip_recorder = False
        self.specs: Dict[str, float] = {}        # name -> bound
        self._by_name = {s[0]: s for s in _SLO_SPECS}
        self._state: Dict[Tuple, _SeriesState] = {}
        self._sources = _WeakCallables()
        self._last_eval: Optional[float] = None
        self.evaluations = 0
        self.breaches_fired = 0

    def configure(self, cfg):
        with self._lock:
            self._cfg_on = getattr(cfg, "telemetry", "on") != "off"
            self.window_s = float(getattr(cfg, "slo_window_s",
                                          self.window_s))
            self.clear_windows = int(getattr(cfg, "slo_clear_windows",
                                             self.clear_windows))
            self.trip_recorder = bool(getattr(cfg, "slo_trip_recorder",
                                              self.trip_recorder))
            specs = {}
            for name, knob, _dir, _kind, _keys in _SLO_SPECS:
                bound = float(getattr(cfg, knob, 0.0) or 0.0)
                if bound > 0:
                    specs[name] = bound
            self.specs = specs
            # prune state for specs no longer configured: a breached
            # series whose spec was disabled would otherwise never be
            # judged again — and never clear — wedging /healthz at
            # "breach" for the life of the process
            self._state = {k: v for k, v in self._state.items()
                           if k[0] in specs}
            if specs:
                # baseline NOW: traffic before this point (warmup
                # compiles!) can never be judged
                self._rebaseline_locked()
                self._last_eval = time.monotonic()

    def add_source(self, fn: Callable[[], Tuple[str, Dict]]):
        """``fn() -> (replica_label, {counter: int})`` with lock-free
        counter reads — the ratio-floor SLOs (prefix hit rate, spec
        accept) are judged from these deltas."""
        self._sources.register(fn)

    def rebaseline(self):
        """Re-snapshot every known series and restart the window clock.
        ``ServingEngine.warmup()``/``ServingRouter.warmup()`` call this
        when they finish, so capture-inflated warmup TTFTs can never be
        judged as a breach."""
        if not self.specs:
            return
        with self._lock:
            self._rebaseline_locked()
            self._last_eval = time.monotonic()

    # ---- evaluation -------------------------------------------------------

    def maybe_evaluate(self, now: Optional[float] = None) -> List[Dict]:
        """The cheap tick: one predicate + one time compare until a full
        window has elapsed."""
        if not (_enabled and telemetry.enabled() and self._cfg_on) \
                or not self.specs:
            return []
        now = time.monotonic() if now is None else now
        if self._last_eval is not None \
                and now - self._last_eval < self.window_s:
            return []
        return self.evaluate(now=now)

    def evaluate(self, now: Optional[float] = None) -> List[Dict]:
        """Judge one full window; returns this evaluation's breach
        events. (``maybe_evaluate`` is the public tick — call this
        directly only to force an off-cadence judgement, e.g. tests.)"""
        if not (_enabled and telemetry.enabled() and self._cfg_on) \
                or not self.specs:
            return []
        with self._lock:
            self._last_eval = time.monotonic() if now is None else now
            self.evaluations += 1
            events: List[Dict] = []
            reg = telemetry.registry()
            for name, bound in self.specs.items():
                _n, _knob, direction, kind, keys = self._by_name[name]
                if kind == "hist_p99":
                    self._eval_hist_locked(reg, name, bound, direction,
                                           keys, events)
                else:
                    self._eval_ratio_locked(name, bound, direction,
                                            keys, events)
            return events

    def _eval_hist_locked(self, reg, name, bound, direction, families,
                          events):
        for fam_name in families:
            fam = reg.family(fam_name)
            if fam is None or fam.kind != "histogram":
                continue
            for ch in fam.children():
                labels = dict(ch.labels)
                replica = labels.get("replica",
                                     "fleet" if not labels else "?")
                sid = (name, fam_name, ch.labels)
                snap = (list(ch.counts), ch.count)
                st = self._state.get(sid)
                if st is None:
                    self._state[sid] = _SeriesState(snap, replica)
                    continue
                delta = [a - b for a, b in zip(snap[0], st.snapshot[0])]
                n = snap[1] - st.snapshot[1]
                st.snapshot = snap
                if n <= 0:
                    continue        # empty window: state unchanged
                value = _delta_quantile(ch.bounds, delta, 0.99)
                self._judge_locked(name, replica, value, bound,
                                   direction, st, events, samples=n)

    def _eval_ratio_locked(self, name, bound, direction, keys, events):
        num_key, den_key = keys
        for fn in self._sources.live():
            try:
                replica, counters = fn()
            except Exception:
                continue
            sid = (name, "source", str(replica))
            snap = (int(counters.get(num_key, 0)),
                    int(counters.get(den_key, 0)))
            st = self._state.get(sid)
            if st is None:
                self._state[sid] = _SeriesState(snap, str(replica))
                continue
            d_num = snap[0] - st.snapshot[0]
            d_den = snap[1] - st.snapshot[1]
            st.snapshot = snap
            if d_den <= 0:
                continue            # no traffic this window
            value = d_num / d_den
            self._judge_locked(name, str(replica), value, bound,
                               direction, st, events, samples=d_den)

    def _judge_locked(self, name, replica, value, bound, direction, st,
                      events, samples: int):
        st.windows += 1
        st.last_value = value
        if direction == "ceiling":
            ok = value <= bound
            margin = (bound - value) / bound
        else:
            ok = value >= bound
            margin = (value - bound) / max(bound, 1e-12)
        reg = telemetry.registry()
        reg.gauge("ff_slo_margin",
                  "normalized SLO headroom (positive = within budget)",
                  labels=("slo", "replica")).labels(
            name, replica).set(round(margin, 6))
        if not ok:
            st.breached = True
            st.ok_streak = 0
            self.breaches_fired += 1
            reg.counter("ff_slo_breach_total",
                        "SLO windows judged in breach",
                        labels=("slo", "replica")).labels(
                name, replica).inc()
            ev = {"slo": name, "replica": replica,
                  "value": round(value, 6), "bound": bound,
                  "direction": direction, "samples": samples}
            events.append(ev)
            fflogger.warning(
                "SLO BREACH: %s replica=%s value=%.6g bound=%.6g "
                "(%s, %d samples in window)", name, replica, value,
                bound, direction, samples)
            telemetry.annotate("slo_breach", slo=name, replica=replica,
                               value=round(value, 6), bound=bound)
            if self.trip_recorder:
                _recorder.trip("slo_breach", **ev)
        elif st.breached:
            st.ok_streak += 1
            if st.ok_streak >= self.clear_windows:
                st.breached = False
                st.ok_streak = 0
                fflogger.warning(
                    "SLO clear: %s replica=%s back within budget "
                    "(%d healthy windows)", name, replica,
                    self.clear_windows)
                telemetry.annotate("slo_clear", slo=name,
                                   replica=replica,
                                   value=round(value, 6))
        reg.gauge("ff_slo_status",
                  "1 = within budget, 0 = in breach",
                  labels=("slo", "replica")).labels(
            name, replica).set(0 if st.breached else 1)

    def _rebaseline_locked(self):
        """Snapshot every currently-known series so pre-configure
        history is invisible to the first judgement."""
        reg = telemetry.registry()
        for name in self.specs:
            _n, _k, _d, kind, keys = self._by_name[name]
            if kind != "hist_p99":
                continue
            for fam_name in keys:
                fam = reg.family(fam_name)
                if fam is None:
                    continue
                for ch in fam.children():
                    labels = dict(ch.labels)
                    sid = (name, fam_name, ch.labels)
                    self._state[sid] = _SeriesState(
                        (list(ch.counts), ch.count),
                        labels.get("replica",
                                   "fleet" if not labels else "?"))
        for name in self.specs:
            _n, _k, _d, kind, keys = self._by_name[name]
            if kind != "ratio":
                continue
            for fn in self._sources.live():
                try:
                    replica, counters = fn()
                except Exception:
                    continue
                sid = (name, "source", str(replica))
                self._state[sid] = _SeriesState(
                    (int(counters.get(keys[0], 0)),
                     int(counters.get(keys[1], 0))), str(replica))

    # ---- introspection ----------------------------------------------------

    def breaches(self) -> List[Dict]:
        """Series currently in breach (hysteresis not yet cleared)."""
        with self._lock:
            out = []
            for (name, _src, _key), st in self._state.items():
                if st.breached:
                    out.append({
                        "slo": name,
                        "replica": st.replica,
                        "value": st.last_value,
                        "bound": self.specs.get(name),
                        "ok_streak": st.ok_streak,
                        "windows": st.windows})
            return out

    def describe(self) -> Dict:
        """Full monitor state — the ``/slo.json`` body."""
        with self._lock:
            series = []
            for (name, src, key), st in self._state.items():
                labels = dict(key) if isinstance(key, tuple) \
                    and key and isinstance(key[0], tuple) else \
                    {"replica": str(key)}
                labels["replica"] = st.replica
                series.append({
                    "slo": name, "series": src,
                    "labels": labels,
                    "value": st.last_value,
                    "bound": self.specs.get(name),
                    "breached": st.breached,
                    "ok_streak": st.ok_streak,
                    "windows": st.windows})
            return {
                "window_s": self.window_s,
                "clear_windows": self.clear_windows,
                "trip_recorder": self.trip_recorder,
                "specs": dict(self.specs),
                "evaluations": self.evaluations,
                "breaches_fired": self.breaches_fired,
                "series": series,
                "breaches": [s for s in series if s["breached"]],
            }


# --------------------------------------------------------------- HBM ledger


class HBMLedger:
    """Per-subsystem device-memory accounting. Sources are weakly-held
    callables ``fn() -> (name, {subsystem: bytes})`` (engines: KV pool
    incl. host tier, adapter pool, serving weights; the model: params,
    optimizer state). Published as ``ff_hbm_bytes{source,subsystem}``
    series by a registry collector at every scrape, embedded in every
    post-mortem bundle, and cross-checked against fflint's footprint
    pass (``ff_hbm_lint_estimated_bytes``, where a model sets one)."""

    def __init__(self):
        self._lock = locks.make_lock("hbm-ledger")
        self._sources = _WeakCallables()
        self._registered_on = None
        self.lint_estimated_bytes: Optional[float] = None

    def add_source(self, fn: Callable[[], Tuple[str, Dict[str, int]]]):
        self._sources.register(fn)
        self._ensure_collector()

    def set_lint_estimate(self, est_bytes: Optional[float]):
        with self._lock:
            self.lint_estimated_bytes = (float(est_bytes)
                                         if est_bytes is not None
                                         else None)
        self._ensure_collector()

    def _ensure_collector(self):
        reg = telemetry.registry()
        with self._lock:
            if self._registered_on is reg:
                return
            self._registered_on = reg
        reg.add_collector(self._collect)

    def snapshot(self) -> Dict:
        with self._lock:
            lint = self.lint_estimated_bytes
        sources: Dict[str, Dict[str, int]] = {}
        for fn in self._sources.live():
            try:
                name, subs = fn()
            except Exception:
                continue
            row = sources.setdefault(str(name), {})
            for k, v in subs.items():
                row[str(k)] = int(v)
        total = sum(v for subs in sources.values()
                    for v in subs.values())
        out = {"sources": sources, "total_tracked_bytes": total,
               "device": device_memory_stats()}
        if lint is not None:
            out["lint_estimated_bytes"] = lint
            out["lint_vs_tracked_ratio"] = round(
                lint / max(total, 1), 4)
        return out

    def _collect(self, reg):
        if not _on():
            return
        snap = self.snapshot()
        fam = reg.gauge("ff_hbm_bytes",
                        "tracked device/host memory by subsystem "
                        "(the memory-objective search's per-pool ledger)",
                        labels=("source", "subsystem"))
        for name, subs in snap["sources"].items():
            for k, v in subs.items():
                fam.labels(name, k).set(v)
        reg.gauge("ff_hbm_total_tracked_bytes",
                  "sum of every tracked ff_hbm_bytes subsystem").set(
            snap["total_tracked_bytes"])
        if "lint_estimated_bytes" in snap:
            reg.gauge("ff_hbm_lint_estimated_bytes",
                      "fflint hbm-footprint pass estimate (cross-check "
                      "against the tracked ledger)").set(
                snap["lint_estimated_bytes"])
        dev = reg.gauge("ff_hbm_device_bytes",
                        "backend device_memory_stats, where available",
                        labels=("device", "stat"))
        for d, stats in snap["device"].items():
            for k, v in stats.items():
                dev.labels(d, k).set(v)


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Memory stats per local card, under the JAX package's stat names:
    ``bytes_in_use`` / ``peak_bytes_in_use`` (the caching allocator's
    allocated bytes, ``torch.cuda.memory_stats``), ``bytes_reserved``,
    ``bytes_limit`` (the card's total, ``torch.cuda.mem_get_info``) and
    ``bytes_free``. Keyed ``gpu:<index>``. Empty without a card (what the
    JAX function returns on a backend without stats). Never raises, and
    reads only cards the process has already initialized."""
    out: Dict[str, Dict[str, float]] = {}
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return out
        for i in range(torch.cuda.device_count()):
            try:
                ms = torch.cuda.memory_stats(i)
                free, total = torch.cuda.mem_get_info(i)
            except Exception:
                continue
            out[f"gpu:{i}"] = {
                "bytes_in_use": float(ms.get("allocated_bytes.all.current",
                                             0)),
                "peak_bytes_in_use": float(
                    ms.get("allocated_bytes.all.peak", 0)),
                "bytes_reserved": float(ms.get("reserved_bytes.all.current",
                                               0)),
                "bytes_limit": float(total),
                "bytes_free": float(free)}
    except Exception:
        pass
    return out


# ---------------------------------------------------------- health rollup

_health_sources = _WeakCallables()


def register_health_source(fn: Callable[[], Dict]):
    """Register a lock-free/cheap health probe (``ServingRouter.health``
    for fleets; an engine's load probe solo) consumed by the
    ``/healthz`` rollup. Weakly referenced."""
    _health_sources.register(fn)


def health_rollup() -> Dict:
    """Fleet health: ``ok`` | ``degraded`` | ``breach`` with per-SLO
    reasons — the ``/healthz`` body. Evaluation rides the SLO monitor's
    own window cadence (``maybe_evaluate``); the probes themselves are
    the lock-free/cheap ones, so this never compiles and never blocks
    behind a mid-tick replica."""
    _slo.maybe_evaluate()
    breaches = _slo.breaches()
    fleet = []
    degraded: List[str] = []
    for fn in _health_sources.live():
        try:
            row = fn()
            if not isinstance(row, dict):
                row = {"value": _jsonable(row)}
        except Exception as e:  # noqa: BLE001
            row = {"error": f"{type(e).__name__}: {e}"}
            degraded.append("health probe failed")
        fleet.append(_jsonable(row))
        if row.get("fenced", 0):
            degraded.append(f"{row['fenced']} replica(s) fenced")
        if row.get("status") in ("dead", "draining"):
            degraded.append(f"fleet status {row['status']}")
        if row.get("deploying"):
            # a rolling deploy is a PLANNED capacity dip: degraded
            # (operators see it), never a breach (nothing is wrong)
            degraded.append("rolling deploy in progress")
        alive, total = row.get("alive"), row.get("replicas")
        if alive is not None and total is not None and alive < total:
            degraded.append(f"{total - alive}/{total} replicas down")
    slos = {name: "ok" for name in _slo.specs}
    for b in breaches:
        name = b["slo"]
        cur = slos.get(name)
        if not isinstance(cur, list):
            slos[name] = []
        slos[name].append({k: b[k] for k in
                           ("replica", "value", "bound")})
    status = ("breach" if breaches
              else "degraded" if degraded else "ok")
    return {
        "status": status,
        "slos": slos,
        "breaches": breaches,
        "degraded_reasons": sorted(set(degraded)),
        "fleet": fleet,
        "recorder": _recorder.stats(),
    }


# ------------------------------------------------------------- process-wide

_recorder = FlightRecorder()
_slo = SLOMonitor()
_hbm = HBMLedger()
_log_ring = LogRing()
# the log window is ALWAYS on (the docstring's contract): a bundle
# written before any configure() — an env-FF_FLIGHT_DIR auto trigger
# during model build, a manual dump in an engine-less process — still
# carries recent logs
_ensure_log_handler()


def recorder() -> FlightRecorder:
    return _recorder


def slo_monitor() -> SLOMonitor:
    return _slo


def hbm_ledger() -> HBMLedger:
    return _hbm


def log_ring() -> LogRing:
    return _log_ring


def configure(cfg):
    """Wire the recorder, SLO monitor and HBM ledger from one FFConfig
    (engines, routers, supervisors and ``fit()`` all call this — last
    configure wins). Also installs the log-ring handler once."""
    _ensure_log_handler()
    _recorder.configure(cfg)
    _slo.configure(cfg)
    _hbm._ensure_collector()


def trip(cause: str, exc: Optional[BaseException] = None, **args):
    """Module-level trigger shorthand (what every trigger site calls)."""
    _recorder.trip(cause, exc=exc, **args)


def dump(cause: str = "manual", directory: Optional[str] = None,
         **args) -> Optional[str]:
    return _recorder.dump(cause, directory=directory, **args)


def reset():
    """Fresh singletons (tests). Sources, pending triggers and SLO state
    registered against the old objects are dropped; the log handler
    stays installed and feeds the new ring."""
    global _recorder, _slo, _hbm, _log_ring, _health_sources, _enabled
    t = _recorder._timer
    if t is not None:
        t.cancel()
    _recorder = FlightRecorder()
    _slo = SLOMonitor()
    _hbm = HBMLedger()
    _log_ring = LogRing()
    _health_sources = _WeakCallables()
    _enabled = True
