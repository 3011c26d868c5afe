"""SLO-driven fleet autoscaling + replacement placement (the JAX package's
``runtime/autoscale.py``).

The SLO monitor (runtime/flightrec.py) is the scale TRIGGER, the router's
live-membership primitives (``add_replica`` / ``remove_replica``) are the
ACTUATORS, and the machine model (search/machine.py, H100 datasheet
figures) PRICES where a replacement lands.

``AutoscalePolicy`` is a windowed hysteresis controller:

  * SCALE OUT when a ``queue_wait_p99`` / ``ttft_p99`` SLO breach persists
    across ``autoscale_breach_windows`` consecutive policy windows (one
    window = one SLO evaluation, FFConfig.slo_window_s);
  * SCALE IN when the fleet sits fully idle (nothing queued, nothing
    outstanding, no breach) for ``autoscale_idle_windows`` consecutive
    windows; the retiree is the least-loaded live replica, whose queued
    requests are resubmitted and whose cached prefixes survivors inherit;
  * breach and idle streaks reset each other, every action zeroes both
    and starts ``autoscale_cooldown_s``, and ``autoscale_min_replicas`` /
    ``autoscale_max_replicas`` bound the fleet.

Drive it with ``start()`` (a daemon thread ticking every policy window)
or ``tick()`` directly for deterministic stepping. The policy registers
on the ``/healthz`` rollup and exports ``ff_autoscale_*`` series.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Dict, Optional

from flexflow_tpu_torch.runtime import flightrec, locks, telemetry
from flexflow_tpu_torch.search.machine import MachineModel

fflogger = logging.getLogger("flexflow_tpu_torch")

# the SLO series that mean "not enough serving capacity" — the only two
# an autoscaler may act on (hit-rate or accept-rate SLOs are quality
# regressions more capacity cannot fix)
_SCALE_SLOS = ("queue_wait_p99", "ttft_p99")

# fallback per-page byte estimate for placement pricing before the fleet
# has observed a real evacuation (one KV page of a small bf16 model;
# refined from the router's evacuation ledger as soon as one exists)
_DEFAULT_PAGE_BYTES = 64 * 1024


class PlacementAdvisor:
    """Price where a replacement/scale-out replica should land.

    ``place(nbytes)`` models moving ``nbytes`` of inherited state (page
    slabs, adapter weights) to a replica in the same NVLink domain
    (``ici``) vs across nodes on the fabric (``dcn``), via the machine
    model (search/machine.py; H100 datasheet figures by default). The
    NVLink tier wins while its modeled transfer fits ``budget_s``; past
    that the advisor still ranks the tiers. The keys are the JAX
    package's."""

    def __init__(self, machine: Optional[MachineModel] = None,
                 budget_s: float = 1.0):
        self.machine = machine or MachineModel()
        self.budget_s = float(budget_s)

    def place(self, nbytes: int) -> Dict:
        ici_s = self.machine.p2p_time(float(nbytes), cross_host=False)
        dcn_s = self.machine.p2p_time(float(nbytes), cross_host=True)
        tier = "ici" if ici_s <= self.budget_s else "dcn"
        return {"tier": tier, "state_bytes": int(nbytes),
                "ici_s": round(ici_s, 6), "dcn_s": round(dcn_s, 6),
                "dcn_penalty_x": round(dcn_s / max(ici_s, 1e-12), 2)}


class AutoscalePolicy:
    """The windowed-hysteresis autoscaler over one ``ServingRouter``.

    Lock order: the policy's own lock ranks ``autoscale`` (7) — above
    ``deploy``, below ``router`` — and is NEVER held across an actuator
    call: ``tick()`` decides under its lock, then acts (add/remove
    replica, each taking router + engine locks) outside it, serialized
    by the single-admission ``_acting`` latch instead."""

    def __init__(self, router, config=None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 breach_windows: Optional[int] = None,
                 idle_windows: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 interval_s: Optional[float] = None,
                 advisor: Optional[PlacementAdvisor] = None):
        cfg = config if config is not None else router.model.config

        def knob(val, name, default):
            return val if val is not None else getattr(cfg, name, default)

        self.router = router
        self.min_replicas = int(knob(min_replicas,
                                     "autoscale_min_replicas", 1))
        self.max_replicas = int(knob(max_replicas,
                                     "autoscale_max_replicas", 8))
        self.breach_windows = int(knob(breach_windows,
                                       "autoscale_breach_windows", 2))
        self.idle_windows = int(knob(idle_windows,
                                     "autoscale_idle_windows", 6))
        self.cooldown_s = float(knob(cooldown_s,
                                     "autoscale_cooldown_s", 30.0))
        self.interval_s = float(interval_s if interval_s is not None
                                else getattr(cfg, "slo_window_s", 10.0))
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas={self.min_replicas}: must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas={self.max_replicas}: must be >= "
                f"min_replicas ({self.min_replicas})")
        self.advisor = advisor or PlacementAdvisor(MachineModel())
        self._lock = locks.make_lock("autoscale")
        self._breach_streak = 0
        self._idle_streak = 0
        self._last_action = ""
        self._last_action_t = 0.0       # monotonic; 0 = never acted
        self._breach_windows_total = 0
        self._idle_windows_total = 0
        self._cooldown_blocks = 0
        self._bound_blocks = 0
        self._scale_outs = 0
        self._scale_ins = 0
        self._events: collections.deque = collections.deque(maxlen=64)
        self._acting = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tm_on = getattr(cfg, "telemetry", "on") != "off"
        if self._tm_on:
            telemetry.registry().add_collector(self._tm_collect)
            flightrec.register_health_source(self._health_probe)

    # ---- the policy ------------------------------------------------------

    def tick(self) -> Optional[str]:
        """One policy evaluation: fold the current SLO verdict and fleet
        load into the streaks, then act if a threshold crossed. Returns
        the action taken (``"scale_out"``/``"scale_in"``) or None.
        Deterministic given the monitor's window state — the smoke and
        tests call this directly instead of racing the loop thread."""
        slo = flightrec.slo_monitor()
        slo.maybe_evaluate()
        breaches = [b for b in slo.breaches()
                    if b["slo"] in _SCALE_SLOS]
        h = self.router.health()
        busy = bool(h["queued"] or h["outstanding"])
        alive = h["alive"]
        now = time.monotonic()
        with self._lock:
            if breaches:
                self._breach_streak += 1
                self._breach_windows_total += 1
                self._idle_streak = 0
            elif not busy:
                self._idle_streak += 1
                self._idle_windows_total += 1
                self._breach_streak = 0
            else:
                # healthy under load: neither pressure nor calm
                self._breach_streak = 0
                self._idle_streak = 0
            cooling = (self._last_action_t
                       and now - self._last_action_t < self.cooldown_s)
            action = None
            if self._breach_streak >= self.breach_windows:
                if alive >= self.max_replicas:
                    self._bound_blocks += 1
                elif cooling:
                    self._cooldown_blocks += 1
                else:
                    action = "scale_out"
            elif self._idle_streak >= self.idle_windows:
                if alive <= self.min_replicas:
                    self._bound_blocks += 1
                elif cooling:
                    self._cooldown_blocks += 1
                else:
                    action = "scale_in"
        if action is None:
            return None
        if self._acting.is_set():
            return None     # an actuator call is already in flight
        self._acting.set()
        try:
            return self._act(action, breaches)
        finally:
            self._acting.clear()

    def _act(self, action: str, breaches) -> Optional[str]:
        advice = self.advisor.place(self._est_state_bytes())
        try:
            if action == "scale_out":
                r = self.router.add_replica()
            else:
                r = self._pick_retiree()
                if r is None:
                    return None
                self.router.remove_replica(r)
        except Exception as e:  # noqa: BLE001 — a failed actuation must
            #   not kill the policy loop; the streaks re-trigger it
            fflogger.warning("autoscale: %s failed (%s)", action, e)
            return None
        event = {"action": action, "replica": r,
                 "t": time.time(), "placement": advice,
                 "breached": sorted({b["slo"] for b in breaches})}
        with self._lock:
            if action == "scale_out":
                self._scale_outs += 1
            else:
                self._scale_ins += 1
            self._breach_streak = 0
            self._idle_streak = 0
            self._last_action = action
            self._last_action_t = time.monotonic()
            self._events.append(event)
        if self._tm_on:
            telemetry.tracer().instant(
                "autoscale", track="router", action=action, replica=r,
                tier=advice["tier"])
        fflogger.info(
            "autoscale: %s -> replica %d (placement %s: ici %.3gs vs "
            "dcn %.3gs for %d inherited bytes)", action, r,
            advice["tier"], advice["ici_s"], advice["dcn_s"],
            advice["state_bytes"])
        return action

    def _pick_retiree(self) -> Optional[int]:
        """Retire the least-loaded, least-prefix-hot live replica —
        evacuation then moves the least state. Suspended/canary replicas
        are the deployer's business, never the autoscaler's."""
        st = self.router.stats()
        rows = [r for r in st["per_replica"]
                if not r["fenced"] and not r["retired"]
                and not r["suspended"]]
        if len(rows) <= self.min_replicas:
            return None
        rows.sort(key=lambda r: (r["outstanding"], r["queued"],
                                 -r["replica"]))
        return rows[0]["replica"]

    def _est_state_bytes(self) -> int:
        """Bytes a replacement inherits, for placement pricing: the
        fleet's observed per-page evacuation cost (its own ledger) times
        the pages one replica holds — falling back to a nominal page
        size before any evacuation has been measured."""
        st = self.router.stats()
        pages = sum(st["fleet"]["pages_by_tier"].values())
        per_replica_pages = pages / max(1, st["alive"])
        if st["evacuated_pages"]:
            per_page = st["evacuation_bytes"] / st["evacuated_pages"]
        else:
            per_page = _DEFAULT_PAGE_BYTES
        return int(per_replica_pages * per_page)

    # ---- lifecycle -------------------------------------------------------

    def start(self):
        """Spawn the policy loop (one tick per ``interval_s``);
        idempotent."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ff-autoscale")
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001
                fflogger.warning("autoscale: tick failed (%s)", e)

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # ---- observability ---------------------------------------------------

    def state(self) -> Dict:
        """Controller state (keys pinned — the /healthz row and the
        smoke's assertion surface)."""
        with self._lock:
            cooldown_left = 0.0
            if self._last_action_t:
                cooldown_left = max(
                    0.0, self.cooldown_s
                    - (time.monotonic() - self._last_action_t))
            return {
                "breach_streak": self._breach_streak,
                "idle_streak": self._idle_streak,
                "breach_windows": self.breach_windows,
                "idle_windows": self.idle_windows,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "cooldown_s": self.cooldown_s,
                "cooldown_remaining_s": round(cooldown_left, 3),
                "last_action": self._last_action,
                "scale_outs": self._scale_outs,
                "scale_ins": self._scale_ins,
                "cooldown_blocks": self._cooldown_blocks,
                "bound_blocks": self._bound_blocks,
                "events": list(self._events),
            }

    def _health_probe(self) -> Dict:
        # deliberately no "alive"/"replicas"/"fenced"/"status" keys:
        # those would alias the rollup's fleet-degradation heuristics —
        # the router's own row covers the fleet
        st = self.state()
        st.pop("events", None)
        return {"kind": "autoscaler", **st}

    def _tm_collect(self, reg):
        st = self.state()
        reg.gauge("ff_autoscale_scale_outs",
                  "autoscaler-initiated replica additions"
                  ).set(st["scale_outs"])
        reg.gauge("ff_autoscale_scale_ins",
                  "autoscaler-initiated replica retirements"
                  ).set(st["scale_ins"])
        reg.gauge("ff_autoscale_breach_streak",
                  "consecutive policy windows with a capacity-SLO "
                  "breach").set(st["breach_streak"])
        reg.gauge("ff_autoscale_idle_streak",
                  "consecutive fully-idle policy windows"
                  ).set(st["idle_streak"])
        reg.gauge("ff_autoscale_cooldown_blocks",
                  "actions suppressed by the cooldown (hysteresis "
                  "working)").set(st["cooldown_blocks"])
        reg.gauge("ff_autoscale_bound_blocks",
                  "actions suppressed by the min/max replica bounds"
                  ).set(st["bound_blocks"])
        reg.gauge("ff_autoscale_cooldown_remaining_seconds",
                  "seconds until the next action is allowed"
                  ).set(st["cooldown_remaining_s"])
