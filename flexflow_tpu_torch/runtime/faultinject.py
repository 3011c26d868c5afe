"""Deterministic fault injection (a copy of the JAX package's
``runtime/faultinject.py``; the port imports nothing of that package).

    FF_FAULT=d2h_fail@migrate:1,h2d_fail@promote:2,swap_fail@deploy:1

Grammar: comma-separated ``kind[(value)]@site:index`` events.

  kind   free-form token consumed by the subsystem that checks it,
         optionally carrying one integer parameter in parentheses —
         read back via ``FaultPlan.last_value`` after a match
  site   where the event fires. ``step`` is special: *index* is the 1-based
         global training step. ``replica`` is identity-indexed (checked
         with ``pending()`` / ``at_site()``). Every other site is
         occurrence-counted: *index* is the 1-based call count at that
         site, so ``d2h_fail@migrate:1`` fails exactly the first demotion.

Duplicate kinds are allowed; a range ``kind@site:3-5`` expands to one
event per index.

Consumers in the port:
  * the tiered prefix cache (``runtime/serving.py RadixPrefixCache``)
    checks ``d2h_fail@migrate:<n>`` on the n-th HBM->host demotion (the
    page dies exactly as it would without a host tier) and
    ``h2d_fail@promote:<n>`` on the n-th host->HBM promotion (the host
    copy is killed and admission falls back to a cold prefill);
  * ``ServingEngine.swap_weights`` checks ``swap_fail@deploy:<n>`` via
    ``maybe_fail`` after installing the new weights (the torn mid-swap
    drill: the engine restores the weights it served).
  * ``ServingEngine._admit`` checks ``slow(<ms>)@serve:<n>`` and stalls
    the n-th admission on the host by ``<ms>`` (the slow-replica drill),
    and ``slow(<ms>)@canary:<n>`` only while the engine is a deploy's
    canary (the canary SLO-breach drill ``runtime/deploy.py`` rolls
    back);
  * ``runtime/router.py`` drives the fleet drills: ``crash@replica:<r>``
    kills replica r's driver thread and ``hang@replica:<r>`` wedges it
    past the health timeout — at its first busy tick, or at its
    *value*-th with ``crash(<tick>)@replica:<r>`` (peeked with
    ``pending()``, consumed with ``at_site()``);
    ``preempt(<deadline_ms>)@replica:<r>`` preempts replica r at its
    first busy tick with that evacuation deadline; and the evacuation
    checks ``slow_evac(<ms>)@evacuate:<n>`` to stall the n-th prefix-slab
    export.

Training and the deploy plane:
  * ``TrainSupervisor`` (``runtime/resilience.py``) checks
    ``nan_loss@step:<n>`` (NaN added to step n's loss; needs the guard),
    ``sigterm@step:<n>`` (a real SIGTERM at the boundary after step n —
    a range, so a scanned chunk crossing n delivers it) and
    ``hang@step:<n>`` (``run()``'s step n blocks past the watchdog);
  * ``runtime/checkpoint.py`` checks ``io_fail@save:<n>`` /
    ``io_fail@load:<n>`` inside its retry (the retry path is the drill)
    and ``corrupt_ckpt@save:<n>`` (bytes flipped in the n-th published
    step); ``WeightArtifactRegistry.publish`` checks
    ``corrupt_ckpt@publish:<n>`` (the n-th artifact torn after it lands);
  * ``runtime/elastic.py`` refuses ``shrink(<k>)@resume:<n>``: a mesh
    refit onto fewer devices is ROADMAP item 8.

The active plan is parsed lazily from ``FF_FAULT`` and re-parsed (with
occurrence counters reset) whenever the env value changes; tests that
reuse a spec should call ``reset()`` between runs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple


def _annotate(kind: str, site: str, index: int,
              value: Optional[int] = None):
    """Report a FIRED injection to the telemetry plane (an instant
    ``fault`` trace annotation) and the flight recorder (a ``fault``
    trigger), so a drill's trace shows where the fault landed. Deferred
    imports (telemetry never imports this module back) and best-effort:
    injection must work even with the plane torn down."""
    try:
        from flexflow_tpu_torch.runtime import telemetry

        telemetry.annotate("fault", kind=kind, site=site, index=index,
                           value=value)
    except Exception:
        pass
    try:
        from flexflow_tpu_torch.runtime import flightrec

        flightrec.trip("fault", kind=kind, site=site, index=index,
                       value=value)
    except Exception:
        pass


class InjectedFault(OSError):
    """Raised by ``maybe_fail``: an IO-flavored injected failure (OSError
    subclass so generic retry(retryable=(OSError,)) policies cover it)."""


class FaultPlan:
    def __init__(self, events: List[Tuple[str, str, int]],
                 values: Optional[Dict[Tuple[str, str, int], int]] = None):
        # [(kind, site, index), ...] — index is a step number for
        # site == "step", a 1-based occurrence count otherwise. Events
        # stay 3-tuples (existing consumers pattern-match them); an
        # optional integer parameter (``shrink(2)@resume:1``) rides in
        # `values`, surfaced through `last_value` after a match.
        self.events = list(events)
        self.values: Dict[Tuple[str, str, int], int] = dict(values or {})
        # parameter of the most recent matched event (at_step/fire); None
        # when the event carried no parameter
        self.last_value: Optional[int] = None
        self._counts: Dict[Tuple[str, str], int] = {}
        self._consumed: set = set()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        import re

        events: List[Tuple[str, str, int]] = []
        values: Dict[Tuple[str, str, int], int] = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            kind, at, rest = part.partition("@")
            site, colon, idx = rest.partition(":")
            if not at or not colon or not kind or not site:
                raise ValueError(
                    f"FF_FAULT entry {part!r}: expected 'kind@site:index' "
                    f"(e.g. nan_loss@step:7)")
            value = None
            m = re.fullmatch(r"([A-Za-z_][\w-]*)(?:\((\d+)\))?", kind)
            if not m:
                raise ValueError(
                    f"FF_FAULT entry {part!r}: kind must be a bare token "
                    f"or 'kind(value)' with an integer value "
                    f"(e.g. shrink(2)@resume:1), got {kind!r}")
            kind = m.group(1)
            if m.group(2) is not None:
                value = int(m.group(2))
            lo, dash, hi = idx.partition("-")
            try:
                lo_i = int(lo)
                hi_i = int(hi) if dash else lo_i
            except ValueError:
                raise ValueError(
                    f"FF_FAULT entry {part!r}: index must be an integer "
                    f"or range 'lo-hi', got {idx!r}") from None
            if hi_i < lo_i:
                raise ValueError(f"FF_FAULT entry {part!r}: empty range")
            for i in range(lo_i, hi_i + 1):
                events.append((kind, site, i))
                if value is not None:
                    values[(kind, site, i)] = value
        return cls(events, values)

    def at_site(self, kind: str, site: str, index: int) -> bool:
        """Identity-indexed one-shot check: True when the plan holds
        ``kind@site:<index>`` where *index* names a thing (a step number,
        a replica id) rather than a call count. A fired event is
        consumed, so it happens exactly once; ``last_value`` carries its
        parameter."""
        ev = (kind, site, int(index))
        if ev in self.events and ev not in self._consumed:
            self._consumed.add(ev)
            self.last_value = self.values.get(ev)
            _annotate(kind, site, int(index), self.last_value)
            return True
        return False

    def pending(self, kind: str, site: str,
                index: int) -> Tuple[bool, Optional[int]]:
        """(scheduled, value) for an identity-indexed event WITHOUT
        consuming it. Callers that trigger on their own clock — the
        router fires ``crash@replica:<r>`` at the replica's value-th
        busy tick — peek here each tick and consume with ``at_site()``
        only when their trigger condition is met."""
        ev = (kind, site, int(index))
        if ev in self.events and ev not in self._consumed:
            return True, self.values.get(ev)
        return False, None

    def at_step(self, kind: str, step: int) -> bool:
        """True when the plan holds ``kind@step:<step>``. One-shot: a
        fired event is consumed, so a supervisor rewind that re-executes
        the step does not re-inject (the fault "happened" once)."""
        return self.at_site(kind, "step", step)

    def has_step_events(self, *kinds: str) -> bool:
        """Does the plan schedule any step-site event of these kinds?
        (Unconsumed only.) Callers with chunked step counters use this to
        fall back to per-step execution so injection can actually land."""
        return any(k in kinds and s == "step" and (k, s, i) not in
                   self._consumed for k, s, i in self.events)

    def in_step_range(self, kind: str, lo: int, hi: int) -> bool:
        """True when the plan holds ``kind@step:i`` with lo < i <= hi.
        Needed by callers whose step counter advances in chunks (fit's
        scanned multi-step program jumps scan_steps at a time) — exact
        equality would silently skip events landing inside a chunk.
        Consumes every matched event (one-shot, like at_step)."""
        fired = False
        for ev in self.events:
            k, s, i = ev
            if (k == kind and s == "step" and lo < i <= hi
                    and ev not in self._consumed):
                self._consumed.add(ev)
                _annotate(kind, "step", i)
                fired = True
        return fired

    def fire(self, kind: str, site: str) -> bool:
        """Occurrence-counted sites: increments the (kind, site) call
        counter and reports whether this occurrence is scheduled to fail.
        Only counts when the plan mentions (kind, site) at all, so an
        unrelated plan never accumulates counters."""
        if not any(k == kind and s == site for k, s, _ in self.events):
            return False
        key = (kind, site)
        self._counts[key] = n = self._counts.get(key, 0) + 1
        if (kind, site, n) in self.events:
            self.last_value = self.values.get((kind, site, n))
            _annotate(kind, site, n, self.last_value)
            return True
        return False

    def __bool__(self) -> bool:
        return bool(self.events)

    def __repr__(self) -> str:
        return f"FaultPlan({self.events!r})"


_plan: Optional[FaultPlan] = None
_plan_spec: Optional[str] = None


def active_plan() -> FaultPlan:
    """The process-wide plan from ``FF_FAULT``. Re-parsed (counters reset)
    whenever the env value changes, so monkeypatched tests see fresh
    state; identical spec across tests needs an explicit reset()."""
    global _plan, _plan_spec
    spec = os.environ.get("FF_FAULT", "")
    if _plan is None or spec != _plan_spec:
        _plan = FaultPlan.parse(spec)
        _plan_spec = spec
    return _plan


def reset():
    """Drop the cached plan and its occurrence counters."""
    global _plan, _plan_spec
    _plan = None
    _plan_spec = None


def maybe_fail(kind: str, site: str):
    """Raise InjectedFault when the active plan schedules this occurrence
    of (kind, site). Call sites place this INSIDE their retry wrapper so
    the retry path itself is what gets exercised."""
    if active_plan().fire(kind, site):
        raise InjectedFault(
            f"injected fault: {kind}@{site} (FF_FAULT)")
