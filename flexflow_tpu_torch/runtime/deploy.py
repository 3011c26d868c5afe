"""Rolling deployment: weight-version registry + SLO-gated fleet roll (the
JAX package's ``runtime/deploy.py``).

A ``WeightArtifactRegistry`` is a directory of manifest-verified weight
artifacts in the checkpoint layout (``step_<N>`` dirs, version
``v<N>``), so a training loop checkpointing into it publishes versions
with no export step. A ``RollingDeployer`` rolls a ``ServingRouter`` fleet
onto a version one replica at a time — the fleet never drops below N-1
capacity and no in-flight request is dropped:

  1. SUSPEND — the router stops dispatching new work to the replica; its
     driver keeps ticking, so in-flight work drains naturally.
  2. QUIESCE + DRAIN — wait until the router owes the replica nothing,
     then ``engine.drain()``.
  3. SWAP — ``engine.swap_weights(tree, version)``. Every replica of a
     fleet shares its model, so the engine moves to the version's
     per-version WeightSet (one device copy a live version, shared by the
     replicas on it) and captures its decode / verify programs against it
     here, drained (``runtime/serving.py``); the drained prefix cache
     flushes.
  4. REOPEN + RE-WARMUP — ``reopen()``, then ``warmup()`` under the new
     weights, which rebaselines the SLO windows.
  5. RESUME — the router readmits the replica and drops its stale
     affinity entries.

The FIRST swapped replica is a CANARY: it serves live traffic under its
own rebaselined SLO windows for ``deploy_canary_windows`` full windows
before any other replica is touched; a breach attributed to it rolls every
swapped replica back to its prior version and dumps a flight-recorder
bundle naming the SLO. A corrupt or torn artifact (manifest verify fails)
REFUSES the deploy before any replica is touched. Two versions A/B-serve
behind one router during the roll with zero stale-KV hits: prefix-cache
namespaces and affinity keys carry the version (``serving.version_ns``).

Drills (FF_FAULT): ``corrupt_ckpt@publish:<n>`` tears the n-th published
artifact; ``swap_fail@deploy:<n>`` dies mid-swap (the deploy rolls back);
``slow(<ms>)@canary:<n>`` stalls canary admissions (the SLO breach).
"""

from __future__ import annotations

import logging
import os
import re
import time
from typing import Dict, List, Optional

from flexflow_tpu_torch.runtime import checkpoint, faultinject, flightrec, \
    locks
from flexflow_tpu_torch.runtime.serving import DEFAULT_WEIGHT_VERSION

fflogger = logging.getLogger("flexflow_tpu_torch")

_VERSION_RE = re.compile(r"v(\d+)")


def _version_step(version: str) -> int:
    m = _VERSION_RE.fullmatch(str(version))
    if not m:
        raise ValueError(
            f"weight version {version!r}: registry versions are "
            f"'v<step>' (one per published checkpoint step)")
    return int(m.group(1))


class WeightArtifactRegistry:
    """Manifest-verified weight artifacts keyed by version, in one watch
    directory in the checkpoint layout: ``save_checkpoint(model,
    watch_dir, async_save=True)`` from a training loop makes version
    ``v<N>`` appear here with the same atomicity (a torn artifact fails
    ``verify`` and the deployer refuses it)."""

    def __init__(self, watch_dir: str):
        if not watch_dir:
            raise ValueError(
                "WeightArtifactRegistry needs a watch directory "
                "(FFConfig.deploy_watch_dir or an explicit path)")
        self.watch_dir = os.path.abspath(watch_dir)

    def versions(self) -> List[str]:
        """Published versions, oldest first."""
        return [f"v{s}"
                for s in sorted(checkpoint._step_dirs(self.watch_dir))]

    def latest(self) -> Optional[str]:
        vs = self.versions()
        return vs[-1] if vs else None

    def latest_intact(self) -> Optional[str]:
        """Newest version whose manifest verifies."""
        s = checkpoint.latest_intact_step(self.watch_dir)
        return None if s is None else f"v{s}"

    def step_dir(self, version: str) -> str:
        return os.path.join(self.watch_dir,
                            f"step_{_version_step(version)}")

    def publish(self, model, step: Optional[int] = None,
                async_save: bool = False) -> str:
        """Publish the model's current weights (and whatever state it
        holds) as version ``v<step>``; returns the version once the
        artifact is live. FF_FAULT=corrupt_ckpt@publish:<n> flips bytes in
        the n-th published artifact after it lands."""
        step = int(step if step is not None else model._step_count)
        version = f"v{step}"
        if version == DEFAULT_WEIGHT_VERSION:
            raise ValueError(
                f"cannot publish as {version!r}: that is the reserved "
                f"construction-weights version every engine starts on — "
                f"publish at step >= 1")
        checkpoint.save_checkpoint(model, self.watch_dir, step=step,
                                   async_save=async_save)
        if async_save:
            checkpoint.wait_pending_saves(self.watch_dir)
        if faultinject.active_plan().fire("corrupt_ckpt", "publish"):
            checkpoint._inject_corruption(self.step_dir(version))
        return version

    def verify(self, version: str):
        """Recompute the artifact's manifest hashes; raises
        ``CheckpointCorruptError`` naming the first mismatching file."""
        checkpoint.verify_checkpoint(self.watch_dir,
                                     _version_step(version))

    def load_params(self, version: str):
        """The artifact's weights as CPU tensors in model.params'
        structure ({op: {weight: tensor}}), memory-mapped."""
        payload = checkpoint.load_payload(self.step_dir(version))
        tree: Dict[str, Dict] = {}
        for name, t in payload.items():
            if name.startswith("params/"):
                op, w = name[len("params/"):].rsplit("/", 1)
                tree.setdefault(op, {})[w] = t
        return tree


class RollingDeployer:
    """Drive a fleet roll through the router: verify, then per replica
    suspend -> quiesce -> drain -> swap -> warmup -> resume, with the
    first replica as the SLO-judged canary. Outcomes come back as a
    report dict (state ``completed`` | ``noop`` | ``refused`` |
    ``rolled_back`` | ``failed``) rather than exceptions — a refused or
    rolled-back deploy is a *result* the caller inspects, not a crash.

    One roll at a time per deployer (the "deploy" lock, outermost in
    the hierarchy: a roll step takes router and engine locks beneath
    it)."""

    def __init__(self, router, registry: Optional[WeightArtifactRegistry]
                 = None, canary_windows: Optional[int] = None,
                 drain_timeout_s: Optional[float] = None):
        cfg = router.model.config
        if registry is None:
            registry = WeightArtifactRegistry(
                getattr(cfg, "deploy_watch_dir", "") or "")
        self.router = router
        self.registry = registry
        self.canary_windows = int(
            canary_windows if canary_windows is not None
            else getattr(cfg, "deploy_canary_windows", 2))
        self.drain_timeout_s = float(
            drain_timeout_s if drain_timeout_s is not None
            else getattr(cfg, "deploy_drain_timeout_s", 120.0))
        self._window_s = float(getattr(cfg, "slo_window_s", 10.0))
        self._lock = locks.make_lock("deploy")
        self.history: List[Dict] = []
        # one entry a swap this deployer made: replica, version, seconds,
        # program captures
        self.swap_log: List[Dict] = []

    # ---- the roll -----------------------------------------------------------

    def deploy(self, version: Optional[str] = None, warmup_prompts=None,
               max_new_tokens: int = 4) -> Dict:
        """Roll every live replica onto ``version`` (default: the
        registry's newest artifact). ``warmup_prompts`` re-warm each
        swapped replica exactly like router.warmup (pass the same set);
        None skips the engine warmup but still rebaselines the SLO
        windows."""
        with self._lock:
            report = self._deploy_locked(version, warmup_prompts,
                                         max_new_tokens)
        self.history.append(report)
        del self.history[:-16]
        return report

    def _deploy_locked(self, version, warmup_prompts, max_new) -> Dict:
        r = self.router
        t0 = time.monotonic()
        if version is None:
            version = self.registry.latest()
            if version is None:
                raise ValueError(
                    f"deploy: no published versions in "
                    f"{self.registry.watch_dir}")
        prior = [eng.weight_version for eng in r.engines]
        report: Dict = {"state": "completed", "version": version,
                        "prior_versions": prior, "swapped": [],
                        "canary": None, "breach": None, "bundle": None,
                        "error": "", "rollback_s": 0.0}
        targets = [i for i in range(r.n) if not r._fenced[i]
                   and r.engines[i].weight_version != version]
        if not targets:
            report["state"] = "noop"
            report["duration_s"] = round(time.monotonic() - t0, 3)
            return report

        # 1. verify FIRST: a corrupt/torn artifact refuses the whole
        # deploy before any replica is touched
        try:
            self.registry.verify(version)
        except checkpoint.CheckpointCorruptError as e:
            report["state"] = "refused"
            report["error"] = str(e)
            report["duration_s"] = round(time.monotonic() - t0, 3)
            fflogger.error(
                "deploy: REFUSED %s — artifact failed manifest verify "
                "(%s); no replica was touched", version, e)
            return report

        # 2. load ONCE: one host tree for every swap; the first swap to a
        # shared model copies it into the version's WeightSet on the
        # device, the later ones reuse that set
        tree = self.registry.load_params(version)

        r.set_deploying(True)
        # the report's list IS the working list: a rolled_back report
        # then names the replicas that were swapped (and rolled back)
        swapped: List[int] = report["swapped"]
        try:
            for n_done, i in enumerate(targets):
                try:
                    self._swap_one(i, tree, version, warmup_prompts,
                                   max_new)
                except Exception as e:  # noqa: BLE001 — the swap_fail
                    #   drill or a real mid-swap death: the engine already
                    #   restored its prior weights; roll everything back
                    report["error"] = (f"swap on replica {i} failed: "
                                       f"{type(e).__name__}: {e}")
                    self._recover_replica(i)
                    self._rollback(swapped, prior, report,
                                   cause="swap_fail")
                    report["state"] = "rolled_back"
                    report["duration_s"] = round(
                        time.monotonic() - t0, 3)
                    return report
                swapped.append(i)
                r.note_swap()
                if n_done == 0 and self.canary_windows > 0:
                    report["canary"] = i
                    breach = self._canary_soak(i)
                    if breach is not None:
                        report["breach"] = breach
                        report["error"] = (
                            f"canary SLO breach: {breach['slo']} = "
                            f"{breach['value']} vs bound "
                            f"{breach['bound']}")
                        self._rollback(swapped, prior, report,
                                       cause="canary_rollback",
                                       breach=breach)
                        report["state"] = "rolled_back"
                        report["duration_s"] = round(
                            time.monotonic() - t0, 3)
                        return report
        finally:
            r.set_deploying(False)
        report["duration_s"] = round(time.monotonic() - t0, 3)
        fflogger.info(
            "deploy: fleet on %s (%d replicas swapped in %.2fs, canary "
            "replica %s held %d SLO window(s))", version, len(swapped),
            report["duration_s"], report["canary"], self.canary_windows)
        return report

    # ---- per-replica machinery ----------------------------------------------

    def _quiesce(self, i: int):
        r = self.router
        deadline = time.monotonic() + self.drain_timeout_s
        while not r.replica_quiesced(i):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replica {i} did not quiesce within "
                    f"{self.drain_timeout_s}s")
            time.sleep(0.003)

    def _swap_one(self, i: int, tree, version: str, warmup_prompts,
                  max_new: int):
        """One replica through the full sequence; raises on a torn swap
        (the caller rolls back). The fleet keeps serving on the other
        replicas the whole time — capacity never drops below N-1. The
        swap's program captures happen here, inside the drained window,
        before reopen()."""
        r = self.router
        eng = r.engines[i]
        r.suspend_replica(i)
        try:
            self._quiesce(i)
            eng.drain()
            t0 = time.monotonic()
            out = eng.swap_weights(tree, version)
            self.swap_log.append({"replica": i, "version": version,
                                  "swap_s": time.monotonic() - t0,
                                  "captures": out["captures"]})
            eng.reopen()
            if warmup_prompts is not None:
                eng.warmup(warmup_prompts, max_new_tokens=max_new)
            else:
                flightrec.slo_monitor().rebaseline()
        finally:
            r.resume_replica(i)

    def _recover_replica(self, i: int):
        """After a failed swap: the engine restored its own prior
        weights; make sure it is admitting again."""
        eng = self.router.engines[i]
        try:
            eng.reopen()
        except Exception:  # noqa: BLE001 — best effort: the fence
            pass           #   machinery owns a truly dead replica

    def _canary_soak(self, i: int) -> Optional[Dict]:
        """Hold the roll while the freshly-swapped canary serves live
        traffic under its own rebaselined SLO windows. Returns the first
        breach attributed to the canary (rollback), or None after
        ``canary_windows`` clean full windows (proceed)."""
        eng = self.router.engines[i]
        label = eng._tm_labels["replica"]
        mon = flightrec.slo_monitor()
        eng.deploy_state = "canary"
        try:
            deadline = (time.monotonic()
                        + self.canary_windows * self._window_s)
            while time.monotonic() < deadline:
                mon.maybe_evaluate()
                hit = [b for b in mon.breaches()
                       if str(b.get("replica")) == label]
                if hit:
                    fflogger.error(
                        "deploy: canary replica %d breached %s "
                        "(%.4g vs bound %.4g) — rolling back", i,
                        hit[0]["slo"], hit[0]["value"], hit[0]["bound"])
                    return dict(hit[0])
                # deliberately under the deploy lock: serializing
                # concurrent deploy() calls across the whole roll —
                # soak included — IS the lock's contract; nothing on
                # the serving hot path ever takes "deploy" (rank 5,
                # outermost)
                time.sleep(min(0.02, self._window_s / 5))  # ffsan: allow(lock-across-blocking)
        finally:
            if eng.deploy_state == "canary":
                eng.deploy_state = "serving"
        return None

    def _rollback(self, swapped: List[int], prior: List[str],
                  report: Dict, cause: str,
                  breach: Optional[Dict] = None):
        """Swap every already-swapped replica back to its prior version
        (None override when the prior is the construction version), dump
        ONE flight-recorder bundle naming the cause (and the offending
        SLO for a canary breach), and stamp the breach->fleet-on-prior
        latency the bench reports."""
        r = self.router
        t0 = time.monotonic()
        for i in swapped:
            prev = prior[i]
            r.suspend_replica(i)
            try:
                self._quiesce(i)
                eng = r.engines[i]
                eng.drain()
                # prior == the construction version -> model.params
                # again (its programs are still held: no capture); a
                # prior REGISTRY version reloads its artifact (a set
                # still live for it is reused)
                if prev == DEFAULT_WEIGHT_VERSION:
                    eng.swap_weights(None, prev)
                else:
                    eng.swap_weights(self.registry.load_params(prev),
                                     prev)
                eng.reopen()
                flightrec.slo_monitor().rebaseline()
            except Exception as e:  # noqa: BLE001
                fflogger.error(
                    "deploy: rollback of replica %d to %s failed (%s) — "
                    "leaving it to the fence machinery", i, prev, e)
            finally:
                r.resume_replica(i)
        r.note_rollback()
        report["rollback_s"] = round(time.monotonic() - t0, 3)
        note = {"from_version": report["version"],
                "rolled_back_replicas": list(swapped),
                "rollback_s": report["rollback_s"]}
        if breach is not None:
            note["slo"] = breach["slo"]
            note["replica"] = breach["replica"]
            note["value"] = breach["value"]
            note["bound"] = breach["bound"]
        try:
            report["bundle"] = flightrec.dump(cause, **note)
        except Exception as e:  # noqa: BLE001 — no configured bundle
            #   dir: the rollback itself must not fail over evidence
            fflogger.warning(
                "deploy: rollback bundle not written (%s)", e)
        fflogger.warning(
            "deploy: ROLLED BACK %s -> prior versions (%s) in %.2fs%s",
            report["version"], cause, report["rollback_s"],
            f" — bundle {report['bundle']}" if report["bundle"] else "")
