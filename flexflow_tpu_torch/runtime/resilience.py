"""Fault-tolerant training (the JAX package's ``runtime/resilience.py``):
the preemption-safe ``TrainSupervisor``, the divergence guard's state,
``retry`` with backoff, and the step ``Watchdog``.

  * ``TrainSupervisor`` wraps the train loop with periodic and SIGTERM-
    triggered atomic checkpoints (runtime/checkpoint.py) and automatic
    resume from the newest intact one: the step counter, the weights, the
    optimizer, BatchNorm and guard state, every drawing op's generator
    and the dataloader cursors come back, in place, so the resumed loss
    trajectory is bitwise an uninterrupted run's. ``FFModel.fit`` drives
    it through ``install`` / ``resume`` / ``after_step`` / ``finalize``
    when ``FFConfig.checkpoint_dir`` is set.
  * The divergence guard (``executor.guarded_train_step``) skips a
    non-finite step on the device; the supervisor counts consecutive bad
    steps on the host and rewinds to the last checkpoint after
    ``nonfinite_rewind_after`` of them.
  * ``retry``: exponential backoff around checkpoint saves and loads.
  * ``Watchdog``: a wall-clock timeout around a blocking host fetch; it
    trips the flight recorder, dumps every thread's stack and aborts the
    main thread (a hang inside a device sync cannot be interrupted from
    Python, hence the hard-exit backstop).

Every path is drilled through ``runtime/faultinject.py``
(``FF_FAULT=nan_loss@step:7,sigterm@step:12,hang@step:3,io_fail@save:1``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import logging
import os
import signal
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Union

import torch

from flexflow_tpu_torch.runtime import faultinject, flightrec, locks, \
    telemetry

log = logging.getLogger("flexflow_tpu_torch")

# process-wide resilience counters (skipped steps / restarts / retries …)
COUNTERS: collections.Counter = collections.Counter()


def counters() -> Dict[str, int]:
    return dict(COUNTERS)


def reset_counters():
    COUNTERS.clear()


def init_guard_state(loss_scale: float = 1.0,
                     device: Union[str, torch.device] = "cpu"
                     ) -> Dict[str, torch.Tensor]:
    """Device-resident carry of the guarded train step
    (``GraphExecutor.guarded_train_step``): the consecutive bad- and
    good-step streaks, the loss scale and the cumulative skip count. It
    lives on the device and is updated in place, so the guard makes no
    host round trip."""
    i32 = dict(dtype=torch.int32, device=device)
    return {"bad_streak": torch.zeros((), **i32),
            "good_streak": torch.zeros((), **i32),
            "loss_scale": torch.full((), loss_scale, dtype=torch.float32,
                                     device=device),
            "skipped": torch.zeros((), **i32)}


def install_sigterm(handler):
    """Install ``handler`` as the SIGTERM disposition — the one
    preemption-notice entry point (``TrainSupervisor`` and
    ``ServingRouter.install_preempt_handler``). Returns ``(installed,
    previous_disposition)`` — ``(False, None)`` off the main thread, where
    the owner must call its ``request_preempt()`` instead."""
    try:
        return True, signal.signal(signal.SIGTERM, handler)
    except ValueError:
        return False, None


# --------------------------------------------------------------- retry


def retry(attempts: int = 3, base_delay: float = 0.1, max_delay: float = 5.0,
          retryable=(OSError,), name: Optional[str] = None,
          sleep: Callable[[float], None] = time.sleep):
    """Exponential-backoff retry decorator for flaky IO boundaries.
    ``retryable`` is an exception class / tuple of classes, or a predicate
    ``exc -> bool``. Non-retryable and final-attempt failures re-raise
    unchanged; each retry counts in COUNTERS["retries"] and logs."""
    if attempts < 1:
        raise ValueError(f"retry: attempts must be >= 1, got {attempts}")
    if isinstance(retryable, (type, tuple)):
        classes = retryable

        def pred(e):
            return isinstance(e, classes)
    else:
        pred = retryable

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            delay = base_delay
            for i in range(attempts):
                try:
                    return fn(*args, **kwargs)
                except Exception as e:
                    if i == attempts - 1 or not pred(e):
                        raise
                    COUNTERS["retries"] += 1
                    log.warning(
                        "retry %s: attempt %d/%d failed (%s: %s); "
                        "retrying in %.2fs",
                        name or getattr(fn, "__name__", "?"), i + 1,
                        attempts, type(e).__name__, e, delay)
                    sleep(min(delay, max_delay))
                    delay *= 2
        return wrapper
    return deco


# ------------------------------------------------------------- watchdog


class Watchdog:
    """Wall-clock timeout around a blocking section (the host fetch that
    waits on a step's device work). On expiry it counts the fire, trips
    the flight recorder (``watchdog_fire``, flushed synchronously: the
    abort may end the process), dumps every thread's stack, and calls
    ``on_timeout(label)`` — by default a KeyboardInterrupt in the main
    thread, with a hard-exit backstop should the interrupt never be
    serviced. ``timeout_s <= 0`` disarms."""

    def __init__(self, timeout_s: float, on_timeout: Optional[Callable] = None,
                 dump_path: Optional[str] = None):
        self.timeout_s = float(timeout_s)
        self.on_timeout = on_timeout
        self.dump_path = dump_path
        self.fired = False
        self.telemetry_on = True

    def _dump(self, label: str, timeout_s: float):
        import faulthandler

        msg = (f"\n[resilience] watchdog: {label!r} exceeded "
               f"{timeout_s:.1f}s wall clock; thread stacks follow\n")
        if self.dump_path:
            with open(self.dump_path, "a") as f:
                f.write(msg)
                faulthandler.dump_traceback(file=f)
        else:
            sys.stderr.write(msg)
            faulthandler.dump_traceback(file=sys.stderr)

    def _memory_snapshot(self):
        """The card's allocator summary beside the stacks (which buffers
        were live when the step wedged); after the abort is signalled."""
        if not self.dump_path or not torch.cuda.is_available():
            return
        try:
            with open(self.dump_path + ".memprof", "w") as f:
                f.write(torch.cuda.memory_summary())
        except Exception:
            pass

    @contextlib.contextmanager
    def arm(self, label: str = "step", scale: float = 1.0):
        """``scale`` stretches the timeout for syncs that wait on more
        than one step's work."""
        if self.timeout_s <= 0:
            yield
            return
        timeout_s = self.timeout_s * max(scale, 1.0)
        grace: List[threading.Timer] = []
        lock = locks.make_lock("watchdog")
        state = {"active": True}

        def hard_exit():
            with lock:
                if not state["active"]:
                    return  # the interrupt was serviced
            os._exit(70)

        def fire():
            with lock:
                if not state["active"]:
                    return  # completed before we fired
                self.fired = True
                COUNTERS["watchdog_fires"] += 1
                if self.telemetry_on:
                    telemetry.tracer().instant(
                        "watchdog_fire", track="train", label=label,
                        timeout_s=timeout_s)
                    flightrec.trip("watchdog_fire", label=label,
                                   timeout_s=timeout_s)
                self._dump(label, timeout_s)
                if self.telemetry_on:
                    # terminal trigger: write the bundle now
                    flightrec.recorder().flush(timeout=15.0)
                if self.on_timeout is not None:
                    self.on_timeout(label)
                else:
                    import _thread

                    g = threading.Timer(max(timeout_s, 10.0), hard_exit)
                    g.daemon = True
                    grace.append(g)
                    g.start()
                    _thread.interrupt_main()
            self._memory_snapshot()

        t = threading.Timer(timeout_s, fire)
        t.daemon = True
        t.start()
        t_arm = time.perf_counter()
        try:
            yield
        finally:
            if self.telemetry_on:
                telemetry.tracer().complete(
                    "watchdog_armed", t_arm, time.perf_counter() - t_arm,
                    track="train", label=label, fired=self.fired)
            t.cancel()
            with lock:
                state["active"] = False
            for g in grace:
                g.cancel()


# ------------------------------------------------------------ supervisor


class TrainSupervisor:
    """Drives a training loop with checkpoint/resume, preemption handling,
    divergence rewind and hang detection (the JAX ``TrainSupervisor``)::

        cfg = FFConfig(checkpoint_dir="ckpt", checkpoint_every=50,
                       on_nonfinite="skip", nonfinite_rewind_after=3)
        model.compile(opt, ...)
        status = TrainSupervisor(model).run(num_steps=1000)

    ``run`` resumes from the newest intact checkpoint (fresh start when
    none), installs a SIGTERM handler (preemption notice -> checkpoint at
    the next step boundary, then stop), checkpoints every
    ``checkpoint_every`` steps and rewinds to the last checkpoint after
    ``rewind_after`` consecutive non-finite steps. ``model.fit`` drives the
    same machinery when FFConfig.checkpoint_dir is set."""

    def __init__(self, model, directory: Optional[str] = None, *,
                 checkpoint_every: Optional[int] = None,
                 keep: Optional[int] = None,
                 rewind_after: Optional[int] = None,
                 step_timeout_s: Optional[float] = None,
                 max_rewinds: int = 3,
                 faults: Optional[faultinject.FaultPlan] = None,
                 verbose: bool = False):
        cfg = model.config
        self.model = model
        self.directory = directory or cfg.checkpoint_dir
        if not self.directory:
            raise ValueError(
                "TrainSupervisor needs a checkpoint directory: pass one or "
                "set FFConfig.checkpoint_dir")
        self.checkpoint_every = (checkpoint_every
                                 if checkpoint_every is not None
                                 else cfg.checkpoint_every)
        self.keep = keep if keep is not None else cfg.keep_checkpoints
        self.rewind_after = (rewind_after if rewind_after is not None
                             else cfg.nonfinite_rewind_after)
        # periodic saves publish on the background thread; preempt /
        # final / initial saves stay synchronous
        self.async_saves = bool(cfg.async_checkpointing)
        self._tm_on = cfg.telemetry != "off"
        flightrec.configure(cfg)
        self.watchdog = Watchdog(step_timeout_s if step_timeout_s is not None
                                 else cfg.step_timeout_s)
        self.watchdog.telemetry_on = self._tm_on
        self.faults = faults
        self.verbose = verbose
        # poll the guard's per-step flag on the host (run(): it syncs the
        # loss anyway); fit turns it off unless rewind needs it
        self.poll_nonfinite = True
        self.losses: List[float] = []
        self._loss_base = model._step_count
        self._bad_streak = 0
        self._skips_counted = 0
        self._fault_mark = model._step_count
        # rewinding to the same checkpoint replays the same params,
        # generators and cursors: cap repeats (a deterministic NaN)
        self.max_rewinds = max_rewinds
        self._last_rewind_step: Optional[int] = None
        self._same_rewinds = 0
        self._last_saved_step: Optional[int] = None
        self._resumed: Optional[int] = None
        self._preempted = threading.Event()
        self._prev_sigterm = None
        self._installed = False

    # ---- signal handling -------------------------------------------------

    def install(self):
        """Install the SIGTERM handler (main thread only; idempotent). The
        handler sets a flag — the checkpoint happens at the next step
        boundary, where the state is consistent."""
        if self._installed:
            return
        ok, prev = install_sigterm(self._on_sigterm)
        if ok:
            self._prev_sigterm = prev
            self._installed = True
        else:
            log.warning("TrainSupervisor: cannot install SIGTERM handler "
                        "outside the main thread; call request_preempt() "
                        "instead")

    def close(self):
        """Restore the previous SIGTERM disposition."""
        if self._installed:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._installed = False

    def _on_sigterm(self, signum, frame):
        self._preempted.set()

    def request_preempt(self):
        """Programmatic preemption notice (same effect as SIGTERM)."""
        self._preempted.set()

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()

    # ---- checkpoint / resume ---------------------------------------------

    def _fault_plan(self) -> faultinject.FaultPlan:
        return self.faults if self.faults is not None \
            else faultinject.active_plan()

    def _extra_meta(self) -> dict:
        # while fit's input pipeline runs, its worker has moved
        # dl.next_index past the last trained batch: record the CONSUMED
        # cursors (the synchronous loop's position), which the pipeline
        # tracks a batch handed out (runtime/pipeline_loader.py)
        pipe = getattr(self.model, "_pipeline", None)
        cursors = pipe.consumed_cursors() if pipe is not None else None
        if cursors is None:
            cursors = {dl.name: int(dl.next_index)
                       for dl in self.model._dataloaders}
        meta = {"dataloaders": cursors}
        gs = self.model._guard_state
        if gs is not None:
            meta["loss_scale"] = float(gs["loss_scale"])
        return meta

    def save(self, reason: str = "periodic") -> Optional[str]:
        """Atomic checkpoint of the model's state, step and cursors. Skips
        a step already saved. With async_checkpointing only periodic saves
        publish asynchronously: a preempt / final / initial save is
        durable when this returns."""
        from flexflow_tpu_torch.runtime.checkpoint import (save_checkpoint,
                                                           wait_pending_saves)

        async_ok = self.async_saves and reason == "periodic"
        if self.async_saves and not async_ok:
            wait_pending_saves(self.directory)
        step = self.model._step_count
        if self._last_saved_step == step:
            return None
        extra = self._extra_meta()
        extra["reason"] = reason
        t0 = time.perf_counter()
        path = save_checkpoint(self.model, self.directory, step=step,
                               extra_meta=extra, keep=self.keep,
                               async_save=async_ok)
        stall = time.perf_counter() - t0
        # the stall this save cost the loop (an async save: the snapshot)
        if self._tm_on:
            telemetry.tracer().complete(
                "checkpoint_save", t0, stall, track="train", step=step,
                reason=reason, published_async=async_ok)
            telemetry.registry().histogram(
                "ff_checkpoint_stall_seconds",
                "training-loop stall per checkpoint save (async "
                "publishes cost only the in-step snapshot)").observe(stall)
        self._last_saved_step = step
        COUNTERS["checkpoints_saved"] += 1
        if self.verbose:
            log.info("supervisor: checkpoint step %d (%s) -> %s", step,
                     reason, path)
        return path

    def _restore(self, step: int):
        from flexflow_tpu_torch.runtime.checkpoint import (load_meta,
                                                           restore_checkpoint)

        # the caller verified this step's manifest moments ago
        restore_checkpoint(self.model, self.directory, step=step,
                           verify=False)
        meta = load_meta(self.directory, step)
        cursors = meta.get("dataloaders") or {}
        for dl in self.model._dataloaders:
            if dl.name in cursors:
                dl.next_index = int(cursors[dl.name])
        gs = self.model._guard_state
        if gs is not None:
            # fresh streaks, in place; keep the backed-off loss scale (or
            # the configured one when the save recorded none)
            scale = meta.get("loss_scale", self.model.config.loss_scale)
            with torch.no_grad():
                for k in ("bad_streak", "good_streak", "skipped"):
                    gs[k].zero_()
                gs["loss_scale"].fill_(float(scale))
        self._bad_streak = 0
        self._skips_counted = 0
        self._last_saved_step = step

    def _check_topology(self, step: int):
        """The elastic policy at resume time (the JAX ``_check_topology``):
        the compile-time hook (runtime/elastic.py) normally applied it
        already, but a supervisor pointed at a directory the config did
        not name skips that path — so its refusals hold here too, and a
        resume across a topology change (the restore copies each rank's
        slice of the saved tensors) counts in ``elastic_resumes``."""
        from flexflow_tpu_torch.runtime.checkpoint import load_meta
        from flexflow_tpu_torch.runtime.elastic import check_saved_topology

        m = self.model
        if check_saved_topology(m.config, load_meta(self.directory, step),
                                step, self.directory,
                                m.mesh_shape if m.mesh is not None
                                else None):
            COUNTERS["elastic_resumes"] += 1
            log.warning("supervisor: resuming step %d across a topology "
                        "change onto mesh %s (policy %s)", step,
                        m.mesh_shape, m.config.on_topology_change)

    def resume(self) -> int:
        """Restore the newest INTACT checkpoint (0 = fresh start); a
        damaged newer step is skipped with a warning, and when every step
        fails the corruption error propagates. A fresh start with rewind
        enabled takes an initial step-0 checkpoint."""
        from flexflow_tpu_torch.runtime.checkpoint import scan_and_restore

        def _count_skip(_s):
            COUNTERS["corrupt_checkpoints_skipped"] += 1

        def _restore_cand(cand):
            self._check_topology(cand)
            self._restore(cand)

        step = scan_and_restore(self.model, self.directory,
                                restore=_restore_cand, on_skip=_count_skip,
                                who="supervisor")
        if step is None:
            self._resumed = 0
            if self.rewind_after:
                self.save(reason="initial")
            return 0
        self.losses.clear()
        self._loss_base = step
        self._fault_mark = step
        self._resumed = step
        COUNTERS["resumes"] += 1
        log.info("supervisor: resumed from step %d in %s", step,
                 self.directory)
        return step

    def rewind(self):
        """Divergence recovery: back to the last intact checkpoint."""
        from flexflow_tpu_torch.runtime.checkpoint import (latest_intact_step,
                                                           wait_pending_saves)

        if self.async_saves:
            try:
                wait_pending_saves(self.directory)
            except RuntimeError as e:
                log.warning("rewind: a pending async checkpoint save had "
                            "failed (%s) — rewinding to the newest intact "
                            "step instead", e)
        step = latest_intact_step(
            self.directory, verify=self.model.config.verify_checkpoints)
        if step is None:
            raise RuntimeError(
                f"rewind requested but no checkpoint (passing integrity "
                f"verification) exists in {self.directory}")
        if step == self._last_rewind_step:
            self._same_rewinds += 1
        else:
            self._last_rewind_step = step
            self._same_rewinds = 1
        if self._same_rewinds > self.max_rewinds:
            raise RuntimeError(
                f"supervisor: rewound to checkpoint step {step} "
                f"{self._same_rewinds} times with no progress — a rewind "
                f"replays identical weights, generators and batches, so "
                f"this non-finite condition is deterministic (bad data or "
                f"a diverged config), not transient; aborting instead of "
                f"livelocking")
        log.warning("supervisor: %d consecutive non-finite steps at step "
                    "%d — rewinding to checkpoint step %d", self._bad_streak,
                    self.model._step_count, step)
        if self._tm_on:
            telemetry.tracer().instant(
                "rewind", track="train", from_step=self.model._step_count,
                to_step=step, bad_streak=self._bad_streak)
            flightrec.trip("nonfinite_rewind",
                           from_step=self.model._step_count, to_step=step,
                           bad_streak=self._bad_streak)
        # losses[i] is the loss of step _loss_base + i + 1
        del self.losses[max(step - self._loss_base, 0):]
        self._restore(step)
        COUNTERS["rewinds"] += 1

    # ---- stepping ---------------------------------------------------------

    def _deliver_step_faults(self, step_no: int):
        # a range: fit's scanned chunks advance the counter several steps
        plan = self._fault_plan()
        lo = min(self._fault_mark, step_no)
        self._fault_mark = step_no
        if plan.in_step_range("sigterm", lo, step_no):
            os.kill(os.getpid(), signal.SIGTERM)
            # signal delivery is asynchronous
            self._preempted.wait(timeout=1.0)

    def after_step(self, nonfinite: Optional[bool] = None) -> bool:
        """Step-boundary bookkeeping shared by run() and fit(): divergence
        streak / rewind, injected and real preemption, periodic saves.
        True when the caller must stop (a preemption checkpoint was
        written)."""
        step_no = self.model._step_count
        if nonfinite is None and self.poll_nonfinite \
                and self.model._guard_state is not None:
            lm = self.model._last_metrics or {}
            if "nonfinite" in lm:
                # blocks on the step's device work
                with self.watchdog.arm(f"step {step_no} guard poll"):
                    nonfinite = bool(int(lm["nonfinite"]))
        if nonfinite:
            self._bad_streak += 1
            self._skips_counted += 1
            COUNTERS["steps_skipped"] += 1
            if self.rewind_after and self._bad_streak >= self.rewind_after:
                self.rewind()
                return False
        elif nonfinite is not None:
            self._bad_streak = 0
        self._deliver_step_faults(step_no)
        if self._preempted.is_set():
            self.save(reason="preempt")
            COUNTERS["preempt_stops"] += 1
            if self._tm_on:
                flightrec.trip("sigterm_preempt",
                               step=self.model._step_count)
                flightrec.recorder().flush(timeout=15.0)
            log.warning("supervisor: preemption notice — checkpointed step "
                        "%d, stopping", self.model._step_count)
            return True
        if (self.checkpoint_every
                and (self._last_saved_step is None
                     or step_no - self._last_saved_step
                     >= self.checkpoint_every)):
            self.save(reason="periodic")
        if self._tm_on:
            flightrec.slo_monitor().maybe_evaluate()
        return False

    def nan_due(self) -> bool:
        """Is a nan_loss fault scheduled for the step about to run?"""
        due = self._fault_plan().at_step("nan_loss",
                                         self.model._step_count + 1)
        if due and self.model._guard_state is None:
            raise RuntimeError(
                "FF_FAULT nan_loss injection requires the divergence guard "
                "(set FFConfig.on_nonfinite='skip' or 'backoff' before "
                "compile())")
        return due

    def step(self) -> float:
        """One supervised step on the next staged batch: scheduled NaNs
        injected in the step, the watchdog armed around the blocking loss
        fetch, the loss recorded."""
        model = self.model
        step_no = model._step_count + 1
        inject = self.nan_due()
        hang = self._fault_plan().at_step("hang", step_no)
        # the loaders stage this rank's rows (under a mesh), as in fit
        prior, model._loader_rows = model._loader_rows, True
        try:
            loss, _ = model._run_train_step(model._stage_batch(),
                                            inject_nan=inject)
        finally:
            model._loader_rows = prior
        with self.watchdog.arm(f"train step {step_no}"):
            if hang and self.watchdog.timeout_s > 0:
                # the host-side hang drill: block past the watchdog so its
                # dump and abort run (a stuck collective or device sync)
                time.sleep(self.watchdog.timeout_s * 3)
            loss_f = float(loss)
        self.losses.append(loss_f)
        return loss_f

    def run(self, num_steps: int) -> str:
        """Supervised loop until ``model._step_count == num_steps``;
        resumes first. Returns "completed" or "preempted" (after the
        preemption checkpoint)."""
        assert self.model.optimizer is not None, \
            "compile() with an optimizer first"
        assert self.model._dataloaders, "attach SingleDataLoader(s) first"
        self.install()
        try:
            if self._resumed is None:
                self.resume()
            while self.model._step_count < num_steps:
                self.step()
                if self.after_step():
                    return "preempted"
            self.save(reason="final")
            return "completed"
        finally:
            self.close()

    def finalize(self):
        """End-of-fit hook: the final checkpoint (skipped after a watchdog
        abort: the device work it would wait on is wedged), the async
        publisher drained, skip counts reconciled, the handler restored."""
        try:
            if not self.watchdog.fired:
                self.save(reason="final")
            if self.async_saves:
                from flexflow_tpu_torch.runtime.checkpoint import \
                    wait_pending_saves

                wait_pending_saves(self.directory)
        finally:
            self.close()
        gs = self.model._guard_state
        if gs is not None:
            skipped = int(gs["skipped"])
            if skipped > self._skips_counted:
                COUNTERS["steps_skipped"] += skipped - self._skips_counted
                self._skips_counted = skipped
        snap = {k: v for k, v in COUNTERS.items() if v}
        if snap:
            log.info("resilience counters: %s", snap)
