"""Checkpoint / resume (the JAX package's ``runtime/checkpoint.py``).

The directory protocol is the JAX package's: each save lands in
``<dir>/.tmp-step_N`` and becomes ``<dir>/step_N`` via one ``os.replace``
— a kill mid-save leaves only an ignored tmp dir, never a half-written
checkpoint. ``ff_meta.json`` (step, layout guards, supervisor extras:
dataloader cursors, loss scale) and ``ff_manifest.json`` (the content-hash
manifest of ``runtime/manifest.py`` over every other file) are written
INSIDE the step dir before the rename, so a published checkpoint is
self-contained and carries its own proof; the top-level ``meta.json`` /
``strategy.txt`` mirror the newest step. Retention keeps the newest K
steps and never deletes the last intact one; resume paths fall back past
a step whose manifest no longer verifies. Save and load run under
``resilience.retry`` with the ``io_fail@save`` / ``io_fail@load`` drills.

The payload is one ``state.pt`` written by ``torch.save``: a flat dict of
CPU tensors named ``params/<op>/<weight>``, ``opt_state/<moment>/...``
(the per-leaf, the fused flat-bucket or the sharded-fused layout — the
ranks' local buckets in mesh order —, named by ``opt_layout`` in the meta,
which for the last also records the weights' specs), ``bn_state/<op>/<stat>``, ``guard/<field>`` and
``generators/<op>`` (each drawing op's ``torch.Generator`` state as a
ByteTensor), read back with ``torch.load(weights_only=True)``. bf16 has
no numpy dtype, so the payload is not numpy, and there is no orbax: the
port cannot read the JAX package's orbax directories and the JAX package
cannot read ``state.pt`` — checkpoints do not cross packages. JAX records
its PRNG key (``rng_key``) in the meta; the port has no key, so the meta
lists instead the generators the payload holds (``generators``).

A restore writes into the model's existing tensors (``copy_``), never
rebinds them: a captured training step (``executor.StepReplay``) and the
serving and generation programs hold their addresses.

``async_save``: the host snapshot is taken before ``save_checkpoint``
returns — on the card ``copy_(non_blocking=True)`` into pinned host
buffers on the current stream, so the next step's in-place update queues
behind the copy, and an event the publisher thread alone waits on — and
everything after it (``torch.save``, the manifest, the rename,
retention) runs on ONE background publisher thread, in submission order,
with at most one snapshot in flight (backpressure, which also caps the
pinned memory); ``wait_pending_saves`` quiesces it and re-raises the
first failure. A synchronous save copies to pageable host memory.

Under a mesh (``FFModel.mesh``, one rank a device; the JAX
``_save_multihost``) every rank calls ``save_checkpoint``: each DTensor —
weights, and optimizer state sharded by FSDP — is made whole
(``full_tensor``, a collective) on the calling thread, and rank 0 alone
writes the one ``state.pt``, between two barriers (JAX's ``ff_ckpt_clean``
/ ``ff_ckpt_done``). An async save gathers on the training thread into
rank 0's pinned snapshot and publishes on rank 0's publisher thread; no
collective ever runs there (the ranks' collective order would part), so
the second barrier waits in ``wait_pending_saves``, which every rank
calls. The meta records ``mesh_shape``, ``num_devices``,
``process_count`` and ``multihost`` under JAX's keys, and ``strategy.txt``
the model's strategy table. A restore reads ``state.pt`` memory-mapped on
every rank and copies each rank's slice into its live shards
(``parallel.copy_full_into``): a checkpoint restores onto any mesh, or
none. The sharded-fused optimizer layout is ROADMAP item 9 part 2's.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import re
import shutil
import threading
from typing import Dict, List, Optional

import torch

from flexflow_tpu_torch import parallel
from flexflow_tpu_torch.runtime import faultinject, locks
from flexflow_tpu_torch.runtime.manifest import (MANIFEST_NAME,
                                                 CheckpointCorruptError,
                                                 HashingWriter,
                                                 _manifest_files,
                                                 verify_dir_manifest,
                                                 write_manifest)
from flexflow_tpu_torch.runtime.resilience import retry

__all__ = ["CheckpointCorruptError", "save_checkpoint", "restore_checkpoint",
           "verify_checkpoint", "verify_step", "iter_intact_steps",
           "latest_intact_step", "intact_steps", "latest_step", "load_meta",
           "has_checkpoints", "trusted_step_for", "wait_pending_saves",
           "pending_saves", "scan_and_restore", "auto_resume",
           "load_payload", "PAYLOAD_NAME"]

log = logging.getLogger("flexflow_tpu_torch")

PAYLOAD_NAME = "state.pt"

# ------------------------------------------------------ integrity


def verify_checkpoint(directory: str, step: int):
    """Recompute the manifest hashes of ``step_<step>`` and raise
    ``CheckpointCorruptError`` naming the first mismatching file. A step
    without a manifest passes (nothing to verify it against)."""
    step_dir = os.path.join(os.path.abspath(directory), f"step_{step}")
    verify_dir_manifest(step_dir, label=f"checkpoint step {step}")


def verify_step(directory: str, step: int) -> bool:
    """Boolean flavor of verify_checkpoint (plus meta readability)."""
    if not _meta_readable(directory, step):
        return False
    try:
        verify_checkpoint(directory, step)
        return True
    except CheckpointCorruptError:
        return False


def _meta_readable(directory: str, step: int) -> bool:
    """Is the step's metadata usable? A per-step ff_meta.json that fails
    to parse marks a damaged dir; a dir with none is usable only through
    a readable top-level meta.json."""
    per_step = os.path.join(directory, f"step_{step}", "ff_meta.json")
    target = per_step if os.path.exists(per_step) \
        else os.path.join(directory, "meta.json")
    try:
        with open(target) as f:
            json.load(f)
        return True
    except (OSError, ValueError):
        return False


def _intact_with_warning(directory: str, step: int, verify: bool) -> bool:
    if not _meta_readable(directory, step):
        log.warning("checkpoint step %d in %s: unreadable metadata — "
                    "skipping (torn write or damaged dir)", step, directory)
        return False
    if verify:
        try:
            verify_checkpoint(directory, step)
        except CheckpointCorruptError as e:
            log.warning("checkpoint step %d in %s failed integrity "
                        "verification — skipping: %s", step, directory, e)
            return False
    return True


def iter_intact_steps(directory: str, verify: bool = True, on_skip=None,
                      trusted_step: Optional[int] = None):
    """Lazily yield published steps newest-first, skipping (with a
    warning and ``on_skip(step)``) any whose metadata is unreadable or —
    when ``verify`` — whose manifest fails. Lazy: the resume paths pay
    one hash pass over the step they restore. ``trusted_step`` was
    verified by the caller already (the compile-time elastic hook)."""
    directory = os.path.abspath(directory)
    for step in sorted(_step_dirs(directory), reverse=True):
        if _intact_with_warning(directory, step,
                                verify and step != trusted_step):
            yield step
        elif on_skip is not None:
            on_skip(step)


def trusted_step_for(model, directory: str) -> Optional[int]:
    """The step the compile-time elastic hook verified, honored only for
    the directory it hashed."""
    step = getattr(model, "_elastic_verified_step", None)
    if step is None:
        return None
    recorded = getattr(model, "_elastic_verified_dir", None)
    if recorded is not None and \
            os.path.abspath(recorded) != os.path.abspath(directory):
        return None
    return step


def has_checkpoints(directory: str) -> bool:
    """Any published step dir at all, intact or not."""
    return bool(_step_dirs(os.path.abspath(directory)))


def intact_steps(directory: str, verify: bool = True) -> List[int]:
    return list(iter_intact_steps(directory, verify=verify))


def latest_intact_step(directory: str, verify: bool = True) -> Optional[int]:
    return next(iter_intact_steps(directory, verify=verify), None)


def _inject_corruption(step_dir: str):
    """FF_FAULT ``corrupt_ckpt@save`` / ``@publish``: flip bytes in the
    middle of the step's largest payload file AFTER the publish rename;
    the manifest stays, so verification catches the damage."""
    skip = {MANIFEST_NAME, "ff_meta.json", "strategy.txt"}
    candidates = [(os.path.getsize(full), rel, full)
                  for rel, full in _manifest_files(step_dir)
                  if rel.split("/")[-1] not in skip
                  and os.path.getsize(full) > 0]
    if not candidates:
        candidates = [(os.path.getsize(full), rel, full)
                      for rel, full in _manifest_files(step_dir)
                      if os.path.getsize(full) > 0]
    if not candidates:
        return
    size, rel, full = max(candidates)
    with open(full, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(8) or b"\x00"
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))
    log.warning("faultinject: corrupted checkpoint payload %s in %s "
                "(FF_FAULT corrupt_ckpt)", rel, step_dir)


# ------------------------------------------------------ the payload


def _opt_layout(model) -> str:
    """The optimizer state's layout: flat per-dtype buckets under the
    fused update ("fused"), the ranks' local buckets flat across the mesh
    under ``ShardedFusedUpdate`` ("sharded_fused"), per leaf otherwise
    (ZeRO-1's state too). A checkpoint of one layout cannot restore into
    another."""
    from flexflow_tpu_torch.runtime.optimizer import (FusedUpdate,
                                                      ShardedFusedUpdate)

    opt = model.optimizer
    if isinstance(opt, ShardedFusedUpdate):
        return "sharded_fused"
    return "fused" if isinstance(opt, FusedUpdate) else "per_leaf"


def _sharded_fused_shardings(model) -> Dict[str, Dict[str, str]]:
    """The weights' specs a sharded-fused flat vector's element order
    follows (with the mesh): recorded so that a restore onto other specs
    is refused instead of scrambling the moments (the JAX
    ``_sharded_fused_shardings``)."""
    return {op: {w: str(tuple(spec)) for w, spec in ws.items()}
            for op, ws in model.optimizer.specs.items()}


def _flatten(prefix: str, tree, out: Dict[str, torch.Tensor]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}/{k}", v, out)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree


def state_tensors(model) -> Dict[str, torch.Tensor]:
    """The model's live state by payload name: weights, optimizer state,
    BatchNorm state and the divergence guard's state (the tensors a
    restore writes into)."""
    out: Dict[str, torch.Tensor] = {}
    _flatten("params", model.params or {}, out)
    if model.opt_state is not None:
        _flatten("opt_state", model.opt_state, out)
    if model.bn_state:
        _flatten("bn_state", model.bn_state, out)
    gs = getattr(model, "_guard_state", None)
    if gs is not None:
        _flatten("guard", gs, out)
    return out


def _host_snapshot(model, pinned: bool, writer: bool = True):
    """(payload, event): every state tensor copied to host memory and the
    generators' states. ``pinned`` (an async save on the card): non-
    blocking copies into pinned buffers on the current stream — the
    next step's in-place update queues behind them — and the event the
    publisher waits on before serializing. Otherwise blocking copies into
    pageable memory (the CPU's copies are clones: the model updates its
    tensors in place). A DTensor is made whole first, on every rank (a
    collective); only the ``writer`` keeps the copies (the others return
    an empty payload)."""
    live = state_tensors(model)
    out: Dict[str, torch.Tensor] = {}
    event = None
    cuda = False
    with torch.no_grad():
        for name, t in live.items():
            t = parallel.full_tensor(t)
            if not writer:
                continue
            cuda = cuda or t.is_cuda
            if t.is_cuda and pinned:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                out[name] = buf
            else:
                out[name] = t.detach().to("cpu", copy=True)
    if not writer:
        return out, None
    if cuda and pinned:
        event = torch.cuda.Event()
        event.record()
    for name, g in getattr(model, "_generators", {}).items():
        out[f"generators/{name}"] = g.get_state()
    return out, event


def _world() -> int:
    from flexflow_tpu_torch.parallel.mesh import world_size

    return world_size()


def _barrier() -> None:
    """All ranks meet (a no-op in a world of one)."""
    if _world() > 1:
        torch.distributed.barrier()


def _build_meta(model, step: int, *, with_opt: bool) -> dict:
    """Per-step ff_meta.json: the JAX package's keys — the mesh (None
    without one), its devices, the processes — and the generators the
    payload holds in place of JAX's ``rng_key``."""
    mesh = getattr(model, "mesh", None)
    world = _world()
    meta = {"step": int(step),
            "mesh_shape": (parallel.mesh_shape_dict(mesh)
                           if mesh is not None else None),
            "num_devices": int(mesh.size()) if mesh is not None else 1,
            "process_count": world,
            "batch_size": int(model.config.batch_size),
            "grad_accum_steps": int(model.config.grad_accum_steps),
            "multihost": world > 1,
            "loss_type": model.loss_type.name if model.loss_type else None,
            "generators": sorted(getattr(model, "_generators", {}))}
    if with_opt:
        meta["opt_layout"] = _opt_layout(model)
        if meta["opt_layout"] == "sharded_fused":
            meta["opt_state_shardings"] = _sharded_fused_shardings(model)
    return meta


#: directories an async save across ranks was submitted to: its second
#: barrier waits in ``wait_pending_saves``
_RANKED_PENDING: set = set()
#: the meta entry carrying the model's strategy table to the publisher
_STRATEGIES = "_strategies"


def save_checkpoint(model, directory: str, step: Optional[int] = None,
                    extra_meta: Optional[dict] = None,
                    keep: Optional[int] = None,
                    async_save: bool = False) -> str:
    """Save model state; returns the step dir's path. Atomic (tmp dir +
    one rename); ``extra_meta`` merges into the per-step ff_meta.json;
    ``keep`` prunes all but the newest ``keep`` steps after a successful
    publish (never the last intact one). ``async_save``: snapshot now,
    publish on the background thread (module docstring). Saving a step
    twice overwrites it. Across ranks every rank calls it (module
    docstring); rank 0 writes."""
    directory = os.path.abspath(directory)
    step = int(step if step is not None else model._step_count)
    meta = _build_meta(model, step, with_opt=model.opt_state is not None)
    if extra_meta:
        meta.update(extra_meta)
    # the strategy table rides to the publisher beside the meta; the
    # finalize writes it to strategy.txt and keeps it out of the JSON
    meta[_STRATEGIES] = dict(model.config.strategies)
    path = os.path.join(directory, f"step_{step}")
    ranked = _world() > 1
    writer = not ranked or torch.distributed.get_rank() == 0
    if async_save:
        # backpressure: each queued save holds a full host snapshot, so a
        # publisher slower than the save cadence slows the caller down —
        # at most one snapshot in flight plus the one being submitted
        if writer:
            _SAVER.wait_below(directory, 1)
        _barrier()                              # ff_ckpt_clean
        state, event = _host_snapshot(model, pinned=True, writer=writer)
        if ranked:
            _RANKED_PENDING.add(directory)
        if writer:
            def publish():
                if event is not None:
                    event.synchronize()
                _publish_step(directory, step, state, meta, keep)

            _SAVER.submit(directory, step, publish)
        return path
    _barrier()                                  # ff_ckpt_clean
    state, _ = _host_snapshot(model, pinned=False, writer=writer)
    try:
        if writer:
            _publish_step(directory, step, state, meta, keep)
    finally:
        _barrier()                              # ff_ckpt_done
    return path


def _publish_step(directory: str, step: int, state: dict, meta: dict,
                  keep: Optional[int]):
    """The write-and-publish half of a save: the payload into the tmp dir
    (retried), then finalize. Never touches the model or the device."""
    tmp = os.path.join(directory, f".tmp-step_{step}")
    os.makedirs(directory, exist_ok=True)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)

    def _save():
        faultinject.maybe_fail("io_fail", "save")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)  # half-written tmp from a failed attempt
        os.makedirs(tmp)
        # hashed as written: the manifest needs no second read of it
        with open(os.path.join(tmp, PAYLOAD_NAME), "wb") as f, \
                _no_zip_crc():
            w = HashingWriter(f)
            torch.save(state, w)
        return {PAYLOAD_NAME: w.digest()}

    known = retry(attempts=3, base_delay=0.05, retryable=(OSError,),
                  name="checkpoint save")(_save)()
    _finalize_step_dir(directory, step, meta, keep, known)


def _no_zip_crc():
    """``torch.save`` without the zip records' CRC32: the sha256 manifest
    already proves the payload, and the CRC pass is a third of the write
    (where this torch's serialization config has the switch)."""
    import contextlib

    try:
        from torch.utils.serialization import config
    except ImportError:
        return contextlib.nullcontext()
    if not hasattr(config.save, "compute_crc32"):
        return contextlib.nullcontext()
    return config.patch({"save.compute_crc32": False})


def _write_strategy(path: str, strategies: Optional[dict]):
    """The model's strategy table in the reference text schema (empty:
    every op runs whole or data-parallel), which an elastic resume
    re-derives on its mesh."""
    from flexflow_tpu_torch.parallel.strategy import save_strategies_to_file

    save_strategies_to_file(path, strategies or {})


def _finalize_step_dir(directory: str, step: int, meta: dict,
                       keep: Optional[int], known: Optional[dict] = None):
    """Meta + strategy + manifest into the tmp dir, the publish rename, the
    top-level mirrors, the corruption drill, and retention."""
    meta = dict(meta)
    strategies = meta.pop(_STRATEGIES, None)
    path = os.path.join(directory, f"step_{step}")
    tmp = os.path.join(directory, f".tmp-step_{step}")
    with open(os.path.join(tmp, "ff_meta.json"), "w") as f:
        json.dump(meta, f)
    _write_strategy(os.path.join(tmp, "strategy.txt"), strategies)
    # the manifest is the LAST write into tmp: it covers every other file
    write_manifest(tmp, known)
    if os.path.exists(path):
        # same-step overwrite: the complete replacement is already on disk
        shutil.rmtree(path)
    os.replace(tmp, path)  # the publish point
    mtmp = os.path.join(directory, f".meta.json.tmp-{os.getpid()}")
    with open(mtmp, "w") as f:
        json.dump(meta, f)
    os.replace(mtmp, os.path.join(directory, "meta.json"))
    stmp = os.path.join(directory, f".strategy.txt.tmp-{os.getpid()}")
    _write_strategy(stmp, strategies)
    os.replace(stmp, os.path.join(directory, "strategy.txt"))
    if faultinject.active_plan().fire("corrupt_ckpt", "save"):
        # damage the just-published payload before retention runs, so the
        # intact-preservation rule below is what keeps a recoverable step
        _inject_corruption(path)
    if keep is not None and keep > 0:
        steps_sorted = sorted(_step_dirs(directory))
        doomed = steps_sorted[:-keep]
        # the step this call just wrote is intact by construction, except
        # under the corruption drill
        drill = any(k == "corrupt_ckpt"
                    for k, _s, _i in faultinject.active_plan().events)

        def _survivor_intact(s: int) -> bool:
            if s == int(step) and not drill:
                return True
            return verify_step(directory, s)

        if doomed and not any(_survivor_intact(s)
                              for s in reversed(steps_sorted[-keep:])):
            # every survivor is damaged: spare the newest intact step
            for s in reversed(doomed):
                if verify_step(directory, s):
                    doomed.remove(s)
                    log.warning(
                        "checkpoint retention: every surviving step of "
                        "keep=%d fails verification — keeping intact step "
                        "%d beyond the retention window", keep, s)
                    break
        for old in doomed:
            shutil.rmtree(os.path.join(directory, f"step_{old}"),
                          ignore_errors=True)


# ------------------------------------------------------ async publisher


class _AsyncSaver:
    """ONE background publisher thread: saves publish strictly in
    submission order, pending work is awaitable per directory, and the
    first failure is re-raised at the next wait. A daemon: a process exit
    mid-publish leaves only a stale tmp dir."""

    def __init__(self):
        self._cond = locks.make_condition("checkpoint-saver")
        self._queue: collections.deque = collections.deque()
        self._active: Optional[str] = None
        self._errors: List[tuple] = []
        self._thread: Optional[threading.Thread] = None

    def submit(self, directory: str, step: int, fn):
        with self._cond:
            self._queue.append((directory, step, fn))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="ff-ckpt-publisher", daemon=True)
                self._thread.start()
            self._cond.notify_all()

    def _run(self):
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
                directory, step, fn = self._queue.popleft()
                self._active = directory
            try:
                fn()
            except BaseException as e:  # surfaced at the next wait()
                log.error("async checkpoint: publishing step %d in %s "
                          "failed: %s: %s", step, directory,
                          type(e).__name__, e)
                # the traceback's frames pin the host snapshot
                e.__traceback__ = None
                with self._cond:
                    self._errors.append((directory, step, e))
            finally:
                # the closure holds the host snapshot: drop it before
                # waiting for the next submission
                fn = None
                with self._cond:
                    self._active = None
                    self._cond.notify_all()

    @staticmethod
    def _matches(d: Optional[str], directory: Optional[str]) -> bool:
        return directory is None or d == directory

    def pending(self, directory: Optional[str] = None) -> int:
        with self._cond:
            return self._pending_locked(directory)

    def wait_below(self, directory: Optional[str], n: int):
        """Block until at most ``n`` matching saves are queued or in
        flight (the backpressure primitive); never raises."""
        with self._cond:
            while self._pending_locked(directory) > n:
                self._cond.wait()

    def _pending_locked(self, directory: Optional[str]) -> int:
        n = sum(1 for d, _s, _f in self._queue
                if self._matches(d, directory))
        if self._active is not None and self._matches(self._active,
                                                      directory):
            n += 1
        return n

    def wait(self, directory: Optional[str] = None):
        with self._cond:
            while self._pending_locked(directory) > 0:
                self._cond.wait()
            errs = [e for e in self._errors
                    if self._matches(e[0], directory)]
            if errs:
                self._errors = [e for e in self._errors if e not in errs]
                if len(errs) > 1:
                    log.warning("async checkpoint: %d further save "
                                "failure(s) consumed alongside the one "
                                "re-raised", len(errs) - 1)
                d, s, exc = errs[0]
                raise RuntimeError(
                    f"async checkpoint save of step {s} in {d} "
                    f"failed") from exc


_SAVER = _AsyncSaver()


def wait_pending_saves(directory: Optional[str] = None):
    """Block until every pending async save (to ``directory``, or anywhere)
    has published, then re-raise the first failure among them. After an
    async save across ranks every rank calls it: rank 0 waits for its
    publisher, then all meet (the save's second barrier, on this
    thread)."""
    d = os.path.abspath(directory) if directory else None
    try:
        _SAVER.wait(d)
    finally:
        hit = {p for p in _RANKED_PENDING if d is None or p == d}
        if hit:
            _RANKED_PENDING.difference_update(hit)
            _barrier()                          # ff_ckpt_done


def pending_saves(directory: Optional[str] = None) -> int:
    """Number of async saves still queued or publishing."""
    return _SAVER.pending(os.path.abspath(directory) if directory else None)


# ------------------------------------------------------ restore


def restore_checkpoint(model, directory: str, step: Optional[int] = None,
                       verify: Optional[bool] = None) -> int:
    """Restore into a compiled model, in place; returns the step.

    ``verify`` (default FFConfig.verify_checkpoints) recomputes the step's
    manifest first; with ``step=None`` the newest INTACT step is chosen.
    A restore failing mid-read over a step that no longer verifies is
    reclassified as ``CheckpointCorruptError`` so the resume fallbacks
    engage; an error over an intact step propagates."""
    directory = os.path.abspath(directory)
    if verify is None:
        verify = bool(getattr(model.config, "verify_checkpoints", True))
    if step is None:
        step = latest_intact_step(directory, verify=verify)
        if step is None:
            raise FileNotFoundError(
                f"no (intact) checkpoint found in {directory}")
    elif verify:
        verify_checkpoint(directory, step)
    try:
        return _restore_into(model, directory, step)
    except CheckpointCorruptError:
        raise
    except Exception as err:
        _reclassify_raced_damage(directory, step, err)
        raise


def _reclassify_raced_damage(directory: str, step: int, err: Exception):
    """Re-check a step whose restore failed: a vanished dir, unreadable
    metadata or a manifest that no longer verifies becomes
    ``CheckpointCorruptError``; an intact step returns (the error is
    real)."""
    step_dir = os.path.join(directory, f"step_{step}")
    if not os.path.isdir(step_dir):
        raise CheckpointCorruptError(
            f"checkpoint step {step} disappeared mid-restore "
            f"({type(err).__name__}: {err})") from err
    if not _meta_readable(directory, step):
        raise CheckpointCorruptError(
            f"checkpoint step {step}: metadata became unreadable "
            f"mid-restore ({type(err).__name__}: {err})") from err
    try:
        verify_checkpoint(directory, step)
    except CheckpointCorruptError as ce:
        raise CheckpointCorruptError(
            f"{ce} (surfaced as {type(err).__name__} mid-restore)") from err


@retry(attempts=3, base_delay=0.05, retryable=(OSError,),
       name="checkpoint load")
def load_payload(step_dir: str) -> Dict[str, torch.Tensor]:
    """A step dir's payload: {name: CPU tensor}, memory-mapped."""
    faultinject.maybe_fail("io_fail", "load")
    path = os.path.join(step_dir, PAYLOAD_NAME)
    if not os.path.exists(path) and os.path.isdir(step_dir):
        raise ValueError(
            f"{step_dir} holds no {PAYLOAD_NAME}: not a flexflow_tpu_torch "
            f"checkpoint (the JAX package's orbax checkpoints do not "
            f"cross packages)")
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)


def _copy_group(live: Dict[str, torch.Tensor], saved, prefix: str,
                what: str):
    """Copy every live tensor under ``prefix`` from the payload, in place
    (a DTensor its own slice: ``parallel.copy_full_into``); a missing
    entry or a shape mismatch refuses."""
    with torch.no_grad():
        for name, t in live.items():
            if not name.startswith(prefix + "/"):
                continue
            src = saved.get(name)
            if src is None:
                raise ValueError(f"checkpoint has no {what} entry {name!r}")
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(
                    f"checkpoint entry {name!r} is {tuple(src.shape)}, the "
                    f"model's is {tuple(t.shape)}")
            parallel.copy_full_into(t, src)


def _restore_into(model, directory: str, step: int) -> int:
    meta = load_meta(directory, step)
    saved_layout = meta.get("opt_layout")
    if saved_layout is not None and model.optimizer is not None:
        if saved_layout != _opt_layout(model):
            raise ValueError(
                f"checkpoint at {directory} stores optimizer state in the "
                f"{saved_layout!r} layout but this model uses "
                f"{_opt_layout(model)!r} (FFConfig.fused_optimizer and the "
                f"sharding strategy determine the layout). Re-compile with "
                f"a matching fused_optimizer setting to restore.")
        if saved_layout == "sharded_fused":
            # the flat vector's element order follows the mesh (in axis
            # order) and the weights' specs: another topology would
            # scramble the moments
            mesh = parallel.mesh_shape_dict(model.mesh)
            saved_sh = meta.get("opt_state_shardings")
            if (list((meta.get("mesh_shape") or {}).items())
                    != list(mesh.items())
                    or (saved_sh is not None
                        and saved_sh != _sharded_fused_shardings(model))):
                raise ValueError(
                    f"checkpoint at {directory} stores sharded-fused "
                    f"optimizer state for mesh {meta.get('mesh_shape')} "
                    f"with different parameter shardings — the flat state "
                    f"layout is topology-dependent. Re-compile with the "
                    f"saved mesh/strategy, or restore weights only "
                    f"(optimizer=None) and start the optimizer fresh.")
    saved = load_payload(os.path.join(directory, f"step_{step}"))
    live = state_tensors(model)
    _copy_group(live, saved, "params", "weight")
    groups = {name.split("/", 1)[0] for name in saved}
    if "opt_state" in groups and model.optimizer is not None:
        _copy_group(live, saved, "opt_state", "optimizer-state")
    if "bn_state" in groups:
        _copy_group(live, saved, "bn_state", "BatchNorm-state")
    if "guard" in groups and getattr(model, "_guard_state", None) is not None:
        _copy_group(live, saved, "guard", "guard-state")
    for name, g in getattr(model, "_generators", {}).items():
        state = saved.get(f"generators/{name}")
        if state is not None:
            g.set_state(state.clone())
    model._step_count = step
    return step


def _step_dirs(directory: str):
    """Published checkpoint step numbers (tmp dirs skipped)."""
    try:
        names = os.listdir(directory)
    except (FileNotFoundError, NotADirectoryError):
        return []
    out = []
    for n in names:
        m = re.fullmatch(r"step_(\d+)", n)
        if m and os.path.isdir(os.path.join(directory, n)):
            out.append(int(m.group(1)))
    return out


def load_meta(directory: str, step: Optional[int] = None) -> dict:
    """The per-step ``step_N/ff_meta.json`` when present, else the
    top-level ``meta.json``."""
    directory = os.path.abspath(directory)
    if step is not None:
        per_step = os.path.join(directory, f"step_{step}", "ff_meta.json")
        if os.path.exists(per_step):
            with open(per_step) as f:
                return json.load(f)
    with open(os.path.join(directory, "meta.json")) as f:
        return json.load(f)


def latest_step(directory: str) -> Optional[int]:
    """Newest published step with READABLE metadata, or None (scans the
    step dirs only; payload verification is ``latest_intact_step``'s)."""
    directory = os.path.abspath(directory)
    for step in sorted(_step_dirs(directory), reverse=True):
        if _meta_readable(directory, step):
            return step
    return None


def scan_and_restore(model, directory: str, *, restore, on_skip=None,
                     who: str = "auto_resume") -> Optional[int]:
    """The one newest-intact-first resume policy (``auto_resume`` and
    ``TrainSupervisor.resume``): restore the first intact step, falling
    back past raced mid-restore damage. None when the directory holds no
    step; ``CheckpointCorruptError`` when every step fails."""
    verify = bool(getattr(model.config, "verify_checkpoints", True))
    for step in iter_intact_steps(
            directory, verify=verify, on_skip=on_skip,
            trusted_step=trusted_step_for(model, directory)):
        try:
            restore(step)
            return step
        except CheckpointCorruptError as e:
            log.warning("%s: checkpoint step %d became unreadable "
                        "mid-restore (%s); falling back to the next intact "
                        "step", who, step, e)
            if on_skip is not None:
                on_skip(step)
    if _step_dirs(os.path.abspath(directory)):
        raise CheckpointCorruptError(
            f"every checkpoint in {directory} fails metadata/manifest "
            f"verification — refusing to silently start fresh over "
            f"damaged checkpoints")
    return None


def auto_resume(model, directory: str) -> int:
    """Restore the newest INTACT checkpoint in ``directory`` and return
    its step; 0 on a fresh start (no step dirs)."""
    def _restore(step):
        restore_checkpoint(model, directory, step=step, verify=False)

    step = scan_and_restore(model, directory, restore=_restore)
    return 0 if step is None else step
