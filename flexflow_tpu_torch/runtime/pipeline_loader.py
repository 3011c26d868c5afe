"""The host-overlap input pipeline: a bounded background prefetch whose
batches are already on the device when the step asks for them (the JAX
package's ``runtime/pipeline_loader.py``).

The synchronous ``fit`` loop slices a batch on the host, copies it to the
device on the training thread — a pageable, stream-ordered copy that waits
for the previous step — and only then dispatches the step: the card idles
through the host work and the host through the device work.
``PipelineLoader`` closes that gap. One daemon worker pulls batches from a
source (the model's ``SingleDataLoader``s or a ``NativeBatchLoader``),
copies each to the device and parks up to ``depth`` ready batches in a
bounded FIFO; ``get()`` hands them to the training loop in order.

On the card (``CardStager``) the worker:

  * makes the model's device current first (a new thread has no CUDA
    context: ``kernels._on_device``);
  * stages each batch in a pinned host buffer from a small ring — the
    native loader copies its slot straight in, a Python source's slice is
    copied in once — and refills a buffer only after the event of its
    last device copy has completed;
  * copies the batch to the device with ``non_blocking`` on a stream of
    its own (``kernels.private_stream``), inside ``kernels.device_section``
    so that no copy lands in another thread's CUDA-graph capture, and
    records an event.

``get()`` then makes the consuming stream wait on that event and calls
``record_stream`` on the batch's tensors for it, so the caching allocator
does not hand their memory to the copy stream while the step still reads
it.

Exactness contracts (what makes overlap safe to turn on by default):

  * **Order**: one worker pulls, copies and buffers strictly in source
    order; ``get()`` pops FIFO — the overlap loop trains the batch
    sequence of the synchronous loop.
  * **Cursor accounting**: the worker moves the source's cursor
    (``dl.next_index``) ahead of training. ``consumed_cursors()`` reports
    the position as of the last batch HANDED to the training loop, and
    every quiesce (epoch break, stop) rewinds the source cursors to it
    and bumps a generation, so a pull that raced the quiesce is dropped
    — a checkpoint at any step boundary records the synchronous loop's
    cursor (runtime/resilience.py reads it through this).
  * **Faults**: the pull runs inside ``resilience.retry`` with
    ``faultinject.maybe_fail("io_fail", "loader")`` checked BEFORE the
    cursor moves, so ``FF_FAULT=io_fail@loader:n`` retries the same
    batch. A worker error that exhausts its retries is parked and
    re-raised from ``get()`` on the training thread.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from flexflow_tpu_torch.runtime import faultinject, locks, telemetry
from flexflow_tpu_torch.runtime.resilience import retry

log = logging.getLogger(__name__)


class CardStager:
    """The worker's device side on the card: a ring of pinned host
    buffers, a private copy stream and an event a batch. ``pin`` and
    ``put`` run on the worker thread (``pin`` before ``put``, one batch at
    a time), ``handoff`` on the training thread."""

    def __init__(self, model, slots: int):
        self.model = model
        self.device = model.device
        self._ring: List[Optional[Dict[str, torch.Tensor]]] = [None] * slots
        self._fence: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0
        self._slot = 0
        self.stream = None

    def context(self):
        from flexflow_tpu_torch.ops import kernels

        return kernels._on_device(self.device)

    def buffers(self, shapes) -> Dict[str, torch.Tensor]:
        """The next ring slot's pinned buffers for ``shapes`` ({name:
        (shape, numpy dtype)}), once the device copy that last read them
        has completed."""
        from flexflow_tpu_torch.ops import kernels

        i = self._slot = self._next
        self._next = (i + 1) % len(self._ring)
        if self._fence[i] is not None:
            self._fence[i].synchronize()
            self._fence[i] = None
        bufs = self._ring[i]
        if bufs is None or any(
                tuple(bufs[k].shape) != tuple(s)
                or bufs[k].dtype != _torch_dtype(d)
                for k, (s, d) in shapes.items()):
            with kernels.device_section():
                bufs = self._ring[i] = {
                    k: torch.empty(s, dtype=_torch_dtype(d),
                                   pin_memory=True)
                    for k, (s, d) in shapes.items()}
        return bufs

    def pin(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """A host batch copied into the next ring slot (one host copy)."""
        arrs = {k: np.asarray(v) for k, v in batch.items()}
        bufs = self.buffers({k: (a.shape, a.dtype) for k, a in arrs.items()})
        for k, a in arrs.items():
            bufs[k].copy_(torch.from_numpy(np.ascontiguousarray(a)))
        return bufs

    def put(self, pinned: Dict[str, torch.Tensor]):
        """The current slot's batch copied to the device on the copy
        stream: (device batch, its event)."""
        from flexflow_tpu_torch.ops import kernels

        with kernels.device_section():
            if self.stream is None:
                self.stream = kernels.private_stream(self.device, self)
            dev = self.model.executor.shard_batch(pinned, stream=self.stream)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self._fence[self._slot] = ev
        return dev, ev

    def handoff(self, staged) -> Dict[str, torch.Tensor]:
        dev, ev = staged
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ev)
        for t in dev.values():
            t.record_stream(cur)
        return dev


def _torch_dtype(d) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=d)).dtype


class PipelineLoader:
    """Bounded background prefetch queue over a batch source.

    ``pull() -> batch dict | None`` (None = end of epoch, the native
    loader's signal), ``shard(batch) -> device batch``, and for sources
    with seekable cursors (the ``SingleDataLoader``s)
    ``cursors()`` / ``restore(snapshot)``. ``context`` is entered on the
    worker thread for its life, ``handoff`` maps a buffered batch on the
    training thread as ``get()`` returns it (the card's stream
    handshake)."""

    def __init__(self, pull: Callable[[], Optional[Dict]],
                 shard: Callable[[Dict], Dict], *, depth: int = 2,
                 cursors: Optional[Callable[[], Dict]] = None,
                 restore: Optional[Callable[[Dict], None]] = None,
                 telemetry_on: bool = True,
                 context: Optional[Callable] = None,
                 handoff: Optional[Callable] = None):
        if depth < 1:
            raise ValueError(f"PipelineLoader depth must be >= 1, got "
                             f"{depth}")
        self._tm_on = bool(telemetry_on)
        self._shard = shard
        self._cursors = cursors
        self._restore = restore
        self._context = context or contextlib.nullcontext
        self._handoff = handoff
        self.depth = depth
        self._cv = locks.make_condition("pipeline-loader")
        self._buf: collections.deque = collections.deque()
        self._paused = False
        self._stopped = False
        self._pulling = False
        self._eos = False
        self._gen = 0   # bumped at every quiesce: stale pulls are dropped
        self._exc: Optional[BaseException] = None
        self._consumed = cursors() if cursors is not None else None
        # h2d_s accumulates on the worker: time the training thread never
        # sees (the point of the pipeline)
        self.stats = {"h2d_s": 0.0, "pull_s": 0.0, "batches": 0}

        # maybe_fail runs BEFORE the pull, so a scheduled io_fail@loader
        # fires without moving a cursor and the retry pulls the same batch
        @retry(attempts=3, base_delay=0.05, retryable=(OSError,),
               name="prefetch pull")
        def _pull_retry():
            faultinject.maybe_fail("io_fail", "loader")
            return pull()

        self._pull = _pull_retry
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ff-prefetch")
        self._started = False

    # ---- constructors ------------------------------------------------------

    @classmethod
    def _card(cls, model, depth: int):
        if model.device.type != "cuda":
            return None
        return CardStager(model, slots=depth + 1)

    @classmethod
    def from_loaders(cls, model, depth: int = 2) -> "PipelineLoader":
        """Prefetch from the model's attached SingleDataLoaders (seekable
        cursors: exact quiesce and checkpoint accounting)."""
        dls = list(model._dataloaders)
        card = cls._card(model, depth)

        def pull():
            batch = {dl.name: dl.next_batch() for dl in dls}
            return card.pin(batch) if card is not None else batch

        def cursors():
            return {dl.name: int(dl.next_index) for dl in dls}

        def restore(snap):
            for dl in dls:
                if dl.name in snap:
                    dl.next_index = int(snap[dl.name])

        return cls(pull, card.put if card is not None
                   else model.executor.shard_batch, depth=depth,
                   cursors=cursors, restore=restore,
                   telemetry_on=model.config.telemetry != "off",
                   context=card.context if card is not None else None,
                   handoff=card.handoff if card is not None else None)

    @classmethod
    def from_native(cls, native_dl, model, depth: int = 2
                    ) -> "PipelineLoader":
        """Prefetch on top of the native threaded loader (which already
        overlaps the host's batch ASSEMBLY; this adds the device copy). On
        the card each slot is copied straight into a pinned ring buffer.
        Its shuffled cursor cannot seek, so there is no cursor contract:
        a resume under the native loader replays batches by count."""
        card = cls._card(model, depth)
        if card is None:
            pull = native_dl.next_batch
        else:
            shapes = native_dl.batch_shapes()

            def pull():
                return native_dl.next_batch(out=card.buffers(shapes))

        return cls(pull, card.put if card is not None
                   else model.executor.shard_batch, depth=depth,
                   telemetry_on=model.config.telemetry != "off",
                   context=card.context if card is not None else None,
                   handoff=card.handoff if card is not None else None)

    # ---- worker ------------------------------------------------------------

    def _run(self):
        try:
            ctx = self._context()
            ctx.__enter__()
        except BaseException as e:  # noqa: BLE001 — parked for get()
            with self._cv:
                self._exc = e
                self._cv.notify_all()
            return
        try:
            self._loop()
        finally:
            ctx.__exit__(None, None, None)

    def _loop(self):
        while True:
            with self._cv:
                while not self._stopped and (
                        self._paused or self._eos
                        or len(self._buf) >= self.depth):
                    self._cv.wait()
                if self._stopped:
                    return
                self._pulling = True
                gen = self._gen
            try:
                t0 = time.perf_counter()
                batch = self._pull()
                t1 = time.perf_counter()
                if batch is None:   # end of epoch (native loader)
                    with self._cv:
                        self._pulling = False
                        self._eos = True
                        self._cv.notify_all()
                    continue
                sharded = self._shard(batch)
                t2 = time.perf_counter()
                snap = self._cursors() if self._cursors is not None else None
            except BaseException as e:  # noqa: BLE001 — parked for get()
                with self._cv:
                    self._pulling = False
                    self._exc = e
                    self._cv.notify_all()
                return
            with self._cv:
                self._pulling = False
                # a quiesce that raced this pull rewound the cursor past
                # it: drop the batch (the generation also covers a pull
                # the quiesce gave up waiting on)
                if not (self._paused or self._stopped) and gen == self._gen:
                    self._buf.append((sharded, snap))
                    self.stats["pull_s"] += t1 - t0
                    self.stats["h2d_s"] += t2 - t1
                    self.stats["batches"] += 1
                    # the worker's phases on their own "loader" track: the
                    # exported trace shows the prefetch under the steps
                    if self._tm_on:
                        telemetry.tracer().complete(
                            "prefetch_pull", t0, t1 - t0, track="loader")
                        telemetry.tracer().complete(
                            "prefetch_h2d", t1, t2 - t1, track="loader")
                self._cv.notify_all()

    # ---- training-thread API ----------------------------------------------

    def start(self):
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def get(self, timeout: Optional[float] = None) -> Dict:
        """The next batch, FIFO. Blocks until the worker delivers (at most
        ``timeout`` seconds); re-raises a worker error here, on the
        training thread, instead of waiting forever."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if self._buf:
                    sharded, snap = self._buf.popleft()
                    if snap is not None:
                        self._consumed = snap
                    self._cv.notify_all()
                    break
                if self._exc is not None:
                    raise RuntimeError(
                        "prefetch worker died") from self._exc
                if self._eos:
                    raise RuntimeError(
                        "prefetch source exhausted mid-epoch (loader "
                        "num_batches disagrees with the training loop)")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"prefetch get() timed out after {timeout}s")
                self._cv.wait(timeout=0.5)
        return self._handoff(sharded) if self._handoff is not None \
            else sharded

    def consumed_cursors(self) -> Optional[Dict]:
        """The source cursors as of the last batch handed to the training
        loop (None for an unseekable source): what a checkpoint records,
        not the source's pulled-ahead cursor."""
        with self._cv:
            return dict(self._consumed) if self._consumed is not None \
                else None

    def reset_stats(self):
        """Zero the counters under the worker's lock (the worker updates
        them under it)."""
        with self._cv:
            for k in self.stats:
                self.stats[k] = 0 if k == "batches" else 0.0

    def _quiesce_locked(self, timeout: float = 10.0):
        self._paused = True
        self._cv.notify_all()
        deadline = time.monotonic() + timeout
        while self._pulling:
            remaining = deadline - time.monotonic()
            if remaining <= 0:   # pragma: no cover — diagnostics
                # a pull stuck on a dead source would hang this quiesce,
                # and a SIGTERM stop() would never reach its checkpoint:
                # abandon the daemon worker; the generation bump drops its
                # batch if it ever completes
                log.warning("prefetch worker still mid-pull after %.0fs "
                            "quiesce wait — abandoning it", timeout)
                break
            self._cv.wait(timeout=min(remaining, 0.5))
        self._gen += 1
        self._buf.clear()
        self._eos = False
        if self._restore is not None and self._consumed is not None:
            # prefetched-but-untrained batches are discarded and pulled
            # again
            self._restore(self._consumed)

    def epoch_break(self, reset: Optional[Callable[[], None]] = None):
        """Epoch boundary: pause the worker, discard prefetched batches,
        rewind the cursors to the consumed position, run ``reset`` with
        the worker idle, snapshot again and resume — the source ends where
        the synchronous loop's epoch boundary leaves it."""
        with self._cv:
            self._quiesce_locked()
            if reset is not None:
                reset()
            if self._cursors is not None:
                self._consumed = self._cursors()
            self._paused = False
            self._cv.notify_all()

    def stop(self):
        """End the worker and rewind the cursors to the consumed position
        (so ``dl.next_index`` after fit is the synchronous loop's).
        Idempotent; never raises — a parked worker error has already
        surfaced on the training thread, or is moot."""
        with self._cv:
            if self._stopped:
                return
            try:
                self._quiesce_locked()
            finally:
                self._stopped = True
                self._cv.notify_all()
        if self._started:
            self._thread.join(timeout=10.0)
            if self._thread.is_alive():   # pragma: no cover — diagnostics
                log.warning("prefetch worker did not exit within 10s at "
                            "stop()")
