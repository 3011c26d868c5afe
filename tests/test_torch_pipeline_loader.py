"""The port's ``PipelineLoader`` (flexflow_tpu_torch/runtime/
pipeline_loader.py) under the contracts of tests/test_pipeline_loader.py:
strict FIFO, the depth bound, consumed-cursor accounting, the epoch break
and stop (idempotent, rewinding the cursors), a worker error re-raised in
``get()``, ``io_fail@loader`` retrying the same batch, the timed ``get``,
the stats — pure host logic, every wait bounded. The last cases drive
the same ordered source through the JAX package's ``PipelineLoader`` and
the port's and compare what each hands out."""

import threading
import time

import numpy as np
import pytest

from flexflow_tpu.runtime import faultinject as j_faultinject
from flexflow_tpu.runtime.pipeline_loader import PipelineLoader as JPipe
from flexflow_tpu_torch.runtime import faultinject, resilience
from flexflow_tpu_torch.runtime.pipeline_loader import PipelineLoader


@pytest.fixture(autouse=True)
def _fresh_fault_state(monkeypatch):
    monkeypatch.delenv("FF_FAULT", raising=False)
    faultinject.reset()
    j_faultinject.reset()
    resilience.reset_counters()
    yield
    faultinject.reset()
    j_faultinject.reset()


class Source:
    """Deterministic pull source with a seekable cursor (the
    SingleDataLoader contract distilled)."""

    def __init__(self, n=1000, eos_at=None):
        self.cursor = 0
        self.eos_at = eos_at
        self.n = n

    def pull(self):
        if self.eos_at is not None and self.cursor >= self.eos_at:
            return None
        v = self.cursor
        self.cursor += 1
        return {"x": v}

    def cursors(self):
        return {"x": self.cursor}

    def restore(self, snap):
        self.cursor = snap["x"]


def make(src, depth=3, shard=None):
    return PipelineLoader(src.pull, shard or (lambda b: dict(b)),
                          depth=depth, cursors=src.cursors,
                          restore=src.restore)


def test_fifo_order_many_items():
    pipe = make(Source(), depth=3).start()
    try:
        assert [pipe.get(timeout=10)["x"] for _ in range(50)] \
            == list(range(50))
    finally:
        pipe.stop()


def test_depth_bound_never_exceeded():
    seen = []

    def shard(b):
        seen.append(b["x"])
        return b

    src = Source()
    pipe = PipelineLoader(src.pull, shard, depth=2, cursors=src.cursors,
                          restore=src.restore).start()
    try:
        time.sleep(0.3)  # worker fills the buffer and must park
        assert len(seen) <= 3  # depth 2 buffered + at most 1 in flight
        pipe.get(timeout=10)
        time.sleep(0.2)
        assert len(seen) <= 4  # one refill per consume
    finally:
        pipe.stop()


def test_consumed_cursor_tracks_handed_out_batches_only():
    src = Source()
    pipe = make(src, depth=3).start()
    try:
        assert pipe.consumed_cursors() == {"x": 0}
        for i in range(4):
            pipe.get(timeout=10)
            assert pipe.consumed_cursors() == {"x": i + 1}
        # the source cursor has been pulled AHEAD of what was consumed
        time.sleep(0.2)
        assert src.cursor > 4
    finally:
        pipe.stop()
    # stop() rewound the source to the consumed position
    assert src.cursor == 4


def test_epoch_break_discards_rewinds_and_resumes():
    src = Source()
    pipe = make(src, depth=3).start()
    try:
        for _ in range(3):
            pipe.get(timeout=10)
        time.sleep(0.2)  # let the worker prefetch past the epoch point
        resets = []
        pipe.epoch_break(lambda: (src.restore({"x": 0}), resets.append(1)))
        assert resets == [1]
        # post-reset: the next batch is batch 0 again, not a stale one
        assert pipe.get(timeout=10)["x"] == 0
    finally:
        pipe.stop()


def test_stop_is_idempotent():
    src = Source()
    pipe = make(src).start()
    pipe.get(timeout=10)
    pipe.stop()
    pipe.stop()
    assert src.cursor == 1


def test_worker_error_surfaces_in_get_not_deadlock():
    def bad_shard(b):
        raise ValueError("boom")

    src = Source()
    pipe = PipelineLoader(src.pull, bad_shard, depth=2,
                          cursors=src.cursors, restore=src.restore).start()
    try:
        with pytest.raises(RuntimeError, match="prefetch worker died"):
            pipe.get(timeout=10)
    finally:
        pipe.stop()


def test_injected_loader_io_fail_retries_same_batch(monkeypatch):
    monkeypatch.setenv("FF_FAULT", "io_fail@loader:2")
    faultinject.reset()
    src = Source()
    pipe = make(src, depth=2).start()
    try:
        assert [pipe.get(timeout=10)["x"] for _ in range(6)] \
            == list(range(6)), "retry must re-pull the SAME batch"
        assert resilience.COUNTERS["retries"] >= 1
    finally:
        pipe.stop()


def test_exhausted_retries_raise_on_training_thread(monkeypatch):
    monkeypatch.setenv("FF_FAULT", "io_fail@loader:1-3")
    faultinject.reset()
    pipe = make(Source(), depth=2).start()
    try:
        with pytest.raises(RuntimeError, match="prefetch worker died"):
            pipe.get(timeout=10)
    finally:
        pipe.stop()


def test_eos_with_empty_buffer_raises_loudly():
    src = Source(eos_at=2)
    pipe = make(src, depth=2).start()
    try:
        assert pipe.get(timeout=10)["x"] == 0
        assert pipe.get(timeout=10)["x"] == 1
        with pytest.raises(RuntimeError, match="exhausted"):
            pipe.get(timeout=10)
    finally:
        pipe.stop()


def test_epoch_break_clears_eos():
    src = Source(eos_at=2)
    pipe = make(src, depth=2).start()
    try:
        pipe.get(timeout=10), pipe.get(timeout=10)
        time.sleep(0.1)  # worker hits eos and parks

        def reset():
            src.cursor = 0
            src.eos_at = None

        pipe.epoch_break(reset)
        assert pipe.get(timeout=10)["x"] == 0
    finally:
        pipe.stop()


def test_get_timeout_raises():
    blocker = threading.Event()

    def slow_pull():
        blocker.wait(5.0)
        return {"x": 0}

    pipe = PipelineLoader(slow_pull, lambda b: b, depth=1)
    pipe.start()
    try:
        with pytest.raises(TimeoutError):
            pipe.get(timeout=0.2)
    finally:
        blocker.set()
        pipe.stop()


def test_stats_count_delivered_batches():
    pipe = make(Source(), depth=2).start()
    try:
        for _ in range(5):
            pipe.get(timeout=10)
        assert pipe.stats["batches"] >= 5
        assert pipe.stats["h2d_s"] >= 0.0
    finally:
        pipe.stop()


def test_unseekable_source_has_no_cursor_contract():
    src = Source()
    pipe = PipelineLoader(src.pull, lambda b: b, depth=2).start()
    try:
        pipe.get(timeout=10)
        assert pipe.consumed_cursors() is None
    finally:
        pipe.stop()


def test_numpy_batches_pass_through_shard():
    src_arrays = [np.full((4,), i, np.float32) for i in range(8)]
    it = iter(src_arrays)
    pipe = PipelineLoader(lambda: {"x": next(it)}, lambda b: dict(b),
                          depth=2).start()
    try:
        for i in range(8):
            np.testing.assert_array_equal(pipe.get(timeout=10)["x"],
                                          src_arrays[i])
    finally:
        pipe.stop()


@pytest.mark.parametrize("fault", ["", "io_fail@loader:3"])
def test_port_hands_out_what_jax_hands_out(monkeypatch, fault):
    """The same ordered source through both packages' loaders, with an
    epoch break and a stop in the middle: the same batches, consumed
    cursors and source cursor after stop."""
    got = {}
    for name, cls, fi in (("jax", JPipe, j_faultinject),
                          ("port", PipelineLoader, faultinject)):
        if fault:
            monkeypatch.setenv("FF_FAULT", fault)
        fi.reset()
        src = Source()
        pipe = cls(src.pull, lambda b: dict(b), depth=2,
                   cursors=src.cursors, restore=src.restore).start()
        seen = []
        try:
            seen += [pipe.get(timeout=10)["x"] for _ in range(5)]
            seen.append(pipe.consumed_cursors()["x"])
            pipe.epoch_break(lambda: src.restore({"x": 100}))
            seen += [pipe.get(timeout=10)["x"] for _ in range(3)]
        finally:
            pipe.stop()
        seen.append(src.cursor)
        got[name] = seen
        monkeypatch.delenv("FF_FAULT", raising=False)
        fi.reset()
    assert got["port"] == got["jax"] == [0, 1, 2, 3, 4, 5, 100, 101,
                                         102, 103]
