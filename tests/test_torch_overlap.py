"""The port's input pipeline through ``FFModel.fit`` (flexflow_tpu_torch/
runtime/pipeline_loader.py, native_loader.py, the host path of
dataloader.py, and fit's dispatch-ahead loop) against the JAX package's
``fit``, with the cases of tests/test_overlap.py.

The model is JAX's test MLP (8 -> 16 relu -> 4, batch 16, 64 samples) with
``device_resident_data=False``, so the data stays on the host: built in
both packages, the JAX-initialised weights copied into the port, f32 on
the CPU. Held:

  * sync, overlap and native loading (unshuffled and shuffled): the
    port's per-step losses and its weights after 2 epochs are JAX's
    within 1e-6; the port's overlap run is bitwise its sync run (also at
    dispatch_ahead 0), and its cursors after fit are the sync loop's;
  * kill-and-resume under prefetch records the CONSUMED cursor, and the
    resumed run is bitwise the uninterrupted one; a periodic save while
    the worker runs ahead records the sync loop's cursor;
  * ``io_fail`` in the worker retries the same batch (bitwise the
    no-fault run), and exhausted retries fail fit, pipeline torn down;
  * the budget sends an over-budget dataset to the host path, and a
    dataset within it is staged on the device;
  * fit's callbacks; fault 8: ``metrics_ignore_index`` drops pad labels
    from accuracy's count and denominator exactly as JAX's, per step and
    under ``scan_steps=2``.
"""

import numpy as np
import pytest
import torch

from flexflow_tpu import ActiMode as JActi
from flexflow_tpu import DataType as JDataType
from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import LossType as JLoss
from flexflow_tpu import MetricsType as JMetrics
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu import SingleDataLoader as JLoader
from flexflow_tpu.runtime import faultinject as j_faultinject
from flexflow_tpu_torch import (ActiMode, DataType, FFConfig, FFModel,
                                LossType, MetricsType, SGDOptimizer,
                                SingleDataLoader)
from flexflow_tpu_torch.runtime import (faultinject, native_loader,
                                        resilience)
from flexflow_tpu_torch.runtime.checkpoint import latest_step, load_meta

TOL = 1e-6
MODES = {
    "sync": dict(prefetch_depth=0, native_dataloader=False),
    "overlap": dict(native_dataloader=False),
    "native": dict(native_dataloader=True),
    "native_shuffled": dict(native_dataloader=True, dataloader_shuffle=True),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_fault_state(monkeypatch):
    monkeypatch.delenv("FF_FAULT", raising=False)
    faultinject.reset()
    j_faultinject.reset()
    resilience.reset_counters()
    yield
    faultinject.reset()
    j_faultinject.reset()


def _data(n=64):
    rs = np.random.RandomState(7)
    return (rs.randn(n, 8).astype(np.float32),
            rs.randint(0, 4, (n, 1)).astype(np.int32))


def _cfg(epochs=2, **kw):
    return dict(dict(batch_size=16, epochs=epochs, seed=3,
                     device_resident_data=False), **kw)


def _jax(**kw):
    ff = JModel(JConfig(mesh_shape={"data": 1}, **_cfg(**kw)))
    x = ff.create_tensor([16, 8], name="x")
    t = ff.dense(x, 16, JActi.AC_MODE_RELU, name="fc1")
    ff.dense(t, 4, name="out")
    ff.compile(JSGD(lr=0.1), JLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [JMetrics.METRICS_ACCURACY])
    xs, ys = _data()
    JLoader(ff, x, xs)
    JLoader(ff, ff.label_tensor, ys)
    return ff


_INIT = {}


def _jax_init():
    if not _INIT:
        jff = _jax()
        _INIT.update({op: {w: np.asarray(a) for w, a in ws.items()}
                      for op, ws in jff.params.items()})
    return _INIT


def _build(ckpt_dir="", n=64, **kw):
    """The port's MLP with JAX's initial weights."""
    cfg = _cfg(**kw)
    if ckpt_dir:
        cfg["checkpoint_dir"] = str(ckpt_dir)
    ff = FFModel(FFConfig(**cfg), device="cpu")
    x = ff.create_tensor([16, 8], name="x")
    t = ff.dense(x, 16, ActiMode.AC_MODE_RELU, name="fc1")
    ff.dense(t, 4, name="out")
    ff.compile(SGDOptimizer(lr=0.1),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY])
    for op, ws in _jax_init().items():
        for w, a in ws.items():
            ff.set_weights(op, w, a.copy())
    xs, ys = _data(n)
    SingleDataLoader(ff, x, xs)
    SingleDataLoader(ff, ff.label_tensor, ys)
    return ff


def _record(ff, **fit_kw):
    """fit, recording every step's loss as a float (the wrapper reads each
    loss: it changes timing, never values)."""
    losses = []
    orig = ff._run_train_step

    def rec(batch, **kw):
        loss, mets = orig(batch, **kw)
        losses.append(float(loss))
        return loss, mets

    ff._run_train_step = rec
    try:
        ff.fit(verbose=False, **fit_kw)
    finally:
        ff._run_train_step = orig
    return losses


def _weights(ff):
    return {op: {w: ff.get_weights(op, w) for w in ws}
            for op, ws in ff.weight_shapes().items()}


def _jax_weights(jff):
    return {op: {w: np.asarray(a) for w, a in ws.items()}
            for op, ws in jff.params.items()}


_JAX_RUNS = {}


def _jax_run(mode):
    if mode not in _JAX_RUNS:
        jff = _jax(**MODES[mode])
        losses = _record(jff)
        _JAX_RUNS[mode] = (losses, _jax_weights(jff),
                           [dl.next_index for dl in jff._dataloaders])
    return _JAX_RUNS[mode]


# ------------------------------------------------------------ vs JAX


@pytest.mark.parametrize("mode", list(MODES))
def test_fit_from_host_data_matches_jax(mode):
    if mode.startswith("native") and native_loader.load_lib() is None:
        pytest.skip("native dataloader unavailable (no g++)")
    ff = _build(**MODES[mode])
    losses = _record(ff)
    want, wts, cursors = _jax_run(mode)
    assert len(losses) == len(want) == 8
    np.testing.assert_allclose(losses, want, rtol=TOL, atol=TOL)
    got = _weights(ff)
    for op, ws in wts.items():
        for w, a in ws.items():
            np.testing.assert_allclose(got[op][w], a, rtol=TOL, atol=TOL)
    assert all(dl._dev_data is None for dl in ff._dataloaders)
    if not mode.startswith("native"):
        assert [dl.next_index for dl in ff._dataloaders] == cursors
    if mode == "native":
        # the unshuffled native stream is the sliced one: sync's losses
        np.testing.assert_allclose(losses, _jax_run("sync")[0], rtol=TOL,
                                   atol=TOL)


def test_overlap_bitwise_the_port_sync_run():
    sync = _build(prefetch_depth=0, native_dataloader=False)
    ls_sync = _record(sync)
    for kw in (dict(), dict(prefetch_depth=3, dispatch_ahead=0)):
        ov = _build(native_dataloader=False, **kw)
        assert _record(ov) == ls_sync
        for op, ws in _weights(sync).items():
            for w, a in ws.items():
                np.testing.assert_array_equal(ov.get_weights(op, w), a)
        assert ([dl.next_index for dl in ov._dataloaders]
                == [dl.next_index for dl in sync._dataloaders])
        assert ov._pipeline is None
        bd = ov.last_step_breakdown
        assert bd["overlap"] and bd["steps"] == 7   # the first is warm-up
        assert 0.0 <= bd["host_wait_fraction"] <= 1.0
        assert set(bd) == {"host_wait", "h2d", "dispatch", "device",
                           "steps", "wall_s", "overlap",
                           "host_wait_fraction"}
    assert not sync.last_step_breakdown["overlap"]


# ------------------------------------------------ checkpoint and resume


def test_kill_and_resume_under_prefetch_restores_consumed_cursor(
        tmp_path, monkeypatch):
    monkeypatch.setenv("FF_FAULT", "sigterm@step:5")
    faultinject.reset()
    ff = _build(ckpt_dir=tmp_path / "ov", epochs=4,
                native_dataloader=False)
    ff.fit(verbose=False)
    assert ff._step_count == 5 and ff.last_fit_status == "preempted"
    meta = load_meta(str(tmp_path / "ov"), 5)
    assert meta["reason"] == "preempt"
    # 5 batches of 16 over 64 samples: the sync loop's cursor, wrapped
    assert meta["dataloaders"] == {"x": 16, "label": 16}
    monkeypatch.delenv("FF_FAULT")
    faultinject.reset()
    ff2 = _build(ckpt_dir=tmp_path / "ov", epochs=4,
                 native_dataloader=False)
    ff2.fit(verbose=False)
    assert ff2._step_count == 16
    ref = _build(epochs=4, prefetch_depth=0, native_dataloader=False)
    ref.fit(verbose=False)
    for op, ws in _weights(ref).items():
        for w, a in ws.items():
            np.testing.assert_array_equal(ff2.get_weights(op, w), a)


def test_periodic_checkpoint_mid_prefetch_records_sync_cursor(tmp_path):
    ff = _build(ckpt_dir=tmp_path, checkpoint_every=3,
                native_dataloader=False)
    ff.fit(verbose=False)
    meta = load_meta(str(tmp_path), 7)
    assert meta["step"] == 7
    assert meta["dataloaders"] == {"x": 48, "label": 48}
    assert latest_step(str(tmp_path)) == 8


# ------------------------------------------------- faults in the worker


def test_io_fail_in_worker_keeps_the_order(monkeypatch):
    monkeypatch.setenv("FF_FAULT", "io_fail@loader:3")
    faultinject.reset()
    ff = _build(native_dataloader=False)
    ff.fit(verbose=False)
    assert resilience.COUNTERS["retries"] >= 1
    assert ff._step_count == 8
    monkeypatch.delenv("FF_FAULT")
    faultinject.reset()
    ref = _build(prefetch_depth=0, native_dataloader=False)
    ref.fit(verbose=False)
    np.testing.assert_array_equal(ff.get_weights("fc1"),
                                  ref.get_weights("fc1"))


def test_io_fail_exhausted_fails_fit(monkeypatch):
    monkeypatch.setenv("FF_FAULT", "io_fail@loader:2-5")
    faultinject.reset()
    ff = _build(native_dataloader=False)
    with pytest.raises(RuntimeError, match="prefetch worker died"):
        ff.fit(verbose=False)
    assert ff._pipeline is None


# ----------------------------------------------------- the data budget


def test_budget_sends_an_over_budget_dataset_to_the_host():
    xs, ys = _data()
    # within the default budget: staged on the device, one copy
    ff = _build(device_resident_data=True, native_dataloader=False)
    ff.fit(verbose=False)
    assert all(dl._dev_data is not None for dl in ff._dataloaders)
    assert ff.last_step_breakdown is not None
    assert not ff.last_step_breakdown["overlap"]
    # a budget below the input array's bytes: host path, overlapped
    ff2 = _build(device_resident_data=True, native_dataloader=False,
                 device_data_budget_bytes=xs.nbytes - 1)
    ls = _record(ff2)
    assert all(dl._dev_data is None and dl._dev_failed
               for dl in ff2._dataloaders)
    assert ff2.last_step_breakdown["overlap"]
    assert ls == _record(_build(native_dataloader=False, prefetch_depth=0))
    # shuffling is host-only, whatever the budget
    ff3 = _build(device_resident_data=True, dataloader_shuffle=True,
                 native_dataloader=False)
    assert not any(dl.device_eligible() for dl in ff3._dataloaders)
    # a host batch is numpy until shard_batch; a device tensor passes
    b = ff2._stage_batch()
    assert isinstance(b["x"], np.ndarray)
    on_dev = ff2.executor.shard_batch(b)
    assert isinstance(on_dev["x"], torch.Tensor)
    assert ff2.executor.shard_batch(on_dev)["x"] is on_dev["x"]


def test_config_validation():
    with pytest.raises(ValueError):
        FFConfig(prefetch_depth=-1)
    with pytest.raises(ValueError):
        FFConfig(dispatch_ahead=-1)
    cfg, jcfg = FFConfig(), JConfig()
    for k in ("native_dataloader", "dataloader_shuffle",
              "dataloader_threads", "dataloader_prefetch_slots",
              "profiling", "metrics_ignore_index", "device_resident_data",
              "device_data_budget_bytes", "prefetch_depth",
              "dispatch_ahead"):
        assert getattr(cfg, k) == getattr(jcfg, k), k


class _Recorder:
    def __init__(self, stop_at=None):
        self.calls = []
        self.stop_at = stop_at

    def set_model(self, model):
        self.calls.append("set_model")

    def on_train_begin(self):
        self.calls.append("train_begin")

    def on_epoch_begin(self, epoch):
        self.calls.append(f"epoch_begin {epoch}")

    def on_epoch_end(self, epoch):
        self.calls.append(f"epoch_end {epoch}")
        return epoch == self.stop_at

    def on_train_end(self):
        self.calls.append("train_end")


def test_callbacks_and_early_stop():
    ff = _build(epochs=3, native_dataloader=False)
    cb = _Recorder(stop_at=0)
    ff.fit(verbose=False, callbacks=[cb])
    assert cb.calls == ["set_model", "train_begin", "epoch_begin 0",
                        "epoch_end 0", "train_end"]
    assert ff._step_count == 4


# ---------------------------------------------- fault 8: the pad mask

VOCAB, SEQ, LM_N = 128, 6, 32


def _lm_data():
    rs = np.random.RandomState(5)
    tok = rs.randint(0, VOCAB, (LM_N, SEQ)).astype(np.int32)
    lab = rs.randint(0, VOCAB, (LM_N, SEQ, 1)).astype(np.int32)
    for i, n in enumerate(rs.randint(1, SEQ + 1, LM_N)):
        lab[i, n:] = -100           # labels past each row's length
    return tok, lab


def _lm(pkg, **cfg):
    jax_side = pkg == "jax"
    Conf, Model = (JConfig, JModel) if jax_side else (FFConfig, FFModel)
    DT = JDataType if jax_side else DataType
    kw = dict(batch_size=8, epochs=1, seed=4, metrics_ignore_index=-100,
              **cfg)
    if jax_side:
        ff = Model(Conf(mesh_shape={"data": 1}, **kw))
    else:
        ff = Model(Conf(**kw), device="cpu")
    tok = ff.create_tensor([8, SEQ], DT.DT_INT32, name="tok")
    h = ff.embedding(tok, VOCAB, 16, name="emb")
    ff.dense(h, VOCAB, name="head")
    ff.compile((JSGD if jax_side else SGDOptimizer)(lr=0.5),
               (JLoss if jax_side else LossType)
               .LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [(JMetrics if jax_side else MetricsType).METRICS_ACCURACY])
    return ff, tok


def _lm_counts(ff, tok, loader, scan=False):
    xs, ys = _lm_data()
    loader(ff, tok, xs)
    loader(ff, ff.label_tensor, ys)
    steps = []
    orig = ff._run_train_step

    def rec(batch, **kw):
        loss, mets = orig(batch, **kw)
        steps.append((int(mets["accuracy_count"]),
                      int(mets["accuracy_total"])))
        return loss, mets

    ff._run_train_step = rec
    try:
        perf = ff.fit(verbose=False, epochs=2)
    finally:
        ff._run_train_step = orig
    return steps, (perf.train_correct, perf.train_pred_total)


@pytest.mark.parametrize("scan", [0, 2])
def test_metrics_ignore_index_counts_equal_jax(scan):
    jff, jtok = _lm("jax", scan_steps=scan)
    tff, ttok = _lm("port", scan_steps=scan)
    for op, ws in jff.params.items():
        for w, a in ws.items():
            tff.set_weights(op, w, np.asarray(a))
    jsteps, jperf = _lm_counts(jff, jtok, JLoader)
    tsteps, tperf = _lm_counts(tff, ttok, SingleDataLoader)
    assert tperf == jperf
    _, lab = _lm_data()
    live = int((lab != -100).sum())
    assert tperf[1] == live    # the last epoch's denominator: live labels
    if not scan:
        assert tsteps == jsteps and len(tsteps) == 8
        assert sum(t for _, t in tsteps) == 2 * live


def test_ignore_index_off_counts_every_position():
    from flexflow_tpu_torch.runtime.metrics import batch_metrics

    logits = torch.eye(4)[None]
    labels = torch.tensor([[0, 1, 9, 9]])
    acc = [MetricsType.METRICS_ACCURACY]
    sparse = LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
    m = batch_metrics(sparse, acc, logits, labels, ignore_index=9)
    assert int(m["accuracy_count"]) == 2 and int(m["accuracy_total"]) == 2
    m2 = batch_metrics(sparse, acc, logits, labels)
    assert int(m2["accuracy_total"]) == 4
