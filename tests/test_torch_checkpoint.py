"""The port's checkpoints (``runtime/checkpoint.py``) against the JAX
package's: the directory protocol, the manifest, the fallbacks, the async
publisher, and resumed training.

The model is JAX's checkpoint-test MLP (8 -> 16 relu -> 4, batch 16) built
in both packages with JAX's initial weights carried into the port; a
second port model adds a dropout op and the fused optimizer, so the
generator states and the flat optimizer buckets ride the payload. f32 on
the CPU. Held:

  * the step dirs, the files beside them, retention, and the
    ``ff_meta.json`` keys equal JAX's for the same model and step, apart
    from JAX's ``rng_key`` (the port records ``generators`` instead);
  * the manifest round trip, corruption detected, a corrupt newest step
    falling back to the previous intact one, raced damage reclassified,
    retention keeping the last intact step, unreadable meta skipped;
  * the async publisher's order, backpressure and re-raised failure;
    ``io_fail`` retried at save and load;
  * the ``opt_layout`` guard;
  * save at step 3 -> restore into a fresh model -> 3 more steps is
    bitwise the uninterrupted run (weights, optimizer state, generators),
    and within 1e-5 of JAX's same sequence (losses and weights).
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from flexflow_tpu import ActiMode as JActi
from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import LossType as JLoss
from flexflow_tpu import MetricsType as JMetrics
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.runtime import checkpoint as jckpt
from flexflow_tpu.runtime import faultinject as j_faultinject
from flexflow_tpu_torch import (ActiMode, FFConfig, FFModel, LossType,
                                MetricsType, SGDOptimizer)
from flexflow_tpu_torch.runtime import checkpoint as ckpt
from flexflow_tpu_torch.runtime import faultinject, resilience
from flexflow_tpu_torch.runtime.manifest import CheckpointCorruptError

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _faults(monkeypatch):
    monkeypatch.delenv("FF_FAULT", raising=False)
    faultinject.reset()
    j_faultinject.reset()
    resilience.reset_counters()
    yield
    ckpt.wait_pending_saves()
    faultinject.reset()
    j_faultinject.reset()


def _arm(monkeypatch, spec):
    monkeypatch.setenv("FF_FAULT", spec)
    faultinject.reset()
    j_faultinject.reset()


def _batch(i):
    rs = np.random.RandomState(100 + i)
    return {"x": rs.randn(16, 8).astype(np.float32),
            "label": rs.randint(0, 4, (16, 1)).astype(np.int32)}


def _jax(momentum=0.9):
    ff = JModel(JConfig(batch_size=16, mesh_shape={"data": 1}, seed=3))
    x = ff.create_tensor([16, 8], name="x")
    t = ff.dense(x, 16, JActi.AC_MODE_RELU, name="fc1")
    ff.dense(t, 4, name="out")
    ff.compile(JSGD(lr=0.1, momentum=momentum),
               JLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [JMetrics.METRICS_ACCURACY])
    return ff


_INIT = {}


def _port(momentum=0.9, dropout=False, fused=False, seed=3):
    """The MLP in the port with JAX's initial weights; ``dropout`` puts a
    dropout op (its own generator) after fc1."""
    if not _INIT:
        _INIT.update({op: {w: np.array(a) for w, a in ws.items()}
                      for op, ws in _jax().params.items()})
    ff = FFModel(FFConfig(batch_size=16, seed=seed,
                          fused_optimizer=fused), device="cpu")
    x = ff.create_tensor([16, 8], name="x")
    t = ff.dense(x, 16, ActiMode.AC_MODE_RELU, name="fc1")
    if dropout:
        t = ff.dropout(t, 0.3, name="drop")
    ff.dense(t, 4, name="out")
    ff.compile(SGDOptimizer(lr=0.1, momentum=momentum),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY])
    for op, ws in _INIT.items():
        for w, a in ws.items():
            ff.set_weights(op, w, a)
    return ff


def _assert_same_state(a, b):
    sa, sb = ckpt.state_tensors(a), ckpt.state_tensors(b)
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for name, g in a._generators.items():
        assert torch.equal(g.get_state(), b._generators[name].get_state())


# ------------------------------------------------------------ the layout


def test_layout_retention_and_meta_keys_equal_jax(tmp_path):
    jff, tff = _jax(), _port()
    for i in range(4):
        jff._run_train_step(_batch(i))
        tff._run_train_step(_batch(i))
        jckpt.save_checkpoint(jff, str(tmp_path / "jax"), keep=2,
                              extra_meta={"reason": "test"})
        ckpt.save_checkpoint(tff, str(tmp_path / "port"), keep=2,
                             extra_meta={"reason": "test"})
    jd, td = tmp_path / "jax", tmp_path / "port"
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd)) == \
        ["meta.json", "step_3", "step_4", "strategy.txt"]
    jfiles = set(os.listdir(jd / "step_4"))
    tfiles = set(os.listdir(td / "step_4"))
    common = {"ff_meta.json", "ff_manifest.json", "strategy.txt"}
    assert common <= jfiles and tfiles == common | {ckpt.PAYLOAD_NAME}
    jm, tm = ckpt.load_meta(str(jd), 4), ckpt.load_meta(str(td), 4)
    assert set(tm) - {"generators"} == set(jm) - {"rng_key"}
    for k in ("step", "batch_size", "grad_accum_steps", "multihost",
              "loss_type", "opt_layout", "reason", "num_devices",
              "process_count"):
        assert tm[k] == jm[k], k
    assert tm["mesh_shape"] is None and tm["generators"] == []
    assert json.loads((td / "meta.json").read_text()) == tm
    assert ckpt.latest_step(str(td)) == jckpt.latest_step(str(jd)) == 4
    # a tmp dir of a killed save is no checkpoint
    (td / ".tmp-step_9").mkdir()
    assert ckpt.latest_step(str(td)) == 4
    assert ckpt.intact_steps(str(td)) == jckpt.intact_steps(str(jd))


def test_payload_names_and_dtypes(tmp_path):
    ff = _port(dropout=True, fused=True)
    ff._run_train_step(_batch(0))
    ckpt.save_checkpoint(ff, str(tmp_path))
    payload = ckpt.load_payload(str(tmp_path / "step_1"))
    groups = {n.split("/")[0] for n in payload}
    assert groups == {"params", "opt_state", "generators"}
    assert "params/fc1/kernel" in payload
    assert "generators/drop" in payload
    assert payload["generators/drop"].dtype == torch.uint8
    assert ckpt.load_meta(str(tmp_path), 1)["generators"] == ["drop"]
    assert ckpt.load_meta(str(tmp_path), 1)["opt_layout"] == "fused"
    assert all(v.device.type == "cpu" for v in payload.values())


# ------------------------------------------------------------ integrity


def test_manifest_roundtrip_and_corruption(tmp_path, monkeypatch):
    ff = _port()
    ff._run_train_step(_batch(0))
    ckpt.save_checkpoint(ff, str(tmp_path), step=1)
    ckpt.verify_checkpoint(str(tmp_path), 1)
    assert ckpt.verify_step(str(tmp_path), 1)
    _arm(monkeypatch, "corrupt_ckpt@save:1")
    ckpt.save_checkpoint(ff, str(tmp_path), step=2)
    with pytest.raises(CheckpointCorruptError, match="hash mismatch"):
        ckpt.verify_checkpoint(str(tmp_path), 2)
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert ckpt.latest_intact_step(str(tmp_path)) == 1
    # restore with step=None falls back to the intact step
    fresh = _port()
    assert ckpt.restore_checkpoint(fresh, str(tmp_path)) == 1
    # and auto_resume likewise
    assert ckpt.auto_resume(_port(), str(tmp_path)) == 1
    # a truncated payload: size mismatch
    with open(tmp_path / "step_1" / ckpt.PAYLOAD_NAME, "r+b") as f:
        f.truncate(10)
    with pytest.raises(CheckpointCorruptError, match="bytes"):
        ckpt.verify_checkpoint(str(tmp_path), 1)
    with pytest.raises(CheckpointCorruptError, match="every checkpoint"):
        ckpt.auto_resume(_port(), str(tmp_path))


def test_unreadable_meta_skipped(tmp_path):
    ff = _port()
    for s in (1, 2):
        ff._run_train_step(_batch(s))
        ckpt.save_checkpoint(ff, str(tmp_path), step=s)
    (tmp_path / "step_2" / "ff_meta.json").write_text("{torn")
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.latest_intact_step(str(tmp_path)) == 1
    assert not ckpt.verify_step(str(tmp_path), 2)
    assert ckpt.has_checkpoints(str(tmp_path))


def test_retention_never_deletes_last_intact(tmp_path, monkeypatch):
    """keep=1 and every later save corrupted: the intact step 1 survives
    beyond the window, as JAX's retention keeps it."""
    ff = _port()
    ff._run_train_step(_batch(0))
    ckpt.save_checkpoint(ff, str(tmp_path), step=1, keep=1)
    _arm(monkeypatch, "corrupt_ckpt@save:1-2")
    for s in (2, 3):
        ff._run_train_step(_batch(s))
        ckpt.save_checkpoint(ff, str(tmp_path), step=s, keep=1)
    steps = sorted(ckpt._step_dirs(str(tmp_path)))
    assert 1 in steps and 3 in steps and 2 not in steps
    assert ckpt.latest_intact_step(str(tmp_path)) == 1


def test_raced_damage_reclassified(tmp_path, monkeypatch):
    """A restore that fails mid-read over a step that no longer verifies
    becomes CheckpointCorruptError (the resume fallbacks' exception); one
    over an intact step propagates as it is."""
    ff = _port()
    ff._run_train_step(_batch(0))
    ckpt.save_checkpoint(ff, str(tmp_path), step=1)
    ff._run_train_step(_batch(1))
    ckpt.save_checkpoint(ff, str(tmp_path), step=2)
    real = ckpt._restore_into

    def racing(model, directory, step):
        if step == 2:   # damage lands after the caller's hash pass
            ckpt._inject_corruption(os.path.join(directory, "step_2"))
            raise RuntimeError("unpickling failed")
        return real(model, directory, step)

    monkeypatch.setattr(ckpt, "_restore_into", racing)
    with pytest.raises(CheckpointCorruptError, match="mid-restore"):
        ckpt.restore_checkpoint(_port(), str(tmp_path), step=2,
                                verify=False)
    # the resume policy falls back past it
    assert ckpt.auto_resume(_port(), str(tmp_path)) == 1
    monkeypatch.setattr(ckpt, "_restore_into",
                        lambda *a: (_ for _ in ()).throw(KeyError("bug")))
    with pytest.raises(KeyError):
        ckpt.restore_checkpoint(_port(), str(tmp_path), step=1)


# ------------------------------------------------------------ async + retry


def test_async_saves_publish_in_order_with_backpressure(tmp_path,
                                                        monkeypatch):
    ff = _port()
    gate = threading.Event()
    order, inflight = [], []
    real = ckpt._publish_step

    def slow_publish(directory, step, state, meta, keep):
        inflight.append(ckpt.pending_saves(directory))
        gate.wait(10)
        order.append(step)
        real(directory, step, state, meta, keep)

    monkeypatch.setattr(ckpt, "_publish_step", slow_publish)
    ff._run_train_step(_batch(0))
    ckpt.save_checkpoint(ff, str(tmp_path), step=1, async_save=True)
    ff._run_train_step(_batch(1))
    ckpt.save_checkpoint(ff, str(tmp_path), step=2, async_save=True)
    assert ckpt.pending_saves(str(tmp_path)) == 2
    # a third submission blocks while two are pending (backpressure)
    done = threading.Event()

    def third():
        ckpt.save_checkpoint(ff, str(tmp_path), step=3, async_save=True)
        done.set()

    th = threading.Thread(target=third)
    th.start()
    time.sleep(0.2)
    assert not done.is_set()
    gate.set()
    th.join(10)
    assert done.is_set()
    ckpt.wait_pending_saves(str(tmp_path))
    assert order == [1, 2, 3]
    assert sorted(ckpt._step_dirs(str(tmp_path))) == [1, 2, 3]
    # each snapshot is taken at submission: step 3 holds the last weights
    want = ckpt.load_payload(str(tmp_path / "step_3"))
    for k, v in ckpt.state_tensors(ff).items():
        assert torch.equal(want[k], v), k


def test_async_failure_reraised_at_wait(tmp_path, monkeypatch):
    ff = _port()
    _arm(monkeypatch, "io_fail@save:1-3")
    ckpt.save_checkpoint(ff, str(tmp_path), step=1, async_save=True)
    with pytest.raises(RuntimeError, match="async checkpoint save of step 1"):
        ckpt.wait_pending_saves(str(tmp_path))
    ckpt.wait_pending_saves(str(tmp_path))   # consumed: no second raise
    assert ckpt.latest_step(str(tmp_path)) is None


def test_io_fail_retried_at_save_and_load(tmp_path, monkeypatch):
    ff = _port()
    ff._run_train_step(_batch(0))
    _arm(monkeypatch, "io_fail@save:1,io_fail@load:1")
    ckpt.save_checkpoint(ff, str(tmp_path), step=1)
    assert resilience.COUNTERS["retries"] == 1
    fresh = _port()
    ckpt.restore_checkpoint(fresh, str(tmp_path), step=1)
    assert resilience.COUNTERS["retries"] == 2
    _assert_same_state(fresh, ff)


# ------------------------------------------------------------ restore


def test_opt_layout_mismatch_refused(tmp_path):
    ff = _port(fused=True)
    ckpt.save_checkpoint(ff, str(tmp_path), step=1)
    with pytest.raises(ValueError, match="'fused' layout"):
        ckpt.restore_checkpoint(_port(), str(tmp_path), step=1)
    # the JAX package refuses the same way
    jff = _jax()
    jckpt.save_checkpoint(jff, str(tmp_path / "j"), step=1)
    meta = jckpt.load_meta(str(tmp_path / "j"), 1)
    assert meta["opt_layout"] == "per_leaf" == ckpt._opt_layout(_port())


@pytest.mark.parametrize("variant", ["sgd_momentum", "dropout_fused"])
def test_resume_bitwise_uninterrupted(tmp_path, variant):
    """Save at 3, restore into a fresh model (other seed), 3 more steps:
    bitwise the uninterrupted 6 — weights, optimizer state, generators."""
    kw = dict(dropout=True, fused=True) if variant == "dropout_fused" \
        else {}
    ref = _port(**kw)
    a = _port(**kw)
    losses_ref, losses = [], []
    for i in range(6):
        losses_ref.append(float(ref._run_train_step(_batch(i))[0]))
    for i in range(3):
        losses.append(float(a._run_train_step(_batch(i))[0]))
    ckpt.save_checkpoint(a, str(tmp_path))
    b = _port(seed=11, **kw)
    assert ckpt.restore_checkpoint(b, str(tmp_path)) == 3
    assert b._step_count == 3
    for i in range(3, 6):
        losses.append(float(b._run_train_step(_batch(i))[0]))
    assert losses == losses_ref
    _assert_same_state(b, ref)


def test_resume_matches_jax_sequence(tmp_path):
    """The same save-at-3 / restore / 3-more sequence in both packages:
    losses and weights within 1e-5."""
    out = {}
    for pkg in ("jax", "port"):
        build = _jax if pkg == "jax" else _port
        mod = jckpt if pkg == "jax" else ckpt
        d = str(tmp_path / pkg)
        a = build()
        losses = [float(a._run_train_step(_batch(i))[0]) for i in range(3)]
        mod.save_checkpoint(a, d)
        b = build()
        assert mod.restore_checkpoint(b, d) == 3
        losses += [float(b._run_train_step(_batch(i))[0])
                   for i in range(3, 6)]
        out[pkg] = (losses, {op: np.asarray(b.get_weights(op, w))
                             for op, w in (("fc1", "kernel"),
                                           ("out", "kernel"))})
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=RTOL,
                               atol=RTOL)
    for op in out["jax"][1]:
        np.testing.assert_allclose(out["port"][1][op], out["jax"][1][op],
                                   rtol=RTOL, atol=RTOL)


def test_restore_is_in_place_and_refuses_misshapen(tmp_path):
    ff = _port()
    ff._run_train_step(_batch(0))
    ckpt.save_checkpoint(ff, str(tmp_path), step=1)
    b = _port()
    ptrs = {k: v.data_ptr() for k, v in ckpt.state_tensors(b).items()}
    ckpt.restore_checkpoint(b, str(tmp_path), step=1)
    assert {k: v.data_ptr() for k, v in ckpt.state_tensors(b).items()} \
        == ptrs
    other = FFModel(FFConfig(batch_size=16), device="cpu")
    x = other.create_tensor([16, 8], name="x")
    other.dense(other.dense(x, 32, name="fc1"), 4, name="out")
    other.compile(SGDOptimizer(lr=0.1, momentum=0.9))
    with pytest.raises(ValueError, match="fc1"):
        ckpt.restore_checkpoint(other, str(tmp_path), step=1)
    with pytest.raises(ValueError, match="do not cross packages"):
        ckpt.load_payload(str(tmp_path))
