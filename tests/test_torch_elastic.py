"""The port's elastic resume policy (``runtime/elastic.py``) against the
JAX package's, in one process.

The compile-time hook reads only a checkpoint's ``ff_meta.json``, its
manifest and its strategy table, whose formats the packages share, so the
port's hook is held on directories the JAX package writes: a one-device
checkpoint resumes as it is (the same decision as JAX's), a four-device
one refits onto this process's one device under "resume_resharded" (the
same decision as JAX's onto ``{"data": 1}``: grad accumulation scaled to
keep the global batch), and is refused under "abort" (JAX refuses its
two-device resume the same way) and below ``elastic_min_devices``;
"research" raises ``NotImplementedError`` naming ROADMAP item 10 (the cost
model), as does the ``shrink@resume`` drill. ``mesh_candidates`` and the
config validation equal JAX's; a same-topology restart adopts the saved
accumulation factor in both packages. Resumes across ranks:
``tests/test_torch_mesh_checkpoint.py``.
"""

import os

import numpy as np
import pytest
import torch

from flexflow_tpu import ActiMode as JActi
from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import LossType as JLoss
from flexflow_tpu import MetricsType as JMetrics
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu import SingleDataLoader as JLoader
from flexflow_tpu import TrainSupervisor as JSupervisor
from flexflow_tpu.runtime import faultinject as j_faultinject
from flexflow_tpu.runtime.elastic import TopologyChangedError as JTopo
from flexflow_tpu.runtime.elastic import mesh_candidates as j_candidates
from flexflow_tpu_torch import (ActiMode, FFConfig, FFModel, LossType,
                                MetricsType, SGDOptimizer, SingleDataLoader)
from flexflow_tpu_torch.runtime import faultinject
from flexflow_tpu_torch.runtime.elastic import (TopologyChangedError,
                                                mesh_candidates,
                                                visible_device_count)
from flexflow_tpu_torch.runtime.resilience import TrainSupervisor


@pytest.fixture(autouse=True)
def _faults(monkeypatch):
    monkeypatch.delenv("FF_FAULT", raising=False)
    faultinject.reset()
    j_faultinject.reset()
    yield
    faultinject.reset()
    j_faultinject.reset()


def _data(n=64):
    rs = np.random.RandomState(7)
    return (rs.randn(n, 8).astype(np.float32),
            rs.randint(0, 4, (n, 1)).astype(np.int32))


def _cfg(ckpt_dir, policy, accum, min_devices):
    return dict(batch_size=16, epochs=1, seed=3,
                checkpoint_dir=str(ckpt_dir), on_topology_change=policy,
                grad_accum_steps=accum, elastic_min_devices=min_devices)


def _jax(ckpt_dir, *, mesh, policy="resume_resharded", accum=1,
         min_devices=1):
    ff = JModel(JConfig(mesh_shape=dict(mesh),
                        **_cfg(ckpt_dir, policy, accum, min_devices)))
    x = ff.create_tensor([16, 8], name="x")
    t = ff.dense(x, 16, JActi.AC_MODE_RELU, name="fc1")
    ff.dense(t, 4, name="out")
    ff.compile(JSGD(lr=0.1), JLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [JMetrics.METRICS_ACCURACY])
    xs, ys = _data()
    JLoader(ff, x, xs)
    JLoader(ff, ff.label_tensor, ys)
    return ff


def _port(ckpt_dir, *, policy="resume_resharded", accum=1, min_devices=1):
    ff = FFModel(FFConfig(**_cfg(ckpt_dir, policy, accum, min_devices)),
                 device="cpu")
    x = ff.create_tensor([16, 8], name="x")
    t = ff.dense(x, 16, ActiMode.AC_MODE_RELU, name="fc1")
    ff.dense(t, 4, name="out")
    ff.compile(SGDOptimizer(lr=0.1),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY])
    xs, ys = _data()
    SingleDataLoader(ff, x, xs)
    SingleDataLoader(ff, ff.label_tensor, ys)
    return ff


def _decision(d):
    return {k: getattr(d, k) for k in (
        "policy", "step", "saved_mesh", "new_mesh", "changed",
        "saved_grad_accum", "grad_accum", "strategy_source")}


def test_mesh_candidates_equal_jax():
    for saved, n in (({"data": 4, "model": 2}, 4), ({"data": 8}, 3),
                     ({"data": 2, "model": 2, "pipe": 2}, 8), ({}, 6),
                     ({"data": 1}, 1)):
        assert mesh_candidates(saved, n) == j_candidates(saved, n)
    cands = mesh_candidates({"data": 4, "model": 2}, 4)
    assert {"data": 2, "model": 2} in cands
    assert all(list(c) == ["data", "model"] for c in cands)


def test_config_validation_equal_jax():
    for kw, match in ((dict(on_topology_change="panic"),
                       "on_topology_change"),
                      (dict(elastic_min_devices=0), "elastic_min_devices"),
                      (dict(checkpoint_every=-1), "checkpoint_every"),
                      (dict(nonfinite_rewind_after=-1),
                       "nonfinite_rewind_after")):
        with pytest.raises(ValueError, match=match):
            FFConfig(**kw)
        with pytest.raises(ValueError, match=match):
            JConfig(**kw)
    jc, tc = JConfig(), FFConfig()
    for knob in ("checkpoint_dir", "checkpoint_every", "keep_checkpoints",
                 "async_checkpointing", "nonfinite_rewind_after",
                 "step_timeout_s", "verify_checkpoints",
                 "on_topology_change", "elastic_min_devices",
                 "slo_step_time_p99_s", "slo_checkpoint_stall_s"):
        assert getattr(tc, knob) == getattr(jc, knob), knob
    # the training SLOs are accepted
    cfg = FFConfig(slo_step_time_p99_s=0.5, slo_checkpoint_stall_s=2.0)
    assert cfg.slo_step_time_p99_s == 0.5


def test_single_device_decision_equals_jax(tmp_path):
    """A one-device checkpoint (the port's own, or JAX's on {data: 1})
    resumes as it is: the port's decision equals JAX's on the same dir,
    and the port's own checkpoint gives the same decision."""
    jd, td = tmp_path / "jax", tmp_path / "port"
    assert JSupervisor(_jax(jd, mesh={"data": 1}), str(jd)).run(2) \
        == "completed"
    jdec = _jax(jd, mesh={"data": 1})._elastic
    assert not jdec.changed
    tdec = _port(jd)._elastic      # the hook reads JAX's meta + manifest
    assert _decision(tdec) == _decision(jdec)
    assert TrainSupervisor(_port(td), str(td)).run(2) == "completed"
    ff = _port(td)
    assert _decision(ff._elastic) == _decision(jdec)
    assert ff._elastic_verified_step == 2
    assert TrainSupervisor(ff, str(td)).resume() == 2
    assert visible_device_count() >= 1


def test_same_topology_restart_adopts_saved_accum(tmp_path):
    jd, td = tmp_path / "jax", tmp_path / "port"
    JSupervisor(_jax(jd, mesh={"data": 1}, accum=2), str(jd)).run(2)
    TrainSupervisor(_port(td, accum=2), str(td)).run(2)
    jff = _jax(jd, mesh={"data": 1})
    tff = _port(td)
    assert tff.config.grad_accum_steps == jff.config.grad_accum_steps == 2
    assert tff._elastic.grad_accum == jff._elastic.grad_accum == 2
    assert TrainSupervisor(tff, str(td)).resume() == 2


def test_more_devices_abort_and_min_devices(tmp_path):
    """A checkpoint saved on four devices: "abort" and
    elastic_min_devices refuse in both packages (JAX resuming on two
    devices, the port on its one)."""
    jd = tmp_path / "jax4"
    JSupervisor(_jax(jd, mesh={"data": 4}), str(jd)).run(2)
    with pytest.raises(JTopo, match="abort"):
        _jax(jd, mesh={"data": 2}, policy="abort")
    with pytest.raises(TopologyChangedError, match="abort"):
        _port(jd, policy="abort")
    with pytest.raises(JTopo, match="elastic_min_devices"):
        _jax(jd, mesh={"data": 2}, min_devices=4)
    with pytest.raises(TopologyChangedError, match="elastic_min_devices"):
        _port(jd, min_devices=4)


@pytest.mark.parametrize("policy", ["resume_resharded", "research"])
def test_refit_policies_name_item_8(tmp_path, policy):
    """A checkpoint of four devices resumed in one process:
    "resume_resharded" refits as JAX does onto {"data": 1} (the same
    decision: changed, grad_accum_steps 1 -> 4, the global batch kept);
    "research" re-searches with the cost model, ROADMAP item 10 — from
    the compile hook and from a supervisor pointed there by hand."""
    jd = tmp_path / "jax4"
    JSupervisor(_jax(jd, mesh={"data": 4}), str(jd)).run(2)
    if policy == "resume_resharded":
        jff = _jax(jd, mesh={"data": 1})
        tff = _port(jd, policy=policy)
        assert tff._elastic.changed
        assert _decision(tff._elastic) == _decision(jff._elastic)
        assert tff.config.grad_accum_steps == \
            jff.config.grad_accum_steps == 4
        return
    with pytest.raises(NotImplementedError, match="item 10"):
        _port(jd, policy=policy)
    # a supervisor pointed there by hand refuses the same way
    ff = _port(tmp_path / "empty", policy=policy)
    with pytest.raises(NotImplementedError, match="item 10"):
        TrainSupervisor(ff, str(jd)).resume()


def test_shrink_drill_refused(tmp_path, monkeypatch):
    td = tmp_path / "port"
    TrainSupervisor(_port(td), str(td)).run(2)
    monkeypatch.setenv("FF_FAULT", "shrink(2)@resume:1")
    faultinject.reset()
    with pytest.raises(NotImplementedError, match="item 10"):
        _port(td)
    assert os.path.isdir(td / "step_2")


def test_fresh_directory_no_decision(tmp_path):
    ff = _port(tmp_path / "nothing")
    assert ff._elastic is None
    assert torch.equal(ff.opt_state["t"], torch.zeros((), dtype=torch.int32))
