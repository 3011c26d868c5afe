"""Checkpoints from every rank, restores onto another mesh, and the elastic
resume onto fewer ranks, against the JAX package's flows.

Gloo ranks (``tests/torch_ckpt_worker.py``, started through the port's
launcher, each spawn bounded by ``SPAWN_TIMEOUT``) run:

  * JAX's ``test_checkpoint_restore_then_generate`` flow (a 2-layer
    ``llama_lm``, hidden 64, 4 heads over 2 kv heads, vocab 97, batch 4,
    seq 8, momentum SGD): 3 steps on 2 ranks under ``{"data": 2}`` with
    FSDP over "data", a save from every rank (and an async save of the
    same state), ``generate``; then a fresh model on the same ranks under
    ``{"data": 1, "model": 2}`` (the head table) restores it and
    generates; this process restores it once more into a model without a
    mesh;
  * JAX's ``test_resume_resharded_onto_fewer_devices``: 4 supervised steps
    of the two-layer MLP on 4 ranks under ``{"data": 4}``, then on 2 ranks
    under ``{"data": 2}``: "abort" and ``elastic_min_devices=4`` refuse,
    "resume_resharded" doubles ``grad_accum_steps`` (the global batch of
    16 kept), restores and trains on to step 16.

The JAX side runs in this process on the conftest's CPU devices, the
weights numpy draws (``numpy_init``) set into the port's models. Limits,
f32: restored weights and FSDP optimizer state bitwise the saved ones;
tokens identical to JAX's; losses within 1e-5 of JAX's.
"""

import json
import os
import sys

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
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu.runtime import faultinject as j_faultinject
from flexflow_tpu.runtime import resilience as j_resilience
from test_torch_zoo import numpy_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ckpt_worker.py")
SPAWN_TIMEOUT = 240
TOL = dict(rtol=1e-5, atol=1e-5)

sys.path.insert(0, os.path.dirname(WORKER))
import torch_ckpt_worker as worker  # noqa: E402
import torch_ranks  # noqa: E402


def _np_params(jff):
    return {f"{op}.{w}": np.asarray(a) for op, ws in jff.params.items()
            for w, a in ws.items()}


def _jax_llama(mesh):
    ff = JModel(JConfig(batch_size=4, mesh_shape=dict(mesh)))
    _, logits = j_llama_lm(ff, 4, **worker.LLAMA)
    ff.compile(JSGD(lr=worker.LR, momentum=worker.MOMENTUM),
               JLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [JMetrics.METRICS_ACCURACY], final_tensor=logits)
    return ff


def _jax_mlp(ckpt, mesh, data):
    """JAX's ``tests/test_elastic.py`` ``_build``."""
    ff = JModel(JConfig(batch_size=16, epochs=1, seed=3,
                        checkpoint_dir=str(ckpt), mesh_shape=dict(mesh),
                        on_topology_change="resume_resharded"))
    x = ff.create_tensor([16, 8], name="x")
    t = ff.dense(x, 16, JActi.AC_MODE_RELU, name="fc1")
    ff.dense(t, 4, name="out")
    ff.compile(JSGD(lr=0.1), JLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [JMetrics.METRICS_ACCURACY])
    JLoader(ff, x, data["mx"])
    JLoader(ff, ff.label_tensor, data["my"])
    return ff


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The ranks' records by scenario, JAX's numbers, and the directory."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    d = str(tmp_path_factory.mktemp("torch_ckpt"))
    rs = np.random.RandomState(29)
    r7 = np.random.RandomState(7)
    data = dict(tokens=rs.randint(0, 97, (4, 8)).astype(np.int32),
                labels=rs.randint(0, 97, (4, 8, 1)).astype(np.int32),
                prompt=rs.randint(0, 97, (2, 5)).astype(np.int32),
                mx=r7.randn(64, 8).astype(np.float32),
                my=r7.randint(0, 4, (64, 1)).astype(np.int32))
    np.savez(os.path.join(d, "data.npz"), **data)
    procs = []
    mp = pytest.MonkeyPatch()
    mp.delenv("FF_FAULT", raising=False)
    j_faultinject.reset()
    jax = {}
    try:
        numpy_init(mp)
        jl = _jax_llama({"data": 2})
        np.savez(os.path.join(d, "llama.npz"), **_np_params(jl))
        ja = _jax_mlp(os.path.join(d, "jax_elastic"), {"data": 4}, data)
        np.savez(os.path.join(d, "mlp.npz"), **_np_params(ja))
        procs = torch_ranks.spawn(WORKER, d, 4, "save4")
        batch = {"input": data["tokens"], "label": data["labels"]}
        jax["losses"] = [float(jl._run_train_step(batch)[0])
                         for _ in range(3)]
        jax["tokens"] = jl.generate(data["prompt"], 5)
        j_resilience.reset_counters()
        assert JSupervisor(ja, os.path.join(d, "jax_elastic")).run(4) \
            == "completed"
        jb = _jax_mlp(os.path.join(d, "jax_elastic"), {"data": 2}, data)
        jax["accum"] = jb.config.grad_accum_steps
        sup = JSupervisor(jb, os.path.join(d, "jax_elastic"))
        assert sup.resume() == 4
        assert sup.run(16) == "completed"
        jax["elastic_losses"] = list(sup.losses)
        torch_ranks.wait(procs, "TORCH-CKPT", SPAWN_TIMEOUT)
        procs = torch_ranks.spawn(WORKER, d, 2, "main")
        torch_ranks.wait(procs, "TORCH-CKPT", SPAWN_TIMEOUT)
    finally:
        torch_ranks.kill(procs)
        mp.undo()
        torch.set_num_threads(threads)
    ranks = {}
    for name, world in (("restore", 2), ("elastic4", 4), ("elastic2", 2)):
        ranks[name] = [dict(np.load(os.path.join(d, f"{name}.{r}.npz")))
                       for r in range(world)]
    return ranks, jax, d, data


def _state(recs, prefix):
    return {k[len(prefix):]: v for k, v in recs.items()
            if k.startswith(prefix)}


def test_ranks_train_as_jax(results):
    ranks, jax, _, _ = results
    a, b = (r["losses"] for r in ranks["restore"])
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, jax["losses"], **TOL)


def test_meta_records_the_mesh_under_jax_keys(results):
    _, _, d, _ = results
    with open(os.path.join(d, "ckpt", "step_3", "ff_meta.json")) as f:
        meta = json.load(f)
    assert meta["mesh_shape"] == {"data": 2}
    assert meta["num_devices"] == 2 and meta["process_count"] == 2
    assert meta["multihost"] is True
    assert sorted(os.listdir(os.path.join(d, "ckpt"))) == \
        ["meta.json", "step_3", "strategy.txt"]


def test_restore_onto_another_mesh_is_bitwise(results):
    """The 2-rank save (FSDP-sharded weights and momentum) restores into a
    fresh model under {"data": 1, "model": 2} bitwise, on both ranks."""
    ranks, _, _, _ = results
    for rec in ranks["restore"]:
        saved = _state(rec, "saved/")
        restored = _state(rec, "restored/")
        assert rec["restored_step"] == 3
        assert set(saved) == set(restored)
        assert any(k.startswith("opt_state/") for k in saved)
        for k, v in saved.items():
            np.testing.assert_array_equal(restored[k], v, err_msg=k)
        # the saving model held FSDP shards, the restoring one head shards
        full = saved["params/ffn_gate_0/kernel"].shape
        assert int(np.prod(rec["sharded/fc_fsdp"])) * 2 == int(np.prod(full))
        assert list(rec["sharded/wq_tp"]) == [64, 2, 16]


def test_tokens_after_save_and_restore_equal_jax(results):
    ranks, jax, _, _ = results
    for rec in ranks["restore"]:
        np.testing.assert_array_equal(rec["tokens"], jax["tokens"])
        np.testing.assert_array_equal(rec["tp_tokens"], jax["tokens"])


def test_restore_into_one_process(results):
    """The ranks' checkpoint restores into a model without a mesh in this
    process: weights and optimizer state bitwise, JAX's tokens."""
    from flexflow_tpu_torch.runtime.checkpoint import restore_checkpoint

    ranks, jax, d, data = results
    ff = worker.llama(None, None)
    assert restore_checkpoint(ff, os.path.join(d, "ckpt")) == 3
    got = worker.state(ff)
    for k, v in _state(ranks["restore"][0], "saved/").items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(ff.generate(data["prompt"], 5),
                                  jax["tokens"])


def test_async_save_under_a_mesh_equals_the_sync_save(results):
    from flexflow_tpu_torch.runtime.checkpoint import (load_payload,
                                                       verify_checkpoint)

    _, _, d, _ = results
    verify_checkpoint(os.path.join(d, "ckpt_async"), 3)
    a = load_payload(os.path.join(d, "ckpt", "step_3"))
    b = load_payload(os.path.join(d, "ckpt_async", "step_3"))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_resharded_onto_fewer_ranks_matches_jax(results):
    """{"data": 4} -> {"data": 2}: grad_accum_steps 1 -> 2 (JAX's), the
    resume at step 4 bitwise the 4-rank weights, counted as an elastic
    resume, and the 12 losses after it within 1e-5 of JAX's."""
    ranks, jax, _, _ = results
    saved = _state(ranks["elastic4"][0], "saved/")
    want = jax["elastic_losses"]
    assert len(want) == 12
    for rec in ranks["elastic2"]:
        changed, saved_accum, accum, cfg_accum, d_old, d_new = \
            rec["decision"]
        assert changed and (d_old, d_new) == (4, 2)
        assert accum == cfg_accum == jax["accum"] == 2 and saved_accum == 1
        assert rec["resumed"] == 4 and rec["elastic_resumes"] >= 1
        restored = _state(rec, "restored/")
        for k, v in saved.items():
            if k.startswith("params/"):
                np.testing.assert_array_equal(restored[k], v, err_msg=k)
        assert str(rec["status"]) == "completed"
        np.testing.assert_allclose(rec["losses"], want, **TOL)


def test_abort_and_min_devices_refuse_on_fewer_ranks(results):
    ranks, _, _, _ = results
    for rec in ranks["elastic2"]:
        assert "on_topology_change='abort'" in str(rec["refused/abort"])
        assert "elastic_min_devices=4" in str(rec["refused/min_devices"])
