"""``ShardedFusedUpdate`` in the port (``FFConfig.fused_optimizer`` under a
strategy that shards weights), across gloo ranks: bitwise the per-leaf
update, as JAX's ``tests/test_mfu_levers.py:255`` holds its own; within
1e-5 of the JAX package's same strategy; and the ``sharded_fused``
checkpoint layout — a round trip from every rank, the restore refused
across layouts and across topologies, and a resume from the JAX
package's flat state.

The model is ``tests/torch_zero1_ep_worker.py``'s MLP (16 x 32 -> 64 ->
relu -> 8), Adam alpha 0.01: "tp" under ``{"data": 2, "model": 2}`` with
d1 column-parallel and head row-parallel (CONTRACT) over "model"; "fsdp"
under ``{"data": 4}`` with ``fsdp_axis="data"``. One spawn of 4 ranks,
bounded; the JAX references run in this process meanwhile.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_zero1_ep_common as common  # noqa: E402

TOL = common.TOL
MEGA = {"data": 2, "model": 2}
TP_MAPS = {"d1": (2, {"data": 0, "model": 1}),
           "head": (2, {"data": 0, "model": -2})}


def _sc(cfg, **kw):
    return dict(dict(model="mlp", steps=3, opt="adam",
                     cfg=dict(cfg, fused_optimizer=True)), **kw)


SCENARIOS = {
    "tp": _sc(dict(mesh_shape=MEGA), axis_maps=TP_MAPS, per_leaf_twin=True,
              ckpt=dict(more=1, others={
                  "per_leaf": dict(fused_optimizer=False),
                  "other_mesh": dict(mesh_shape={"data": 1, "model": 4})})),
    "fsdp": _sc(dict(mesh_shape={"data": 4}, fsdp_axis="data"),
                per_leaf_twin=True, ckpt=dict(more=1)),
    "pure_dp": _sc(dict(mesh_shape={"data": 4}), steps=2),
    "from_jax_tp": _sc(dict(mesh_shape=MEGA), axis_maps=TP_MAPS, steps=1,
                       start=2, from_jax=True),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    threads = common.one_thread()
    tmp = str(tmp_path_factory.mktemp("sharded_fused"))
    data = common.make_data(4)
    jax_res, models = {}, {}
    sc = SCENARIOS["from_jax_tp"]
    _, jff = common.jax_run(dict(sc, start=0), data, steps=2)
    data.update(common.jax_state_arrays(jff))
    jax_res["from_jax_tp"], models["from_jax_tp"] = common.jax_run(
        sc, data, ff=jff)
    scs = [dict(sc, name=n) for n, sc in SCENARIOS.items()]
    procs = []
    try:
        d, procs = common.spawn(tmp, 4, scs, data)
        for n, sc in SCENARIOS.items():
            if n != "from_jax_tp":
                steps = sc["steps"] + sc.get("ckpt", {}).get("more", 0)
                jax_res[n], models[n] = common.jax_run(sc, data, steps=steps)
        ranks = common.collect(d, procs, scs, 4)
    finally:
        common.torch_ranks.kill(procs)
        import torch

        torch.set_num_threads(threads)
    return jax_res, models, ranks, d


@pytest.mark.parametrize("name", ["tp", "fsdp"])
def test_sharded_fused_bitwise_the_per_leaf_update(results, name):
    """Losses and every weight after 3 Adam steps bitwise the per-leaf
    update's on the same mesh (the same elementwise formula on the same
    operands: flattening the local shards changes no value)."""
    for r in results[2][name]:
        assert r["kind"].tolist() == [False, True, False]
        np.testing.assert_array_equal(r["losses"], r["twin/losses"])
        for k in [k for k in r if k.startswith("weight/")]:
            np.testing.assert_array_equal(r[k], r[f"twin/{k}"], err_msg=k)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_fused_matches_jax(results, name):
    """Losses and weights within 1e-5 of the JAX package's same strategy
    (there ``ShardedFusedUpdate`` too, ``FusedUpdate`` for pure data
    parallelism)."""
    from flexflow_tpu.runtime.optimizer import (FusedUpdate,
                                                ShardedFusedUpdate)

    jax_res, models, ranks, _ = results
    sharded = name != "pure_dp"
    assert isinstance(models[name].optimizer,
                      ShardedFusedUpdate if sharded else FusedUpdate)
    got, want = ranks[name][0], jax_res[name]
    assert got["kind"].tolist() == [False, sharded, not sharded]
    n = len(got["losses"])
    np.testing.assert_allclose(got["losses"], want["losses"][:n], **TOL)
    if "ckpt" not in SCENARIOS[name]:
        for k in [k for k in want if k.startswith("weight/")]:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("name", ["tp", "fsdp"])
def test_flat_state_is_sharded_across_the_mesh(results, name):
    """Each rank stores its own bucket: 1/4 of the flat state (the
    weights' every dim divides here), and every rank returns the same
    whole state."""
    rs = results[2][name]
    for r in rs:
        local, glob = r["state_bytes"].tolist()
        assert local * 4 == glob
        for k in [k for k in r if k.startswith(("state/", "losses"))]:
            np.testing.assert_array_equal(r[k], rs[0][k], err_msg=k)


@pytest.mark.parametrize("name", ["tp", "fsdp"])
def test_sharded_fused_checkpoint_round_trip(results, name):
    """A save from every rank records the ``sharded_fused`` layout with
    the weights' specs; restored into fresh models on the same mesh the
    weights and the flat state are bitwise the saved ones, and the next
    step's loss is the uninterrupted run's, bitwise."""
    from flexflow_tpu_torch.runtime.checkpoint import load_meta

    _, _, ranks, d = results
    meta = load_meta(os.path.join(d, f"ckpt_{name}"))
    assert meta["opt_layout"] == "sharded_fused"
    assert set(meta["opt_state_shardings"]) == {"d1", "head"}
    for r in ranks[name]:
        saved = [k for k in r if k.startswith(("state/", "weight/"))]
        assert any(k.startswith("state/m/") for k in saved)
        for k in saved:
            np.testing.assert_array_equal(r[f"same/{k}"], r[k], err_msg=k)
        np.testing.assert_array_equal(r["same/losses"], r["cont/losses"])


def test_restore_across_layouts_and_topologies_refused(results):
    """The ``sharded_fused`` checkpoint refuses a restore into the
    per-leaf layout, and into the same layout on another mesh (the flat
    vector's element order follows the mesh and the specs), as JAX's
    ``checkpoint.py:776-804``."""
    for r in results[2]["tp"]:
        assert "'sharded_fused' layout" in str(r["per_leaf/refused"])
        assert "'per_leaf'" in str(r["per_leaf/refused"])
        assert "topology-dependent" in str(r["other_mesh/refused"])


def test_resume_from_jax_flat_state(results):
    """JAX's ``ShardedFusedUpdate`` state after 2 steps (its flat vectors:
    each device's local shards in sorted leaf order, devices in mesh
    order), carried into the port by ``convert.opt_state_from_jax`` —
    each rank its own bucket in the port's order —: the third step's
    loss and weights within 1e-5 of JAX's."""
    jax_res, _, ranks, _ = results
    got, want = ranks["from_jax_tp"][0], jax_res["from_jax_tp"]
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    for k in [k for k in want if k.startswith("weight/")]:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
