"""ZeRO-1 under ``FFConfig.overlap_grad_sync`` in the port, across gloo
ranks, against the JAX package under the same mesh and config (the cases
of JAX's ``tests/test_collective_overlap.py``).

The model is that file's (16 rows of 32 features -> dense 64 -> relu ->
dense 8), SGD lr 0.1 unless named, weights and batches from numpy seeds.
Ranks: ``tests/torch_zero1_ep_worker.py`` through the port's launcher, a
world of 2 and one of 4, each spawn bounded (``torch_ranks``); the JAX
references run in this process meanwhile. Tolerance: JAX's own for this
path, 1e-5 (f32; the reduce-scatter sums in another order than the
all-reduce).
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_zero1_ep_common as common  # noqa: E402

TOL = common.TOL
D2, D4 = {"data": 2}, {"data": 4}


def _sc(mesh, accum=4, **kw):
    cfg = dict(mesh_shape=mesh, grad_accum_steps=accum,
               overlap_grad_sync=True)
    cfg.update(kw.pop("cfg", {}))
    return dict(dict(model="mlp", steps=3, cfg=cfg), **kw)


SCENARIOS = {
    "accum_d2": _sc(D2),
    "no_accum_d2": _sc(D2, accum=1),
    "fsdp_d2": _sc(D2, cfg=dict(fsdp_axis="data")),
    "adam_d2": _sc(D2, opt="adam"),
    "momentum_d2": _sc(D2, momentum=0.9),
    "noop_model2": _sc({"model": 2}, accum=2),
    "resume_d2": _sc(D2, steps=2, ckpt=dict(more=2, others={
        "off": dict(overlap_grad_sync=False)})),
    "from_jax_d2": _sc(D2, momentum=0.9, steps=1, start=2, from_jax=True),
    "accum_d4": _sc(D4),
    "no_accum_d4": _sc(D4, accum=1),
}
WORLD = {n: 4 if n.endswith("d4") else 2 for n in SCENARIOS}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    threads = common.one_thread()
    tmp = str(tmp_path_factory.mktemp("zero1"))
    data = common.make_data(3)
    jax_res, models = {}, {}
    # the resume-from-JAX scenario starts from JAX's state after 2 steps
    sc = SCENARIOS["from_jax_d2"]
    _, jff = common.jax_run(dict(sc, start=0), data, steps=2)
    data.update(common.jax_state_arrays(jff))
    jax_res["from_jax_d2"], _ = common.jax_run(sc, data, ff=jff)
    spawns = []
    try:
        for world in (2, 4):
            scs = [dict(sc, name=n) for n, sc in SCENARIOS.items()
                   if WORLD[n] == world]
            spawns.append((world, scs) + common.spawn(tmp, world, scs, data))
        for n, sc in SCENARIOS.items():
            if n == "from_jax_d2":
                continue
            steps = sc["steps"] + sc.get("ckpt", {}).get("more", 0)
            jax_res[n], models[n] = common.jax_run(sc, data, steps=steps)
        ranks = {}
        for world, scs, d, procs in spawns:
            ranks.update(common.collect(d, procs, scs, world))
    finally:
        for *_, procs in spawns:
            common.torch_ranks.kill(procs)
        import torch

        torch.set_num_threads(threads)
    return jax_res, models, ranks


PINNED = [n for n in SCENARIOS if n not in ("resume_d2",)]


@pytest.mark.parametrize("name", PINNED)
def test_overlap_matches_jax(results, name):
    """Losses of every step and every weight after them within 1e-5 of
    the JAX package's same mesh and config."""
    jax_res, _, ranks = results
    got, want = ranks[name][0], jax_res[name]
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    keys = [k for k in want if k.startswith("weight/")]
    assert keys and set(keys) == {k for k in got if k.startswith("weight/")}
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_every_rank_returns_the_same_numbers(results, name):
    rs = results[2][name]
    for r in rs[1:]:
        for key in rs[0]:
            if key != "state_bytes":
                np.testing.assert_array_equal(r[key], rs[0][key],
                                              err_msg=key)


@pytest.mark.parametrize("name", ["accum_d2", "adam_d2", "momentum_d2",
                                  "fsdp_d2", "accum_d4"])
def test_state_is_one_shard_a_data_rank(results, name):
    """ZeRO-1: the update is ``Zero1Update`` and each rank stores 1/N of
    the optimizer state (Adam's m and v, momentum's v) — under FSDP the
    state follows the weights, already split over "data". A plain SGD
    has no state (0 bytes either way)."""
    n = SCENARIOS[name]["cfg"]["mesh_shape"]["data"]
    for r in results[2][name]:
        assert r["kind"].tolist() == [True, False, False]
        local, glob = r["state_bytes"].tolist()
        assert local * n == glob


def test_noop_without_data_axis(results):
    """No "data" axis > 1: the plain per-leaf update (logged), as JAX, and
    training runs unchanged (the losses are JAX's, see above)."""
    jax_res, models, ranks = results
    from flexflow_tpu.runtime.optimizer import Zero1Update

    assert not isinstance(models["noop_model2"].optimizer, Zero1Update)
    for r in ranks["noop_model2"]:
        assert r["kind"].tolist() == [False, False, False]
        assert json.loads(str(r["scatter"])) == {}


@pytest.mark.parametrize("name", ["accum_d2", "fsdp_d2", "accum_d4"])
def test_grad_scatter_shardings_equal_jax(results, name):
    """``executor.grad_scatter_shardings`` gives JAX's layout weight by
    weight (under FSDP over "data" the weights' own specs)."""
    _, models, ranks = results
    want = {op: {w: [e for e in ns.spec] + [None] * (
        len(models[name].params[op][w].shape) - len(ns.spec))
        for w, ns in ws.items()}
        for op, ws in models[name].executor.grad_scatter_shardings().items()}
    got = json.loads(str(ranks[name][0]["scatter"]))
    assert got == want


@pytest.mark.parametrize("name", ["accum_d2", "no_accum_d2", "accum_d4"])
def test_reduce_scatter_and_all_gather_bytes(results, name):
    """Each microbatch reduce-scatters every f32 gradient (the global
    tensor's bytes counted once a rank) and each step all-gathers every
    updated shard (1/N of the weights a rank)."""
    sc = SCENARIOS[name]
    n, accum = sc["cfg"]["mesh_shape"]["data"], sc["cfg"]["grad_accum_steps"]
    full = 4 * sum(int(np.prod(s)) for ws in common.SHAPES["mlp"].values()
                   for s in ws.values())
    for r in results[2][name]:
        assert r["rs_ag_bytes"].tolist() == [
            sc["steps"] * accum * full, sc["steps"] * full // n]


def test_resume_across_the_checkpoint_boundary(results):
    """A ZeRO-1 run saved after 2 steps (from both ranks) and restored into
    a fresh ZeRO-1 model continues bitwise as the uninterrupted run;
    restored with overlap_grad_sync off (the per-leaf layout, the same
    state tree) it continues within 1e-5; all within 1e-5 of JAX's 4
    uninterrupted steps. The restored state is the saved state,
    bitwise."""
    jax_res, _, ranks = results
    for r in ranks["resume_d2"]:
        np.testing.assert_array_equal(r["same/losses"], r["cont/losses"])
        np.testing.assert_allclose(r["off/losses"], r["cont/losses"], **TOL)
        np.testing.assert_allclose(
            np.concatenate([r["losses"], r["cont/losses"]]),
            jax_res["resume_d2"]["losses"], **TOL)
        saved = [k for k in r if k.startswith("state/")]
        assert saved
        for k in saved:
            np.testing.assert_array_equal(r[f"same/{k}"], r[k], err_msg=k)
            np.testing.assert_array_equal(r[f"off/{k}"], r[k], err_msg=k)
