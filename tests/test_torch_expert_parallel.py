"""Expert parallelism in the port: a MoE whose experts an "expert" mesh axis
splits runs the dense dispatch through ``parallel.all_to_all``, across
gloo ranks, against the JAX package under the same mesh and strategy.

The model is ``tests/torch_zero1_ep_worker.py``'s: input (4, 8, 16) ->
moe (4 experts of width 32, top-2) -> dense 8, sparse cross-entropy over
the 32 positions, the aux loss (weight 1e-2) added to it; SGD lr 0.1.
Cases: ``{"expert": 2}`` (capacity factor 1.25, and 0.5, where capacity
binds and assignments drop); ``{"data": 2, "expert": 2}`` by the mesh
axis's name and by an EXPERT strategy entry. Ranks through the port's
launcher, each spawn bounded; the JAX references run in this process
meanwhile. Tolerance: f32, 1e-5 (sums over the experts' partials in
another order).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_zero1_ep_common as common  # noqa: E402

TOL = common.TOL
E2, D2E2 = {"expert": 2}, {"data": 2, "expert": 2}
EXPERT = -4


def _sc(mesh, **kw):
    return dict(dict(model="moe", steps=2, cfg=dict(mesh_shape=mesh)), **kw)


SCENARIOS = {
    "e2": _sc(E2),
    "e2_binding": _sc(E2, capacity=0.5),
    "d2e2": _sc(D2E2),
    "d2e2_strategy": _sc(D2E2, axis_maps={
        "moe": (3, {"data": 0, "expert": EXPERT})}),
}
WORLD = {n: 4 if n.startswith("d2") else 2 for n in SCENARIOS}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    threads = common.one_thread()
    tmp = str(tmp_path_factory.mktemp("expert_parallel"))
    data = common.make_data(5)
    spawns = []
    try:
        for world in (2, 4):
            scs = [dict(sc, name=n) for n, sc in SCENARIOS.items()
                   if WORLD[n] == world]
            spawns.append((world, scs) + common.spawn(tmp, world, scs, data))
        jax_res = {n: common.jax_run(sc, data)[0]
                   for n, sc in SCENARIOS.items()}
        ranks = {}
        for world, scs, d, procs in spawns:
            ranks.update(common.collect(d, procs, scs, world))
    finally:
        for *_, procs in spawns:
            common.torch_ranks.kill(procs)
        import torch

        torch.set_num_threads(threads)
    return jax_res, ranks


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_auto_takes_the_dense_dispatch_as_jax(results, name):
    jax_res, ranks = results
    assert jax_res[name]["sort_dispatch"] is False
    for r in ranks[name]:
        assert not bool(r["sort_dispatch"])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_outputs_aux_loss_and_gradients_match_jax(results, name):
    """The logits, the loss with the aux loss, every gradient (the
    router's, through the routing, too) and the losses of 2 SGD steps
    within 1e-5 of JAX's same strategy, on every rank."""
    jax_res, ranks = results
    want = jax_res[name]
    for r in ranks[name]:
        np.testing.assert_allclose(r["logits"], want["logits"], **TOL)
        np.testing.assert_allclose(float(r["loss0"]), want["loss0"], **TOL)
        grads = [k for k in want if k.startswith("grad/")]
        assert set(grads) == {k for k in r if k.startswith("grad/")}
        for k in grads:
            np.testing.assert_allclose(r[k], want[k], err_msg=k, **TOL)
        np.testing.assert_allclose(r["losses"], want["losses"], **TOL)
        for k in [k for k in want if k.startswith("weight/")]:
            np.testing.assert_allclose(r[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tokens_travel_by_all_to_all(results, name):
    """A training step's all-to-all bytes a rank: the dispatch sends this
    rank's rows' (E, C, D) slots, the combine each expert rank's f32
    partials of the group's rows (r rows each), and the combine's
    backward the same again (the input needs no gradient, so the
    dispatch has no backward)."""
    sc = SCENARIOS[name]
    b, s, d = common.worker.MOE_SHAPE
    n_tokens, experts, ranks = b * s, 4, WORLD[name]
    cap = int(sc.get("capacity", 1.25) * n_tokens * 2 / experts)
    r = n_tokens // ranks
    dispatch = experts * cap * d * 4
    combine = 2 * r * d * 4
    for rec in results[1][name]:
        assert int(rec["a2a_bytes"]) == dispatch + 2 * combine
