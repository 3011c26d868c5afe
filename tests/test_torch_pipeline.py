"""The port's pipeline parallelism across gloo ranks, against the JAX
package on the conftest's 8 CPU devices and against the port's serial
path.

Ranks run ``tests/torch_pp_worker.py`` through the port's launcher
(``tests/torch_ranks.py``): a world of 2, then one of 4, each bounded by
``SPAWN_TIMEOUT`` and overlapped with the JAX references computed in this
process (the stack's blocks through JAX's Pallas flash kernels in
interpret mode, ``FF_FORCE_FLASH_ATTENTION=1``; numpy weights,
``test_torch_zoo.numpy_init``).

  * the pipelined stack (8 causal blocks, hidden 64, 2 heads of 32, seq
    32, batch 8, a dense head, sparse cross-entropy over every position,
    SGD 0.05) under ``{"blocks": 4}`` with a STAGE assignment (JAX's
    ``test_stack_executes_search_assigned_stage_axis``) and under ``{"data":
    2, "pipe": 2}``: predict and 3 SGD steps against JAX under the same
    mesh and strategy and against the serial path; the stage weights are
    ``Shard(0)``, each rank holding L / stages layers (``params_from_jax``
    gives each rank the same slice of JAX's whole arrays). Limits 1e-5
    (f32).
  * the stack under ``{"seq": 2}`` (behind a dense): the same against
    JAX's serial run.
  * ``pipeline_train_1f1b`` at (stages, microbatches) (2, 6) and (4, 4)
    and the dp x pp composition (``{"pipe": 2, "data": 2}``) against
    serial autodiff and JAX's (loss 1e-5, grads rtol 1e-4 / atol 1e-5 as
    ``tests/test_pipeline_1f1b.py:45``), and GPipe's gradients through
    ``parallel.pipeline`` against 1F1B's; a stage that is inf / NaN on
    the zeros a dead tick carries gives finite gradients equal to serial
    autodiff (no stage runs on a dead tick).
  * a checkpoint of the stage-sharded stack saved from 2 ranks restores
    bitwise onto ``{"pipe": 4}`` and into one process, and the next step's
    loss matches the uninterrupted run's.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import LossType as JLoss
from flexflow_tpu import MetricsType as JMetrics
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.parallel.mesh import make_mesh as j_make_mesh
from flexflow_tpu.parallel.pconfig import STAGE as J_STAGE
from flexflow_tpu.parallel.pconfig import ParallelConfig as JPC
from flexflow_tpu.parallel.pipeline import \
    pipeline_train_1f1b as j_pipeline_train_1f1b
from test_torch_zoo import numpy_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_pp_worker.py")
sys.path.insert(0, os.path.dirname(WORKER))
import torch_ranks  # noqa: E402
import torch_pp_worker as worker  # noqa: E402

SPAWN_TIMEOUT = 240
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
S = worker.STACK

STACKS = {
    "stage": dict(mesh={"blocks": 4}, axis_map={"stack": {"blocks": "STAGE"}},
                  world=4),
    "dp_pp": dict(mesh={"data": 2, "pipe": 2}, axis_map={"*": {"data": 0}},
                  world=4),
    "seq": dict(mesh={"seq": 2}, axis_map={"*": {"seq": 1}}, world=2,
                pre=True),
}
F1B = {
    "n2m6": dict(mesh={"pipe": 2}, micro=6, mb=2, world=2, stage="tanh"),
    "n4m4": dict(mesh={"pipe": 4}, micro=4, mb=2, world=4, stage="tanh"),
    "dp_pp": dict(mesh={"pipe": 2, "data": 2}, micro=4, mb=4, world=4,
                  stage="tanh"),
    "dead": dict(mesh={"pipe": 4}, micro=6, mb=2, world=4, stage="bad",
                 shift=3.0),
}
SCENARIOS = (
    [dict(name=f"stack_{k}", mode="stack", **v) for k, v in STACKS.items()]
    + [dict(name=f"f1b_{k}", mode="f1b", data=k, **v)
       for k, v in F1B.items()]
    + [dict(name="ckpt_save", mode="ckpt_save", mesh={"pipe": 2}, world=2),
       dict(name="ckpt_restore", mode="ckpt_restore", mesh={"pipe": 4},
            world=4)])


def _f1b_data(k, sc):
    """JAX's ``_mlp_stages`` and inputs (tests/test_pipeline_1f1b.py)."""
    n, m, mb, d = sc["mesh"]["pipe"], sc["micro"], sc["mb"], 16
    rs = np.random.RandomState({"n2m6": 0, "n4m4": 0, "dp_pp": 1,
                                "dead": 7}[k])
    out = {"w": rs.randn(n, d, d).astype(np.float32) * 0.3,
           "b": rs.randn(n, d).astype(np.float32) * 0.1,
           "wo": rs.randn(d, 4).astype(np.float32) * 0.3}
    out["x"] = (rs.randn(m * mb, d) + sc.get("shift", 0.0)).astype(
        np.float32)
    out["lab"] = rs.randn(m * mb, 4).astype(np.float32)
    return out


def _j_stack(mesh, axis_map=None, pre=False):
    cfg = JConfig(batch_size=S["batch"], seed=5, mesh_shape=dict(mesh))
    jff = JModel(cfg)
    t = jff.create_tensor([S["batch"], S["seq"], S["hidden"]], name="x")
    if pre:
        t = jff.dense(t, S["hidden"], name="pre")
    t = jff.transformer_pipeline_stack(t, S["layers"], S["heads"],
                                       causal=True, name="stack")
    t = jff.dense(t, S["classes"], name="head")
    for op in jff.ops:
        am = (axis_map or {}).get(op.name, (axis_map or {}).get("*"))
        if op.inputs and am is not None:
            am = {a: (J_STAGE if d == "STAGE" else d) for a, d in am.items()}
            cfg.strategies[op.name] = JPC.from_axis_map(3, mesh, am)
    jff.compile(JSGD(lr=worker.LR), JLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                [JMetrics.METRICS_ACCURACY], final_tensor=t)
    return jff


def _run(ff, data):
    batch = {"x": data["sx"], "label": data["sy"]}
    pred = np.asarray(ff.predict({"x": data["sx"]}))
    losses = [float(ff._run_train_step(batch)[0]) for _ in range(3)]
    weights = {f"{op}.{w}": np.asarray(ff.get_weights(op, w))
               for op, ws in ff.params.items() for w in ws}
    return pred, losses, weights


def _j_1f1b(sc, d):
    def stage_fn(p, h):
        return jax.numpy.tanh(h @ p["w"] + p["b"])

    def loss_fn(y, lab, hp):
        return jax.numpy.mean((y @ hp["wo"] - lab) ** 2)

    mesh = j_make_mesh(dict(sc["mesh"]))
    dp = "data" if "data" in sc["mesh"] else None
    loss, g, gh, dx = jax.jit(lambda sp, hp, x, lab: j_pipeline_train_1f1b(
        stage_fn, loss_fn, sp, x, lab, mesh, num_microbatches=sc["micro"],
        head_params=hp, data_axis=dp))(
        {"w": d["w"], "b": d["b"]}, {"wo": d["wo"]}, d["x"], d["lab"])
    return dict(loss=float(loss), g={k: np.asarray(v) for k, v in g.items()},
                gh=np.asarray(gh["wo"]), dx=np.asarray(dx))


def _serial_1f1b(sc, d):
    """Autodiff through the serial model (JAX's ``_serial_loss``), grads
    scaled to microbatch sums."""
    stages, loss_fn = worker._f1b_fns()
    fn = stages[sc["stage"]]
    n, m = sc["mesh"]["pipe"], sc["micro"]
    st = {k: torch.tensor(d[k]).requires_grad_() for k in ("w", "b")}
    wo = torch.tensor(d["wo"]).requires_grad_()
    x = torch.tensor(d["x"]).requires_grad_()
    xm, lm = x.reshape(m, -1, x.shape[-1]), torch.tensor(d["lab"]).reshape(
        m, -1, 4)
    ls = []
    for j in range(m):
        h = xm[j]
        for i in range(n):
            h = fn({k: v[i] for k, v in st.items()}, h)
        ls.append(loss_fn(h, lm[j], {"wo": wo}))
    loss = torch.stack(ls).mean()
    loss.backward()
    return dict(loss=loss.item(), g={k: v.grad.numpy() * m
                                     for k, v in st.items()},
                gh=wo.grad.numpy() * m, dx=x.grad.numpy() * m)


def _port_serial(data, pre):
    ff, _ = worker.stack_model(pre=pre)
    worker.set_weights(ff, np.load(data["path"]),
                       "stackpre" if pre else "stack")
    return _run(ff, data)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    d = str(tmp_path_factory.mktemp("torch_pp"))
    rs = np.random.RandomState(4)
    data = {"sx": rs.randn(S["batch"], S["seq"], S["hidden"])
            .astype(np.float32),
            "sy": rs.randint(0, S["classes"], (S["batch"], S["seq"]))
            .astype(np.int32)}
    f1b_data = {k: _f1b_data(k, v) for k, v in F1B.items()}
    for k, v in f1b_data.items():
        data.update({f"{k}/{n}": a for n, a in v.items()})
    procs = []
    mp = pytest.MonkeyPatch()
    mp.setenv("FF_FORCE_FLASH_ATTENTION", "1")
    jax_out = {}
    try:
        numpy_init(mp)
        serial = {pre: _j_stack({"data": 1}, pre=pre) for pre in (False,
                                                                  True)}
        for pre, jff in serial.items():
            data.update({f"{'stackpre' if pre else 'stack'}/{op}.{w}":
                         np.asarray(a) for op, ws in jff.params.items()
                         for w, a in ws.items()})
        path = os.path.join(d, "data.npz")
        np.savez(path, **data)
        with open(os.path.join(d, "spec.json"), "w") as f:
            json.dump({"scenarios": SCENARIOS}, f)
        for world in (2, 4):
            procs = torch_ranks.spawn(WORKER, d, world)
            if world == 2:
                for pre, jff in serial.items():
                    jax_out[f"serial/{pre}"] = _run(jff, data)
                for k, v in F1B.items():
                    jax_out[f"f1b/{k}"] = _j_1f1b(v, f1b_data[k])
            else:
                for k in ("stage", "dp_pp"):
                    jax_out[f"stack/{k}"] = _run(_j_stack(
                        STACKS[k]["mesh"], STACKS[k]["axis_map"]), data)
            torch_ranks.wait(procs, "TORCH-PP", SPAWN_TIMEOUT)
    finally:
        torch_ranks.kill(procs)
        mp.undo()
        torch.set_num_threads(threads)
    ranks = {sc["name"]: [dict(np.load(os.path.join(
        d, f"{sc['name']}.{r}.npz"))) for r in range(sc["world"])]
        for sc in SCENARIOS}
    data["path"] = path
    port = {pre: _port_serial(data, pre) for pre in (False, True)}
    return ranks, jax_out, port, f1b_data, d


def _close(rec, want, label):
    pred, losses, weights = want
    np.testing.assert_allclose(rec["pred"], pred, err_msg=label, **TOL)
    np.testing.assert_allclose(rec["losses"], losses, err_msg=label, **TOL)
    for k, w in weights.items():
        np.testing.assert_allclose(rec[f"weight/{k}"], w,
                                   err_msg=f"{label} {k}", **TOL)


@pytest.mark.parametrize("name", ["stage", "dp_pp"])
def test_stack_pipelined_matches_jax_and_serial(results, name):
    """GPipe over the stage axis: predict, 3 SGD steps and the weights
    after them equal JAX's under the same mesh and strategy and the serial
    path's; the stacked weights are split on their layer dim, each rank
    holding L / stages layers; one GPipe call a walk."""
    ranks, jax_out, port, _, _ = results
    stages = 4 if name == "stage" else 2
    for rec in ranks[f"stack_{name}"]:
        _close(rec, jax_out[f"stack/{name}"], "jax")
        _close(rec, port[False], "serial")
        # split on the stage axis (the mesh's first), whole over "data"
        assert rec["w1_split"].tolist() == [True] + [False] * (
            len(STACKS[name]["mesh"]) - 1)
        assert list(rec["w1_local"]) == [S["layers"] // stages, S["hidden"],
                                         4 * S["hidden"]]
        assert list(rec["calls"]) == [3, 0]
        assert bool(rec["from_jax"])


def test_stack_under_sharded_sequence(results):
    """The stack on the ranks' positions, each block's attention over the
    gathered sequence: predict and 3 SGD steps equal JAX's serial run and
    the port's; 8 attention calls a walk on local shards."""
    ranks, jax_out, port, _, _ = results
    for rec in ranks["stack_seq"]:
        _close(rec, jax_out["serial/True"], "jax")
        _close(rec, port[True], "serial")
        assert list(rec["calls"]) == [0, 3 * S["layers"]]
        assert bool(rec["from_jax"])


@pytest.mark.parametrize("name", ["n2m6", "n4m4", "dp_pp", "dead"])
def test_1f1b_matches_serial_autodiff_and_jax(results, name):
    """pipeline_train_1f1b's loss, stage and head grads and dx equal
    serial autodiff's and JAX's on every rank; GPipe's gradients through
    ``parallel.pipeline`` equal them (as microbatch means). The dead-tick
    case's stage is inf / NaN on zeros: every gradient stays finite."""
    ranks, jax_out, _, f1b_data, _ = results
    sc = F1B[name]
    want = _serial_1f1b(sc, f1b_data[name])
    refs = [want] + ([jax_out[f"f1b/{name}"]] if name != "dead" else [])
    m = sc["micro"]
    for rec in ranks[f"f1b_{name}"]:
        for ref in refs:
            np.testing.assert_allclose(rec["loss"], ref["loss"], rtol=1e-5)
            for k in ("w", "b"):
                np.testing.assert_allclose(rec[f"g/{k}"], ref["g"][k],
                                           err_msg=k, **GRAD_TOL)
            np.testing.assert_allclose(rec["gh/wo"], ref["gh"], **GRAD_TOL)
            if "data" not in sc["mesh"]:
                np.testing.assert_allclose(rec["dx"], ref["dx"], **GRAD_TOL)
        for k in ("w", "b"):
            assert np.isfinite(rec[f"g/{k}"]).all()
            np.testing.assert_allclose(rec[f"gpipe/g/{k}"] * m, want["g"][k],
                                       err_msg=f"gpipe {k}", **GRAD_TOL)
        np.testing.assert_allclose(rec["gpipe/dx"] * m, want["dx"],
                                   **GRAD_TOL)


def test_dp_pp_1f1b_dx_matches_jax(results):
    """Under dp x pp each data slice's dx is d(slice loss)/d(slice inputs)
    scaled by 1/dp, as JAX returns it."""
    ranks, jax_out, _, _, _ = results
    for rec in ranks["f1b_dp_pp"]:
        np.testing.assert_allclose(rec["dx"], jax_out["f1b/dp_pp"]["dx"],
                                   **GRAD_TOL)


def test_stage_sharded_checkpoint_restores(results):
    """Saved by 2 stage ranks (4 layers each), restored onto {"pipe": 4}
    (2 layers each) and into one process: every state tensor bitwise the
    payload, and the next step's loss the uninterrupted run's."""
    from flexflow_tpu_torch import parallel
    from flexflow_tpu_torch.runtime.checkpoint import (load_payload,
                                                       restore_checkpoint,
                                                       state_tensors)

    ranks, _, _, _, d = results
    saved = ranks["ckpt_save"]
    assert [list(r["local"]) for r in saved] == [[4, 64, 256]] * 2
    after = float(saved[0]["loss_after"])
    for rec in ranks["ckpt_restore"]:
        assert bool(rec["bitwise"]) and int(rec["entries"]) > 0
        assert list(rec["local"]) == [2, 64, 256]
        np.testing.assert_allclose(rec["loss_after"], after, **TOL)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ff, _ = worker.stack_model(momentum=0.9)
        ckpt = os.path.join(d, "ckpt")
        restore_checkpoint(ff, ckpt, step=2)
        payload = load_payload(os.path.join(ckpt, "step_2"))
        live = state_tensors(ff)
        assert set(payload) >= set(live)
        for k, t in live.items():
            assert torch.equal(parallel.full_tensor(t), payload[k]), k
        for k, w in ((k[len("weight/"):], v) for k, v in saved[0].items()
                     if k.startswith("weight/")):
            np.testing.assert_array_equal(ff.get_weights(*k.split(".", 1)),
                                          w)
        batch = {"x": np.load(os.path.join(d, "data.npz"))["sx"],
                 "label": np.load(os.path.join(d, "data.npz"))["sy"]}
        loss = float(ff._run_train_step(batch)[0])
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_allclose(loss, after, **TOL)
