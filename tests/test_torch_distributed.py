"""The port's strategy path across ranks, against the JAX package under the
same mesh and strategy and against the port's own single-process run.

Ranks run on gloo (``--device cpu``), started through the port's launcher
(``flexflow_tpu_torch.launcher``) as ``tests/test_multihost.py`` starts
JAX's: a world of 2 through the launcher's flags, a world of 4 through
torchrun's environment. Each spawn runs several scenarios
(``tests/torch_dist_worker.py``) and is bounded by ``SPAWN_TIMEOUT``; a
rank that outlives it is killed and fails the test. The JAX side runs in
this process on the conftest's 8 CPU devices, its attention and fused add
+ LayerNorm through the Pallas kernels in interpret mode
(``FF_FORCE_FLASH_ATTENTION=1``), as ``test_torch_training.py`` runs it.

Scenarios (the small flagship: batch 8, seq 16, hidden 64, 2 layers, 4
heads, fused add + LayerNorm, SGD lr 0.05; weights and data from numpy
seeds, the same in both packages):

  (a) ``{"data": 2}`` through ``fit`` over 3 batches, the data staged on
      the device and from the host (the native loader);
  (b) ``{"data": 2, "model": 2}`` under the Megatron strategy (attention
      and ffn1 split over "model" on the hidden dim, ffn2 CONTRACT),
      imported from a file the JAX package exported;
  (c) (b) with ``fsdp_axis="data"``: every rank holds half of (b)'s local
      weight and optimizer-state bytes;
  (d) the divergence guard (a NaN step skipped) and grad accumulation
      (2 microbatches) under (a)'s mesh;
  (e) a conv + BatchNorm + pool net under ``{"data": 2}``: the running
      statistics equal JAX's global-batch statistics;
  (f) the conv net with a second conv under ``{"data": 2, "model": 2}``:
      conv1 split on its out-channels over "model", conv2 row-parallel
      (CONTRACT), BatchNorm between (its channels gathered);
  (g) a two-layer regression MLP under ``{"data": 2}``: MSE loss, and
      accuracy, MSE, RMSE and MAE — the global batch's metrics on every
      rank (RMSE the root of the global mean, not a mean of roots).

Every scenario also compares the metrics of batch 0 (accuracy's count
and total for the classifiers).

Tolerances, f32: logits, losses and metrics 1e-5; gradients 1e-4 of each weight's
largest gradient (plus 1e-6); weights after 3 SGD steps and BatchNorm
state 1e-5. Every rank returns the same numbers (bitwise).
"""

import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys

import jax
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
from flexflow_tpu.ffconst import PoolType as JPool
from flexflow_tpu.models.transformer import \
    build_encoder_classifier as j_build
from flexflow_tpu.parallel.pconfig import CONTRACT, ParallelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
SPAWN_TIMEOUT = 240

_spec = importlib.util.spec_from_file_location("torch_dist_worker", WORKER)
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)

B, DIMS, CLASSES, LR = 8, (16, 64, 2, 4), 16, 0.05
IMAGE = (B, 3, 8, 8)
TOL = dict(rtol=1e-5, atol=1e-5)
MEGA = {"data": 2, "model": 2}

FLAG = dict(model="flagship", batch=B, dims=list(DIMS), classes=CLASSES,
            lr=LR, weights="flag", x="fx", y="fy")
CONV = dict(model="convbn", batch=B, image=list(IMAGE), classes=10, lr=LR,
            weights="conv", x="cx", y="cy")
MLP = dict(model="mlp", batch=B, features=16, classes=4, lr=LR,
           weights="mlp", x="mx", y="my")
SCENARIOS = {
    "a_resident": dict(FLAG, mode="fit", world=2,
                       cfg=dict(mesh_shape={"data": 2}, use_fused_ln=True)),
    "a_host": dict(FLAG, mode="fit", world=2,
                   cfg=dict(mesh_shape={"data": 2}, use_fused_ln=True,
                            device_resident_data=False)),
    "d_guard": dict(FLAG, mode="steps", world=2,
                    nan_steps=[False, True, False],
                    cfg=dict(mesh_shape={"data": 2}, use_fused_ln=True,
                             on_nonfinite="skip")),
    "d_accum": dict(FLAG, mode="steps", world=2,
                    nan_steps=[False, False, False],
                    cfg=dict(mesh_shape={"data": 2}, use_fused_ln=True,
                             grad_accum_steps=2)),
    "e_convbn": dict(CONV, mode="fit", world=2,
                     cfg=dict(mesh_shape={"data": 2})),
    "g_mse": dict(MLP, mode="fit", world=2,
                  cfg=dict(mesh_shape={"data": 2})),
    "b_megatron": dict(FLAG, mode="fit", world=4, momentum=0.9,
                       strategy=True,
                       cfg=dict(mesh_shape=MEGA, use_fused_ln=True)),
    "c_fsdp": dict(FLAG, mode="fit", world=4, momentum=0.9, strategy=True,
                   cfg=dict(mesh_shape=MEGA, use_fused_ln=True,
                            fsdp_axis="data")),
    # two convs, the first split on its out-channels over "model", the
    # second row-parallel (CONTRACT) over it, BatchNorm between
    "f_conv_tp": dict(CONV, model="convtp", weights="convtp", mode="fit",
                      world=4, cfg=dict(mesh_shape=MEGA),
                      axis_maps={"conv1": {"data": 0, "model": 1},
                                 "conv2": {"data": 0, "model": -2}}),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _weights(shapes, seed):
    rs = np.random.RandomState(seed)
    out = {}
    for op, ws in shapes.items():
        for k, shape in ws.items():
            if len(shape) > 1:
                v = rs.randn(*shape) / np.sqrt(shape[0])
            else:
                v = (1.0 if k == "scale" else 0.0) + 0.1 * rs.randn(*shape)
            out[f"{op}.{k}"] = v.astype(np.float32)
    return out


def _data(tmp):
    """Weights (from the port's weight shapes), batches, and the Megatron
    strategy file written by the JAX package."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import build_encoder_classifier

    arrays = {}
    ff = FFModel(FFConfig(batch_size=B, use_fused_ln=True), device="cpu")
    build_encoder_classifier(ff, B, *DIMS, num_classes=CLASSES)
    arrays.update({f"flag/{k}": v for k, v in
                   _weights(ff.weight_shapes(), 5).items()})
    cshapes = {"conv1": {"kernel": (8, 3, 3, 3), "bias": (8,)},
               "bn1": {"scale": (8,), "bias": (8,)},
               "head": {"kernel": (8 * 4 * 4, 10), "bias": (10,)}}
    arrays.update({f"conv/{k}": v for k, v in _weights(cshapes, 6).items()})
    cshapes["conv2"] = {"kernel": (8, 8, 3, 3), "bias": (8,)}
    arrays.update({f"convtp/{k}": v
                   for k, v in _weights(cshapes, 8).items()})
    mshapes = {"fc1": {"kernel": (16, 32), "bias": (32,)},
               "fc2": {"kernel": (32, 4), "bias": (4,)}}
    arrays.update({f"mlp/{k}": v for k, v in _weights(mshapes, 9).items()})
    rs = np.random.RandomState(7)
    arrays["fx"] = rs.randn(3 * B, DIMS[0], DIMS[1]).astype(np.float32)
    arrays["fy"] = rs.randint(0, CLASSES, (3 * B, 1)).astype(np.int32)
    arrays["cx"] = rs.randn(3 * B, *IMAGE[1:]).astype(np.float32)
    arrays["cy"] = rs.randint(0, 10, (3 * B, 1)).astype(np.int32)
    # small inputs and targets, so that some rows fall inside the
    # regression accuracy's 0.5 and the count is not trivially 0
    arrays["mx"] = (0.3 * rs.randn(3 * B, 16)).astype(np.float32)
    arrays["my"] = (0.3 * rs.randn(3 * B, 4)).astype(np.float32)
    np.savez(os.path.join(tmp, "data.npz"), **arrays)
    # the strategy table, exported by the JAX package
    jff = JModel(JConfig(batch_size=B, mesh_shape=dict(MEGA)))
    for i in range(DIMS[2]):
        for op in (f"attn_{i}", f"ffn1_{i}"):
            jff.config.strategies[op] = ParallelConfig.from_axis_map(
                3, MEGA, {"data": 0, "model": 2})
        jff.config.strategies[f"ffn2_{i}"] = ParallelConfig.from_axis_map(
            3, MEGA, {"data": 0, "model": CONTRACT})
    path = os.path.join(tmp, "megatron.ff")
    jff.export_strategies(path)
    return path


def _spawn(tmp, world, scenarios, via_env):
    d = os.path.join(tmp, f"w{world}")
    os.makedirs(d)
    os.link(os.path.join(tmp, "data.npz"), os.path.join(d, "data.npz"))
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump({"world": world, "scenarios": scenarios}, f)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["FF_INIT_TIMEOUT_S"] = "120"
    procs = []
    for r in range(world):
        cmd = [sys.executable, "-m", "flexflow_tpu_torch.launcher", WORKER,
               "--device", "cpu"]
        e = dict(env)
        if via_env:
            e.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        else:
            cmd += ["--num-processes", str(world), "--process-id", str(r),
                    "--coordinator", f"127.0.0.1:{port}"]
        procs.append(subprocess.Popen(
            cmd + ["--", d], env=e, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True))
    return d, procs


def _wait(procs):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=SPAWN_TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "TORCH-DIST" in out, \
            f"rank {r} failed (rc {p.returncode}):\n{out[-4000:]}"


def _jax_run(sc, data, strategy_file, mp):
    """The scenario in the JAX package, keys as ``worker.run``'s. Its
    executor is handed the scenario's numpy weights (its ``init_params``
    compiles a program a weight, ~0.3 s each, for weights the test then
    replaces), and its loss gradient runs as one jitted program."""
    from flexflow_tpu.runtime import executor as jex

    prefix = sc["weights"] + "/"

    def init_params(self, rng_key):
        sh = self.param_shardings()
        out = {}
        for key in data.files:
            if key.startswith(prefix):
                op, w = key[len(prefix):].split(".")
                out.setdefault(op, {})[w] = jax.device_put(data[key],
                                                           sh[op][w])
        return out

    mp.setattr(jex.GraphExecutor, "init_params", init_params)
    cfg = dict(sc["cfg"])
    if sc.get("strategy"):
        cfg["import_strategy_file"] = strategy_file
    ff = JModel(JConfig(batch_size=B, seed=1, **cfg))
    for op, am in sc.get("axis_maps", {}).items():
        ff.config.strategies[op] = ParallelConfig.from_axis_map(
            4, cfg["mesh_shape"], am)
    loss = JLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
    metrics = [JMetrics.METRICS_ACCURACY]
    if sc["model"] == "flagship":
        x, out = j_build(ff, B, *DIMS, num_classes=CLASSES)
    elif sc["model"] == "mlp":
        x = ff.create_tensor([B, sc["features"]], name="input")
        t = ff.dense(x, 32, JActi.AC_MODE_RELU, name="fc1")
        out = ff.dense(t, sc["classes"], name="fc2")
        loss = JLoss.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE
        metrics = [JMetrics.METRICS_ACCURACY,
                   JMetrics.METRICS_MEAN_SQUARED_ERROR,
                   JMetrics.METRICS_ROOT_MEAN_SQUARED_ERROR,
                   JMetrics.METRICS_MEAN_ABSOLUTE_ERROR]
    else:
        x = ff.create_tensor(list(IMAGE), name="input")
        t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="conv1")
        t = ff.batch_norm(t, relu=True, name="bn1")
        if sc["model"] == "convtp":
            t = ff.conv2d(t, 8, 3, 3, 1, 1, 1, 1, name="conv2")
        t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, JPool.POOL_MAX, name="pool1")
        t = ff.flat(t, name="flat")
        out = ff.dense(t, sc["classes"], name="head")
    ff.compile(JSGD(lr=LR, momentum=sc.get("momentum", 0.0)), loss,
               metrics, final_tensor=out)
    xs, ys = data[sc["x"]], data[sc["y"]]
    batch = {"input": xs[:B], "label": ys[:B]}
    res = {"logits": np.asarray(ff.predict({"input": xs[:B]}))}
    loss_fn = ff.executor._make_loss_fn(ff.loss_type, ff.metric_types,
                                        ff._loss_tensor)
    sharded = ff.executor.shard_batch(batch)
    (loss, (_, mets)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(ff.params, ff.bn_state, sharded,
                                jax.random.PRNGKey(0))
    res["loss0"] = float(loss)
    for k, v in mets.items():
        res[f"metric/{k}"] = float(v)
    for op, ws in grads.items():
        for k, g in ws.items():
            res[f"grad/{op}.{k}"] = np.asarray(g)
    if sc["mode"] == "fit":
        JLoader(ff, x, xs)
        JLoader(ff, ff.label_tensor, ys)
        ff.fit(epochs=1)
        res["losses"] = np.array([float(ff._last_loss)])
    else:
        losses = []
        for i, nan in enumerate(sc["nan_steps"]):
            lo = (i % (len(xs) // B)) * B
            loss, mets = ff._run_train_step(
                {"input": xs[lo:lo + B], "label": ys[lo:lo + B]},
                inject_nan=nan)
            losses.append(float(loss))
            if "skipped_total" in mets:
                res["skipped"] = int(mets["skipped_total"])
        res["losses"] = np.array(losses)
    for op, ws in ff.params.items():
        for k, w in ws.items():
            res[f"weight/{op}.{k}"] = np.asarray(w)
    for op, st in (ff.bn_state or {}).items():
        for k, v in st.items():
            res[f"state/{op}.{k}"] = np.asarray(v)
    return res


def _single(sc):
    """The scenario on the port's single-device path (no mesh)."""
    cfg = {k: v for k, v in sc["cfg"].items()
           if k not in ("mesh_shape", "fsdp_axis")}
    return dict(sc, cfg=cfg, axis_maps={})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("FF_FORCE_FLASH_ATTENTION", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = str(tmp_path_factory.mktemp("torch_dist"))
    strategy_file = _data(tmp)
    spawns = []
    try:
        for world, via_env in ((2, False), (4, True)):
            scs = [dict(sc, name=n, import_strategy=None)
                   for n, sc in SCENARIOS.items() if sc["world"] == world]
            for sc in scs:
                if sc.get("strategy"):
                    sc["cfg"] = dict(sc["cfg"],
                                     import_strategy_file=strategy_file)
            spawns.append((world,) + _spawn(tmp, world, scs, via_env))
        data = np.load(os.path.join(tmp, "data.npz"))
        # the host-loader run's reference is the resident run's
        jax_res = {n: _jax_run(sc, data, strategy_file, mp)
                   for n, sc in SCENARIOS.items() if n != "a_host"}
        jax_res["a_host"] = jax_res["a_resident"]
        single = {n: worker.run(_single(sc), data)
                  for n, sc in SCENARIOS.items()}
        for _, _, procs in spawns:
            _wait(procs)
    finally:
        for _, _, procs in spawns:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
        torch.set_num_threads(threads)
        mp.undo()
    ranks = {}
    for world, d, _ in spawns:
        for n, sc in SCENARIOS.items():
            if sc["world"] == world:
                ranks[n] = [dict(np.load(os.path.join(d, f"{n}.{r}.npz")))
                            for r in range(world)]
    return jax_res, single, ranks


def _close(got, want, tag):
    for key, w in want.items():
        if key in ("param_bytes", "opt_bytes", "shard_calls") or \
                key.startswith("shard/"):
            continue
        g = got[key]
        if key.startswith("grad/"):
            atol = 1e-4 * float(np.max(np.abs(w))) + 1e-6
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=f"{tag} {key}")
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64),
                                       err_msg=f"{tag} {key}", **TOL)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_strategy_path_matches_jax(results, name):
    jax_res, _, ranks = results
    got = ranks[name][0]
    kinds = ("grad/", "weight/", "state/", "metric/")
    assert {k for k in got if k.startswith(kinds)} \
        == {k for k in jax_res[name] if k.startswith(kinds)}
    _close(got, jax_res[name], "port vs jax")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_strategy_path_matches_single_process(results, name):
    _, single, ranks = results
    _close(ranks[name][0], single[name], "mesh vs single")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_every_rank_returns_the_same_numbers(results, name):
    rs = results[2][name]
    for r in rs[1:]:
        for key in rs[0]:
            if key in ("param_bytes", "opt_bytes"):
                continue
            np.testing.assert_array_equal(r[key], rs[0][key], err_msg=key)


def test_guard_skips_the_nan_step_on_every_rank(results):
    jax_res, _, ranks = results
    for r in ranks["d_guard"]:
        assert int(r["skipped"]) == jax_res["d_guard"]["skipped"] == 1
        assert np.isnan(r["losses"][1]) and np.isfinite(r["losses"][[0, 2]]
                                                        ).all()


def test_fsdp_divides_weight_and_state_bytes(results):
    """Each rank holds 1/n of every weight, n the ranks its placements
    split it over; under fsdp_axis="data" every weight but the two ffn1
    biases (their one dim spent on "model", as JAX leaves them) is split
    over "data" too, so a rank holds about half of the Megatron run's
    weights, and its momentum state takes the weights' placements."""
    _, single, ranks = results
    whole = {k: v.size for k, v in single["b_megatron"].items()
             if k.startswith("weight/")}
    for rb, rc in zip(ranks["b_megatron"], ranks["c_fsdp"]):
        for r in (rb, rc):
            for k, n in whole.items():
                local, parts, _ = r["shard/" + k[len("weight/"):]]
                assert local * parts == n, k
            assert int(r["opt_bytes"]) == int(r["param_bytes"])
        unsplit = sorted(k for k in rc if k.startswith("shard/")
                         and not rc[k][2])
        assert unsplit == ["shard/ffn1_0.bias", "shard/ffn1_1.bias"]
        spare = sum(rc[k][0] for k in unsplit) * 4
        assert (int(rc["param_bytes"]) - spare) * 2 == \
            int(rb["param_bytes"]) - spare
    for r in ranks["a_resident"]:     # data parallel replicates
        assert int(r["param_bytes"]) == sum(whole.values()) * 4


def test_kernels_ran_on_local_shards(results):
    """The attention, add + LayerNorm and update calls went through the
    local-shard wrapper on every rank (counted a call); BatchNorm and the
    conv too in (e) and (f), the update alone in (g)."""
    for name, rs in results[2].items():
        calls = rs[0]["shard_calls"]
        if SCENARIOS[name]["model"] == "flagship":
            assert (calls[:3] > 0).all(), (name, calls)
        elif SCENARIOS[name]["model"] == "mlp":
            assert calls[2] > 0, (name, calls)
        else:
            assert (calls[2:] > 0).all(), (name, calls)


def test_conv_channel_and_contract_split_over_model(results):
    """(f): conv1's kernel split on its out-channels, conv2's on its input
    channels (CONTRACT), each over "model"."""
    for r in results[2]["f_conv_tp"]:
        assert list(r["shard/conv1.kernel"][:2]) == [4 * 3 * 9, 2]
        assert list(r["shard/conv2.kernel"][:2]) == [8 * 4 * 9, 2]
        assert list(r["shard/conv1.bias"][:2]) == [4, 2]
        assert list(r["shard/conv2.bias"][:2]) == [8, 1]


def test_launcher_refuses_elastic_and_checks_its_flags():
    from flexflow_tpu_torch import launcher

    with pytest.raises(NotImplementedError, match="item 10"):
        launcher.main([WORKER, "--elastic", "--device", "cpu"])
    with pytest.raises(SystemExit):
        launcher.main([WORKER, "--num-processes", "2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        launcher.main([WORKER, "--process-id", "1", "--device", "cpu"])
