"""Shared by ``tests/test_torch_zero1.py``, ``test_torch_sharded_fused.py``
and ``test_torch_expert_parallel.py``: the scenarios' numpy data, the
spawn of the port's gloo ranks (``tests/torch_zero1_ep_worker.py``), and
the same scenarios run by the JAX package in the test's own process (its
8 virtual CPU devices)."""

import json
import os

import jax
import numpy as np
import torch

import torch_ranks
import torch_zero1_ep_worker as worker

WORKER = os.path.join(torch_ranks.REPO, "tests", "torch_zero1_ep_worker.py")
#: each spawn's bound (seconds a rank)
SPAWN_TIMEOUT = 150
#: f32 tolerance of JAX's tests/test_collective_overlap.py:53-60 (the
#: reduce-scatter sums in another order than the all-reduce)
TOL = dict(rtol=1e-5, atol=1e-5)

SHAPES = {
    "mlp": {"d1": {"kernel": (32, 64), "bias": (64,)},
            "head": {"kernel": (64, 8), "bias": (8,)}},
    "moe": {"moe": {"router": (16, 4), "w_in": (4, 16, 32),
                    "w_out": (4, 32, 16)},
            "head": {"kernel": (16, 8), "bias": (8,)}},
}


def make_data(seed=0):
    """Weights of both models and 3 batches of each, from ``seed``."""
    rs = np.random.RandomState(seed)
    out = {}
    for model, shapes in SHAPES.items():
        for op, ws in shapes.items():
            for k, s in ws.items():
                fan = s[-2] if len(s) > 1 else 1
                out[f"{model}/{op}.{k}"] = (rs.randn(*s)
                                            / np.sqrt(fan)).astype(np.float32)
    out["mlp_x"] = rs.randn(3 * worker.MLP_BATCH, 32).astype(np.float32)
    out["mlp_y"] = rs.randint(0, 8, (3 * worker.MLP_BATCH, 1)).astype(
        np.int32)
    b, s, d = worker.MOE_SHAPE
    out["moe_x"] = rs.randn(3 * b, s, d).astype(np.float32)
    out["moe_y"] = rs.randint(0, 8, (3 * b, s, 1)).astype(np.int32)
    return out


def spawn(tmp, world, scenarios, data):
    """Start ``world`` ranks running ``scenarios`` on ``data``; returns
    (dir, procs)."""
    d = os.path.join(tmp, f"w{world}")
    os.makedirs(d)
    np.savez(os.path.join(d, "data.npz"), **data)
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump({"world": world, "scenarios": scenarios}, f)
    return d, torch_ranks.spawn(WORKER, d, world)


def collect(d, procs, scenarios, world):
    """Wait for the ranks; {scenario: [each rank's results]}."""
    torch_ranks.wait(procs, "TORCH-ZERO1-EP", SPAWN_TIMEOUT)
    return {sc["name"]: [dict(np.load(os.path.join(d, f"{sc['name']}.{r}"
                                                    f".npz")))
                         for r in range(world)]
            for sc in scenarios}


def jax_model(sc, data):
    """The JAX package's model of scenario ``sc``, its weights set from
    ``data``."""
    import flexflow_tpu as fj
    from flexflow_tpu import FFConfig, FFModel, LossType, MetricsType
    from flexflow_tpu.parallel.pconfig import ParallelConfig

    cfg = FFConfig(batch_size=worker.batch_size(sc), seed=1,
                   **sc.get("cfg", {}))
    for op, (nd, am) in sc.get("axis_maps", {}).items():
        cfg.strategies[op] = ParallelConfig.from_axis_map(
            nd, cfg.mesh_shape, am)
    ff = FFModel(cfg)
    _, out = worker.graph(ff, sc)
    ff.compile(worker.optimizer(fj, sc),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY], final_tensor=out)
    prefix = sc["model"] + "/"
    for key, v in data.items():
        if key.startswith(prefix):
            op, w = key[len(prefix):].split(".")
            ff.set_weights(op, w, v)
    return ff


def jax_run(sc, data, steps=None, ff=None):
    """Scenario ``sc`` in the JAX package: keys as the worker's (losses,
    weight/..., and for the MoE logits, loss0, grad/...)."""
    ff = ff or jax_model(sc, data)
    res = {}
    if sc["model"] == "moe":
        b0 = worker.batch(sc, data)
        res["sort_dispatch"] = ff.get_op_by_name("moe")._use_sort_dispatch()
        res["logits"] = np.asarray(ff.predict({"input": b0["input"]}))
        loss_fn = ff.executor._make_loss_fn(ff.loss_type, ff.metric_types,
                                            ff._loss_tensor)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(ff.params, ff.bn_state,
                                    ff.executor.shard_batch(b0),
                                    jax.random.PRNGKey(0))
        res["loss0"] = float(loss)
        for op, ws in grads.items():
            for k, g in ws.items():
                res[f"grad/{op}.{k}"] = np.asarray(g)
    n = sc["steps"] if steps is None else steps
    start = sc.get("start", 0)
    res["losses"] = np.array([
        float(ff._run_train_step(worker.batch(sc, data, i))[0])
        for i in range(start, start + n)])
    for op, ws in ff.params.items():
        for k, w in ws.items():
            res[f"weight/{op}.{k}"] = np.asarray(w, np.float32)
    return res, ff


def jax_state_arrays(ff):
    """A JAX model's weights and optimizer state as npz entries
    (``jax_weight/<op>.<w>``, ``jax_state/<path>``) for a worker's
    ``from_jax`` scenario."""
    out = {}
    for op, ws in ff.params.items():
        for k, w in ws.items():
            out[f"jax_weight/{op}.{k}"] = np.asarray(w, np.float32)

    def walk(prefix, node):
        if node is None:
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        else:
            out[prefix] = np.asarray(node)

    walk("jax_state", ff.opt_state)
    return out


def one_thread():
    """Set torch to one intra-op thread; returns the old count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    return n
