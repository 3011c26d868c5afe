"""Scenarios of the port's sharded optimizer state and expert parallelism,
run by the gloo ranks that ``tests/test_torch_zero1.py``,
``tests/test_torch_sharded_fused.py`` and
``tests/test_torch_expert_parallel.py`` start through the port's launcher
(``python -m flexflow_tpu_torch.launcher tests/torch_zero1_ep_worker.py
--device cpu ... -- <dir>``). Imports nothing of jax.

``<dir>/spec.json`` lists the scenarios; ``<dir>/data.npz`` holds the
weights and batches (and, for a scenario that resumes from the JAX
package's state, that state). Each rank writes
``<dir>/<scenario>.<rank>.npz``. The graphs (``graph``) build alike in both
packages:

  mlp: input (16, 32) -> dense d1 64 -> relu -> dense head 8 (the JAX
       ``tests/test_collective_overlap.py`` model);
  moe: input (4, 8, 16) -> moe (4 experts of 32, top-2) -> dense head 8,
       sparse cross-entropy over the 32 positions.
"""

import json
import os
import sys

import numpy as np
import torch

MLP_BATCH = 16
MOE_SHAPE = (4, 8, 16)


def graph(ff, sc):
    """(input tensor, output tensor) of scenario ``sc``'s model on ``ff``
    (either package's FFModel)."""
    if sc["model"] == "mlp":
        x = ff.create_tensor([MLP_BATCH, 32], name="input")
        t = ff.dense(x, 64, name="d1")
        t = ff.relu(t, name="r1")
        return x, ff.dense(t, 8, name="head")
    x = ff.create_tensor(list(MOE_SHAPE), name="input")
    t = ff.moe(x, 4, 32, k=2, capacity_factor=sc.get("capacity", 1.25),
               name="moe")
    return x, ff.dense(t, 8, name="head")


def optimizer(pkg, sc):
    """Scenario ``sc``'s optimizer from package module ``pkg``."""
    if sc.get("opt") == "adam":
        return pkg.AdamOptimizer(alpha=0.01)
    return pkg.SGDOptimizer(lr=0.1, momentum=sc.get("momentum", 0.0))


def batch_size(sc):
    return MLP_BATCH if sc["model"] == "mlp" else MOE_SHAPE[0]


def build(sc, data, **over):
    """The port's model of scenario ``sc`` (``over`` overrides config
    fields), weights set from ``data``."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, MetricsType
    from flexflow_tpu_torch.parallel import ParallelConfig

    cfg = FFConfig(batch_size=batch_size(sc), seed=1,
                   **dict(sc.get("cfg", {}), **over))
    for op, (nd, am) in sc.get("axis_maps", {}).items():
        cfg.strategies[op] = ParallelConfig.from_axis_map(
            nd, cfg.mesh_shape, am)
    ff = FFModel(cfg, device="cpu")
    _, out = graph(ff, sc)
    ff.compile(optimizer(ft, sc),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY], final_tensor=out)
    prefix = sc["model"] + "/"
    for key in data.files:
        if key.startswith(prefix):
            op, w = key[len(prefix):].split(".")
            ff.set_weights(op, w, data[key])
    return ff


def batch(sc, data, i=0):
    """Step ``i``'s global batch."""
    b = batch_size(sc)
    x, y = data[sc["model"] + "_x"], data[sc["model"] + "_y"]
    lo = (i * b) % len(x)
    return {"input": x[lo:lo + b], "label": y[lo:lo + b]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def state_bytes(ff):
    """(this rank's optimizer-state bytes, the global state's) — the step
    counter left out."""
    from flexflow_tpu_torch import parallel

    loc = glob = 0
    for t in _leaves(ff.opt_state):
        if t.dim() == 0:
            continue
        loc += parallel.local(t).numel() * t.element_size()
        glob += t.numel() * t.element_size()
    return np.array([loc, glob], dtype=np.int64)


def record(ff, out, tag=""):
    """Every weight (whole) and the optimizer state (whole) into ``out``."""
    from flexflow_tpu_torch import parallel

    for op, ws in ff.params.items():
        for k in ws:
            out[f"{tag}weight/{op}.{k}"] = ff.get_weights(op, k)
    for name, t in _state_items(ff.opt_state):
        v = parallel.full_tensor(t)
        out[f"{tag}state/{name}"] = v.float().numpy()


def _state_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _state_items(v, f"{prefix}{k}/")
    elif isinstance(tree, torch.Tensor):
        yield prefix.rstrip("/"), tree


def run(sc, data, d):
    """The scenario's results (numpy) on this rank."""
    from flexflow_tpu_torch import parallel
    from flexflow_tpu_torch.runtime import checkpoint
    from flexflow_tpu_torch.runtime.optimizer import (ShardedFusedUpdate,
                                                      Zero1Update)

    out = {}
    ff = build(sc, data)
    ex = ff.executor
    out["kind"] = np.array([isinstance(ff.optimizer, Zero1Update),
                            isinstance(ff.optimizer, ShardedFusedUpdate),
                            ff.optimizer.__class__.__name__ == "FusedUpdate"])
    out["scatter"] = np.array(json.dumps(
        {op: {w: list(sp) for w, sp in ws.items()}
         for op, ws in ex.grad_scatter_shardings().items()}))
    out["state_bytes"] = state_bytes(ff)
    if sc.get("from_jax"):
        # resume from the JAX package's weights and optimizer state
        from flexflow_tpu_torch.convert import opt_state_from_jax

        jstate = {"t": data["jax_state/t"]}
        for key in data.files:
            if key.startswith("jax_state/") and key != "jax_state/t":
                parts = key.split("/")[1:]
                node = jstate
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = data[key]
        for key in data.files:
            if key.startswith("jax_weight/"):
                op, w = key[len("jax_weight/"):].split(".")
                ff.set_weights(op, w, data[key])
        opt_state_from_jax(jstate, ff)
    if sc["model"] == "moe":
        moe = ff.get_op_by_name("moe")
        out["sort_dispatch"] = np.array(moe._use_sort_dispatch())
        b0 = batch(sc, data)
        out["logits"] = ff.predict({"input": b0["input"]}).detach().numpy()
        parallel.reset_transport_stats()
        loss, _, grads, _ = ex._loss_and_grads(
            ff.params, ex.shard_batch(ex.local_batch(b0)), ff.loss_type,
            ff.metric_types, ff._final_tensor)
        out["a2a_bytes"] = np.int64(
            parallel.transport_stats()["all_to_all_bytes"])
        out["loss0"] = np.float64(loss)
        for op, ws in grads.items():
            for k, g in ws.items():
                out[f"grad/{op}.{k}"] = parallel.full_tensor(g).numpy()
    parallel.reset_transport_stats()
    start = sc.get("start", 0)
    end = start + sc["steps"]
    losses = [float(ff._run_train_step(batch(sc, data, i))[0])
              for i in range(start, end)]
    out["losses"] = np.array(losses)
    st = parallel.transport_stats()
    out["rs_ag_bytes"] = np.array([st["reduce_scatter_bytes"],
                                   st["all_gather_bytes"]], dtype=np.int64)
    record(ff, out)
    ck = sc.get("ckpt")
    if ck:
        # save from every rank, then restore into fresh models
        path = os.path.join(d, f"ckpt_{sc['name']}")
        checkpoint.save_checkpoint(ff, path)
        checkpoint.wait_pending_saves()
        for tag, over in (("same", {}),) + tuple(
                (t, o) for t, o in ck.get("others", {}).items()):
            other = build(sc, data, **over)
            try:
                checkpoint.restore_checkpoint(other, path)
            except ValueError as e:
                out[f"{tag}/refused"] = np.array(str(e))
                continue
            record(other, out, f"{tag}/")
            more = [float(other._run_train_step(batch(sc, data, i))[0])
                    for i in range(end, end + ck["more"])]
            out[f"{tag}/losses"] = np.array(more)
        out["cont/losses"] = np.array(
            [float(ff._run_train_step(batch(sc, data, i))[0])
             for i in range(end, end + ck["more"])])
    if sc.get("per_leaf_twin"):
        # the same scenario under the per-leaf update, for bitwise checks
        twin = build(sc, data, fused_optimizer=False)
        twin_losses = [float(twin._run_train_step(batch(sc, data, i))[0])
                       for i in range(start, end)]
        out["twin/losses"] = np.array(twin_losses)
        record(twin, out, "twin/")
    return out


def main():
    import torch.distributed as dist

    torch.set_num_threads(1)
    d = sys.argv[1]
    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    data = np.load(os.path.join(d, "data.npz"))
    rank = dist.get_rank()
    assert dist.get_world_size() == spec["world"], dist.get_world_size()
    for sc in spec["scenarios"]:
        res = run(sc, data, d)
        np.savez(os.path.join(d, f"{sc['name']}.{rank}.npz"), **res)
        dist.barrier()
    print(f"TORCH-ZERO1-EP rank={rank} ok", flush=True)


if __name__ == "__main__":
    main()
