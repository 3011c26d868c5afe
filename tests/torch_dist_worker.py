"""Scenarios of the port's strategy path, run by the ranks that
``tests/test_torch_distributed.py`` starts through the port's launcher
(``python -m flexflow_tpu_torch.launcher tests/torch_dist_worker.py
--device cpu ... -- <dir>``), and in the test's own process on one rank
(the single-process reference). Imports nothing of jax.

``<dir>/spec.json`` lists the scenarios; ``<dir>/data.npz`` holds the
weights and batches. Each rank writes ``<dir>/<scenario>.<rank>.npz``:
the logits of batch 0, its loss, metrics and every gradient before
training, the losses of the training steps, every weight after them, the BatchNorm
state, each weight's local share, the bytes of this rank's local weights
and optimizer state, and the local-shard calls.
"""

import json
import os
import sys

import numpy as np
import torch


def build(sc, data, device="cpu"):
    """(model, input tensor) of scenario ``sc``, weights set from
    ``data``."""
    from flexflow_tpu_torch import (ActiMode, FFConfig, FFModel, LossType,
                                    MetricsType, SGDOptimizer)
    from flexflow_tpu_torch.ffconst import PoolType
    from flexflow_tpu_torch.models import build_encoder_classifier

    from flexflow_tpu_torch.parallel import ParallelConfig

    cfg = FFConfig(batch_size=sc["batch"], seed=1, **sc.get("cfg", {}))
    for op, am in sc.get("axis_maps", {}).items():
        cfg.strategies[op] = ParallelConfig.from_axis_map(
            4, cfg.mesh_shape, {k: v for k, v in am.items()})
    ff = FFModel(cfg, device=device)
    loss = LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
    metrics = [MetricsType.METRICS_ACCURACY]
    if sc["model"] == "flagship":
        x, out = build_encoder_classifier(ff, sc["batch"], *sc["dims"],
                                          num_classes=sc["classes"])
    elif sc["model"] == "mlp":
        # a regression head: MSE loss, every regression metric
        x = ff.create_tensor([sc["batch"], sc["features"]], name="input")
        t = ff.dense(x, 32, ActiMode.AC_MODE_RELU, name="fc1")
        out = ff.dense(t, sc["classes"], name="fc2")
        loss = LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE
        metrics = [MetricsType.METRICS_ACCURACY,
                   MetricsType.METRICS_MEAN_SQUARED_ERROR,
                   MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR,
                   MetricsType.METRICS_MEAN_ABSOLUTE_ERROR]
    else:
        b, c, h, w = sc["image"]
        x = ff.create_tensor([b, c, h, w], name="input")
        t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="conv1")
        t = ff.batch_norm(t, relu=True, name="bn1")
        if sc["model"] == "convtp":
            t = ff.conv2d(t, 8, 3, 3, 1, 1, 1, 1, name="conv2")
        t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, PoolType.POOL_MAX, name="pool1")
        t = ff.flat(t, name="flat")
        out = ff.dense(t, sc["classes"], name="head")
    ff.compile(SGDOptimizer(lr=sc["lr"], momentum=sc.get("momentum", 0.0)),
               loss, metrics, final_tensor=out)
    prefix = sc["weights"] + "/"
    for key in data.files:
        if key.startswith(prefix):
            op, w = key[len(prefix):].split(".")
            ff.set_weights(op, w, data[key])
    return ff, x


def run(sc, data, device="cpu"):
    """The scenario's results (numpy), on this rank."""
    from flexflow_tpu_torch import SingleDataLoader, parallel

    ff, x = build(sc, data, device)
    ex = ff.executor
    xs, ys = data[sc["x"]], data[sc["y"]]
    b = sc["batch"]
    batch = {"input": xs[:b], "label": ys[:b]}
    out = {"logits": ff.predict({"input": xs[:b]}).detach().numpy()}
    loss, mets, grads, _ = ex._loss_and_grads(
        ff.params, ex.shard_batch(ex.local_batch(batch)), ff.loss_type,
        ff.metric_types, ff._final_tensor)
    out["loss0"] = np.float64(loss)
    for k, v in mets.items():
        out[f"metric/{k}"] = np.float64(float(v))
    for op, ws in grads.items():
        for k, g in ws.items():
            out[f"grad/{op}.{k}"] = parallel.full_tensor(g).numpy()
    if sc["mode"] == "fit":
        SingleDataLoader(ff, x, xs)
        SingleDataLoader(ff, ff.label_tensor, ys)
        ff.fit(epochs=1, verbose=False)
        out["losses"] = np.array([float(ff._last_loss)])
    else:
        losses = []
        for i, nan in enumerate(sc["nan_steps"]):
            lo = (i % (len(xs) // b)) * b
            step = {"input": xs[lo:lo + b], "label": ys[lo:lo + b]}
            loss, mets = ff._run_train_step(step, inject_nan=nan)
            losses.append(float(loss))
            if "skipped_total" in mets:
                out["skipped"] = np.int64(mets["skipped_total"])
        out["losses"] = np.array(losses)
    for op, ws in ff.params.items():
        for k in ws:
            out[f"weight/{op}.{k}"] = ff.get_weights(op, k)
    for op, st in (ff.bn_state or {}).items():
        for k, v in st.items():
            out[f"state/{op}.{k}"] = v.numpy()
    for op, ws in ff.params.items():
        for k, w in ws.items():
            # (local elements, ranks holding distinct parts, data-split)
            split = [ff.mesh.size(i) for i, p in enumerate(w.placements)
                     if p.is_shard()] if parallel.is_dtensor(w) else []
            on_data = parallel.is_dtensor(w) and any(
                p.is_shard() and n == "data" for p, n in
                zip(w.placements, ff.mesh.mesh_dim_names))
            out[f"shard/{op}.{k}"] = np.array(
                [parallel.local(w).numel(), int(np.prod(split)), on_data])
    local = parallel.local_tree(ff.params)
    out["param_bytes"] = np.int64(sum(
        w.numel() * w.element_size() for ws in local.values()
        for w in ws.values()))
    state = [t for t in _leaves(parallel.local_tree(ff.opt_state))
             if t.dim() > 0]
    out["opt_bytes"] = np.int64(sum(t.numel() * t.element_size()
                                    for t in state))
    out["shard_calls"] = np.array(
        [parallel.LOCAL_SHARD_CALLS[k] for k in
         ("flash_attention", "fused_add_layernorm", "fused_update",
          "batch_norm", "conv2d")])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


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
        res = run(sc, data)
        np.savez(os.path.join(d, f"{sc['name']}.{rank}.npz"), **res)
        dist.barrier()
    print(f"TORCH-DIST rank={rank} ok", flush=True)


if __name__ == "__main__":
    main()
