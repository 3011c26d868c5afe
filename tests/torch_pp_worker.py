"""A rank of ``tests/test_torch_pipeline.py``: the pipelined stack under a
stage axis, a sharded sequence dim and dp x pp, the 1F1B schedule, and a
stage-sharded checkpoint, started through the port's launcher (``python
-m flexflow_tpu_torch.launcher tests/torch_pp_worker.py --device cpu
--num-processes N --process-id R --coordinator HOST:PORT -- DIR``).
``DIR/spec.json`` names the scenarios of each world size, ``DIR/data.npz``
holds the inputs and the weights (``stack/<op>.<weight>`` and
``f1b/...`` keys); records go to ``DIR/<name>.<rank>.npz``. Imports
nothing of jax.
"""

import json
import os
import sys

import numpy as np
import torch

STACK = dict(batch=8, seq=32, hidden=64, heads=2, layers=8, classes=8)
LR = 0.05


def stack_model(mesh=None, axis_map=None, ckpt="", momentum=0.0,
                pre=False, device="cpu"):
    """x (batch, seq, hidden) -> [a dense "pre" ->] the pipelined stack
    (causal) -> a dense head; sparse cross-entropy over every position."""
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType,
                                    MetricsType, SGDOptimizer)
    from flexflow_tpu_torch.parallel import ParallelConfig

    s = STACK
    cfg = FFConfig(batch_size=s["batch"], seed=5, mesh_shape=mesh,
                   checkpoint_dir=ckpt)
    ff = FFModel(cfg, device=device)
    t = x = ff.create_tensor([s["batch"], s["seq"], s["hidden"]], name="x")
    if pre:
        t = ff.dense(t, s["hidden"], name="pre")
    t = ff.transformer_pipeline_stack(t, s["layers"], s["heads"],
                                      causal=True, name="stack")
    t = ff.dense(t, s["classes"], name="head")
    for op in ff.ops:
        am = (axis_map or {}).get(op.name, (axis_map or {}).get("*"))
        if op.inputs and am is not None:
            cfg.strategies[op.name] = ParallelConfig.from_axis_map(3, mesh,
                                                                   am)
    ff.compile(SGDOptimizer(lr=LR, momentum=momentum),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY], final_tensor=t)
    return ff, x


def set_weights(ff, data, prefix="stack"):
    for key in data.files:
        if key.startswith(prefix + "/"):
            op, w = key[len(prefix) + 1:].split(".", 1)
            if op in ff.params:
                ff.set_weights(op, w, data[key])


def _axis_map(sc):
    from flexflow_tpu_torch.parallel import STAGE

    return {op: {ax: (STAGE if d == "STAGE" else d) for ax, d in am.items()}
            for op, am in sc.get("axis_map", {}).items()}


def stack(sc, data, out):
    """predict, then 3 SGD steps on one batch; the stack's weight
    placements and local shapes, the shard calls."""
    from flexflow_tpu_torch import parallel

    from flexflow_tpu_torch.convert import params_from_jax

    ff, _ = stack_model(sc["mesh"], _axis_map(sc), pre=sc.get("pre", False))
    prefix = "stackpre" if sc.get("pre") else "stack"
    set_weights(ff, data, prefix)
    # JAX's whole arrays carried in: each rank keeps its own slice (the
    # stage's layers under a stage axis, everything under "seq")
    tree = {}
    for key in data.files:
        if key.startswith(prefix + "/"):
            op, w = key[len(prefix) + 1:].split(".", 1)
            tree.setdefault(op, {})[w] = data[key]
    got = params_from_jax(tree, "cpu", torch.float32, model=ff)
    out["from_jax"] = np.bool_(all(
        torch.equal(parallel.local(got[op][w]), parallel.local(t))
        and tuple(parallel.local(got[op][w]).shape) == tuple(
            parallel.local(t).shape)
        for op, ws in ff.params.items() for w, t in ws.items()))
    batch = {"x": data["sx"], "label": data["sy"]}
    out["pred"] = ff.predict({"x": data["sx"]}).detach().numpy()
    parallel.reset_local_calls()
    out["losses"] = np.array([float(ff._run_train_step(batch)[0])
                              for _ in range(3)])
    out["calls"] = np.array([parallel.LOCAL_SHARD_CALLS[k]
                             for k in ("gpipe", "flash_attention")])
    w1 = ff.params["stack"]["w1"]
    out["w1_split"] = np.array([p.is_shard(0) for p in w1.placements])
    out["w1_local"] = np.array(parallel.local(w1).shape)
    for op, ws in ff.params.items():
        for k in ws:
            out[f"weight/{op}.{k}"] = ff.get_weights(op, k)


def _f1b_fns():
    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    def bad_stage(p, h):
        # 1/sqrt(mean(h^2)): finite on real activations, inf / NaN on the
        # zeros a dead tick would carry (JAX's dead-tick test)
        return torch.tanh(h @ p["w"] + p["b"]) / torch.sqrt((h * h).mean())

    def loss_fn(y, lab, hp):
        return ((y @ hp["wo"] - lab) ** 2).mean()

    return {"tanh": stage_fn, "bad": bad_stage}, loss_fn


def f1b(sc, data, out):
    """One ``pipeline_train_1f1b`` step (JAX's MLP stages) and, beside it,
    GPipe (``parallel.pipeline``) with autograd on the same loss."""
    from flexflow_tpu_torch import parallel
    from flexflow_tpu_torch.parallel.pipeline import (pipeline,
                                                      pipeline_train_1f1b)

    stages, loss_fn = _f1b_fns()
    fn = stages[sc["stage"]]
    mesh = parallel.make_mesh(sc["mesh"])
    key = sc["data"]
    st = {k: torch.tensor(data[f"{key}/{k}"]) for k in ("w", "b")}
    hp = {"wo": torch.tensor(data[f"{key}/wo"])}
    x, lab = torch.tensor(data[f"{key}/x"]), torch.tensor(data[f"{key}/lab"])
    m = sc["micro"]
    dp = "data" if "data" in sc["mesh"] else None
    loss, g, gh, dx = pipeline_train_1f1b(fn, loss_fn, st, x, lab, mesh,
                                          num_microbatches=m,
                                          head_params=hp, data_axis=dp)
    out["loss"] = np.float64(float(loss))
    out["dx"] = dx.numpy()
    out["gh/wo"] = gh["wo"].numpy()
    for k, v in g.items():
        out[f"g/{k}"] = v.numpy()
    # GPipe on the same stages: the mean of the microbatch losses
    stg = {k: v.clone().requires_grad_() for k, v in st.items()}
    hpg = {k: v.clone().requires_grad_() for k, v in hp.items()}
    xg = x.clone().requires_grad_()
    y = pipeline(fn, stg, xg, mesh, num_microbatches=m, data_axis=dp)
    ym, lm = y.reshape(m, -1, y.shape[-1]), lab.reshape(m, -1, lab.shape[-1])
    torch.stack([loss_fn(ym[j], lm[j], hpg) for j in range(m)]).mean() \
        .backward()
    out["gpipe/dx"] = xg.grad.numpy()
    for k, v in stg.items():
        out[f"gpipe/g/{k}"] = v.grad.numpy()


def ckpt_save(sc, data, out):
    """The stack under {"pipe": 2} (momentum SGD) takes 2 steps and saves
    from every rank; the weights and optimizer state at the save."""
    from flexflow_tpu_torch import parallel
    from flexflow_tpu_torch.runtime.checkpoint import save_checkpoint

    ff, _ = stack_model(sc["mesh"], momentum=0.9,
                        device=sc.get("device", "cpu"))
    set_weights(ff, data)
    batch = {"x": data["sx"], "label": data["sy"]}
    for _ in range(2):
        ff._run_train_step(batch)
    save_checkpoint(ff, os.path.join(sc["dir"], "ckpt"), step=2)
    out["local"] = np.array(parallel.local(ff.params["stack"]["w1"]).shape)
    for op, ws in ff.params.items():
        for k in ws:
            # a copy: on the CPU get_weights may share the weight's memory,
            # which the next step updates in place
            out[f"weight/{op}.{k}"] = np.array(ff.get_weights(op, k))
    out["loss_after"] = np.float64(float(ff._run_train_step(batch)[0]))


def ckpt_restore(sc, data, out):
    """The 2-rank checkpoint restored onto this world's mesh: every state
    tensor bitwise the payload, then the next step's loss."""
    from flexflow_tpu_torch import parallel
    from flexflow_tpu_torch.runtime.checkpoint import (load_payload,
                                                       restore_checkpoint,
                                                       state_tensors)

    ff, _ = stack_model(sc["mesh"], momentum=0.9)
    d = os.path.join(sc["dir"], "ckpt")
    restore_checkpoint(ff, d, step=2)
    saved = load_payload(os.path.join(d, "step_2"))
    live = state_tensors(ff)
    out["bitwise"] = np.bool_(set(saved) >= set(live) and all(
        torch.equal(parallel.full_tensor(t), saved[k])
        for k, t in live.items()))
    out["entries"] = np.int64(len(live))
    out["local"] = np.array(parallel.local(ff.params["stack"]["w1"]).shape)
    batch = {"x": data["sx"], "label": data["sy"]}
    out["loss_after"] = np.float64(float(ff._run_train_step(batch)[0]))


def main():
    import torch.distributed as dist

    torch.set_num_threads(1)
    d = sys.argv[1]
    world = dist.get_world_size()
    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    data = np.load(os.path.join(d, "data.npz"))
    rank = dist.get_rank()
    for sc in spec["scenarios"]:
        if sc["world"] != world:
            continue
        out = {}
        {"stack": stack, "f1b": f1b, "ckpt_save": ckpt_save,
         "ckpt_restore": ckpt_restore}[sc["mode"]](dict(sc, dir=d), data,
                                                   out)
        np.savez(os.path.join(d, f"{sc['name']}.{rank}.npz"), **out)
        dist.barrier()
    print(f"TORCH-PP rank={rank} ok", flush=True)


if __name__ == "__main__":
    main()
