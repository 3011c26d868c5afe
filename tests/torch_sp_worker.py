"""A rank of ``tests/test_torch_sequence_parallel.py``: the port's ring and
Ulysses attention on this rank's sequence shard, started through the
port's launcher (``python -m flexflow_tpu_torch.launcher
tests/torch_sp_worker.py --device cpu --num-processes N --process-id R
--coordinator HOST:PORT -- DIR``). ``DIR/spec.json`` names the scenarios
of this world size, ``DIR/data.npz`` holds the inputs and the weights
(``<weights>/<op>.<weight>`` keys); each scenario's record goes to
``DIR/<name>.<rank>.npz``. Imports nothing of jax.
"""

import json
import os
import sys

import numpy as np
import torch


#: dropout draws averaged: their mean's error falls as 1 / sqrt(DRAWS);
#: at 40 (JAX's count) the largest of 512 elements sat near JAX's limits
#: (0.12 + 0.2 |x|) by chance alone, at 200 it sits near half of them
DRAWS = 200


def _t(a):
    return torch.tensor(np.asarray(a))


def attention_fns(sc, data, out):
    """ring (torch ops), ring (kernels 1 and 2: their plain versions on the
    CPU) and Ulysses on this rank's shard of q / k / v, causal and not:
    the output and the gradients of sum(out * do), local shards."""
    from flexflow_tpu_torch import parallel
    from flexflow_tpu_torch.parallel.ring_attention import (
        ring_attention, ulysses_attention)

    mesh = parallel.make_mesh({"seq": sc["world"]})
    axis = parallel.mesh_axis(mesh, "seq")
    q, k, v, do = (_t(data[n]) for n in ("q", "k", "v", "do"))
    s = q.shape[1] // axis.size
    pos = slice(axis.index * s, (axis.index + 1) * s)
    fns = {"ring": lambda *a, **kw: ring_attention(*a, use_flash=False, **kw),
           "ring_flash": ring_attention, "ulysses": ulysses_attention}
    for causal in (False, True):
        for name, fn in fns.items():
            ql, kl, vl = (t[:, pos].clone().requires_grad_()
                          for t in (q, k, v))
            o = fn(ql, kl, vl, axis, causal=causal)
            (o * do[:, pos]).sum().backward()
            tag = f"{name}/{int(causal)}"
            out[f"{tag}/out"] = o.detach().numpy()
            for g, t in (("dq", ql), ("dk", kl), ("dv", vl)):
                out[f"{tag}/{g}"] = t.grad.numpy()


def dropout(sc, data, out):
    """Attention dropout inside the ring (torch ops) and inside Ulysses'
    blockwise scan: the undropped output, and the mean of DRAWS dropped
    ones (rate 0.3, a seed each) with the first of them."""
    from flexflow_tpu_torch import parallel
    from flexflow_tpu_torch.parallel.ring_attention import (
        ring_attention, ulysses_attention)

    mesh = parallel.make_mesh({"seq": sc["world"]})
    axis = parallel.mesh_axis(mesh, "seq")
    s = data["dq"].shape[1] // axis.size
    q, k, v = (_t(data[n])[:, axis.index * s:(axis.index + 1) * s]
               for n in ("dq", "dk", "dv"))
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        base = fn(q, k, v, axis, use_flash=False)
        draws = [fn(q, k, v, axis, dropout_rate=0.3,
                    seed=torch.tensor(1000 * axis.index + i))
                 for i in range(DRAWS)]
        out[f"{name}/base"] = base.numpy()
        out[f"{name}/first"] = draws[0].numpy()
        out[f"{name}/mean"] = torch.stack(draws).mean(0).numpy()


def card(sc, data, out):
    """On the card (two gloo ranks sharing it): the ring through kernels 1
    and 2 against the torch-op ring on the same local CUDA shards, f32
    and bf16, causal and not, forward and gradients, with each kernel's
    launches; Ulysses (its all-to-alls on CUDA tensors through gloo)
    against the same; the transport's counters (the ring's point-to-point
    transfers staged through host memory); a head dim the kernels refuse
    raising rather than running the torch-op ring."""
    from flexflow_tpu_torch import parallel
    from flexflow_tpu_torch.ops import kernels
    from flexflow_tpu_torch.parallel.ring_attention import (
        ring_attention, ulysses_attention)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = parallel.make_mesh({"seq": sc["world"]}, "cuda")
    axis = parallel.mesh_axis(mesh, "seq")
    s = data["cq"].shape[1] // axis.size
    pos = slice(axis.index * s, (axis.index + 1) * s)
    parallel.reset_transport_stats()

    def run(fn, dtype, causal, **kw):
        ts = [_t(data[n])[:, pos].to(dev, dtype) for n in
              ("cq", "ck", "cv", "cdo")]
        leaves = [t.clone().requires_grad_() for t in ts[:3]]
        kernels.reset_launch_counts()
        o = fn(*leaves, axis, causal=causal, **kw)
        (o.float() * ts[3].float()).sum().backward()
        torch.cuda.synchronize()
        got = [o.detach()] + [t.grad for t in leaves]
        return [g.float().cpu().numpy() for g in got], kernels.launch_counts()

    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for causal in (False, True):
            key = f"{tag}/{int(causal)}"
            print(f"card {key}: ring", flush=True)
            got, la = run(ring_attention, dtype, causal)
            ref, la_plain = run(ring_attention, dtype, causal,
                                use_flash=False)
            print(f"card {key}: ulysses", flush=True)
            uly, la_uly = run(ulysses_attention, dtype, causal)
            for i, n in enumerate(("out", "dq", "dk", "dv")):
                out[f"ring/{key}/{n}"] = got[i]
                out[f"plain/{key}/{n}"] = ref[i]
                out[f"ulysses/{key}/{n}"] = uly[i]
            for name, counts in (("ring", la), ("plain", la_plain),
                                 ("ulysses", la_uly)):
                out[f"{name}/{key}/launches"] = np.array(
                    [counts["flash_attention_fwd"],
                     counts["flash_attention_bwd"]])
    # head dim 96 (bf16: the CUDA-core kernels) under a causal ring: the
    # same q / k / v / dO on every rank (one seed), each its shard
    g = torch.Generator(device=dev).manual_seed(96)
    full = [torch.randn(1, s * axis.size, 4, 96, device=dev, generator=g)
            for _ in range(4)]

    def run96(**kw):
        leaves = [t[:, pos].to(torch.bfloat16).requires_grad_()
                  for t in full[:3]]
        kernels.reset_launch_counts()
        o = ring_attention(*leaves, axis, causal=True, **kw)
        (o.float() * full[3][:, pos]).sum().backward()
        torch.cuda.synchronize()
        return ([t.float().cpu().numpy() for t in
                 [o.detach()] + [x.grad for x in leaves]],
                kernels.launch_counts())

    got, la = run96()
    ref, _ = run96(use_flash=False)
    for i, n in enumerate(("out", "dq", "dk", "dv")):
        out[f"hd96/ring/{n}"] = got[i]
        out[f"hd96/plain/{n}"] = ref[i]
    out["hd96/launches"] = np.array([la["flash_attention_fwd"],
                                     la["flash_attention_bwd"]])
    # a head dim the kernels are not built for (48) raises in kernel 1's
    # wrapper on each rank (before any transfer): no torch-op ring
    kernels.reset_launch_counts()
    q48 = torch.randn(1, s, 4, 48, device=dev, dtype=torch.bfloat16)
    try:
        ring_attention(q48, q48, q48, axis, causal=True)
        raised = 0
    except ValueError as e:
        raised = int("head dim 48" in str(e))
    la = kernels.launch_counts()
    out["refused/hd48"] = np.array([raised, la["flash_attention_fwd"],
                                    la["flash_attention_bwd"]])
    st = parallel.transport_stats()
    out["transport"] = np.array([st[k] for k in ("p2p_bytes",
                                                 "all_to_all_bytes",
                                                 "staged_calls")])


def _strategies(ff, mesh, am):
    from flexflow_tpu_torch.parallel import ParallelConfig

    for op in ff.ops:
        if op.inputs:
            ff.config.strategies[op.name] = ParallelConfig.from_axis_map(
                op.outputs[0].num_dims, mesh, am)


def _set(ff, data, prefix):
    for key in data.files:
        if key.startswith(prefix + "/"):
            ff.set_weights(*key[len(prefix) + 1:].split(".", 1), data[key])


def mha(sc, data, out):
    """The attention op (RoPE, GQA, causal) under the scenario's mesh and
    axis map on every op: predict, then 3 SGD steps (MSE)."""
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType,
                                    SGDOptimizer, parallel)

    b, s, d, h, kvh = sc["arch"]
    ff = FFModel(FFConfig(batch_size=b, seed=5, mesh_shape=sc["mesh"]),
                 device="cpu")
    x = ff.create_tensor([b, s, d], name="x")
    t = ff.dense(x, d, name="pre")
    t = ff.multihead_attention(t, t, t, d, h, causal=True, num_kv_heads=kvh,
                               rope=True, name="mha",
                               dropout=sc.get("dropout", 0.0))
    _strategies(ff, sc["mesh"], sc["axis_map"])
    ff.compile(SGDOptimizer(lr=0.05),
               LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               final_tensor=t)
    _set(ff, data, "mha")
    xs, ys = data["mx"], data["my"]
    if sc.get("expect_error"):
        try:
            ff.predict({"x": xs})
        except ValueError as e:
            out["error"] = np.array(str(e))
        return
    out["pred"] = ff.predict({"x": xs}).detach().numpy()
    parallel.reset_local_calls()
    out["losses"] = np.array([float(ff._run_train_step(
        {"x": xs, "label": ys})[0]) for _ in range(3)])
    out["calls"] = np.array([parallel.LOCAL_SHARD_CALLS[k] for k in
                             ("ring_attention", "ulysses_attention")])
    for op, ws in ff.params.items():
        for k in ws:
            out[f"weight/{op}.{k}"] = ff.get_weights(op, k)


def llama(sc, data, out):
    """A 2-layer narrow llama_lm (RoPE, GQA) under {"seq": n} on every op
    and ``sc["sp_mode"]``: predict, then ``fit`` over 3 batches (3 SGD
    steps); the shape of each rank's local q at the ring's entry."""
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType,
                                    MetricsType, SGDOptimizer,
                                    SingleDataLoader, parallel)
    from flexflow_tpu_torch.models import llama_lm
    from flexflow_tpu_torch.parallel import ring_attention as ra

    arch = sc["arch"]
    b = sc["batch"]
    ff = FFModel(FFConfig(batch_size=b, seed=1, mesh_shape=sc["mesh"],
                          sp_mode=sc["sp_mode"]), device="cpu")
    x, logits = llama_lm(ff, b, **arch)
    _strategies(ff, sc["mesh"], {"seq": 1})
    ff.compile(SGDOptimizer(lr=0.05),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY], final_tensor=logits)
    _set(ff, data, "llama")
    xs, ys = data["lx"], data["ly"]
    shapes = []
    fn = "ring_attention" if sc["sp_mode"] == "ring" else "ulysses_attention"
    inner = getattr(ra, fn)

    def seen(q, *a, **kw):
        shapes.append(tuple(q.shape))
        return inner(q, *a, **kw)

    setattr(ra, fn, seen)
    try:
        out["pred"] = ff.predict({"input": xs[:b]}).detach().numpy()
        SingleDataLoader(ff, x, xs)
        SingleDataLoader(ff, ff.label_tensor, ys)
        parallel.reset_local_calls()
        ff.fit(epochs=1, verbose=False)
    finally:
        setattr(ra, fn, inner)
    out["last_loss"] = np.float64(float(ff._last_loss))
    out["q_shapes"] = np.array(sorted(set(shapes)))
    out["calls"] = np.int64(parallel.LOCAL_SHARD_CALLS[fn])
    for op, ws in ff.params.items():
        for k in ws:
            out[f"weight/{op}.{k}"] = ff.get_weights(op, k)


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
        {"fns": attention_fns, "dropout": dropout, "mha": mha,
         "llama": llama, "card": card}[sc["mode"]](sc, data, out)
        np.savez(os.path.join(d, f"{sc['name']}.{rank}.npz"), **out)
        dist.barrier()
    print(f"TORCH-SP rank={rank} ok", flush=True)


if __name__ == "__main__":
    main()
