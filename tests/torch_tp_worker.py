"""A rank of ``tests/test_torch_tp_serving.py``: the port's serving engine
and ``generate`` under a head-sharded mesh, started through the port's
launcher (``python -m flexflow_tpu_torch.launcher tests/torch_tp_worker.py
--device cpu --num-processes 2 --process-id R --coordinator HOST:PORT --
DIR``). ``DIR/spec.json`` names the scenarios, ``DIR/<weights>.npz`` holds
the weights (the JAX model's, ``op.weight`` keys); each scenario's record
goes to ``DIR/<name>.<rank>.npz``.
"""

import json
import os
import sys

import numpy as np
import torch


def table(mesh, layers, ops=("attn", "ffn_gate", "ffn_up")):
    """The head table: attention and the gate / up projections split on
    their hidden dim over "model" (JAX's ``test_generate_under_head_sharded
    _tp`` form, with the up projection beside the gate)."""
    from flexflow_tpu_torch.parallel import ParallelConfig

    return {f"{op}_{i}": ParallelConfig.from_axis_map(
        3, mesh, {"data": 0, "model": 2})
        for i in range(layers) for op in ops}


def build(sc, weights, device="cpu"):
    """The scenario's llama under its mesh and table, the weights of
    ``weights`` (``op.weight`` -> array) carried in; compiled for serving,
    or with ``sc["trained"]`` with an optimizer (f32 master weights, as a
    trained model reaches ``generate``)."""
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType,
                                    MetricsType, SGDOptimizer)
    from flexflow_tpu_torch.convert import params_from_jax
    from flexflow_tpu_torch.models import llama_lm

    arch = sc["arch"]
    mesh = sc.get("mesh")
    cfg = FFConfig(batch_size=2, mesh_shape=mesh)
    if mesh:
        cfg.strategies.update(table(mesh, arch["layers"]))
    ff = FFModel(cfg, device=device)
    _, logits = llama_lm(ff, 2, **arch)
    if sc.get("trained"):
        ff.compile(SGDOptimizer(lr=0.1),
                   LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   [MetricsType.METRICS_ACCURACY], final_tensor=logits)
        for key in weights.files:
            ff.set_weights(*key.split(".", 1), weights[key])
        return ff
    ff.compile(final_tensor=logits)
    tree = {}
    for key in weights.files:
        op, w = key.split(".", 1)
        tree.setdefault(op, {})[w] = weights[key]
    ff.params = params_from_jax(tree, device, torch.float32, model=ff)
    return ff


def trained(sc, weights, out):
    """A model compiled with an optimizer under the mesh (weights
    DTensors) reaches ``generate`` and the engine."""
    ff = build(sc, weights)
    prompt = np.asarray(sc["gen_prompt"], np.int32)
    out["gen/greedy"] = ff.generate(prompt, sc["max_new"])
    reqs = ff.make_serving_engine(**sc["engine"]).run(
        [np.asarray(p, np.int32) for p in sc["prompts"]],
        max_new_tokens=sc["max_new"])
    for i, q in enumerate(reqs):
        out[f"tokens/0/{i}"] = np.asarray(q.tokens, np.int32)


def counting(kernels, names):
    """Count every call of the wrappers ``names`` (patched on the module,
    where the ops and the engine look them up)."""
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(kernels, n)

        def wrap(*a, _fn=fn, _n=n, **k):
            calls[_n] += 1
            return _fn(*a, **k)

        setattr(kernels, n, wrap)
    return calls


WRAPPERS = ("flash_attention_fwd", "paged_attention_fwd",
            "paged_prefill_write_layers", "grouped_cache_attention")


def serve(sc, weights, out):
    """Two rounds of the prompts through one engine (the second hits the
    prefix cache), the first prompt's prefill logits, and the pool's
    head layout and bytes."""
    from flexflow_tpu_torch import parallel
    from flexflow_tpu_torch.ops import kernels

    ff = build(sc, weights)
    prompts = [np.asarray(p, np.int32) for p in sc["prompts"]]
    eng = ff.make_serving_engine(**sc["engine"])
    base = dict(parallel.LOCAL_SHARD_CALLS)
    calls = counting(kernels, WRAPPERS)
    for r in range(sc.get("rounds", 1)):
        reqs = eng.run(prompts, max_new_tokens=sc["max_new"])
        for i, q in enumerate(reqs):
            out[f"tokens/{r}/{i}"] = np.asarray(q.tokens, np.int32)
    now = parallel.LOCAL_SHARD_CALLS
    for n in WRAPPERS:
        out[f"calls/{n}"] = np.int64(calls[n])
        out[f"local_calls/{n}"] = np.int64(now.get(n, 0) - base.get(n, 0))
    st = eng.stats()
    for k in ("prefix_hits", "completed", "free_pages", "kv_pages",
              "kv_pool_bytes", "kv_heads_local", "kv_heads_duplicated",
              "kv_duplicated_bytes"):
        out[f"stats/{k}"] = np.int64(st.get(k, -1))
    for op in eng.gen.attn_ops:
        lay = op.head_layout()
        out[f"layout/{op.name}"] = np.asarray(
            [lay.q_start, lay.q_heads, lay.group] + list(lay.kv_heads))
        out[f"pool_shape/{op.name}"] = np.asarray(eng.pool[op.name]["k"].shape)
    gen = eng.gen
    n = prompts[0].size
    bucket = eng._bucket(n)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = prompts[0]
    with torch.no_grad():
        logits, _ = gen._prefill(gen.params(), torch.as_tensor(padded),
                                 eng._new_caches(gen, bucket),
                                 torch.as_tensor(np.asarray([n], np.int32)))
    out["logits"] = logits[:, -1].numpy()


def generate(sc, weights, out):
    """``FFModel.generate``: greedy, scored and beams."""
    ff = build(sc, weights)
    prompt = np.asarray(sc["gen_prompt"], np.int32)
    n = sc["max_new"]
    out["gen/greedy"] = ff.generate(prompt, n)
    toks, scores = ff.generate(prompt, n, return_scores=True)
    out["gen/scored"], out["gen/scores"] = toks, scores
    out["gen/beams"] = ff.generate(prompt, n, num_beams=2)


def prefill_write(sc, weights, out):
    """Kernel 5 on this rank's kv heads of a quantized pool: the plain
    version's pages and scales for a fixed slab (the test holds them to
    the slice of JAX's whole-pool write)."""
    from flexflow_tpu_torch.ops import kernels

    ff = build(sc, weights)
    op = next(o for o in ff.ops if o.name == "attn_0")
    lay = op.head_layout()
    rs = np.random.RandomState(5)
    kh = (rs.randn(1, 10, op.num_kv_heads, op.qk_head_dim) * 4) \
        .astype(np.float32)
    vh = (rs.randn(1, 10, op.num_kv_heads, op.qk_head_dim) * 0.03) \
        .astype(np.float32)
    sel = list(lay.kv_heads)
    pool = op.init_paged_cache(6, 4, torch.float32, torch.device("cpu"),
                               kv_dtype=sc["kv"])
    kernels.paged_prefill_write_layers(
        [pool["k"]], [pool["v"]], [torch.as_tensor(kh[:, :, sel])],
        [torch.as_tensor(vh[:, :, sel])],
        torch.as_tensor(np.asarray([4, 1, 3], np.int32)),
        [pool["k_scale"]], [pool["v_scale"]])
    for k, t in pool.items():
        out[f"pool/{k}"] = (t.view(torch.uint8) if t.element_size() == 1
                            else t).numpy()
    out["kv_heads"] = np.asarray(sel)


def main():
    import torch.distributed as dist

    torch.set_num_threads(1)
    d = sys.argv[1]
    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    rank = dist.get_rank()
    for sc in spec["scenarios"]:
        weights = np.load(os.path.join(d, sc["weights"] + ".npz"))
        out = {}
        {"serve": serve, "generate": generate, "trained": trained,
         "prefill_write": prefill_write}[sc["mode"]](sc, weights, out)
        np.savez(os.path.join(d, f"{sc['name']}.{rank}.npz"), **out)
        dist.barrier()
    print(f"TORCH-TP rank={rank} ok", flush=True)


if __name__ == "__main__":
    main()
