"""The port's serving engine and ``generate`` under a head-sharded mesh,
against the JAX package's under the same mesh and table.

Two gloo ranks (``tests/torch_tp_worker.py``, started through the port's
launcher as ``tests/test_torch_distributed.py`` starts its ranks; the
spawn bounded by ``SPAWN_TIMEOUT``) serve a 2-layer ``llama_lm`` (hidden
128, 4 heads of 32 over 2 kv heads — a head dim kernel 1 takes —, vocab
61, f32) under ``{"data": 1, "model":
2}``: attention and the gate / up projections split on their hidden dim
over "model" (JAX's ``test_generate_under_head_sharded_tp`` table, the up
projection beside the gate). Each rank holds 2 q heads and 1 kv head; its
pool holds that kv head only. A straddling GQA case (6 heads over 3 kv
heads, hidden 192) keeps ``wk`` / ``wv`` replicated (the head degree does
not divide the kv heads, as in JAX) and its pools take one kv head a
local q head (the group-1 layout, rank 0 kv heads 0, 0, 1).

The JAX side runs in this process on the conftest's CPU devices
(``paged_attention_impl="einsum"``, its CPU route), the weights numpy
draws (``numpy_init``) carried into the port (``params_from_jax``, each
rank keeping its slice). Limits, f32: greedy tokens identical — both
ranks to each other, to JAX's engine under the same mesh and to JAX's
``{"data": 1}`` engine —, the first token's logits within 1e-5, scores
within 1e-5; the quantizing prefill write's pages and scales bitwise the
rank's slice of JAX's whole-pool write (the plain write on the same slab,
as ``test_torch_quantized_serving.py`` holds it).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu.parallel.pconfig import ParallelConfig as JParallelConfig
from flexflow_tpu.runtime.generation import Generator as JGenerator
from test_torch_zoo import numpy_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_worker.py")
sys.path.insert(0, os.path.dirname(WORKER))
import torch_ranks  # noqa: E402
SPAWN_TIMEOUT = 240

VOCAB = 61
ARCH = dict(seq_len=16, hidden=128, layers=2, heads=4, kv_heads=2,
            vocab_size=VOCAB)
STRADDLE = dict(ARCH, hidden=192, heads=6, kv_heads=3)
MESH = {"data": 1, "model": 2}
ENGINE = dict(serve_slots=2, kv_page_size=4, max_seq_len=48)
MAX_NEW = 6
GEN_PROMPT = (np.arange(10, dtype=np.int32).reshape(2, 5) * 7) % VOCAB
TOL = dict(rtol=1e-5, atol=1e-5)


def _prompts():
    """Three prompts behind one 8-token (two-page) prefix: the second
    round of the same prompts hits the prefix cache."""
    rs = np.random.RandomState(3)
    pre = rs.randint(0, VOCAB, 8)
    return [np.concatenate([pre, rs.randint(0, VOCAB, n)]).astype(np.int32)
            for n in (3, 9, 1)]


SCENARIOS = {
    "native": dict(mode="serve", arch=ARCH, weights="w4", rounds=2,
                   engine=ENGINE),
    "int8": dict(mode="serve", arch=ARCH, weights="w4",
                 engine=dict(ENGINE, kv_cache_dtype="int8")),
    "fp8": dict(mode="serve", arch=ARCH, weights="w4",
                engine=dict(ENGINE, kv_cache_dtype="fp8")),
    "straddle": dict(mode="serve", arch=STRADDLE, weights="w6",
                     engine=ENGINE),
    "generate": dict(mode="generate", arch=ARCH, weights="w4",
                     gen_prompt=GEN_PROMPT.tolist()),
    "trained": dict(mode="trained", arch=ARCH, weights="w4", trained=True,
                    engine=ENGINE, gen_prompt=GEN_PROMPT.tolist()),
    "write_int8": dict(mode="prefill_write", arch=STRADDLE, weights="w6",
                       kv="int8"),
    "write_fp8": dict(mode="prefill_write", arch=ARCH, weights="w4",
                      kv="fp8"),
}


def _jax_model(arch, mesh):
    cfg = JConfig(batch_size=2, mesh_shape=dict(mesh))
    if "model" in mesh:
        for i in range(arch["layers"]):
            for op in ("attn", "ffn_gate", "ffn_up"):
                cfg.strategies[f"{op}_{i}"] = JParallelConfig.from_axis_map(
                    3, mesh, {"data": 0, "model": 2})
    ff = JModel(cfg)
    _, logits = j_llama_lm(ff, 2, **arch)
    ff.compile(final_tensor=logits)
    return ff


def _np_params(jff):
    return {f"{op}.{w}": np.asarray(a) for op, ws in jff.params.items()
            for w, a in ws.items()}






def _jax_serve(jff, engine, prompts, rounds=1):
    eng = jff.make_serving_engine(paged_attention_impl="einsum", **engine)
    toks = [[list(q.tokens) for q in eng.run(prompts, max_new_tokens=MAX_NEW)]
            for _ in range(rounds)]
    return toks, eng.stats()


def _jax_first_logits(jff, prompt):
    n = prompt.size
    bucket = max(8, 1 << int(np.ceil(np.log2(n))))
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = prompt
    gen = JGenerator(jff)
    caches = {op.name: op.init_cache(1, bucket, jnp.float32)
              for op in gen.attn_ops}
    logits, _ = gen._prefill(jff.params, jff.bn_state, jnp.asarray(padded),
                             caches, jnp.asarray([n], np.int32), 0)
    return np.asarray(logits)[:, -1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The ranks' records ({scenario: [rank 0, rank 1]}) and JAX's."""
    import json

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    d = str(tmp_path_factory.mktemp("torch_tp"))
    prompts = _prompts()
    procs = []
    mp = pytest.MonkeyPatch()
    try:
        numpy_init(mp)
        jdp = {k: _jax_model(a, {"data": 1}) for k, a in
               (("w4", ARCH), ("w6", STRADDLE))}
        for k, jff in jdp.items():
            np.savez(os.path.join(d, f"{k}.npz"), **_np_params(jff))
        scs = [dict(sc, name=n, mesh=MESH, max_new=MAX_NEW,
                    prompts=[p.tolist() for p in prompts])
               for n, sc in SCENARIOS.items()]
        with open(os.path.join(d, "spec.json"), "w") as f:
            json.dump({"scenarios": scs}, f)
        procs = torch_ranks.spawn(WORKER, d, 2)
        jtp = {k: _jax_model(a, MESH) for k, a in
               (("w4", ARCH), ("w6", STRADDLE))}
        jax = {"dp_native": _jax_serve(jdp["w4"], ENGINE, prompts, 2),
               "dp_straddle": _jax_serve(jdp["w6"], ENGINE, prompts)}
        for name, sc in SCENARIOS.items():
            if sc["mode"] == "serve":
                jax[name] = _jax_serve(jtp[sc["weights"]], sc["engine"],
                                       prompts, sc.get("rounds", 1))
        jax["logits"] = {k: _jax_first_logits(jtp[k], prompts[0])
                         for k in jtp}
        jff = jtp["w4"]
        jax["gen"] = {"greedy": jff.generate(GEN_PROMPT, MAX_NEW),
                      "scored": jff.generate(GEN_PROMPT, MAX_NEW,
                                             return_scores=True),
                      "beams": jff.generate(GEN_PROMPT, MAX_NEW,
                                            num_beams=2)}
        jax["dp_gen"] = jdp["w4"].generate(GEN_PROMPT, MAX_NEW)
        jax["same_weights"] = all(
            np.array_equal(a, _np_params(jtp[k])[key])
            for k in jtp for key, a in _np_params(jdp[k]).items())
        jax["writes"] = {n: _jax_write(jdp[sc["weights"]], sc["kv"])
                         for n, sc in SCENARIOS.items()
                         if sc["mode"] == "prefill_write"}
        torch_ranks.wait(procs, "TORCH-TP", SPAWN_TIMEOUT)
    finally:
        torch_ranks.kill(procs)
        mp.undo()
        torch.set_num_threads(threads)
    ranks = {n: [dict(np.load(os.path.join(d, f"{n}.{r}.npz")))
                 for r in range(2)] for n in SCENARIOS}
    return ranks, jax, prompts


def _jax_write(jff, kv):
    """JAX's plain quantizing prefill write (the einsum branch, eagerly)
    of the worker's slab over every kv head."""
    op = next(o for o in jff.ops if o.name == "attn_0")
    rs = np.random.RandomState(5)
    kh = (rs.randn(1, 10, op.num_kv_heads, op.qk_head_dim) * 4) \
        .astype(np.float32)
    vh = (rs.randn(1, 10, op.num_kv_heads, op.qk_head_dim) * 0.03) \
        .astype(np.float32)
    pool = op.init_paged_cache(6, 4, jnp.float32, kv_dtype=kv)
    out = op.paged_prefill_write(pool, jnp.asarray(kh), jnp.asarray(vh),
                                 jnp.asarray([4, 1, 3], np.int32))
    res = {}
    for k, a in out.items():
        a = np.asarray(a)
        res[k] = a.view(np.uint8) if a.dtype.itemsize == 1 else a
    return res


def _tokens(rec, rounds=1, n=3):
    return [[list(rec[f"tokens/{r}/{i}"]) for i in range(n)]
            for r in range(rounds)]


@pytest.mark.parametrize("name", ["native", "int8", "fp8", "straddle"])
def test_tokens_equal_jax_engine_under_the_mesh(results, name):
    """Both ranks' greedy tokens are each other's and JAX's engine's under
    the same mesh and table; the native and straddling ones are also
    JAX's ``{"data": 1}`` engine's."""
    ranks, jax, _ = results
    rounds = SCENARIOS[name].get("rounds", 1)
    got = [_tokens(r, rounds) for r in ranks[name]]
    assert got[0] == got[1]
    assert got[0] == jax[name][0]
    if name in ("native", "straddle"):
        assert got[0] == jax[f"dp_{name}"][0]


def test_pools_hold_the_local_kv_heads(results):
    """Each rank's pool holds its head layout's kv heads: one of 2 (half
    the bytes of JAX's whole pool), and in the straddling case 3 — one a
    local q head, group 1 — with the duplicated head's bytes stated."""
    ranks, jax, _ = results
    for r, rec in enumerate(ranks["native"]):
        assert list(rec["layout/attn_0"]) == [2 * r, 2, 2, r]
        assert list(rec["pool_shape/attn_1"][2:]) == [1, 32]
        assert rec["stats/kv_pool_bytes"] * 2 == \
            jax["native"][1]["kv_pool_bytes"]
        assert rec["stats/kv_heads_duplicated"] == 0
    want = {0: [0, 3, 1, 0, 0, 1], 1: [3, 3, 1, 1, 2, 2]}
    for r, rec in enumerate(ranks["straddle"]):
        assert list(rec["layout/attn_1"]) == want[r]
        assert list(rec["pool_shape/attn_0"][2:]) == [3, 32]
        assert rec["stats/kv_heads_duplicated"] == 2
        assert rec["stats/kv_duplicated_bytes"] * 3 == \
            rec["stats/kv_pool_bytes"]


def test_prefix_hits_equal_jax(results):
    """The second round hits the prefix cache as often as JAX's engine,
    and every page comes back."""
    ranks, jax, _ = results
    for rec in ranks["native"]:
        assert rec["stats/prefix_hits"] == jax["native"][1]["prefix_hits"]
        assert rec["stats/prefix_hits"] > 0
        assert rec["stats/completed"] == 6


@pytest.mark.parametrize("name", ["native", "straddle"])
def test_first_logits_within_1e5(results, name):
    ranks, jax, prompts = results
    want = jax["logits"][SCENARIOS[name]["weights"]]
    for rec in ranks[name]:
        np.testing.assert_allclose(rec["logits"], want, **TOL)


def test_generate_matches_jax_under_the_mesh(results):
    """greedy, scored (1e-5) and beams equal JAX's TP ``generate`` (the
    ``test_generate_under_head_sharded_tp`` form) on both ranks."""
    ranks, jax, _ = results
    g = jax["gen"]
    assert jax["same_weights"]
    for rec in ranks["generate"]:
        np.testing.assert_array_equal(rec["gen/greedy"], g["greedy"])
        np.testing.assert_array_equal(rec["gen/scored"], g["scored"][0])
        np.testing.assert_allclose(rec["gen/scores"], g["scored"][1], **TOL)
        np.testing.assert_array_equal(rec["gen/beams"], g["beams"])


@pytest.mark.parametrize("name", ["write_int8", "write_fp8"])
def test_quantized_write_is_the_slice_of_jax(results, name):
    """Kernel 5's plain version on a rank's kv heads: pages and per-(page,
    kv head) scales bitwise JAX's whole-pool write at those heads."""
    ranks, jax, _ = results
    want = jax["writes"][name]
    for rec in ranks[name]:
        sel = list(rec["kv_heads"])
        for k in ("k", "v"):
            np.testing.assert_array_equal(rec[f"pool/{k}"],
                                          want[k][:, :, sel])
            np.testing.assert_array_equal(rec[f"pool/{k}_scale"],
                                          want[f"{k}_scale"][:, sel])


@pytest.mark.parametrize("name", ["native", "int8", "straddle"])
def test_every_kernel_call_counted_on_local_shards(results, name):
    """``LOCAL_SHARD_CALLS`` counts every call of kernels 1, 4 and 5 (and
    the grouped cache attention of a prefix hit) on a rank's shards; the
    paged kernel's plain version calls the grouped attention itself."""
    ranks, _, _ = results
    for rec in ranks[name]:
        for k in ("flash_attention_fwd", "paged_attention_fwd",
                  "paged_prefill_write_layers"):
            assert rec[f"local_calls/{k}"] == rec[f"calls/{k}"] > 0, k
        assert rec["local_calls/grouped_cache_attention"] + \
            rec["calls/paged_attention_fwd"] == \
            rec["calls/grouped_cache_attention"]


def test_trained_mesh_model_generates_and_serves(results):
    """ROADMAP fault 9: a model compiled with an optimizer under the mesh
    (its weights DTensors) raised on ``generate`` and in the engine (a
    plain token tensor met a DTensor embedding table); JAX's decodes.
    Now both ranks give JAX's ``{"data": 1}`` tokens."""
    ranks, jax, _ = results
    for rec in ranks["trained"]:
        np.testing.assert_array_equal(rec["gen/greedy"], jax["dp_gen"])
        assert _tokens(rec) == jax["dp_native"][0][:1]


def test_one_device_mesh_serves_as_no_mesh():
    """``{"data": 1}`` in one process (a world of one) serves and
    generates exactly as the model without a mesh."""
    import torch.distributed as dist

    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import llama_lm

    def build(mesh):
        ff = FFModel(FFConfig(batch_size=2, mesh_shape=mesh), device="cpu")
        _, logits = llama_lm(ff, 2, **ARCH)
        ff.compile(final_tensor=logits)
        return ff

    prompts = _prompts()
    a = build(None)
    want = [list(q.tokens) for q in a.make_serving_engine(**ENGINE).run(
        prompts, max_new_tokens=MAX_NEW)]
    try:
        b = build({"data": 1})
        assert b.mesh is not None
        got = [list(q.tokens) for q in b.make_serving_engine(**ENGINE).run(
            prompts, max_new_tokens=MAX_NEW)]
        assert got == want
        np.testing.assert_array_equal(b.generate(GEN_PROMPT, MAX_NEW),
                                      a.generate(GEN_PROMPT, MAX_NEW))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_out_of_scope_features_refused_under_a_mesh():
    """Speculation, LoRA pools, the host tier, weight quantization,
    ``swap_weights`` and ``generate_seq2seq`` name ROADMAP item 8; a fleet
    of replicas names item 9."""
    import torch.distributed as dist

    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import llama_lm
    from flexflow_tpu_torch.runtime.router import ServingRouter
    from flexflow_tpu_torch.runtime.seq2seq_generation import \
        Seq2SeqGenerator

    try:
        ff = FFModel(FFConfig(batch_size=2, mesh_shape={"data": 1}),
                     device="cpu")
        _, logits = llama_lm(ff, 2, **ARCH)
        ff.compile(final_tensor=logits)
        for kw in (dict(speculate_k=2), dict(adapter_pool_pages=2),
                   dict(host_kv_pages=4), dict(weight_dtype="int8")):
            with pytest.raises(NotImplementedError, match="item 8"):
                ff.make_serving_engine(**ENGINE, **kw)
        with pytest.raises(NotImplementedError, match="item 8"):
            ff.generate(GEN_PROMPT, 2, quantize="int8")
        eng = ff.make_serving_engine(**ENGINE)
        with pytest.raises(NotImplementedError, match="item 8"):
            eng.swap_weights(None, "v1")
        with pytest.raises(NotImplementedError, match="item 8"):
            Seq2SeqGenerator(ff)
        with pytest.raises(NotImplementedError, match="item 9"):
            ServingRouter(ff, replicas=1, start=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
