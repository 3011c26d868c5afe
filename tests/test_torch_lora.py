"""LoRA adapters in the PyTorch port's serving engine, against the JAX
package.

  * ``ops/lora.py``: ``gather_op_lora`` and ``lora_delta`` against JAX's on
    the same numpy pool and inputs, within 1e-6 (f32 through the rank);
    the pool written in place, the null page 0 giving exactly zero.
  * ``runtime/lora.py``: ``LoraAdapterPool`` driven through the same
    sequences as JAX's (refcounts, LRU among refcount-0 pages, a pool full
    of pinned pages refusing, re-registering) — same pages, same faults,
    same stats.
  * the engine (the small f32 Llama of tests/test_torch_serving.py, hidden
    64, 2 layers, JAX weights carried across with ``params_from_jax``):
    tenants mixed across the slots give the JAX engine's greedy tokens and
    adapter counters; an adapter's stream equals a model whose Linear
    kernels were merged with ``a @ b * alpha / rank``; a pool-less engine
    and the null adapter give the base model's tokens; the prefix cache is
    namespaced per adapter, and re-registering an adapter flushes its
    namespace.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu.ops import lora as j_lora
from flexflow_tpu.runtime.lora import LoraAdapterPool as JPool
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import llama_lm
from flexflow_tpu_torch.ops import lora as t_lora
from flexflow_tpu_torch.runtime.lora import LoraAdapterPool as TPool

VOCAB = 89
ARCH = dict(seq_len=16, hidden=64, layers=2, heads=4, kv_heads=2,
            vocab_size=VOCAB)
ENGINE = dict(serve_slots=3, kv_page_size=4, max_seq_len=48)
RANK = 4
MAX_NEW = 5
ADAPTER_STATS = ("adapter_pool_pages", "adapters_registered",
                 "adapters_resident", "adapter_pages_in_use",
                 "adapter_pool_occupancy", "adapter_lookups", "adapter_hits",
                 "adapter_faults", "adapter_evictions", "adapter_refs_live",
                 "lora_rank", "requests_by_adapter", "prefix_hits",
                 "prefix_lookups", "free_pages", "tokens_generated")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread runs them faster than the
    default pool, whose threads spin against the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Op:
    def __init__(self, name, din, dout):
        self.name, self.in_dim, self.out_dim = name, din, dout


def _weights(geometry, seed, scale=0.3, rank=RANK, ops=None):
    rs = np.random.RandomState(seed)
    return {name: {"a": (rs.randn(din, rank) * scale).astype(np.float32),
                   "b": (rs.randn(rank, dout) * scale).astype(np.float32)}
            for name, (din, dout) in geometry.items()
            if ops is None or name in ops}


# ---- ops/lora.py -------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 1, 12), (3, 5, 12), (2, 12)],
                         ids=["decode", "slab", "rows"])
def test_gather_and_delta_match_jax(shape):
    """Pages written into both pools, gathered per row, and the delta of a
    (B, ..., in) input: within 1e-6 of JAX's; page 0 gives exactly 0."""
    ops = [_Op("l1", 12, 7), _Op("l2", 7, 12)]
    pages, rs = 3, np.random.RandomState(0)
    jpool = j_lora.init_lora_pool(ops, pages, RANK)
    tpool = t_lora.init_lora_pool(ops, pages, RANK, "cpu")
    for page in (1, 2, 3):
        payload = _weights({o.name: (o.in_dim, o.out_dim) for o in ops},
                           page)
        scale = 0.5 * page
        jpool = j_lora.write_adapter_page(jpool, page, payload, scale)
        ptr = tpool["l1"]["a"].data_ptr()
        t_lora.write_adapter_page(tpool, page, payload, scale)
        assert tpool["l1"]["a"].data_ptr() == ptr, "written in place"
    for name in ("l1", "l2"):
        for w in ("a", "b"):
            np.testing.assert_array_equal(tpool[name][w].numpy(),
                                          np.asarray(jpool[name][w]))
    rows = np.asarray([2, 0, 3][:shape[0]], np.int32)
    x = rs.randn(*shape).astype(np.float32)
    ja = j_lora.gather_op_lora(jpool, "l1", rows)
    ta = t_lora.gather_op_lora(tpool, "l1", torch.from_numpy(rows))
    assert t_lora.gather_op_lora(tpool, "nope", torch.from_numpy(rows)) \
        is None
    for j, t in zip(ja, ta):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    want = np.asarray(j_lora.lora_delta(jnp.asarray(x), *ja))
    got = t_lora.lora_delta(torch.from_numpy(x), *ta).numpy()
    assert got.shape == want.shape == shape[:-1] + (7,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not np.any(got[rows == 0])
    z = t_lora.zero_payload(ops, RANK)
    assert z["l2"]["a"].shape == (7, RANK) and not z["l2"]["b"].any()


# ---- runtime/lora.py ---------------------------------------------------------


def _pool_pair(pages):
    ops = [_Op("l1", 8, 12), _Op("l2", 12, 8)]
    return JPool(pages, RANK, ops), TPool(pages, RANK, ops)


def _drive(pool, steps):
    """Run a checkout / release / register sequence; record each outcome."""
    out = []
    for op, name, *seed in steps:
        try:
            if op == "reg":
                pool.register(name, _weights(pool.geometry, seed[0]))
                out.append(("reg", pool.lookup_page(name)))
            elif op == "out":
                got = pool.checkout(name)
                out.append(None if got is None
                           else (got[0], got[1] is not None))
            else:
                pool.release(name)
                out.append("rel")
        except (ValueError, KeyError, AssertionError) as e:
            out.append(type(e).__name__)
    return out + [pool.stats(), pool.live_refs(), pool.pages_in_use()]


SEQUENCES = {
    "refcounts_and_hits": (2, [("reg", "a", 0), ("out", "a"), ("out", "a"),
                               ("rel", "a"), ("rel", "a"), ("rel", "a"),
                               ("out", "ghost")]),
    "lru_prefers_oldest_ref0": (2, [("reg", "a", 0), ("reg", "b", 1),
                                    ("reg", "c", 2), ("out", "a"),
                                    ("rel", "a"), ("out", "b"), ("rel", "b"),
                                    ("out", "c"), ("out", "a"),
                                    ("out", "b")]),
    "pinned_full_refuses": (1, [("reg", "a", 0), ("reg", "b", 1),
                                ("out", "a"), ("out", "b"), ("rel", "a"),
                                ("out", "b")]),
    "reregister_unless_pinned": (1, [("reg", "a", 0), ("out", "a"),
                                     ("reg", "a", 9), ("rel", "a"),
                                     ("reg", "a", 9), ("out", "a"),
                                     ("rel", "a")]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_adapter_pool_sequence_matches_jax(name):
    pages, steps = SEQUENCES[name]
    jp, tp = _pool_pair(pages)
    assert _drive(tp, steps) == _drive(jp, steps)


def test_adapter_pool_validation_matches_jax():
    for pool in _pool_pair(2):
        with pytest.raises(ValueError, match="not a LoRA-targeted"):
            pool.register("x", {"nope": {"a": np.zeros((8, RANK)),
                                         "b": np.zeros((RANK, 12))}})
        with pytest.raises(ValueError, match="pool geometry"):
            pool.register("x", {"l1": {"a": np.zeros((8, RANK + 1)),
                                       "b": np.zeros((RANK + 1, 12))}})
        with pytest.raises(ValueError, match="non-empty"):
            pool.register("x", {})


# ---- the engine --------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jff = JModel(JConfig(batch_size=2, mesh_shape={"data": 1}))
    _, logits = j_llama_lm(jff, 2, **ARCH)
    jff.compile(final_tensor=logits)
    tff = FFModel(FFConfig(batch_size=2), device="cpu")
    _, logits = llama_lm(tff, 2, **ARCH)
    tff.compile(final_tensor=logits)
    tff.params = params_from_jax(
        {op: {w: np.asarray(a) for w, a in ws.items()}
         for op, ws in jff.params.items()}, "cpu", torch.float32, model=tff)
    return jff, tff


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(3)
    return [rs.randint(1, VOCAB, size=n).astype(np.int32)
            for n in (5, 11, 3, 9, 14, 7)]


def _register(eng, names, seeds, **kw):
    for n, s in zip(names, seeds):
        eng.register_adapter(n, _weights(eng.lora.geometry, s), alpha=8.0,
                             **kw)


def _mixed(eng, prompts, tenants):
    reqs = [eng.submit(p, MAX_NEW, adapter=a)
            for p, a in zip(prompts, tenants)]
    while eng.step():
        pass
    return reqs


@pytest.mark.parametrize("knobs", [{}, dict(prefill_chunk=8),
                                   dict(prefill_chunk=8,
                                        prefill_interleave_chunks=1)],
                         ids=["whole", "chunked", "interleaved"])
def test_mixed_tenants_match_jax_engine(models, prompts, knobs):
    """Three adapters and the base model mixed across three slots, through
    a 2-page pool (adapter faults and LRU evictions), the prefix cache on,
    the prompts prefilled whole, chunked or chunk-interleaved: the JAX
    engine's tokens, hits and adapter ledger; adapters move tokens; each
    tenant's tokens equal its own single-tenant run."""
    jff, tff = models
    tenants = ["a", None, "b", "c", "a", "b"]
    kw = dict(ENGINE, adapter_pool_pages=2, lora_rank=RANK, **knobs)
    j_eng = jff.make_serving_engine(paged_attention_impl="einsum", **kw)
    eng = tff.make_serving_engine(**kw)
    for e in (j_eng, eng):
        _register(e, "abc", (1, 2, 3))
    jr, tr = _mixed(j_eng, prompts, tenants), _mixed(eng, prompts, tenants)
    for a, b in zip(jr, tr):
        assert b.state == a.state == "done"
        assert b.tokens == a.tokens, b.rid
    st, jst = eng.stats(), j_eng.stats()
    for key in ADAPTER_STATS:
        assert st[key] == jst[key], key
    assert st["adapter_evictions"] > 0 and st["adapter_refs_live"] == 0
    if knobs:
        return
    base = tff.make_serving_engine(**ENGINE).run(prompts, MAX_NEW)
    assert any(b.tokens != r.tokens
               for b, r, t in zip(base, tr, tenants) if t is not None)
    solo = tff.make_serving_engine(**kw)
    _register(solo, "abc", (1, 2, 3))
    for i, (p, t) in enumerate(zip(prompts, tenants)):
        one = solo.run([p], MAX_NEW, adapter=t)[0]
        assert one.tokens == tr[i].tokens, i


def test_adapter_stream_equals_merged_weights(models, prompts):
    """An adapter served from the pool gives the tokens of a model whose
    Linear kernels were merged with a @ b * alpha / rank (f32), with and
    without a draft (the verify pass applies the adapter too)."""
    jff, tff = models
    eng = tff.make_serving_engine(adapter_pool_pages=1, lora_rank=RANK,
                                  prefix_cache=False, **ENGINE)
    w = _weights(eng.lora.geometry, 5)
    eng.register_adapter("t", w, alpha=8.0)
    got = eng.run(prompts, MAX_NEW, adapter="t")
    merged = FFModel(FFConfig(batch_size=2), device="cpu")
    _, logits = llama_lm(merged, 2, **ARCH)
    merged.compile(final_tensor=logits)
    merged.params = {op: {k: v.clone() for k, v in ws.items()}
                     for op, ws in tff.params.items()}
    for name, ab in w.items():
        merged.params[name]["kernel"] += torch.from_numpy(
            ab["a"] @ ab["b"] * (8.0 / RANK))
    want = merged.make_serving_engine(prefix_cache=False, **ENGINE).run(
        prompts, MAX_NEW)
    for g, m in zip(got, want):
        assert g.tokens == m.tokens, g.rid
    spec = tff.make_serving_engine(adapter_pool_pages=1, lora_rank=RANK,
                                   prefix_cache=False, draft_model=tff,
                                   speculate_k=2, **ENGINE)
    spec.register_adapter("t", w, alpha=8.0)
    for g, s in zip(got, spec.run(prompts, MAX_NEW, adapter="t")):
        assert g.tokens == s.tokens, g.rid


def test_null_adapter_and_poolless_bitwise(models, prompts):
    """The null page and an all-zero adapter leave the base tokens and the
    first-token logits bitwise unchanged; a pool-less engine serves the
    base model."""
    _, tff = models
    base = tff.make_serving_engine(**ENGINE).run(prompts, MAX_NEW)
    eng = tff.make_serving_engine(adapter_pool_pages=2, lora_rank=RANK,
                                  **ENGINE)
    geo = eng.lora.geometry
    eng.register_adapter("zero", {n: {"a": np.zeros((g[0], RANK)),
                                      "b": np.zeros((RANK, g[1]))}
                                  for n, g in geo.items()})
    null = eng.run(prompts, MAX_NEW)
    zero = eng.run(prompts, MAX_NEW, adapter="zero")
    for b, n, z in zip(base, null, zero):
        assert b.tokens == n.tokens == z.tokens
    gen = eng.gen
    pad = np.zeros((1, 16), np.int32)
    pad[0, :prompts[1].size] = prompts[1]
    with torch.inference_mode():
        outs = []
        for lora in (None, eng._lora_1(0)):
            caches = eng._new_caches(gen, 16)
            logits, _ = gen._prefill(gen.params(), torch.from_numpy(pad),
                                     caches, torch.tensor([prompts[1].size]),
                                     lora=lora)
            outs.append(logits)
    assert torch.equal(outs[0], outs[1])


def test_prefix_cache_namespaced_per_adapter(models, prompts):
    """The same prompt under two adapters shares no prefix page, the same
    adapter hits its own; counters equal JAX's."""
    jff, tff = models
    long = np.concatenate([prompts[4], prompts[1]])[:21]
    kw = dict(ENGINE, adapter_pool_pages=2, lora_rank=RANK)
    hits = []
    for eng in (jff.make_serving_engine(paged_attention_impl="einsum", **kw),
                tff.make_serving_engine(**kw)):
        _register(eng, "xy", (3, 4))
        seq = []
        for adapter in ("x", "x", "y", None, "y"):
            eng.run([long], 3, adapter=adapter)
            seq.append(eng.stats()["prefix_hits"])
        hits.append(seq)
    assert hits[0] == hits[1] == [0, 1, 1, 1, 2]


def test_reregister_flushes_namespace(models, prompts):
    """Re-registering an adapter flushes its namespace (its pages return
    to the pool): the next request under it prefills cold and gives a
    fresh engine's tokens under the new weights; refused while pinned."""
    _, tff = models
    long = np.concatenate([prompts[4], prompts[1]])[:21]
    kw = dict(ENGINE, adapter_pool_pages=2, lora_rank=RANK)
    # one decode step a tick, so a request is still live after one step()
    eng = tff.make_serving_engine(decode_chunk=1, **kw)
    geo = eng.lora.geometry
    eng.register_adapter("t", _weights(geo, 0))
    eng.run([long], 4, adapter="t")
    assert eng.stats()["kv_pages_cached"] > 0
    free0 = eng.stats()["free_pages"]
    eng.register_adapter("t", _weights(geo, 8))
    assert eng.stats()["free_pages"] > free0
    got = eng.run([long], 4, adapter="t")[0]
    assert got.prefix_tokens == 0
    cold = tff.make_serving_engine(**kw)
    cold.register_adapter("t", _weights(geo, 8))
    assert got.tokens == cold.run([long], 4, adapter="t")[0].tokens
    eng.submit(long, 4, adapter="t")
    eng.step()
    with pytest.raises(ValueError, match="pinned"):
        eng.register_adapter("t", _weights(geo, 1))
    eng.run()


def test_engine_lora_knobs_validate(models):
    """The knobs' validation, JAX's messages: an unknown target, a
    negative pool, an adapter on a pool-less engine or unregistered."""
    _, tff = models
    with pytest.raises(ValueError, match="not Linear ops"):
        tff.make_serving_engine(adapter_pool_pages=1, lora_targets=["nope"],
                                **ENGINE)
    with pytest.raises(ValueError, match="adapter_pool_pages"):
        tff.make_serving_engine(adapter_pool_pages=-1, **ENGINE)
    eng = tff.make_serving_engine(adapter_pool_pages=1, lora_rank=RANK,
                                  lora_targets=["lm_head"], **ENGINE)
    assert set(eng.lora.geometry) == {"lm_head"}
    assert set(eng.lora_pool) == {"lm_head", "_scale"}
    with pytest.raises(ValueError, match="not registered"):
        eng.submit(np.asarray([1, 2]), 2, adapter="ghost")
    with pytest.raises(ValueError, match="no adapter pool"):
        tff.make_serving_engine(**ENGINE).submit(np.asarray([1, 2]), 2,
                                                 adapter="x")
    with pytest.raises(RuntimeError, match="no adapter pool"):
        tff.make_serving_engine(**ENGINE).register_adapter("x", {})
