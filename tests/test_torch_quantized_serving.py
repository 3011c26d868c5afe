"""The quantized serving tier of the PyTorch port against the JAX package.

The same small Llama (hidden 64, 2 layers, 4 heads over 2 kv heads, vocab
89, f32) is built in both packages; the JAX-initialised weights are carried
into the port with ``params_from_jax`` and JAX pools with
``pool_from_jax``. Inputs are made with numpy from a seed. Held to JAX:

  * bitwise (f32 inputs): ``page_scale`` / ``page_quantize`` /
    ``page_dequantize``; the prefill write's payload and scales against
    the JAX einsum branch; the quantized decode append after three
    appends, one of which raises a page's scale; weight-only quantization
    (int8, fp8). Against ``paged_prefill_write_pallas`` in interpret mode
    the payload is bitwise given the kernel's scales, and the scales are
    within one f32 step: XLA compiles the kernel body's ``amax / qmax`` as
    a multiply by the reciprocal of the constant, where the port (and the
    eager einsum branch) divide (ROADMAP.md §3);
  * within 1e-5 of the output's largest magnitude: paged attention over an
    int8 / fp8 pool and over a bf16 pool under f32 queries, against JAX's
    einsum branch of ``_paged_attention_ctx`` and against
    ``paged_attention_fwd_pallas`` in interpret mode, at S = 1 and S = 3
    with pages of 4 and 8 positions (sums in other orders);
  * the engine: greedy tokens identical to the JAX engine's (einsum
    route) for int8, fp8 and bf16 KV pools and for int8 weights, with the
    prefix cache on and shared-prefix prompts (served twice in
    tests/test_torch_prefix_cache.py), and the quantized tier's and the
    cache's ``stats()`` equal.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held to those on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu.ops import attention as jattn
from flexflow_tpu.ops.pallas_kernels import (paged_attention_fwd_pallas,
                                             paged_prefill_write_pallas)
from flexflow_tpu.runtime.generation import Generator as JGenerator
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.convert import params_from_jax, pool_from_jax
from flexflow_tpu_torch.models import llama_lm
from flexflow_tpu_torch.ops import attention as tattn
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.runtime.generation import Generator

VOCAB = 89
ARCH = dict(seq_len=16, hidden=64, layers=2, heads=4, kv_heads=2,
            vocab_size=VOCAB)
QDTYPES = ("int8", "fp8")
# the stats the quantized tier and the prefix cache own
STATS = ("kv_cache_dtype", "weight_dtype", "kv_pool_bytes",
         "kv_bytes_per_token", "tokens_per_pool_gb", "kv_capacity_vs_bf16",
         "free_pages", "kv_pages_cached", "kv_pages_shared",
         "prefix_lookups", "prefix_hits", "prefix_hit_rate",
         "prefill_tokens_saved", "prefix_evictions", "prefix_refs_live")


@pytest.fixture(scope="module")
def jff():
    model = JModel(JConfig(batch_size=2, mesh_shape={"data": 1}))
    _, logits = j_llama_lm(model, 2, **ARCH)
    model.compile(final_tensor=logits)
    return model


@pytest.fixture(scope="module")
def tff(jff):
    model = FFModel(FFConfig(batch_size=2), device="cpu")
    _, logits = llama_lm(model, 2, **ARCH)
    model.compile(final_tensor=logits)
    model.params = params_from_jax(
        {op: {w: np.asarray(a) for w, a in ws.items()}
         for op, ws in jff.params.items()}, "cpu", torch.float32, model=model)
    return model


def _attn(model):
    return next(op for op in model.ops
                if type(op).__name__ == "MultiHeadAttention")


def _bits(a):
    """The bytes of a numpy array or a tensor, as a uint8 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _same_pool(tpool, jpool):
    assert set(tpool) == set(jpool)
    for name in jpool:
        np.testing.assert_array_equal(_bits(tpool[name]), _bits(jpool[name]),
                                      err_msg=name)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# ---- the page helpers ------------------------------------------------------


@pytest.mark.parametrize("dt", QDTYPES)
def test_page_helpers_bitwise(dt):
    """Scale, quantize and dequantize of f32 pages, bitwise JAX's — values
    across four binades, one all-zero page (scale 0, divisor 1e-12)."""
    rs = np.random.RandomState(0)
    x = (rs.randn(4, 8, 2, 16) * np.float32(10.0) ** rs.randint(
        -2, 2, (4, 1, 2, 1))).astype(np.float32)
    x[2] = 0.0
    jdt, jq = jattn.kv_storage_dtype(dt)
    tdt, tq = tattn.kv_storage_dtype(dt)
    assert tq == jq == tattn.storage_qmax(tdt)
    assert tdt.itemsize == jnp.dtype(jdt).itemsize == 1
    js = jattn.page_scale(jnp.asarray(x), jq)
    ts = tattn.page_scale(_t(x), tq)
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    jqd = jattn.page_quantize(jnp.asarray(x), js, jq, jdt)
    tqd = tattn.page_quantize(_t(x), ts, tq, tdt)
    np.testing.assert_array_equal(_bits(tqd), _bits(jqd))
    np.testing.assert_array_equal(
        _bits(tattn.page_dequantize(tqd, ts)),
        _bits(jattn.page_dequantize(jqd, js)))


def test_kv_storage_dtype_mapping():
    assert tattn.kv_storage_dtype("native") == (None, None)
    assert tattn.kv_storage_dtype(None) == (None, None)
    assert tattn.kv_storage_dtype("bf16") == (torch.bfloat16, None)
    assert tattn.kv_storage_dtype("int8") == (torch.int8, 127.0)
    assert tattn.kv_storage_dtype("fp8") == (torch.float8_e4m3fn, 448.0)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tattn.kv_storage_dtype("int4")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        FFConfig(kv_cache_dtype="int4")
    with pytest.raises(ValueError, match="serve_weight_dtype"):
        FFConfig(serve_weight_dtype="bf16")


# ---- the pool write protocol ----------------------------------------------


def _pools(jff, tff, kv, n_pages=10, page=4):
    ja, ta = _attn(jff), _attn(tff)
    jpool = ja.init_paged_cache(n_pages, page, jnp.float32, kv_dtype=kv)
    tpool = ta.init_paged_cache(n_pages, page, torch.float32, "cpu",
                                kv_dtype=kv)
    _same_pool(tpool, jpool)
    return ja, ta, jpool, tpool


@pytest.mark.parametrize("kv", QDTYPES + ("bf16",))
@pytest.mark.parametrize("length", [6, 16])
def test_prefill_write_bitwise(jff, tff, kv, length):
    """The plain write against the JAX einsum branch: payload and scales
    bitwise, the zero tail of a part-filled last page included (bf16: the
    cast of an f32 slab). Against the Pallas kernel (interpret mode): the
    payload bitwise once quantized against the kernel's own scales, and
    those scales within one f32 step of the port's."""
    ja, ta, jpool, tpool = _pools(jff, tff, kv)
    rs = np.random.RandomState(length)
    kh = (rs.randn(1, length, 2, 16) * 4).astype(np.float32)
    vh = (rs.randn(1, length, 2, 16) * 0.03).astype(np.float32)
    pages = np.asarray([7, 2, 5, 9][:-(-length // 4)], np.int32)
    jout = ja.paged_prefill_write(jpool, jnp.asarray(kh), jnp.asarray(vh),
                                  jnp.asarray(pages))
    jpal = paged_prefill_write_pallas(jpool, jnp.asarray(kh),
                                      jnp.asarray(vh), jnp.asarray(pages),
                                      interpret=True)
    ta.paged_prefill_write(tpool, _t(kh), _t(vh), _t(pages))
    _same_pool(tpool, jout)
    if kv == "bf16":
        _same_pool(tpool, jpal)
        return
    tdt, qmax = tattn.kv_storage_dtype(kv)
    for name, x in (("k", kh), ("v", vh)):
        scale = np.asarray(jpal[name + "_scale"])[pages]
        ours = tpool[name + "_scale"][_t(pages).long()].numpy()
        steps = np.abs(ours.view(np.int32).astype(np.int64)
                       - scale.view(np.int32).astype(np.int64))
        assert steps.max() <= 1, name
        pf = np.zeros((len(pages) * 4, 2, 16), np.float32)
        pf[:length] = x[0]
        want = tattn.page_quantize(_t(pf.reshape(len(pages), 4, 2, 16)),
                                   _t(scale), qmax, tdt)
        np.testing.assert_array_equal(
            _bits(want), np.asarray(jpal[name]).view(np.uint8)[pages])


@pytest.mark.parametrize("kv", QDTYPES)
def test_paged_append_bitwise(jff, tff, kv):
    """Three decode appends into a prefilled quantized pool, two slots per
    step on distinct private pages: the first below the pages' running
    max (same-scale requantization is exact), the second raising one
    page's scale (its older tokens re-round), the third into a fresh
    position. Pool and scales bitwise JAX's after every step."""
    ja, ta, jpool, tpool = _pools(jff, tff, kv)
    rs = np.random.RandomState(3)
    kh = (rs.randn(1, 6, 2, 16) * 2).astype(np.float32)
    vh = (rs.randn(1, 6, 2, 16) * 2).astype(np.float32)
    jpool = ja.paged_prefill_write(jpool, jnp.asarray(kh), jnp.asarray(vh),
                                   jnp.asarray([3, 6], jnp.int32))
    ta.paged_prefill_write(tpool, _t(kh), _t(vh), _t(np.asarray([3, 6],
                                                                np.int32)))
    _same_pool(tpool, jpool)
    before = tpool["k_scale"][6].clone()
    steps = [((3, 6), (1, 2), 0.1), ((6, 3), (3, 0), 50.0),
             ((6, 4), (0, 1), 1.0)]
    for page_ids, offs, mag in steps:
        x = (rs.randn(2, 2, 16) * mag).astype(np.float32)
        y = (rs.randn(2, 2, 16) * mag).astype(np.float32)
        pid, off = np.asarray(page_ids), np.asarray(offs)
        jpool = ja._paged_append(jpool, jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(pid), jnp.asarray(off))
        ta._paged_append(tpool, _t(x), _t(y), _t(pid).long(), _t(off).long())
        _same_pool(tpool, jpool)
    assert (tpool["k_scale"][6] > before).all()     # the scale grew


@pytest.mark.parametrize("wd", QDTYPES)
def test_quantized_params_bitwise(jff, tff, wd):
    """Weight-only quantization: payload and per-output-channel scales
    bitwise JAX's for every weight; 1-D weights stay as they are, in the
    tree's own copies (a weight swap rewrites the served tree in place,
    never the model's tensors)."""
    jq = JGenerator(jff, quantize=wd)._quantized_params()
    tq = Generator(tff, quantize=wd)._quantized_params()
    assert set(tq) == set(jq)
    quantized = 0
    for op, ws in jq.items():
        for w, v in ws.items():
            if isinstance(v, dict):
                quantized += 1
                assert tq[op][w]["q"].dtype == (
                    torch.int8 if wd == "int8" else torch.float8_e4m3fn)
                np.testing.assert_array_equal(_bits(tq[op][w]["q"]),
                                              _bits(v["q"]))
                np.testing.assert_array_equal(_bits(tq[op][w]["s"]),
                                              _bits(v["s"]))
            else:
                assert torch.equal(tq[op][w], tff.params[op][w])
                assert tq[op][w].data_ptr() != tff.params[op][w].data_ptr()
    assert quantized >= 4


# ---- paged attention over quantized and mixed-width pools -----------------


def _filled(ja, ta, jpool, tpool, rs, page):
    """Prefill two slots' worth of pages (slot 1's table scrambled),
    identically in both packages."""
    for pages, n in (([5, 2, 7, 1][:-(-14 // page)], 14),
                     ([3, 6, 4, 8][:-(-13 // page)], 13)):
        kh = rs.randn(1, n, 2, 16).astype(np.float32)
        vh = rs.randn(1, n, 2, 16).astype(np.float32)
        p = np.asarray(pages, np.int32)
        jpool = ja.paged_prefill_write(jpool, jnp.asarray(kh),
                                       jnp.asarray(vh), jnp.asarray(p))
        ta.paged_prefill_write(tpool, _t(kh), _t(vh), _t(p))
    return jpool


@pytest.mark.parametrize("kv", QDTYPES + ("bf16",))
@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("s", [1, 3])
def test_paged_attention_plain_matches_jax(jff, tff, kv, page, s):
    """The plain version of the paged-attention wrapper over an int8 / fp8
    pool (with scales) or a bf16 pool under f32 queries, against JAX's
    einsum branch and the Pallas kernel in interpret mode: within 1e-5 of
    the output's largest magnitude."""
    ja, ta, jpool, tpool = _pools(jff, tff, kv, page=page)
    rs = np.random.RandomState(11 + page + s)
    jpool = _filled(ja, ta, jpool, tpool, rs, page)
    pps = 16 // page
    table = np.zeros((3, pps), np.int32)
    table[0, :-(-14 // page)] = [5, 2, 7, 1][:-(-14 // page)]
    table[1, :-(-13 // page)] = [3, 6, 4, 8][:-(-13 // page)]
    q = rs.randn(3, s, 4, 16).astype(np.float32)
    wp = np.minimum(np.asarray([9, 12, 0])[:, None] + np.arange(s),
                    [[13], [12], [0]]).astype(np.int32)
    rl = np.asarray([3, 7, 0], np.int32)
    pad = np.asarray([8, 8, 0], np.int32)
    jargs = [jnp.asarray(a) for a in (q, table, wp, rl, pad)]
    ein = ja._paged_attention_ctx(jargs[0], jpool, *jargs[1:],
                                  impl="einsum")
    pal = paged_attention_fwd_pallas(
        jargs[0], jpool["k"], jpool["v"], *jargs[1:], 16 ** -0.5,
        k_scales=jpool.get("k_scale"), v_scales=jpool.get("v_scale"),
        interpret=True)
    n0 = kernels.paged_attention_fwd.launches
    out = ta._paged_attention_ctx(_t(q), tpool, _t(table), _t(wp), _t(rl),
                                  _t(pad)).numpy()
    assert kernels.paged_attention_fwd.launches == n0   # the plain version
    for ref in (np.asarray(ein), np.asarray(pal)):
        scale = np.abs(ref).max()
        assert np.abs(out - ref).max() <= 1e-5 * scale


# ---- the engine ------------------------------------------------------------


def _shared_prefix_prompts():
    rs = np.random.RandomState(17)
    system = rs.randint(1, VOCAB, (8,)).astype(np.int32)    # 2 full pages
    return [np.concatenate([system,
                            rs.randint(1, VOCAB, (n,)).astype(np.int32)])
            for n in (2, 5, 1, 4)] + [rs.randint(1, VOCAB, (6,)).astype(
                np.int32)]


@pytest.mark.parametrize("knobs", [
    dict(kv_cache_dtype="int8"),
    dict(kv_cache_dtype="fp8"),
    dict(kv_cache_dtype="bf16"),
    dict(weight_dtype="int8"),
], ids=lambda k: "_".join(f"{k}={v}" for k, v in k.items()))
def test_engine_tokens_match_jax(jff, tff, knobs):
    """Shared-prefix prompts through two slots on one engine (the first
    admission publishes the shared pages, the rest hit them; the second
    round is in tests/test_torch_prefix_cache.py): the port's greedy
    tokens equal the JAX engine's, and so do the quantized tier's and the
    prefix cache's stats."""
    kw = dict(serve_slots=2, kv_page_size=4, max_seq_len=64, **knobs)
    prompts = _shared_prefix_prompts()
    j_eng = jff.make_serving_engine(paged_attention_impl="einsum", **kw)
    eng = tff.make_serving_engine(**kw)
    j_reqs = j_eng.run(prompts, max_new_tokens=4)
    t_reqs = eng.run(prompts, max_new_tokens=4)
    for jr, tr in zip(j_reqs, t_reqs):
        assert tr.state == jr.state == "done"
        assert tr.tokens == jr.tokens, (tr.rid, knobs)
    st, jst = eng.stats(), j_eng.stats()
    assert st["prefix_hits"] == len(prompts) - 2     # the last shares none
    assert {k: st[k] for k in STATS} == {k: jst[k] for k in STATS}
    assert st["prefix_refs_live"] == 0
    assert st["free_pages"] + st["kv_pages_cached"] == st["kv_pages"] - 1
    pool = eng.pool[_attn(tff).name]
    want = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
            "bf16": torch.bfloat16}.get(knobs.get("kv_cache_dtype"),
                                        torch.float32)
    assert pool["k"].dtype == want
    assert ("k_scale" in pool) == (want in (torch.int8,
                                            torch.float8_e4m3fn))


@pytest.mark.parametrize("kv", QDTYPES + ("bf16",))
def test_pool_from_jax_bitwise(jff, kv):
    """A JAX engine's pool, fp8 and bf16 included, crosses into torch bit
    for bit."""
    eng = jff.make_serving_engine(serve_slots=1, kv_page_size=4,
                                  max_seq_len=16, kv_cache_dtype=kv)
    name = _attn(jff).name
    rs = np.random.RandomState(5)
    kh = jnp.asarray(rs.randn(1, 7, 2, 16), jnp.float32)
    jpool = _attn(jff).paged_prefill_write(eng.pool[name], kh, kh * 2,
                                           jnp.asarray([1, 3], jnp.int32))
    tpool = pool_from_jax({name: {k: np.asarray(v)
                                  for k, v in jpool.items()}}, "cpu")[name]
    assert tpool["k"].dtype == tattn.kv_storage_dtype(kv)[0]
    _same_pool(tpool, jpool)


def test_weight_dtype_validation(tff):
    with pytest.raises(ValueError, match="weight_dtype"):
        tff.make_serving_engine(weight_dtype="int4", max_seq_len=32)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tff.make_serving_engine(kv_cache_dtype="int4", max_seq_len=32)
    with pytest.raises(ValueError, match="quantize"):
        Generator(tff, quantize="int4")
