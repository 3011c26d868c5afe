"""Speculative decoding in the PyTorch port against the JAX package.

A small Llama target (hidden 64, 2 layers, 4 heads over 2 kv heads, vocab
89, f32) and a smaller draft (hidden 32, 1 layer) are built in both
packages; the JAX-initialised weights are carried into the port with
``params_from_jax``. Held to JAX:

  * ``paged_verify_forward``, a (B, K + 1) slab over the paged pool,
    against JAX's on its einsum route: the output within 1e-5 (f32) and
    the pool bitwise, native and int8, for slabs crossing a page boundary
    and slabs clamped at a slot's budget (repeated write positions);
  * greedy speculation: tokens identical to the JAX engine's at K = 1, 3
    and 8 (8 > max_new_tokens), with a draft whose proposals mostly miss
    and with the target as its own draft (most accepted), with eos and the
    prefix cache; the speculation counters of ``stats()`` equal JAX's;
  * the validation errors of JAX's engine.

Sampled speculation cannot be held to JAX's threefry bits, so it is held
to the port's own non-speculative sampler by distribution, as
tests/test_sampled_spec.py holds JAX's: token frequencies over a seed
sweep within TV_LIMIT of the sampler's (total-variation distance), a limit
another temperature's frequencies exceed, for an independent tiny draft
(heavy rejection) at K = 1, 3, 8 and a self-draft (long acceptance).
Greedy rows in a mixed batch keep their tokens, and sampled streams are
reproducible across slots and engines.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.convert import params_from_jax, pool_from_jax
from flexflow_tpu_torch.models import llama_lm

VOCAB = 89
TARGET = dict(seq_len=16, hidden=64, layers=2, heads=4, kv_heads=2,
              vocab_size=VOCAB)
DRAFT = dict(seq_len=16, hidden=32, layers=1, heads=2, kv_heads=2,
             vocab_size=VOCAB)
ENGINE = dict(serve_slots=2, kv_page_size=4, max_seq_len=64)
OUT_TOL = 1e-5
#: the sampled-spec histograms: vocab, seeds swept, and the TV limit
#: (measured 0.049-0.054 at these sizes; another temperature: 0.21)
S_VOCAB = 16
N_SEEDS = 12
TV_LIMIT = 0.10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines here run many small torch ops: one intra-op thread runs
    them faster than the default pool, whose threads spin against the
    suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return {op: {w: np.asarray(a) for w, a in ws.items()}
            for op, ws in params.items()}


def _pair(arch):
    jff = JModel(JConfig(batch_size=2, mesh_shape={"data": 1}))
    _, logits = j_llama_lm(jff, 2, **arch)
    jff.compile(final_tensor=logits)
    tff = FFModel(FFConfig(batch_size=2), device="cpu")
    _, logits = llama_lm(tff, 2, **arch)
    tff.compile(final_tensor=logits)
    tff.params = params_from_jax(_np_tree(jff.params), "cpu", torch.float32,
                                 model=tff)
    return jff, tff


@pytest.fixture(scope="module")
def target():
    return _pair(TARGET)


@pytest.fixture(scope="module")
def draft():
    return _pair(DRAFT)


def _prompts(seed, lengths, vocab=VOCAB):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, (n,)).astype(np.int32) for n in lengths]


def _attn(model):
    return next(op for op in model.ops
                if type(op).__name__ == "MultiHeadAttention")


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


# ---- the verify pass -------------------------------------------------------


def _verify_case(target, kv, layout, patched):
    """A (3, 4) slab (K = 3) over a prefilled pool of 4-position pages:
    slot 0 crosses a page boundary, slot 1 is clamped at its budget in the
    "clamped" layout (its last write positions repeat), slot 2 is idle
    (scratch page 0). ``patched``: both ops' projections return the same
    seeded q / k / v, so the pools see identical values."""
    jff, tff = target
    ja, ta = _attn(jff), _attn(tff)
    page, n_pages, s = 4, 12, 4
    rs = np.random.RandomState(5 if layout == "page_cross" else 6)
    jpool = ja.init_paged_cache(n_pages, page, jnp.float32, kv_dtype=kv)
    for pages, n in (([5, 2, 7], 10), ([3, 6, 4], 9)):
        kh = rs.randn(1, n, 2, 16).astype(np.float32)
        vh = rs.randn(1, n, 2, 16).astype(np.float32)
        jpool = ja.paged_prefill_write(jpool, jnp.asarray(kh),
                                       jnp.asarray(vh),
                                       jnp.asarray(pages, jnp.int32))
    tpool = pool_from_jax({k: np.asarray(v) for k, v in jpool.items()},
                          "cpu")
    table = np.asarray([[5, 2, 7, 9], [3, 6, 4, 10], [0, 0, 0, 0]],
                       np.int32)
    row_len = np.asarray([6, 5, 0], np.int32)
    pad = np.asarray([8, 8, 0], np.int32)
    if layout == "page_cross":
        wp0, budget = np.asarray([10, 9, 0]), np.asarray([16, 16, 1])
    else:
        wp0, budget = np.asarray([9, 11, 0]), np.asarray([16, 13, 1])
    wp = np.minimum(wp0[:, None] + np.arange(s),
                    (budget - 1)[:, None]).astype(np.int32)
    rope0 = np.asarray([8, 9, 0], np.int32)
    x = rs.randn(3, s, TARGET["hidden"]).astype(np.float32)
    if patched:
        qkv = [(rs.randn(3, s, h, 16) * 3).astype(np.float32)
               for h in (4, 2, 2)]
        ja._project_qkv = lambda *a, **k: tuple(jnp.asarray(t) for t in qkv)
        ta._project_qkv = lambda *a, **k: tuple(torch.from_numpy(t)
                                                for t in qkv)
    try:
        jout, jpool = ja.paged_verify_forward(
            jff.params[ja.name], [jnp.asarray(x)] * 3, jpool,
            *(jnp.asarray(a) for a in (table, wp, rope0, row_len, pad)),
            impl="einsum")
        with torch.inference_mode():
            out, tpool = ta.paged_verify_forward(
                tff.params[ta.name], [torch.from_numpy(x)] * 3, tpool,
                *(torch.from_numpy(a) for a in (table, wp, rope0, row_len,
                                                pad)))
    finally:
        for op in (ja, ta):
            op.__dict__.pop("_project_qkv", None)
    jout = np.asarray(jout)
    np.testing.assert_allclose(out.numpy(), jout, rtol=0,
                               atol=OUT_TOL * np.abs(jout).max())
    # page 0 is scratch: the idle slot's and the repeated positions'
    # writes land there, in no defined order
    return ({k: v[1:] for k, v in tpool.items()},
            {k: np.asarray(v)[1:] for k, v in jpool.items()})


@pytest.mark.parametrize("kv", [None, "int8"], ids=["native", "int8"])
@pytest.mark.parametrize("layout", ["page_cross", "clamped"])
def test_paged_verify_forward_matches_jax(target, kv, layout):
    """Given the same projections: the output within 1e-5 and the pool
    bitwise JAX's (native: one scatter, the last of repeated positions
    written; int8: the sequential requantizing appends)."""
    tpool, jpool = _verify_case(target, kv, layout, patched=True)
    for name in jpool:
        np.testing.assert_array_equal(_bits(tpool[name]),
                                      _bits(jpool[name]), err_msg=name)


@pytest.mark.parametrize("layout", ["page_cross", "clamped"])
def test_paged_verify_forward_projections_match_jax(target, layout):
    """The op's own projections and per-position RoPE (rope_pos0 + i):
    the output within 1e-5, the written k / v within 1e-5 (the two
    frameworks sum the projections in other orders)."""
    tpool, jpool = _verify_case(target, None, layout, patched=False)
    for name in jpool:
        np.testing.assert_allclose(tpool[name].numpy(), jpool[name],
                                   rtol=0, atol=OUT_TOL)


# ---- greedy speculation against the JAX engine ----------------------------


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("which", ["small", "self"])
def test_greedy_speculation_matches_jax_engine(target, draft, k, which):
    """Speculation at K emits the non-speculative greedy stream, the JAX
    engine's tokens, and the JAX engine's speculation counters."""
    jff, tff = target
    jd, td = draft if which == "small" else target
    prompts = _prompts(43, [5, 9, 3, 12])
    base = [r.tokens for r in tff.make_serving_engine(**ENGINE).run(
        prompts, max_new_tokens=5)]
    eng = tff.make_serving_engine(draft_model=td, speculate_k=k, **ENGINE)
    reqs = eng.run(prompts, max_new_tokens=5)
    jeng = jff.make_serving_engine(draft_model=jd, speculate_k=k,
                                   paged_attention_impl="einsum", **ENGINE)
    jreqs = jeng.run(prompts, max_new_tokens=5)
    for r, jr, want in zip(reqs, jreqs, base):
        assert r.state == jr.state == "done"
        assert r.tokens == jr.tokens == want
    st, jst = eng.stats(), jeng.stats()
    for key in ("speculate_k", "spec_proposed", "spec_accepted",
                "spec_accept_rate", "decode_steps", "tokens_generated",
                "free_pages", "kv_pages_cached", "prefix_refs_live"):
        assert st[key] == jst[key], key
    if which == "self":
        assert st["spec_accepted"] > 0
    # the draft's proposals, the verify pass: one program each
    assert st["recompiles"] == 2


def test_greedy_speculation_with_eos_and_prefix_cache(target, draft):
    """eos retiring mid-window truncates cleanly, and the prefix cache and
    speculation compose (the draft's prefill mirrors the target's hit):
    the JAX engine's tokens under the same eos."""
    jff, tff = target
    jd, td = draft
    rs = np.random.RandomState(47)
    system = rs.randint(1, VOCAB, (8,)).astype(np.int32)
    prompts = [np.concatenate([system, rs.randint(1, VOCAB, (n,))
                               .astype(np.int32)]) for n in (2, 5, 3)]
    first = tff.make_serving_engine(**ENGINE).run(prompts[:1], 8)[0].tokens
    eos = int(first[2])
    kw = dict(ENGINE, eos_id=eos)
    want = [r.tokens for r in tff.make_serving_engine(**kw).run(prompts, 8)]
    eng = tff.make_serving_engine(draft_model=td, speculate_k=2, **kw)
    got = [r.tokens for r in eng.run(prompts, 8)]
    jeng = jff.make_serving_engine(draft_model=jd, speculate_k=2,
                                   paged_attention_impl="einsum", **kw)
    jgot = [r.tokens for r in jeng.run(prompts, 8)]
    assert got == jgot == want
    assert got[0][-1] == eos and len(got[0]) <= 3
    st, jst = eng.stats(), jeng.stats()
    assert st["prefix_hits"] == jst["prefix_hits"] >= len(prompts) - 1
    for key in ("spec_proposed", "spec_accepted", "free_pages",
                "kv_pages_cached", "prefix_refs_live"):
        assert st[key] == jst[key], key


def test_speculative_validation(target, draft):
    """The JAX engine's construction errors, and sampled speculation
    constructs."""
    jff, tff = target
    _, td = draft
    with pytest.raises(ValueError, match="draft model"):
        tff.make_serving_engine(speculate_k=2)
    with pytest.raises(ValueError, match="must be >= 0"):
        tff.make_serving_engine(speculate_k=-1, draft_model=td)
    eng = tff.make_serving_engine(speculate_k=2, draft_model=td,
                                  temperature=0.7, kv_page_size=4,
                                  max_seq_len=64)
    assert eng.speculate_k == 2 and eng.default_temperature == 0.7
    for knob, name in ((dict(temperature=-0.5), "temperature"),
                       (dict(top_p=0.0), "top_p"), (dict(top_k=-3), "top_k")):
        with pytest.raises(ValueError, match=name):
            tff.make_serving_engine(**knob)
        with pytest.raises(ValueError, match=name):
            jff.make_serving_engine(**knob)
    with pytest.raises(ValueError, match="serve_speculate_k"):
        FFConfig(serve_speculate_k=-2)


def test_speculative_vocab_mismatch_rejected(target):
    _, tff = target
    other = FFModel(FFConfig(batch_size=2), device="cpu")
    _, logits = llama_lm(other, 2, **dict(DRAFT, vocab_size=VOCAB + 7))
    other.compile(final_tensor=logits)
    with pytest.raises(ValueError, match="vocab mismatch"):
        tff.make_serving_engine(speculate_k=2, draft_model=other)


# ---- sampled speculation by distribution -----------------------------------


def _small(hidden, seed):
    model = FFModel(FFConfig(batch_size=2, seed=seed), device="cpu")
    _, logits = llama_lm(model, 2, seq_len=16, hidden=hidden, layers=1,
                         heads=2, kv_heads=2, vocab_size=S_VOCAB)
    model.compile(final_tensor=logits)
    return model


@pytest.fixture(scope="module")
def s_target():
    return _small(32, 0)


@pytest.fixture(scope="module")
def s_draft():
    return _small(16, 1)


@pytest.fixture(scope="module")
def s_base(s_target):
    return _freqs(s_target, {})


def _freqs(model, engine_kw, temp=0.9, top_p=0.95, max_new=48):
    """Token frequencies over N_SEEDS seeds of four prompts."""
    eng = model.make_serving_engine(serve_slots=4, kv_page_size=4,
                                    max_seq_len=64, **engine_kw)
    prompts = _prompts(1, [4, 6, 5, 7], S_VOCAB)
    toks = []
    for s in range(N_SEEDS):
        for r in eng.run(prompts, max_new_tokens=max_new, temperature=temp,
                         top_p=top_p, seed=s):
            assert r.state == "done", r.error
            toks.extend(r.tokens)
    toks = np.asarray(toks)
    return np.bincount(toks, minlength=S_VOCAB) / toks.size, eng.stats()


def _tv(a, b):
    return 0.5 * float(np.abs(a - b).sum())


@pytest.mark.parametrize("which,k", [("small", 1), ("small", 3),
                                     ("small", 8), ("self", 3)])
def test_rejection_spec_matches_sampler(s_target, s_draft, s_base, which,
                                        k):
    """Rejection-sampled speculation emits the non-speculative sampler's
    distribution: TV under TV_LIMIT, with a rejecting draft and with the
    target as its own draft; another temperature's frequencies stay
    further than TV_LIMIT from the sampler's."""
    base, _ = s_base
    dm = s_draft if which == "small" else s_target
    spec, st = _freqs(s_target, {"draft_model": dm, "speculate_k": k})
    assert _tv(base, spec) < TV_LIMIT
    if which == "small":
        assert 0.0 < st["spec_accept_rate"] < 0.9
    else:
        assert st["spec_accept_rate"] > 0.6
    if k == 3 and which == "small":
        ctrl, _ = _freqs(s_target, {}, temp=0.3)
        assert _tv(base, ctrl) > TV_LIMIT


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_greedy_rows_unchanged_in_mixed_batch(s_target, s_draft, spec):
    """A greedy request decoding beside sampled ones (with and without
    speculation) emits its solo greedy stream."""
    prompts = _prompts(1, [4, 6, 5, 7], S_VOCAB)
    kw = dict(serve_slots=4, kv_page_size=4, max_seq_len=64)
    solo = s_target.make_serving_engine(**kw).run(prompts[:1], 8)[0].tokens
    if spec:
        kw.update(draft_model=s_draft, speculate_k=3)
    eng = s_target.make_serving_engine(**kw)
    greedy = eng.submit(prompts[0], 8, temperature=0.0)
    for p in prompts[1:]:
        eng.submit(p, 8, temperature=1.1, seed=3)
    while eng.step():
        pass
    assert greedy.tokens == solo
    assert eng.stats()["sampled_requests"] == 3


def test_sampled_streams_reproducible_across_slots_and_engines(s_target,
                                                              s_draft):
    """Same (prompt, seed, config) -> same stream, whatever the slot, the
    neighbours or the engine; within each speculation configuration."""
    prompts = _prompts(2, [5, 7, 4], S_VOCAB)
    kw = dict(kv_page_size=4, max_seq_len=64)
    e1 = s_target.make_serving_engine(serve_slots=2, **kw)
    a = e1.run([prompts[0]], 8, temperature=0.8, top_p=0.9, seed=11)[0]
    b = e1.run(list(prompts), 8, temperature=0.8, top_p=0.9, seed=11)[0]
    assert a.tokens == b.tokens
    e2 = s_target.make_serving_engine(serve_slots=4, **kw)
    c = e2.run([prompts[2], prompts[0]], 8, temperature=0.8, top_p=0.9,
               seed=11)[1]
    assert a.tokens == c.tokens
    e3 = s_target.make_serving_engine(serve_slots=2, draft_model=s_draft,
                                      speculate_k=3, **kw)
    e4 = s_target.make_serving_engine(serve_slots=3, draft_model=s_draft,
                                      speculate_k=3, **kw)
    s1 = e3.run([prompts[0]], 8, temperature=0.8, seed=11)[0]
    s2 = e4.run([prompts[1], prompts[0]], 8, temperature=0.8, seed=11)[1]
    assert s1.tokens == s2.tokens
    # another seed, another stream
    d = e1.run([prompts[0]], 8, temperature=0.8, top_p=0.9, seed=12)[0]
    assert d.tokens != a.tokens
