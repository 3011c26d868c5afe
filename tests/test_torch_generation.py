"""``FFModel.generate`` in the PyTorch port against the JAX package's.

The same small Llama (hidden 64, 2 layers, 4 heads over 4 / 2 / 1 kv
heads, vocab 97, f32) is built in both packages and the JAX-initialised
weights are carried into the port (``params_from_jax``). On the CPU the
port's decode step runs eagerly (on the card it is a CUDA graph:
tests/test_torch_cuda.py holds the two against each other) and its prefill
runs the plain version of kernel 1. Limits, f32: greedy and beam tokens
identical; per-token scores, beam scores and first-token logits within
1e-5 (the two frameworks sum in other orders; the scores measured within
1e-6); ``decode_forward`` alone within 1e-6. bf16 compute: the first
token's logits within 0.1 of JAX's, on logits up to 2.6 in magnitude
(measured 0.033: bf16 keeps 8 bits of mantissa and the two packages round
at other places), and no token compared. Sampled streams are not JAX's threefry
bits: they are held to JAX's keep-sets and to softmax(logits / T) by
distribution, as tests/test_sampled_spec.py holds the serving sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.ffconst import DataType as JDataType
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu.runtime.generation import Generator as JGenerator
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.ffconst import DataType
from flexflow_tpu_torch.models import llama_lm
from flexflow_tpu_torch.runtime.generation import Generator
from test_torch_zoo import numpy_init

VOCAB = 97
ARCH = dict(seq_len=16, hidden=64, layers=2, heads=4, vocab_size=VOCAB)
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_LOGIT_ATOL = 0.1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread runs them faster than the
    default pool, whose threads spin against the suite's workers. JAX's
    models take numpy-drawn weights (``numpy_init``: its own init compiles
    a program a weight shape)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        numpy_init(mp)
        yield
    torch.set_num_threads(n)


def _np_tree(params):
    return {op: {w: np.asarray(a) for w, a in ws.items()}
            for op, ws in params.items()}


def _carry(jff, tff, dtype=torch.float32):
    tff.params = params_from_jax(_np_tree(jff.params), "cpu", dtype,
                                 model=tff)
    return tff


def _graphs(kv_heads=2, final=None, compute_dtype="float32"):
    """The Llama's graph in both packages, not compiled; ``final(ff,
    logits)`` appends ops after the lm_head. Returns the two models and
    their final tensors."""
    jff = JModel(JConfig(batch_size=2, mesh_shape={"data": 1},
                         compute_dtype=compute_dtype))
    _, lj = j_llama_lm(jff, 2, kv_heads=kv_heads, **ARCH)
    tff = FFModel(FFConfig(batch_size=2, compute_dtype=compute_dtype),
                  device="cpu")
    _, lt = llama_lm(tff, 2, kv_heads=kv_heads, **ARCH)
    if final:
        lj, lt = final(jff, lj), final(tff, lt)
    return jff, lj, tff, lt


def _pair(kv_heads=2, final=None, compute_dtype="float32"):
    """The Llama in both packages with the same weights."""
    jff, lj, tff, lt = _graphs(kv_heads, final, compute_dtype)
    jff.compile(final_tensor=lj)
    tff.compile(final_tensor=lt)
    dt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    return jff, _carry(jff, tff, dt)


@pytest.fixture(scope="module")
def models():
    return {kvh: _pair(kvh) for kvh in (4, 2, 1)}


@pytest.fixture(scope="module")
def pair(models):
    return models[2]


PROMPT = np.random.RandomState(0).randint(1, VOCAB, (3, 9)).astype(np.int32)
LENGTHS = np.asarray([9, 4, 6], np.int32)


def _ragged(ragged):
    return dict(prompt_lengths=LENGTHS) if ragged else {}


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
@pytest.mark.parametrize("kv_heads", [4, 2, 1], ids=["mha", "gqa", "mqa"])
def test_greedy_tokens_match_jax(models, kv_heads, ragged):
    jff, tff = models[kv_heads]
    want = jff.generate(PROMPT, 10, **_ragged(ragged))
    got = tff.generate(PROMPT, 10, **_ragged(ragged))
    assert got.dtype == np.int32 and got.shape == (3, 19)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_return_scores_match_jax(pair, ragged):
    jff, tff = pair
    want, ws = jff.generate(PROMPT, 8, return_scores=True, **_ragged(ragged))
    got, gs = tff.generate(PROMPT, 8, return_scores=True, **_ragged(ragged))
    np.testing.assert_array_equal(got, want)
    assert gs.shape == (3, 8) and gs.dtype == np.float32
    np.testing.assert_allclose(gs, ws, **TOL)


def _eos_of(tff):
    """A token the greedy stream of row 0 emits mid-way: eos there freezes
    row 0 early while the other rows run on."""
    return int(tff.generate(PROMPT, 10)[0, 9 + 3])


def test_eos_pads_with_score_zero_and_early_exit(pair):
    """After eos a row emits pad_id at score 0 (JAX's tokens and scores);
    early_exit stops once every row is done, with the full loop's
    tokens, in fewer steps."""
    jff, tff = pair
    eos = _eos_of(tff)
    kw = dict(eos_token_id=eos, pad_token_id=0, return_scores=True)
    want, ws = jff.generate(PROMPT, 10, **kw)
    got, gs = tff.generate(PROMPT, 10, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(gs, ws, **TOL)
    new = got[0, 9:]
    hit = int(np.where(new == eos)[0][0])
    assert (new[hit + 1:] == 0).all() and (gs[0, hit + 1:] == 0.0).all()
    # early exit: every row's eos is row 0's first token
    first = tff.generate(PROMPT[:1], 1)[0, 9]
    one = np.repeat(PROMPT[:1], 2, axis=0)
    full = tff.generate(one, 10, eos_token_id=int(first))
    (gen,) = [g for k, g in tff._decoders.items() if k[2] == int(first)]
    assert gen.last_decode_steps == 9
    assert gen.last_decode_ms is None      # device time: on the card only
    early = tff.generate(one, 10, eos_token_id=int(first), early_exit=True)
    np.testing.assert_array_equal(early, full)
    np.testing.assert_array_equal(
        early, jff.generate(one, 10, eos_token_id=int(first),
                            early_exit=True))
    (gen,) = [g for k, g in tff._decoders.items() if k[2] == int(first)]
    assert gen.last_decode_steps == 0
    got = tff.generate(PROMPT, 10, eos_token_id=eos, early_exit=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_chunked_prefill_matches_jax(pair, ragged):
    """prefill_chunk=4 over 9-position prompts (three chunks): JAX's
    tokens, and the first token's logits within 1e-5 of JAX's chunked
    and of the port's whole-prompt prefill."""
    jff, tff = pair
    want = jff.generate(PROMPT, 6, prefill_chunk=4, **_ragged(ragged))
    got = tff.generate(PROMPT, 6, prefill_chunk=4, **_ragged(ragged))
    np.testing.assert_array_equal(got, want)
    lengths = LENGTHS if ragged else None
    jgen = JGenerator(jff)
    jc = {op.name: op.init_cache(3, 15, jnp.float32) for op in jgen.attn_ops}
    jl, _ = jgen._prefill(jff.params, jff.bn_state, jnp.asarray(PROMPT), jc,
                          None if lengths is None else jnp.asarray(lengths),
                          4)
    gen = Generator(tff)
    outs = []
    for chunk in (4, 0):
        c = {op.name: op.init_cache(3, 15, torch.float32, tff.device)
             for op in gen.attn_ops}
        with torch.inference_mode():
            lg, _ = gen._prefill(
                tff.params, torch.as_tensor(PROMPT).long(), c,
                None if lengths is None else torch.as_tensor(lengths), chunk)
        outs.append(lg[:, -1].numpy())
    np.testing.assert_allclose(outs[0], np.asarray(jl)[:, -1], **TOL)
    np.testing.assert_allclose(outs[0], outs[1], **TOL)


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
@pytest.mark.parametrize("beams", [2, 4])
def test_beam_search_matches_jax(pair, beams, ragged):
    jff, tff = pair
    kw = dict(num_beams=beams, length_penalty=1.0, return_scores=True,
              **_ragged(ragged))
    want, ws = jff.generate(PROMPT, 7, **kw)
    got, gs = tff.generate(PROMPT, 7, **kw)
    np.testing.assert_array_equal(got, want)
    assert gs.shape == (3,)
    np.testing.assert_allclose(gs, ws, **TOL)


@pytest.mark.parametrize("penalty", [0.0, 1.0])
def test_beam_eos_freezes_and_normalizes_by_emitted_length(pair, penalty):
    """JAX's test_beam_search_eos_freezes_and_normalizes_by_emitted_length
    setting: eos is the token beam search emits first for row 0, so beams
    freeze at step 1 — pads after eos, and the pick normalized by each
    beam's emitted length: JAX's tokens and scores."""
    jff, tff = pair
    prompt = np.random.RandomState(17).randint(1, VOCAB, (2, 4)).astype(
        np.int32)
    probe = tff.generate(prompt, 6, num_beams=2)
    eos = int(probe[0, 4])
    kw = dict(num_beams=2, length_penalty=penalty, eos_token_id=eos,
              pad_token_id=0, return_scores=True)
    want, ws = jff.generate(prompt, 6, **kw)
    got, gs = tff.generate(prompt, 6, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(gs, ws, **TOL)
    for row in got[:, 4:]:
        hits = np.where(row == eos)[0]
        if hits.size:
            assert (row[hits[0] + 1:] == 0).all()
    if penalty == 0.0:
        # the raw sum favours the beam frozen after its first token
        assert got[0, 4] == eos and (got[0, 5:] == 0).all()


@pytest.mark.parametrize("quantize", ["int8", "fp8"])
def test_weight_only_quantized_tokens_match_jax(pair, quantize):
    jff, tff = pair
    want = jff.generate(PROMPT, 8, quantize=quantize,
                        prompt_lengths=LENGTHS)
    got = tff.generate(PROMPT, 8, quantize=quantize, prompt_lengths=LENGTHS)
    np.testing.assert_array_equal(got, want)


def _moe_decoder(pkg):
    """JAX's _moe_decoder (tests/test_generation.py): attention + MoE FFN
    blocks, capacity 0.5 (tight in training; inference runs at the slab's
    token count)."""
    model_cls, cfg_cls, dt = ((JModel, JConfig, JDataType) if pkg == "jax"
                              else (FFModel, FFConfig, DataType))
    kw = dict(mesh_shape={"data": 1}) if pkg == "jax" else {}
    ff = (model_cls(cfg_cls(batch_size=2, **kw)) if pkg == "jax"
          else model_cls(cfg_cls(batch_size=2), device="cpu"))
    toks = ff.create_tensor([2, 12], dtype=dt.DT_INT32, name="input")
    t = ff.embedding(toks, VOCAB, 32, name="embed")
    for i in range(2):
        a = ff.rms_norm(t, name=f"ln1_{i}")
        a = ff.multihead_attention(a, a, a, 32, 4, causal=True, bias=False,
                                   rope=True, name=f"attn_{i}")
        t = ff.add(t, a, name=f"res1_{i}")
        m = ff.moe(ff.rms_norm(t, name=f"ln2_{i}"), num_experts=4,
                   hidden_dim=64, k=2, capacity_factor=0.5, name=f"moe_{i}")
        t = ff.add(t, m, name=f"res2_{i}")
    logits = ff.dense(t, VOCAB, use_bias=False, name="lm_head")
    ff.compile(final_tensor=logits)
    return ff


def test_moe_decoder_tokens_match_jax():
    jff = _moe_decoder("jax")
    tff = _carry(jff, _moe_decoder("torch"))
    prompt = np.random.RandomState(12).randint(0, VOCAB, (4, 6)).astype(
        np.int32)
    np.testing.assert_array_equal(tff.generate(prompt, 5),
                                  jff.generate(prompt, 5))


def test_prefill_through_jax_flash_kernel(pair, monkeypatch):
    """FF_FORCE_FLASH_ATTENTION=1: JAX's prefill runs its Pallas flash
    kernel (interpret mode), the port's the plain version of kernel 1:
    the same tokens, scores within 1e-5."""
    jff, tff = pair
    monkeypatch.setenv("FF_FORCE_FLASH_ATTENTION", "1")
    # a key of its own (max_new_tokens 5): JAX traces it under the flag
    want, ws = jff.generate(PROMPT, 5, return_scores=True,
                            prompt_lengths=LENGTHS)
    got, gs = tff.generate(PROMPT, 5, return_scores=True,
                           prompt_lengths=LENGTHS)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(gs, ws, **TOL)


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_decode_forward_matches_jax(pair, ragged):
    """MultiHeadAttention.decode_forward alone: a (3, 1, 64) slab at slot
    pos 10 of a 16-slot cache of random k/v, RoPE at pos (or at each row's
    logical position), the pad slots masked for ragged rows: output and
    the written cache within 1e-6 of JAX's."""
    jff, tff = pair
    jop, top = jff.get_op_by_name("attn_1"), tff.get_op_by_name("attn_1")
    rs = np.random.RandomState(4)
    x = rs.randn(3, 1, 64).astype(np.float32)
    ck = rs.randn(3, 16, 2, 16).astype(np.float32)
    cv = rs.randn(3, 16, 2, 16).astype(np.float32)
    pos, s0 = 10, 9
    lengths = np.asarray([9, 4, 6], np.int32)
    rope_pos = lengths + (pos - s0)
    kw = (dict(rope_pos=rope_pos, row_lengths=lengths, prompt_len=s0)
          if ragged else {})
    jout, jc = jop.decode_forward(
        jff.params["attn_1"], [jnp.asarray(x)] * 3,
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, pos,
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    tkw = {k: (torch.as_tensor(v).long() if isinstance(v, np.ndarray)
               else v) for k, v in kw.items()}
    cache = {"k": torch.as_tensor(ck.copy()), "v": torch.as_tensor(cv.copy())}
    tout, tc = top.decode_forward(tff.params["attn_1"],
                                  [torch.as_tensor(x)] * 3, cache,
                                  torch.tensor(pos), **tkw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)
    for part in ("k", "v"):
        np.testing.assert_allclose(tc[part].numpy(), np.asarray(jc[part]),
                                   rtol=1e-6, atol=1e-6)


def test_engine_and_generate_agree(pair):
    """The port's continuous-batching engine and its generate give the
    same greedy tokens for the same prompts."""
    _, tff = pair
    prompts = [PROMPT[i, :n] for i, n in enumerate(LENGTHS)]
    eng = tff.make_serving_engine(serve_slots=2, kv_page_size=4,
                                  max_seq_len=32, prefix_cache=False)
    reqs = eng.run(prompts, max_new_tokens=8)
    out = tff.generate(PROMPT, 8, prompt_lengths=LENGTHS)
    for r, row in zip(reqs, out):
        assert r.state == "done"
        assert list(r.tokens) == list(row[9:])
    del eng, reqs


def test_program_lru_holds_cache_limit(pair, monkeypatch):
    """FF_GEN_PROGRAM_CACHE=2: a third key evicts the least recently used
    program; a hit moves its key to the back."""
    _, tff = pair
    monkeypatch.setenv("FF_GEN_PROGRAM_CACHE", "2")
    gen = Generator(tff)
    for n in (3, 4, 3, 5):
        gen(PROMPT, n)
    keys = [k[0] for k in gen._programs]
    assert keys == [3, 5]
    np.testing.assert_array_equal(gen(PROMPT, 4), tff.generate(PROMPT, 4))
    assert [k[0] for k in gen._programs] == [5, 4]


def test_non_decodable_graphs_refused_by_op_name():
    ff = FFModel(FFConfig(batch_size=2), device="cpu")
    x = ff.create_tensor([2, 3, 8, 8], name="input")
    ff.compile(final_tensor=ff.conv2d(x, 4, 3, 3, 1, 1, 1, 1, name="conv"))
    with pytest.raises(ValueError):
        Generator(ff)
    ff = FFModel(FFConfig(batch_size=2), device="cpu")
    t = ff.create_tensor([2, 8], dtype=DataType.DT_INT32, name="input")
    e = ff.embedding(t, VOCAB, 16, name="embed")
    c = ff.concat([e, e], axis=1, name="cat_seq")
    ff.compile(final_tensor=ff.dense(c, VOCAB, name="head"))
    with pytest.raises(ValueError, match="cat_seq"):
        Generator(ff)
    ff = FFModel(FFConfig(batch_size=2), device="cpu")
    t = ff.create_tensor([2, 8], dtype=DataType.DT_INT32, name="input")
    e = ff.embedding(t, VOCAB, 16, name="embed")
    a = ff.multihead_attention(e, e, e, 16, 2, name="bidir")
    ff.compile(final_tensor=ff.dense(a, VOCAB, name="head"))
    with pytest.raises(ValueError, match="bidir.*causal"):
        Generator(ff)


def test_swap_weights_refused_after_generate():
    """Once generate() ran, its Generator reads model.params in place for
    the model's life: a native swap on an engine of the model is refused,
    naming FFModel.generate."""
    tff = FFModel(FFConfig(batch_size=2), device="cpu")
    _, logits = llama_lm(tff, 2, kv_heads=2, **ARCH)
    tff.compile(final_tensor=logits)
    eng = tff.make_serving_engine(serve_slots=2, kv_page_size=4,
                                  max_seq_len=32, prefix_cache=False)
    tree = {op: {w: t.clone() for w, t in ws.items()}
            for op, ws in tff.params.items()}
    assert eng.swap_weights(tree, "v1")["version"] == "v1"
    eng.swap_weights(None, "v0")
    tff.generate(PROMPT, 3)
    with pytest.raises(RuntimeError, match="FFModel.generate"):
        eng.swap_weights(tree, "v1")


# ---- the last-axis softmax (a fault the port had: it refused the graph) ---


def _softmax_last(ff, logits):
    return ff.softmax(logits, axis=-1, name="probs")


def test_final_softmax_serves_and_generates_as_jax():
    jff, tff = _pair(2, final=_softmax_last)
    np.testing.assert_array_equal(tff.generate(PROMPT, 6),
                                  jff.generate(PROMPT, 6))
    prompts = [PROMPT[i, :n] for i, n in enumerate(LENGTHS)]
    kw = dict(serve_slots=2, kv_page_size=4, max_seq_len=32,
              prefix_cache=False)
    want = [r.tokens for r in jff.make_serving_engine(
        paged_attention_impl="einsum", **kw).run(prompts, max_new_tokens=6)]
    got = [r.tokens for r in tff.make_serving_engine(**kw).run(
        prompts, max_new_tokens=6)]
    assert got == want


def test_softmax_off_the_last_axis_refused_by_both():
    def mid(ff, logits):
        return ff.softmax(logits, axis=1, name="probs_seq")

    jff, _, tff, _ = _graphs(2, final=mid)
    for gen_cls, ff in ((JGenerator, jff), (Generator, tff)):
        with pytest.raises(ValueError, match="probs_seq: softmax over a "
                                             "non-feature axis"):
            gen_cls(ff)


# ---- bf16 compute ---------------------------------------------------------


def test_bf16_first_logits_within_stated_tolerance():
    jff, tff = _pair(2, compute_dtype="bfloat16")
    jgen = JGenerator(jff)
    jc = {op.name: op.init_cache(3, 12, jnp.bfloat16)
          for op in jgen.attn_ops}
    jl, _ = jgen._prefill(jff.params, jff.bn_state, jnp.asarray(PROMPT), jc,
                          jnp.asarray(LENGTHS), 0)
    gen = Generator(tff)
    c = {op.name: op.init_cache(3, 12, torch.bfloat16, tff.device)
         for op in gen.attn_ops}
    with torch.inference_mode():
        lg, _ = gen._prefill(tff.params, torch.as_tensor(PROMPT).long(), c,
                             torch.as_tensor(LENGTHS))
    got = lg[:, -1].float().numpy()
    want = np.asarray(jl[:, -1], np.float32)
    assert np.abs(got - want).max() <= BF16_LOGIT_ATOL
    out = tff.generate(PROMPT, 4, prompt_lengths=LENGTHS)
    assert out.shape == (3, 13) and ((out >= 0) & (out < VOCAB)).all()


# ---- sampling, by distribution --------------------------------------------


TIES = np.asarray([[2.0, 1.0, 2.0, 0.5, 2.0, 1.0, -1.0, 2.0],
                   [0.0, 3.0, 3.0, 3.0, 1.0, 1.0, 1.0, 1.0]], np.float32)


@pytest.mark.parametrize("top_k", [1, 2, 3, 5])
def test_keep_sets_match_jax_top_k_scatter_with_ties(top_k):
    """The warp keeps exactly JAX's ``lax.top_k`` scatter: the same k
    vocabulary entries on tied logits (ties to the lower index), with the
    same warped values, and -inf elsewhere."""
    t = 0.7
    warped = TIES / t
    vals, idxs = jax.lax.top_k(jnp.asarray(warped), top_k)
    want = np.asarray(jnp.full_like(warped, -jnp.inf).at[
        jnp.arange(2)[:, None], idxs].set(vals))
    gen = Generator.__new__(Generator)
    gen.temperature, gen.top_k = t, top_k
    got = gen._warp(torch.as_tensor(TIES)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], rtol=1e-6)


def _draws(gen, logits, seeds, n_rows):
    out = []
    for seed in seeds:
        keys = gen._draw_keys(gen._row_keys(seed, n_rows), 0)
        tok, _ = gen._sample(torch.as_tensor(logits).expand(n_rows, -1),
                             keys)
        out.append(tok.numpy())
    return np.concatenate(out)


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.6, 0),
                                               (1.3, 3)])
def test_sampled_frequencies_follow_softmax_over_temperature(temperature,
                                                             top_k):
    """20 seeds x 1000 rows of one logit row: the empirical frequencies
    are within total-variation distance 0.03 of softmax(logits / T) over
    the keep-set (expected ~0.01 at 20000 draws), and far from the
    distribution at another temperature."""
    logits = np.asarray([1.5, 0.2, -0.7, 1.1, 0.0, 2.0], np.float32)
    gen = Generator.__new__(Generator)
    gen.model = type("M", (), {"device": torch.device("cpu")})()
    gen.temperature, gen.top_k = temperature, top_k
    toks = _draws(gen, logits, range(20), 1000)
    freq = np.bincount(toks, minlength=6) / toks.size

    def target(t):
        w = logits / t
        if top_k:
            w = np.where(np.argsort(np.argsort(-w, kind="stable"),
                                    kind="stable") < top_k, w, -np.inf)
        p = np.exp(w - w.max())
        return p / p.sum()

    assert 0.5 * np.abs(freq - target(temperature)).sum() < 0.03
    assert 0.5 * np.abs(freq - target(temperature * 3)).sum() > 0.06
    if top_k:
        assert set(np.unique(toks)) <= {5, 0, 3}


def test_sampled_generate_is_a_function_of_the_seed(pair):
    _, tff = pair
    kw = dict(temperature=0.8, top_k=50)
    a = tff.generate(PROMPT, 12, seed=3, **kw)
    np.testing.assert_array_equal(a, tff.generate(PROMPT, 12, seed=3, **kw))
    b = tff.generate(PROMPT, 12, seed=4, **kw)
    assert not np.array_equal(a, b)
    # rows draw independent streams: the same prompt twice parts
    same = np.repeat(PROMPT[:1], 3, axis=0)
    c = tff.generate(same, 12, seed=3, **kw)
    assert len({tuple(r) for r in c[:, 9:]}) > 1


def test_top_k_at_least_vocab_is_a_no_op_that_warns_once(caplog):
    logits = torch.as_tensor(TIES)
    gen = Generator.__new__(Generator)
    gen.temperature = 0.9
    gen.top_k = 0
    full = gen._warp(logits)
    gen.top_k = TIES.shape[1]
    with caplog.at_level("WARNING"):
        a = gen._warp(logits)
        b = gen._warp(logits)
    assert torch.equal(a, full) and torch.equal(b, full)
    assert sum("top_k=8 >= vocab 8" in r.getMessage()
               for r in caplog.records) == 1


def test_generate_runs_on_the_model_device(pair):
    """A model built with device="cpu" decodes on the CPU: its programs'
    state is there and their step runs eagerly (no capture stream)."""
    _, tff = pair
    tff.generate(PROMPT, 2)
    for gen in tff._decoders.values():
        for loop in gen._programs.values():
            assert loop.step.stream is None
            assert all(t.device.type == "cpu" for t in loop.state.values())


def test_f32_master_weights_decode_in_bf16_compute(pair):
    """A model compiled for training under bf16 compute keeps f32 master
    weights; generate casts them per use, as the JAX walk does: the tokens
    of a serving-compiled model holding the same weights in bf16."""
    from flexflow_tpu_torch import SGDOptimizer

    _, tff = pair
    models = []
    for opt in (SGDOptimizer(lr=0.1), None):
        ff = FFModel(FFConfig(batch_size=2, compute_dtype="bfloat16"),
                     device="cpu")
        _, logits = llama_lm(ff, 2, kv_heads=2, **ARCH)
        ff.compile(opt, final_tensor=logits)
        dt = torch.float32 if opt else torch.bfloat16
        ff.params = {op: {w: t.to(dt) for w, t in ws.items()}
                     for op, ws in tff.params.items()}
        models.append(ff)
    master, served = models
    assert master.params["lm_head"]["kernel"].dtype == torch.float32
    np.testing.assert_array_equal(master.generate(PROMPT, 6),
                                  served.generate(PROMPT, 6))

