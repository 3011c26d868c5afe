"""Chunked prefill, chunk-interleaved admission and the decode chunk of the
PyTorch port's serving engine against the JAX package.

The small Llama of tests/test_torch_serving.py (hidden 64, 2 layers, 4
heads over 2 kv heads, vocab 89, f32) is built in both packages, the
JAX-initialised weights carried into the port with ``params_from_jax``.
Held to JAX:

  * ``Generator._prefill`` with ``prefill_chunk``: ragged rows, every chunk
    cache-only, then the query of each row's last token — first-token
    logits within 1e-4 of JAX's chunked prefill and of the port's
    whole-prompt prefill (sums in other orders; f32);
  * the engine with ``prefill_chunk`` (cold and prefix-hit admissions) and
    with ``prefill_interleave_chunks`` (a long cold prompt's chunks run a
    few a tick between decode dispatches): greedy tokens identical to the
    JAX engine's and to whole-prompt prefill's; the interleave counters
    and the prefix cache's ledger equal JAX's; interleaving under
    speculation (the draft prefills when the last chunk lands) gives the
    plain engine's tokens;
  * decode-chunk invariance (JAX's ``test_decode_chunk_invariance``): any
    ``decode_chunk`` gives the same tokens, eos landing mid-chunk included.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu.runtime.generation import Generator as JGenerator
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import llama_lm
from flexflow_tpu_torch.runtime.generation import Generator

VOCAB = 89
ARCH = dict(seq_len=16, hidden=64, layers=2, heads=4, kv_heads=2,
            vocab_size=VOCAB)
DRAFT = dict(ARCH, hidden=32, layers=1, heads=2)
ENGINE = dict(serve_slots=2, kv_page_size=4, max_seq_len=64)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# ragged, and long enough for several chunks of 4 or 8
PROMPT_LENS = (5, 19, 3, 30, 12)
MAX_NEW = 6
# the interleave counters and the cache ledger held to JAX's
STATS = ("prefill_chunks_interleaved", "prefill_preempted_ticks",
         "prefill_partial_slots", "prefix_lookups", "prefix_hits",
         "kv_pages_cached", "free_pages", "prefix_refs_live",
         "tokens_generated", "decode_steps")


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
def models():
    return _pair(ARCH)


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(7)
    return [rs.randint(1, VOCAB, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def _shared_prefix_prompts():
    """Prompts sharing an 8-token (two-page) prefix, so a second round
    hits the prefix cache."""
    rs = np.random.RandomState(9)
    system = rs.randint(1, VOCAB, (8,)).astype(np.int32)
    return [np.concatenate([system, rs.randint(1, VOCAB, (n,))
                            .astype(np.int32)]) for n in (3, 11, 22, 6)]


@pytest.mark.parametrize("chunk", [8])
def test_chunked_prefill_logits_match_jax(models, prompts, chunk):
    """Two ragged rows through the chunked prefill: the logits at each
    row's last position within 1e-4 of JAX's chunked prefill and of the
    port's whole-prompt prefill."""
    jff, tff = models
    rows = [prompts[1], prompts[3]]
    bucket = 32
    padded = np.zeros((2, bucket), np.int32)
    for i, p in enumerate(rows):
        padded[i, :p.size] = p
    lengths = np.asarray([p.size for p in rows], np.int32)
    jgen = JGenerator(jff)
    jcaches = {op.name: op.init_cache(2, bucket, jnp.float32)
               for op in jgen.attn_ops}
    jlogits, _ = jgen._prefill(jff.params, jff.bn_state, jnp.asarray(padded),
                               jcaches, jnp.asarray(lengths), chunk)
    gen = Generator(tff)
    out = {}
    for c in (chunk, 0):
        caches = {op.name: op.init_cache(2, bucket, torch.float32, "cpu")
                  for op in gen.attn_ops}
        with torch.inference_mode():
            logits, _ = gen._prefill(tff.params, torch.as_tensor(padded),
                                     caches, torch.as_tensor(lengths), c)
        out[c] = logits.numpy()[:, -1]
    np.testing.assert_allclose(out[chunk], np.asarray(jlogits)[:, -1],
                               **LOGIT_TOL)
    np.testing.assert_allclose(out[chunk], out[0], **LOGIT_TOL)


def _run_both(jff, tff, prompts, rounds=1, **kw):
    """The same prompts through both engines (``rounds`` times each, on
    one engine); returns the tokens of every round and both stats."""
    jeng = jff.make_serving_engine(paged_attention_impl="einsum", **kw)
    eng = tff.make_serving_engine(**kw)
    jt, tt = [], []
    for _ in range(rounds):
        jt += [r.tokens for r in jeng.run(prompts, max_new_tokens=MAX_NEW)]
        reqs = eng.run(prompts, max_new_tokens=MAX_NEW)
        assert all(r.state == "done" for r in reqs)
        tt += [r.tokens for r in reqs]
    return tt, jt, eng.stats(), jeng.stats()


@pytest.mark.parametrize("chunk,prefix", [(4, False), (8, True)],
                         ids=["cold-4", "prefix-8"])
def test_chunked_prefill_engine_matches_jax(models, prompts, chunk, prefix):
    """``prefill_chunk``: the JAX engine's tokens and the whole-prompt
    engine's; with the prefix cache, shared-prefix prompts served twice
    (hits in the second round)."""
    jff, tff = models
    ps = _shared_prefix_prompts() if prefix else prompts
    kw = dict(ENGINE, prefix_cache=prefix)
    whole = [r.tokens for r in tff.make_serving_engine(**kw).run(
        ps, max_new_tokens=MAX_NEW)]
    tt, jt, st, jst = _run_both(jff, tff, ps, rounds=2 if prefix else 1,
                                prefill_chunk=chunk, **kw)
    assert tt == jt
    assert tt[:len(ps)] == whole
    for key in STATS:
        assert st[key] == jst[key], key
    if prefix:
        assert st["prefix_hits"] >= len(ps)


@pytest.mark.parametrize("per_tick,prefix", [(1, False), (2, True)],
                         ids=["cold-1", "prefix-2"])
def test_interleaved_admission_matches_jax(models, prompts, per_tick,
                                           prefix):
    """``prefill_interleave_chunks``: long cold prompts prefill a few
    chunks a tick between decode dispatches, round-robin across slots;
    tokens identical to the JAX engine's and to run-to-completion
    admission's, and the interleave counters equal JAX's (chunks run,
    ticks a prefill was preempted)."""
    jff, tff = models
    ps = _shared_prefix_prompts() if prefix else prompts
    kw = dict(ENGINE, prefix_cache=prefix, prefill_chunk=4)
    whole = [r.tokens for r in tff.make_serving_engine(**kw).run(
        ps, max_new_tokens=MAX_NEW)]
    tt, jt, st, jst = _run_both(jff, tff, ps, rounds=2 if prefix else 1,
                                prefill_interleave_chunks=per_tick, **kw)
    assert tt == jt
    assert tt[:len(ps)] == whole
    for key in STATS:
        assert st[key] == jst[key], key
    assert st["prefill_chunks_interleaved"] > 0
    assert st["prefill_preempted_ticks"] > 0
    assert st["prefill_partial_slots"] == 0


def test_interleaved_admission_with_speculation(models, prompts):
    """Interleaving under speculation: the draft prefills when the
    target's last chunk lands; tokens are the plain engine's (greedy
    speculation emits the target's argmax whatever the draft)."""
    _, tff = models
    draft = FFModel(FFConfig(batch_size=2, seed=1), device="cpu")
    _, logits = llama_lm(draft, 2, **DRAFT)
    draft.compile(final_tensor=logits)
    want = [r.tokens for r in tff.make_serving_engine(**ENGINE).run(
        prompts, max_new_tokens=MAX_NEW)]
    eng = tff.make_serving_engine(draft_model=draft, speculate_k=3,
                                  prefill_chunk=4,
                                  prefill_interleave_chunks=1, **ENGINE)
    got = [r.tokens for r in eng.run(prompts, max_new_tokens=MAX_NEW)]
    assert got == want
    st = eng.stats()
    assert st["prefill_chunks_interleaved"] > 0 and st["spec_proposed"] > 0
    assert st["prefill_partial_slots"] == 0
    assert st["free_pages"] + st["kv_pages_cached"] == st["kv_pages"] - 1


def test_interleave_validation(models):
    """The JAX engine's errors: the interleave needs a chunk, and neither
    may be negative."""
    jff, tff = models
    for kw, msg in ((dict(prefill_interleave_chunks=2), "needs "
                     "prefill_chunk"),
                    (dict(prefill_interleave_chunks=-1, prefill_chunk=4),
                     "must be >= 0")):
        with pytest.raises(ValueError, match=msg):
            tff.make_serving_engine(**ENGINE, **kw)
        with pytest.raises(ValueError, match=msg):
            jff.make_serving_engine(**ENGINE, **kw)
    with pytest.raises(ValueError, match="prefill_interleave_chunks"):
        FFConfig(prefill_interleave_chunks=-1)


def test_decode_chunk_invariance(models, prompts):
    """``decode_chunk`` trades host round trips for retirement
    granularity only: chunks of 1, 3 and 16 give the same tokens, with an
    eos landing mid-chunk and max_new_tokens not a multiple of the chunk;
    chunk 1 is the JAX engine's stream under the same eos."""
    jff, tff = models
    ps = prompts[:4]
    first = tff.make_serving_engine(**ENGINE).run(ps[:1], 10)[0].tokens
    eos = int(first[2])
    outs = {}
    for chunk in (1, 3, 16):
        eng = tff.make_serving_engine(decode_chunk=chunk, eos_id=eos,
                                      **ENGINE)
        reqs = eng.run(ps, max_new_tokens=10)
        assert [r.state for r in reqs] == ["done"] * len(ps)
        outs[chunk] = [r.tokens for r in reqs]
        # one decode program a chunk size
        assert eng.stats()["recompiles"] == 1
    assert outs[1] == outs[3] == outs[16]
    jeng = jff.make_serving_engine(decode_chunk=1, eos_id=eos,
                                   paged_attention_impl="einsum", **ENGINE)
    assert [r.tokens for r in jeng.run(ps, max_new_tokens=10)] == outs[1]
    assert outs[1][0][-1] == eos
    assert max(len(t) for t in outs[1]) == 10
    assert math.isfinite(eng.stats()["decode_step_ms"])
