"""The radix prefix cache of the PyTorch port (HBM tier) against the JAX
package — the port of tests/test_serving.py's prefix-cache tests.

Pure host: the trie round-trip, an insert stopping at an existing chunk,
refcounts and LRU eviction with its cascade and protection. Engine level
(the small f32 Llama of tests/test_torch_serving.py, JAX weights carried
across with ``params_from_jax``, JAX on its einsum route): shared-prefix
prompts served twice give the JAX engine's greedy tokens and the same cache
ledger, and the tokens of a port engine with the cache off; copy-on-write
leaves a donor's published pages bitwise untouched by borrowers, payload
and scales of an int8 pool alike; a pool too small for the traffic evicts
under pressure as the JAX engine does; and after a run no reference is
live and a flush returns every page.
"""

import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import llama_lm
from flexflow_tpu_torch.runtime.serving import RadixPrefixCache

VOCAB = 89
ARCH = dict(seq_len=16, hidden=64, layers=2, heads=4, kv_heads=2,
            vocab_size=VOCAB)
LEDGER = ("prefix_lookups", "prefix_hits", "prefix_hit_rate",
          "prefill_tokens_saved", "prefix_evictions", "kv_pages_cached",
          "kv_pages_shared", "free_pages", "prefix_refs_live", "kv_pages")


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


def _engines(jff, tff, **kw):
    return (jff.make_serving_engine(paged_attention_impl="einsum", **kw),
            tff.make_serving_engine(**kw))


def _same_run(j_eng, eng, prompts, max_new):
    j_reqs = j_eng.run(prompts, max_new_tokens=max_new)
    reqs = eng.run(prompts, max_new_tokens=max_new)
    for jr, tr in zip(j_reqs, reqs):
        assert tr.state == jr.state == "done"
        assert tr.tokens == jr.tokens, tr.rid
        assert tr.prefix_tokens == jr.prefix_tokens, tr.rid
    return reqs


def _ledger(eng):
    st = eng.stats()
    return {k: st[k] for k in LEDGER}


# ---- the trie, pure host ---------------------------------------------------


def test_radix_trie_match_insert_roundtrip():
    """A published prefix is found page-aligned: full pages only, longest
    path wins, the partial last page never enters the trie."""
    pc = RadixPrefixCache(4)
    prompt = np.arange(1, 14, dtype=np.int32)         # 13 tokens: 3 full
    created = pc.insert(prompt, [], 0, [7, 8, 9])
    assert [n.page for n in created] == [7, 8, 9] and pc.pages == 3
    assert [n.page for n in pc.match(prompt, 3)] == [7, 8, 9]
    other = prompt.copy()
    other[9] = 77                                     # shares 8 tokens
    assert [n.page for n in pc.match(other, 3)] == [7, 8]
    assert [n.page for n in pc.match(prompt, 1)] == [7]
    assert pc.match(np.full((8,), 60, np.int32), 2) == []
    # forget kills the unmounted childless tail of a cached path
    pc.release(created)
    pc.acquire(created[:1])
    assert sorted(pc.forget(prompt)) == [8, 9] and pc.pages == 1
    assert [n.page for n in pc.match(prompt, 3)] == [7]


def test_radix_trie_insert_stops_at_existing_chunk():
    """Publishing under a capped match stops at the first chunk that
    already exists — the duplicate page stays the caller's."""
    pc = RadixPrefixCache(4)
    prompt = np.arange(1, 13, dtype=np.int32)
    pc.insert(prompt, [], 0, [5, 6])
    assert pc.insert(prompt, [], 0, [11, 12]) == []
    assert pc.pages == 2
    created = pc.insert(prompt, pc.match(prompt, 3), 2, [13])
    assert [n.page for n in created] == [13] and pc.pages == 3


def test_radix_trie_refcounts_and_eviction():
    """Refcounted pages never evict; refcount-0 leaves evict LRU-first
    and cascade to exposed parents; a protected path survives; a flush
    reclaims everything unmounted and is no pressure eviction."""
    pc = RadixPrefixCache(4)
    a = np.arange(1, 9, dtype=np.int32)
    b = np.full((4,), 50, np.int32)
    na = pc.insert(a, [], 0, [1, 2])      # chain 1 -> 2
    nb = pc.insert(b, [], 0, [3])         # leaf 3
    pc.release(na)
    pc.release(nb)
    assert pc.live_refs() == 0 and pc.pages == 3
    pc.match(a, 2)                        # touch chain a (newer last_use)
    assert pc.evict(1) == [3]             # LRU leaf goes first
    assert sorted(pc.evict(2)) == [1, 2] and pc.pages == 0
    nc = pc.insert(a, [], 0, [4, 5])
    pc.acquire(nc[:1])
    assert pc.shared_pages() == 1 and pc.live_refs() == 3
    assert pc.evict(5) == [] and pc.pages == 2
    pc.release(nc)
    pc.release(nc[:1])
    assert pc.evict(5, protect=nc) == [] and pc.pages == 2
    assert sorted(pc.evict(5, pressure=False)) == [4, 5]
    assert pc.evictions == 3 and pc.pages == 0
    with pytest.raises(AssertionError, match="underflow"):
        pc.release(nc)


# ---- the engine ------------------------------------------------------------


def _shared(seed, system_len, tails):
    rs = np.random.RandomState(seed)
    system = rs.randint(1, VOCAB, (system_len,)).astype(np.int32)
    return [np.concatenate([system, rs.randint(1, VOCAB, (n,)).astype(
        np.int32)]) for n in tails]


def test_prefix_cache_twice_matches_jax_and_cold(jff, tff):
    """Shared-prefix traffic served twice on one engine: the second round
    mounts the pages the first published. Tokens equal the JAX engine's
    under the same traffic and a cache-less port engine's; the ledger
    (lookups, hits, tokens saved, cached pages) equals JAX's."""
    prompts = _shared(23, 12, (3, 7, 1, 5, 9))         # 3 shared pages
    kw = dict(serve_slots=2, kv_page_size=4, max_seq_len=64)
    j_eng, eng = _engines(jff, tff, **kw)
    cold = tff.make_serving_engine(prefix_cache=False, **kw)
    want = [r.tokens for r in cold.run(prompts, max_new_tokens=5)]
    for rnd in range(2):
        reqs = _same_run(j_eng, eng, prompts, 5)
        assert [r.tokens for r in reqs] == want
        assert _ledger(eng) == _ledger(j_eng)
    st = eng.stats()
    assert st["prefix_lookups"] == 2 * len(prompts)
    assert st["prefix_hits"] == 2 * len(prompts) - 1
    assert st["prefill_tokens_saved"] >= (2 * len(prompts) - 1) * 12
    assert st["free_pages"] + st["kv_pages_cached"] == st["kv_pages"] - 1
    cs = cold.stats()
    assert not cs["prefix_cache"] and cs["prefix_lookups"] == 0
    assert cs["free_pages"] == cs["kv_pages"] - 1


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_prefix_cow_isolation(jff, tff, kv):
    """Copy-on-write: borrowers mounting a published prefix write their
    tails and decode tokens into their own pages — the donor's pages
    (payload and, quantized, scales) are bitwise untouched, and every
    stream equals the JAX engine's."""
    prompts = _shared(29, 8, (2, 6, 4, 3))              # 2 shared pages
    j_eng, eng = _engines(jff, tff, serve_slots=2, kv_page_size=4,
                          max_seq_len=64, kv_cache_dtype=kv)
    _same_run(j_eng, eng, prompts[:1], 4)              # publish the prefix
    shared, node = [], eng.prefix_cache.root
    while node.children:
        node = next(iter(node.children.values()))
        shared.append(node.page)
    assert len(shared) >= 2
    idx = torch.as_tensor(shared)
    before = {op: {n: t[idx].clone() for n, t in c.items()}
              for op, c in eng.pool.items()}
    for r in _same_run(j_eng, eng, prompts[1:], 4):
        assert r.prefix_tokens >= 8
    for op, c in eng.pool.items():
        assert set(c) == ({"k", "v", "k_scale", "v_scale"} if kv == "int8"
                          else {"k", "v"})
        for n, t in c.items():
            assert torch.equal(t[idx].view(torch.uint8),
                               before[op][n].view(torch.uint8)), (op, n)
    st = eng.stats()
    assert st["kv_pages_shared"] == 0 and st["prefix_refs_live"] == 0


def test_prefix_evict_under_pressure(jff, tff):
    """A pool sized for one maximal request: cached pages from retired
    traffic are reclaimed LRU-first when admission needs them; the tokens
    and the eviction count equal the JAX engine's."""
    rs = np.random.RandomState(31)
    prompts = [rs.randint(1, VOCAB, (14,)).astype(np.int32)
               for _ in range(4)]
    j_eng, eng = _engines(jff, tff, serve_slots=1, kv_page_size=4,
                          max_seq_len=32, kv_pages=9)
    _same_run(j_eng, eng, prompts, 4)
    st = eng.stats()
    assert st["prefix_evictions"] > 0
    assert _ledger(eng) == _ledger(j_eng)
    assert st["free_pages"] + st["kv_pages_cached"] == st["kv_pages"] - 1
    assert st["prefix_refs_live"] == 0


def test_prefix_refcounts_clean_after_run(jff, tff):
    """Slots retire mid-chunk at mixed lengths: afterwards no trie
    reference is live, every page is free or cached, and a flush returns
    the pool to exactly kv_pages - 1 free (the leak check)."""
    prompts = _shared(37, 8, (1, 5, 2, 7, 3, 6))
    eng = tff.make_serving_engine(serve_slots=3, kv_page_size=4,
                                  max_seq_len=64, decode_chunk=3)
    for r in eng.run(prompts, max_new_tokens=7):
        assert r.state == "done" and not r.trie_nodes
    st = eng.stats()
    assert st["prefix_refs_live"] == 0 and st["kv_pages_cached"] > 0
    assert st["free_pages"] + st["kv_pages_cached"] == st["kv_pages"] - 1
    assert eng.flush_prefix_cache() == st["kv_pages_cached"]
    st = eng.stats()
    assert st["free_pages"] == st["kv_pages"] - 1
    assert st["kv_pages_cached"] == 0 and st["prefix_evictions"] == 0
