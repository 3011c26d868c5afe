"""The prefix cache's host tier in the PyTorch port, against the JAX
package.

The state machine alone: the sixteen scenarios of tests/test_tiered_prefix.py
run against both packages' ``RadixPrefixCache`` with the same fake D2H / H2D
(page payloads are dicts, a page's publish can be held behind an Event), and
each scenario's asserts hold in both; its counters and depth-1 tier events
are equal between the two.

Engine level (the small f32 Llama of tests/test_torch_serving.py, hidden
64, 2 layers, JAX weights carried across with ``params_from_jax``, JAX on
its einsum route): prompts of four prefix families served through a pool too
small to keep them, with a host tier, twice — greedy tokens, prefix hits and
the tier's counters equal the JAX engine's (native and int8 pools, with and
without a draft), and the tokens equal a port engine's with an ample pool
and no tier (a promoted page is its demoted self, bitwise); a page exported
before its demotion and after its promotion is the same bytes; after
``drain`` and a flush every pool page is free and the host tier empty; the
``FF_FAULT`` drills (a failed demotion, a failed promotion) fall back as
JAX's do, with the same tokens.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu.runtime import faultinject as j_faultinject
from flexflow_tpu.runtime import serving as j_serving
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import llama_lm
from flexflow_tpu_torch.runtime import faultinject as t_faultinject
from flexflow_tpu_torch.runtime import serving as t_serving

PS = 2  # the state machine's page size: tiny, so prompts stay readable
PKGS = {"jax": types.SimpleNamespace(cache=j_serving.RadixPrefixCache,
                                     faults=j_faultinject),
        "torch": types.SimpleNamespace(cache=t_serving.RadixPrefixCache,
                                       faults=t_faultinject)}


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("FF_FAULT", raising=False)
    for pkg in PKGS.values():
        pkg.faults.reset()
    yield
    for pkg in PKGS.values():
        pkg.faults.reset()


def _set_fault(monkeypatch, spec):
    monkeypatch.setenv("FF_FAULT", spec)
    for pkg in PKGS.values():
        pkg.faults.reset()


class FakeIO:
    """Batched D2H / H2D fakes (tests/test_tiered_prefix.py's): payloads
    are dicts; ``gate(page)`` holds that page's publish behind an Event."""

    def __init__(self):
        self.gates = {}
        self.published = []
        self.written = []
        self.h2d_boom = False

    def gate(self, page):
        ev = self.gates[page] = threading.Event()
        return ev

    def d2h(self, pages):
        def resolve():
            out = []
            for page in pages:
                ev = self.gates.get(page)
                if ev is not None:
                    assert ev.wait(30), f"gate for page {page} never opened"
                self.published.append(page)
                out.append({"page": page, "bytes": f"kv-{page}"})
            return out

        return resolve

    def h2d(self, pages, payloads):
        if self.h2d_boom:
            raise RuntimeError("injected H2D loss")
        self.written.extend((int(p), pl) for p, pl in zip(pages, payloads))


def make_cache(pkg, host_pages=8):
    io = FakeIO()
    return pkg.cache(PS, host_pages=host_pages, d2h=io.d2h, h2d=io.h2d), io


def publish(cache, prompt, pages):
    """Publish ``pages`` for ``prompt`` as a finished prefill does: inserted
    at ref 1, released to the warm refcount-0 state."""
    prompt = np.asarray(prompt, np.int32)
    matched = cache.match(prompt, len(prompt) // PS)
    created = cache.insert(prompt, matched, len(matched), list(pages))
    cache.release(created)
    return matched + created


def prompt_of(*chunks):
    return np.asarray([t for c in chunks for t in c], np.int32)


def ledger(cache, io=None):
    """What must agree between the packages after a scenario."""
    out = {k: getattr(cache, k) for k in (
        "pages", "host_used", "demotions", "promotions", "demote_failures",
        "promote_failures", "host_evictions", "evictions")}
    out["live_refs"] = cache.live_refs()
    out["tier_events"] = list(cache.tier_events)
    if io is not None:
        out["published"] = list(io.published)
        out["written"] = list(io.written)
    return out


# ---- the scenarios: each runs its asserts on one package and returns the
# ledger the two packages must agree on ----------------------------------


def sc_demote_promote_roundtrip(pkg):
    cache, io = make_cache(pkg)
    path = publish(cache, prompt_of((1, 2), (3, 4)), [5, 6])
    freed = cache.evict(2)
    assert sorted(freed) == [5, 6]
    assert [n.tier for n in path] == ["host", "host"]
    assert cache.pages == 0 and cache.host_used == 2
    assert cache.demotions == 2
    assert cache.wait_migrations(5)
    assert cache.promote(path[0], 9)
    assert path[0].tier == "hbm" and path[0].page == 9
    assert io.written[0][0] == 9
    assert cache.promotions == 1
    assert cache.host_used == 1 and cache.pages == 1
    m = cache.match(prompt_of((1, 2), (3, 4)), 2)
    assert [n.tier for n in m] == ["hbm", "host"]
    return ledger(cache, io)


def sc_ordered_publisher(pkg):
    cache, io = make_cache(pkg)
    publish(cache, prompt_of((1, 2)), [3])
    publish(cache, prompt_of((5, 6)), [4])
    g3, g4 = io.gate(3), io.gate(4)
    cache.match(prompt_of((1, 2)), 1)
    freed = cache.evict(2)
    assert sorted(freed) == [3, 4]
    g3.set()
    time.sleep(0.05)
    assert io.published == []
    g4.set()
    assert cache.wait_migrations(5)
    assert io.published == [4, 3]
    return ledger(cache, io)


def sc_promote_waits_for_publish(pkg):
    cache, io = make_cache(pkg)
    (node,) = publish(cache, prompt_of((1, 2)), [3])
    gate = io.gate(3)
    cache.evict(1)
    assert node.tier == "host" and node.hostdata is None
    got = {}
    t = threading.Thread(target=lambda: got.update(ok=cache.promote(node,
                                                                    7)))
    t.start()
    time.sleep(0.05)
    assert t.is_alive(), "promote must wait for the pending publish"
    gate.set()
    t.join(10)
    assert got["ok"] and node.tier == "hbm" and node.page == 7
    assert io.written[0][0] == 7
    return ledger(cache, io)


def sc_refcount_rules(pkg):
    cache, io = make_cache(pkg)
    (node,) = publish(cache, prompt_of((1, 2)), [3])
    cache.acquire([node])
    assert cache.evict(1) == []
    assert node.tier == "hbm"
    cache.release([node])
    cache.evict(1)
    assert node.tier == "host"
    with pytest.raises(AssertionError, match="promoted before"):
        cache.acquire([node])
    assert cache.live_refs() == 0
    assert cache.promote(node, 9)
    cache.acquire([node])
    assert cache.live_refs() == 1
    cache.release([node])
    return ledger(cache, io)


def sc_path_invariant(pkg):
    cache, io = make_cache(pkg)
    a, b, c = publish(cache, prompt_of((1, 2), (3, 4), (5, 6)), [3, 4, 5])
    tiers = []
    for _ in range(3):
        cache.evict(1)
        tiers.append([n.tier for n in (a, b, c)])
    assert tiers == [["hbm", "hbm", "host"], ["hbm", "host", "host"],
                     ["host", "host", "host"]]
    assert cache.wait_migrations(5)
    assert cache.promote(a, 9)
    assert [n.tier for n in (a, b, c)] == ["hbm", "host", "host"]
    return ledger(cache, io)


def sc_host_lru(pkg):
    cache, io = make_cache(pkg, host_pages=2)
    n1 = publish(cache, prompt_of((1, 2)), [3])[0]
    n2 = publish(cache, prompt_of((5, 6)), [4])[0]
    n3 = publish(cache, prompt_of((7, 8)), [5])[0]
    cache.match(prompt_of((1, 2)), 1)
    freed = cache.evict(3)
    assert sorted(freed) == [3, 4, 5]
    assert cache.wait_migrations(5)
    assert cache.host_used == 2 and cache.host_evictions == 1
    assert [n.tier for n in (n1, n2, n3)].count("host") == 2
    assert n1.tier == "host", "the warmest page must survive the LRU"
    dead = n2 if n2.tier != "host" else n3
    assert cache.match(prompt_of(tuple(dead.chunk)), 1) == []
    return ledger(cache, io)


def sc_abandoned_publish_dropped(pkg):
    cache, io = make_cache(pkg)
    (node,) = publish(cache, prompt_of((1, 2)), [3])
    gate = io.gate(3)
    cache.evict(1)
    gen_at_demote = node.gen
    cache.evict(cache.host_pages + 8, pressure=False)
    assert node.tier == "reaped" and node.gen > gen_at_demote
    gate.set()
    assert cache.wait_migrations(5)
    assert node.hostdata is None, "late publish resurrected a dead node"
    assert cache.host_used == 0
    assert cache.match(prompt_of((1, 2)), 1) == []
    return ledger(cache, io)


def sc_republish_new_generation(pkg):
    cache, io = make_cache(pkg)
    publish(cache, prompt_of((1, 2)), [3])
    gate = io.gate(3)
    cache.evict(1)
    cache.evict(99, pressure=False)
    (new,) = publish(cache, prompt_of((1, 2)), [6])
    gate.set()
    assert cache.wait_migrations(5)
    assert new.tier == "hbm" and new.page == 6
    cache.evict(1)
    assert cache.wait_migrations(5)
    assert new.hostdata == {"page": 6, "bytes": "kv-6"}
    return ledger(cache, io)


def sc_d2h_fail(pkg):
    cache, io = make_cache(pkg)
    publish(cache, prompt_of((1, 2)), [3])
    publish(cache, prompt_of((5, 6)), [4])
    freed = cache.evict(2)
    assert sorted(freed) == [3, 4]
    assert cache.demote_failures == 1 and cache.demotions == 1
    assert cache.host_used == 1
    alive = [p for p in ((1, 2), (5, 6)) if cache.match(prompt_of(p), 1)]
    assert len(alive) == 1
    assert cache.wait_migrations(5)
    return ledger(cache, io)


def sc_d2h_fail_on_parent(pkg):
    cache, io = make_cache(pkg)
    publish(cache, prompt_of((1, 2), (3, 4)), [5, 6])
    freed = cache.evict(2)
    assert sorted(freed) == [5, 6], "both pages free, each exactly once"
    assert cache.pages == 0 and cache.host_used == 0
    assert cache.demote_failures == 1
    assert cache.match(prompt_of((1, 2)), 1) == []
    assert cache.wait_migrations(5)
    assert io.published == [], "nothing may publish after the kill"
    return ledger(cache, io)


def sc_h2d_fail(pkg):
    cache, io = make_cache(pkg)
    (n1,) = publish(cache, prompt_of((1, 2)), [3])
    (n2,) = publish(cache, prompt_of((5, 6)), [4])
    cache.evict(2)
    assert cache.wait_migrations(5)
    assert not cache.promote(n1, 9), "injected h2d_fail must fail"
    assert cache.promote_failures == 1 and n1.tier == "reaped"
    assert cache.match(prompt_of((1, 2)), 1) == []
    assert cache.promote(n2, 9) and n2.tier == "hbm"
    return ledger(cache, io)


def sc_h2d_exception(pkg):
    cache, io = make_cache(pkg)
    (node,) = publish(cache, prompt_of((1, 2)), [3])
    cache.evict(1)
    assert cache.wait_migrations(5)
    io.h2d_boom = True
    assert not cache.promote(node, 9)
    assert cache.promote_failures == 1 and node.tier == "reaped"
    return ledger(cache, io)


def sc_tier_off(pkg):
    cache = pkg.cache(PS)
    publish(cache, prompt_of((1, 2), (3, 4)), [3, 4])
    freed = cache.evict(2)
    assert sorted(freed) == [3, 4]
    assert cache.host_used == 0 and cache.demotions == 0
    assert cache.match(prompt_of((1, 2)), 1) == []
    with pytest.raises(ValueError, match="d2h and h2d"):
        pkg.cache(PS, host_pages=4)
    return ledger(cache)


def sc_flush_kills_both_tiers(pkg):
    cache, io = make_cache(pkg)
    publish(cache, prompt_of((1, 2)), [3])
    publish(cache, prompt_of((5, 6)), [4])
    cache.evict(1)
    assert cache.wait_migrations(5)
    freed = cache.evict(99, pressure=False)
    assert len(freed) == 1
    assert cache.pages == 0 and cache.host_used == 0
    assert cache.evictions == 1
    return ledger(cache, io)


def sc_tier_events(pkg):
    cache, io = make_cache(pkg, host_pages=1)
    (n1,) = publish(cache, prompt_of((1, 2)), [3])
    publish(cache, prompt_of((5, 6)), [4])
    cache.evict(1)
    assert cache.wait_migrations(5)
    cache.promote(n1, 9)
    cache.evict(1)
    assert cache.wait_migrations(5)
    out = ledger(cache, io)
    events = cache.drain_tier_events()
    assert events and all(isinstance(k, tuple) and t in ("host", "hbm", None)
                          for k, t in events)
    assert cache.drain_tier_events() == []
    return out


def sc_forget_reinsert(pkg):
    cache, io = make_cache(pkg)
    p = prompt_of((1, 2), (3, 4))
    publish(cache, p, [3, 4])
    assert sorted(cache.forget(p)) == [3, 4]
    assert cache.match(p, 2) == []
    publish(cache, p, [5, 6])
    assert [n.page for n in cache.match(p, 2)] == [5, 6]
    return ledger(cache, io)


SCENARIOS = {
    "demote_promote_roundtrip": (sc_demote_promote_roundtrip, ""),
    "ordered_publisher": (sc_ordered_publisher, ""),
    "promote_waits_for_publish": (sc_promote_waits_for_publish, ""),
    "refcount_rules": (sc_refcount_rules, ""),
    "path_invariant": (sc_path_invariant, ""),
    "host_lru": (sc_host_lru, ""),
    "abandoned_publish_dropped": (sc_abandoned_publish_dropped, ""),
    "republish_new_generation": (sc_republish_new_generation, ""),
    "d2h_fail": (sc_d2h_fail, "d2h_fail@migrate:1"),
    "d2h_fail_on_parent": (sc_d2h_fail_on_parent, "d2h_fail@migrate:2"),
    "h2d_fail": (sc_h2d_fail, "h2d_fail@promote:1"),
    "h2d_exception": (sc_h2d_exception, ""),
    "tier_off": (sc_tier_off, ""),
    "flush_kills_both_tiers": (sc_flush_kills_both_tiers, ""),
    "tier_events": (sc_tier_events, ""),
    "forget_reinsert": (sc_forget_reinsert, ""),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_state_machine_scenario(name, monkeypatch):
    """One scenario of tests/test_tiered_prefix.py on both packages: its
    asserts hold in each, and the counters, tier events, publish order and
    H2D writes are equal."""
    fn, fault = SCENARIOS[name]
    got = {}
    for pkg_name, pkg in PKGS.items():
        _set_fault(monkeypatch, fault)
        got[pkg_name] = fn(pkg)
    assert got["torch"] == got["jax"]


# ---- engine level ------------------------------------------------------------

VOCAB = 89
ARCH = dict(seq_len=16, hidden=64, layers=2, heads=4, kv_heads=2,
            vocab_size=VOCAB)
DRAFT = dict(ARCH, hidden=32, layers=1, heads=2)
ENGINE = dict(serve_slots=2, kv_page_size=4, max_seq_len=32)
TIGHT = dict(kv_pages=13, host_kv_pages=24)
AMPLE = dict(kv_pages=80, host_kv_pages=0)
MAX_NEW = 3
TIER_STATS = ("prefix_lookups", "prefix_hits", "tier_demotions",
              "tier_promotions", "tier_demote_failures",
              "tier_promote_failures", "tier_host_evictions",
              "kv_pages_host", "kv_pages_hbm", "free_pages",
              "prefix_evictions", "tokens_generated")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread runs them faster than the
    default pool, whose threads spin against the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch):
    jff = JModel(JConfig(batch_size=2, mesh_shape={"data": 1}))
    _, logits = j_llama_lm(jff, 2, **arch)
    jff.compile(final_tensor=logits)
    tff = FFModel(FFConfig(batch_size=2), device="cpu")
    _, logits = llama_lm(tff, 2, **arch)
    tff.compile(final_tensor=logits)
    tff.params = params_from_jax(
        {op: {w: np.asarray(a) for w, a in ws.items()}
         for op, ws in jff.params.items()}, "cpu", torch.float32, model=tff)
    return jff, tff


@pytest.fixture(scope="module")
def models():
    return _pair(ARCH)


@pytest.fixture(scope="module")
def drafts():
    return _pair(DRAFT)


def _traffic():
    """Four families of a 2-page shared prefix with 1..7-token tails, two
    prompts a family, families in turn, then the first two families
    again: more distinct prefix pages than the tight pool keeps."""
    rs = np.random.RandomState(11)
    fams = [rs.randint(1, VOCAB, size=8) for _ in range(4)]
    tails = [rs.randint(1, VOCAB, size=1 + (i % 7)) for i in range(8)]
    first = [np.concatenate([fams[i // 2], tails[i]]).astype(np.int32)
             for i in range(8)]
    return first, first[:4]


def _serve(eng, rounds):
    out = []
    for prompts in rounds:
        out += eng.run(prompts, max_new_tokens=MAX_NEW)
    return out


def _engines(models, drafts, kv, draft, **kw):
    jff, tff = models
    jk = dict(ENGINE, paged_attention_impl="einsum", kv_cache_dtype=kv, **kw)
    tk = dict(ENGINE, kv_cache_dtype=kv, **kw)
    if draft:
        jk.update(draft_model=drafts[0], speculate_k=2)
        tk.update(draft_model=drafts[1], speculate_k=2)
    return jff.make_serving_engine(**jk), tff.make_serving_engine(**tk)


@pytest.mark.parametrize("kv,draft", [("native", False), ("int8", False),
                                      ("native", True), ("int8", True)],
                         ids=["native", "int8", "native-draft", "int8-draft"])
def test_tier_engine_matches_jax(models, drafts, kv, draft):
    """Pool pressure with a host tier: tokens, prefix hits and the tier's
    counters equal the JAX engine's; pages demote and promote; the tokens
    equal an ample-pool port engine's without a tier; a drained, flushed
    engine holds no page in either tier."""
    j_eng, eng = _engines(models, drafts, kv, draft, **TIGHT)
    rounds = _traffic()
    j_reqs, reqs = _serve(j_eng, rounds), _serve(eng, rounds)
    for jr, tr in zip(j_reqs, reqs):
        assert tr.state == jr.state == "done"
        assert tr.tokens == jr.tokens, tr.rid
        assert tr.prefix_tokens == jr.prefix_tokens, tr.rid
    j_eng.prefix_cache.wait_migrations()
    eng.prefix_cache.wait_migrations()
    st, jst = eng.stats(), j_eng.stats()
    for key in TIER_STATS:
        assert st[key] == jst[key], key
    assert st["tier_demotions"] > 0 and st["tier_promotions"] > 0
    assert st["tier_demote_failures"] == st["tier_promote_failures"] == 0
    _, ample = _engines(models, drafts, kv, draft, **AMPLE)
    for tr, ar in zip(reqs, _serve(ample, rounds)):
        assert tr.tokens == ar.tokens, tr.rid
        assert tr.prefix_tokens == ar.prefix_tokens, tr.rid
    eng.drain()
    eng.flush_prefix_cache()
    st = eng.stats()
    assert st["free_pages"] == st["kv_pages"] - 1
    assert st["kv_pages_host"] == 0 and st["prefix_refs_live"] == 0


def test_promoted_page_bitwise_its_demoted_self(models):
    """A family's prefix exported while in HBM, then demoted, then promoted
    by a hit and exported again: the same bytes, scales included."""
    _, tff = models
    eng = tff.make_serving_engine(kv_cache_dtype="int8", **ENGINE, **TIGHT)
    first, again = _traffic()
    eng.run(first[:2], max_new_tokens=MAX_NEW)
    before = eng.export_prefix_slab(first[0][:8])
    eng.run(first[2:], max_new_tokens=MAX_NEW)
    eng.prefix_cache.wait_migrations()
    node = eng.prefix_cache.match(first[0], 2)[0]
    assert node.tier == "host", "the first family must have been demoted"
    eng.run(again[:1], max_new_tokens=MAX_NEW)
    assert eng.prefix_cache.match(first[0], 2)[0].tier == "hbm"
    after = eng.export_prefix_slab(first[0][:8])
    assert eng.stats()["tier_promotions"] >= 2
    for pb, pa in zip(before["payload"], after["payload"]):
        assert pb.keys() == pa.keys()
        for key in pb:
            assert set(pb[key]) == {"k", "v", "k_scale", "v_scale"}
            for name in pb[key]:
                np.testing.assert_array_equal(pa[key][name], pb[key][name])


@pytest.mark.parametrize("fault", ["d2h_fail@migrate:2",
                                   "h2d_fail@promote:1"])
def test_fault_drills_fall_back_as_jax(models, drafts, fault, monkeypatch):
    """A failed demotion kills the page (as without a tier), a failed
    promotion kills the host copy and the admission prefills cold: the
    failure counters, hits and tokens equal the JAX engine's under the
    same FF_FAULT."""
    _set_fault(monkeypatch, fault)
    j_eng, eng = _engines(models, drafts, "native", False, **TIGHT)
    rounds = _traffic()
    j_reqs, reqs = _serve(j_eng, rounds), _serve(eng, rounds)
    for jr, tr in zip(j_reqs, reqs):
        assert tr.state == jr.state == "done"
        assert tr.tokens == jr.tokens and \
            tr.prefix_tokens == jr.prefix_tokens, tr.rid
    j_eng.prefix_cache.wait_migrations()
    eng.prefix_cache.wait_migrations()
    st, jst = eng.stats(), j_eng.stats()
    for key in TIER_STATS:
        assert st[key] == jst[key], key
    kind = fault.split("@")[0]
    assert st["tier_demote_failures" if kind == "d2h_fail"
              else "tier_promote_failures"] == 1


@pytest.mark.parametrize("kv", ["native", "bf16", "int8", "fp8"])
def test_export_import_page_bitwise_jax(models, kv):
    """``export_page`` gathers a pool's pages (payload and, for int8 / fp8,
    the scales) bitwise as JAX's does from the same pool; ``import_page``
    writes them into other pages verbatim, never requantizing: export
    then import round-trips bitwise, and the port's import of JAX's
    export equals JAX's import."""
    import jax.numpy as jnp

    from flexflow_tpu_torch.runtime.serving import payload_numpy

    jff, tff = models
    jop = next(op for op in jff.ops if type(op).__name__ ==
               "MultiHeadAttention")
    top = next(op for op in tff.ops if type(op).__name__ ==
               "MultiHeadAttention")
    kv_dtype = None if kv == "native" else kv
    jpool = jop.init_paged_cache(8, 4, jnp.float32, kv_dtype=kv_dtype)
    tpool = top.init_paged_cache(8, 4, torch.float32, "cpu",
                                 kv_dtype=kv_dtype)
    rs = np.random.RandomState(2)
    for name in tpool:
        src = rs.randn(*tpool[name].shape).astype(np.float32)
        if name.endswith("scale"):
            src = np.abs(src) * 0.01
        t = torch.from_numpy(src).to(tpool[name].dtype)
        tpool[name] = t
        jpool[name] = jnp.asarray(payload_numpy(t))
    pages = np.asarray([5, 2, 7], np.int32)
    jexp = jop.export_page(jpool, pages)
    texp = top.export_page(tpool, torch.from_numpy(pages).long())
    assert set(texp) == set(jexp) == set(tpool)
    for name in texp:
        assert payload_numpy(texp[name]).tobytes() \
            == np.asarray(jexp[name]).tobytes(), name
    dst = np.asarray([1, 3, 4], np.int32)
    before = {n: t.clone() for n, t in tpool.items()}
    top.import_page(tpool, torch.from_numpy(dst).long(), texp)
    jimp = jop.import_page(jpool, dst, jexp)
    for name in tpool:
        assert torch.equal(tpool[name][dst].view(torch.uint8),
                           texp[name].view(torch.uint8)), name
        assert payload_numpy(tpool[name]).tobytes() \
            == np.asarray(jimp[name]).tobytes(), name
        keep = [p for p in range(8) if p not in dst]
        assert torch.equal(tpool[name][keep].view(torch.uint8),
                           before[name][keep].view(torch.uint8))
    bad = dict(texp, k=texp["k"].float() if kv != "native"
               else texp["k"].double())
    with pytest.raises(ValueError, match="pool stores"):
        top.import_page(tpool, torch.from_numpy(dst).long(), bad)
