"""The serving engine's lifecycle API in the PyTorch port, against the JAX
package.

The small f32 Llama of tests/test_torch_serving.py (hidden 64, 2 layers, 4
heads over 2 kv heads, vocab 89), built in both packages, the
JAX-initialised weights carried into the port with ``params_from_jax``;
JAX's engines on their einsum route. Held to JAX:

  * ``drain`` with live and queued requests, ``reclaim_queued`` and
    ``reopen``: the same requests finish, the same come back, and served
    again they give JAX's tokens; ``submit`` on a draining engine raises;
  * ``submit(deadline=)``: a request still queued past its deadline
    retires "timeout" without prefilling (the ``timeouts`` stat);
  * ``health()`` and ``load()``: JAX's keys, and JAX's values after the
    same traffic (``recompiles`` aside: the port counts its decode-side
    programs only);
  * ``swap_weights`` to a second weight set: JAX's swapped tokens, those of
    a fresh engine on those weights, nothing built again; the swap back
    restores the first tokens; the int8-weight tier re-quantizes in place;
    refused under live slots; the ``swap_fail`` drill rolls back; at
    native width (a swap writes model.params) refused while another engine
    reads the model, which then keeps its tokens; an engine built while a
    swap stands serves the swapped version; a released engine (one with a
    host-tier publisher thread included) no longer blocks a swap;
  * the prefix slab: ``prefill_into_cache`` / ``export_prefix_slab`` /
    ``import_prefix_slab`` round-trip bitwise between two port engines
    (native and int8 pools), a JAX-exported slab imported by the port
    serves JAX's tokens as a prefix hit and re-exports bitwise, partial
    slabs and their refusals;
  * ``warmup``: the requests it ran, the programs it built, and serving the
    same prompts after it builds nothing.
"""

import time
import weakref

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu.runtime import faultinject as j_faultinject
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import llama_lm
from flexflow_tpu_torch.runtime import faultinject as t_faultinject

VOCAB = 89
ARCH = dict(seq_len=16, hidden=64, layers=2, heads=4, kv_heads=2,
            vocab_size=VOCAB)
ENGINE = dict(serve_slots=2, kv_page_size=4, max_seq_len=48)
MAX_NEW = 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread runs them faster than the
    default pool, whose threads spin against the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("FF_FAULT", raising=False)
    j_faultinject.reset()
    t_faultinject.reset()
    yield
    j_faultinject.reset()
    t_faultinject.reset()


def _np_tree(params):
    return {op: {w: np.asarray(a) for w, a in ws.items()}
            for op, ws in params.items()}


def _port_model(tree):
    tff = FFModel(FFConfig(batch_size=2), device="cpu")
    _, logits = llama_lm(tff, 2, **ARCH)
    tff.compile(final_tensor=logits)
    tff.params = params_from_jax(tree, "cpu", torch.float32, model=tff)
    return tff


@pytest.fixture(scope="module")
def models():
    jff = JModel(JConfig(batch_size=2, mesh_shape={"data": 1}))
    _, logits = j_llama_lm(jff, 2, **ARCH)
    jff.compile(final_tensor=logits)
    return jff, _port_model(_np_tree(jff.params))


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(9)
    return [rs.randint(1, VOCAB, size=n).astype(np.int32)
            for n in (6, 13, 3, 10, 17)]


def _engines(models, **kw):
    jff, tff = models
    return (jff.make_serving_engine(paged_attention_impl="einsum",
                                    **ENGINE, **kw),
            tff.make_serving_engine(**ENGINE, **kw))


def _same(j_reqs, t_reqs):
    for jr, tr in zip(j_reqs, t_reqs):
        assert tr.state == jr.state
        assert tr.tokens == jr.tokens, tr.rid


# ---- drain / reclaim / reopen, deadlines, health / load ----------------------


def test_drain_reclaim_reopen_match_jax(models, prompts):
    """Five requests, two slots, one tick, then drain(): the live requests
    finish, the queued ones stay queued and come back from
    reclaim_queued(); submit() raises while draining; after reopen() the
    reclaimed prompts serve JAX's tokens."""
    out = {}
    for name, eng in zip(("jax", "torch"), _engines(models)):
        reqs = [eng.submit(p, MAX_NEW) for p in prompts]
        eng.step()
        assert eng.health()["status"] == "busy"
        snap = eng.drain()
        assert snap["drained"] and snap["queued"] == 3
        with pytest.raises(RuntimeError, match="draining"):
            eng.submit(prompts[0], 2)
        assert eng.health()["status"] == "drained"
        assert not eng.step(), "a drained engine has no progressable work"
        back = eng.reclaim_queued()
        assert [r.rid for r in back] == [2, 3, 4]
        assert all(r.state == "queued" for r in back)
        eng.reopen()
        again = eng.run([r.prompt for r in back], MAX_NEW)
        st = eng.stats()
        assert st["prefix_refs_live"] == 0
        out[name] = ([r.state for r in reqs], [r.tokens for r in reqs[:2]],
                     [r.tokens for r in again], st["completed"])
    assert out["torch"] == out["jax"]


def test_deadline_expires_queued_request(models, prompts):
    """A request queued past its deadline retires "timeout" at the next
    tick without prefilling (no page, no token); the others serve JAX's
    tokens."""
    got = {}
    for name, eng in zip(("jax", "torch"), _engines(models)):
        expired = eng.submit(prompts[1], MAX_NEW,
                             deadline=time.perf_counter() - 1.0,
                             trace_id="t-1")
        live = [eng.submit(p, MAX_NEW, deadline=time.perf_counter() + 600)
                for p in prompts[2:4]]
        free0 = eng.stats()["free_pages"]
        eng.step()
        assert expired.state == "timeout" and expired.tokens == []
        assert expired.trace_id == "t-1"
        while eng.step():
            pass
        st = eng.stats()
        assert st["timeouts"] == 1 and st["completed"] == 2
        assert st["free_pages"] + st["kv_pages_cached"] == free0
        got[name] = [r.tokens for r in live]
    assert got["torch"] == got["jax"]


def test_deadline_expires_mid_prefill(models, prompts):
    """Under chunk-interleaved admission a request whose deadline passes
    while its chunks run retires "timeout" before decoding and frees its
    pages; the other requests serve JAX's tokens and the counters agree."""
    got = {}
    kw = dict(prefill_chunk=4, prefill_interleave_chunks=1)
    long = np.concatenate([prompts[4], prompts[3]]).astype(np.int32)[:24]
    for name, eng in zip(("jax", "torch"), _engines(models, **kw)):
        short = eng.submit(prompts[2], MAX_NEW)
        late = eng.submit(long, MAX_NEW, deadline=time.perf_counter() + 600)
        eng.step()
        assert late.state == "running" and not late.tokens
        late.deadline = time.perf_counter() - 1.0
        while eng.step():
            pass
        st = eng.stats()
        assert late.state == "timeout" and late.tokens == []
        assert st["timeouts"] == 1 and st["prefill_partial_slots"] == 0
        assert st["free_pages"] + st["kv_pages_cached"] == st["kv_pages"] - 1
        got[name] = (short.tokens, st["prefill_chunks_interleaved"])
    assert got["torch"] == got["jax"]


def test_health_from_another_thread(models, prompts):
    """health() and load() from another thread while step() runs: every
    probe answers, health() serializing behind the tick and load() reading
    without the lock; the statuses walk busy -> idle."""
    import threading

    _, tff = models
    eng = tff.make_serving_engine(decode_chunk=1, **ENGINE)
    seen, errors, stop = [], [], threading.Event()

    def probe():
        try:
            while not stop.is_set():
                seen.append((eng.health()["status"], eng.load()))
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)

    th = threading.Thread(target=probe)
    th.start()
    reqs = eng.run(prompts, MAX_NEW)
    stop.set()
    th.join()
    assert not errors and all(r.state == "done" for r in reqs)
    assert "busy" in {s for s, _ in seen}
    assert eng.health()["status"] == "idle"
    assert eng.load() == {"active_slots": 0, "queued": 0}


def test_health_and_load_match_jax(models, prompts):
    """health() and load(): JAX's keys, and its values after the same
    traffic, mid-run and drained (recompiles aside)."""
    snaps = {}
    for name, eng in zip(("jax", "torch"), _engines(models)):
        rows = [eng.health(), eng.load()]
        for p in prompts:
            eng.submit(p, MAX_NEW)
        eng.step()
        rows += [eng.health(), eng.load()]
        eng.drain()
        rows += [eng.health(), eng.load()]
        snaps[name] = rows
    for j, t in zip(snaps["jax"], snaps["torch"]):
        assert list(t) == list(j)
        for key in j:
            if key != "recompiles":
                assert t[key] == j[key], key


# ---- swap_weights ------------------------------------------------------------


def _second_weights(jff):
    rs = np.random.RandomState(21)
    return {op: {w: (rs.standard_normal(np.shape(a)) * 0.08)
                 .astype(np.float32) for w, a in ws.items()}
            for op, ws in jff.params.items()}


@pytest.mark.parametrize("weights", ["native", "int8"])
def test_swap_weights_matches_jax(models, prompts, weights):
    """A swap to a second weight set serves JAX's swapped tokens (native
    width) and a fresh engine's on those weights, with no program built
    again and the prefix cache flushed; the swap back restores the first
    tokens (the int8 tier re-quantizes in place both times)."""
    jff, tff = models
    new = _second_weights(jff)
    kw = dict(weight_dtype=weights)
    # JAX's swap at native width; the int8 tier against a fresh engine
    j_eng = (jff.make_serving_engine(paged_attention_impl="einsum",
                                     **ENGINE, **kw)
             if weights == "native" else None)
    eng = tff.make_serving_engine(**ENGINE, **kw)
    first = eng.run(prompts, MAX_NEW)
    if j_eng is not None:
        _same(j_eng.run(prompts, MAX_NEW), first)
    built = eng.stats()["recompiles"]
    t_new = params_from_jax(new, "cpu", torch.float32, model=tff)
    out = eng.swap_weights(t_new, "v1")
    assert out["version"] == "v1" and out["swaps"] == 1
    assert out["flushed_pages"] > 0
    swapped = eng.run(prompts, MAX_NEW)
    if j_eng is not None:
        j_eng.swap_weights(jax.tree.map(jax.numpy.asarray, new), "v1")
        _same(j_eng.run(prompts, MAX_NEW), swapped)
    assert any(a.tokens != b.tokens for a, b in zip(first, swapped))
    fresh = _port_model(new).make_serving_engine(**ENGINE, **kw)
    for a, b in zip(swapped, fresh.run(prompts, MAX_NEW)):
        assert a.tokens == b.tokens
    st = eng.stats()
    assert st["recompiles"] == built and st["weight_version"] == "v1"
    assert st["weight_swaps"] == 1 and st["deploy_state"] == "serving"
    eng.swap_weights(None, "v0")
    for a, b in zip(first, eng.run(prompts, MAX_NEW)):
        assert a.tokens == b.tokens
    # the construction weights are back in model.params, bitwise
    ref = params_from_jax(_np_tree(jff.params), "cpu", torch.float32,
                          model=tff)
    for op, ws in ref.items():
        for w, t in ws.items():
            assert torch.equal(tff.params[op][w], t), (op, w)


def test_swap_refused_live_and_rolled_back(models, prompts, monkeypatch):
    """swap_weights refuses while a slot is live; under FF_FAULT
    swap_fail@deploy:1 the install fails and the engine keeps serving the
    weights (and version) it had, bitwise."""
    jff, tff = models
    t_new = params_from_jax(_second_weights(jff), "cpu", torch.float32,
                            model=tff)
    eng = tff.make_serving_engine(decode_chunk=1, **ENGINE)
    first = eng.run(prompts[:2], MAX_NEW)
    eng.submit(prompts[0], MAX_NEW)
    eng.step()
    with pytest.raises(RuntimeError, match="live slots"):
        eng.swap_weights(t_new, "v1")
    eng.run()
    monkeypatch.setenv("FF_FAULT", "swap_fail@deploy:1")
    t_faultinject.reset()
    with pytest.raises(t_faultinject.InjectedFault):
        eng.swap_weights(t_new, "v1")
    st = eng.stats()
    assert st["weight_version"] == "v0" and st["weight_swaps"] == 0
    assert st["deploy_state"] == "serving"
    for a, b in zip(first, eng.run(prompts[:2], MAX_NEW)):
        assert a.tokens == b.tokens
    with pytest.raises(ValueError, match="geometry"):
        bad = {op: dict(ws) for op, ws in t_new.items()}
        bad["lm_head"]["kernel"] = bad["lm_head"]["kernel"][:, :-1]
        eng.swap_weights(bad, "v2")


def _tokens(eng, prompts):
    return [r.tokens for r in eng.run(prompts, MAX_NEW)]


@pytest.mark.parametrize("other", ["native", "int8", "draft"])
def test_native_swap_refused_while_another_engine_reads(models, prompts,
                                                        other):
    """At native width a swap writes model.params, which every engine on
    the model reads. While a second engine on it is alive — native, on an
    int8 weight tier, or serving another model with this one as its draft —
    the swap is refused and both engines keep their tokens. Released, the
    second engine no longer blocks; an engine built while the swap stands
    serves and reports the swapped version, and blocks the swap back until
    it is released too."""
    jff, _ = models
    tff = _port_model(_np_tree(jff.params))
    t_new = params_from_jax(_second_weights(jff), "cpu", torch.float32,
                            model=tff)
    eng = tff.make_serving_engine(**ENGINE)
    first = _tokens(eng, prompts)
    if other == "draft":
        sec = _port_model(_np_tree(jff.params)).make_serving_engine(
            **ENGINE, draft_model=tff, speculate_k=2)
    else:
        sec = tff.make_serving_engine(**ENGINE, weight_dtype=other)
    before = _tokens(sec, prompts)
    with pytest.raises(RuntimeError, match="other engine"):
        eng.swap_weights(t_new, "v1")
    assert eng.stats()["weight_version"] == "v0"
    assert eng.stats()["weight_swaps"] == 0
    assert _tokens(sec, prompts) == before
    assert _tokens(eng, prompts) == first
    del sec
    eng.swap_weights(t_new, "v1")
    swapped = _tokens(eng, prompts)
    assert swapped != first
    late = tff.make_serving_engine(**ENGINE)
    assert late.stats()["weight_version"] == "v1"
    assert _tokens(late, prompts) == swapped
    with pytest.raises(RuntimeError, match="other engine"):
        eng.swap_weights(None, "v0")
    del late
    eng.swap_weights(None, "v0")
    assert _tokens(eng, prompts) == first


def test_int8_engine_under_a_standing_native_swap(models, prompts):
    """An int8-weight engine built while a native swap stands quantizes the
    swapped weights and reports their version; its own swap back (None)
    serves the construction weights, from the host copy the native swap
    kept — as an int8 engine on them does."""
    jff, _ = models
    new = _second_weights(jff)
    tff = _port_model(_np_tree(jff.params))
    want_v0 = _tokens(tff.make_serving_engine(**ENGINE, weight_dtype="int8"),
                      prompts)
    want_v1 = _tokens(_port_model(new).make_serving_engine(
        **ENGINE, weight_dtype="int8"), prompts)
    eng = tff.make_serving_engine(**ENGINE)
    eng.swap_weights(params_from_jax(new, "cpu", torch.float32, model=tff),
                     "v1")
    q = tff.make_serving_engine(**ENGINE, weight_dtype="int8")
    assert q.stats()["weight_version"] == "v1"
    assert _tokens(q, prompts) == want_v1
    q.swap_weights(None, "v0")
    assert q.stats()["weight_version"] == "v0"
    assert _tokens(q, prompts) == want_v0
    del q
    eng.swap_weights(None, "v0")


def test_released_tier_engine_does_not_block_a_swap(models, prompts):
    """The host tier's publisher thread holds its cache weakly: an engine
    that demoted pages and was then dropped by its caller is collected,
    its publisher ends, and it no longer counts against a native swap."""
    jff, _ = models
    tff = _port_model(_np_tree(jff.params))
    rs = np.random.RandomState(5)
    fams = [rs.randint(1, VOCAB, size=8) for _ in range(4)]
    traffic = [np.concatenate([f, rs.randint(1, VOCAB, size=3)])
               .astype(np.int32) for f in fams for _ in range(2)]
    tier = tff.make_serving_engine(**ENGINE, kv_pages=13, host_kv_pages=24)
    tier.run(traffic, 3)
    tier.run(traffic[:2], 3)
    assert tier.stats()["tier_demotions"] > 0
    publisher = tier.prefix_cache._publisher
    assert publisher is not None and publisher.is_alive()
    eng = tff.make_serving_engine(**ENGINE)
    first = _tokens(eng, prompts)
    gone = weakref.ref(tier)
    del tier
    eng.swap_weights(params_from_jax(_second_weights(jff), "cpu",
                                     torch.float32, model=tff), "v1")
    assert gone() is None
    publisher.join(timeout=10.0)
    assert not publisher.is_alive()
    eng.swap_weights(None, "v0")
    assert _tokens(eng, prompts) == first


# ---- the prefix slab ---------------------------------------------------------


def _assert_slabs_equal(a, b):
    assert a["page_size"] == b["page_size"] and a["ns"] == b["ns"]
    assert a["start_page"] == b["start_page"]
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert len(a["payload"]) == len(b["payload"])
    for pa, pb in zip(a["payload"], b["payload"]):
        assert pa.keys() == pb.keys()
        for key in pa:
            assert pa[key].keys() == pb[key].keys()
            for name in pa[key]:
                assert np.asarray(pa[key][name]).dtype == \
                    np.asarray(pb[key][name]).dtype
                np.testing.assert_array_equal(pa[key][name], pb[key][name])


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_slab_roundtrip_bitwise(models, prompts, kv):
    """Engine A prefills a prompt into its cache and exports the slab;
    engine B imports it and serves the prompt as a hit with A's tokens;
    B's re-export is A's slab bitwise (scales included)."""
    _, tff = models
    long = np.concatenate([prompts[4], prompts[3]]).astype(np.int32)[:22]
    a = tff.make_serving_engine(kv_cache_dtype=kv, **ENGINE)
    b = tff.make_serving_engine(kv_cache_dtype=kv, **ENGINE)
    assert a.prefill_into_cache(long) == 5
    slab = a.export_prefix_slab(long)
    assert len(slab["payload"]) == 5 and slab["ns"] is None
    names = set(next(iter(slab["payload"][0].values())))
    assert names == ({"k", "v"} if kv == "native"
                     else {"k", "v", "k_scale", "v_scale"})
    assert b.import_prefix_slab(slab) == 5
    assert b.import_prefix_slab(slab) == 0, "cached chunks are skipped"
    _assert_slabs_equal(b.export_prefix_slab(long), slab)
    ra = a.run([long], MAX_NEW)[0]
    rb = b.run([long], MAX_NEW)[0]
    assert ra.prefix_tokens == rb.prefix_tokens == 20
    assert ra.tokens == rb.tokens
    st = b.stats()
    assert st["prefix_slab_imports"] == 1 and st["prefix_pages_imported"] == 5
    assert a.stats()["prefill_only_requests"] == 1


def test_jax_slab_imported_by_port(models, prompts):
    """A slab the JAX engine exports imports into the port, which serves
    the prompt as a hit with the JAX engine's tokens and re-exports the
    same bytes; a port slab imports into the JAX engine likewise."""
    long = np.concatenate([prompts[4], prompts[3]]).astype(np.int32)[:22]
    j_eng, eng = _engines(models)
    assert j_eng.prefill_into_cache(long) == 5
    j_slab = j_eng.export_prefix_slab(long)
    assert eng.import_prefix_slab(j_slab) == 5
    _assert_slabs_equal(eng.export_prefix_slab(long), j_slab)
    jr, tr = j_eng.run([long], MAX_NEW)[0], eng.run([long], MAX_NEW)[0]
    assert tr.prefix_tokens == jr.prefix_tokens == 20
    assert tr.tokens == jr.tokens
    j2, t2 = _engines(models)
    assert t2.prefill_into_cache(long) == 5
    assert j2.import_prefix_slab(t2.export_prefix_slab(long)) == 5
    assert j2.run([long], MAX_NEW)[0].tokens == jr.tokens


def test_partial_slabs_and_refusals(models, prompts):
    """A partial-prefix slab (start_page > 0) merges only after its
    predecessors; a bad start_page, a foreign page size and a pool of
    another dtype are refused; the manifest lists the cached path."""
    _, tff = models
    long = np.concatenate([prompts[4], prompts[3]]).astype(np.int32)[:22]
    a = tff.make_serving_engine(**ENGINE)
    a.prefill_into_cache(long)
    head = a.export_prefix_slab(long[:8])
    tail = a.export_prefix_slab(long, start_page=2)
    assert len(tail["payload"]) == 3 and tail["start_page"] == 2
    with pytest.raises(ValueError, match="start_page"):
        a.export_prefix_slab(long, start_page=5)
    b = tff.make_serving_engine(**ENGINE)
    assert b.import_prefix_slab(tail) == 0, "a gap before the slab"
    assert b.import_prefix_slab(head) == 2
    assert b.import_prefix_slab(tail) == 3
    assert b.stats()["partial_slab_imports"] == 1
    _assert_slabs_equal(b.export_prefix_slab(long), a.export_prefix_slab(
        long))
    (toks, ns), = b.cached_prefix_manifest()
    assert ns is None and np.array_equal(toks, long[:20])
    _assert_slabs_equal(b.export_prefix_path(toks, ns),
                        b.export_prefix_slab(long))
    c = tff.make_serving_engine(**dict(ENGINE, kv_page_size=8))
    with pytest.raises(ValueError, match="page_size"):
        c.import_prefix_slab(head)
    d = tff.make_serving_engine(kv_cache_dtype="int8", **ENGINE)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        d.import_prefix_slab(head)


# ---- warmup ------------------------------------------------------------------


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "draft"])
def test_warmup_counts(models, prompts, spec):
    """warmup() runs every prompt twice (JAX's request count), builds the
    decode-side programs (one decode chunk; or the draft's proposals and
    the verify pass), and serving the same prompts afterwards builds
    nothing and trips no sentinel; a key warmup never reached does."""
    jff, tff = models
    kw = dict(ENGINE, host_kv_pages=8)
    if spec:
        kw.update(speculate_k=2, draft_model=tff)
    eng = tff.make_serving_engine(**kw)
    tw = eng.warmup(prompts)
    if not spec:
        # JAX's without the host tier: its page-import warm-up compiles
        # programs this count does not depend on
        j_eng = jff.make_serving_engine(paged_attention_impl="einsum",
                                        **ENGINE)
        assert j_eng.warmup(prompts)["requests"] == tw["requests"]
        _same(j_eng.run(prompts, MAX_NEW), eng.run(prompts, MAX_NEW))
    assert tw["requests"] == 2 * len(prompts)
    keys = ([("draft_propose", 2), ("verify", 2)] if spec
            else [("decode", 8)])
    assert tw["programs"] == len(keys)
    assert tw["variants"] == sorted(keys, key=repr)
    built = eng.stats()["recompiles"]
    eng.run(prompts, MAX_NEW)
    st = eng.stats()
    assert st["recompiles"] == built and st["sanitizer_retraces"] == 0
    if spec:
        eng.speculate_k = 3     # keys warmup never reached
    eng.decode_chunk = 3
    eng.run(prompts[:1], 2)
    assert eng.stats()["sanitizer_retraces"] == len(keys)
