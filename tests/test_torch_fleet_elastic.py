"""The disaggregated and elastic fleet in the PyTorch port, against the JAX
package's router — the cases of tests/test_disagg.py, tests/test_seq_parallel.py
and tests/test_elastic_serve.py that drive a real fleet.

The small f32 Llama of tests/test_torch_router.py, built in both packages
with the JAX-initialised weights carried into the port; JAX's engines run
their einsum route, and JAX's single engine's greedy streams are the
reference. Held:

  * roles and the handoff: "prefill,decode,decode" — long prompts prefill
    on the prefill replica, move as page slabs and admit as hits on a
    decode replica; the tokens are JAX's, and driven one request at a time
    the ledgers (handoffs, fallbacks, slab exports / imports, pages
    imported) equal JAX's fleet's; a saturated prefill tier does not stall
    direct work;
  * the fallback: the prefill replica crashes (``crash(2)@replica:0``) and
    its work falls back cold on the decode replicas, which build no
    program past their warmup;
  * sequence-parallel prefill: shard slabs merged on a decode engine are
    bitwise the pages of one replica running the same shard schedule, and
    within f32 rounding of one cold prefill (2 and 3 shards), and a
    "prefill,prefill,decode" fleet with ``seq_parallel_shards=2`` serves
    JAX's tokens with JAX's ``seq_parallel_prefills``;
  * ``add_replica`` (warmed before its first dispatch, no program built
    after) and ``remove_replica`` (never-admitted work requeued, the
    retiree's prefix pages inherited bitwise, the evacuation summary equal
    to JAX's);
  * the preemption drills: ``preempt(800)@replica:0`` evacuates exactly
    once with no loss counted, and ``slow_evac`` starves a 150 ms deadline
    into a fence; an evacuation that outlasts the health timeout but meets
    its deadline is not fenced as a hang (the JAX router's sweep would);
    every stream is JAX's.
"""

import time

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
PS = 4
ARCH = dict(seq_len=16, hidden=64, layers=2, heads=4, kv_heads=2,
            vocab_size=VOCAB)
FLEET = dict(serve_slots=2, kv_page_size=PS, max_seq_len=64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
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
    monkeypatch.delenv("FF_FAULT", raising=False)
    j_faultinject.reset()
    t_faultinject.reset()


@pytest.fixture(scope="module")
def models():
    jff = JModel(JConfig(batch_size=2, mesh_shape={"data": 1}))
    _, logits = j_llama_lm(jff, 2, **ARCH)
    jff.compile(final_tensor=logits)
    tree = {op: {w: np.asarray(a) for w, a in ws.items()}
            for op, ws in jff.params.items()}
    tff = FFModel(FFConfig(batch_size=2), device="cpu")
    _, t_logits = llama_lm(tff, 2, **ARCH)
    tff.compile(final_tensor=t_logits)
    tff.params = params_from_jax(tree, "cpu", torch.float32, model=tff)
    return jff, tff


def _prompts(seed, lengths):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, VOCAB, (n,)).astype(np.int32) for n in lengths]


def _mixed_prompts(seed, n=8, sys_len=16):
    """Half share a sys_len-token system prompt, half are background."""
    rs = np.random.RandomState(seed)
    system = rs.randint(1, VOCAB, (sys_len,)).astype(np.int32)
    out = []
    for i in range(n):
        if i % 2 == 0:
            out.append(np.concatenate(
                [system, rs.randint(1, VOCAB, (3,)).astype(np.int32)]))
        else:
            out.append(rs.randint(
                1, VOCAB, (int(rs.randint(5, 12)),)).astype(np.int32))
    return out


def _jax_tokens(jff, prompts, max_new, **kw):
    eng = jff.make_serving_engine(paged_attention_impl="einsum",
                                  **dict(FLEET, **kw))
    return [list(r.tokens) for r in eng.run(prompts, max_new)]


def _arm(monkeypatch, spec):
    monkeypatch.setenv("FF_FAULT", spec)
    t_faultinject.reset()


def _prefix_pages(eng, prompt, n_pages):
    """Every pool plane of the prompt's first n cached pages, keyed
    (op, plane)."""
    path = eng.prefix_cache.match(prompt, n_pages)
    assert len(path) == n_pages, "prefix not fully cached"
    out = {}
    for op in eng.gen.attn_ops:
        pool = eng.pool[op.name]
        for plane in pool:
            out[(op.name, plane)] = torch.stack(
                [pool[plane][nd.page] for nd in path]).numpy()
    return out


def _slab_bitwise(a, b):
    assert len(a["payload"]) == len(b["payload"])
    for pa, pb in zip(a["payload"], b["payload"]):
        assert pa.keys() == pb.keys()
        for key in pa:
            for name in pa[key]:
                np.testing.assert_array_equal(pa[key][name], pb[key][name])


# ---- roles and the handoff ------------------------------------------------------


def test_dispatch_skips_saturated_prefill_tier(models):
    """A saturated prefill tier's queue head is skipped; direct work
    behind it still dispatches to the decode replica."""
    _, tff = models
    router = tff.make_serving_router(replicas=2, roles=["prefill", "decode"],
                                     start=False, **FLEET)
    try:
        for i in range(router._cap):
            router._outstanding[0][10_000 + i] = (None, None)
        a = router.submit(np.arange(1, 20, dtype=np.int32), 4)
        b = router.submit(np.arange(1, 4, dtype=np.int32), 4)
        with router._lock:
            router._dispatch_locked()
        assert a.state == "queued" and a.phase == "prefill"
        assert b.state == "dispatched" and b.replica == 1
        router._outstanding[0].clear()
    finally:
        router.close()


def test_role_split_tokens_and_ledger_equal_jax(models):
    """1 prefill + 2 decode replicas: long prompts hand off as slabs and
    every stream is JAX's; driven one request at a time, the handoff
    ledger equals JAX's fleet's; the prefill replica completes nothing
    routed."""
    jff, tff = models
    prompts = _mixed_prompts(25, n=8)
    want = _jax_tokens(jff, prompts, 6)
    ledgers = {}
    for name, ff, kw in (("jax", jff, {"paged_attention_impl": "einsum"}),
                         ("torch", tff, {})):
        router = ff.make_serving_router(
            replicas=3, roles=["prefill", "decode", "decode"],
            start=False, **FLEET, **kw)
        try:
            got = []
            for p in prompts:
                got += router.run([p], max_new_tokens=6, timeout=300)
            assert [r.state for r in got] == ["done"] * len(prompts)
            assert [list(r.tokens) for r in got] == want, name
            st = router.stats()
            ledgers[name] = {
                "handoffs": st["handoffs"],
                "handoff_fallbacks": st["handoff_fallbacks"],
                "handoff_flags": [r.handoff for r in got],
                "replicas": [r.replica for r in got],
                **{k: st["fleet"][k] for k in (
                    "prefix_slab_exports", "prefix_slab_imports",
                    "prefix_pages_imported", "prefill_only_requests",
                    "prefix_hits", "completed")}}
            assert st["handoffs"] >= 1
            assert router.engines[0].stats()["completed"] == 0
            assert router.engines[0].stats()["prefill_only_requests"] >= 1
            assert st["fleet"]["per_role"]["decode"]["replicas"] == 2
        finally:
            router.close()
    assert ledgers["torch"] == ledgers["jax"]


def test_prefill_replica_crash_cold_path_fallback(models, monkeypatch):
    """The prefill tier dies mid-traffic: its work falls back cold on the
    decode replicas (JAX's tokens), which build nothing past warmup."""
    jff, tff = models
    prompts = _mixed_prompts(27, n=10)
    want = _jax_tokens(jff, prompts, 6, decode_chunk=2)
    router = tff.make_serving_router(
        replicas=3, roles=["prefill", "decode", "decode"], decode_chunk=2,
        start=False, **FLEET)
    try:
        router.warmup(prompts[:4], max_new_tokens=2)
        warm = [e.recompile_count for e in router.engines]
        _arm(monkeypatch, "crash(2)@replica:0")
        reqs = router.run(prompts, max_new_tokens=6, timeout=300)
        assert [r.state for r in reqs] == ["done"] * len(prompts)
        assert [list(r.tokens) for r in reqs] == want
        st = router.stats()
        assert st["fenced"] == 1 and st["alive"] == 2
        for r in (1, 2):
            assert router.engines[r].recompile_count == warm[r]
            assert router.engines[r].stats()["sanitizer_retraces"] == 0
        assert st["completed"] == len(prompts)
        assert all(r.losses <= 1 for r in reqs)
    finally:
        router.close()


# ---- sequence-parallel prefill ------------------------------------------------


def _bounds(last, shards):
    base, rem = divmod(last, shards)
    out, s = [], 0
    for i in range(shards):
        e = s + base + (1 if i < rem else 0)
        out.append((s, e))
        s = e
    return out


def _schedule_pages(tff, prompt, shards):
    """One replica running the shard schedule itself: each shard's
    prefix prefilled in turn, so shard i computes its pages as a prefix
    hit over shards < i — the arithmetic the sharded fleet spreads over
    replicas."""
    last = prompt.size // PS
    eng = tff.make_serving_engine(**FLEET)
    for _, e_pg in _bounds(last, shards):
        assert eng.prefill_into_cache(prompt[:e_pg * PS]) == e_pg
    return _prefix_pages(eng, prompt, last)


def _assert_pages_close(got, want):
    """Within f32 rounding of the cold prefill of the whole prompt: a
    shard's prefill runs at another bucket (and, past shard 0, as a prefix
    hit through the grouped einsum), and torch's CPU products sum in an
    order that depends on those shapes, so its pages may sit an ulp from
    the whole prompt's (JAX's CPU paths coincide)."""
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-6, err_msg=str(key))


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_merge_bitwise_single_replica(models, shards):
    """The sequence-parallel protocol by hand: one engine a shard, the
    predecessors' slabs imported first, partial exports merged into a
    fresh engine — bitwise the pages of one replica running the same
    shard schedule (the handoff moves pages losslessly), and within f32
    rounding of a single cold prefill."""
    _, tff = models
    prompt = _prompts(41, [24])[0]          # 6 full pages
    ref = tff.make_serving_engine(**FLEET)
    assert ref.prefill_into_cache(prompt) == 6
    cold = _prefix_pages(ref, prompt, 6)
    want = _schedule_pages(tff, prompt, shards)
    slabs = []
    for s_pg, e_pg in _bounds(6, shards):
        eng = tff.make_serving_engine(**FLEET)
        for sl in slabs:
            assert eng.import_prefix_slab(sl) > 0
        assert eng.prefill_into_cache(prompt[:e_pg * PS]) == e_pg
        sl = eng.export_prefix_slab(prompt[:e_pg * PS], start_page=s_pg)
        assert sl is not None and len(sl["payload"]) == e_pg - s_pg
        slabs.append(sl)
    dec = tff.make_serving_engine(**FLEET)
    for sl in slabs:
        assert dec.import_prefix_slab(sl) > 0
    got = _prefix_pages(dec, prompt, 6)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))
    _assert_pages_close(got, cold)
    assert dec.stats()["partial_slab_imports"] == shards - 1


def test_router_seq_parallel_equals_jax(models):
    """"prefill,prefill,decode" with seq_parallel_shards=2: JAX's tokens;
    the two long prompts shard (JAX's seq_parallel_prefills), the short
    one takes the plain handoff; the decode replica's merged pages are
    bitwise those of one replica running the same shard schedule."""
    jff, tff = models
    prompts = _prompts(59, [24, 26, 7])
    want = _jax_tokens(jff, prompts, 5)
    fleets = {}
    for name, ff, kw in (("jax", jff, {"paged_attention_impl": "einsum"}),
                         ("torch", tff, {})):
        router = ff.make_serving_router(
            replicas=3, roles="prefill,prefill,decode",
            seq_parallel_shards=2, handoff_min_pages=2, **FLEET, **kw)
        try:
            reqs = router.run(prompts, max_new_tokens=5, timeout=300)
            assert [r.state for r in reqs] == ["done"] * 3
            assert [list(r.tokens) for r in reqs] == want, name
            fleets[name] = router.stats()["fleet"]
            if name == "torch":
                want_pages = _schedule_pages(tff, prompts[0], 2)
                got = _prefix_pages(router.engines[2], prompts[0], 6)
                for key in want_pages:
                    np.testing.assert_array_equal(got[key], want_pages[key])
        finally:
            router.close()
    for name in ("jax", "torch"):
        assert fleets[name]["seq_parallel_prefills"] == 2, name
        assert fleets[name]["partial_slab_imports"] >= 2, name
        assert fleets[name]["prefill_chunks_interleaved"] == 0, name


# ---- elastic membership and preemption ---------------------------------------


def test_scale_out_warm_and_token_identical(models):
    """add_replica() mid-flood: the newcomer is warmed before admission
    (nothing built after), takes real work, every stream is JAX's."""
    jff, tff = models
    prompts = _prompts(31, [5, 9, 3, 12, 7, 6, 11, 4])
    more_p = _prompts(32, [6, 8, 5, 9])
    want = _jax_tokens(jff, prompts, 5)
    want_more = _jax_tokens(jff, more_p, 4)
    router = tff.make_serving_router(replicas=1, start=False, **FLEET)
    try:
        router.warmup(_prompts(6, [5, 9]), max_new_tokens=2)
        reqs = [router.submit(p, max_new_tokens=5) for p in prompts]
        router.start()
        r_new = router.add_replica()
        assert r_new == 1
        built = router.engines[r_new].recompile_count
        assert built > 0, "the newcomer was not warmed"
        router.wait(reqs, timeout=300)
        assert [list(r.tokens) for r in reqs] == want
        st = router.stats()
        assert st["scale_outs"] == 1 and st["alive"] == 2
        assert router.health()["replicas"] == 2
        more = router.run(more_p, max_new_tokens=4, timeout=300)
        assert [list(r.tokens) for r in more] == want_more
        assert any(r.replica == r_new for r in reqs + more)
        assert router.engines[r_new].recompile_count == built
    finally:
        router.close()


def test_scale_in_requeues_and_survivor_inherits(models):
    """remove_replica() racing fresh submissions strands nothing; the
    retiree's prefix pages land bitwise on the survivor and serve warm
    hits; the evacuation summary equals JAX's for the same drive."""
    jff, tff = models
    rs = np.random.RandomState(13)
    system = rs.randint(1, VOCAB, (8,)).astype(np.int32)
    shared = [np.concatenate([system,
                              rs.randint(1, VOCAB, (n,)).astype(np.int32)])
              for n in (2, 5, 3)]
    prompts = _prompts(41, [5, 9, 3, 12, 7, 6])
    want = _jax_tokens(jff, prompts, 5)
    want_more = _jax_tokens(jff, shared[1:], 4)
    summaries = {}
    for name, ff, kw in (("jax", jff, {"paged_attention_impl": "einsum"}),
                         ("torch", tff, {})):
        router = ff.make_serving_router(replicas=2, **FLEET, **kw)
        try:
            home = router.run([shared[0]], max_new_tokens=4,
                              timeout=300)[0].replica
            survivor = 1 - home
            snap = router.remove_replica(home)
            summaries[name] = {k: snap[k] for k in
                               ("fenced", "slabs", "pages", "paths")}
            if name == "jax":
                continue
            ref_slab = None
            reqs = [router.submit(p, max_new_tokens=5) for p in prompts]
            router.wait(reqs, timeout=300)
            assert [list(r.tokens) for r in reqs] == want
            assert all(r.replica == survivor for r in reqs)
            st = router.stats()
            assert st["scale_ins"] == 1 and st["alive"] == 1
            assert st["fenced"] == 0
            assert st["replicas"] == 1 and st["retired"] == 1
            got = router.engines[survivor].export_prefix_slab(system)
            ref_slab = router.engines[home].export_prefix_slab(system)
            assert got is not None and ref_slab is not None
            _slab_bitwise(got, ref_slab)
            h0 = router.engines[survivor].stats()["prefix_hits"]
            more = router.run(shared[1:], max_new_tokens=4, timeout=300)
            assert [list(r.tokens) for r in more] == want_more
            assert router.engines[survivor].stats()["prefix_hits"] > h0
        finally:
            router.close()
    assert summaries["torch"] == summaries["jax"]
    assert summaries["torch"]["pages"] >= 2


def test_preempt_exactly_once_and_prefix_evacuation(models, monkeypatch):
    """preempt(800)@replica:0 mid-flood: the replica evacuates within the
    deadline and retires without a fence; every request completes once
    with JAX's tokens; the shared prefix then serves warm on the
    survivor."""
    jff, tff = models
    rs = np.random.RandomState(17)
    system = rs.randint(1, VOCAB, (8,)).astype(np.int32)
    shared = [np.concatenate([system,
                              rs.randint(1, VOCAB, (n,)).astype(np.int32)])
              for n in (2, 5, 3, 4)]
    prompts = shared + _prompts(61, [5, 9, 12, 7, 6])
    want = _jax_tokens(jff, prompts, 8)
    router = tff.make_serving_router(replicas=2, decode_chunk=2,
                                     start=False, **FLEET)
    try:
        router.warmup(_prompts(6, [5, 9]), max_new_tokens=2)
        base = [e.stats()["completed"] for e in router.engines]
        _arm(monkeypatch, "preempt(800)@replica:0")
        reqs = router.run(prompts, max_new_tokens=8, timeout=300)
        assert [list(r.tokens) for r in reqs] == want
        st = router.stats()
        assert st["preempts"] == 1 and st["fenced"] == 0
        assert st["evac_deadline_misses"] == 0
        assert st["completed"] == len(prompts)
        done = [e.stats()["completed"] - b
                for e, b in zip(router.engines, base)]
        assert sum(done) == len(prompts)
        assert st["per_replica"][0]["retired"]
        assert router.health()["replicas"] == 1
        if st["evacuated_slabs"]:
            assert st["evacuated_pages"] > 0 and st["evacuation_bytes"] > 0
        h0 = router.engines[1].stats()["prefix_hits"]
        more = router.run([shared[0]], max_new_tokens=4, timeout=300)
        assert more[0].state == "done" and more[0].replica == 1
        assert router.engines[1].stats()["prefix_hits"] > h0
        assert all(r.losses == 0 for r in reqs)
    finally:
        router.close()


def test_preempt_deadline_starved_degrades_to_fence(models, monkeypatch):
    """slow_evac stalls the first slab export past a 150 ms deadline: the
    replica is fenced (a loss) and its work resubmits cold; every stream
    is JAX's."""
    jff, tff = models
    prompts = _prompts(71, [5, 9, 3, 12, 7, 6])
    want = _jax_tokens(jff, prompts, 8)
    router = tff.make_serving_router(replicas=2, decode_chunk=2,
                                     start=False, **FLEET)
    try:
        router.warmup(_prompts(6, [5, 9]), max_new_tokens=2)
        _arm(monkeypatch,
             "preempt(150)@replica:0,slow_evac(400)@evacuate:1")
        t0 = time.monotonic()
        reqs = router.run(prompts, max_new_tokens=8, timeout=300)
        assert [list(r.tokens) for r in reqs] == want
        st = router.stats()
        assert st["preempts"] == 1 and st["evac_deadline_misses"] == 1
        assert st["fenced"] == 1
        assert st["completed"] == len(prompts)
        assert all(1 <= r.attempts <= 2 for r in reqs)
        assert st["per_replica"][0]["retired"]
        assert st["preempt_margin_s"] < 0
        assert time.monotonic() - t0 < 60
    finally:
        router.close()


def test_slow_evacuation_within_deadline_is_not_a_hang(models, monkeypatch):
    """slow_evac(1200) stalls the preempted replica's first slab export
    past a 0.5 s health timeout, inside its 5 s deadline: the heartbeat
    sweep leaves a replica racing its deadline alone — the evacuation
    completes, nothing is fenced, every stream is JAX's."""
    jff, tff = models
    rs = np.random.RandomState(23)
    system = rs.randint(1, VOCAB, (8,)).astype(np.int32)
    shared = [np.concatenate([system,
                              rs.randint(1, VOCAB, (n,)).astype(np.int32)])
              for n in (2, 5)]
    prompts = _prompts(73, [5, 9, 3, 12, 7, 6])
    want = _jax_tokens(jff, prompts, 8)
    router = tff.make_serving_router(replicas=2, decode_chunk=2,
                                     health_timeout_s=0.5, start=False,
                                     **FLEET)
    try:
        router.warmup(shared, max_new_tokens=2)     # prefixes to evacuate
        _arm(monkeypatch,
             "preempt(5000)@replica:0,slow_evac(1200)@evacuate:1")
        reqs = [router.submit(p, max_new_tokens=8) for p in prompts]
        router.start()
        router.wait(reqs, timeout=300)
        assert [list(r.tokens) for r in reqs] == want
        st = router.stats()
        assert st["preempts"] == 1 and st["evac_deadline_misses"] == 0
        assert st["fenced"] == 0, st["per_replica"]
        assert st["evacuated_slabs"] >= 1
        assert st["per_replica"][0]["retired"]
    finally:
        router.close()
