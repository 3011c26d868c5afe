"""The serving fleet's router (``runtime/router.py`` ``ServingRouter``) in the
PyTorch port, against the JAX package's router — the cases of
tests/test_router.py.

The small f32 Llama of tests/test_torch_serving.py (hidden 64, 2 layers, 4
heads over 2 kv heads, vocab 89) is built in both packages and the
JAX-initialised weights are carried into the port (``params_from_jax``);
JAX's engines run their einsum route. The reference for every greedy
stream is JAX's single engine on the same prompts, and the no-fault fleet
is also held to JAX's fleet (tokens and ledger). Held:

  * the router moves work, never changes it: the fleet's greedy tokens are
    JAX's single engine's and JAX's fleet's, and both replicas serve;
  * failover is exactly once: ``crash@replica`` and ``hang@replica`` fence
    the replica, its work resubmits once (attempts <= 2), every stream
    stays JAX's, nothing is lost or duplicated; the heartbeats start with
    the drivers, so a fleet idle past its health timeout before it starts
    fences nobody (the JAX router starts them at construction);
  * deadlines: expired while queued never dispatches; expired in flight on
    a fenced replica (``slow@serve``) is not resubmitted;
  * shedding rejects fast and leaves accepted work JAX's; ``drain()``;
  * prefix affinity concentrates shared-prefix traffic on one replica;
  * ``stats()`` / ``health()`` / per-replica / fleet-rollup key sets equal
    JAX's, and the counters JAX's tests pin are equal;
  * ``FFModel.serve_fleet``.

Replicas are built with ``start=False`` and pumped where an order must be
deterministic; every wait is bounded.
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
ARCH = dict(seq_len=16, hidden=64, layers=2, heads=4, kv_heads=2,
            vocab_size=VOCAB)
FLEET = dict(serve_slots=2, kv_page_size=4, max_seq_len=64)


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


def _jax_tokens(jff, prompts, max_new, **kw):
    """JAX's single engine (einsum route): the reference streams."""
    eng = jff.make_serving_engine(paged_attention_impl="einsum",
                                  **dict(FLEET, **kw))
    return [list(r.tokens) for r in eng.run(prompts, max_new)]


def _arm(monkeypatch, spec):
    monkeypatch.setenv("FF_FAULT", spec)
    t_faultinject.reset()


def _keys(d):
    return set(d)


# ---- host-side semantics ------------------------------------------------------


def test_router_validation_and_rejection_is_fast(models):
    """Malformed submits raise synchronously; a full queue rejects 20
    requests in well under 0.1 s; the constructor guards and the config
    knob are JAX's."""
    _, tff = models
    router = tff.make_serving_router(replicas=1, serve_slots=2,
                                     kv_page_size=4, max_seq_len=32,
                                     max_queue=2, start=False)
    try:
        with pytest.raises(ValueError, match="empty"):
            router.submit(np.zeros((0,), np.int32), 4)
        with pytest.raises(ValueError, match="max_new_tokens"):
            router.submit(np.arange(1, 5, dtype=np.int32), 0)
        with pytest.raises(ValueError, match="max_seq_len"):
            router.submit(np.arange(1, 30, dtype=np.int32), 16)
        with pytest.raises(ValueError, match="deadline_s"):
            router.submit(np.arange(1, 5, dtype=np.int32), 4,
                          deadline_s=-1.0)
        a = router.submit(np.arange(1, 5, dtype=np.int32), 4)
        b = router.submit(np.arange(1, 6, dtype=np.int32), 4)
        t0 = time.perf_counter()
        shed = [router.submit(np.arange(1, 5, dtype=np.int32), 4)
                for _ in range(20)]
        dt = time.perf_counter() - t0
        assert [r.state for r in shed] == ["rejected"] * 20
        assert all(r.attempts == 0 and r.t_done for r in shed)
        assert dt < 0.1, f"20 rejections took {dt:.3f}s"
        assert a.state == "queued" and b.state == "queued"
        st = router.stats()
        assert st["rejected"] == 20 and st["queued"] == 2
        assert st["submitted"] == 22 and st["max_queue"] == 2
    finally:
        router.close()
    with pytest.raises(ValueError, match="replicas"):
        tff.make_serving_router(replicas=0, start=False)
    with pytest.raises(ValueError, match="max_queue"):
        tff.make_serving_router(replicas=1, max_queue=-1, start=False)
    with pytest.raises(ValueError, match="health_timeout_s"):
        tff.make_serving_router(replicas=1, health_timeout_s=0.0,
                                start=False)
    with pytest.raises(ValueError, match="serve_max_queue"):
        FFConfig(serve_max_queue=-1)
    with pytest.raises(ValueError, match="serve_replica_roles"):
        FFConfig(serve_replica_roles="prefill,bogus")
    with pytest.raises(ValueError, match="seq_parallel_shards"):
        FFConfig(seq_parallel_shards=1)
    with pytest.raises(ValueError, match="preempt_deadline_s"):
        FFConfig(preempt_deadline_s=0.0)


def test_deadline_expired_while_queued_never_dispatches(models):
    """A request whose deadline passes in the router queue retires as
    "timeout" with zero dispatch and zero programs built."""
    _, tff = models
    router = tff.make_serving_router(replicas=2, serve_slots=2,
                                     kv_page_size=4, max_seq_len=32,
                                     start=False)
    try:
        req = router.submit(np.arange(1, 6, dtype=np.int32), 4,
                            deadline_s=0.0)
        time.sleep(0.005)
        router.start()
        router.wait([req], timeout=30)
        assert req.state == "timeout" and req.attempts == 0
        assert "router queue" in req.error
        st = router.stats()
        assert st["timeouts"] == 1 and st["dispatched"] == 0
        assert all(e.recompile_count == 0 for e in router.engines)
        assert all(e.stats()["requests"] == 0 for e in router.engines)
        assert router.health()["status"] == "idle"
    finally:
        router.close()


def test_heartbeats_start_with_the_drivers(models):
    """A fleet built, then left idle past its health timeout (a long
    warmup does that) before its drivers start: no replica reads as hung
    at the first sweep, every request completes with no fence."""
    jff, tff = models
    prompts = _prompts(19, [5, 9, 3, 12])
    want = _jax_tokens(jff, prompts, 4)
    router = tff.make_serving_router(replicas=2, health_timeout_s=0.5,
                                     start=False, **FLEET)
    try:
        router.warmup(prompts[:1], max_new_tokens=2)
        time.sleep(0.6)
        # queued before the drivers start: the first driver's first tick
        # dispatches to both replicas before the second has ticked
        reqs = [router.submit(p, 4) for p in prompts]
        router.start()
        router.wait(reqs, timeout=300)
        assert [list(r.tokens) for r in reqs] == want
        assert router.stats()["fenced"] == 0
    finally:
        router.close()


def test_stats_and_health_keys_equal_jax(models):
    """stats(), its per-replica rows, its fleet rollup and per-role rows,
    and health() carry exactly JAX's keys (one dashboard serves both)."""
    jff, tff = models
    j = jff.make_serving_router(replicas=2, roles="prefill,decode",
                                paged_attention_impl="einsum",
                                start=False, **FLEET)
    t = tff.make_serving_router(replicas=2, roles="prefill,decode",
                                start=False, **FLEET)
    try:
        js, ts = j.stats(), t.stats()
        assert _keys(ts) == _keys(js)
        assert _keys(ts["per_replica"][0]) == _keys(js["per_replica"][0])
        assert _keys(ts["fleet"]) == _keys(js["fleet"])
        assert _keys(ts["fleet"]["per_role"]) == \
            _keys(js["fleet"]["per_role"])
        assert _keys(ts["fleet"]["per_role"]["decode"]) == \
            _keys(js["fleet"]["per_role"]["decode"])
        assert _keys(t.health()) == _keys(j.health())
        assert t.health() == j.health()
        assert ts["roles"] == js["roles"] == ["prefill", "decode"]
        # the engines carry the fleet identity
        assert [e._tm_labels for e in t.engines] == \
            [e._tm_labels for e in j.engines]
    finally:
        j.close()
        t.close()


# ---- fleet semantics ----------------------------------------------------------


def test_fleet_tokens_equal_jax_and_both_replicas_serve(models):
    """More requests than one replica holds: every stream is JAX's single
    engine's and JAX's fleet's, both port replicas serve, and the ledgers
    agree."""
    jff, tff = models
    prompts = _prompts(3, [5, 9, 3, 12, 7, 6, 17, 2, 11, 4])
    want = _jax_tokens(jff, prompts, 6)
    j = jff.make_serving_router(replicas=2, paged_attention_impl="einsum",
                                **FLEET)
    try:
        j_reqs = j.run(prompts, max_new_tokens=6, timeout=300)
        js = j.stats()
    finally:
        j.close()
    t = tff.make_serving_router(replicas=2, **FLEET)
    try:
        reqs = t.run(prompts, max_new_tokens=6, timeout=300)
        assert [r.state for r in reqs] == ["done"] * len(prompts)
        assert [list(r.tokens) for r in reqs] == want
        assert [list(r.tokens) for r in j_reqs] == want
        np.testing.assert_array_equal(
            reqs[0].output, np.concatenate([prompts[0],
                                            np.asarray(want[0], np.int32)]))
        st = t.stats()
        for k in ("completed", "submitted", "dispatched", "fenced",
                  "resubmitted", "rejected", "timeouts", "failed"):
            assert st[k] == js[k], k
        assert st["completed"] == len(prompts)
        served = [e.stats()["completed"] for e in t.engines]
        assert all(c > 0 for c in served), served
        assert sum(served) == len(prompts)
        assert 0 < st["ttft_p50_ms"] <= st["ttft_p99_ms"]
        assert st["fleet"]["completed"] == len(prompts)
    finally:
        t.close()


def test_crash_failover_exactly_once_equals_jax(models, monkeypatch):
    """crash(3)@replica:0 mid-flight: replica 0 is fenced, its work
    resubmits to the survivor exactly once, every request completes with
    JAX's tokens, none is duplicated."""
    jff, tff = models
    prompts = _prompts(5, [5, 9, 3, 12, 7, 6])
    want = _jax_tokens(jff, prompts, 12)
    router = tff.make_serving_router(replicas=2, decode_chunk=2,
                                     start=False, **FLEET)
    try:
        router.warmup(_prompts(6, [5, 9]), max_new_tokens=2)
        warm_done = router.engines[1].stats()["completed"]
        _arm(monkeypatch, "crash(3)@replica:0")
        reqs = router.run(prompts, max_new_tokens=12, timeout=300)
        assert [r.state for r in reqs] == ["done"] * len(prompts)
        assert [list(r.tokens) for r in reqs] == want
        st = router.stats()
        assert st["fenced"] == 1 and st["resubmitted"] >= 1
        assert st["completed"] == len(prompts)
        assert all(1 <= r.attempts <= 2 for r in reqs)
        assert any(r.attempts == 2 for r in reqs)
        assert router.engines[1].stats()["completed"] - warm_done == sum(
            1 for r in reqs if r.replica == 1)
        assert router.health()["alive"] == 1
        assert "ReplicaCrash" in st["per_replica"][0]["fence_reason"]
    finally:
        router.close()


def test_requeue_after_crash_with_prefix_and_spec(models, monkeypatch):
    """A request resubmitted mid-stream gives JAX's uninterrupted tokens
    with the prefix cache and speculative decoding (the target as its own
    draft) live on both replicas."""
    jff, tff = models
    rs = np.random.RandomState(11)
    system = rs.randint(1, VOCAB, (8,)).astype(np.int32)
    prompts = [np.concatenate([system,
                               rs.randint(1, VOCAB, (n,)).astype(np.int32)])
               for n in (2, 6, 4, 3, 5)]
    want = _jax_tokens(jff, prompts, 10, decode_chunk=2)
    router = tff.make_serving_router(replicas=2, decode_chunk=2,
                                     draft_model=tff, speculate_k=2,
                                     start=False, **FLEET)
    try:
        router.warmup(prompts[:2], max_new_tokens=2)
        _arm(monkeypatch, "crash(3)@replica:0")
        reqs = router.run(prompts, max_new_tokens=10, timeout=300)
        assert [r.state for r in reqs] == ["done"] * len(prompts)
        st = router.stats()
        assert st["fenced"] == 1 and st["resubmitted"] >= 1
        assert any(r.attempts == 2 for r in reqs)
        assert [list(r.tokens) for r in reqs] == want
        sst = router.engines[1].stats()
        assert sst["prefix_hits"] > 0 and sst["spec_proposed"] > 0
    finally:
        router.close()


def test_hang_fenced_and_survivor_completes(models, monkeypatch):
    """hang@replica:1: the wedged driver stops heartbeating, the sweep
    fences it within health_timeout_s, the survivor serves JAX's tokens;
    the fence frees nothing of the hung replica's engine."""
    jff, tff = models
    prompts = _prompts(7, [5, 9, 3, 12])
    want = _jax_tokens(jff, prompts, 10)
    router = tff.make_serving_router(replicas=2, decode_chunk=2,
                                     prefix_cache=False,
                                     health_timeout_s=1.0, start=False,
                                     **FLEET)
    try:
        router.warmup(_prompts(8, [6, 10]), max_new_tokens=2)
        _arm(monkeypatch, "hang@replica:1")
        t0 = time.monotonic()
        reqs = router.run(prompts, max_new_tokens=10, timeout=300)
        assert [r.state for r in reqs] == ["done"] * len(prompts)
        assert [list(r.tokens) for r in reqs] == want
        st = router.stats()
        assert st["fenced"] == 1
        assert "hang" in st["per_replica"][1]["fence_reason"]
        assert time.monotonic() - t0 < 60
        hung = router.engines[1]
        assert hung.pool is not None and hung._programs
    finally:
        router.close()


def test_slow_replica_expired_inflight_not_resubmitted(models, monkeypatch):
    """slow(400)@serve:1 stalls replica 0's first admission past a 150 ms
    deadline; when replica 0 then crashes, the expired in-flight request
    retires "timeout" without resubmission, the other completes with
    JAX's tokens."""
    jff, tff = models
    prompts = _prompts(9, [5, 9])
    want = _jax_tokens(jff, prompts[1:], 12)
    router = tff.make_serving_router(replicas=2, decode_chunk=2,
                                     prefix_cache=False, start=False,
                                     **FLEET)
    try:
        router.warmup(_prompts(10, [6, 10]), max_new_tokens=2)
        _arm(monkeypatch, "slow(400)@serve:1,crash(3)@replica:0")
        a = router.submit(prompts[0], 12, deadline_s=0.15)
        router.start()
        t0 = time.monotonic()
        while a.attempts == 0 and time.monotonic() - t0 < 60:
            time.sleep(0.002)
        assert a.replica == 0
        time.sleep(0.1)
        b = router.submit(prompts[1], 12)
        router.wait([a, b], timeout=300)
        assert a.state == "timeout" and a.attempts == 1
        assert "fenced replica" in a.error
        assert b.state == "done" and [list(b.tokens)] == want
        st = router.stats()
        assert st["fenced"] == 1 and st["resubmitted"] == 0
        assert st["timeouts"] == 1
    finally:
        router.close()


def test_prefix_affinity_concentrates_shared_prompts(models):
    """After the first shared-prefix request homes, the rest follow it:
    prefix hits concentrate on one engine, tokens are JAX's."""
    jff, tff = models
    rs = np.random.RandomState(13)
    system = rs.randint(1, VOCAB, (8,)).astype(np.int32)
    shared = [np.concatenate([system,
                              rs.randint(1, VOCAB, (n,)).astype(np.int32)])
              for n in (2, 5, 3, 4)]
    want = _jax_tokens(jff, shared, 4)
    router = tff.make_serving_router(replicas=2, **FLEET)
    try:
        first = router.run([shared[0]], max_new_tokens=4, timeout=300)[0]
        home = first.replica
        reqs = router.run(shared[1:], max_new_tokens=4, timeout=300)
        assert all(r.state == "done" for r in reqs)
        assert all(r.replica == home for r in reqs)
        hits = [e.stats()["prefix_hits"] for e in router.engines]
        assert hits[home] == len(shared) - 1 and hits[1 - home] == 0
        assert [list(r.tokens) for r in [first] + reqs] == want
        assert router.stats()["affinity_keys"] >= 1
    finally:
        router.close()


def test_shedding_accepted_work_unaffected_and_fleet_drains(models):
    """A bounded queue sheds without touching accepted work (JAX's
    tokens); drain() settles the fleet and drains every engine."""
    jff, tff = models
    prompts = _prompts(15, [5, 9, 3, 12, 7, 6, 4, 8])
    want = _jax_tokens(jff, prompts[:3], 5)
    router = tff.make_serving_router(replicas=1, max_queue=3, start=False,
                                     **FLEET)
    try:
        reqs = [router.submit(p, max_new_tokens=5) for p in prompts]
        accepted = [r for r in reqs if r.state == "queued"]
        shed = [r for r in reqs if r.state == "rejected"]
        assert len(accepted) == 3 and len(shed) == len(prompts) - 3
        snap = router.drain()
        assert snap["drained"] and snap["rejected"] == len(shed)
        assert [r.state for r in accepted] == ["done"] * 3
        assert [list(r.tokens) for r in accepted] == want
        assert router.health()["status"] == "drained"
        assert router.engines[0].health()["status"] == "drained"
        with pytest.raises(RuntimeError, match="draining"):
            router.submit(prompts[0], 4)
    finally:
        router.close()


def test_serve_fleet_api(models):
    """FFModel.serve_fleet returns outputs aligned with the prompts (JAX's
    tokens) and the fleet ledger, as JAX's does."""
    jff, tff = models
    prompts = _prompts(17, [5, 9, 3, 12])
    outs, st = tff.serve_fleet(prompts, max_new_tokens=5, replicas=2,
                               **FLEET)
    j_outs, jst = jff.serve_fleet(prompts, max_new_tokens=5, replicas=2,
                                  paged_attention_impl="einsum", **FLEET)
    assert st["completed"] == jst["completed"] == len(prompts)
    assert st["alive"] == jst["alive"] == 2
    for out, j_out in zip(outs, j_outs):
        np.testing.assert_array_equal(out, np.asarray(j_out))
