"""The runtime plane's named locks and sanitizer in the PyTorch port
(``runtime/locks.py``) — the runtime half of tests/test_ffsan.py, held
against the port, and the rank table held to the JAX package's.

  * order-asserting proxies: an inversion is reported with both stacks,
    pairs dedupe but count, reentrant re-acquisition is legal, strict mode
    raises and leaves the held stack consistent, a condition's wait keeps
    the held stack exact; off mode hands out the raw primitives; an
    undeclared name is refused;
  * the retrace sentinel over the engine's program dict: a miss before
    arming and inside ``suspended()`` is free, a new key after ``arm()``
    is recorded (the port records in every mode — a program built on the
    card is a capture — where JAX's jit-cache watch passes through when
    off), strict raises; on a real engine, serving after ``warmup()``
    builds nothing and a new decode-chunk key is one retrace, raised under
    ``sanitize="strict"``;
  * ``lock_graph_snapshot()``'s shape equals JAX's; the engine, the
    prefix cache's condition, the adapter pool and the router make their
    locks through the factories.
"""

import json
import threading

import numpy as np
import pytest
import torch

from flexflow_tpu.runtime import locks as j_locks
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.models import llama_lm
from flexflow_tpu_torch.runtime import locks
from flexflow_tpu_torch.runtime.locks import (LOCK_RANKS, LockOrderViolation,
                                              RetraceSentinel,
                                              RetraceViolation)

VOCAB = 61
ENGINE = dict(serve_slots=2, kv_page_size=4, max_seq_len=32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def san():
    prev = locks.set_mode("on")
    locks.reset()
    yield locks
    locks.set_mode(prev)
    locks.reset()


@pytest.fixture
def strict():
    prev = locks.set_mode("strict")
    locks.reset()
    yield locks
    locks.set_mode(prev)
    locks.reset()


@pytest.fixture(scope="module")
def tff():
    torch.manual_seed(0)
    ff = FFModel(FFConfig(batch_size=2), device="cpu")
    _, logits = llama_lm(ff, 2, seq_len=16, hidden=32, layers=1, heads=2,
                         kv_heads=2, vocab_size=VOCAB)
    ff.compile(final_tensor=logits)
    return ff


def test_rank_table_equals_jax():
    assert LOCK_RANKS == j_locks.LOCK_RANKS
    assert list(LOCK_RANKS) == list(j_locks.LOCK_RANKS)


def test_proxy_detects_inversion_with_both_stacks(san):
    reg = locks.make_lock("telemetry-registry")
    eng = locks.make_rlock("engine")
    with eng:
        with reg:            # increasing rank: legal
            pass
    assert locks.violations() == []
    with reg:
        with eng:            # engine(20) under telemetry-registry(70)
            pass
    [v] = locks.violations()
    assert (v["outer"], v["inner"]) == ("telemetry-registry", "engine")
    assert "acquire" in v["outer_stack"] and v["inner_stack"]
    assert v["thread"] == threading.current_thread().name


def test_proxy_dedups_pairs_but_counts(san):
    reg = locks.make_lock("telemetry-registry")
    eng = locks.make_rlock("engine")
    for _ in range(3):
        with reg:
            with eng:
                pass
    assert len(locks.violations()) == 1
    snap = locks.lock_graph_snapshot()
    assert snap["violation_pairs"] == {"telemetry-registry->engine": 3}


def test_reentrant_and_same_object_always_legal(san):
    eng = locks.make_rlock("engine")
    with eng:
        with eng:
            pass
    assert locks.violations() == []


def test_two_engine_locks_may_not_nest(san):
    """Two different objects at one rank: the A->B / B->A fleet
    deadlock the hierarchy exists to prevent."""
    a, b = locks.make_rlock("engine"), locks.make_rlock("engine")
    with a:
        with b:
            pass
    [v] = locks.violations()
    assert v["outer"] == v["inner"] == "engine"


def test_strict_mode_raises(strict):
    reg = locks.make_lock("telemetry-registry")
    eng = locks.make_rlock("engine")
    with pytest.raises(LockOrderViolation, match="engine"):
        with reg:
            with eng:
                pass
    with eng:
        with reg:
            pass


def test_condition_wait_keeps_held_stack_exact(san):
    cv = locks.make_condition("prefix-cache")
    rt = locks.make_rlock("router")
    woke = threading.Event()

    def waker():
        with cv:
            woke.set()
            cv.notify_all()

    with cv:
        t = threading.Thread(target=waker)
        t.start()
        assert cv.wait_for(woke.is_set, timeout=10.0)
        # still (re-)holding prefix-cache(30) after the wait: taking
        # router(10) now must be flagged
        with rt:
            pass
    t.join(timeout=10.0)
    pairs = {(v["outer"], v["inner"]) for v in locks.violations()}
    assert ("prefix-cache", "router") in pairs


def test_off_mode_returns_raw_primitives():
    prev = locks.set_mode("off")
    try:
        lk = locks.make_lock("engine")
        assert not hasattr(lk, "rank")
        assert isinstance(locks.make_condition("engine"),
                          threading.Condition)
    finally:
        locks.set_mode(prev)


def test_unknown_name_rejected_at_creation():
    with pytest.raises(ValueError, match="unknown lock name"):
        locks.make_lock("no-such-lock")
    with pytest.raises(ValueError, match="sanitize"):
        locks.set_mode("bogus")


# ---- the retrace sentinel ------------------------------------------------------


def test_sentinel_note_miss_and_suspended(san):
    s = RetraceSentinel("t")
    s.note_miss("early", ())          # before arming: warmup builds are free
    s.arm()
    with s.suspended():               # a deliberate warm-path build
        s.note_miss("imported-page", ())
    assert s.hits == 0
    s.note_miss(("decode", 3), (torch.zeros(2, 3),))
    assert s.hits == 1
    [rec] = locks.retrace_log()
    assert rec["kind"] == "new-program" and "decode" in rec["program"]
    assert rec["signature"] == ["Tensor(2, 3):torch.float32"]


def test_sentinel_strict_raises(strict):
    s = RetraceSentinel("t")
    s.arm()
    with pytest.raises(RetraceViolation, match="late"):
        s.note_miss("late", ())


def test_sentinel_counts_in_off_mode_unlike_jax():
    prev = locks.set_mode("off")
    j_prev = j_locks.set_mode("off")
    try:
        s, js = RetraceSentinel("t"), j_locks.RetraceSentinel("t")
        s.arm()
        js.arm()
        s.note_miss("anything", ())
        js.note_miss("anything", ())
        assert s.hits == 1 and js.hits == 0
    finally:
        locks.set_mode(prev)
        j_locks.set_mode(j_prev)
        locks.reset()


def test_engine_sentinel_over_program_dict(tff):
    """A warmed engine serves its warm prompts building nothing; a decode
    chunk warmup never reached is one retrace; under sanitize="strict" it
    raises."""
    prompts = [np.arange(1, 7, dtype=np.int32),
               np.arange(3, 14, dtype=np.int32)]
    eng = tff.make_serving_engine(**ENGINE)
    assert eng.stats()["sanitizer_retraces"] == 0
    tw = eng.warmup(prompts, max_new_tokens=3)
    assert tw["variants"] == [("decode", 8)]
    built = eng.recompile_count
    eng.run(prompts, 3)
    assert eng.recompile_count == built
    assert eng.stats()["sanitizer_retraces"] == 0
    eng.warm_page_import(prompts[1])   # exempt: suspended
    assert eng.stats()["sanitizer_retraces"] == 0
    eng.decode_chunk = 3
    eng.run(prompts[:1], 2)
    assert eng.stats()["sanitizer_retraces"] == 1
    assert eng._retrace.owner == eng._tm_labels["replica"]

    prev = locks.mode()
    try:
        strict_eng = tff.make_serving_engine(**ENGINE)
        locks.set_mode("strict")
        strict_eng.warmup(prompts, max_new_tokens=3)
        strict_eng.decode_chunk = 5
        strict_eng.submit(prompts[0], 2)
        with pytest.raises(RetraceViolation):
            strict_eng.step()
    finally:
        locks.set_mode(prev)
        locks.reset()


def test_factories_used_by_the_serving_plane(tff, san):
    """Under sanitize="on" the engine's lock, the prefix cache's
    condition, the adapter pool's lock and the router's lock are ranked
    proxies under their JAX names."""
    router = tff.make_serving_router(replicas=1, adapter_pool_pages=2,
                                     lora_rank=2, start=False, **ENGINE)
    try:
        eng = router.engines[0]
        assert (eng._lock.name, eng._lock.rank) == ("engine", 20)
        assert router._lock.name == "router"
        assert eng.lora._lock.name == "adapter-pool"
        assert eng.prefix_cache._cv._lock.name == "prefix-cache"
        names = {r["name"] for r in locks.lock_graph_snapshot()[
            "tracked_locks"]}
        assert {"engine", "router", "adapter-pool",
                "prefix-cache"} <= names
    finally:
        router.close()


def test_lock_graph_snapshot_shape_equals_jax(san):
    locks.make_rlock("engine")
    snap = locks.lock_graph_snapshot()
    j_snap = j_locks.lock_graph_snapshot()
    assert set(snap) == set(j_snap)
    assert snap["mode"] == "on"
    assert snap["ranks"] == LOCK_RANKS
    assert {"name": "engine", "rank": 20} in snap["tracked_locks"]
    json.dumps(snap)


def test_config_knob_validation_and_adoption():
    with pytest.raises(ValueError, match="sanitize"):
        FFConfig(sanitize="bogus")
    prev = locks.mode()
    try:
        locks.configure(FFConfig(sanitize="strict"))
        assert locks.mode() == "strict"
        locks.configure(FFConfig())          # empty: leaves the mode
        assert locks.mode() == "strict"
    finally:
        locks.set_mode(prev)


# ---- the capture gate (ops/kernels.py): one capture, no device work beside --


def test_capture_gate_excludes_device_work_and_upgrades_without_deadlock():
    """Shared sections run together; an exclusive section waits for the
    others' shared sections to end and holds new ones off; two threads
    inside their own shared sections that both ask for the exclusive side
    (two engines capturing mid-tick) both get it, one after the other."""
    from flexflow_tpu_torch.ops.kernels import _CaptureGate

    gate = _CaptureGate()
    log, lock = [], threading.Lock()
    in_shared = threading.Barrier(2, timeout=10)

    def note(x):
        with lock:
            log.append(x)

    def upgrader(name):
        with gate.shared():
            in_shared.wait()            # both are inside their sections
            with gate.exclusive():
                note(f"{name} in")
                with gate.shared():     # the capturing thread's own work
                    pass
                note(f"{name} out")
            note(f"{name} back")

    ts = [threading.Thread(target=upgrader, args=(n,)) for n in "ab"]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in ts), "upgraders deadlocked"
    ins = [i for i, x in enumerate(log) if x.endswith(" in")]
    outs = [i for i, x in enumerate(log) if x.endswith(" out")]
    assert len(ins) == len(outs) == 2
    assert outs[0] < ins[1], f"two exclusive sections overlapped: {log}"

    held, entered = threading.Event(), threading.Event()
    release = threading.Event()

    def worker():
        with gate.shared():
            held.set()
            release.wait(10)

    def capturer():
        with gate.exclusive():
            entered.set()

    w = threading.Thread(target=worker)
    w.start()
    assert held.wait(10)
    c = threading.Thread(target=capturer)
    c.start()
    assert not entered.wait(0.2), "a capture ran beside device work"
    release.set()
    assert entered.wait(10)
    for t in (w, c):
        t.join(timeout=10)
