"""The port's rolling deployment (``runtime/deploy.py``, the engine's
per-version weight sets, the router's deploy hooks) against the JAX
package's ``RollingDeployer`` — the cases of tests/test_deploy.py.

The small f32 Llama (hidden 64, 2 layers, 4 heads over 2 kv heads, vocab
61) is built in both packages with JAX's initial weights carried into the
port; "v1" is every weight times 1.25, published by each package into its
own registry (checkpoints do not cross packages). JAX's engines run their
einsum route. Held to JAX: the registry's versions and refusals, every
deploy report's keys and outcome (completed, noop, refused on a torn
artifact, rolled back on a torn swap), the router's deploy counters and
per-replica versions, and the fleet's greedy tokens after the roll. Held
in the port: the version salt isolates the prefix cache, an A/B fleet
accrues hits only within a version, a roll on a started fleet captures
only inside the drained window (``swap_captures``), none after, and no
program is built after the replicas resume; a weight set is shared by the
replicas on its version and freed when its last reader rolls back or is
removed.
"""

import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu.runtime import faultinject as j_faultinject
from flexflow_tpu.runtime.deploy import RollingDeployer as JDeployer
from flexflow_tpu.runtime.deploy import \
    WeightArtifactRegistry as JRegistry
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.models import llama_lm
from flexflow_tpu_torch.runtime import checkpoint, faultinject
from flexflow_tpu_torch.runtime.deploy import (RollingDeployer,
                                               WeightArtifactRegistry)
from flexflow_tpu_torch.runtime.generation import served_weights
from flexflow_tpu_torch.runtime.serving import (DEFAULT_WEIGHT_VERSION,
                                                RadixPrefixCache, version_ns)

VOCAB = 61
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
    faultinject.reset()
    j_faultinject.reset()
    yield
    monkeypatch.delenv("FF_FAULT", raising=False)
    faultinject.reset()
    j_faultinject.reset()


@pytest.fixture(scope="module")
def jff():
    model = JModel(JConfig(batch_size=2, mesh_shape={"data": 1}))
    _, logits = j_llama_lm(model, 2, **ARCH)
    model.compile(final_tensor=logits)
    return model


def _np_tree(params):
    return {op: {w: np.asarray(a) for w, a in ws.items()}
            for op, ws in params.items()}


def _port(tree):
    """A port model holding ``tree`` (numpy) in place."""
    ff = FFModel(FFConfig(batch_size=2), device="cpu")
    _, logits = llama_lm(ff, 2, **ARCH)
    ff.compile(final_tensor=logits)
    with torch.no_grad():
        for op, ws in tree.items():
            for w, a in ws.items():
                ff.params[op][w].copy_(torch.from_numpy(np.array(a)))
    return ff


def _bumped(tree, scale=1.25):
    return {op: {w: (a * scale).astype(a.dtype) for w, a in ws.items()}
            for op, ws in tree.items()}


def _publish_port(ff, watch_dir, step, scale=1.25):
    """Publish the model's weights times ``scale`` as v<step>, then put
    the model's own weights back."""
    reg = WeightArtifactRegistry(str(watch_dir))
    keep = {op: {w: t.clone() for w, t in ws.items()}
            for op, ws in ff.params.items()}
    with torch.no_grad():
        for ws in ff.params.values():
            for t in ws.values():
                t.mul_(scale)
    try:
        version = reg.publish(ff, step=step)
    finally:
        with torch.no_grad():
            for op, ws in ff.params.items():
                for w, t in ws.items():
                    t.copy_(keep[op][w])
    return reg, version


def _publish_jax(jff, watch_dir, step, scale=1.25):
    reg = JRegistry(str(watch_dir))
    keep = jff.params
    jff.params = jff.executor.reshard_params(_bumped(_np_tree(keep), scale))
    try:
        version = reg.publish(jff, step=step)
    finally:
        jff.params = keep
    return reg, version


def _arm(monkeypatch, spec):
    monkeypatch.setenv("FF_FAULT", spec)
    faultinject.reset()
    j_faultinject.reset()


def _prompts(seed, lengths):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, VOCAB, (n,)).astype(np.int32) for n in lengths]


def _routers(jff, tff, **kw):
    j = jff.make_serving_router(replicas=2, paged_attention_impl="einsum",
                                start=False, **FLEET, **kw)
    t = tff.make_serving_router(replicas=2, start=False, **FLEET, **kw)
    return j, t


def _deploy_stats(router):
    st = router.stats()
    return {k: st[k] for k in ("swaps_completed", "rollbacks",
                               "deploying")} | {
        "versions": [row["weight_version"] for row in st["per_replica"]]}


# ---- the registry -------------------------------------------------------------


def test_version_ns_default_is_unsalted():
    for v in (None, "", DEFAULT_WEIGHT_VERSION):
        assert version_ns(v) is None
        assert version_ns(v, "lora-a") == "lora-a"
    assert version_ns("v3") == ("v3", None)
    assert version_ns("v3", "lora-a") == ("v3", "lora-a")
    toks = np.arange(1, 5, dtype=np.int32)
    keys = {RadixPrefixCache.first_chunk(toks, version_ns(v, None))
            for v in (DEFAULT_WEIGHT_VERSION, "v1", "v2")}
    assert len(keys) == 3
    keys = {RadixPrefixCache.first_chunk(toks, version_ns(v, a))
            for v in ("v0", "v1") for a in (None, "lora-a")}
    assert len(keys) == 4


def test_registry_publish_verify_load(jff, tmp_path):
    tff = _port(_np_tree(jff.params))
    reg = WeightArtifactRegistry(str(tmp_path / "port"))
    jreg = JRegistry(str(tmp_path / "jax"))
    for r in (reg, jreg):
        assert r.versions() == [] and r.latest() is None
        assert r.latest_intact() is None
    with pytest.raises(ValueError, match="reserved"):
        reg.publish(tff, step=0)
    assert reg.publish(tff, step=3) == jreg.publish(jff, step=3) == "v3"
    assert reg.versions() == jreg.versions() == ["v3"]
    assert reg.latest() == reg.latest_intact() == "v3"
    reg.verify("v3")
    host = reg.load_params("v3")
    assert set(host) == set(tff.params)
    for op, ws in tff.params.items():
        assert set(host[op]) == set(ws)
        for w, t in ws.items():
            assert host[op][w].device.type == "cpu"
            assert torch.equal(host[op][w], t)
    with pytest.raises(ValueError, match="v<step>"):
        reg.step_dir("release-candidate")
    with pytest.raises(ValueError, match="watch directory"):
        WeightArtifactRegistry("")


def test_corrupt_publish_refuses_deploy(jff, tmp_path, monkeypatch):
    tff = _port(_np_tree(jff.params))
    _arm(monkeypatch, "corrupt_ckpt@publish:1")
    reg = WeightArtifactRegistry(str(tmp_path / "port"))
    v = reg.publish(tff, step=1)
    with pytest.raises(checkpoint.CheckpointCorruptError):
        reg.verify(v)
    jreg = JRegistry(str(tmp_path / "jax"))
    jreg.publish(jff, step=1)
    assert reg.latest() == jreg.latest() == "v1"
    assert reg.latest_intact() is jreg.latest_intact() is None
    _arm(monkeypatch, "")
    jr, tr = _routers(jff, tff)
    try:
        jrep = JDeployer(jr, jreg, canary_windows=0).deploy("v1")
        trep = RollingDeployer(tr, reg, canary_windows=0).deploy("v1")
        assert set(trep) == set(jrep)
        assert trep["state"] == jrep["state"] == "refused"
        assert "hash mismatch" in trep["error"]
        for eng in tr.engines:
            assert eng.weight_version == DEFAULT_WEIGHT_VERSION
            assert eng.deploy_state == "serving"
            assert eng.stats()["weight_swaps"] == 0
        assert _deploy_stats(tr) == _deploy_stats(jr)
    finally:
        jr.close()
        tr.close()


def test_deploy_completes_and_torn_swap_rolls_back(jff, tmp_path,
                                                   monkeypatch):
    """Idle fleets, no decode: a clean deploy moves both replicas to v1;
    the same version again is a noop; a torn swap on the roll to v2 rolls
    the fleet back to v1 — reports, engine states and router counters
    equal to JAX's."""
    tff = _port(_np_tree(jff.params))
    jreg, _ = _publish_jax(jff, tmp_path / "jax", 1)
    reg, v1 = _publish_port(tff, tmp_path / "port", 1)
    jr, tr = _routers(jff, tff)
    try:
        jd = JDeployer(jr, jreg, canary_windows=0)
        td = RollingDeployer(tr, reg, canary_windows=0)
        jrep, trep = jd.deploy(v1), td.deploy(v1)
        assert set(trep) == set(jrep)
        for k in ("state", "version", "prior_versions", "swapped", "canary",
                  "breach", "bundle", "error"):
            assert trep[k] == jrep[k], k
        assert trep["state"] == "completed" and trep["swapped"] == [0, 1]
        for eng in tr.engines:
            assert eng.weight_version == "v1"
            assert eng._cache_ns(None) == ("v1", None)
            assert eng.stats()["weight_swaps"] == 1
        assert _deploy_stats(tr) == _deploy_stats(jr)
        assert tr.health()["weight_versions"] == ["v1", "v1"]
        # the replicas share one device copy of v1
        sets = served_weights(tff).live_sets()
        assert list(sets) == ["v1"]
        assert tr.engines[0].gen._weight_set is tr.engines[1].gen._weight_set
        for op, ws in sets["v1"].tree.items():
            for w, t in ws.items():
                assert torch.equal(t, tff.params[op][w] * 1.25), (op, w)
        assert jd.deploy(v1)["state"] == td.deploy(v1)["state"] == "noop"
        jreg2, _ = _publish_jax(jff, tmp_path / "jax", 2, scale=1.5)
        reg2, v2 = _publish_port(tff, tmp_path / "port", 2, scale=1.5)
        _arm(monkeypatch, "swap_fail@deploy:1")
        jrep = jd.deploy(v2)
        _arm(monkeypatch, "swap_fail@deploy:1")
        trep = td.deploy(v2)
        for k in ("state", "swapped", "prior_versions", "bundle"):
            assert trep[k] == jrep[k], k
        assert trep["state"] == "rolled_back"
        assert "swap on replica 0" in trep["error"]
        for eng in tr.engines:
            assert eng.weight_version == "v1"
            assert eng.deploy_state == "serving"
        assert _deploy_stats(tr) == _deploy_stats(jr)
        assert not tr._suspended[0] and not tr._suspended[1]
        assert list(served_weights(tff).live_sets()) == ["v1"]
    finally:
        jr.close()
        tr.close()


def test_drain_reopen_gate_without_decode(jff):
    tff = _port(_np_tree(jff.params))
    eng = tff.make_serving_engine(serve_slots=2, kv_page_size=4,
                                  max_seq_len=32)
    snap = eng.drain()
    assert snap["drained"] and snap["completed"] == 0
    with pytest.raises(RuntimeError, match="draining"):
        eng.submit(np.arange(1, 5, dtype=np.int32), 4)
    eng.reopen()
    assert eng.submit(np.arange(1, 5, dtype=np.int32), 4).state == "queued"
    eng.reopen()
    assert eng.stats()["weight_version"] == DEFAULT_WEIGHT_VERSION
    assert eng.stats()["deploy_state"] == "serving"


# ---- decode-carrying paths ------------------------------------------------


def test_version_salt_isolates_prefix_cache(jff, tmp_path):
    """A prompt hot under v0 admits cold after the swap to v1, serves the
    v1 reference's tokens, and hits its own pages under v1."""
    tff = _port(_np_tree(jff.params))
    reg, v1 = _publish_port(tff, tmp_path, 1)
    eng = tff.make_serving_engine(**FLEET)
    shared = _prompts(7, [8])[0]
    eng.run([shared], max_new_tokens=4)
    base = eng.stats()
    eng.run([shared], max_new_tokens=4)
    assert eng.stats()["prefix_hits"] == base["prefix_hits"] + 1
    eng.drain()
    eng.swap_weights(reg.load_params(v1), v1)
    eng.reopen()
    assert eng.stats()["kv_pages_cached"] == 0
    post = eng.stats()
    r1 = eng.run([shared], max_new_tokens=4)[0]
    after = eng.stats()
    assert after["prefix_hits"] == post["prefix_hits"]
    ref = _port(_bumped(_np_tree(jff.params)))
    np.testing.assert_array_equal(
        np.asarray(r1.tokens, np.int32),
        ref.generate(shared[None, :], max_new_tokens=4)[0, shared.size:])
    eng.run([shared], max_new_tokens=4)
    assert eng.stats()["prefix_hits"] == after["prefix_hits"] + 1


def test_ab_fleet_per_version_hit_accounting(jff, tmp_path):
    """Replica 0 on v1, replica 1 on v0: a prompt keeps a home, hits
    accrue only in one version's world, and the streams are that
    version's reference tokens."""
    tff = _port(_np_tree(jff.params))
    reg, v1 = _publish_port(tff, tmp_path, 1)
    router = tff.make_serving_router(replicas=2, **FLEET)
    try:
        router.suspend_replica(0)
        while not router.replica_quiesced(0):
            pass
        router.engines[0].drain()
        router.engines[0].swap_weights(reg.load_params(v1), v1)
        router.engines[0].reopen()
        router.resume_replica(0)
        assert [e.weight_version for e in router.engines] == ["v1", "v0"]
        shared = _prompts(9, [8])[0]
        first = router.run([shared], max_new_tokens=4, timeout=300)[0]
        home = first.replica
        rest = router.run([shared, shared], max_new_tokens=4, timeout=300)
        assert [r.replica for r in rest] == [home, home]
        assert router.engines[1 - home].stats()["prefix_hits"] == 0
        assert router.engines[home].stats()["prefix_hits"] >= 1
        tree = _np_tree(jff.params)
        if router.engines[home].weight_version == v1:
            tree = _bumped(tree)
        want = _port(tree).generate(shared[None, :], max_new_tokens=4)
        for r in [first] + rest:
            np.testing.assert_array_equal(np.asarray(r.tokens, np.int32),
                                          want[0, shared.size:])
    finally:
        router.close()


def test_rolling_deploy_on_live_fleet(jff, tmp_path):
    """A roll on started fleets in both packages: both replicas end on v1;
    the port's programs are captured inside the drained window only
    (``swap_captures``), no program is built after the replicas resume
    (``recompiles`` flat, no sentinel record); post-deploy tokens equal
    the JAX fleet's after its own roll and the v1 reference's; the swap
    log names each replica's seconds and captures."""
    tff = _port(_np_tree(jff.params))
    jreg, _ = _publish_jax(jff, tmp_path / "jax", 1)
    reg, v1 = _publish_port(tff, tmp_path / "port", 1)
    jr, tr = _routers(jff, tff)
    try:
        warm = _prompts(3, [5, 9])
        for r in (jr, tr):
            r.warmup(warm, max_new_tokens=2)
            r.start()
        pre = [e.stats()["recompiles"] for e in tr.engines]
        td = RollingDeployer(tr, reg, canary_windows=0)
        trep = td.deploy(v1, warmup_prompts=warm, max_new_tokens=2)
        jrep = JDeployer(jr, jreg, canary_windows=0).deploy(
            v1, warmup_prompts=warm, max_new_tokens=2)
        assert set(trep) == set(jrep)
        assert trep["state"] == jrep["state"] == "completed"
        assert [e.weight_version for e in tr.engines] == ["v1", "v1"]
        caps = [e.stats()["swap_captures"] for e in tr.engines]
        assert all(c >= 1 for c in caps)
        assert [s["captures"] for s in td.swap_log] == caps
        assert all(s["swap_s"] > 0 for s in td.swap_log)
        assert [e.stats()["recompiles"] for e in tr.engines] == pre
        prompts = _prompts(11, [6, 10, 4])
        treqs = tr.run(prompts, max_new_tokens=4, timeout=300)
        jreqs = jr.run(prompts, max_new_tokens=4, timeout=300)
        assert [r.state for r in treqs] == ["done"] * 3
        assert [list(r.tokens) for r in treqs] == \
            [list(r.tokens) for r in jreqs]
        ref = _port(_bumped(_np_tree(jff.params)))
        for r in treqs:
            np.testing.assert_array_equal(
                np.asarray(r.tokens, np.int32),
                ref.generate(r.prompt[None, :],
                             max_new_tokens=4)[0, r.prompt.size:])
        for e in tr.engines:
            st = e.stats()
            assert st["recompiles"] == pre[0]
            assert st["swap_captures"] == caps[tr.engines.index(e)]
            assert st["sanitizer_retraces"] == 0
        assert _deploy_stats(tr) == _deploy_stats(jr)
    finally:
        jr.close()
        tr.close()


def test_weight_set_refcount(jff, tmp_path):
    """Both replicas on v1 share one set; rolling one back keeps it; the
    other's removal frees it; a rollback re-captures nothing."""
    tff = _port(_np_tree(jff.params))
    reg, v1 = _publish_port(tff, tmp_path, 1)
    tff.generate(_prompts(1, [5])[0][None, :], max_new_tokens=2)
    router = tff.make_serving_router(replicas=2, start=False, **FLEET)
    sw = served_weights(tff)
    try:
        router.warmup(_prompts(3, [5, 9]), max_new_tokens=2)
        router.start()
        rep = RollingDeployer(router, reg, canary_windows=0).deploy(v1)
        assert rep["state"] == "completed"
        sets = sw.live_sets()
        assert list(sets) == ["v1"] and len(sets["v1"].readers) == 2
        e0, e1 = router.engines
        router.suspend_replica(0)
        e0.drain()
        assert e0.swap_weights(None, "v0")["captures"] == 0
        e0.reopen()
        router.resume_replica(0)
        assert list(sw.live_sets()) == ["v1"]
        assert len(sw.live_sets()["v1"].readers) == 1
        router.remove_replica(1)
        assert sw.live_sets() == {}
        assert e1.gen._weight_set is None
        reqs = router.run(_prompts(5, [6, 7]), max_new_tokens=3,
                          timeout=300)
        assert all(r.state == "done" and r.replica == 0 for r in reqs)
    finally:
        router.close()
