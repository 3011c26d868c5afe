"""The port's autoscaler (``runtime/autoscale.py``) and machine model
(``search/machine.py``) against the JAX package's — the autoscale,
placement and knob cases of tests/test_elastic_serve.py and the pure cases
of tests/test_machine_model.py.

Both packages' ``AutoscalePolicy`` tick side by side over the same scripted
fleet (a fake router and SLO monitor): every tick's decision, the
actuator calls and the controller state are equal. ``PlacementAdvisor``
and every collective's time are equal under the same ``MachineModel``
constants (the port's defaults are an H100's datasheet figures, JAX's a
TPU's, so the constants are passed explicitly). A real CPU fleet of the
port scales out and back in under the policy, its streams equal to a
single engine's, the retiree's cached prefixes inherited by the survivor.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu.runtime import autoscale as JA
from flexflow_tpu.search.machine import MachineModel as JMachine
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.models import llama_lm
from flexflow_tpu_torch.runtime import autoscale as TA
from flexflow_tpu_torch.search.machine import MachineModel

VOCAB = 89
B = 64 * 1024 * 1024


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeCfg:
    telemetry = "off"
    slo_window_s = 10.0
    dcn_mesh_shape = {"data": 2}
    autoscale_min_replicas = 1
    autoscale_max_replicas = 3
    autoscale_breach_windows = 2
    autoscale_idle_windows = 3
    autoscale_cooldown_s = 30.0


class _FakeModel:
    config = _FakeCfg()


class _FakeRouter:
    """health(), stats() and the two actuators, with a scriptable load."""

    def __init__(self, replicas=2):
        self.model = _FakeModel()
        self.alive = replicas
        self.queued = 0
        self.outstanding = 0
        self.added = []
        self.removed = []

    def health(self):
        return {"alive": self.alive, "queued": self.queued,
                "outstanding": self.outstanding}

    def stats(self):
        rows = [{"replica": r, "fenced": False, "retired": False,
                 "suspended": False, "outstanding": r, "queued": 0}
                for r in range(self.alive)]
        return {"alive": self.alive, "per_replica": rows,
                "fleet": {"pages_by_tier": {"hbm": 8, "host": 0}},
                "evacuated_pages": 0, "evacuation_bytes": 0}

    def add_replica(self):
        self.alive += 1
        self.added.append(self.alive - 1)
        return self.alive - 1

    def remove_replica(self, r, **kw):
        self.alive -= 1
        self.removed.append(r)
        return {"replica": r, "requeued": 0, "fenced": False}


class _FakeSLO:
    def __init__(self):
        self.rows = []

    def maybe_evaluate(self, now=None):
        return []

    def breaches(self):
        return self.rows

    def __getattr__(self, name):
        return lambda *a, **kw: None


def _jax_machine_fields():
    return {f.name: getattr(JMachine(), f.name)
            for f in dataclasses.fields(JMachine)}


def _pair(monkeypatch, replicas=2, **kw):
    """(jax policy, port policy, their fake routers, the shared fake SLO):
    both advisors price with JAX's default constants."""
    slo = _FakeSLO()
    monkeypatch.setattr(JA.flightrec, "slo_monitor", lambda: slo)
    monkeypatch.setattr(TA.flightrec, "slo_monitor", lambda: slo)
    jr, tr = _FakeRouter(replicas), _FakeRouter(replicas)
    jp = JA.AutoscalePolicy(jr, **kw)
    tp = TA.AutoscalePolicy(
        tr, advisor=TA.PlacementAdvisor(MachineModel(
            **dict(_jax_machine_fields(), dcn_axes={"data": 2}))), **kw)
    return jp, tp, jr, tr, slo


def _same_state(jp, tp):
    js, ts = jp.state(), tp.state()
    assert set(js) == set(ts)
    for k in js:
        if k in ("cooldown_remaining_s", "events"):
            continue
        assert ts[k] == js[k], k
    assert [{k: e[k] for k in ("action", "replica", "placement",
                               "breached")} for e in ts["events"]] == \
        [{k: e[k] for k in ("action", "replica", "placement", "breached")}
         for e in js["events"]]


def _tick_both(jp, tp, jr, tr):
    got = (jp.tick(), tp.tick())
    assert got[0] == got[1]
    assert (jr.added, jr.removed, jr.alive) == (tr.added, tr.removed,
                                                tr.alive)
    _same_state(jp, tp)
    return got[1]


QUEUE_BREACH = [{"slo": "queue_wait_p99", "replica": -1, "value": 2.0,
                 "bound": 0.5, "ok_streak": 0, "windows": 3}]


def test_breach_streak_hysteresis_and_cooldown(monkeypatch):
    jp, tp, jr, tr, slo = _pair(monkeypatch, max_replicas=5)
    slo.rows = QUEUE_BREACH
    assert _tick_both(jp, tp, jr, tr) is None
    assert _tick_both(jp, tp, jr, tr) == "scale_out" and tr.added == [2]
    assert _tick_both(jp, tp, jr, tr) is None
    assert _tick_both(jp, tp, jr, tr) is None
    assert tp.state()["cooldown_blocks"] >= 1 and tr.alive == 3
    # a quality SLO is no capacity signal
    slo.rows = [{"slo": "prefix_hit_rate", "replica": -1, "value": 0.1,
                 "bound": 0.5, "ok_streak": 0, "windows": 3}]
    jp2, tp2, jr2, tr2, slo2 = _pair(monkeypatch, replicas=1)
    slo2.rows = slo.rows
    for _ in range(5):
        assert _tick_both(jp2, tp2, jr2, tr2) is None
    assert tp2.state()["breach_streak"] == 0


def test_max_bound_blocks_scale_out(monkeypatch):
    jp, tp, jr, tr, slo = _pair(monkeypatch, replicas=3)
    slo.rows = [{"slo": "ttft_p99", "replica": 0, "value": 9.0,
                 "bound": 1.0, "ok_streak": 0, "windows": 2}]
    for _ in range(4):
        assert _tick_both(jp, tp, jr, tr) is None
    assert tr.added == [] and tp.state()["bound_blocks"] >= 1


def test_idle_streak_scale_in_and_min_bound(monkeypatch):
    jp, tp, jr, tr, slo = _pair(monkeypatch, cooldown_s=0.0)
    assert _tick_both(jp, tp, jr, tr) is None
    assert _tick_both(jp, tp, jr, tr) is None
    jr.queued = tr.queued = 3
    assert _tick_both(jp, tp, jr, tr) is None
    assert tp.state()["idle_streak"] == 0
    jr.queued = tr.queued = 0
    for _ in range(2):
        assert _tick_both(jp, tp, jr, tr) is None
    assert _tick_both(jp, tp, jr, tr) == "scale_in"
    assert tr.removed == [0]
    for _ in range(6):
        _tick_both(jp, tp, jr, tr)
    assert tr.alive == 1 and tp.state()["bound_blocks"] >= 1


def test_knob_validation_and_state_keys():
    rt = _FakeRouter()
    for mod in (JA, TA):
        with pytest.raises(ValueError, match="min_replicas"):
            mod.AutoscalePolicy(rt, min_replicas=0)
        with pytest.raises(ValueError, match="max_replicas"):
            mod.AutoscalePolicy(rt, min_replicas=4, max_replicas=2)
    assert set(TA.AutoscalePolicy(rt).state()) == \
        set(JA.AutoscalePolicy(rt).state())
    for kw, match in ((dict(autoscale_min_replicas=0),
                       "autoscale_min_replicas"),
                      (dict(autoscale_min_replicas=3,
                            autoscale_max_replicas=2),
                       "autoscale_max_replicas"),
                      (dict(autoscale_breach_windows=0),
                       "autoscale_breach_windows"),
                      (dict(autoscale_idle_windows=0),
                       "autoscale_idle_windows"),
                      (dict(autoscale_cooldown_s=-1.0),
                       "autoscale_cooldown_s"),
                      (dict(deploy_canary_windows=-1),
                       "deploy_canary_windows"),
                      (dict(deploy_drain_timeout_s=0.0),
                       "deploy_drain_timeout_s")):
        with pytest.raises(ValueError, match=match):
            FFConfig(**kw)
        with pytest.raises(ValueError, match=match):
            JConfig(**kw)
    jc, tc = JConfig(), FFConfig()
    for knob in ("autoscale_min_replicas", "autoscale_max_replicas",
                 "autoscale_breach_windows", "autoscale_idle_windows",
                 "autoscale_cooldown_s", "deploy_watch_dir",
                 "deploy_canary_windows", "deploy_drain_timeout_s"):
        assert getattr(tc, knob) == getattr(jc, knob), knob


@pytest.mark.parametrize("nbytes", [1 << 20, 10 ** 9, 10 ** 12])
def test_placement_equals_jax_with_the_same_constants(nbytes):
    fields = _jax_machine_fields()
    j = JA.PlacementAdvisor(JMachine(**fields), budget_s=1.0).place(nbytes)
    t = TA.PlacementAdvisor(MachineModel(**fields),
                            budget_s=1.0).place(nbytes)
    assert t == j


def test_placement_under_the_h100_model():
    """Under the H100 datasheet figures NVLink (450 GB/s) carries a 16 GB
    state in ~36 ms; the 50 GB/s fabric is 9x slower."""
    adv = TA.PlacementAdvisor(budget_s=1.0)
    small = adv.place(1 << 20)
    assert small["tier"] == "ici" and small["dcn_s"] > small["ici_s"]
    big = adv.place(16 * 10 ** 9)
    assert big["tier"] == "ici"
    assert big["dcn_penalty_x"] == pytest.approx(9.0, rel=1e-3)
    assert adv.place(10 ** 12)["tier"] == "dcn"
    m = MachineModel()
    assert (m.peak_flops, m.peak_flops_f32, m.hbm_bw, m.hbm_bytes,
            m.ici_bw, m.dcn_bw) == (989e12, 67e12, 3.35e12, 80e9, 4.5e11,
                                    5.0e10)


# ------------------------------------------------------------ machine model


def _machines(mod):
    fields = _jax_machine_fields()
    return (mod(**dict(fields, dcn_axes={"data": 2})), mod(**fields),
            mod(**dict(fields, dcn_axes={"x": 2})))


@pytest.mark.parametrize("fn", ["all_reduce_time", "all_gather_time",
                                "reduce_scatter_time", "all_to_all_time"])
def test_collectives_equal_jax(fn):
    for jm, tm in zip(_machines(JMachine), _machines(MachineModel)):
        for size, axis in ((8, "data"), (8, "model"), (4, None),
                           (2, "x"), (1, "data"), (6, "data")):
            assert getattr(tm, fn)(B, size, axis) == \
                getattr(jm, fn)(B, size, axis), (fn, size, axis)
        for cross in (False, True):
            assert tm.p2p_time(B, cross) == jm.p2p_time(B, cross)
        assert tm.compute_time(1e12, 1e9, 2) == jm.compute_time(1e12, 1e9,
                                                                  2)


def test_composition_clamping_and_size_one_axes():
    hier, ici, dcn = _machines(MachineModel)
    assert hier.all_reduce_time(B, 8, "data") == pytest.approx(
        ici.all_reduce_time(B, 4, None) + dcn.all_reduce_time(B, 2, "x"),
        rel=1e-12)
    assert hier.all_gather_time(B, 8, "data") == pytest.approx(
        ici.all_gather_time(B, 4, None)
        + dcn.all_gather_time(4 * B, 2, "x"), rel=1e-12)
    assert MachineModel(dcn_axes={"data": 3})._tiers(8, "data") == (4, 2)
    assert MachineModel(dcn_axes={"data": 16})._tiers(8, "data") == (1, 8)
    m = MachineModel(dcn_axes={"data": 2})
    assert m.reduce_scatter_time(B, 1, "data") == 0.0
    assert m.all_reduce_time(B, 1, "data") == 0.0


# ------------------------------------------------------------ a real fleet


def test_autoscaler_drives_real_router(monkeypatch):
    """The port's policy on a real CPU fleet: a scripted breach grows it
    (the newcomer serves a single engine's tokens), scripted idleness
    shrinks it back; the retired replica's cached prefixes are inherited
    by the survivor."""
    arch = dict(seq_len=16, hidden=64, layers=2, heads=4, kv_heads=2,
                vocab_size=VOCAB)
    ff = FFModel(FFConfig(batch_size=2), device="cpu")
    _, logits = llama_lm(ff, 2, **arch)
    ff.compile(final_tensor=logits)
    router = ff.make_serving_router(replicas=1, serve_slots=2,
                                    kv_page_size=4, max_seq_len=64,
                                    start=False)
    slo = _FakeSLO()
    monkeypatch.setattr(TA.flightrec, "slo_monitor", lambda: slo)
    pol = TA.AutoscalePolicy(router, min_replicas=1, max_replicas=2,
                             breach_windows=2, idle_windows=2,
                             cooldown_s=0.0)
    rs = np.random.RandomState(81)
    prompts = [rs.randint(1, VOCAB, (n,)).astype(np.int32)
               for n in (5, 9, 3, 7, 12, 8)]
    try:
        router.warmup(prompts[:2], max_new_tokens=2)
        router.start()
        slo.rows = QUEUE_BREACH
        assert pol.tick() is None
        assert pol.tick() == "scale_out"
        assert router.stats()["alive"] == 2
        reqs = router.run(prompts, max_new_tokens=4, timeout=300)
        assert all(r.state == "done" for r in reqs)
        assert {r.replica for r in reqs} == {0, 1}
        eng = ff.make_serving_engine(serve_slots=2, kv_page_size=4,
                                     max_seq_len=64, prefix_cache=False)
        want = [list(r.tokens) for r in eng.run(prompts, max_new_tokens=4)]
        del eng
        assert [list(r.tokens) for r in reqs] == want
        slo.rows = []
        assert pol.tick() is None
        assert pol.tick() == "scale_in"
        st = router.stats()
        assert st["alive"] == 1 and st["retired"] == 1
        assert st["evacuated_pages"] > 0
        event = pol.state()["events"][-1]
        assert event["placement"]["tier"] == "ici"
        assert event["placement"] == TA.PlacementAdvisor().place(
            event["placement"]["state_bytes"])
    finally:
        pol.close()
        router.close()
