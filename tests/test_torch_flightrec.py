"""The flight recorder, SLO monitor, HBM ledger and health rollup in the
PyTorch port (``runtime/flightrec.py``), against the JAX package's.

  * SLO breach and clear hysteresis on injected series: the same
    observations through both packages' monitors give the same breach
    events (slo, replica, value, bound), the same breach state after
    each window and the same ``describe()`` — ceilings over the TTFT
    histogram, the fleet-labelled router series, the ratio floors from a
    counter source, ``rebaseline`` hiding warm-up traffic, and a spec
    turned off clearing its state;
  * ``health_rollup`` ok / degraded / breach equal JAX's for the same
    probes; the HBM ledger's sources and exposition; the device memory
    stats are empty on the CPU, as JAX's are on a backend without stats;
  * bundles: debounce and cooldown, retention, the file set, and a bundle
    either package writes passes the other's ``verify_bundle``; a flipped
    byte fails both; the fingerprint names torch and no JAX;
  * an engine's stats, health and HBM rows ride the bundle, and
    ``FFModel.dump_flight_record`` honours the off contract.
"""

import json
import os

import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu.runtime import flightrec as j_fr
from flexflow_tpu.runtime import telemetry as j_tm
from flexflow_tpu.runtime.checkpoint import \
    CheckpointCorruptError as JCorrupt
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.models import llama_lm
from flexflow_tpu_torch.runtime import flightrec as t_fr
from flexflow_tpu_torch.runtime import telemetry as t_tm
from flexflow_tpu_torch.runtime.manifest import \
    CheckpointCorruptError as TCorrupt

BUNDLE_FILES = {"trigger.json", "trace.json", "metrics.json",
                "logs.jsonl", "fingerprint.json", "engines.json",
                "hbm.json", "slo.json", "sanitizer.json",
                "ff_manifest.json"}
PKGS = {"jax": (j_fr, j_tm), "torch": (t_fr, t_tm)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    for fr, tm in PKGS.values():
        tm.reset()
        fr.reset()
    yield
    for fr, tm in PKGS.values():
        fr.reset()
        tm.reset()


def _cfg(pkg, directory=None, **kw):
    if directory is not None:
        kw["flight_recorder_dir"] = str(directory)
    if pkg == "jax":
        return JConfig(batch_size=2, mesh_shape={"data": 1}, **kw)
    return FFConfig(batch_size=2, **kw)


def _ttft(tm, replica="0", role="mixed"):
    return tm.registry().histogram(
        "ff_serving_ttft_seconds", labels=("replica", "role")).labels(
        replica, role)


def _strip(events):
    return [{k: e[k] for k in ("slo", "replica", "value", "bound", "kind")
             if k in e} for e in events]


def _ceiling_drill(pkg, tmp_path):
    fr, tm = PKGS[pkg]
    fr.configure(_cfg(pkg, tmp_path / pkg, slo_ttft_p99_s=0.1,
                      slo_window_s=30.0, slo_clear_windows=2))
    m = fr.slo_monitor()
    ch = _ttft(tm)
    fleet = tm.registry().histogram("ff_router_ttft_seconds").labels()
    out = [m.maybe_evaluate(), m.evaluate()]
    ch.observe(0.5)
    fleet.observe(2.0)
    out.append(m.evaluate())
    out.append(m.evaluate())                    # an empty window
    ch.observe(0.001)
    out.append(m.evaluate())                    # one healthy window
    states = [sorted((b["slo"], b["replica"]) for b in m.breaches())]
    ch.observe(0.001)
    fleet.observe(0.001)
    out.append(m.evaluate())
    fleet.observe(0.001)
    out.append(m.evaluate())
    states.append(sorted((b["slo"], b["replica"]) for b in m.breaches()))
    reg = tm.registry()
    counts = reg.counter("ff_slo_breach_total",
                         labels=("slo", "replica")).labels(
        "ttft_p99", "0").get()
    status = reg.gauge("ff_slo_status", labels=("slo", "replica")).labels(
        "ttft_p99", "0").get()
    traces = (len(tm.tracer().events(name="slo_breach")),
              len(tm.tracer().events(name="slo_clear")))
    desc = m.describe()
    return ([_strip(e) for e in out], states, counts, status, traces,
            desc["specs"], sorted(desc))


def test_slo_ceiling_hysteresis_equals_jax(tmp_path):
    got, want = _ceiling_drill("torch", tmp_path), \
        _ceiling_drill("jax", tmp_path)
    assert got == want
    events, states = got[0], got[1]
    assert [e["slo"] for e in events[2]] == ["ttft_p99", "ttft_p99"]
    assert {e["replica"] for e in events[2]} == {"0", "fleet"}
    assert states[0] and states[1] == []


def _ratio_drill(pkg, tmp_path):
    fr, tm = PKGS[pkg]
    fr.configure(_cfg(pkg, tmp_path / pkg, slo_prefix_hit_rate_min=0.8,
                      slo_spec_accept_min=0.5, slo_clear_windows=1))
    m = fr.slo_monitor()
    counters = {"prefix_hits": 0, "prefix_lookups": 0,
                "spec_accepted": 0, "spec_proposed": 0}

    def source():
        return ("r7", dict(counters))

    m.add_source(source)
    out = [m.evaluate()]
    counters.update(prefix_hits=1, prefix_lookups=10, spec_accepted=3,
                    spec_proposed=4)
    out.append(m.evaluate())
    out.append(m.evaluate())
    b1 = sorted((b["slo"], b["replica"]) for b in m.breaches())
    counters.update(prefix_hits=11, prefix_lookups=20, spec_accepted=4,
                    spec_proposed=8)
    out.append(m.evaluate())
    b2 = sorted((b["slo"], b["replica"]) for b in m.breaches())
    # warm-up traffic before rebaseline is never judged
    ch = _ttft(tm, "w")
    fr.configure(_cfg(pkg, tmp_path / pkg, slo_ttft_p99_s=0.1))
    m.evaluate()
    ch.observe(9.0)
    m.rebaseline()
    out.append(m.evaluate())
    # a spec turned off prunes its breach state
    ch.observe(5.0)
    out.append(m.evaluate())
    b3 = bool(m.breaches())
    fr.configure(_cfg(pkg, tmp_path / pkg))
    return [_strip(e) for e in out], b1, b2, b3, m.breaches()


def test_slo_ratio_floors_rebaseline_and_off_equal_jax(tmp_path):
    got, want = _ratio_drill("torch", tmp_path), \
        _ratio_drill("jax", tmp_path)
    assert got == want
    events, b1, b2, b3, after = got
    assert [e["slo"] for e in events[1]] == ["prefix_hit_rate"]
    assert b1 == [("prefix_hit_rate", "r7")]
    assert b2 == [("spec_accept", "r7")]       # 1 of 4 accepted
    assert events[4] == [] and b3 and after == []


def _rollup_drill(pkg, tmp_path):
    fr, tm = PKGS[pkg]
    probe_row = {"kind": "router", "status": "busy", "alive": 2,
                 "replicas": 2, "fenced": 0}

    def probe():
        return dict(probe_row)

    fr.register_health_source(probe)
    fr.configure(_cfg(pkg, tmp_path / pkg, slo_ttft_p99_s=0.1))
    rolls = [fr.health_rollup()]
    probe_row.update(fenced=1, alive=1)
    rolls.append(fr.health_rollup())
    probe_row.update(deploying=True)
    rolls.append(fr.health_rollup())
    m = fr.slo_monitor()
    ch = _ttft(tm)
    m.evaluate()
    ch.observe(5.0)
    m.evaluate()
    rolls.append(fr.health_rollup())
    return [{"status": r["status"],
             "degraded": sorted(r["degraded_reasons"]),
             "slos": {k: (v if isinstance(v, str)
                          else [x["replica"] for x in v])
                      for k, v in r["slos"].items()},
             "keys": sorted(r)} for r in rolls]


def test_health_rollup_equals_jax(tmp_path):
    got = _rollup_drill("torch", tmp_path)
    assert got == _rollup_drill("jax", tmp_path)
    assert [r["status"] for r in got] == ["ok", "degraded", "degraded",
                                          "breach"]


def test_hbm_ledger_and_device_stats():
    led = t_fr.hbm_ledger()

    def src():
        return ("fakepool", {"kv_pool": 1000, "adapter_pool": 24})

    led.add_source(src)
    led.set_lint_estimate(2048.0)
    snap = led.snapshot()
    assert snap["total_tracked_bytes"] == 1024
    assert snap["lint_vs_tracked_ratio"] == 2.0
    text = t_tm.registry().to_prometheus()
    assert ('ff_hbm_bytes{source="fakepool",subsystem="kv_pool"} 1000'
            in text)
    assert "ff_hbm_total_tracked_bytes 1024" in text
    # no card here: no device rows, as JAX's on a backend without stats
    assert t_fr.device_memory_stats() == {} and snap["device"] == {}


def test_trip_debounce_cooldown_and_retention(tmp_path):
    t_fr.configure(_cfg("torch", tmp_path, flight_debounce_s=0.05,
                        flight_cooldown_s=60.0))
    t_fr.trip("replica_fence", replica=1, reason="crash")
    t_fr.trip("fault", kind="crash", site="replica")
    assert t_fr.recorder().wait_pending(10.0)
    [b] = t_fr.list_bundles(str(tmp_path))
    trig = json.load(open(os.path.join(b, "trigger.json")))
    assert trig["cause"] == "replica_fence"
    assert [t["cause"] for t in trig["merged_triggers"]] == ["fault"]
    t_fr.trip("replica_fence", replica=2)
    assert t_fr.recorder().wait_pending(1.0)
    assert len(t_fr.list_bundles(str(tmp_path))) == 1
    assert t_fr.recorder().triggers_suppressed == 1
    keep_dir = tmp_path / "keep"
    t_fr.configure(_cfg("torch", keep_dir, flight_keep=2,
                        flight_cooldown_s=0.0))
    paths = [t_fr.dump(n=i) for i in range(4)]
    left = t_fr.list_bundles(str(keep_dir))
    assert left == paths[-2:]


def test_bundles_verify_across_packages(tmp_path):
    """A bundle either package writes has the same file set and passes
    the other package's verify_bundle; a flipped byte fails both."""
    paths = {}
    for pkg, (fr, tm) in PKGS.items():
        fr.configure(_cfg(pkg, tmp_path / pkg, slo_ttft_p99_s=5.0))
        tm.tracer().instant("drill_marker", track="t", k=1)
        paths[pkg] = fr.dump(cause="manual", operator="test")
        assert set(os.listdir(paths[pkg])) == BUNDLE_FILES
    for path in paths.values():
        t_fr.verify_bundle(path)
        j_fr.verify_bundle(path)
    t_path = paths["torch"]
    fp = json.load(open(os.path.join(t_path, "fingerprint.json")))
    assert fp["env"]["torch"] == torch.__version__
    assert fp["env"]["backend"] == "cpu" and "jax" not in fp["env"]
    assert fp["config"]["slo_ttft_p99_s"] == 5.0
    assert set(json.load(open(os.path.join(t_path, "fingerprint.json")))) \
        == set(json.load(open(os.path.join(paths["jax"],
                                           "fingerprint.json"))))
    san = json.load(open(os.path.join(t_path, "sanitizer.json")))
    assert san["ranks"]["router"] < san["ranks"]["engine"]
    trace = json.load(open(os.path.join(t_path, "trace.json")))
    assert any(e["name"] == "drill_marker" for e in trace["traceEvents"])
    victim = os.path.join(t_path, "metrics.json")
    blob = bytearray(open(victim, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(victim, "wb").write(bytes(blob))
    with pytest.raises(TCorrupt):
        t_fr.verify_bundle(t_path)
    with pytest.raises(JCorrupt):
        j_fr.verify_bundle(t_path)
    bare = tmp_path / (t_fr.BUNDLE_PREFIX + "99999_bare")
    bare.mkdir()
    with pytest.raises(TCorrupt):
        t_fr.verify_bundle(str(bare))


def test_engine_rows_ride_the_bundle_and_model_dump(tmp_path):
    """A port engine's stats / health / HBM rows and its health probe
    ride a manual bundle; FFModel.dump_flight_record writes a verified
    bundle, and returns None under telemetry="off"; trip() is silent under
    "off"."""
    ff = FFModel(FFConfig(batch_size=2), device="cpu")
    _, logits = llama_lm(ff, 2, seq_len=16, hidden=32, layers=1, heads=2,
                         kv_heads=2, vocab_size=53)
    ff.compile(final_tensor=logits)
    eng = ff.make_serving_engine(serve_slots=2, kv_page_size=8,
                                 max_seq_len=32)
    eng.set_telemetry_identity("fr0", "solo-test")
    rs = np.random.RandomState(3)
    reqs = eng.run([rs.randint(1, 53, (n,)).astype(np.int32)
                    for n in (5, 9)], max_new_tokens=3)
    assert all(r.state == "done" for r in reqs)
    path = ff.dump_flight_record(directory=str(tmp_path), note="drill")
    t_fr.verify_bundle(path)
    j_fr.verify_bundle(path)
    trig = json.load(open(os.path.join(path, "trigger.json")))
    assert trig["cause"] == "manual" and trig["args"]["source"] == "model"
    engines = json.load(open(os.path.join(path, "engines.json")))
    row = engines["engine-fr0"]
    assert row["stats"]["completed"] == 2
    assert row["health"]["status"] == "idle"
    hbm = json.load(open(os.path.join(path, "hbm.json")))
    assert hbm["sources"]["engine-fr0"]["kv_pool"] == \
        eng.stats()["kv_pool_bytes"]
    kinds = [r.get("kind") for r in t_fr.health_rollup()["fleet"]]
    assert "engine" in kinds
    ff.config.telemetry = "off"
    try:
        assert ff.dump_flight_record(directory=str(tmp_path)) is None
        off_dir = tmp_path / "off"
        ff.config.flight_recorder_dir = str(off_dir)
        ff.make_serving_engine(serve_slots=2, kv_page_size=8,
                               max_seq_len=32)
        t_fr.trip("engine_exception", replica="off0")
        assert t_fr.recorder().wait_pending(2.0)
        assert not off_dir.exists() or \
            t_fr.list_bundles(str(off_dir)) == []
    finally:
        ff.config.telemetry = "on"
        ff.config.flight_recorder_dir = ""


def _train_slo_drill(pkg, tmp_path):
    fr, tm = PKGS[pkg]
    fr.configure(_cfg(pkg, tmp_path / pkg, slo_step_time_p99_s=0.05,
                      slo_checkpoint_stall_s=1.0, slo_clear_windows=1))
    m = fr.slo_monitor()
    step = tm.registry().histogram("ff_train_step_seconds").labels()
    stall = tm.registry().histogram("ff_checkpoint_stall_seconds").labels()
    out = [m.evaluate()]
    step.observe(0.2)
    stall.observe(0.1)
    out.append(m.evaluate())
    b1 = sorted((b["slo"], b["replica"]) for b in m.breaches())
    step.observe(0.01)
    stall.observe(3.0)
    out.append(m.evaluate())
    b2 = sorted((b["slo"], b["replica"]) for b in m.breaches())
    desc = m.describe()
    fr.configure(_cfg(pkg, tmp_path / pkg))
    return [_strip(e) for e in out], b1, b2, desc["specs"]


def test_config_validation(tmp_path):
    for kw, match in ((dict(telemetry="bogus"), "telemetry"),
                      (dict(metrics_port=70000), "metrics_port"),
                      (dict(flight_keep=0), "flight_keep"),
                      (dict(flight_cooldown_s=-1.0), "flight_cooldown_s"),
                      (dict(flight_window_s=0.0), "flight_window_s"),
                      (dict(slo_ttft_p99_s=-1.0), "slo_ttft_p99_s"),
                      (dict(slo_prefix_hit_rate_min=1.5),
                       "slo_prefix_hit_rate_min"),
                      (dict(slo_window_s=0.0), "slo_window_s"),
                      (dict(slo_clear_windows=0), "slo_clear_windows")):
        with pytest.raises(ValueError, match=match):
            FFConfig(**kw)
        with pytest.raises(ValueError, match=match):
            JConfig(**kw)
    # the training SLOs are accepted and judge fit's step histogram and
    # the supervisor's checkpoint stall as JAX's monitor does
    assert _train_slo_drill("torch", tmp_path) == \
        _train_slo_drill("jax", tmp_path)
    jc, tc = JConfig(), FFConfig()
    for knob in ("serve_max_queue", "serve_replica_roles",
                 "seq_parallel_shards", "preempt_deadline_s", "telemetry",
                 "metrics_port", "flight_recorder_dir", "flight_keep",
                 "flight_cooldown_s", "flight_debounce_s",
                 "flight_window_s", "slo_ttft_p99_s",
                 "slo_queue_wait_p99_s", "slo_prefix_hit_rate_min",
                 "slo_spec_accept_min", "slo_step_time_p99_s",
                 "slo_checkpoint_stall_s", "slo_window_s",
                 "slo_clear_windows", "slo_trip_recorder", "sanitize"):
        assert getattr(tc, knob) == getattr(jc, knob), knob
