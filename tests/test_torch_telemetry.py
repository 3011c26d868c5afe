"""The telemetry plane in the PyTorch port (``runtime/telemetry.py`` and the
engine's and router's wiring), against the JAX package's.

  * the same observations fed to both packages' ``Registry`` give the same
    Prometheus text and the same ``/metrics.json`` snapshot;
    ``log_bounds`` and ``bucket_quantile`` agree;
  * span trees (nesting, cross-thread begin / end, annotations) are built
    alike, and the exported Chrome trace follows the trace-event schema;
  * the HTTP server on port 0 serves ``/metrics``, ``/metrics.json``,
    ``/trace.json`` and ``/healthz`` on localhost;
  * the port's engine on the same small-model traffic as JAX's exports
    the same families with the same label sets and the same histogram
    observation counts (no timing compared); the stats-derived gauges
    differ exactly by the stats keys the two engines do not share;
  * every request's span tree holds its queue_wait, prefill (cold / hit)
    and decode spans, and through a router it is complete under the
    request's root, across a crash failover and across a prefill -> decode
    handoff;
  * ``telemetry="off"`` leaves the tokens and the programs as they are
    and emits nothing.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu.runtime import faultinject as j_faultinject
from flexflow_tpu.runtime import telemetry as j_tm
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import llama_lm
from flexflow_tpu_torch.runtime import faultinject as t_faultinject
from flexflow_tpu_torch.runtime import telemetry as t_tm

VOCAB = 61
ARCH = dict(seq_len=16, hidden=32, layers=1, heads=2, kv_heads=2,
            vocab_size=VOCAB)
ENGINE = dict(serve_slots=2, kv_page_size=8, max_seq_len=48)
#: stats() keys only one engine has (the port's CUDA-graph and launch
#: ledger and the captures a shared-model weight swap made; JAX's
#: kernel-tune table and page-touch counters)
PORT_ONLY_STATS = {"decode_step_ms", "graph_replays", "spec_dispatches",
                   "swap_captures"}
JAX_ONLY_STATS = {"kernel_tune_hits", "kernel_tune_misses",
                  "kv_effective_page_capacity", "last_pages_touched",
                  "pages_touched"}


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


def _feed(tm):
    """One set of observations into a fresh registry of package ``tm``."""
    reg = tm.Registry()
    c = reg.counter("ff_req_total", "requests served",
                    labels=("replica", "role"))
    c.labels("0", "mixed").inc(4)
    c.labels(replica="1", role="decode").inc(2.5)
    reg.gauge("ff_up", "liveness").set(1)
    reg.gauge("ff_q", 'quoted "help"', labels=("k",)).labels(
        'a"b\\c\nd').set(-3.25)
    h = reg.histogram("ff_lat_seconds", "latency",
                      labels=("replica",), bounds=tm.log_bounds(1e-3, 1.0))
    for v in (0.0005, 0.002, 0.002, 0.07, 0.5, 3.0):
        h.labels("0").observe(v)
    d = reg.histogram("ff_default_seconds", "default bounds")
    for v in (1e-5, 0.3, 250.0):
        d.observe(v)

    class Src:
        def collect(self, r):
            r.gauge("ff_collected", "from a collector",
                    labels=("replica", "role")).labels("0", "solo").set(7)

    src = Src()
    reg.add_collector(src.collect)
    return reg, src


def test_registry_exposition_equals_jax():
    j_reg, j_src = _feed(j_tm)
    t_reg, t_src = _feed(t_tm)
    text = t_reg.to_prometheus()
    assert text == j_reg.to_prometheus()
    assert 'ff_lat_seconds_bucket{replica="0",le="+Inf"} 6' in text
    assert t_reg.snapshot() == j_reg.snapshot()
    assert t_reg.describe() == j_reg.describe()
    json.dumps(t_reg.snapshot())
    hist = t_reg.family("ff_lat_seconds").labels("0")
    j_hist = j_reg.family("ff_lat_seconds").labels("0")
    for q in (0.5, 0.9, 0.99):
        assert hist.quantile(q) == j_hist.quantile(q)


@pytest.mark.parametrize("lo,hi,growth", [(1e-4, 200.0, 2.0),
                                          (1e-3, 1.0, 1.5), (0.5, 64, 4.0)])
def test_log_bounds_and_bucket_quantile_equal_jax(lo, hi, growth):
    b = t_tm.log_bounds(lo, hi, growth)
    assert b == j_tm.log_bounds(lo, hi, growth)
    rs = np.random.RandomState(3)
    counts = list(rs.randint(0, 9, len(b) + 1))
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert t_tm.bucket_quantile(b, counts, q) == \
            j_tm.bucket_quantile(b, counts, q)
    assert t_tm.DEFAULT_LATENCY_BOUNDS == j_tm.DEFAULT_LATENCY_BOUNDS
    with pytest.raises(ValueError):
        t_tm.log_bounds(1.0, 0.5)


def test_counters_exact_under_threads():
    reg = t_tm.Registry()
    c = reg.counter("stress_total", labels=("t",))
    h = reg.histogram("stress_seconds", bounds=(0.5,))

    def work(i):
        for _ in range(2000):
            c.labels(str(i % 2)).inc()
            h.observe(0.25)

    ts = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert c.labels("0").get() + c.labels("1").get() == 8000
    assert h.labels().count == 8000


def _trace(tm):
    tr = tm.Tracer(cap=64)
    with tr.span("root", trace_id="tX", track="a"):
        with tr.span("child", trace_id="tX", track="b") as sp:
            sp.annotate(pages=3)
        tr.instant("mark", trace_id="tX", track="a", where="q")
    h = tr.begin("work", trace_id="tX", track="c")
    t = threading.Thread(target=lambda: tr.end(h, state="done"))
    t.start()
    t.join(timeout=10)
    tr.end(h)          # a second end is a no-op
    tr.end(0)          # the off handle is a no-op
    for i in range(100):
        tr.instant("e", trace_id=f"t{i}")
    return tr


def _shape(tree):
    return {"complete": tree["complete"], "names": sorted(tree["names"]),
            "tracks": tree["tracks"],
            "annotations": [e["name"] for e in tree["annotations"]],
            "root": tree["root"]["name"] if tree["root"] else None}


def test_span_trees_equal_jax(tmp_path):
    tr, jtr = _trace(t_tm), _trace(j_tm)
    assert len(tr) == len(jtr) == 64
    # the ring dropped the same oldest events
    assert [e["name"] for e in tr.events()] == \
        [e["name"] for e in jtr.events()]
    with t_tm.tracer().span("outer", trace_id="ctx1"):
        assert t_tm.current_trace_id() == "ctx1"
    assert t_tm.current_trace_id() is None
    tr2, jtr2 = t_tm.Tracer(), j_tm.Tracer()
    for t in (tr2, jtr2):
        with t.span("root", trace_id="tY", track="a"):
            with t.span("child", trace_id="tY", track="b"):
                pass
            t.instant("mark", trace_id="tY", track="a")
    assert _shape(tr2.trace_tree("tY")) == _shape(jtr2.trace_tree("tY"))
    assert tr2.trace_tree("tY")["complete"]
    # the Chrome trace of the process ring
    path = str(tmp_path / "trace.json")
    assert t_tm.export_chrome_trace(path) >= 1
    doc = json.load(open(path))
    for ev in doc["traceEvents"]:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(ev)
        if ev["ph"] == "X":
            assert "dur" in ev


def test_set_enabled_short_circuits():
    reg = t_tm.Registry()
    c = reg.counter("off_total")
    tr = t_tm.Tracer()
    prev = t_tm.set_enabled(False)
    try:
        assert tr.span("x") is t_tm.NULL_SPAN
        assert tr.begin("y") == 0
        tr.instant("z")
        c.inc()
        assert len(tr) == 0 and c.labels().get() == 0
    finally:
        t_tm.set_enabled(prev)


def test_fault_injection_annotates_trace(monkeypatch):
    monkeypatch.setenv("FF_FAULT", "swap_fail@deploy:1")
    t_faultinject.reset()
    before = len(t_tm.fault_events())
    with pytest.raises(t_faultinject.InjectedFault):
        t_faultinject.maybe_fail("swap_fail", "deploy")
    evs = t_tm.fault_events()
    assert len(evs) == before + 1
    assert evs[-1]["args"]["kind"] == "swap_fail"
    assert 'ff_fault_fired_total{kind="swap_fail",site="deploy"}' in \
        t_tm.registry().to_prometheus()


def test_http_server_on_port_zero():
    port = t_tm.start_http_server(0)
    try:
        assert port > 0
        assert t_tm.start_http_server(0) == port     # one a process
        t_tm.registry().counter("ff_http_probe_total").inc()

        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.status, r.headers["Content-Type"], r.read()

        code, ctype, body = get("/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        assert b"ff_http_probe_total 1" in body
        code, ctype, body = get("/metrics.json")
        assert code == 200 and "ff_http_probe_total" in json.loads(body)
        code, _, body = get("/trace.json")
        assert "traceEvents" in json.loads(body)
        code, _, body = get("/healthz")
        assert json.loads(body)["status"] in ("ok", "degraded", "breach")
    finally:
        t_tm.stop_http_server()


# ---- the engine's and the router's wiring ---------------------------------------


def _series(tm, ident):
    """{family: (type, sorted label-name tuples, [counts or values])} of
    the series labeled replica=ident in package tm's process registry."""
    snap = tm.registry().snapshot()
    out = {}
    for name, fam in snap.items():
        rows = [s for s in fam["series"]
                if s["labels"].get("replica") == ident]
        if not rows:
            continue
        out[name] = (fam["type"],
                     sorted(tuple(sorted(s["labels"])) for s in rows),
                     sorted(s["count"] for s in rows)
                     if fam["type"] == "histogram" else None)
    return out


def test_engine_families_and_counts_equal_jax(models):
    """The same traffic through JAX's engine and the port's, each under
    its own fleet identity: the same families, label sets and histogram
    observation counts; the stats gauges differ by the unshared stats
    keys only; tokens equal."""
    jff, tff = models
    prompts = _prompts(3, [5, 9, 12, 20])
    rs = np.random.RandomState(5)
    system = rs.randint(1, VOCAB, (16,)).astype(np.int32)
    shared = [np.concatenate([system,
                              rs.randint(1, VOCAB, (n,)).astype(np.int32)])
              for n in (3, 4)]
    je = jff.make_serving_engine(paged_attention_impl="einsum", **ENGINE)
    te = tff.make_serving_engine(**ENGINE)
    je.set_telemetry_identity("famA", "parity")
    te.set_telemetry_identity("famA", "parity")
    j_reqs = je.run(prompts, 4) + je.run(shared[:1], 3) + \
        je.run(shared[1:], 3)
    t_reqs = te.run(prompts, 4) + te.run(shared[:1], 3) + \
        te.run(shared[1:], 3)
    assert [r.tokens for r in t_reqs] == [r.tokens for r in j_reqs]
    js, ts = _series(j_tm, "famA"), _series(t_tm, "famA")
    stats_fams = {f"ff_serving_{k}" for k in PORT_ONLY_STATS | JAX_ONLY_STATS}
    assert set(ts) - set(js) == {f"ff_serving_{k}" for k in PORT_ONLY_STATS}
    assert set(js) - set(ts) == {f"ff_serving_{k}" for k in JAX_ONLY_STATS}
    for name in set(ts) & set(js):
        assert ts[name] == js[name], name
    assert ts["ff_serving_ttft_seconds"][2] == [len(prompts) + 2]
    assert ts["ff_serving_intertoken_seconds"][2] == [
        len(prompts) * 3 + 2 * 2]
    assert ts["ff_serving_queue_wait_seconds"][2] == [len(prompts) + 2]
    assert "ff_serving_requests_total" in ts
    assert ts["ff_serving_engine_info"][1] == [
        ("impl", "kv_cache_dtype", "replica", "role", "weight_dtype")]
    assert not stats_fams & (set(ts) & set(js))
    # every request's tree: queue_wait + prefill + decode, connected
    for r in t_reqs:
        tree = t_tm.trace_tree(r.trace_id)
        assert {"queue_wait", "prefill", "decode"} <= set(tree["names"])
        decode = [e for e in tree["spans"] if e["name"] == "decode"][0]
        assert decode["args"]["state"] == "done"
        assert decode["args"]["tokens"] == len(r.tokens)
    kinds = [[e for e in t_tm.trace_tree(r.trace_id)["spans"]
              if e["name"] == "prefill"][0]["args"]
             for r in t_reqs[-2:]]
    assert kinds[0]["kind"] == "cold" and kinds[1]["kind"] == "hit"
    assert kinds[1]["matched_pages"] == 2
    text = t_tm.registry().to_prometheus()
    assert 'ff_serving_completed{replica="famA",role="parity"} 6' in text


def test_telemetry_off_same_tokens_and_programs(models):
    """telemetry="off": identical tokens, the same programs built, no
    span and no observation."""
    _, tff = models
    prompts = _prompts(7, [5, 9, 14])
    on = tff.make_serving_engine(**ENGINE)
    want = [r.tokens for r in on.run(prompts, 5)]
    prev = tff.config.telemetry
    tff.config.telemetry = "off"
    try:
        off = tff.make_serving_engine(**ENGINE)
        off.set_telemetry_identity("off0", "off-test")
        ring = len(t_tm.tracer())
        reqs = off.run(prompts, 5)
        assert [r.tokens for r in reqs] == want
        assert off.recompile_count == on.recompile_count
        assert sorted(off._programs, key=repr) == \
            sorted(on._programs, key=repr)
        assert not t_tm.tracer().events(trace_id=reqs[0].trace_id)
        assert len(t_tm.tracer()) == ring
        assert all(r.decode_span == 0 for r in reqs)
        assert "off0" not in t_tm.registry().to_prometheus()
    finally:
        tff.config.telemetry = prev


def test_router_trace_trees_failover_and_handoff(models, monkeypatch):
    """Through a router every request's tree is complete under its root;
    a crash-failover request keeps one tree with a resubmit annotation
    and spans on both replicas; a handed-off request's tree runs
    handoff_export on the prefill replica and handoff_import and decode
    on the decode replica; the fleet series carry replica / role
    labels."""
    _, tff = models
    router = tff.make_serving_router(replicas=1, start=False, **ENGINE)
    try:
        reqs = router.run(_prompts(11, [5, 9, 14]), max_new_tokens=4,
                          timeout=300)
        for r in reqs:
            tree = t_tm.trace_tree(r.trace_id)
            assert tree["complete"] and tree["root"]["name"] == "request"
            assert tree["root"]["args"]["state"] == "done"
            assert {"queue_wait", "prefill", "decode"} <= set(tree["names"])
            assert any(e["name"] == "dispatch" for e in tree["annotations"])
        assert {t["trace_id"] for t in router.recent_traces()} >= \
            {r.trace_id for r in reqs}
    finally:
        router.close()

    monkeypatch.setenv("FF_FAULT", "crash(2)@replica:0")
    t_faultinject.reset()
    router = tff.make_serving_router(replicas=2, decode_chunk=2,
                                     start=False, **ENGINE)
    try:
        reqs = router.run(_prompts(13, [6, 10, 15, 7, 11, 9, 8, 12, 5, 14]),
                          max_new_tokens=8, timeout=300)
        assert router.stats()["fenced"] == 1
        resub = [r for r in reqs if r.attempts == 2]
        assert resub
        for r in resub:
            tree = t_tm.trace_tree(r.trace_id)
            assert tree["complete"] and r.state == "done"
            assert "resubmit" in [e["name"] for e in tree["annotations"]]
        assert any(len({e["pid"] for e in t_tm.trace_tree(r.trace_id)[
            "spans"] if e["name"] == "prefill"}) == 2 for r in resub)
        assert any(e["args"]["kind"] == "crash"
                   for e in t_tm.fault_events())
        text = t_tm.registry().to_prometheus()
        assert 'ff_router_replica_up{replica="0",role="mixed"} 0' in text
        assert "ff_router_fenced" in text
    finally:
        router.close()
        monkeypatch.delenv("FF_FAULT", raising=False)
        t_faultinject.reset()

    router = tff.make_serving_router(replicas=2, roles=["prefill", "decode"],
                                     start=False, **ENGINE)
    try:
        rs = np.random.RandomState(17)
        system = rs.randint(1, VOCAB, (16,)).astype(np.int32)
        prompts = [np.concatenate(
            [system, rs.randint(1, VOCAB, (3,)).astype(np.int32)])
            for _ in range(3)]
        reqs = router.run(prompts, max_new_tokens=4, timeout=300)
        handed = [r for r in reqs if r.handoff]
        assert handed
        for r in handed:
            tree = t_tm.trace_tree(r.trace_id)
            assert tree["complete"]
            assert {"handoff_export", "handoff_import", "prefill",
                    "decode"} <= set(tree["names"])
            by = {e["name"]: e["pid"] for e in tree["spans"]}
            assert by["handoff_export"] == "replica0"
            assert by["decode"] == "replica1"
        text = t_tm.registry().to_prometheus()
        assert 'role="prefill"' in text and 'role="decode"' in text
    finally:
        router.close()
