"""The port's profiler (flexflow_tpu_torch/runtime/profiler.py) and
``FFModel.step_breakdown`` against the JAX package's, on a small CNN
(conv -> BatchNorm -> pool -> flat -> dense -> dropout -> dense, f32 on the
CPU) built in both packages:

  * ``profile_step``'s rows carry JAX's op names, types and output shapes;
  * ``export_taskgraph`` writes JAX's DOT text, byte for byte;
  * ``step_breakdown`` returns JAX's keys (merged over fit's breakdown),
    ``collective_instructions`` 0 as on JAX's one device, and leaves the
    weights, optimizer, BatchNorm and generator state bitwise as they were;
  * ``in_situ_op_summary`` puts forward and backward rows on JAX's ops;
  * ``FFConfig.profiling`` names every op's range in a profiled step and
    leaves the step's results bitwise; ``torch_trace`` writes a Chrome
    trace; ``export_sim_taskgraph`` raises ``not_ported``.
"""

import json

import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.runtime import profiler as jprof
from flexflow_tpu_torch.runtime import profiler


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(pkg, **cfg):
    if pkg is J:
        ff = J.FFModel(J.FFConfig(batch_size=4, seed=1,
                                  mesh_shape={"data": 1}, **cfg))
    else:
        ff = T.FFModel(T.FFConfig(batch_size=4, seed=1, **cfg),
                       device="cpu")
    x = ff.create_tensor([4, 3, 8, 8], name="img")
    t = ff.conv2d(x, 4, 3, 3, 1, 1, 1, 1, name="conv")
    t = ff.batch_norm(t, name="bn")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, 10, pkg.ActiMode.AC_MODE_RELU, name="fc")
    t = ff.dropout(t, 0.25, name="drop")
    t = ff.dense(t, 3, name="out")
    ff.compile(pkg.SGDOptimizer(lr=0.1),
               pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [pkg.MetricsType.METRICS_ACCURACY])
    return ff


def _batch():
    rs = np.random.RandomState(0)
    return {"img": rs.randn(4, 3, 8, 8).astype(np.float32),
            "label": rs.randint(0, 3, (4, 1)).astype(np.int32)}


@pytest.fixture(scope="module")
def models():
    return _build(J), _build(T)


def _state(ff):
    flat = []
    todo = [ff.params, ff.opt_state, ff.bn_state]
    while todo:
        x = todo.pop()
        if isinstance(x, dict):
            todo.extend(x[k] for k in sorted(x, key=str))
        elif isinstance(x, torch.Tensor):
            flat.append(x.detach().clone())
    gens = {k: g.get_state().clone() for k, g in ff._generators.items()}
    return flat, gens


def test_profile_step_rows_are_jax_rows(models):
    jff, tff = models
    key = lambda rows: sorted((r["op"], r["type"], tuple(r["output_shape"]))
                              for r in rows)
    got = profiler.profile_step(tff, _batch(), iters=1)
    assert key(got) == key(jprof.profile_step(jff, _batch(), iters=1))
    assert all(r["ms"] > 0 for r in got)
    assert [r["ms"] for r in got] == sorted((r["ms"] for r in got),
                                            reverse=True)


def test_export_taskgraph_is_jax_text(models, tmp_path):
    jff, tff = models
    jprof.export_taskgraph(jff, str(tmp_path / "j.dot"))
    profiler.export_taskgraph(tff, str(tmp_path / "t.dot"))
    assert (tmp_path / "t.dot").read_text() == \
        (tmp_path / "j.dot").read_text()


def test_step_breakdown_keys_and_state_untouched(models):
    jff, tff = models
    T.SingleDataLoader(tff, tff.get_op_by_name("img").outputs[0],
                       np.repeat(_batch()["img"], 2, axis=0))
    T.SingleDataLoader(tff, tff.label_tensor,
                       np.repeat(_batch()["label"], 2, axis=0))
    tff.fit(epochs=1, verbose=False)
    before, gens = _state(tff)
    step = tff._step_count
    got = tff.step_breakdown(iters=2)
    after, gens2 = _state(tff)
    assert len(before) == len(after)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    for k in gens:
        assert torch.equal(gens[k], gens2[k])
    assert tff._step_count == step
    want = jff.step_breakdown(_batch(), iters=1)
    assert set(want) <= set(got)
    # the rest is fit's breakdown, merged
    assert set(got) - set(want) <= {"host_wait", "h2d", "dispatch",
                                    "device", "steps", "wall_s", "overlap",
                                    "host_wait_fraction"}
    assert got["collective_instructions"] == \
        want["collective_instructions"] == 0
    assert got["collective_bytes"] == 0.0
    assert got["device_step_ms"] > 0 and got["epilogue_ms"] > 0
    assert 0 < got["epilogue_fraction"] <= 1
    assert got["grad_sync_overlapped"] is False


def test_in_situ_rows_on_jax_ops(models):
    jff, tff = models
    want = jprof.in_situ_op_summary(jff, jff.executor.shard_batch(_batch()))
    before, _ = _state(tff)
    got = profiler.in_situ_op_summary(tff, _batch())
    after, _ = _state(tff)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert {r["op"] for r in got} == {r["op"] for r in want}
    g = {r["op"]: r for r in got}
    for r in want:
        if r["fwd_instructions"]:
            assert g[r["op"]]["fwd_instructions"] > 0, r["op"]
        if r["bwd_instructions"]:
            assert g[r["op"]]["bwd_instructions"] > 0, r["op"]


def test_profiling_names_op_ranges_and_keeps_results():
    from torch.profiler import profile

    runs = []
    for prof_on in (False, True):
        ff = _build(T, profiling=prof_on)
        with profile() as prof:
            loss, _ = ff._run_train_step(_batch())
        names = {e.name for e in prof.events()}
        assert {"conv", "bn", "pool", "flat", "fc", "drop", "out"} <= names
        runs.append((loss, [w.clone() for ws in ff.params.values()
                            for w in ws.values()]))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_torch_trace_writes_chrome_trace(models, tmp_path):
    _, tff = models
    path = tmp_path / "trace.json"
    with profiler.torch_trace(str(path)):
        tff.predict({"img": _batch()["img"]})
    doc = json.loads(path.read_text())
    assert {e.get("name") for e in doc["traceEvents"]} >= {"conv", "out"}


def test_export_sim_taskgraph_not_ported(models, tmp_path):
    with pytest.raises(NotImplementedError, match="item 10"):
        profiler.export_sim_taskgraph(models[1], str(tmp_path / "s.dot"))
