"""The port's fault-tolerant training (``runtime/resilience.py``,
``runtime/checkpoint.py``, the ``FF_FAULT`` step drills), with the cases of
tests/test_resilience.py, against the JAX package's ``TrainSupervisor``.

The model is JAX's test MLP (8 -> 16 relu -> 4, batch 16, 64 samples):
built in both packages, the JAX-initialised weights copied into the port.
f32 on the CPU. Held:

  * the retry decorator's backoff and predicate; the watchdog's stack
    dump, its default abort of the main thread, its disarmed fast path;
  * a NaN step is skipped with weights and optimizer state bitwise
    untouched; backoff halves the loss scale; rewinds after consecutive
    NaNs, ``fit``'s rewind accounting, the livelock cap, a rewind with no
    checkpoint refused;
  * kill-and-resume (``sigterm@step``) and fit's auto-resume are bitwise
    the port's uninterrupted run;
  * under the same ``FF_FAULT`` plan the port's supervisor records the
    losses of JAX's within 1e-5 (relative; sums in other orders) and the
    same step accounting and counters;
  * ``hang@step`` trips the supervisor's watchdog;
  * restore-then-generate: a checkpoint of a trained Llama restored into a
    fresh model generates the tokens of the model that saved it, which
    are JAX's tokens from the same weights.
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

from flexflow_tpu import ActiMode as JActi
from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import LossType as JLoss
from flexflow_tpu import MetricsType as JMetrics
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu import SingleDataLoader as JLoader
from flexflow_tpu import TrainSupervisor as JSupervisor
from flexflow_tpu.runtime import faultinject as j_faultinject
from flexflow_tpu.runtime import resilience as j_resilience
from flexflow_tpu_torch import (ActiMode, FFConfig, FFModel, LossType,
                                MetricsType, SGDOptimizer, SingleDataLoader)
from flexflow_tpu_torch.runtime import faultinject, resilience
from flexflow_tpu_torch.runtime.checkpoint import (latest_step, load_meta,
                                                   restore_checkpoint,
                                                   save_checkpoint)
from flexflow_tpu_torch.runtime.faultinject import FaultPlan
from flexflow_tpu_torch.runtime.resilience import TrainSupervisor

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_fault_state(monkeypatch):
    monkeypatch.delenv("FF_FAULT", raising=False)
    faultinject.reset()
    j_faultinject.reset()
    resilience.reset_counters()
    j_resilience.reset_counters()
    yield
    faultinject.reset()
    j_faultinject.reset()


def _data(n=64):
    rs = np.random.RandomState(7)
    return (rs.randn(n, 8).astype(np.float32),
            rs.randint(0, 4, (n, 1)).astype(np.int32))


def _cfg(ckpt_dir, on_nonfinite, rewind_after, checkpoint_every, keep, seed):
    return dict(batch_size=16, epochs=1, seed=seed,
                checkpoint_dir=str(ckpt_dir),
                checkpoint_every=checkpoint_every, keep_checkpoints=keep,
                on_nonfinite=on_nonfinite,
                nonfinite_rewind_after=rewind_after)


def _jax(ckpt_dir="", *, on_nonfinite="skip", rewind_after=0,
         checkpoint_every=0, keep=3, seed=3):
    ff = JModel(JConfig(mesh_shape={"data": 1},
                        **_cfg(ckpt_dir, on_nonfinite, rewind_after,
                               checkpoint_every, keep, seed)))
    x = ff.create_tensor([16, 8], name="x")
    t = ff.dense(x, 16, JActi.AC_MODE_RELU, name="fc1")
    ff.dense(t, 4, name="out")
    ff.compile(JSGD(lr=0.1), JLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [JMetrics.METRICS_ACCURACY])
    xs, ys = _data()
    JLoader(ff, x, xs)
    JLoader(ff, ff.label_tensor, ys)
    return ff


_INIT = {}


def _jax_init():
    """JAX's initial weights of the test MLP (seed 3), as numpy."""
    if not _INIT:
        jff = _jax()
        _INIT.update({op: {w: np.asarray(a) for w, a in ws.items()}
                      for op, ws in jff.params.items()})
    return _INIT


def _build(ckpt_dir="", *, on_nonfinite="skip", rewind_after=0,
           checkpoint_every=0, keep=3, seed=3):
    """The port's MLP with JAX's initial weights (written in place)."""
    ff = FFModel(FFConfig(**_cfg(ckpt_dir, on_nonfinite, rewind_after,
                                 checkpoint_every, keep, seed)),
                 device="cpu")
    x = ff.create_tensor([16, 8], name="x")
    t = ff.dense(x, 16, ActiMode.AC_MODE_RELU, name="fc1")
    ff.dense(t, 4, name="out")
    ff.compile(SGDOptimizer(lr=0.1),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY])
    for op, ws in _jax_init().items():
        for w, a in ws.items():
            ff.set_weights(op, w, a.copy())
    xs, ys = _data()
    SingleDataLoader(ff, x, xs)
    SingleDataLoader(ff, ff.label_tensor, ys)
    return ff


def _arm(monkeypatch, spec):
    if spec:
        monkeypatch.setenv("FF_FAULT", spec)
    else:
        monkeypatch.delenv("FF_FAULT", raising=False)
    faultinject.reset()
    j_faultinject.reset()


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=RTOL)


# ------------------------------------------------------------ retry


def test_retry_decorator_backoff_and_predicates():
    sleeps, calls = [], []

    @resilience.retry(attempts=3, base_delay=0.01, retryable=(ValueError,),
                      sleep=sleeps.append)
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError("transient")
        return "ok"

    assert flaky() == "ok"
    assert len(calls) == 3 and sleeps == [0.01, 0.02]
    assert resilience.COUNTERS["retries"] == 2

    @resilience.retry(attempts=3, base_delay=0.01, retryable=(ValueError,),
                      sleep=sleeps.append)
    def wrong_kind():
        raise KeyError("not retryable")

    with pytest.raises(KeyError):
        wrong_kind()
    with pytest.raises(ValueError, match="attempts"):
        resilience.retry(attempts=0)


def test_retry_on_injected_save_failure(tmp_path, monkeypatch):
    ff = _build(tmp_path)
    sup = TrainSupervisor(ff, str(tmp_path))
    sup.step()
    _arm(monkeypatch, "io_fail@save:1-3")
    with pytest.raises(OSError):
        sup.save(reason="test")
    assert latest_step(str(tmp_path)) is None
    _arm(monkeypatch, "io_fail@save:1")
    resilience.reset_counters()
    sup.save(reason="test")
    assert resilience.COUNTERS["retries"] == 1
    assert latest_step(str(tmp_path)) == 1


# ------------------------------------------------------------ watchdog


def test_watchdog_dumps_and_calls_on_timeout(tmp_path):
    dump = tmp_path / "dump.txt"
    fired = []
    wd = resilience.Watchdog(0.1, on_timeout=fired.append,
                             dump_path=str(dump))
    with wd.arm("slow step"):
        time.sleep(0.35)
    assert fired == ["slow step"] and wd.fired
    text = dump.read_text()
    assert "watchdog" in text and "Current thread" in text
    assert resilience.COUNTERS["watchdog_fires"] == 1


def test_watchdog_default_aborts_main_thread():
    wd = resilience.Watchdog(0.1)
    with pytest.raises(KeyboardInterrupt):
        with wd.arm("hung collective"):
            time.sleep(0.5)


def test_watchdog_disarmed_and_fast_path():
    wd = resilience.Watchdog(0.0)
    with wd.arm("x"):
        pass
    wd = resilience.Watchdog(5.0)
    with wd.arm("y"):
        pass
    assert not wd.fired
    assert resilience.COUNTERS["watchdog_fires"] == 0


def test_hang_injection_trips_supervisor_watchdog(tmp_path):
    ff = _build(tmp_path)
    sup = TrainSupervisor(ff, str(tmp_path), step_timeout_s=0.15,
                          faults=FaultPlan.parse("hang@step:2"))
    with pytest.raises(KeyboardInterrupt):
        sup.run(3)
    assert resilience.COUNTERS["watchdog_fires"] == 1
    assert sup.watchdog.fired and ff._step_count == 2


# ------------------------------------------------------------ the guard


def test_nan_injection_skips_step_state_untouched(tmp_path):
    ff = _build(tmp_path)
    sup = TrainSupervisor(ff, str(tmp_path),
                          faults=FaultPlan.parse("nan_loss@step:3"))
    for _ in range(2):
        sup.step(), sup.after_step()
    w = ff.params["fc1"]["kernel"].clone()
    t = ff.opt_state["t"].clone()
    sup.step()   # step 3: the injected NaN
    assert np.isnan(sup.losses[-1])
    assert torch.equal(ff.params["fc1"]["kernel"], w)
    assert torch.equal(ff.opt_state["t"], t)
    assert int(ff._guard_state["skipped"]) == 1
    assert int(ff._guard_state["bad_streak"]) == 1
    sup.after_step()
    assert resilience.COUNTERS["steps_skipped"] == 1
    sup.step(), sup.after_step()
    assert np.isfinite(sup.losses[-1])
    assert int(ff._guard_state["bad_streak"]) == 0
    assert not torch.equal(ff.params["fc1"]["kernel"], w)


def test_backoff_mode_halves_loss_scale(tmp_path):
    ff = _build(tmp_path, on_nonfinite="backoff")
    sup = TrainSupervisor(ff, str(tmp_path),
                          faults=FaultPlan.parse("nan_loss@step:2"))
    sup.step()
    assert float(ff._guard_state["loss_scale"]) == 1.0
    sup.step()
    assert float(ff._guard_state["loss_scale"]) == 0.5
    sup.step()
    assert float(ff._guard_state["loss_scale"]) == 0.5
    assert np.isfinite(sup.losses[-1])


# ------------------------------------------------------------ rewind


def test_rewind_after_consecutive_nans(tmp_path):
    ff = _build(tmp_path, rewind_after=2, checkpoint_every=2)
    sup = TrainSupervisor(
        ff, str(tmp_path),
        faults=FaultPlan.parse("nan_loss@step:3,nan_loss@step:4"))
    assert sup.run(6) == "completed"
    assert resilience.COUNTERS["rewinds"] == 1
    assert ff._step_count == 6
    assert len(sup.losses) == 6 and np.isfinite(sup.losses).all()
    clean = _build(tmp_path / "clean", rewind_after=2, checkpoint_every=2)
    csup = TrainSupervisor(clean, str(tmp_path / "clean"))
    assert csup.run(6) == "completed"
    assert sup.losses == csup.losses
    # a rewind after a resume truncates losses relative to the resume
    sup2 = TrainSupervisor(
        ff, str(tmp_path), rewind_after=2, checkpoint_every=0,
        faults=FaultPlan.parse("nan_loss@step:8,nan_loss@step:9"))
    assert sup2.run(10) == "completed"
    assert resilience.COUNTERS["rewinds"] == 2
    assert len(sup2.losses) == 4 and np.isfinite(sup2.losses).all()
    csup2 = TrainSupervisor(clean, str(tmp_path / "clean"), rewind_after=2,
                            checkpoint_every=0)
    assert csup2.run(10) == "completed"
    assert sup2.losses == csup2.losses
    # the livelock cap
    sup3 = TrainSupervisor(ff, str(tmp_path), max_rewinds=2)
    sup3.rewind()
    sup3.rewind()
    with pytest.raises(RuntimeError, match="livelock"):
        sup3.rewind()


def test_fit_rewind_step_accounting(tmp_path, monkeypatch):
    """1 epoch x 4 batches, a checkpoint at step 1 (then every 2), NaN at
    step 3 with rewind_after=1: the rewound steps replay and the epoch
    ends at step 4, as JAX's fit."""
    _arm(monkeypatch, "nan_loss@step:3")
    ff = _build(tmp_path, rewind_after=1, checkpoint_every=2)
    ff.fit(verbose=False)
    assert resilience.COUNTERS["rewinds"] == 1
    assert ff._step_count == 4
    _arm(monkeypatch, "nan_loss@step:3")
    jff = _jax(tmp_path / "jax", rewind_after=1, checkpoint_every=2)
    jff.fit(verbose=False)
    assert j_resilience.COUNTERS["rewinds"] == 1
    assert jff._step_count == ff._step_count


def test_rewind_without_checkpoint_raises(tmp_path):
    ff = _build(tmp_path)
    sup = TrainSupervisor(ff, str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="no checkpoint"):
        sup.rewind()


# ------------------------------------------------------------ preemption


def test_kill_and_resume_bitwise_identical(tmp_path, monkeypatch):
    ff_a = _build(tmp_path / "a")
    sup_a = TrainSupervisor(ff_a, str(tmp_path / "a"))
    assert sup_a.run(15) == "completed"
    assert len(sup_a.losses) == 15
    _arm(monkeypatch, "sigterm@step:9")
    prev = signal.getsignal(signal.SIGTERM)
    ff_b = _build(tmp_path / "b")
    sup_b = TrainSupervisor(ff_b, str(tmp_path / "b"))
    assert sup_b.run(15) == "preempted"
    assert ff_b._step_count == 9
    assert latest_step(str(tmp_path / "b")) == 9
    assert load_meta(str(tmp_path / "b"), 9)["reason"] == "preempt"
    assert signal.getsignal(signal.SIGTERM) == prev
    assert resilience.COUNTERS["preempt_stops"] == 1
    assert sup_b.losses == sup_a.losses[:9]
    _arm(monkeypatch, "")
    ff_c = _build(tmp_path / "b")
    sup_c = TrainSupervisor(ff_c, str(tmp_path / "b"))
    assert sup_c.run(15) == "completed"
    assert resilience.COUNTERS["resumes"] == 1
    assert sup_c.losses == sup_a.losses[9:]
    for op, ws in ff_a.params.items():
        for w, t in ws.items():
            assert torch.equal(ff_c.params[op][w], t), f"{op}.{w}"


def test_fit_auto_resume_and_preemption(tmp_path, monkeypatch):
    """2 epochs x 4 batches; preempted after step 5 (mid-epoch 2); a fresh
    model's fit resumes and ends bitwise a plain 2-epoch fit."""
    _arm(monkeypatch, "sigterm@step:5")
    ff = _build(tmp_path, checkpoint_every=4)
    ff.config.epochs = 2
    ff.fit(verbose=False)
    assert ff._step_count == 5 and ff.last_fit_status == "preempted"
    assert latest_step(str(tmp_path)) == 5
    _arm(monkeypatch, "")
    ff2 = _build(tmp_path, checkpoint_every=4)
    ff2.config.epochs = 2
    ff2.fit(verbose=False)
    assert ff2._step_count == 8 and ff2.last_fit_status == "completed"
    ref = _build("")
    ref.config.epochs = 2
    ref.fit(verbose=False)
    for op, ws in ref.params.items():
        for w, t in ws.items():
            assert torch.equal(ff2.params[op][w], t), f"{op}.{w}"


@pytest.mark.parametrize("plan, steps", [
    ("sigterm@step:9", 15),
    ("nan_loss@step:3,nan_loss@step:4", 6),
    ("nan_loss@step:2,io_fail@save:2", 5),
], ids=["sigterm", "rewind", "nan_io_fail"])
def test_supervisor_matches_jax_under_fault_plan(tmp_path, monkeypatch,
                                                 plan, steps):
    """The same FF_FAULT plan through both packages' supervisors (rewind
    after 2, a checkpoint every 2 steps): the recorded losses agree within
    1e-5, and the status, step count, the checkpoint steps on disk and the
    counters are equal; a preempted run resumed by a fresh model agrees
    too."""
    out = {}
    for pkg in ("jax", "port"):
        _arm(monkeypatch, plan)
        build = _jax if pkg == "jax" else _build
        sup_cls = JSupervisor if pkg == "jax" else TrainSupervisor
        counters = j_resilience if pkg == "jax" else resilience
        counters.reset_counters()
        d = tmp_path / pkg
        ff = build(d, rewind_after=2, checkpoint_every=2)
        sup = sup_cls(ff, str(d))
        status = sup.run(steps)
        losses = list(sup.losses)
        if status == "preempted":
            _arm(monkeypatch, "")
            ff = build(d, rewind_after=2, checkpoint_every=2)
            sup = sup_cls(ff, str(d))
            assert sup.run(steps) == "completed"
            losses += sup.losses
        out[pkg] = dict(status=status, steps=ff._step_count, losses=losses,
                        dirs=sorted(n for n in os.listdir(d)
                                    if n.startswith("step_")),
                        counters={k: v for k, v in
                                  counters.counters().items() if v},
                        w=np.asarray(ff.get_weights("fc1")))
    j, t = out["jax"], out["port"]
    assert t["status"] == j["status"]
    assert t["steps"] == j["steps"] == steps
    assert len(t["losses"]) == len(j["losses"])
    _close(t["losses"], j["losses"])
    assert t["dirs"] == j["dirs"]
    assert t["counters"] == j["counters"]
    _close(t["w"], j["w"])


# ------------------------------------------------------------ generate


def test_checkpoint_restore_then_generate(tmp_path):
    """Train a small Llama 3 steps, checkpoint, restore into a FRESH model
    (another seed), generate: the tokens equal the saving model's, and
    JAX's from the same trained weights."""
    from flexflow_tpu.models.llama import llama_lm as j_llama
    from flexflow_tpu_torch.models import llama_lm

    vocab = 61
    arch = dict(seq_len=8, hidden=64, layers=2, heads=4, kv_heads=2,
                vocab_size=vocab)

    def build(seed):
        ff = FFModel(FFConfig(batch_size=4, seed=seed), device="cpu")
        _, logits = llama_lm(ff, 4, **arch)
        ff.compile(SGDOptimizer(lr=0.1),
                   LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   [MetricsType.METRICS_ACCURACY], final_tensor=logits)
        return ff

    rs = np.random.RandomState(29)
    ff = build(0)
    batch = {"input": rs.randint(0, vocab, (4, 8)).astype(np.int32),
             "label": rs.randint(0, vocab, (4, 8, 1)).astype(np.int32)}
    for _ in range(3):
        ff._run_train_step(batch)
    save_checkpoint(ff, str(tmp_path), step=3)
    prompt = rs.randint(0, vocab, (2, 5)).astype(np.int32)
    want = ff.generate(prompt, max_new_tokens=5)
    ff2 = build(1)
    op0 = next(iter(ff.params))
    assert not torch.equal(ff2.params[op0]["kernel"],
                           ff.params[op0]["kernel"])
    assert restore_checkpoint(ff2, str(tmp_path), step=3) == 3
    got = ff2.generate(prompt, max_new_tokens=5)
    np.testing.assert_array_equal(got, want)
    jff = JModel(JConfig(batch_size=4, mesh_shape={"data": 1}))
    _, jlogits = j_llama(jff, 4, **arch)
    jff.compile(final_tensor=jlogits)
    jff.params = {op: {w: ff2.get_weights(op, w) for w in ws}
                  for op, ws in jff.params.items()}
    np.testing.assert_array_equal(
        np.asarray(jff.generate(prompt, max_new_tokens=5)), got)
