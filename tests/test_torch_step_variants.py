"""The training step's variants in the PyTorch port, against the JAX
package and against the port's own per-step path: gradient accumulation,
the divergence-guarded step and the scanned steps (``train_scanned`` and
``fit`` with ``scan_steps``).

f32 on the CPU (the scanned steps run as a plain loop there; the CUDA
graph replay is held to the per-step path on the card by
tests/test_torch_cuda.py and chip_smoke.py). The JAX-initialised weights
are carried into the port. Tolerances: against JAX, weights 1e-5 of the
largest weight and losses 1e-5 relative (sums of products in other
orders); grad-norm 1e-5 relative (per-leaf sums in other orders);
accumulation 2 against the full-batch step 1e-6 of the largest weight (the
microbatches' gradients summed, then halved, where the full batch sums
once); the port against itself (guarded vs unguarded, scanned vs
per-step): bitwise.
"""

import logging

import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import LossType as JLoss
from flexflow_tpu import MetricsType as JMetrics
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu import SingleDataLoader as JLoader
from flexflow_tpu.models.transformer import \
    build_encoder_classifier as j_build
from flexflow_tpu_torch import (FFConfig, FFModel, LossType, MetricsType,
                                SGDOptimizer, SingleDataLoader)
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import build_encoder_classifier

B, S, HIDDEN, LAYERS, HEADS, CLASSES = 4, 16, 64, 1, 4, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _data(seed: int, n: int):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, S, HIDDEN).astype(np.float32),
            rs.randint(0, CLASSES, (n, 1)).astype(np.int32))


def _np_tree(params):
    return {op: {w: np.asarray(a) for w, a in ws.items()}
            for op, ws in params.items()}


def _jax_model(**cfg):
    jff = JModel(JConfig(batch_size=B, mesh_shape={"data": 1}, seed=1,
                         **cfg))
    x, out = j_build(jff, B, S, HIDDEN, LAYERS, HEADS, num_classes=CLASSES)
    jff.compile(JSGD(lr=0.05, momentum=0.9),
                JLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                [JMetrics.METRICS_ACCURACY], final_tensor=out)
    return jff, x


def _port_model(init=None, **cfg):
    ff = FFModel(FFConfig(batch_size=B, seed=1, **cfg), device="cpu")
    x, out = build_encoder_classifier(ff, B, S, HIDDEN, LAYERS, HEADS,
                                      num_classes=CLASSES)
    ff.compile(SGDOptimizer(lr=0.05, momentum=0.9),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY], final_tensor=out)
    if init is not None:
        ff.params = params_from_jax(init, "cpu", torch.float32, model=ff)
        ff.opt_state = ff.optimizer.init_state(ff.params)
    return ff, x


def _same_weights(a, b):
    return all(torch.equal(w, b.params[op][k])
               for op, ws in a.params.items() for k, w in ws.items())


def _close_to_jax(tff, jff, rel=1e-5):
    want = _np_tree(jff.params)
    wmax = max(np.abs(a).max() for ws in want.values() for a in ws.values())
    for op, ws in want.items():
        for w, ref in ws.items():
            np.testing.assert_allclose(tff.params[op][w].detach().numpy(),
                                       ref, rtol=0, atol=rel * wmax,
                                       err_msg=f"{op}.{w}")


def _batch(seed, n=B):
    x, y = _data(seed, n)
    return {"input": x, "label": y}


# ---- gradient accumulation ----------------------------------------------------


def test_accumulation_matches_jax_and_the_full_batch_step():
    """grad_accum_steps=2: three steps against JAX's accumulation (weights,
    losses, summed accuracy counts and totals), and against the port's
    full-batch step from the same weights."""
    jff, _ = _jax_model(grad_accum_steps=2)
    init = _np_tree(jff.params)
    tff, _ = _port_model(init, grad_accum_steps=2)
    full, _ = _port_model(init)
    for i in range(3):
        b = _batch(20 + i)
        jl, jm = jff._run_train_step(b)
        tl, tm = tff._run_train_step(b)
        fl, _ = full._run_train_step(b)
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
        np.testing.assert_allclose(float(tl), float(fl), **TOL)
        assert int(tm["accuracy_count"]) == int(jm["accuracy_count"])
        assert int(tm["accuracy_total"]) == int(jm["accuracy_total"]) == B
    _close_to_jax(tff, jff)
    wmax = max(w.abs().max().item() for ws in full.params.values()
               for w in ws.values())
    for op, ws in full.params.items():
        for k, w in ws.items():
            torch.testing.assert_close(tff.params[op][k], w, rtol=0,
                                       atol=1e-6 * wmax)


def test_accumulation_refuses_a_batch_it_cannot_split():
    with pytest.raises(ValueError, match="not divisible"):
        FFConfig(batch_size=6, grad_accum_steps=4)
    tff, _ = _port_model(grad_accum_steps=2)
    with pytest.raises(ValueError, match="grad_accum_steps=2"):
        tff._run_train_step(_batch(25, n=3))


def test_accumulation_in_bf16_carries_f32_grads():
    """bf16 weights: the microbatches' gradients sum in f32 and reach the
    update as f32 (the fused update buckets them by their weights'
    dtype): fused and per-leaf models stay bitwise equal."""
    xs, ys = _data(26, 3 * B)
    models = []
    for fused in (False, True):
        ff, x = _port_model(grad_accum_steps=2, master_dtype="bfloat16",
                            fused_optimizer=fused)
        SingleDataLoader(ff, x, xs)
        SingleDataLoader(ff, ff.label_tensor, ys)
        ff.fit(verbose=False)
        models.append(ff)
    assert _same_weights(*models)
    assert all(w.dtype == torch.bfloat16 and torch.isfinite(w).all()
               for ws in models[0].params.values() for w in ws.values())


# ---- the divergence guard ---------------------------------------------------------


def test_guarded_step_is_bitwise_unguarded_while_finite():
    """loss_scale 1.0 and finite steps: the guarded trajectory is the
    unguarded one bit for bit, fused optimizer or not."""
    for fused in (False, True):
        plain, _ = _port_model(fused_optimizer=fused)
        init = {op: {k: w.detach().numpy().copy() for k, w in ws.items()}
                for op, ws in plain.params.items()}
        guarded, _ = _port_model(init, on_nonfinite="skip",
                                 fused_optimizer=fused)
        plain, _ = _port_model(init, fused_optimizer=fused)
        for i in range(3):
            b = _batch(30 + i)
            lp, _ = plain._run_train_step(b)
            lg, mg = guarded._run_train_step(b)
            assert torch.equal(lp, lg)
            assert int(mg["nonfinite"]) == 0
        assert _same_weights(plain, guarded)


def test_skipped_step_changes_nothing_and_metrics_match_jax():
    """skip mode, one injected NaN step between finite ones: the skipped
    step leaves weights, optimizer state and the step counter bitwise
    untouched, and every step's loss and guard metrics match JAX's
    (grad-norm within 1e-5 relative)."""
    jff, _ = _jax_model(on_nonfinite="skip")
    init = _np_tree(jff.params)
    tff, _ = _port_model(init, on_nonfinite="skip")
    for i in range(4):
        nan = i == 2
        b = _batch(40 + i)
        if nan:
            before = {op: {k: w.clone() for k, w in ws.items()}
                      for op, ws in tff.params.items()}
            v = {op: {k: w.clone() for k, w in ws.items()}
                 for op, ws in tff.opt_state["v"].items()}
            t = int(tff.opt_state["t"])
        jl, jm = jff._run_train_step(b, inject_nan=nan)
        tl, tm = tff._run_train_step(b, inject_nan=nan)
        if nan:
            assert np.isnan(float(tl)) and np.isnan(float(jl))
            assert all(torch.equal(w, before[op][k])
                       for op, ws in tff.params.items()
                       for k, w in ws.items())
            assert all(torch.equal(w, v[op][k])
                       for op, ws in tff.opt_state["v"].items()
                       for k, w in ws.items())
            assert int(tff.opt_state["t"]) == t
        else:
            np.testing.assert_allclose(float(tl), float(jl), **TOL)
        for k in ("nonfinite", "skipped_total"):
            assert int(tm[k]) == int(jm[k]), k
        assert float(tm["loss_scale"]) == float(jm["loss_scale"]) == 1.0
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert int(tff._guard_state["skipped"]) == 1
    _close_to_jax(tff, jff)


def test_backoff_halves_the_scale_and_regrows_like_jax():
    """backoff mode from loss scale 8 with growth interval 2: a NaN step
    halves the scale, two clean steps double it; scale, streaks and skip
    count match JAX's step by step."""
    cfg = dict(on_nonfinite="backoff", loss_scale=8.0,
               loss_scale_growth_interval=2)
    jff, _ = _jax_model(**cfg)
    tff, _ = _port_model(_np_tree(jff.params), **cfg)
    scales = []
    for i, nan in enumerate((False, True, False, False, True)):
        b = _batch(50 + i)
        _, jm = jff._run_train_step(b, inject_nan=nan)
        _, tm = tff._run_train_step(b, inject_nan=nan)
        scales.append(float(tm["loss_scale"]))
        assert float(tm["loss_scale"]) == float(jm["loss_scale"])
        assert int(tm["skipped_total"]) == int(jm["skipped_total"])
        for k in ("bad_streak", "good_streak"):
            assert int(tff._guard_state[k]) == int(jff._guard_state[k]), k
    assert scales == [8.0, 4.0, 4.0, 8.0, 4.0]
    _close_to_jax(tff, jff)


def test_guard_with_accumulation_warns_and_trains_unguarded(caplog):
    with caplog.at_level(logging.WARNING):
        tff, _ = _port_model(on_nonfinite="skip", grad_accum_steps=2)
    assert "unguarded" in caplog.text
    assert tff._guard is None
    with pytest.raises(RuntimeError, match="on_nonfinite"):
        tff._run_train_step(_batch(60), inject_nan=True)


def test_guard_config_is_validated():
    for bad in (dict(loss_scale=0.0), dict(loss_scale_growth_interval=0),
                dict(on_nonfinite="retry")):
        with pytest.raises(ValueError):
            FFConfig(**bad)


# ---- scanned steps -------------------------------------------------------------------


def _loaded(n_samples, seed=70, **cfg):
    xs, ys = _data(seed, n_samples)
    ff, x = _port_model(**cfg)
    SingleDataLoader(ff, x, xs)
    SingleDataLoader(ff, ff.label_tensor, ys)
    return ff, xs, ys


def test_train_scanned_matches_per_step_and_jax():
    """train_scanned(5) over 3 batches (wrapping) against five per-step
    steps from the same weights (bitwise, losses and metrics stacked (5,))
    and against JAX's train_scanned (weights and losses within 1e-5)."""
    xs, ys = _data(71, 3 * B)
    jff, jx = _jax_model()
    JLoader(jff, jx, xs)
    JLoader(jff, jff.label_tensor, ys)
    init = _np_tree(jff.params)
    scan, tx = _port_model(init)
    SingleDataLoader(scan, tx, xs)
    SingleDataLoader(scan, scan.label_tensor, ys)
    per, px = _port_model(init)
    SingleDataLoader(per, px, xs)
    SingleDataLoader(per, per.label_tensor, ys)
    losses, mets = scan.train_scanned(5)
    assert losses.shape == (5,) and mets["accuracy_count"].shape == (5,)
    ref = [per._run_train_step(per._stage_batch())[0] for _ in range(5)]
    assert torch.equal(losses, torch.stack(ref))
    assert _same_weights(scan, per)
    assert scan._step_count == 5
    jlosses, _ = jff.train_scanned(5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
    _close_to_jax(scan, jff)


def test_scan_cursor_interleaves_with_per_step():
    """A per-step step, a scanned pair, a per-step step: the batch order
    is the per-step path's (0, 1, 2, 3 mod 3) and the loaders' cursors
    follow the scan."""
    scan, _, _ = _loaded(3 * B)
    per, _, _ = _loaded(3 * B)
    per.params = {op: {k: w.detach().clone() for k, w in ws.items()}
                  for op, ws in scan.params.items()}
    per.opt_state = per.optimizer.init_state(per.params)
    got = [scan._run_train_step(scan._stage_batch())[0]]
    got += list(scan.train_scanned(2)[0])
    assert scan._dataloaders[0].next_index == 0   # 3 % 3 batches
    got.append(scan._run_train_step(scan._stage_batch())[0])
    ref = [per._run_train_step(per._stage_batch())[0] for _ in range(4)]
    assert torch.equal(torch.stack(got), torch.stack(ref))
    assert _same_weights(scan, per)


def test_fit_scans_in_chunks_with_a_ragged_tail(capsys):
    """fit with scan_steps=2 over 5 batches: two scanned chunks and one
    per-step tail step an epoch, bitwise the per-step fit, with the same
    epoch metrics."""
    scan, _, _ = _loaded(5 * B + 1, seed=72, scan_steps=2)
    per, _, _ = _loaded(5 * B + 1, seed=72)
    per.params = {op: {k: w.detach().clone() for k, w in ws.items()}
                  for op, ws in scan.params.items()}
    per.opt_state = per.optimizer.init_state(per.params)
    calls = []
    run = scan.train_scanned
    scan.train_scanned = lambda n: calls.append(n) or run(n)
    p_scan = scan.fit(epochs=2, verbose=False)
    p_per = per.fit(epochs=2, verbose=False)
    assert calls == [2, 2, 2, 2]
    assert scan._step_count == per._step_count == 10
    assert _same_weights(scan, per)
    assert (p_scan.train_all, p_scan.train_correct) == \
        (p_per.train_all, p_per.train_correct)
    assert p_scan.train_pred_total == p_per.train_pred_total == 5 * B


def test_scan_is_ineligible_under_the_guard():
    ff, _, _ = _loaded(2 * B, on_nonfinite="skip", scan_steps=2)
    with pytest.raises(RuntimeError, match="divergence guard"):
        ff.train_scanned(2)
    with pytest.raises(ValueError, match="n_steps"):
        ff.train_scanned(0)
    ff.fit(verbose=False)          # fit falls back to per-step
    assert ff._step_count == 2
