"""The training slice of the PyTorch port end to end, against the JAX
package.

The flagship encoder classifier (``build_encoder_classifier``: hidden 128,
2 layers, 4 heads of 32, seq 32, batch 4, 16 classes, f32) is built in
both packages with ``use_fused_ln`` on and off; the JAX-initialised weights
are carried into the port with ``params_from_jax``. The JAX side runs with
``FF_FORCE_FLASH_ATTENTION=1``, so its attention forward and backward go
through the Pallas flash kernels and its fused add + LayerNorm through the
Pallas kernel, all in interpret mode. On the CPU the port runs its plain
branches (the einsum attention, the f32-stats add + LayerNorm) under
torch autograd; the CUDA kernels themselves are held to those on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Compared: logits, loss, the gradient of every weight, every weight after
three SGD steps through ``fit`` (with momentum 0.9 in the fused case,
plain in the unfused one), and ``evaluate``'s loss and accuracy count.
Tolerances, f32: logits and loss 1e-5; gradients 1e-4 of each weight's largest gradient plus 1e-6 (sums of
up to 128 products in other orders); weights after three steps 1e-5
(lr 0.05 times those gradient differences).
"""

import jax
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

B, S, HIDDEN, LAYERS, HEADS, CLASSES = 4, 32, 128, 2, 4, 16
STEPS = 3
LR = 0.05
TOL = dict(rtol=1e-5, atol=1e-5)


def _data(seed: int, n: int):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, S, HIDDEN).astype(np.float32),
            rs.randint(0, CLASSES, (n, 1)).astype(np.int32))


def _jax_model(fused: bool, momentum: float):
    ff = JModel(JConfig(batch_size=B, mesh_shape={"data": 1}, seed=2,
                        use_fused_ln=fused))
    x, out = j_build(ff, B, S, HIDDEN, LAYERS, HEADS, num_classes=CLASSES)
    ff.compile(JSGD(lr=LR, momentum=momentum),
               JLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [JMetrics.METRICS_ACCURACY], final_tensor=out)
    return ff, x, out


def _port_model(fused: bool, momentum: float, jparams):
    ff = FFModel(FFConfig(batch_size=B, seed=2, use_fused_ln=fused),
                 device="cpu")
    x, out = build_encoder_classifier(ff, B, S, HIDDEN, LAYERS, HEADS,
                                      num_classes=CLASSES)
    ff.compile(SGDOptimizer(lr=LR, momentum=momentum),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY], final_tensor=out)
    ff.params = params_from_jax(jparams, "cpu", torch.float32, model=ff)
    ff.opt_state = ff.optimizer.init_state(ff.params)
    return ff, x, out


def _np_tree(params):
    return {op: {w: np.asarray(a) for w, a in ws.items()}
            for op, ws in params.items()}


@pytest.fixture(scope="module", params=[(True, 0.9), (False, 0.0)],
                ids=["fused_ln-momentum", "unfused_ln-sgd"])
def pair(request):
    """(JAX model, port model, JAX's initial weights, output tensors, input
    tensors) for one lowering of the residual add + LayerNorm pairs and
    one SGD momentum, at initialisation."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FF_FORCE_FLASH_ATTENTION", "1")
    fused, momentum = request.param
    jff, jx, jout = _jax_model(fused, momentum)
    init = _np_tree(jff.params)
    tff, tx, tout = _port_model(fused, momentum, init)
    yield jff, tff, init, jout, tout, jx, tx
    mp.undo()


def test_fused_graph_uses_the_kernel_ops(pair):
    jff, tff = pair[:2]
    names = [op.name for op in tff.ops]
    assert names == [op.name for op in jff.ops]
    fused = any(type(op).__name__ == "AddLayerNorm" for op in tff.ops)
    assert fused == tff.config.use_fused_ln
    assert tff.weight_shapes() == {
        op: {w: tuple(a.shape) for w, a in ws.items()}
        for op, ws in pair[2].items()}


def test_logits_and_loss_match_jax(pair):
    jff, tff, _, jout, tout = pair[:5]
    x, y = _data(0, B)
    jlogits = jff.executor.make_forward([jout])(
        jff.params, jff.bn_state, {"input": x})[0]
    tlogits = tff.executor.forward(tff.params, tff._to_device({"input": x}),
                                   [tout])[0]
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    jloss, jmets, _ = jff.evaluate({"input": x, "label": y})
    tloss, tmets, _ = tff.evaluate({"input": x, "label": y})
    np.testing.assert_allclose(tloss, jloss, **TOL)
    assert tmets["accuracy_count"] == jmets["accuracy_count"]
    assert tmets["accuracy_total"] == jmets["accuracy_total"] == B


def test_every_gradient_matches_jax(pair):
    jff, tff = pair[:2]
    x, y = _data(1, B)
    batch = {"input": x, "label": y}
    loss_fn = jff.executor._make_loss_fn(jff.loss_type, jff.metric_types,
                                         jff._loss_tensor)
    (jloss, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jff.params, jff.bn_state, batch, jax.random.PRNGKey(0))
    leaves = [w.requires_grad_() for ws in tff.params.values()
              for w in ws.values()]
    tloss, _, _ = tff.executor.loss_and_metrics(
        tff.params, tff._to_device(batch), tff.loss_type, tff.metric_types,
        pair[4], training=True)
    flat = iter(torch.autograd.grad(tloss, leaves))
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    n = 0
    for op, ws in tff.params.items():
        for w in ws:
            g = next(flat).numpy()
            ref = np.asarray(jgrads[op][w])
            atol = 1e-4 * np.abs(ref).max() + 1e-6
            np.testing.assert_allclose(g, ref, rtol=0, atol=atol,
                                       err_msg=f"{op}.{w}")
            n += 1
    assert n == len(leaves) and n > 20


def test_three_sgd_steps_through_fit_match_jax(pair):
    """Three batches, one epoch of ``fit`` in both packages; every weight
    afterwards, and the loss ``evaluate`` reports on a fresh batch. Runs
    last for its models: it trains them."""
    jff, tff, init, _, _, jx, tx = pair
    xs, ys = _data(2, B * STEPS)
    JLoader(jff, jx, xs)
    JLoader(jff, jff.label_tensor, ys)
    SingleDataLoader(tff, tx, xs)
    SingleDataLoader(tff, tff.label_tensor, ys)
    jff.fit(epochs=1, verbose=False)
    perf = tff.fit(epochs=1, verbose=False)
    assert tff._step_count == STEPS and perf.train_all == B * STEPS
    got = _np_tree({op: {w: t.detach() for w, t in ws.items()}
                    for op, ws in tff.params.items()})
    want = _np_tree(jff.params)
    moved = 0
    for op, ws in want.items():
        for w, ref in ws.items():
            np.testing.assert_allclose(got[op][w], ref, **TOL,
                                       err_msg=f"{op}.{w}")
            moved += not np.array_equal(ref, init[op][w])
    assert moved > 20   # the steps did move the weights
    x, y = _data(3, B)
    jloss, jmets, _ = jff.evaluate({"input": x, "label": y})
    tloss, tmets, _ = tff.evaluate({"input": x, "label": y})
    np.testing.assert_allclose(tloss, jloss, **TOL)
    assert tmets["accuracy_count"] == jmets["accuracy_count"]


def _small_port_model(**cfg):
    ff = FFModel(FFConfig(batch_size=B, **cfg), device="cpu")
    x, out = build_encoder_classifier(ff, B, S, HIDDEN, 1, HEADS,
                                      num_classes=CLASSES)
    return ff, x, out


@pytest.mark.parametrize("knobs", [dict(checkpoint_dir="ckpt")],
                         ids=lambda k: next(iter(k)))
def test_later_slice_training_knobs_raise(knobs):
    ff, _, out = _small_port_model(**knobs)
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 11"):
        ff.compile(SGDOptimizer(), final_tensor=out)
    ff.compile(final_tensor=out)   # serving compile ignores them


def test_flash_off_trains_through_the_einsum_route(monkeypatch):
    """``use_flash_attention=False`` compiles for training and routes the
    dense attention to the einsum route (the flash autograd Function is
    never called): a train step from the same weights gives the loss and
    weights of the default model, whose attention runs the flash kernels'
    plain versions on the CPU (the same einsum arithmetic)."""
    from flexflow_tpu_torch.ops import kernels

    calls = []
    flash = kernels.flash_attention
    monkeypatch.setattr(kernels, "flash_attention",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    xs, ys = _data(5, B)
    batch = {"input": xs, "label": ys}
    models = []
    for on in (True, False):
        ff, _, out = _small_port_model(use_flash_attention=on)
        ff.compile(SGDOptimizer(lr=LR), final_tensor=out)
        models.append(ff)
    models[1].params = {op: {w: t.clone() for w, t in ws.items()}
                        for op, ws in models[0].params.items()}
    models[1].opt_state = models[1].optimizer.init_state(models[1].params)
    steps = []
    for ff in models:
        calls.clear()
        steps.append((float(ff._run_train_step(batch)[0]), len(calls)))
    on, off = models
    (l_on, n_on), (l_off, n_off) = steps
    assert (n_on, n_off) == (1, 0)
    np.testing.assert_allclose(l_off, l_on, **TOL)
    for op, ws in on.params.items():
        for w, t in ws.items():
            np.testing.assert_allclose(off.params[op][w].detach().numpy(),
                                       t.detach().numpy(), **TOL)


def test_fit_prints_epochs_and_throughput(capsys):
    ff, x, out = _small_port_model(master_dtype="bfloat16", epochs=2)
    with pytest.raises(RuntimeError, match="optimizer"):
        ff.fit()
    ff.compile(SGDOptimizer(lr=0.05), final_tensor=out)
    assert all(w.dtype == torch.bfloat16 for ws in ff.params.values()
               for w in ws.values())
    with pytest.raises(RuntimeError, match="dataloaders"):
        ff.fit()
    xs, ys = _data(4, 3 * B + 1)   # the last, partial batch is dropped
    SingleDataLoader(ff, x, xs)
    SingleDataLoader(ff, ff.label_tensor, ys)
    perf = ff.fit()
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:2]] == ["epoch 0", "epoch 1"]
    assert "accuracy=" in lines[1] and "THROUGHPUT" in lines[2]
    assert ff._step_count == 6 and perf.train_all == 3 * B
    # bf16 storage, f32 update arithmetic: still bf16 and finite
    assert all(w.dtype == torch.bfloat16 and torch.isfinite(w).all()
               for ws in ff.params.values() for w in ws.values())
