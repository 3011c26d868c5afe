"""The rest of the train loop in the PyTorch port, against the JAX package:
the lr schedules, the initializers, SGD and Adam through ``fit``, and
``FusedUpdate``.

Same inputs from a numpy seed; the JAX-initialised weights are carried
into the port with ``params_from_jax``; f32 on the CPU, where the port runs
its kernels' plain versions. Tolerances:

- schedules: 1e-6 relative (f32 ``cos`` / ``pow`` may round one or two
  ulps apart in the two frameworks);
- weights after three steps through ``fit``: 1e-5 of the largest weight
  (sums of products in other orders, through three updates). Adam's key
  biases are the exception: their exact gradient is zero (softmax ignores
  a shift of every key), so what each framework feeds Adam there is
  rounding noise, which Adam normalises to steps of up to ~alpha; they are
  held to the bound such steps allow;
- ``FusedUpdate`` against the per-leaf update: bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import AdamOptimizer as JAdam
from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import LossType as JLoss
from flexflow_tpu import MetricsType as JMetrics
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu import SingleDataLoader as JLoader
from flexflow_tpu.models.transformer import \
    build_encoder_classifier as j_build
from flexflow_tpu.runtime import schedule as jsched
from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel, LossType,
                                MetricsType, SGDOptimizer, SingleDataLoader)
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import build_encoder_classifier
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.base import WeightSpec
from flexflow_tpu_torch.runtime import initializer, schedule
from flexflow_tpu_torch.runtime.optimizer import FusedUpdate

B, S, HIDDEN, LAYERS, HEADS, CLASSES = 4, 16, 64, 2, 4, 8
STEPS = 3


def _data(seed: int, n: int):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, S, HIDDEN).astype(np.float32),
            rs.randint(0, CLASSES, (n, 1)).astype(np.int32))


def _np_tree(params):
    return {op: {w: np.asarray(a) for w, a in ws.items()}
            for op, ws in params.items()}


def _pair(jopt, topt, **cfg):
    """(JAX model, port model, JAX's initial weights, JAX input, port
    input), the port carrying JAX's weights, both compiled for training."""
    jff = JModel(JConfig(batch_size=B, mesh_shape={"data": 1}, seed=1,
                         **cfg))
    jx, jout = j_build(jff, B, S, HIDDEN, LAYERS, HEADS, num_classes=CLASSES)
    jff.compile(jopt, JLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                [JMetrics.METRICS_ACCURACY], final_tensor=jout)
    init = _np_tree(jff.params)
    tff = FFModel(FFConfig(batch_size=B, seed=1, **cfg), device="cpu")
    tx, tout = build_encoder_classifier(tff, B, S, HIDDEN, LAYERS, HEADS,
                                        num_classes=CLASSES)
    tff.compile(topt, LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                [MetricsType.METRICS_ACCURACY], final_tensor=tout)
    tff.params = params_from_jax(init, "cpu", torch.float32, model=tff)
    tff.opt_state = tff.optimizer.init_state(tff.params)
    return jff, tff, init, jx, tx


# ---- schedules ---------------------------------------------------------------

SCHEDULES = {
    "constant": ("ConstantSchedule", (), {}),
    "warmup_cosine": ("WarmupCosine", (5, 40), {}),
    "cosine_floor": ("WarmupCosine", (0, 30), {"final_scale": 0.1}),
    "warmup_linear": ("WarmupLinear", (10, 45), {"final_scale": 0.2}),
    "step_decay": ("StepDecay", (7,), {"gamma": 0.5}),
    "exponential": ("ExponentialDecay", (0.93,), {}),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule_matches_jax(case):
    """Each schedule's scale for t in 0..50: a 0-dim f32 tensor of the
    int32 step tensor, within 1e-6 relative of JAX's."""
    name, args, kw = SCHEDULES[case]
    js, ts = getattr(jsched, name)(*args, **kw), getattr(schedule, name)(
        *args, **kw)
    want = np.array([np.float32(js(jnp.int32(t))) for t in range(51)])
    got = []
    for t in range(51):
        v = ts(torch.tensor(t, dtype=torch.int32))
        assert v.shape == () and v.dtype == torch.float32
        got.append(v.item())
    np.testing.assert_allclose(np.array(got, np.float32), want, rtol=1e-6,
                               atol=0)


def test_resolve():
    assert isinstance(schedule.resolve(None), schedule.ConstantSchedule)
    cos = schedule.WarmupCosine(1, 5)
    assert schedule.resolve(cos) is cos
    with pytest.raises(TypeError, match="did you mean WarmupCosine"):
        schedule.resolve(schedule.WarmupCosine)
    with pytest.raises(TypeError, match="callable"):
        schedule.resolve(0.5)


# ---- initializers -------------------------------------------------------------

N_DRAW = 200_000


def _moments(x):
    x = x.double()
    return x.mean().item(), x.std().item()


@pytest.mark.parametrize("fan", [None, (300, 100)], ids=["shape", "fan"])
def test_glorot_bounds_and_spread(fan):
    """uniform(-a, a), a = sqrt(6 / (fan_in + fan_out)), the fan from the
    shape's first and last dims unless given: bounds, mean 0 and std
    a / sqrt(3) within 5 sigma of the sample's."""
    spec = WeightSpec("kernel", (400, 500), init="glorot", fan=fan)
    gen = torch.Generator().manual_seed(0)
    w = initializer.init_weight(spec, gen)
    fi, fo = fan or (400, 500)
    a = (6.0 / (fi + fo)) ** 0.5
    assert w.shape == (400, 500) and w.dtype == torch.float32
    assert w.abs().max().item() <= a and w.abs().max().item() > 0.99 * a
    mean, std = _moments(w)
    sd = a / 3 ** 0.5
    n = w.numel()
    assert abs(mean) <= 5 * sd / n ** 0.5
    assert abs(std - sd) <= 5 * sd / (2 * n) ** 0.5


@pytest.mark.parametrize("args", [None, (-2.0, 3.0)], ids=["default", "args"])
def test_uniform_bounds_and_spread(args):
    spec = WeightSpec("w", (N_DRAW,), init="uniform", init_args=args)
    w = initializer.init_weight(spec, torch.Generator().manual_seed(1))
    lo, hi = args or (-0.05, 0.05)
    assert lo <= w.min().item() and w.max().item() <= hi
    mean, std = _moments(w)
    sd = (hi - lo) / 12 ** 0.5
    assert abs(mean - (lo + hi) / 2) <= 5 * sd / N_DRAW ** 0.5
    assert abs(std - sd) <= 5 * sd / (2 * N_DRAW) ** 0.5


@pytest.mark.parametrize("args", [None, (0.5, 0.02)], ids=["default", "args"])
def test_normal_mean_and_std(args):
    spec = WeightSpec("w", (N_DRAW,), init="normal", init_args=args)
    w = initializer.init_weight(spec, torch.Generator().manual_seed(2))
    mu, sd = args or (0.0, 1.0)
    mean, std = _moments(w)
    assert abs(mean - mu) <= 5 * sd / N_DRAW ** 0.5
    assert abs(std - sd) <= 5 * sd / (2 * N_DRAW) ** 0.5


def test_constant_zero_one_exact():
    gen = torch.Generator().manual_seed(3)
    for spec, v in ((WeightSpec("c", (3, 4), init="constant",
                                init_args=(0.25,)), 0.25),
                    (WeightSpec("z", (5,), init="zero"), 0.0),
                    (WeightSpec("o", (2, 2), init="one"), 1.0)):
        w = initializer.init_weight(spec, gen)
        assert torch.equal(w, torch.full(spec.shape, v))
    assert torch.equal(initializer.ConstantInitializer(-1.5)(gen, (2,)),
                       torch.tensor([-1.5, -1.5]))
    with pytest.raises(ValueError, match="unknown init"):
        initializer.init_weight(WeightSpec("x", (2,), init="orthogonal"), gen)


def test_init_params_go_through_init_weight():
    """compile() draws every weight through init_weight from the seeded
    generator: the same seed gives the same weights, another seed others;
    Linear kernels are glorot within their bound, biases zero, LayerNorm
    scales one."""
    def build(seed):
        ff = FFModel(FFConfig(batch_size=B, seed=seed), device="cpu")
        _, out = build_encoder_classifier(ff, B, S, HIDDEN, 1, HEADS,
                                          num_classes=CLASSES)
        ff.compile(SGDOptimizer(), final_tensor=out)
        return ff.params

    a, b, c = build(4), build(4), build(5)
    assert all(torch.equal(a[op][w], b[op][w]) for op in a for w in a[op])
    assert not torch.equal(a["ffn1_0"]["kernel"], c["ffn1_0"]["kernel"])
    k = a["ffn1_0"]["kernel"]
    assert k.abs().max() <= (6.0 / sum(k.shape)) ** 0.5
    assert torch.equal(a["ffn1_0"]["bias"], torch.zeros(k.shape[1]))
    assert torch.equal(a["ln1_0"]["scale"], torch.ones(HIDDEN))


# ---- SGD and Adam through fit ---------------------------------------------------

FIT_CASES = {
    "adam-warmup_cosine": (
        lambda: JAdam(alpha=0.01, schedule=jsched.WarmupCosine(1, 10)),
        lambda: AdamOptimizer(alpha=0.01,
                              schedule=schedule.WarmupCosine(1, 10))),
    "momentum-step_decay": (
        lambda: JSGD(lr=0.05, momentum=0.9,
                     schedule=jsched.StepDecay(2, 0.5)),
        lambda: SGDOptimizer(lr=0.05, momentum=0.9,
                             schedule=schedule.StepDecay(2, 0.5))),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_three_steps_through_fit_match_jax(case):
    """Three steps of ``fit`` in both packages from the same weights; every
    weight afterwards within 1e-5 of the largest (Adam's key biases: within
    three steps of 2 alpha, see the module docstring); the step counter
    is a device int32 tensor at 3."""
    jopt, topt = FIT_CASES[case]
    jff, tff, init, jx, tx = _pair(jopt(), topt())
    xs, ys = _data(2, B * STEPS)
    JLoader(jff, jx, xs)
    JLoader(jff, jff.label_tensor, ys)
    SingleDataLoader(tff, tx, xs)
    SingleDataLoader(tff, tff.label_tensor, ys)
    jff.fit(epochs=1, verbose=False)
    tff.fit(epochs=1, verbose=False)
    t = tff.opt_state["t"]
    assert t.dtype == torch.int32 and t.shape == () and int(t) == STEPS
    want = _np_tree(jff.params)
    wmax = max(np.abs(a).max() for ws in want.values() for a in ws.values())
    adam = case.startswith("adam")
    moved = 0
    for op, ws in want.items():
        for w, ref in ws.items():
            got = tff.params[op][w].detach().numpy()
            atol = (STEPS * 2 * 0.01 if adam and w == "bias_k"
                    else 1e-5 * wmax)
            np.testing.assert_allclose(got, ref, rtol=0, atol=atol,
                                       err_msg=f"{op}.{w}")
            moved += not np.array_equal(ref, init[op][w])
    assert moved > 20
    np.testing.assert_allclose(float(tff._last_loss), float(jff._last_loss),
                               rtol=1e-5)


# ---- FusedUpdate ------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda: SGDOptimizer(lr=0.1, weight_decay=0.01),
    "momentum": lambda: SGDOptimizer(lr=0.1, momentum=0.9,
                                     schedule=schedule.ExponentialDecay(0.9)),
    "nesterov": lambda: SGDOptimizer(lr=0.1, momentum=0.9, nesterov=True,
                                     weight_decay=0.01),
    "adam": lambda: AdamOptimizer(alpha=0.01, weight_decay=0.01,
                                  schedule=schedule.WarmupLinear(1, 8)),
}
LEAVES = {"a": {"kernel": (3, 5), "bias": (5,)},
          "b": {"scale": (1,), "kernel": (17, 2)}}


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _tree(rs, dtype):
    return {op: {k: torch.tensor(rs.randn(*s), dtype=torch.float32).to(dtype)
                 for k, s in ws.items()} for op, ws in LEAVES.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_fused_update_bitwise_per_leaf(opt, dtype):
    """Four steps of FusedUpdate against the per-leaf update from the same
    weights and gradients: weights bitwise; the flat state bitwise the
    per-leaf state concatenated; the step counter alike."""
    rs = np.random.RandomState(6)
    per, fused = OPTIMIZERS[opt](), FusedUpdate(OPTIMIZERS[opt]())
    p1 = _tree(rs, dtype)
    p2 = {op: {k: w.clone() for k, w in ws.items()} for op, ws in p1.items()}
    s1, s2 = per.init_state(p1), fused.init_state(p2)
    for _ in range(4):
        g = _tree(rs, dtype)
        per.update(p1, g, s1)
        fused.update(p2, g, s2)
    for op, ws in p1.items():
        for k, w in ws.items():
            assert torch.equal(_bits(w), _bits(p2[op][k])), (op, k)
    for n in per.moment_names():
        flat = torch.cat([s1[n][op][k].reshape(-1) for op, ws in p1.items()
                          for k in ws])
        assert torch.equal(_bits(flat), _bits(s2[n][dtype]))
    assert int(s1["t"]) == int(s2["t"]) == 4


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_fused_update_grad_dtype_mismatch(opt):
    """bf16 weights, f32 gradients for some leaves (as accumulation gives):
    they bucket with their weights, and the update is bitwise the
    per-leaf one, which reads the same f32 values."""
    rs = np.random.RandomState(7)
    per, fused = OPTIMIZERS[opt](), FusedUpdate(OPTIMIZERS[opt]())
    p1 = _tree(rs, torch.bfloat16)
    p2 = {op: {k: w.clone() for k, w in ws.items()} for op, ws in p1.items()}
    s1, s2 = per.init_state(p1), fused.init_state(p2)
    assert list(s2["v"]) == [torch.bfloat16]
    for _ in range(3):
        g = _tree(rs, torch.float32)
        g["a"]["bias"] = g["a"]["bias"].to(torch.bfloat16)
        per.update(p1, g, s1)
        fused.update(p2, g, s2)
    assert all(torch.equal(_bits(p1[op][k]), _bits(p2[op][k]))
               for op in p1 for k in p1[op])


def test_fused_update_finite_false_keeps_every_bit():
    rs = np.random.RandomState(8)
    opt = FusedUpdate(OPTIMIZERS["adam"]())
    p = _tree(rs, torch.bfloat16)
    s = opt.init_state(p)
    opt.update(p, _tree(rs, torch.bfloat16), s)
    before = {op: {k: w.clone() for k, w in ws.items()} for op, ws in
              p.items()}
    m, v = s["m"][torch.bfloat16].clone(), s["v"][torch.bfloat16].clone()
    opt.update(p, _tree(rs, torch.bfloat16), s, finite=torch.tensor(False))
    assert all(torch.equal(_bits(p[op][k]), _bits(before[op][k]))
               for op in p for k in p[op])
    assert torch.equal(_bits(m), _bits(s["m"][torch.bfloat16]))
    assert torch.equal(_bits(v), _bits(s["v"][torch.bfloat16]))
    assert int(s["t"]) == 1


def test_fused_update_plain_is_the_per_leaf_formula():
    """kernels.fused_update on CPU tensors is its plain version, which is
    update_math on the concatenated bucket; launches are not counted."""
    rs = np.random.RandomState(9)
    rule = kernels.UpdateRule("sgd", momentum=0.9, nesterov=True)
    ps = [torch.tensor(rs.randn(n), dtype=torch.float32) for n in (2, 7)]
    gs = [torch.tensor(rs.randn(n), dtype=torch.float32) for n in (2, 7)]
    v = torch.tensor(rs.randn(9), dtype=torch.float32)
    lr = torch.tensor(0.1)
    w_new, (v_new,) = kernels.update_math(rule, torch.cat(ps), torch.cat(gs),
                                          [v], lr)
    n0 = kernels.fused_update.launches
    kernels.fused_update(rule, ps, gs, [v], lr)
    assert kernels.fused_update.launches == n0
    assert torch.equal(torch.cat(ps), w_new) and torch.equal(v, v_new)


def test_fused_optimizer_trains_bitwise_the_per_leaf_one():
    """FFConfig.fused_optimizer through fit (Adam, bf16 weights): every
    weight bitwise the per-leaf model's."""
    xs, ys = _data(10, B * STEPS)
    models = []
    for fused in (False, True):
        ff = FFModel(FFConfig(batch_size=B, seed=3, master_dtype="bfloat16",
                              fused_optimizer=fused), device="cpu")
        x, out = build_encoder_classifier(ff, B, S, HIDDEN, 1, HEADS,
                                          num_classes=CLASSES)
        ff.compile(OPTIMIZERS["adam"](), final_tensor=out)
        SingleDataLoader(ff, x, xs)
        SingleDataLoader(ff, ff.label_tensor, ys)
        ff.fit(verbose=False)
        models.append(ff)
    per, fused = models
    assert isinstance(fused.optimizer, FusedUpdate)
    assert fused.optimizer.schedule is fused.optimizer.inner.schedule
    assert all(torch.equal(_bits(w), _bits(fused.params[op][k]))
               for op, ws in per.params.items() for k, w in ws.items())
