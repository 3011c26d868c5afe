"""The ops of the port's zoo slice against the JAX package's, op by op,
and BatchNorm's running state through every training step variant.

Each case builds a one-op graph (the builder verb in both packages, same
names), carries JAX's weights into the port, and runs the same numpy
inputs through both graph walks (``apply_graph``): the outputs, and the
gradients of every weight and float input for one numpy cotangent
(jax.vjp against torch autograd). Shapes include strided, padded, grouped
and 1 x 7 convs, max and average pools with padding (also past half the
kernel, which ``F.max_pool2d`` / ``F.avg_pool2d`` do not take), BatchNorm
in training and inference, Embedding SUM / AVG bags, each tensor op
(TopK on distinct values: the order of equal values may differ), each
elementwise op, Cast to each DataType, Softmax, and Dropout at rate 0 and
in inference (the identity; its masks are checked by distribution in
tests/test_torch_dropout.py).

BatchNorm's state (f32 ``mean`` / ``var`` per channel) is then held
against JAX's after ``fit`` over 3 SGD steps, under
``grad_accum_steps=2``, under ``train_scanned``, in ``evaluate`` (the
running statistics, the state unchanged), and under the divergence guard
with an injected NaN (weights and state bitwise unchanged).

Tolerances, f32: outputs 1e-5; gradients 1e-4 of each array's largest
gradient plus 1e-6; weights after the steps 1e-5; BatchNorm state 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu_torch.convert import params_from_jax, state_from_jax
from test_torch_zoo import _np_tree, numpy_init

TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=0, atol=1e-6)


@pytest.fixture(autouse=True)
def _numpy_weights(monkeypatch):
    numpy_init(monkeypatch)


def _models(build, **cfg):
    """The graph of ``build(pkg, ff)`` in both packages, compiled with SGD;
    the port on JAX's weights and state. ``build`` returns ({input name:
    numpy value}, [output tensors])."""
    out = []
    for pkg in (J, T):
        kw = dict(batch_size=cfg.pop("batch_size", 2), **cfg)
        if pkg is J:
            ff = J.FFModel(J.FFConfig(mesh_shape={"data": 1}, **kw))
        else:
            ff = T.FFModel(T.FFConfig(**kw), device="cpu")
        feeds, outs = build(pkg, ff)
        ff.compile(pkg.SGDOptimizer(lr=0.05),
                   pkg.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
                   [pkg.MetricsType.METRICS_MEAN_SQUARED_ERROR],
                   final_tensor=outs[0])
        out.append((ff, feeds, outs))
    (jff, feeds, jouts), (tff, _, touts) = out
    tff.params = params_from_jax(_np_tree(jff.params), "cpu", torch.float32,
                                 model=tff)
    tff.bn_state = state_from_jax(_np_tree(jff.bn_state), "cpu", model=tff)
    return jff, tff, feeds, jouts, touts


def _floating(a) -> bool:
    return jnp.issubdtype(np.asarray(a).dtype, jnp.floating)


def _run(build, training=False, seed=0):
    """Outputs and gradients of one graph in both packages: ({output i:
    (port, jax)}, {name: (port grad, jax grad)})."""
    jff, tff, feeds, jouts, touts = _models(build)
    names = {op.name: op.outputs[0] for op in tff.ops
             if type(op).__name__ == "InputOp"}
    jnames = {op.name: op.outputs[0] for op in jff.ops
              if type(op).__name__ == "InputOp"}
    diff = [k for k, v in feeds.items() if _floating(v)]

    def jfun(params, xs):
        vals = {jnames[k]: jnp.asarray(v) for k, v in feeds.items()}
        vals.update({jnames[k]: x for k, x in zip(diff, xs)})
        got, _ = jff.executor.apply_graph(params, jff.bn_state, vals,
                                          training=training, rng=None)
        return [got[t] for t in jouts]

    jy, vjp = jax.vjp(jfun, jff.params, [jnp.asarray(feeds[k])
                                         for k in diff])
    rs = np.random.RandomState(seed)
    cots = [rs.randn(*np.shape(y)).astype(np.float32) for y in jy]
    jgp, jgx = vjp([c.astype(y.dtype) if _floating(y)
                    else np.zeros(np.shape(y), jax.dtypes.float0)
                    for c, y in zip(cots, jy)])

    tx = {k: torch.tensor(v, requires_grad=k in diff)
          for k, v in feeds.items()}
    leaves = [w.requires_grad_() for ws in tff.params.values()
              for w in ws.values()]
    vals, _ = tff.executor.apply_graph(
        tff.params, {names[k]: v for k, v in tx.items()}, training=training,
        state=tff.bn_state)
    ty = [vals[t] for t in touts]
    outs = {i: (t.detach().to(torch.float32 if t.dtype == torch.bfloat16
                              else t.dtype).numpy(), np.asarray(j))
            for i, (t, j) in enumerate(zip(ty, jy))}
    loss = sum((t * torch.as_tensor(c)).sum()
               for t, c in zip(ty, cots) if t.is_floating_point())
    wrt = leaves + [tx[k] for k in diff]
    grads = {}
    if wrt and isinstance(loss, torch.Tensor) and loss.requires_grad:
        tg = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        for op, ws in tff.params.items():
            for w in ws:
                grads[f"{op}.{w}"] = (next(tg), jgp[op][w])
        for k, g in zip(diff, jgx):
            grads[k] = (next(tg), g)
    return outs, grads


def _check(build, training=False):
    outs, grads = _run(build, training)
    for i, (t, j) in outs.items():
        assert t.shape == j.shape, (i, t.shape, j.shape)
        if _floating(j):
            np.testing.assert_allclose(t, j, **TOL, err_msg=f"output {i}")
        else:
            np.testing.assert_array_equal(t, j, err_msg=f"output {i}")
    for name, (t, j) in grads.items():
        j = np.asarray(j)
        t = np.zeros_like(j) if t is None else t.numpy()
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=1e-4 * np.abs(j).max() + 1e-6,
                                   err_msg=name)
    return outs, grads


def _x(*shape, seed=1, offset=0.0):
    return (np.random.RandomState(seed).randn(*shape) + offset).astype(
        np.float32)


def _one(verb, shape, *args, offset=0.0, **kw):
    """A graph of one verb on one float input of ``shape``."""
    def build(pkg, ff):
        x = ff.create_tensor(list(shape), name="x")
        y = getattr(ff, verb)(x, *args, name="op", **kw)
        return {"x": _x(*shape, offset=offset)}, (y if isinstance(y, list)
                                                   else [y])
    return build


def _act(pkg):
    return pkg.ActiMode.AC_MODE_RELU


CONVS = {
    "strided-padded-relu": lambda pkg: ((2, 4, 9, 9), (6, 3, 3, 2, 2, 1, 1,
                                                        _act(pkg))),
    "grouped-no-bias": lambda pkg: ((2, 4, 7, 7), (6, 3, 3, 1, 1, 1, 1),
                                    dict(groups=2, use_bias=False)),
    "depthwise-strided": lambda pkg: ((2, 4, 8, 8), (4, 3, 3, 2, 2, 1, 1),
                                      dict(groups=4)),
    "1x7": lambda pkg: ((2, 3, 6, 9), (5, 1, 7, 1, 1, 0, 3)),
    "patchify": lambda pkg: ((2, 3, 16, 16), (8, 8, 8, 8, 8, 0, 0)),
}


@pytest.mark.parametrize("case", list(CONVS))
def test_conv2d(case):
    def build(pkg, ff):
        shape, args, *kw = CONVS[case](pkg)
        return _one("conv2d", shape, *args, **(kw[0] if kw else {}))(pkg,
                                                                     ff)
    _check(build)


POOLS = {
    # (kernel, stride, padding, type, activation)
    "max-k3s2p1": (3, 2, 1, "POOL_MAX", None),
    "avg-k3s1p1": (3, 1, 1, "POOL_AVG", None),
    "avg-k2s2-relu": (2, 2, 0, "POOL_AVG", "AC_MODE_RELU"),
    "max-pad-past-half": (3, 2, 2, "POOL_MAX", None),
    "avg-pad-past-half": (3, 1, 2, "POOL_AVG", None),
    "global-avg": (7, 1, 0, "POOL_AVG", None),
}


@pytest.mark.parametrize("case", list(POOLS))
def test_pool2d(case):
    k, s, p, kind, act = POOLS[case]

    def build(pkg, ff):
        extra = {} if act is None else dict(
            activation=getattr(pkg.ActiMode, act))
        return _one("pool2d", (2, 3, 7, 7), k, k, s, s, p, p,
                    getattr(pkg.PoolType, kind), **extra)(pkg, ff)
    _check(build)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "affine"])
def test_batch_norm(training, relu):
    """Training: batch statistics (the biased variance); inference: the
    running state (here JAX's initial zeros / ones, offset by the inputs'
    mean of 2 so the two differ)."""
    _check(_one("batch_norm", (3, 4, 5, 5), relu=relu, offset=2.0),
           training=training)


def test_flat():
    _check(_one("flat", (2, 3, 4, 5)))


@pytest.mark.parametrize("aggr", ["AGGR_MODE_SUM", "AGGR_MODE_AVG",
                                  "AGGR_MODE_NONE"])
def test_embedding_bags(aggr):
    def build(pkg, ff):
        idx = ff.create_tensor([3, 2, 4], pkg.DataType.DT_INT32, name="idx")
        y = ff.embedding(idx, 11, 6, getattr(pkg.AggrMode, aggr), name="op")
        ids = np.random.RandomState(2).randint(0, 11, (3, 2, 4))
        return {"idx": ids.astype(np.int32)}, [y]
    _check(build)


def test_batch_matmul():
    def build(pkg, ff):
        a = ff.create_tensor([2, 3, 4, 5], name="a")
        b = ff.create_tensor([2, 3, 5, 6], name="b")
        return ({"a": _x(2, 3, 4, 5), "b": _x(2, 3, 5, 6, seed=3)},
                [ff.batch_matmul(a, b, name="op")])
    _check(build)


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax(axis):
    _check(_one("softmax", (2, 5, 7), axis))


TENSOR_OPS = {
    "reshape": ("reshape", (2, 3, 4), ([4, -1, 3],)),
    "transpose": ("transpose", (2, 3, 4), ([2, 0, 1],)),
    "reverse": ("reverse", (2, 3, 4), (1,)),
    "split-equal": ("split", (2, 6, 4), (3, 1)),
    "split-sizes": ("split", (2, 6, 4), ([1, 2, 3], 1)),
    "topk": ("topk", (3, 9), (4,)),
    "topk-unsorted": ("topk", (3, 9), (2, False)),
    "pad": ("pad", (2, 3, 4), ([(0, 0), (1, 2), (3, 0)], 0.5)),
}


@pytest.mark.parametrize("case", list(TENSOR_OPS))
def test_tensor_op(case):
    verb, shape, args = TENSOR_OPS[case]
    _check(_one(verb, shape, *args))


def test_concat_and_gather():
    def build(pkg, ff):
        a = ff.create_tensor([2, 3, 4], name="a")
        b = ff.create_tensor([2, 5, 4], name="b")
        c = ff.concat([a, b], axis=1, name="cat")
        idx = ff.create_tensor([2, 3, 4], pkg.DataType.DT_INT32, name="idx")
        g = ff.gather(c, idx, axis=1, name="op")
        ids = np.random.RandomState(4).randint(0, 8, (2, 3, 4))
        return ({"a": _x(2, 3, 4), "b": _x(2, 5, 4, seed=5),
                 "idx": ids.astype(np.int32)}, [g, c])
    _check(build)


@pytest.mark.parametrize("dtype", ["DT_FLOAT", "DT_DOUBLE", "DT_INT32",
                                   "DT_INT64", "DT_BOOLEAN", "DT_HALF",
                                   "DT_BFLOAT16"])
def test_cast(dtype):
    """Cast of values that every type holds exactly (and a zero for the
    bool): equal values in both packages (JAX, without jax_enable_x64,
    keeps 32 bits where the port keeps the named 64)."""
    def build(pkg, ff):
        x = ff.create_tensor([2, 6], name="x")
        y = ff.cast(x, getattr(pkg.DataType, dtype), name="op")
        vals = np.array([[0, 1, -2, 3.5, 40, -0.25], [7, 0, 1, 2, -8, 9]],
                        np.float32)
        if dtype.startswith("DT_INT"):
            vals = np.round(vals)
        return {"x": vals}, [y]
    outs, _ = _run(build)
    t, j = outs[0]
    np.testing.assert_array_equal(np.asarray(t, np.float64),
                                  np.asarray(j, np.float64))


UNARY = {"relu": (), "tanh": (), "elu": (), "gelu": (), "exp": (),
         "sin": (), "cos": (), "rsqrt": (), "identity": (), "sigmoid": (),
         "pow": (3.0,), "scalar_multiply": (-1.5,)}


@pytest.mark.parametrize("verb", list(UNARY))
def test_unary(verb):
    offset = 3.0 if verb == "rsqrt" else 0.0
    _check(_one(verb, (2, 3, 5), *UNARY[verb], offset=offset))


@pytest.mark.parametrize("verb", ["add", "subtract", "multiply", "divide",
                                  "max", "min"])
def test_binary(verb):
    def build(pkg, ff):
        a = ff.create_tensor([2, 3, 5], name="a")
        b = ff.create_tensor([3, 5], name="b")
        off = 3.0 if verb == "divide" else 0.0
        return ({"a": _x(2, 3, 5), "b": _x(3, 5, seed=6, offset=off)},
                [getattr(ff, verb)(a, b, name="op")])
    _check(build)


@pytest.mark.parametrize("rate,training", [(0.0, True), (0.5, False)],
                         ids=["rate0-train", "eval"])
def test_dropout_is_the_identity(rate, training):
    outs, _ = _check(_one("dropout", (4, 9), rate), training=training)
    np.testing.assert_array_equal(outs[0][0], _x(4, 9))


# ---- BatchNorm's state through the step variants --------------------------

B = 4


def _bn_net(pkg, ff):
    """conv -> BN (relu) -> pool -> conv -> BN -> global pool -> fc."""
    x = ff.create_tensor([B, 3, 8, 8], name="input")
    t = ff.conv2d(x, 6, 3, 3, 1, 1, 1, 1, name="c1")
    t = ff.batch_norm(t, relu=True, name="bn1")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="p1")
    t = ff.conv2d(t, 8, 3, 3, 1, 1, 1, 1, name="c2")
    t = ff.batch_norm(t, relu=False, name="bn2")
    t = ff.pool2d(t, 4, 4, 1, 1, 0, 0, pkg.PoolType.POOL_AVG, name="gap")
    return ff.dense(ff.flat(t, name="flat"), 5, name="fc")


def _bn_pair(**cfg):
    out = []
    for pkg in (J, T):
        if pkg is J:
            ff = J.FFModel(J.FFConfig(batch_size=B, mesh_shape={"data": 1},
                                      **cfg))
        else:
            ff = T.FFModel(T.FFConfig(batch_size=B, **cfg), device="cpu")
        y = _bn_net(pkg, ff)
        ff.compile(pkg.SGDOptimizer(lr=0.1),
                   pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   [pkg.MetricsType.METRICS_ACCURACY], final_tensor=y)
        out.append(ff)
    jff, tff = out
    tff.params = params_from_jax(_np_tree(jff.params), "cpu", torch.float32,
                                 model=tff)
    tff.opt_state = tff.optimizer.init_state(tff.params)
    tff.bn_state = state_from_jax(_np_tree(jff.bn_state), "cpu", model=tff)
    return jff, tff


def _bn_data(n, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 3, 8, 8).astype(np.float32) * 2 + 1,
            rs.randint(0, 5, (n, 1)).astype(np.int32))


def _attach(ff, pkg, n):
    x, y = _bn_data(n)
    inp = next(op.outputs[0] for op in ff.ops if op.name == "input")
    pkg.SingleDataLoader(ff, inp, x)
    pkg.SingleDataLoader(ff, ff.label_tensor, y)


def _same_state_and_weights(jff, tff, moved=True):
    for op, ws in _np_tree(jff.bn_state).items():
        for k, ref in ws.items():
            got = tff.bn_state[op][k].numpy()
            np.testing.assert_allclose(got, ref, **STATE_TOL,
                                       err_msg=f"{op}.{k}")
            if moved:   # the steps moved the state off its init
                assert not np.allclose(ref, 0.0 if k == "mean" else 1.0)
    got = _np_tree(tff.params)
    for op, ws in _np_tree(jff.params).items():
        for w, ref in ws.items():
            np.testing.assert_allclose(got[op][w], ref, **TOL,
                                       err_msg=f"{op}.{w}")


@pytest.mark.parametrize("cfg", [dict(), dict(grad_accum_steps=2)],
                         ids=["fit", "grad_accum_2"])
def test_bn_state_through_fit_matches_jax(cfg):
    """Three SGD steps through ``fit``; under accumulation each
    microbatch's statistics move the state in turn (JAX's scan carry)."""
    jff, tff = _bn_pair(**cfg)
    for ff, pkg in ((jff, J), (tff, T)):
        _attach(ff, pkg, 3 * B)
        ff.fit(epochs=1, verbose=False)
    np.testing.assert_allclose(float(tff._last_loss), float(jff._last_loss),
                               **TOL)
    _same_state_and_weights(jff, tff)


def test_bn_state_through_train_scanned_matches_jax():
    jff, tff = _bn_pair()
    for ff, pkg in ((jff, J), (tff, T)):
        _attach(ff, pkg, 3 * B)
    jl, _ = jff.train_scanned(3)
    tl, _ = tff.train_scanned(3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _same_state_and_weights(jff, tff)


def test_evaluate_reads_the_running_state_and_keeps_it():
    """One step moves the state; ``evaluate`` and ``predict`` then
    normalise by it (JAX's loss and logits) and leave it bitwise."""
    jff, tff = _bn_pair()
    x, y = _bn_data(B, seed=1)
    batch = {"input": x, "label": y}
    jff._run_train_step(batch)
    tff._run_train_step(batch)
    before = _np_tree(tff.bn_state)
    x2, y2 = _bn_data(B, seed=2)
    jloss, _, jlogits = jff.evaluate({"input": x2, "label": y2})
    tloss, _, tlogits = tff.evaluate({"input": x2, "label": y2})
    np.testing.assert_allclose(tloss, jloss, **TOL)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(tff.predict({"input": x2}).numpy(),
                               np.asarray(jlogits), **TOL)
    for op, ws in before.items():
        for k, v in ws.items():
            np.testing.assert_array_equal(tff.bn_state[op][k].numpy(), v)
    _same_state_and_weights(jff, tff)


def test_guard_leaves_bn_state_bitwise_on_an_injected_nan():
    """Under ``on_nonfinite="skip"`` a NaN step leaves the weights and the
    state bitwise (JAX's too); the next, finite step moves both as JAX's
    does."""
    jff, tff = _bn_pair(on_nonfinite="skip")
    x, y = _bn_data(B, seed=3)
    batch = {"input": x, "label": y}
    w0, s0 = _np_tree(tff.params), _np_tree(tff.bn_state)
    js0 = _np_tree(jff.bn_state)
    _, tm = tff._run_train_step(batch, inject_nan=True)
    _, jm = jff._run_train_step(batch, inject_nan=True)
    assert int(tm["nonfinite"]) == int(jm["nonfinite"]) == 1
    for tree, ref in ((tff.bn_state, s0), (tff.params, w0),
                      (jff.bn_state, js0)):
        for op, ws in _np_tree(tree).items():
            for k, v in ws.items():
                np.testing.assert_array_equal(v, ref[op][k])
    tff._run_train_step(batch)
    jff._run_train_step(batch)
    _same_state_and_weights(jff, tff)
