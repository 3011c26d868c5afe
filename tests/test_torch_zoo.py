"""The convolutional and MLP models of the PyTorch port's zoo against the
JAX package, model by model (tests/test_torch_zoo_attention.py holds the
attention models with the helpers of this file).

Each model is built at a small size in both packages with the same
builder; the JAX-initialised weights (and BatchNorm state) are carried into
the port with ``params_from_jax`` / ``state_from_jax``. The JAX side runs
with ``FF_FORCE_FLASH_ATTENTION=1``, so its attention goes through the
Pallas flash kernels in interpret mode; the port runs its kernels' plain
versions on the CPU.

Compared, f32: the logits (inference: BatchNorm on its running state) and
the training loss within 1e-5; every gradient within 1e-4 of its weight's
largest gradient (plus 1e-6); after three SGD steps through ``fit`` every
weight within 1e-5, every BatchNorm mean / var within 1e-6, and the
losses within 1e-5. The full ``resnet50`` takes ~50 s to build in JAX
here, so JAX holds it block by block (a ResNet of the same stem and
``_bottleneck`` blocks); the port's own ``resnet50`` at image 32 trains
and lowers its loss. Last, ``tie_weights``: its refusals, and both uses'
gradients summed into one leaf.
"""

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.models import bert as j_bert
from flexflow_tpu.models import cnn as j_cnn
from flexflow_tpu.models import dlrm as j_dlrm
from flexflow_tpu.models import llama as j_llama
from flexflow_tpu.models import vit as j_vit
import flexflow_tpu_torch as T
from flexflow_tpu_torch.convert import params_from_jax, state_from_jax
from flexflow_tpu_torch.models import bert as t_bert
from flexflow_tpu_torch.models import cnn as t_cnn
from flexflow_tpu_torch.models import llama as t_llama
from flexflow_tpu_torch.models.dlrm import dlrm as t_dlrm
from flexflow_tpu_torch.models.vit import vit as t_vit

B = 2
STEPS = 3
LR = 0.05
TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=0, atol=1e-6)
SPARSE = "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY"
MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"


def _resnet_blocks(pkg):
    """The stem of resnet50 and two ``_bottleneck`` blocks (one with a
    strided projection), global average pool, fc: resnet50 block by
    block."""
    cnn = j_cnn if pkg is J else t_cnn

    def build(ff, b):
        x = ff.create_tensor([b, 3, 32, 32], name="input")
        t = ff.conv2d(x, 16, 7, 7, 2, 2, 3, 3, name="conv1")
        t = ff.batch_norm(t, relu=True, name="bn1")
        t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, name="pool1")
        t = cnn._bottleneck(ff, t, 8, 1, 0, downsample=True)
        t = cnn._bottleneck(ff, t, 8, 1, 1, downsample=False)
        t = cnn._bottleneck(ff, t, 16, 2, 2, downsample=True)
        h = t.dims[2]
        t = ff.pool2d(t, h, h, 1, 1, 0, 0, pkg.PoolType.POOL_AVG,
                      name="gap")
        t = ff.flat(t)
        return {"input": x}, ff.dense(t, 10, name="fc")
    return build


def _image(size):
    return lambda rs, n: {"input": rs.randn(n, 3, size, size).astype(
        np.float32)}


def _tokens(vocab, seq, positions=False):
    def feed(rs, n):
        out = {"input": rs.randint(0, vocab, (n, seq)).astype(np.int32)}
        if positions:
            out["positions"] = np.tile(np.arange(seq, dtype=np.int32),
                                       (n, 1))
        return out
    return feed


def _dlrm_feed(rs, n):
    out = {"dense_input": rs.randn(n, 8).astype(np.float32)}
    for i in range(3):
        out[f"sparse_{i}"] = rs.randint(0, 50, (n, 3)).astype(np.int32)
    return out


def _uno_feed(rs, n):
    widths = {"dose1": 1, "dose2": 1, "cell_rnaseq": 942,
              "drug1_descriptors": 5270, "drug1_fingerprints": 2048,
              "drug2_descriptors": 5270, "drug2_fingerprints": 2048}
    return {k: rs.randn(n, w).astype(np.float32) for k, w in widths.items()}


def _named(ins, out):
    """(inputs by name, output) from a builder's return value."""
    flat = []
    for v in (ins.values() if isinstance(ins, dict) else
              ins if isinstance(ins, (list, tuple)) else [ins]):
        flat.extend(v if isinstance(v, list) else [v])
    return {t.owner_op.name: t for t in flat}, out


#: name -> (builder(pkg) -> build(ff, batch) -> (inputs, output), feed,
#: loss, classes (labels) or None (MSE targets))
ZOO = {
    "alexnet_cifar10": (
        lambda pkg: lambda ff, b: (
            (j_cnn if pkg is J else t_cnn).alexnet_cifar10(ff, b)),
        _image(32), SPARSE, 10),
    "inception_v3_stem": (
        lambda pkg: lambda ff, b: (
            (j_cnn if pkg is J else t_cnn).inception_v3_stem(
                ff, b, num_classes=10, image_size=43)),
        _image(43), SPARSE, 10),
    "candle_uno": (
        lambda pkg: lambda ff, b: (
            (j_cnn if pkg is J else t_cnn).candle_uno(
                ff, b, dense_layers=(32, 16),
                dense_feature_layers=(16, 8))),
        _uno_feed, MSE, None),
    "resnet_blocks": (_resnet_blocks, _image(32), SPARSE, 10),
    "vit": (
        lambda pkg: lambda ff, b: (j_vit.vit if pkg is J else t_vit)(
            ff, b, image_size=32, patch_size=8, hidden=64, layers=1,
            heads=1, num_classes=10),
        _image(32), SPARSE, 10),
    "dlrm": (
        lambda pkg: lambda ff, b: (lambda r: ((r[0], r[1]), r[2]))(
            (j_dlrm.dlrm if pkg is J else t_dlrm)(
                ff, b, embedding_size=16, embedding_entries=50,
                num_tables=3, indices_per_table=3, dense_dim=8,
                mlp_bot=(32, 16), mlp_top=(32, 1))),
        _dlrm_feed, MSE, None),
    "bert_base": (
        lambda pkg: lambda ff, b: (lambda r: ((r[0], r[1]), r[2]))(
            (j_bert if pkg is J else t_bert).bert_base(
                ff, b, seq_len=16, hidden=64, layers=2, heads=1,
                vocab_size=61)),
        _tokens(61, 16, positions=True), SPARSE, 2),
    "gpt_lm": (
        lambda pkg: lambda ff, b: (j_bert if pkg is J else t_bert).gpt_lm(
            ff, b, seq_len=16, hidden=64, layers=2, heads=2,
            vocab_size=53),
        _tokens(53, 16), SPARSE, 53),
}


def _compile(pkg, ff, out, loss):
    metric = ("METRICS_ACCURACY" if loss == SPARSE
              else "METRICS_MEAN_SQUARED_ERROR")
    ff.compile(pkg.SGDOptimizer(lr=LR), getattr(pkg.LossType, loss),
               [getattr(pkg.MetricsType, metric)], final_tensor=out)


def _labels(rs, out, classes, n):
    dims = (n,) + tuple(out.dims[1:])
    if classes is None:
        return rs.rand(*dims).astype(np.float32)
    return rs.randint(0, classes, dims[:-1] + (1,)).astype(np.int32)


def _np_tree(tree):
    return {op: {k: np.asarray(v.detach() if isinstance(v, torch.Tensor)
                               else v)
                 for k, v in ws.items()} for op, ws in tree.items()}


def numpy_init(mp):
    """Give the JAX executor numpy-drawn weights: its ``init_params``
    compiles one small program a weight shape (~0.3 s each here, 58 for
    the Inception stem), and the parity needs the same weights in both
    packages, not JAX's draws. Kernels glorot-uniform; biases, scales
    and the rest perturbed around their zero / one init, so every term of
    the gradients is exercised."""
    from flexflow_tpu.runtime import executor as jex

    def init_params(self, rng_key):
        rs = np.random.RandomState(11)
        shardings = self.param_shardings()
        params = {}
        for op in self.model.ops:
            if not op.weight_specs():
                continue
            ws = {}
            for spec in op.weight_specs():
                if (op.name, spec.name) in self.model._tied:
                    continue
                shape = tuple(spec.shape)
                if spec.init == "glorot":
                    fan_in, fan_out = spec.fan or (
                        int(np.prod(shape[:-1])), shape[-1])
                    lim = np.sqrt(6.0 / (fan_in + fan_out))
                    a = rs.uniform(-lim, lim, shape)
                else:
                    a = (spec.init == "one") + 0.1 * rs.randn(*shape)
                ws[spec.name] = jax.device_put(
                    a.astype(np.float32), shardings[op.name][spec.name])
            params[op.name] = ws
        return params

    mp.setattr(jex.GraphExecutor, "init_params", init_params)


def _build_pair(name):
    builder, _, loss, _ = ZOO[name]
    jff = J.FFModel(J.FFConfig(batch_size=B, mesh_shape={"data": 1},
                               seed=3))
    jins, jout = _named(*builder(J)(jff, B))
    _compile(J, jff, jout, loss)
    tff = T.FFModel(T.FFConfig(batch_size=B, seed=3), device="cpu")
    tins, tout = _named(*builder(T)(tff, B))
    _compile(T, tff, tout, loss)
    tff.params = params_from_jax(_np_tree(jff.params), "cpu",
                                 torch.float32, model=tff)
    tff.opt_state = tff.optimizer.init_state(tff.params)
    tff.bn_state = state_from_jax(_np_tree(jff.bn_state), "cpu", model=tff)
    return jff, tff, jins, tins, jout, tout


def zoo_pair(name):
    """(name, JAX model, port model, inputs of each, outputs of each) at
    initialisation, the JAX side on numpy weights and its flash
    kernels; undone when the generator closes."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FF_FORCE_FLASH_ATTENTION", "1")
    numpy_init(mp)
    yield (name,) + _build_pair(name)
    mp.undo()


#: the models this file holds; tests/test_torch_zoo_attention.py holds
#: the attention models (vit, bert_base, gpt_lm), so each file runs in
#: under a minute
CONV_ZOO = ["alexnet_cifar10", "inception_v3_stem", "candle_uno",
            "resnet_blocks", "dlrm"]


@pytest.fixture(scope="module", params=CONV_ZOO)
def pair(request):
    yield from zoo_pair(request.param)


def _batch(name, out, n, seed):
    _, feed, _, classes = ZOO[name]
    rs = np.random.RandomState(seed)
    batch = feed(rs, n)
    batch["label"] = _labels(rs, out, classes, n)
    return batch


def check_logits_loss_and_gradients(pair):
    """The logits (inference), the training loss and every gradient of
    one batch, port against JAX."""
    name, jff, tff, _, _, jout, tout = pair
    batch = _batch(name, tout, B, 0)
    inputs = {k: v for k, v in batch.items() if k != "label"}
    jlogits = jff.executor.make_forward([jout])(
        jff.params, jff.bn_state, inputs)[0]
    tlogits = tff.predict(inputs)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    loss_fn = jff.executor._make_loss_fn(jff.loss_type, jff.metric_types,
                                         jff._loss_tensor)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jff.params, jff.bn_state, batch, jax.random.PRNGKey(0))
    tloss, _, tgrads, _ = tff.executor._loss_and_grads(
        tff.params, tff._to_device(batch), tff.loss_type, tff.metric_types,
        tout)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    n = 0
    for op, ws in tgrads.items():
        for w, g in ws.items():
            ref = np.asarray(jgrads[op][w])
            np.testing.assert_allclose(
                g.numpy(), ref, rtol=0,
                atol=1e-4 * np.abs(ref).max() + 1e-6, err_msg=f"{op}.{w}")
            n += 1
    assert n == len(jax.tree_util.tree_leaves(jff.params)) > 3


def check_three_sgd_steps(pair):
    """Three batches, one epoch of ``fit`` in both packages: the losses,
    every weight and the BatchNorm state afterwards, and ``evaluate`` on a
    fresh batch (the running statistics, which it leaves as they are).
    Trains the pair: run it last."""
    name, jff, tff, jins, tins, jout, tout = pair
    data = _batch(name, tout, B * STEPS, 1)
    for k, v in data.items():
        J.SingleDataLoader(jff, jff.label_tensor if k == "label"
                           else jins[k], v)
        T.SingleDataLoader(tff, tff.label_tensor if k == "label"
                           else tins[k], v)
    init = _np_tree(tff.params)
    jff.fit(epochs=1, verbose=False)
    tff.fit(epochs=1, verbose=False)
    np.testing.assert_allclose(float(tff._last_loss),
                               float(jff._last_loss), **TOL)
    got, want = _np_tree(tff.params), _np_tree(jff.params)
    moved = 0
    for op, ws in want.items():
        for w, ref in ws.items():
            np.testing.assert_allclose(got[op][w], ref, **TOL,
                                       err_msg=f"{op}.{w}")
            moved += not np.array_equal(ref, init[op][w])
    assert moved > 3
    jstate, tstate = _np_tree(jff.bn_state), _np_tree(tff.bn_state)
    assert set(jstate) == set(tstate)
    for op, ws in jstate.items():
        for k, ref in ws.items():
            np.testing.assert_allclose(tstate[op][k], ref, **STATE_TOL,
                                       err_msg=f"{op}.{k}")
    batch = _batch(name, tout, B, 2)
    before = _np_tree(tff.bn_state)
    jloss, _, _ = jff.evaluate(batch)
    tloss, _, _ = tff.evaluate(batch)
    np.testing.assert_allclose(tloss, jloss, **TOL)
    for op, ws in before.items():
        for k, v in ws.items():
            np.testing.assert_array_equal(tff.bn_state[op][k].numpy(), v)


def test_logits_loss_and_every_gradient_match_jax(pair):
    check_logits_loss_and_gradients(pair)


def test_three_sgd_steps_through_fit_match_jax(pair):
    check_three_sgd_steps(pair)


def test_port_resnet50_trains_at_image_32():
    """The port's own full-depth resnet50 at image 32 and 10 classes (53
    convs and 53 BatchNorms, 214 leaves) builds, and four SGD steps on one
    repeated batch lower its loss; every BatchNorm's running mean
    moved."""
    torch.manual_seed(0)
    ff = T.FFModel(T.FFConfig(batch_size=4, seed=0), device="cpu")
    x, out = t_cnn.resnet50(ff, 4, num_classes=10, image_size=32)
    ff.compile(T.SGDOptimizer(lr=0.002),
               T.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [T.MetricsType.METRICS_ACCURACY], final_tensor=out)
    bns = [op for op in ff.ops if op.stateful]
    assert len(bns) == 53 and len(ff.bn_state) == 53
    assert sum(len(ws) for ws in ff.params.values()) == 53 * 4 + 2
    rs = np.random.RandomState(0)
    batch = {"input": rs.randn(4, 3, 32, 32).astype(np.float32),
             "label": rs.randint(0, 10, (4, 1)).astype(np.int32)}
    losses = [float(ff._run_train_step(batch)[0]) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert all(not torch.equal(s["mean"], torch.zeros_like(s["mean"]))
               for s in ff.bn_state.values())


# ---- tie_weights --------------------------------------------------------


def _denses(pkg):
    """input -> a -> b -> d (6 x 6 kernels) -> c (6 x 4, biased)."""
    ff = pkg.FFModel(pkg.FFConfig(batch_size=2, **(
        {"mesh_shape": {"data": 1}} if pkg is J else {})),
        **({} if pkg is J else {"device": "cpu"}))
    x = ff.create_tensor([2, 6], name="input")
    t = x
    for name in "abd":
        t = ff.dense(t, 6, use_bias=False, name=name)
    return ff, x, ff.dense(t, 4, name="c")


@pytest.mark.parametrize("args,match", [
    (("b", "kernel", "a", "kernel", "flip"), "transform"),
    (("b", "kernel", "nope", "kernel"), "no op named 'nope'"),
    (("b", "kernel", "a", "bias"), "has no weight 'bias'"),
    (("b", "bias", "a", "kernel"), "has no weight 'bias'"),
    (("c", "kernel", "a", "kernel"), "shape mismatch"),
], ids=["transform", "no-op", "no-src-weight", "no-dst-weight", "shape"])
def test_tie_weights_refusals_match_jax(args, match):
    for pkg in (J, T):
        ff, _, _ = _denses(pkg)
        with pytest.raises(ValueError, match=match):
            ff.tie_weights(*args)


def test_tie_weights_chain_and_late_refusals():
    """A tied source, a tie of a tied destination and a tie of a source as
    destination are refused, in both packages; so is a tie after
    compile."""
    for pkg in (J, T):
        ff, _, out = _denses(pkg)
        ff.tie_weights("b", "kernel", "a", "kernel")
        with pytest.raises(ValueError, match="itself tied"):
            ff.tie_weights("d", "kernel", "b", "kernel")
        with pytest.raises(ValueError, match="already tied"):
            ff.tie_weights("b", "kernel", "a", "kernel", "transpose")
        with pytest.raises(ValueError, match="SOURCE of an existing tie"):
            ff.tie_weights("a", "kernel", "d", "kernel")
        ff.compile(pkg.SGDOptimizer(lr=0.1), final_tensor=out)
        with pytest.raises(ValueError, match="before compile"):
            ff.tie_weights("b", "kernel", "a", "kernel", "transpose")
        with pytest.raises(ValueError, match="tied to a.kernel"):
            ff.set_weights("b", "kernel", np.zeros((6, 6), np.float32))


def test_tied_gradients_sum_into_the_source_leaf():
    """b's kernel is a's, transposed: the destination owns no leaf
    (weights, optimizer and weight_shapes never see it), the gradient of
    a's leaf is the sum of both uses', and it matches JAX's; get_weights
    reads the destination through the tie."""
    trees = {}
    for pkg in (J, T):
        ff, x, out = _denses(pkg)
        ff.tie_weights("b", "kernel", "a", "kernel", "transpose")
        ff.compile(pkg.SGDOptimizer(lr=0.1),
                   pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   [pkg.MetricsType.METRICS_ACCURACY], final_tensor=out)
        trees[pkg] = (ff, out)
    jff, _ = trees[J]
    tff, tout = trees[T]
    assert tff.weight_shapes() == {"a": {"kernel": (6, 6)}, "b": {},
                                   "d": {"kernel": (6, 6)},
                                   "c": {"kernel": (6, 4), "bias": (4,)}}
    assert "kernel" not in jff.params["b"]
    tff.params = params_from_jax(_np_tree(jff.params), "cpu",
                                 torch.float32, model=tff)
    np.testing.assert_array_equal(tff.get_weights("b"),
                                  tff.get_weights("a").T)
    rs = np.random.RandomState(0)
    batch = {"input": rs.randn(2, 6).astype(np.float32),
             "label": rs.randint(0, 4, (2, 1)).astype(np.int32)}
    loss_fn = jff.executor._make_loss_fn(jff.loss_type, jff.metric_types,
                                         jff._loss_tensor)
    _, jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jff.params, jff.bn_state, batch, jax.random.PRNGKey(0))
    _, _, tgrads, _ = tff.executor._loss_and_grads(
        tff.params, tff._to_device(batch), tff.loss_type, tff.metric_types,
        tout)
    assert set(tgrads["b"]) == set()
    np.testing.assert_allclose(tgrads["a"]["kernel"].numpy(),
                               np.asarray(jgrads["a"]["kernel"]), **TOL)
    # the sum of both uses: a's own gradient alone differs from it
    a = tff.params["a"]["kernel"].detach()
    b_own = a.t().clone().requires_grad_()
    a_own = a.clone().requires_grad_()
    xin = torch.as_tensor(batch["input"])
    h = (xin @ a_own) @ b_own @ tff.params["d"]["kernel"].detach()
    logits = h @ tff.params["c"]["kernel"].detach() \
        + tff.params["c"]["bias"].detach()
    loss = torch.nn.functional.cross_entropy(
        logits, torch.as_tensor(batch["label"][:, 0]).long())
    ga, gb = torch.autograd.grad(loss, [a_own, b_own])
    torch.testing.assert_close(tgrads["a"]["kernel"], ga + gb.t(),
                               rtol=1e-6, atol=1e-7)
    assert not torch.allclose(ga, ga + gb.t())
