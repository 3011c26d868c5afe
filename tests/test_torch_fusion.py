"""The PyTorch port's ``apply_fusion`` (``FFConfig.perform_fusion``) and
``FusedOp`` against the JAX package's, and fused training against the
port's unfused training.

On the same graphs in both packages — the JAX package's own fusion test
graph (dense, relu, scale, dense, gelu, dense), a tensor with two
consumers, a final tensor inside a chain, a ResNet of ``_bottleneck``
blocks (its add + ReLU tails fuse) and a BatchNorm leading a ReLU — the
groups (leader and member names) and the count of ops eliminated equal
JAX's. A protected tensor (the final tensor, a MoE's aux loss) is never
swallowed. Training: the fused ResNet and the BatchNorm-led graph are
held to JAX as the zoo models are (tests/test_torch_zoo.py: logits, loss,
every gradient, 3 SGD steps through ``fit``, ``evaluate``, BatchNorm
state), and a fused graph whose group holds a dropout draws and trains
bitwise what the unfused graph does.

Tolerances, f32: outputs and losses 1e-5; gradients 1e-4 of their
largest value plus 1e-6; weights after 3 steps 1e-5; BatchNorm state
1e-6; the port against itself: bitwise.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.ops.fused import FusedOp as JFusedOp
import flexflow_tpu_torch as T
from flexflow_tpu_torch.convert import params_from_jax, state_from_jax
from flexflow_tpu_torch.ops.fused import FusedOp
from test_torch_zoo import (B, ZOO, _compile, _image, _named, _np_tree,
                            _resnet_blocks, check_logits_loss_and_gradients,
                            check_three_sgd_steps, numpy_init)


def _chain(pkg):
    """The JAX package's tests/test_fusion.py graph."""
    def build(ff, b):
        x = ff.create_tensor([b, 32], name="input")
        t = ff.dense(x, 64, name="fc1")
        t = ff.relu(t, name="act1")
        t = ff.scalar_multiply(t, 0.5, name="scale1")
        t = ff.dense(t, 32, name="fc2")
        t = ff.gelu(t, name="act2")
        return {"input": x}, ff.dense(t, 10, name="fc3")
    return build


def _two_consumers(pkg):
    def build(ff, b):
        x = ff.create_tensor([b, 16], name="input")
        t = ff.dense(x, 16, name="fc1")
        a = ff.relu(t, name="act")
        return {"input": x}, ff.add(t, a, name="resid")
    return build


def _final_inside(pkg):
    """The final tensor (act's) has a follower: it stays visible."""
    def build(ff, b):
        x = ff.create_tensor([b, 16], name="input")
        t = ff.dense(x, 8, name="fc1")
        out = ff.relu(t, name="act")
        ff.scalar_multiply(out, 2.0, name="after")
        return {"input": x}, out
    return build


def _bn_relu(pkg, dropout: float = 0.0):
    """A BatchNorm (relu off) leading a ReLU, and with ``dropout`` a
    Dropout, both fused onto it."""
    def build(ff, b):
        x = ff.create_tensor([b, 3, 8, 8], name="input")
        t = ff.conv2d(x, 4, 3, 3, 1, 1, 1, 1, name="conv")
        t = ff.batch_norm(t, relu=False, name="bn")
        t = ff.relu(t, name="act")
        if dropout:
            t = ff.dropout(t, dropout, name="drop")
        t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool")
        return {"input": x}, ff.dense(ff.flat(t, name="flat"), 5,
                                      name="fc")
    return build


GRAPHS = {"chain": _chain, "two_consumers": _two_consumers,
          "final_inside": _final_inside, "resnet_blocks": _resnet_blocks,
          "bn_relu": _bn_relu}
#: the fused zoo models held to JAX through training
ZOO["bn_relu"] = (_bn_relu, _image(8), "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY",
                  5)


def _groups(ff, fused_cls):
    return [(op.name, [m.name for m in op.members]) for op in ff.ops
            if isinstance(op, fused_cls)]


def _build(pkg, graph, fusion: bool):
    kw = {"mesh_shape": {"data": 1}} if pkg is J else {}
    ff = pkg.FFModel(pkg.FFConfig(batch_size=B, seed=3,
                                  perform_fusion=fusion, **kw),
                     **({} if pkg is J else {"device": "cpu"}))
    ins, out = _named(*GRAPHS[graph](pkg)(ff, B))
    return ff, ins, out


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_groups_and_eliminated_count_match_jax(graph, monkeypatch):
    numpy_init(monkeypatch)
    got = {}
    for pkg, cls in ((J, JFusedOp), (T, FusedOp)):
        ff, _, out = _build(pkg, graph, True)
        n = len(ff.ops)
        ff.compile(final_tensor=out)
        got[pkg] = (_groups(ff, cls), n - len(ff.ops))
    assert got[T] == got[J]
    tff_groups, eliminated = got[T]
    want = {"chain": 3, "two_consumers": 0, "final_inside": 1,
            "resnet_blocks": 3, "bn_relu": 1}[graph]
    assert eliminated == want
    if graph == "final_inside":   # "after" is not swallowed onto act
        assert tff_groups == [("fc1", ["act"])]


def _moe_relu_graph(pkg, ff):
    """MoE -> ReLU -> Dense -> ReLU, compiled with perform_fusion."""
    x = ff.create_tensor([2, 4, 8], name="input")
    t = ff.moe(x, 4, 16, name="moe")
    t = ff.relu(t, name="act")
    t = ff.dense(t, 8, name="fc")
    out = ff.relu(t, name="out_act")
    ff.compile(pkg.SGDOptimizer(lr=0.1),
               pkg.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
               [pkg.MetricsType.METRICS_MEAN_SQUARED_ERROR], final_tensor=out)
    rs = np.random.RandomState(0)
    return {"input": rs.randn(2, 4, 8).astype(np.float32),
            "label": rs.rand(2, 4, 8).astype(np.float32)}


def test_protected_aux_is_never_swallowed():
    """A MoE followed by a ReLU: the group would adopt the ReLU's single
    output and drop the MoE's aux from the value map, so the MoE does not
    lead (the JAX function fuses it, and its first training step then
    raises KeyError: see test_reference_fusion_drops_moe_aux); the final
    tensor stays the tail of its group."""
    ff = T.FFModel(T.FFConfig(batch_size=2, perform_fusion=True),
                   device="cpu")
    batch = _moe_relu_graph(T, ff)
    assert _groups(ff, FusedOp) == [("fc", ["out_act"])]
    assert len(ff.ops) == 4   # input, moe, act, fc + out_act
    loss, _ = ff._run_train_step(batch)
    assert np.isfinite(float(loss))


def test_reference_fusion_drops_moe_aux():
    """The departure pinned against the reference (ROADMAP.md §3, fault
    2): on the same graph the JAX package's apply_fusion lets the MoE lead
    a group whose FusedOp adopts the ReLU's single output, so the MoE's
    aux loss leaves the value map and the first training step raises
    KeyError naming the aux tensor."""
    jff = J.FFModel(J.FFConfig(batch_size=2, mesh_shape={"data": 1},
                               perform_fusion=True))
    batch = _moe_relu_graph(J, jff)
    assert _groups(jff, JFusedOp) == [("moe", ["act"]), ("fc", ["out_act"])]
    with pytest.raises(KeyError, match="owner=moe"):
        jff._run_train_step(batch)


def _fused_pair(name):
    """The zoo pair (tests/test_torch_zoo.py ``_build_pair``) with
    ``perform_fusion`` on in both packages."""
    mp = pytest.MonkeyPatch()
    numpy_init(mp)
    builder, _, loss, _ = ZOO[name]
    try:
        jff = J.FFModel(J.FFConfig(batch_size=B, mesh_shape={"data": 1},
                                   seed=3, perform_fusion=True))
        jins, jout = _named(*builder(J)(jff, B))
        _compile(J, jff, jout, loss)
    finally:
        mp.undo()
    tff = T.FFModel(T.FFConfig(batch_size=B, seed=3, perform_fusion=True),
                    device="cpu")
    tins, tout = _named(*builder(T)(tff, B))
    _compile(T, tff, tout, loss)
    assert _groups(tff, FusedOp) == _groups(jff, JFusedOp) != []
    tff.params = params_from_jax(_np_tree(jff.params), "cpu",
                                 torch.float32, model=tff)
    tff.opt_state = tff.optimizer.init_state(tff.params)
    tff.bn_state = state_from_jax(_np_tree(jff.bn_state), "cpu", model=tff)
    return name, jff, tff, jins, tins, jout, tout


@pytest.fixture(scope="module", params=["resnet_blocks", "bn_relu"])
def pair(request):
    return _fused_pair(request.param)


def test_fused_logits_loss_and_every_gradient_match_jax(pair):
    check_logits_loss_and_gradients(pair)


def test_fused_three_sgd_steps_through_fit_match_jax(pair):
    """Losses, weights and the BatchNorm state (kept under each group
    leader's name) after 3 steps."""
    name, _, tff, _, _, _, _ = pair
    if name == "bn_relu":
        assert [op.name for op in tff.ops if isinstance(op, FusedOp)] \
            == list(tff.bn_state) == ["bn"]
    check_three_sgd_steps(pair)


@pytest.mark.parametrize("graph", ["resnet_blocks", "bn_relu_dropout"])
def test_fused_training_is_bitwise_the_unfused(graph):
    """Three SGD steps through fit, fused and unfused, from the same seed:
    losses, every weight and the BatchNorm state bitwise; a dropout member
    keeps its own generator (the same masks as unfused)."""
    build = (_resnet_blocks(T) if graph == "resnet_blocks"
             else _bn_relu(T, dropout=0.3))
    runs = []
    for fusion in (False, True):
        ff = T.FFModel(T.FFConfig(batch_size=B, seed=9,
                                  perform_fusion=fusion), device="cpu")
        ins, out = _named(*build(ff, B))
        _compile(T, ff, out, "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY")
        rs = np.random.RandomState(1)
        size = ins["input"].dims[-1]
        T.SingleDataLoader(ff, ins["input"], rs.randn(
            3 * B, 3, size, size).astype(np.float32))
        T.SingleDataLoader(ff, ff.label_tensor, rs.randint(
            0, out.dims[-1], (3 * B, 1)).astype(np.int32))
        losses = []
        step = ff._run_train_step
        ff._run_train_step = lambda b, **kw: (
            lambda r: losses.append(float(r[0])) or r)(step(b, **kw))
        ff.fit(epochs=1, verbose=False)
        runs.append((ff, losses))
    (plain, lp), (fused, lf) = runs
    assert len(fused.ops) < len(plain.ops)
    if graph != "resnet_blocks":
        assert set(fused._generators) == set(plain._generators) == {"drop"}
    assert lf == lp and len(lf) == 3
    for op, ws in plain.params.items():
        for k, w in ws.items():
            assert torch.equal(fused.params[op][k], w), f"{op}.{k}"
    assert set(fused.bn_state) == set(plain.bn_state)
    for op, ws in plain.bn_state.items():
        for k, v in ws.items():
            assert torch.equal(fused.bn_state[op][k], v), f"{op}.{k}"


def test_chip_smoke_fusion_count_is_jaxs(monkeypatch):
    """chip_smoke.py's phase 10 fuses its ResNet of bottleneck blocks (phase
    8's widths) and gates the ops eliminated at FUSION_ELIMINATED: the
    count the JAX package's apply_fusion takes from the same blocks here,
    and the port's on chip_smoke's own graph."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    numpy_init(monkeypatch)
    jff, _, jout = _build(J, "resnet_blocks", True)
    n = len(jff.ops)
    jff.compile(final_tensor=jout)
    tff = T.FFModel(T.FFConfig(batch_size=B, perform_fusion=True),
                    device="cpu")
    _, tout = smoke._zoo_resnet_blocks(T, tff, B)
    m = len(tff.ops)
    tff.compile(final_tensor=tout)
    assert n - len(jff.ops) == m - len(tff.ops) == smoke.FUSION_ELIMINATED
