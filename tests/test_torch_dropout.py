"""Dropout and attention dropout in the PyTorch port, by distribution.

The port cannot reproduce JAX's threefry bits: its masks come from a
``torch.Generator`` per drawing op, seeded from ``FFConfig.seed``, the op's
index and its own ``seed`` (``executor.op_generator_seed``) and advanced
by its draws, step after step. So the masks are held to their law, not to
JAX's bits: the identity at rate 0 and in inference; the kept share of n
elements within 4.5 binomial standard deviations of n * keep; every kept
value exactly x / keep (an IEEE division by keep in x's dtype, as JAX
divides); the same masks from the same seed and other masks from another;
two ops, and two steps of one op, agreeing on a share of positions
within 4.5 sigma of keep^2 + rate^2 (independent masks). Attention
dropout takes the JAX route: off the flash kernels, the mask on the
einsum branch's probabilities (rebuilt here from a copy of the
generator), and past the blockwise threshold on each key block's
probabilities with a mask hashed from one drawn seed, which the
backward's recomputation redraws exactly.
"""

import math

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as T
from flexflow_tpu_torch.ops import attention as attn
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.norm import dropout
from flexflow_tpu_torch.runtime.executor import op_generator_seed

SIGMAS = 4.5


def _within_binomial(k: int, n: int, p: float):
    sd = math.sqrt(n * p * (1 - p))
    assert abs(k - n * p) <= SIGMAS * sd, (k, n * p, sd)


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _dropout_model(rates=(0.3,), seed=0, batch=4, width=5000, **cfg):
    """input (batch, width) -> one dropout a rate, each on the input;
    compiled with SGD (no weights)."""
    ff = T.FFModel(T.FFConfig(batch_size=batch, seed=seed, **cfg),
                   device="cpu")
    x = ff.create_tensor([batch, width], name="input")
    outs = [ff.dropout(x, r, name=f"drop{i}") for i, r in enumerate(rates)]
    ff.compile(T.SGDOptimizer(lr=0.1),
               T.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
               [T.MetricsType.METRICS_MEAN_SQUARED_ERROR],
               final_tensor=outs[0])
    return ff, x, outs


def _step_outputs(ff, x, outs, xv):
    """One training walk of the graph (drawing from the model's
    generators): each dropout's output."""
    vals, _ = ff.executor.apply_graph(ff.params, {x: xv}, training=True,
                                      gens=ff._generators)
    return [vals[t] for t in outs]


@pytest.mark.parametrize("rate,training", [(0.0, True), (0.5, False)],
                         ids=["rate0", "eval"])
def test_identity_at_rate_0_and_in_inference(rate, training):
    ff, x, outs = _dropout_model((rate,))
    xv = torch.randn(4, 5000)
    vals, _ = ff.executor.apply_graph(ff.params, {x: xv}, training=training,
                                      gens=ff._generators)
    assert torch.equal(vals[outs[0]], xv)
    assert torch.equal(dropout(xv, 0.0, _gen()), xv)
    assert torch.equal(dropout(xv, 0.5, None), xv)


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_kept_share_within_binomial_bounds(rate):
    x = torch.rand(400, 1000) + 0.5          # no zero in x
    y = dropout(x, rate, _gen(int(rate * 10)))
    _within_binomial(int((y != 0).sum()), x.numel(), 1 - rate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kept_values_are_exactly_x_over_keep(dtype):
    """keep = 1 - rate in x's dtype (JAX's weakly typed python float), an
    IEEE division; zeros elsewhere."""
    rate = 0.3
    x = (torch.randn(300, 300, generator=_gen(1)) + 0.1).to(dtype)
    y = dropout(x, rate, _gen(2))
    kept = y != 0
    keep = torch.tensor(1 - rate, dtype=dtype)
    if dtype == torch.float32:
        want = torch.from_numpy(x.numpy() / np.float32(1 - rate))
    else:
        want = (x.double() / keep.double()).to(dtype)   # one rounding
    assert torch.equal(y[kept], want[kept])
    assert torch.equal(y[~kept], torch.zeros_like(y[~kept]))


def test_masks_reproducible_from_the_seed():
    xv = torch.rand(4, 5000) + 0.5
    a = _step_outputs(*_dropout_model(seed=7), xv)[0]
    b = _step_outputs(*_dropout_model(seed=7), xv)[0]
    c = _step_outputs(*_dropout_model(seed=8), xv)[0]
    assert torch.equal(a, b)
    assert not torch.equal(a != 0, c != 0)


def _agreement(m1, m2, keep):
    """Assert two masks agree on a share within SIGMAS of independent
    masks' keep^2 + (1 - keep)^2."""
    n = m1.numel()
    _within_binomial(int((m1 == m2).sum()), n, keep ** 2 + (1 - keep) ** 2)


def test_masks_independent_across_ops_and_steps():
    """Two dropouts of one input in one step, and one dropout's masks in
    two steps, agree only as independent masks do; each op's generator
    is seeded from its index (and its own seed)."""
    rate = 0.4
    ff, x, outs = _dropout_model((rate, rate))
    xv = torch.rand(4, 5000) + 0.5
    s1 = [o != 0 for o in _step_outputs(ff, x, outs, xv)]
    s2 = [o != 0 for o in _step_outputs(ff, x, outs, xv)]
    _agreement(s1[0], s1[1], 1 - rate)
    _agreement(s1[0], s2[0], 1 - rate)
    _agreement(s1[1], s2[1], 1 - rate)
    seeds = {op_generator_seed(0, i, 0) for i in (1, 2)}
    seeds.add(op_generator_seed(0, 1, 5))
    seeds.add(op_generator_seed(1, 1, 0))
    assert len(seeds) == 4


def test_dropout_trains_through_fit_and_the_scanned_steps():
    """A model with dropout before its head trains through ``fit`` per
    step and with ``scan_steps`` (the CPU's plain loop), from the same
    seed: the same masks, so the same losses; under accumulation each
    microbatch draws its own mask."""
    def run(**cfg):
        ff = T.FFModel(T.FFConfig(batch_size=4, seed=3, **cfg),
                       device="cpu")
        x = ff.create_tensor([4, 32], name="input")
        t = ff.dense(x, 64, T.ActiMode.AC_MODE_RELU, name="fc1")
        t = ff.dropout(t, 0.5, name="drop")
        out = ff.dense(t, 3, name="fc2")
        ff.compile(T.SGDOptimizer(lr=0.05),
                   T.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   [T.MetricsType.METRICS_ACCURACY], final_tensor=out)
        rs = np.random.RandomState(0)
        T.SingleDataLoader(ff, x, rs.randn(16, 32).astype(np.float32))
        T.SingleDataLoader(ff, ff.label_tensor,
                           rs.randint(0, 3, (16, 1)).astype(np.int32))
        losses = []
        step = ff._run_train_step

        def recording(batch, inject_nan=False):
            loss, mets = step(batch, inject_nan)
            losses.append(float(loss))
            return loss, mets
        ff._run_train_step = recording
        scanned = ff.train_scanned

        def recording_scan(n):
            ls, mets = scanned(n)
            losses.extend(float(v) for v in ls)
            return ls, mets
        ff.train_scanned = recording_scan
        ff.fit(epochs=1, verbose=False)
        return losses, ff
    per_step, ff = run()
    scanned, _ = run(scan_steps=2)
    assert per_step == scanned and len(per_step) == 4
    assert all(np.isfinite(per_step))
    accum, _ = run(grad_accum_steps=2)
    assert all(np.isfinite(accum)) and accum != per_step


# ---- attention dropout ----------------------------------------------------


def _mha_model(seq=16, dropout_rate=0.25, causal=False):
    ff = T.FFModel(T.FFConfig(batch_size=2, seed=1), device="cpu")
    x = ff.create_tensor([2, seq, 64], name="input")
    y = ff.multihead_attention(x, x, x, 64, 2, dropout=dropout_rate,
                               causal=causal, name="attn")
    ff.compile(T.SGDOptimizer(lr=0.1),
               T.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
               [T.MetricsType.METRICS_MEAN_SQUARED_ERROR], final_tensor=y)
    return ff, ff.get_op_by_name("attn")


@pytest.mark.parametrize("causal", [False, True])
def test_attention_dropout_masks_the_einsum_probabilities(causal,
                                                          monkeypatch):
    """In training with a generator the op leaves the flash route and
    masks the einsum branch's probabilities (the JAX route): its output
    is ``einsum_attention`` with ``norm.dropout`` of the probabilities,
    drawn from a copy of the generator; gradients flow; in inference the
    flash route runs (head dim 32) and nothing is drawn."""
    ff, op = _mha_model(causal=causal)
    calls = []
    real = kernels.flash_attention
    monkeypatch.setattr(kernels, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    p = ff.params["attn"]
    x = torch.randn(2, 16, 64, generator=_gen(4), requires_grad=True)
    gen = ff._generators["attn"]
    copy = torch.Generator()
    copy.set_state(gen.get_state())
    y = op.forward(p, [x] * 3, training=True, gen=gen)[0]
    assert not calls
    qh, kh, vh = op._project_qkv(p, x, x, x)
    ctx = attn.einsum_attention(qh, kh, vh, causal, op.scale, op.dropout,
                                copy)
    torch.testing.assert_close(y, op._out_proj(p, ctx), rtol=0, atol=0)
    assert not torch.equal(copy.get_state(), _gen(0).get_state())
    (gx,) = torch.autograd.grad(y.sum(), [x])
    assert torch.isfinite(gx).all()
    state = gen.get_state()
    y_eval = op.forward(p, [x] * 3, training=False, gen=gen)[0]
    assert calls and torch.equal(gen.get_state(), state)
    assert not torch.allclose(y_eval, y)


def test_only_ops_that_draw_get_a_generator():
    """A Dropout or an attention at rate 0 draws nothing, so it gets no
    generator (and a captured step registers none); each at a rate above
    0 gets its own."""
    ff = T.FFModel(T.FFConfig(batch_size=2, seed=1), device="cpu")
    x = ff.create_tensor([2, 8, 64], name="input")
    y = ff.multihead_attention(x, x, x, 64, 2, name="attn_plain")
    y = ff.multihead_attention(y, y, y, 64, 2, dropout=0.1,
                               name="attn_drop")
    y = ff.dropout(y, 0.0, name="drop_plain")
    y = ff.dropout(y, 0.2, name="drop")
    ff.compile(T.SGDOptimizer(lr=0.1),
               T.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
               [T.MetricsType.METRICS_MEAN_SQUARED_ERROR], final_tensor=y)
    assert sorted(ff._generators) == ["attn_drop", "drop"]
    assert sorted(ff.executor.init_generators()) == ["attn_drop", "drop"]


def test_hashed_keep_mask_law_and_determinism():
    seed = torch.tensor(123456789, dtype=torch.int64)
    m = attn.hashed_keep_mask(seed, (50, 64, 64), 0.7)
    _within_binomial(int(m.sum()), m.numel(), 0.7)
    assert torch.equal(m, attn.hashed_keep_mask(seed, (50, 64, 64), 0.7))
    other = attn.hashed_keep_mask(seed + 1, (50, 64, 64), 0.7)
    _agreement(m, other, 0.7)
    # consecutive elements of one mask are independent too
    flat = m.reshape(-1)
    _agreement(flat[:-1], flat[1:], 0.7)


def test_blockwise_attention_dropout_recomputes_its_masks():
    """Past the blockwise threshold the scan masks each key block's
    probabilities with a hashed mask of one seed drawn from the op's
    generator: the checkpointed scan's gradients (the backward
    recomputes each block) equal those of the scan taken straight, and
    the seed reproduces the output."""
    q, k, v = (torch.randn(1, 64, 2, 8, generator=_gen(i),
                           requires_grad=True) for i in range(3))
    seed = torch.tensor(-987654321, dtype=torch.int64)
    args = (True, 0.35, 16, 0.3, seed)
    straight = attn.blockwise_attention(q, k, v, *args)
    ck = torch.utils.checkpoint.checkpoint(attn.blockwise_attention, q, k,
                                           v, *args, use_reentrant=False)
    assert torch.equal(straight, ck)
    cot = torch.randn(straight.shape, generator=_gen(9))
    g1 = torch.autograd.grad((straight * cot).sum(), [q, k, v])
    g2 = torch.autograd.grad((ck * cot).sum(), [q, k, v])
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    plain = attn.blockwise_attention(q, k, v, True, 0.35, 16)
    assert not torch.allclose(plain, straight)


def test_mha_takes_the_blockwise_route_with_dropout_past_the_threshold(
        monkeypatch):
    """Past ``BLOCKWISE_SEQ_THRESHOLD`` (lowered to 32 here) the training
    op with dropout runs the blockwise scan with a seed drawn from its
    generator."""
    monkeypatch.setattr(attn, "BLOCKWISE_SEQ_THRESHOLD", 32)
    seen = []
    real = attn.blockwise_attention

    def spy(q, k, v, causal, scale, block, rate=0.0, seed=None):
        seen.append((block, rate, seed))
        return real(q, k, v, causal, scale, block, rate, seed)
    monkeypatch.setattr(attn, "blockwise_attention", spy)
    ff, op = _mha_model(seq=64)
    x = torch.randn(2, 64, 64, generator=_gen(5), requires_grad=True)
    y = op.forward(ff.params["attn"], [x] * 3, training=True,
                   gen=ff._generators["attn"])[0]
    (gx,) = torch.autograd.grad(y.sum(), [x])
    assert torch.isfinite(gx).all()
    assert seen and seen[0][1] == op.dropout and seen[0][2] is not None
