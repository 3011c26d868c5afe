"""The port's ops against the JAX package's, op by op.

One small Llama (hidden 64, 2 layers, 4 heads over 2 kv heads, vocab 89,
f32) and one small encoder classifier with fused add + LayerNorm (hidden
128, 1 layer, 4 heads) are built in both packages, so the ops share names;
JAX's initialised weights are carried into the port. Each op runs on the
same numpy inputs in both. Tolerance 1e-5 (f32; matrix products sum in
different orders); gradients (the training ops, through jax.vjp and torch
autograd with one numpy cotangent) 1e-4 relative and 1e-5 absolute. The
attention paths run their kernels' plain versions here — the JAX side its
einsum paths, or its Pallas kernels in interpret mode where a test forces
them (FF_FORCE_FLASH_ATTENTION=1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu.models.transformer import \
    build_encoder_classifier as j_build_encoder
from flexflow_tpu.ops.attention import _apply_rope as j_apply_rope
from flexflow_tpu.ops.sampling import sample_tokens as j_sample_tokens
from flexflow_tpu.ops.sampling import validate_sampling as j_validate
from flexflow_tpu.runtime.loss import compute_loss as j_compute_loss
from flexflow_tpu.runtime.metrics import batch_metrics as j_batch_metrics
from flexflow_tpu.ffconst import LossType as JLoss
from flexflow_tpu.ffconst import MetricsType as JMetrics
from flexflow_tpu_torch import FFConfig, FFModel, LossType, MetricsType
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import build_encoder_classifier, llama_lm
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.attention import _apply_rope
from flexflow_tpu_torch.ops.sampling import sample_tokens, validate_sampling
from flexflow_tpu_torch.runtime.loss import compute_loss
from flexflow_tpu_torch.runtime.metrics import batch_metrics

VOCAB = 89
HIDDEN = 64
ARCH = dict(seq_len=16, hidden=HIDDEN, layers=2, heads=4, kv_heads=2,
            vocab_size=VOCAB)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ENC = dict(seq_len=12, hidden=128, layers=1, heads=4, num_classes=16)


@pytest.fixture(scope="module")
def models():
    jff = JModel(JConfig(batch_size=2, mesh_shape={"data": 1}))
    _, logits = j_llama_lm(jff, 2, **ARCH)
    jff.compile(final_tensor=logits)
    tff = FFModel(FFConfig(batch_size=2), device="cpu")
    _, logits = llama_lm(tff, 2, **ARCH)
    tff.compile(final_tensor=logits)
    tff.params = params_from_jax(
        {op: {w: np.asarray(a) for w, a in ws.items()}
         for op, ws in jff.params.items()}, "cpu", torch.float32, model=tff)
    return jff, tff


@pytest.fixture(scope="module")
def enc_models():
    jff = JModel(JConfig(batch_size=2, mesh_shape={"data": 1},
                         use_fused_ln=True))
    _, out = j_build_encoder(jff, 2, **ENC)
    jff.compile(final_tensor=out)
    tff = FFModel(FFConfig(batch_size=2, use_fused_ln=True), device="cpu")
    _, out = build_encoder_classifier(tff, 2, **ENC)
    tff.compile(final_tensor=out)
    tff.params = params_from_jax(
        {op: {w: np.asarray(a) for w, a in ws.items()}
         for op, ws in jff.params.items()}, "cpu", torch.float32, model=tff)
    return jff, tff


def _pair(models, name):
    jff, tff = models
    jop, top = jff.get_op_by_name(name), tff.get_op_by_name(name)
    assert type(jop).__name__ == type(top).__name__
    jp = {k: jnp.asarray(v) for k, v in jff.params.get(name, {}).items()}
    return jop, jp, top, tff.params.get(name, {})


def _run_both(models, name, xs_np):
    jop, jp, top, tp = _pair(models, name)
    jout = jop.forward(jp, [jnp.asarray(x) for x in xs_np])[0]
    with torch.inference_mode():
        tout = top.forward(tp, [torch.as_tensor(x) for x in xs_np])[0]
    return np.asarray(jout), tout.numpy()


@pytest.mark.parametrize("name", ["ln1_0", "ln_f"])
def test_rmsnorm(models, name):
    x = np.random.RandomState(0).randn(2, 5, HIDDEN).astype(np.float32)
    np.testing.assert_allclose(*_run_both(models, name, [x]), **TOL)


@pytest.mark.parametrize("name", ["ffn_gate_0", "ffn_down_1", "lm_head"])
def test_linear(models, name):
    jop = models[0].get_op_by_name(name)
    x = np.random.RandomState(1).randn(2, 5, jop.in_dim).astype(np.float32)
    np.testing.assert_allclose(*_run_both(models, name, [x]), **TOL)


def test_embedding(models):
    ids = np.random.RandomState(2).randint(0, VOCAB, size=(2, 7))
    ids = ids.astype(np.int32)
    jout, tout = _run_both(models, "tok_embed", [ids])
    np.testing.assert_array_equal(jout, tout)   # a gather: exact


@pytest.mark.parametrize("name,arity", [("ffn_sig_0", 1), ("res1_0", 2),
                                        ("ffn_silu_1", 2)])
def test_elementwise(models, name, arity):
    rs = np.random.RandomState(3)
    xs = [rs.randn(2, 5, HIDDEN).astype(np.float32) for _ in range(arity)]
    np.testing.assert_allclose(*_run_both(models, name, xs), **TOL)


@pytest.mark.parametrize("offset", ["scalar", "per_row"])
def test_apply_rope(offset):
    rs = np.random.RandomState(4)
    x = rs.randn(3, 6, 4, 16).astype(np.float32)
    off = 9 if offset == "scalar" else np.asarray([0, 37, 500], np.int32)
    jout = j_apply_rope(jnp.asarray(x), 10000.0,
                        off if offset == "scalar" else jnp.asarray(off))
    tout = _apply_rope(torch.as_tensor(x), 10000.0,
                       off if offset == "scalar" else torch.as_tensor(off))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_mha_prefill_forward(models):
    """Whole-prompt attention (the flash kernel's plain version) and the
    contiguous cache it fills."""
    jop, jp, top, tp = _pair(models, "attn_0")
    x = np.random.RandomState(5).randn(2, 12, HIDDEN).astype(np.float32)
    jout, jcache = jop.prefill_forward(
        jp, [jnp.asarray(x)] * 3, jop.init_cache(2, 16, jnp.float32))
    with torch.inference_mode():
        tout, tcache = top.prefill_forward(
            tp, [torch.as_tensor(x)] * 3,
            top.init_cache(2, 16, torch.float32, torch.device("cpu")))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                   **TOL)


def test_mha_paged_decode_forward(models):
    """One decode step over a scrambled paged pool with ragged prompts and
    an inactive slot: the output (the paged kernel's plain version) and
    the appended pool agree with JAX's einsum path."""
    jop, jp, top, tp = _pair(models, "attn_1")
    rs = np.random.RandomState(6)
    kvh, hd, ps = jop.num_kv_heads, jop.qk_head_dim, 4
    pool = {n: rs.randn(10, ps, kvh, hd).astype(np.float32)
            for n in ("k", "v")}
    x = rs.randn(3, 1, HIDDEN).astype(np.float32)
    table = np.asarray([[5, 2, 7, 1], [3, 6, 4, 8], [0, 0, 0, 0]], np.int32)
    wp = np.asarray([9, 13, 0], np.int32)
    rope = np.asarray([4, 12, 0], np.int32)
    row_len = np.asarray([3, 7, 0], np.int32)
    pad = np.asarray([8, 8, 0], np.int32)
    ints = (table, wp, rope, row_len, pad)
    jout, jpool = jop.paged_decode_forward(
        jp, [jnp.asarray(x)] * 3, {n: jnp.asarray(a) for n, a in pool.items()},
        *map(jnp.asarray, ints), impl="einsum")
    tpool = {n: torch.as_tensor(a.copy()) for n, a in pool.items()}
    with torch.inference_mode():
        tout, tpool = top.paged_decode_forward(
            tp, [torch.as_tensor(x)] * 3, tpool, *map(torch.as_tensor, ints))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tpool[n].numpy(), np.asarray(jpool[n]),
                                   **TOL)


def test_greedy_sampling_takes_first_maximum():
    """Greedy sampling is argmax of the f32 logits, first maximum on ties,
    as the JAX sampler's temperature-0 rows."""
    logits = np.random.RandomState(8).randn(4, 50).astype(np.float32)
    logits[1, [3, 17]] = 9.0      # a two-way tie
    logits[2, :] = 0.0            # all tied
    b = logits.shape[0]
    jtok = j_sample_tokens(jnp.asarray(logits), jnp.zeros(b), jnp.ones(b),
                           jnp.zeros(b, jnp.int32), jnp.zeros(b, jnp.int32),
                           jnp.zeros(b, jnp.int32))
    tok = sample_tokens(torch.as_tensor(logits))
    assert tok.tolist() == np.asarray(jtok).tolist()
    assert tok[1] == 3 and tok[2] == 0


@pytest.mark.parametrize("args", [(-0.1, 1.0, 0), (float("nan"), 1.0, 0),
                                  (0.0, 0.0, 0), (0.0, 1.5, 0),
                                  (0.0, 1.0, -1)])
def test_validate_sampling_rejects_like_jax(args):
    with pytest.raises(ValueError):
        j_validate(*args)
    with pytest.raises(ValueError):
        validate_sampling(*args)


def _vjp_pair(models, name, xs_np, seed):
    """Outputs and the gradients of every weight and input of one op under
    training, in both packages, for the same random cotangents: (port
    outputs, JAX outputs, port gradients, JAX gradients) as numpy."""
    jop, jp, top, tp = _pair(models, name)
    jxs = [jnp.asarray(x) for x in xs_np]
    jouts, vjp = jax.vjp(lambda p, xs: tuple(jop.forward(p, xs,
                                                         training=True)),
                         jp, jxs)
    rs = np.random.RandomState(seed)
    cots = [rs.randn(*o.shape).astype(np.float32) for o in jouts]
    jgp, jgx = vjp(tuple(jnp.asarray(c) for c in cots))
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    txs = [torch.tensor(x, requires_grad=True) for x in xs_np]
    touts = top.forward(tp, txs, training=True)
    grads = torch.autograd.grad(touts, list(tp.values()) + txs,
                                [torch.as_tensor(c) for c in cots])
    want = [jgp[k] for k in tp] + list(jgx)
    assert len(touts) == len(jouts) and len(grads) == len(want)
    return ([o.detach().numpy() for o in touts],
            [np.asarray(o) for o in jouts], [g.numpy() for g in grads],
            [np.asarray(w) for w in want])


def _vjp_both(models, name, xs_np, seed):
    """``_vjp_pair``'s outputs within TOL and gradients within GRAD_TOL,
    elementwise."""
    touts, jouts, grads, want = _vjp_pair(models, name, xs_np, seed)
    for to, jo in zip(touts, jouts):
        np.testing.assert_allclose(to, jo, **TOL)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def test_layernorm_forward_and_grads(enc_models):
    x = np.random.RandomState(9).randn(2, 12, 128).astype(np.float32)
    _vjp_both(enc_models, "ln1_0", [x], 10)


@pytest.mark.parametrize("force", [False, True], ids=["plain", "pallas"])
def test_add_layernorm_forward_and_grads(enc_models, monkeypatch, force):
    """Both outputs and all four gradients; the JAX side through its
    plain branch or, forced, its Pallas kernel and custom VJP."""
    if force:
        monkeypatch.setenv("FF_FORCE_FLASH_ATTENTION", "1")
    rs = np.random.RandomState(11)
    xs = [(rs.randn(2, 12, 128) + 5.0).astype(np.float32),
          rs.randn(2, 12, 128).astype(np.float32)]
    _vjp_both(enc_models, "res1_ln2_0", xs, 12)


def test_mean_forward_and_grads(enc_models):
    x = np.random.RandomState(13).randn(2, 12, 128).astype(np.float32)
    _vjp_both(enc_models, "pool", [x], 14)


@pytest.mark.parametrize("route", ["einsum", "flash_function"])
@pytest.mark.parametrize("which", ["encoder", "llama_gqa"])
def test_mha_forward_and_grads(models, enc_models, monkeypatch, route,
                               which):
    """The dense training path: the encoder's non-causal attention and the
    Llama's causal GQA + RoPE attention. The port always runs the flash
    autograd Function (its plain versions on the CPU); the route picks
    the JAX side: its einsum path, or ("flash_function") its Pallas flash
    kernels in interpret mode."""
    pair, name, width = ((enc_models, "attn_0", 128) if which == "encoder"
                         else (models, "attn_0", HIDDEN))
    if route == "flash_function":
        monkeypatch.setenv("FF_FORCE_FLASH_ATTENTION", "1")
    rs = np.random.RandomState(15)
    xs = [rs.randn(2, 16, width).astype(np.float32) for _ in range(3)]
    _vjp_both(pair, name, xs, 16)


# ---- the routes off the kernels: shapes the kernels do not take ---------
#
# The JAX ops route these shapes off their Pallas kernels (attention.py
# _flash_ok, norm.py _fused_ok); on the CPU the JAX ops always take those
# routes. The port's ops route them by ``kernels.flash_attention_takes`` /
# ``fused_add_layernorm_takes`` to their own torch code, on the card too
# (tests/test_torch_cuda.py holds the card's route to the CPU's).

ROUTE_CASES = {
    # name: (q seq, kv seq, embed, heads, kv heads, kdim, vdim, causal,
    #        use_flash_attention)
    "head_dim_48_gqa": (10, 10, 96, 2, 1, 0, 0, True, True),
    "kdim_ne_vdim": (9, 9, 64, 2, 0, 64, 32, False, True),
    "causal_sq_gt_sk": (6, 3, 64, 2, 0, 0, 0, True, True),
    "flash_off": (12, 12, 64, 2, 0, 0, 0, True, False),
    "blockwise": (4160, 4160, 16, 2, 0, 0, 0, True, True),
}


def _single_op_models(build, flash=True):
    """One op built by ``build(ff)`` in both packages (batch 1 or 2), the
    JAX weights carried into the port."""
    jff = JModel(JConfig(batch_size=2, mesh_shape={"data": 1},
                         use_flash_attention=flash))
    out = build(jff)
    jff.compile(final_tensor=out)
    tff = FFModel(FFConfig(batch_size=2, use_flash_attention=flash),
                  device="cpu")
    out = build(tff)
    tff.compile(final_tensor=out)
    tff.params = params_from_jax(
        {op: {w: np.asarray(a) for w, a in ws.items()}
         for op, ws in jff.params.items()}, "cpu", torch.float32, model=tff)
    return jff, tff


def _route_close(names, touts, jouts, grads, want):
    """Outputs within 1e-5 (f32); each gradient within 1e-4 of its largest
    magnitude (sums over up to 4160 keys in other orders). The key bias's
    true gradient is zero (a bias shared by every key shifts a query's
    logits alike, which the softmax ignores): both packages return
    round-off for it, held below 1e-5 of the op's largest gradient."""
    for to, jo in zip(touts, jouts):
        np.testing.assert_allclose(to, jo, **TOL)
    top = max(np.abs(w).max() for w in want)
    for name, g, w in zip(names, grads, want):
        if name == "bias_k":
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-5 * top
        else:
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name


def _spy(monkeypatch, name):
    """Record each call of the kernel wrapper ``kernels.<name>`` (the CPU
    runs its plain version and counts no launch)."""
    calls = []
    fn = getattr(kernels, name)
    monkeypatch.setattr(kernels, name,
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_mha_torch_route_matches_jax(case, monkeypatch):
    """Forward and every gradient of an attention op whose shape the flash
    kernels do not take (head dim 48 under GQA; q and v head dims 32 and
    16; causal with 6 queries over 3 keys — its first 3 rows have no live
    key and come out uniform in both), or under use_flash_attention=False,
    and the blockwise scan past 4096 positions (2 heads of width 8,
    causal), against the JAX op."""
    sq, sk, e, h, kvh, kdim, vdim, causal, flash = ROUTE_CASES[case]
    b = 1 if case == "blockwise" else 2

    def build(ff):
        q = ff.create_tensor((b, sq, e))
        kv = ff.create_tensor((b, sk, e))
        return ff.multihead_attention(q, kv, kv, e, h, kdim=kdim, vdim=vdim,
                                      causal=causal, num_kv_heads=kvh,
                                      name="attn")

    jff, tff = _single_op_models(build, flash)
    top = tff.get_op_by_name("attn")
    qt = torch.zeros(b, sq, h, top.qk_head_dim)
    kt = torch.zeros(b, sk, h, top.qk_head_dim)
    vt = torch.zeros(b, sk, h, top.v_head_dim)
    assert not (flash and kernels.flash_attention_takes(qt, kt, vt, causal))
    rs = np.random.RandomState(17)
    xs = [rs.randn(b, n, e).astype(np.float32) for n in (sq, sk, sk)]
    calls = _spy(monkeypatch, "flash_attention")
    _route_close(list(tff.params["attn"]) + ["q", "k", "v"],
                 *_vjp_pair((jff, tff), "attn", xs, 18))
    assert not calls


def test_mha_prefill_forward_off_kernel_matches_jax(monkeypatch):
    """The prompt pass of a head-dim-48 GQA op (the dense route on
    broadcast kv heads) and the cache it fills, against the JAX op."""
    def build(ff):
        x = ff.create_tensor((1, 10, 96))
        return ff.multihead_attention(x, x, x, 96, 2, causal=True,
                                      num_kv_heads=1, name="attn")

    jff, tff = _single_op_models(build)
    jop, jp, top, tp = _pair((jff, tff), "attn")
    x = np.random.RandomState(19).randn(1, 10, 96).astype(np.float32)
    calls = _spy(monkeypatch, "flash_attention_fwd")
    jout, jcache = jop.prefill_forward(
        jp, [jnp.asarray(x)] * 3, jop.init_cache(1, 12, jnp.float32))
    with torch.inference_mode():
        tout, tcache = top.prefill_forward(
            tp, [torch.as_tensor(x)] * 3,
            top.init_cache(1, 12, torch.float32, torch.device("cpu")))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                   **TOL)
    assert not calls


def test_add_layernorm_torch_route_matches_jax(monkeypatch):
    """Both outputs and all four gradients of an add + LayerNorm whose
    rows (width 1004, not a multiple of 8) the kernel does not take,
    against the JAX op's plain branch."""
    def build(ff):
        x = ff.create_tensor((2, 5, 1004))
        r = ff.create_tensor((2, 5, 1004))
        return ff.add_layer_norm(x, r, name="add_ln")[1]

    jff, tff = _single_op_models(build)
    rs = np.random.RandomState(21)
    xs = [(rs.randn(2, 5, 1004) + 3.0).astype(np.float32),
          rs.randn(2, 5, 1004).astype(np.float32)]
    tparams = tff.params["add_ln"]
    x2 = torch.as_tensor(xs[0]).reshape(-1, 1004)
    assert not kernels.fused_add_layernorm_takes(x2, x2, tparams["scale"],
                                                 tparams["bias"])
    calls = _spy(monkeypatch, "fused_add_layernorm")
    _route_close(["scale", "bias", "x", "r"],
                 *_vjp_pair((jff, tff), "add_ln", xs, 22))
    assert not calls


def test_mha_training_dropout_is_refused(enc_models):
    """The name is from when attention dropout was refused in training;
    it is not any more, and this checks how it runs: with a generator the
    op draws its mask (tests/test_torch_dropout.py holds its law); without
    one it is the identity, as the JAX op without an rng; in inference it
    never draws."""
    top = enc_models[1].get_op_by_name("attn_0")
    p = enc_models[1].params["attn_0"]
    top.dropout = 0.5
    try:
        x = torch.randn(1, 4, 128, generator=torch.Generator().manual_seed(0))
        ref = top.forward(p, [x] * 3)[0]                       # inference
        torch.testing.assert_close(
            top.forward(p, [x] * 3, training=True)[0], ref)    # no rng
        gen = torch.Generator().manual_seed(1)
        state = gen.get_state()
        torch.testing.assert_close(
            top.forward(p, [x] * 3, training=False, gen=gen)[0], ref)
        assert torch.equal(gen.get_state(), state)
        dropped = top.forward(p, [x] * 3, training=True, gen=gen)[0]
        assert not torch.equal(gen.get_state(), state)
        assert not torch.allclose(dropped, ref)
    finally:
        top.dropout = 0.0


def _loss_inputs(loss: LossType):
    """(logits, labels) for one loss: class ids (one per position, with the
    trailing singleton dim) for sparse CE, probabilities for dense CE,
    targets for the rest."""
    rs = np.random.RandomState(17)
    logits = rs.randn(4, 3, 10).astype(np.float32)
    if loss == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        return logits, rs.randint(0, 10, (4, 3, 1)).astype(np.int32)
    if loss == LossType.LOSS_CATEGORICAL_CROSSENTROPY:
        p = rs.rand(4, 3, 10).astype(np.float32)
        return logits, p / p.sum(-1, keepdims=True)
    return logits, (logits + 0.4 * rs.randn(4, 3, 10)).astype(np.float32)


@pytest.mark.parametrize("loss", list(LossType), ids=lambda t: t.name)
def test_compute_loss_and_metrics_match_jax(loss):
    """Every loss, and the metrics that take its labels, against the JAX
    functions on the same logits and labels."""
    logits, labels = _loss_inputs(loss)
    jl = j_compute_loss(JLoss[loss.name], jnp.asarray(logits),
                        jnp.asarray(labels))
    tl = compute_loss(loss, torch.as_tensor(logits), torch.as_tensor(labels))
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    M = MetricsType
    metrics = {
        LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
            [M.METRICS_ACCURACY, M.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY],
        LossType.LOSS_CATEGORICAL_CROSSENTROPY:
            [M.METRICS_ACCURACY, M.METRICS_CATEGORICAL_CROSSENTROPY],
    }.get(loss, [M.METRICS_ACCURACY, M.METRICS_MEAN_SQUARED_ERROR,
                 M.METRICS_ROOT_MEAN_SQUARED_ERROR,
                 M.METRICS_MEAN_ABSOLUTE_ERROR])
    jm = j_batch_metrics(JLoss[loss.name], [JMetrics[m.name] for m in metrics],
                         jnp.asarray(logits), jnp.asarray(labels))
    tm = batch_metrics(loss, metrics, torch.as_tensor(logits),
                       torch.as_tensor(labels))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL,
                                   err_msg=k)
