"""The port's ops against the JAX package's, op by op.

One small Llama (hidden 64, 2 layers, 4 heads over 2 kv heads, vocab 89,
f32) is built in both packages, so the ops share names; JAX's initialised
weights are carried into the port. Each op runs on the same numpy inputs
in both. Tolerance 1e-5 (f32; matrix products sum in different orders).
The attention paths run their kernels' plain versions here — the JAX side
its einsum paths, which the JAX tests pin to its Pallas kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu.ops.attention import _apply_rope as j_apply_rope
from flexflow_tpu.ops.sampling import sample_tokens as j_sample_tokens
from flexflow_tpu.ops.sampling import validate_sampling as j_validate
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import llama_lm
from flexflow_tpu_torch.ops.attention import _apply_rope
from flexflow_tpu_torch.ops.sampling import sample_tokens, validate_sampling

VOCAB = 89
HIDDEN = 64
ARCH = dict(seq_len=16, hidden=HIDDEN, layers=2, heads=4, kv_heads=2,
            vocab_size=VOCAB)
TOL = dict(rtol=1e-5, atol=1e-5)


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
