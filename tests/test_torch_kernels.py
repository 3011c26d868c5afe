"""The port's five kernels (flexflow_tpu_torch/ops/kernels.py).

On the CPU (every test not marked ``cuda``): each kernel's plain PyTorch
version — what a wrapper runs for CPU tensors — is held against the JAX
package's Pallas kernel, run in interpret mode as tests/test_pallas_paged.py
runs it, and the autograd Functions against the JAX custom VJPs. Inputs
are made once with numpy and handed to both. Tolerances (f32): attention
and its lse 2e-5 (the online and the one-shot softmax sum in different
orders); the attention backward 1e-5 (sums over at most 48 keys or 32
queries in other orders); add + LayerNorm 1e-5 and its gradients 1e-5
relative; the prefill write bitwise. The CUDA kernels themselves are held
against these plain versions on the card by tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas_kernels import (flash_attention_bwd_pallas,
                                             flash_attention_fwd_pallas,
                                             fused_add_layernorm,
                                             fused_add_layernorm_fwd_pallas,
                                             paged_attention_fwd_pallas,
                                             paged_prefill_write_pallas)
from flexflow_tpu_torch.ops import kernels

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# ------------------------------------------------------- flash attention

FLASH_CASES = {
    # name: (B, Sq, Sk, H, KVH, D, causal)
    "causal": (2, 32, 32, 2, 2, 16, True),
    "non_causal": (2, 32, 32, 2, 2, 16, False),
    "sk_gt_sq_offset": (1, 16, 48, 2, 2, 16, True),
    "gqa": (2, 32, 32, 4, 2, 16, True),
    # the head dims kernels 1 and 2 take past 32 / 64 / 128 (bf16 on the
    # CUDA-core kernels): the Pallas blocks keep the head dim whole
    "head_dim_80": (1, 32, 32, 2, 2, 80, True),
    "head_dim_96": (1, 32, 48, 2, 2, 96, False),
    "head_dim_256": (1, 16, 32, 2, 2, 256, True),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_matches_pallas(case):
    b, sq, sk, h, kvh, d, causal = FLASH_CASES[case]
    rs = np.random.RandomState(1)
    q = rs.randn(b, sq, h, d).astype(np.float32)
    k = rs.randn(b, sk, kvh, d).astype(np.float32)
    v = rs.randn(b, sk, kvh, d).astype(np.float32)
    scale = d ** -0.5
    out = kernels.flash_attention_fwd(_t(q), _t(k), _t(v), causal, scale)
    assert out.shape == (b, sq, h, d)
    # the Pallas kernel takes MHA shapes: broadcast kv heads as the JAX
    # dense path does (_broadcast_kv, jnp.repeat over heads)
    kj = np.repeat(k, h // kvh, axis=2)
    vj = np.repeat(v, h // kvh, axis=2)
    ref, _ = flash_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(kj), jnp.asarray(vj), causal, scale,
        block_q=16, block_k=16, need_lse=False)
    ref = np.asarray(ref).reshape(b, h, sq, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


MHA_CASES = {k: v for k, v in FLASH_CASES.items() if v[3] == v[4]}


def _mha_inputs(case):
    b, sq, sk, h, _, d, causal = FLASH_CASES[case]
    rs = np.random.RandomState(2)
    q, do = (rs.randn(b, sq, h, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, sk, h, d).astype(np.float32) for _ in range(2))
    return q, k, v, do, causal, d ** -0.5


@pytest.mark.parametrize("case", list(MHA_CASES))
def test_flash_plain_lse_and_bwd_match_pallas(case):
    """The forward's lse and the backward's dq, dk, dv against the Pallas
    kernels (16-row blocks, so causal dead tiles are skipped there)."""
    q, k, v, do, causal, scale = _mha_inputs(case)
    b, sq, h, d = q.shape
    out, lse = kernels.flash_attention_fwd(_t(q), _t(k), _t(v), causal,
                                           scale, need_lse=True)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jout, jlse = flash_attention_fwd_pallas(jq, jk, jv, causal, scale,
                                            block_q=16, block_k=16)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jlse)[..., 0].reshape(b, h, sq), **TOL)
    jo = jout.reshape(b, h, sq, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), **TOL)
    grads = kernels.flash_attention_bwd(_t(q), _t(k), _t(v), out, lse,
                                        _t(do), causal, scale)
    refs = flash_attention_bwd_pallas(jq, jk, jv, jo, jlse, jdo, causal,
                                      scale, block_q=16, block_k=16)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", list(MHA_CASES))
def test_flash_autograd_matches_plain_autograd(case):
    """The autograd Function (plain forward with lse, plain backward) gives
    torch autograd's gradients of the plain forward."""
    q, k, v, do, causal, scale = _mha_inputs(case)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(kernels.flash_attention(*leaves, causal,
                                                      scale), leaves, _t(do))
    ref = torch.autograd.grad(kernels.flash_attention_plain(
        *leaves, causal, scale), leaves, _t(do))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _bwd_extras(q, do, jo, mode):
    """The (delta, dlse) pair of a ``mode``: a caller's delta (the rowsum
    of dO * O moved by noise, so a test sees whether it is used) and / or a
    random lse cotangent, both (B, H, Sq) f32."""
    b, sq, h, _ = q.shape
    rs = np.random.RandomState(6)
    delta = ((do * np.asarray(jo)).sum(-1).transpose(0, 2, 1)
             + 0.1 * rs.randn(b, h, sq)).astype(np.float32)
    dlse = rs.randn(b, h, sq).astype(np.float32)
    return (delta if "delta" in mode else None,
            dlse if "dlse" in mode else None)


@pytest.mark.parametrize("mode", ["dlse", "delta", "delta_dlse"])
@pytest.mark.parametrize("case", [c for c in MHA_CASES
                                  if not c.startswith("head_dim")
                                  or c == "head_dim_96"])
def test_flash_bwd_delta_and_dlse_match_pallas(case, mode):
    """The backward's ``delta`` / ``dlse`` entry against the Pallas
    backward's ``delta_precomputed`` / ``dlse`` (interpret mode); of the
    head dims past 32 / 64 / 128, 96 (the ring's entry at Phi-3-mini's
    heads; the others share its code)."""
    q, k, v, do, causal, scale = _mha_inputs(case)
    b, sq, h, d = q.shape
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jout, jlse = flash_attention_fwd_pallas(jq, jk, jv, causal, scale,
                                            block_q=16, block_k=16)
    jo = jout.reshape(b, h, sq, d).transpose(0, 2, 1, 3)
    delta, dlse = _bwd_extras(q, do, jo, mode)
    lse = _t(np.asarray(jlse)[..., 0].reshape(b, h, sq))
    grads = kernels.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(np.array(jo)), lse, _t(do), causal, scale,
        delta=None if delta is None else _t(delta),
        dlse=None if dlse is None else _t(dlse))
    refs = flash_attention_bwd_pallas(
        jq, jk, jv, jo, jlse, jdo, causal, scale, block_q=16, block_k=16,
        delta_precomputed=None if delta is None else jnp.asarray(delta),
        dlse=None if dlse is None else jnp.asarray(dlse))
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_flash_bwd_lse_cotangent_alone():
    """do = 0, dlse = w (tests/test_recurrent_flash.py's dlse case): the
    gradient flows through the lse alone, as the Pallas backward gives it,
    and dv is exactly 0 (the lse does not depend on v)."""
    b, s, h, d = 1, 64, 2, 16
    rs = np.random.RandomState(9)
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    w = rs.randn(b, h, s).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout, jlse = flash_attention_fwd_pallas(jq, jk, jv, False, scale)
    jo = jout.reshape(b, h, s, d).transpose(0, 2, 1, 3)
    zero = np.zeros_like(q)
    grads = kernels.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(np.array(jo)),
        _t(np.asarray(jlse)[..., 0].reshape(b, h, s)), _t(zero), False,
        scale, dlse=_t(w))
    refs = flash_attention_bwd_pallas(jq, jk, jv, jo, jlse,
                                      jnp.asarray(zero), False, scale,
                                      dlse=jnp.asarray(w))
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert np.abs(grads[2].numpy()).max() == 0


def test_flash_bwd_refuses_malformed_delta_and_dlse():
    q = torch.zeros(1, 8, 2, 16)
    lse = torch.zeros(1, 2, 8)
    for kw in (dict(delta=torch.zeros(1, 8, 2)),
               dict(dlse=torch.zeros(1, 2, 8, dtype=torch.float64))):
        with pytest.raises(ValueError, match="delta|dlse"):
            kernels.flash_attention_bwd(q, q, q, q, lse, q, False, 0.25, **kw)


def test_flash_bwd_refuses_grouped_query():
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="grouped-query"):
        kernels.flash_attention_bwd(q, kv, kv, q, torch.zeros(1, 4, 8), q,
                                    True, 0.25)


# ------------------------------------------------- fused add + layernorm

def _add_ln_inputs(n=24, d=128):
    rs = np.random.RandomState(4)
    # a residual stream whose mean dwarfs its spread (the two-pass variance)
    x = (rs.randn(n, d) + 20.0).astype(np.float32)
    r = rs.randn(n, d).astype(np.float32)
    scale = (rs.rand(d) + 0.5).astype(np.float32)
    bias = rs.randn(d).astype(np.float32)
    return x, r, scale, bias


def test_add_layernorm_plain_matches_pallas():
    args = _add_ln_inputs()
    s, y, mean, rstd = kernels.fused_add_layernorm_fwd(*map(_t, args), 1e-5)
    js, jy, jmean, jrstd = fused_add_layernorm_fwd_pallas(
        *map(jnp.asarray, args), 1e-5, block_n=8)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for got, ref in ((y, jy), (mean, np.asarray(jmean)[:, 0]),
                     (rstd, np.asarray(jrstd)[:, 0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    _, _, m2, r2 = kernels.fused_add_layernorm_fwd(*map(_t, args), 1e-5,
                                                   need_stats=False)
    assert m2 is None and r2 is None


def test_add_layernorm_autograd_matches_jax_grad():
    """Gradients of sum(sin(y)) + sum(cos(s)) through the autograd Function
    against jax.grad of the JAX fused_add_layernorm (its custom VJP), as
    tests/test_mfu_levers.py checks the JAX op."""
    args = _add_ln_inputs()

    def jloss(x, r, scale, bias):
        s, y = fused_add_layernorm(x, r, scale, bias)
        return jnp.sum(jnp.sin(y)) + jnp.sum(jnp.cos(s))

    refs = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    leaves = [_t(a).requires_grad_() for a in args]
    s, y = kernels.fused_add_layernorm(*leaves)
    grads = torch.autograd.grad(torch.sin(y).sum() + torch.cos(s).sum(),
                                leaves)
    for name, g, r in zip(("x", "r", "scale", "bias"), grads, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


# ------------------------------------------------------- paged attention

def _paged_inputs(rs, s: int):
    """3 slots over a 10-page pool of 4-position pages: slots 0/1 hold
    scrambled page tables with ragged prompts, slot 2 is inactive (zero
    table, frontier 0 — the engine's idle-slot state)."""
    b, h, kvh, d, ps = 3, 4, 2, 16, 4
    q = rs.randn(b, s, h, d).astype(np.float32)
    kp = rs.randn(10, ps, kvh, d).astype(np.float32)
    vp = rs.randn(10, ps, kvh, d).astype(np.float32)
    table = np.asarray([[5, 2, 7, 1], [3, 6, 4, 8], [0, 0, 0, 0]], np.int32)
    wp0 = np.asarray([9, 11, 0], np.int32)
    # per-position frontiers, nondecreasing, clamped to the slot budget
    wp = np.minimum(wp0[:, None] + np.arange(s)[None, :],
                    np.asarray([13, 15, 0])[:, None]).astype(np.int32)
    row_len = np.asarray([3, 7, 0], np.int32)
    prompt_pad = np.asarray([8, 8, 0], np.int32)
    return q, kp, vp, table, wp, row_len, prompt_pad


@pytest.mark.parametrize("s", [1, 3], ids=["decode", "slab3"])
def test_paged_plain_matches_pallas(s):
    rs = np.random.RandomState(3)
    args = _paged_inputs(rs, s)
    scale = 16 ** -0.5
    out = kernels.paged_attention_fwd(*map(_t, args), scale)
    ref = paged_attention_fwd_pallas(*map(jnp.asarray, args), scale)
    assert out.shape == args[0].shape
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _many_page_inputs(rs, s: int, quant: bool):
    """3 slots of 64 pages of 4 positions (256 positions), small widths: slot 0 a 200-position prompt then a slab,
    slot 1 a ragged prompt, 40 pages of dead bucket padding and a slab,
    slot 2 inactive. A quantized pool carries int8 payloads and random
    positive per-(page, kv head) scales."""
    b, h, kvh, d, ps, pps = 3, 4, 2, 16, 4, 64
    n_pool = b * pps + 1
    q = rs.randn(b, s, h, d).astype(np.float32)
    if quant:
        kp, vp = (rs.randint(-127, 128, (n_pool, ps, kvh, d)).astype(np.int8)
                  for _ in range(2))
        scales = tuple((rs.rand(n_pool, kvh) + 0.1).astype(np.float32)
                       / 127.0 for _ in range(2))
    else:
        kp, vp = (rs.randn(n_pool, ps, kvh, d).astype(np.float32)
                  for _ in range(2))
        scales = ()
    table = (rs.permutation(n_pool - 1)[:b * pps] + 1).reshape(b, pps)
    table = table.astype(np.int32)
    table[2] = 0
    row_len = np.asarray([200, 9, 0], np.int32)
    prompt_pad = np.asarray([200, 9 + 160, 0], np.int32)
    wp = np.minimum(np.asarray([200, 240, 0])[:, None]
                    + np.arange(s)[None, :], pps * ps - 1).astype(np.int32)
    wp[2] = 0
    return (q, kp, vp, table, wp, row_len, prompt_pad), scales


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("s", [1, 3], ids=["decode", "slab3"])
def test_paged_plain_matches_pallas_many_pages(s, quant):
    """The plain version the card holds the split-KV kernel to at long
    contexts, against the Pallas kernel (interpret mode) at a 64-page
    context with a long dead padding and an inactive slot."""
    rs = np.random.RandomState(6)
    args, scales = _many_page_inputs(rs, s, quant)
    scale = 16 ** -0.5
    kw = dict(zip(("k_scales", "v_scales"), map(_t, scales)))
    out = kernels.paged_attention_fwd(*map(_t, args), scale, **kw)
    jkw = dict(zip(("k_scales", "v_scales"), map(jnp.asarray, scales)))
    ref = paged_attention_fwd_pallas(*map(jnp.asarray, args), scale,
                                     interpret=True, **jkw)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


PLAN_SHAPES = {
    # name: (B, S, H, KVH, page_size, pages_per_slot)
    "serving": (4, 1, 32, 8, 128, 8),
    "long_context": (4, 1, 32, 8, 128, 64),
    "verify5": (4, 5, 32, 8, 128, 8),
    "small_pages": (3, 1, 8, 2, 16, 516),
    "many_slots": (64, 1, 32, 8, 128, 8),
    "one_page": (2, 1, 4, 4, 8, 1),
    "huge_table": (1, 1, 8, 1, 16, 8192),
}


@pytest.mark.parametrize("case", list(PLAN_SHAPES))
def test_paged_attention_plan(case):
    """The split plan depends on the shapes and the SM count alone: whole
    pages a split, every page in exactly one split, no split shorter than
    the minimum unless the table is, at most the cap, 16 query rows a row
    chunk, and at the serving shape on a 132-SM H100 well over one block
    an SM. With ``decode_splits`` the grid keeps the slab's row chunks and
    the splits are a decode step's whatever S (a verify slab's positions
    split their keys as decode steps do)."""
    b, s, h, kvh, ps, pps = PLAN_SHAPES[case]
    plan = kernels.paged_attention_plan(b, s, h, kvh, ps, pps, 132)
    chunks = -(-s * (h // kvh) // kernels.PAGED_ROWS)
    assert plan.grid == (b * kvh * chunks, plan.splits)
    as_decode = kernels.paged_attention_plan(b, s, h, kvh, ps, pps, 132,
                                             decode_splits=True)
    decode = kernels.paged_attention_plan(b, 1, h, kvh, ps, pps, 132)
    assert as_decode.grid == (b * kvh * chunks, decode.splits)
    assert (as_decode.splits, as_decode.split_pages) == (decode.splits,
                                                         decode.split_pages)
    assert 1 <= plan.split_pages <= pps
    assert (plan.splits - 1) * plan.split_pages < pps \
        <= plan.splits * plan.split_pages
    assert plan.split_pages * ps >= min(kernels.PAGED_MIN_SPLIT, pps * ps)
    assert plan.splits <= kernels.PAGED_MAX_SPLITS
    if plan.splits > 1:   # no more splits than the card needs
        assert b * kvh * chunks * (plan.splits - 1) \
            < kernels.PAGED_BLOCKS_PER_SM * 132 or \
            plan.split_pages * ps < 2 * kernels.PAGED_MIN_SPLIT
    if case == "serving":
        assert plan.blocks >= 1.5 * 132


# --------------------------------------------------- paged prefill write

@pytest.mark.parametrize("s", [8, 10], ids=["whole_pages", "padded_tail"])
def test_prefill_write_plain_bitwise_pallas(s):
    rs = np.random.RandomState(5)
    ps, kvh, d = 4, 2, 16
    pool_k = rs.randn(9, ps, kvh, d).astype(np.float32)
    pool_v = rs.randn(9, ps, kvh, d).astype(np.float32)
    kh = rs.randn(1, s, kvh, d).astype(np.float32)
    vh = rs.randn(1, s, kvh, d).astype(np.float32)
    pages = np.asarray([6, 2, 4][:-(-s // ps)], np.int32)
    tk, tv = _t(pool_k.copy()), _t(pool_v.copy())
    kernels.paged_prefill_write(tk, tv, _t(kh), _t(vh), _t(pages))
    ref = paged_prefill_write_pallas(
        {"k": jnp.asarray(pool_k), "v": jnp.asarray(pool_v)},
        jnp.asarray(kh), jnp.asarray(vh), pages)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(ref["k"]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(ref["v"]))
    # pages not listed are untouched
    keep = [p for p in range(9) if p not in pages]
    np.testing.assert_array_equal(tk.numpy()[keep], pool_k[keep])


GROUP_POOLS = ("native", "cast", "int8", "fp8")


def _np_pool(rs, kind, shape):
    """A numpy pool of ``kind`` filled with random values: f32 (native),
    bf16 (cast), int8 or fp8 e4m3fn payload."""
    x = rs.randn(*shape).astype(np.float32)
    if kind == "native":
        return x
    if kind == "cast":
        return x.astype(jnp.bfloat16)
    if kind == "int8":
        return rs.randint(-127, 128, shape).astype(np.int8)
    return (x * 100).clip(-448, 448).astype(jnp.float8_e4m3fn)


def _torch_of(a):
    """A numpy array (bf16 and fp8 through their bits) as a torch tensor."""
    if a.dtype == jnp.bfloat16:
        return _t(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype == jnp.float8_e4m3fn:
        return _t(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return _t(a)


def _bits_np(t):
    """The raw bits of a torch tensor (or a jax array) as numpy."""
    if isinstance(t, torch.Tensor):
        return t.view({1: torch.uint8, 2: torch.int16,
                       4: torch.int32}[t.element_size()]).numpy()
    a = np.asarray(t)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.itemsize])


@functools.lru_cache(maxsize=None)
def _pallas_write(pages: tuple):
    """``paged_prefill_write_pallas`` in interpret mode over ``pages``,
    jitted, so the layers of a test (and the tests of one shape) share one
    compile; jitted, its scales may sit one f32 step from the eager
    division (ROADMAP.md section 3 item 1)."""
    return jax.jit(functools.partial(paged_prefill_write_pallas,
                                     pages=np.asarray(pages, np.int32),
                                     interpret=True))


@pytest.mark.parametrize("layers", [1, 3], ids=["L1", "L3"])
@pytest.mark.parametrize("s", [1, 127, 128, 300, 512])
@pytest.mark.parametrize("kind", GROUP_POOLS)
def test_prefill_write_layers_plain_matches_jax(kind, s, layers):
    """``paged_prefill_write_layers`` (its plain version, on the CPU)
    writing every layer of a prefill into 128-row pages listed out of
    order, against the JAX package per layer: bitwise its eager scatter
    branch (payload, scales, the zero tail of a part-filled last page);
    against ``paged_prefill_write_pallas`` in interpret mode bitwise for
    the copy and the cast, and for int8 / fp8 scales within one f32 step
    (the compiled division, ROADMAP.md section 3 item 1) with the payload
    bitwise once quantized against the kernel's own scales. Pages not
    listed, and their scales, are untouched."""
    from flexflow_tpu.ops.attention import MultiHeadAttention as JMHA
    from flexflow_tpu.ops.attention import page_quantize as j_quantize
    from flexflow_tpu.ops.attention import storage_qmax as j_qmax

    rs = np.random.RandomState(s * 10 + layers)
    ps, kvh, d, n_pool = 128, 2, 16, 6
    n_pages = -(-s // ps)
    pages = np.asarray([4, 1, 5, 2][:n_pages], np.int32)
    quant = kind in ("int8", "fp8")
    shape = (n_pool, ps, kvh, d)
    init = [{n: _np_pool(rs, kind, shape) for n in ("k", "v")}
            for _ in range(layers)]
    if quant:
        for pool in init:
            for n in ("k_scale", "v_scale"):
                pool[n] = rs.rand(n_pool, kvh).astype(np.float32)
    slabs = [{n: (rs.randn(1, s, kvh, d) * (3.0 if n == "k" else 0.05))
              .astype(np.float32) for n in ("k", "v")}
             for _ in range(layers)]
    tpools = [{n: _torch_of(a.copy()) for n, a in pool.items()}
              for pool in init]
    kernels.paged_prefill_write_layers(
        [p["k"] for p in tpools], [p["v"] for p in tpools],
        [_t(x["k"]) for x in slabs], [_t(x["v"]) for x in slabs],
        _t(pages), [p["k_scale"] for p in tpools] if quant else None,
        [p["v_scale"] for p in tpools] if quant else None)
    keep = [p for p in range(n_pool) if p not in pages]
    for pool, tpool, slab in zip(init, tpools, slabs):
        jpool = {n: jnp.asarray(a) for n, a in pool.items()}
        kh, vh = jnp.asarray(slab["k"]), jnp.asarray(slab["v"])
        eager = JMHA.paged_prefill_write(None, jpool, kh, vh,
                                         jnp.asarray(pages))
        pallas = _pallas_write(tuple(pages))(jpool, kh, vh)
        for name in pool:
            got = _bits_np(tpool[name])
            np.testing.assert_array_equal(got, _bits_np(eager[name]),
                                          err_msg=name)
            np.testing.assert_array_equal(got[keep], _bits_np(pool[name])
                                          [keep], err_msg=name)
            if not quant:
                np.testing.assert_array_equal(got, _bits_np(pallas[name]),
                                              err_msg=name)
        if not quant:
            continue
        qmax = j_qmax(pool["k"].dtype)
        for name in ("k", "v"):
            ours = _bits_np(tpool[name + "_scale"])[pages].astype(np.int64)
            theirs = np.asarray(pallas[name + "_scale"])[pages]
            steps = np.abs(ours - theirs.view(np.int32).astype(np.int64))
            assert steps.max() <= 1, name
            pf = np.zeros((n_pages * ps, kvh, d), np.float32)
            pf[:s] = slab[name][0]
            want = j_quantize(jnp.asarray(pf.reshape(n_pages, ps, kvh, d)),
                              jnp.asarray(theirs), qmax, pool[name].dtype)
            np.testing.assert_array_equal(
                _bits_np(want), _bits_np(pallas[name])[pages], err_msg=name)


def test_prefill_write_layers_refuses_unequal_lists():
    pool = torch.zeros(3, 4, 1, 16)
    slab = torch.zeros(1, 4, 1, 16)
    pages = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="equal-length"):
        kernels.paged_prefill_write_layers([pool, pool], [pool], [slab],
                                           [slab], pages)
    with pytest.raises(ValueError, match="equal-length"):
        kernels.paged_prefill_write_layers([], [], [], [], pages)


@pytest.mark.parametrize("case", [(128, 128, 1), (16, 64, 1), (1, 16, 1),
                                  (256, 128, 2), (128, 256, 2),
                                  (512, 128, 4), (256, 512, 8)],
                         ids=["ps128_d128", "ps16_d64", "ps1_d16",
                              "ps256_d128", "ps128_d256", "ps512_d128",
                              "ps256_d512"])
def test_prefill_write_cluster(case):
    """The CTAs a quantizing write gives a tile, from its page size and D:
    one while a CTA's registers hold the tile (16384 values), else the
    fewest of 2, 4, 8 that do; a tile 8 CTAs cannot hold is refused."""
    ps, d, want = case
    assert kernels.prefill_write_cluster(ps, d) == want
    with pytest.raises(ValueError, match="cluster of 8"):
        kernels.prefill_write_cluster(1024, 512)


def test_launch_counters_are_plain_integers():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {
        "flash_attention_fwd": 0, "flash_attention_bwd": 0,
        "fused_add_layernorm_fwd": 0, "paged_attention_fwd": 0,
        "paged_prefill_write": 0, "fused_update": 0}
