"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:cacheprovider --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
use and the card's machine need not have.) Each kernel is held against its
plain PyTorch version on the same CUDA tensors — f32 within 2e-5 (the
online and the one-shot softmax sum in different orders), bf16 within 2e-2
(bf16 output rounding of unit-scale values), the prefill write bitwise —
at ragged and edge shapes beyond the serving path's, and each launch is
counted. The flash backward is held to 1e-4 of the gradients' largest
magnitude in f32 (sums over up to 512 keys in other orders) and to 2e-2 of
it in bf16 (bf16 rounds ds and p before three of the products, and a value
near a rounding boundary may round the other way); add + LayerNorm's sum
is bitwise, its output within 1e-4 (f32: the rows' mean of ~30 carries
sum-order error ~3e-5) or one bf16 step (2e-2 + 1e-2 relative). Paged
attention over int8 / fp8 pools is held to 2e-5 in f32 and to 1e-2 of the
output's largest magnitude in bf16 (the kernel's products are exact with
f32 sums — bf16 queries run on the tensor cores, the raw payload exact in
bf16 and the probabilities entering P.V with 16 significant bits — the
plain version casts K/V and the probabilities to bf16, as the JAX einsum
oracle does); the quantizing prefill write is bitwise, payload
and scales. bf16 flash attention runs the tensor-core kernels (wgmma +
TMA) and f32 the CUDA-core kernels, so the f32 cases pin the CUDA-core
route; the bf16 route is also held at tile edges (S from 1 to 1000 around
the 64- and 128-row tiles, causal offsets, GQA and MQA, head dims
32 / 64 / 128) and with a caller's delta and an lse cotangent (dlse).
The plain versions are held against the JAX package's Pallas
kernels by tests/test_torch_kernels.py and
tests/test_torch_quantized_serving.py.

The fused optimizer update (the port's own kernel) is held bitwise to the
per-leaf torch formula and to its plain version — every rule, f32 and
bf16, flat and per-leaf state, leaves of 1 to 16385 elements around the
16-byte vector and the 4096-element chunk, views at storage offsets of 1
to 7 elements in the weight, the grad or the state (f32 grads of bf16
weights too), more leaves than one launch takes, a bucket past 2^31
bytes, the finite flag off, the per-leaf optimizer's update on the card
(launches counted) and a CUDA graph of it replayed. The
train loop on the card: the scanned steps (a CUDA graph captured and
replayed) against per-step training within 1e-5 in f32 (cuBLAS may choose
other algorithms under capture), with every replayed launch counted; Adam
under a schedule, fused and guarded with a NaN step, against the CPU
within 1e-5 (the key biases, whose exact gradient is zero, within Adam's
step bound).
"""

import ctypes
import math

import pytest
import torch

from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.ops import kernels

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(python -m pytest tests/test_torch_cuda.py -m cuda "
                    "--noconftest)")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _close(out, ref, dtype):
    tol = TOL if dtype == torch.float32 else dict(rtol=0, atol=2e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


DTYPES = [torch.float32, torch.bfloat16]
GPU_FLASH = [
    # (B, Sq, Sk, H, KVH, D, causal)
    (2, 100, 100, 4, 2, 64, True),     # ragged tiles, GQA
    (1, 37, 129, 8, 8, 128, True),     # sk > sq: bottom-right offset
    (2, 65, 65, 4, 1, 32, False),      # non-causal, MQA
    (1, 512, 512, 32, 8, 128, True),   # the Llama-3-8B prefill shape
    (4, 1, 1, 4, 4, 64, True),         # a one-token prompt's prefill
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GPU_FLASH, ids=lambda s: "x".join(map(str, s)))
def test_flash_kernel_matches_plain(cuda, dtype, shape):
    b, sq, sk, h, kvh, d, causal = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, sq, h, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, sk, kvh, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, sk, kvh, d, device=cuda, generator=g).to(dtype)
    n0 = kernels.flash_attention_fwd.launches
    out = kernels.flash_attention_fwd(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert kernels.flash_attention_fwd.launches == n0 + 1
    _close(out, kernels.flash_attention_plain(q, k, v, causal, d ** -0.5),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 3], ids=["decode", "slab3"])
@pytest.mark.parametrize("prompts", [((30, 17, 64, 0), (32, 32, 64, 0)),
                                     ((3, 17, 64, 0), (80, 32, 64, 0))],
                         ids=["tight", "wide_pad"])
def test_paged_kernel_matches_plain(cuda, dtype, s, prompts):
    """Ragged prompts, a scrambled table and an inactive slot; "wide_pad"
    puts whole 32-position chunks inside slot 0's dead bucket padding,
    which the kernel skips."""
    b, h, kvh, d, ps, pps, n_pool = 4, 32, 8, 128, 16, 8, 40
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(b, s, h, d, device=cuda, generator=g).to(dtype)
    kp = torch.randn(n_pool, ps, kvh, d, device=cuda, generator=g).to(dtype)
    vp = torch.randn(n_pool, ps, kvh, d, device=cuda, generator=g).to(dtype)
    perm = torch.randperm(n_pool - 1, device=cuda, generator=g)[:b * pps] + 1
    table = perm.reshape(b, pps).to(torch.int32)
    table[3] = 0                                     # slot 3 inactive
    wp0 = torch.tensor([100, 45, 127 - s, 0], dtype=torch.int32)
    wp = torch.minimum(wp0[:, None] + torch.arange(s)[None, :],
                       torch.tensor([120, 60, 127, 0])[:, None])
    wp = wp.to(torch.int32).to(cuda)
    row_len, pad = (torch.tensor(x, dtype=torch.int32, device=cuda)
                    for x in prompts)
    args = (q, kp, vp, table.contiguous(), wp.contiguous(), row_len, pad)
    n0 = kernels.paged_attention_fwd.launches
    out = kernels.paged_attention_fwd(*args, d ** -0.5)
    torch.cuda.synchronize()
    assert kernels.paged_attention_fwd.launches == n0 + 1
    assert torch.isfinite(out.float()).all()
    _close(out, kernels.paged_attention_plain(*args, d ** -0.5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", [(37, 16, 8, 128), (512, 128, 8, 128),
                                  (10, 4, 3, 2), (9, 4, 1, 3)],
                         ids=lambda g: "x".join(map(str, g)))
def test_prefill_write_kernel_bitwise(cuda, dtype, geom):
    """Page-tail padding, and row sizes that force the 16-, 4- and 2-byte
    copy units."""
    s, ps, kvh, d = geom
    g = torch.Generator(device=cuda).manual_seed(2)
    n_pages = -(-s // ps)
    pool_k = torch.randn(n_pages + 5, ps, kvh, d, device=cuda,
                         generator=g).to(dtype)
    pool_v = torch.randn_like(pool_k)
    kh = torch.randn(1, s, kvh, d, device=cuda, generator=g).to(dtype)
    vh = torch.randn_like(kh)
    pages = (torch.randperm(n_pages + 4, device=cuda, generator=g)[:n_pages]
             + 1).to(torch.int32)
    rk, rv = pool_k.clone(), pool_v.clone()
    kernels.paged_prefill_write_plain(rk, rv, kh, vh, pages)
    n0 = kernels.paged_prefill_write.launches
    kernels.paged_prefill_write(pool_k, pool_v, kh, vh, pages)
    torch.cuda.synchronize()
    assert kernels.paged_prefill_write.launches == n0 + 1
    assert torch.equal(_bits(pool_k), _bits(rk))
    assert torch.equal(_bits(pool_v), _bits(rv))


@pytest.mark.cuda
def test_wrappers_raise_on_unsupported_cuda_input(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        kernels.flash_attention_fwd(q, q, q, True, 0.125)
    q = torch.zeros(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        kernels.flash_attention_fwd(q, q, q, True, 0.125)


def _rel_err(out, ref):
    """max |out - ref| scaled to ref's largest magnitude."""
    ref = ref.float()
    return ((out.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def _qkvo(cuda, dtype, shape, seed):
    b, sq, sk, h, d, causal = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn(b, sq, h, d, device=cuda, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, device=cuda, generator=g).to(dtype)
            for _ in range(2))
    return q, k, v, do


GPU_FLASH_BWD = [
    # (B, Sq, Sk, H, D, causal)
    (2, 100, 100, 4, 64, True),      # ragged tiles
    (1, 37, 129, 8, 128, True),      # sk > sq: bottom-right offset
    (2, 65, 65, 4, 32, False),       # non-causal, ragged
    (8, 512, 512, 32, 128, False),   # the flagship training shape
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GPU_FLASH_BWD,
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_lse_and_bwd_kernels_match_plain(cuda, dtype, shape):
    causal, d = shape[-1], shape[-2]
    q, k, v, do = _qkvo(cuda, dtype, shape, 3)
    scale = d ** -0.5
    n_fwd = kernels.flash_attention_fwd.launches
    n_bwd = kernels.flash_attention_bwd.launches
    o, lse = kernels.flash_attention_fwd(q, k, v, causal, scale,
                                         need_lse=True)
    ro, rlse = kernels.flash_attention_plain(q, k, v, causal, scale,
                                             need_lse=True)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    _close(o, ro, dtype)
    grads = kernels.flash_attention_bwd(q, k, v, o, lse, do, causal, scale)
    refs = kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                             scale)
    torch.cuda.synchronize()
    assert kernels.flash_attention_fwd.launches == n_fwd + 1
    assert kernels.flash_attention_bwd.launches == n_bwd + 1
    limit = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == dtype and g.shape == r.shape
        assert torch.isfinite(g.float()).all(), name
        assert _rel_err(g, r) <= limit, (name, _rel_err(g, r))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_autograd_on_card_matches_plain_autograd(cuda, causal):
    """The autograd Function through both kernels against torch autograd
    of the plain forward, f32."""
    q, k, v, do = _qkvo(cuda, torch.float32, (2, 70, 70, 4, 64, causal), 4)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(kernels.flash_attention(*leaves, causal),
                              leaves, do)
    ref = torch.autograd.grad(
        kernels.flash_attention_plain(*leaves, causal, 64 ** -0.5), leaves,
        do)
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= 1e-4


@pytest.mark.cuda
def test_flash_autograd_on_card_matches_plain_autograd_bf16(cuda):
    """The autograd Function through the tensor-core kernels against torch
    autograd of the plain forward, bf16: each gradient within 2e-2 of its
    largest magnitude (the backward's bf16 rounding of ds and p)."""
    q, k, v, do = _qkvo(cuda, torch.bfloat16, (2, 200, 200, 4, 128, True), 4)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(kernels.flash_attention(*leaves, True),
                              leaves, do)
    ref = torch.autograd.grad(
        kernels.flash_attention_plain(*leaves, True, 128 ** -0.5), leaves, do)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        assert _rel_err(g, r) <= 2e-2, _rel_err(g, r)


# ---- the tensor-core (bf16) route at tile edges ----------------------------
#
# The bf16 kernels work on 128-row resident tiles and 32- to 128-row
# streamed tiles; these shapes put the sequence just under, on and over
# those edges, and below one tile (the serving buckets of 16). Gradients are
# held to 2e-2 of max(largest magnitude, 1e-2): at S = 1 the softmax
# gradient vanishes (p = 1, dp = delta), so dq and dk are rounding noise
# around 0 in both versions, and a scale of their own would be noise too.

EDGE_S = [1, 16, 63, 64, 65, 127, 128, 129, 1000]


def _grad_err(out, ref):
    ref = ref.float()
    return ((out.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-2)).item()


def _fwd_bwd_check(cuda, b, sq, sk, h, kvh, d, causal, seed, bwd=True):
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn(b, sq, h, d, device=cuda, generator=g).to(bf)
    k = torch.randn(b, sk, kvh, d, device=cuda, generator=g).to(bf)
    v = torch.randn(b, sk, kvh, d, device=cuda, generator=g).to(bf)
    scale = d ** -0.5
    o, lse = kernels.flash_attention_fwd(q, k, v, causal, scale,
                                         need_lse=True)
    ro, rlse = kernels.flash_attention_plain(q, k, v, causal, scale,
                                             need_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    _close(o, ro, bf)
    if not bwd:
        return
    do = torch.randn(b, sq, h, d, device=cuda, generator=g).to(bf)
    grads = kernels.flash_attention_bwd(q, k, v, o, lse, do, causal, scale)
    refs = kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                             scale)
    torch.cuda.synchronize()
    for name, gr, r in zip(("dq", "dk", "dv"), grads, refs):
        assert gr.dtype == bf and torch.isfinite(gr.float()).all(), name
        assert _grad_err(gr, r) <= 2e-2, (name, _grad_err(gr, r))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", EDGE_S)
def test_flash_bf16_tile_edges_match_plain(cuda, s, d, causal):
    """Forward (with lse) and backward, sq = sk = s, MHA."""
    _fwd_bwd_check(cuda, 2, s, s, 3, 3, d, causal, seed=s)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk", [(1, 16), (37, 129), (65, 200),
                                   (100, 1000), (129, 300)],
                         ids=lambda x: str(x))
def test_flash_bf16_causal_offset_matches_plain(cuda, sq, sk, d):
    """Causal with sk > sq by offsets that are no multiple of a tile: the
    bottom-right diagonal crosses tiles at odd places."""
    _fwd_bwd_check(cuda, 1, sq, sk, 2, 2, d, True, seed=sq + sk)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 200, 200, 8, 2, 128, True),    # GQA 4:1
    (1, 1000, 1000, 8, 2, 64, False),  # GQA 4:1, long
    (2, 65, 65, 4, 1, 64, True),       # MQA
    (1, 129, 300, 4, 1, 32, True),     # MQA, causal offset
    (1, 16, 16, 32, 8, 128, True),     # the serving path's smallest bucket
], ids=lambda s: "x".join(map(str, s)))
def test_flash_bf16_grouped_query_forward_matches_plain(cuda, shape):
    b, sq, sk, h, kvh, d, causal = shape
    _fwd_bwd_check(cuda, b, sq, sk, h, kvh, d, causal, seed=7, bwd=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["dlse", "delta", "delta_dlse"])
@pytest.mark.parametrize("shape", [(2, 100, 100, 4, 64, True),
                                   (1, 37, 129, 2, 128, True),
                                   (2, 65, 65, 4, 32, False)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_bwd_delta_and_dlse_match_plain(cuda, dtype, mode, shape):
    """The backward's caller-given delta (the delta kernel is skipped) and
    lse cotangent dlse (subtracted where the kernels read delta), on both
    routes, against the plain version given the same."""
    causal, d = shape[-1], shape[-2]
    q, k, v, do = _qkvo(cuda, dtype, shape, 11)
    scale = d ** -0.5
    o, lse = kernels.flash_attention_fwd(q, k, v, causal, scale,
                                         need_lse=True)
    g = torch.Generator(device=cuda).manual_seed(12)
    delta = ((do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
             + 0.1 * torch.randn(lse.shape, device=cuda, generator=g))
    dlse = torch.randn(lse.shape, device=cuda, generator=g)
    kw = dict(delta=delta if "delta" in mode else None,
              dlse=dlse if "dlse" in mode else None)
    grads = kernels.flash_attention_bwd(q, k, v, o, lse, do, causal, scale,
                                        **kw)
    refs = kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                             scale, **kw)
    torch.cuda.synchronize()
    limit = 1e-4 if dtype == torch.float32 else 2e-2
    for name, gr, r in zip(("dq", "dk", "dv"), grads, refs):
        assert _grad_err(gr, r) <= limit, (name, _grad_err(gr, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_flash_bwd_lse_cotangent_alone_gives_zero_dv(cuda, dtype):
    """do = 0, dlse = w: dv is exactly 0, dq / dk the plain version's."""
    q, k, v, _ = _qkvo(cuda, dtype, (1, 64, 64, 2, 64, False), 13)
    o, lse = kernels.flash_attention_fwd(q, k, v, False, 0.125,
                                         need_lse=True)
    w = torch.randn(lse.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(14))
    zero = torch.zeros_like(q)
    grads = kernels.flash_attention_bwd(q, k, v, o, lse, zero, False, 0.125,
                                        dlse=w)
    refs = kernels.flash_attention_bwd_plain(q, k, v, o, lse, zero, False,
                                             0.125, dlse=w)
    torch.cuda.synchronize()
    assert torch.count_nonzero(grads[2]) == 0
    limit = 1e-4 if dtype == torch.float32 else 2e-2
    for gr, r in zip(grads[:2], refs[:2]):
        assert _grad_err(gr, r) <= limit


@pytest.mark.cuda
def test_flash_bf16_refuses_unaligned_tensors(cuda):
    """TMA reads tiles from 16-byte aligned addresses: a bf16 view that
    starts 2 bytes in is refused before any launch."""
    buf = torch.zeros(1 + 1 * 8 * 2 * 64, device=cuda, dtype=torch.bfloat16)
    q = buf[1:].view(1, 8, 2, 64)
    n0 = kernels.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="aligned"):
        kernels.flash_attention_fwd(q, q, q, True, 0.125)
    assert kernels.flash_attention_fwd.launches == n0


@pytest.mark.cuda
def test_flash_bwd_refuses_grouped_query(cuda):
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    kv = torch.zeros(1, 8, 2, 64, device=cuda)
    lse = torch.zeros(1, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="grouped-query"):
        kernels.flash_attention_bwd(q, kv, kv, q, lse, q, True, 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("nd", [(37, 128), (5, 392), (4096, 4096),
                                (3, 16384)],
                         ids=lambda s: "x".join(map(str, s)))
def test_add_layernorm_kernel_matches_plain(cuda, dtype, nd):
    """Row widths that launch blocks of 32 threads up to 1024 (f32 at
    16384: 4096 vectors of 16 bytes)."""
    n, d = nd
    g = torch.Generator(device=cuda).manual_seed(5)
    # a residual stream whose mean dwarfs its spread: the two-pass variance
    x = (torch.randn(n, d, device=cuda, generator=g) + 30.0).to(dtype)
    r = torch.randn(n, d, device=cuda, generator=g).to(dtype)
    scale = (torch.rand(d, device=cuda, generator=g) + 0.5).to(dtype)
    bias = torch.randn(d, device=cuda, generator=g).to(dtype)
    n0 = kernels.fused_add_layernorm_fwd.launches
    s, y, mean, rstd = kernels.fused_add_layernorm_fwd(x, r, scale, bias,
                                                       1e-5)
    rs, ry, rmean, rrstd = kernels.fused_add_layernorm_plain(x, r, scale,
                                                             bias, 1e-5)
    torch.cuda.synchronize()
    assert kernels.fused_add_layernorm_fwd.launches == n0 + 1
    assert torch.equal(_bits(s), _bits(rs))
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rrstd, rtol=1e-4, atol=0)
    tol = (dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32
           else dict(rtol=1e-2, atol=2e-2))
    torch.testing.assert_close(y.float(), ry.float(), **tol)
    _, y2, m2, r2 = kernels.fused_add_layernorm_fwd(x, r, scale, bias, 1e-5,
                                                    need_stats=False)
    assert m2 is None and r2 is None and torch.equal(_bits(y2), _bits(y))


@pytest.mark.cuda
def test_add_layernorm_autograd_on_card_matches_plain_autograd(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    xs = [torch.randn(64, 256, device=cuda, generator=g) for _ in range(2)]
    ws = [torch.rand(256, device=cuda, generator=g) + 0.5,
          torch.randn(256, device=cuda, generator=g)]
    leaves = [t.requires_grad_() for t in xs + ws]

    def loss(s, y):
        return torch.sin(y).sum() + torch.cos(s).sum()

    got = torch.autograd.grad(loss(*kernels.fused_add_layernorm(*leaves)),
                              leaves)
    s, y, _, _ = kernels.fused_add_layernorm_plain(*leaves, 1e-5)
    ref = torch.autograd.grad(loss(s, y), leaves)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_add_layernorm_refuses_unsupported_rows(cuda):
    x = torch.zeros(4, 12, device=cuda)
    w = torch.zeros(12, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.fused_add_layernorm_fwd(x, x, w, w, 1e-5)
    x = torch.zeros(2, 16392, device=cuda)
    w = torch.zeros(16392, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        kernels.fused_add_layernorm_fwd(x, x, w, w, 1e-5)
    x = torch.zeros(4, 16, device=cuda, dtype=torch.float16)
    w = torch.zeros(16, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        kernels.fused_add_layernorm_fwd(x, x, w, w, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,runs", [(1000, True), (1004, False)],
                         ids=["d1000_unaligned_kernel", "d1004_torch_route"])
def test_add_layernorm_op_on_card_never_runs_plain(cuda, dim, runs):
    """The op sends every CUDA row the kernel takes to it (a width that is
    no multiple of 128 launches it) and never to the plain version; a row
    it does not take (1004, not a multiple of 8) launches nothing and runs
    the op's torch route, the JAX plain branch: output and gradients as
    the same op on the CPU."""
    ff = FFModel(FFConfig(batch_size=2), device="cuda")
    t = ff.create_tensor((2, 5, dim))
    ff.add_layer_norm(t, t)
    ff.compile(final_tensor=ff.ops[-1].outputs[0])
    op = ff.ops[-1]
    params = ff.params[op.name]
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 5, dim, device=cuda, generator=g)
    r = torch.randn(2, 5, dim, device=cuda, generator=g)
    assert kernels.fused_add_layernorm_takes(
        x.reshape(-1, dim), r.reshape(-1, dim), params["scale"],
        params["bias"]) == runs
    n0 = kernels.fused_add_layernorm_fwd.launches
    leaves = [x.clone().requires_grad_(), r.clone().requires_grad_()]
    s, y = op.forward(params, leaves)
    assert kernels.fused_add_layernorm_fwd.launches == n0 + runs
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    cpu_params = {k: v.cpu() for k, v in params.items()}
    rs, ry = op.forward(cpu_params, cpu)
    torch.testing.assert_close(s.cpu(), rs.detach(), rtol=0, atol=0)
    torch.testing.assert_close(y.cpu(), ry.detach(), rtol=1e-5, atol=1e-4)
    cot = torch.randn(2, 5, dim, generator=torch.Generator().manual_seed(5))
    got = torch.autograd.grad((y * cot.to(cuda)).sum() + s.sum(), leaves)
    want = torch.autograd.grad((ry * cot).sum() + rs.sum(), cpu)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.cpu(), w, rtol=1e-4, atol=1e-4)


#: (q seq, kv seq, embed, heads, kv heads, vdim, causal, use_flash_attention)
ROUTE_CASES = {
    "head_dim_64_kernel": (100, 100, 128, 2, 1, 0, True, True),
    "head_dim_48": (10, 10, 96, 2, 1, 0, True, True),
    "kdim_ne_vdim": (9, 9, 64, 2, 0, 32, False, True),
    "causal_sq_gt_sk": (6, 3, 64, 1, 0, 0, True, True),
    "flash_off": (12, 12, 64, 2, 0, 0, True, False),
    "blockwise": (4160, 4160, 16, 2, 0, 0, True, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_attention_op_on_card_refuses_unsupported_shapes(cuda, case):
    """Route, not refusal: a shape the flash kernels take (head dim 64,
    GQA) launches the forward and backward kernels; a shape they do not
    take (head dim 96 / 2 = 48, q and v head dims 32 and 16, causal with
    more queries than keys), any shape under use_flash_attention=False,
    and the blockwise scan past 4096 positions launch nothing and run the
    op's torch route. Output and every gradient as the same op on the CPU
    (f32: 2e-5, sums in other orders)."""
    sq, sk, e, h, kvh, vdim, causal, flash = ROUTE_CASES[case]
    b = 1 if case == "blockwise" else 2
    ff = FFModel(FFConfig(batch_size=b, use_flash_attention=flash),
                 device="cuda")
    q = ff.create_tensor((b, sq, e))
    kv = ff.create_tensor((b, sk, e))
    ff.multihead_attention(q, kv, kv, e, h, vdim=vdim, causal=causal,
                           num_kv_heads=kvh)
    ff.compile(final_tensor=ff.ops[-1].outputs[0])
    op = ff.ops[-1]
    params = {k: v.clone().requires_grad_()
              for k, v in ff.params[op.name].items()}
    g = torch.Generator(device=cuda).manual_seed(6)
    xs = [torch.randn(*t.dims, device=cuda, generator=g).requires_grad_()
          for t in (q, kv, kv)]
    kernels.reset_launch_counts()
    out = op.forward(params, xs, training=True)[0]
    cot = torch.randn(out.shape, device=cuda, generator=g)
    grads = torch.autograd.grad(out, list(params.values()) + xs, cot)
    runs = case == "head_dim_64_kernel"
    assert kernels.flash_attention_fwd.launches == runs
    assert kernels.flash_attention_bwd.launches == runs
    cparams = {k: v.detach().cpu().requires_grad_()
               for k, v in params.items()}
    cxs = [x.detach().cpu().requires_grad_() for x in xs]
    ref = op.forward(cparams, cxs, training=True)[0]
    want = torch.autograd.grad(ref, list(cparams.values()) + cxs, cot.cpu())
    torch.testing.assert_close(out.detach().cpu(), ref.detach(), **TOL)
    # the key bias's true gradient is zero (the softmax ignores a shift
    # shared by every key): both devices return round-off for it
    top = max(w.abs().max().item() for w in want)
    for name, a, w in zip(list(params) + ["q", "k", "v"], grads, want):
        err = (a.cpu() - w).abs().max().item()
        if name == "bias_k":
            assert max(a.abs().max().item(), w.abs().max().item()) \
                <= 1e-5 * top
        else:
            assert err <= 1e-4 * w.abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_flash_predicate_agrees_with_the_wrapper(cuda, dtype):
    """``flash_attention_takes`` is True exactly where the forward wrapper
    launches rather than raise."""
    shapes = [  # (Sq, Sk, H, KVH, Dq, Dv, causal)
        (8, 8, 2, 2, 64, 64, True), (8, 8, 2, 1, 48, 48, False),
        (8, 8, 2, 2, 64, 32, False), (9, 3, 2, 2, 64, 64, True),
        (9, 3, 2, 2, 64, 64, False), (8, 8, 3, 2, 64, 64, False),
        (1, 8, 4, 2, 128, 128, True)]
    for sq, sk, h, kvh, dq, dv, causal in shapes:
        q = torch.zeros(1, sq, h, dq, device=cuda, dtype=dtype)
        k = torch.zeros(1, sk, kvh, dq, device=cuda, dtype=dtype)
        v = torch.zeros(1, sk, kvh, dv, device=cuda, dtype=dtype)
        takes = kernels.flash_attention_takes(q, k, v, causal)
        n0 = kernels.flash_attention_fwd.launches
        try:
            kernels.flash_attention_fwd(q, k, v, causal, 0.125)
            raised = False
        except ValueError:
            raised = True
        assert takes != raised
        assert kernels.flash_attention_fwd.launches == n0 + takes


# ---- quantized and mixed-width pools ---------------------------------------


def _quant_pool(cuda, g, shape, dtype):
    """A random int8 / fp8 (or bf16) payload of ``shape`` on the card."""
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, device=cuda, generator=g,
                             dtype=torch.int8)
    x = torch.randn(shape, device=cuda, generator=g) * 100.0
    return x.clamp(-448, 448).to(dtype)


POOLS = [torch.int8, torch.float8_e4m3fn]


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", POOLS, ids=["int8", "fp8"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("ps", [8, 128])
@pytest.mark.parametrize("s", [1, 3], ids=["decode", "slab3"])
def test_quantized_paged_kernel_matches_plain(cuda, qdtype, pool, d, ps, s):
    """Int8 / fp8 pools with random positive per-(page, kv head) scales,
    ragged prompts, a scrambled table and an inactive slot. The kernel's
    products are exact with f32 sums (the Pallas kernel's arithmetic; under
    bf16 queries the probabilities enter P.V with 16 significant bits); the
    plain version casts K/V and the probabilities to q's dtype (the JAX
    einsum oracle), so bf16 is held to 1e-2 of the output's largest
    magnitude (2.5 bf16 steps) and f32 to 2e-5."""
    b, h, kvh, max_len = 4, 8, 2, 128
    pps = max_len // ps
    n_pool = b * pps + 3
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(b, s, h, d, device=cuda, generator=g).to(qdtype)
    kp = _quant_pool(cuda, g, (n_pool, ps, kvh, d), pool)
    vp = _quant_pool(cuda, g, (n_pool, ps, kvh, d), pool)
    ks, vs = ((torch.rand(n_pool, kvh, device=cuda, generator=g) + 0.1)
              / 127.0 for _ in range(2))
    perm = torch.randperm(n_pool - 1, device=cuda, generator=g)[:b * pps] + 1
    table = perm.reshape(b, pps).to(torch.int32)
    table[3] = 0                                     # slot 3 inactive
    wp = torch.minimum(torch.tensor([100, 45, 127 - s, 0])[:, None]
                       + torch.arange(s)[None, :],
                       torch.tensor([120, 60, 127, 0])[:, None])
    row_len = torch.tensor([30, 3, 64, 0], dtype=torch.int32, device=cuda)
    pad = torch.tensor([32, 16, 64, 0], dtype=torch.int32, device=cuda)
    args = (q, kp, vp, table.contiguous(), wp.to(torch.int32).to(cuda),
            row_len, pad, d ** -0.5)
    n0 = kernels.paged_attention_fwd.launches
    out = kernels.paged_attention_fwd(*args, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert kernels.paged_attention_fwd.launches == n0 + 1
    assert out.dtype == qdtype and torch.isfinite(out.float()).all()
    ref = kernels.paged_attention_plain(*args, k_scales=ks, v_scales=vs)
    if qdtype == torch.float32:
        torch.testing.assert_close(out, ref, **TOL)
    else:
        assert _rel_err(out, ref) <= 1e-2, _rel_err(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("ps", [8, 128])
@pytest.mark.parametrize("s", [1, 3], ids=["decode", "slab3"])
def test_mixed_width_paged_kernel_matches_plain(cuda, d, ps, s):
    """A bf16 pool under f32 queries (kv_cache_dtype='bf16' with f32
    compute): the kernel upcasts the tile, both versions compute in f32."""
    b, h, kvh, max_len = 3, 4, 2, 128
    pps = max_len // ps
    n_pool = b * pps + 2
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(b, s, h, d, device=cuda, generator=g)
    kp, vp = (torch.randn(n_pool, ps, kvh, d, device=cuda,
                          generator=g).to(torch.bfloat16) for _ in range(2))
    perm = torch.randperm(n_pool - 1, device=cuda, generator=g)[:b * pps] + 1
    table = perm.reshape(b, pps).to(torch.int32).contiguous()
    wp = (torch.tensor([90, 127 - s, 40])[:, None]
          + torch.arange(s)[None, :]).clamp(max=127)
    row_len = torch.tensor([7, 100, 33], dtype=torch.int32, device=cuda)
    pad = torch.tensor([8, 128, 40], dtype=torch.int32, device=cuda)
    args = (q, kp, vp, table, wp.to(torch.int32).to(cuda), row_len, pad,
            d ** -0.5)
    out = kernels.paged_attention_fwd(*args)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, kernels.paged_attention_plain(*args),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("slab,pool", [
    (torch.float32, torch.int8), (torch.bfloat16, torch.int8),
    (torch.float32, torch.float8_e4m3fn),
    (torch.bfloat16, torch.float8_e4m3fn),
    (torch.float32, torch.bfloat16),
], ids=["f32_int8", "bf16_int8", "f32_fp8", "bf16_fp8", "f32_bf16_cast"])
@pytest.mark.parametrize("geom", [(37, 16, 8, 128), (512, 128, 8, 128),
                                  (10, 8, 2, 32), (9, 8, 1, 64)],
                         ids=lambda g: "x".join(map(str, g)))
def test_quantized_prefill_write_kernel_bitwise(cuda, slab, pool, geom):
    """Payload and scales bitwise the plain version's: the page-tail zero
    padding, a page that is all padding past its first rows, and slabs of
    unit and of large magnitude. The bf16 pool takes an f32 slab (a cast;
    a bf16 slab into it is the native copy, tested above)."""
    s, ps, kvh, d = geom
    n_pages = -(-s // ps)
    g = torch.Generator(device=cuda).manual_seed(9)
    kh = (torch.randn(1, s, kvh, d, device=cuda, generator=g) * 3).to(slab)
    vh = (torch.randn(1, s, kvh, d, device=cuda, generator=g) * 300).to(slab)
    pool_k = _quant_pool(cuda, g, (n_pages + 5, ps, kvh, d), pool)
    pool_v = _quant_pool(cuda, g, (n_pages + 5, ps, kvh, d), pool)
    quant = pool in POOLS
    ks = torch.rand(n_pages + 5, kvh, device=cuda, generator=g) \
        if quant else None
    vs = torch.rand_like(ks) if quant else None
    pages = (torch.randperm(n_pages + 4, device=cuda, generator=g)[:n_pages]
             + 1).to(torch.int32)
    ref = [t.clone() if t is not None else None
           for t in (pool_k, pool_v, ks, vs)]
    kernels.paged_prefill_write_plain(ref[0], ref[1], kh, vh, pages,
                                      ref[2], ref[3])
    n0 = kernels.paged_prefill_write.launches
    kernels.paged_prefill_write(pool_k, pool_v, kh, vh, pages, ks, vs)
    torch.cuda.synchronize()
    assert kernels.paged_prefill_write.launches == n0 + 1
    for got, want in zip((pool_k, pool_v), ref[:2]):
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    if quant:
        assert torch.equal(ks.view(torch.int32), ref[2].view(torch.int32))
        assert torch.equal(vs.view(torch.int32), ref[3].view(torch.int32))


# ---- the prefill write of every layer in one launch -----------------------

#: (slab dtype, pool dtype): the copy (f32, bf16), the cast, the quantizing
#: writes from f32 and bf16 slabs
GROUP_POOLS = [(torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16),
               (torch.float32, torch.int8), (torch.bfloat16, torch.int8),
               (torch.float32, torch.float8_e4m3fn),
               (torch.bfloat16, torch.float8_e4m3fn)]
GROUP_IDS = ["f32", "bf16", "cast", "f32_int8", "bf16_int8", "f32_fp8",
             "bf16_fp8"]


def _poisoned_layers(cuda, seed, n_layers, slab, pool, s, ps=128, kvh=8,
                     d=128, extra=5):
    """``n_layers`` layers of pools (and scale planes) full of random
    bytes — NaN and inf patterns included — and random slabs, with the
    page list of an S-position prefill listed out of order: (pools_k,
    pools_v, slabs_k, slabs_v, k_scales, v_scales, pages)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n_pages = -(-s // ps)
    n_pool = n_pages + extra
    shape = (n_pool, ps, kvh, d)
    nbytes = math.prod(shape) * torch.tensor([], dtype=pool).element_size()

    def poison(shape_, dtype, n):
        return torch.randint(0, 256, (n,), device=cuda, generator=g,
                             dtype=torch.uint8).view(dtype).view(shape_)

    pk = [poison(shape, pool, nbytes) for _ in range(n_layers)]
    pv = [poison(shape, pool, nbytes) for _ in range(n_layers)]
    kh = [(torch.randn(1, s, kvh, d, device=cuda, generator=g) * 3).to(slab)
          for _ in range(n_layers)]
    vh = [(torch.randn(1, s, kvh, d, device=cuda, generator=g) * 300)
          .to(slab) for _ in range(n_layers)]
    quant = pool in POOLS
    ks = [poison((n_pool, kvh), torch.float32, 4 * n_pool * kvh)
          for _ in range(n_layers)] if quant else None
    vs = [poison((n_pool, kvh), torch.float32, 4 * n_pool * kvh)
          for _ in range(n_layers)] if quant else None
    pages = (torch.randperm(n_pool - 1, device=cuda, generator=g)[:n_pages]
             + 1).to(torch.int32)
    return pk, pv, kh, vh, ks, vs, pages


def _clone_all(ts):
    return [t.clone() for t in ts] if ts is not None else None


@pytest.mark.cuda
@pytest.mark.parametrize("n_layers", [1, 2, 32,
                                      kernels.PREFILL_WRITE_MAX_LAYERS + 1],
                         ids=["L1", "L2", "L32", "Lcap+1"])
@pytest.mark.parametrize("s", [1, 127, 128, 300, 512])
@pytest.mark.parametrize("slab,pool", GROUP_POOLS, ids=GROUP_IDS)
def test_prefill_write_layers_kernel_bitwise(cuda, slab, pool, s, n_layers):
    """Every layer's pages (and scales) bitwise the plain version's, in one
    launch (ceil(L / 64) past the cap), at Llama-3-8B widths (8 kv heads,
    D = 128, 128-row pages listed out of order); the pool bytes of pages
    not listed, and their scales, left as they were (poisoned with random
    bytes, NaN patterns included, so a stray write or a read of them
    shows)."""
    pk, pv, kh, vh, ks, vs, pages = _poisoned_layers(
        cuda, 11 + s + n_layers, n_layers, slab, pool, s)
    before = [_clone_all(x) for x in (pk, pv, ks, vs)]
    ref = [_clone_all(x) for x in (pk, pv, ks, vs)]
    kernels.paged_prefill_write_layers_plain(ref[0], ref[1], kh, vh, pages,
                                             ref[2], ref[3])
    n0 = kernels.paged_prefill_write.launches
    kernels.paged_prefill_write_layers(pk, pv, kh, vh, pages, ks, vs)
    torch.cuda.synchronize()
    cap = kernels.PREFILL_WRITE_MAX_LAYERS
    assert kernels.paged_prefill_write.launches == n0 + -(-n_layers // cap)
    listed = torch.zeros(pk[0].shape[0], dtype=torch.bool, device=cuda)
    listed[pages.long()] = True
    for got, want, old in zip((pk, pv, ks, vs), ref, before):
        if got is None:
            continue
        for g_, w_, o_ in zip(got, want, old):
            gb, wb, ob = (t.view(torch.uint8).view(t.shape[0], -1)
                          for t in (g_, w_, o_))
            assert torch.equal(gb, wb)
            assert torch.equal(gb[~listed], ob[~listed])


@pytest.mark.cuda
@pytest.mark.parametrize("slab,pool", GROUP_POOLS[2:], ids=GROUP_IDS[2:])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_prefill_write_every_cluster_size_bitwise(cuda, slab, pool, cluster):
    """A quantizing or casting write with each tile's rows split over 1, 2,
    4 or 8 CTAs of a cluster (the C entry called with each size), 3 layers
    of a 300-position prefill: bitwise the plain version."""
    pk, pv, kh, vh, ks, vs, pages = _poisoned_layers(cuda, 40 + cluster, 3,
                                                     slab, pool, 300)
    ref = [_clone_all(x) for x in (pk, pv, ks, vs)]
    kernels.paged_prefill_write_layers_plain(ref[0], ref[1], kh, vh, pages,
                                             ref[2], ref[3])
    lib = kernels.LIBRARY.get()
    arr = lambda ts: (ctypes.c_void_p * len(ts))(  # noqa: E731
        *(t.data_ptr() for t in ts))
    kernels._check(lib.ff_paged_prefill_write_layers(
        arr(kh), arr(vh), arr(pk), arr(pv), arr(ks) if ks else None,
        arr(vs) if vs else None, 3, pages.data_ptr(), pages.shape[0], 300,
        128, 8, 128, 128, kh[0].element_size(), kernels._DTYPE_CODES[slab],
        kernels._DTYPE_CODES[pool], cluster,
        torch.cuda.current_stream().cuda_stream), "cluster")
    torch.cuda.synchronize()
    for got, want in zip((pk, pv, ks, vs), ref):
        for g_, w_ in zip(got or [], want or []):
            assert torch.equal(g_.view(torch.uint8), w_.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("slab,pool", GROUP_POOLS[2:], ids=GROUP_IDS[2:])
@pytest.mark.parametrize("ps,d", [(256, 128), (512, 128), (256, 256)],
                         ids=["ps256_d128", "ps512_d128", "ps256_d256"])
def test_prefill_write_large_pages_bitwise(cuda, slab, pool, ps, d):
    """Pages too large for one CTA's registers (clusters of 2, 4 and 4
    CTAs through the wrapper), 2 layers of a prefill that ends inside its
    last page: bitwise the plain version, pages not listed untouched."""
    s = ps + ps // 2 + 3
    assert kernels.prefill_write_cluster(ps, d) > 1
    pk, pv, kh, vh, ks, vs, pages = _poisoned_layers(
        cuda, 50 + ps + d, 2, slab, pool, s, ps=ps, kvh=2, d=d, extra=2)
    before = [_clone_all(x) for x in (pk, pv, ks, vs)]
    ref = [_clone_all(x) for x in (pk, pv, ks, vs)]
    kernels.paged_prefill_write_layers_plain(ref[0], ref[1], kh, vh, pages,
                                             ref[2], ref[3])
    kernels.paged_prefill_write_layers(pk, pv, kh, vh, pages, ks, vs)
    torch.cuda.synchronize()
    listed = torch.zeros(pk[0].shape[0], dtype=torch.bool, device=cuda)
    listed[pages.long()] = True
    for got, want, old in zip((pk, pv, ks, vs), ref, before):
        for g_, w_, o_ in zip(got or [], want or [], old or []):
            gb, wb, ob = (t.view(torch.uint8).view(t.shape[0], -1)
                          for t in (g_, w_, o_))
            assert torch.equal(gb, wb)
            assert torch.equal(gb[~listed], ob[~listed])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", [(10, 4, 3, 2), (9, 4, 1, 3), (37, 16, 2, 8)],
                         ids=lambda g: "x".join(map(str, g)))
def test_prefill_write_layers_copy_units_bitwise(cuda, dtype, geom):
    """The grouped copy in 4-, 2- and 16-byte units (row sizes of 12, 6
    and 32 values) over 3 layers: bitwise the plain version."""
    s, ps, kvh, d = geom
    g = torch.Generator(device=cuda).manual_seed(12)
    n_pages = -(-s // ps)
    pk = [torch.randn(n_pages + 3, ps, kvh, d, device=cuda,
                      generator=g).to(dtype) for _ in range(3)]
    pv = [torch.randn_like(t) for t in pk]
    kh = [torch.randn(1, s, kvh, d, device=cuda, generator=g).to(dtype)
          for _ in range(3)]
    vh = [torch.randn_like(t) for t in kh]
    pages = (torch.randperm(n_pages + 2, device=cuda, generator=g)[:n_pages]
             + 1).to(torch.int32)
    rk, rv = _clone_all(pk), _clone_all(pv)
    kernels.paged_prefill_write_layers_plain(rk, rv, kh, vh, pages)
    n0 = kernels.paged_prefill_write.launches
    kernels.paged_prefill_write_layers(pk, pv, kh, vh, pages)
    torch.cuda.synchronize()
    assert kernels.paged_prefill_write.launches == n0 + 1
    for a, b in zip(pk + pv, rk + rv):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_prefill_write_layers_refuses_unlike_layers(cuda):
    """Layers of one call must match in shape, dtype and scales; a
    mismatch raises before anything launches."""
    pk, pv, kh, vh, ks, vs, pages = _poisoned_layers(
        cuda, 3, 2, torch.bfloat16, torch.int8, 128)
    n0 = kernels.paged_prefill_write.launches
    with pytest.raises(ValueError, match="layer 1 differs"):
        kernels.paged_prefill_write_layers(pk, pv, [kh[0], kh[1][:, :64]],
                                           vh, pages, ks, vs)
    with pytest.raises(ValueError, match="layer 1 differs"):
        kernels.paged_prefill_write_layers(pk, pv, [kh[0], kh[1].float()],
                                           vh, pages, ks, vs)
    with pytest.raises(ValueError, match="equal-length"):
        kernels.paged_prefill_write_layers(pk, pv, kh, vh, pages, ks[:1],
                                           vs)
    assert kernels.paged_prefill_write.launches == n0


@pytest.mark.cuda
def test_quantized_wrappers_refuse_mismatched_scales(cuda):
    """Scales go with an int8 / fp8 pool and only with one; an fp8 pool
    under a mismatched scale shape, and a bf16 slab into an f32 pool, are
    refused too — none of them launches."""
    q = torch.zeros(1, 1, 4, 64, device=cuda)
    bf = torch.zeros(4, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    i8 = torch.zeros(4, 8, 2, 64, device=cuda, dtype=torch.int8)
    sc = torch.ones(4, 2, device=cuda)
    ints = (torch.zeros(1, 2, dtype=torch.int32, device=cuda),
            torch.zeros(1, 1, dtype=torch.int32, device=cuda),
            torch.zeros(1, dtype=torch.int32, device=cuda),
            torch.zeros(1, dtype=torch.int32, device=cuda))
    n0 = (kernels.paged_attention_fwd.launches,
          kernels.paged_prefill_write.launches)
    with pytest.raises(ValueError, match="scales"):
        kernels.paged_attention_fwd(q, bf, bf, *ints, 0.125, k_scales=sc,
                                    v_scales=sc)
    with pytest.raises(ValueError, match="scales"):
        kernels.paged_attention_fwd(q, i8, i8, *ints, 0.125)
    with pytest.raises(ValueError, match="scales must be"):
        kernels.paged_attention_fwd(q, i8, i8, *ints, 0.125,
                                    k_scales=sc[:, :1].contiguous(),
                                    v_scales=sc[:, :1].contiguous())
    slab = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    pages = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="scales"):
        kernels.paged_prefill_write(bf, bf, slab, slab, pages, sc, sc)
    f32 = torch.zeros(4, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="cannot be written"):
        kernels.paged_prefill_write(f32, f32, slab, slab, pages)
    assert (kernels.paged_attention_fwd.launches,
            kernels.paged_prefill_write.launches) == n0


# ---- split-KV paged attention: split edges, long contexts, repeats --------

PAGED_POOLS = [  # (query dtype, pool dtype)
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.int8),
    (torch.bfloat16, torch.float8_e4m3fn)]
PAGED_POOL_IDS = ["bf16", "f32", "mixed", "int8", "fp8"]


def _paged_pool(cuda, g, shape, pool):
    """K/V payloads of ``shape`` and, for an int8 / fp8 pool, random
    positive per-(page, kv head) scales."""
    if pool in POOLS:
        kp, vp = (_quant_pool(cuda, g, shape, pool) for _ in range(2))
        ks, vs = ((torch.rand(shape[0], shape[2], device=cuda, generator=g)
                   + 0.1) / 127.0 for _ in range(2))
        return kp, vp, dict(k_scales=ks, v_scales=vs)
    kp, vp = (torch.randn(shape, device=cuda, generator=g).to(pool)
              for _ in range(2))
    return kp, vp, {}


def _paged_run(cuda, seed, qdtype, pool, d, ps, pps, s, row_len, pad, wp0):
    """Slots of 8 query heads over 2 kv heads with prompts ``row_len``,
    buckets ``pad`` and slab frontiers wp0 + i (i < s, clamped to the
    table's reach); a slot with row_len = pad = wp0 = 0 is inactive (an
    all-zero table row). Returns (kernel output, plain output, args)."""
    b, h, kvh = len(row_len), 8, 2
    n_pool = b * pps + 1
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, s, h, d, device=cuda, generator=g).to(qdtype)
    kp, vp, kw = _paged_pool(cuda, g, (n_pool, ps, kvh, d), pool)
    table = (torch.randperm(n_pool - 1, device=cuda, generator=g)[:b * pps]
             + 1).reshape(b, pps).to(torch.int32)
    wp = torch.tensor(wp0)[:, None] + torch.arange(s)[None, :]
    wp = wp.clamp(max=pps * ps - 1)
    for i in range(b):
        if row_len[i] == pad[i] == wp0[i] == 0:
            table[i] = 0
            wp[i] = 0
    args = (q, kp, vp, table.contiguous(), wp.to(torch.int32).to(cuda),
            torch.tensor(row_len, dtype=torch.int32, device=cuda),
            torch.tensor(pad, dtype=torch.int32, device=cuda), d ** -0.5)
    n0 = kernels.paged_attention_fwd.launches
    out = kernels.paged_attention_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.paged_attention_fwd.launches == n0 + 1
    assert out.dtype == qdtype and torch.isfinite(out.float()).all()
    return out, kernels.paged_attention_plain(*args, **kw), (args, kw)


def _paged_close(out, ref, qdtype, pool):
    """The limits of the paged card tests above: 2e-5 under f32 queries
    (f32 and mixed-width pools, both versions in f32), one bf16 step (2e-2)
    on a native bf16 pool, 1e-2 of the output's largest magnitude over an
    int8 / fp8 pool under bf16 queries."""
    if qdtype == torch.float32:
        torch.testing.assert_close(out, ref, **TOL)
    elif pool in POOLS:
        assert _rel_err(out, ref) <= 1e-2, _rel_err(out, ref)
    else:
        _close(out, ref, qdtype)


def _context(ctx, ps, s):
    """Three slots holding ``ctx`` live positions each way: slot 0 a slab
    right after its prompt, slot 1 a ragged prompt then a slab past three
    pages of bucket padding, slot 2 inactive; and the table's pages."""
    rl0 = max(ctx - s, 0)
    rl1 = ctx // 2
    pad1 = rl1 + 3 * ps
    wp1 = max(pad1 + ctx - rl1 - s, pad1)
    pps = -(-(wp1 + s) // ps) + 1
    return pps, [rl0, rl1, 0], [rl0, pad1, 0], [max(ctx - s, 0), wp1, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,pool", PAGED_POOLS, ids=PAGED_POOL_IDS)
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("ctx", ["1", "page-1", "page", "page+1", "8190"])
@pytest.mark.parametrize("s", [1, 5], ids=["decode", "verify5"])
def test_paged_split_kernel_contexts_match_plain(cuda, qdtype, pool, d, ctx,
                                                 s):
    """16-position pages (no multiple of 32): contexts of 1 position, a
    page less one, a page, a page and one, and 8190 (where the plan splits
    into the most blocks); S = 1 and the speculative-verify slab S = 5
    (20 query rows: two row chunks of 16); an inactive slot in every case."""
    ps = 16
    n = {"1": 1, "page-1": ps - 1, "page": ps, "page+1": ps + 1,
         "8190": 8190}[ctx]
    pps, rl, pad, wp0 = _context(n, ps, s)
    out, ref, _ = _paged_run(cuda, 11, qdtype, pool, d, ps, pps, s, rl, pad,
                             wp0)
    _paged_close(out, ref, qdtype, pool)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,pool", PAGED_POOLS, ids=PAGED_POOL_IDS)
@pytest.mark.parametrize("ctx", ["1", "page-1", "page", "page+1", "8190"])
def test_paged_split_kernel_contexts_page128_match_plain(cuda, qdtype, pool,
                                                         ctx):
    """The serving engine's 128-position pages at D = 128, S = 1."""
    ps = 128
    n = {"1": 1, "page-1": ps - 1, "page": ps, "page+1": ps + 1,
         "8190": 8190}[ctx]
    pps, rl, pad, wp0 = _context(n, ps, 1)
    out, ref, _ = _paged_run(cuda, 12, qdtype, pool, 128, ps, pps, 1, rl,
                             pad, wp0)
    _paged_close(out, ref, qdtype, pool)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,pool", PAGED_POOLS, ids=PAGED_POOL_IDS)
@pytest.mark.parametrize("s", [1, 5], ids=["decode", "verify5"])
def test_paged_split_in_padding_and_live_end_inside_split(cuda, qdtype, pool,
                                                          s):
    """Slot 1's bucket padding holds whole splits (they find no live tile
    and leave an empty partial) and its live range ends inside a split;
    checked against the plan the wrapper launches."""
    ps, pps, b, h, kvh = 16, 64, 3, 8, 2
    plan = kernels.paged_attention_plan(b, s, h, kvh, ps, pps,
                                        kernels.sm_count(cuda))
    span = plan.split_pages * ps
    pad1 = 3 * span
    wp1 = pad1 + span // 2 + 3 - s
    assert plan.splits >= 5 and wp1 + s <= pps * ps
    assert 5 <= span and pad1 >= 2 * span       # split 1 is all padding
    assert (wp1 + s) % span                      # the live end inside one
    out, ref, _ = _paged_run(cuda, 13, qdtype, pool, 64, ps, pps, s,
                             [40, 5, 0], [48, pad1, 0], [60, wp1, 0])
    _paged_close(out, ref, qdtype, pool)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,pool", PAGED_POOLS, ids=PAGED_POOL_IDS)
def test_paged_split_kernel_repeat_launches_bitwise(cuda, qdtype, pool):
    """The splits merge in split order, whichever block finishes last: two
    launches at a long context give the same bits."""
    pps, rl, pad, wp0 = _context(8000, 128, 1)
    out, ref, (args, kw) = _paged_run(cuda, 14, qdtype, pool, 128, 128, pps,
                                      1, rl, pad, wp0)
    again = kernels.paged_attention_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(again))
    _paged_close(out, ref, qdtype, pool)


@pytest.mark.cuda
def test_paged_plan_fills_the_card_at_the_serving_shape(cuda):
    """The Llama-3-8B decode step (4 slots, 32 heads over 8 kv heads,
    8 pages of 128 a slot) launches well over one block an SM."""
    sms = kernels.sm_count(cuda)
    plan = kernels.paged_attention_plan(4, 1, 32, 8, 128, 8, sms)
    assert plan.blocks >= 1.5 * sms, (plan, sms)


# ---- add + LayerNorm on the persistent grid --------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 4097])
@pytest.mark.parametrize("width", ["8", "768", "4096", "max"])
def test_add_layernorm_persistent_grid_matches_plain(cuda, dtype, n, width):
    """One row, and 4097 rows (no multiple of any grid the card holds);
    widths 8, 768, 4096 and the widest the wrapper takes (4096 vectors of
    16 bytes); s bitwise, mean and rstd checked."""
    d = 4096 * 16 // (4 if dtype == torch.float32 else 2) \
        if width == "max" else int(width)
    g = torch.Generator(device=cuda).manual_seed(15)
    x = (torch.randn(n, d, device=cuda, generator=g) + 30.0).to(dtype)
    r = torch.randn(n, d, device=cuda, generator=g).to(dtype)
    scale = (torch.rand(d, device=cuda, generator=g) + 0.5).to(dtype)
    bias = torch.randn(d, device=cuda, generator=g).to(dtype)
    n0 = kernels.fused_add_layernorm_fwd.launches
    s, y, mean, rstd = kernels.fused_add_layernorm_fwd(x, r, scale, bias,
                                                       1e-5)
    rs, ry, rmean, rrstd = kernels.fused_add_layernorm_plain(x, r, scale,
                                                             bias, 1e-5)
    torch.cuda.synchronize()
    assert kernels.fused_add_layernorm_fwd.launches == n0 + 1
    assert torch.equal(_bits(s), _bits(rs))
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rrstd, rtol=1e-4, atol=0)
    tol = (dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32
           else dict(rtol=1e-2, atol=2e-2))
    torch.testing.assert_close(y.float(), ry.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", POOLS, ids=["int8", "fp8"])
@pytest.mark.parametrize("ctx", [130, 8190])
def test_quantized_paged_kernel_keeps_f32_products(cuda, pool, ctx):
    """Under bf16 queries the tensor-core kernel computes a quantized pool's
    attention as the f32 reference does (the plain version fed the same
    queries in f32): its only rounding of note is the bf16 output's, half
    a bf16 step (2^-9 = 1.95e-3 of an element); 2.5e-3 of the output's
    largest magnitude leaves room for the probabilities' 16 significant
    bits and sums in other orders."""
    pps, rl, pad, wp0 = _context(ctx, 128, 1)
    out, _, (args, kw) = _paged_run(cuda, 16, torch.bfloat16, pool, 128,
                                    128, pps, 1, rl, pad, wp0)
    ref = kernels.paged_attention_plain(args[0].float(), *args[1:], **kw)
    assert _rel_err(out, ref) <= 2.5e-3, _rel_err(out, ref)


# ---- the fused optimizer update --------------------------------------------

UPDATE_RULES = {
    "sgd": kernels.UpdateRule("sgd"),
    "sgd_wd": kernels.UpdateRule("sgd", weight_decay=0.01),
    "momentum": kernels.UpdateRule("sgd", momentum=0.9, weight_decay=0.01),
    "nesterov": kernels.UpdateRule("sgd", momentum=0.9, nesterov=True),
    "adam": kernels.UpdateRule("adam", weight_decay=0.01),
    "adam_nowd": kernels.UpdateRule("adam"),
}
#: odd sizes, 1-element leaves, and a leaf past one 2048-element tile
UPDATE_SHAPES = [(1,), (3, 5), (1,), (17,), (64, 33), (2049,), (7, 1, 3)]


def _update_case(cuda, rule, dtype, shapes, seed, f32_grads=()):
    """Weights, gradients (f32 for the leaves in ``f32_grads``) and flat
    state; moments positive where Adam's v must be."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    ps = [torch.randn(s, device=cuda, generator=g).to(dtype) for s in shapes]
    gs = [torch.randn(s, device=cuda, generator=g).to(
        torch.float32 if i in f32_grads else dtype)
        for i, s in enumerate(shapes)]
    total = sum(p.numel() for p in ps)
    ms = [torch.randn(total, device=cuda, generator=g).abs().to(dtype)
          for _ in range(rule.n_moments)]
    return ps, gs, ms


def _per_leaf(rule, ps, gs, ms, lr, finite=None):
    """The per-leaf torch formula on the same tensors (optimizer.py
    apply_update_plain), state sliced from the flat vectors or taken leaf
    by leaf (the per-leaf form)."""
    from flexflow_tpu_torch.runtime.optimizer import apply_update_plain

    off = 0
    for i, (p, gr) in enumerate(zip(ps, gs)):
        n = p.numel()
        apply_update_plain(
            rule, p, gr, [m[off:off + n].view(p.shape) if torch.is_tensor(m)
                          else m[i] for m in ms], lr, finite)
        off += n


def _clone(ts):
    return [t.clone() for t in ts]


def _same(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rule", list(UPDATE_RULES), ids=list(UPDATE_RULES))
def test_fused_update_kernel_bitwise_per_leaf(cuda, dtype, rule):
    """Three steps at odd leaf sizes, 1-element leaves and a grad-dtype
    mismatch (f32 grads of two leaves): the kernel's weights and state are
    bitwise the per-leaf torch update's and its plain version's, with one
    launch a step."""
    rule = UPDATE_RULES[rule]
    ps, gs, ms = _update_case(cuda, rule, dtype, UPDATE_SHAPES, 21,
                              f32_grads=(1, 4))
    ref_p, ref_m = _clone(ps), _clone(ms)
    plain_p, plain_m = _clone(ps), _clone(ms)
    for step in range(3):
        lr = torch.full((), 0.01 * (step + 1), device=cuda)
        n0 = kernels.fused_update.launches
        kernels.fused_update(rule, ps, gs, ms, lr)
        assert kernels.fused_update.launches == n0 + 1
        _per_leaf(rule, ref_p, gs, ref_m, lr)
        kernels.fused_update_plain(rule, plain_p, gs, plain_m, lr)
    torch.cuda.synchronize()
    assert _same(ps, ref_p) and _same(ms, ref_m)
    assert _same(ps, plain_p) and _same(ms, plain_m)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["momentum", "adam"])
def test_fused_update_many_leaves_take_several_launches(cuda, rule):
    """300 leaves: three launches of at most 128 leaves each, state offsets
    carried across them; bitwise the per-leaf update."""
    rule = UPDATE_RULES[rule]
    shapes = [((i * 37) % 50 + 1,) for i in range(300)]
    ps, gs, ms = _update_case(cuda, rule, torch.bfloat16, shapes, 22)
    ref_p, ref_m = _clone(ps), _clone(ms)
    lr = torch.full((), 0.05, device=cuda)
    n0 = kernels.fused_update.launches
    kernels.fused_update(rule, ps, gs, ms, lr)
    _per_leaf(rule, ref_p, gs, ref_m, lr)
    torch.cuda.synchronize()
    assert kernels.fused_update.launches == n0 + 3
    assert _same(ps, ref_p) and _same(ms, ref_m)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam"])
def test_fused_update_finite_flag_off_writes_nothing(cuda, rule):
    rule = UPDATE_RULES[rule]
    ps, gs, ms = _update_case(cuda, rule, torch.bfloat16, UPDATE_SHAPES, 23)
    before_p, before_m = _clone(ps), _clone(ms)
    lr = torch.full((), 0.05, device=cuda)
    kernels.fused_update(rule, ps, gs, ms, lr,
                         torch.zeros((), dtype=torch.bool, device=cuda))
    torch.cuda.synchronize()
    assert _same(ps, before_p) and _same(ms, before_m)
    kernels.fused_update(rule, ps, gs, ms, lr,
                         torch.ones((), dtype=torch.bool, device=cuda))
    _per_leaf(rule, before_p, gs, before_m, lr)
    torch.cuda.synchronize()
    assert _same(ps, before_p) and _same(ms, before_m)


@pytest.mark.cuda
def test_fused_update_bucket_past_2_31_bytes(cuda):
    """A bf16 bucket of 2^30 + 2^20 + 9 elements (past 2^31 bytes, as the
    flagship's 1.21 B weights are) with momentum: 64-bit indices into the
    weights and the flat state; bitwise the per-leaf update."""
    rule = UPDATE_RULES["momentum"]
    shapes = [(2 ** 20 + 9,), (2 ** 30,)]
    ps, gs, ms = _update_case(cuda, rule, torch.bfloat16, shapes, 24)
    ref_p, ref_m = _clone(ps), _clone(ms)
    lr = torch.full((), 0.01, device=cuda)
    kernels.fused_update(rule, ps, gs, ms, lr)
    _per_leaf(rule, ref_p, gs, ref_m, lr)
    torch.cuda.synchronize()
    assert _same(ps, ref_p) and _same(ms, ref_m)


@pytest.mark.cuda
def test_fused_update_refuses_what_it_does_not_take(cuda):
    rule = UPDATE_RULES["adam"]
    ps, gs, ms = _update_case(cuda, rule, torch.bfloat16, [(4,), (5,)], 25)
    lr = torch.full((), 0.01, device=cuda)
    with pytest.raises(ValueError, match="state vectors"):
        kernels.fused_update(rule, ps, gs, ms[:1], lr)
    with pytest.raises(ValueError, match="leaf 1"):
        kernels.fused_update(rule, ps, [gs[0], gs[1].to(torch.float16)], ms,
                             lr)
    with pytest.raises(ValueError, match="0-dim f32"):
        kernels.fused_update(rule, ps, gs, ms, lr.double())


FORMS = ["flat", "per_leaf"]
#: around the 8-element bf16 vector, the 4-element f32 one, the
#: 4096-element bf16 (2048 f32) chunk and several chunks
EDGE_SHAPES = [(1,), (7,), (8,), (9,), (4095,), (4096,), (4097,), (3, 5),
               (8191,), (8193,), (16385,)]


def _as_form(ms, ps, form):
    """The flat state ``ms`` as ``form``: itself, or per-leaf tensors of
    each weight's shape (fresh allocations)."""
    if form == "flat":
        return ms
    out = []
    for m in ms:
        leaves, off = [], 0
        for p in ps:
            leaves.append(m[off:off + p.numel()].clone().view(p.shape))
            off += p.numel()
        out.append(leaves)
    return out


def _clone_state(ms):
    return [m.clone() if torch.is_tensor(m) else _clone(m) for m in ms]


def _state_list(ms):
    return [x for m in ms for x in ([m] if torch.is_tensor(m) else m)]


def _at_offset(t, off):
    """A contiguous copy of ``t`` as a view ``off`` elements into a larger
    buffer (a storage offset: the data pointer off a 16-byte boundary)."""
    buf = torch.empty(t.numel() + off + 8, dtype=t.dtype, device=t.device)
    v = buf[off:off + t.numel()].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rule", list(UPDATE_RULES), ids=list(UPDATE_RULES))
def test_fused_update_edge_sizes_bitwise_per_leaf(cuda, rule, dtype, form):
    """Leaves of 1 to 16385 elements (heads, tails and chunk edges), two
    steps: bitwise the per-leaf torch formula
    and the plain version, in either state form, one launch a step."""
    rule = UPDATE_RULES[rule]
    ps, gs, ms = _update_case(cuda, rule, dtype, EDGE_SHAPES, 31)
    ms = _as_form(ms, ps, form)
    ref_p, ref_m = _clone(ps), _clone_state(ms)
    pl_p, pl_m = _clone(ps), _clone_state(ms)
    for step in range(2):
        lr = torch.full((), 0.01 * (step + 1), device=cuda)
        n0 = kernels.fused_update.launches
        kernels.fused_update(rule, ps, gs, ms, lr)
        assert kernels.fused_update.launches == n0 + 1
        _per_leaf(rule, ref_p, gs, ref_m, lr)
        kernels.fused_update_plain(rule, pl_p, gs, pl_m, lr)
    torch.cuda.synchronize()
    assert _same(ps, ref_p) and _same(_state_list(ms), _state_list(ref_m))
    assert _same(ps, pl_p) and _same(_state_list(ms), _state_list(pl_m))


OFFSET_CASES = ["w", "g", "state", "all_same", "all_mixed"]


@pytest.mark.cuda
@pytest.mark.parametrize("where", OFFSET_CASES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rule", list(UPDATE_RULES), ids=list(UPDATE_RULES))
def test_fused_update_storage_offsets_bitwise_per_leaf(cuda, rule, dtype,
                                                       where):
    """Views at storage offsets of 1 to 7 elements in the weight, the grad
    or the per-leaf state alone, in all of them by the same offset (the
    leaf stays on the vector path after a scalar head) and in all of them
    by different offsets (the leaf goes element by element): bitwise the
    per-leaf torch formula, and the plan takes vectors exactly where
    every pointer aligns."""
    rule = UPDATE_RULES[rule]
    shapes = [(8191,), (100, 37), (9,), (4096,), (1,), (2000,), (8193,)]
    ps, gs, ms = _update_case(cuda, rule, dtype, shapes, 32)
    ms = _as_form(ms, ps, "per_leaf")
    for i in range(len(ps)):
        k = i % 7 + 1
        off = dict(w=k, g=k, s=k) if where == "all_same" else \
            dict(w=k, g=(k + 2) % 7 + 1, s=(k + 4) % 7 + 1) \
            if where == "all_mixed" else {where[0]: k}
        ps[i] = _at_offset(ps[i], off.get("w", 0))
        gs[i] = _at_offset(gs[i], off.get("g", 0))
        for m in ms:
            m[i] = _at_offset(m[i], off.get("s", 0))
    plan = kernels.fused_update_launches(ps, gs, ms)[0].plan
    for i, vec in enumerate(plan.vector):
        ptrs = [ps[i], gs[i]] + [m[i] for m in ms]
        h = plan.head[i]
        assert vec == all((t.data_ptr() + h * t.element_size()) % 16 == 0
                          for t in ptrs)
    if where == "all_same":
        assert all(plan.vector)
    ref_p, ref_m = _clone(ps), _clone_state(ms)
    lr = torch.full((), 0.02, device=cuda)
    for _ in range(2):
        kernels.fused_update(rule, ps, gs, ms, lr)
        _per_leaf(rule, ref_p, gs, ref_m, lr)
    torch.cuda.synchronize()
    assert _same(ps, ref_p) and _same(_state_list(ms), _state_list(ref_m))


@pytest.mark.cuda
@pytest.mark.parametrize("g_off", [0, 1, 3, 4, 5, 7])
@pytest.mark.parametrize("w_off", [0, 1, 3, 5])
@pytest.mark.parametrize("rule", list(UPDATE_RULES), ids=list(UPDATE_RULES))
def test_fused_update_f32_grads_of_bf16_at_odd_offsets(cuda, rule, w_off,
                                                       g_off):
    """f32 grads of bf16 weights (two 16-byte loads for 8 elements) with
    the weight and state at w_off and the grad at g_off elements into
    their buffers: vectors where both align (g_off = w_off, or 4 apart),
    element by element elsewhere; bitwise the per-leaf torch formula."""
    rule = UPDATE_RULES[rule]
    shapes = [(8193,), (17, 31), (5,)]
    ps, gs, ms = _update_case(cuda, rule, torch.bfloat16, shapes, 33,
                              f32_grads=(0, 1, 2))
    ms = _as_form(ms, ps, "per_leaf")
    ps = [_at_offset(p, w_off) for p in ps]
    gs = [_at_offset(g, g_off) for g in gs]
    ms = [[_at_offset(x, w_off) for x in m] for m in ms]
    plan = kernels.fused_update_launches(ps, gs, ms)[0].plan
    assert plan.vector[0] == ((w_off - g_off) % 4 == 0)
    ref_p, ref_m = _clone(ps), _clone_state(ms)
    lr = torch.full((), 0.03, device=cuda)
    kernels.fused_update(rule, ps, gs, ms, lr)
    _per_leaf(rule, ref_p, gs, ref_m, lr)
    torch.cuda.synchronize()
    assert _same(ps, ref_p) and _same(_state_list(ms), _state_list(ref_m))


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n_leaves", [129, 300])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rule", list(UPDATE_RULES), ids=list(UPDATE_RULES))
def test_fused_update_leaves_past_one_launch(cuda, rule, dtype, n_leaves,
                                             form):
    """129 and 300 leaves: a launch per 128, each leaf's state pointer
    carried across them; bitwise the per-leaf torch formula."""
    rule = UPDATE_RULES[rule]
    shapes = [((i * 53) % 700 + 1,) for i in range(n_leaves)]
    ps, gs, ms = _update_case(cuda, rule, dtype, shapes, 34)
    ms = _as_form(ms, ps, form)
    ref_p, ref_m = _clone(ps), _clone_state(ms)
    lr = torch.full((), 0.05, device=cuda)
    n0 = kernels.fused_update.launches
    kernels.fused_update(rule, ps, gs, ms, lr)
    _per_leaf(rule, ref_p, gs, ref_m, lr)
    torch.cuda.synchronize()
    assert kernels.fused_update.launches == n0 + -(-n_leaves // 128)
    assert _same(ps, ref_p) and _same(_state_list(ms), _state_list(ref_m))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rule", list(UPDATE_RULES), ids=list(UPDATE_RULES))
def test_fused_update_per_leaf_finite_flag_off_writes_nothing(cuda, rule,
                                                              dtype):
    rule = UPDATE_RULES[rule]
    ps, gs, ms = _update_case(cuda, rule, dtype, EDGE_SHAPES, 35)
    ms = _as_form(ms, ps, "per_leaf")
    before_p, before_m = _clone(ps), _clone_state(ms)
    lr = torch.full((), 0.05, device=cuda)
    kernels.fused_update(rule, ps, gs, ms, lr,
                         torch.zeros((), dtype=torch.bool, device=cuda))
    torch.cuda.synchronize()
    assert _same(ps, before_p)
    assert _same(_state_list(ms), _state_list(before_m))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rule", list(UPDATE_RULES), ids=list(UPDATE_RULES))
def test_fused_update_per_leaf_and_flat_forms_agree(cuda, rule, dtype):
    """The same update through per-leaf state tensors and through the flat
    vectors: bitwise each other."""
    rule = UPDATE_RULES[rule]
    ps, gs, ms = _update_case(cuda, rule, dtype, UPDATE_SHAPES + EDGE_SHAPES,
                              36, f32_grads=(1, 9) if dtype != torch.float32
                              else ())
    per = _as_form(ms, ps, "per_leaf")
    ps2 = _clone(ps)
    lr = torch.full((), 0.04, device=cuda)
    for _ in range(3):
        kernels.fused_update(rule, ps, gs, ms, lr)
        kernels.fused_update(rule, ps2, gs, per, lr)
    torch.cuda.synchronize()
    assert _same(ps, ps2)
    for m, leaves in zip(ms, per):
        assert _same([m], [torch.cat([x.reshape(-1) for x in leaves])])


def _opt_tree(cuda, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    shapes = {"dense": {"kernel": (64, 129), "bias": (129,)},
              "ln": {"scale": (7,), "bias": (7,)},
              "head": {"kernel": (129, 16), "bias": (16,)}}
    return {op: {k: torch.randn(s, device=cuda, generator=g).to(dtype)
                 for k, s in ws.items()} for op, ws in shapes.items()}


def _optimizers():
    from flexflow_tpu_torch import AdamOptimizer, SGDOptimizer
    from flexflow_tpu_torch.runtime import schedule

    return {
        "sgd": lambda: SGDOptimizer(lr=0.05),
        "momentum": lambda: SGDOptimizer(lr=0.05, momentum=0.9,
                                         weight_decay=0.01),
        "adam": lambda: AdamOptimizer(alpha=0.01,
                                      schedule=schedule.WarmupLinear(1, 8)),
    }


def _plain_steps(opt, params, grads, state, steps):
    """``steps`` updates of the per-leaf torch formula on a copy."""
    from flexflow_tpu_torch.runtime.optimizer import apply_update_plain

    names = opt.moment_names()
    t = state["t"].clone()
    for _ in range(steps):
        lr = opt.lr_of(t)
        for op, ws in params.items():
            for k, w in ws.items():
                apply_update_plain(opt.rule, w, grads[op][k],
                                   [state[n][op][k] for n in names], lr)
        t += 1


def _copy_tree(tree):
    return {op: {k: w.clone() for k, w in ws.items()}
            for op, ws in tree.items()}


def _copy_state(state, names):
    out = {n: _copy_tree(state[n]) for n in names}
    out["t"] = state["t"].clone()
    return out


def _same_tree(a, b):
    return all(torch.equal(_bits(w), _bits(b[op][k]))
               for op, ws in a.items() for k, w in ws.items())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_optimizer_per_leaf_update_launches_the_kernel(cuda, opt, dtype):
    """The per-leaf Optimizer's update on CUDA tensors: one fused_update
    launch a step (one dtype bucket), per-leaf state kept, f32 grads of
    bf16 weights on one leaf; bitwise the per-leaf torch formula over
    three steps of the schedule."""
    make = _optimizers()[opt]
    o = make()
    params = _opt_tree(cuda, dtype, 37)
    state = o.init_state(params)
    grads = [_opt_tree(cuda, dtype, 38 + i) for i in range(3)]
    if dtype == torch.bfloat16:
        for g in grads:
            g["dense"]["kernel"] = g["dense"]["kernel"].float()
    names = o.moment_names()
    ref_p, ref_s = _copy_tree(params), _copy_state(state, names)
    n0 = kernels.fused_update.launches
    for g in grads:
        o.update(params, g, state)
    assert kernels.fused_update.launches == n0 + 3
    for g in grads:
        _plain_steps(o, ref_p, g, ref_s, 1)
        ref_s["t"] += 1
    torch.cuda.synchronize()
    assert int(state["t"]) == 3
    assert _same_tree(params, ref_p)
    assert all(_same_tree(state[n], ref_s[n]) for n in names)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_per_leaf_update_graph_replay_bitwise(cuda, opt, dtype):
    """The per-leaf Optimizer's update captured in a CUDA graph (the leaf
    table held by value) and replayed three times: bitwise three eager
    steps of the per-leaf torch formula, the step counter and the
    scheduled lr read on the device at each replay."""
    o = _optimizers()[opt]()
    params = _opt_tree(cuda, dtype, 41)
    grads = _opt_tree(cuda, dtype, 42)
    state = o.init_state(params)
    names = o.moment_names()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        o.update(params, grads, state)          # eager warm-up step
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    ref_p, ref_s = _copy_tree(params), _copy_state(state, names)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        o.update(params, grads, state)
    for _ in range(3):
        graph.replay()
    _plain_steps(o, ref_p, grads, ref_s, 3)
    torch.cuda.synchronize()
    assert int(state["t"]) == 4
    assert _same_tree(params, ref_p)
    assert all(_same_tree(state[n], ref_s[n]) for n in names)


VECTOR_COUNT_CASES = ["flat", "per_leaf", "w", "all_same", "all_mixed",
                      "f32_grads", "finite_off"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", VECTOR_COUNT_CASES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rule", ["sgd", "adam"])
def test_fused_update_counts_its_vector_path(cuda, rule, dtype, case):
    """``vector_count``: the elements the kernel stored on its 16-byte
    path, counted on the card, equal the plan's vector elements (aligned
    leaves in both state forms, storage offsets, f32 grads of bf16 weights
    at an odd offset), and nothing under a false ``finite``; the update
    stays bitwise the per-leaf torch formula with the counter on."""
    rule = UPDATE_RULES[rule]
    ps, gs, ms = _update_case(
        cuda, rule, dtype, EDGE_SHAPES, 44,
        f32_grads=range(len(EDGE_SHAPES)) if case == "f32_grads" else ())
    ms = _as_form(ms, ps, "flat" if case == "flat" else "per_leaf")
    for i in range(len(ps)):
        k = i % 7 + 1
        off = dict(w=dict(w=k), all_same=dict(w=k, g=k, s=k),
                   all_mixed=dict(w=k, g=(k + 2) % 7 + 1, s=(k + 4) % 7 + 1),
                   f32_grads=dict(g=3)).get(case, {})
        ps[i] = _at_offset(ps[i], off.get("w", 0))
        gs[i] = _at_offset(gs[i], off.get("g", 0))
        if case != "flat":
            for m in ms:
                m[i] = _at_offset(m[i], off.get("s", 0))
    planned = sum(sum(kernels.fused_update_vector_elements(x.plan))
                  for x in kernels.fused_update_launches(ps, gs, ms))
    if case in ("flat", "per_leaf", "all_same"):
        assert planned > 0
    ref_p, ref_m = _clone(ps), _clone_state(ms)
    lr = torch.full((), 0.02, device=cuda)
    finite = (torch.zeros((), dtype=torch.bool, device=cuda)
              if case == "finite_off" else None)
    counted = torch.zeros(1, dtype=torch.int64, device=cuda)
    kernels.fused_update(rule, ps, gs, ms, lr, finite, vector_count=counted)
    _per_leaf(rule, ref_p, gs, ref_m, lr, finite)
    torch.cuda.synchronize()
    assert int(counted) == (0 if finite is not None else planned)
    assert _same(ps, ref_p) and _same(_state_list(ms), _state_list(ref_m))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_optimizer_update_plain_on_the_card_is_the_kernel(cuda, opt, dtype):
    """``Optimizer.update_plain`` on CUDA tensors (the per-leaf torch
    formula, no launch) and ``Optimizer.update`` (the kernel) from the same
    weights and state, three steps: bitwise, the step counter advanced by
    both."""
    o = _optimizers()[opt]()
    params = _opt_tree(cuda, dtype, 45)
    state = o.init_state(params)
    names = o.moment_names()
    ref_p, ref_s = _copy_tree(params), _copy_state(state, names)
    grads = [_opt_tree(cuda, dtype, 46 + i) for i in range(3)]
    n0 = kernels.fused_update.launches
    for g in grads:
        o.update_plain(ref_p, g, ref_s)
    assert kernels.fused_update.launches == n0
    for g in grads:
        o.update(params, g, state)
    assert kernels.fused_update.launches == n0 + 3
    torch.cuda.synchronize()
    assert int(state["t"]) == int(ref_s["t"]) == 3
    assert _same_tree(params, ref_p)
    assert all(_same_tree(state[n], ref_s[n]) for n in names)


@pytest.mark.cuda
def test_fused_update_refuses_bad_per_leaf_state(cuda):
    rule = UPDATE_RULES["momentum"]
    ps, gs, ms = _update_case(cuda, rule, torch.bfloat16, [(4,), (5,)], 43)
    per = _as_form(ms, ps, "per_leaf")
    lr = torch.full((), 0.01, device=cuda)
    with pytest.raises(ValueError, match="per-leaf state of 1"):
        kernels.fused_update(rule, ps, gs, [per[0][:1]], lr)
    with pytest.raises(ValueError, match="leaf 1: per-leaf state"):
        kernels.fused_update(rule, ps, gs, [[per[0][0], per[0][1].float()]],
                             lr)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fused_update(rule, [ps[0], ps[1]], gs,
                             [[per[0][0], torch.zeros(
                                 10, dtype=torch.bfloat16,
                                 device=cuda)[::2]]], lr)


# ---- the train loop on the card ---------------------------------------------


def _small_flagship(device, opt, seed=5, **cfg):
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType,
                                    MetricsType, SingleDataLoader)
    from flexflow_tpu_torch.models import build_encoder_classifier

    ff = FFModel(FFConfig(batch_size=4, seed=seed, use_fused_ln=True, **cfg),
                 device=device)
    x, out = build_encoder_classifier(ff, 4, 64, 128, 2, 4, 4, 16)
    ff.compile(opt, LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY], final_tensor=out)
    rs = torch.Generator().manual_seed(seed)
    SingleDataLoader(ff, x, torch.randn(24, 64, 128, generator=rs).numpy())
    SingleDataLoader(ff, ff.label_tensor, torch.randint(
        0, 16, (24, 1), generator=rs, dtype=torch.int32).numpy())
    return ff


def _copy_weights(dst, src):
    dst.params = {op: {w: t.detach().to(dst.device).clone()
                       for w, t in ws.items()} for op, ws in
                  src.params.items()}
    dst.opt_state = dst.optimizer.init_state(dst.params)


def _max_diff(a, b, skip=()):
    return max((a.params[op][w].detach().cpu().float()
                - t.detach().cpu().float()).abs().max().item()
               for op, ws in b.params.items() for w, t in ws.items()
               if w not in skip)


@pytest.mark.cuda
def test_scanned_steps_replay_a_cuda_graph_like_per_step(cuda):
    """scan_steps 3 through FFModel.train_scanned (one eager step, one
    capture, replays) against per-step training from the same weights,
    f32: losses and weights within 1e-5 (the graph replays the same
    kernels; cuBLAS may pick other algorithms under capture), and the
    launch counters count every replayed launch."""
    from flexflow_tpu_torch import SGDOptimizer

    per = _small_flagship(cuda, SGDOptimizer(lr=0.05, momentum=0.9))
    scan = _small_flagship(cuda, SGDOptimizer(lr=0.05, momentum=0.9),
                           scan_steps=3, fused_optimizer=True)
    _copy_weights(scan, per)
    _copy_weights(per, scan)
    kernels.reset_launch_counts()
    losses, mets = scan.train_scanned(6)
    torch.cuda.synchronize()
    assert losses.shape == (6,) and mets["accuracy_count"].shape == (6,)
    launched = kernels.launch_counts()
    assert launched["flash_attention_fwd"] == 2 * 6
    assert launched["fused_add_layernorm_fwd"] == 4 * 6
    assert launched["fused_update"] == 6
    assert scan._replay.replays == 5
    ref = [float(per._run_train_step(per._stage_batch())[0])
           for _ in range(6)]
    torch.testing.assert_close(losses.cpu(), torch.tensor(ref), rtol=1e-5,
                               atol=1e-5)
    assert _max_diff(scan, per) <= 1e-5


@pytest.mark.cuda
def test_adam_and_guard_on_the_card_match_the_cpu(cuda):
    """Adam under WarmupCosine, fused, guarded with one injected NaN step:
    3 steps on the card vs the CPU from the same weights, f32. Every weight
    within 1e-5 but the key biases, whose exact gradient is zero (softmax
    ignores a shift of every key) and whose Adam steps are rounding noise
    normalised: those within 3 steps of alpha (1 - b1) / sqrt(1 - b2)."""
    from flexflow_tpu_torch import AdamOptimizer, WarmupCosine

    def adam():
        return AdamOptimizer(alpha=0.01, schedule=WarmupCosine(1, 10))

    cfg = dict(fused_optimizer=True, on_nonfinite="skip")
    cpu = _small_flagship("cpu", adam(), **cfg)
    gpu = _small_flagship(cuda, adam(), **cfg)
    _copy_weights(gpu, cpu)
    for i in range(4):
        b = cpu._stage_batch()
        lc, _ = cpu._run_train_step(b, inject_nan=(i == 1))
        lg, mg = gpu._run_train_step(gpu._stage_batch(), inject_nan=(i == 1))
        if i == 1:
            assert int(mg["nonfinite"]) == 1
        else:
            torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-5)
    assert int(gpu._guard_state["skipped"]) == 1
    assert int(gpu.opt_state["t"]) == 3
    assert _max_diff(gpu, cpu, skip=("bias_k",)) <= 1e-5
    assert _max_diff(gpu, cpu) <= 3 * 0.01 * 0.1 / (0.001 ** 0.5)


# ---- the zoo slice on the card ----------------------------------------------


@pytest.fixture
def no_tf32(cuda):
    """f32 convs and matmuls in f32 (cuDNN's TF32 is on by default)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _zoo_op_graph(device, build):
    """A one-op graph from ``build(ff) -> ({name: array}, output)``, f32,
    compiled for training (SGD) on ``device``."""
    from flexflow_tpu_torch import LossType, MetricsType, SGDOptimizer

    ff = FFModel(FFConfig(batch_size=2, seed=3), device=device)
    feeds, out = build(ff)
    ff.compile(SGDOptimizer(lr=0.1),
               LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
               [MetricsType.METRICS_MEAN_SQUARED_ERROR], final_tensor=out)
    return ff, feeds, out


def _zoo_ops():
    import numpy as np
    from flexflow_tpu_torch import AggrMode, DataType, PoolType

    rs = np.random.RandomState(0)

    def one(verb, shape, *args, offset=0.0, **kw):
        def build(ff):
            x = ff.create_tensor(list(shape), name="x")
            y = getattr(ff, verb)(x, *args, name="op", **kw)
            return ({"x": (rs.randn(*shape) + offset).astype(np.float32)},
                    y[0] if isinstance(y, list) else y)
        return build

    def bag(aggr):
        def build(ff):
            idx = ff.create_tensor([4, 6], DataType.DT_INT32, name="idx")
            y = ff.embedding(idx, 50, 16, aggr, name="op")
            return {"idx": rs.randint(0, 50, (4, 6)).astype(np.int32)}, y
        return build

    def bmm(ff):
        a = ff.create_tensor([2, 3, 16, 8], name="a")
        b = ff.create_tensor([2, 3, 8, 12], name="b")
        return ({"a": rs.randn(2, 3, 16, 8).astype(np.float32),
                 "b": rs.randn(2, 3, 8, 12).astype(np.float32)},
                ff.batch_matmul(a, b, name="op"))

    def concat_gather(ff):
        a = ff.create_tensor([2, 3, 4], name="a")
        b = ff.create_tensor([2, 5, 4], name="b")
        c = ff.concat([a, b], axis=1, name="cat")
        idx = ff.create_tensor([2, 3, 4], DataType.DT_INT32, name="idx")
        return ({"a": rs.randn(2, 3, 4).astype(np.float32),
                 "b": rs.randn(2, 5, 4).astype(np.float32),
                 "idx": rs.randint(0, 8, (2, 3, 4)).astype(np.int32)},
                ff.gather(c, idx, axis=1, name="op"))

    relu = __import__("flexflow_tpu_torch").ActiMode.AC_MODE_RELU
    return {
        # the slice of MoE and LSTM / GRU: the MoE at a binding capacity
        # (4 of ~12 assignments an expert)
        "moe-sort": one("moe", (2, 12, 16), 4, 32, capacity_factor=0.5,
                        dispatch="sort"),
        "moe-dense": one("moe", (2, 12, 16), 4, 32, capacity_factor=0.5,
                         dispatch="dense"),
        "lstm": one("lstm", (3, 7, 12), 10),
        "lstm-last": one("lstm", (3, 7, 12), 10, return_sequences=False),
        "gru": one("gru", (3, 7, 12), 10),
        "gru-last": one("gru", (3, 7, 12), 10, return_sequences=False),
        "conv-strided-padded": one("conv2d", (2, 8, 17, 17), 16, 3, 3, 2, 2,
                                   1, 1, relu),
        "conv-grouped": one("conv2d", (2, 8, 9, 9), 8, 3, 3, 1, 1, 1, 1,
                            groups=4, use_bias=False),
        "conv-1x7": one("conv2d", (2, 4, 9, 12), 6, 1, 7, 1, 1, 0, 3),
        "pool-max": one("pool2d", (2, 4, 9, 9), 3, 3, 2, 2, 1, 1),
        "pool-avg": one("pool2d", (2, 4, 9, 9), 3, 3, 1, 1, 1, 1,
                        PoolType.POOL_AVG),
        "pool-max-past-half": one("pool2d", (2, 4, 9, 9), 3, 3, 2, 2, 2, 2),
        "pool-avg-past-half": one("pool2d", (2, 4, 9, 9), 3, 3, 1, 1, 2, 2,
                                  PoolType.POOL_AVG),
        "batch-norm-relu": one("batch_norm", (4, 6, 5, 5), True,
                               offset=2.0),
        "batch-norm": one("batch_norm", (4, 6, 5, 5), False, offset=-1.0),
        "flat": one("flat", (2, 3, 4, 5)),
        "embedding-sum": bag(AggrMode.AGGR_MODE_SUM),
        "embedding-avg": bag(AggrMode.AGGR_MODE_AVG),
        "batch-matmul": bmm,
        "softmax": one("softmax", (2, 5, 33), -1),
        "reshape": one("reshape", (2, 3, 4), [4, -1, 3]),
        "transpose": one("transpose", (2, 3, 4), [2, 0, 1]),
        "reverse": one("reverse", (2, 3, 4), 1),
        "split": one("split", (2, 6, 4), [1, 2, 3], 1),
        "topk": one("topk", (3, 40), 5),
        "pad": one("pad", (2, 3, 4), [(0, 0), (1, 2), (3, 0)], 0.5),
        "concat-gather": concat_gather,
        "cast-bf16": one("cast", (2, 6), DataType.DT_BFLOAT16),
        "gelu": one("gelu", (3, 40)),
        "elu": one("elu", (3, 40)),
        "rsqrt": one("rsqrt", (3, 40), offset=3.0),
        "pow": one("pow", (3, 40), 3.0),
        "divide": lambda ff: (lambda a, b: (
            {"a": rs.randn(3, 40).astype(np.float32),
             "b": (rs.randn(3, 40) + 4).astype(np.float32)},
            ff.divide(a, b, name="op")))(ff.create_tensor([3, 40], name="a"),
                                         ff.create_tensor([3, 40], name="b")),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_zoo_ops()))
def test_zoo_op_on_card_matches_the_cpu(no_tf32, case):
    """Each new op in training mode, f32 without TF32, on the card against
    the same op on the CPU from the same weights: outputs within 1e-5, the
    gradients of every weight and float input within 1e-5 of their largest
    value (sums in other orders); the BatchNorm state's update too."""
    import numpy as np

    graphs = []
    for dev in ("cpu", no_tf32):
        ff, feeds, out = _zoo_op_graph(dev, _zoo_ops()[case])
        graphs.append((ff, feeds, out))
    cpu, feeds, cout = graphs[0]
    gpu, _, gout = graphs[1]
    _copy_weights(gpu, cpu)
    results = []
    for ff, out in ((cpu, cout), (gpu, gout)):
        ins = {op.name: op.outputs[0] for op in ff.ops
               if type(op).__name__ == "InputOp"}
        xs = {k: torch.tensor(v, device=ff.device,
                              requires_grad=np.issubdtype(v.dtype,
                                                          np.floating))
              for k, v in feeds.items()}
        leaves = [w.requires_grad_() for ws in ff.params.values()
                  for w in ws.values()]
        vals, state = ff.executor.apply_graph(
            ff.params, {ins[k]: x for k, x in xs.items()}, training=True,
            state=ff.bn_state)
        y = vals[out]
        wrt = leaves + [x for x in xs.values() if x.requires_grad]
        cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(
            1)).to(ff.device, y.dtype)
        grads = (torch.autograd.grad((y * cot).sum(), wrt)
                 if y.requires_grad else [])
        results.append((y.detach().float().cpu(),
                        [g.float().cpu() for g in grads],
                        [v.cpu() for ws in state.values()
                         for v in ws.values()]))
    (yc, gc_, sc), (yg, gg, sg) = results
    torch.testing.assert_close(yg, yc, rtol=1e-5, atol=1e-5)
    for a, b in zip(gg, gc_):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * b.abs().max().item() + 1e-7)
    for a, b in zip(sg, sc):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _bn_cnn(device, seed=1, **cfg):
    """conv -> BatchNorm (relu) -> conv -> BatchNorm -> global pool -> fc,
    f32, SGD, 6 batches of 4 staged."""
    import numpy as np
    from flexflow_tpu_torch import (LossType, MetricsType, PoolType,
                                    SGDOptimizer, SingleDataLoader)

    ff = FFModel(FFConfig(batch_size=4, seed=seed, **cfg), device=device)
    x = ff.create_tensor([4, 3, 16, 16], name="input")
    t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="c1")
    t = ff.batch_norm(t, relu=True, name="bn1")
    t = ff.conv2d(t, 8, 3, 3, 2, 2, 1, 1, name="c2")
    t = ff.batch_norm(t, relu=False, name="bn2")
    t = ff.pool2d(t, 8, 8, 1, 1, 0, 0, PoolType.POOL_AVG, name="gap")
    out = ff.dense(ff.flat(t), 5, name="fc")
    ff.compile(SGDOptimizer(lr=0.1),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY], final_tensor=out)
    rs = np.random.RandomState(seed)
    SingleDataLoader(ff, x, (rs.randn(24, 3, 16, 16) * 2 + 1).astype(
        np.float32))
    SingleDataLoader(ff, ff.label_tensor,
                     rs.randint(0, 5, (24, 1)).astype(np.int32))
    return ff


@pytest.mark.cuda
def test_bn_state_under_step_replay_matches_per_step(no_tf32):
    """BatchNorm's running state through scan_steps (a CUDA graph of one
    step replayed; the state committed in place with copy_, so every
    replay writes the live tensors) against per-step training on the card
    and on the CPU from the same weights: state within 1e-6, weights
    within 1e-5, and the state moves on every replayed step."""
    per = _bn_cnn(no_tf32)
    scan = _bn_cnn(no_tf32, scan_steps=3)
    cpu = _bn_cnn("cpu")
    for ff in (scan, cpu):
        _copy_weights(ff, per)
    addr = {op: {k: v.data_ptr() for k, v in ws.items()}
            for op, ws in scan.bn_state.items()}
    means = []
    for _ in range(2):
        scan.train_scanned(3)
        means.append(scan.bn_state["bn1"]["mean"].clone())
    # the first chunk: an eager step, the capture, 2 replays; then 3
    assert scan._replay.replays == 5
    assert not torch.equal(means[0], means[1])
    assert addr == {op: {k: v.data_ptr() for k, v in ws.items()}
                    for op, ws in scan.bn_state.items()}
    for ff in (per, cpu):
        for _ in range(6):
            ff._run_train_step(ff._stage_batch())
    for ref in (per, cpu):
        for op, ws in ref.bn_state.items():
            for k, v in ws.items():
                torch.testing.assert_close(scan.bn_state[op][k].cpu(),
                                           v.cpu(), rtol=1e-6, atol=1e-6)
        assert _max_diff(scan, ref) <= 1e-5


@pytest.mark.cuda
def test_dropout_masks_differ_across_replays(cuda):
    """A dropout model trained by train_scanned on one repeated batch at
    lr 0: the eager step and every replay of the captured step draw their
    own masks (the op's generator is registered with the graph), so the
    losses all differ; the kept share of each replayed mask's output
    stays near keep."""
    import numpy as np
    from flexflow_tpu_torch import (LossType, MetricsType, SGDOptimizer,
                                    SingleDataLoader)

    ff = FFModel(FFConfig(batch_size=8, seed=4, scan_steps=6),
                 device=cuda)
    x = ff.create_tensor([8, 512], name="input")
    h = ff.dropout(x, 0.5, name="drop")
    out = ff.dense(h, 4, name="fc")
    ff.compile(SGDOptimizer(lr=0.0),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY], final_tensor=out)
    rs = np.random.RandomState(0)
    SingleDataLoader(ff, x, np.tile(rs.randn(8, 512).astype(np.float32),
                                    (6, 1)))
    SingleDataLoader(ff, ff.label_tensor, np.tile(
        rs.randint(0, 4, (8, 1)).astype(np.int32), (6, 1)))
    gen = ff._generators["drop"]
    before = gen.get_state()
    losses, _ = ff.train_scanned(6)
    assert ff._replay.replays == 5
    vals = losses.cpu().tolist()
    assert len(set(vals)) == 6, vals
    assert not torch.equal(gen.get_state(), before)


@pytest.mark.cuda
def test_fused_update_at_resnet50_leaves_bitwise_per_leaf(cuda):
    """The per-leaf SGD update over ResNet-50's 214 bf16 leaves (64 to
    2.4 M elements): two launches, bitwise the per-leaf torch formula
    (Optimizer.update_plain) on the card."""
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch.models import resnet50

    ff = FFModel(FFConfig(batch_size=1), device=cuda)
    resnet50(ff, 1)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = {op: {k: torch.randn(s, device=cuda, generator=g).to(
        torch.bfloat16) for k, s in ws.items()}
        for op, ws in ff.weight_shapes().items()}
    grads = {op: {k: torch.randn(w.shape, device=cuda, generator=g).mul_(
        1e-2).to(torch.bfloat16) for k, w in ws.items()}
        for op, ws in params.items()}
    assert sum(len(ws) for ws in params.values()) == 214
    opt = SGDOptimizer(lr=0.1)
    ref = {op: {k: w.clone() for k, w in ws.items()}
           for op, ws in params.items()}
    n0 = kernels.fused_update.launches
    opt.update(params, grads, opt.init_state(params))
    assert kernels.fused_update.launches - n0 == 2
    opt.update_plain(ref, grads, opt.init_state(ref))
    for op, ws in ref.items():
        for k, w in ws.items():
            assert torch.equal(_bits(params[op][k]), _bits(w)), f"{op}.{k}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_at_bert_base_heads(cuda, dtype):
    """Kernels 1 (with its lse) and 2 at BERT-base's attention: 12 heads
    of 64, seq 512, non-causal (batch 2), against their plain versions:
    f32 within 2e-5 (the backward within 1e-4 of the gradients' largest
    value), bf16 within 2e-2 of the largest magnitude."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (torch.randn(2, 512, 12, 64, device=cuda,
                               generator=g).to(dtype) for _ in range(4))
    scale = 64 ** -0.5
    n0 = kernels.flash_attention_fwd.launches
    o, lse = kernels.flash_attention_fwd(q, k, v, False, scale,
                                         need_lse=True)
    ro, rlse = kernels.flash_attention_plain(q, k, v, False, scale,
                                             need_lse=True)
    assert kernels.flash_attention_fwd.launches == n0 + 1
    _close(o, ro, dtype)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-3)
    got = kernels.flash_attention_bwd(q, k, v, o, lse, do, False, scale)
    ref = kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, False,
                                            scale)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, ref):
        torch.testing.assert_close(
            a.float(), b.float(), rtol=0,
            atol=rel * b.float().abs().max().item())


# ---- MoE, the recurrent ops, the pipelined stack and fusion on the card --


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_at_gpt2_small_heads_causal(cuda, dtype):
    """Kernels 1 (with its lse) and 2 at the MoE and pipelined LMs'
    attention: 12 heads of 64, seq 1024, causal (batch 8), against their
    plain versions: f32 within 2e-5 (the backward within 1e-4 of the
    gradients' largest value), bf16 within 2e-2 of the largest
    magnitude."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(8, 1024, 12, 64, device=cuda,
                               generator=g).to(dtype) for _ in range(4))
    scale = 64 ** -0.5
    n0 = kernels.flash_attention_fwd.launches
    o, lse = kernels.flash_attention_fwd(q, k, v, True, scale,
                                         need_lse=True)
    ro, rlse = kernels.flash_attention_plain(q, k, v, True, scale,
                                             need_lse=True)
    assert kernels.flash_attention_fwd.launches == n0 + 1
    _close(o, ro, dtype)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-3)
    got = kernels.flash_attention_bwd(q, k, v, o, lse, do, True, scale)
    ref = kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, True,
                                            scale)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, ref):
        torch.testing.assert_close(
            a.float(), b.float(), rtol=0,
            atol=rel * b.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["flash", "einsum"])
def test_pipeline_stack_on_card_matches_the_cpu(no_tf32, route):
    """The pipelined stack (2 stacked layers, hidden 64, 2 heads of 32,
    causal) in f32 on the card — the f32 flash kernels, or its einsum
    route under use_flash_attention=False — against the CPU from the same
    weights: output within 1e-5, each gradient within 1e-5 of its largest
    value, but the key bias's, which is zero in exact arithmetic (a
    constant a query row, which the softmax drops): there both devices'
    rounding noise stays under 1e-6 of the largest gradient."""
    import numpy as np

    rs = np.random.RandomState(0)
    x = rs.randn(2, 64, 64).astype(np.float32)
    cot = rs.randn(2, 64, 64).astype(np.float32)
    res, src = [], None
    for dev in ("cpu", no_tf32):
        ff = FFModel(FFConfig(batch_size=2, seed=3,
                              use_flash_attention=route == "flash"),
                     device=dev)
        xt = ff.create_tensor([2, 64, 64], name="x")
        ff.transformer_pipeline_stack(xt, 2, 2, causal=True, name="op")
        ff.compile(final_tensor=ff.ops[-1].outputs[0])
        if src is None:
            src = ff.params
        else:
            ff.params = {op: {k: w.to(dev) for k, w in ws.items()}
                         for op, ws in src.items()}
        p = {k: w.clone().requires_grad_() for k, w in ff.params["op"].items()}
        xv = torch.tensor(x, device=dev, requires_grad=True)
        n0 = kernels.flash_attention_bwd.launches
        y = ff.get_op_by_name("op").forward(p, [xv], training=True)[0]
        grads = torch.autograd.grad(
            (y * torch.tensor(cot, device=dev)).sum(), [xv, *p.values()])
        launched = kernels.flash_attention_bwd.launches - n0
        res.append((y.detach().cpu(), dict(zip(["x", *p], [
            g.cpu() for g in grads]))))
    assert launched == (2 if route == "flash" else 0)
    (yc, gc_), (yg, gg) = res
    torch.testing.assert_close(yg, yc, rtol=1e-5, atol=1e-5)
    top = max(g.abs().max().item() for g in gc_.values())
    for got in (gg.pop("bk"), gc_.pop("bk")):
        assert got.abs().max().item() <= 1e-6 * top
    for k, b in gc_.items():
        torch.testing.assert_close(gg[k], b, rtol=0,
                                   atol=1e-5 * b.abs().max().item(),
                                   msg=lambda m: f"{k}: {m}")


def _moe_lm(device, seed=2, **cfg):
    """gpt_lm(moe_every=2) small in f32 (hidden 64, 2 heads of 32, 4
    experts at the default capacity), SGD, 6 batches of 4 staged."""
    import numpy as np
    from flexflow_tpu_torch import (LossType, MetricsType, SGDOptimizer,
                                    SingleDataLoader)
    from flexflow_tpu_torch.models import gpt_lm

    ff = FFModel(FFConfig(batch_size=4, seed=seed, **cfg), device=device)
    tok, out = gpt_lm(ff, 4, seq_len=64, hidden=64, layers=2, heads=2,
                      vocab_size=97, moe_every=2, num_experts=4)
    ff.compile(SGDOptimizer(lr=0.05),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY], final_tensor=out)
    rs = np.random.RandomState(seed)
    SingleDataLoader(ff, tok, rs.randint(0, 97, (24, 64)).astype(np.int32))
    SingleDataLoader(ff, ff.label_tensor,
                     rs.randint(0, 97, (24, 64, 1)).astype(np.int32))
    return ff


@pytest.mark.cuda
def test_moe_lm_aux_under_step_replay_matches_per_step(no_tf32):
    """The MoE LM through scan_steps (one step captured as a CUDA graph,
    the routing and the aux loss inside it) against per-step training on
    the card and on the CPU from the same weights: losses within 1e-5
    relative, weights within 1e-5; the flash kernels launched on every
    replayed step."""
    per = _moe_lm(no_tf32)
    scan = _moe_lm(no_tf32, scan_steps=3)
    cpu = _moe_lm("cpu")
    for ff in (scan, cpu):
        _copy_weights(ff, per)
    n0 = kernels.flash_attention_bwd.launches
    losses = torch.cat([scan.train_scanned(3)[0] for _ in range(2)]).cpu()
    assert scan._replay.replays == 5
    assert kernels.flash_attention_bwd.launches - n0 == 6 * 2
    for ref in (per, cpu):
        want = torch.stack([ref._run_train_step(ref._stage_batch())[0]
                            for _ in range(6)]).cpu()
        torch.testing.assert_close(losses, want, rtol=1e-5, atol=0)
        assert _max_diff(scan, ref) <= 1e-5


@pytest.mark.cuda
def test_fused_group_dropout_replays_like_unfused(cuda):
    """A dropout fused onto its producer (perform_fusion) keeps its own
    generator, which the CUDA graph of a scanned step registers through
    the group: every replay draws a new mask, and the fused model's losses
    over 6 scanned steps are bitwise the unfused model's."""
    import numpy as np
    from flexflow_tpu_torch import (LossType, MetricsType, SGDOptimizer,
                                    SingleDataLoader)

    runs = []
    for fusion in (False, True):
        ff = FFModel(FFConfig(batch_size=8, seed=4, scan_steps=6,
                              perform_fusion=fusion), device=cuda)
        x = ff.create_tensor([8, 256], name="input")
        h = ff.dense(x, 256, name="fc1")
        h = ff.relu(h, name="act")
        h = ff.dropout(h, 0.5, name="drop")
        out = ff.dense(h, 4, name="fc2")
        ff.compile(SGDOptimizer(lr=0.01),
                   LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   [MetricsType.METRICS_ACCURACY], final_tensor=out)
        rs = np.random.RandomState(0)
        SingleDataLoader(ff, x, np.tile(rs.randn(8, 256).astype(
            np.float32), (6, 1)))
        SingleDataLoader(ff, ff.label_tensor, np.tile(
            rs.randint(0, 4, (8, 1)).astype(np.int32), (6, 1)))
        runs.append((ff, ff.train_scanned(6)[0].cpu()))
    (plain, lp), (fused, lf) = runs
    assert len(plain.ops) - len(fused.ops) == 2
    assert fused._replay.replays == 5
    assert len(set(lf.tolist())) == 6
    assert torch.equal(lf, lp)


# ---- the serving engine's decode features on the card ----------------------


def _small_llama(device, seed=1, **arch):
    """A small f32 Llama (head dim 128, GQA 2) for the engine's card
    checks."""
    from flexflow_tpu_torch.models import llama_lm

    arch = dict(dict(hidden=256, layers=2, heads=2, kv_heads=1,
                     ffn_hidden=512, vocab_size=500, rope_theta=500000.0),
                **arch)
    ff = FFModel(FFConfig(batch_size=4, seed=seed), device=device)
    _, logits = llama_lm(ff, 4, seq_len=256, **arch)
    ff.compile(final_tensor=logits)
    return ff


def _llama_pair(cuda, seed=1, **arch):
    """The small Llama on the CPU and on the card with the same weights."""
    cpu = _small_llama("cpu", seed, **arch)
    gpu = _small_llama(cuda, seed, **arch)
    gpu.params = {op: {w: t.to(cuda) for w, t in ws.items()}
                  for op, ws in cpu.params.items()}
    return cpu, gpu


def _serve_prompts(n_vocab=500, lens=(5, 30, 77, 130)):
    import numpy as np

    rs = np.random.RandomState(3)
    return [rs.randint(1, n_vocab, size=n).astype(np.int32) for n in lens]


ENGINE_KW = dict(serve_slots=4, kv_page_size=16, max_seq_len=320)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"], ids=["native", "int8"])
def test_captured_decode_matches_uncaptured_body(no_tf32, kv):
    """The decode chunk as a CUDA graph (captured at its first use,
    replayed after) against the same body run eagerly on the card (an
    engine built with ``capture=False``): tokens and pool bitwise; the graph's
    launches are counted on every replay, the split-KV tickets are zero
    after every replay, and the key is captured once."""
    _, gpu = _llama_pair(no_tf32)
    prompts = _serve_prompts()
    kw = dict(ENGINE_KW, kv_cache_dtype=kv or "native", decode_chunk=4,
              prefix_cache=False)
    graph = gpu.make_serving_engine(**kw)
    n0 = kernels.paged_attention_fwd.launches
    a = [r.tokens for r in graph.run(prompts, max_new_tokens=12)]
    st = graph.stats()
    assert st["recompiles"] == 1 and st["graph_replays"] > 0
    assert kernels.paged_attention_fwd.launches - n0 \
        == 2 * st["decode_steps"]
    assert kernels.tickets_clear()
    eager = gpu.make_serving_engine(**kw, capture=False)
    b = [r.tokens for r in eager.run(prompts, max_new_tokens=12)]
    assert a == b
    for name in graph.pool:
        for t in graph.pool[name]:
            assert torch.equal(graph.pool[name][t].view(torch.uint8),
                               eager.pool[name][t].view(torch.uint8))
    # a second round replays only; on the native pool it serves the
    # first round's tokens (an int8 page reused for decode appends starts
    # from its previous owner's running-max scale, as JAX's append does,
    # so there a second round may round otherwise)
    c = [r.tokens for r in graph.run(prompts, max_new_tokens=12)]
    assert graph.stats()["recompiles"] == 1 and kernels.tickets_clear()
    if kv is None:
        assert c == a


@pytest.mark.cuda
@pytest.mark.parametrize("decode_splits", [False, True],
                         ids=["slab_splits", "decode_splits"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_paged_kernel_at_verify_shape_with_repeated_positions(cuda, dtype,
                                                              decode_splits):
    """Kernel 4 at a verify slab (4 slots, K + 1 = 5 positions, 32 heads
    over 8 kv heads, head dim 128): slots clamped at their budget repeat
    their last write position; an idle slot reads scratch page 0. Against
    the plain version, with the slab's splits and with a decode step's;
    with a decode step's, slab position 0 is bitwise a one-position launch
    at its frontier."""
    g = torch.Generator(device=cuda).manual_seed(5)
    ps, pps, s = 128, 8, 5
    n_pool = 4 * pps + 1
    q = torch.randn(4, s, 32, 128, device=cuda, generator=g).to(dtype)
    kp, vp = (torch.randn(n_pool, ps, 8, 128, device=cuda, generator=g)
              .to(dtype) for _ in range(2))
    table = (torch.randperm(n_pool - 1, device=cuda, generator=g)[:4 * pps]
             + 1).reshape(4, pps).to(torch.int32)
    table[3] = 0
    wp0 = torch.tensor([600, 700, 530, 0], device=cuda)
    budget = torch.tensor([1024, 703, 532, 1], device=cuda)
    wp = torch.minimum(wp0[:, None] + torch.arange(s, device=cuda),
                       budget[:, None] - 1).to(torch.int32)
    assert (wp[1, -2:] == 702).all() and (wp[2, 2:] == 531).all()
    row_len = torch.tensor([500, 620, 400, 0], dtype=torch.int32,
                           device=cuda)
    pad = torch.tensor([512, 640, 512, 0], dtype=torch.int32, device=cuda)
    args = (q, kp, vp, table, wp, row_len, pad, 128 ** -0.5)
    kw = dict(decode_splits=decode_splits)
    n0 = kernels.paged_attention_fwd.launches
    out = kernels.paged_attention_fwd(*args, **kw)
    assert kernels.paged_attention_fwd.launches == n0 + 1
    _close(out, kernels.paged_attention_plain(*args), dtype)
    # positions sharing a write frontier see the same keys: equal rows
    # wherever the slab's queries are equal
    q2 = q.clone()
    q2[1, 4] = q2[1, 3]
    out2 = kernels.paged_attention_fwd(q2, *args[1:], **kw)
    assert torch.equal(out2[1, 4], out2[1, 3])
    if decode_splits:
        one = kernels.paged_attention_fwd(q[:, :1].contiguous(), kp, vp,
                                          table, wp[:, :1].contiguous(),
                                          row_len, pad, 128 ** -0.5)
        assert torch.equal(out[:, 0], one[:, 0])


@pytest.mark.cuda
def test_sampler_on_card_matches_cpu(cuda):
    """The sampler's draws are integer arithmetic on (seed, tag, index):
    on identical f32 logits the card and the CPU give the same tokens,
    the same accept uniforms and the same residual draws. The sampling
    probabilities agree within 1e-6 (plus the mass that moved), but at
    the top-p boundary: the card and the CPU sum 128256 sorted f32
    probabilities in other orders, so a token whose preceding mass lies
    within 1e-4 of top_p may be kept on one and not the other (with top_p
    1 that is the far tail, where the f32 sum reaches 1 before the last
    token, in JAX's sampler too); the mass that moves stays under 1e-3."""
    import numpy as np
    from flexflow_tpu_torch.ops import sampling

    rs = np.random.RandomState(0)
    b, v = 12, 128256
    logits = (rs.randn(b, v) * 3).astype(np.float32)
    temps = np.asarray([0, 0.7, 1.0] * 4, np.float32)
    top_ps = np.asarray([1.0, 0.9, 0.9, 1.0] * 3, np.float32)
    top_ks = np.asarray([0, 50, 0] * 4, np.int32)
    seeds = np.arange(b, dtype=np.int32) * 7
    ctrs = np.arange(b, dtype=np.int32)
    host = [torch.from_numpy(a) for a in (logits, temps, top_ps, top_ks,
                                          seeds, ctrs)]
    dev = [t.to(cuda) for t in host]
    for tag in (sampling.TAG_TARGET, sampling.TAG_DRAFT):
        assert torch.equal(sampling.sample_tokens(*dev, tag=tag).cpu(),
                           sampling.sample_tokens(*host, tag=tag))
    p_dev = sampling.sampling_probs(*dev[:4]).cpu()
    p_host = sampling.sampling_probs(*host[:4])
    moved = (p_dev > 0) != (p_host > 0)
    # the warped distribution's mass before each position, in f64
    warped = host[0] / torch.where(host[1] > 0, host[1], 1.0)[:, None]
    probs = torch.softmax(warped.double(), -1)
    order = torch.sort(-probs, dim=-1, stable=True).indices
    before = torch.empty_like(probs).scatter_(
        -1, order, torch.cumsum(torch.gather(probs, -1, order), -1)
        - torch.gather(probs, -1, order))
    gap = (before - torch.from_numpy(top_ps).double()[:, None]).abs()
    assert (gap[moved] < 1e-4).all()
    mass = torch.where(moved, torch.maximum(p_dev, p_host), 0.0).sum(-1)
    assert (mass < 1e-3).all(), mass
    diff = (p_dev - p_host).abs().masked_fill(moved, 0.0).amax(-1)
    assert (diff <= 1e-6 + mass).all(), diff
    assert torch.equal(sampling.accept_uniforms(dev[4], dev[5], 4).cpu(),
                       sampling.accept_uniforms(host[4], host[5], 4))
    p = torch.softmax(host[0], -1)
    q = torch.softmax(host[0].flip(-1), -1)
    assert torch.equal(
        sampling.residual_sample(p.to(cuda), q.to(cuda), dev[4],
                                 dev[5]).cpu(),
        sampling.residual_sample(p, q, host[4], host[5]))


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [
    dict(speculate_k=3),
    dict(speculate_k=3, self_draft=True),
    dict(prefill_chunk=32),
    dict(prefill_chunk=32, prefill_interleave_chunks=1),
    dict(paged_attention_impl="einsum"),
], ids=["spec", "self_spec", "chunk", "interleave", "einsum"])
def test_engine_features_card_vs_cpu(no_tf32, knobs):
    """Speculation (K = 3, its proposals and the verify pass captured)
    with a smaller draft, which rejects nearly every proposal, and with
    the target as its own draft, which accepts them and takes the bonus
    token; chunked and chunk-interleaved prefill — on a small f32 Llama:
    greedy tokens on the card equal the CPU's, and so do the counters.
    The einsum route is the CPU's: the card refuses it."""
    cpu, gpu = _llama_pair(no_tf32)
    knobs = dict(knobs)
    self_draft = knobs.pop("self_draft", False)
    kw = dict(ENGINE_KW, **knobs)
    if knobs.get("paged_attention_impl") == "einsum":
        with pytest.raises(ValueError, match="paged_attention_fwd"):
            gpu.make_serving_engine(**kw)
        return
    if self_draft:
        kw_cpu, kw_gpu = dict(kw, draft_model=cpu), dict(kw, draft_model=gpu)
    elif "speculate_k" in knobs:
        dcpu, dgpu = _llama_pair(no_tf32, seed=2, hidden=128, layers=1,
                                 heads=1)
        kw_cpu = dict(kw, draft_model=dcpu)
        kw_gpu = dict(kw, draft_model=dgpu)
    else:
        kw_cpu = kw_gpu = kw
    prompts = _serve_prompts()
    ref = cpu.make_serving_engine(**kw_cpu)
    eng = gpu.make_serving_engine(**kw_gpu)
    n0 = kernels.paged_attention_fwd.launches
    want = [r.tokens for r in ref.run(prompts, max_new_tokens=10)]
    got = [r.tokens for r in eng.run(prompts, max_new_tokens=10)]
    assert got == want
    st, cst = eng.stats(), ref.stats()
    for key in ("spec_proposed", "spec_accepted", "decode_steps",
                "prefill_chunks_interleaved"):
        assert st[key] == cst[key], key
    if self_draft:
        assert st["spec_accepted"] > 0
    assert kernels.paged_attention_fwd.launches - n0 > 0
    assert kernels.tickets_clear()


# ---- the rest of the serving engine on the card: LoRA, the host tier,
# the slab handoff, weight swaps under captured programs --------------------


def _adapter(geometry, seed, rank=8, scale=0.05):
    import numpy as np

    rs = np.random.RandomState(seed)
    return {n: {"a": (rs.randn(i, rank) * scale).astype(np.float32),
                "b": (rs.randn(rank, o) * scale).astype(np.float32)}
            for n, (i, o) in geometry.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True], ids=["decode", "self_spec"])
def test_lora_tenants_card_vs_cpu(no_tf32, spec):
    """Three adapters and the base model mixed across four slots through a
    2-page adapter pool (faults and LRU evictions) — the adapter gathered
    inside the captured decode (and verify) programs: the card's greedy
    tokens and adapter counters equal the CPU's; adapters move tokens."""
    cpu, gpu = _llama_pair(no_tf32)
    kw = dict(ENGINE_KW, adapter_pool_pages=2, lora_rank=8)
    if spec:
        kw_cpu, kw_gpu = (dict(kw, speculate_k=3, draft_model=cpu),
                          dict(kw, speculate_k=3, draft_model=gpu))
    else:
        kw_cpu = kw_gpu = kw
    prompts = _serve_prompts() * 2
    tenants = ["a", None, "b", "c", "c", "a", None, "b"]
    out = []
    for ff, kwx in ((cpu, kw_cpu), (gpu, kw_gpu)):
        eng = ff.make_serving_engine(**kwx)
        for i, name in enumerate("abc"):
            eng.register_adapter(name, _adapter(eng.lora.geometry, i),
                                 alpha=16.0)
        reqs = [eng.submit(p, 10, adapter=t)
                for p, t in zip(prompts, tenants)]
        while eng.step():
            pass
        st = eng.stats()
        out.append(([r.tokens for r in reqs],
                    {k: st[k] for k in ("adapter_faults", "adapter_hits",
                                        "adapter_evictions",
                                        "adapter_refs_live")}))
    assert out[1] == out[0]
    assert out[1][1]["adapter_evictions"] > 0
    base = gpu.make_serving_engine(**ENGINE_KW).run(prompts[:4], 10)
    assert [r.tokens for r in base] != out[1][0][:4]
    assert kernels.tickets_clear()


def _tier_traffic(n_vocab=500):
    import numpy as np

    rs = np.random.RandomState(8)
    fams = [rs.randint(1, n_vocab, size=48) for _ in range(6)]
    first = [np.concatenate([fams[i // 2], rs.randint(1, n_vocab,
                                                      size=5 + 7 * i)])
             .astype(np.int32) for i in range(12)]
    return first, first[:6]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["native", "int8"])
def test_host_tier_on_card(no_tf32, kv):
    """Pool pressure with a host tier on the card: pages demote into pinned
    host memory and promote back; the tokens and prefix hits equal the
    CPU's tier engine and an ample card pool's; a page exported before its
    demotion and after its promotion is the same bytes; no copy failed;
    drained and flushed, every page is free and the host tier empty."""
    cpu, gpu = _llama_pair(no_tf32)
    first, again = _tier_traffic()
    tight = dict(ENGINE_KW, kv_cache_dtype=kv, kv_pages=45,
                 host_kv_pages=48)
    runs = []
    for ff, knobs in ((cpu, tight), (gpu, tight),
                      (gpu, dict(tight, kv_pages=140, host_kv_pages=0))):
        eng = ff.make_serving_engine(**knobs)
        reqs = eng.run(first[:2], 8)
        before = eng.export_prefix_slab(first[0][:48])
        reqs += eng.run(first[2:], 8)
        reqs += eng.run(again, 8)
        after = eng.export_prefix_slab(first[0][:48])
        eng.prefix_cache.wait_migrations()
        st = eng.stats()
        runs.append(([r.tokens for r in reqs],
                     [r.prefix_tokens for r in reqs], st))
        for pb, pa in zip(before["payload"], after["payload"]):
            for key in pb:
                for name in pb[key]:
                    assert (pb[key][name].tobytes()
                            == pa[key][name].tobytes())
        if knobs["host_kv_pages"]:
            assert st["tier_demotions"] > 0 and st["tier_promotions"] > 0
            assert st["tier_demote_failures"] == 0
            assert st["tier_promote_failures"] == 0
            eng.drain()
            eng.flush_prefix_cache()
            st = eng.stats()
            assert st["free_pages"] == st["kv_pages"] - 1
            assert st["kv_pages_host"] == 0
    assert runs[1][:2] == runs[0][:2] and runs[2][:2] == runs[1][:2]
    for key in ("tier_demotions", "tier_promotions", "prefix_hits"):
        assert runs[1][2][key] == runs[0][2][key], key


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["native", "int8"])
def test_prefix_slab_on_card(no_tf32, kv):
    """A slab exported on the card imports into another card engine and
    into a CPU engine: each re-exports it bitwise and serves the prompt as
    a hit with the exporter's tokens."""
    cpu, gpu = _llama_pair(no_tf32)
    prompt = _tier_traffic()[0][3]
    kw = dict(ENGINE_KW, kv_cache_dtype=kv)
    a = gpu.make_serving_engine(**kw)
    n = a.prefill_into_cache(prompt)
    slab = a.export_prefix_slab(prompt)
    want = a.run([prompt], 8)[0]
    assert want.prefix_tokens == n * 16
    for ff in (gpu, cpu):
        b = ff.make_serving_engine(**kw)
        assert b.import_prefix_slab(slab) == n
        again = b.export_prefix_slab(prompt)
        for pa, pb in zip(slab["payload"], again["payload"]):
            for key in pa:
                for name in pa[key]:
                    assert (pa[key][name].tobytes()
                            == pb[key][name].tobytes())
        got = b.run([prompt], 8)[0]
        assert got.prefix_tokens == want.prefix_tokens
        assert got.tokens == want.tokens


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["native", "int8"])
def test_swap_weights_under_captured_decode(no_tf32, weights):
    """An engine whose decode chunk is a captured CUDA graph swaps to a
    second weight set: it serves a fresh engine's tokens on those weights
    with no capture added (the graph reads the new values in place — for
    the int8 tier, re-quantized into the same buffers); the swap back
    restores its first tokens."""
    _, gpu = _llama_pair(no_tf32)
    _, gpu2 = _llama_pair(no_tf32, seed=7)
    kw = dict(ENGINE_KW, weight_dtype=weights, prefix_cache=False)
    prompts = _serve_prompts()
    eng = gpu.make_serving_engine(**kw)
    first = [r.tokens for r in eng.run(prompts, 10)]
    caps = eng.stats()["recompiles"]
    assert caps == 1 and eng.stats()["graph_replays"] > 0
    new = {op: {w: t.clone() for w, t in ws.items()}
           for op, ws in gpu2.params.items()}
    eng.swap_weights(new, "v1")
    swapped = [r.tokens for r in eng.run(prompts, 10)]
    fresh = [r.tokens for r in
             gpu2.make_serving_engine(**kw).run(prompts, 10)]
    assert swapped == fresh and swapped != first
    assert eng.stats()["recompiles"] == caps
    eng.swap_weights(None, "v0")
    assert [r.tokens for r in eng.run(prompts, 10)] == first
    assert eng.stats()["recompiles"] == caps


@pytest.mark.cuda
def test_capture_survives_a_dead_graph_in_a_cycle(cuda):
    """A graph left in a reference cycle dies only when the collector runs;
    a collection during another capture would destroy it there and
    invalidate that capture. ``kernels.capture`` keeps the collector off
    while it captures: a body that leaves such a cycle behind and then
    allocates enough to trigger a collection (threshold 1) still captures
    and replays right."""
    import gc

    from flexflow_tpu_torch.ops import kernels

    side = torch.cuda.Stream()
    x = torch.arange(4.0, device=cuda)
    dead = [torch.cuda.CUDAGraph()]
    kernels.capture(dead[0], side, lambda: x + 1)

    def body():
        cycle = {"graph": dead.pop()}
        cycle["self"] = cycle
        del cycle
        junk = [[i] for i in range(64)]
        return x * 2 + len(junk) * 0

    old = gc.get_threshold()
    gc.set_threshold(1)
    try:
        graph = torch.cuda.CUDAGraph()
        outs, _ = kernels.capture(graph, side, body)
    finally:
        gc.set_threshold(*old)
    x.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(outs, x * 2)


@pytest.mark.cuda
def test_native_swap_refused_with_a_second_engine_on_card(no_tf32):
    """Two engines with captured decodes on one model: the first one's
    native swap (it would write model.params under the second's graphs) is
    refused and the second keeps its tokens; with the second released, the
    swap serves an engine on the second weight set's tokens."""
    _, gpu = _llama_pair(no_tf32)
    _, gpu2 = _llama_pair(no_tf32, seed=7)
    kw = dict(ENGINE_KW, prefix_cache=False)
    prompts = _serve_prompts()
    eng = gpu.make_serving_engine(**kw)
    sec = gpu.make_serving_engine(**kw)
    first = [r.tokens for r in eng.run(prompts, 10)]
    assert [r.tokens for r in sec.run(prompts, 10)] == first
    with pytest.raises(RuntimeError, match="other engine"):
        eng.swap_weights(gpu2.params, "v1")
    assert [r.tokens for r in sec.run(prompts, 10)] == first
    del sec
    eng.swap_weights(gpu2.params, "v1")
    want = [r.tokens for r in
            gpu2.make_serving_engine(**kw).run(prompts, 10)]
    assert [r.tokens for r in eng.run(prompts, 10)] == want != first
    eng.swap_weights(None, "v0")
    assert [r.tokens for r in eng.run(prompts, 10)] == first


# ---- FFModel.generate: the decode step as a CUDA graph ---------------------


def _gen_prompts(n_vocab=500, b=3, s=40):
    import numpy as np

    rs = np.random.RandomState(11)
    return rs.randint(1, n_vocab, size=(b, s)).astype(np.int32), \
        np.asarray([40, 23, 9], np.int32)[:b]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["greedy", "ragged_scores", "sampled",
                                  "beam", "beam_ragged", "int8"])
def test_generate_graph_matches_eager_decode(no_tf32, mode):
    """generate()'s decode step captured as a CUDA graph and replayed
    against the same step run eagerly on the card (``capture=False``):
    tokens bitwise, scores bitwise; greedy and ragged beam tokens also the
    CPU's (f32, TF32 off). One capture a program, replayed max_new - 1
    times."""
    import numpy as np

    from flexflow_tpu_torch.runtime.generation import Generator

    cpu, gpu = _llama_pair(no_tf32)
    toks, lengths = _gen_prompts()
    kw = dict(temperature=0.9, top_k=40) if mode == "sampled" else {}
    if mode == "int8":
        kw["quantize"] = "int8"
    call = dict(prompt_lengths=lengths) if "ragged" in mode else {}
    outs = []
    for capture in (True, False):
        g = Generator(gpu, eos_id=7, capture=capture, **kw)
        if mode.startswith("beam"):
            outs.append(g.beam_search(toks, 12, 3, 1.0, return_scores=True,
                                      **call))
        else:
            outs.append(g(toks, 12, seed=5, return_scores=True, **call))
        (loop,) = g._programs.values()
        assert (loop.step.graph is not None) == capture
        if capture:
            assert loop.step.replays == 10
        assert g.last_decode_steps == 11 and g.last_decode_ms > 0.0
    (a, sa), (b, sb) = outs
    assert np.array_equal(a, b) and np.array_equal(sa, sb)
    if mode in ("greedy", "beam_ragged"):
        g = Generator(cpu, eos_id=7)
        want = (g.beam_search(toks, 12, 3, 1.0, prompt_lengths=lengths)
                if mode.startswith("beam") else g(toks, 12))
        assert np.array_equal(a, want)


@pytest.mark.cuda
def test_generate_keys_capture_their_own_programs(cuda):
    """Two max_new_tokens values capture a program each; a second call of
    either replays its graph without capturing again and gives the same
    tokens."""
    import numpy as np

    ff = _small_llama(cuda)
    toks, _ = _gen_prompts()
    a8 = ff.generate(toks, 8)
    a12 = ff.generate(toks, 12)
    (gen,) = ff._decoders.values()
    progs = list(gen._programs.values())
    assert len(progs) == 2 and all(p.step.graph is not None for p in progs)
    graphs = [p.step.graph for p in progs]
    assert np.array_equal(ff.generate(toks, 8), a8)
    assert np.array_equal(ff.generate(toks, 12), a12)
    assert [p.step.graph for p in gen._programs.values()] == graphs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_launches_flash_once_a_layer_a_prefill(cuda, dtype):
    """Kernel 1 runs each whole-prompt prefill, once a layer for the whole
    batch; the decode steps launch no kernel (the grouped einsum, as in
    JAX), replayed or not."""
    ff = FFModel(FFConfig(batch_size=3, compute_dtype=dtype), device=cuda)
    from flexflow_tpu_torch.models import llama_lm

    _, logits = llama_lm(ff, 3, seq_len=64, hidden=256, layers=3, heads=2,
                         kv_heads=1, vocab_size=500)
    ff.compile(final_tensor=logits)
    toks, lengths = _gen_prompts()
    for _ in range(2):
        kernels.reset_launch_counts()
        ff.generate(toks, 10, prompt_lengths=lengths)
        torch.cuda.synchronize()
        want = dict.fromkeys(kernels.launch_counts(), 0)
        want["flash_attention_fwd"] = 3
        assert kernels.launch_counts() == want


@pytest.mark.cuda
def test_generate_lru_eviction_frees_program_memory(cuda, monkeypatch):
    """FF_GEN_PROGRAM_CACHE=1: a second key evicts the first program, and
    its graph and static caches go back to the allocator (every program
    captures on one side stream a device: cuBLAS keeps a workspace a
    stream)."""
    import gc

    monkeypatch.setenv("FF_GEN_PROGRAM_CACHE", "1")
    ff = _small_llama(cuda)
    toks, _ = _gen_prompts(b=3, s=40)
    ff.generate(toks, 4)
    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated(cuda)
    ff.generate(toks, 200)     # a program with caches of 240 positions
    torch.cuda.synchronize()
    big = torch.cuda.memory_allocated(cuda)
    ff.generate(toks, 4)       # evicts it
    (gen,) = ff._decoders.values()
    assert len(gen._programs) == 1
    torch.cuda.synchronize()
    gc.collect()
    after = torch.cuda.memory_allocated(cuda)
    per_pos = 2 * 2 * 3 * 128 * 4     # layers, k/v, rows, Hd, f32
    assert big - after >= (240 - 44) * per_pos
    assert abs(after - base) <= (big - after) // 4


@pytest.mark.cuda
def test_generate_seq2seq_graph_matches_cpu(no_tf32):
    """generate_seq2seq on the card (the encoder through kernel 1, the
    decode step a CUDA graph) gives the CPU's greedy tokens in f32; the
    encoder's and the decoder prefill's self-attentions launch kernel 1."""
    import numpy as np

    from flexflow_tpu_torch.models import seq2seq_lm

    models = []
    for dev in ("cpu", no_tf32):
        ff = FFModel(FFConfig(batch_size=4), device=dev)
        seq2seq_lm(ff, 4, src_len=48, tgt_len=8, hidden=256, layers=2,
                   heads=4, vocab_size=301)
        ff.compile()
        models.append(ff)
    cpu, gpu = models
    gpu.params = {op: {w: t.to(no_tf32) for w, t in ws.items()}
                  for op, ws in cpu.params.items()}
    src = np.random.RandomState(2).randint(1, 301, (4, 48)).astype(np.int32)
    kernels.reset_launch_counts()
    got = gpu.generate_seq2seq(src, max_new_tokens=16)
    torch.cuda.synchronize()
    assert kernels.flash_attention_fwd.launches == 4
    assert np.array_equal(got, cpu.generate_seq2seq(src, max_new_tokens=16))
    (gen,) = gpu._decoders.values()
    (loop,) = gen._programs.values()
    assert loop.step.graph is not None and loop.step.replays == 14
