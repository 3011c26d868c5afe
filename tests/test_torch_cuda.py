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
counted. The plain versions are held against the JAX package's Pallas
kernels by tests/test_torch_kernels.py.
"""

import pytest
import torch

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
