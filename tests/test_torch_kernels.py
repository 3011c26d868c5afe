"""The port's three kernels (flexflow_tpu_torch/ops/kernels.py).

On the CPU (every test not marked ``cuda``): each kernel's plain PyTorch
version — what a wrapper runs for CPU tensors — is held against the JAX
package's Pallas kernel, run in interpret mode as tests/test_pallas_paged.py
runs it. Inputs are made once with numpy and handed to both. Tolerances:
attention 2e-5 (f32; the online and the one-shot softmax sum in different
orders), the prefill write bitwise. The CUDA kernels themselves are held
against these plain versions on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas_kernels import (flash_attention_fwd_pallas,
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


def test_launch_counters_are_plain_integers():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {
        "flash_attention_fwd": 0, "paged_attention_fwd": 0,
        "paged_prefill_write": 0}
