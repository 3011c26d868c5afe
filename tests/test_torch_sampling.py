"""The port's sampler (``flexflow_tpu_torch/ops/sampling.py``) against the
JAX package's (``flexflow_tpu/ops/sampling.py``).

The warp is deterministic and held to JAX's on the same seeded f32 logits
(numpy): the keep-sets of top-k and top-p (ties broken by vocab index)
are identical and the sampling probabilities within 1e-6; temperature-0
rows are bitwise ``argmax(f32(logits))``. The draws are the port's own
(splitmix64 of (seed, stream tag, draw index), not JAX's threefry bits),
so they are checked by distribution: token histograms over many draw
indices against the exact ``sampling_probs`` by total-variation distance
under TV_LIMIT, a limit another temperature's distribution exceeds; and
they are a pure function of (seed, tag, index). The accept uniforms are
uniform, and the residual re-draw follows its distribution, the
empty-residual fallback included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops import sampling as jsampling
from flexflow_tpu_torch.ops import sampling

V = 64
#: draws a histogram takes, and the TV distance it must stay under: the
#: expected TV of N draws over V outcomes is about sqrt(V / (2 pi N)) ~ 0.03
N_DRAWS = 8000
TV_LIMIT = 0.06
PROB_ATOL = 1e-6

# rows: (temperature, top_p, top_k) — greedy, plain, nucleus, top-k, both
CONFIGS = [(0.0, 1.0, 0), (1.0, 1.0, 0), (0.7, 0.9, 0), (1.3, 1.0, 5),
           (0.9, 0.8, 12), (2.0, 0.5, 40), (0.5, 1.0, 1)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines here run many small torch ops: one intra-op thread runs
    them faster than the default pool, whose threads spin against the
    suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(ties: bool, seed: int = 0):
    rs = np.random.RandomState(seed)
    logits = rs.randn(len(CONFIGS), V).astype(np.float32) * 2.0
    if ties:
        # a few distinct values a row: top-k and top-p cut through ties
        logits = np.round(logits * 2.0) / 2.0
    temps, top_ps, top_ks = (np.asarray(c, dt) for c, dt in zip(
        zip(*CONFIGS), (np.float32, np.float32, np.int32)))
    return logits, temps, top_ps, top_ks


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_keep_set_and_probs_match_jax(ties):
    """The masked warped logits' keep-sets equal JAX's; the sampling
    probabilities agree within 1e-6."""
    args = _rows(ties)
    got = sampling._masked_warped(*_t(*args)).numpy()
    want = np.asarray(jsampling._masked_warped(*_j(*args)))
    live = args[1] > 0
    np.testing.assert_array_equal(np.isfinite(got)[live],
                                  np.isfinite(want)[live])
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want[np.isfinite(want)])
    p = sampling.sampling_probs(*_t(*args)).numpy()
    pj = np.asarray(jsampling.sampling_probs(*_j(*args)))
    np.testing.assert_allclose(p, pj, rtol=0, atol=PROB_ATOL)
    # top-k keeps exactly k (rank 0 always survives top-p)
    kept = np.isfinite(got).sum(axis=1)
    for row, (t, tp, tk) in enumerate(CONFIGS):
        if t > 0 and tk:
            assert 1 <= kept[row] <= tk
        if t > 0:
            assert np.isfinite(got[row, np.argmax(got[row])])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_greedy_rows_bitwise_argmax(dtype):
    """Temperature-0 rows take argmax(f32(logits)), the first maximum, as
    the greedy-only decode did and as JAX's sampler does."""
    logits, temps, top_ps, top_ks = _rows(ties=True, seed=3)
    lt = torch.from_numpy(logits).to(dtype)
    z = np.zeros(len(CONFIGS), np.int32)
    got = sampling.sample_tokens(lt, *_t(np.zeros_like(temps), top_ps,
                                         top_ks, z, z)).numpy()
    want = torch.argmax(lt.float(), dim=-1).numpy()
    np.testing.assert_array_equal(got, want)
    jwant = np.asarray(jsampling.sample_tokens(
        jnp.asarray(lt.float().numpy()), *_j(np.zeros_like(temps), top_ps,
                                             top_ks, z, z)))
    np.testing.assert_array_equal(got, jwant)
    # the greedy rows of a mixed batch are untouched by their neighbours
    mixed = sampling.sample_tokens(lt, *_t(temps, top_ps, top_ks, z + 5,
                                           z)).numpy()
    g = temps == 0
    np.testing.assert_array_equal(mixed[g], want[g])


def _tv(a, b) -> float:
    return 0.5 * float(np.abs(np.asarray(a) - np.asarray(b)).sum())


def _histogram(row_logits, t, tp, tk, seed=7, tag=sampling.TAG_TARGET):
    """N_DRAWS draws of one row, draw indices 0 .. N_DRAWS - 1."""
    n = N_DRAWS
    logits = torch.from_numpy(np.repeat(row_logits[None], n, axis=0))
    toks = sampling.sample_tokens(
        logits, *_t(np.full(n, t, np.float32), np.full(n, tp, np.float32),
                    np.full(n, tk, np.int32), np.full(n, seed, np.int32),
                    np.arange(n, dtype=np.int32)), tag=tag).numpy()
    return np.bincount(toks, minlength=V) / n


@pytest.mark.parametrize("row", [1, 2, 3, 4, 5])
def test_sample_histogram_matches_exact_probs(row):
    """Draws follow JAX's exact sampling distribution (TV under
    TV_LIMIT); the same statistic separates another temperature's
    distribution (TV above it). Tokens outside the keep-set never
    appear."""
    logits, temps, top_ps, top_ks = _rows(ties=False, seed=11)
    t, tp, tk = CONFIGS[row]
    freq = _histogram(logits[row], t, tp, tk)
    exact = np.asarray(jsampling.sampling_probs(*_j(
        logits[row:row + 1], temps[row:row + 1], top_ps[row:row + 1],
        top_ks[row:row + 1])))[0]
    assert _tv(freq, exact) < TV_LIMIT
    assert not np.any(freq[exact == 0.0])
    other = np.asarray(jsampling.sampling_probs(*_j(
        logits[row:row + 1], np.float32([t / 4.0]), top_ps[row:row + 1],
        top_ks[row:row + 1])))[0]
    assert _tv(freq, other) > TV_LIMIT


def test_draws_are_a_pure_function_of_seed_tag_index():
    """A draw depends on (seed, tag, index) only: the same request's row
    gives the same token in any batch position or batch; another seed, tag
    or index gives another stream."""
    logits, temps, top_ps, top_ks = _rows(ties=False, seed=5)
    row = logits[2]
    cfg = (np.float32(1.0), np.float32(1.0), np.int32(0))
    n = 256

    def draw(seeds, ctrs, tag=sampling.TAG_TARGET, perm=None):
        b = len(seeds)
        lg = np.repeat(row[None], b, axis=0)
        out = sampling.sample_tokens(torch.from_numpy(lg), *_t(
            np.full(b, cfg[0]), np.full(b, cfg[1]), np.full(b, cfg[2]),
            np.asarray(seeds, np.int32), np.asarray(ctrs, np.int32)),
            tag=tag).numpy()
        return out

    ctr = np.arange(n, dtype=np.int32)
    a = draw(np.full(n, 9), ctr)
    perm = np.random.RandomState(0).permutation(n)
    b = draw(np.full(n, 9), ctr[perm])
    np.testing.assert_array_equal(a[perm], b)
    # one at a time, in a batch of one
    for i in (0, 17, 255):
        assert draw([9], [i])[0] == a[i]
    # beside other requests
    mixed = draw(np.asarray([1, 9, 2], np.int32), np.asarray([3, 40, 5]))
    assert mixed[1] == a[40]
    # another seed, tag or shifted index: another stream
    assert np.mean(draw(np.full(n, 10), ctr) == a) < 0.5
    assert np.mean(draw(np.full(n, 9), ctr,
                        tag=sampling.TAG_DRAFT) == a) < 0.5
    assert np.mean(draw(np.full(n, 9), ctr + 1) == a) < 0.5


def test_accept_uniforms_uniform_and_indexed():
    """accept_uniforms: row b, column i is the ACCEPT stream's draw at
    counters[b] + i; the values are uniform on (0, 1)."""
    n, k = 2000, 4
    seeds = np.arange(n, dtype=np.int32) % 7
    ctrs = np.arange(n, dtype=np.int32)
    u = sampling.accept_uniforms(*_t(seeds, ctrs), k).numpy()
    assert u.shape == (n, k) and u.dtype == np.float32
    assert 0.0 < u.min() and u.max() < 1.0
    u1 = sampling.accept_uniforms(*_t(seeds, ctrs + 2), 1).numpy()
    np.testing.assert_array_equal(u[:, 2], u1[:, 0])
    # ten equal bins: each within 5 sigma of its binomial mean
    counts = np.histogram(u.ravel(), bins=10, range=(0, 1))[0]
    m = u.size / 10
    assert np.all(np.abs(counts - m) < 5 * np.sqrt(m * 0.9))
    assert abs(u.mean() - 0.5) < 5 * np.sqrt(1 / 12 / u.size)


def _residual_hist(p, q, seed=3):
    n = N_DRAWS
    toks = sampling.residual_sample(
        torch.from_numpy(np.repeat(p[None], n, 0)),
        torch.from_numpy(np.repeat(q[None], n, 0)),
        *_t(np.full(n, seed, np.int32), np.arange(n, dtype=np.int32)))
    return np.bincount(toks.numpy(), minlength=V) / n


def test_residual_sample_follows_residual_and_falls_back():
    """residual_sample draws from norm(max(p - q, 0)); with q = 0 (the
    bonus draw) that is p, and with q >= p everywhere (an empty residual)
    it falls back to p."""
    rs = np.random.RandomState(2)
    p = rs.dirichlet(np.ones(V)).astype(np.float32)
    q = rs.dirichlet(np.ones(V)).astype(np.float32)
    r = np.maximum(p - q, 0)
    freq = _residual_hist(p, q)
    assert _tv(freq, r / r.sum()) < TV_LIMIT
    assert not np.any(freq[r == 0])
    assert _tv(_residual_hist(p, np.zeros_like(p)), p) < TV_LIMIT
    assert _tv(_residual_hist(p, p), p) < TV_LIMIT
    assert _tv(_residual_hist(p, p * 2), p) < TV_LIMIT
    # JAX's residual distribution is the same
    jr = np.asarray(jsampling.residual_sample(
        jnp.asarray(p[None]), jnp.asarray(q[None]), jnp.int32([0]),
        jnp.int32([0])))
    assert r[int(jr[0])] > 0


def test_sample_with_probs_equals_both_functions():
    """The draft's fused call returns exactly sample_tokens' tokens and
    sampling_probs' distributions."""
    logits, temps, top_ps, top_ks = _rows(ties=True, seed=8)
    b = len(CONFIGS)
    seeds, ctrs = np.arange(b, dtype=np.int32), np.arange(b, dtype=np.int32)
    args = _t(logits, temps, top_ps, top_ks, seeds, ctrs)
    tok, probs = sampling.sample_with_probs(*args, tag=sampling.TAG_DRAFT)
    np.testing.assert_array_equal(
        tok.numpy(), sampling.sample_tokens(*args,
                                            tag=sampling.TAG_DRAFT).numpy())
    np.testing.assert_array_equal(
        probs.numpy(), sampling.sampling_probs(*args[:4]).numpy())


def test_validate_sampling_matches_jax():
    for bad, name in (((-0.5, 1.0, 0), "temperature"),
                      ((1.0, 0.0, 0), "top_p"), ((1.0, 1.0, -3), "top_k")):
        with pytest.raises(ValueError, match=name):
            sampling.validate_sampling(*bad)
        with pytest.raises(ValueError, match=name):
            jsampling.validate_sampling(*bad)
    assert sampling.validate_sampling(0.7, 0.9, 5) \
        == jsampling.validate_sampling(0.7, 0.9, 5)
