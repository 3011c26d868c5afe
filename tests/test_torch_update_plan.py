"""The fused update's host side in the PyTorch port, without a card.

- ``fused_update_plan`` (how the kernel cuts a launch's leaves into
  chunks, heads, vector bodies and tails) over random leaf sizes, storage
  offsets and grad dtypes: every element covered exactly once, no chunk
  across leaves, vectors exactly where every pointer aligns.
- ``_check_update``'s flat and per-leaf state forms, and its refusals.
- The wrapper's cached launch tables: the cache key follows every
  tensor's address, shape and dtype and the state's form; the ctypes
  tables are the plan's; ``vector_count`` (a card measurement) refused on
  the CPU.
- ``fused_update`` on CPU tensors in the per-leaf form (its plain
  version): bitwise the per-leaf torch formula, no launch counted.
- The per-leaf optimizer against the JAX package's optimizers, one update
  from the same weights, grads and state (numpy, f32): within 1e-6 of the
  largest value (the two frameworks' ``pow`` / ``sqrt`` in Adam's alpha_t
  may round an ulp apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from flexflow_tpu import AdamOptimizer as JAdam
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu_torch import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.runtime.optimizer import apply_update_plain

BASE = 1 << 20     # a 16-byte (indeed 512-byte) aligned allocation


def _spans(plan):
    """Every chunk of the plan as (leaf, s0, a, b, e), in chunk order,
    each chunk's leaf found from the prefix sums as the kernel finds it."""
    out, c = [], 0
    for c in range(plan.chunk_end[-1] if plan.chunk_end else 0):
        leaf = next(i for i, end in enumerate(plan.chunk_end) if end > c)
        k = c - (plan.chunk_end[leaf - 1] if leaf else 0)
        out.append((leaf,) + kernels.fused_update_chunk_spans(plan, leaf, k))
    return out


leaf_st = st.tuples(st.integers(1, 100_000),          # elements
                    st.integers(0, 7), st.integers(0, 7),
                    st.integers(0, 7), st.booleans())  # offsets, f32 grad


@settings(max_examples=150, deadline=None)
@given(leaves=st.lists(leaf_st, min_size=1, max_size=12),
       elem=st.sampled_from([2, 4]), n_state=st.integers(0, 2))
def test_plan_covers_every_element_once(leaves, elem, n_state):
    numels, pointers = [], []
    for i, (n, ow, og, os_, g32) in enumerate(leaves):
        gsize = 4 if g32 else elem
        base = BASE * (4 * i + 1)
        ptrs = [(base + ow * elem, elem), (base + BASE + og * gsize, gsize)]
        ptrs += [(base + (2 + j) * BASE + os_ * elem, elem)
                 for j in range(n_state)]
        numels.append(n)
        pointers.append(ptrs)
    plan = kernels.fused_update_plan(numels, pointers, elem)
    width = 16 // elem
    assert plan.width == width and plan.chunk == 128 * 4 * width
    seen = {i: [] for i in range(len(numels))}
    for leaf, s0, a, b, e in _spans(plan):
        n = numels[leaf]
        assert 0 <= s0 <= a <= b <= e <= n and e > s0   # inside one leaf
        assert e - s0 <= plan.chunk + width              # one chunk's worth
        assert (b - a) % width == 0 and b - a <= plan.chunk
        if not plan.vector[leaf]:
            assert a == b == s0
        for j in range(a, b, width):                     # aligned vectors
            assert all((p + j * s) % 16 == 0 for p, s in pointers[leaf])
        seen[leaf].append((s0, e))
    for leaf, n in enumerate(numels):
        spans = seen[leaf]
        assert spans[0][0] == 0 and spans[-1][1] == n    # exactly once
        assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
        head = plan.head[leaf]
        aligned = all((p + head * s) % 16 == 0 for p, s in pointers[leaf])
        assert plan.vector[leaf] == aligned
    vec = kernels.fused_update_vector_elements(plan)
    for leaf, (n, v) in enumerate(zip(numels, vec)):
        body = sum(b - a for lf, s0, a, b, e in _spans(plan) if lf == leaf)
        assert v == body and (n - v < 2 * width if plan.vector[leaf]
                              else v == 0)


def test_plan_of_aligned_tensors_takes_vectors_but_the_edges():
    """Fresh bf16 tensors (allocations are 16-byte aligned) and a flat
    state vector of leaf sizes that are multiples of 8: every leaf on the
    vector path; a 16-element leaf is one vector pair and no scalar."""
    sizes = [4096, 16, 24, 8 * 1000]
    ps = [torch.zeros(n, dtype=torch.bfloat16) for n in sizes]
    gs = [torch.zeros(n, dtype=torch.bfloat16) for n in sizes]
    m = torch.zeros(sum(sizes), dtype=torch.bfloat16)
    (launch,) = kernels.fused_update_launches(ps, gs, [m])
    lo, plan = launch.lo, launch.plan
    assert lo == 0 and all(plan.vector) and set(plan.head) == {0}
    assert kernels.fused_update_vector_elements(plan) == tuple(sizes)
    # a leaf of 9 elements puts the next leaf's state one element off:
    # its head realigns the weight, so the state no longer aligns there
    sizes = [9, 4096]
    ps = [torch.zeros(n, dtype=torch.bfloat16) for n in sizes]
    gs = [torch.zeros(n, dtype=torch.bfloat16) for n in sizes]
    m = torch.zeros(sum(sizes), dtype=torch.bfloat16)
    plan = kernels.fused_update_launches(ps, gs, [m])[0].plan
    assert plan.vector == (True, False)


def test_plans_split_past_max_leaves():
    ps = [torch.zeros(3) for _ in range(300)]
    launches = kernels.fused_update_launches(ps, ps, [])
    assert [x.lo for x in launches] == [0, 128, 256]
    assert [len(x.plan.numel) for x in launches] == [128, 128, 44]


def _case(dtype=torch.float32, shapes=((3, 5), (7,), (1,)), seed=0):
    rs = np.random.RandomState(seed)
    ps = [torch.tensor(rs.randn(*s), dtype=torch.float32).to(dtype)
          for s in shapes]
    gs = [torch.tensor(rs.randn(*s), dtype=torch.float32).to(dtype)
          for s in shapes]
    return ps, gs


def _refusal(rule, ps, gs, ms, lr=None, finite=None):
    lr = torch.tensor(0.1) if lr is None else lr
    with pytest.raises(ValueError) as e:
        kernels._check_update("fused_update", rule, ps, gs, ms, lr, finite)
    return str(e.value)


def test_check_update_takes_both_state_forms():
    rule = kernels.UpdateRule("adam")
    ps, gs = _case()
    total = sum(p.numel() for p in ps)
    flat = [torch.zeros(total), torch.zeros(total)]
    per = [[torch.zeros_like(p) for p in ps] for _ in range(2)]
    lr = torch.tensor(0.1)
    kernels._check_update("fused_update", rule, ps, gs, flat, lr, None)
    kernels._check_update("fused_update", rule, ps, gs, per, lr,
                          torch.tensor(True))


@pytest.mark.parametrize("case", [
    "state_count", "mixed_forms", "flat_shape", "flat_dtype",
    "per_leaf_count", "per_leaf_shape", "per_leaf_dtype", "grad_dtype",
    "weight_dtype", "lr", "finite"])
def test_check_update_refusals_are_named(case):
    rule = kernels.UpdateRule("adam")
    ps, gs = _case()
    total = sum(p.numel() for p in ps)
    flat = [torch.zeros(total), torch.zeros(total)]
    per = [[torch.zeros_like(p) for p in ps] for _ in range(2)]
    want = {
        "state_count": (lambda: _refusal(rule, ps, gs, flat[:1]),
                        "want 2 for adam"),
        "mixed_forms": (lambda: _refusal(rule, ps, gs, [flat[0], per[1]]),
                        "all flat vectors or all lists"),
        "flat_shape": (lambda: _refusal(rule, ps, gs, [flat[0],
                                                       torch.zeros(3)]),
                       f"state vectors must be ({total},)"),
        "flat_dtype": (lambda: _refusal(rule, ps, gs, [flat[0],
                                                       flat[1].double()]),
                       "state vectors must be"),
        "per_leaf_count": (lambda: _refusal(rule, ps, gs,
                                            [per[0], per[1][:2]]),
                           "per-leaf state of 2 tensors for 3 weights"),
        "per_leaf_shape": (lambda: _refusal(
            rule, ps, gs, [per[0], [per[1][0], torch.zeros(8),
                                    per[1][2]]]),
            "leaf 1: per-leaf state (8,)"),
        "per_leaf_dtype": (lambda: _refusal(
            rule, ps, gs, [per[0], [per[1][0], per[1][1],
                                    per[1][2].to(torch.bfloat16)]]),
            "leaf 2: per-leaf state"),
        "grad_dtype": (lambda: _refusal(rule, ps, [gs[0], gs[1].half(),
                                                   gs[2]], flat),
                       "leaf 1: weight"),
        "weight_dtype": (lambda: _refusal(rule, [p.half() for p in ps], gs,
                                          flat), "weights must be one of"),
        "lr": (lambda: _refusal(rule, ps, gs, flat, lr=torch.tensor(0.1,
                                dtype=torch.float64)), "0-dim f32"),
        "finite": (lambda: _refusal(rule, ps, gs, flat,
                                    finite=torch.tensor(1)),
                   "finite must be a 0-dim bool"),
    }
    fn, text = want[case]
    assert text in fn()


KEY_CHANGES = ["weight_address", "weight_shape", "grad_dtype",
               "state_address", "state_form", "state_count"]


@pytest.mark.parametrize("change", KEY_CHANGES)
def test_update_key_follows_what_the_launch_depends_on(change):
    """The cache key of ``fused_update``'s launch tables: the same for the
    same tensors in new lists, another one when an address, a shape, a
    grad's dtype, the state's form or its count changes (a cache hit must
    never launch another plan)."""
    rule = kernels.UpdateRule("adam")
    ps, gs = _case()
    total = sum(p.numel() for p in ps)
    flat = [torch.zeros(total), torch.zeros(total)]
    key = kernels._update_key(rule, ps, gs, flat)
    assert kernels._update_key(rule, list(ps), list(gs), list(flat)) == key
    ps2, gs2, ms2, rule2 = list(ps), list(gs), list(flat), rule
    if change == "weight_address":
        ps2[1] = ps[1].clone()
    elif change == "weight_shape":
        ps2[0] = ps[0].view(5, 3)
    elif change == "grad_dtype":
        gs2[2] = gs[2].double()
    elif change == "state_address":
        ms2[1] = flat[1].clone()
    elif change == "state_form":
        ms2[0] = [flat[0][:15].view(3, 5), flat[0][15:22], flat[0][22:]]
    else:
        rule2, ms2 = kernels.UpdateRule("sgd", momentum=0.9), flat[:1]
    assert kernels._update_key(rule2, ps2, gs2, ms2) != key


@pytest.mark.parametrize("form", ["flat", "per_leaf"])
def test_update_args_are_the_plans_tables(form):
    """``_update_args``: one table a launch (300 leaves: three), each
    the plan's sizes, heads, chunk prefix sums and the tensors' addresses,
    a leaf's flags its f32 grad (1) and its vector body (2)."""
    rule = kernels.UpdateRule("sgd", momentum=0.9)
    ps = [torch.zeros(i % 37 + 1, dtype=torch.bfloat16) for i in range(300)]
    gs = [torch.zeros(p.shape, dtype=torch.float32 if i % 5 == 0
                      else torch.bfloat16) for i, p in enumerate(ps)]
    total = sum(p.numel() for p in ps)
    ms = [torch.zeros(total, dtype=torch.bfloat16)]
    if form == "per_leaf":
        ms = [[torch.zeros_like(p) for p in ps]]
    args = kernels._update_args(rule, ps, gs, ms)
    launches = kernels.fused_update_launches(ps, gs, ms)
    assert len(args) == len(launches) == 3
    for (w, g, m, v, numel, flags, head, ends, n, chunk), x in zip(
            args, launches):
        plan = x.plan
        assert m is None and n == len(plan.numel) and chunk == plan.chunk
        assert list(w) == x.w and list(g) == x.g and list(v) == x.state[0]
        assert tuple(numel) == plan.numel and tuple(head) == plan.head
        assert tuple(ends) == plan.chunk_end
        assert list(flags) == [
            (gs[x.lo + i].dtype == torch.float32) | 2 * vec
            for i, vec in enumerate(plan.vector)]


def test_vector_count_is_refused_on_the_cpu():
    """The kernel's vector-path count is a card measurement: the CPU's
    plain version has no vector path and refuses it."""
    ps, gs = _case()
    with pytest.raises(ValueError, match="vector_count counts the card"):
        kernels.fused_update(kernels.UpdateRule("sgd"), ps, gs, [],
                             torch.tensor(0.1),
                             vector_count=torch.zeros(1, dtype=torch.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rule", [
    kernels.UpdateRule("sgd", weight_decay=0.01),
    kernels.UpdateRule("sgd", momentum=0.9, nesterov=True),
    kernels.UpdateRule("adam", weight_decay=0.01)],
    ids=["sgd_wd", "nesterov", "adam"])
def test_per_leaf_form_plain_is_the_per_leaf_formula(rule, dtype):
    """``fused_update`` on CPU tensors with per-leaf state is its plain
    version: bitwise ``apply_update_plain`` leaf by leaf, state kept in
    its tensors, and no launch counted; also under a false ``finite``."""
    ps, gs = _case(dtype, seed=1)
    ms = [[torch.rand(p.shape).to(dtype) for p in ps]
          for _ in range(rule.n_moments)]
    ref_p = [p.clone() for p in ps]
    ref_m = [[x.clone() for x in m] for m in ms]
    lr = torch.tensor(0.05)
    n0 = kernels.fused_update.launches
    for finite in (None, torch.tensor(False), torch.tensor(True)):
        kernels.fused_update(rule, ps, gs, ms, lr, finite)
        for i, (p, g) in enumerate(zip(ref_p, gs)):
            apply_update_plain(rule, p, g, [m[i] for m in ref_m], lr, finite)
    assert kernels.fused_update.launches == n0
    assert all(torch.equal(a, b) for a, b in zip(ps, ref_p))
    assert all(torch.equal(a, b) for m, r in zip(ms, ref_m)
               for a, b in zip(m, r))


JAX_PAIRS = {
    "momentum": (lambda: JSGD(lr=0.1, momentum=0.9, weight_decay=0.01),
                 lambda: SGDOptimizer(lr=0.1, momentum=0.9,
                                      weight_decay=0.01)),
    "nesterov": (lambda: JSGD(lr=0.1, momentum=0.9, nesterov=True),
                 lambda: SGDOptimizer(lr=0.1, momentum=0.9, nesterov=True)),
    "adam": (lambda: JAdam(alpha=0.01, weight_decay=0.01),
             lambda: AdamOptimizer(alpha=0.01, weight_decay=0.01)),
}


@pytest.mark.parametrize("opt", list(JAX_PAIRS))
def test_per_leaf_optimizer_matches_jax(opt):
    """Two updates of the per-leaf optimizer (its CPU path, the formula the
    card's kernel matches bitwise) against the JAX optimizer's ``update``
    from the same weights and grads, f32."""
    jopt, topt = (f() for f in JAX_PAIRS[opt])
    rs = np.random.RandomState(4)
    shapes = {"a": {"kernel": (5, 3), "bias": (3,)}, "b": {"scale": (9,)}}
    params = {op: {k: rs.randn(*s).astype(np.float32) for k, s in ws.items()}
              for op, ws in shapes.items()}
    grads = [{op: {k: rs.randn(*s).astype(np.float32)
                   for k, s in ws.items()} for op, ws in shapes.items()}
             for _ in range(2)]
    jp = {op: {k: jnp.asarray(w) for k, w in ws.items()}
          for op, ws in params.items()}
    js = jopt.init_state(jp)
    tp = {op: {k: torch.tensor(w) for k, w in ws.items()}
          for op, ws in params.items()}
    ts = topt.init_state(tp)
    for g in grads:
        jp, js = jopt.update(jp, {op: {k: jnp.asarray(x) for k, x in ws.items()}
                                  for op, ws in g.items()}, js)
        topt.update(tp, {op: {k: torch.tensor(x) for k, x in ws.items()}
                         for op, ws in g.items()}, ts)
    for op, ws in tp.items():
        for k, w in ws.items():
            ref = np.asarray(jp[op][k])
            np.testing.assert_allclose(w.numpy(), ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max())
    assert int(ts["t"]) == int(js["t"]) == 2
