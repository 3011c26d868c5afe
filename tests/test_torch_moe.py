"""The PyTorch port's Mixture-of-Experts against the JAX package: the op,
the MoE language model trained through ``fit`` (its load-balancing aux
loss folded into the training loss in every step variant), and served.

The op (6 experts, top-2, hidden 16 -> 32, 24 tokens) runs in both
packages from one numpy draw of its weights, for the sort and the dense
dispatch, with the capacity ample and binding, and with the router's
logits tied in pairs (columns 0 = 1 and 2 = 3), where the top-k must take
the lowest index first: output, aux and the gradient of every input and
weight; and sort against dense inside the port. ``gpt_lm(moe_every=2)``
(hidden 64, 2 layers, 4 experts) is held to JAX as the zoo models are
(tests/test_torch_zoo.py: logits, loss, every gradient, 3 SGD steps
through ``fit``, ``evaluate``, which leaves the aux out), and again
under ``grad_accum_steps=2`` and ``train_scanned``; under the divergence
guard its steps are bitwise the plain ones, and under bf16 compute the
aux stays f32. A small MoE LM serves the JAX engine's greedy tokens, cold
and again from the prefix cache, and under a tight training capacity its
batched rows equal each prompt served alone (the serving walk's capacity
= the slab's tokens).

Tolerances, f32: outputs and aux 1e-5; gradients 1e-4 of their largest
value; weights after N steps 1e-5 (of the largest weight under the step
variants); greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.models import bert as j_bert
import flexflow_tpu_torch as T
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import bert as t_bert
from test_torch_zoo import (ZOO, _np_tree, _tokens,
                            check_logits_loss_and_gradients,
                            check_three_sgd_steps, numpy_init, zoo_pair)

N, D, E, F = 24, 16, 6, 32
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4
#: capacity factors: ample (no drop) and binding (capacity 4 of the ~8
#: assignments an expert)
CAPACITY = {"ample": 100.0, "binding": 0.5}
VOCAB = 53
LM = dict(seq_len=16, hidden=64, layers=2, heads=2, vocab_size=VOCAB,
          moe_every=2, num_experts=4)

ZOO["gpt_lm_moe"] = (
    lambda pkg: lambda ff, b: (j_bert if pkg is J else t_bert).gpt_lm(
        ff, b, **LM),
    _tokens(VOCAB, LM["seq_len"]), "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY",
    VOCAB)


# ---- the op --------------------------------------------------------------


def _weights(ties: bool):
    rs = np.random.RandomState(3)

    def glorot(shape, fan_in, fan_out):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return rs.uniform(-lim, lim, shape).astype(np.float32)

    w = {"router": glorot((D, E), D, E), "w_in": glorot((E, D, F), D, F),
         "w_out": glorot((E, F, D), F, D)}
    if ties:
        w["router"][:, 1] = w["router"][:, 0]
        w["router"][:, 3] = w["router"][:, 2]
    return w


def _ops(dispatch: str, capacity_factor: float):
    """The MoE op of each package over a (2, N/2, D) input."""
    ops = []
    for pkg, kw in ((J, {"mesh_shape": {"data": 1}}), (T, {})):
        ff = pkg.FFModel(pkg.FFConfig(batch_size=2, **kw),
                         **({} if pkg is J else {"device": "cpu"}))
        x = ff.create_tensor([2, N // 2, D], name="x")
        ff.moe(x, E, F, k=2, capacity_factor=capacity_factor,
               dispatch=dispatch, name="moe")
        ops.append(ff.get_op_by_name("moe"))
    return ops


def _inputs():
    rs = np.random.RandomState(4)
    return (rs.randn(2, N // 2, D).astype(np.float32),
            rs.randn(2, N // 2, D).astype(np.float32))


def _jax_run(op, w, x, r):
    """(y, aux, grads of x and every weight) of sum(y * r) + 10 aux."""
    def f(x, p):
        y, aux = op.forward(p, [x])
        return jnp.sum(y * r) + 10.0 * aux, (y, aux)
    (_, (y, aux)), (gx, gp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                         {k: jnp.asarray(v)
                                          for k, v in w.items()})
    grads = {"x": gx, **gp}
    return (np.asarray(y), float(aux),
            {k: np.asarray(v) for k, v in grads.items()})


def _port_run(op, w, x, r):
    xt = torch.tensor(x, requires_grad=True)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    y, aux = op.forward(p, [xt])
    (torch.sum(y * torch.as_tensor(r)) + 10.0 * aux).backward()
    grads = {"x": xt.grad, **{k: v.grad for k, v in p.items()}}
    return (y.detach().numpy(), aux.item(),
            {k: v.numpy() for k, v in grads.items()})


def _assert_runs_close(got, want):
    np.testing.assert_allclose(got[0], want[0], **OUT_TOL)
    np.testing.assert_allclose(got[1], want[1], **OUT_TOL)
    for k, ref in want[2].items():
        np.testing.assert_allclose(got[2][k], ref, rtol=0,
                                   atol=GRAD_REL * np.abs(ref).max(),
                                   err_msg=k)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("dispatch", ["sort", "dense"])
def test_moe_op_matches_jax(dispatch, capacity, ties):
    """Output, aux and every gradient against the JAX op; with a binding
    capacity some tokens lose an expert (or both), and the same ones in
    both packages."""
    jop, top = _ops(dispatch, CAPACITY[capacity])
    assert top.capacity == jop.capacity
    assert top._use_sort_dispatch() == (dispatch == "sort")
    w = _weights(ties)
    x, r = _inputs()
    want = _jax_run(jop, w, x, r)
    got = _port_run(top, w, x, r)
    _assert_runs_close(got, want)
    assert got[1] > 0
    # a binding capacity drops assignments: some token's output row is
    # then one expert's, or zero
    if capacity == "binding":
        ample = _port_run(_ops(dispatch, CAPACITY["ample"])[1], w, x, r)
        assert not np.allclose(got[0], ample[0])


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_sort_dispatch_matches_dense_in_port(capacity, ties):
    """The port's two dispatches agree: same drops, same outputs, aux and
    gradients."""
    w = _weights(ties)
    x, r = _inputs()
    sort = _port_run(_ops("sort", CAPACITY[capacity])[1], w, x, r)
    dense = _port_run(_ops("dense", CAPACITY[capacity])[1], w, x, r)
    _assert_runs_close(sort, dense)


def test_auto_dispatch_sorts_and_capacity_override():
    """'auto' takes the sort path (no mesh shards the experts); the
    capacity follows the JAX formula and the forward's override wins."""
    jop, top = _ops("auto", 1.25)
    assert top._use_sort_dispatch() and jop._use_sort_dispatch()
    assert top.capacity == jop.capacity == int(1.25 * N * 2 / E)
    w = _weights(False)
    x, _ = _inputs()
    p = {k: torch.tensor(v) for k, v in w.items()}
    y1, _ = top.forward(p, [torch.tensor(x)], capacity=1)
    yn, _ = top.forward(p, [torch.tensor(x)], capacity=N)
    want = jop.forward({k: jnp.asarray(v) for k, v in w.items()},
                       [jnp.asarray(x)], capacity=1)[0]
    np.testing.assert_allclose(y1.numpy(), np.asarray(want), **OUT_TOL)
    assert not np.allclose(y1.numpy(), yn.numpy())


# ---- the MoE language model through fit ------------------------------------


@pytest.fixture(scope="module")
def pair():
    yield from zoo_pair("gpt_lm_moe")


def test_moe_lm_logits_loss_and_every_gradient_match_jax(pair):
    """At initialisation: logits, the training loss (aux included, in both
    packages) and every gradient."""
    _, _, tff, _, _, _, _ = pair
    assert [op.name for op in tff.ops if op.op_type.name == "OP_MOE"] \
        == ["moe_1"]
    assert len(tff._aux_tensors) == 1
    check_logits_loss_and_gradients(pair)


def test_moe_lm_three_sgd_steps_through_fit_match_jax(pair):
    """Three SGD steps through fit: losses (with aux), every weight,
    evaluate's loss (without aux, as JAX's: exactly the cross-entropy of
    its logits)."""
    check_three_sgd_steps(pair)
    from flexflow_tpu_torch.runtime.loss import compute_loss

    _, _, tff, _, _, _, _ = pair
    x, y = _lm_data(3, 2)
    loss, _, logits = tff.evaluate({"input": x, "label": y})
    assert loss == compute_loss(tff.loss_type, logits,
                                torch.as_tensor(y)).item()


def test_aux_stays_f32_under_bf16_compute():
    """Under bf16 compute the MoE's output is bf16 and its aux f32 in the
    value map, and the training loss is the f32 cross-entropy plus the
    aux."""
    from flexflow_tpu_torch.runtime.loss import compute_loss

    ff = T.FFModel(T.FFConfig(batch_size=2, compute_dtype="bfloat16"),
                   device="cpu")
    tok, out = t_bert.gpt_lm(ff, 2, **LM)
    ff.compile(T.SGDOptimizer(lr=0.05),
               T.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [T.MetricsType.METRICS_ACCURACY], final_tensor=out)
    x, y = _lm_data(4, 2)
    batch = ff._to_device({"input": x, "label": y})
    vals, _ = ff.executor.apply_graph(ff.params, {tok: batch["input"]},
                                      training=True)
    aux = vals[ff._aux_tensors[0]]
    assert aux.dtype == torch.float32 and aux.dim() == 0 and aux > 0
    assert vals[ff.get_op_by_name("moe_1").outputs[0]].dtype == \
        torch.bfloat16
    loss, _, _, _ = ff.executor._loss_and_grads(
        ff.params, batch, ff.loss_type, ff.metric_types, out)
    ce = compute_loss(ff.loss_type, vals[out], batch["label"])
    assert loss.dtype == torch.float32
    torch.testing.assert_close(loss, ce + aux, rtol=0, atol=0)


def _lm_pair(**cfg):
    """gpt_lm(moe_every=2) in both packages under ``cfg``, JAX's numpy
    weights in the port."""
    mp = pytest.MonkeyPatch()
    numpy_init(mp)
    try:
        jff = J.FFModel(J.FFConfig(batch_size=4, mesh_shape={"data": 1},
                                   seed=5, **cfg))
        jtok, jout = j_bert.gpt_lm(jff, 4, **LM)
        jff.compile(J.SGDOptimizer(lr=0.05),
                    J.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                    [J.MetricsType.METRICS_ACCURACY], final_tensor=jout)
    finally:
        mp.undo()
    tff = T.FFModel(T.FFConfig(batch_size=4, seed=5, **cfg), device="cpu")
    ttok, tout = t_bert.gpt_lm(tff, 4, **LM)
    tff.compile(T.SGDOptimizer(lr=0.05),
                T.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                [T.MetricsType.METRICS_ACCURACY], final_tensor=tout)
    tff.params = params_from_jax(_np_tree(jff.params), "cpu", torch.float32,
                                 model=tff)
    tff.opt_state = tff.optimizer.init_state(tff.params)
    return jff, tff, jtok, ttok


def _lm_data(seed, n):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, VOCAB, (n, LM["seq_len"])).astype(np.int32),
            rs.randint(0, VOCAB, (n, LM["seq_len"], 1)).astype(np.int32))


def _close_to_jax(tff, jff):
    want = _np_tree(jff.params)
    wmax = max(np.abs(a).max() for ws in want.values() for a in ws.values())
    for op, ws in want.items():
        for w, ref in ws.items():
            np.testing.assert_allclose(tff.params[op][w].detach().numpy(),
                                       ref, rtol=0, atol=1e-5 * wmax,
                                       err_msg=f"{op}.{w}")


def test_moe_lm_aux_through_the_guard_bitwise_unguarded():
    """The divergence-guarded step (on_nonfinite="skip", loss scale 1)
    adds the aux as the plain step does: 3 finite steps give the
    unguarded step's losses and weights bitwise (the plain step is held
    to JAX above)."""
    runs = []
    for guard in ("none", "skip"):
        ff = T.FFModel(T.FFConfig(batch_size=4, seed=5, on_nonfinite=guard),
                       device="cpu")
        _, out = t_bert.gpt_lm(ff, 4, **LM)
        ff.compile(T.SGDOptimizer(lr=0.05),
                   T.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   [T.MetricsType.METRICS_ACCURACY], final_tensor=out)
        losses = []
        for i in range(3):
            x, y = _lm_data(9 + i, 4)
            losses.append(ff._run_train_step({"input": x, "label": y})[0])
        runs.append((ff, torch.stack(losses)))
    (plain, lp), (guarded, lg) = runs
    assert guarded._guard is not None and torch.equal(lg, lp)
    for op, ws in plain.params.items():
        for k, w in ws.items():
            assert torch.equal(guarded.params[op][k], w), f"{op}.{k}"


@pytest.mark.parametrize("variant", ["grad_accum_steps=2", "train_scanned"])
def test_moe_lm_aux_through_step_variants_matches_jax(variant):
    """The aux is each microbatch's under accumulation (two microbatches
    of 2), and inside the scanned steps: 3 steps against JAX's."""
    if variant == "train_scanned":
        jff, tff, jtok, ttok = _lm_pair()
        x, y = _lm_data(8, 12)
        J.SingleDataLoader(jff, jtok, x)
        J.SingleDataLoader(jff, jff.label_tensor, y)
        T.SingleDataLoader(tff, ttok, x)
        T.SingleDataLoader(tff, tff.label_tensor, y)
        jl, _ = jff.train_scanned(3)
        tl, _ = tff.train_scanned(3)
        jl, tl = np.asarray(jl), tl.numpy()
    else:
        jff, tff, _, _ = _lm_pair(grad_accum_steps=2)
        jl, tl = [], []
        for i in range(3):
            x, y = _lm_data(9 + i, 4)
            batch = {"input": x, "label": y}
            jl.append(float(jff._run_train_step(batch)[0]))
            tl.append(float(tff._run_train_step(batch)[0]))
    np.testing.assert_allclose(tl, jl, **OUT_TOL)
    _close_to_jax(tff, jff)


# ---- serving ----------------------------------------------------------------


SERVE = dict(serve_slots=2, kv_page_size=4, max_seq_len=32)


def test_moe_lm_serves_jax_engines_greedy_tokens():
    """gpt_lm(moe_every=2) (no rope, no attention bias) served by the port
    from JAX's weights: the JAX engine's greedy tokens; the decode walk
    reaches the MoE at capacity = the slab's tokens."""
    mp = pytest.MonkeyPatch()
    numpy_init(mp)
    try:
        jff = J.FFModel(J.FFConfig(batch_size=2, mesh_shape={"data": 1}))
        _, logits = j_bert.gpt_lm(jff, 2, **LM)
        jff.compile(final_tensor=logits)
    finally:
        mp.undo()
    tff = T.FFModel(T.FFConfig(batch_size=2), device="cpu")
    _, logits = t_bert.gpt_lm(tff, 2, **LM)
    tff.compile(final_tensor=logits)
    tff.params = params_from_jax(_np_tree(jff.params), "cpu", torch.float32,
                                 model=tff)
    rs = np.random.RandomState(6)
    prompts = [rs.randint(1, VOCAB, n).astype(np.int32) for n in (5, 11, 3)]
    jeng = jff.make_serving_engine(paged_attention_impl="einsum", **SERVE)
    jout = [r.output for r in jeng.run(prompts, max_new_tokens=6)]
    seen = []
    moe = tff.get_op_by_name("moe_1")
    fwd = moe.forward
    moe.forward = lambda p, xs, **kw: seen.append(kw) or fwd(p, xs, **kw)
    tout, stats = tff.serve(prompts, max_new_tokens=6, **SERVE)
    assert stats["completed"] == len(prompts)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    # decode slabs hold one token a slot
    assert {"capacity": SERVE["serve_slots"]} in seen
    # a second round on each engine mounts the cached prefixes: the chunk
    # and gather-last passes (no rope there either) give JAX's tokens
    teng = tff.make_serving_engine(**SERVE)
    teng.run(prompts, max_new_tokens=6)
    again = [r.output for r in teng.run(prompts, max_new_tokens=6)]
    jagain = [r.output for r in jeng.run(prompts, max_new_tokens=6)]
    assert teng.stats()["prefix_hits"] == jeng.stats()["prefix_hits"] > 0
    for j, t in zip(jagain, again):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _tight_moe_decoder(batch):
    """The JAX test's Mixtral-style decoder (rope attention + MoE FFN) with
    a training capacity of 0.5 (drops in training)."""
    ff = T.FFModel(T.FFConfig(batch_size=batch, seed=8), device="cpu")
    toks = ff.create_tensor([batch, 12], dtype=T.DataType.DT_INT32,
                            name="input")
    t = ff.embedding(toks, VOCAB, 32, name="embed")
    for i in range(2):
        a = ff.rms_norm(t, name=f"ln1_{i}")
        a = ff.multihead_attention(a, a, a, 32, 1, causal=True, bias=False,
                                   rope=True, name=f"attn_{i}")
        t = ff.add(t, a, name=f"res1_{i}")
        m = ff.moe(ff.rms_norm(t, name=f"ln2_{i}"), num_experts=4,
                   hidden_dim=64, k=2, capacity_factor=0.5,
                   name=f"moe_{i}")
        t = ff.add(t, m, name=f"res2_{i}")
    logits = ff.dense(t, VOCAB, use_bias=False, name="lm_head")
    ff.compile(final_tensor=logits)
    return ff


def test_moe_decode_rows_independent_under_tight_capacity():
    """Under a training capacity that drops tokens, four prompts served
    together give each prompt's tokens served alone (JAX's
    test_moe_decode_rows_independent_under_tight_capacity, on the port's
    engine)."""
    ff = _tight_moe_decoder(4)
    assert ff.get_op_by_name("moe_0").capacity < 12 * 4 * 2 // 4
    rs = np.random.RandomState(12)
    prompts = [rs.randint(0, VOCAB, n).astype(np.int32) for n in (6, 9, 4,
                                                                  7)]
    kw = dict(serve_slots=4, kv_page_size=4, max_seq_len=32,
              prefix_cache=False)
    together, _ = ff.serve(prompts, max_new_tokens=4, **kw)
    for i, p in enumerate(prompts):
        solo, _ = ff.serve([p], max_new_tokens=4, **kw)
        np.testing.assert_array_equal(together[i], solo[0],
                                      err_msg=f"row {i} coupled")
