"""The PyTorch port's pipelined transformer layer stack (its serial path)
and ``gpt_pipelined`` against the JAX package.

The stack (2 layers of stacked (L, ...) weights, hidden 64, 2 heads of
32, seq 16, batch 2) runs in both packages from one numpy draw of its
weights on both attention routes: the flash route (the JAX side with
``FF_FORCE_FLASH_ATTENTION=1``, so its Pallas flash kernels run forward
and backward in interpret mode; the port's flash autograd Function runs
its plain versions) and the einsum route (``use_flash_attention=False``
in both), causal and not: the output and the gradient of the input and
of every stacked weight. ``gpt_pipelined`` is held to JAX as the zoo
models are (tests/test_torch_zoo.py: logits, loss, every gradient, 3 SGD
steps through ``fit``, ``evaluate``). Inside the port the stack equals an
unrolled chain of the same blocks on separate per-layer weights, and each
layer's gradient lands in its slice of the one stacked leaf (bitwise).

Tolerances, f32: outputs 1e-5; gradients 1e-4 of their largest value,
but the key bias's, which is zero in exact arithmetic (it adds a constant
to a query row, which the softmax drops): there both packages' rounding
noise must stay under 1e-6 of the op's largest gradient; weights after 3
steps 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.models import bert as j_bert
import flexflow_tpu_torch as T
from flexflow_tpu_torch.models import bert as t_bert
from flexflow_tpu_torch.ops.pipelined import _block
from test_torch_zoo import (ZOO, _tokens, check_logits_loss_and_gradients,
                            check_three_sgd_steps, zoo_pair)

B, S, D, HEADS, L = 2, 16, 64, 2, 2
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4
ZERO_GRAD = 1e-6
VOCAB = 47

ZOO["gpt_pipelined"] = (
    lambda pkg: lambda ff, b: (j_bert if pkg is J else t_bert).gpt_pipelined(
        ff, b, seq_len=S, hidden=D, layers=L, heads=HEADS,
        vocab_size=VOCAB),
    _tokens(VOCAB, S), "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY", VOCAB)


def _stacks(causal: bool, use_flash: bool):
    ops = []
    for pkg, kw in ((J, {"mesh_shape": {"data": 1}}), (T, {})):
        ff = pkg.FFModel(pkg.FFConfig(batch_size=B,
                                      use_flash_attention=use_flash, **kw),
                         **({} if pkg is J else {"device": "cpu"}))
        x = ff.create_tensor([B, S, D], name="x")
        ff.transformer_pipeline_stack(x, L, HEADS, causal=causal,
                                      name="blocks")
        ops.append(ff.get_op_by_name("blocks"))
    return ops


def _draw(op):
    """Weights around their init (biases and norms perturbed), an input
    and an output cotangent."""
    rs = np.random.RandomState(7)
    w = {}
    for spec in op.weight_specs():
        if spec.init == "glorot" or spec.init is None:
            fan_in, fan_out = spec.fan
            lim = np.sqrt(6.0 / (fan_in + fan_out))
            w[spec.name] = rs.uniform(-lim, lim, spec.shape)
        else:
            w[spec.name] = (spec.init == "one") + 0.1 * rs.randn(*spec.shape)
    w = {k: v.astype(np.float32) for k, v in w.items()}
    return (w, rs.randn(B, S, D).astype(np.float32),
            rs.randn(B, S, D).astype(np.float32))


def _port_run(op, w, x, r):
    xt = torch.tensor(x, requires_grad=True)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    y = op.forward(p, [xt])[0]
    torch.sum(y * torch.as_tensor(r)).backward()
    return y.detach(), {"x": xt.grad, **{k: v.grad for k, v in p.items()}}


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "bidirectional"])
@pytest.mark.parametrize("route", ["flash", "einsum"])
def test_stack_matches_jax(route, causal, monkeypatch):
    monkeypatch.setenv("FF_FORCE_FLASH_ATTENTION", "1")
    jop, top = _stacks(causal, route == "flash")
    assert {w.name: w.shape for w in top.weight_specs()} == \
        {w.name: w.shape for w in jop.weight_specs()}
    w, x, r = _draw(jop)

    def f(x, p):
        y = jop.forward(p, [x])[0]
        return jnp.sum(y * r), y
    (_, jy), (jgx, jgp) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()})
    launches = []
    from flexflow_tpu_torch.ops import kernels
    flash = kernels.flash_attention
    monkeypatch.setattr(kernels, "flash_attention",
                        lambda *a: launches.append(1) or flash(*a))
    y, grads = _port_run(top, w, x, r)
    assert len(launches) == (L if route == "flash" else 0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **OUT_TOL)
    want = {"x": np.asarray(jgx), **{k: np.asarray(v)
                                     for k, v in jgp.items()}}
    # the key bias adds q . bk to a whole query row, which the softmax
    # drops: its gradient is zero, and both packages return rounding noise
    top_grad = max(np.abs(v).max() for v in want.values())
    for got in (grads["bk"].numpy(), want.pop("bk")):
        assert np.abs(got).max() <= ZERO_GRAD * top_grad
    for k, ref in want.items():
        np.testing.assert_allclose(grads[k].numpy(), ref, rtol=0,
                                   atol=GRAD_REL * np.abs(ref).max(),
                                   err_msg=k)


def test_stack_equals_unrolled_blocks_on_separate_weights():
    """The stacked op against L ``_block`` calls on per-layer leaves of
    the same values: the output, and each layer's gradient in its slice
    of the stacked leaf, bitwise."""
    _, top = _stacks(True, True)
    w, x, r = _draw(top)
    y, grads = _port_run(top, w, x, r)
    layers = [{k: torch.tensor(v[i], requires_grad=True)
               for k, v in w.items()} for i in range(L)]
    xt = torch.tensor(x, requires_grad=True)
    h = xt
    for p in layers:
        h = _block(p, h, HEADS, True)
    torch.sum(h * torch.as_tensor(r)).backward()
    assert torch.equal(h.detach(), y)
    assert torch.equal(xt.grad, grads["x"])
    for i, p in enumerate(layers):
        for k, leaf in p.items():
            assert torch.equal(leaf.grad, grads[k][i]), f"{k}[{i}]"


@pytest.fixture(scope="module")
def pair():
    yield from zoo_pair("gpt_pipelined")


def test_gpt_pipelined_logits_loss_and_every_gradient_match_jax(pair):
    _, _, tff, _, _, _, _ = pair
    assert tff.weight_shapes()["blocks"]["w1"] == (L, D, 4 * D)
    check_logits_loss_and_gradients(pair)


def test_gpt_pipelined_three_sgd_steps_through_fit_match_jax(pair):
    check_three_sgd_steps(pair)


def test_params_from_jax_checks_the_stacked_depth(pair):
    """params_from_jax carries the stacked (L, ...) weights, and refuses a
    stack of another depth by name and shape."""
    from flexflow_tpu_torch.convert import params_from_jax
    from test_torch_zoo import _np_tree

    _, jff, tff, _, _, _, _ = pair
    good = _np_tree(jff.params)
    assert params_from_jax(good, "cpu", torch.float32,
                           model=tff)["blocks"]["wq"].shape == (L, D, D)
    bad = {op: dict(ws) for op, ws in good.items()}
    bad["blocks"]["w1"] = bad["blocks"]["w1"][:1]
    with pytest.raises(ValueError, match="blocks.w1"):
        params_from_jax(bad, "cpu", torch.float32, model=tff)
