"""The PyTorch port's recurrent ops (LSTM, GRU) and the NMT seq2seq model
against the JAX package.

Each op (batch 3, 7 steps, input 12, hidden 10) runs in both packages
from one numpy draw of its weights, with and without
``return_sequences``: the output and the gradient of the input and every
weight. ``nmt_seq2seq`` (2 + 2 LSTM layers, embed = hidden 16, vocab 41,
source 5, target 6) is held to JAX as the zoo models are
(tests/test_torch_zoo.py: logits, loss, every gradient, 3 SGD steps
through ``fit``, ``evaluate``).

Tolerances, f32: outputs 1e-5; gradients 1e-4 of their largest value;
weights after 3 steps 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.models import nmt as j_nmt
import flexflow_tpu_torch as T
from flexflow_tpu_torch.models import nmt as t_nmt
from test_torch_zoo import (ZOO, check_logits_loss_and_gradients,
                            check_three_sgd_steps, zoo_pair)

B, S, DIN, H = 3, 7, 12, 10
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4
NMT = dict(src_len=5, tgt_len=6, embed_size=16, hidden_size=16,
           vocab_size=41, num_layers=2)


def _nmt_feed(rs, n):
    return {"src_tokens": rs.randint(0, NMT["vocab_size"],
                                     (n, NMT["src_len"])).astype(np.int32),
            "tgt_tokens": rs.randint(0, NMT["vocab_size"],
                                     (n, NMT["tgt_len"])).astype(np.int32)}


ZOO["nmt_seq2seq"] = (
    lambda pkg: lambda ff, b: (lambda r: ((r[0], r[1]), r[2]))(
        (j_nmt if pkg is J else t_nmt).nmt_seq2seq(ff, b, **NMT)),
    _nmt_feed, "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY", NMT["vocab_size"])


def _ops(kind: str, return_sequences: bool):
    ops = []
    for pkg, kw in ((J, {"mesh_shape": {"data": 1}}), (T, {})):
        ff = pkg.FFModel(pkg.FFConfig(batch_size=B, **kw),
                         **({} if pkg is J else {"device": "cpu"}))
        x = ff.create_tensor([B, S, DIN], name="x")
        getattr(ff, kind)(x, H, return_sequences=return_sequences,
                          name="rnn")
        ops.append(ff.get_op_by_name("rnn"))
    return ops


@pytest.mark.parametrize("return_sequences", [True, False],
                         ids=["sequences", "last"])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_recurrent_op_matches_jax(kind, return_sequences):
    """Output and the gradient of sum(out * r) by the input and every
    weight (bias perturbed off its zero init)."""
    jop, top = _ops(kind, return_sequences)
    assert [w.name for w in top.weight_specs()] == \
        [w.name for w in jop.weight_specs()]
    rs = np.random.RandomState(1)
    w = {}
    for spec in jop.weight_specs():
        w[spec.name] = (0.4 * rs.randn(*spec.shape)).astype(np.float32)
    x = rs.randn(B, S, DIN).astype(np.float32)
    r = rs.randn(*top.outputs[0].dims).astype(np.float32)

    def f(x, p):
        y = jop.forward(p, [x])[0]
        return jnp.sum(y * r), y
    (_, jy), (jgx, jgp) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()})
    xt = torch.tensor(x, requires_grad=True)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    y = top.forward(p, [xt])[0]
    assert tuple(y.shape) == top.outputs[0].dims
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               **OUT_TOL)
    torch.sum(y * torch.as_tensor(r)).backward()
    want = {"x": np.asarray(jgx), **{k: np.asarray(v)
                                     for k, v in jgp.items()}}
    got = {"x": xt.grad.numpy(), **{k: v.grad.numpy()
                                    for k, v in p.items()}}
    for k, ref in want.items():
        np.testing.assert_allclose(got[k], ref, rtol=0,
                                   atol=GRAD_REL * np.abs(ref).max(),
                                   err_msg=k)


def test_recurrent_carry_stays_in_the_input_dtype():
    """A bf16 input keeps a bf16 carry and output, as the JAX scan."""
    _, top = _ops("lstm", True)
    rs = np.random.RandomState(2)
    p = {s.name: torch.tensor(0.3 * rs.randn(*s.shape),
                              dtype=torch.bfloat16)
         for s in top.weight_specs()}
    x = torch.tensor(rs.randn(B, S, DIN), dtype=torch.bfloat16)
    assert top.forward(p, [x])[0].dtype == torch.bfloat16


@pytest.fixture(scope="module")
def pair():
    yield from zoo_pair("nmt_seq2seq")


def test_nmt_logits_loss_and_every_gradient_match_jax(pair):
    _, _, tff, _, _, _, _ = pair
    assert sum(op.op_type == T.OperatorType.OP_LSTM for op in tff.ops) == 4
    check_logits_loss_and_gradients(pair)


def test_nmt_three_sgd_steps_through_fit_match_jax(pair):
    check_three_sgd_steps(pair)
