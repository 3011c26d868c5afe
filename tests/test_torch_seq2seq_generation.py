"""``FFModel.generate_seq2seq`` and the copied transformer builders in the
PyTorch port against the JAX package's.

``seq2seq_lm`` (hidden 32, 2 + 2 layers, 4 heads, vocab 61, f32) is built
in both packages with the same weights. Limits: teacher-forced logits
within 1e-5; greedy tokens identical, with the default BOS prompt and with
a given prompt; ``encode_kv`` / ``cross_forward_cached`` within 1e-6; the
other builders of ``models/transformer.py`` (``attention_encoder_decoder``,
``build_reference_transformer``, ``build_seq2seq_transformer``) give
JAX's logits and MSE loss within 1e-5. Sampled streams are checked for
shape, range, eos / pad and seed reproducibility (their bits are not
JAX's; tests/test_torch_generation.py checks the sampler by
distribution).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.ffconst import LossType as JLoss
from flexflow_tpu.models import transformer as jtr
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.ffconst import LossType
from flexflow_tpu_torch.models import transformer as ttr
from test_torch_zoo import _np_tree, numpy_init

VOCAB = 61
S2S = dict(src_len=7, tgt_len=6, hidden=32, layers=2, heads=4,
           vocab_size=VOCAB)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the default pool's threads spin against the
    suite's workers); JAX's models take numpy-drawn weights."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        numpy_init(mp)
        yield
    torch.set_num_threads(n)


def _build(build, batch=2, optimizer=False, **kw):
    """``build(ff, batch, **kw) -> out or (..., out)`` in both packages
    with the same weights; with ``optimizer`` compiled for training (SGD,
    MSE)."""
    jff = JModel(JConfig(batch_size=batch, mesh_shape={"data": 1}))
    tff = FFModel(FFConfig(batch_size=batch), device="cpu")
    outs = [build(m, batch, **kw) for m in (jff, tff)]
    outs = [o[-1] if isinstance(o, tuple) else o for o in outs]
    if optimizer:
        jff.compile(JSGD(lr=0.01),
                    JLoss.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE, [],
                    final_tensor=outs[0])
        tff.compile(SGDOptimizer(lr=0.01),
                    LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE, [],
                    final_tensor=outs[1])
    else:
        jff.compile(final_tensor=outs[0])
        tff.compile(final_tensor=outs[1])
    tff.params = params_from_jax(_np_tree(jff.params), "cpu", torch.float32,
                                 model=tff)
    return jff, tff


@pytest.fixture(scope="module")
def pair():
    return _build(lambda ff, b: ttr.seq2seq_lm(ff, b, **S2S)
                  if isinstance(ff, FFModel) else jtr.seq2seq_lm(ff, b, **S2S))


SRC = np.random.RandomState(0).randint(1, VOCAB, (2, 7)).astype(np.int32)


def test_teacher_forced_logits_match_jax(pair):
    jff, tff = pair
    tgt = np.random.RandomState(1).randint(1, VOCAB, (2, 6)).astype(np.int32)
    want = np.asarray(jff.predict({"src": SRC, "tgt": tgt}))
    got = tff.predict({"src": SRC, "tgt": tgt}).numpy()
    assert got.shape == (2, 6, VOCAB)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("prompt", [None, 3], ids=["bos", "prompt"])
def test_greedy_tokens_match_jax(pair, prompt):
    jff, tff = pair
    tgt = None
    if prompt:
        tgt = np.random.RandomState(2).randint(1, VOCAB, (2, prompt)).astype(
            np.int32)
    want = jff.generate_seq2seq(SRC, tgt, max_new_tokens=9)
    got = tff.generate_seq2seq(SRC, tgt, max_new_tokens=9)
    assert got.dtype == np.int32
    assert got.shape == (2, (prompt or 1) + 9)
    np.testing.assert_array_equal(got, want)
    if not prompt:
        assert (got[:, 0] == 1).all()


def test_eos_and_sampling_shapes(pair):
    """Greedy with an eos the stream emits: JAX's tokens, pads after it.
    Sampled (temperature 1, top_k 5): the shape, tokens in range, the same
    seed the same tokens, and pads after an eos."""
    jff, tff = pair
    greedy = tff.generate_seq2seq(SRC, max_new_tokens=9)
    eos = int(greedy[0, 3])
    want = jff.generate_seq2seq(SRC, max_new_tokens=9, eos_token_id=eos,
                                pad_token_id=0)
    got = tff.generate_seq2seq(SRC, max_new_tokens=9, eos_token_id=eos,
                               pad_token_id=0)
    np.testing.assert_array_equal(got, want)
    kw = dict(max_new_tokens=9, temperature=1.0, top_k=5, eos_token_id=2,
              seed=7)
    a = tff.generate_seq2seq(SRC, **kw)
    assert a.shape == (2, 10) and ((a >= 0) & (a < VOCAB)).all()
    np.testing.assert_array_equal(a, tff.generate_seq2seq(SRC, **kw))
    for row in a[:, 1:]:
        hits = np.where(row == 2)[0]
        if hits.size:
            assert (row[hits[0] + 1:] == 0).all()


def test_encode_kv_and_cross_forward_cached_match_jax(pair):
    jff, tff = pair
    name = "s2s_dec_cross_1"
    jop, top = jff.get_op_by_name(name), tff.get_op_by_name(name)
    rs = np.random.RandomState(5)
    enc = rs.randn(2, 7, 32).astype(np.float32)
    dec = rs.randn(2, 3, 32).astype(np.float32)
    jkv = jop.encode_kv(jff.params[name], jnp.asarray(enc))
    tkv = top.encode_kv(tff.params[name], torch.as_tensor(enc))
    for part in ("k", "v"):
        np.testing.assert_allclose(tkv[part].numpy(), np.asarray(jkv[part]),
                                   rtol=1e-6, atol=1e-6)
    jout = jop.cross_forward_cached(jff.params[name], [jnp.asarray(dec)] * 3,
                                    jkv)
    tout = top.cross_forward_cached(tff.params[name],
                                    [torch.as_tensor(dec)] * 3, tkv)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)


def _one_layer(ff, b):
    """attention_encoder_decoder alone: one reference layer on two
    streams, summed into one output."""
    x1 = ff.create_tensor([b, 5, 16], name="x1")
    x2 = ff.create_tensor([b, 5, 16], name="x2")
    mod = ttr if isinstance(ff, FFModel) else jtr
    t1, t2 = mod.attention_encoder_decoder(ff, x1, x2, 16, 2, 0)
    return ff.add(t1, t2, name="sum")


def _reference(ff, b):
    mod = ttr if isinstance(ff, FFModel) else jtr
    cfg = mod.TransformerConfig(hidden_size=16, embedding_size=16,
                                num_heads=2, num_layers=2, sequence_length=5)
    return mod.build_reference_transformer(ff, b, cfg)


def _seq2seq_hidden(ff, b):
    mod = ttr if isinstance(ff, FFModel) else jtr
    return mod.build_seq2seq_transformer(ff, b, src_len=6, tgt_len=4,
                                         hidden=16, layers=2, heads=2,
                                         vocab_size=0)


@pytest.mark.parametrize("build,feeds,out_shape", [
    (_one_layer, {"x1": (5, 16), "x2": (5, 16)}, (5, 16)),
    (_reference, {"input": (5, 16)}, (5, 1)),
    (_seq2seq_hidden, {"src": (6, 16), "tgt": (4, 16)}, (4, 16)),
], ids=["attention_encoder_decoder", "build_reference_transformer",
        "build_seq2seq_transformer"])
def test_copied_builders_forward_and_loss_match_jax(build, feeds, out_shape):
    jff, tff = _build(build, batch=2, optimizer=True)
    rs = np.random.RandomState(9)
    batch = {k: rs.randn(2, *s).astype(np.float32) for k, s in feeds.items()}
    batch["label"] = rs.randn(2, *out_shape).astype(np.float32)
    jloss, _, jlogits = jff.evaluate(batch)
    tloss, _, tlogits = tff.evaluate(batch)
    assert tuple(tlogits.shape) == (2,) + out_shape
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(tloss, jloss, **TOL)
