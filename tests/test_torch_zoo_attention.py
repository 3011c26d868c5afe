"""The attention models of the PyTorch port's zoo against the JAX package:
``vit`` (image 32, patch 8, head dim 64), ``bert_base`` (hidden 64, 2
layers, head dim 64) and ``gpt_lm`` (causal), with the checks and
tolerances of tests/test_torch_zoo.py (which holds the convolutional and
MLP models); the JAX side runs its Pallas flash kernels in interpret mode
(``FF_FORCE_FLASH_ATTENTION=1``). And a Llama with tied embeddings
(``llama_lm(tie_embeddings=True)``) serving the JAX engine's greedy
tokens.
"""

import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.models import llama as j_llama
import flexflow_tpu_torch as T
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import llama as t_llama
from test_torch_zoo import (_np_tree, check_logits_loss_and_gradients,
                            check_three_sgd_steps, zoo_pair)


@pytest.fixture(scope="module", params=["vit", "bert_base", "gpt_lm"])
def pair(request):
    yield from zoo_pair(request.param)


def test_logits_loss_and_every_gradient_match_jax(pair):
    check_logits_loss_and_gradients(pair)


def test_three_sgd_steps_through_fit_match_jax(pair):
    check_three_sgd_steps(pair)


LLAMA = dict(seq_len=32, hidden=64, layers=2, heads=4, kv_heads=2,
             vocab_size=97, tie_embeddings=True)


def test_tied_llama_serves_jax_engines_greedy_tokens():
    """``llama_lm(tie_embeddings=True)`` ties lm_head to tok_embed
    (transposed) in both packages; the port's engine, from JAX's weights,
    serves the JAX engine's greedy tokens."""
    jff = J.FFModel(J.FFConfig(batch_size=2, mesh_shape={"data": 1}))
    _, logits = j_llama.llama_lm(jff, 2, **LLAMA)
    jff.compile(final_tensor=logits)
    tff = T.FFModel(T.FFConfig(batch_size=2), device="cpu")
    _, logits = t_llama.llama_lm(tff, 2, **LLAMA)
    tff.compile(final_tensor=logits)
    assert tff._tied == {("lm_head", "kernel"):
                         ("tok_embed", "kernel", "transpose")}
    assert tff.params["lm_head"] == {}
    tff.params = params_from_jax(_np_tree(jff.params), "cpu",
                                 torch.float32, model=tff)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, 97, n).astype(np.int32) for n in (5, 11, 3)]
    kw = dict(serve_slots=2, kv_page_size=4, max_seq_len=32)
    jeng = jff.make_serving_engine(paged_attention_impl="einsum", **kw)
    teng = tff.make_serving_engine(**kw)
    jout = [r.output for r in jeng.run(prompts, max_new_tokens=6)]
    tout = [r.output for r in teng.run(prompts, max_new_tokens=6)]
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
