"""BERT / GPT-style language models on the native API — a copy of the JAX
package's ``models/bert.py`` against the port's FFModel. The MoE layers
of ``gpt_lm`` and the pipelined stack of ``gpt_pipelined`` are not ported
yet (ROADMAP.md queue 1, item 4): both raise.

Reference analog: examples/python/native/bert_proxy_native.py (BERT-proxy
encoder stack). Adds the decoder-only GPT/Llama-style variant (RMSNorm +
causal attention + MoE option) — the modern configs the TPU rebuild targets
(BASELINE.json: "GPT-3 / Llama-3-8B ... on v5p pod").
"""

from __future__ import annotations

from flexflow_tpu_torch.config import ROADMAP_OPS, not_ported
from flexflow_tpu_torch.ffconst import ActiMode, DataType
from flexflow_tpu_torch.models.transformer import encoder_block


def bert_base(ff, batch_size: int, seq_len: int = 128,
              hidden: int = 768, layers: int = 12, heads: int = 12,
              vocab_size: int = 30_522, num_classes: int = 2):
    """BERT-base encoder with a classification head (proxy config matches
    bert_proxy_native.py: H768 L12 A12)."""
    tokens = ff.create_tensor([batch_size, seq_len], dtype=DataType.DT_INT32,
                              name="input")
    t = ff.embedding(tokens, vocab_size, hidden, name="tok_embed")
    pos = ff.create_tensor([batch_size, seq_len], dtype=DataType.DT_INT32,
                           name="positions")
    p = ff.embedding(pos, seq_len, hidden, name="pos_embed")
    t = ff.add(t, p, name="embed_add")
    for i in range(layers):
        t = encoder_block(ff, t, hidden, heads, 4, i, causal=False)
    t = ff.layer_norm(t, name="ln_f")
    cls = ff.mean(t, dims=[1], name="pool")  # mean-pool (CLS proxy)
    out = ff.dense(cls, num_classes, name="cls_head")
    return tokens, pos, out


def gpt_lm(ff, batch_size: int, seq_len: int = 256,
           hidden: int = 512, layers: int = 8, heads: int = 8,
           vocab_size: int = 32_000, moe_every: int = 0,
           num_experts: int = 8):
    """Decoder-only causal LM; set moe_every=2 for a GShard-style MoE stack
    (not ported yet: raises)."""
    if moe_every:
        raise not_ported(f"gpt_lm(moe_every={moe_every}): the MoE layer",
                         where=ROADMAP_OPS)
    tokens = ff.create_tensor([batch_size, seq_len], dtype=DataType.DT_INT32,
                              name="input")
    t = ff.embedding(tokens, vocab_size, hidden, name="tok_embed")
    for i in range(layers):
        a = ff.rms_norm(t, name=f"ln1_{i}")
        a = ff.multihead_attention(a, a, a, hidden, heads, causal=True,
                                   bias=False, name=f"attn_{i}")
        t = ff.add(t, a, name=f"res1_{i}")
        f = ff.rms_norm(t, name=f"ln2_{i}")
        f = ff.dense(f, hidden * 4, ActiMode.AC_MODE_GELU, name=f"ffn1_{i}")
        f = ff.dense(f, hidden, name=f"ffn2_{i}")
        t = ff.add(t, f, name=f"res2_{i}")
    t = ff.rms_norm(t, name="ln_f")
    logits = ff.dense(t, vocab_size, use_bias=False, name="lm_head")
    return tokens, logits


def gpt_pipelined(ff, batch_size: int, seq_len: int = 256,
                  hidden: int = 512, layers: int = 8, heads: int = 8,
                  vocab_size: int = 32_000,
                  num_microbatches=None):
    """Decoder-only causal LM with the layer stack as ONE pipelined op
    (ops/pipelined.py): under a 'pipe' mesh axis the blocks run as a GPipe
    ring; single-device it is a lax.scan over layers. The graph-level PP
    counterpart of the reference's NMT pipeline (nmt/rnn.h:21-63). Not
    ported yet: raises."""
    raise not_ported("gpt_pipelined: the pipelined layer stack",
                     where=ROADMAP_OPS)
