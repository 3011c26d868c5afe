"""Llama-family decoder: RMSNorm pre-norm, RoPE, grouped-query attention,
SwiGLU MLP, no biases — a copy of the JAX package's ``models/llama.py``
builder, against the port's FFModel."""

from __future__ import annotations

from flexflow_tpu_torch.ffconst import DataType


def swiglu(ff, x, hidden: int, ffn_hidden: int, i: int):
    """SwiGLU MLP: (silu(x W_gate) * x W_up) W_down, silu = x * sigmoid(x)."""
    g = ff.dense(x, ffn_hidden, use_bias=False, name=f"ffn_gate_{i}")
    s = ff.multiply(g, ff.sigmoid(g, name=f"ffn_sig_{i}"),
                    name=f"ffn_silu_{i}")
    u = ff.dense(x, ffn_hidden, use_bias=False, name=f"ffn_up_{i}")
    h = ff.multiply(s, u, name=f"ffn_gated_{i}")
    return ff.dense(h, hidden, use_bias=False, name=f"ffn_down_{i}")


def llama_lm(ff, batch_size: int, seq_len: int = 256,
             hidden: int = 512, layers: int = 4, heads: int = 4,
             kv_heads: int = 0, ffn_hidden: int = 0,
             vocab_size: int = 32_000, rope_theta: float = 10000.0,
             tie_embeddings: bool = False):
    """Decoder-only causal LM in the Llama shape. kv_heads=0 -> MHA;
    kv_heads < heads -> grouped-query attention. ffn_hidden defaults to
    the Llama-style ~8/3 * hidden rounded to a multiple of 128."""
    if tie_embeddings:
        raise NotImplementedError(
            "tied embeddings need FFModel.tie_weights, which is not ported "
            "yet (ROADMAP.md queue 1, item 2)")
    if not ffn_hidden:
        ffn_hidden = max(128, (8 * hidden // 3 + 127) // 128 * 128)
    tokens = ff.create_tensor([batch_size, seq_len], dtype=DataType.DT_INT32,
                              name="input")
    t = ff.embedding(tokens, vocab_size, hidden, name="tok_embed")
    for i in range(layers):
        a = ff.rms_norm(t, name=f"ln1_{i}")
        a = ff.multihead_attention(
            a, a, a, hidden, heads, causal=True, bias=False,
            num_kv_heads=kv_heads, rope=True, rope_theta=rope_theta,
            name=f"attn_{i}")
        t = ff.add(t, a, name=f"res1_{i}")
        f = swiglu(ff, ff.rms_norm(t, name=f"ln2_{i}"), hidden, ffn_hidden, i)
        t = ff.add(t, f, name=f"res2_{i}")
    t = ff.rms_norm(t, name="ln_f")
    logits = ff.dense(t, vocab_size, use_bias=False, name="lm_head")
    return tokens, logits
