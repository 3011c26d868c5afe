"""Transformer builders (copies of the JAX package's
``models/transformer.py`` ``encoder_block`` and
``build_encoder_classifier``, the flagship trained model)."""

from __future__ import annotations

from flexflow_tpu_torch.ffconst import ActiMode


def encoder_block(ff, x, hidden, heads, ffn_mult, i, causal=False,
                  dropout=0.0):
    """Pre-LN block: x + MHA(LN(x)); x + FFN(LN(x)) with GELU."""
    a = ff.layer_norm(x, name=f"ln1_{i}")
    a = ff.multihead_attention(a, a, a, hidden, heads, dropout=dropout,
                               causal=causal, name=f"attn_{i}")
    x = ff.add(x, a, name=f"res1_{i}")
    f = ff.layer_norm(x, name=f"ln2_{i}")
    f = ff.dense(f, hidden * ffn_mult, ActiMode.AC_MODE_GELU, name=f"ffn1_{i}")
    f = ff.dense(f, hidden, name=f"ffn2_{i}")
    return ff.add(x, f, name=f"res2_{i}")


def build_encoder_classifier(ff, batch_size: int, seq_len: int = 128,
                             hidden: int = 512, layers: int = 6, heads: int = 8,
                             ffn_mult: int = 4, num_classes: int = 16,
                             causal: bool = False):
    x = ff.create_tensor([batch_size, seq_len, hidden], name="input")
    t = x
    fused = getattr(ff.config, "use_fused_ln", False)
    # one graph, two lowerings of each residual-add + following layernorm
    # pair: fused (FFConfig.use_fused_ln) or separate ops. Same math, same
    # norm-parameter count (2L+1) either way; in the fused form the last
    # add_ln's normed output IS ln_f.
    n = ff.layer_norm(t, name="ln1_0") if fused else None
    for i in range(layers):
        if fused:
            a = ff.multihead_attention(n, n, n, hidden, heads, causal=causal,
                                       name=f"attn_{i}")
            t, n = ff.add_layer_norm(t, a, name=f"res1_ln2_{i}")
            f = ff.dense(n, hidden * ffn_mult, ActiMode.AC_MODE_GELU,
                         name=f"ffn1_{i}")
            f = ff.dense(f, hidden, name=f"ffn2_{i}")
            t, n = ff.add_layer_norm(t, f, name=f"res2_ln1_{i}")
        else:
            t = encoder_block(ff, t, hidden, heads, ffn_mult, i, causal)
    t = n if fused else ff.layer_norm(t, name="ln_f")
    t = ff.mean(t, dims=[1], name="pool")
    out = ff.dense(t, num_classes, name="head")
    return x, out
