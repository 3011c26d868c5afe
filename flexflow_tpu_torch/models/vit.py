"""Vision Transformer (patchify-conv + pre-norm encoder) — a copy of the
JAX package's ``models/vit.py`` against the port's FFModel.

Net-new model family vs the reference zoo (its vision workloads are all
CNNs — examples/cpp/{AlexNet,ResNet,InceptionV3}); built entirely from
existing graph ops: Conv2D patch embedding (kernel=stride=patch),
reshape/transpose to (B, N, hidden), pre-norm MHA blocks with RoPE over
the patch sequence (rotary ViT — no learned positional table needed, and
positions stay absolute under sequence sharding), GELU MLP, mean-pool
head. Shapes default head_dim-64; pass heads to hit head_dim 128 on TPU
(see the round-3 MFU probe finding).
"""

from __future__ import annotations

from flexflow_tpu_torch.ffconst import ActiMode


def vit(ff, batch_size: int, image_size: int = 224,
        patch_size: int = 16, hidden: int = 384, layers: int = 6,
        heads: int = 6, mlp_ratio: int = 4, num_classes: int = 1000,
        channels: int = 3):
    assert image_size % patch_size == 0, \
        f"image {image_size} not divisible by patch {patch_size}"
    grid = image_size // patch_size
    n_patches = grid * grid

    x = ff.create_tensor([batch_size, channels, image_size, image_size],
                         name="input")
    # non-overlapping patch embedding: one conv with kernel == stride
    t = ff.conv2d(x, hidden, patch_size, patch_size, patch_size, patch_size,
                  0, 0, name="patch_embed")
    # (B, hidden, g, g) -> (B, N, hidden)
    t = ff.reshape(t, [batch_size, hidden, n_patches], name="patch_flat")
    t = ff.transpose(t, [0, 2, 1], name="patch_seq")
    for i in range(layers):
        a = ff.layer_norm(t, name=f"ln1_{i}")
        a = ff.multihead_attention(a, a, a, hidden, heads, rope=True,
                                   name=f"attn_{i}")
        t = ff.add(t, a, name=f"res1_{i}")
        m = ff.layer_norm(t, name=f"ln2_{i}")
        m = ff.dense(m, hidden * mlp_ratio, ActiMode.AC_MODE_GELU,
                     name=f"mlp_up_{i}")
        m = ff.dense(m, hidden, name=f"mlp_down_{i}")
        t = ff.add(t, m, name=f"res2_{i}")
    t = ff.layer_norm(t, name="ln_f")
    t = ff.mean(t, [1], name="pool")          # mean over patches
    logits = ff.dense(t, num_classes, name="head")
    return x, logits
