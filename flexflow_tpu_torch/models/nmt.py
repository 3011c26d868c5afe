"""NMT: LSTM encoder-decoder seq2seq — a copy of the JAX package's
``models/nmt.py`` against the port's FFModel.

Reference: the standalone nmt/ subsystem (rnn.cu, lstm.cu, nmt.cc:31-99 —
2 layers, seq 20->40, hidden/embed 2048, vocab 20k, hand-scheduled pipeline
over per-(layer,timestep) ParallelConfigs). Here the model is ordinary graph
ops, and the SoftmaxDP data-parallel softmax is just the softmax op under a
data-parallel strategy.
"""

from __future__ import annotations

from flexflow_tpu_torch.ffconst import DataType


def nmt_seq2seq(ff, batch_size: int,
                src_len: int = 20, tgt_len: int = 20,
                embed_size: int = 2048, hidden_size: int = 2048,
                vocab_size: int = 20_000, num_layers: int = 2):
    """Returns (src_input, tgt_input, logits). Teacher-forced decoder: encoder
    final state feeds the decoder via concat of encoder context (simplified
    vs cuDNN state-passing; the reference also feeds full chunked states)."""
    src = ff.create_tensor([batch_size, src_len], dtype=DataType.DT_INT32,
                           name="src_tokens")
    tgt = ff.create_tensor([batch_size, tgt_len], dtype=DataType.DT_INT32,
                           name="tgt_tokens")
    enc = ff.embedding(src, vocab_size, embed_size, name="src_embed")
    for i in range(num_layers):
        enc = ff.lstm(enc, hidden_size, name=f"enc_lstm_{i}")
    # context = mean over source positions (stand-in for final-state passing)
    ctx = ff.mean(enc, dims=[1], keepdims=True, name="enc_context")

    dec = ff.embedding(tgt, vocab_size, embed_size, name="tgt_embed")
    for i in range(num_layers):
        dec = ff.lstm(dec, hidden_size, name=f"dec_lstm_{i}")
    # broadcast-add context to every decoder position
    dec = ff.add(dec, ctx, name="ctx_add")
    logits = ff.dense(dec, vocab_size, name="vocab_proj")
    return src, tgt, logits
