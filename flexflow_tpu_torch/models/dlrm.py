"""DLRM — deep learning recommendation model — a copy of the JAX
package's ``models/dlrm.py`` against the port's FFModel.

Reference: examples/cpp/DLRM/dlrm.cc:77+ and run_summit.sh (Summit config:
512/GPU batch, up to 24 x 1M-row x 64-dim embedding tables, mlp-bot
64-512-512-64, mlp-top 576-1024-1024-1024-1). The embedding tables are the
parallelization showcase: the reference places them per-GPU via hetero
strategies; here each table's ParallelConfig can shard its output dim over
'model' (vocab-partitioned lookup under GSPMD).
"""

from __future__ import annotations

from typing import List, Sequence

from flexflow_tpu_torch.ffconst import ActiMode, AggrMode, DataType


def _mlp(ff, t, sizes: Sequence[int], prefix: str, sigmoid_last=False):
    for i, s in enumerate(sizes):
        last = i == len(sizes) - 1
        act = (ActiMode.AC_MODE_SIGMOID if (last and sigmoid_last)
               else ActiMode.AC_MODE_RELU)
        t = ff.dense(t, s, act, name=f"{prefix}_{i}")
    return t


def dlrm(ff, batch_size: int,
         embedding_size: int = 64,
         embedding_entries: int = 100_000,
         num_tables: int = 8,
         indices_per_table: int = 1,
         dense_dim: int = 64,
         mlp_bot: Sequence[int] = (512, 512, 64),
         mlp_top: Sequence[int] = (1024, 1024, 1024, 1)):
    """Returns (dense_input, sparse_inputs, output)."""
    dense_in = ff.create_tensor([batch_size, dense_dim], name="dense_input")
    sparse_ins: List = []
    emb_outs: List = []
    for i in range(num_tables):
        s = ff.create_tensor([batch_size, indices_per_table],
                             dtype=DataType.DT_INT32, name=f"sparse_{i}")
        sparse_ins.append(s)
        e = ff.embedding(s, embedding_entries, embedding_size,
                         AggrMode.AGGR_MODE_SUM, name=f"emb_{i}")
        emb_outs.append(e)
    x = _mlp(ff, dense_in, mlp_bot, "bot")
    # interaction: concat embeddings + bottom-MLP output (reference dlrm.cc
    # interact_features 'cat' mode)
    t = ff.concat([x] + emb_outs, axis=1, name="interact")
    out = _mlp(ff, t, mlp_top, "top", sigmoid_last=True)
    return dense_in, sparse_ins, out
