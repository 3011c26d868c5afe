"""The port's sequence parallelism (ring and Ulysses attention) across gloo
ranks, against the JAX package on the conftest's 8 CPU devices.

Ranks run ``tests/torch_sp_worker.py`` through the port's launcher
(``tests/torch_ranks.py``): one world of 2 and one of 4, each bounded by
``SPAWN_TIMEOUT``, started before the JAX references are computed in this
process so the two overlap. JAX's ring runs its Pallas kernels in
interpret mode (``FF_FORCE_FLASH_ATTENTION=1``, as
``tests/test_sequence_parallel.py:189`` runs it); its weights are numpy
draws (``test_torch_zoo.numpy_init``) carried into the port.

  * ``ring_attention`` (torch ops), ``ring_attention`` through kernels 1
    and 2 (their plain versions here) and ``ulysses_attention`` on 2 and 4
    ranks, causal and not, against JAX's flash ring under ``shard_map``
    (q / k / v (2, 32, 4, 32) f32); ``blockwise_attention`` against JAX's
    (8-key blocks). Outputs within 1e-5; dq / dk / dv within 1e-4 of
    their largest value.
  * the attention op (RoPE, GQA, causal, behind a dense) under
    ``{"data": 2, "seq": 2}`` and ``{"seq": 4}`` on every op, against JAX
    under the same mesh and strategy: predict, 3 SGD steps (MSE), losses
    and weights within 1e-5.
  * a 2-layer narrow ``llama_lm`` (hidden 128, 4 heads of 32 over 2 kv
    heads, RoPE, vocab 97, seq 64) under ``{"seq": 2}`` on every op:
    predict, then ``fit`` over 3 batches, against JAX under the same
    mesh — with ``sp_mode="ring"`` and ``"ulysses"`` (JAX's ring the
    reference of both); each rank's local q is (2, 32, 4, 32).
  * attention dropout in the ring and in Ulysses by distribution (JAX's
    threefry bits are not reproduced): applied, and the mean of 200 draws
    within JAX's own limits of the undropped output
    (``test_sp_attention_dropout_applied_and_unbiased``, which averages
    40: the port's mean of 40 sat at those limits by chance alone).
  * the ``ValueError``s: a bad ``sp_mode``, a sequence dim split over two
    mesh axes.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import LossType as JLoss
from flexflow_tpu import MetricsType as JMetrics
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu import SingleDataLoader as JLoader
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu.parallel import shard_map_compat
from flexflow_tpu.parallel.mesh import make_mesh as j_make_mesh
from flexflow_tpu.parallel.pconfig import ParallelConfig as JPC
from flexflow_tpu.parallel.ring_attention import \
    blockwise_attention as j_blockwise
from flexflow_tpu.parallel.ring_attention import ring_attention as j_ring
from test_torch_zoo import numpy_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_sp_worker.py")
sys.path.insert(0, os.path.dirname(WORKER))
import torch_ranks  # noqa: E402

SPAWN_TIMEOUT = 240
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
QKV = (2, 32, 4, 32)
MHA_ARCH = (2, 32, 128, 4, 2)              # batch, seq, hidden, heads, kv
LLAMA = dict(seq_len=64, hidden=128, layers=2, heads=4, kv_heads=2,
             vocab_size=97)
LLAMA_BATCH = 2
FNS = ("ring", "ring_flash", "ulysses")
MHA_MESHES = {"dp_sp": ({"data": 2, "seq": 2}, {"data": 0, "seq": 1}),
              "sp4": ({"seq": 4}, {"seq": 1})}

SCENARIOS = [
    dict(name="fns2", mode="fns", world=2),
    dict(name="llama_ring", mode="llama", world=2, sp_mode="ring",
         mesh={"seq": 2}, arch=LLAMA, batch=LLAMA_BATCH),
    dict(name="llama_ulysses", mode="llama", world=2, sp_mode="ulysses",
         mesh={"seq": 2}, arch=LLAMA, batch=LLAMA_BATCH),
    dict(name="fns4", mode="fns", world=4),
    dict(name="dropout", mode="dropout", world=4),
    dict(name="mha_dp_sp", mode="mha", world=4, arch=MHA_ARCH,
         mesh=MHA_MESHES["dp_sp"][0], axis_map=MHA_MESHES["dp_sp"][1]),
    dict(name="mha_sp4", mode="mha", world=4, arch=MHA_ARCH,
         mesh=MHA_MESHES["sp4"][0], axis_map=MHA_MESHES["sp4"][1]),
    dict(name="mha_dropout", mode="mha", world=4, arch=MHA_ARCH,
         mesh=MHA_MESHES["dp_sp"][0], axis_map=MHA_MESHES["dp_sp"][1],
         dropout=0.2),
    dict(name="two_axes", mode="mha", world=4, arch=MHA_ARCH,
         mesh={"seq": 2, "model": 2}, axis_map={"seq": 1, "model": 1},
         expect_error=True),
]


def _inputs():
    rs = np.random.RandomState(0)
    data = {n: rs.randn(*QKV).astype(np.float32)
            for n in ("q", "k", "v", "do")}
    # the dropout case: JAX's test_sequence_parallel.make_qkv(s=32)
    rs = np.random.RandomState(0)
    for n in ("dq", "dk", "dv"):
        data[n] = rs.randn(2, 32, 4, 8).astype(np.float32)
    b, s, d, _, _ = MHA_ARCH
    rs = np.random.RandomState(1)
    data["mx"] = rs.randn(b, s, d).astype(np.float32)
    data["my"] = rs.randn(b, s, d).astype(np.float32)
    rs = np.random.RandomState(2)
    n = 3 * LLAMA_BATCH
    data["lx"] = rs.randint(0, LLAMA["vocab_size"],
                            (n, LLAMA["seq_len"])).astype(np.int32)
    data["ly"] = rs.randint(0, LLAMA["vocab_size"],
                            (n, LLAMA["seq_len"])).astype(np.int32)
    return data


def _j_strategies(jff, mesh, am):
    for op in jff.ops:
        if op.inputs:
            jff.config.strategies[op.name] = JPC.from_axis_map(
                op.outputs[0].num_dims, mesh, am)


def _j_mha(mesh, am):
    b, s, d, h, kvh = MHA_ARCH
    jff = JModel(JConfig(batch_size=b, seed=5, mesh_shape=dict(mesh)))
    x = jff.create_tensor([b, s, d], name="x")
    t = jff.dense(x, d, name="pre")
    t = jff.multihead_attention(t, t, t, d, h, causal=True,
                                num_kv_heads=kvh, rope=True, name="mha")
    _j_strategies(jff, mesh, am)
    jff.compile(JSGD(lr=0.05), JLoss.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE, [],
                final_tensor=t)
    return jff


def _j_llama(mesh):
    jff = JModel(JConfig(batch_size=LLAMA_BATCH, seed=1,
                         mesh_shape=dict(mesh)))
    x, logits = j_llama_lm(jff, LLAMA_BATCH, **LLAMA)
    _j_strategies(jff, mesh, {"seq": 1})
    jff.compile(JSGD(lr=0.05), JLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                [JMetrics.METRICS_ACCURACY], final_tensor=logits)
    return jff, x


def _weights(jff):
    return {f"{op}.{w}": np.asarray(a) for op, ws in jff.params.items()
            for w, a in ws.items()}


def _j_ring_vjp(data, world, causal):
    """JAX's flash ring under shard_map over {"seq": world}: the output
    and the vjp of ``do``."""
    mesh = j_make_mesh({"seq": world})
    spec = P(None, "seq", None, None)
    f = shard_map_compat(
        lambda a, b, c: j_ring(a, b, c, "seq", causal=causal,
                               use_flash=True), mesh, (spec,) * 3, spec)

    def fg(q, k, v, do):
        o, pull = jax.vjp(f, q, k, v)
        return (o,) + pull(do)

    got = jax.jit(fg)(*(data[n] for n in ("q", "k", "v", "do")))
    return [np.asarray(t) for t in got]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The ranks' records ({scenario: [rank records]}) and JAX's."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    d = str(tmp_path_factory.mktemp("torch_sp"))
    data = _inputs()
    procs = []
    mp = pytest.MonkeyPatch()
    mp.setenv("FF_FORCE_FLASH_ATTENTION", "1")
    try:
        numpy_init(mp)
        jmha = {k: _j_mha(*v) for k, v in MHA_MESHES.items()}
        jllama, jx = _j_llama({"seq": 2})
        # numpy_init draws the same weights for both meshes
        data.update({f"mha/{key}": a
                     for key, a in _weights(jmha["dp_sp"]).items()})
        data.update({f"llama/{key}": a
                     for key, a in _weights(jllama).items()})
        np.savez(os.path.join(d, "data.npz"), **data)
        with open(os.path.join(d, "spec.json"), "w") as f:
            json.dump({"scenarios": SCENARIOS}, f)
        jax_out = {}
        for world in (2, 4):
            procs = torch_ranks.spawn(WORKER, d, world)
            if world == 2:
                for causal in (False, True):
                    for w in (2, 4):
                        jax_out[f"ring/{w}/{int(causal)}"] = _j_ring_vjp(
                            data, w, causal)
                jax_out["llama_pred"] = np.asarray(
                    jllama.predict({"input": data["lx"][:LLAMA_BATCH]}))
                JLoader(jllama, jx, data["lx"])
                JLoader(jllama, jllama.label_tensor, data["ly"])
                jllama.fit(epochs=1, verbose=False)
                jax_out["llama_loss"] = float(jllama._last_loss)
                jax_out["llama_w"] = _weights(jllama)
            else:
                for k, jff in jmha.items():
                    batch = {"x": data["mx"], "label": data["my"]}
                    pred = np.asarray(jff.predict({"x": data["mx"]}))
                    losses = [float(jff._run_train_step(batch)[0])
                              for _ in range(3)]
                    jax_out[f"mha/{k}"] = (pred, losses, _weights(jff))
            torch_ranks.wait(procs, "TORCH-SP", SPAWN_TIMEOUT)
    finally:
        torch_ranks.kill(procs)
        mp.undo()
        torch.set_num_threads(threads)
    ranks = {sc["name"]: [dict(np.load(os.path.join(d, f"{sc['name']}.{r}"
                                                       f".npz")))
                          for r in range(sc["world"])] for sc in SCENARIOS}
    return ranks, jax_out, data


def _grad_close(got, want, name):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale + 1e-7,
                               err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("causal", [False, True])
def test_attention_functions_match_jax_ring(results, world, fn, causal):
    """Each rank's output and gradients, joined over the ranks, are JAX's
    flash ring's under shard_map."""
    ranks, jax_out, _ = results
    want = jax_out[f"ring/{world}/{int(causal)}"]
    recs = ranks[f"fns{world}"]
    tag = f"{fn}/{int(causal)}"
    joined = [np.concatenate([r[f"{tag}/{k}"] for r in recs], axis=1)
              for k in ("out", "dq", "dk", "dv")]
    np.testing.assert_allclose(joined[0], want[0], **OUT_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), joined[1:], want[1:]):
        _grad_close(g, w, f"{tag} {name}")


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_attention_matches_jax(causal):
    """The one ``blockwise_attention`` (ops/attention.py, imported by
    parallel/ring_attention.py) against JAX's, 8-key blocks: output and
    the vjp of a cotangent."""
    from flexflow_tpu_torch.parallel import ring_attention as ra

    data = _inputs()
    q, k, v, do = (data[n] for n in ("q", "k", "v", "do"))
    scale = 1.0 / np.sqrt(q.shape[-1])
    o, pull = jax.vjp(lambda a, b, c: j_blockwise(
        a, b, c, causal=causal, scale=scale, block_size=8), q, k, v)
    want = [np.asarray(o)] + [np.asarray(g) for g in pull(jnp.asarray(do))]
    tq, tk, tv = (torch.tensor(t).requires_grad_() for t in (q, k, v))
    got = ra.blockwise_attention(tq, tk, tv, causal, scale, 8)
    (got * torch.tensor(do)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want[0], **OUT_TOL)
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want[1:]):
        _grad_close(t.grad.numpy(), w, name)


@pytest.mark.parametrize("mesh", sorted(MHA_MESHES))
def test_mha_op_matches_jax_same_strategy(results, mesh):
    """The attention op under a seq-sharded strategy: predict, 3 SGD
    steps and the weights after them equal JAX's under the same mesh and
    strategy, every rank alike; its attention took the ring (4 calls)."""
    ranks, jax_out, _ = results
    pred, losses, weights = jax_out[f"mha/{mesh}"]
    for rec in ranks[f"mha_{mesh}"]:
        np.testing.assert_allclose(rec["pred"], pred, **OUT_TOL)
        np.testing.assert_allclose(rec["losses"], losses, **OUT_TOL)
        for k, w in weights.items():
            np.testing.assert_allclose(rec[f"weight/{k}"], w, err_msg=k,
                                       **OUT_TOL)
        assert list(rec["calls"]) == [3, 0]


@pytest.mark.parametrize("sp_mode", ["ring", "ulysses"])
def test_llama_fit_matches_jax_under_seq_sharding(results, sp_mode):
    """A RoPE / GQA llama_lm under {"seq": 2} through predict and fit
    equals JAX's under the same mesh (its ring the reference of both
    lowerings): logits, the last loss and every weight within 1e-5. Each
    rank's local q is (B, S/2, H, D): the RoPE tables met the shards
    without gathering the sequence; one SP call a layer a step."""
    ranks, jax_out, _ = results
    for rec in ranks[f"llama_{sp_mode}"]:
        np.testing.assert_allclose(rec["pred"], jax_out["llama_pred"],
                                   **OUT_TOL)
        np.testing.assert_allclose(rec["last_loss"], jax_out["llama_loss"],
                                   **OUT_TOL)
        for k, w in jax_out["llama_w"].items():
            np.testing.assert_allclose(rec[f"weight/{k}"], w, err_msg=k,
                                       **OUT_TOL)
        s = LLAMA["seq_len"] // 2
        want = (LLAMA_BATCH, s, LLAMA["heads"],
                LLAMA["hidden"] // LLAMA["heads"])
        assert [tuple(x) for x in rec["q_shapes"]] == [want]
        assert int(rec["calls"]) == LLAMA["layers"] * 3


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_sp_dropout_applied_and_unbiased(results, name):
    """Dropout inside the recurrence is applied (a draw differs from the
    undropped output) and unbiased (200 draws average back to it, within
    JAX's limits), on every rank's shard."""
    ranks, _, _ = results
    for rec in ranks["dropout"]:
        base = rec[f"{name}/base"]
        assert np.abs(rec[f"{name}/first"] - base).max() > 1e-3
        np.testing.assert_allclose(rec[f"{name}/mean"], base, rtol=0.2,
                                   atol=0.12)


def test_mha_sp_dropout_training_runs(results):
    """Training steps with attention dropout under {"data": 2, "seq": 2}
    run the torch ring from each shard's generator: finite losses that
    differ from the undropped run's."""
    ranks, jax_out, _ = results
    undropped = jax_out["mha/dp_sp"][1]
    for rec in ranks["mha_dropout"]:
        assert np.isfinite(rec["losses"]).all()
        assert np.abs(rec["losses"] - undropped).max() > 1e-6
    assert all(np.array_equal(r["losses"], ranks["mha_dropout"][0]["losses"])
               for r in ranks["mha_dropout"])


def test_two_sequence_axes_raise(results):
    """A sequence dim split over two mesh axes raises JAX's ValueError on
    every rank."""
    ranks, _, _ = results
    for rec in ranks["two_axes"]:
        assert "multiple mesh axes" in str(rec["error"])


def test_bad_sp_mode_raises():
    from flexflow_tpu_torch import FFConfig

    with pytest.raises(ValueError, match="sp_mode must be 'ring' or "
                                         "'ulysses'"):
        FFConfig(sp_mode="allgather")
    assert FFConfig(sp_mode="ulysses").sp_mode == "ulysses"
