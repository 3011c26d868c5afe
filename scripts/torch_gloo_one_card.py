"""Two gloo ranks sharing one card with CUDA tensors: NCCL does not put two
ranks of one communicator on one GPU, so this asks what the port's
multi-rank paths can do on a one-card machine over gloo.

Two ranks are started through the port's launcher with ``--device cpu``
(the gloo backend). By default each builds the small flagship (f32,
batch 8, seq 16, hidden 64, 2 layers, 4 heads) on ``cuda:0`` under
``{"data": 2}``: the DTensor collectives then hand CUDA tensors to gloo.
Three SGD steps are compared with the same model trained in the parent
process on the single-device path on the card. With ``--collectives``
each rank instead tries c10d's point-to-point (``batch_isend_irecv``),
``all_to_all_single``, ``all_reduce``, ``all_gather_into_tensor`` and
``broadcast`` on CUDA tensors handed to gloo directly, each checked
against the values the peer sent, then the port's ``parallel.exchange`` / ``all_to_all``
(``exchange`` stages CUDA tensors through pinned host buffers on gloo,
which refuses them point to point). Prints
one JSON line: the outcome of each try on each rank ("ok", "wrong
values", or the error raised) and, by default, the losses. From the root
of a checkout, on a machine with a card:

    python3 scripts/torch_gloo_one_card.py [--collectives]
"""
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, DIMS, CLASSES = 8, (16, 64, 2, 4), 16


def train(mesh_shape):
    """Three SGD steps of the small flagship on the card; the losses."""
    import numpy as np
    import torch

    from flexflow_tpu_torch import (FFConfig, FFModel, LossType, MetricsType,
                                    SGDOptimizer)
    from flexflow_tpu_torch.models import build_encoder_classifier

    torch.backends.cuda.matmul.allow_tf32 = False
    ff = FFModel(FFConfig(batch_size=B, seed=3, use_fused_ln=True,
                          mesh_shape=mesh_shape), device="cuda")
    build_encoder_classifier(ff, B, *DIMS, num_classes=CLASSES)
    ff.compile(SGDOptimizer(lr=0.05),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY])
    rs = np.random.RandomState(0)
    losses = []
    for _ in range(3):
        batch = {"input": rs.randn(B, DIMS[0], DIMS[1]).astype(np.float32),
                 "label": rs.randint(0, CLASSES, (B, 1)).astype(np.int32)}
        losses.append(float(ff._run_train_step(batch)[0]))
    return losses


def collectives() -> dict:
    """Each c10d collective on CUDA tensors handed to gloo, then the port's
    staged ones: {name: "ok" | "wrong values" | the error}."""
    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch import parallel

    rank, dev = dist.get_rank(), torch.device("cuda")
    peer = 1 - rank
    mine = torch.arange(8, dtype=torch.float32, device=dev) + 100 * rank
    theirs = torch.arange(8, dtype=torch.float32, device=dev) + 100 * peer

    def p2p():
        got = torch.empty_like(mine)
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, mine, peer),
                dist.P2POp(dist.irecv, got, peer)]):
            w.wait()
        return torch.equal(got, theirs)

    def a2a():
        out = torch.empty_like(mine)
        dist.all_to_all_single(out, mine)
        want = torch.cat([(theirs if r == peer else mine).view(2, 4)[rank]
                          for r in range(2)])
        return torch.equal(out, want)

    def reduce():
        t = mine.clone()
        dist.all_reduce(t)
        return torch.equal(t, mine + theirs)

    def bcast():
        t = mine.clone()
        dist.broadcast(t, src=1)
        return torch.equal(t, mine if rank == 1 else theirs)

    def gather():
        out = torch.empty(16, device=dev)
        dist.all_gather_into_tensor(out, mine)
        return torch.equal(out, torch.cat([mine, theirs][::1 - 2 * rank]))

    def staged():
        mesh = parallel.make_mesh({"seq": 2}, "cuda")
        axis = parallel.mesh_axis(mesh, "seq")
        got = parallel.exchange(axis, [(peer, mine)], [(peer, mine)])[0]
        x = mine.view(1, 2, 4)
        y = parallel.all_to_all(x, axis, 2, 1)
        # heads split over the ranks, positions joined in rank order
        want = torch.cat([(mine if r == rank else theirs).view(1, 2, 4)[
            :, :, 2 * rank:2 * rank + 2] for r in range(2)], dim=1)
        return (torch.equal(got, theirs) and torch.equal(y, want)
                and parallel.transport_stats()["staged_calls"] > 0)

    res = {}
    # a try that fails may leave the pair's connection closed for the
    # tries after it: the port's staged transport first, then the
    # collectives gloo documents for CUDA tensors, point to point last
    for name, fn in (("port_staged_exchange_all_to_all", staged),
                     ("all_reduce", reduce),
                     ("all_gather_into_tensor", gather),
                     ("broadcast", bcast),
                     ("all_to_all_single", a2a),
                     ("batch_isend_irecv", p2p)):
        try:
            ok = fn()
            torch.cuda.synchronize()
            res[name] = "ok" if ok else "wrong values"
        except Exception as e:  # noqa: BLE001 — the outcome is the record
            res[name] = f"{type(e).__name__}: {e}"[:300]
    return res


def rank_main(out: str, mode: str) -> None:
    import torch.distributed as dist

    rank = dist.get_rank()
    try:
        if mode == "collectives":
            res = {"collectives": collectives(), "error": None}
        else:
            res = {"losses": train({"data": 2}), "error": None}
    except Exception as e:  # noqa: BLE001 — the outcome is the record
        res = {"losses": None, "error": f"{type(e).__name__}: {e}"[:600]}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def main(mode: str) -> int:
    sys.path.insert(0, str(ROOT))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tempfile.mkdtemp(dir=str(ROOT / "build"))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["FF_INIT_TIMEOUT_S"] = "60"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "flexflow_tpu_torch.launcher", __file__,
         "--device", "cpu", "--num-processes", "2", "--process-id", str(r),
         "--coordinator", f"127.0.0.1:{port}", "--",
         "--rank", out, mode], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0] + "\n(killed at 240 s)")
    ranks = []
    for r in range(2):
        path = os.path.join(out, f"rank{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else
                     {"losses": None, "error": f"no record; rc "
                      f"{procs[r].returncode}: {logs[r][-600:]}"})
    if mode == "collectives":
        print(json.dumps({"mode": mode, "ranks": ranks}), flush=True)
        return 0
    single = train(None)
    ok = all(r["error"] is None for r in ranks)
    diff = (max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                     single))
            if ok else None)
    print(json.dumps({"outcome": "ok" if ok else "failed", "ranks": ranks,
                      "single_device_losses": single,
                      "max_relative_difference": diff}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--rank":
        rank_main(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main("collectives" if "--collectives" in sys.argv[1:]
                      else "train"))
