"""One try at two gloo ranks sharing one card with CUDA tensors: NCCL does
not put two ranks of one communicator on one GPU, so this asks whether
the strategy path can check a mesh of 2 on a one-card machine over gloo.

Two ranks are started through the port's launcher with ``--device cpu``
(the gloo backend), and each builds the small flagship (f32, batch 8,
seq 16, hidden 64, 2 layers, 4 heads) on ``cuda:0`` under ``{"data": 2}``:
the DTensor collectives then hand CUDA tensors to gloo. Three SGD steps
are compared with the same model trained in the parent process on the
single-device path on the card. Prints one JSON line: the outcome
("ok", or the error each rank raised) and the losses. From the root of a
checkout, on a machine with a card:

    python3 scripts/torch_gloo_one_card.py
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


def rank_main(out: str) -> None:
    import torch.distributed as dist

    rank = dist.get_rank()
    try:
        res = {"losses": train({"data": 2}), "error": None}
    except Exception as e:  # noqa: BLE001 — the outcome is the record
        res = {"losses": None, "error": f"{type(e).__name__}: {e}"[:600]}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def main() -> int:
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
         "--rank", out], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
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
    if len(sys.argv) == 3 and sys.argv[1] == "--rank":
        rank_main(sys.argv[2])
    else:
        sys.exit(main())
