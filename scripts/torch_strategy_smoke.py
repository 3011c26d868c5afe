"""chip_smoke.py's phase 17 alone on one card: the card's name and power
limit, the kernels' build, the card tests (pytest arguments pass through,
e.g. ``-k "strategy_path_world or dtensor_given"``), then phase 17 (the
flagship on the strategy path at world size 1, one NCCL rank started by
the port's launcher, against the single-device path). From the root of a
checkout:

    python3 scripts/torch_strategy_smoke.py [pytest -k ...]
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    import flexflow_tpu_torch as port
    from flexflow_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    card = cs.phase_card()
    cs.phase_build(kernels)
    rc = subprocess.call([sys.executable, "-m", "pytest",
                          "tests/test_torch_cuda.py", "-m", "cuda", "-q",
                          "-p", "no:cacheprovider", "--noconftest"]
                         + sys.argv[1:], cwd=ROOT)
    print("card tests rc", rc, flush=True)
    out = cs.phase_strategy(torch, port, kernels, card)
    print("launches", out)
    print(f"torch_strategy_smoke total {time.perf_counter() - t0:.1f} s")
    return rc


if __name__ == "__main__":
    sys.exit(main())
