"""chip_smoke.py's phase 16 alone on one card: the card's name and power
limit, the kernels' build, the card tests (pytest arguments pass through,
e.g. ``-k "pipeline_batches or pinned_buffer or concurrent_capture"``),
then phase 16 (the input pipeline and the profiler). From the root of a
checkout:

    python3 scripts/torch_pipeline_smoke.py [pytest -k ...]
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
    out = cs.phase_pipeline(torch, port, kernels, card)
    print("launches", out)
    print(f"torch_pipeline_smoke total {time.perf_counter() - t0:.1f} s")
    return rc


if __name__ == "__main__":
    sys.exit(main())
