"""chip_smoke.py's phase 18 alone on one card: the card's name and power
limit, the kernels' build, kernels 1, 4 and 5 at (b)'s local-shard shapes
against their plain versions (the "_tp" rows), then phase 18 (two gloo
ranks sharing the card serve a tensor-parallel Llama and save a
checkpoint; a world of one over NCCL serves at world size 1 and restores
it). From the root of a checkout:

    python3 scripts/torch_tp_smoke.py
"""
import json
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
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = cs.tp_kernel_rows(torch, kernels, g)
    for name, r in rows.items():
        print(f"kernel {name}: {r['shape']}: max abs err {r['err']:.3g}, "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms by {r['bound'][1]}"
              + (f", {r['library']} {r['library_ms']:.4f} ms"
                 if r["library_ms"] else "") + ")", flush=True)
    out = cs.phase_tp(torch, port, kernels, card)
    print(json.dumps({"launches": out}))
    print(f"torch_tp_smoke total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
