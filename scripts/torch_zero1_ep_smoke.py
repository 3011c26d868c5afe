"""chip_smoke.py's phase 20 alone on one card: the card's name and power
limit, the kernels' build, kernels 1 and 2 at head dims 80, 96 and 256
against their plain versions (phase 3's "_hd80" / "_hd96" / "_hd256"
rows), then phase 20 (the single-device references in this process, then
two gloo ranks sharing the card run (a) ZeRO-1 under overlap_grad_sync,
(b) ShardedFusedUpdate and its checkpoint layout, (c) the MoE's EXPERT
axis and (d) ring attention at those head dims; it prints its own rows at
the ranks' shapes). From the root of a checkout:

    python3 scripts/torch_zero1_ep_smoke.py [--no-rows]
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
    if "--no-rows" not in sys.argv[1:]:
        g = torch.Generator(device="cuda").manual_seed(0)
        for name, r in cs.head_dim_kernel_rows(torch, kernels, g).items():
            cs.say_row(name, r)
    out, _ = cs.phase_zero1_ep(torch, port, kernels, card)
    print(json.dumps({"launches": out}))
    print(f"torch_zero1_ep_smoke total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
