"""chip_smoke.py's phase 19 alone on one card: the card's name and power
limit, the kernels' build, kernels 1 and 2 at phase 19's local shapes
against their plain versions (the "_ring", "_ring_full", "_ulysses" and
"_pipe" rows), then phase 19 (the single-device references in this
process, then two gloo ranks sharing the card run ring and Ulysses
attention on a Llama-3-8B-width model over 8192 tokens and GPipe / 1F1B
on gpt_pipelined over a pipe axis). From the root of a checkout:

    python3 scripts/torch_sp_pp_smoke.py [--no-rows]
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
        for name, r in cs.sp_pp_kernel_rows(torch, kernels, g).items():
            print(f"kernel {name}: {r['shape']}: max abs err {r['err']:.3g}, "
                  f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound'][0]:.4f} ms by {r['bound'][1]}, "
                  f"{r['library']} {r['library_ms']:.4f} ms) [{card}]",
                  flush=True)
    out = cs.phase_sp_pp(torch, port, kernels, card)
    print(json.dumps({"launches": out}))
    print(f"torch_sp_pp_smoke total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
