"""chip_smoke.py's phase 9 (ResNet-50 and BERT-base through fit at their
published widths) in the checkout at ``--root`` (default: this one), for
comparing two trees on one card in turns, e.g. the parent commit unpacked
under build/parent:

    for r in build/parent . . build/parent; do
        python3 scripts/torch_train_ab.py --root $r; done

Each run builds the kernels of its checkout, then prints phase 9's lines
(step ms, samples/s, idle share, device time by kernel class)."""
import argparse
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]))
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import torch

    import flexflow_tpu_torch as port
    from flexflow_tpu_torch.ops import kernels

    if Path(port.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {port.__file__}, not {root}")
    t0 = time.perf_counter()
    card = cs.phase_card()
    cs.phase_build(kernels)
    cs.phase_zoo_train(torch, port, kernels, card)
    print(f"torch_train_ab {root.name}: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
