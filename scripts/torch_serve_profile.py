#!/usr/bin/env python3
"""Where a serve of the PyTorch port spends its time on the card.

    python3 scripts/torch_serve_profile.py [--layers 32] [--ab ROUNDS]
        [--kv-cache-dtype native|bf16|int8|fp8] [--weight-dtype native|int8|fp8]

Builds the Llama-3-8B-width decoder of chip_smoke.py (bf16, seeded random
weights) and serves its six prompts three times, on chip_smoke.py's engine
with the given KV-pool and weight storage: once to warm up, once timed
without the profiler, once under torch.profiler (CPU and CUDA activities).
Prints:

  * the timed serve's wall time and TTFT p50 / p99, the device's busy
    time in the profiled serve (the union of kernel intervals on the
    card), and from the two the device's idle share;
  * the prefill write kernels' device time and launches;
  * the top operators by device time and by host time.

With ``--ab ROUNDS`` it instead serves the prompts in ROUNDS of four,
A B B A: A as the port runs, where a graph walk derives the RoPE tables
and the decode write slot once for all its layers, and B with every
attention op deriving its own. It prints each serve's wall time and
decode step and the medians of each side.

Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def per_layer_tables():
    """Every attention op derives its own RoPE tables and write slot: the
    graph walk hands each op None for both."""
    from flexflow_tpu_torch.runtime import generation

    stack = contextlib.ExitStack()
    for name in ("rope_tables", "paged_slot"):
        stack.enter_context(mock.patch.object(generation, name,
                                              lambda *a: None))
    return stack


def ab(serve, rounds: int, card: str):
    """A B B A rounds of serves: A shares the walk's tables, B does not."""
    walls = {"A": [], "B": []}
    steps = {"A": [], "B": []}
    for _ in range(rounds):
        for side in "ABBA":
            with (per_layer_tables() if side == "B"
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                st = serve()
                wall = (time.perf_counter() - t0) * 1e3
            walls[side].append(wall)
            steps[side].append(st["decode_step_ms"])
            print(f"ab {side}: serve {wall:.1f} ms wall, decode step "
                  f"{st['decode_step_ms']:.2f} ms", flush=True)
    for side, what in (("A", "tables shared by the walk"),
                       ("B", "tables per layer")):
        print(f"ab {side} ({what}): median serve "
              f"{statistics.median(walls[side]):.1f} ms, median decode step "
              f"{statistics.median(steps[side]):.2f} ms over "
              f"{len(walls[side])} serves [{card}]")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--ab", type=int, default=0, metavar="ROUNDS",
                    help="A/B the walk's shared tables instead of profiling")
    ap.add_argument("--kv-cache-dtype", default="native",
                    choices=("native", "bf16", "int8", "fp8"))
    ap.add_argument("--weight-dtype", default="native",
                    choices=("native", "int8", "fp8"))
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import llama_lm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    arch = dict(chip_smoke.LLAMA3_8B, layers=args.layers)
    ff = chip_smoke.build_llama(FFConfig, FFModel, llama_lm, "cuda",
                                "bfloat16", 0, **arch)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, arch["vocab_size"], size=n).astype(np.int32)
               for n in chip_smoke.PROMPT_LENS]
    kw = dict(chip_smoke.ENGINE, kv_cache_dtype=args.kv_cache_dtype,
              weight_dtype=args.weight_dtype)

    def serve():
        _, st = ff.serve(prompts, max_new_tokens=chip_smoke.MAX_NEW, **kw)
        torch.cuda.synchronize()
        return st

    serve()   # warm up
    if args.ab:
        return ab(serve, args.ab, card)
    t0 = time.perf_counter()
    st = serve()
    wall = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        serve()
        wall_prof = (time.perf_counter() - t0) * 1e3
    busy = chip_smoke.busy_ms(prof.events())
    print(f"layers {args.layers}, kv {args.kv_cache_dtype}, weights "
          f"{args.weight_dtype}: serve {wall:.1f} ms wall (TTFT p50 "
          f"{st['ttft_p50_ms']:.1f} ms, p99 {st['ttft_p99_ms']:.1f} ms; "
          f"decode step {st['decode_step_ms']:.2f} ms over "
          f"{st['decode_steps']} steps); "
          f"under the profiler {wall_prof:.1f} ms wall, device busy "
          f"{busy:.1f} ms; idle share {1 - busy / wall:.3f} [{card}]")
    ka = prof.key_averages()
    write = [e for e in ka if "prefill_" in e.key and e.device_time_total]
    print(f"prefill write kernels: "
          f"{sum(e.device_time_total for e in write) / 1e3:.3f} ms of device "
          f"time over {sum(e.count for e in write)} launches [{card}]")
    print(ka.table(sort_by="cuda_time_total", row_limit=25))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=25))


if __name__ == "__main__":
    main()
