#!/usr/bin/env python3
"""Where a serve of the PyTorch port spends its time on the card.

    python3 scripts/torch_serve_profile.py [--root DIR] [--layers 32]
        [--kv-cache-dtype native|bf16|int8|fp8]
        [--weight-dtype native|int8|fp8] [--speculate-k K] [--rounds N]

Builds the Llama-3-8B-width decoder of chip_smoke.py (bf16, seeded random
weights) and serves its six prompts on one engine of chip_smoke.py's
geometry without the prefix cache (so every round prefills cold), with the
given KV-pool and weight storage and, with ``--speculate-k``, a
Llama-3.2-1B-width draft proposing K tokens a slot: once to warm up (on
this tree the decode chunk, or the draft's proposals and the verify pass,
are captured as CUDA graphs then), ``--rounds`` times timed without the
profiler, once under torch.profiler (CPU and CUDA activities). Prints:

  * each timed round's wall time, decode step and TTFT p50 / p99, and the
    engine's program captures and graph replays where it counts them;
  * the profiled serve's wall time, the device's busy time (the union of
    kernel intervals on the card) and from the two the device's idle
    share; and the idle share against the unprofiled rounds' median wall
    (the profiler's host cost a launch inflates the profiled wall, most
    for an eager decode);
  * device time by kernel class (paged attention, flash attention, the
    prefill write, GEMMs, the sampler's sort, the rest), the device
    kernels launched and their count a decode step;
  * the top operators by device time and by host time.

``--root DIR`` imports the port and chip_smoke.py from another checkout
(e.g. the parent commit unpacked with ``git archive``), so two trees are
measured by the same script in one run on the card, in turns. The engine
arguments it passes exist in every tree since the quantized tier.

Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def kernel_class(name: str) -> str:
    """Where a device kernel of a serve belongs."""
    low = name.lower()
    if "paged_attn" in name:
        return "paged attention (kernel 4)"
    if "flash_fwd_" in name:
        return "flash attention (kernel 1)"
    if "prefill_write" in name:
        return "prefill write (kernel 5)"
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "GEMMs (cuBLAS)"
    if any(k in low for k in ("sort", "radix", "scan")):
        return "sort / scan (the sampler's warp)"
    if any(k in low for k in ("index", "scatter", "gather")):
        return "index / gather / scatter"
    return "other (elementwise, reductions, copies)"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose port is measured")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kv-cache-dtype", default="native",
                    choices=("native", "bf16", "int8", "fp8"))
    ap.add_argument("--weight-dtype", default="native",
                    choices=("native", "int8", "fp8"))
    ap.add_argument("--speculate-k", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
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
    kw = dict(chip_smoke.ENGINE, prefix_cache=False,
              kv_cache_dtype=args.kv_cache_dtype,
              weight_dtype=args.weight_dtype)
    if args.speculate_k:
        draft = chip_smoke.build_llama(
            FFConfig, FFModel, llama_lm, "cuda", "bfloat16", 1,
            tie_embeddings=True, **chip_smoke.LLAMA32_1B)
        kw.update(draft_model=draft, speculate_k=args.speculate_k)
    eng = ff.make_serving_engine(**kw)
    tag = (f"{root.name}: layers {args.layers}, kv {args.kv_cache_dtype}, "
           f"weights {args.weight_dtype}, speculate_k {args.speculate_k}")

    def serve():
        """One round; its wall ms, decode steps, decode step ms, TTFTs."""
        before = eng.stats()
        t0 = time.perf_counter()
        reqs = eng.run(prompts, max_new_tokens=chip_smoke.MAX_NEW)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        st = eng.stats()
        steps = st["decode_steps"] - before["decode_steps"]
        step_ms = ((st["decode_step_ms"] * st["decode_steps"]
                    - before["decode_step_ms"] * before["decode_steps"])
                   / max(1, steps))
        ttfts = sorted(r.ttft * 1e3 for r in reqs)
        return wall, steps, step_ms, ttfts, st

    serve()   # warm up: builds the kernels and captures the programs
    walls, step_mss = [], []
    for i in range(args.rounds):
        wall, steps, step_ms, ttfts, st = serve()
        walls.append(wall)
        step_mss.append(step_ms)
        print(f"{tag}: round {i + 1}: serve {wall:.1f} ms wall, decode step "
              f"{step_ms:.2f} ms over {steps} steps, TTFT p50 "
              f"{ttfts[len(ttfts) // 2]:.1f} ms p99 {ttfts[-1]:.1f} ms, "
              f"captures {st.get('recompiles', 'n/a')}, graph replays "
              f"{st.get('graph_replays', 'n/a')} [{card}]", flush=True)
    print(f"{tag}: median of {args.rounds}: serve "
          f"{statistics.median(walls):.1f} ms wall, decode step "
          f"{statistics.median(step_mss):.2f} ms [{card}]")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        wall, steps, step_ms, _, st = serve()
    busy = chip_smoke.busy_ms(prof.events())
    print(f"{tag}: under the profiler serve {wall:.1f} ms wall, decode step "
          f"{step_ms:.2f} ms over {steps} steps, device busy {busy:.1f} ms; "
          f"idle share {1 - busy / wall:.3f} [{card}]")
    # the profiler's host cost a launch inflates the profiled wall, most
    # for an eager decode: the same device time over the unprofiled rounds'
    # median wall is the serve's own idle share
    print(f"{tag}: idle share outside the profiler (busy / median unprofiled"
          f" wall): {1 - busy / statistics.median(walls):.3f} [{card}]")
    classes, launches = {}, 0
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        launches += 1
        c = kernel_class(e.name)
        classes[c] = classes.get(c, 0.0) + e.time_range.elapsed_us() / 1e3
    total = sum(classes.values())
    for c, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"{tag}: {c}: {ms:.2f} ms ({100 * ms / total:.1f}% of device "
              f"time) [{card}]")
    print(f"{tag}: {launches} device kernels in the serve, "
          f"{launches / max(1, steps):.1f} a decode step (prefill's "
          f"included)")
    ka = prof.key_averages()
    print(ka.table(sort_by="cuda_time_total", row_limit=20))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=15))


if __name__ == "__main__":
    main()
