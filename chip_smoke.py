#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure (non-zero exit, no result line):

  1. card     — print the card's name and power limit (nvidia-smi).
  2. build    — compile the eight CUDA sources from flexflow_tpu_torch/csrc
                with nvcc (sm_90a), one process each, all started together,
                and print the build time and ptxas's registers and spills;
                count each flash and paged-attention kernel's HGMMA
                (tensor-core), UTMALDG (TMA load) and LDGSTS (cp.async)
                instructions with cuobjdump -sass and fail unless every
                tensor-core flash kernel holds HGMMA and UTMALDG and every
                paged-attention kernel LDGSTS or UTMALDG, and every
                fused-update kernel 16-byte global loads and stores.
                bf16 flash attention (forward and backward) runs on the
                tensor cores (wgmma, tiles by TMA: flash_attention_wgmma.cu,
                flash_attention_bwd_wgmma.cu), f32 on the CUDA-core kernels
                (flash_attention.cu, flash_attention_bwd.cu); the dtype
                alone chooses.
  3. kernels  — hold each kernel against its plain PyTorch version on the
                card, in bf16 (so the flash rows run the tensor-core
                kernels), at the shapes the Llama-3-8B serving path and the
                flagship training path give it (limits below), the flash
                backward also with a caller's delta and an lse cotangent
                (dlse) at the training shape (a checked line, same kernel),
                the quantized variants too (paged attention over an int8 /
                fp8 pool with scales and over a bf16 pool under f32
                queries; the prefill write into int8 / fp8 pages, bitwise),
                and paged attention again at ~8000 live positions a slot
                (native, int8 and fp8 pools; each paged row prints its
                split-KV grid and split count); the prefill write also for
                Llama-3-8B's 32 layers in one launch (native, int8, fp8;
                bitwise); time kernel, plain version and, where one
                exists, a torch call computing the same function as a
                yardstick (the port never calls it; for the native
                prefill writes index_copy_ of the page-reshaped slabs,
                beside a device copy of the same bytes), each with CUDA
                events around single launches after an L2 flush and a
                short device wait that hides the wrapper's host time
                (cuda_ms); print each row's share of its bound and its
                ratio to the torch call. Then the fused optimizer update
                (fused_update.cu, the port's own kernel) at the full-width
                flagship's bucket (1.21 B bf16 weights, ~100 leaves) for
                SGD, SGD with momentum and Adam on flat state (FusedUpdate's
                layout), and SGD and Adam as the per-leaf optimizer calls
                it (Adam on per-leaf state tensors): bitwise against its
                plain version (run a few leaves at a time) and the
                per-leaf torch formula (apply_update_plain); timed beside
                that formula, torch._foreach_* of the same formula and a
                device copy of the same bytes; each row prints the share
                of its bytes on the kernel's 16-byte vector path, counted
                on the card (vector_count) and held equal to the plan's.
  4. check    — a small Llama (2 layers, head dim 128) served in f32 on the
                card through the kernels gives the same greedy tokens as the
                same weights served on the CPU through the plain versions:
                native pool; int8 pool with the prefix cache, prompts
                sharing a 2-page prefix run twice on one engine (prefix
                hits); bf16 pool under f32 compute (the mixed-width
                kernel). Then one small f32 case of each torch route the
                ops take for shapes a kernel does not (attention with head
                dim 48, unequal q / v head dims, causal with more queries
                than keys, use_flash_attention=False, the blockwise scan
                past 4096 positions; add + LayerNorm at width 1004): card
                vs CPU, forward and gradients, and no kernel launched.
  5. train check — a small f32 flagship encoder classifier (hidden 512, 2
                layers, 4 heads of 128, fused add + LayerNorm) takes 3
                steps on the card through the kernels and on the CPU
                through the plain branches from the same weights, for each
                of: SGD; Adam under WarmupCosine; fused SGD with momentum
                (also bitwise, on the card, the per-leaf torch formula —
                Optimizer.update_plain, no kernel — and the per-leaf
                optimizer, which launches the same kernel on per-leaf
                state); grad_accum_steps 2; on_nonfinite="skip" with a NaN injected at step 2 (the
                weights bitwise untouched by it); scan_steps=3 through the
                CUDA graph replay. Losses within 1e-4 relative, every
                weight within 1e-5 (Adam's key biases: see
                ADAM_NOISE_ATOL), exact launch counts (one update launch
                a step in every variant: the per-leaf optimizer runs the
                fused update kernel on the card too).
  6. serve    — Llama-3-8B widths (hidden 4096, 32 heads over 8 kv heads,
                ffn 14336, vocab 128256, rope_theta 500000, 32 layers, bf16,
                seeded random weights) serve 6 prompts (13..700 tokens, 32
                new tokens each) through FFModel.serve with 4 slots and
                128-token pages; every request must finish with finite
                logits, each kernel's launch count must be its expected
                count (layers x prefills for flash attention, one prefill
                write a prefill for every layer, layers x decode steps),
                and a
                second serve must return the same tokens. The prefix cache
                is on (the default); these prompts share no prefix.
  6b. serve quantized — the same model serves 8 prompts (a 384-token
                shared prefix + tails of 16..300 tokens) twice on one
                engine for each of: int8 KV pool, fp8 KV pool, int8 KV pool
                with int8 weights; prefix hits (>= 7, then all 8), exact
                launch counts, no leaked page; tokens/s, TTFT, decode step,
                KV bytes per token, peak memory, and the token agreement
                with the native pool (printed, not gated).
  7. train    — the flagship encoder classifier at the widths of the TPU
                headline tier (batch 8, seq 512, hidden 4096, 6 layers, 32
                heads, ffn 16384, 16 classes, bf16 weights and compute,
                fused add + LayerNorm, SGD lr 0.01, seeded random weights
                and data) takes one warm-up step, then FFModel.fit runs one
                epoch of 4 steps: every loss finite, and per step exactly
                6 flash forwards, 6 flash backwards, 12 add + LayerNorm
                launches and one fused update (the per-leaf optimizer's,
                on per-leaf state). Prints step time, samples/s, peak
                memory and a torch.profiler breakdown of one more step (by
                kernel class, the top 8 kernels, and the top 8 of the
                "other" class with their launches). Then the same
                model, compiled again from the same seed, trains the same
                way with the fused SGD update, the fused Adam update, and
                scan_steps=4 (one chunk a fit: a CUDA graph replayed 4
                times): each with exact launch counts (one fused update a
                step), step time, samples/s, idle share, peak memory, and
                the update's own device time (CUDA events around
                ff.optimizer.update on one step's gradients, also for the
                per-leaf SGD run). Every run sees the same batches, so the
                fused and scanned SGD runs' losses are compared with the
                per-leaf run's (printed: bitwise or not).

  8. zoo check — the zoo small and f32 (TF32 off), card through the
                kernels vs CPU through the plain versions from the same
                weights and BatchNorm state, 2 SGD steps on the same
                batches: alexnet_cifar10, inception_v3_stem (image 75), a
                ResNet of resnet50's stem and bottleneck blocks (image
                32), vit (patch 8, head dim 64), dlrm (SUM bags),
                bert_base (2 layers, head dim 64), gpt_lm: losses within
                1e-4 relative, weights 1e-5, BatchNorm state 1e-5; a
                small Llama with tied embeddings serving the CPU's greedy
                tokens; dropout on the card: the kept share within 4.5
                sigma of the binomial mean, kept values exactly x / keep,
                and fit(scan_steps=4) at lr 0 on one repeated batch
                giving 4 different losses (every replayed step draws its
                own mask).
  9. zoo train — ResNet-50 (224 x 224, 1000 classes, batch 128, SGD lr
                0.1, the per-leaf optimizer: 214 leaves, two update
                launches a step) and BERT-base (hidden 768, 12 layers, 12
                heads, seq 512, batch 32, 2 classes, SGD lr 1e-4: the
                flash kernels at head dim 64, 12 launches each a step),
                bf16, seeded random weights, one batch repeated: compile
                time, a warm-up step, then fit over 4 steps (the loss
                finite and falling; exact launch counts): step ms,
                samples/s, peak memory, the idle share and device time by
                kernel class (cuDNN's conv kernels, the GEMM kernels of
                cuBLAS and of cuDNN's GEMM-run convs, flash, the update,
                BatchNorm, pooling, the rest) over one profiled step, and
                the update's own device time and share of its bound.
                Phase 3 also holds the flash rows at BERT-base's shape
                (32, 512, 12, 64) and the fused update at ResNet-50's
                leaves.
 10. rest     — the rest of the single-device op set. Card vs CPU (f32,
                TF32 off): the MoE op (sort and dense dispatch at a
                binding capacity), LSTM and GRU, forward and gradients;
                nmt_seq2seq, gpt_pipelined and gpt_lm with MoE small
                through 2 SGD steps (phase 8's limits); a small MoE LM's
                greedy tokens served. Fusion: phase 8's ResNet blocks
                trained 4 steps with perform_fusion and without, from
                the same seed (cuDNN deterministic): FUSION_ELIMINATED
                ops fused away and the losses, weights and BatchNorm
                state bitwise equal. Then, bf16 at published widths with
                seeded random weights, each through train_run (a warm-up
                step, fit over 4 copies of one batch with exact launch
                counts, a profiled step): NMT (nmt/nmt.cc's 2 + 2 LSTM
                layers of 2048, vocab 20k, batch 64, 20 + 20 steps) once
                a step and with scan_steps=4 (a CUDA graph); the GLaM
                (0.1B/64E) MoE LM (hidden 768, 12 layers, 64 experts
                top-2 every other layer, vocab 256k, seq 1024, batch 8,
                2.26 B weights); the pipelined LM at GPT-2 small's widths
                (seq 1024, batch 16); then the same MoE LM served through
                FFModel.serve (8 prompts of 512 tokens, 64 new tokens, 4
                slots, exact launches), a profiled serve's share of device
                time in the expert products (capacity = the slab's
                tokens) and those products timed alone. Phase 3 holds
                kernels 1 and 2 at the MoE LM's (8, 1024, 12, 64) causal,
                and kernels 1, 4 and 5 at its serve's shapes.

The last two lines of standard output are a JSON object
describing each kernel and the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12       # H100 SXM data sheet, dense
F32_FLOP_PER_S = 67e12         # H100 SXM data sheet, outside the tensor cores
# max abs error against the plain version: flash outputs are about 1 in
# size (bf16 rounding ~4e-3); paged decode outputs average ~600 unit
# values and are about 0.07 (bf16 rounding ~5e-4), so its limit is tighter
FLASH_TOL = 2e-2
PAGED_TOL = 5e-3
# the quantized paged-attention rows, scaled to the output's largest
# magnitude: the kernel's products are exact with f32 sums (the raw payload
# is exact in bf16; the probabilities enter P.V with 16 significant bits),
# the Pallas kernel's arithmetic to ~1e-5; the plain version casts K/V and
# the probabilities to bf16 (the JAX einsum oracle), and the output is
# rounded to bf16 once: 1e-2 is 2.5 bf16 steps. The mixed-width row (bf16 pool, f32 queries) computes in
# f32 in both versions: sums in other orders, 1e-4.
QUANT_TOL = 1e-2
MIXED_TOL = 1e-4
# the training rows' errors are scaled to the output's largest magnitude
# (max |kernel - plain| / max |plain|). bf16 keeps 8 significant bits, a
# relative step of 2^-8 = 3.9e-3 at the top of a binade: the flash forward
# and add + LayerNorm outputs are rounded once, so their limit is 1e-2
# (2.5 steps); the backward rounds ds and p to bf16 before three of its
# products, and a value near a rounding boundary may round the other way
# in the two versions, so its limit is 2e-2. The lse is f32: 1e-3 absolute
# on values ~7 (sums over 512 keys in other orders, then a log).
SCALED_TOL = 1e-2
BWD_TOL = 2e-2
LSE_TOL = 1e-3
# the f32 train check: card (kernels, cuBLAS without TF32) vs CPU (plain
# branches) sum in other orders, ~1e-6 relative per product; three SGD
# steps at lr 0.01 move weights by ~1e-3, so the weights agree far inside
# 1e-5, the losses inside 1e-4 relative
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5

#: the flagship at the widths of the TPU headline tier (bench.py xxl_scan)
FLAGSHIP = dict(batch=8, seq=512, hidden=4096, layers=6, heads=32,
                ffn_mult=4, num_classes=16)
TRAIN_STEPS = 4
TRAIN_LR = 0.01

LLAMA3_8B = dict(hidden=4096, layers=32, heads=32, kv_heads=8,
                 ffn_hidden=14336, vocab_size=128256, rope_theta=500000.0)
PROMPT_LENS = (13, 37, 90, 200, 512, 700)
MAX_NEW = 32
# pow2 buckets, but 768 for the 700-token prompt: its pow2 bucket (1024)
# plus 32 new tokens would not fit max_seq_len 1024
BUCKETS = [16, 32, 64, 128, 256, 512, 768]
ENGINE = dict(serve_slots=4, max_seq_len=1024, kv_page_size=128,
              decode_buckets=BUCKETS)
#: phase 6b: the quantized pools (and weights) serve these prompts twice
QUANT_CONFIGS = (("int8", dict(kv_cache_dtype="int8")),
                 ("fp8", dict(kv_cache_dtype="fp8")),
                 ("int8_w8", dict(kv_cache_dtype="int8", weight_dtype="int8")))
QUANT_PREFIX = 384
QUANT_TAILS = (16, 57, 98, 139, 180, 221, 262, 300)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


# ------------------------------------------------------------- timing


#: device cycles (~0.5 ms on the H100) the card spins before each timed
#: call, so the host's time in the wrapper lies behind it (cuda_ms)
SLEEP_CYCLES = 1_000_000
#: ~10 ms: the wait before a call that enqueues many launches (a loop over
#: 32 layers), so their host time lies behind it too
LONG_SLEEP_CYCLES = 20_000_000


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            sleep: int = SLEEP_CYCLES) -> float:
    """Median device time of one call of ``fn``: the 50 MB L2 flushed before
    each (the serving path meets its inputs cold), then a short device wait
    (``torch.cuda._sleep``), then the start event, the call and the end
    event. The wait keeps the card busy while the host runs the call's
    Python (argument checks, allocation, the launch), so the events bracket
    device time only: without it the card idles between the start event and
    the launch, and that idle time counted as kernel time. ``sleep``: the
    wait in device cycles; a call whose host time passes the default needs
    a longer one (``LONG_SLEEP_CYCLES``)."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(sleep)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, flops: float, flop_per_s: float = BF16_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scaled_err(out, ref) -> float:
    """max |out - ref| over max |ref|."""
    ref = ref.float()
    return ((out.float() - ref).abs().max() / ref.abs().max()).item()


def busy_ms(events) -> float:
    """Union of the device kernels' [start, end) intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type.name == "CUDA")
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3   # us -> ms


# ------------------------------------------------------------- phases


def phase_card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi: {e}")
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    say(line)
    return line


def phase_build(kernels):
    t0 = time.perf_counter()
    try:
        kernels.LIBRARY.get()
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    say(f"build: {time.perf_counter() - t0:.1f} s -> {kernels.LIBRARY.path}")
    log = (kernels.LIBRARY.path.parent / "build.log")
    if log.exists():
        for ln in log.read_text().splitlines():
            if "Compiling entry" in ln:
                say("  ptxas " + kernel_name(ln))
            elif "registers" in ln or "spill" in ln or ln.startswith("=="):
                say("  ptxas " + ln.strip())
    sass_counts(kernels)


def kernel_name(mangled: str) -> str:
    """'flash_fwd_wgmma_kernel<Li128>' from a mangled symbol (or a line
    holding one), for the build's and the profile's printouts."""
    m = re.search(r"\d+([a-z][a-z_]*?_kernel)I(\w*?)EE", mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m else mangled.strip()


def sass_counts(kernels):
    """Count the tensor-core (HGMMA, HMMA), TMA-load (UTMALDG) and cp.async
    (LDGSTS) instructions of each flash and paged-attention kernel in the
    built library (cuobjdump -sass); fail unless every tensor-core flash
    kernel holds HGMMA and UTMALDG, every paged-attention kernel streams
    its K/V by cp.async or TMA, every bf16-query paged kernel
    (paged_attn_mma_kernel) holds HMMA, and every fused-update kernel
    16-byte global loads and stores (LDG / STG .128)."""
    ops = ("HGMMA", "UTMALDG", "LDGSTS", "HMMA", "LDG.128", "STG.128")
    tool = Path(kernels._find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(kernels.LIBRARY.path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump exited {out.returncode}: {out.stderr.strip()}")
    counts, cur = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = kernel_name(m.group(1)) if any(
                k in m.group(1) for k in ("flash", "simt", "paged_attn",
                                          "fused_update")) else None
            if cur:
                counts[cur] = dict.fromkeys(ops, 0)
        elif cur:
            for op in ops[:4]:
                counts[cur][op] += op in ln
            # 16-byte global loads and stores (LDG.E.EF.128 and the like)
            for op in ops[4:]:
                counts[cur][op] += op[:3] in ln and ".128" in ln
    wgmma = [k for k in counts if "wgmma" in k]
    paged = [k for k in counts if "paged_attn" in k]
    update = [k for k in counts if "fused_update" in k]
    if len(wgmma) != 9:
        fail(f"expected 9 tensor-core flash kernels in the library, found "
             f"{sorted(wgmma)}")
    if len(paged) != 21:
        fail(f"expected 21 paged-attention kernels in the library, found "
             f"{sorted(paged)}")
    if len(update) != 16:     # 4 rules x 2 dtypes x weight decay on / off
        fail(f"expected 16 fused-update kernels in the library, found "
             f"{sorted(update)}")
    for name, c in sorted(counts.items()):
        say(f"  sass {name}: " + ", ".join(f"{c[op]} {op}" for op in ops))
        if name in wgmma and not (c["HGMMA"] and c["UTMALDG"]):
            fail(f"{name} holds no HGMMA or no UTMALDG instruction")
        if name in paged and not (c["LDGSTS"] or c["UTMALDG"]):
            fail(f"{name} holds no cp.async (LDGSTS) or TMA (UTMALDG) load")
        if "paged_attn_mma" in name and not c["HMMA"]:
            fail(f"{name} holds no tensor-core (HMMA) instruction")
        if name in update and not (c["LDG.128"] and c["STG.128"]):
            fail(f"{name} holds no 16-byte global load or store")


def phase_kernels(torch, port, kernels):
    """Kernel vs plain version at the serving and training shapes (bf16;
    the flash training rows at the flagship's, BERT-base's and the MoE
    LM's; the serving rows at Llama-3-8B's and the MoE LM's), and the
    fused update at the flagship's bucket and ResNet-50's leaves."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {"flash_attention_fwd": flash_serve_row(
        torch, kernels, g, LLAMA3_8B["heads"], LLAMA3_8B["kv_heads"], 128)}
    rows.update(paged_attention_rows(torch, kernels, g))
    rows.update(prefill_write_rows(torch, kernels, g))
    rows.update(training_kernel_rows(torch, kernels, g))
    rows.update(moe_serve_kernel_rows(torch, kernels, g))
    rows.update(fused_update_rows(torch, port, kernels, g))
    rows.update(fused_update_rows(torch, port, kernels, g,
                                  resnet50_leaf_shapes(port),
                                  RESNET_UPDATE_ROWS, "ResNet-50's leaves"))
    for name, r in rows.items():
        say(f"kernel {name}: {r['shape']}: max abs err {r['err']:.3g}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms by {r['bound'][1]}: "
            f"{100 * r['bound'][0] / r['ms']:.1f}% of bound"
            + (f", {r['library']} {r['library_ms']:.4f} ms: "
               f"{r['ms'] / r['library_ms']:.2f}x its time"
               if r["library_ms"] else "")
            + (f", a device copy of the same bytes {r['copy_ms']:.4f} ms: "
               f"{r['ms'] / r['copy_ms']:.2f}x its time"
               if r.get("copy_ms") else "")
            + (f", the per-leaf torch formula {r['per_leaf_ms']:.4f} ms: "
               f"{r['ms'] / r['per_leaf_ms']:.2f}x its time"
               if r.get("per_leaf_ms") else "")
            + (f", {100 * r['vector_share']:.4f}% of the bytes on the "
               f"vector path, counted on the card" if "vector_share" in r
               else "") + ")")
    return rows


#: paged-attention rows: (row name, pool, long context)
def flash_serve_row(torch, kernels, g, h: int, kvh: int, d: int,
                    s: int = 512) -> dict:
    """Flash attention forward at a prefill of an ``s``-token bucket: q (1,
    s, h, d), k/v (1, s, kvh, d), causal, bf16; SDPA (GQA) as the
    yardstick."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    scale = d ** -0.5
    q = torch.randn(1, s, h, d, device=dev, generator=g).to(bf16)
    k = torch.randn(1, s, kvh, d, device=dev, generator=g).to(bf16)
    v = torch.randn(1, s, kvh, d, device=dev, generator=g).to(bf16)
    out = kernels.flash_attention_fwd(q, k, v, True, scale)
    ref = kernels.flash_attention_plain(q, k, v, True, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= FLASH_TOL:
        fail(f"flash_attention_fwd disagrees with its plain version at q "
             f"{tuple(q.shape)}: max abs err {err}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)

        def lib():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
    except TypeError:   # torch without enable_gqa: expand kv heads first
        ke = kt.repeat_interleave(h // kvh, dim=1)
        ve = vt.repeat_interleave(h // kvh, dim=1)

        def lib():
            F.scaled_dot_product_attention(qt, ke, ve, is_causal=True)
    pairs = s * (s + 1) // 2
    return dict(
        err=err,
        ms=cuda_ms(lambda: kernels.flash_attention_fwd(q, k, v, True, scale)),
        plain_ms=cuda_ms(
            lambda: kernels.flash_attention_plain(q, k, v, True, scale)),
        library_ms=cuda_ms(lib), library="F.scaled_dot_product_attention",
        bound=bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                    4 * pairs * h * d),
        shape=f"q (1,{s},{h},{d}) k/v (1,{s},{kvh},{d}) causal bf16")


PAGED_CASES = (("paged_attention_fwd", "bf16", False),
              ("paged_attention_fwd_int8", "int8", False),
              ("paged_attention_fwd_fp8", "fp8", False),
              ("paged_attention_fwd_mixed", "mixed", False),
              ("paged_attention_fwd_long", "bf16", True),
              ("paged_attention_fwd_long_int8", "int8", True),
              ("paged_attention_fwd_long_fp8", "fp8", True))


def paged_case(torch, kernels, g, pool: str, long: bool,
               geom: dict = None) -> dict:
    """One decode step of 4 slots at Llama-3-8B widths (32 heads over 8 kv
    heads, D = 128, 128-token pages): ~620 live positions a slot (the
    serving shape, 8 pages a slot) or ~8000 (``long``: Llama-3-8B's 8192
    context, 64 pages a slot), with ragged prompts whose bucket padding is
    dead. ``pool``: "bf16" (native), "int8" / "fp8" (random payload, random
    positive per-(page, kv head) scales) under bf16 queries, or "mixed" (a
    bf16 pool under f32 queries). ``geom`` overrides the heads, kv heads,
    head dim, pages a slot and the (row_len, prompt_pad, write_pos) lists
    (another model's serve). Returns the wrapper's arguments, the error
    and its limit, the bound, the launch plan and a description."""
    dev = torch.device("cuda")
    h, kvh, d = LLAMA3_8B["heads"], LLAMA3_8B["kv_heads"], 128
    b, ps = ENGINE["serve_slots"], ENGINE["kv_page_size"]
    if long:
        pps = 64
        lens = ([7900, 8050, 7700, 8100], [7936, 8064, 7744, 8128],
                [8000, 8150, 7900, 8180])
    else:
        pps = 8
        lens = ([500, 620, 530, 690], [512, 640, 544, 704],
                [600, 660, 560, 720])
    if geom:
        h, kvh, d, pps, lens = (geom[k] for k in ("heads", "kv_heads", "d",
                                                  "pages", "lens"))
    n_pool = b * pps + 1
    qdt = torch.float32 if pool == "mixed" else torch.bfloat16
    q = torch.randn(b, 1, h, d, device=dev, generator=g).to(qdt)
    table = (torch.randperm(n_pool - 1, device=dev, generator=g) + 1)
    table = table[:b * pps].reshape(b, pps).to(torch.int32).contiguous()
    row_len, pad = (torch.tensor(x, dtype=torch.int32, device=dev)
                    for x in lens[:2])
    wp = torch.tensor(lens[2], dtype=torch.int32, device=dev)[:, None]
    shape = (n_pool, ps, kvh, d)
    kw = {}
    if pool in ("bf16", "mixed"):
        kp, vp = (torch.randn(shape, device=dev, generator=g)
                  .to(torch.bfloat16) for _ in range(2))
    else:
        dt = torch.int8 if pool == "int8" else torch.float8_e4m3fn
        if dt == torch.int8:
            kp, vp = (torch.randint(-127, 128, shape, device=dev, generator=g,
                                    dtype=dt) for _ in range(2))
        else:
            kp, vp = ((torch.randn(shape, device=dev, generator=g) * 100)
                      .clamp(-448, 448).to(dt) for _ in range(2))
        kw = dict(zip(("k_scales", "v_scales"), (
            (torch.rand(n_pool, kvh, device=dev, generator=g) + 0.1) / 127.0
            for _ in range(2))))
    # live keys per slot: the prompt, then the decoded positions from the
    # bucket's end to the write frontier (the padding between is dead), and
    # the pages they lie in (the scale reads)
    live, pages_read = 0, 0
    for i in range(b):
        pos = list(range(int(row_len[i]))) + list(
            range(int(pad[i]), int(wp[i, 0]) + 1))
        live += len(pos)
        pages_read += len({j // ps for j in pos})
    ints = 4 * (table.numel() + wp.numel() + 2 * b)
    # q read and out written, the live K/V once, a quantized pool's scales
    nbytes = (2 * q.element_size() * q.numel()
              + 2 * live * kvh * d * kp.element_size() + ints
              + (4 * 2 * pages_read * kvh if kw else 0))
    peak = F32_FLOP_PER_S if pool == "mixed" else BF16_FLOP_PER_S
    plan = kernels.paged_attention_plan(b, 1, h, kvh, ps, pps,
                                        kernels.sm_count(dev))
    limit, scaled = {"bf16": (PAGED_TOL, False), "int8": (QUANT_TOL, True),
                     "fp8": (QUANT_TOL, True),
                     "mixed": (MIXED_TOL, True)}[pool]
    desc = (f"q ({b},1,{h},{d}) {'f32' if pool == 'mixed' else 'bf16'}, "
            f"{'bf16' if pool == 'mixed' else pool} pool ({n_pool},{ps},"
            f"{kvh},{d}){' + scales' if kw else ''}, {live} live positions; "
            f"grid {plan.grid} = {plan.blocks} blocks of {plan.threads}, "
            f"{plan.splits} splits of {plan.split_pages} page(s)")
    return dict(args=(q, kp, vp, table, wp, row_len, pad, d ** -0.5), kw=kw,
                limit=limit, scaled=scaled, bound=bound(nbytes, 4 * live * h
                                                        * d, peak),
                plan=plan, shape=desc)


def paged_err(case: dict, out, ref) -> float:
    """The error a paged row is held to: max abs for a native bf16 pool
    (its outputs are ~0.07, bf16 rounding ~5e-4), scaled to the output's
    largest magnitude for the others."""
    if case["scaled"]:
        return scaled_err(out, ref)
    return (out.float() - ref.float()).abs().max().item()


def paged_attention_rows(torch, kernels, g, cases=PAGED_CASES,
                         geom: dict = None):
    """Paged attention over every pool at the serving shape and at ~8000
    live positions a slot (``cases``, at ``geom``: see paged_case),
    against its plain version."""
    rows = {}
    for name, pool, long in cases:
        c = paged_case(torch, kernels, g, pool, long, geom)
        out = kernels.paged_attention_fwd(*c["args"], **c["kw"])
        ref = kernels.paged_attention_plain(*c["args"], **c["kw"])
        torch.cuda.synchronize()
        err = paged_err(c, out, ref)
        if not err <= c["limit"]:
            fail(f"{name} disagrees with its plain version: err {err} "
                 f"(limit {c['limit']}{', scaled' if c['scaled'] else ''})")
        rows[name] = dict(
            err=err,
            ms=cuda_ms(lambda: kernels.paged_attention_fwd(*c["args"],
                                                           **c["kw"])),
            plain_ms=cuda_ms(lambda: kernels.paged_attention_plain(
                *c["args"], **c["kw"])),
            library_ms=None, library=None, bound=c["bound"], shape=c["shape"])
        del c, out, ref
    return rows


#: layers of the grouped prefill-write rows: Llama-3-8B's 32
WRITE_LAYERS = LLAMA3_8B["layers"]
#: the prefill-write rows: (name suffix, pool)
WRITE_POOLS = (("", "bf16"), ("_int8", "int8"), ("_fp8", "fp8"))


def prefill_write_case(torch, g, pool: str, n_layers: int,
                       kvh: int = LLAMA3_8B["kv_heads"],
                       d: int = 128) -> dict:
    """The prefill write of a 512-token bf16 slab (Llama-3-8B's 8 kv heads,
    D = 128, or ``kvh`` / ``d``) into 4 of 33 pool pages (128 rows, listed
    out of order) for ``n_layers`` layers: a native bf16 pool, or int8 /
    fp8 with random positive scales. Returns ``new()`` (fresh copies of the
    pools and scales: the ``paged_prefill_write_layers`` arguments), the
    bound and a description."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    ps, s = ENGINE["kv_page_size"], 512
    n_pool, n_pages = 33, s // ps
    dt = {"bf16": bf16, "int8": torch.int8,
          "fp8": torch.float8_e4m3fn}[pool]
    pages = (torch.randperm(n_pool - 1, device=dev, generator=g)[:n_pages]
             + 1).to(torch.int32)
    khs, vhs = ([torch.randn(1, s, kvh, d, device=dev, generator=g).to(bf16)
                 for _ in range(n_layers)] for _ in range(2))
    shape = (n_pool, ps, kvh, d)
    if dt == bf16:
        pools = [torch.randn(shape, device=dev, generator=g).to(bf16)
                 for _ in range(2 * n_layers)]
    elif dt == torch.int8:
        pools = [torch.randint(-127, 128, shape, device=dev, generator=g,
                               dtype=dt) for _ in range(2 * n_layers)]
    else:
        pools = [(torch.randn(shape, device=dev, generator=g) * 100)
                 .clamp(-448, 448).to(dt) for _ in range(2 * n_layers)]
    scales = None
    if dt != bf16:
        scales = [(torch.rand(n_pool, kvh, device=dev, generator=g) + 0.1)
                  / 127.0 for _ in range(2 * n_layers)]

    def new():
        ts = [t.clone() for t in pools]
        sc = [t.clone() for t in scales] if scales else None
        return (ts[:n_layers], ts[n_layers:], khs, vhs, pages,
                sc[:n_layers] if sc else None, sc[n_layers:] if sc else None)

    # the bf16 slabs read, the pages written, a quantized pool's f32 scales
    # written, the page list read once
    out_bytes = dt.itemsize * 2 * n_pages * ps * kvh * d
    nbytes = n_layers * (2 * 2 * s * kvh * d + out_bytes
                         + (4 * 2 * n_pages * kvh if scales else 0)) \
        + 4 * n_pages
    return dict(new=new, bound=bound(nbytes, 0.0), shape=(
        f"{n_layers} layer{'s' if n_layers > 1 else ''}: slab (1,{s},{kvh},"
        f"{d}) bf16 into {n_pages} {pool} pages of {ps}"
        + (" + scales" if scales else "")))


def same_bytes(torch, a, b) -> bool:
    """Two prefill-write argument tuples hold the same pool and scale
    bytes."""
    return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for xs, ys in zip(a, b) if isinstance(xs, list)
               for x, y in zip(xs, ys))


def prefill_write_rows(torch, kernels, g, pools=WRITE_POOLS,
                       layer_counts=(1, WRITE_LAYERS), tag_suffix: str = "",
                       **geom):
    """The prefill write of a 512-token bf16 slab into 4 pages of a native,
    an int8 and an fp8 pool (``pools``), for one layer
    (``paged_prefill_write``) and for Llama-3-8B's 32 layers in one launch
    (``paged_prefill_write_layers``, the serving engine's call), or for
    ``layer_counts`` at ``geom`` (prefill_write_case's kvh / d): payload
    (and scales) bitwise the plain version's. The native rows also time
    ``index_copy_`` of the page-reshaped slabs (k and v, each layer) as the
    library call and a device copy of the same bytes as a yardstick."""
    rows = {}
    for suffix, pool in pools:
        suffix += tag_suffix
        for n_layers in layer_counts:
            c = prefill_write_case(torch, g, pool, n_layers, **geom)
            got, ref = c["new"](), c["new"]()
            if n_layers == 1:
                tag = f"paged_prefill_write{suffix}"

                def fn(a=got):
                    kernels.paged_prefill_write(
                        a[0][0], a[1][0], a[2][0], a[3][0], a[4],
                        *(x[0] if x else None for x in a[5:]))
            else:
                tag = f"paged_prefill_write_layers{n_layers}{suffix}"

                def fn(a=got):
                    kernels.paged_prefill_write_layers(*a)

            def plain(a=ref):
                kernels.paged_prefill_write_layers_plain(*a)

            fn()
            plain()
            torch.cuda.synchronize()
            if not same_bytes(torch, got, ref):
                fail(f"{tag} is not bitwise its plain version (payload and "
                     f"scales)")
            # the grouped wrapper checks ~200 tensors a call: its host
            # time can pass the default wait
            row = dict(err=0.0, ms=cuda_ms(fn, sleep=LONG_SLEEP_CYCLES),
                       plain_ms=cuda_ms(plain, sleep=LONG_SLEEP_CYCLES),
                       library_ms=None, library=None, copy_ms=None,
                       bound=c["bound"], shape=c["shape"])
            if pool == "bf16":
                lib_args = c["new"]()
                pk, pv, khs, vhs, pages = lib_args[:5]
                n_pages, ps = pages.shape[0], pk[0].shape[1]
                idx = pages.long()
                pairs = list(zip(pk, khs)) + list(zip(pv, vhs))

                def lib(pairs=pairs):
                    for dst, slab in pairs:
                        dst.index_copy_(0, idx, slab.view(
                            n_pages, ps, *slab.shape[2:]))
                lib()
                torch.cuda.synchronize()
                if not same_bytes(torch, lib_args, ref):
                    fail(f"{tag}: index_copy_ does not write what the plain "
                         f"version does")
                src = torch.empty(sum(t.numel() for t in khs + vhs),
                                  dtype=khs[0].dtype, device=khs[0].device)
                dst = torch.empty_like(src)
                row.update(library_ms=cuda_ms(lib, sleep=LONG_SLEEP_CYCLES),
                           library="index_copy_ of the page-reshaped slab, "
                                   "k and v of each layer",
                           copy_ms=cuda_ms(lambda: dst.copy_(src)))
                del lib_args, pairs, src, dst
            rows[tag] = row
            del c, got, ref
    return rows


def training_kernel_rows(torch, kernels, g):
    """Flash forward with its lse, flash backward and add + LayerNorm at
    the flagship's training shapes (bf16, non-causal attention), and the
    flash rows again at BERT-base's (phase 9) and, causal, at the MoE
    LM's (phase 10); errors scaled to the output's magnitude."""
    import torch.nn.functional as F

    h = FLAGSHIP["heads"]
    rows = flash_training_rows(torch, kernels, g, FLAGSHIP["batch"],
                               FLAGSHIP["seq"], h, FLAGSHIP["hidden"] // h,
                               "", entry_check=True)
    b, s = BERT_BASE["batch"], BERT_BASE["seq"]
    rows.update(flash_training_rows(
        torch, kernels, g, b, s, BERT_BASE["heads"],
        BERT_BASE["hidden"] // BERT_BASE["heads"], "_bert"))
    # the MoE LM's attention (phase 10): GLaM 0.1B/64E's heads, causal
    rows.update(flash_training_rows(
        torch, kernels, g, GLAM["batch"], GLAM["seq"], GLAM["heads"],
        GLAM["hidden"] // GLAM["heads"], "_moe_lm", causal=True))

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    b, s = FLAGSHIP["batch"], FLAGSHIP["seq"]
    n, dm = b * s, FLAGSHIP["hidden"]
    x, r = (torch.randn(n, dm, device=dev, generator=g).to(bf16)
            for _ in range(2))
    sc = (torch.rand(dm, device=dev, generator=g) + 0.5).to(bf16)
    bi = torch.randn(dm, device=dev, generator=g).to(bf16)
    got = kernels.fused_add_layernorm_fwd(x, r, sc, bi, 1e-5)
    ref = kernels.fused_add_layernorm_plain(x, r, sc, bi, 1e-5)
    torch.cuda.synchronize()
    err = scaled_err(got[1], ref[1])
    stats_err = max(scaled_err(a, b) for a, b in zip(got[2:], ref[2:]))
    if not (torch.equal(got[0], ref[0]) and err <= SCALED_TOL
            and stats_err <= 1e-5):
        fail(f"fused_add_layernorm_fwd disagrees with its plain version: "
             f"sum bitwise {torch.equal(got[0], ref[0])}, scaled err {err} "
             f"(limit {SCALED_TOL}), stats {stats_err} (limit 1e-5)")
    rows["fused_add_layernorm_fwd"] = dict(
        err=err,
        ms=cuda_ms(lambda: kernels.fused_add_layernorm_fwd(x, r, sc, bi,
                                                           1e-5)),
        plain_ms=cuda_ms(lambda: kernels.fused_add_layernorm_plain(
            x, r, sc, bi, 1e-5)),
        library_ms=cuda_ms(lambda: F.layer_norm(x + r, (dm,), sc, bi, 1e-5)),
        library="x + r, then F.layer_norm (two calls)",
        # x, r read, s, y written, scale/bias read, mean/rstd written;
        # ~9 f32 operations an element on the CUDA cores
        bound=bound(2 * 4 * n * dm + 2 * 2 * dm + 4 * 2 * n, 9 * n * dm,
                    F32_FLOP_PER_S),
        shape=f"x/r ({n},{dm}) bf16 with stats")
    return rows


def flash_training_rows(torch, kernels, g, b, s, h, d, suffix: str,
                        entry_check: bool = False, causal: bool = False):
    """The rows ``flash_attention_fwd_lse<suffix>`` and
    ``flash_attention_bwd<suffix>`` at q/k/v (b, s, h, d) bf16, non-causal
    or ``causal`` (a training step's shapes), with SDPA and its backward as
    yardsticks; ``entry_check`` also holds the backward with a caller's
    delta and an lse cotangent. A causal row's operations count the (q,
    k) pairs on and below the diagonal."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    scale = d ** -0.5
    rows = {}
    q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=g).to(bf16)
                   for _ in range(4))
    n_qkv = q.numel()
    shape = (f"q/k/v ({b},{s},{h},{d}) "
             f"{'causal' if causal else 'non-causal'} bf16")
    pairs = s * (s + 1) // 2 if causal else s * s

    o, lse = kernels.flash_attention_fwd(q, k, v, causal, scale,
                                         need_lse=True)
    ro, rlse = kernels.flash_attention_plain(q, k, v, causal, scale,
                                             need_lse=True)
    torch.cuda.synchronize()
    err = scaled_err(o, ro)
    lse_err = (lse - rlse).abs().max().item()
    if not (err <= SCALED_TOL and lse_err <= LSE_TOL):
        fail(f"flash_attention_fwd with lse disagrees with its plain "
             f"version: scaled err {err} (limit {SCALED_TOL}), lse err "
             f"{lse_err} (limit {LSE_TOL})")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rows["flash_attention_fwd_lse" + suffix] = dict(
        err=err,
        ms=cuda_ms(lambda: kernels.flash_attention_fwd(
            q, k, v, causal, scale, need_lse=True)),
        plain_ms=cuda_ms(lambda: kernels.flash_attention_plain(
            q, k, v, causal, scale, need_lse=True)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)),
        library="F.scaled_dot_product_attention",
        bound=bound(2 * 4 * n_qkv + 4 * lse.numel(), 4 * b * h * pairs * d),
        shape=shape + ", lse (B,H,S) f32")

    grads = kernels.flash_attention_bwd(q, k, v, o, lse, do, causal, scale)
    refs = kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                             scale)
    torch.cuda.synchronize()
    err = max(scaled_err(a, r) for a, r in zip(grads, refs))
    if not err <= BWD_TOL:
        fail(f"flash_attention_bwd disagrees with its plain version: "
             f"scaled err {err} (limit {BWD_TOL})")
    # the yardstick is SDPA's backward alone: its forward runs once here
    leaves = [x.transpose(1, 2).contiguous().requires_grad_()
              for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    lib_do = do.transpose(1, 2).contiguous()
    rows["flash_attention_bwd" + suffix] = dict(
        err=err,
        ms=cuda_ms(lambda: kernels.flash_attention_bwd(
            q, k, v, o, lse, do, causal, scale)),
        plain_ms=cuda_ms(lambda: kernels.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal, scale)),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            lib_out, leaves, lib_do, retain_graph=True)),
        library="F.scaled_dot_product_attention backward",
        # q, k, v, o, dO read, dq, dk, dv written; the five products
        bound=bound(2 * 8 * n_qkv + 4 * lse.numel(),
                    10 * b * h * pairs * d),
        shape=shape + ", o/dO/lse -> dq/dk/dv")

    if not entry_check:
        return rows
    # the Pallas backward's delta_precomputed / dlse entry: a caller's delta
    # skips the delta kernel, an lse cotangent is folded into delta
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dlse = torch.randn(lse.shape, device=dev, generator=g)
    grads = kernels.flash_attention_bwd(q, k, v, o, lse, do, False, scale,
                                        delta=delta, dlse=dlse)
    refs = kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, False,
                                             scale, delta=delta, dlse=dlse)
    torch.cuda.synchronize()
    err = max(scaled_err(a, r) for a, r in zip(grads, refs))
    if not err <= BWD_TOL:
        fail(f"flash_attention_bwd with delta and dlse disagrees with its "
             f"plain version: scaled err {err} (limit {BWD_TOL})")
    say(f"kernel flash_attention_bwd with a given delta and dlse: {shape}: "
        f"scaled err {err:.3g} (limit {BWD_TOL})")
    return rows


def moe_serve_kernel_rows(torch, kernels, g):
    """Kernels 1, 4 and 5 at the shapes of phase 10's MoE serve (12 heads
    of 64, no GQA, 4 slots of 512-token prompts and 64 new tokens on the
    native bf16 pool, 12 layers): the prefill's flash forward, a decode
    step's paged attention (5 pages a slot, 540-575 live positions) and
    the prefill write of all 12 layers in one launch."""
    h, d = GLAM["heads"], GLAM["hidden"] // GLAM["heads"]
    rows = {"flash_attention_fwd_moe_serve": flash_serve_row(
        torch, kernels, g, h, h, d, MOE_SERVE["prompt"])}
    p = MOE_SERVE["prompt"]
    geom = dict(heads=h, kv_heads=h, d=d, pages=-(-(
        p + MOE_SERVE["new"]) // ENGINE["kv_page_size"]),
        lens=([p] * 4, [p] * 4, [p + 27, p + 47, p + 63, p + 37]))
    rows.update(paged_attention_rows(
        torch, kernels, g, (("paged_attention_fwd_moe_serve", "bf16",
                             False),), geom))
    rows.update(prefill_write_rows(
        torch, kernels, g, pools=(("", "bf16"),),
        layer_counts=(GLAM["layers"],), tag_suffix="_moe_serve", kvh=h,
        d=d))
    return rows


#: phase 3's fused-update rows at the flagship's bucket: (row, rule, state
#: form, bytes an element moves in bf16 (w, g read, w written, plus v or m
#: and v read and written), f32 operations an element)
UPDATE_ROWS = (("fused_update", dict(kind="sgd"), "flat", 6, 2),
               ("fused_update_per_leaf", dict(kind="sgd"), "per_leaf", 6, 2),
               ("fused_update_momentum", dict(kind="sgd", momentum=0.9),
                "flat", 10, 4),
               ("fused_update_adam", dict(kind="adam"), "flat", 14, 12),
               ("fused_update_adam_per_leaf", dict(kind="adam"), "per_leaf",
                14, 12))
UPDATE_CALLER = {"flat": "FusedUpdate", "per_leaf": "the per-leaf Optimizer"}
#: the plain version runs this many elements' leaves at a time (for memory)
PLAIN_CHUNK = 1 << 28


def flagship_leaf_shapes(port):
    """The full-width flagship's weight shapes, in walk order (no weights
    allocated)."""
    from flexflow_tpu_torch.models import build_encoder_classifier

    f = FLAGSHIP
    ff = port.FFModel(port.FFConfig(batch_size=f["batch"], use_fused_ln=True),
                      device="cuda")
    build_encoder_classifier(ff, f["batch"], f["seq"], f["hidden"],
                             f["layers"], f["heads"], f["ffn_mult"],
                             f["num_classes"])
    return [s for ws in ff.weight_shapes().values() for s in ws.values()]


def update_case(torch, g, rule, shapes, form="flat"):
    """bf16 weights ~N(0, 1), grads ~N(0, 1e-4), state: momentum ~N(0,
    1e-4), Adam's m ~N(0, 1e-4) and v its square's scale; flat (a vector a
    moment) or per leaf (a tensor of each weight's shape a moment)."""
    bf16 = torch.bfloat16
    ps = [torch.randn(s, device="cuda", generator=g).to(bf16) for s in shapes]
    gs = [torch.randn(s, device="cuda", generator=g).mul_(1e-2).to(bf16)
          for s in shapes]
    total = sum(p.numel() for p in ps)
    ms = []
    for i in range(rule.n_moments):
        m = torch.empty(total, dtype=bf16, device="cuda")
        for lo in range(0, total, PLAIN_CHUNK):
            x = torch.randn(min(PLAIN_CHUNK, total - lo), device="cuda",
                            generator=g).mul_(1e-2)
            v_of_adam = rule.kind == "adam" and i == 1
            m[lo:lo + x.numel()] = x.square_() if v_of_adam else x
        if form == "per_leaf":
            m = [m[lo:lo + p.numel()].clone().view(p.shape) for p, lo in
                 zip(ps, itertools.accumulate([0] + [p.numel() for p in ps]))]
        ms.append(m)
    return ps, gs, ms


def leaf_state(torch, ps, m):
    """State ``m`` of either form as one tensor of each weight's shape."""
    if not torch.is_tensor(m):
        return m
    offs = itertools.accumulate([0] + [p.numel() for p in ps])
    return [m[lo:lo + p.numel()].view(p.shape) for p, lo in zip(ps, offs)]


def _groups(ps, limit):
    """Runs of consecutive leaves of at most ``limit`` elements (or one
    leaf), with their offsets into the flat state."""
    out, lo, cur, off = [], 0, [], 0
    for i, p in enumerate(ps):
        if cur and off + p.numel() - lo > limit:
            out.append((cur, lo, off))
            cur, lo = [], off
        cur.append(i)
        off += p.numel()
    out.append((cur, lo, off))
    return out


#: the fused update at ResNet-50's leaves (phase 9's per-leaf SGD: 214
#: leaves of 64 .. 2.4 M elements, two launches a step)
RESNET_UPDATE_ROWS = (("fused_update_resnet50", dict(kind="sgd"),
                       "per_leaf", 6, 2),)


def resnet50_leaf_shapes(port):
    """ResNet-50's weight shapes at 224 x 224 and 1000 classes, in walk
    order (no weights allocated)."""
    from flexflow_tpu_torch.models import resnet50

    ff = port.FFModel(port.FFConfig(batch_size=1), device="cuda")
    resnet50(ff, 1)
    return [s for ws in ff.weight_shapes().values() for s in ws.values()]


def fused_update_rows(torch, port, kernels, g, shapes=None,
                      cases=UPDATE_ROWS, where="the flagship's bucket"):
    """The fused update at the flagship's bucket (1.21 B bf16 weights in
    its ~100 leaves), SGD, SGD with momentum and Adam on flat state (as
    FusedUpdate keeps it), and SGD (no state) and Adam on per-leaf state
    as the per-leaf optimizer calls it: bitwise against the per-leaf torch formula
    (optimizer.py apply_update_plain, which nothing on the card's main
    path runs) and against its plain version (run a few leaves at a time,
    which is the same elementwise function); times beside the per-leaf
    torch formula, torch._foreach_* of the same formula and a device copy
    of the same bytes; the share of the bytes on the vector path, counted
    by the kernel on the card."""
    from flexflow_tpu_torch.runtime.optimizer import apply_update_plain

    shapes = shapes or flagship_leaf_shapes(port)
    n = sum(math.prod(s) for s in shapes)
    rows = {}
    for name, kw, form, bytes_per, ops_per in cases:
        rule = kernels.UpdateRule(**kw)
        ps, gs, ms = update_case(torch, g, rule, shapes, form)
        if rule.kind == "adam":
            lr = port.AdamOptimizer(alpha=1e-3).lr_of(
                torch.zeros((), dtype=torch.int32, device="cuda"))
        else:
            lr = torch.full((), TRAIN_LR, device="cuda")
        groups = _groups(ps, PLAIN_CHUNK)

        def per_leaf(ps, ms):
            views = [leaf_state(torch, ps, m) for m in ms]
            for i, (p, gr) in enumerate(zip(ps, gs)):
                apply_update_plain(rule, p, gr, [v[i] for v in views], lr)

        def plain(ps, ms):
            for idx, lo, hi in groups:
                kernels.fused_update_plain(
                    rule, [ps[i] for i in idx], [gs[i] for i in idx],
                    [m[lo:hi] if torch.is_tensor(m) else [m[i] for i in idx]
                     for m in ms], lr)

        def clone(ms):
            return [m.clone() if torch.is_tensor(m) else [x.clone() for x in m]
                    for m in ms]

        def flat(ts):
            return [x for t in ts for x in ([t] if torch.is_tensor(t) else t)]

        ref = ([p.clone() for p in ps], clone(ms))
        pln = ([p.clone() for p in ps], clone(ms))
        # the elements the kernel's 16-byte path stored, counted on the card
        # (every array of a row is bf16, so it is the share of the bytes
        # too), and the plan's count, which it must equal
        counted = torch.zeros(1, dtype=torch.int64, device="cuda")
        kernels.fused_update(rule, ps, gs, ms, lr, vector_count=counted)
        planned = sum(sum(kernels.fused_update_vector_elements(x.plan))
                      for x in kernels.fused_update_launches(ps, gs, ms))
        per_leaf(*ref)
        plain(*pln)
        torch.cuda.synchronize()
        bits = lambda ts: [t.view(torch.int16) for t in ts]  # noqa: E731
        for tag, (rp, rm) in (("the per-leaf torch formula", ref),
                              ("its plain version", pln)):
            if not all(torch.equal(a, b) for a, b in
                       zip(bits(ps + flat(ms)), bits(rp + flat(rm)))):
                fail(f"{name}: the kernel is not bitwise {tag}")
        counted = int(counted.item())
        if counted != planned:
            fail(f"{name}: the kernel stored {counted} elements on its "
                 f"vector path, its plan {planned}")
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(ps, pln[0]))
        del ref, pln
        lr_f = lr.item()
        mv = [leaf_state(torch, ps, m) for m in ms]

        def foreach():
            if rule.kind == "adam":
                m, v = mv
                torch._foreach_mul_(m, rule.beta1)
                torch._foreach_add_(m, gs, alpha=1 - rule.beta1)
                torch._foreach_mul_(v, rule.beta2)
                torch._foreach_addcmul_(v, gs, gs, value=1 - rule.beta2)
                den = torch._foreach_sqrt(v)
                torch._foreach_add_(den, rule.epsilon)
                torch._foreach_addcdiv_(ps, m, den, value=-lr_f)
            elif rule.momentum:
                (v,) = mv
                torch._foreach_mul_(v, rule.momentum)
                torch._foreach_add_(v, gs)
                torch._foreach_add_(ps, v, alpha=-lr_f)
            else:
                torch._foreach_add_(ps, gs, alpha=-lr_f)

        nbytes = bytes_per * n
        rows[name] = dict(
            err=err,
            # the long wait hides the wrapper's host time (~100 leaves'
            # addresses a call)
            ms=cuda_ms(lambda: kernels.fused_update(rule, ps, gs, ms, lr),
                       iters=5, warmup=1, sleep=LONG_SLEEP_CYCLES),
            per_leaf_ms=cuda_ms(lambda: per_leaf(ps, ms), iters=3,
                                warmup=1, sleep=LONG_SLEEP_CYCLES),
            plain_ms=cuda_ms(lambda: plain(ps, ms), iters=3, warmup=1),
            library_ms=cuda_ms(foreach, iters=3, warmup=1,
                               sleep=LONG_SLEEP_CYCLES),
            library="torch._foreach_* of the formula (bf16 storage)",
            vector_share=counted / n,
            bound=bound(nbytes, ops_per * n, F32_FLOP_PER_S),
            shape=f"{len(shapes)} leaves, {n / 1e9:.3f} B bf16 elements, "
                  f"{rule.kind}" + (" momentum" if rule.momentum else "")
                  + (", no state" if not ms else
                     f", {form.replace('_', '-')} state")
                  + f", as {UPDATE_CALLER[form]} calls it at {where}")
        del ps, gs, ms, mv
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        rows[name]["copy_ms"] = cuda_ms(lambda: dst.copy_(src), iters=5,
                                        warmup=1)
        del src, dst
        torch.cuda.empty_cache()
    return rows


def build_llama(FFConfig, FFModel, llama_lm, device, dtype: str, seed: int,
                **arch):
    ff = FFModel(FFConfig(batch_size=ENGINE["serve_slots"],
                          compute_dtype=dtype, seed=seed), device=device)
    _, logits = llama_lm(ff, ENGINE["serve_slots"],
                         seq_len=ENGINE["max_seq_len"], **arch)
    ff.compile(final_tensor=logits)
    return ff


def phase_check(torch, FFConfig, FFModel, llama_lm, kernels):
    """Small f32 model: card (kernels) vs CPU (plain versions) on a native
    pool, on an int8 pool with the prefix cache (two rounds of prompts
    sharing a 2-page prefix on one engine) and on a bf16 pool. Returns the
    launches of the int8 and the bf16 serves."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = dict(hidden=512, layers=2, heads=4, kv_heads=2, ffn_hidden=1024,
                vocab_size=1000, rope_theta=500000.0)
    cpu = build_llama(FFConfig, FFModel, llama_lm, "cpu", "float32",
                      1, **arch)
    gpu = build_llama(FFConfig, FFModel, llama_lm, "cuda",
                      "float32", 1, **arch)
    gpu.params = {op: {w: t.to("cuda") for w, t in ws.items()}
                  for op, ws in cpu.params.items()}
    import numpy as np

    def same(tag, ref, got):
        if any(o is None for o in ref + got):
            fail(f"small-model check ({tag}): a request failed")
        for i, (a, b) in enumerate(zip(ref, got)):
            if not np.array_equal(a, b):
                fail(f"small-model check ({tag}): prompt {i} tokens differ "
                     f"card vs CPU: {b[-8:].tolist()} vs {a[-8:].tolist()}")

    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, arch["vocab_size"], size=n).astype(np.int32)
               for n in (5, 30, 77, 130)]
    kw = dict(ENGINE, decode_buckets=None)
    ref, _ = cpu.serve(prompts, max_new_tokens=8, **kw)
    got, st = gpu.serve(prompts, max_new_tokens=8, **kw)
    if st["kernel_launches"]["paged_attention_fwd"] == 0:
        fail("small-model check did not reach the kernels")
    same("native", ref, got)

    # int8 pool under the prefix cache: one engine, two rounds
    system = rs.randint(0, arch["vocab_size"], size=2 * kw["kv_page_size"])
    shared = [np.concatenate([system, rs.randint(
        0, arch["vocab_size"], size=n)]).astype(np.int32) for n in (5, 40, 99)]
    engines = [m.make_serving_engine(kv_cache_dtype="int8", **kw)
               for m in (cpu, gpu)]
    kernels.reset_launch_counts()
    for rnd in range(2):
        outs = [[r.output for r in e.run(shared, max_new_tokens=8)]
                for e in engines]
        same(f"int8 pool, prefix cache, round {rnd + 1}", *outs)
    launches = {"check_int8": kernels.launch_counts()}
    sts = [e.stats() for e in engines]
    if not (sts[1]["prefix_hits"] > 0
            and sts[0]["prefix_hits"] == sts[1]["prefix_hits"]):
        fail(f"small-model check (int8): prefix hits card "
             f"{sts[1]['prefix_hits']}, CPU {sts[0]['prefix_hits']}")
    if launches["check_int8"]["paged_prefill_write"] == 0:
        fail("small-model check (int8) did not reach the kernels")

    # bf16 pool under f32 compute: the mixed-width kernel
    ref, _ = cpu.serve(shared, max_new_tokens=8, kv_cache_dtype="bf16", **kw)
    kernels.reset_launch_counts()
    got, _ = gpu.serve(shared, max_new_tokens=8, kv_cache_dtype="bf16", **kw)
    launches["check_bf16"] = kernels.launch_counts()
    same("bf16 pool", ref, got)
    say(f"check: small f32 Llama, card through the kernels == CPU plain "
        f"versions on {len(prompts)} prompts x 8 tokens (native pool), on "
        f"{len(shared)} shared-prefix prompts x 8 tokens twice (int8 pool, "
        f"prefix cache: {sts[1]['prefix_hits']} hits of "
        f"{sts[1]['prefix_lookups']}) and once more (bf16 pool)")
    check_routes(torch, FFConfig, FFModel, kernels)
    return launches


#: the attention op's torch routes (shapes the flash kernels do not take):
#: (q seq, kv seq, embed, heads, kv heads, vdim, causal, use_flash_attention)
ROUTE_CASES = {
    "head dim 48, GQA": (10, 10, 96, 2, 1, 0, True, True),
    "q / v head dims 32 / 16": (9, 9, 64, 2, 0, 32, False, True),
    "causal, 6 queries over 3 keys": (6, 3, 64, 1, 0, 0, True, True),
    "use_flash_attention=False": (12, 12, 64, 2, 0, 0, True, False),
    "blockwise, 4160 positions": (4160, 4160, 16, 2, 0, 0, True, True),
}


def check_routes(torch, FFConfig, FFModel, kernels):
    """One small f32 case of each torch route on the card — the attention
    op on shapes the flash kernels do not take, or under
    use_flash_attention=False, and add + LayerNorm on rows the kernel does
    not take (width 1004) — against the same op on the CPU: outputs within
    2e-5, each gradient within 1e-4 of its largest value (the key bias's,
    zero in exact arithmetic, below 1e-5 of the op's largest gradient),
    and no launch of the kernels it routes around."""
    def build(kind, b, case):
        ff = FFModel(FFConfig(batch_size=b, use_flash_attention=case[-1]),
                     device="cuda")
        if kind == "attention":
            sq, sk, e, h, kvh, vdim, causal, _ = case
            q, kv = ff.create_tensor((b, sq, e)), ff.create_tensor((b, sk, e))
            ff.multihead_attention(q, kv, kv, e, h, vdim=vdim, causal=causal,
                                   num_kv_heads=kvh)
            dims = (q.dims, kv.dims, kv.dims)
        else:
            x = ff.create_tensor((b, 5, 1004))
            ff.add_layer_norm(x, x)
            dims = (x.dims, x.dims)
        ff.compile(final_tensor=ff.ops[-1].outputs[0])
        return ff.ops[-1], ff.params[ff.ops[-1].name], dims

    cases = [("attention", n, c) for n, c in ROUTE_CASES.items()]
    cases.append(("add + LayerNorm", "width 1004", (True,)))
    g = torch.Generator(device="cuda").manual_seed(7)
    for kind, name, case in cases:
        b = 1 if name.startswith("blockwise") else 2
        op, params, dims = build(kind, b, case)
        outs, grads = [], []
        for dev in ("cuda", "cpu"):
            ps = {k: v.detach().to(dev).requires_grad_()
                  for k, v in params.items()}
            if dev == "cuda":
                xs = [torch.randn(*dm, device="cuda", generator=g)
                      for dm in dims]
                kernels.reset_launch_counts()
            xl = [x.to(dev).requires_grad_() for x in xs]
            out = op.forward(ps, xl, training=True)
            if dev == "cuda":
                cots = [torch.randn(o.shape, device="cuda", generator=g)
                        for o in out]
                launches = kernels.launch_counts()
            outs.append([o.detach().cpu() for o in out])
            grads.append([t.cpu() for t in torch.autograd.grad(
                out, list(ps.values()) + xl, [c.to(dev) for c in cots])])
        if any(launches.values()):
            fail(f"route check {kind} ({name}) launched kernels: {launches}")
        err = max((a - b).abs().max().item() for a, b in zip(*outs))
        top = max(w.abs().max().item() for w in grads[1])
        gerr = 0.0
        for pname, a, w in zip(list(params) + ["inputs"] * len(dims),
                               *grads):
            scale = w.abs().max().item()
            if pname == "bias_k":
                if max(a.abs().max().item(), scale) > 1e-5 * top:
                    fail(f"route check {kind} ({name}): the key bias's "
                         f"gradient is not round-off")
                continue
            gerr = max(gerr, (a - w).abs().max().item() / scale)
        if not (err <= 2e-5 and gerr <= 1e-4):
            fail(f"route check {kind} ({name}): card vs CPU output {err} "
                 f"(limit 2e-5), gradients {gerr} relative (limit 1e-4)")
        say(f"check: {kind} torch route ({name}) on the card == CPU: output "
            f"{err:.2e}, gradients {gerr:.2e} relative, no kernel launch")


def build_flagship(port, device, dtype: str, seed: int, batch, seq, hidden,
                   layers, heads, ffn_mult, num_classes, opt=None, **cfg):
    """The flagship encoder classifier (models/transformer.py), fused add +
    LayerNorm, compiled for training (SGD unless ``opt``), sparse
    cross-entropy and accuracy as __graft_entry__.py compiles the JAX
    one; ``cfg``: more FFConfig fields."""
    from flexflow_tpu_torch.models import build_encoder_classifier

    ff = port.FFModel(port.FFConfig(batch_size=batch, seed=seed,
                                    compute_dtype=dtype, master_dtype=dtype,
                                    use_fused_ln=True, **cfg), device=device)
    x, out = build_encoder_classifier(ff, batch, seq, hidden, layers, heads,
                                      ffn_mult, num_classes)
    ff.compile(opt or port.SGDOptimizer(lr=TRAIN_LR),
               port.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [port.MetricsType.METRICS_ACCURACY], final_tensor=out)
    return ff, x


def copy_weights(dst, params):
    """A copy of ``params`` ({op: {weight: tensor}}) as dst's weights, on
    dst's device; dst's optimizer state fresh."""
    dst.params = {op: {w: t.detach().to(dst.device).clone()
                       for w, t in ws.items()}
                  for op, ws in params.items()}
    dst.opt_state = dst.optimizer.init_state(dst.params)


def same_bits(a, b) -> bool:
    """Two {op: {weight: tensor}} trees equal bit for bit."""
    import torch

    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    return all(torch.equal(bits(a[op][w]), bits(t))
               for op, ws in b.items() for w, t in ws.items())


def weight_diff(a, b, skip=()) -> float:
    return max((a.params[op][w].detach().cpu() - t.detach().cpu()).abs()
               .max().item() for op, ws in b.params.items()
               for w, t in ws.items() if w not in skip)


#: phase 5's variants: (name, optimizer factory, FFConfig fields)
TRAIN_CHECK_VARIANTS = (
    ("SGD", lambda port: port.SGDOptimizer(lr=TRAIN_LR), {}),
    ("Adam under WarmupCosine",
     lambda port: port.AdamOptimizer(alpha=1e-3,
                                     schedule=port.WarmupCosine(1, 10)), {}),
    ("fused SGD with momentum",
     lambda port: port.SGDOptimizer(lr=TRAIN_LR, momentum=0.9),
     dict(fused_optimizer=True)),
    ("grad_accum_steps=2", lambda port: port.SGDOptimizer(lr=TRAIN_LR),
     dict(grad_accum_steps=2)),
    ("on_nonfinite=skip, a NaN at step 2",
     lambda port: port.SGDOptimizer(lr=TRAIN_LR), dict(on_nonfinite="skip")),
    ("scan_steps=3 (CUDA graph replay)",
     lambda port: port.SGDOptimizer(lr=TRAIN_LR, momentum=0.9),
     dict(scan_steps=3, fused_optimizer=True)),
)
# Adam's key biases have an exact gradient of zero (softmax ignores a
# shift of every key): card and CPU feed Adam rounding noise there, which
# it normalises to steps of up to ~alpha; they are held to 2 alpha a step
ADAM_NOISE_ATOL = 3 * 2 * 1e-3


def phase_train_check(torch, port, kernels):
    """Small f32 flagship, card (kernels) vs CPU (plain branches) from the
    same weights, 3 steps of each variant of TRAIN_CHECK_VARIANTS; the
    fused update on the card bitwise the per-leaf torch formula and the
    per-leaf optimizer on the card; the
    skipped step bitwise a no-op; the scanned steps replay a CUDA graph.
    Returns {variant name: launch counts}."""
    import numpy as np

    arch = dict(batch=4, seq=128, hidden=512, layers=2, heads=4, ffn_mult=4,
                num_classes=16)
    rs = np.random.RandomState(3)
    xs = rs.randn(12, arch["seq"], arch["hidden"]).astype(np.float32)
    ys = rs.randint(0, 16, (12, 1)).astype(np.int32)
    batches = [{"input": xs[4 * i:4 * i + 4], "label": ys[4 * i:4 * i + 4]}
               for i in range(3)]
    out = {}
    for name, opt, cfg in TRAIN_CHECK_VARIANTS:
        cpu, _ = build_flagship(port, "cpu", "float32", 3, **arch,
                                opt=opt(port), **cfg)
        gpu, gx = build_flagship(port, "cuda", "float32", 3, **arch,
                                 opt=opt(port), **cfg)
        copy_weights(gpu, cpu.params)
        start = {op: {w: t.clone() for w, t in ws.items()}
                 for op, ws in cpu.params.items()}
        copy_weights(cpu, start)
        guard = "on_nonfinite" in cfg
        scan = "scan_steps" in cfg
        if scan:
            port.SingleDataLoader(gpu, gx, xs)
            port.SingleDataLoader(gpu, gpu.label_tensor, ys)
        kernels.reset_launch_counts()
        if scan:
            gl = [float(v) for v in gpu.train_scanned(3)[0]]
        worst = 0.0
        for i, batch in enumerate(batches):
            nan = guard and i == 1
            if nan:
                before = {op: {w: t.clone() for w, t in ws.items()}
                          for op, ws in gpu.params.items()}
            lc = float(cpu._run_train_step(batch, inject_nan=nan)[0])
            lg = gl[i] if scan else float(
                gpu._run_train_step(batch, inject_nan=nan)[0])
            if nan:
                if not (np.isnan(lg) and np.isnan(lc)
                        and same_bits(before, gpu.params)
                        and int(gpu._guard_state["skipped"]) == 1):
                    fail(f"train check ({name}): the NaN step was not "
                         f"skipped bitwise on the card")
                continue
            if not (np.isfinite(lg)
                    and abs(lg - lc) <= TRAIN_LOSS_RTOL * abs(lc)):
                fail(f"train check ({name}): step {i} loss on the card "
                     f"{lg} vs the CPU {lc} (limit {TRAIN_LOSS_RTOL} "
                     f"relative)")
            worst = max(worst, abs(lg - lc) / abs(lc))
        adam = name.startswith("Adam")
        diff = weight_diff(gpu, cpu, skip=("bias_k",) if adam else ())
        noise = weight_diff(gpu, cpu)
        if not (diff <= TRAIN_PARAM_ATOL and noise <= (
                ADAM_NOISE_ATOL if adam else TRAIN_PARAM_ATOL)):
            fail(f"train check ({name}): weights after 3 steps differ card "
                 f"vs CPU by {diff} (limit {TRAIN_PARAM_ATOL}; all weights "
                 f"{noise})")
        launches = kernels.launch_counts()
        micro = 2 if cfg.get("grad_accum_steps") else 1
        # one update launch a step, per-leaf or fused (the guard's skipped
        # step launches it too, and it writes nothing)
        want = dict(flash_attention_fwd=2 * micro * 3,
                    flash_attention_bwd=2 * micro * 3,
                    fused_add_layernorm_fwd=4 * micro * 3, fused_update=3)
        if any(launches[k] != v for k, v in want.items()):
            fail(f"train check ({name}) did not run through the kernels: "
                 f"{launches} (want {want})")
        out[name] = launches
        extra = ""
        if cfg.get("fused_optimizer") and not scan:
            # from the same weights and batches on the card: the per-leaf
            # torch formula (Optimizer.update_plain, apply_update_plain leaf
            # by leaf, no kernel), and the per-leaf optimizer (the same
            # kernel on per-leaf state); the fused run bitwise both
            for tag, plain in (("the per-leaf torch formula", True),
                               ("the per-leaf optimizer", False)):
                per, _ = build_flagship(port, "cuda", "float32", 3, **arch,
                                        opt=opt(port))
                if plain:
                    per.optimizer.update = per.optimizer.update_plain
                copy_weights(per, start)
                n0 = kernels.fused_update.launches
                for batch in batches:
                    per._run_train_step(batch)
                ran = kernels.fused_update.launches - n0
                if ran != (0 if plain else 3):
                    fail(f"train check ({name}): {tag} on the card launched "
                         f"the update kernel {ran} times")
                if not same_bits(per.params, gpu.params):
                    fail(f"train check ({name}): the fused update on the "
                         f"card is not bitwise {tag} on the card")
                del per
            extra = ("; bitwise the per-leaf torch formula and the per-leaf "
                     "optimizer on the card")
        if scan:
            per, _ = build_flagship(port, "cuda", "float32", 3, **arch,
                                    opt=opt(port), **cfg)
            copy_weights(per, start)
            for batch in batches:
                per._run_train_step(batch)
            extra = (f"; {gpu._replay.replays} graph replays; vs the card's "
                     f"per-step path: weights within "
                     f"{weight_diff(gpu, per):.2e} (bitwise: "
                     f"{same_bits(per.params, gpu.params)})")
            del per
        say(f"train check ({name}): small f32 flagship, 3 steps, card "
            f"through the kernels vs CPU plain branches: losses within "
            f"{worst:.2e} relative, weights within {diff:.2e}"
            + (f" (key biases, Adam's normalised noise: {noise:.2e})"
               if adam else "") + extra)
        del cpu, gpu, start
    return out


def phase_serve(torch, FFConfig, FFModel, llama_lm, kernels, card: str):
    import numpy as np

    layers = LLAMA3_8B["layers"]
    t0 = time.perf_counter()
    ff = build_llama(FFConfig, FFModel, llama_lm, "cuda", "bfloat16",
                     0, **LLAMA3_8B)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for ws in ff.params.values()
                   for t in ws.values())
    say(f"serve: Llama-3-8B widths, {layers} layers, {n_params / 1e9:.3f} B "
        f"params bf16, built in {time.perf_counter() - t0:.1f} s")
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, LLAMA3_8B["vocab_size"], size=n).astype(np.int32)
               for n in PROMPT_LENS]

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs, st = ff.serve(prompts, max_new_tokens=MAX_NEW, **ENGINE)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if any(o is None for o in outs) or st["completed"] != len(prompts):
        fail(f"serve: not every request finished with finite logits: {st}")
    want = {"flash_attention_fwd": layers * len(prompts),
            "paged_prefill_write": len(prompts),
            "paged_attention_fwd": layers * st["decode_steps"],
            "flash_attention_bwd": 0, "fused_add_layernorm_fwd": 0,
            "fused_update": 0}
    if launches != want:
        fail(f"serve: kernel launches {launches} != expected {want}")
    for o, n in zip(outs, PROMPT_LENS):
        if o.shape != (n + MAX_NEW,):
            fail(f"serve: output shape {o.shape} for a {n}-token prompt")

    t0 = time.perf_counter()
    outs2, st2 = ff.serve(prompts, max_new_tokens=MAX_NEW, **ENGINE)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(outs, outs2)):
        fail("serve: a second serve of the same prompts gave other tokens")
    for tag, wall, s in (("first", wall1, st), ("second", wall2, st2)):
        say(f"serve {tag}: {s['tokens_generated']} tokens in {wall:.3f} s = "
            f"{s['tokens_generated'] / wall:.2f} tokens/s [{card}]")
        say(f"serve {tag}: TTFT p50 {s['ttft_p50_ms']:.1f} ms, p99 "
            f"{s['ttft_p99_ms']:.1f} ms [{card}]")
        say(f"serve {tag}: decode step {s['decode_step_ms']:.2f} ms over "
            f"{s['decode_steps']} steps of {ENGINE['serve_slots']} slots "
            f"[{card}]")
    say(f"serve: launches {launches}")
    say(f"serve: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    return launches, ff


def _serve_round(torch, kernels, eng, prompts, layers):
    """One run() of ``prompts`` on ``eng`` with the launch counts set to 0
    just before: its requests, wall time, stats deltas and launches; fails
    unless each kernel ran exactly its expected count."""
    import numpy as np

    before = eng.stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = eng.run(prompts, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    st = eng.stats()
    d = {k: st[k] - before[k] for k in ("prefix_lookups", "prefix_hits",
                                        "decode_steps", "tokens_generated")}
    if any(r.state != "done" for r in reqs):
        fail(f"serve quantized: not every request finished with finite "
             f"logits: {[r.state for r in reqs]}")
    cold = d["prefix_lookups"] - d["prefix_hits"]
    want = {"flash_attention_fwd": layers * cold,
            "paged_prefill_write": d["prefix_lookups"],
            "paged_attention_fwd": layers * d["decode_steps"],
            "flash_attention_bwd": 0, "fused_add_layernorm_fwd": 0,
            "fused_update": 0}
    if launches != want:
        fail(f"serve quantized: kernel launches {launches} != expected "
             f"{want}")
    if st["prefix_refs_live"] != 0 \
            or st["free_pages"] + st["kv_pages_cached"] != st["kv_pages"] - 1:
        fail(f"serve quantized: pages leaked: refs {st['prefix_refs_live']},"
             f" free {st['free_pages']} + cached {st['kv_pages_cached']} != "
             f"{st['kv_pages']} - 1")
    # decode step ms of this round: the engine's running mean, unwound
    step_ms = ((st["decode_step_ms"] * st["decode_steps"]
                - before["decode_step_ms"] * before["decode_steps"])
               / max(1, d["decode_steps"]))
    ttfts = sorted(r.ttft * 1e3 for r in reqs)
    return dict(reqs=reqs, wall=wall, launches=launches, delta=d, st=st,
                step_ms=step_ms, ttft_p50=ttfts[len(ttfts) // 2],
                ttft_p99=ttfts[min(len(ttfts) - 1,
                                   int(0.99 * len(ttfts)))],
                tokens=[np.asarray(r.tokens) for r in reqs])


def phase_serve_quantized(torch, ff, kernels, card: str):
    """Phase 6b: the Llama-3-8B model of phase 6 serves shared-prefix
    prompts twice on one engine per quantized configuration."""
    import numpy as np

    layers = LLAMA3_8B["layers"]
    rs = np.random.RandomState(5)
    vocab = LLAMA3_8B["vocab_size"]
    prefix = rs.randint(0, vocab, size=QUANT_PREFIX)
    prompts = [np.concatenate([prefix, rs.randint(0, vocab, size=n)])
               .astype(np.int32) for n in QUANT_TAILS]
    ref_eng = ff.make_serving_engine(**ENGINE)
    ref = _serve_round(torch, kernels, ref_eng, prompts, layers)
    say(f"serve quantized: native pool reference: {ref['delta']} in "
        f"{ref['wall']:.3f} s, decode step {ref['step_ms']:.2f} ms "
        f"[{card}]")
    del ref_eng
    launches = {}
    for name, knobs in QUANT_CONFIGS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ff.make_serving_engine(**ENGINE, **knobs)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        total = {}
        for rnd in (1, 2):
            r = _serve_round(torch, kernels, eng, prompts, layers)
            hits = r["delta"]["prefix_hits"]
            if hits < (len(prompts) - 1 if rnd == 1 else len(prompts)):
                fail(f"serve quantized {name}: round {rnd} had {hits} "
                     f"prefix hits of {len(prompts)}")
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
            agree = float(np.mean([np.mean(a == b) for a, b in
                                   zip(r["tokens"], ref["tokens"])]))
            st = r["st"]
            n_tok = r["delta"]["tokens_generated"]
            say(f"serve quantized {name} round {rnd}: {n_tok} tokens in "
                f"{r['wall']:.3f} s = {n_tok / r['wall']:.2f} tokens/s, "
                f"TTFT p50 {r['ttft_p50']:.1f} ms p99 {r['ttft_p99']:.1f} "
                f"ms, decode step {r['step_ms']:.2f} ms over "
                f"{r['delta']['decode_steps']} steps, {hits} hits "
                f"[{card}]")
            say(f"serve quantized {name} round {rnd}: token agreement with "
                f"the native pool {agree:.3f} (positionwise, not gated)")
        say(f"serve quantized {name}: kv {st['kv_cache_dtype']}, weights "
            f"{st['weight_dtype']}, {st['kv_bytes_per_token']} KV bytes a "
            f"token, {st['kv_capacity_vs_bf16']}x a bf16 pool's tokens, "
            f"pool {st['kv_pool_bytes'] / 2**20:.1f} MiB, engine built in "
            f"{build_s:.2f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        say(f"serve quantized {name}: launches over both rounds {total}")
        launches[f"serve_{name}"] = total
        del eng
    return launches


def kernel_class(name: str) -> str:
    """Where a device kernel of a training step belongs."""
    low = name.lower()
    # cuDNN's convolutions (implicit-GEMM fprop / dgrad / wgrad kernels
    # and their layout transposes); checked before cuBLAS, whose GEMMs
    # share the xmma / cutlass names
    if any(k in low for k in ("cudnn", "fprop", "dgrad", "wgrad", "conv",
                              "implicit_gemm", "nchwtonhwc", "nhwctonchw")):
        return "cuDNN conv"
    if "batch_norm" in low or "batchnorm" in low:
        return "BatchNorm"
    if "pool" in low:
        return "pooling"
    # flash_fwd_wgmma_kernel (bf16), flash_fwd_simt_kernel (f32)
    if "flash_fwd_" in name:
        return "flash forward"
    # flash_bwd_dq/dkv_wgmma_kernel (bf16), dq/dkv_simt_kernel (f32), and
    # the delta kernel of both
    if any(k in name for k in ("flash_bwd_", "dq_simt_kernel",
                               "dkv_simt_kernel", "delta_kernel")):
        return "flash backward"
    if "add_ln_fwd_kernel" in name:
        return "add + LayerNorm forward"
    if "fused_update_kernel" in name:
        return "fused update"
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass")):
        # cuDNN runs some convs (1 x 1 among them) on these GEMM kernels
        return "GEMM kernels (cuBLAS; cuDNN's GEMM-run convs)"
    if any(k in low for k in ("sort", "radix", "index", "scatter",
                              "gather")):
        # the MoE's routing (stable sorts), dispatch (an index write) and
        # combine (a gather), and their backwards; also any embedding's
        # backward (a sort) and the loss's gather
        return "sort / index / gather / scatter (MoE routing)"
    return "other (elementwise, reductions, copies)"


#: phase 7's runs after the per-leaf SGD one: (label, the path its launch
#: counts report, optimizer factory, FFConfig fields)
TRAIN_VARIANTS = (
    ("fused SGD", "train_fused",
     lambda port: port.SGDOptimizer(lr=TRAIN_LR), dict(fused_optimizer=True)),
    ("fused Adam", "train_adam", lambda port: port.AdamOptimizer(alpha=1e-4),
     dict(fused_optimizer=True)),
    (f"scan_steps={TRAIN_STEPS}, fused SGD", "train_scan",
     lambda port: port.SGDOptimizer(lr=TRAIN_LR),
     dict(fused_optimizer=True, scan_steps=TRAIN_STEPS)),
)


def phase_train(torch, port, kernels, card: str):
    """The flagship at full width: per-leaf SGD, then each TRAIN_VARIANTS
    run from the same seeded weights (compile again); each one warm-up
    step (scanned: one step, then the graph's capture), fit() over one
    epoch of TRAIN_STEPS steps, one step (or chunk) under torch.profiler,
    and the update's own device time. Returns {path: launch counts}."""
    import numpy as np

    gc.collect()
    torch.cuda.empty_cache()
    f = FLAGSHIP
    t0 = time.perf_counter()
    ff, x = build_flagship(port, "cuda", "bfloat16", 0, **f)
    n = f["batch"] * TRAIN_STEPS
    rs = np.random.RandomState(0)
    port.SingleDataLoader(ff, x, rs.randn(n, f["seq"], f["hidden"]).astype(
        np.float32))
    port.SingleDataLoader(ff, ff.label_tensor, rs.randint(
        0, f["num_classes"], (n, 1)).astype(np.int32))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for ws in ff.params.values()
                   for t in ws.values())
    say(f"train: flagship encoder classifier, hidden {f['hidden']}, "
        f"{f['layers']} layers, {f['heads']} heads, batch {f['batch']}, seq "
        f"{f['seq']}, {n_params / 1e9:.3f} B params bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    out, losses = {}, {}
    out["train"], losses["train"] = train_run(torch, kernels, card, ff,
                                              "per-leaf SGD")
    for label, path, opt, cfg in TRAIN_VARIANTS:
        ff.config.fused_optimizer = False
        ff.config.scan_steps = 0
        for k, v in cfg.items():
            setattr(ff.config, k, v)
        ff.params = ff.opt_state = ff._replay = None
        gc.collect()
        torch.cuda.empty_cache()
        ff.compile(opt(port),
                   port.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   [port.MetricsType.METRICS_ACCURACY],
                   final_tensor=ff._final_tensor)
        out[path], losses[path] = train_run(torch, kernels, card, ff, label)
    # the fused and the scanned SGD runs took the per-leaf run's steps from
    # the same weights on the same batches: the fused update is bitwise the
    # per-leaf one and the graph replays the same kernels, but cuBLAS may
    # choose other algorithms under capture (printed, not gated in bf16;
    # phase 5 holds the f32 case)
    for path, what in (("train_fused", "fused SGD"),
                       ("train_scan", "scanned SGD")):
        a, b = losses[path], losses["train"]
        rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        say(f"train: the {what} run's {len(a)} losses against the per-leaf "
            f"SGD run's (same weights, same batches): max relative "
            f"difference {rel:.3g}, bitwise {a == b}")
    return out


def train_run(torch, kernels, card: str, ff, label: str, want=None,
              batch_size: int = FLAGSHIP["batch"], falls: bool = False):
    """One training configuration at full width: warm-up, fit() of
    TRAIN_STEPS steps (exact launch counts ``want``, by default the
    flagship's: 6 flash forwards and backwards, 12 add + LayerNorm and 1
    update a step, the scanned ones counted through the graph's replays),
    the profile of one step (scanned: one chunk) with the idle share and
    device time by kernel class, and the update's own device time (CUDA
    events around ff.optimizer.update on one step's real gradients) and
    its share of its bound, and the profile's top kernels. ``falls``: the
    fit's batches are one batch repeated, and its last loss must be under
    its first. Returns the launch counts and the losses (warm-up first:
    the same batches for every configuration)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    f = FLAGSHIP
    n = batch_size * TRAIN_STEPS
    scan = ff.config.scan_steps > 0
    torch.cuda.reset_peak_memory_stats()
    losses = []
    step, scanned = ff._run_train_step, ff.train_scanned

    def recording_step(batch, inject_nan=False):
        loss, mets = step(batch, inject_nan)
        losses.append(loss.reshape(1))
        return loss, mets

    def recording_scan(k):
        ls, mets = scanned(k)
        losses.append(ls)
        return ls, mets

    ff._run_train_step, ff.train_scanned = recording_step, recording_scan
    ff._reset_dataloaders()      # every configuration sees batch 0 first
    if scan:          # warm-up: one eager step, then the capture
        recording_scan(1)
    else:
        recording_step(ff._stage_batch())
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ff.fit(epochs=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    del ff._run_train_step, ff.train_scanned
    vals = [float(v) for v in torch.cat(losses)]
    if len(vals) != TRAIN_STEPS + 1 or not all(np.isfinite(vals)):
        fail(f"train ({label}): losses {vals}")
    if falls and not vals[-1] < vals[1]:
        fail(f"train ({label}): on a repeated batch the loss did not fall "
             f"over the {TRAIN_STEPS} steps of fit: {vals[1:]}")
    layers = f["layers"]
    want = want or {"flash_attention_fwd": layers * TRAIN_STEPS,
                    "flash_attention_bwd": layers * TRAIN_STEPS,
                    "fused_add_layernorm_fwd": 2 * layers * TRAIN_STEPS,
                    "paged_attention_fwd": 0, "paged_prefill_write": 0,
                    "fused_update": TRAIN_STEPS}
    if launches != want:
        fail(f"train ({label}): kernel launches {launches} != expected "
             f"{want}")
    step_ms = wall * 1e3 / TRAIN_STEPS
    say(f"train ({label}): losses {[round(v, 4) for v in vals]} "
        f"(warm-up first)")
    say(f"train ({label}): fit of {TRAIN_STEPS} steps in {wall:.3f} s: "
        f"step {step_ms:.1f} ms, {n / wall:.2f} samples/s [{card}]")
    say(f"train ({label}): launches per step "
        f"{ {k: v // TRAIN_STEPS for k, v in launches.items() if v} }")
    say(f"train ({label}): peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    batch = ff._stage_batch()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if scan:
            ff.train_scanned(TRAIN_STEPS)
        else:
            step(batch)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = busy_ms(events) / (TRAIN_STEPS if scan else 1)
    by_class, by_name = {}, {}
    for e in events:
        us = e.time_range.end - e.time_range.start
        by_class[kernel_class(e.name)] = by_class.get(kernel_class(e.name),
                                                      0) + us
        by_name[e.name] = by_name.get(e.name, 0) + us
    say(f"train profile ({label}): {len(events)} device events, device busy "
        f"{busy:.1f} ms a step of {step_ms:.1f} ms: idle share "
        f"{max(1 - busy / step_ms, 0):.3f} [{card}]")
    total = sum(by_class.values()) or 1
    per = TRAIN_STEPS if scan else 1
    for k, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        say(f"train profile ({label}): {k}: {us / 1e3 / per:.2f} ms a step "
            f"({100 * us / total:.1f}%)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say(f"train profile kernel ({label}): {us / 1e3 / per:.3f} ms a "
            f"step {name[:100]}")
    for cls, tag in (("other", "other"), ("GEMM", "GEMM"),
                     ("sort", "routing")):
        picked = [(n, us) for n, us in by_name.items()
                  if kernel_class(n).startswith(cls)]
        for name, us in sorted(picked, key=lambda kv: -kv[1])[:8]:
            calls = sum(e.name == name for e in events) / per
            say(f"train profile {tag} ({label}): {us / 1e3 / per:.3f} ms a "
                f"step, {calls:g} launches a step: {name[:200]}")

    _, _, grads, _ = ff.executor._loss_and_grads(
        ff.params, ff._to_device(batch), ff.loss_type, ff.metric_types,
        ff._final_tensor)
    upd = cuda_ms(lambda: ff.optimizer.update(ff.params, grads, ff.opt_state),
                  iters=5, warmup=1, sleep=LONG_SLEEP_CYCLES)
    # bytes an update moves: each weight and its grad read, the weight
    # written, each moment read and written; ~2 f32 operations an element
    # a moment more than SGD's two (update_math)
    leaves = [w for ws in ff.params.values() for w in ws.values()]
    moments = ff.optimizer.rule.n_moments
    nbytes = sum(w.numel() * w.element_size() * (3 + 2 * moments)
                 for w in leaves)
    elems = sum(w.numel() for w in leaves)
    ub = bound(nbytes, (2 + 5 * moments) * elems, F32_FLOP_PER_S)
    say(f"train ({label}): the update {upd:.3f} ms of device time (CUDA "
        f"events around ff.optimizer.update on one step's gradients), "
        f"{len(leaves)} leaves, {elems / 1e6:.2f} M elements, bound "
        f"{ub[0]:.4f} ms by {ub[1]}: {100 * ub[0] / upd:.1f}% of bound "
        f"[{card}]")
    del grads
    return launches, vals


# ------------------------------------------------- phases 8 and 9: the zoo


def _zoo_resnet_blocks(port, ff, b):
    """ResNet-50's stem and three ``_bottleneck`` blocks (one strided
    projection) at image 32: ResNet-50 block by block."""
    from flexflow_tpu_torch.models import cnn

    x = ff.create_tensor([b, 3, 32, 32], name="input")
    t = ff.conv2d(x, 32, 7, 7, 2, 2, 3, 3, name="conv1")
    t = ff.batch_norm(t, relu=True, name="bn1")
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, name="pool1")
    t = cnn._bottleneck(ff, t, 16, 1, 0, downsample=True)
    t = cnn._bottleneck(ff, t, 16, 1, 1, downsample=False)
    t = cnn._bottleneck(ff, t, 32, 2, 2, downsample=True)
    h = t.dims[2]
    t = ff.pool2d(t, h, h, 1, 1, 0, 0, port.PoolType.POOL_AVG, name="gap")
    return {"input": x}, ff.dense(ff.flat(t), 10, name="fc")


def _zoo_builders():
    """Phase 8's models at small widths: name -> (build(port, ff, batch)
    -> ({input name: Tensor}, output), feed(rs, n) -> {input name: array},
    classes of the labels (None: MSE targets))."""
    from flexflow_tpu_torch.models import (alexnet_cifar10, bert_base, dlrm,
                                           gpt_lm, inception_v3_stem, vit)
    import numpy as np

    def image(size):
        return lambda rs, n: {"input": rs.randn(n, 3, size, size).astype(
            np.float32)}

    def tokens(vocab, seq, positions=False):
        def feed(rs, n):
            out = {"input": rs.randint(0, vocab, (n, seq)).astype(np.int32)}
            if positions:
                out["positions"] = np.tile(np.arange(seq, dtype=np.int32),
                                           (n, 1))
            return out
        return feed

    def dlrm_feed(rs, n):
        out = {"dense_input": rs.randn(n, 16).astype(np.float32)}
        out.update({f"sparse_{i}": rs.randint(0, 1000, (n, 3)).astype(
            np.int32) for i in range(4)})
        return out

    def named(x, out):
        return {"input": x}, out

    def dlrm_named(r):
        return ({t.owner_op.name: t for t in [r[0]] + r[1]}, r[2])

    def bert_named(r):
        return {"input": r[0], "positions": r[1]}, r[2]

    return {
        "alexnet_cifar10": (
            lambda port, ff, b: named(*alexnet_cifar10(ff, b)), image(32),
            10),
        "inception_v3_stem": (
            lambda port, ff, b: named(*inception_v3_stem(
                ff, b, num_classes=10, image_size=75)), image(75), 10),
        "resnet blocks": (_zoo_resnet_blocks, image(32), 10),
        "vit (patch 8, head dim 64)": (
            lambda port, ff, b: named(*vit(
                ff, b, image_size=32, patch_size=8, hidden=128, layers=2,
                heads=2, num_classes=10)), image(32), 10),
        "dlrm (SUM bags)": (
            lambda port, ff, b: dlrm_named(dlrm(
                ff, b, embedding_size=16, embedding_entries=1000,
                num_tables=4, indices_per_table=3, dense_dim=16,
                mlp_bot=(64, 16), mlp_top=(64, 1))), dlrm_feed, None),
        "bert_base (2 layers, head dim 64)": (
            lambda port, ff, b: bert_named(bert_base(
                ff, b, seq_len=128, hidden=128, layers=2, heads=2,
                vocab_size=1000)), tokens(1000, 128, positions=True), 2),
        "gpt_lm": (
            lambda port, ff, b: named(*gpt_lm(
                ff, b, seq_len=128, hidden=128, layers=2, heads=2,
                vocab_size=1000)), tokens(1000, 128), 1000),
    }


#: phase 8: card vs CPU, f32 with TF32 off, after ZOO_CHECK_STEPS SGD steps
#: at lr ZOO_LR from the same weights and batches. Sums in other orders
#: (cuDNN's and cuBLAS's algorithms against the CPU's) differ by ~1e-6
#: relative a product; two steps at lr 0.01 move the weights ~1e-3, so
#: they agree far inside 1e-5, the losses inside 1e-4 relative; the
#: BatchNorm state (0.1 of a batch statistic a step) inside 1e-5
ZOO_CHECK_STEPS = 2
ZOO_LR = 0.01
ZOO_STATE_ATOL = 1e-5
ZOO_BATCH = 4
#: dropout on the card: elements drawn, and the kept-share bound in
#: binomial standard deviations
DROPOUT_N = 1 << 22
DROPOUT_SIGMAS = 4.5


def phase_zoo_check(torch, port, kernels):
    """Phase 8: each zoo model small and f32 on the card (the kernels;
    cuDNN and cuBLAS without TF32) against the CPU (the plain versions)
    from the same weights and BatchNorm state, ZOO_CHECK_STEPS SGD steps
    on the same batches: losses, weights and BatchNorm state; a tied Llama
    serving the CPU's greedy tokens; dropout's law on the card and a
    different mask on each replayed step of fit(scan_steps=4). Returns
    {path: launch counts}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.reset_launch_counts()
    for name, (build, feed, classes) in _zoo_builders().items():
        train_card_vs_cpu(torch, port, "zoo check", name, build, feed,
                          classes)
    launches = {"zoo_check": kernels.launch_counts()}
    for k in ("flash_attention_fwd", "flash_attention_bwd", "fused_update"):
        if launches["zoo_check"][k] == 0:
            fail(f"zoo check: no launch of {k} ({launches['zoo_check']})")
    zoo_tied_llama(torch, port, kernels)
    zoo_dropout(torch, port, kernels)
    return launches


def train_card_vs_cpu(torch, port, phase: str, name: str, build, feed,
                      classes, lr: float = ZOO_LR):
    """One model small in f32 on the card (the kernels; cuBLAS and cuDNN
    as the caller set TF32) against the CPU (the plain versions) from the
    same weights and BatchNorm state: ZOO_CHECK_STEPS SGD steps at ``lr``
    on the same batches; losses within TRAIN_LOSS_RTOL, weights within
    TRAIN_PARAM_ATOL, the BatchNorm state within ZOO_STATE_ATOL.
    ``build(port, ff, batch)`` -> ({input name: Tensor}, output); ``feed(rs,
    n)`` -> {input name: array}; ``classes`` of the labels (None: MSE
    targets)."""
    import numpy as np

    models = []
    for dev in ("cpu", "cuda"):
        ff = port.FFModel(port.FFConfig(batch_size=ZOO_BATCH, seed=11),
                          device=dev)
        ins, out = build(port, ff, ZOO_BATCH)
        loss = ("LOSS_SPARSE_CATEGORICAL_CROSSENTROPY" if classes
                else "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE")
        ff.compile(port.SGDOptimizer(lr=lr), getattr(port.LossType, loss),
                   [port.MetricsType.METRICS_ACCURACY if classes else
                    port.MetricsType.METRICS_MEAN_SQUARED_ERROR],
                   final_tensor=out)
        models.append(ff)
    cpu, gpu = models
    copy_weights(gpu, cpu.params)
    gpu.bn_state = {op: {k: v.to("cuda") for k, v in ws.items()}
                    for op, ws in cpu.bn_state.items()}
    rs = np.random.RandomState(5)
    worst = 0.0
    for step in range(ZOO_CHECK_STEPS):
        batch = feed(rs, ZOO_BATCH)
        dims = (ZOO_BATCH,) + tuple(cpu._final_tensor.dims[1:])
        batch["label"] = (rs.rand(*dims).astype(np.float32)
                          if classes is None else rs.randint(
                              0, classes, dims[:-1] + (1,)).astype(np.int32))
        lc = float(cpu._run_train_step(batch)[0])
        lg = float(gpu._run_train_step(batch)[0])
        if not (np.isfinite(lg) and abs(lg - lc) <= TRAIN_LOSS_RTOL
                * abs(lc)):
            fail(f"{phase} ({name}): step {step} loss card {lg} vs CPU {lc} "
                 f"(limit {TRAIN_LOSS_RTOL} relative)")
        worst = max(worst, abs(lg - lc) / abs(lc))
    diff = weight_diff(gpu, cpu)
    sdiff = max([(gpu.bn_state[op][k].cpu() - v).abs().max().item()
                 for op, ws in cpu.bn_state.items()
                 for k, v in ws.items()] or [0.0])
    if not (diff <= TRAIN_PARAM_ATOL and sdiff <= ZOO_STATE_ATOL):
        fail(f"{phase} ({name}): after {ZOO_CHECK_STEPS} steps the weights "
             f"differ card vs CPU by {diff} (limit {TRAIN_PARAM_ATOL}), the "
             f"BatchNorm state by {sdiff} (limit {ZOO_STATE_ATOL})")
    say(f"{phase} ({name}): f32, {ZOO_CHECK_STEPS} SGD steps, card vs CPU: "
        f"losses within {worst:.2e} relative, weights within {diff:.2e}, "
        f"{len(cpu.bn_state)} BatchNorm states within {sdiff:.2e}")


def zoo_tied_llama(torch, port, kernels):
    """A small f32 Llama with tied embeddings serves on the card the CPU's
    greedy tokens from the same weights (one stored table for both
    uses)."""
    import numpy as np
    from flexflow_tpu_torch.models import llama_lm

    arch = dict(hidden=256, layers=2, heads=4, kv_heads=2, ffn_hidden=512,
                vocab_size=1000, tie_embeddings=True)
    models = []
    for dev in ("cpu", "cuda"):
        ff = port.FFModel(port.FFConfig(batch_size=2, seed=2), device=dev)
        _, logits = llama_lm(ff, 2, seq_len=256, **arch)
        ff.compile(final_tensor=logits)
        models.append(ff)
    cpu, gpu = models
    if cpu.params["lm_head"] or gpu.params["lm_head"]:
        fail("zoo check (tied Llama): lm_head owns a weight")
    gpu.params = {op: {w: t.to("cuda") for w, t in ws.items()}
                  for op, ws in cpu.params.items()}
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 1000, n).astype(np.int32) for n in (7, 40, 100)]
    kw = dict(serve_slots=2, kv_page_size=64, max_seq_len=256)
    kernels.reset_launch_counts()
    ref, _ = cpu.serve(prompts, max_new_tokens=8, **kw)
    got, _ = gpu.serve(prompts, max_new_tokens=8, **kw)
    if kernels.paged_attention_fwd.launches == 0:
        fail("zoo check (tied Llama) did not reach the kernels")
    for i, (a, b) in enumerate(zip(ref, got)):
        if a is None or b is None or not np.array_equal(a, b):
            fail(f"zoo check (tied Llama): prompt {i} tokens card vs CPU "
                 f"differ")
    say(f"zoo check (tied Llama): lm_head tied to tok_embed (transposed), "
        f"{len(prompts)} prompts x 8 greedy tokens on the card == the CPU's")


def zoo_dropout(torch, port, kernels):
    """Dropout on the card: the kept share of DROPOUT_N elements within
    DROPOUT_SIGMAS binomial deviations of keep * n, every kept value
    exactly x / keep (the CPU's IEEE division of the same values), and a
    model with dropout trained by fit(scan_steps=4) on one repeated batch
    at lr 0: the eager step and the 3 replays of the captured one give 4
    different losses (new masks a replay: the op's generator is
    registered with the graph)."""
    import numpy as np
    from flexflow_tpu_torch.ops.norm import dropout

    rate = 0.3
    x = torch.rand(DROPOUT_N, device="cuda") + 0.5
    gen = torch.Generator(device="cuda").manual_seed(1)
    y = dropout(x, rate, gen)
    kept = int((y != 0).sum())
    keep = 1 - rate
    sd = math.sqrt(DROPOUT_N * keep * rate)
    if abs(kept - keep * DROPOUT_N) > DROPOUT_SIGMAS * sd:
        fail(f"dropout on the card kept {kept} of {DROPOUT_N} (expected "
             f"{keep * DROPOUT_N:.0f} +- {DROPOUT_SIGMAS} x {sd:.0f})")
    yc, xc = y.cpu().numpy(), x.cpu().numpy()
    mask = yc != 0
    if not np.array_equal(yc[mask], xc[mask] / np.float32(keep)):
        fail("dropout on the card: kept values are not exactly x / keep")

    ff = port.FFModel(port.FFConfig(batch_size=8, seed=4, scan_steps=4),
                      device="cuda")
    t = ff.create_tensor([8, 256], name="input")
    h = ff.dense(t, 256, port.ActiMode.AC_MODE_RELU, name="fc1")
    h = ff.dropout(h, 0.5, name="drop")
    out = ff.dense(h, 4, name="fc2")
    ff.compile(port.SGDOptimizer(lr=0.0),
               port.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [port.MetricsType.METRICS_ACCURACY], final_tensor=out)
    rs = np.random.RandomState(0)
    xs = np.tile(rs.randn(8, 256).astype(np.float32), (4, 1))
    ys = np.tile(rs.randint(0, 4, (8, 1)).astype(np.int32), (4, 1))
    port.SingleDataLoader(ff, t, xs)
    port.SingleDataLoader(ff, ff.label_tensor, ys)
    losses = []
    scanned = ff.train_scanned

    def recording(n):
        ls, mets = scanned(n)
        losses.extend(float(v) for v in ls)
        return ls, mets
    ff.train_scanned = recording
    ff.fit(epochs=1, verbose=False)
    replays = ff._replay.replays if ff._replay is not None else 0
    if len(losses) != 4 or replays != 3 or len(set(losses)) != 4:
        fail(f"dropout under fit(scan_steps=4): losses {losses} over "
             f"{replays} graph replays: a replay repeated a mask")
    say(f"zoo check (dropout): kept {kept} of {DROPOUT_N} at rate {rate} "
        f"({(kept - keep * DROPOUT_N) / sd:+.2f} sigma), kept values "
        f"exactly x / keep; fit(scan_steps=4) at lr 0 on one batch: losses "
        f"{[round(v, 5) for v in losses]} (eager step, then {replays} "
        f"replays), each its own mask")


#: phase 9: the two zoo models at their published widths (bf16 weights and
#: compute). ResNet-50: He et al. 2015, Table 1, 50-layer (torchvision
#: resnet50), 224 x 224, 1000 classes, batch 128, SGD lr 0.1, the
#: per-leaf optimizer. BERT-base: google-research/bert
#: uncased_L-12_H-768_A-12 bert_config.json (hidden 768, 12 layers, 12
#: heads, intermediate 3072, vocab 30522), sequence 512, batch 32, 2
#: classes, SGD lr 1e-4 (the per-leaf optimizer, as ResNet-50's). From its
#: glorot initialisation the model's first steps are steep, in the JAX
#: package as in the port: at full width on the CPU
#: (tests/test_torch_bert_witness.py: seq 512, batch 8, f32, both packages
#: from the same weights, agreeing within 3e-6 over 5 steps) one repeated
#: batch's loss oscillates at lr 1e-2 and 1e-3, still rises at 3e-4 and
#: falls at 1e-4.
RESNET50 = dict(batch=128, image=224, classes=1000, lr=0.1)
BERT_BASE = dict(batch=32, seq=512, hidden=768, layers=12, heads=12,
                 vocab=30522, classes=2, lr=1e-4)


def phase_zoo_train(torch, port, kernels, card: str):
    """Phase 9: ResNet-50 and BERT-base train through FFModel.fit at the
    widths above: compile time, then train_run (a warm-up step, fit over
    TRAIN_STEPS copies of one batch, whose loss must fall; exact launch
    counts; step ms, samples/s, peak memory, the idle share and device
    time by kernel class over one profiled step, the update's own device
    time and share of its bound). Returns {path: launch counts}."""
    import numpy as np
    from flexflow_tpu_torch.models import bert_base, resnet50

    out = {}
    rs = np.random.RandomState(0)
    for label, path in (("ResNet-50", "zoo_resnet50"),
                        ("BERT-base", "zoo_bert")):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = port.FFConfig(compute_dtype="bfloat16",
                            master_dtype="bfloat16", seed=0,
                            batch_size=(RESNET50 if path == "zoo_resnet50"
                                        else BERT_BASE)["batch"])
        t0 = time.perf_counter()
        ff = port.FFModel(cfg, device="cuda")
        if path == "zoo_resnet50":
            r = RESNET50
            b = r["batch"]
            x, logits = resnet50(ff, b, r["classes"], r["image"])
            ff.compile(port.SGDOptimizer(lr=r["lr"]),
                       port.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                       [port.MetricsType.METRICS_ACCURACY],
                       final_tensor=logits)
            feeds = {x: rs.randn(b, 3, r["image"], r["image"]).astype(
                np.float32)}
            classes = r["classes"]
            want = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
        else:
            r = BERT_BASE
            b = r["batch"]
            tok, pos, logits = bert_base(ff, b, r["seq"], r["hidden"],
                                         r["layers"], r["heads"], r["vocab"],
                                         r["classes"])
            ff.compile(port.SGDOptimizer(lr=r["lr"]),
                       port.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                       [port.MetricsType.METRICS_ACCURACY],
                       final_tensor=logits)
            feeds = {tok: rs.randint(0, r["vocab"], (b, r["seq"])).astype(
                np.int32), pos: np.tile(np.arange(r["seq"], dtype=np.int32),
                                        (b, 1))}
            classes = r["classes"]
            want = {"flash_attention_fwd": r["layers"] * TRAIN_STEPS,
                    "flash_attention_bwd": r["layers"] * TRAIN_STEPS}
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        feeds[ff.label_tensor] = rs.randint(0, classes, (b, 1)).astype(
            np.int32)
        for t, a in feeds.items():      # one batch, TRAIN_STEPS times
            port.SingleDataLoader(ff, t, np.concatenate([a] * TRAIN_STEPS))
        leaves = sum(len(ws) for ws in ff.params.values())
        n_params = sum(w.numel() for ws in ff.params.values()
                       for w in ws.values())
        launches = -(-leaves // kernels.FUSED_UPDATE_MAX_LEAVES)
        want.update({"fused_add_layernorm_fwd": 0, "paged_attention_fwd": 0,
                     "paged_prefill_write": 0,
                     "fused_update": launches * TRAIN_STEPS})
        say(f"zoo train ({label}): {n_params / 1e6:.2f} M params bf16 in "
            f"{leaves} leaves ({launches} update launches a step), "
            f"{len(ff.bn_state)} BatchNorm states, batch {b}; built and "
            f"compiled in {compile_s:.2f} s [{card}]")
        out[path], _ = train_run(torch, kernels, card, ff, label, want=want,
                                 batch_size=b, falls=True)
        del ff, feeds
    return out


# --------------------- phase 10: MoE, LSTM / GRU, the pipelined stack, fusion

#: GLaM (0.1B/64E), Du et al. 2022, "GLaM", Table 4: hidden 768, 12 layers,
#: 12 heads, expert FFN 3072 (4 x hidden), 64 experts, top-2, a MoE layer
#: every other layer, the paper's 256k SentencePiece vocabulary; seq 1024,
#: batch 8, capacity factor 1.25 (the op's default); SGD, bf16. gpt_lm has
#: no relative position bias and no gated dense FFN (PERF.md section 4)
GLAM = dict(batch=8, seq=1024, hidden=768, layers=12, heads=12,
            vocab=256_000, experts=64, moe_every=2, lr=1e-4)
#: the same model served: 8 prompts of 512 tokens, 64 new tokens each,
#: through 4 slots on the native bf16 pool
MOE_SERVE = dict(prompts=8, prompt=512, new=64)
MOE_ENGINE = dict(serve_slots=4, kv_page_size=128, max_seq_len=576)
#: GPT-2 small's widths (openai-community/gpt2 config.json: n_embd 768,
#: n_layer 12, n_head 12, n_positions 1024, vocab_size 50257) as
#: gpt_pipelined's one stacked op; seq 1024, batch 16, SGD, bf16
GPT2_SMALL = dict(batch=16, seq=1024, hidden=768, layers=12, heads=12,
                  vocab=50257, lr=1e-4)
#: NMT at the reference's widths (nmt/nmt.cc:31-99: 2 encoder and 2
#: decoder LSTM layers, embed = hidden 2048, vocab 20k; batch 64, the
#: reference's samples a worker), source and target 20 (nmt_seq2seq's
#: defaults); SGD, bf16
NMT = dict(batch=64, src=20, tgt=20, embed=2048, hidden=2048, vocab=20_000,
           layers=2, lr=0.01)
#: the fused ResNet (phase 8's blocks at batch 16, f32): the ops
#: apply_fusion eliminates from it, the count tests/test_torch_fusion.py
#: takes from the JAX package's apply_fusion on the same graph (its three
#: add + ReLU tails)
FUSION_ELIMINATED = 3
FUSION_BATCH = 16
#: phase 10's card-vs-CPU op checks, f32 without TF32: outputs within 1e-5,
#: gradients within 1e-5 of their largest value (sums in other orders)
OP_TOL = 1e-5


def _rest_ops():
    """Phase 10's one-op checks: name -> (verb, input shape, args,
    kwargs)."""
    return {
        "moe sort, binding capacity": ("moe", (4, 32, 64), (8, 256),
                                       dict(capacity_factor=0.5,
                                            dispatch="sort")),
        "moe dense, binding capacity": ("moe", (4, 32, 64), (8, 256),
                                        dict(capacity_factor=0.5,
                                             dispatch="dense")),
        "lstm": ("lstm", (8, 20, 64), (128,), {}),
        "gru (last step)": ("gru", (8, 20, 64), (128,),
                            dict(return_sequences=False)),
    }


def op_card_vs_cpu(torch, port, name, verb, shape, args, kw):
    """One op in training mode, f32, on the card against the CPU from the
    same weights and input: the output (and a MoE's aux) within OP_TOL,
    the gradients of sum(out * cot) + aux by every weight and the input
    within OP_TOL of their largest value."""
    import numpy as np

    rs = np.random.RandomState(9)
    x = rs.randn(*shape).astype(np.float32)
    cot = rs.randn(*shape[:-1], 1).astype(np.float32)
    res, src = [], None
    for dev in ("cpu", "cuda"):
        ff = port.FFModel(port.FFConfig(batch_size=shape[0], seed=3),
                          device=dev)
        xt = ff.create_tensor(list(shape), name="x")
        y = getattr(ff, verb)(xt, *args, name="op", **kw)
        ff.compile(port.SGDOptimizer(lr=0.1),
                   port.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
                   [port.MetricsType.METRICS_MEAN_SQUARED_ERROR],
                   final_tensor=y)
        if src is None:
            src = ff.params
        else:
            copy_weights(ff, src)
        xv = torch.tensor(x, device=dev, requires_grad=True)
        leaves = [w.requires_grad_() for ws in ff.params.values()
                  for w in ws.values()]
        vals, _ = ff.executor.apply_graph(ff.params, {xt: xv},
                                          training=True)
        out = vals[y]
        aux = sum(vals[t] for t in ff._aux_tensors) if ff._aux_tensors \
            else torch.zeros((), device=dev)
        c = torch.tensor(cot, device=dev)
        c = c if out.dim() == c.dim() else c[:, 0]
        grads = torch.autograd.grad((out * c).sum() + aux, leaves + [xv])
        res.append((out.detach().cpu(), aux.detach().cpu(),
                    [g.cpu() for g in grads]))
    (yc, ac, gc_), (yg, ag, gg) = res
    err = max((yg - yc).abs().max().item(), (ag - ac).abs().item())
    gerr = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
               for a, b in zip(gg, gc_))
    if not (err <= OP_TOL and gerr <= OP_TOL):
        fail(f"phase 10 check ({name}): card vs CPU output err {err}, "
             f"gradient err {gerr} of the largest (limit {OP_TOL})")
    say(f"phase 10 check ({name}): f32, card vs CPU: output within "
        f"{err:.2e}, gradients within {gerr:.2e} of their largest")


def _rest_models():
    """Phase 10's small models trained card vs CPU (train_card_vs_cpu):
    name -> (build, feed, classes)."""
    import numpy as np
    from flexflow_tpu_torch.models import gpt_lm, gpt_pipelined, nmt_seq2seq

    def tokens(vocab, *names_and_lens):
        return lambda rs, n: {k: rs.randint(0, vocab, (n, s)).astype(
            np.int32) for k, s in names_and_lens}

    def nmt(port, ff, b):
        src, tgt, out = nmt_seq2seq(ff, b, src_len=10, tgt_len=12,
                                    embed_size=64, hidden_size=64,
                                    vocab_size=500)
        return {"src_tokens": src, "tgt_tokens": tgt}, out

    def pipe(port, ff, b):
        x, out = gpt_pipelined(ff, b, seq_len=128, hidden=128, layers=2,
                               heads=2, vocab_size=1000)
        return {"input": x}, out

    def moe(port, ff, b):
        x, out = gpt_lm(ff, b, seq_len=128, hidden=128, layers=2, heads=2,
                        vocab_size=1000, moe_every=2, num_experts=4)
        return {"input": x}, out

    return {
        "nmt_seq2seq (2 + 2 LSTM layers, hidden 64)": (
            nmt, tokens(500, ("src_tokens", 10), ("tgt_tokens", 12)), 500),
        "gpt_pipelined (2 stacked layers, head dim 64)": (
            pipe, tokens(1000, ("input", 128)), 1000),
        "gpt_lm with MoE (4 experts, top-2)": (
            moe, tokens(1000, ("input", 128)), 1000),
    }


def rest_moe_served_check(torch, port, kernels):
    """A small f32 MoE LM serves on the card the CPU's greedy tokens from
    the same weights."""
    import numpy as np
    from flexflow_tpu_torch.models import gpt_lm

    models = []
    for dev in ("cpu", "cuda"):
        ff = port.FFModel(port.FFConfig(batch_size=2, seed=2), device=dev)
        _, logits = gpt_lm(ff, 2, seq_len=256, hidden=128, layers=2,
                           heads=2, vocab_size=1000, moe_every=2,
                           num_experts=4)
        ff.compile(final_tensor=logits)
        models.append(ff)
    cpu, gpu = models
    gpu.params = {op: {w: t.to("cuda") for w, t in ws.items()}
                  for op, ws in cpu.params.items()}
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 1000, n).astype(np.int32) for n in (7, 40, 100)]
    kw = dict(serve_slots=2, kv_page_size=64, max_seq_len=256)
    kernels.reset_launch_counts()
    ref, _ = cpu.serve(prompts, max_new_tokens=8, **kw)
    got, _ = gpu.serve(prompts, max_new_tokens=8, **kw)
    for k in ("flash_attention_fwd", "paged_attention_fwd",
              "paged_prefill_write"):
        if getattr(kernels, k).launches == 0:
            fail(f"phase 10 check (served MoE LM): no launch of {k}")
    for i, (a, b) in enumerate(zip(ref, got)):
        if a is None or b is None or not np.array_equal(a, b):
            fail(f"phase 10 check (served MoE LM): prompt {i} tokens card "
                 f"vs CPU differ")
    say(f"phase 10 check (served MoE LM): {len(prompts)} prompts x 8 greedy "
        f"tokens on the card == the CPU's")


def rest_fusion(torch, port, kernels, card: str):
    """phase 8's ResNet blocks (f32, batch FUSION_BATCH, cuDNN
    deterministic) trained 4 SGD steps through fit with perform_fusion and
    without, from the same seed: FUSION_ELIMINATED ops fused away, and the
    losses, weights and BatchNorm state bitwise equal. Returns the fused
    run's launch counts."""
    import numpy as np

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    for fusion in (False, True):
        ff = port.FFModel(port.FFConfig(batch_size=FUSION_BATCH, seed=12,
                                        perform_fusion=fusion),
                          device="cuda")
        ins, out = _zoo_resnet_blocks(port, ff, FUSION_BATCH)
        n_ops = len(ff.ops)
        ff.compile(port.SGDOptimizer(lr=ZOO_LR),
                   port.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   [port.MetricsType.METRICS_ACCURACY], final_tensor=out)
        rs = np.random.RandomState(6)
        n = FUSION_BATCH * TRAIN_STEPS
        port.SingleDataLoader(ff, ins["input"], rs.randn(
            n, 3, 32, 32).astype(np.float32))
        port.SingleDataLoader(ff, ff.label_tensor, rs.randint(
            0, 10, (n, 1)).astype(np.int32))
        losses = []
        step = ff._run_train_step
        ff._run_train_step = lambda b, **kw: (
            lambda r: losses.append(r[0].reshape(1)) or r)(step(b, **kw))
        kernels.reset_launch_counts()
        ff.fit(epochs=1, verbose=False)
        torch.cuda.synchronize()
        runs.append((ff, torch.cat(losses).cpu(), kernels.launch_counts(),
                     n_ops - len(ff.ops)))
    torch.backends.cudnn.deterministic = saved
    (plain, lp, _, _), (fused, lf, launches, gone) = runs
    if gone != FUSION_ELIMINATED:
        fail(f"fusion: {gone} ops eliminated, expected {FUSION_ELIMINATED}")
    bn_same = all(torch.equal(fused.bn_state[op][k], v)
                  for op, ws in plain.bn_state.items() for k, v in ws.items())
    if not (torch.equal(lf, lp) and same_bits(fused.params, plain.params)
            and bn_same and bool(torch.isfinite(lf).all())):
        fail(f"fusion: fused training is not bitwise the unfused: losses "
             f"{lf.tolist()} vs {lp.tolist()}")
    say(f"fusion: phase 8's ResNet blocks, batch {FUSION_BATCH}, f32: "
        f"{gone} ops fused away ({len(plain.ops)} -> {len(fused.ops)}); "
        f"{TRAIN_STEPS} SGD steps through fit, losses "
        f"{[round(v, 5) for v in lf.tolist()]} bitwise the unfused run's, "
        f"weights and {len(plain.bn_state)} BatchNorm states bitwise "
        f"[{card}]")
    return launches


def _repeat_loaders(port, ff, feeds):
    """Attach one batch, repeated TRAIN_STEPS times, to each input."""
    import numpy as np

    for t, a in feeds.items():
        port.SingleDataLoader(ff, t, np.concatenate([a] * TRAIN_STEPS))


def _train_want(kernels, ff, flash: int):
    """A full-width run's exact launches over TRAIN_STEPS steps: ``flash``
    flash forwards and backwards a step, the per-leaf update's launches."""
    leaves = sum(len(ws) for ws in ff.params.values())
    return {"flash_attention_fwd": flash * TRAIN_STEPS,
            "flash_attention_bwd": flash * TRAIN_STEPS,
            "fused_add_layernorm_fwd": 0, "paged_attention_fwd": 0,
            "paged_prefill_write": 0,
            "fused_update": -(-leaves // kernels.FUSED_UPDATE_MAX_LEAVES)
            * TRAIN_STEPS}


def _bf16_config(port, batch: int, **cfg):
    return port.FFConfig(batch_size=batch, seed=0, compute_dtype="bfloat16",
                         master_dtype="bfloat16", **cfg)


def _describe(torch, ff, label: str, t0: float, card: str,
              extra: str = ""):
    torch.cuda.synchronize()
    leaves = sum(len(ws) for ws in ff.params.values())
    n_params = sum(w.numel() for ws in ff.params.values()
                   for w in ws.values())
    say(f"phase 10 train ({label}): {n_params / 1e9:.3f} B params bf16 in "
        f"{leaves} leaves{extra}; built and compiled in "
        f"{time.perf_counter() - t0:.2f} s [{card}]")


def rest_train(torch, port, kernels, card: str):
    """The full-width training runs (train_run: a warm-up step, fit over
    TRAIN_STEPS copies of one batch with exact launches, step ms,
    samples/s, peak memory, the idle share and device time by kernel class
    over one profiled step, the update's device time): NMT once a step and
    with scan_steps=TRAIN_STEPS (a CUDA graph replayed), the GLaM-width MoE
    LM and the GPT-2-small-width pipelined LM. Returns {path: launches}."""
    import numpy as np
    from flexflow_tpu_torch.models import gpt_lm, gpt_pipelined, nmt_seq2seq

    out = {}
    rs = np.random.RandomState(0)
    # NMT: the recurrence is a host-launch loop; the scanned run replays it
    n = NMT
    losses = {}
    for label, path, scan in (("NMT", "nmt_train", 0),
                              (f"NMT, scan_steps={TRAIN_STEPS}",
                               "nmt_scan", TRAIN_STEPS)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ff = port.FFModel(_bf16_config(port, n["batch"], scan_steps=scan),
                          device="cuda")
        src, tgt, logits = nmt_seq2seq(ff, n["batch"], n["src"], n["tgt"],
                                       n["embed"], n["hidden"], n["vocab"],
                                       n["layers"])
        ff.compile(port.SGDOptimizer(lr=n["lr"]),
                   port.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   [port.MetricsType.METRICS_ACCURACY], final_tensor=logits)
        data = np.random.RandomState(1)
        _repeat_loaders(port, ff, {
            src: data.randint(0, n["vocab"], (n["batch"], n["src"])).astype(
                np.int32),
            tgt: data.randint(0, n["vocab"], (n["batch"], n["tgt"])).astype(
                np.int32),
            ff.label_tensor: data.randint(0, n["vocab"], (
                n["batch"], n["tgt"], 1)).astype(np.int32)})
        _describe(torch, ff, label, t0, card,
                  f", batch {n['batch']}, source and target {n['src']}, "
                  f"{2 * n['layers']} LSTM layers of {n['hidden']}, vocab "
                  f"{n['vocab']}")
        out[path], losses[path] = train_run(
            torch, kernels, card, ff, label, want=_train_want(kernels, ff, 0),
            batch_size=n["batch"])
        del ff
    a, b = losses["nmt_scan"], losses["nmt_train"]
    say(f"phase 10 train (NMT): the scanned run's losses against the "
        f"per-step run's: max relative difference "
        f"{max(abs(x - y) / abs(y) for x, y in zip(a, b)):.3g}, bitwise "
        f"{a == b}")

    for label, path in (("GLaM-width MoE LM", "moe_lm_train"),
                        ("GPT-2-small-width pipelined LM", "pipe_train")):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        m = GLAM if path == "moe_lm_train" else GPT2_SMALL
        t0 = time.perf_counter()
        ff = port.FFModel(_bf16_config(port, m["batch"]), device="cuda")
        if path == "moe_lm_train":
            tok, logits = gpt_lm(ff, m["batch"], m["seq"], m["hidden"],
                                 m["layers"], m["heads"], m["vocab"],
                                 moe_every=m["moe_every"],
                                 num_experts=m["experts"])
            moe = ff.get_op_by_name("moe_1")
            extra = (f", {m['layers'] // m['moe_every']} MoE layers of "
                     f"{m['experts']} experts (top-{moe.k}, capacity "
                     f"{moe.capacity} a expert)")
        else:
            tok, logits = gpt_pipelined(ff, m["batch"], m["seq"],
                                        m["hidden"], m["layers"],
                                        m["heads"], m["vocab"])
            extra = f", {m['layers']} layers stacked in one op"
        ff.compile(port.SGDOptimizer(lr=m["lr"]),
                   port.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   [port.MetricsType.METRICS_ACCURACY], final_tensor=logits)
        _repeat_loaders(port, ff, {
            tok: rs.randint(0, m["vocab"], (m["batch"], m["seq"])).astype(
                np.int32),
            ff.label_tensor: rs.randint(0, m["vocab"], (
                m["batch"], m["seq"], 1)).astype(np.int32)})
        _describe(torch, ff, label, t0, card,
                  extra + f", batch {m['batch']}, seq {m['seq']}, vocab "
                  f"{m['vocab']}")
        out[path], vals = train_run(
            torch, kernels, card, ff, label,
            want=_train_want(kernels, ff, m["layers"]),
            batch_size=m["batch"])
        say(f"phase 10 train ({label}): on one repeated batch the loss went "
            f"{vals[1]:.4f} -> {vals[-1]:.4f} over fit (not gated)")
        del ff
    return out


def rest_moe_serve(torch, port, kernels, card: str):
    """The GLaM-width MoE LM (bf16, seeded random weights) serves
    MOE_SERVE's prompts through FFModel.serve: every request finishes,
    exact launch counts (12 flash forwards and one prefill write a
    prefill, 12 paged attentions a decode step); tokens/s, TTFT (the
    second wave's queued behind the first's decode), decode step, peak
    memory; one wave's TTFT (4 prompts x 16 new tokens). Then a profiled
    serve of that wave:
    device busy and idle share under the profiler, and the share of its
    device time in the expert products (aten::bmm: their only caller on
    this path), which run at capacity = the slab's tokens; and the expert
    products timed alone at a prefill's capacity and at the routed rows'.
    Returns the timed serve's launch counts."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from flexflow_tpu_torch.models import gpt_lm
    from flexflow_tpu_torch.ops.moe import expert_ffn

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m = GLAM
    t0 = time.perf_counter()
    ff = port.FFModel(port.FFConfig(batch_size=MOE_ENGINE["serve_slots"],
                                    seed=0, compute_dtype="bfloat16"),
                      device="cuda")
    _, logits = gpt_lm(ff, MOE_ENGINE["serve_slots"],
                       MOE_ENGINE["max_seq_len"], m["hidden"], m["layers"],
                       m["heads"], m["vocab"], moe_every=m["moe_every"],
                       num_experts=m["experts"])
    ff.compile(final_tensor=logits)
    torch.cuda.synchronize()
    n_params = sum(w.numel() for ws in ff.params.values()
                   for w in ws.values())
    say(f"phase 10 serve (MoE LM): {n_params / 1e9:.3f} B params bf16, "
        f"built in {time.perf_counter() - t0:.2f} s [{card}]")
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, m["vocab"], MOE_SERVE["prompt"]).astype(
        np.int32) for _ in range(MOE_SERVE["prompts"])]
    ff.serve(prompts[:2], max_new_tokens=4, **MOE_ENGINE)     # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs, st = ff.serve(prompts, max_new_tokens=MOE_SERVE["new"],
                        **MOE_ENGINE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if any(o is None for o in outs) or st["completed"] != len(prompts):
        fail(f"phase 10 serve (MoE LM): not every request finished with "
             f"finite logits: {st}")
    for o in outs:
        if o.shape != (MOE_SERVE["prompt"] + MOE_SERVE["new"],):
            fail(f"phase 10 serve (MoE LM): output shape {o.shape}")
    want = {"flash_attention_fwd": m["layers"] * len(prompts),
            "paged_prefill_write": len(prompts),
            "paged_attention_fwd": m["layers"] * st["decode_steps"],
            "flash_attention_bwd": 0, "fused_add_layernorm_fwd": 0,
            "fused_update": 0}
    if launches != want:
        fail(f"phase 10 serve (MoE LM): kernel launches {launches} != "
             f"expected {want}")
    say(f"phase 10 serve (MoE LM): {len(prompts)} prompts of "
        f"{MOE_SERVE['prompt']} tokens, {st['tokens_generated']} tokens in "
        f"{wall:.3f} s = {st['tokens_generated'] / wall:.2f} tokens/s; "
        f"TTFT p50 {st['ttft_p50_ms']:.1f} ms, p99 {st['ttft_p99_ms']:.1f} "
        f"ms; decode step {st['decode_step_ms']:.2f} ms over "
        f"{st['decode_steps']} steps of {MOE_ENGINE['serve_slots']} slots; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{card}]")
    say(f"phase 10 serve (MoE LM): launches {launches}")
    # one wave (a prompt a slot): TTFT without the queue behind a wave
    _, st1 = ff.serve(prompts[:4], max_new_tokens=16, **MOE_ENGINE)
    say(f"phase 10 serve (MoE LM): one wave of 4 prompts x 16 new tokens: "
        f"TTFT p50 {st1['ttft_p50_ms']:.1f} ms, p99 "
        f"{st1['ttft_p99_ms']:.1f} ms (the prefills run one after another),"
        f" decode step {st1['decode_step_ms']:.2f} ms [{card}]")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ff.serve(prompts[:4], max_new_tokens=16, **MOE_ENGINE)
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = busy_ms(events)
    bmm = sum(getattr(e, "device_time_total", 0) or
              getattr(e, "cuda_time_total", 0)
              for e in prof.key_averages() if e.key == "aten::bmm") / 1e3
    say(f"phase 10 serve profile (MoE LM): 4 prompts x 16 new tokens, "
        f"{len(events)} device events, device busy {busy:.1f} ms of "
        f"{pwall:.1f} ms under the profiler (idle share "
        f"{max(1 - busy / pwall, 0):.3f}); the expert products (aten::bmm, "
        f"capacity = the slab's tokens) {bmm:.2f} ms, "
        f"{100 * bmm / busy:.1f}% of the device time [{card}]")
    p = ff.params["moe_1"]
    e, d = m["experts"], m["hidden"]
    g = torch.Generator(device="cuda").manual_seed(1)
    routed = MOE_SERVE["prompt"] * 2 // e
    times = {}
    for c in (MOE_SERVE["prompt"], routed, MOE_ENGINE["serve_slots"]):
        buf = torch.randn(e, c, d, device="cuda", generator=g).to(
            torch.bfloat16)
        times[c] = cuda_ms(lambda: expert_ffn(buf, p["w_in"],
                                              p["w_out"]))
    say(f"phase 10 serve (MoE LM): one layer's expert products at a "
        f"{MOE_SERVE['prompt']}-token prefill's capacity "
        f"({e}, {MOE_SERVE['prompt']}, {d}): {times[MOE_SERVE['prompt']]:.4f}"
        f" ms; at the rows top-2 routing fills on average ({e}, {routed}, "
        f"{d}): {times[routed]:.4f} ms; a decode step's ({e}, "
        f"{MOE_ENGINE['serve_slots']}, {d}): "
        f"{times[MOE_ENGINE['serve_slots']]:.4f} ms [{card}]")
    del ff
    return launches


def phase_rest(torch, port, kernels, card: str):
    """Phase 10: the card-vs-CPU checks (each op, each small model through
    2 SGD steps, a served MoE LM's tokens), the fused ResNet bitwise the
    unfused, the full-width training runs and the MoE serve. Returns
    {path: launch counts}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.reset_launch_counts()
    for name, (verb, shape, args, kw) in _rest_ops().items():
        op_card_vs_cpu(torch, port, name, verb, shape, args, kw)
    for name, (build, feed, classes) in _rest_models().items():
        train_card_vs_cpu(torch, port, "phase 10 check", name, build, feed,
                          classes)
    checked = kernels.launch_counts()
    for k in ("flash_attention_fwd", "flash_attention_bwd", "fused_update"):
        if checked[k] == 0:
            fail(f"phase 10 check: no launch of {k} ({checked})")
    rest_moe_served_check(torch, port, kernels)
    launches = {"fusion": rest_fusion(torch, port, kernels, card)}
    launches.update(rest_train(torch, port, kernels, card))
    launches["moe_serve"] = rest_moe_serve(torch, port, kernels, card)
    return launches


FUSED_UPDATE_REPLACES = "flexflow_tpu/runtime/optimizer.py:40"
#: the JSON line's rows: name -> (source, what it replaces (a line of
#: flexflow_tpu/ops/pallas_kernels.py, or a file:line), the main path whose
#: launch counts it reports, wrapper)
KERNEL_ROWS = {
    "flash_attention_fwd": ("flash_attention_wgmma.cu", 180, "serve",
                            "flash_attention_fwd"),
    "paged_attention_fwd": ("paged_attention.cu", 689, "serve",
                            "paged_attention_fwd"),
    "paged_prefill_write": ("paged_prefill_write.cu", 779, "serve",
                            "paged_prefill_write"),
    "paged_attention_fwd_int8": ("paged_attention.cu", 689, "serve_int8",
                                 "paged_attention_fwd"),
    "paged_prefill_write_int8": ("paged_prefill_write.cu", 779,
                                 "serve_int8", "paged_prefill_write"),
    "paged_attention_fwd_fp8": ("paged_attention.cu", 689, "serve_fp8",
                                "paged_attention_fwd"),
    "paged_prefill_write_fp8": ("paged_prefill_write.cu", 779, "serve_fp8",
                                "paged_prefill_write"),
    f"paged_prefill_write_layers{WRITE_LAYERS}": (
        "paged_prefill_write.cu", 779, "serve", "paged_prefill_write"),
    f"paged_prefill_write_layers{WRITE_LAYERS}_int8": (
        "paged_prefill_write.cu", 779, "serve_int8", "paged_prefill_write"),
    f"paged_prefill_write_layers{WRITE_LAYERS}_fp8": (
        "paged_prefill_write.cu", 779, "serve_fp8", "paged_prefill_write"),
    "paged_attention_fwd_mixed": ("paged_attention.cu", 689, "check_bf16",
                                  "paged_attention_fwd"),
    "paged_attention_fwd_long": ("paged_attention.cu", 689, "serve",
                                 "paged_attention_fwd"),
    "paged_attention_fwd_long_int8": ("paged_attention.cu", 689,
                                      "serve_int8", "paged_attention_fwd"),
    "paged_attention_fwd_long_fp8": ("paged_attention.cu", 689, "serve_fp8",
                                     "paged_attention_fwd"),
    "flash_attention_fwd_lse": ("flash_attention_wgmma.cu", 180, "train",
                                "flash_attention_fwd"),
    "flash_attention_bwd": ("flash_attention_bwd_wgmma.cu", 335, "train",
                            "flash_attention_bwd"),
    "fused_add_layernorm_fwd": ("fused_add_layernorm.cu", 461, "train",
                                "fused_add_layernorm_fwd"),
    # the port's own kernel: JAX's FusedUpdate is an XLA fusion, not a
    # Pallas kernel
    "fused_update": ("fused_update.cu", FUSED_UPDATE_REPLACES, "train_fused",
                     "fused_update"),
    "fused_update_momentum": ("fused_update.cu", FUSED_UPDATE_REPLACES,
                              "train_check_fused", "fused_update"),
    "fused_update_adam": ("fused_update.cu", FUSED_UPDATE_REPLACES,
                          "train_adam", "fused_update"),
    # the per-leaf optimizer's call: SGD as phase 7's default per-leaf run
    # takes it, Adam on per-leaf state (phase 5)
    "fused_update_per_leaf": ("fused_update.cu", FUSED_UPDATE_REPLACES,
                              "train", "fused_update"),
    "fused_update_adam_per_leaf": ("fused_update.cu", FUSED_UPDATE_REPLACES,
                                   "train_check_adam", "fused_update"),
    # phase 10's shapes: the MoE LM's causal attention in training, and
    # its serve's prefill, decode step and 12-layer prefill write
    "flash_attention_fwd_lse_moe_lm": ("flash_attention_wgmma.cu", 180,
                                       "moe_lm_train", "flash_attention_fwd"),
    "flash_attention_bwd_moe_lm": ("flash_attention_bwd_wgmma.cu", 335,
                                   "moe_lm_train", "flash_attention_bwd"),
    "flash_attention_fwd_moe_serve": ("flash_attention_wgmma.cu", 180,
                                      "moe_serve", "flash_attention_fwd"),
    "paged_attention_fwd_moe_serve": ("paged_attention.cu", 689,
                                      "moe_serve", "paged_attention_fwd"),
    f"paged_prefill_write_layers{GLAM['layers']}_moe_serve": (
        "paged_prefill_write.cu", 779, "moe_serve", "paged_prefill_write"),
    # phase 9's shapes: BERT-base's attention (head dim 64, 12 heads) and
    # ResNet-50's 214 leaves (two update launches a step)
    "flash_attention_fwd_lse_bert": ("flash_attention_wgmma.cu", 180,
                                     "zoo_bert", "flash_attention_fwd"),
    "flash_attention_bwd_bert": ("flash_attention_bwd_wgmma.cu", 335,
                                 "zoo_bert", "flash_attention_bwd"),
    "fused_update_resnet50": ("fused_update.cu", FUSED_UPDATE_REPLACES,
                              "zoo_resnet50", "fused_update"),
}


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the card")
    if not (ROOT / "flexflow_tpu_torch" / "__init__.py").is_file():
        fail(f"run from a checkout: {ROOT} holds no flexflow_tpu_torch/")
    sys.path.insert(0, str(ROOT))
    import flexflow_tpu_torch as port
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import llama_lm
    from flexflow_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    card = phase_card()
    phase_build(kernels)
    rows = phase_kernels(torch, port, kernels)
    launches = phase_check(torch, FFConfig, FFModel, llama_lm, kernels)
    checked = phase_train_check(torch, port, kernels)
    launches["train_check_fused"] = checked["fused SGD with momentum"]
    launches["train_check_adam"] = checked["Adam under WarmupCosine"]
    launches["serve"], ff = phase_serve(torch, FFConfig, FFModel, llama_lm,
                                        kernels, card)
    launches.update(phase_serve_quantized(torch, ff, kernels, card))
    del ff
    launches.update(phase_train(torch, port, kernels, card))
    launches.update(phase_zoo_check(torch, port, kernels))
    launches.update(phase_zoo_train(torch, port, kernels, card))
    launches.update(phase_rest(torch, port, kernels, card))
    say(f"total: {time.perf_counter() - t_start:.1f} s")

    table = []
    for name, r in rows.items():
        src, line, path, wrapper = KERNEL_ROWS[name]
        if launches[path][wrapper] == 0:
            fail(f"{name}: its kernel was launched no time on its path "
                 f"({path})")
        table.append({
            "name": name, "route": "cuda",
            "source": f"flexflow_tpu_torch/csrc/{src}",
            "replaces": (line if isinstance(line, str) else
                         f"flexflow_tpu/ops/pallas_kernels.py:{line}"),
            "path": path, "launches": launches[path][wrapper],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "library": r["library"],
            "copy_ms": r.get("copy_ms"), "per_leaf_ms": r.get("per_leaf_ms"),
            "vector_share": r.get("vector_share")})
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
