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

 11. decode features — right after 6b, on phase 6's Llama-3-8B (bf16, 4
                slots, 128-token pages, no prefix cache so every round
                prefills cold): (a) greedy through the captured decode (a
                CUDA graph: one capture, then replays), twice on one
                engine and once under torch.profiler (idle share), and the
                same body uncaptured in the same process (its decode step
                and token agreement printed); (b) sampled per request
                (temperatures 0 / 0.7 / 1.0, top_p 0.9, top_k 50, a seed
                each) on two engines; (c) greedy and (d) sampled
                speculation at K = 4 with a draft at Llama-3.2-1B's widths
                (hidden 2048, 16 layers, 32 heads over 8 kv heads, ffn
                8192, tied embeddings); (e) prefill_chunk=256, then with
                prefill_interleave_chunks=1 (and a wave whose 700-token
                prompt prefills while three short ones decode). Greedy
                tokens identical to phase 6's in every run (the
                temperature-0 rows of the sampled ones too), sampled
                streams identical across two engines, exact launch counts
                (the draft's layers included), each key captured once, the
                split-KV tickets zero after every round. Phase 3 holds
                kernel 4 at the verify slab (4, 5, 32, 128) with clamped
                positions and at the draft's decode step, kernel 1 at the
                draft's prefill and kernel 5 over its 16 layers.

 12. serving rest — right after 11, on phase 6's Llama-3-8B: (a) LoRA
                tenants (4 adapter pages + the null page, rank 16, every
                Linear op targeted: the 96 FFN Linears and lm_head; five
                seeded adapters A..E, alpha 16): the null adapter's tokens
                are phase 6's, each tenant alone, then A, B, C and the base
                model mixed across the slots (each request's tokens its
                tenant-alone tokens), then D, E and A again (LRU evictions,
                A's tokens unchanged, no capture added); decode step and
                adapter fault-in times. (b) The prefix cache's host tier
                (64 pinned host pages; a pool of 29 pages: scratch and the
                4 live slots' worst case, cached prefixes keeping what the
                live requests leave): six families of a 384-token
                prefix, two prompts each, then the first three families
                again — pages demote and promote, no copy fails, prefix
                hits equal an ample pool's without a tier, the native
                pool's tokens too, and a prefix exported before its
                demotion and after its promotion is the same bytes; the
                same from an int8 pool, where each request's first token
                (before any decode append) is the ample pool's and the
                rest agree positionwise at P12_INT8_AGREE or better (an
                append into a reused int8 page starts from the previous
                owner's scale, in both packages); TTFT of a promoted hit,
                an HBM hit
                and a cold prefill, D2H and H2D GB/s; drained and flushed,
                every page is free. (c) The lifecycle: a prefix slab
                prefilled on one engine and imported by another (the same
                tokens, re-exported bitwise); drain() with 4 live and 4
                queued, reclaim_queued(), reopen() (phase 6's tokens);
                health() polled from another thread meanwhile, its keys and
                load()'s JAX's; a request past its deadline retires with
                no launch; swap_weights to a second seeded model's
                weights on a native and an int8-weight engine (the tokens
                of an engine on that second model, no capture added) and
                back (the first tokens), refused under a live slot and, at
                native width, while another engine reads the model (which
                keeps its tokens); warmup() then the same prompts capture
                nothing. Exact launch counts in every round.

 13. generate — right after 12, on phase 6's Llama-3-8B (its construction
                weights back, no engine holding it): (a) FFModel.generate
                of the six prompts right-padded with prompt_lengths, 32 new
                tokens, greedy: kernel 1 once a layer (the batched
                whole-prompt prefill) and no other launch, the decode step
                a CUDA graph replayed 30 times, a second call's tokens
                identical, positionwise agreement with phase 6's serving
                tokens >= P13_AGREE (printed with the first-token
                matches); prefill ms, the decode step as a graph and
                uncaptured (one eager run: the same tokens), tokens/s;
                early_exit at an eos two rows emit (the full loop's tokens
                in fewer steps); return_scores; sampled (temperature 0.8,
                top_k 50: one seed twice, the same tokens); 4 beams on two
                prompts with scores; quantize="int8"; peak memory. (b) 2
                layers at Llama-3-8B widths in f32 (TF32 off), the same
                weights on the card and the CPU: greedy and beam tokens
                identical (a parting row prints its step and the CPU's
                top-2 logit margin there, and fails). (c) seq2seq_lm at
                Transformer-base widths (d_model 512, 6 + 6 layers, 8
                heads, d_ff 2048, vocab 37000) through generate_seq2seq:
                batch 32, source 128, a BOS prompt, 64 new tokens, bf16:
                kernel 1 once an encoder layer and once a decoder prefill
                layer, tokens/s; in f32 the card's tokens the CPU's.
                Phase 3 holds kernel 1 at generate's prefill (6, 700, 32,
                128) causal and the encoder's (32, 128, 8, 64) non-causal.

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
    rows.update(decode_feature_kernel_rows(torch, kernels, g))
    rows.update(generation_kernel_rows(torch, kernels, g))
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
                    s: int = 512, b: int = 1, causal: bool = True) -> dict:
    """Flash attention forward at a prefill of ``b`` rows of an ``s``-token
    bucket: q (b, s, h, d), k/v (b, s, kvh, d), causal (or not), bf16; SDPA
    (GQA) as the yardstick."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    scale = d ** -0.5
    q = torch.randn(b, s, h, d, device=dev, generator=g).to(bf16)
    k = torch.randn(b, s, kvh, d, device=dev, generator=g).to(bf16)
    v = torch.randn(b, s, kvh, d, device=dev, generator=g).to(bf16)
    out = kernels.flash_attention_fwd(q, k, v, causal, scale)
    ref = kernels.flash_attention_plain(q, k, v, causal, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= FLASH_TOL:
        fail(f"flash_attention_fwd disagrees with its plain version at q "
             f"{tuple(q.shape)}: max abs err {err}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                       enable_gqa=True)

        def lib():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)
    except TypeError:   # torch without enable_gqa: expand kv heads first
        ke = kt.repeat_interleave(h // kvh, dim=1)
        ve = vt.repeat_interleave(h // kvh, dim=1)

        def lib():
            F.scaled_dot_product_attention(qt, ke, ve, is_causal=causal)
    pairs = s * (s + 1) // 2 if causal else s * s
    return dict(
        err=err,
        ms=cuda_ms(lambda: kernels.flash_attention_fwd(q, k, v, causal,
                                                       scale)),
        plain_ms=cuda_ms(
            lambda: kernels.flash_attention_plain(q, k, v, causal, scale)),
        library_ms=cuda_ms(lib), library="F.scaled_dot_product_attention",
        bound=bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                    4 * b * pairs * h * d),
        shape=f"q ({b},{s},{h},{d}) k/v ({b},{s},{kvh},{d}) "
              f"{'causal' if causal else 'non-causal'} bf16")


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
    s = 1
    if geom:
        h, kvh, d, pps, lens = (geom[k] for k in ("heads", "kv_heads", "d",
                                                  "pages", "lens"))
        s = geom.get("s", 1)
    n_pool = b * pps + 1
    qdt = torch.float32 if pool == "mixed" else torch.bfloat16
    q = torch.randn(b, s, h, d, device=dev, generator=g).to(qdt)
    table = (torch.randperm(n_pool - 1, device=dev, generator=g) + 1)
    table = table[:b * pps].reshape(b, pps).to(torch.int32).contiguous()
    row_len, pad = (torch.tensor(x, dtype=torch.int32, device=dev)
                    for x in lens[:2])
    # a verify slab (s > 1): position i writes at lens[2] + i, clamped to
    # the slot's budget - 1 (the clamped slots repeat their last position)
    wp = torch.tensor(lens[2], dtype=torch.int32, device=dev)[:, None] \
        + torch.arange(s, dtype=torch.int32, device=dev)
    if s > 1:
        wp = torch.minimum(wp, torch.tensor(geom["budget"], dtype=torch.int32,
                                            device=dev)[:, None] - 1)
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
    # the pages they lie in (the scale reads); K/V are read once a slot (up
    # to its furthest frontier), the products count every query row's keys
    keys, live, pages_read = 0, 0, 0
    for i in range(b):
        front = [int(x) for x in wp[i]]
        pos = list(range(int(row_len[i]))) + list(
            range(int(pad[i]), max(front) + 1))
        keys += len(pos)
        live += sum(int(row_len[i]) + f + 1 - int(pad[i]) for f in front)
        pages_read += len({j // ps for j in pos})
    ints = 4 * (table.numel() + wp.numel() + 2 * b)
    # q read and out written, the live K/V once, a quantized pool's scales
    nbytes = (2 * q.element_size() * q.numel()
              + 2 * keys * kvh * d * kp.element_size() + ints
              + (4 * 2 * pages_read * kvh if kw else 0))
    peak = F32_FLOP_PER_S if pool == "mixed" else BF16_FLOP_PER_S
    # a bf16 verify slab splits as a decode step does, as the engine runs
    # it (attention.verify_as_decode)
    fwd_kw = dict(decode_splits=True) if s > 1 else {}
    plan = kernels.paged_attention_plan(b, s, h, kvh, ps, pps,
                                        kernels.sm_count(dev), **fwd_kw)
    limit, scaled = {"bf16": (PAGED_TOL, False), "int8": (QUANT_TOL, True),
                     "fp8": (QUANT_TOL, True),
                     "mixed": (MIXED_TOL, True)}[pool]
    desc = (f"q ({b},{s},{h},{d}) {'f32' if pool == 'mixed' else 'bf16'}, "
            f"{'bf16' if pool == 'mixed' else pool} pool ({n_pool},{ps},"
            f"{kvh},{d}){' + scales' if kw else ''}, {keys} live positions"
            + (f", write_pos {wp.tolist()}" if s > 1 else "") + "; "
            f"grid {plan.grid} = {plan.blocks} blocks of {plan.threads}, "
            f"{plan.splits} splits of {plan.split_pages} page(s)")
    return dict(args=(q, kp, vp, table, wp, row_len, pad, d ** -0.5), kw=kw,
                fwd_kw=fwd_kw, limit=limit, scaled=scaled, bound=bound(nbytes, 4 * live * h
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
        out = kernels.paged_attention_fwd(*c["args"], **c["kw"],
                                          **c["fwd_kw"])
        ref = kernels.paged_attention_plain(*c["args"], **c["kw"])
        torch.cuda.synchronize()
        err = paged_err(c, out, ref)
        if not err <= c["limit"]:
            fail(f"{name} disagrees with its plain version: err {err} "
                 f"(limit {c['limit']}{', scaled' if c['scaled'] else ''})")
        rows[name] = dict(
            err=err,
            ms=cuda_ms(lambda: kernels.paged_attention_fwd(
                *c["args"], **c["kw"], **c["fwd_kw"])),
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


def decode_feature_kernel_rows(torch, kernels, g):
    """Kernels 1, 4 and 5 at the new shapes of phase 11's speculative
    serve: kernel 4 at the verify slab (4 slots of K + 1 = 5 positions
    over Llama-3-8B's pool, the clamped slots repeating their last write
    position) and at the draft's decode step (Llama-3.2-1B's 32 heads of
    64 over 8 kv heads), kernel 1 at the draft's 512-token prefill, and
    kernel 5 writing the draft's 16 layers in one launch."""
    h, kvh = LLAMA32_1B["heads"], LLAMA32_1B["kv_heads"]
    d = LLAMA32_1B["hidden"] // h
    rows = paged_attention_rows(
        torch, kernels, g, (("paged_attention_fwd_verify", "bf16", False),),
        dict(heads=LLAMA3_8B["heads"], kv_heads=LLAMA3_8B["kv_heads"],
             d=128, pages=8, s=SPEC_K + 1,
             lens=([500, 620, 530, 690], [512, 640, 544, 704],
                   [600, 660, 560, 720]), budget=[1024, 662, 562, 1024]))
    rows.update(paged_attention_rows(
        torch, kernels, g, (("paged_attention_fwd_draft", "bf16", False),),
        dict(heads=h, kv_heads=kvh, d=d, pages=8,
             lens=([500, 620, 530, 690], [512, 640, 544, 704],
                   [600, 660, 560, 720]))))
    rows["flash_attention_fwd_draft"] = flash_serve_row(torch, kernels, g, h,
                                                        kvh, d)
    rows.update(prefill_write_rows(
        torch, kernels, g, pools=(("", "bf16"),),
        layer_counts=(LLAMA32_1B["layers"],), tag_suffix="_draft", kvh=kvh,
        d=d))
    return rows


def generation_kernel_rows(torch, kernels, g):
    """Kernel 1 at phase 13's three new shapes: generate's prefill of the
    six prompts right-padded to 700 (Llama-3-8B's 32 heads over 8 kv
    heads, causal), the Transformer-base encoder's self-attention (batch
    32, source 128, 8 heads of 64, non-causal) and its decoder's prefill
    of the one-token BOS prompt (batch 32, q/k/v of one position, causal:
    one valid row and one key in the tile)."""
    h, kvh = LLAMA3_8B["heads"], LLAMA3_8B["kv_heads"]
    th, td = T_BASE["heads"], T_BASE["hidden"] // T_BASE["heads"]
    return {
        "flash_attention_fwd_generate": flash_serve_row(
            torch, kernels, g, h, kvh, 128, s=max(PROMPT_LENS),
            b=len(PROMPT_LENS)),
        "flash_attention_fwd_seq2seq": flash_serve_row(
            torch, kernels, g, th, th, td, s=T_BASE_RUN["src"],
            b=T_BASE_RUN["batch"], causal=False),
        "flash_attention_fwd_seq2seq_dec": flash_serve_row(
            torch, kernels, g, th, th, td, s=1, b=T_BASE_RUN["batch"])}


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
    return launches, ff, outs


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


# ------------------- phase 11: the serving engine's decode features

#: the draft: Llama-3.2-1B's widths (meta-llama/Llama-3.2-1B config.json;
#: its "llama3" rope scaling is implemented by neither package)
LLAMA32_1B = dict(hidden=2048, layers=16, heads=32, kv_heads=8,
                  ffn_hidden=8192, vocab_size=128256, rope_theta=500000.0)
SPEC_K = 4
#: phase 11's engine: phase 6's without the prefix cache, so a second
#: round on one engine prefills cold again (a hit's tail runs the grouped
#: einsum attention, not the flash kernel, and its tokens may differ)
P11_ENGINE = dict(ENGINE, prefix_cache=False)
#: the sampled requests: temperatures cycled over the prompts, nucleus
#: and top-k filters, one seed a request
P11_TEMPS = (0.0, 0.7, 1.0)
P11_TOP_P, P11_TOP_K = 0.9, 50
P11_CHUNK = 256


def _p11_sampled_kw(n: int):
    return [dict(temperature=P11_TEMPS[i % len(P11_TEMPS)], top_p=P11_TOP_P,
                 top_k=P11_TOP_K, seed=100 + i) for i in range(n)]


def _p11_expected(eng, prompts, st):
    """The launches a serve of ``prompts`` on ``eng`` must make, from its
    stats deltas ``st``: kernel 1 once a layer for each prompt prefilled
    whole (the target's, unless its bucket passes prefill_chunk; the
    draft's always), kernel 5 once a prefill a model, kernel 4 once a
    layer a decode step (under speculation: the draft's layers K times a
    dispatch, the target's once)."""
    layers = len(eng.gen.attn_ops)
    chunk = eng.prefill_chunk
    whole = sum(1 for p in prompts
                if not chunk or eng._bucket(p.size) <= chunk)
    n = len(prompts)
    want = {"flash_attention_fwd": layers * whole,
            "paged_prefill_write": n,
            "paged_attention_fwd": layers * st["decode_steps"],
            "flash_attention_bwd": 0, "fused_add_layernorm_fwd": 0,
            "fused_update": 0}
    if eng.draft_gen is not None:
        dl = len(eng.draft_gen.attn_ops)
        want["flash_attention_fwd"] += dl * n
        want["paged_prefill_write"] += n
        want["paged_attention_fwd"] = (layers + dl * eng.speculate_k) \
            * st["spec_dispatches"]
    return want


def _p11_round(torch, kernels, eng, prompts, tag: str, kws=None):
    """One serve of ``prompts`` on ``eng`` (``kws``: one submit() kwargs
    dict a request) with the launch counts set to 0 just before; fails
    unless every request finished and each kernel ran exactly its
    expected count, or a split-KV ticket was left set. Returns the tokens,
    wall time, stats deltas, TTFTs (ms) and launches."""
    import numpy as np

    before = eng.stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, MAX_NEW, **(kws[i] if kws else {}))
            for i, p in enumerate(prompts)]
    while eng.step():
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    st = eng.stats()
    d = {k: st[k] - before[k] for k in (
        "decode_steps", "tokens_generated", "spec_dispatches",
        "spec_proposed", "spec_accepted", "prefill_chunks_interleaved",
        "recompiles", "graph_replays")}
    d["decode_ms"] = (st["decode_step_ms"] * st["decode_steps"]
                      - before["decode_step_ms"] * before["decode_steps"])
    if any(r.state != "done" for r in reqs):
        fail(f"phase 11 ({tag}): not every request finished: "
             f"{[(r.state, r.error) for r in reqs]}")
    want = _p11_expected(eng, prompts, d)
    if launches != want:
        fail(f"phase 11 ({tag}): kernel launches {launches} != expected "
             f"{want}")
    if not kernels.tickets_clear():
        fail(f"phase 11 ({tag}): a split-KV ticket was left set")
    toks = [list(r.tokens) for r in reqs]
    vocab = LLAMA3_8B["vocab_size"]
    if any(not 0 <= t < vocab for ts in toks for t in ts):
        fail(f"phase 11 ({tag}): a token outside [0, {vocab})")
    return dict(tokens=toks, wall=wall, d=d, launches=launches,
                step_ms=d["decode_ms"] / max(1, d["decode_steps"]),
                ttfts=[r.ttft * 1e3 for r in reqs], st=st)


def _p11_diff(got, want) -> str:
    """Where two token lists first differ, per prompt ('' if equal)."""
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            out.append(f"prompt {i} from token {j} of {len(b)}")
    return "; ".join(out)


def _p11_say(tag: str, r: dict, card: str):
    t = sorted(r["ttfts"])
    say(f"phase 11 ({tag}): {r['d']['tokens_generated']} tokens in "
        f"{r['wall']:.3f} s = {r['d']['tokens_generated'] / r['wall']:.2f} "
        f"tokens/s, decode step {r['step_ms']:.2f} ms over "
        f"{r['d']['decode_steps']} steps, TTFT p50 {t[len(t) // 2]:.1f} ms "
        f"p99 {t[-1]:.1f} ms, captures {r['d']['recompiles']}, replays "
        f"{r['d']['graph_replays']} [{card}]")


def phase_decode_features(torch, FFConfig, FFModel, llama_lm, kernels, ff,
                          ref, prompts, card: str):
    """Phase 11: phase 6's Llama-3-8B serves through the decode features —
    (a) greedy through the captured decode, (b) sampled per request, (c)
    greedy and (d) sampled speculation with a Llama-3.2-1B-width draft at
    K = SPEC_K, greedy speculation with the target as its own draft, (e)
    chunked and chunk-interleaved prefill. ``ref``: phase
    6's tokens. Returns {path: launch counts} and the captured decode's
    step (ms) of (a)'s replay round."""
    from torch.profiler import ProfilerActivity, profile

    problems = []

    def same(tag, got, want):
        diff = _p11_diff(got, want)
        say(f"phase 11 ({tag}): tokens identical: {not diff}"
            + (f" (differ: {diff})" if diff else ""))
        if diff:
            problems.append(f"{tag}: {diff}")

    out = {}
    # (a) greedy through the captured decode: a round that captures, a
    # round of replays only, then the same body uncaptured (printed)
    eng = ff.make_serving_engine(**P11_ENGINE)
    a1 = _p11_round(torch, kernels, eng, prompts, "greedy, capture")
    same("greedy, captured decode vs phase 6", a1["tokens"], ref)
    a2 = _p11_round(torch, kernels, eng, prompts, "greedy, replay")
    same("greedy, second round on the engine", a2["tokens"], ref)
    if a1["d"]["recompiles"] != 1 or a2["d"]["recompiles"] != 0:
        fail(f"phase 11 (greedy): captures {a1['d']['recompiles']} then "
             f"{a2['d']['recompiles']}: the decode key must be captured once")
    out["decode_graph"] = a2["launches"]
    _p11_say("greedy, captured decode, first round", a1, card)
    _p11_say("greedy, captured decode, replays only", a2, card)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a3 = _p11_round(torch, kernels, eng, prompts, "greedy, profiled")
    busy = busy_ms(prof.events())
    say(f"phase 11 (greedy, captured decode, under the profiler): serve "
        f"{a3['wall'] * 1e3:.1f} ms wall, device busy {busy:.1f} ms, idle "
        f"share {1 - busy / (a3['wall'] * 1e3):.3f}, decode step "
        f"{a3['step_ms']:.2f} ms [{card}]")
    del prof
    # the same decode body, run uncaptured (the engine's comparison switch)
    eager = ff.make_serving_engine(**P11_ENGINE, capture=False)
    e1 = _p11_round(torch, kernels, eager, prompts, "greedy, uncaptured")
    e2 = _p11_round(torch, kernels, eager, prompts, "greedy, uncaptured")
    agree = sum(x == y for a, b in zip(e2["tokens"], ref)
                for x, y in zip(a, b)) / sum(len(b) for b in ref)
    say(f"phase 11 (greedy, the decode body uncaptured, same process): "
        f"decode step {e2['step_ms']:.2f} ms against the graph's "
        f"{a2['step_ms']:.2f} ms; {e2['d']['tokens_generated'] / e2['wall']:.2f}"
        f" against {a2['d']['tokens_generated'] / a2['wall']:.2f} tokens/s; "
        f"token agreement with the graph's {agree:.3f} (positionwise, not "
        f"gated: cuBLAS may choose other algorithms under capture) [{card}]")
    del eager, e1, e2

    # (b) sampled, per request, on two engines
    kws = _p11_sampled_kw(len(prompts))
    b1 = _p11_round(torch, kernels, eng, prompts, "sampled", kws)
    eng_b = ff.make_serving_engine(**P11_ENGINE)
    b2 = _p11_round(torch, kernels, eng_b, prompts, "sampled, 2nd engine",
                    kws)
    same("sampled, two engines", b2["tokens"], b1["tokens"])
    greedy_rows = [i for i, k in enumerate(kws) if k["temperature"] == 0]
    same("sampled, temperature-0 rows vs phase 6",
         [b1["tokens"][i] for i in greedy_rows], [ref[i] for i in greedy_rows])
    sampled_rows = [i for i in range(len(prompts)) if i not in greedy_rows]
    moved = sum(b1["tokens"][i] != ref[i] for i in sampled_rows)
    say(f"phase 11 (sampled): temperatures {[k['temperature'] for k in kws]}"
        f", top_p {P11_TOP_P}, top_k {P11_TOP_K}: {moved} of "
        f"{len(sampled_rows)} sampled streams differ from the greedy one")
    _p11_say("sampled", b1, card)
    if b1["d"]["recompiles"] != 0:
        fail("phase 11 (sampled): the decode graph was captured again")
    out["sampled"] = b1["launches"]
    del eng_b

    # (c) and (d): speculation with the Llama-3.2-1B-width draft
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    draft = build_llama(FFConfig, FFModel, llama_lm, "cuda", "bfloat16", 1,
                        tie_embeddings=True, **LLAMA32_1B)
    n_draft = sum(t.numel() for ws in draft.params.values()
                  for t in ws.values())
    say(f"phase 11: draft at Llama-3.2-1B widths, {LLAMA32_1B['layers']} "
        f"layers, tied embeddings, {n_draft / 1e9:.3f} B params bf16, built "
        f"in {time.perf_counter() - t0:.1f} s")
    spec_kw = dict(P11_ENGINE, draft_model=draft, speculate_k=SPEC_K)
    eng_c = ff.make_serving_engine(**spec_kw)
    c1 = _p11_round(torch, kernels, eng_c, prompts, "speculative greedy")
    same("speculative greedy vs (a)", c1["tokens"], a1["tokens"])
    c2 = _p11_round(torch, kernels, eng_c, prompts, "speculative greedy")
    same("speculative greedy, second round", c2["tokens"], a1["tokens"])
    if c1["d"]["recompiles"] != 2 or c2["d"]["recompiles"] != 0:
        fail(f"phase 11 (speculative): captures {c1['d']['recompiles']} "
             f"then {c2['d']['recompiles']}: the proposal and the verify "
             f"keys must be captured once each")
    for tag, r in (("first round", c1), ("second round", c2)):
        _p11_say(f"speculative greedy K={SPEC_K}, {tag}", r, card)
        say(f"phase 11 (speculative greedy K={SPEC_K}, {tag}): accept rate "
            f"{r['d']['spec_accepted'] / max(1, r['d']['spec_proposed']):.4f}"
            f" ({r['d']['spec_accepted']} of {r['d']['spec_proposed']}, "
            f"{r['d']['spec_dispatches']} dispatches) [{card}]")
    out["spec_greedy"] = c2["launches"]
    d1 = _p11_round(torch, kernels, eng_c, prompts, "speculative sampled",
                    kws)
    eng_d = ff.make_serving_engine(**spec_kw)
    d2 = _p11_round(torch, kernels, eng_d, prompts,
                    "speculative sampled, 2nd engine", kws)
    same("speculative sampled, two engines", d2["tokens"], d1["tokens"])
    same("speculative sampled, temperature-0 rows vs phase 6",
         [d1["tokens"][i] for i in greedy_rows], [ref[i] for i in greedy_rows])
    _p11_say("speculative sampled", d1, card)
    out["spec_sampled"] = d1["launches"]
    say(f"phase 11: launches, speculative greedy round {c2['launches']}")
    del eng_c, eng_d, draft
    gc.collect()
    torch.cuda.empty_cache()

    # (c) again with the target as its own draft: its proposals are the
    # decode's tokens, so the verify accepts them and takes the bonus token
    # (the accepted path, which the random draft never reaches)
    eng_s = ff.make_serving_engine(**P11_ENGINE, draft_model=ff,
                                   speculate_k=SPEC_K)
    s1 = _p11_round(torch, kernels, eng_s, prompts,
                    "self-draft speculative greedy")
    same("self-draft speculative greedy vs (a)", s1["tokens"], a1["tokens"])
    _p11_say(f"self-draft speculative greedy K={SPEC_K}", s1, card)
    say(f"phase 11 (self-draft speculative greedy K={SPEC_K}): accept rate "
        f"{s1['d']['spec_accepted'] / max(1, s1['d']['spec_proposed']):.4f}"
        f" ({s1['d']['spec_accepted']} of {s1['d']['spec_proposed']}, "
        f"{s1['d']['spec_dispatches']} dispatches) [{card}]")
    if not s1["d"]["spec_accepted"] > 0:
        fail("phase 11 (self-draft speculative greedy): no proposal was "
             "accepted")
    out["spec_self_draft"] = s1["launches"]
    del eng_s
    gc.collect()
    torch.cuda.empty_cache()

    # (e) chunked, then chunk-interleaved prefill
    for tag, knobs in (("prefill_chunk", dict(prefill_chunk=P11_CHUNK)),
                       ("interleaved", dict(prefill_chunk=P11_CHUNK,
                                            prefill_interleave_chunks=1))):
        eng_e = ff.make_serving_engine(**P11_ENGINE, **knobs)
        r = _p11_round(torch, kernels, eng_e, prompts, tag)
        same(f"{tag} {P11_CHUNK} vs (a)", r["tokens"], a1["tokens"])
        _p11_say(tag, r, card)
        out[f"chunk_{tag}"] = r["launches"]
        # the short prompts' TTFT while the longest prompt prefills: it is
        # admitted first and its chunks run a tick each (interleaved) or
        # all at its admission
        wave = [max(prompts, key=len)] + sorted(prompts, key=len)[:3]
        w = _p11_round(torch, kernels, eng_e, wave, f"{tag}, one wave")
        say(f"phase 11 ({tag}): a wave of {[p.size for p in wave]}-token "
            f"prompts: TTFT {[round(t, 1) for t in w['ttfts']]} ms, "
            f"{w['d']['prefill_chunks_interleaved']} chunks interleaved "
            f"[{card}]")
        del eng_e
    del eng
    if problems:
        fail("phase 11: " + " | ".join(problems))
    return out, a2["step_ms"]


#: phase 12: the LoRA pool (pages, rank, alpha, the adapters' spread), the
#: host tier (its pages; the tight pool: scratch and the 4 slots' worst case
#: of 7 pages each, so cached prefixes keep only what live requests leave;
#: the ample reference pool), the copy-rate batch
P12_LORA = dict(adapter_pool_pages=4, lora_rank=16)
P12_ALPHA = 16.0
P12_LORA_STD = 0.03
P12_TIER = dict(prefix_cache=True, host_kv_pages=64, kv_pages=29)
P12_AMPLE = dict(prefix_cache=True, host_kv_pages=0, kv_pages=80)
P12_COPY_PAGES = 8
#: the int8 tier engine's positionwise token agreement with the ample int8
#: pool, at least: a decode append into a reused int8 page starts from its
#: previous owner's running-max scale (JAX's ``_paged_append`` too), and the
#: two pools reuse other pages, so past each request's first token the
#: streams may part; below phase 6b's int8-vs-native agreements at these
#: widths (0.938 / 0.977 on an H100 80GB HBM3 at 700 W), far above the
#: repo's documented int8 budget against full width (0.6, docs/serving.md)
P12_INT8_AGREE = 0.9
#: JAX's health() and load() keys (flexflow_tpu/runtime/serving.py
#: ServingEngine.health / load), in order
P12_HEALTH_KEYS = ["status", "admitting", "active_slots", "queued",
                   "weight_version", "deploy_state", "serve_slots",
                   "free_pages", "completed", "failed", "timeouts",
                   "occupancy", "recompiles", "pages_in_use",
                   "kv_pages_shared", "prefix_hit_rate", "spec_accept_rate",
                   "kv_cache_dtype", "weight_dtype", "kv_bytes_per_token",
                   "tokens_per_pool_gb"]
P12_LOAD_KEYS = ["active_slots", "queued"]


def _p12_round(torch, kernels, eng, prompts, tag: str, kws=None):
    """One serve of ``prompts`` on ``eng`` (no draft) with the launch
    counts set to 0 just before: fails unless every request finished and
    each kernel ran exactly its count — kernel 1 once a layer for each cold
    prefill (an admission the prefix cache did not hit), kernel 5 once an
    admission, kernel 4 once a layer a decode step. Returns the tokens,
    prefix tokens, TTFTs (ms), stats deltas and launches."""
    layers = len(eng.gen.attn_ops)
    before = eng.stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, MAX_NEW, **(kws[i] if kws else {}))
            for i, p in enumerate(prompts)]
    while eng.step():
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    st = eng.stats()
    d = {k: st[k] - before[k] for k in (
        "decode_steps", "tokens_generated", "prefix_lookups", "prefix_hits",
        "recompiles", "tier_demotions", "tier_promotions")}
    d["decode_ms"] = (st["decode_step_ms"] * st["decode_steps"]
                      - before["decode_step_ms"] * before["decode_steps"])
    if any(r.state != "done" for r in reqs):
        fail(f"phase 12 ({tag}): not every request finished: "
             f"{[(r.state, r.error) for r in reqs]}")
    admitted = d["prefix_lookups"] if eng.prefix_cache else len(prompts)
    want = {"flash_attention_fwd": layers * (admitted - d["prefix_hits"]),
            "paged_prefill_write": admitted,
            "paged_attention_fwd": layers * d["decode_steps"],
            "flash_attention_bwd": 0, "fused_add_layernorm_fwd": 0,
            "fused_update": 0}
    if launches != want:
        fail(f"phase 12 ({tag}): kernel launches {launches} != expected "
             f"{want}")
    if not kernels.tickets_clear():
        fail(f"phase 12 ({tag}): a split-KV ticket was left set")
    return dict(tokens=[list(r.tokens) for r in reqs],
                prefix=[r.prefix_tokens for r in reqs],
                ttfts=[r.ttft * 1e3 for r in reqs], wall=wall, d=d,
                launches=launches, st=st,
                step_ms=d["decode_ms"] / max(1, d["decode_steps"]))


def _p12_adapter(np, geometry, seed: int, rank: int):
    rs = np.random.RandomState(seed)
    return {n: {"a": (rs.standard_normal((i, rank)) * P12_LORA_STD)
                .astype(np.float32),
                "b": (rs.standard_normal((rank, o)) * P12_LORA_STD)
                .astype(np.float32)}
            for n, (i, o) in geometry.items()}


def _p12_lora(torch, kernels, ff, ref, prompts, step_ms_p11: float,
              card: str, same, out):
    """Phase 12 (a): LoRA tenants on the captured decode."""
    import numpy as np

    eng = ff.make_serving_engine(**P11_ENGINE, **P12_LORA)
    geo = eng.lora.geometry
    n_ops = len(geo)
    t0 = time.perf_counter()
    for i, name in enumerate("ABCDE"):
        eng.register_adapter(name, _p12_adapter(np, geo, 40 + i,
                                                eng.lora_rank),
                             alpha=P12_ALPHA)
    pool_mb = sum(t.numel() * 4 for v in eng.lora_pool.values()
                  for t in (v.values() if isinstance(v, dict) else [v])) \
        / 2**20
    say(f"phase 12 (LoRA): {n_ops} Linear ops targeted, rank "
        f"{eng.lora_rank}, alpha {P12_ALPHA}, 5 adapters registered in "
        f"{time.perf_counter() - t0:.1f} s, device pool "
        f"{eng.adapter_pool_pages} pages + the null page = {pool_mb:.0f} MiB")
    if n_ops != 3 * LLAMA3_8B["layers"] + 1:
        fail(f"phase 12 (LoRA): {n_ops} Linear ops targeted, expected the "
             f"{3 * LLAMA3_8B['layers']} FFN Linears and lm_head")
    w1 = _p12_round(torch, kernels, eng, prompts, "LoRA, null adapter")
    same("LoRA wave 1 (null adapter) vs phase 6", w1["tokens"], ref)
    caps = eng.stats()["recompiles"]
    out["lora"] = w1["launches"]
    say(f"phase 12 (LoRA): decode step with the adapter pool "
        f"{w1['step_ms']:.2f} ms (null pages, first round, incl. capture) "
        f"against phase 11's captured step {step_ms_p11:.2f} ms [{card}]")
    # each tenant alone over every prompt, then the tenants mixed
    solo = {}
    for name in "ABC":
        r = _p12_round(torch, kernels, eng, prompts, f"LoRA, {name} alone",
                       [dict(adapter=name)] * len(prompts))
        solo[name] = r["tokens"]
    # C comes back last, so A and B are the least recently used pages
    tenants = ["A", "B", "C", None, "C", None]
    mixed = _p12_round(torch, kernels, eng, prompts, "LoRA, mixed",
                       [dict(adapter=t) for t in tenants])
    same("LoRA wave 2 (A, B, C, null mixed) vs each tenant alone",
         mixed["tokens"], [solo[t][i] if t else ref[i]
                           for i, t in enumerate(tenants)])
    moved = sum(solo[n][i] != ref[i] for n in "ABC"
                for i in range(len(prompts)))
    say(f"phase 12 (LoRA): {moved} of {3 * len(prompts)} tenant streams "
        f"differ from the base model's")
    if not moved:
        fail("phase 12 (LoRA): no adapter moved a token")
    say(f"phase 12 (LoRA): decode step, mixed tenants "
        f"{mixed['step_ms']:.2f} ms over {mixed['d']['decode_steps']} "
        f"steps (replays only) against phase 11's {step_ms_p11:.2f} ms "
        f"[{card}]")
    # adapter fault-in: one adapter's pages written into its device page
    # (the same bytes again), host -> device
    st = eng.stats()
    page = eng.lora.lookup_page("A")
    ent = eng.lora.registry["A"]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._write_adapter_page(page, ent["payload"], ent["scale"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    mb = sum(a.nbytes for sub in ent["payload"].values()
             for a in sub.values()) / 2**20
    say(f"phase 12 (LoRA): adapter fault-in {sorted(times)[1]:.1f} ms "
        f"(median of 3) for {mb:.0f} MiB from pageable host memory "
        f"[{card}]")
    # D and E take the free page and then evict the least recently used
    # tenant; A's return evicts the next
    for name in "DEA":
        r = _p12_round(torch, kernels, eng, prompts, f"LoRA, {name} alone",
                       [dict(adapter=name)] * len(prompts))
    same("LoRA wave 3: A after eviction and fault-in vs A alone before",
         r["tokens"], solo["A"])
    st = eng.stats()
    say(f"phase 12 (LoRA): adapter faults {st['adapter_faults']}, hits "
        f"{st['adapter_hits']}, evictions {st['adapter_evictions']}, "
        f"captures since wave 1 {st['recompiles'] - caps}; launches of the "
        f"mixed wave {mixed['launches']}")
    if st["adapter_evictions"] < 2 or st["recompiles"] != caps \
            or st["adapter_refs_live"] != 0:
        fail(f"phase 12 (LoRA): evictions {st['adapter_evictions']} (>= 2)"
             f", captures added {st['recompiles'] - caps} (0), live refs "
             f"{st['adapter_refs_live']} (0)")
    out["lora_mixed"] = mixed["launches"]
    del eng


def _p12_tier_traffic(np):
    """Six families of a QUANT_PREFIX-token prefix, two prompts a family
    (phase 6b's tails), families in turn; then the first three families'
    prompts again."""
    rs = np.random.RandomState(12)
    vocab = LLAMA3_8B["vocab_size"]
    fams = [rs.randint(0, vocab, size=QUANT_PREFIX) for _ in range(6)]
    first = [np.concatenate([fams[i // 2], rs.randint(
        0, vocab, size=QUANT_TAILS[i % len(QUANT_TAILS)])]).astype(np.int32)
        for i in range(12)]
    return first, first[:6]


def _p12_tier_run(torch, kernels, eng, first, again, tag):
    """The tier traffic on one engine: family 0, the prefix's pages
    exported, families 1-5, then the repeats one request at a time (each
    TTFT is its own admission's), the prefix exported again."""
    r0 = _p12_round(torch, kernels, eng, first[:2], f"{tag}, family 0")
    before = eng.export_prefix_slab(first[0][:QUANT_PREFIX])
    r1 = _p12_round(torch, kernels, eng, first[2:], f"{tag}, families 1-5")
    tier0 = eng.prefix_cache.match(first[0], 3)[0].tier
    rep = [_p12_round(torch, kernels, eng, [p], f"{tag}, repeat {i}")
           for i, p in enumerate(again)]
    after = eng.export_prefix_slab(first[0][:QUANT_PREFIX])
    eng.prefix_cache.wait_migrations()
    return dict(tokens=r0["tokens"] + r1["tokens"]
                + [r["tokens"][0] for r in rep],
                prefix=r0["prefix"] + r1["prefix"]
                + [r["prefix"][0] for r in rep],
                cold_ttft=r0["ttfts"][0], rep=rep, before=before,
                after=after, tier0=tier0, st=eng.stats(),
                launches=r1["launches"])


def _p12_copy_rates(torch, eng, card: str, tag: str):
    """The host tier's copies at their batch: P12_COPY_PAGES pool pages
    (target pool, scales included) D2H into pinned memory and back H2D
    into free pages of the drained, flushed engine (nothing served
    changes)."""
    pages = list(range(1, 1 + P12_COPY_PAGES))
    dst = eng._free_pages[:P12_COPY_PAGES]
    page_bytes = sum(t[0].numel() * t.element_size()
                     for c in eng.pool.values() for t in c.values())
    d2h, h2d = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payloads = eng._page_d2h(pages)()
        d2h.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._page_h2d(dst, payloads)
        torch.cuda.synchronize()
        h2d.append(time.perf_counter() - t0)
    nbytes = page_bytes * P12_COPY_PAGES
    say(f"phase 12 (host tier, {tag}): D2H {nbytes / sorted(d2h)[2] / 1e9:.1f}"
        f" GB/s, H2D {nbytes / sorted(h2d)[2] / 1e9:.1f} GB/s (median of 5,"
        f" {P12_COPY_PAGES} pages of {page_bytes / 2**20:.1f} MiB, pinned "
        f"host memory, host clock around each copy and its sync) [{card}]")


def _p12_tier(torch, kernels, ff, card: str, same, out):
    """Phase 12 (b): the host tier under a tight pool, native and int8."""
    import numpy as np

    first, again = _p12_tier_traffic(np)
    for kv in ("native", "int8"):
        tag = f"host tier, {kv} pool"
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        eng = ff.make_serving_engine(**ENGINE, kv_cache_dtype=kv,
                                     **P12_TIER)
        tight = _p12_tier_run(torch, kernels, eng, first, again, tag)
        t_tight = time.perf_counter() - t0
        ample_eng = ff.make_serving_engine(**ENGINE, kv_cache_dtype=kv,
                                           **P12_AMPLE)
        ample = _p12_tier_run(torch, kernels, ample_eng, first, again,
                              f"ample {kv} pool")
        st = tight["st"]
        say(f"phase 12 ({tag}): kv_pages {st['kv_pages']}, host pages "
            f"{st['host_kv_pages']}: demotions {st['tier_demotions']}, "
            f"promotions {st['tier_promotions']}, host evictions "
            f"{st['tier_host_evictions']}, failures "
            f"{st['tier_demote_failures']} / "
            f"{st['tier_promote_failures']}, hits {st['prefix_hits']} of "
            f"{st['prefix_lookups']} (ample pool: "
            f"{ample['st']['prefix_hits']}); the first family's prefix was "
            f"{tight['tier0']}-resident before its repeat; {t_tight:.1f} s")
        if st["tier_demotions"] == 0 or st["tier_promotions"] == 0 \
                or st["tier_demote_failures"] or st["tier_promote_failures"] \
                or tight["tier0"] != "host":
            fail(f"phase 12 ({tag}): demotions {st['tier_demotions']} and "
                 f"promotions {st['tier_promotions']} must be > 0, failures "
                 f"{st['tier_demote_failures']} / "
                 f"{st['tier_promote_failures']} 0, and the first family "
                 f"demoted ({tight['tier0']})")
        if tight["prefix"] != ample["prefix"]:
            fail(f"phase 12 ({tag}): prefix hits {tight['prefix']} != the "
                 f"ample pool's {ample['prefix']}")
        for pb, pa in zip(tight["before"]["payload"],
                          tight["after"]["payload"]):
            for key in pb:
                for name in pb[key]:
                    if pb[key][name].tobytes() != pa[key][name].tobytes():
                        fail(f"phase 12 ({tag}): page {key} {name} not "
                             f"bitwise after demotion and promotion")
        say(f"phase 12 ({tag}): the first family's {QUANT_PREFIX}-token "
            f"prefix exported before its demotion and after its promotion:"
            f" bitwise equal")
        if kv == "native":
            same(f"{tag} vs an ample pool without a host tier",
                 tight["tokens"], ample["tokens"])
        else:
            same(f"{tag}: each request's first token vs the ample pool's",
                 [x[:1] for x in tight["tokens"]],
                 [y[:1] for y in ample["tokens"]])
            agree = np.mean([a == b for x, y in zip(tight["tokens"],
                                                    ample["tokens"])
                             for a, b in zip(x, y)])
            parted = [next((i for i, (a, b) in enumerate(zip(x, y))
                            if a != b), None)
                      for x, y in zip(tight["tokens"], ample["tokens"])]
            say(f"phase 12 ({tag}): token agreement with the ample int8 "
                f"pool {agree:.4f} (positionwise; limit {P12_INT8_AGREE}: "
                f"a decode append into a reused int8 page starts from its "
                f"previous owner's scale); first differing token of each "
                f"request {parted}")
            if agree < P12_INT8_AGREE:
                fail(f"phase 12 ({tag}): token agreement {agree:.4f} with "
                     f"the ample int8 pool is below {P12_INT8_AGREE}")
        promoted = [r["ttfts"][0] for r in tight["rep"]
                    if r["d"]["tier_promotions"] > 0]
        hbm = [r["ttfts"][0] for r in ample["rep"]]
        say(f"phase 12 ({tag}): TTFT of a promoted hit "
            f"{np.median(promoted):.1f} ms (median of {len(promoted)}), of "
            f"an HBM hit {np.median(hbm):.1f} ms (median of {len(hbm)}), of "
            f"a cold prefill {tight['cold_ttft']:.1f} ms (the first "
            f"request) [{card}]")
        eng.drain()
        eng.flush_prefix_cache()
        st = eng.stats()
        if st["free_pages"] != st["kv_pages"] - 1 or st["kv_pages_host"] \
                or st["prefix_refs_live"]:
            fail(f"phase 12 ({tag}): after drain and flush free "
                 f"{st['free_pages']} (want {st['kv_pages'] - 1}), host "
                 f"{st['kv_pages_host']} (0), refs {st['prefix_refs_live']}")
        _p12_copy_rates(torch, eng, card, kv)
        out[f"tier_{kv}"] = tight["launches"]
        del eng, ample_eng, tight, ample


def _p12_lifecycle(torch, kernels, ff, ref, prompts, card: str, same, out):
    """Phase 12 (c): the slab handoff, drain / reclaim / reopen, a
    deadline, weight swaps, warmup, health and load."""
    import threading

    import numpy as np

    layers = LLAMA3_8B["layers"]
    first, _ = _p12_tier_traffic(np)
    # ---- the slab handoff: A prefills into its cache, B imports the slab
    prompt = first[1]
    a = ff.make_serving_engine(**ENGINE)
    b = ff.make_serving_engine(**ENGINE)
    kernels.reset_launch_counts()
    n = a.prefill_into_cache(prompt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slab = a.export_prefix_slab(prompt)
    t_exp = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = b.import_prefix_slab(slab)
    torch.cuda.synchronize()
    t_imp = time.perf_counter() - t0
    launches = kernels.launch_counts()
    want = {"flash_attention_fwd": layers, "paged_prefill_write": 1,
            "paged_attention_fwd": 0, "flash_attention_bwd": 0,
            "fused_add_layernorm_fwd": 0, "fused_update": 0}
    if got != n or launches != want:
        fail(f"phase 12 (slab): {n} pages prefilled, {got} imported; "
             f"launches {launches} != {want}")
    ra = _p12_round(torch, kernels, a, [prompt], "slab, exporter")
    rb = _p12_round(torch, kernels, b, [prompt], "slab, importer")
    nbytes = sum(x.nbytes for p in slab["payload"] for sub in p.values()
                 for x in sub.values())
    say(f"phase 12 (slab): {n} pages ({nbytes / 2**20:.0f} MiB) exported "
        f"in {t_exp * 1e3:.0f} ms, imported in {t_imp * 1e3:.0f} ms; both "
        f"engines serve the {prompt.size}-token prompt as a hit of "
        f"{rb['prefix'][0]} tokens [{card}]")
    if ra["prefix"] != rb["prefix"] or rb["prefix"][0] != n * 128:
        fail(f"phase 12 (slab): prefix tokens {ra['prefix']} / "
             f"{rb['prefix']}, want {n * 128}")
    same("slab: the importer vs the exporter", rb["tokens"], ra["tokens"])
    again = b.export_prefix_slab(prompt)
    if any(pa[k][m].tobytes() != pb[k][m].tobytes()
           for pa, pb in zip(slab["payload"], again["payload"])
           for k in pa for m in pa[k]):
        fail("phase 12 (slab): the importer's re-export is not the slab")
    say("phase 12 (slab): the importer's re-export is the slab, bitwise")
    del a, b, slab, again

    # ---- drain with 4 live and 4 queued, reclaim, reopen
    eng = ff.make_serving_engine(**P11_ENGINE)
    eight = list(prompts) + list(prompts[:2])
    want_tok = list(ref) + list(ref[:2])
    reqs = [eng.submit(p, MAX_NEW) for p in eight]
    seen = []
    stop = threading.Event()

    def probe():
        while not stop.is_set():
            seen.append((eng.health()["status"], eng.load()))
            time.sleep(0.005)

    th = threading.Thread(target=probe)
    th.start()
    eng.step()
    snap = eng.drain()
    stop.set()
    th.join()
    back = eng.reclaim_queued()
    if snap["queued"] != 4 or len(back) != 4 \
            or [r.state for r in reqs[:4]] != ["done"] * 4:
        fail(f"phase 12 (drain): queued {snap['queued']}, reclaimed "
             f"{len(back)}, live states {[r.state for r in reqs[:4]]}")
    eng.reopen()
    r = _p12_round(torch, kernels, eng, [q.prompt for q in back],
                   "drain, reopened")
    same("drain: the live requests vs phase 6",
         [q.tokens for q in reqs[:4]], want_tok[:4])
    same("drain: the reclaimed requests, reopened, vs phase 6",
         r["tokens"], want_tok[4:])
    statuses = sorted({s for s, _ in seen})
    say(f"phase 12 (drain): 4 live finished, 4 reclaimed and served after "
        f"reopen; health() from another thread during the drain saw "
        f"{statuses} in {len(seen)} probes")
    h, ld = eng.health(), eng.load()
    if list(h) != P12_HEALTH_KEYS or list(ld) != P12_LOAD_KEYS:
        fail(f"phase 12: health() keys {list(h)} / load() keys {list(ld)} "
             f"are not JAX's")
    say("phase 12: health() and load() keys are JAX's")

    # ---- a deadline already passed: timeout, no launch
    kernels.reset_launch_counts()
    late = eng.submit(prompts[0], MAX_NEW,
                      deadline=time.perf_counter() - 1.0)
    while eng.step():
        pass
    torch.cuda.synchronize()
    launched = sum(kernels.launch_counts().values())
    if late.state != "timeout" or launched \
            or eng.stats()["timeouts"] != 1:
        fail(f"phase 12 (deadline): state {late.state}, launches "
             f"{launched}, timeouts {eng.stats()['timeouts']}")
    say("phase 12 (deadline): a request past its deadline retired "
        "'timeout' with no kernel launched")
    del eng

    # ---- weight swaps under captured decode. The second weight set is a
    # second model of the same graph from its own seed; the witness of a
    # swap to it is an engine on that model, which reads those tensors
    # directly (not the swapped engine's model.params).
    gc.collect()
    torch.cuda.empty_cache()
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import llama_lm

    ff2 = build_llama(FFConfig, FFModel, llama_lm, ff.device,
                      ff.config.compute_dtype, 12, **LLAMA3_8B)
    new = ff2.params
    eng_n = ff.make_serving_engine(**P11_ENGINE)
    n1 = _p12_round(torch, kernels, eng_n, prompts, "swap, native before")
    same("swap: native engine before the swap vs phase 6", n1["tokens"],
         ref)
    eng_n.submit(prompts[0], MAX_NEW)
    eng_n.step()
    try:
        eng_n.swap_weights(new, "v-live")
        fail("phase 12 (swap): swap_weights under a live slot did not raise")
    except RuntimeError:
        pass
    eng_n.run()
    say("phase 12 (swap): swap_weights with a live slot raised")
    # a native swap writes ff.params: refused while another engine reads
    # them, and that engine keeps its tokens
    other = ff.make_serving_engine(**P11_ENGINE)
    try:
        eng_n.swap_weights(new, "v1")
        fail("phase 12 (swap): a native swap with a second engine on the "
             "model did not raise")
    except RuntimeError as e:
        if "other engine" not in str(e):
            raise
    o1 = _p12_round(torch, kernels, other, prompts, "swap, other engine")
    same("swap refused: the model's other engine vs phase 6", o1["tokens"],
         ref)
    del other
    caps_n = eng_n.stats()["recompiles"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng_n.swap_weights(new, "v1")
    torch.cuda.synchronize()
    t_swap = time.perf_counter() - t0
    n2 = _p12_round(torch, kernels, eng_n, prompts, "swap, native after")
    fresh = ff2.make_serving_engine(**P11_ENGINE)
    f2 = _p12_round(torch, kernels, fresh, prompts, "swap, fresh native")
    del fresh
    same("swap: native engine after the swap vs an engine on the second "
         "model", n2["tokens"], f2["tokens"])
    if n2["tokens"] == n1["tokens"]:
        fail("phase 12 (swap): the second weight set served the first "
             "set's tokens")
    t0 = time.perf_counter()
    eng_n.swap_weights(None, "v0")
    torch.cuda.synchronize()
    t_back = time.perf_counter() - t0
    n3 = _p12_round(torch, kernels, eng_n, prompts, "swap, native back")
    same("swap back: native vs phase 6", n3["tokens"], ref)
    added_n = eng_n.stats()["recompiles"] - caps_n
    out["swap"] = n2["launches"]
    del eng_n
    gc.collect()
    torch.cuda.empty_cache()
    eng_q = ff.make_serving_engine(**P11_ENGINE, weight_dtype="int8")
    q1 = _p12_round(torch, kernels, eng_q, prompts, "swap, int8 before")
    caps_q = eng_q.stats()["recompiles"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng_q.swap_weights(new, "v1")
    torch.cuda.synchronize()
    t_swap_q = time.perf_counter() - t0
    q2 = _p12_round(torch, kernels, eng_q, prompts, "swap, int8 after")
    fresh = ff2.make_serving_engine(**P11_ENGINE, weight_dtype="int8")
    fq2 = _p12_round(torch, kernels, fresh, prompts, "swap, fresh int8")
    del fresh
    same("swap: int8-weight engine after the swap vs an int8 engine on the "
         "second model", q2["tokens"], fq2["tokens"])
    eng_q.swap_weights(None, "v0")
    q3 = _p12_round(torch, kernels, eng_q, prompts, "swap, int8 back")
    same("swap back: int8 weights vs before the swap", q3["tokens"],
         q1["tokens"])
    added = (added_n, eng_q.stats()["recompiles"] - caps_q)
    say(f"phase 12 (swap): native swap {t_swap:.2f} s and back "
        f"{t_back:.2f} s (the construction weights kept in host memory), "
        f"int8 re-quantization in place {t_swap_q:.2f} s; captures added "
        f"across the swaps {added}; a second engine on the model refused "
        f"the native swap and kept its tokens [{card}]")
    if added != (0, 0):
        fail(f"phase 12 (swap): captures added across the swaps {added}")
    del eng_q, new, ff2
    gc.collect()
    torch.cuda.empty_cache()

    # ---- warmup, then the same prompts build nothing
    eng = ff.make_serving_engine(**ENGINE)
    t0 = time.perf_counter()
    w = eng.warmup(prompts, max_new_tokens=MAX_NEW)
    t_w = time.perf_counter() - t0
    caps = eng.stats()["recompiles"]
    _p12_round(torch, kernels, eng, prompts, "after warmup")
    st = eng.stats()
    say(f"phase 12 (warmup): {w['requests']} requests, {w['programs']} "
        f"captures ({w['variants']}) in {t_w:.1f} s; serving the same "
        f"prompts after it captured {st['recompiles'] - caps}, retraces "
        f"{st['sanitizer_retraces']}")
    if w["requests"] != 2 * len(prompts) or w["programs"] != 1 \
            or st["recompiles"] != caps or st["sanitizer_retraces"]:
        fail(f"phase 12 (warmup): {w}, captures after it "
             f"{st['recompiles'] - caps}")
    del eng


def phase_serving_rest(torch, kernels, ff, ref, prompts, step_ms_p11: float,
                       card: str):
    """Phase 12: phase 6's Llama-3-8B through the rest of the serving
    engine — (a) LoRA tenants, (b) the prefix cache's host tier, (c) the
    lifecycle API. ``ref``: phase 6's tokens; ``step_ms_p11``: phase 11's
    captured decode step. Returns {path: launch counts}."""
    problems = []

    def same(tag, got, want):
        diff = _p11_diff(got, want)
        say(f"phase 12 ({tag}): tokens identical: {not diff}"
            + (f" (differ: {diff})" if diff else ""))
        if diff:
            problems.append(f"{tag}: {diff}")

    out = {}
    t0 = time.perf_counter()
    _p12_lora(torch, kernels, ff, ref, prompts, step_ms_p11, card, same,
              out)
    t1 = time.perf_counter()
    _p12_tier(torch, kernels, ff, card, same, out)
    t2 = time.perf_counter()
    _p12_lifecycle(torch, kernels, ff, ref, prompts, card, same, out)
    say(f"phase 12: LoRA {t1 - t0:.1f} s, host tier {t2 - t1:.1f} s, "
        f"lifecycle {time.perf_counter() - t2:.1f} s")
    if problems:
        fail("phase 12: " + " | ".join(problems))
    return out


# ---- phase 13: generation ---------------------------------------------------

#: phase 13 (a): sampled generate's settings, the beam width and the
#: least positionwise agreement of generate's greedy tokens with the
#: serving engine's for the same prompts (the same model; the engine's
#: decode attention is kernel 4 over the paged pool, generate's the grouped
#: einsum over the static cache, and prefill batches differ, so bf16 rounds
#: otherwise and a near tie may part a stream)
P13_SAMPLED = dict(temperature=0.8, top_k=50)
P13_BEAMS = 4
P13_AGREE = 0.9
#: (b): full width at 2 layers in f32, card vs CPU
P13_EXACT = dict(LLAMA3_8B, layers=2)
P13_EXACT_LENS = PROMPT_LENS[:4]
P13_EXACT_NEW = 16
#: (c): Transformer-base (Vaswani et al. 2017, Table 3 "base": d_model 512,
#: 6 + 6 layers, 8 heads, d_ff 2048, a 37000-token shared vocabulary)
#: through seq2seq_lm
T_BASE = dict(hidden=512, layers=6, heads=8, ffn_mult=4, vocab_size=37000)
T_BASE_RUN = dict(batch=32, src=128, new=64)


def _p13_right_pad(np, prompts, width=None):
    """Right-padded (B, width) int32 prompts and their (B,) lengths."""
    lens = np.asarray([len(p) for p in prompts], np.int32)
    toks = np.zeros((len(prompts), width or int(lens.max())), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return toks, lens


def _p13_timed(torch, fn):
    """(fn(), wall seconds) with the card synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _p13_want(kernels, flash: int):
    want = dict.fromkeys(kernels.launch_counts(), 0)
    want["flash_attention_fwd"] = flash
    return want


def _p13_full_width(torch, kernels, ff, ref, prompts, card: str):
    """Phase 13 (a): FFModel.generate on phase 6's Llama-3-8B (bf16, 32
    layers, seeded random weights), after phase 12's swaps (the model's
    construction weights back; no engine holds it)."""
    import numpy as np

    from flexflow_tpu_torch.runtime.generation import Generator

    layers = LLAMA3_8B["layers"]
    toks, lens = _p13_right_pad(np, prompts)
    n_new = len(prompts) * MAX_NEW
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out, wall = _p13_timed(torch, lambda: ff.generate(
        toks, MAX_NEW, prompt_lengths=lens))
    launches = kernels.launch_counts()
    say(f"phase 13 (a): generate's kernel launches {launches} (kernel 1: "
        f"one a layer for the whole-prompt prefill of all 6 rows)")
    if launches != _p13_want(kernels, layers):
        fail(f"phase 13 (a): kernel launches {launches} != "
             f"{_p13_want(kernels, layers)}")
    if out.shape != (len(prompts), toks.shape[1] + MAX_NEW):
        fail(f"phase 13 (a): output shape {out.shape}")
    (gen,) = ff._decoders.values()
    (loop,) = gen._programs.values()
    if loop.step.graph is None or loop.step.replays != MAX_NEW - 2:
        fail(f"phase 13 (a): the decode step was not a graph replayed "
             f"{MAX_NEW - 2} times (graph {loop.step.graph}, replays "
             f"{loop.step.replays})")
    new = [list(r) for r in out[:, toks.shape[1]:]]
    again, wall2 = _p13_timed(torch, lambda: ff.generate(
        toks, MAX_NEW, prompt_lengths=lens))
    if not np.array_equal(again, out):
        fail("phase 13 (a): a second generate gave other tokens")
    agree = float(np.mean([a == b for g, r in zip(new, ref)
                           for a, b in zip(g, r)]))
    first = [g[0] == r[0] for g, r in zip(new, ref)]
    say(f"phase 13 (a): greedy tokens vs the serving engine's (phase 6): "
        f"positionwise agreement {agree:.4f} (least {P13_AGREE}), first "
        f"tokens {sum(first)}/{len(first)} equal {first}; parting: "
        f"{_p11_diff(new, ref) or 'none'}")
    if agree < P13_AGREE:
        fail(f"phase 13 (a): agreement {agree:.4f} with the serving "
             f"engine's tokens < {P13_AGREE}")

    step_graph = gen.last_decode_ms / gen.last_decode_steps
    # prefill alone (max_new_tokens 1: no decode step); the decode step
    # uncaptured, from the eager Generator's second call (its first
    # allocates its caches). Both step times are the CUDA-event time of a
    # warm call's decode loop over its steps.
    _p13_timed(torch, lambda: ff.generate(toks, 1, prompt_lengths=lens))
    _, t_pre = _p13_timed(torch, lambda: ff.generate(
        toks, 1, prompt_lengths=lens))
    eager = Generator(ff, capture=False)
    eager(toks, MAX_NEW, prompt_lengths=lens)
    e_out = eager(toks, MAX_NEW, prompt_lengths=lens)
    step_eager = eager.last_decode_ms / eager.last_decode_steps
    say(f"phase 13 (a): prefill (6 rows right-padded to {toks.shape[1]}, "
        f"first token) {t_pre * 1e3:.2f} ms; decode step {step_graph:.2f} "
        f"ms as a CUDA graph, {step_eager:.2f} ms uncaptured (the eager "
        f"Generator's second call; tokens identical: "
        f"{np.array_equal(e_out, out)}); {n_new} tokens in {wall2:.3f} s = "
        f"{n_new / wall2:.2f} tokens/s (first call, capture included: "
        f"{wall:.3f} s) [{card}]")
    if not np.array_equal(e_out, out):
        fail(f"phase 13 (a): the uncaptured decode gave other tokens: "
             f"{_p11_diff([list(r) for r in e_out], [list(r) for r in out])}")
    del eager

    _p13_profile(torch, ff, toks, lens, card)

    # early exit: two rows of one prompt, eos the first token of their
    # stream that appears late (a random-weight stream may repeat one
    # token from the start, which would exit before any step)
    for r in range(len(prompts)):
        two = np.stack([toks[r, :lens[r]]] * 2)
        stream = list(ff.generate(two, MAX_NEW)[0, lens[r]:])
        late = [j for j in range(MAX_NEW // 4, MAX_NEW)
                if stream[j] not in stream[:j]]
        if late:
            break
    else:
        fail("phase 13 (a): no prompt's stream has a token new after its "
             f"{MAX_NEW // 4}th to stop at")
    j = late[0]
    eos = int(stream[j])
    kw = dict(eos_token_id=eos)
    full = ff.generate(two, MAX_NEW, **kw)
    steps_full = ff._decoders[(0.0, 0, eos, 0, None)].last_decode_steps
    early = ff.generate(two, MAX_NEW, early_exit=True, **kw)
    steps_early = ff._decoders[(0.0, 0, eos, 0, None)].last_decode_steps
    say(f"phase 13 (a): early_exit at eos {eos} (prompt {r}'s token {j}, "
        f"two rows of it): tokens identical to the full loop: "
        f"{np.array_equal(early, full)}, {steps_early} decode steps "
        f"against {steps_full}")
    if not np.array_equal(early, full) or not steps_early < steps_full:
        fail(f"phase 13 (a): early_exit gave other tokens or no fewer "
             f"steps ({steps_early} vs {steps_full})")

    scored, scores = ff.generate(toks, MAX_NEW, prompt_lengths=lens,
                                 return_scores=True)
    if not np.array_equal(scored, out) or scores.shape != (6, MAX_NEW) \
            or not np.isfinite(scores).all() or (scores > 0).any():
        fail(f"phase 13 (a): return_scores: tokens equal "
             f"{np.array_equal(scored, out)}, scores {scores.shape}, finite "
             f"{np.isfinite(scores).all()}, max {scores.max()}")
    say(f"phase 13 (a): return_scores: tokens identical, mean logprob "
        f"{scores.mean():.4f}")

    s1 = ff.generate(toks, MAX_NEW, prompt_lengths=lens, seed=11,
                     **P13_SAMPLED)
    s2 = ff.generate(toks, MAX_NEW, prompt_lengths=lens, seed=11,
                     **P13_SAMPLED)
    s3 = ff.generate(toks, MAX_NEW, prompt_lengths=lens, seed=12,
                     **P13_SAMPLED)
    say(f"phase 13 (a): sampled {P13_SAMPLED}: seed 11 twice identical: "
        f"{np.array_equal(s1, s2)}; seed 12 differs: "
        f"{not np.array_equal(s1, s3)}")
    if not np.array_equal(s1, s2):
        fail("phase 13 (a): the same seed gave other sampled tokens")

    btoks, blens = _p13_right_pad(np, prompts[:2])
    (bout, bscore), t_beam = _p13_timed(torch, lambda: ff.generate(
        btoks, MAX_NEW, num_beams=P13_BEAMS, prompt_lengths=blens,
        return_scores=True))
    if bout.shape != (2, btoks.shape[1] + MAX_NEW) \
            or not np.isfinite(bscore).all():
        fail(f"phase 13 (a): beam search {bout.shape}, scores {bscore}")
    say(f"phase 13 (a): {P13_BEAMS} beams on 2 prompts: best scores "
        f"{bscore.tolist()} in {t_beam:.3f} s (capture included) [{card}]")

    (qout, t_q) = _p13_timed(torch, lambda: ff.generate(
        toks, MAX_NEW, prompt_lengths=lens, quantize="int8"))
    q_agree = float(np.mean(qout[:, toks.shape[1]:] == out[:, toks.shape[1]:]))
    if qout.shape != out.shape or ((qout < 0) | (qout >= LLAMA3_8B[
            "vocab_size"])).any():
        fail(f"phase 13 (a): int8 weights: output {qout.shape}")
    say(f"phase 13 (a): quantize='int8' greedy: agreement with bf16 "
        f"{q_agree:.4f}, {t_q:.3f} s (weights quantized and the step "
        f"captured in the call) [{card}]")
    say(f"phase 13 (a): peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    ff._decoders.clear()
    return launches


def _p13_profile(torch, ff, toks, lens, card: str):
    """One generate call (the program warm: prefill, first token, 31
    replays) under torch.profiler: device busy, idle share, device time by
    kernel class and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = _p13_timed(torch, lambda: ff.generate(
            toks, MAX_NEW, prompt_lengths=lens))
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = busy_ms(events)
    by_class, by_name = {}, {}
    for e in events:
        us = e.time_range.end - e.time_range.start
        by_class[kernel_class(e.name)] = by_class.get(kernel_class(e.name),
                                                      0) + us
        by_name[e.name] = by_name.get(e.name, 0) + us
    say(f"phase 13 (a) profile: one generate call, {len(events)} device "
        f"events, device busy {busy:.1f} ms of {wall * 1e3:.1f} ms under the "
        f"profiler: idle share {max(1 - busy / (wall * 1e3), 0):.3f} [{card}]")
    total = sum(by_class.values()) or 1
    for k, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        say(f"phase 13 (a) profile: {k}: {us / 1e3:.2f} ms "
            f"({100 * us / total:.1f}%)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        calls = sum(e.name == name for e in events)
        say(f"phase 13 (a) profile kernel: {us / 1e3:.3f} ms, {calls} "
            f"launches: {name[:120]}")
    del prof


def _p13_parting(torch, gen_cpu, toks, got, want, s0):
    """Each row where the card's tokens part from the CPU's: the step and
    the CPU model's top-2 logit margin there."""
    out = []
    for r in range(got.shape[0]):
        diff = [j for j in range(s0, got.shape[1]) if got[r, j] != want[r, j]]
        if not diff:
            continue
        j = diff[0]
        seq = torch.as_tensor(want[r:r + 1, :j]).long()
        c = {op.name: op.init_cache(1, j, torch.float32, gen_cpu.model.device)
             for op in gen_cpu.attn_ops}
        with torch.inference_mode():
            lg, _ = gen_cpu._prefill(gen_cpu.model.params, seq, c, None)
        top = torch.topk(lg[0, -1].float(), 2).values
        out.append(f"row {r} at step {j - s0}: top-2 margin "
                   f"{(top[0] - top[1]).item():.3g}")
    return "; ".join(out)


def _p13_exact(torch, FFConfig, FFModel, llama_lm, kernels, prompts, card):
    """Phase 13 (b): 2 layers at Llama-3-8B widths in f32 (TF32 off), the
    same weights on the card and the CPU: greedy and beam tokens
    identical."""
    import numpy as np

    from flexflow_tpu_torch.runtime.generation import Generator

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cpu = build_llama(FFConfig, FFModel, llama_lm, "cpu", "float32", 3,
                      **P13_EXACT)
    gpu = build_llama(FFConfig, FFModel, llama_lm, "cuda", "float32", 3,
                      **P13_EXACT)
    gpu.params = {op: {w: t.to("cuda") for w, t in ws.items()}
                  for op, ws in cpu.params.items()}
    toks, lens = _p13_right_pad(np, [p for p in prompts
                                     if len(p) in P13_EXACT_LENS])
    btoks, blens = toks[:2, :int(lens[:2].max())], lens[:2]
    t_build = time.perf_counter() - t0
    problems = []
    for tag, call in (
            ("greedy", lambda ff: ff.generate(toks, P13_EXACT_NEW,
                                              prompt_lengths=lens)),
            (f"{P13_BEAMS} beams", lambda ff: ff.generate(
                btoks, P13_EXACT_NEW, num_beams=P13_BEAMS,
                prompt_lengths=blens))):
        t1 = time.perf_counter()
        want = call(cpu)
        t_cpu = time.perf_counter() - t1
        got, t_gpu = _p13_timed(torch, lambda: call(gpu))
        same = np.array_equal(got, want)
        parting = "" if same else _p13_parting(
            torch, Generator(cpu), toks if tag == "greedy" else btoks, got,
            want, (toks if tag == "greedy" else btoks).shape[1])
        say(f"phase 13 (b): {tag}, 2 layers at Llama-3-8B widths, f32: card "
            f"tokens identical to the CPU's: {same}"
            + (f" (parting: {parting})" if parting else "")
            + f"; card {t_gpu:.3f} s, CPU {t_cpu:.1f} s [{card}]")
        if not same:
            problems.append(f"{tag}: {parting}")
    torch.backends.cuda.matmul.allow_tf32 = saved
    say(f"phase 13 (b): models built in {t_build:.1f} s")
    del cpu, gpu
    if problems:
        fail("phase 13 (b): card vs CPU: " + " | ".join(problems))


def _p13_seq2seq(torch, FFConfig, FFModel, kernels, card: str):
    """Phase 13 (c): seq2seq_lm at Transformer-base widths through
    generate_seq2seq: bf16 on the card (kernel 1 in the encoder and the
    decoder prefill; tokens/s), and in f32 the card's greedy tokens the
    CPU's."""
    import numpy as np

    from flexflow_tpu_torch.models import seq2seq_lm

    r = T_BASE_RUN
    layers = T_BASE["layers"]

    def build(dev, dtype):
        ff = FFModel(FFConfig(batch_size=r["batch"], compute_dtype=dtype,
                              seed=5), device=dev)
        seq2seq_lm(ff, r["batch"], src_len=r["src"], tgt_len=r["new"],
                   **T_BASE)
        ff.compile()
        return ff

    src = np.random.RandomState(4).randint(
        1, T_BASE["vocab_size"], (r["batch"], r["src"])).astype(np.int32)
    ff = build("cuda", "bfloat16")
    n_params = sum(t.numel() for ws in ff.params.values()
                   for t in ws.values())
    kernels.reset_launch_counts()
    out, wall = _p13_timed(torch, lambda: ff.generate_seq2seq(
        src, max_new_tokens=r["new"]))
    launches = kernels.launch_counts()
    if launches != _p13_want(kernels, 2 * layers):
        fail(f"phase 13 (c): kernel launches {launches} != "
             f"{_p13_want(kernels, 2 * layers)} (kernel 1 once an encoder "
             f"layer and once a decoder prefill layer)")
    again, wall2 = _p13_timed(torch, lambda: ff.generate_seq2seq(
        src, max_new_tokens=r["new"]))
    if not np.array_equal(again, out) or out.shape != (r["batch"],
                                                       1 + r["new"]):
        fail(f"phase 13 (c): output {out.shape}, second call identical "
             f"{np.array_equal(again, out)}")
    n = r["batch"] * r["new"]
    say(f"phase 13 (c): Transformer-base seq2seq_lm ({n_params / 1e6:.1f} M "
        f"params, bf16), batch {r['batch']}, source {r['src']}, BOS prompt, "
        f"{r['new']} new tokens: kernel launches {launches}; {n} tokens in "
        f"{wall2:.3f} s = {n / wall2:.1f} tokens/s (first call, capture "
        f"included: {wall:.3f} s) [{card}]")
    del ff
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, gpu = build("cpu", "float32"), build("cuda", "float32")
    gpu.params = {op: {w: t.to("cuda") for w, t in ws.items()}
                  for op, ws in cpu.params.items()}
    want = cpu.generate_seq2seq(src, max_new_tokens=r["new"])
    got = gpu.generate_seq2seq(src, max_new_tokens=r["new"])
    torch.backends.cuda.matmul.allow_tf32 = saved
    same = np.array_equal(got, want)
    say(f"phase 13 (c): f32, card tokens identical to the CPU's: {same}"
        + ("" if same else " (differ: " + _p11_diff(
            [list(x) for x in got], [list(x) for x in want]) + ")"))
    if not same:
        fail("phase 13 (c): f32 seq2seq tokens differ card vs CPU")
    return launches


def phase_generate(torch, FFConfig, FFModel, llama_lm, kernels, ff, ref,
                   prompts, card: str):
    """Phase 13: generation — (a) FFModel.generate at Llama-3-8B widths on
    phase 6's model, (b) exactness at full width and 2 layers, (c)
    generate_seq2seq at Transformer-base widths. Returns {path: launch
    counts}."""
    t0 = time.perf_counter()
    out = {"generate": _p13_full_width(torch, kernels, ff, ref, prompts,
                                       card)}
    t1 = time.perf_counter()
    _p13_exact(torch, FFConfig, FFModel, llama_lm, kernels, prompts, card)
    t2 = time.perf_counter()
    out["seq2seq"] = _p13_seq2seq(torch, FFConfig, FFModel, kernels, card)
    say(f"phase 13: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{time.perf_counter() - t2:.1f} s")
    return out


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
    # phase 11's shapes: the verify slab, and the draft's decode step,
    # prefill and 16-layer prefill write (the speculative greedy serve
    # launches each: its launches count the target's and the draft's)
    "paged_attention_fwd_verify": ("paged_attention.cu", 689, "spec_greedy",
                                   "paged_attention_fwd"),
    "paged_attention_fwd_draft": ("paged_attention.cu", 689, "spec_greedy",
                                  "paged_attention_fwd"),
    "flash_attention_fwd_draft": ("flash_attention_wgmma.cu", 180,
                                  "spec_greedy", "flash_attention_fwd"),
    f"paged_prefill_write_layers{LLAMA32_1B['layers']}_draft": (
        "paged_prefill_write.cu", 779, "spec_greedy", "paged_prefill_write"),
    # phase 13's shapes: generate's prefill, and the seq2seq encoder and
    # decoder prefill. Both seq2seq rows report the path's launches of the
    # kernel at both shapes, one an encoder layer and one a decoder layer
    "flash_attention_fwd_generate": ("flash_attention_wgmma.cu", 180,
                                     "generate", "flash_attention_fwd"),
    "flash_attention_fwd_seq2seq": ("flash_attention_wgmma.cu", 180,
                                    "seq2seq", "flash_attention_fwd"),
    "flash_attention_fwd_seq2seq_dec": ("flash_attention_wgmma.cu", 180,
                                        "seq2seq", "flash_attention_fwd"),
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
    launches["serve"], ff, outs = phase_serve(torch, FFConfig, FFModel,
                                              llama_lm, kernels, card)
    launches.update(phase_serve_quantized(torch, ff, kernels, card))
    ref = [list(o[n:]) for o, n in zip(outs, PROMPT_LENS)]
    prompts = [o[:n] for o, n in zip(outs, PROMPT_LENS)]
    p11, step_ms_p11 = phase_decode_features(
        torch, FFConfig, FFModel, llama_lm, kernels, ff, ref, prompts, card)
    launches.update(p11)
    launches.update(phase_serving_rest(torch, kernels, ff, ref, prompts,
                                       step_ms_p11, card))
    launches.update(phase_generate(torch, FFConfig, FFModel, llama_lm,
                                   kernels, ff, ref, prompts, card))
    del ff, outs
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
