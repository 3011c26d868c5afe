#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure (non-zero exit, no result line):

  1. card     — print the card's name and power limit (nvidia-smi).
  2. build    — compile the three CUDA kernels from flexflow_tpu_torch/csrc
                with nvcc (sm_90a) and print the build time.
  3. kernels  — hold each kernel against its plain PyTorch version on the
                card, in bf16, at the shapes the Llama-3-8B serving path
                gives it (max abs error: flash <= 2e-2, paged decode
                <= 5e-3; prefill write bitwise);
                time kernel, plain version and, for flash attention, torch's
                scaled_dot_product_attention as a yardstick (the port never
                calls it), each with CUDA events around single launches
                after an L2 flush.
  4. check    — a small Llama (2 layers, head dim 128) served in f32 on the
                card through the kernels gives the same greedy tokens as the
                same weights served on the CPU through the plain versions.
  5. serve    — Llama-3-8B widths (hidden 4096, 32 heads over 8 kv heads,
                ffn 14336, vocab 128256, rope_theta 500000, 32 layers, bf16,
                seeded random weights) serve 6 prompts (13..700 tokens, 32
                new tokens each) through FFModel.serve with 4 slots and
                128-token pages; every request must finish with finite
                logits, each kernel's launch count must be its expected
                count (layers x prefills, layers x decode steps), and a
                second serve must return the same tokens.

The last two lines of standard output are a JSON object describing each
kernel and the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12       # H100 SXM data sheet, dense
# max abs error against the plain version: flash outputs are about 1 in
# size (bf16 rounding ~4e-3); paged decode outputs average ~600 unit
# values and are about 0.07 (bf16 rounding ~5e-4), so its limit is tighter
FLASH_TOL = 2e-2
PAGED_TOL = 5e-3

LLAMA3_8B = dict(hidden=4096, layers=32, heads=32, kv_heads=8,
                 ffn_hidden=14336, vocab_size=128256, rope_theta=500000.0)
PROMPT_LENS = (13, 37, 90, 200, 512, 700)
MAX_NEW = 32
# pow2 buckets, but 768 for the 700-token prompt: its pow2 bucket (1024)
# plus 32 new tokens would not fit max_seq_len 1024
BUCKETS = [16, 32, 64, 128, 256, 512, 768]
ENGINE = dict(serve_slots=4, max_seq_len=1024, kv_page_size=128,
              prefix_cache=False, decode_buckets=BUCKETS)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


# ------------------------------------------------------------- timing


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median time of one call of ``fn`` on the card, CUDA events around
    each call, the 50 MB L2 flushed before each (the serving path meets
    its inputs cold)."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
            if "registers" in ln or "spill" in ln or ln.startswith("=="):
                say("  ptxas " + ln.strip())


def phase_kernels(torch, kernels):
    """Kernel vs plain version at the serving shapes (bf16)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    h, kvh, d = LLAMA3_8B["heads"], LLAMA3_8B["kv_heads"], 128
    scale = d ** -0.5
    rows = {}

    # flash attention: the prefill of a 512-token bucket
    s = 512
    q = torch.randn(1, s, h, d, device=dev, generator=g).to(bf16)
    k = torch.randn(1, s, kvh, d, device=dev, generator=g).to(bf16)
    v = torch.randn(1, s, kvh, d, device=dev, generator=g).to(bf16)
    out = kernels.flash_attention_fwd(q, k, v, True, scale)
    ref = kernels.flash_attention_plain(q, k, v, True, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= FLASH_TOL:
        fail(f"flash_attention_fwd disagrees with its plain version: "
             f"max abs err {err}")
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
    rows["flash_attention_fwd"] = dict(
        err=err,
        ms=cuda_ms(lambda: kernels.flash_attention_fwd(q, k, v, True, scale)),
        plain_ms=cuda_ms(
            lambda: kernels.flash_attention_plain(q, k, v, True, scale)),
        library_ms=cuda_ms(lib),
        bound=bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                    4 * pairs * h * d),
        shape=f"q (1,{s},{h},{d}) k/v (1,{s},{kvh},{d}) causal bf16")

    # paged attention: one decode step of 4 slots at ~600 live positions
    ps, pps, n_pool, b = 128, 8, 33, 4
    qd = torch.randn(b, 1, h, d, device=dev, generator=g).to(bf16)
    kp = torch.randn(n_pool, ps, kvh, d, device=dev, generator=g).to(bf16)
    vp = torch.randn(n_pool, ps, kvh, d, device=dev, generator=g).to(bf16)
    table = (torch.randperm(n_pool - 1, device=dev, generator=g) + 1)
    table = table[:b * pps].reshape(b, pps).to(torch.int32).contiguous()
    row_len = torch.tensor([500, 620, 530, 690], dtype=torch.int32,
                           device=dev)
    pad = torch.tensor([512, 640, 544, 704], dtype=torch.int32, device=dev)
    wp = torch.tensor([[600], [660], [560], [720]], dtype=torch.int32,
                      device=dev)
    args = (qd, kp, vp, table, wp, row_len, pad)
    out = kernels.paged_attention_fwd(*args, scale)
    ref = kernels.paged_attention_plain(*args, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= PAGED_TOL:
        fail(f"paged_attention_fwd disagrees with its plain version: "
             f"max abs err {err}")
    # live keys per slot: the prompt, then the decoded positions from the
    # bucket's end to the write frontier (the padding between is dead)
    live = int((row_len + (wp[:, 0] - pad + 1).clamp(min=0)).sum())
    rows["paged_attention_fwd"] = dict(
        err=err,
        ms=cuda_ms(lambda: kernels.paged_attention_fwd(*args, scale)),
        plain_ms=cuda_ms(lambda: kernels.paged_attention_plain(*args, scale)),
        library_ms=None,
        bound=bound(2 * (2 * qd.numel() + 2 * live * kvh * d)
                    + 4 * (table.numel() + wp.numel() + 2 * b),
                    4 * live * h * d),
        shape=f"q ({b},1,{h},{d}) pool ({n_pool},{ps},{kvh},{d}) "
              f"{live} live positions bf16")

    # paged prefill write: the 512-token slab into 4 pages
    n_pages = s // ps
    kh = torch.randn(1, s, kvh, d, device=dev, generator=g).to(bf16)
    vh = torch.randn(1, s, kvh, d, device=dev, generator=g).to(bf16)
    pages = table[0, :n_pages].contiguous()
    pk, pv = kp.clone(), vp.clone()
    rk, rv = kp.clone(), vp.clone()
    kernels.paged_prefill_write(pk, pv, kh, vh, pages)
    kernels.paged_prefill_write_plain(rk, rv, kh, vh, pages)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                  for a, b in ((pk, rk), (pv, rv)))
    if not bitwise:
        fail("paged_prefill_write is not bitwise its plain version")
    rows["paged_prefill_write"] = dict(
        err=0.0,
        ms=cuda_ms(lambda: kernels.paged_prefill_write(pk, pv, kh, vh,
                                                       pages)),
        plain_ms=cuda_ms(lambda: kernels.paged_prefill_write_plain(
            rk, rv, kh, vh, pages)),
        library_ms=None,
        bound=bound(2 * (kh.numel() + vh.numel())
                    + 2 * 2 * n_pages * ps * kvh * d + 4 * n_pages, 0.0),
        shape=f"slab (1,{s},{kvh},{d}) into {n_pages} pages of {ps} bf16")

    for name, r in rows.items():
        say(f"kernel {name}: {r['shape']}: max abs err {r['err']:.3g}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms by {r['bound'][1]}"
            + (f", sdpa {r['library_ms']:.4f} ms" if r["library_ms"] else "")
            + ")")
    return rows


def build_llama(FFConfig, FFModel, llama_lm, device, dtype: str, seed: int,
                **arch):
    ff = FFModel(FFConfig(batch_size=ENGINE["serve_slots"],
                          compute_dtype=dtype, seed=seed), device=device)
    _, logits = llama_lm(ff, ENGINE["serve_slots"],
                         seq_len=ENGINE["max_seq_len"], **arch)
    ff.compile(final_tensor=logits)
    return ff


def phase_check(torch, FFConfig, FFModel, llama_lm):
    """Small f32 model: card (kernels) vs CPU (plain versions)."""
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

    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, arch["vocab_size"], size=n).astype(np.int32)
               for n in (5, 30, 77, 130)]
    kw = dict(ENGINE, decode_buckets=None)
    ref, _ = cpu.serve(prompts, max_new_tokens=8, **kw)
    got, st = gpu.serve(prompts, max_new_tokens=8, **kw)
    if any(o is None for o in ref + got):
        fail("small-model check: a request failed")
    if st["kernel_launches"]["paged_attention_fwd"] == 0:
        fail("small-model check did not reach the kernels")
    for i, (a, b) in enumerate(zip(ref, got)):
        if not np.array_equal(a, b):
            fail(f"small-model check: prompt {i} tokens differ card vs CPU:"
                 f" {b[-8:].tolist()} vs {a[-8:].tolist()}")
    say(f"check: small f32 Llama, card through the kernels == CPU plain "
        f"versions on {len(prompts)} prompts x 8 tokens")


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
            "paged_prefill_write": layers * len(prompts),
            "paged_attention_fwd": layers * st["decode_steps"]}
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
    return launches


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
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import llama_lm
    from flexflow_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    card = phase_card()
    phase_build(kernels)
    rows = phase_kernels(torch, kernels)
    phase_check(torch, FFConfig, FFModel, llama_lm)
    launches = phase_serve(torch, FFConfig, FFModel, llama_lm, kernels, card)
    say(f"total: {time.perf_counter() - t_start:.1f} s")

    sources = {"flash_attention_fwd": ("flash_attention.cu", 180),
               "paged_attention_fwd": ("paged_attention.cu", 689),
               "paged_prefill_write": ("paged_prefill_write.cu", 779)}
    table = []
    for name, r in rows.items():
        src, line = sources[name]
        table.append({
            "name": name, "route": "cuda",
            "source": f"flexflow_tpu_torch/csrc/{src}",
            "replaces": f"flexflow_tpu/ops/pallas_kernels.py:{line}",
            "launches": launches[name], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
