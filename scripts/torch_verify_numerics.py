#!/usr/bin/env python3
"""Whether a speculative verify slab computes a decode step's bits, and what
that costs.

    python3 scripts/torch_verify_numerics.py

Greedy speculation emits the target's argmax at each verify position, so
its tokens are the plain decode's only where slab position 0's logits are
the decode step's. In bf16 that rests on the arithmetic, not on the math:
on the card at 16-bit widths the verify projects k / v a position at a
time and sizes kernel 4's splits for one position
(``attention.verify_as_decode``). On one CUDA device this prints:

  * for the matrix products of a Llama-3-8B layer and its lm_head (bf16,
    K x N = 4096 x 4096, 4096 x 1024, 4096 x 14336, 14336 x 4096, 4096 x
    128256), whether the rows of an M = 20 product (a verify slab of 4
    slots x 5 positions) are bitwise the M = 4 product's (a decode step's)
    and the M = 8 one's, and whether a batch of 5 M = 4 products (``bmm``,
    the weight broadcast) is;
  * on chip_smoke.py's Llama-3-8B (bf16, seeded random weights) with four
    prompts admitted, the decode step's logits against slab position 0's
    of a 5-position verify pass from the same pool, in five forms: as the
    port runs it, with k / v a position at a time as one batched product,
    with k / v projected as one product, with kernel 4's splits sized for
    the slab's rows, and with both undone — bitwise or
    not, the largest difference, whether the argmax agrees, and the
    verify pass's device time in that form (the pass captured as a CUDA
    graph, as the engine runs it; median of 3 rounds of 20 replays, the
    forms in turns) beside the decode step's;
  * kernel 4 alone at phase 11's verify row (chip_smoke.py: q (4, 5, 32,
    128) bf16, two slots clamped) with the decode step's splits and with
    the slab's (chip_smoke.cuda_ms: L2 flushed, median of 20).
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def slab_sized_plan(kernels):
    """``paged_attention_plan`` with the splits sized for the slab's own
    row chunks whatever the caller asks (the verify before the decode
    split plan)."""
    plan = kernels.paged_attention_plan

    def slab(b, s, h, kvh, page_size, pages_per_slot, sms, *_, **__):
        return plan(b, s, h, kvh, page_size, pages_per_slot, sms)
    return slab


def batched_by_position(x, w):
    """k / v a position at a time as ONE batched product: (S, B, D) x the
    weight broadcast over S (stride 0), each batch entry an M = B
    product."""
    import torch

    b, s, d = x.shape
    w2 = w.reshape(d, -1)
    y = torch.bmm(x.transpose(0, 1).contiguous(), w2.expand(s, *w2.shape))
    return y.transpose(0, 1).reshape(b, s, w.shape[1], w.shape[2])


def replay_ms(prog, rounds: int = 20) -> float:
    """Median device time of one replay of a captured program (CUDA
    events around each replay)."""
    import torch

    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        prog()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import llama_lm
    from flexflow_tpu_torch.ops import attention, kernels
    from flexflow_tpu_torch.runtime import serving

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    g = torch.Generator(device="cuda").manual_seed(0)
    for k, n in [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                 (4096, 128256)]:
        w = (torch.randn(k, n, device="cuda", generator=g) * 0.02).to(
            torch.bfloat16)
        x20 = torch.randn(20, k, device="cuda", generator=g).to(
            torch.bfloat16)
        y20 = x20 @ w
        y4 = x20[::5].contiguous() @ w
        y8 = x20[:8].contiguous() @ w
        yb = torch.bmm(x20.view(5, 4, k), w.expand(5, k, n))
        print(f"product {k} x {n}: the M = 4 rows bitwise M = 20's "
              f"{torch.equal(y20[::5], y4)} (largest difference "
              f"{(y20[::5].float() - y4.float()).abs().max().item():.3g}), "
              f"M = 8's {torch.equal(y20[:8], y8)}, a batch of 5 M = 4 "
              f"products' {torch.equal(yb[0], x20[:4].contiguous() @ w)} "
              f"[{card}]", flush=True)
        del w, x20, y20, y4, y8, yb

    ff = chip_smoke.build_llama(FFConfig, FFModel, llama_lm, "cuda",
                                "bfloat16", 0, **chip_smoke.LLAMA3_8B)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, chip_smoke.LLAMA3_8B["vocab_size"], size=n)
               .astype(np.int32) for n in chip_smoke.PROMPT_LENS[:4]]
    eng = ff.make_serving_engine(**chip_smoke.P11_ENGINE)
    with torch.inference_mode():
        for p in prompts:
            eng.submit(p, chip_smoke.MAX_NEW)
        eng._admit()
        wp, rp, budget = eng._slot_decode_state()
        dev = lambda a: torch.tensor(a, device="cuda")  # noqa: E731
        paged = dict(page_table=dev(eng.page_tables), write_pos=dev(wp),
                     rope_pos=dev(rp), row_len=dev(eng.row_len),
                     prompt_pad=dev(eng.prompt_pad))
        tok = dev(eng.last_tok).long()
        params = eng.gen.params()
        decode, _ = eng.gen._walk(params, tok[:, None], eng.pool,
                                  paged=paged)
        slab = tok[:, None].repeat(1, 5)
        verify_pos = torch.minimum(
            dev(wp)[:, None] + torch.arange(5, device="cuda"),
            dev(budget)[:, None] - 1).int()
        project = attention.MultiHeadAttention._project_qkv

        def one_product(self, *a, **kw):
            kw["kv_by_position"] = False
            return project(self, *a, **kw)

        def form(what):
            patches = []
            if "batched" in what:
                patches.append(mock.patch.object(
                    attention, "_head_proj_by_position",
                    batched_by_position))
            if "project" in what:
                patches.append(mock.patch.object(
                    attention.MultiHeadAttention, "_project_qkv",
                    one_product))
            if "plan" in what:
                patches.append(mock.patch.object(
                    kernels, "paged_attention_plan", slab_sized_plan(kernels)))
            stack = contextlib.ExitStack()
            for ptc in patches:
                stack.enter_context(ptc)
            return stack

        verify_paged = dict(paged, write_pos=verify_pos)
        forms = (("as the port runs it", ()),
                 ("k / v a batched product over positions", ("batched",)),
                 ("k / v as one product", ("project",)),
                 ("splits sized for the slab", ("plan",)),
                 ("both undone", ("project", "plan")))
        progs = {}
        stream = torch.cuda.Stream()
        for tag, what in forms:
            with form(what):
                verify, _ = eng.gen._walk(params, slab, eng.pool,
                                          paged=verify_paged)
                # the first call runs eagerly, the second captures
                prog = serving._Program(
                    lambda: eng.gen._walk(params, slab, eng.pool,
                                          paged=verify_paged)[0],
                    {}, stream)
                prog()
                prog()
            progs[tag] = prog
            a, b = decode[:, 0].float(), verify[:, 0].float()
            print(f"decode step vs verify position 0 ({tag}): logits "
                  f"bitwise {torch.equal(a, b)}, largest difference "
                  f"{(a - b).abs().max().item():.4g}, argmax equal "
                  f"{torch.equal(a.argmax(-1), b.argmax(-1))} [{card}]",
                  flush=True)
        dprog = serving._Program(
            lambda: eng.gen._walk(params, tok[:, None], eng.pool,
                                  paged=paged)[0], {}, stream)
        dprog()
        dprog()
        times = {tag: [] for tag in [*progs, "decode step"]}
        for _ in range(3):
            for tag, prog in [*progs.items(), ("decode step", dprog)]:
                times[tag].append(replay_ms(prog))
        for tag, ts in times.items():
            what = "decode step (one position)" if tag == "decode step" \
                else f"verify pass, 5 positions ({tag})"
            print(f"{what}: {statistics.median(ts):.4f} ms a replay "
                  f"(rounds {[round(t, 4) for t in ts]}) [{card}]",
                  flush=True)

    geom = dict(heads=32, kv_heads=8, d=128, pages=8, s=5,
                lens=([500, 620, 530, 690], [512, 640, 544, 704],
                      [600, 660, 560, 720]), budget=[1024, 662, 562, 1024])
    c = chip_smoke.paged_case(torch, kernels, g, "bf16", False, geom)
    for tag, splits in (("the decode step's splits", True),
                        ("the slab's splits", False)):
        plan = kernels.paged_attention_plan(4, 5, 32, 8, 128, 8,
                                            kernels.sm_count(
                                                torch.device("cuda")),
                                            decode_splits=splits)
        ms = chip_smoke.cuda_ms(lambda: kernels.paged_attention_fwd(
            *c["args"], **c["kw"], decode_splits=splits))
        print(f"kernel 4 at the verify row, {tag} (grid {plan.grid}, "
              f"{plan.splits} splits of {plan.split_pages} page(s)): "
              f"{ms:.4f} ms [{card}]", flush=True)


if __name__ == "__main__":
    main()
