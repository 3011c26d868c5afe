#!/usr/bin/env python3
"""Time this checkout's paged-attention, add + LayerNorm, prefill-write and
fused-update kernels beside another checkout's (the parent commit's, say)
on one card, in turns.

    python3 scripts/torch_kernel_ab.py --other DIR [--rounds 3] [--serve N]
        [--cases all|ln|paged|write|update] [--out FILE]

DIR is the root of another checkout of the repository (for instance
``git archive`` of the parent commit unpacked into ``build/parent``, which
.gitignore lists). Each checkout's kernel library is built from its own
sources into its own ``build/`` and both are loaded into this process. For
each case both outputs are first held against the plain version to
chip_smoke.py's limits; then the other checkout's kernel and this one's are
timed in turns (other, this, other, this, ... ``--rounds`` times each) with
chip_smoke.py's timer (``cuda_ms``: L2 flushed, a device wait that hides the
wrapper's host time, CUDA events, the median of 20 launches), and the median
over the rounds is printed beside the bound, the plain version's time and,
for add + LayerNorm, the time of ``x + r`` then ``F.layer_norm`` and of a
device copy of the same bytes (what the card reaches on that traffic). It
also prints each wrapper's host time a call (other, this, this, other; the
card held busy meanwhile), which a host-bound decode step pays per layer.

Cases: add + LayerNorm at the flagship's training shape ((4096, 4096) bf16
rows with stats), paged attention over the native, int8, fp8 and
mixed-width pools at the serving shape and over the native, int8 and fp8
pools at ~8000 live positions a slot (``chip_smoke.paged_case``), and the
prefill write of a 512-token slab into native, int8 and fp8 pools for one
layer and for 32 layers (``chip_smoke.prefill_write_case``): this
checkout's ``paged_prefill_write_layers`` (one launch) against the other
checkout's ``paged_prefill_write`` once a layer (32 launches, timed after
a ~10 ms device wait so that their host time lies behind it too). With
``--serve N`` it also serves chip_smoke.py's Llama-3-8B-width model from a
native and an int8 pool, swapping the two checkouts' prefill writes in one
process, A B B A N times (``serve_ab``: wall time, TTFT, decode step).
The fused update (``update``) runs at chip_smoke.py's phase-3 bucket (the
full-width flagship's 1.21 B bf16 weights in ~100 leaves) for SGD, SGD
with momentum and Adam on flat state, both checkouts' ``fused_update``
bitwise the per-leaf torch formula, timed in turns after a ~10 ms device
wait (the wrapper's host time: it reads every leaf's address, and plans
the leaves where it has no cached tables for them), beside a device copy
of the same bytes. ``--cases`` picks one group of cases (default all).
Writes the numbers as JSON to FILE (default build/kernel_ab.json).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load_kernels(root: Path, name: str):
    """The ``ops/kernels.py`` module of the checkout at ``root``, loaded
    under ``name``; it builds its library from ``root``'s sources."""
    path = root / "flexflow_tpu_torch" / "ops" / "kernels.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--serve", type=int, default=0, metavar="ROUNDS",
                    help="also serve chip_smoke.py's Llama-3-8B-width model "
                         "ROUNDS times A B B A per KV pool, with this and "
                         "the other checkout's prefill write")
    ap.add_argument("--cases", default="all",
                    choices=("all", "ln", "paged", "write", "update"),
                    help="run one group of cases (default: all)")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "kernel_ab.json")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("torch_kernel_ab: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from flexflow_tpu_torch.ops import kernels as this

    card = cs.phase_card()
    other = load_kernels(args.other.resolve(), "other_kernels")
    for k in (other, this):
        k.LIBRARY.get()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results = []

    def host_us(fn, calls: int = 100) -> float:
        """Host time of one call of ``fn`` (the wrapper's Python and the
        launch), in us, with the card held busy by a device wait so that
        no call waits for it: what a host-bound decode step pays a call."""
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return t

    def run_case(name, fns, check, plain, library, bnd, shape,
                 library_name="x + r, F.layer_norm", sleep=cs.SLEEP_CYCLES):
        for tag, fn in (("other", fns[0]), ("this", fns[1])):
            err, limit = check(fn())
            if not err <= limit:
                cs.fail(f"{name} ({tag} checkout) disagrees with its plain "
                        f"version: err {err} (limit {limit})")
        times = {"other": [], "this": []}
        for _ in range(args.rounds):
            times["other"].append(cs.cuda_ms(fns[0], sleep=sleep))
            times["this"].append(cs.cuda_ms(fns[1], sleep=sleep))
        med = {k: statistics.median(v) for k, v in times.items()}
        host = [host_us(fn) for fn in (fns[0], fns[1], fns[1], fns[0])]
        row = dict(name=name, shape=shape, card=card,
                   other_ms=med["other"], this_ms=med["this"],
                   other_host_us=(host[0] + host[3]) / 2,
                   this_host_us=(host[1] + host[2]) / 2,
                   other_rounds=times["other"], this_rounds=times["this"],
                   plain_ms=cs.cuda_ms(plain, sleep=sleep),
                   library_ms=(cs.cuda_ms(library, sleep=sleep) if library
                               else None),
                   bound_ms=bnd[0], bound_by=bnd[1])
        results.append(row)
        cs.say(f"ab {name}: {shape}: this {row['this_ms']:.4f} ms "
               f"({100 * bnd[0] / row['this_ms']:.1f}% of bound), other "
               f"{row['other_ms']:.4f} ms ({100 * bnd[0] / row['other_ms']:.1f}"
               f"%), {row['other_ms'] / row['this_ms']:.2f}x; bound "
               f"{bnd[0]:.4f} ms by {bnd[1]}; plain {row['plain_ms']:.4f} ms"
               + (f"; {library_name} {row['library_ms']:.4f} ms"
                  if library else "")
               + f"; host a call: this {row['this_host_us']:.1f} us, other "
               f"{row['other_host_us']:.1f} us"
               + f"; rounds this {times['this']} other {times['other']} "
               f"[{card}]")

    def want(group):
        return args.cases in ("all", group)

    if want("ln"):
        layernorm_ab(torch, F, cs, this, other, g, dev, card, results,
                     run_case)
    if want("paged"):
        for name, pool, long in cs.PAGED_CASES:
            c = cs.paged_case(torch, this, g, pool, long)
            pref = this.paged_attention_plain(*c["args"], **c["kw"])

            def check_paged(out, c=c, pref=pref):
                torch.cuda.synchronize()
                return cs.paged_err(c, out, pref), c["limit"]

            run_case(name,
                     [lambda k=k, c=c: k.paged_attention_fwd(*c["args"],
                                                             **c["kw"])
                      for k in (other, this)], check_paged,
                     lambda c=c: this.paged_attention_plain(*c["args"],
                                                            **c["kw"]),
                     None, c["bound"], c["shape"])
            del c, pref
    if want("write"):
        prefill_write_ab(torch, cs, this, other, g, run_case)
    if want("update"):
        update_ab(torch, cs, this, other, g, card, results, run_case)
    if args.serve:
        results.extend(serve_ab(torch, cs, this, other, card, args.serve))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    cs.say(f"ab: {len(results)} cases -> {args.out}")


def layernorm_ab(torch, F, cs, this, other, g, dev, card, results, run_case):
    """Add + LayerNorm at the flagship's training shape, and a device copy
    of the same bytes."""
    f = cs.FLAGSHIP
    n, dm = f["batch"] * f["seq"], f["hidden"]
    bf16 = torch.bfloat16
    x, r = (torch.randn(n, dm, device=dev, generator=g).to(bf16)
            for _ in range(2))
    sc = (torch.rand(dm, device=dev, generator=g) + 0.5).to(bf16)
    bi = torch.randn(dm, device=dev, generator=g).to(bf16)
    ref = this.fused_add_layernorm_plain(x, r, sc, bi, 1e-5)

    def check_ln(got):
        torch.cuda.synchronize()
        stats = max(cs.scaled_err(a, b) for a, b in zip(got[2:], ref[2:]))
        exact = torch.equal(got[0], ref[0])
        err = cs.scaled_err(got[1], ref[1]) if exact else float("inf")
        return (err if stats <= 1e-5 else float("inf")), cs.SCALED_TOL

    run_case("fused_add_layernorm_fwd",
             [lambda k=k: k.fused_add_layernorm_fwd(x, r, sc, bi, 1e-5)
              for k in (other, this)], check_ln,
             lambda: this.fused_add_layernorm_plain(x, r, sc, bi, 1e-5),
             lambda: F.layer_norm(x + r, (dm,), sc, bi, 1e-5),
             cs.bound(2 * 4 * n * dm + 2 * 2 * dm + 4 * 2 * n, 9 * n * dm,
                      cs.F32_FLOP_PER_S),
             f"x/r ({n},{dm}) bf16 with stats")
    # what a plain device copy of the same bytes takes: reading 2 N D
    # bf16 values and writing as many, the traffic of add + LayerNorm
    src = torch.randn(2 * n, dm, device=dev, generator=g).to(bf16)
    dst = torch.empty_like(src)
    copy_ms = cs.cuda_ms(lambda: dst.copy_(src))
    results.append(dict(name="copy_same_bytes", shape=f"({2 * n},{dm}) bf16",
                        card=card, this_ms=copy_ms))
    cs.say(f"ab copy of the same bytes: ({2 * n},{dm}) bf16 read and "
           f"written: {copy_ms:.4f} ms ({4 * n * dm * 2 / copy_ms / 1e9:.2f} "
           f"TB/s) [{card}]")
    del x, r, ref, src, dst


def update_ab(torch, cs, this, other, g, card, results, run_case):
    """The fused update at chip_smoke.py's phase-3 bucket, flat state, for
    SGD, SGD with momentum and Adam: each checkout's ``fused_update`` on a
    copy of the same weights and state, checked bitwise against the
    per-leaf torch formula on a third copy, then timed in turns; the
    "plain" column is that formula's time, and a device copy of the same
    bytes stands beside them."""
    import math

    import flexflow_tpu_torch as port
    from flexflow_tpu_torch.runtime.optimizer import apply_update_plain

    shapes = cs.flagship_leaf_shapes(port)
    n = sum(math.prod(s) for s in shapes)
    for name, kw, form, bytes_per, ops_per in cs.UPDATE_ROWS:
        if form != "flat":
            continue
        rule = this.UpdateRule(**kw)
        ps, gs, ms = cs.update_case(torch, g, rule, shapes)
        if rule.kind == "adam":
            lr = port.AdamOptimizer(alpha=1e-3).lr_of(
                torch.zeros((), dtype=torch.int32, device="cuda"))
        else:
            lr = torch.full((), cs.TRAIN_LR, device="cuda")
        copies = {tag: ([p.clone() for p in ps], [m.clone() for m in ms])
                  for tag in ("other", "this")}
        ref_p, ref_m = ps, ms          # the formula runs on the originals
        views = [cs.leaf_state(torch, ref_p, m) for m in ref_m]

        def formula(ps=ref_p, views=views):
            for i, (p, gr) in enumerate(zip(ps, gs)):
                apply_update_plain(rule, p, gr, [v[i] for v in views], lr)

        formula()

        def check(got, ref=(ref_p, ref_m)):
            torch.cuda.synchronize()
            same = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                       for a, b in zip(got[0] + got[1], ref[0] + ref[1]))
            return (0.0 if same else float("inf")), 0.0

        def step(k, tag):
            cp, cm = copies[tag]
            k.fused_update(rule, cp, gs, cm, lr)
            return cp, cm

        run_case(name, [lambda: step(other, "other"),
                        lambda: step(this, "this")], check,
                 formula, None,
                 cs.bound(bytes_per * n, ops_per * n, cs.F32_FLOP_PER_S),
                 f"{len(shapes)} leaves, {n / 1e9:.3f} B bf16 elements, "
                 f"{name}, flat state", sleep=cs.LONG_SLEEP_CYCLES)
        del ps, gs, ms, copies, ref_p, ref_m, views
        src = torch.empty(bytes_per * n // 2, dtype=torch.uint8,
                          device="cuda")
        dst = torch.empty_like(src)
        copy_ms = cs.cuda_ms(lambda: dst.copy_(src), iters=5, warmup=1)
        results.append(dict(name=f"copy_{name}", card=card,
                            this_ms=copy_ms,
                            shape=f"{bytes_per * n} bytes, read and written"))
        cs.say(f"ab copy of {name}'s bytes: {copy_ms:.4f} ms [{card}]")
        del src, dst
        torch.cuda.empty_cache()


def prefill_write_ab(torch, cs, this, other, g, run_case):
    """The prefill write (kernel 5) at chip_smoke.py's phase-3 shapes, one
    layer and 32: this checkout's grouped wrapper against the other's
    single-layer wrapper called once a layer, both bitwise the plain
    version; the native cases also time index_copy_ of the page-reshaped
    slabs (k and v of each layer)."""
    for suffix, pool in cs.WRITE_POOLS:
        for n_layers in (1, cs.WRITE_LAYERS):
            c = cs.prefill_write_case(torch, g, pool, n_layers)
            ref = c["new"]()
            this.paged_prefill_write_layers_plain(*ref)

            def other_fn(a=c["new"](), n=n_layers):
                for i in range(n):
                    other.paged_prefill_write(
                        a[0][i], a[1][i], a[2][i], a[3][i], a[4],
                        *(x[i] if x else None for x in a[5:]))
                return a

            def this_fn(a=c["new"]()):
                this.paged_prefill_write_layers(*a)
                return a

            def check(a, ref=ref):
                torch.cuda.synchronize()
                return (0.0 if cs.same_bytes(torch, a, ref)
                        else float("inf")), 0.0

            library = None
            if pool == "bf16":
                pk, pv, khs, vhs, pages = c["new"]()[:5]
                shape = (pages.shape[0], pk[0].shape[1], *khs[0].shape[2:])
                pairs = list(zip(pk, khs)) + list(zip(pv, vhs))

                def library(pairs=pairs, idx=pages.long(), shape=shape):
                    for dst, slab in pairs:
                        dst.index_copy_(0, idx, slab.view(shape))

            tag = "" if n_layers == 1 else f"_layers{n_layers}"
            run_case(f"paged_prefill_write{tag}{suffix}", [other_fn, this_fn],
                     check, lambda a=c["new"](): (
                         this.paged_prefill_write_layers_plain(*a)),
                     library, c["bound"], c["shape"],
                     library_name="index_copy_ (k and v a layer)",
                     sleep=cs.LONG_SLEEP_CYCLES)
            del c, ref


def serve_ab(torch, cs, this, other, card, rounds):
    """chip_smoke.py phase 6's model and prompts served from a native and
    an int8 pool, alternating (A B B A, ``rounds`` times) between this
    checkout's prefill write (one launch for every layer) and the other's
    (one launch a layer), swapped in one process (so the host's speed,
    which varies between processes, is the same for both): each serve's
    wall time, TTFT p50 and decode step."""
    import numpy as np

    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import llama_lm

    ff = cs.build_llama(FFConfig, FFModel, llama_lm, "cuda", "bfloat16", 0,
                        **cs.LLAMA3_8B)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cs.LLAMA3_8B["vocab_size"], size=n)
               .astype(np.int32) for n in cs.PROMPT_LENS]
    own = this.paged_prefill_write_layers

    def per_layer(pools_k, pools_v, khs, vhs, pages, k_scales=None,
                  v_scales=None):
        for i in range(len(pools_k)):
            other.paged_prefill_write(
                pools_k[i], pools_v[i], khs[i], vhs[i], pages,
                k_scales[i] if k_scales is not None else None,
                v_scales[i] if v_scales is not None else None)

    out = []
    for kv in ("native", "int8"):
        knobs = {} if kv == "native" else dict(kv_cache_dtype="int8")
        eng = ff.make_serving_engine(**cs.ENGINE, **knobs)
        eng.run(prompts, max_new_tokens=cs.MAX_NEW)      # warm-up
        times = {"this": [], "other": []}
        for _ in range(rounds):
            for tag in ("other", "this", "this", "other"):
                this.paged_prefill_write_layers = (
                    own if tag == "this" else per_layer)
                before = eng.stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                reqs = eng.run(prompts, max_new_tokens=cs.MAX_NEW)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                st = eng.stats()
                steps = st["decode_steps"] - before["decode_steps"]
                step_ms = (st["decode_step_ms"] * st["decode_steps"]
                           - before["decode_step_ms"]
                           * before["decode_steps"]) / max(1, steps)
                ttft = statistics.median(r.ttft * 1e3 for r in reqs)
                times[tag].append((wall * 1e3, ttft, step_ms))
        this.paged_prefill_write_layers = own
        med = {k: [statistics.median(x[i] for x in v) for i in range(3)]
               for k, v in times.items()}
        out.append(dict(name=f"serve_{kv}", card=card, rounds=times,
                        this_wall_ms=med["this"][0],
                        other_wall_ms=med["other"][0],
                        this_ttft_p50_ms=med["this"][1],
                        other_ttft_p50_ms=med["other"][1],
                        this_step_ms=med["this"][2],
                        other_step_ms=med["other"][2]))
        cs.say(f"ab serve {kv} pool: wall this {med['this'][0]:.1f} ms, "
               f"other {med['other'][0]:.1f} ms; TTFT p50 this "
               f"{med['this'][1]:.1f} ms, other {med['other'][1]:.1f} ms; "
               f"decode step this {med['this'][2]:.2f} ms, other "
               f"{med['other'][2]:.2f} ms (medians of {2 * rounds}, A B B A)"
               f" [{card}]")
        del eng
    return out


if __name__ == "__main__":
    main()
