#!/usr/bin/env python3
"""Time the paged-attention kernel at every split count, on one card.

    python3 scripts/torch_paged_split_sweep.py

For chip_smoke.py's paged-attention cases (4 slots at Llama-3-8B widths,
~620 or ~8000 live positions a slot; native and int8 pools), launches the
kernel through its C entry with each split length of 1, 2, 4, ... pages
(up to the table, within the kernel's 32-split cap), holds each result to
chip_smoke.py's limit against the plain version, and prints the device time
(chip_smoke.py's cuda_ms) beside the split count that
``ops/kernels.py paged_attention_plan`` picks — the data for tuning
``PAGED_BLOCKS_PER_SM``. Needs one CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_paged_split_sweep: no CUDA device")
    import chip_smoke as cs
    from flexflow_tpu_torch.ops import kernels as K

    card = cs.phase_card()
    lib = K.LIBRARY.get()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def launch(c, split_pages):
        """The wrapper's launch with another split length."""
        q, kp, vp, table, wp, rl, pad, scale = c["args"]
        b, s, h, d = q.shape
        ps, kvh, pps = kp.shape[1], kp.shape[2], table.shape[1]
        splits = -(-pps // split_pages)
        gx = b * kvh * -(-s * (h // kvh) // K.PAGED_ROWS)
        out = torch.empty_like(q)
        n_part = gx * splits * K.PAGED_ROWS
        ws = torch.empty(n_part * (d + 2), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
        K._check(lib.ff_paged_attention_fwd(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            ptr(c["kw"].get("k_scales")), ptr(c["kw"].get("v_scales")),
            table.data_ptr(), wp.data_ptr(), rl.data_ptr(), pad.data_ptr(),
            out.data_ptr(), ws.data_ptr(), ws.data_ptr() + 4 * n_part * d,
            K._tickets(dev, stream, gx).data_ptr(), K._DTYPE_CODES[q.dtype],
            K._DTYPE_CODES[kp.dtype], b, s, h, kvh, d, ps, pps, split_pages,
            float(scale), stream), "paged_attention_fwd")
        return out

    for pool, long in (("bf16", False), ("int8", False), ("bf16", True),
                       ("int8", True)):
        c = cs.paged_case(torch, K, g, pool, long)
        ref = K.paged_attention_plain(*c["args"], **c["kw"])
        pps = c["args"][3].shape[1]
        cs.say(f"sweep {pool} {'~8000' if long else '~620'} live a slot: "
               f"the plan picks {c['plan'].splits} splits of "
               f"{c['plan'].split_pages} page(s) [{card}]")
        sp = max(1, -(-pps // K.PAGED_MAX_SPLITS))
        while sp <= pps:
            out = launch(c, sp)
            torch.cuda.synchronize()
            err = cs.paged_err(c, out, ref)
            if not err <= c["limit"]:
                cs.fail(f"split length {sp}: err {err} (limit {c['limit']})")
            ms = cs.cuda_ms(lambda: launch(c, sp))
            cs.say(f"sweep   {-(-pps // sp):3d} splits of {sp:2d} page(s): "
                   f"{ms:.4f} ms ({100 * c['bound'][0] / ms:.1f}% of bound)")
            sp *= 2
        del c, ref


if __name__ == "__main__":
    main()
