#!/usr/bin/env python3
"""Time the quantizing prefill write at every cluster size, on one card.

    python3 scripts/torch_prefill_write_cluster_sweep.py

For chip_smoke.py's prefill-write cases (a 512-token bf16 slab at
Llama-3-8B widths into 4 pages of an int8 or an fp8 pool, for one layer and
for 32), launches the kernel through its C entry with each tile's rows
split over 1, 2, 4 and 8 CTAs of a thread block cluster, holds each result
bitwise to the plain version, and prints the device time (chip_smoke.py's
cuda_ms) beside the cluster size that ``ops/kernels.py
prefill_write_cluster`` picks — the data that decided against splitting a
tile one CTA holds to fill the card. Needs one CUDA device.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_prefill_write_cluster_sweep: no CUDA device")
    import chip_smoke as cs
    from flexflow_tpu_torch.ops import kernels as K

    card = cs.phase_card()
    lib = K.LIBRARY.get()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def launch(a, cluster):
        """The wrapper's launch with another cluster size."""
        pk, pv, khs, vhs, pages, ks, vs = a
        arr = lambda ts: (ctypes.c_void_p * len(ts))(  # noqa: E731
            *(t.data_ptr() for t in ts))
        n_pool, ps, kvh, d = pk[0].shape
        K._check(lib.ff_paged_prefill_write_layers(
            arr(khs), arr(vhs), arr(pk), arr(pv), arr(ks), arr(vs), len(pk),
            pages.data_ptr(), pages.shape[0], khs[0].shape[1], ps, kvh, d, d,
            khs[0].element_size(), K._DTYPE_CODES[khs[0].dtype],
            K._DTYPE_CODES[pk[0].dtype], cluster,
            torch.cuda.current_stream().cuda_stream), "prefill_write")

    for pool in ("int8", "fp8"):
        for n_layers in (1, cs.WRITE_LAYERS):
            c = cs.prefill_write_case(torch, g, pool, n_layers)
            ref = c["new"]()
            K.paged_prefill_write_layers_plain(*ref)
            pk, _, _, _, pages = ref[:5]
            tiles = n_layers * pages.shape[0] * pk[0].shape[2] * 2
            pick = K.prefill_write_cluster(pk[0].shape[1], pk[0].shape[3])
            cs.say(f"sweep {pool}, {c['shape']}: {tiles} tiles, the plan "
                   f"picks clusters of {pick} [{card}]")
            for cluster in (1, 2, 4, 8):
                a = c["new"]()
                launch(a, cluster)
                torch.cuda.synchronize()
                if not cs.same_bytes(torch, a, ref):
                    cs.fail(f"cluster {cluster}: not bitwise the plain "
                            f"version")
                ms = cs.cuda_ms(lambda: launch(a, cluster))
                cs.say(f"sweep   clusters of {cluster}: {tiles * cluster} "
                       f"CTAs, {ms:.4f} ms ({100 * c['bound'][0] / ms:.1f}% "
                       f"of bound)")
            del c, ref


if __name__ == "__main__":
    main()
