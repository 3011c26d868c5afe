"""Machine model (the JAX package's ``search/machine.py``, its formulas
unchanged) with an H100 SXM node's figures as the defaults.

Every default below is a datasheet figure of NVIDIA's H100 SXM5 80 GB
(none is measured by this repo): 989 TFLOP/s dense bf16 and 67 TFLOP/s
f32 (CUDA cores), 3.35 TB/s of HBM3, 80 GB, NVLink 4 at 450 GB/s a
direction, one 400 Gb/s NDR InfiniBand port (50 GB/s) between nodes, and
PCIe Gen5 x16 (64 GB/s a direction) to the host.

The field names are the JAX package's, so a search or a placement written
against one package reads the other: ``ici_*`` is the fast intra-node
domain — NVLink here, the TPU's inter-chip interconnect there — and
``dcn_*`` the inter-node fabric — InfiniBand here, the data-center network
there. ``dcn_axes`` maps a mesh axis to the number of nodes it spans: a
collective over such an axis decomposes hierarchically, a ring over NVLink
within the node, then a ring over the fabric across nodes. Collective
costs are ring formulas over the axis being reduced.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class MachineModel:
    # per-card compute (datasheet, H100 SXM5)
    peak_flops: float = 989e12  # bf16 dense tensor-core FLOP/s
    peak_flops_f32: float = 67e12  # f32 CUDA-core FLOP/s
    hbm_bw: float = 3.35e12  # bytes/s, HBM3
    hbm_bytes: float = 80e9  # capacity per card
    # interconnect (datasheet): NVLink 4 in the node, NDR between nodes
    ici_bw: float = 4.5e11  # bytes/s per direction (NVLink, 450 GB/s)
    dcn_bw: float = 5.0e10  # bytes/s per node (one 400 Gb/s NDR port)
    ici_latency: float = 1e-6  # seconds per hop (not measured)
    dcn_latency: float = 1e-5  # seconds per hop (NIC + switch; not measured)
    # host<->device bandwidth: PCIe Gen5 x16, per direction (datasheet)
    host_bw: float = 6.4e10  # bytes/s
    mxu_efficiency: float = 0.5  # achievable fraction of peak on real shapes
    # mesh axis name -> number of nodes the axis spans (1 = NVLink only)
    dcn_axes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def compute_time(self, flops: float, bytes_moved: float,
                     dtype_bytes: int = 4) -> float:
        """Roofline: max(FLOP time, HBM time)."""
        f = self.peak_flops if dtype_bytes <= 2 else self.peak_flops_f32
        return max(flops / (f * self.mxu_efficiency),
                   bytes_moved / self.hbm_bw)

    # ---- tier decomposition -------------------------------------------------

    def _tiers(self, axis_size: int, axis_name: Optional[str]):
        """(intra_host_degree, cross_host_degree) for one mesh axis."""
        hosts = self.dcn_axes.get(axis_name, 1) if axis_name else 1
        hosts = max(1, min(hosts, axis_size))
        while hosts > 1 and axis_size % hosts != 0:
            hosts -= 1  # degenerate config: clamp to a divisor
        return axis_size // hosts, hosts

    @staticmethod
    def _ring(bytes_per_chip: float, size: int, bw: float, lat: float) -> float:
        """Bidirectional ring all-reduce over one tier."""
        if size <= 1:
            return 0.0
        return (2.0 * (size - 1) / size * bytes_per_chip / (2 * bw)
                + size * lat)

    # ---- collectives --------------------------------------------------------

    def all_reduce_time(self, bytes_per_chip: float, axis_size: int,
                        axis_name: Optional[str] = None) -> float:
        """Hierarchical ring all-reduce: ICI within the host, DCN across."""
        if axis_size <= 1:
            return 0.0
        intra, hosts = self._tiers(axis_size, axis_name)
        t = self._ring(bytes_per_chip, intra, self.ici_bw, self.ici_latency)
        t += self._ring(bytes_per_chip, hosts, self.dcn_bw, self.dcn_latency)
        return t

    def all_gather_time(self, bytes_per_chip: float, axis_size: int,
                        axis_name: Optional[str] = None) -> float:
        if axis_size <= 1:
            return 0.0
        intra, hosts = self._tiers(axis_size, axis_name)
        t = 0.0
        if intra > 1:
            t += ((intra - 1) / intra * bytes_per_chip * intra
                  / (2 * self.ici_bw) + intra * self.ici_latency)
        if hosts > 1:
            # each host gathers the other hosts' (already intra-gathered) parts
            t += ((hosts - 1) / hosts * bytes_per_chip * axis_size / hosts
                  / self.dcn_bw + hosts * self.dcn_latency)
        return t

    def reduce_scatter_time(self, bytes_per_chip: float, axis_size: int,
                            axis_name: Optional[str] = None) -> float:
        """Hierarchical ring reduce-scatter — the bucketed grad-sync
        primitive (FFConfig.overlap_grad_sync) and FSDP's gradient
        collective: the ring's reduce phase without the all-gather return
        trip, so each tier costs half an all-reduce's wire time plus the
        full per-hop latency."""
        if axis_size <= 1:
            return 0.0
        intra, hosts = self._tiers(axis_size, axis_name)
        t = 0.0
        if intra > 1:
            t += ((intra - 1) / intra * bytes_per_chip / (2 * self.ici_bw)
                  + intra * self.ici_latency)
        if hosts > 1:
            t += ((hosts - 1) / hosts * bytes_per_chip / (2 * self.dcn_bw)
                  + hosts * self.dcn_latency)
        return t

    def all_to_all_time(self, bytes_per_chip: float, axis_size: int,
                        axis_name: Optional[str] = None) -> float:
        if axis_size <= 1:
            return 0.0
        intra, hosts = self._tiers(axis_size, axis_name)
        t = 0.0
        if intra > 1:
            # each chip sends (size-1)/size of its shard, both ring dirs
            t += (bytes_per_chip * (intra - 1) / intra / (2 * self.ici_bw)
                  + intra * self.ici_latency)
        if hosts > 1:
            t += (bytes_per_chip * (hosts - 1) / hosts / self.dcn_bw
                  + hosts * self.dcn_latency)
        return t

    def p2p_time(self, nbytes: float, cross_host: bool = False) -> float:
        if cross_host:
            return nbytes / self.dcn_bw + self.dcn_latency
        return nbytes / self.ici_bw + self.ici_latency
