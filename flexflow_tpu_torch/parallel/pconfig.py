"""ParallelConfig: the per-op parallelization strategy record (the JAX
package's ``parallel/pconfig.py``, its jax-free parts copied).

Reference: include/config.h:47-69 ``ParallelConfig{device_type, nDims,
dim[], device_ids[]}``; data-parallel seeding src/runtime/model.cc:483-494.

Beside the reference's per-dim partition degrees the record carries an
explicit ``axis_map``: mesh-axis name -> the logical tensor dim it shards
(None: replicated over that axis). Degrees are derivable from the axis map
and the mesh; they are kept so the reference's text schema round-trips
(src/runtime/strategy.cc:95-189).

Dim order: degrees are stored in LOGICAL order (dim 0 = sample). The
reference stores them reversed (Legion domain order, sample last); file IO
(``parallel/strategy.py``) reverses accordingly.

The JAX record lowers to a ``PartitionSpec``; the port's lowers to DTensor
placements, one a mesh dim (``to_placements``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# axis_map value meaning "shard the op's CONTRACTION dim over this mesh
# axis" (row-parallel, Megatron-style): the weight is sharded on its
# input-feature dim, the input arrives sharded on its last dim (a
# column-parallel producer's layout), and the product is reduced over the
# axis, so the output is replicated over it. The reference's analog is
# Linear's NDIM+1 replica dimension (linear.cu:171-192,774-835).
CONTRACT = -2

# axis_map value meaning "run this op PIPELINED over this mesh axis": its
# stacked layer dim shards over the axis (only ops with pipeline_stages()
# accept it). The output is delivered replicated over the axis.
STAGE = -3

# axis_map value meaning "shard this op's EXPERTS over this mesh axis"
# (MoE expert parallelism). The output is delivered replicated over it.
EXPERT = -4


@dataclasses.dataclass
class ParallelConfig:
    # the file's int 0 is the accelerator pool: the port executes it on
    # the GPU (the JAX package names the same pool "TPU"); int 1 is the
    # host CPU
    device_type: str = "GPU"
    dims: Tuple[int, ...] = ()  # partition degree per logical output dim
    device_ids: Tuple[int, ...] = ()
    # mesh-axis name -> logical tensor dim it partitions (None = replicated)
    axis_map: Optional[Dict[str, Optional[int]]] = None
    # the search's per-op memory-relief mode (kept for the schema; the
    # port has no search yet)
    mem_mode: str = "none"

    # ---- constructors -----------------------------------------------------

    @staticmethod
    def data_parallel(ndims: int, num_parts: int) -> "ParallelConfig":
        """Reference: Op::get_data_parallel_config model.cc:483-494."""
        dims = tuple(num_parts if i == 0 else 1 for i in range(ndims))
        return ParallelConfig(
            dims=dims,
            device_ids=tuple(range(num_parts)),
            axis_map={"data": 0} if num_parts > 1 else {"data": None},
        )

    @staticmethod
    def replicated(ndims: int) -> "ParallelConfig":
        return ParallelConfig(dims=(1,) * ndims, device_ids=(0,), axis_map={})

    @staticmethod
    def host(ndims: int) -> "ParallelConfig":
        """Host (CPU) placement, degree 1 (the reference's heterogeneous
        DLRM embeddings). The port records it; running it is item 9 part 2's
        placement executor."""
        return ParallelConfig(dims=(1,) * ndims, device_ids=(0,),
                              axis_map={}, device_type="CPU")

    @staticmethod
    def from_axis_map(ndims: int, mesh_shape: Dict[str, int],
                      axis_map: Dict[str, Optional[int]]) -> "ParallelConfig":
        dims = [1] * ndims
        contract_deg = stage_deg = expert_deg = 1
        for ax, d in axis_map.items():
            if d == CONTRACT:
                contract_deg *= mesh_shape[ax]
            elif d == STAGE:
                # shards a WEIGHT dim: lives only in the axis map, but the
                # op occupies the stage devices
                stage_deg *= mesh_shape[ax]
            elif d == EXPERT:
                expert_deg *= mesh_shape[ax]
            elif d is not None:
                dims[d] *= mesh_shape[ax]
        if contract_deg > 1:
            # an extra trailing degree: the reference's convention for
            # Linear's replica dim (an NDIM+1 tensor)
            dims.append(contract_deg)
        n = 1
        for v in dims:
            n *= v
        return ParallelConfig(dims=tuple(dims),
                              device_ids=tuple(range(n * stage_deg
                                                     * expert_deg)),
                              axis_map=dict(axis_map))

    # ---- queries ----------------------------------------------------------

    @property
    def nDims(self) -> int:
        return len(self.dims)

    def num_parts(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def degree(self, dim: int) -> int:
        return self.dims[dim]

    def is_data_parallel_only(self) -> bool:
        return all(d == 1 for d in self.dims[1:])

    def to_placements(self, mesh_dim_names: Sequence[str],
                      ndims: Optional[int] = None) -> List:
        """The DTensor placements of the op's output on a mesh of
        ``mesh_dim_names``: ``Shard(d)`` on each mesh dim the axis map
        sends to tensor dim d, ``Replicate()`` elsewhere. The sentinels
        (CONTRACT / STAGE / EXPERT) never shard an output dim, exactly as
        the JAX ``to_partition_spec`` leaves them out of the output spec.
        Several mesh dims on one tensor dim shard it in mesh order (the
        JAX spec's tuple, major to minor)."""
        from torch.distributed.tensor import Replicate, Shard

        ndims = ndims if ndims is not None else self.nDims
        out = []
        for name in mesh_dim_names:
            d = (self.axis_map or {}).get(name)
            out.append(Shard(d) if d is not None and 0 <= d < ndims
                       else Replicate())
        return out

    def __hash__(self):
        am = tuple(sorted((k, v if v is not None else -1)
                          for k, v in (self.axis_map or {}).items()))
        return hash((self.dims, am))
