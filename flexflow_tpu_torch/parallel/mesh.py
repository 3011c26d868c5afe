"""Device mesh construction (the JAX package's ``parallel/mesh.py``): a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group, one rank a device.

Axis vocabulary, as in the JAX package:

  data   — batch / sample parallelism (the reference's SOAP 'S')
  model  — parameter / tensor parallelism (SOAP 'P'; linear.cu out-channel)
  seq    — sequence / context parallelism
  pipe   — pipeline stages
  expert — MoE expert parallelism

Axes of size 1 are legal, so one mesh covers every strategy. Ranks are
laid out in ``AXIS_ORDER``, the innermost axes fastest-varying, so the
axes that talk most ('model', 'seq') join the nearest ranks.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

AXIS_ORDER = ("pipe", "data", "expert", "seq", "model")


def ensure_process_group(device_type: str) -> None:
    """A process group for this process: the launcher's
    (``flexflow_tpu_torch.launcher``), else a world of one — NCCL on the
    card, gloo on the CPU — over an in-memory store, so a mesh of one
    device needs no launcher."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Dict[str, int], device_type: str = "cpu"):
    """A DeviceMesh from {axis: size}, its axes in the canonical order
    (names outside it after, sorted). It needs as many ranks as its
    devices: a mesh larger than the world raises, as the JAX ``make_mesh``
    does for missing devices; one smaller than the world (a rank subset)
    raises too — subsets come with placement (ROADMAP item 9 part 2)."""
    from torch.distributed.device_mesh import DeviceMesh

    axes = [a for a in AXIS_ORDER if a in shape and shape[a] > 0]
    axes += sorted(a for a in shape if a not in AXIS_ORDER)
    sizes = [shape[a] for a in axes]
    n = math.prod(sizes) if sizes else 1
    ensure_process_group(device_type)
    have = world_size()
    if have < n:
        raise ValueError(f"mesh {shape} needs {n} devices, have {have}")
    if have > n:
        raise ValueError(
            f"mesh {shape} uses {n} of the {have} ranks of this process "
            f"group; a mesh over a subset of the ranks is not ported "
            f"(ROADMAP item 9 part 2, placement)")
    if not axes:
        axes, sizes = ["data"], [1]
    if device_type == "cuda":
        # DeviceMesh sets an uninitialised CUDA context to the card of
        # LOCAL_RANK; gloo ranks sharing one card (LOCAL_RANK 1 of one
        # card) would then die there while the others wait in new_group.
        # The context is the current device's (the launcher's choice).
        torch.cuda.init()
        if dist.get_backend() == "gloo":
            route_gloo_cuda_collectives()
    return DeviceMesh(device_type, torch.arange(n).reshape(sizes),
                      mesh_dim_names=tuple(axes))


def _group_of(group):
    """The ProcessGroup of a functional collective's ``group`` argument:
    (mesh, mesh dim), a one-dim mesh, or a group."""
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    if hasattr(group, "get_group"):
        return group.get_group()
    return group


def _all_gather_c10d(x, gather_dim, group, tag=""):
    pg = _group_of(group)
    n = dist.get_world_size(pg)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=pg)
    if gather_dim != 0:
        out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
    return out


def _reduce_scatter_c10d(x, reduceOp, scatter_dim, group, tag=""):
    pg = _group_of(group)
    n = dist.get_world_size(pg)
    # the chunks along scatter_dim stacked on dim 0, c10d's scatter dim
    chunks = torch.chunk(x, n, dim=scatter_dim)
    out = torch.empty_like(chunks[0], memory_format=torch.contiguous_format)
    dist.reduce_scatter_tensor(
        out, torch.cat([c.contiguous() for c in chunks], dim=0),
        op=getattr(dist.ReduceOp, str(reduceOp).upper()), group=pg)
    return out


def route_gloo_cuda_collectives() -> None:
    """Ranks on gloo holding CUDA tensors (two ranks sharing one card,
    which NCCL refuses): DTensor's gathers and reduce-scatters go through
    torch's functional collectives, whose wait crashed (a segmentation
    fault in ``wait_tensor``) on gloo's CUDA path in torch 2.11 while
    c10d's ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` and the
    functional all-reduce worked. Route those two through c10d,
    synchronously. Installed once by ``make_mesh`` for a CUDA mesh on
    gloo; NCCL meshes never take it."""
    import torch.distributed._functional_collectives as funcol

    if getattr(funcol, "_ff_routed", False):
        return
    for name in ("all_gather_tensor", "all_gather_single"):
        if hasattr(funcol, name):
            setattr(funcol, name, _all_gather_c10d)
    funcol.reduce_scatter_tensor = _reduce_scatter_c10d
    funcol._ff_routed = True


def default_mesh(num_devices: Optional[int] = None,
                 device_type: str = "cpu"):
    n = num_devices if num_devices is not None else world_size()
    return make_mesh({"data": n}, device_type)


def mesh_shape_dict(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


class MeshAxis(NamedTuple):
    """One axis of a mesh as this rank sees it (JAX's ``axis_name`` inside
    ``shard_map``): the process group of the ranks that differ from this
    one on that axis only, this rank's index on it (``lax.axis_index``),
    its size, and the global rank of each index (a c10d peer)."""

    name: str
    group: object
    index: int
    size: int
    ranks: Tuple[int, ...]

    def peer(self, index: int) -> int:
        return self.ranks[index % self.size]


def mesh_axis(mesh, name: str) -> MeshAxis:
    """The ``MeshAxis`` of axis ``name`` of ``mesh`` for this rank
    (``DeviceMesh.get_group``)."""
    group = mesh.get_group(name)
    return MeshAxis(name, group, mesh.get_local_rank(name),
                    mesh.size(mesh.mesh_dim_names.index(name)),
                    tuple(dist.get_process_group_ranks(group)))
