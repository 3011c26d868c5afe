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
from typing import Dict, Optional

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
    raises too — subsets come with placement (ROADMAP item 9)."""
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
            f"(ROADMAP item 9, placement)")
    if not axes:
        axes, sizes = ["data"], [1]
    return DeviceMesh(device_type, torch.arange(n).reshape(sizes),
                      mesh_dim_names=tuple(axes))


def default_mesh(num_devices: Optional[int] = None,
                 device_type: str = "cpu"):
    n = num_devices if num_devices is not None else world_size()
    return make_mesh({"data": n}, device_type)


def mesh_shape_dict(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
