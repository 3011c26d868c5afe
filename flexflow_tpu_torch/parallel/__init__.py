"""Distribution (the JAX package's ``parallel/``): the mesh, the per-op
``ParallelConfig`` strategies and their files, and the helpers that run
the port's kernels on DTensor shards.

Under a mesh (``FFConfig.mesh_shape``, or a world of several ranks) the
weights are DTensors and every op runs on DTensors, DTensor's sharding
propagation playing the part GSPMD plays in the JAX package. A kernel
cannot take a DTensor (its wrapper raises): ``local_shard`` runs it on
each rank's local shard and wraps the result again under the same
placements — the JAX package's ``shard_map`` around a ``pallas_call``.
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.parallel.mesh import (default_mesh,  # noqa: F401
                                              make_mesh, mesh_shape_dict)
from flexflow_tpu_torch.parallel.pconfig import (CONTRACT,  # noqa: F401
                                                 EXPERT, STAGE,
                                                 ParallelConfig)

#: calls of each kernel wrapper through ``local_shard`` (by the wrapper's
#: name): a main path's run shows its kernels were reached on shards
LOCAL_SHARD_CALLS: Dict[str, int] = collections.Counter()
_CALLS_LOCK = threading.Lock()

_DTENSOR = None


def _dtensor_cls():
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor

        _DTENSOR = DTensor
    return _DTENSOR


def is_dtensor(t) -> bool:
    """``t`` is a DTensor (without importing DTensor for plain tensors:
    the single-device path never pays for it)."""
    return (type(t) is not torch.Tensor and isinstance(t, torch.Tensor)
            and isinstance(t, _dtensor_cls()))


def local(t):
    """The local shard of a DTensor (its storage: in-place writes reach
    the DTensor); any other value as it is."""
    return t._local_tensor if is_dtensor(t) else t


def local_tree(tree):
    """``tree`` (nested dicts / lists) with every DTensor leaf replaced by
    its local shard."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_tree(v) for v in tree)
    return local(tree)


def note_local_call(name: str) -> None:
    with _CALLS_LOCK:
        LOCAL_SHARD_CALLS[name] += 1


def reset_local_calls() -> None:
    with _CALLS_LOCK:
        LOCAL_SHARD_CALLS.clear()


def shard_entries(mesh_shape: Dict[str, int], axis_map, shape,
                  dims: Sequence[int]) -> Dict[int, tuple]:
    """For each tensor dim in ``dims``: the mesh axes the strategy shards
    it over — () when the dim is unsharded or its size is not divisible
    by the product of their sizes (that dim alone degrades to unsharded,
    the rest keeps its parallelism; the JAX ``shard_entries``). Axes of
    size 1 shard nothing."""
    out = {}
    for d in dims:
        axes = [ax for ax, dd in (axis_map or {}).items()
                if dd == d and mesh_shape.get(ax, 1) > 1]
        deg = 1
        for ax in axes:
            deg *= mesh_shape[ax]
        out[d] = tuple(axes) if axes and shape[d] % deg == 0 else ()
    return out


def placements_for(mesh, axis_map, shape) -> list:
    """DTensor placements of a tensor of ``shape`` under ``axis_map`` on
    ``mesh`` (the JAX ``with_sharding_constraint``'s spec): ``Shard(d)`` on
    each mesh dim the map sends to dim d — of one device too, so a mesh of
    one runs the same placements — unless the product of those dims' sizes
    does not divide dim d (then unsharded, as the JAX ``shard_entries``
    degrades it); ``Replicate()`` elsewhere. Sentinel entries (CONTRACT /
    STAGE / EXPERT) shard no dim."""
    from torch.distributed.tensor import Replicate, Shard

    ms = mesh_shape_dict(mesh)
    axis_dim = {}
    for d in range(len(shape)):
        axes = [ax for ax, dd in (axis_map or {}).items() if dd == d]
        deg = 1
        for ax in axes:
            deg *= ms[ax]
        if axes and shape[d] % deg == 0:
            axis_dim.update((ax, d) for ax in axes)
    return [Shard(axis_dim[n]) if n in axis_dim else Replicate()
            for n in mesh.mesh_dim_names]


def keep_shards(placements, dims: Sequence[int]) -> list:
    """``placements`` with every Shard of a dim outside ``dims`` (and
    every Partial) made Replicate: what a kernel that is parallel over
    ``dims`` only can take."""
    from torch.distributed.tensor import Replicate, Shard

    return [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in placements]


def local_shard(fn, args: Sequence, placements: Sequence, name: str,
                out_placements: Optional[Sequence] = None):
    """Run ``fn`` on each rank's local shards: every DTensor in ``args``
    is redistributed to its entry of ``placements`` (None: the arg is not
    a DTensor and passes as it is), taken local, and ``fn``'s tensor
    outputs are wrapped back as DTensors under ``out_placements`` (default
    the first arg's placements). Autograd runs through both conversions,
    so a kernel's backward runs on the same shards. Counts one call of
    ``name`` (``LOCAL_SHARD_CALLS``)."""
    from torch.distributed.tensor import Partial, Replicate

    DTensor = _dtensor_cls()
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    opl = out_placements if out_placements is not None else placements[0]
    loc = []
    for a, pl in zip(args, placements):
        if pl is None:
            loc.append(a)
            continue
        if tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, pl)
        # an input replicated over a mesh dim the output is split over
        # (a weight beside sharded rows) gets a partial gradient a rank
        gp = [Partial() if isinstance(p, Replicate) and not isinstance(
            o, Replicate) else p for p, o in zip(pl, opl)]
        loc.append(a.to_local(grad_placements=gp))
    out = fn(*loc)
    note_local_call(name)

    def wrap(t):
        return DTensor.from_local(t, mesh, opl, run_check=False)

    if isinstance(out, (tuple, list)):
        return type(out)(wrap(t) for t in out)
    return wrap(out)


def reduce_partial(t):
    """A DTensor with its Partial placements reduced (Replicate there),
    its shards kept: a bias added after a row-parallel product must see
    the reduced sum, or it is counted once a rank."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh,
                          [Replicate() if p.is_partial() else p
                           for p in t.placements])


def sum_over(x: torch.Tensor, mesh, mesh_dims: Sequence[int],
             root: bool = False) -> torch.Tensor:
    """The sum of the plain tensor ``x`` over the ranks along
    ``mesh_dims`` (the rest of the mesh left alone), differentiable: the
    all-reduce of a Partial DTensor. Every rank uses the sum on its own
    rows, so its gradient there is a part of the whole, and the backward
    all-reduces it too — unless ``root``: the sum is the loss every rank
    differentiates, whose gradient (1) is the whole on each rank."""
    if not mesh_dims:
        return x
    from torch.distributed.tensor import Partial, Replicate

    DTensor = _dtensor_cls()
    src = [Partial() if i in mesh_dims else Replicate()
           for i in range(mesh.ndim)]
    d = DTensor.from_local(x, mesh, src, run_check=False)
    d = d.redistribute(mesh, [Replicate()] * mesh.ndim)
    return d.to_local() if root else d.to_local(grad_placements=src)


_MASK64 = (1 << 64) - 1


def _mix(seed: int, *vals: int) -> int:
    """splitmix64 of ``seed`` folded with ``vals`` (63 bits)."""
    z = seed & _MASK64
    for v in vals:
        z = (z + (v & _MASK64) + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


def shard_generator(gen: Optional[torch.Generator], mesh, placements):
    """The generator a rank draws a sharded op's mask from: ``gen`` itself
    on the first shard (so a mesh of one draws what one process draws),
    else one of this rank's shard coordinates — the mesh dims the
    placements shard — seeded from ``gen``'s seed and the coordinates,
    made once and advancing step by step as ``gen`` does. Ranks holding
    one shard (replicas over the other mesh dims) draw the same mask;
    ranks holding other rows draw their own."""
    if gen is None:
        return None
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    key = tuple(c if isinstance(p, Shard) else 0
                for c, p in zip(coord, placements))
    if not any(key):
        return gen
    with _CALLS_LOCK:
        shards = _SHARD_GENS.setdefault(gen, {})
        g = shards.get(key)
        if g is None:
            g = shards[key] = torch.Generator(device=gen.device)
            g.manual_seed(_mix(gen.initial_seed(), *key))
    return g


#: an op's generator -> {shard coordinates: its generator}; the shards'
#: generators live as long as the op's
_SHARD_GENS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def full_tensor(t):
    """The global value of a DTensor on every rank; any other value as it
    is."""
    return t.full_tensor() if is_dtensor(t) else t


def rows_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` (..., K) @ ``w`` (K, N): ``torch.matmul``, but on DTensors as
    ``torch.mm`` of the flattened rows, the view back after — the product
    ``matmul`` itself folds to, so the same kernel and bits. DTensor caches
    mm's sharding; in torch 2.11 it re-propagated ``aten.matmul`` through
    fake tensors at every call (~3 ms a call on the card's host, most of a
    mesh engine's decode step)."""
    if not (is_dtensor(x) or is_dtensor(w)) or x.dim() < 2:
        return torch.matmul(x, w)
    y = torch.mm(x.reshape(-1, x.shape[-1]), w)
    return y.view(*x.shape[:-1], w.shape[-1])


def replicate(t, mesh):
    """A plain tensor, the same on every rank, as a DTensor replicated over
    ``mesh`` (no collective)."""
    from torch.distributed.tensor import Replicate

    return _dtensor_cls().from_local(t, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)


def local_slice(shape, mesh, placements) -> Tuple[slice, ...]:
    """The slices of a global tensor of ``shape`` that this rank holds
    under ``placements`` (DTensor's own chunking; a Partial or Replicate
    dim whole)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    lshape, off = compute_local_shape_and_global_offset(
        tuple(shape), mesh, list(placements))
    return tuple(slice(o, o + n) for o, n in zip(off, lshape))


def copy_full_into(dst: torch.Tensor, full: torch.Tensor) -> None:
    """Write the global value ``full`` (a plain tensor on any device, the
    same on every rank) into ``dst`` in place: a DTensor takes its own
    slice into its local shard — no collective, so a memory-mapped
    checkpoint entry is read only where this rank needs it —, a plain
    tensor the whole."""
    if not is_dtensor(dst):
        dst.copy_(full)
        return
    sl = local_slice(dst.shape, dst.device_mesh, dst.placements)
    dst._local_tensor.copy_(full[sl])


class HeadLayout(NamedTuple):
    """The attention heads one rank holds on a serving pass (``head_layout``):
    its q heads ``[q_start, q_start + q_heads)``, the global kv head of
    each kv head its KV caches and pool hold, the indices of those in its
    k / v projection's local heads (None: all of them, in order) and the
    query heads a pooled kv head serves (``group``: kernel 4 maps local q
    head h to pooled kv head h // group)."""

    q_start: int
    q_heads: int
    kv_heads: Tuple[int, ...]
    kv_select: Optional[Tuple[int, ...]]
    group: int

    @property
    def duplicated(self) -> int:
        """kv heads the pool holds more than once (the group-1 layout)."""
        return len(self.kv_heads) - len(set(self.kv_heads))


def head_layout(op, mesh=None, axis_map=None) -> HeadLayout:
    """Which q and kv heads of attention op ``op`` a rank holds under
    ``axis_map`` on ``mesh``, read from the op's ``weight_partition`` (the
    placements of ``wq`` and ``wk``; JAX's GSPMD gives each shard the same
    heads). Three cases:

      * kv heads split with the q heads (the head degree divides
        ``num_kv_heads``): the rank's kv heads, the group unchanged;
      * kv replicated (GQA, the degree does not divide ``num_kv_heads``)
        and the local q heads lining up with whole kv groups (kv heads |
        degree, or whole groups a rank): just the kv heads they read;
      * otherwise (a group straddles two ranks): one kv head a local q
        head, group 1 — the kernels' h // group mapping stays right, at
        the cost of the duplicated heads' bytes.

    Without a mesh: every head."""
    h, kvh = op.num_heads, op.num_kv_heads
    g = h // kvh
    if mesh is None:
        return HeadLayout(0, h, tuple(range(kvh)), None, g)
    from flexflow_tpu_torch.runtime.executor import spec_placements

    wp = op.weight_partition(axis_map or {})

    def heads(name, n):
        shape = (1, n, 1)
        spec = wp.get(name, (None, None, None))
        sl = local_slice(shape, mesh, spec_placements(spec, mesh, shape))
        return sl[1].start, sl[1].stop - sl[1].start

    q0, qn = heads("wq", h)
    k0, kn = heads("wk", kvh)
    if kn < kvh:                      # kv heads split with the q heads
        return HeadLayout(q0, qn, tuple(range(k0, k0 + kn)), None, qn // kn)
    if qn % g == 0 and q0 % g == 0:   # whole groups
        kv = tuple(range(q0 // g, (q0 + qn) // g))
        return HeadLayout(q0, qn, kv, None if len(kv) == kvh else kv, g)
    if g % qn == 0:                   # within one group
        return HeadLayout(q0, qn, (q0 // g,), (q0 // g,), qn)
    kv = tuple(i // g for i in range(q0, q0 + qn))
    return HeadLayout(q0, qn, kv, kv, 1)
