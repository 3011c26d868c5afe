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

from flexflow_tpu_torch.parallel.mesh import (MeshAxis,  # noqa: F401
                                              default_mesh, make_mesh,
                                              mesh_axis, mesh_shape_dict)
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
    mesh engine's decode step). A DTensor ``x`` sharded on a dim between
    the first and the last (a sequence-parallel activation) multiplies
    each rank's rows locally (``_local_rows_matmul``): flattening would
    need DTensor to gather that dim first."""
    if not (is_dtensor(x) or is_dtensor(w)) or x.dim() < 2:
        return torch.matmul(x, w)
    if is_dtensor(x) and any(p.is_shard() and 0 < p.dim < x.dim() - 1
                             for p in x.placements):
        y = _local_rows_matmul(x, w)
        if y is not None:
            return y
    y = torch.mm(x.reshape(-1, x.shape[-1]), w)
    return y.view(*x.shape[:-1], w.shape[-1])


def _local_rows_matmul(x, w):
    """``x @ w`` on each rank's local shards, for the layouts whose
    product needs no collective: per mesh dim, rows of ``x`` split (``w``
    replicated), ``w`` split on its columns (``x`` replicated: the output
    split on its last dim), both split on the contraction (a partial sum),
    or neither. None for any other layout."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    last = x.dim() - 1
    wpl = (w.placements if is_dtensor(w)
           else [Replicate()] * x.device_mesh.ndim)
    out = []
    for px, pw in zip(x.placements, wpl):
        if px.is_shard() and px.dim < last and pw.is_replicate():
            out.append(px)
        elif px.is_replicate() and pw.is_replicate():
            out.append(Replicate())
        elif px.is_replicate() and pw.is_shard(1):
            out.append(Shard(last))
        elif px.is_shard(last) and pw.is_shard(0):
            out.append(Partial())
        else:
            return None
    return local_shard(torch.matmul, (x, w),
                       (list(x.placements),
                        list(wpl) if is_dtensor(w) else None),
                       "rows_matmul", out_placements=out)


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


# ---- per-axis collectives (ring / Ulysses attention and the pipeline
# schedules) -------------------------------------------------
#
# c10d's point-to-point, all-to-all, all-reduce, all-gather and broadcast
# over one mesh axis's group (the JAX package's ``lax.ppermute``,
# ``lax.all_to_all`` and ``lax.psum`` inside ``shard_map``), the first two
# with their gradients. They go through c10d, never
# ``torch.distributed._functional_collectives`` (whose wait crashed on
# gloo's CUDA path, ``mesh.route_gloo_cuda_collectives``). gloo takes CUDA
# tensors in its collectives but refuses them point to point ("writev:
# Bad address", ranks sharing one card, which NCCL refuses): there
# ``exchange`` stages them through pinned host buffers — chosen from the
# group's backend, and counted (``transport_stats``); an NCCL group sends
# device tensors.

#: bytes this process sent point to point (``exchange``), by all-to-all
#: and by the axis all-reduce / all-gather / broadcast, and of the
#: point-to-point ones
#: those staged through host memory and the calls that staged them
TRANSPORT: Dict[str, int] = collections.Counter()


def transport_stats() -> Dict[str, int]:
    """{"p2p_bytes", "all_to_all_bytes", "reduce_bytes",
    "reduce_scatter_bytes", "all_gather_bytes", "staged_bytes",
    "staged_calls"} since the last ``reset_transport_stats``. The
    reduce-scatters are the gradients' into a Shard placement (FSDP's,
    and ZeRO-1's buckets, ``executor._reduce_grad``), counted at the
    global tensor's bytes; the all-gathers ZeRO-1's updated shards
    (``optimizer.Zero1Update``), at the bytes a rank sends."""
    with _CALLS_LOCK:
        return {k: int(TRANSPORT[k]) for k in
                ("p2p_bytes", "all_to_all_bytes", "reduce_bytes",
                 "reduce_scatter_bytes", "all_gather_bytes",
                 "staged_bytes", "staged_calls")}


def reset_transport_stats() -> None:
    with _CALLS_LOCK:
        TRANSPORT.clear()


def note_transport(kind: str, nbytes: int, staged: bool = False) -> None:
    """Add ``nbytes`` to the ``kind`` entry of ``transport_stats`` (and,
    ``staged``, to the bytes and calls staged through host memory)."""
    with _CALLS_LOCK:
        TRANSPORT[kind] += nbytes
        if staged:
            TRANSPORT["staged_bytes"] += nbytes
            TRANSPORT["staged_calls"] += 1


def host_staged(axis: MeshAxis, device: torch.device) -> bool:
    """Whether point-to-point transfers of tensors on ``device`` cross
    ``axis`` through host memory: CUDA tensors in a gloo group."""
    import torch.distributed as dist

    return device.type == "cuda" and dist.get_backend(axis.group) == "gloo"


def exchange(axis: MeshAxis, sends: Sequence[Tuple[int, torch.Tensor]],
             recvs: Sequence[Tuple[int, torch.Tensor]]) -> list:
    """One round of point-to-point transfers over ``axis``: each
    (index, tensor) of ``sends`` goes to the rank at that index of the
    axis, and each (index, like) of ``recvs`` receives a tensor of
    ``like``'s shape, dtype and device from that index — all posted at
    once (``batch_isend_irecv``), so the order of the ranks' calls cannot
    deadlock, and each peer's messages pair in the order they are listed.
    A transfer to this rank itself is a copy. Returns the received
    tensors in ``recvs``'s order. Every wait is bounded by the group's
    timeout."""
    import torch.distributed as dist

    out = [None] * len(recvs)
    own = [t for i, t in sends if i % axis.size == axis.index]
    ops, landing = [], []
    for i, t in sends:
        if i % axis.size == axis.index:
            continue
        staged = host_staged(axis, t.device)
        if staged:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
        else:
            buf = t.contiguous()
        ops.append(dist.P2POp(dist.isend, buf, axis.peer(i), axis.group))
        note_transport("p2p_bytes", t.numel() * t.element_size(), staged)
    for j, (i, like) in enumerate(recvs):
        if i % axis.size == axis.index:
            out[j] = own.pop(0).clone()
            continue
        buf = (torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
               if host_staged(axis, like.device) else torch.empty_like(
                   like, memory_format=torch.contiguous_format))
        ops.append(dist.P2POp(dist.irecv, buf, axis.peer(i), axis.group))
        landing.append((j, buf, like.device))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    for j, buf, dev in landing:
        out[j] = buf.to(dev)
    return out


def permute(xs: Sequence[torch.Tensor], axis: MeshAxis,
            perm: Sequence[Tuple[int, int]]) -> list:
    """``lax.ppermute`` of each tensor of ``xs`` over ``axis`` (no
    gradient): ``perm`` lists (source, destination) indices; a rank no
    source sends to gets zeros."""
    me = axis.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    got = exchange(axis, [(d, x) for d in dst for x in xs],
                   [(s, x) for s in src for x in xs])
    if not src:
        return [torch.zeros_like(x) for x in xs]
    return got


class _PPermute(torch.autograd.Function):
    """``permute`` with its gradient: the cotangents travel the inverse
    permutation."""

    @staticmethod
    def forward(ctx, axis, perm, *xs):
        ctx.axis, ctx.perm = axis, tuple(perm)
        return tuple(permute(xs, axis, perm))

    @staticmethod
    def backward(ctx, *gs):
        inv = [(d, s) for s, d in ctx.perm]
        return (None, None) + tuple(permute(gs, ctx.axis, inv))


def ppermute(xs, axis: MeshAxis, perm: Sequence[Tuple[int, int]]):
    """Differentiable ``lax.ppermute`` of a tensor or a tuple of tensors
    (one round of transfers for all of them) over ``axis``."""
    single = isinstance(xs, torch.Tensor)
    out = _PPermute.apply(axis, perm, *((xs,) if single else xs))
    return out[0] if single else out


def _all_to_all(x: torch.Tensor, axis: MeshAxis, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    import torch.distributed as dist

    n = axis.size
    if n == 1:
        return x
    inp = torch.stack(torch.chunk(x, n, dim=split_dim)).contiguous()
    note_transport("all_to_all_bytes", inp.numel() * inp.element_size())
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=axis.group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, split_dim, concat_dim)
        return _all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return (_all_to_all(g.contiguous(), axis, concat_dim, split_dim),
                None, None, None)


def all_to_all(x: torch.Tensor, axis: MeshAxis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Differentiable ``lax.all_to_all(x, axis, split_dim, concat_dim,
    tiled=True)``: ``x`` splits into ``axis.size`` chunks along
    ``split_dim``, chunk i goes to index i, and the chunks received are
    concatenated along ``concat_dim`` in index order
    (``all_to_all_single``). Its gradient is the inverse swap."""
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


def axis_all_reduce(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (``lax.psum``; no gradient), on
    every rank of it."""
    import torch.distributed as dist

    if axis.size == 1:
        return x
    buf = x.contiguous().clone()
    note_transport("reduce_bytes", buf.numel() * buf.element_size())
    dist.all_reduce(buf, group=axis.group)
    return buf


def axis_broadcast(x: torch.Tensor, axis: MeshAxis, src: int) -> torch.Tensor:
    """The index ``src``'s ``x`` on every rank of ``axis``, written into
    ``x`` (contiguous) on the others (no gradient)."""
    import torch.distributed as dist

    if axis.size == 1:
        return x
    note_transport("reduce_bytes", x.numel() * x.element_size())
    dist.broadcast(x, src=axis.peer(src), group=axis.group)
    return x


def axis_all_gather(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on dim 0 in index
    order (no gradient)."""
    import torch.distributed as dist

    if axis.size == 1:
        return x
    buf = x.contiguous()
    note_transport("reduce_bytes", buf.numel() * buf.element_size())
    out = buf.new_empty((axis.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, buf, group=axis.group)
    return out
