"""GraphExecutor: interprets the op graph for training and evaluation (the
JAX package's ``runtime/executor.py``, the single-device subset).

The JAX executor jits a fused forward + backward + update program per
step; the port runs the same walk eagerly and takes the gradient with
``torch.autograd``. The step variants follow the JAX executor: gradient
accumulation, the divergence-guarded step, and (``StepReplay``) n steps a
dispatch over the staged dataset — the ``lax.scan`` program's analog, on
the card one step captured as a CUDA graph and replayed. Mixed precision
follows the JAX package: weights are stored in ``FFConfig.master_dtype``
and every op runs in ``FFConfig.compute_dtype`` — inputs and weights are
cast at the start of the walk, so gradients come back in the storage
dtype.

Op state (BatchNorm's running statistics, ``FFModel.bn_state``) stays out
of the weights: never cast, no gradient, read by the walk and replaced by
what the stateful ops return, which a training step commits in place
(``copy_``, so a captured step keeps writing live addresses) — after each
microbatch under accumulation, only on a finite step under the guard.
Evaluation reads it and leaves it. Ops that ``needs_rng`` draw from a
``torch.Generator`` of their own (``init_generators``: seeded from
``FFConfig.seed``, the op's index and its ``seed``, as the JAX executor
folds them into its step key), which their draws advance step by step; a
captured step registers them with its CUDA graph, so every replay draws
anew. Tied weights (``FFModel.tie_weights``) are resolved from their
source's leaf in the walk (``resolve_tied_params``), so both uses'
gradients sum into that leaf. An op may have several outputs (the MoE's
second is its 0-d f32 aux loss, which a training loss adds in every step
variant); a fused group (``ops/fused.py``) runs as one op under its
leader's name, each of its parts that draws from its own generator.

Under a mesh (``FFModel.mesh``: an explicit ``FFConfig.mesh_shape``, or a
world of several ranks) the executor runs the strategy path, the JAX
executor's GSPMD lowering in DTensor terms: every op's ``ParallelConfig``
resolves to an axis map (``resolve_axis_map``; the default data-parallel
on "data", else replicated), the weights are DTensors under their ops'
``weight_partition`` (with ``FFConfig.fsdp_axis``, ``_with_fsdp``), gathered
to it at use, and every op's outputs are redistributed to the placements
of its axis map after it runs (``with_sharding_constraint``'s analog).
Each rank holds the rows of the global batch its "data" coordinate owns;
the loss and the metrics are the global batch's on every rank, so the
guard's verdict and the loss scale agree everywhere. The kernels run on
local shards (``parallel.local_shard``), and the update on each rank's
local shards of the weights, gradients and optimizer state. Nothing of
the single-device path changes when there is no mesh.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.config import ROADMAP_PARALLEL, not_ported
from flexflow_tpu_torch.ffconst import LossType, MetricsType
from flexflow_tpu_torch.ops.base import InputOp
from flexflow_tpu_torch.ops.fused import FusedOp
from flexflow_tpu_torch import parallel
from flexflow_tpu_torch.parallel.pconfig import (CONTRACT, EXPERT, STAGE,
                                                 ParallelConfig)
from flexflow_tpu_torch.runtime.initializer import init_weight
from flexflow_tpu_torch.runtime.loss import compute_loss
from flexflow_tpu_torch.runtime.metrics import batch_metrics

Params = Dict[str, Dict[str, torch.Tensor]]
Batch = Dict[str, torch.Tensor]
State = Dict[str, Dict[str, torch.Tensor]]

log = logging.getLogger(__name__)

_MASK64 = (1 << 64) - 1


def op_generator_seed(seed: int, index: int, op_seed: int = 0) -> int:
    """The seed of the generator of the op at graph ``index``: splitmix64
    of ``FFConfig.seed``, the index and the op's own ``seed`` (the JAX
    executor's ``fold_in(fold_in(step key, index), seed)`` in spirit; its
    threefry bits are not reproduced)."""
    z = 0
    for v in (seed, index, op_seed):
        z = (z + (v & _MASK64) + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1          # manual_seed takes up to 2^63 - 1 here


def tie_transform(w: torch.Tensor, tf: str) -> torch.Tensor:
    """The one definition of a tie's transform ("same" | "transpose")."""
    return w.t() if tf == "transpose" else w


def resolve_tied_params(model, params: Params, op_name: str,
                        p: Dict[str, torch.Tensor], leaf=None
                        ) -> Dict[str, torch.Tensor]:
    """``p`` (``op_name``'s weights) with its tied weights
    (``FFModel.tie_weights``) taken from their source's leaf, transformed
    (the JAX ``resolve_tied_params``). Autograd then sums both uses'
    gradients into the source leaf. ``leaf`` maps the stored source
    before the transform (the serving walk dequantizes there)."""
    out = None
    for (dst_op, dst_w), (src_op, src_w, tf) in model._tied.items():
        if dst_op != op_name:
            continue
        if out is None:
            out = dict(p)
        w = params[src_op][src_w]
        if leaf is not None:
            w = leaf(w)
        out[dst_w] = tie_transform(w, tf)
    return p if out is None else out


def drawing_ops(model):
    """(graph index, op) of every op that draws, fused groups' parts
    included: the index is the op's place in the graph before
    ``apply_fusion`` (``FFModel._graph_index``), so a fused model's ops
    draw what the unfused model's do."""
    index = model._graph_index
    for idx, op in enumerate(model.ops):
        for part in (op.parts() if isinstance(op, FusedOp) else [op]):
            if part.needs_rng:
                yield (index[part.name] if index else idx), part


def resolve_axis_map(pc: ParallelConfig, mesh_shape: Dict[str, int],
                     ndims: int) -> Dict[str, Optional[int]]:
    """The axis map of ``pc`` on a mesh of ``mesh_shape`` for an op whose
    output has ``ndims`` dims (the JAX ``resolve_axis_map``,
    executor.py:33-127): an explicit map is checked against the mesh (an
    axis absent from it, or a dim outside the op's rank, raises; degrees
    recorded for other axis sizes warn and run at the new ones); a
    degrees-only strategy (a reference-written file) is mapped greedily —
    each partitioned dim takes unused mesh axes whose sizes multiply to
    its degree, the sample dim preferring "data"."""
    if pc.axis_map is not None:
        missing = [ax for ax, d in pc.axis_map.items()
                   if d is not None and ax not in mesh_shape]
        if missing:
            raise ValueError(
                f"strategy axis_map references mesh axes {missing} absent "
                f"from this mesh {mesh_shape} — the strategy was "
                f"produced for a different mesh; regenerate it or rename "
                f"the mesh axes")
        bad = {ax: d for ax, d in pc.axis_map.items()
               if d is not None and d not in (CONTRACT, STAGE, EXPERT)
               and not (0 <= d < ndims)}
        if bad:
            raise ValueError(
                f"strategy axis_map entries {bad} map mesh axes to tensor "
                f"dims outside this op's rank {ndims} (valid: 0..{ndims - 1} "
                f"or the CONTRACT/STAGE/EXPERT sentinels) — the @axismap "
                f"record is corrupt or was written for a different operator")
        if pc.dims:
            expect = ParallelConfig.from_axis_map(ndims, mesh_shape,
                                                  pc.axis_map).dims
            if tuple(expect) != tuple(pc.dims):
                log.warning(
                    "strategy axis_map on this mesh gives degrees %s but "
                    "the strategy recorded %s — the mesh axis sizes "
                    "changed since it was written; executing at the NEW "
                    "degrees", tuple(expect), tuple(pc.dims))
        return pc.axis_map
    remaining = dict(mesh_shape)
    axis_map: Dict[str, Optional[int]] = {}
    # a degree list one longer than the output rank carries a trailing
    # CONTRACT degree (the reference's replica dim, linear.cu:171-192)
    targets = list(range(min(ndims, len(pc.dims))))
    if len(pc.dims) == ndims + 1 and pc.dims[ndims] > 1:
        targets.append(ndims)
    for d in sorted(targets, key=lambda d: (d != 0,)):  # sample dim first
        deg = pc.dims[d]
        logical = CONTRACT if d == ndims else d
        if deg == 1:
            continue
        prefs = (["data"] if d == 0 else []) + list(remaining.keys())
        single = [ax for ax in prefs if remaining.get(ax) == deg]
        if single:
            axis_map[single[0]] = logical
            del remaining[single[0]]
            continue
        found = None
        axes = list(remaining.keys())
        for r in range(2, len(axes) + 1):
            for combo in itertools.combinations(axes, r):
                if math.prod(remaining[ax] for ax in combo) == deg:
                    found = combo
                    break
            if found:
                break
        if not found:
            raise ValueError(
                f"strategy degree {deg} on dim {d} not expressible as a "
                f"product of unused mesh axes (mesh {mesh_shape}, "
                f"remaining {remaining})")
        for ax in found:
            axis_map[ax] = logical
            del remaining[ax]
    return axis_map


def _with_fsdp(spec: tuple, shape, axis: str, axis_size: int) -> tuple:
    """FSDP on a weight's spec (``FFConfig.fsdp_axis``; the JAX
    ``_with_fsdp``, executor.py:709-735): its LARGEST still-unsharded dim
    that ``axis_size`` divides is sharded over ``axis`` too (on top of any
    strategy sharding: 2-D weight sharding). Unchanged when the strategy
    already spent the axis on the weight, when nothing divides, or when
    the axis has one device."""
    if shape is None or axis_size <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                used.add(a)
    if axis in used:
        return spec
    best = None
    for d, e in enumerate(entries):
        if e is None and shape[d] % axis_size == 0:
            if best is None or shape[d] > shape[best]:
                best = d
    if best is None:
        return spec
    entries[best] = axis
    return tuple(entries)


def spec_placements(spec: tuple, mesh, shape) -> list:
    """The DTensor placements of a weight of ``shape`` under ``spec`` (one
    entry a dim: None, a mesh-axis name or a tuple of names) on ``mesh``.
    A dim the product of its axes' sizes does not divide stays unsharded
    (the JAX ``shard_entries`` rule): DTensor would shard it unevenly."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = parallel.mesh_shape_dict(mesh)
    by_axis = {}
    for d, e in enumerate(spec):
        axes = e if isinstance(e, tuple) else ((e,) if e else ())
        if axes and shape[d] % math.prod(sizes[a] for a in axes) == 0:
            for a in axes:
                by_axis[a] = d
    return [Shard(by_axis[n]) if n in by_axis else Replicate()
            for n in mesh.mesh_dim_names]


def _refuse_later_strategies(op, am: Dict[str, Optional[int]],
                             mesh_shape: Dict[str, int]) -> None:
    """Strategies of item 9 raise ``not_ported`` naming it instead of
    running: a STAGE (pipeline) or EXPERT axis of more than one device,
    and an attention (or pipelined stack) whose sequence dim is sharded
    (ring / Ulysses attention)."""
    for ax, d in am.items():
        if mesh_shape.get(ax, 1) <= 1:
            continue
        if d in (STAGE, EXPERT):
            raise not_ported(
                f"{op.name}: the {'STAGE' if d == STAGE else 'EXPERT'} "
                f"strategy on mesh axis {ax!r}", ROADMAP_PARALLEL)
        if d is not None and d in op.single_axis_dims():
            raise not_ported(
                f"{op.name}: sharding its sequence dim over {ax!r} (ring / "
                f"Ulysses attention)", ROADMAP_PARALLEL)


def _zeros(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Zeros of ``w``'s shape and device in ``dtype`` (a DTensor's: its
    placements)."""
    if parallel.is_dtensor(w):
        return torch.zeros_like(w, dtype=dtype)
    return torch.zeros(w.shape, device=w.device, dtype=dtype)


class GraphExecutor:
    # the global row count of the batch the walk runs (the strategy path:
    # each rank holds its rows of it); 0: the config's batch size
    batch_rows: int = 0

    def __init__(self, model):
        self.model = model
        self.input_ops = [op for op in model.ops if isinstance(op, InputOp)]
        # the strategy path: the mesh, each op's axis map, and the
        # placements of the weights (stored, and at use)
        self.mesh = getattr(model, "mesh", None)
        self._op_axis_maps: Dict[str, Dict[str, Optional[int]]] = {}
        if self.mesh is not None:
            self.mesh_shape = parallel.mesh_shape_dict(self.mesh)
            self._resolve_strategies()
            self._compute_placements = self._param_placements(fsdp=False)
            self._store_placements = self._param_placements(fsdp=True)

    # ---- strategies (the strategy path) ---------------------------------------

    def _resolve_strategies(self) -> None:
        """Every op's axis map (the JAX ``_resolve_strategies``): its
        ``FFConfig.strategies`` entry, else data-parallel on "data"
        (replicated without a "data" axis)."""
        strategies = self.model.config.strategies
        for op in self.model.ops:
            if isinstance(op, InputOp):
                continue
            nd = op.outputs[0].num_dims
            pc = strategies.get(op.name)
            if pc is None:
                pc = ParallelConfig.data_parallel(
                    nd, self.mesh_shape.get("data", 1))
                if "data" not in self.mesh_shape:
                    pc = ParallelConfig.replicated(nd)
            am = resolve_axis_map(pc, self.mesh_shape, nd)
            _refuse_later_strategies(op, am, self.mesh_shape)
            self._op_axis_maps[op.name] = am

    def op_axis_map(self, op) -> Dict[str, Optional[int]]:
        return self._op_axis_maps.get(op.name, {})

    def op_output_placements(self, op, shape) -> list:
        """The placements an op's output of ``shape`` is redistributed to
        (the JAX ``op_output_sharding``)."""
        return parallel.placements_for(self.mesh, self.op_axis_map(op),
                                       shape)

    def weight_specs(self, fsdp: bool = True) -> Dict[str, Dict[str, tuple]]:
        """{op: {weight: spec}}: each op's ``weight_partition`` under its
        axis map, with ``fsdp_axis`` applied (the JAX
        ``param_shardings``'s specs). A ``fsdp_axis`` that is not a mesh
        axis raises."""
        axis = self.model.config.fsdp_axis if fsdp else ""
        if axis and axis not in self.mesh_shape:
            raise ValueError(f"fsdp_axis={axis!r} is not a mesh axis "
                             f"(mesh {self.mesh_shape})")
        out: Dict[str, Dict[str, tuple]] = {}
        for op in self.model.ops:
            specs = op.weight_specs()
            if not specs:
                continue
            shapes = {w.name: tuple(w.shape) for w in specs}
            wp = op.weight_partition(self.op_axis_map(op))
            out[op.name] = {
                name: (_with_fsdp(sp, shapes.get(name), axis,
                                  self.mesh_shape.get(axis, 1))
                       if axis else sp)
                for name, sp in wp.items()}
        return out

    def _param_placements(self, fsdp: bool) -> Dict[str, Dict[str, list]]:
        shapes = {op.name: {w.name: tuple(w.shape) for w in op.weight_specs()}
                  for op in self.model.ops if op.weight_specs()}
        return {op: {w: spec_placements(sp, self.mesh, shapes[op][w])
                     for w, sp in ws.items()}
                for op, ws in self.weight_specs(fsdp).items()}

    def distribute_params(self, params: Params) -> Params:
        """Full weights (the same on every rank) as DTensors under their
        stored placements: each rank keeps its slice, no collective."""
        from torch.distributed.tensor import DTensor, Replicate

        rep = [Replicate()] * self.mesh.ndim
        out = {}
        for op, ws in params.items():
            pl = self._store_placements[op]
            out[op] = {k: DTensor.from_local(w, self.mesh, rep,
                                             run_check=False).redistribute(
                self.mesh, pl[k]).detach() for k, w in ws.items()}
        return out

    def data_dims(self) -> List[int]:
        """The mesh dims the batch rows are split over: "data"."""
        names = self.mesh.mesh_dim_names
        return [names.index("data")] if "data" in names else []

    def batch_split(self, rows: int) -> bool:
        """Whether a global batch of ``rows`` is split over "data" (the
        axis divides it; the JAX ``input_sharding``), else replicated."""
        dd = self.data_dims()
        return bool(dd) and rows % self.mesh.size(dd[0]) == 0

    def input_placements(self, split: bool) -> list:
        """A batch entry's placements: its rows over "data" when
        ``split``, else replicated."""
        from torch.distributed.tensor import Replicate, Shard

        dd = self.data_dims() if split else []
        return [Shard(0) if i in dd else Replicate()
                for i in range(self.mesh.ndim)]

    def local_rows(self, rows: int) -> Tuple[int, int]:
        """[lo, hi): the rows of a global batch of ``rows`` this rank
        holds (all of them off a mesh, or when "data" does not divide
        them)."""
        if self.mesh is None or not self.batch_split(rows):
            return 0, rows
        dd = self.data_dims()[0]
        n = self.mesh.size(dd)
        c = self.mesh.get_coordinate()[dd]
        return c * rows // n, (c + 1) * rows // n

    def local_batch(self, batch) -> Dict:
        """This rank's rows of a global batch (the batch itself off a
        mesh); the global batch's row count becomes ``batch_rows``."""
        if self.mesh is None:
            return batch
        out = {}
        for k, v in batch.items():
            v = v if hasattr(v, "shape") else np.asarray(v)
            self.batch_rows = v.shape[0]
            lo, hi = self.local_rows(v.shape[0])
            out[k] = v[lo:hi]
        return out

    def _split(self) -> bool:
        return self.batch_split(self.batch_rows
                                or self.model.config.batch_size)

    def _batch_degree(self) -> int:
        """The ranks the batch rows are split over (1: replicated)."""
        return self.mesh.size(self.data_dims()[0]) if self._split() else 1

    # ---- parameters ----------------------------------------------------------

    def init_params(self, gen: torch.Generator) -> Params:
        """Every weight drawn in f32 from ``gen`` on the model's device and
        stored in the master dtype (the JAX ``init_params``: init in f32,
        then cast)."""
        master = (torch.bfloat16 if self.model.config.master_dtype ==
                  "bfloat16" else torch.float32)
        dev = self.model.device
        tied = self.model._tied
        return {op.name: {w.name: init_weight(w, gen, torch.float32,
                                              dev).to(master)
                          for w in op.weight_specs()
                          if (op.name, w.name) not in tied}
                for op in self.model.ops if op.weight_specs()}

    def init_state(self) -> State:
        """Every stateful op's initial state on the model's device."""
        return {op.name: op.init_state(self.model.device)
                for op in self.model.ops if op.stateful}

    def init_generators(self) -> Dict[str, torch.Generator]:
        """A generator on the model's device for every op that draws
        (``needs_rng``), seeded by ``op_generator_seed``."""
        gens = {}
        for idx, op in drawing_ops(self.model):
            g = torch.Generator(device=self.model.device)
            g.manual_seed(op_generator_seed(
                self.model.config.seed, idx, getattr(op, "seed", 0)))
            gens[op.name] = g
        return gens

    # ---- forward interpretation ----------------------------------------------

    def apply_graph(self, params: Params, input_values: Dict, *,
                    training: bool, state: Optional[State] = None,
                    gens: Optional[Dict[str, torch.Generator]] = None
                    ) -> Tuple[Dict, State]:
        """Interpret the graph in order; returns (the tensor -> value map,
        the new state of every stateful op). With a bf16 compute dtype, f32
        inputs are cast to bf16; every floating weight (tied ones resolved
        from their source) is cast to the compute dtype, the state never.
        ``gens`` (training) hands each drawing op its generator.

        On the strategy path (``self.mesh``) the inputs (this rank's rows)
        become DTensors, every op runs on DTensors (plain tensors mixed
        in, such as RoPE tables and masks, count as replicated), and each
        output is redistributed to its op's placements
        (``_constrain_outputs``)."""
        cdt = self.model.compute_dtype
        bf16 = cdt == torch.bfloat16
        state = state or {}
        new_state: State = {}
        vals = {t: (v.to(cdt) if bf16 and v.dtype == torch.float32 else v)
                for t, v in input_values.items()}
        sharded = self.mesh is not None
        replicate = self.replicating()
        if sharded:
            from torch.distributed.tensor import DTensor

            pl = self.input_placements(self._split())
            vals = {t: DTensor.from_local(v, self.mesh, pl, run_check=False)
                    for t, v in vals.items()}
        # named op ranges for the profiler (runtime/profiler.py): under
        # FFConfig.profiling or a running torch.profiler only, so the
        # unprofiled step pays one check a walk
        ranged = (self.model.config.profiling
                  or torch._C._autograd._profiler_enabled())
        with replicate:
            for op in self.model.ops:
                if isinstance(op, InputOp):
                    if op.outputs[0] not in vals:
                        raise ValueError(f"missing input value for "
                                         f"{op.name}")
                    continue
                xs = [vals[t] for t in op.inputs]
                if ranged:
                    with torch.profiler.record_function(op.name):
                        outs, st = self.run_op(op, params, xs, training,
                                               state, gens)
                else:
                    outs, st = self.run_op(op, params, xs, training, state,
                                           gens)
                if st is not None:
                    new_state[op.name] = st
                if sharded:
                    outs = self._constrain_outputs(op, outs)
                for t, v in zip(op.outputs, outs):
                    vals[t] = v
        return vals, new_state

    def replicating(self):
        """Under a mesh, DTensor's ``implicit_replication`` (a plain
        tensor meeting a DTensor counts as replicated); else nothing."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication

        return implicit_replication()

    def _constrain_outputs(self, op, outs) -> list:
        """``op``'s outputs redistributed to its placements (the JAX
        ``with_sharding_constraint``). An output of the primary output's
        rank that a dim of the axis map lies outside raises (the JAX
        executor's rank check, executor.py:325-335)."""
        am = self.op_axis_map(op)
        top = max([d for d in am.values() if d is not None and d >= 0],
                  default=-1)
        res = []
        for i, (t, v) in enumerate(zip(op.outputs, outs)):
            if parallel.is_dtensor(v) and v.dim() == t.num_dims:
                if top < v.dim():
                    want = self.op_output_placements(op, v.shape)
                    if list(v.placements) != want:
                        v = v.redistribute(self.mesh, want)
                elif i == 0:
                    raise ValueError(
                        f"sharding constraint for {op.name!r} shards dim "
                        f"{top} but its output is rank {v.dim()} — the "
                        f"strategy entry does not match this op's output; "
                        f"fix or regenerate the strategy file")
            res.append(v)
        return res

    def constrain_serving(self, op, outs) -> list:
        """A serving walk's ``_constrain_outputs``: ``op``'s outputs
        redistributed to its placements with the batch dim (the slots,
        which every rank serves) left whole — its axis map without the
        entries on dim 0. Without it DTensor's propagation picks the
        activations' layouts from its cost model, which may shard the
        positions over "model" and gather the heads back before
        attention. A Partial output (a row-parallel product) is reduced by
        an all-reduce first, the shards then taken locally: the sums are
        the reduce-scatter's, and gloo's CUDA path has the all-reduce."""
        am = {ax: d for ax, d in self.op_axis_map(op).items() if d != 0}
        res = []
        for t, v in zip(op.outputs, outs):
            if parallel.is_dtensor(v) and v.dim() == t.num_dims:
                want = parallel.placements_for(self.mesh, am, v.shape)
                if list(v.placements) != want:
                    v = parallel.reduce_partial(v)
                if list(v.placements) != want:
                    v = v.redistribute(self.mesh, want)
            res.append(v)
        return res

    def run_op(self, op, params: Params, xs: List[torch.Tensor],
               training: bool, state: Optional[State] = None,
               gens: Optional[Dict[str, torch.Generator]] = None):
        """One op of the walk on its input values ``xs``: (outputs, its
        new state or None). Its weights (tied ones resolved) are cast to
        the compute dtype."""
        cdt = self.model.compute_dtype
        p = resolve_tied_params(self.model, params, op.name,
                                params.get(op.name, {}))
        p = {k: (w.to(cdt) if w.is_floating_point() and w.dtype != cdt
                 else w)
             for k, w in p.items()}
        if self.mesh is not None:
            p = self.at_compute(op.name, p)
        kw = {"gens": gens} if isinstance(op, FusedOp) else {}
        if op.stateful:
            return op.forward_stateful(p, (state or {})[op.name], xs,
                                       training=training, **kw)
        if kw:
            return op.forward(p, xs, training=training, **kw), None
        if op.needs_rng:
            return op.forward(p, xs, training=training,
                              gen=(gens or {}).get(op.name)), None
        return op.forward(p, xs, training=training), None

    def at_compute(self, op_name: str, p: Dict) -> Dict:
        """An op's weights ``p`` gathered to the strategy's layout at use
        (FSDP: the all-gather, its backward the gradient's
        reduce-scatter); those already there as they are."""
        want = self._compute_placements.get(op_name, {})
        return {k: (w.redistribute(self.mesh, want[k])
                    if k in want and list(w.placements) != want[k] else w)
                for k, w in p.items()}

    def shard_batch(self, batch, stream=None) -> Batch:
        """Every entry of ``batch`` on the model's device (the JAX
        ``shard_batch``). A tensor already there passes through with no
        copy; a numpy array or a host tensor is copied — on the card from
        pinned memory with ``non_blocking`` on ``stream`` (the current
        stream when None), from pageable memory synchronously; on the CPU
        it is used in place, as before."""
        dev = self.model.device
        out = {}
        for k, v in batch.items():
            if isinstance(v, torch.Tensor) and v.device == dev:
                out[k] = v
                continue
            t = v if isinstance(v, torch.Tensor) else \
                torch.as_tensor(np.asarray(v), device="cpu")
            if dev.type != "cuda":
                out[k] = t.to(dev)
                continue
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                out[k] = t.to(dev, non_blocking=t.is_pinned())
        return out

    def _input_values(self, batch: Batch) -> Dict:
        return {op.outputs[0]: batch[op.name] for op in self.input_ops}

    def _loss_and_state(self, params: Params, batch: Batch,
                        loss_type: LossType,
                        metric_types: Sequence[MetricsType], final_tensor,
                        training: bool, label_key: str = "label"):
        """(loss, metrics, logits, new state) of one batch — the JAX
        ``_make_loss_fn`` body — on the model's state, drawing from its
        generators in training. A training loss adds every aux tensor
        (``FFModel._aux_tensors``: each MoE's load-balancing loss, a 0-d
        f32 value); evaluation leaves them out, as JAX's eval step
        does."""
        vals, new_state = self.apply_graph(
            params, self._input_values(batch), training=training,
            state=self.model.bn_state,
            gens=self.model._generators if training else None)
        logits = vals[final_tensor]
        if self.mesh is not None:
            return self._global_loss(logits, vals, batch[label_key],
                                     loss_type, metric_types, training) + (
                new_state,)
        loss = compute_loss(loss_type, logits, batch[label_key])
        if training:
            for t in self.model._aux_tensors:   # MoE load-balancing losses
                loss = loss + vals[t]
        mets = batch_metrics(loss_type, metric_types, logits.detach(),
                             batch[label_key],
                             self.model.config.metrics_ignore_index)
        return loss, mets, logits, new_state

    def _global_loss(self, logits, vals, labels, loss_type: LossType,
                     metric_types: Sequence[MetricsType], training: bool):
        """(loss, metrics, logits) of the global batch on every rank (the
        strategy path). The logits are brought to the batch's layout
        (rows over "data", replicated elsewhere); each rank's loss over
        its rows, scaled by its share of them, is summed over the ranks
        holding other rows — the global batch's mean, every loss being a
        mean over rows of equal count a rank. Count metrics
        (``*_count`` / ``*_total``) sum over those ranks, the means
        average, and ``rmse_loss`` averages its square (the mean squared
        error) and takes the root of the global mean. The logits come back
        as the DTensor."""
        import torch.distributed as dist

        deg = self._batch_degree()
        dd = self.data_dims() if deg > 1 else []
        rows = logits.redistribute(self.mesh, self.input_placements(deg > 1))
        mine = rows.to_local()
        loss = compute_loss(loss_type, mine, labels)
        if deg > 1:
            loss = parallel.sum_over(loss / deg, self.mesh, dd, root=True)
        if training:
            for t in self.model._aux_tensors:
                loss = loss + parallel.full_tensor(vals[t])
        mets = batch_metrics(loss_type, metric_types, mine.detach(), labels,
                             self.model.config.metrics_ignore_index)
        if deg > 1 and mets:
            keys = sorted(mets)
            flat = torch.stack([mets[k].double() ** 2 if k == "rmse_loss"
                                else mets[k].double() for k in keys])
            for i in dd:
                dist.all_reduce(flat, group=self.mesh.get_group(i))
            glob = {k: (flat[j] if k.endswith(("_count", "_total"))
                        else flat[j] / deg) for j, k in enumerate(keys)}
            if "rmse_loss" in glob:
                glob["rmse_loss"] = glob["rmse_loss"].sqrt()
            mets = {k: v.to(mets[k].dtype) for k, v in glob.items()}
        return loss, mets, logits

    def loss_and_metrics(self, params: Params, batch: Batch,
                         loss_type: LossType,
                         metric_types: Sequence[MetricsType], final_tensor,
                         *, training: bool, label_key: str = "label"
                         ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """(loss, metrics, logits) of one batch; the model's state is read
        and left as it is."""
        return self._loss_and_state(params, batch, loss_type, metric_types,
                                    final_tensor, training, label_key)[:3]

    def commit_state(self, new_state: State,
                     finite: Optional[torch.Tensor] = None) -> None:
        """Write ``new_state`` into the model's state in place — where
        ``finite`` (a 0-dim bool tensor) is true, else keep the old bits
        (the guard's ``jnp.where`` per state leaf)."""
        with torch.no_grad():
            for op, ws in new_state.items():
                for k, v in ws.items():
                    old = self.model.bn_state[op][k]
                    if v is old:
                        continue
                    old.copy_(v if finite is None
                              else torch.where(finite, v, old))

    # ---- steps ---------------------------------------------------------------

    def _loss_and_grads(self, params: Params, batch: Batch,
                        loss_type: LossType,
                        metric_types: Sequence[MetricsType], final_tensor,
                        scale: Optional[torch.Tensor] = None,
                        inject_nan: bool = False
                        ) -> Tuple[torch.Tensor, Dict, Params, State]:
        """(loss, metrics, grads, new state) of one training batch; the
        state is not committed. With ``scale`` (a 0-dim f32 tensor) the
        gradient is taken of loss * scale; ``inject_nan`` adds NaN to the
        loss (the guard's fault hook)."""
        leaves: List[torch.Tensor] = [w for ws in params.values()
                                      for w in ws.values()]
        for w in leaves:
            w.requires_grad_(True)
        loss, mets, _, new_state = self._loss_and_state(
            params, batch, loss_type, metric_types, final_tensor, True)
        if inject_nan:
            loss = loss + float("nan")
        target = loss if scale is None else loss * scale
        # the backward meets the plain tensors the forward mixed in (RoPE
        # tables, masks) again: as replicated, as in the forward
        with self.replicating():
            flat = iter(torch.autograd.grad(target, leaves))
        grads = {op: {k: next(flat) for k in ws} for op, ws in params.items()}
        if self.mesh is not None:
            # partial sums over the ranks reduced into the weights'
            # layout (an all-reduce, or FSDP's reduce-scatter)
            grads = {op: {k: (g.redistribute(self.mesh, params[op][k]
                                             .placements)
                              if parallel.is_dtensor(g) else g)
                          for k, g in ws.items()}
                     for op, ws in grads.items()}
        return loss.detach(), mets, grads, new_state

    def _accum_loss_and_grads(self, params: Params, batch: Batch, accum: int,
                              *args) -> Tuple[torch.Tensor, Dict, Params]:
        """Gradient accumulation (the JAX ``accum_step``): the batch splits
        into ``accum`` equal microbatches whose gradients are summed —
        bf16 / f16 ones in an f32 carry — and divided by ``accum``;
        numerically the full-batch step (every loss is a batch mean), at a
        microbatch's activation memory. The loss is the microbatches'
        mean; ``*_count`` / ``*_total`` metrics sum, the others average.
        Each microbatch's state is committed before the next runs (the
        carry of the JAX scan)."""
        for k, v in batch.items():
            if v.shape[0] % accum:
                raise ValueError(
                    f"batch dim {v.shape[0]} of {k!r} not divisible by "
                    f"grad_accum_steps={accum}")
        micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                 for k, v in batch.items()}
        wide = (torch.bfloat16, torch.float16)
        acc = {op: {k: _zeros(w, torch.float32 if w.dtype in wide
                              else w.dtype)
                    for k, w in ws.items()} for op, ws in params.items()}
        losses, all_mets = [], []
        for i in range(accum):
            loss, mets, grads, new_state = self._loss_and_grads(
                params, {k: v[i] for k, v in micro.items()}, *args)
            self.commit_state(new_state)
            for op, ws in acc.items():
                for k, a in ws.items():
                    a.add_(grads[op][k].to(a.dtype))
            del grads
            losses.append(loss)
            all_mets.append(mets)
        grads = {op: {k: a / accum for k, a in ws.items()}
                 for op, ws in acc.items()}
        mets = {k: (torch.stack([m[k] for m in all_mets]).sum()
                    if k.endswith(("_count", "_total"))
                    else torch.stack([m[k] for m in all_mets]).mean())
                for k in all_mets[0]}
        return torch.stack(losses).mean(), mets, grads

    def train_step(self, params: Params, opt_state, batch: Batch, optimizer,
                   loss_type: LossType, metric_types: Sequence[MetricsType],
                   final_tensor) -> Tuple[torch.Tensor, Dict]:
        """Forward, backward and one optimizer update (in place on
        ``params`` and ``opt_state``) — over ``grad_accum_steps``
        microbatches when that is above 1; returns the loss and metrics as
        device scalars. Reads nothing back to the host, so a CUDA graph
        can capture it (``FFModel.train_scanned``)."""
        accum = self.model.config.grad_accum_steps
        args = (loss_type, metric_types, final_tensor)
        if accum > 1:
            loss, mets, grads = self._accum_loss_and_grads(params, batch,
                                                           accum, *args)
        else:
            loss, mets, grads, new_state = self._loss_and_grads(
                params, batch, *args)
            self.commit_state(new_state)
        self._update(optimizer, params, grads, opt_state)
        return loss, mets

    def _mixing(self):
        """On the strategy path, a context in which plain tensors mixed
        with DTensors count as replicated."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication

        return implicit_replication()

    def _update(self, optimizer, params: Params, grads: Params, opt_state,
                finite: Optional[torch.Tensor] = None) -> None:
        """The optimizer's in-place update; on the strategy path on each
        rank's local shards of the weights, gradients and state (the
        update is elementwise: the numbers are the single device's)."""
        if self.mesh is None:
            optimizer.update(params, grads, opt_state, finite=finite)
            return
        optimizer.update(parallel.local_tree(params),
                         parallel.local_tree(grads),
                         parallel.local_tree(opt_state), finite=finite)
        parallel.note_local_call("fused_update")

    def guarded_train_step(self, params: Params, opt_state, batch: Batch,
                           optimizer, loss_type: LossType,
                           metric_types: Sequence[MetricsType], final_tensor,
                           guard: Dict, gstate: Dict[str, torch.Tensor],
                           inject_nan: bool = False
                           ) -> Tuple[torch.Tensor, Dict]:
        """The divergence-guarded step (the JAX
        ``make_guarded_train_step``): the loss is scaled by
        ``gstate["loss_scale"]`` and the gradients unscaled; ``finite`` =
        loss and the f32 global grad-norm² both finite, computed on the
        device; the optimizer writes nothing when it is false, so a
        non-finite step leaves weights, optimizer state and op state
        bitwise untouched. The
        streaks, the loss scale ("backoff": halved on a bad step, doubled
        after ``growth_interval`` good ones, within [2^-14, 2^15]) and the
        skip count update in place on the device: no host sync in the
        step. With loss scale 1.0 and every step finite the trajectory is
        bitwise the unguarded step's. Metrics add ``nonfinite``,
        ``grad_norm``, ``loss_scale`` and ``skipped_total``; the loss
        returned is the raw one."""
        scale = gstate["loss_scale"]
        loss, mets, grads, new_state = self._loss_and_grads(
            params, batch, loss_type, metric_types, final_tensor,
            scale=scale, inject_nan=inject_nan)
        inv = 1.0 / scale
        with self._mixing():
            grads = {op: {k: g * inv.to(g.dtype) for k, g in ws.items()}
                     for op, ws in grads.items()}
        gnorm_sq = torch.zeros((), dtype=torch.float32, device=scale.device)
        for ws in grads.values():
            for g in ws.values():
                # a DTensor's sum is the global one (every rank alike)
                gnorm_sq = gnorm_sq + parallel.full_tensor(
                    torch.sum(torch.square(g.float())))
        finite = torch.isfinite(loss) & torch.isfinite(gnorm_sq)
        self._update(optimizer, params, grads, opt_state, finite)
        self.commit_state(new_state, finite)
        bad = ~finite
        zero = torch.zeros_like(gstate["bad_streak"])
        streak = torch.where(bad, gstate["bad_streak"] + 1, zero)
        good = torch.where(bad, zero, gstate["good_streak"] + 1)
        if guard.get("on_nonfinite", "skip") == "backoff":
            backoff = float(guard.get("backoff", 2.0))
            down = torch.clamp(scale / backoff,
                               min=float(guard.get("min_loss_scale",
                                                   2.0 ** -14)))
            grow = good >= int(guard.get("growth_interval", 200))
            up = torch.where(grow, torch.clamp(
                scale * backoff, max=float(guard.get("max_loss_scale",
                                                     2.0 ** 15))), scale)
            new_scale = torch.where(bad, down, up)
            good = torch.where(grow & ~bad, zero, good)
        else:
            new_scale = scale.clone()
        skipped = gstate["skipped"] + bad.to(torch.int32)
        for k, v in (("bad_streak", streak), ("good_streak", good),
                     ("loss_scale", new_scale), ("skipped", skipped)):
            gstate[k].copy_(v)
        mets = dict(mets)
        mets["nonfinite"] = bad.to(torch.int32)
        mets["grad_norm"] = torch.sqrt(gnorm_sq)
        mets["loss_scale"] = new_scale
        mets["skipped_total"] = skipped
        return loss, mets

    @torch.no_grad()
    def eval_step(self, params: Params, batch: Batch, loss_type: LossType,
                  metric_types: Sequence[MetricsType], final_tensor):
        return self.loss_and_metrics(params, batch, loss_type, metric_types,
                                     final_tensor, training=False)

    @torch.no_grad()
    def forward(self, params: Params, batch: Batch,
                final_tensors: Optional[Sequence] = None) -> List:
        """Plain forward over the graph inputs (inference)."""
        finals = final_tensors or [self.model.ops[-1].outputs[0]]
        vals, _ = self.apply_graph(params, self._input_values(batch),
                                   training=False, state=self.model.bn_state)
        return [parallel.full_tensor(vals[t]) for t in finals]


class StepReplay:
    """n training steps a dispatch over the staged dataset: the port's
    counterpart of the JAX ``make_train_scan`` (one ``lax.scan`` program
    over the pre-batched device-resident data).

    ``staged`` maps each graph input (and "label") to its (num_batches,
    batch, ...) device tensor. The batch index and the slot of the
    per-step output buffers are device tensors advanced by the step
    itself: step i reads batch (start + i) mod num_batches, writes its
    loss and metrics into slot i, so a run returns them stacked (n,).

    On the card one step is captured as a CUDA graph
    (``torch.cuda.graph``) and replayed: the first use runs one real step
    eagerly on a side stream (it builds the kernels and settles the
    allocator), captures the next without running it, and replays the
    graph for the remaining steps. Weights and optimizer state are
    updated in place, so the graph's addresses stay valid; the owner
    rebuilds the replay when they, or the staged data, change. The step's
    generators (``generators``: those of the ops that draw) are registered
    with the graph (``CUDAGraph.register_generator_state``), so each replay
    advances them and draws new masks; a graph replaying one offset would
    repeat the captured step's masks. Launch counters do not tick on a
    replay, so each replay adds the launches its capture recorded (and the
    capture, which launches nothing, takes back what it counted). On the
    CPU — and under a mesh, uncaptured (``capture=False``) — the same step
    runs as a plain loop."""

    def __init__(self, step_fn, staged: Dict[str, torch.Tensor],
                 capacity: int, generators: Sequence[torch.Generator] = (),
                 capture: bool = True):
        self.step_fn = step_fn          # batch -> (loss, metrics)
        # False (a step under a mesh, whose collectives a graph would have
        # to capture too): every step runs eagerly, on the card as well
        self.capture = capture
        self.generators = list(generators)
        self.staged = staged
        self.nb = min(v.shape[0] for v in staged.values())
        dev = next(iter(staged.values())).device
        self.device = dev
        self.capacity = max(1, capacity)
        self.bi = torch.zeros(1, dtype=torch.int64, device=dev)
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.losses: Optional[torch.Tensor] = None
        self.mets: Dict[str, torch.Tensor] = {}
        self.graph = None
        self.launches: Dict[str, int] = {}
        self.replays = 0

    def _step(self) -> None:
        batch = {k: v.index_select(0, self.bi)[0]
                 for k, v in self.staged.items()}
        loss, mets = self.step_fn(batch)
        if self.losses is None:        # the eager first step allocates
            n = self.capacity
            self.losses = torch.zeros(n, dtype=loss.dtype,
                                      device=self.device)
            self.mets = {k: torch.zeros(n, dtype=v.dtype, device=self.device)
                         for k, v in mets.items()}
        self.losses.index_copy_(0, self.slot, loss.detach().reshape(1))
        for k, v in mets.items():
            self.mets[k].index_copy_(0, self.slot, v.reshape(1))
        self.bi.copy_(torch.remainder(self.bi + 1, self.nb))
        self.slot.add_(1)

    def _capture(self) -> None:
        from flexflow_tpu_torch.ops import kernels

        side = kernels.private_stream(self.device, self)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._step()              # a real step: one of this run's
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.generators and not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                "this PyTorch's CUDAGraph cannot register a generator, so a "
                "replayed step would repeat its dropout masks; train this "
                "model with scan_steps=0")
        for g in self.generators:
            graph.register_generator_state(g)
        # captured, not run
        _, self.launches = kernels.capture(graph, side, self._step)
        self.graph = graph

    def _replay(self) -> None:
        from flexflow_tpu_torch.ops import kernels

        self.graph.replay()
        self.replays += 1
        kernels.add_launches(self.launches)

    def run(self, start: int, n: int) -> Tuple[torch.Tensor, Dict]:
        """Steps on batches start, start + 1, ... (mod num_batches);
        returns the losses and metrics stacked (n,)."""
        self.bi.fill_(start % self.nb)
        losses, mets = [], []
        done = 0
        while done < n:
            k = min(n - done, self.capacity)
            self.slot.zero_()
            i = 0
            if (self.capture and self.device.type == "cuda"
                    and self.graph is None):
                self._capture()
                i = 1
            for _ in range(i, k):
                if self.graph is not None:
                    self._replay()
                else:
                    self._step()
            losses.append(self.losses[:k].clone())
            mets.append({key: v[:k].clone() for key, v in self.mets.items()})
            done += k
        return (torch.cat(losses),
                {key: torch.cat([m[key] for m in mets]) for key in mets[0]})
