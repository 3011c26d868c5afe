"""Profiling and tracing (the JAX package's ``runtime/profiler.py``), on
``torch.profiler`` and CUDA events.

The reference times each op with CUDA events behind ``--profiling``
(linear.cu:526-553), dumps the simulator's task graph as DOT
(``--taskgraph``) and writes Legion profiles. The port's counterparts:

  * in-situ attribution: under ``FFConfig.profiling`` or a running
    ``torch.profiler`` the executor runs each op inside
    ``record_function(op.name)`` (the JAX ``named_scope``), so
    ``in_situ_op_summary`` gives every kernel of the PRODUCTION step to
    its op — forward kernels by the op range they ran in, backward ones
    by the autograd node the op's forward created (its sequence number);
  * ``profile_step``: the forward op by op, each timed alone;
  * ``step_phase_breakdown``: the full step and the optimizer update
    alone, timed on clones of the model's state, and the collective
    kernels of a profiled step;
  * ``torch_trace``: a Chrome trace of whatever runs inside it;
  * ``export_taskgraph``: the op graph as Graphviz DOT, the JAX text.

The model's weights, optimizer state, BatchNorm state, generators and
guard state are left bitwise as they were by every function here.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch

from flexflow_tpu_torch.config import ROADMAP_SEARCH, not_ported
from flexflow_tpu_torch.ops.base import InputOp
from flexflow_tpu_torch.runtime.executor import GraphExecutor


def _timed_ms(device: torch.device, fn: Callable, iters: int) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` runs after one warm
    run: CUDA events on the card (device time, the host's launch time
    hidden behind the queue), the wall clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


@contextlib.contextmanager
def _scratch_state(model):
    """Clones of the model's training state, swapped in for the model's
    own for the length of the block: (params, opt_state, guard state).
    BatchNorm state and the drawing ops' generators, which the step reads
    from the model, are clones too inside the block."""
    bn, gens = model.bn_state, model._generators
    model.bn_state = _clone(bn)
    model._generators = {}
    for name, g in gens.items():
        c = torch.Generator(device=g.device)
        c.set_state(g.get_state())
        model._generators[name] = c
    try:
        yield (_clone(model.params), _clone(model.opt_state),
               _clone(model._guard_state))
    finally:
        model.bn_state, model._generators = bn, gens


def _step_fn(model, batch, params, opt_state, guard_state) -> Callable:
    """The production train step (guarded when the model is) on the given
    state."""
    ex = model.executor
    args = (model.optimizer, model.loss_type, model.metric_types,
            model._final_tensor)
    if model._guard is not None:
        return lambda: ex.guarded_train_step(params, opt_state, batch, *args,
                                             model._guard, guard_state)
    return lambda: ex.train_step(params, opt_state, batch, *args)


def _batch(model, batch):
    if batch is None:
        batch = model._current_batch or model._stage_batch()
    return model.executor.shard_batch(batch)


def profile_step(model, batch: Dict, iters: int = 3) -> List[dict]:
    """Run the forward graph op by op (eval mode, each op alone) and time
    each. Returns [{op, type, ms, output_shape}], costliest first."""
    ex = model.executor or GraphExecutor(model)
    dev = ex.shard_batch(batch)
    cdt = model.compute_dtype
    vals = {}
    for op in model.ops:
        if isinstance(op, InputOp) and op.name in dev:
            v = dev[op.name]
            vals[op.outputs[0]] = (v.to(cdt) if cdt == torch.bfloat16
                                   and v.dtype == torch.float32 else v)
    rows = []
    with torch.no_grad():
        for op in model.ops:
            if isinstance(op, InputOp):
                continue
            xs = [vals[t] for t in op.inputs]
            out = {}

            def run():
                out["v"] = ex.run_op(op, model.params, xs, False,
                                     model.bn_state)[0]

            ms = _timed_ms(model.device, run, iters)
            for t, v in zip(op.outputs, out["v"]):
                vals[t] = v
            rows.append({"op": op.name, "type": type(op).__name__,
                         "ms": ms, "output_shape": op.outputs[0].dims})
    rows.sort(key=lambda r: -r["ms"])
    return rows


def _descendants(ev):
    todo = list(ev.cpu_children)
    while todo:
        e = todo.pop()
        yield e
        todo.extend(e.cpu_children)


def _work(ev, on_card: bool):
    """(launches, device ms) under a profiler event: its device kernels
    on the card; on the CPU its leaf operator calls (no device time)."""
    if on_card:
        ks = [k for e in [ev, *_descendants(ev)] for k in e.kernels]
        return len(ks), sum(k.duration for k in ks) / 1e3
    return sum(1 for e in _descendants(ev) if not e.cpu_children), 0.0


def in_situ_op_summary(model, batch: Optional[Dict] = None,
                       totals: Optional[Dict[str, float]] = None
                       ) -> List[dict]:
    """Per-op breakdown of the PRODUCTION train step, run once under
    ``torch.profiler`` on clones of the model's state (which stays as it
    was). A forward kernel belongs to the op whose ``record_function``
    range it ran in; a backward one to the op whose forward created the
    autograd node that launched it. Rows ``{op, fwd_instructions,
    bwd_instructions, fwd_ms, bwd_ms}``, heaviest first: kernel launches
    and their device milliseconds on the card; on the CPU leaf operator
    calls, and no device time. ``totals`` (a dict) receives the step's
    kernel milliseconds (``kernel_ms``, summed), its device-busy
    milliseconds (``device_ms``, the union of the device's intervals) and
    the part of the kernel time the rows hold (``attributed_ms``)."""
    from torch.profiler import ProfilerActivity, profile

    batch = _batch(model, batch)
    on_card = model.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    names = {op.name for op in model.ops}
    with _scratch_state(model) as (params, opt, gs):
        step = _step_fn(model, batch, params, opt, gs)
        step()                       # builds and caches outside the trace
        model._sync()
        with profile(activities=acts) as prof:
            step()
            model._sync()
    fwd: Dict[str, List[float]] = {}
    bwd: Dict[str, List[float]] = {}
    owner: Dict[tuple, str] = {}
    events = prof.events()
    for ev in events:
        if ev.name in names:
            n, ms = _work(ev, on_card)
            acc = fwd.setdefault(ev.name, [0, 0.0])
            acc[0] += n
            acc[1] += ms
            for e in _descendants(ev):
                if e.sequence_nr >= 0:
                    owner.setdefault((e.thread, e.sequence_nr), ev.name)
    for ev in events:
        if not ev.name.startswith("autograd::engine::evaluate_function"):
            continue
        name = owner.get((ev.fwd_thread, ev.sequence_nr))
        if name is None:
            continue
        n, ms = _work(ev, on_card)
        acc = bwd.setdefault(name, [0, 0.0])
        acc[0] += n
        acc[1] += ms
    rows = [{"op": n, "fwd_instructions": fwd.get(n, [0])[0],
             "bwd_instructions": bwd.get(n, [0])[0],
             "fwd_ms": fwd.get(n, [0, 0.0])[1],
             "bwd_ms": bwd.get(n, [0, 0.0])[1]}
            for n in {**fwd, **bwd}]
    rows.sort(key=lambda r: -(r["fwd_instructions"] + r["bwd_instructions"]))
    if totals is not None:
        ks = [k for ev in events for k in ev.kernels]
        totals["kernel_ms"] = sum(k.duration for k in ks) / 1e3
        # the op ranges' own device-side annotations are not device work
        totals["device_ms"] = _union_ms(
            (ev.time_range.start, ev.time_range.end) for ev in events
            if ev.device_type.name == "CUDA"
            and not getattr(ev, "is_user_annotation", False))
        totals["attributed_ms"] = sum(r["fwd_ms"] + r["bwd_ms"]
                                      for r in rows)
    return rows


def _union_ms(spans) -> float:
    """Milliseconds covered by the union of (start, end) microsecond
    intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


#: NCCL kernel name fragments -> the collective kinds of the JAX counts
_NCCL_KINDS = (("AllReduce", "all_reduce"),
               ("ReduceScatter", "reduce_scatter"),
               ("AllGather", "all_gather"), ("AllToAll", "all_to_all"),
               ("SendRecv", "collective_permute"),
               ("Broadcast", "broadcast"))
_DTYPE_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8,
                "int": 4, "long int": 8, "signed char": 1,
                "unsigned char": 1, "bool": 1, "c10::Float8_e4m3fn": 1}


def _shape_elems(shape) -> int:
    if not shape:
        return 0
    if isinstance(shape[0], (list, tuple)):
        return sum(_shape_elems(s) for s in shape)
    n = 1
    for d in shape:
        n *= int(d)
    return n


def collective_stats(events) -> Dict[str, float]:
    """The collective kernels of a profiled step (the JAX counts read
    from HLO text): ``collective_instructions`` (NCCL kernel launches),
    ``collective_bytes`` (the c10d ops' input bytes) and a count per
    kind. Zero on one device."""
    count = 0
    nbytes = 0.0
    per_kind: Dict[str, int] = {}
    for ev in events:
        for k in ev.kernels:
            if "nccl" not in k.name.lower():
                continue
            count += 1
            kind = next((v for frag, v in _NCCL_KINDS if frag in k.name),
                        "other")
            per_kind[kind] = per_kind.get(kind, 0) + 1
        if ev.name.startswith("c10d::"):
            dts = getattr(ev, "input_dtypes", None) or []
            for shape, dt in zip(ev.input_shapes or [], dts):
                nbytes += _shape_elems(shape) * _DTYPE_BYTES.get(dt, 0)
    out: Dict[str, float] = {"collective_instructions": count,
                             "collective_bytes": nbytes}
    for kind, n in per_kind.items():
        out[f"collective_{kind}"] = n
    return out


def step_phase_breakdown(model, batch: Optional[Dict] = None,
                         iters: int = 3) -> Dict[str, float]:
    """Per-step compute / collective / epilogue breakdown of the train
    step:

      * ``device_step_ms`` — the full production step, timed on clones of
        the weights, optimizer, BatchNorm, generator and guard state (the
        JAX package times an undonated re-jit; here too the model's own
        state is bitwise unchanged, so this is safe mid-training);
      * ``epilogue_ms`` / ``epilogue_fraction`` — the optimizer update
        alone on zero gradients (its time does not depend on the values);
      * ``compute_ms`` — the difference;
      * ``collective_instructions`` / ``collective_bytes`` (+ a count per
        kind) — the NCCL kernels of one profiled step (``collective_
        stats``);
      * ``grad_sync_overlapped`` — whether an overlapped gradient sync was
        configured (the port runs on one device: False).

    ``FFModel.step_breakdown`` merges the result into
    ``last_step_breakdown``."""
    from torch.profiler import ProfilerActivity, profile

    if model.optimizer is None:
        raise RuntimeError("compile() with an optimizer first")
    batch = _batch(model, batch)
    dev = model.device
    with _scratch_state(model) as (params, opt, gs):
        step = _step_fn(model, batch, params, opt, gs)
        device_step_ms = _timed_ms(dev, step, iters)
        zeros = {op: {k: torch.zeros_like(w) for k, w in ws.items()}
                 for op, ws in params.items()}
        epilogue_ms = _timed_ms(
            dev, lambda: model.optimizer.update(params, zeros, opt), iters)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.type == "cuda" else [])
        with profile(activities=acts, record_shapes=True) as prof:
            step()
            model._sync()
    rows: Dict[str, float] = {
        "device_step_ms": round(device_step_ms, 4),
        "epilogue_ms": round(epilogue_ms, 4),
        "compute_ms": round(max(device_step_ms - epilogue_ms, 0.0), 4),
        "epilogue_fraction": round(
            min(epilogue_ms / max(device_step_ms, 1e-9), 1.0), 4),
        "grad_sync_overlapped": bool(
            getattr(model.config, "overlap_grad_sync", False)),
    }
    rows.update(collective_stats(prof.events()))
    return rows


@contextlib.contextmanager
def torch_trace(filename: str):
    """A Chrome trace (``torch.profiler``: host ops, and the card's kernels
    when it runs one) of whatever runs inside the context, written to
    ``filename`` — the JAX ``xla_trace``. The ops' ``record_function``
    ranges name the graph's ops on the timeline."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(filename)


def export_taskgraph(model, filename: str):
    """The op graph as Graphviz DOT (the reference's DotFile): the JAX
    text, with no strategy labels (the port runs each op on one
    device)."""
    lines = ["digraph taskgraph {", "  rankdir=LR;"]
    for op in model.ops:
        label = f"{op.name}\\n{type(op).__name__}"
        shape = "box" if isinstance(op, InputOp) else "ellipse"
        lines.append(f'  "{op.name}" [label="{label}", shape={shape}];')
    for op in model.ops:
        for t in op.inputs:
            if t.owner_op is not None:
                lines.append(f'  "{t.owner_op.name}" -> "{op.name}";')
    lines.append("}")
    with open(filename, "w") as f:
        f.write("\n".join(lines))
    return filename


def export_sim_taskgraph(model, filename: str, mesh_shape=None):
    """The simulated schedule as DOT needs the strategy search's
    simulator, which is not ported yet."""
    raise not_ported("export_sim_taskgraph (the simulated schedule)",
                     ROADMAP_SEARCH)
