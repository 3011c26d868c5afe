"""Pipeline parallelism over a 'pipe' (or search-assigned STAGE) mesh axis
(the JAX package's ``parallel/pipeline.py``).

Every rank of the axis holds ONE stage's parameters (stacked parameters
split on dim 0 over the axis) and microbatches flow from stage to stage by
point-to-point transfers (``parallel.exchange``) to the NEXT stage only
(the backward's cotangents to the previous one). The JAX schedules are
``lax.scan``s in which every device computes on every tick, the bubble
ticks on garbage, because SPMD must; here a stage runs only on the ticks
where it holds a microbatch, so a stage computes ``microbatches`` times a
schedule, and the transfers of a tick are posted together after it.

  * ``gpipe`` / ``pipeline`` — GPipe. The forward runs stage i on
    microbatch j at tick i + j, keeping each microbatch's autograd graph
    (O(microbatches) boundary activations a stage); the last stage's
    outputs are then handed to every stage. The backward (an autograd
    Function's) runs microbatch j's backward at stage i at tick (n - 1 -
    i) + j from the kept graphs, the cotangent of the replicated output
    taken on the last stage only, so stage weights get the serial
    model's gradient and not n times it; the input's gradient lives on
    stage 0 (the caller sums it over the axis).
  * ``pipeline_train_1f1b`` — one-forward-one-backward: forward of
    microbatch j at stage i at tick i + j, its backward at tick 2(n - 1) -
    i + j, recomputing the stage from a stashed INPUT (a ring of min(m,
    2n - 1) inputs: per-stage activation memory O(stages), independent of
    the microbatch count); the last stage seeds the cotangent in the tick
    of the forward.

Constraint (both): every stage keeps the activation's shape.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from flexflow_tpu_torch.parallel import (MeshAxis, axis_all_gather,
                                         axis_all_reduce, axis_broadcast,
                                         exchange, is_dtensor, mesh_axis,
                                         mesh_shape_dict, replicate)


def _exchange_tick(axis: MeshAxis, send_fwd, send_bwd, want_fwd: bool,
                   want_bwd: bool, like):
    """The transfers after one tick: ``send_fwd`` (or None) to the next
    stage, ``send_bwd`` to the previous one; ``want_fwd`` receives the
    next tick's input from the previous stage, ``want_bwd`` its cotangent
    from the next. Returns (input, cotangent), None where not wanted."""
    i, n = axis.index, axis.size
    sends = []
    if send_fwd is not None and i < n - 1:
        sends.append((i + 1, send_fwd))
    if send_bwd is not None and i > 0:
        sends.append((i - 1, send_bwd))
    recvs = []
    if want_fwd and i > 0:
        recvs.append((i - 1, like))
    if want_bwd and i < n - 1:
        recvs.append((i + 1, like))
    got = iter(exchange(axis, sends, recvs) if sends or recvs else [])
    return (next(got) if want_fwd and i > 0 else None,
            next(got) if want_bwd and i < n - 1 else None)


def _live(j: int, m: int) -> bool:
    return 0 <= j < m


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """Gradient sums over microbatches of 16-bit leaves are kept in f32."""
    return (torch.float32 if t.dtype in (torch.bfloat16, torch.float16)
            else t.dtype)


class _GPipe(torch.autograd.Function):
    """GPipe over ``axis`` on this rank's stage parameters and microbatched
    input (m, mb, ...), differentiable in both."""

    @staticmethod
    def forward(ctx, stage_fn, axis: MeshAxis, names, x_mb, *params):
        n, i = axis.size, axis.index
        m = x_mb.shape[0]
        grad = any(ctx.needs_input_grad[3:])
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        tree = dict(zip(names, leaves))
        kept = [None] * m
        outs = torch.empty_like(x_mb)
        buf = None
        for t in range(m + n - 1):
            j, y = t - i, None
            if _live(j, m):
                inp = (x_mb[j] if i == 0 else buf).detach()
                with torch.set_grad_enabled(grad):
                    inp.requires_grad_(grad)
                    y = stage_fn(tree, inp)
                if grad:
                    kept[j] = (inp, y)
                if i == n - 1:
                    outs[j] = y.detach()
                y = y.detach()
            buf, _ = _exchange_tick(axis, y, None, _live(t + 1 - i, m), False,
                                    x_mb[0])
        # the last stage's outputs on every stage
        axis_broadcast(outs, axis, n - 1)
        ctx.args = (axis, kept, leaves, m)
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        axis, kept, leaves, m = ctx.args
        n, i = axis.size, axis.index
        want = [p.requires_grad for p in leaves]
        acc = [torch.zeros(p.shape, dtype=_acc_dtype(p), device=p.device)
               if w else None for p, w in zip(leaves, want)]
        # zeros on the other stages, not None: the caller's sum over the
        # axis is a collective every stage joins
        dx = torch.zeros_like(g_outs) if ctx.needs_input_grad[3] else None
        buf = None
        lag = n - 1 - i
        for t in range(m + n - 1):
            j, dinp = t - lag, None
            if _live(j, m):
                inp, y = kept[j]
                kept[j] = None
                dy = g_outs[j] if i == n - 1 else buf
                srcs = [inp] + [p for p, w in zip(leaves, want) if w]
                gs = torch.autograd.grad(y, srcs, dy.to(y.dtype),
                                         allow_unused=True)
                dinp = gs[0]
                it = iter(gs[1:])
                for k, w in enumerate(want):
                    if w:
                        g = next(it)
                        if g is not None:
                            acc[k] += g.to(acc[k].dtype)
                if dx is not None and i == 0:
                    dx[j] = dinp
            _, buf = _exchange_tick(axis, None, dinp, False,
                                    _live(t + 1 - lag, m), g_outs[0])
        grads = [a.to(p.dtype) if a is not None else None
                 for a, p in zip(acc, leaves)]
        return (None, None, None, dx) + tuple(grads)


def gpipe(stage_fn: Callable, stage_params: Dict[str, torch.Tensor],
          x_mb: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """GPipe over ``axis`` (the JAX ``gpipe_loop`` with ``pipeline``'s
    broadcast): this rank's stage parameters (plain tensors) and the
    (m, mb, ...) microbatched input (plain; only stage 0 reads it) ->
    the (m, mb, ...) outputs of the last stage, on every stage.
    Differentiable: the stage parameters get this stage's gradient, the
    input its gradient on stage 0 (zeros elsewhere)."""
    names = list(stage_params)
    return _GPipe.apply(stage_fn, axis, names, x_mb,
                        *[stage_params[k] for k in names])


def stage_shards(stacked, mesh, axis_name: str):
    """A stacked parameter (leading stage dim) as a DTensor split on dim 0
    over ``axis_name``: a plain tensor (the same on every rank) is split
    (its gradient gathered back whole), a DTensor redistributed."""
    from torch.distributed.tensor import Replicate, Shard

    d = stacked if is_dtensor(stacked) else replicate(stacked, mesh)
    want = [Shard(0) if n == axis_name else Replicate()
            for n in mesh.mesh_dim_names]
    return d if list(d.placements) == want else d.redistribute(mesh, want)


def local_stage(params: Dict, x, axis_name: str):
    """The local tensors ``gpipe`` runs on: each DTensor parameter's shard
    and ``x``'s, with the gradient placements that make their local
    gradients right — a parameter replicated over a mesh dim that splits
    ``x`` gets a partial gradient there; ``x``'s gradient is partial over
    the stage axis (only stage 0 computes it)."""
    from torch.distributed.tensor import Partial

    names = x.device_mesh.mesh_dim_names
    xl = x.to_local(grad_placements=[
        Partial() if n == axis_name else p
        for n, p in zip(names, x.placements)])
    loc = {}
    for k, p in params.items():
        gp = [Partial() if pp.is_replicate() and not px.is_replicate()
              else pp for pp, px in zip(p.placements, x.placements)]
        loc[k] = p.to_local(grad_placements=gp)
    return loc, xl


def gpipe_sharded(stage_fn: Callable, stacked_params: Dict, x,
                  axis_name: str, microbatches: int):
    """GPipe on DTensors, the part ``pipeline`` and the pipelined stack
    share: each stacked parameter split on dim 0 over ``axis_name``
    (``stage_shards``), this rank's rows of ``x`` in ``microbatches``
    microbatches through its stage (``gpipe``), the output a DTensor of
    ``x``'s placements."""
    from torch.distributed.tensor import DTensor

    mesh = x.device_mesh
    loc, xl = local_stage({k: stage_shards(v, mesh, axis_name)
                           for k, v in stacked_params.items()}, x, axis_name)
    rows = xl.shape[0]
    if rows % microbatches:
        raise ValueError(f"{rows} rows a rank do not split into "
                         f"{microbatches} microbatches")
    out = gpipe(stage_fn, loc,
                xl.reshape(microbatches, rows // microbatches, *xl.shape[1:]),
                mesh_axis(mesh, axis_name))
    return DTensor.from_local(out.reshape(xl.shape), mesh, x.placements,
                              run_check=False)


def pipeline(stage_fn: Callable, stacked_params: Dict, x, mesh,
             axis_name: str = "pipe", num_microbatches: Optional[int] = None,
             data_axis: Optional[str] = None):
    """User-facing pipelined apply (the JAX ``pipeline``):
    ``stage_fn(params_i, h) -> h'`` of h's shape; ``stacked_params``
    {name: (stages, ...)} (plain tensors the same on every rank, or
    DTensors); ``x`` (batch, ...) global, the same on every rank. Returns
    the (batch, ...) output on every rank, differentiable in the
    parameters and ``x``. ``data_axis``: a mesh axis the batch is also
    split over (dp x pp: each pipe runs its data slice's rows in
    ``num_microbatches`` microbatches)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape_dict(mesh)
    m = num_microbatches or sizes[axis_name]
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} % microbatches {m}")
    dp = data_axis if data_axis and sizes.get(data_axis, 1) > 1 else None
    xd = replicate(x, mesh)
    if dp:
        xd = xd.redistribute(mesh, [Shard(0) if nm == dp else Replicate()
                                    for nm in mesh.mesh_dim_names])
    out = gpipe_sharded(
        lambda p, h: stage_fn({k: v[0] for k, v in p.items()}, h),
        stacked_params, xd, axis_name, m)
    return out.full_tensor()


def _1f1b_loop(stage_fn, loss_fn, params, x_mb, lab_mb, head_params,
               axis: MeshAxis):
    """This rank's 1F1B schedule (the JAX ``_1f1b_loop``): (stage grads,
    head grads, dx, loss sum), each a microbatch SUM, head grads and the
    loss on the last stage, dx on stage 0 (zeros elsewhere). Forward of
    microbatch j at stage i at tick i + j (without a graph), its backward
    at tick 2(n - 1) - i + j, recomputing the stage from the stashed
    input; a live forward and a live backward never share a stash slot
    (the JAX argument)."""
    n, i = axis.size, axis.index
    m = x_mb.shape[0]
    slots = min(m, 2 * n - 1)
    stash = [None] * slots
    is_last = i == n - 1
    p_leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    h_leaves = {k: v.detach().requires_grad_()
                for k, v in head_params.items()}
    g = {k: torch.zeros(v.shape, dtype=_acc_dtype(v), device=v.device)
         for k, v in params.items()}
    gh = {k: torch.zeros(v.shape, dtype=_acc_dtype(v), device=v.device)
          for k, v in head_params.items()}
    dx = torch.zeros_like(x_mb)
    loss = torch.zeros((), dtype=torch.float32, device=x_mb.device)
    buf_f = buf_b = None
    for t in range(2 * (n - 1) + m):
        jf, jb = t - i, t - (2 * (n - 1) - i)
        y = dy_last = dinp = None
        if _live(jf, m):
            inp = x_mb[jf] if i == 0 else buf_f
            stash[jf % slots] = inp
            with torch.no_grad():
                y = stage_fn(params, inp)
            if is_last:
                yy = y.detach().requires_grad_()
                with torch.enable_grad():
                    lj = loss_fn(yy, lab_mb[jf], h_leaves)
                gs = torch.autograd.grad(lj, [yy] + list(h_leaves.values()),
                                         allow_unused=True)
                dy_last = gs[0]
                for k, gk in zip(h_leaves, gs[1:]):
                    if gk is not None:
                        gh[k] += gk.to(gh[k].dtype)
                loss = loss + lj.detach().float()
        if _live(jb, m):
            inp_b = stash[jb % slots].detach().requires_grad_()
            cot = dy_last if is_last else buf_b
            with torch.enable_grad():
                yb = stage_fn(p_leaves, inp_b)
            gs = torch.autograd.grad(yb, [inp_b] + list(p_leaves.values()),
                                     cot.to(yb.dtype), allow_unused=True)
            dinp = gs[0]
            for k, gk in zip(p_leaves, gs[1:]):
                if gk is not None:
                    g[k] += gk.to(g[k].dtype)
            if i == 0:
                dx[jb] = dinp
        buf_f, buf_b = _exchange_tick(
            axis, y, dinp, _live(t + 1 - i, m),
            _live(t + 1 - (2 * (n - 1) - i), m), x_mb[0])
    return g, gh, dx, loss


def pipeline_train_1f1b(stage_fn: Callable, loss_fn: Callable,
                        stacked_params: Dict, x, labels, mesh,
                        axis_name: str = "pipe",
                        num_microbatches: Optional[int] = None,
                        head_params: Optional[Dict] = None,
                        data_axis: Optional[str] = None):
    """One 1F1B-scheduled pipelined training step (the JAX
    ``pipeline_train_1f1b``). ``stage_fn(params_i, h) -> h'`` of h's
    shape; ``loss_fn(y_mb, labels_mb, head_params) -> scalar`` mean loss
    of one microbatch; ``stacked_params`` {name: (stages, ...)}, ``x``
    (batch, ...), ``labels`` (batch, ...) and ``head_params`` plain
    tensors, the same on every rank.

    Returns (loss, grads, head_grads, dx), each whole on every rank: the
    microbatch-mean loss; grads stacked like ``stacked_params`` and head
    grads, both microbatch SUMS (divide by the microbatch count upstream
    for the mean's); d(loss sum)/dx. With ``data_axis`` each data slice
    pipelines its share of every microbatch and the results are its
    slices' mean (dx of each slice scaled alike), as in JAX."""
    sizes = mesh_shape_dict(mesh)
    axis = mesh_axis(mesh, axis_name)
    n = axis.size
    m = num_microbatches or n
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} % microbatches {m}")
    x_mb = x.reshape(m, b // m, *x.shape[1:])
    lab_mb = labels.reshape(m, b // m, *labels.shape[1:])
    head_params = head_params or {}
    dp = data_axis if data_axis and sizes.get(data_axis, 1) > 1 else None
    if dp:
        dax = mesh_axis(mesh, dp)
        per = x_mb.shape[1] // dax.size
        rows = slice(dax.index * per, (dax.index + 1) * per)
        x_mb, lab_mb = x_mb[:, rows], lab_mb[:, rows]
    params = {k: v[axis.index] for k, v in stacked_params.items()}
    g, gh, dx, loss = _1f1b_loop(stage_fn, loss_fn, params,
                                 x_mb.contiguous(), lab_mb.contiguous(),
                                 head_params, axis)
    gh = {k: axis_all_reduce(v, axis) for k, v in gh.items()}
    dx = axis_all_reduce(dx, axis)
    loss = axis_all_reduce(loss, axis) / m
    if dp:
        nd = dax.size
        g = {k: axis_all_reduce(v, dax) / nd for k, v in g.items()}
        gh = {k: axis_all_reduce(v, dax) / nd for k, v in gh.items()}
        loss = axis_all_reduce(loss, dax) / nd
        dx = axis_all_gather(dx.transpose(0, 1).contiguous(), dax
                             ).transpose(0, 1) / nd
    g = {k: axis_all_gather(v[None], axis).to(stacked_params[k].dtype)
         for k, v in g.items()}
    gh = {k: v.to(head_params[k].dtype) for k, v in gh.items()}
    return loss, g, gh, dx.reshape(b, *x.shape[1:]).to(x.dtype)

