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
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.ffconst import LossType, MetricsType
from flexflow_tpu_torch.ops.base import InputOp
from flexflow_tpu_torch.ops.fused import FusedOp
from flexflow_tpu_torch.runtime.initializer import init_weight
from flexflow_tpu_torch.runtime.loss import compute_loss
from flexflow_tpu_torch.runtime.metrics import batch_metrics

Params = Dict[str, Dict[str, torch.Tensor]]
Batch = Dict[str, torch.Tensor]
State = Dict[str, Dict[str, torch.Tensor]]

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


class GraphExecutor:
    def __init__(self, model):
        self.model = model
        self.input_ops = [op for op in model.ops if isinstance(op, InputOp)]

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
        ``gens`` (training) hands each drawing op its generator."""
        cdt = self.model.compute_dtype
        bf16 = cdt == torch.bfloat16
        state = state or {}
        new_state: State = {}
        vals = {t: (v.to(cdt) if bf16 and v.dtype == torch.float32 else v)
                for t, v in input_values.items()}
        for op in self.model.ops:
            if isinstance(op, InputOp):
                if op.outputs[0] not in vals:
                    raise ValueError(f"missing input value for {op.name}")
                continue
            p = resolve_tied_params(self.model, params, op.name,
                                    params.get(op.name, {}))
            p = {k: (w.to(cdt) if w.is_floating_point() and w.dtype != cdt
                     else w)
                 for k, w in p.items()}
            xs = [vals[t] for t in op.inputs]
            kw = {"gens": gens} if isinstance(op, FusedOp) else {}
            if op.stateful:
                outs, new_state[op.name] = op.forward_stateful(
                    p, state[op.name], xs, training=training, **kw)
            elif kw:
                outs = op.forward(p, xs, training=training, **kw)
            elif op.needs_rng:
                outs = op.forward(p, xs, training=training,
                                  gen=(gens or {}).get(op.name))
            else:
                outs = op.forward(p, xs, training=training)
            for t, v in zip(op.outputs, outs):
                vals[t] = v
        return vals, new_state

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
        loss = compute_loss(loss_type, logits, batch[label_key])
        if training:
            for t in self.model._aux_tensors:   # MoE load-balancing losses
                loss = loss + vals[t]
        mets = batch_metrics(loss_type, metric_types, logits.detach(),
                             batch[label_key])
        return loss, mets, logits, new_state

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
        flat = iter(torch.autograd.grad(target, leaves))
        grads = {op: {k: next(flat) for k in ws} for op, ws in params.items()}
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
        acc = {op: {k: torch.zeros(w.shape, device=w.device,
                                   dtype=torch.float32 if w.dtype in wide
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
        optimizer.update(params, grads, opt_state)
        return loss, mets

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
        grads = {op: {k: g * inv.to(g.dtype) for k, g in ws.items()}
                 for op, ws in grads.items()}
        gnorm_sq = torch.zeros((), dtype=torch.float32, device=scale.device)
        for ws in grads.values():
            for g in ws.values():
                gnorm_sq = gnorm_sq + torch.sum(torch.square(g.float()))
        finite = torch.isfinite(loss) & torch.isfinite(gnorm_sq)
        optimizer.update(params, grads, opt_state, finite=finite)
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
        return [vals[t] for t in finals]


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
    CPU the same step runs as a plain loop."""

    def __init__(self, step_fn, staged: Dict[str, torch.Tensor],
                 capacity: int, generators: Sequence[torch.Generator] = ()):
        self.step_fn = step_fn          # batch -> (loss, metrics)
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

        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._step()              # a real step: one of this run's
        torch.cuda.current_stream(self.device).wait_stream(side)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        if self.generators and not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                "this PyTorch's CUDAGraph cannot register a generator, so a "
                "replayed step would repeat its dropout masks; train this "
                "model with scan_steps=0")
        for g in self.generators:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph, stream=side):
            self._step()              # captured, not run
        after = kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        for fn in kernels.KERNELS:    # the capture launched nothing
            fn.launches -= self.launches[fn.__name__]
        self.graph = graph

    def _replay(self) -> None:
        from flexflow_tpu_torch.ops import kernels

        self.graph.replay()
        self.replays += 1
        for fn in kernels.KERNELS:
            fn.launches += self.launches[fn.__name__]

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
            if self.device.type == "cuda" and self.graph is None:
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
