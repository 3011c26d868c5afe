"""FFModel: the graph builder, the training and the serving entry points
(the JAX package's ``model.py``, the subsets the ported slices run).

The builder verbs append ops to a graph exactly as in the JAX package, so
model builders (``models/llama.py``, ``models/transformer.py``) read the
same. ``compile`` initialises the parameters on the model's device from a
seeded ``torch.Generator``: with an optimizer for training (``fit``,
``evaluate``), without one for serving (``make_serving_engine`` /
``serve`` drive the continuous-batching engine). Training steps one batch
a call (``fit``'s per-step path, ``_run_train_step``) or, with
``FFConfig.scan_steps`` or ``train_scanned``, n steps a dispatch (a CUDA
graph replayed on the card); ``grad_accum_steps``, ``on_nonfinite`` (the
divergence guard) and ``fused_optimizer`` select the step's variants as in
the JAX package. ``predict`` is the label-free forward. The model runs on
the card unless it is built with ``device="cpu"``.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flexflow_tpu_torch._device import resolve_device
from flexflow_tpu_torch.config import FFConfig, check_training_ported
from flexflow_tpu_torch.ffconst import (ActiMode, AggrMode, CompMode, DataType,
                                        LossType, MetricsType, OperatorType)
from flexflow_tpu_torch.ops.attention import MultiHeadAttention
from flexflow_tpu_torch.ops.base import InputOp, Op
from flexflow_tpu_torch.ops.dense import Embedding, Linear
from flexflow_tpu_torch.ops.elementwise import (ElementBinary, ElementUnary,
                                                Mean)
from flexflow_tpu_torch.ops.norm import AddLayerNorm, LayerNorm, RMSNorm
from flexflow_tpu_torch.runtime.executor import GraphExecutor, StepReplay
from flexflow_tpu_torch.runtime.initializer import init_weight
from flexflow_tpu_torch.runtime.loss import loss_type_from_name
from flexflow_tpu_torch.runtime.metrics import PerfMetrics, metrics_from_names
from flexflow_tpu_torch.runtime.optimizer import FusedUpdate
from flexflow_tpu_torch.runtime.resilience import init_guard_state
from flexflow_tpu_torch.tensor import Tensor

Params = Dict[str, Dict[str, torch.Tensor]]

log = logging.getLogger(__name__)


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config or FFConfig()
        self.device = resolve_device(device)
        self.ops: List[Op] = []
        self._op_counters: Dict[str, int] = {}
        self.params: Optional[Params] = None
        self._final_tensor: Optional[Tensor] = None
        # training state (compile with an optimizer)
        self.executor: Optional[GraphExecutor] = None
        self.optimizer = None
        self.opt_state = None
        self.loss_type: Optional[LossType] = None
        self.metric_types: List[MetricsType] = []
        self.comp_mode = CompMode.COMP_MODE_TRAINING
        self.label_tensor: Optional[Tensor] = None
        self._dataloaders: List = []
        self._step_count = 0
        self._last_loss: Optional[torch.Tensor] = None
        self._last_metrics: Dict[str, torch.Tensor] = {}
        self._perf = PerfMetrics()
        # the divergence guard (on_nonfinite): its settings and device state
        self._guard: Optional[Dict] = None
        self._guard_state: Optional[Dict[str, torch.Tensor]] = None
        # the scanned steps' replay, and what it was built over
        self._replay: Optional[StepReplay] = None
        self._replay_key: Optional[tuple] = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.config.compute_dtype == "bfloat16"
                else torch.float32)

    # ------------------------------------------------------------------ graph

    def _name(self, kind: str, name: Optional[str]) -> str:
        if name:
            return name
        n = self._op_counters.get(kind, 0)
        self._op_counters[kind] = n + 1
        return f"{kind}_{n}" if n else kind

    def _add(self, op: Op) -> Union[Tensor, List[Tensor]]:
        if self.get_op_by_name(op.name) is not None:
            raise ValueError(f"duplicate op name {op.name!r} (params key by "
                             f"name)")
        self.ops.append(op)
        return op.outputs[0] if len(op.outputs) == 1 else op.outputs

    def get_op_by_name(self, name: str) -> Optional[Op]:
        for op in self.ops:
            if op.name == name:
                return op
        return None

    def create_tensor(self, dims: Sequence[int],
                      dtype: DataType = DataType.DT_FLOAT,
                      name: Optional[str] = None) -> Tensor:
        if not isinstance(dtype, DataType):
            raise TypeError(
                f"create_tensor dtype must be a DataType enum, got "
                f"{dtype!r} — did you mean name={dtype!r}?")
        op = InputOp(self, self._name("input", name), tuple(dims), dtype)
        op.finalize()
        return self._add(op)

    def dense(self, input: Tensor, out_dim: int,
              activation: ActiMode = ActiMode.AC_MODE_NONE,
              use_bias: bool = True, name: Optional[str] = None) -> Tensor:
        return self._add(Linear(self, self._name("dense", name), [input],
                                out_dim, activation, use_bias))

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: AggrMode = AggrMode.AGGR_MODE_NONE,
                  name: Optional[str] = None) -> Tensor:
        return self._add(Embedding(self, self._name("embedding", name),
                                   [input], num_entries, out_dim, aggr))

    def layer_norm(self, input: Tensor, eps: float = 1e-5,
                   elementwise_affine: bool = True,
                   name: Optional[str] = None) -> Tensor:
        return self._add(LayerNorm(self, self._name("layer_norm", name),
                                   [input], eps, elementwise_affine))

    def add_layer_norm(self, input: Tensor, residual: Tensor,
                       eps: float = 1e-5,
                       name: Optional[str] = None) -> List[Tensor]:
        """Fused (input + residual, LN(input + residual)); returns
        [sum, normed]."""
        return self._add(AddLayerNorm(self, self._name("add_ln", name),
                                      [input, residual], eps))

    def mean(self, input: Tensor, dims: Sequence[int], keepdims: bool = False,
             name: Optional[str] = None) -> Tensor:
        return self._add(Mean(self, self._name("mean", name), [input], dims,
                              keepdims))

    def rms_norm(self, input: Tensor, eps: float = 1e-6,
                 name: Optional[str] = None) -> Tensor:
        return self._add(RMSNorm(self, self._name("rms_norm", name), [input],
                                 eps))

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, dropout: float = 0.0,
                            bias: bool = True, add_bias_kv: bool = False,
                            add_zero_attn: bool = False, causal: bool = False,
                            num_kv_heads: int = 0, rope: bool = False,
                            rope_theta: float = 10000.0,
                            name: Optional[str] = None) -> Tensor:
        return self._add(MultiHeadAttention(
            self, self._name("multihead_attention", name),
            [query, key, value], embed_dim, num_heads, kdim, vdim, dropout,
            bias, add_bias_kv, add_zero_attn, causal,
            num_kv_heads=num_kv_heads, rope=rope, rope_theta=rope_theta))

    def sigmoid(self, x: Tensor, name: Optional[str] = None) -> Tensor:
        return self._add(ElementUnary(self, self._name("sigmoid", name), [x],
                                      OperatorType.OP_SIGMOID))

    def add(self, a: Tensor, b: Tensor, name: Optional[str] = None) -> Tensor:
        return self._add(ElementBinary(self, self._name("ew_add", name),
                                       [a, b], OperatorType.OP_EW_ADD))

    def multiply(self, a: Tensor, b: Tensor,
                 name: Optional[str] = None) -> Tensor:
        return self._add(ElementBinary(self, self._name("ew_mul", name),
                                       [a, b], OperatorType.OP_EW_MUL))

    # -------------------------------------------------------------- compile

    def weight_shapes(self) -> Dict[str, Dict[str, Tuple[int, ...]]]:
        """{op name: {weight name: shape}} of every op that owns weights."""
        return {op.name: {w.name: tuple(w.shape) for w in op.weight_specs()}
                for op in self.ops if op.weight_specs()}

    def compile(self, optimizer=None,
                loss_type: Union[LossType, str] =
                LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics: Sequence = (MetricsType.METRICS_ACCURACY,),
                comp_mode: CompMode = CompMode.COMP_MODE_TRAINING,
                final_tensor: Optional[Tensor] = None):
        """Fix the output tensor and initialise every weight on the model's
        device, drawn from a ``torch.Generator`` seeded with
        ``config.seed``. No strategy search and no lint in the port yet.

        With an optimizer (training): weights in ``config.master_dtype``,
        the loss, the metrics, the label tensor (shaped like the output's
        sample dims; (..., 1) int32 for sparse cross-entropy) and the
        optimizer's state. Without one (serving): weights in the compute
        dtype."""
        if not self.ops:
            raise ValueError("compile() on an empty graph")
        self._final_tensor = final_tensor or self.ops[-1].outputs[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed)
        if optimizer is None:
            dtype = self.compute_dtype
            self.params = {
                op.name: {w.name: init_weight(w, gen, dtype, self.device)
                          for w in op.weight_specs()}
                for op in self.ops if op.weight_specs()}
            return
        cfg = self.config
        check_training_ported(cfg)
        if cfg.fused_optimizer:
            optimizer = FusedUpdate(optimizer)
        self.optimizer = optimizer
        self.loss_type = loss_type_from_name(loss_type)
        self.metric_types = metrics_from_names(metrics)
        self.comp_mode = comp_mode
        fdims = self._final_tensor.dims
        if self.loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
            self.label_tensor = Tensor(dims=tuple(fdims[:-1]) + (1,),
                                       dtype=DataType.DT_INT32, name="label")
        else:
            self.label_tensor = Tensor(dims=fdims, dtype=DataType.DT_FLOAT,
                                       name="label")
        self.executor = GraphExecutor(self)
        self.params = self.executor.init_params(gen)
        self.opt_state = optimizer.init_state(self.params)
        self._guard = self._guard_state = None
        self._replay = self._replay_key = None
        if cfg.on_nonfinite != "none":
            if cfg.grad_accum_steps > 1:
                log.warning("on_nonfinite=%r: divergence guard unsupported "
                            "under grad accumulation — training runs "
                            "unguarded", cfg.on_nonfinite)
            else:
                self._guard = {"on_nonfinite": cfg.on_nonfinite,
                               "growth_interval":
                                   cfg.loss_scale_growth_interval}
                self._guard_state = init_guard_state(cfg.loss_scale,
                                                     self.device)

    # ------------------------------------------------------------- training

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(
                    v, torch.Tensor) else v).to(self.device)
                for k, v in batch.items()}

    def _stage_batch(self) -> Dict[str, torch.Tensor]:
        return {dl.name: dl.next_batch() for dl in self._dataloaders}

    def _reset_dataloaders(self):
        for dl in self._dataloaders:
            dl.reset()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self, batch: Dict[str, torch.Tensor]):
        """The unguarded step on a device batch: (loss, metrics)."""
        return self.executor.train_step(
            self.params, self.opt_state, batch, self.optimizer,
            self.loss_type, self.metric_types, self._final_tensor)

    def _run_train_step(self, batch, inject_nan: bool = False):
        """One forward + backward + update on ``batch`` ({input name or
        "label": array or tensor}); returns (loss, metrics) as device
        scalars. Under the divergence guard (``on_nonfinite``) the guarded
        step runs; ``inject_nan`` adds NaN to its loss (the fault hook,
        which needs the guard)."""
        if self.optimizer is None:
            raise RuntimeError("compile() with an optimizer first")
        batch = self._to_device(batch)
        if self._guard is not None:
            loss, mets = self.executor.guarded_train_step(
                self.params, self.opt_state, batch, self.optimizer,
                self.loss_type, self.metric_types, self._final_tensor,
                self._guard, self._guard_state, inject_nan=inject_nan)
        else:
            if inject_nan:
                raise RuntimeError(
                    "nan_loss injection needs the divergence guard: set "
                    "FFConfig.on_nonfinite before compile()")
            loss, mets = self._step(batch)
        self._step_count += 1
        self._last_loss = loss
        self._last_metrics = mets
        return loss, mets

    def _scan_eligible(self) -> bool:
        """Scanned steps need an optimizer, no divergence guard (a guarded
        fit stays per-step, or a non-finite step inside a chunk would
        commit), loaders of one batch count (the scan has one batch
        index), and every loader staged (num_batches, batch, ...)."""
        return (self.optimizer is not None and self._guard is None
                and bool(self._dataloaders)
                and len({dl.num_batches for dl in self._dataloaders}) == 1
                and all(dl._try_stage_on_device()
                        for dl in self._dataloaders))

    def train_scanned(self, n_steps: int):
        """Run ``n_steps`` training steps a dispatch over the staged
        dataset (``executor.StepReplay``: on the card, one step captured as
        a CUDA graph and replayed). Losses and metrics come back stacked,
        shape (n_steps,). Batch order and wrap follow the per-step path,
        and the loaders' cursors move as if the steps ran one by one."""
        if n_steps < 1:
            raise ValueError(f"train_scanned: n_steps={n_steps} (>= 1)")
        if not self._scan_eligible():
            raise RuntimeError(
                "train_scanned needs compile() with an optimizer, no "
                "divergence guard, and dataloaders of equal batch counts "
                "holding at least one full batch")
        staged = {dl.name: dl._dev_data for dl in self._dataloaders}
        key = tuple((k, v.data_ptr(), tuple(v.shape))
                    for k, v in staged.items()) + tuple(
            t.data_ptr() for t in self._state_leaves())
        if self._replay is None or self._replay_key != key:
            self._replay = StepReplay(self._step, staged,
                                      max(n_steps, self.config.scan_steps))
            self._replay_key = key
        nb = min(dl.num_batches for dl in self._dataloaders)
        first = self._dataloaders[0]
        start = (first.next_index // first.batch_size) % nb
        losses, mets = self._replay.run(start, n_steps)
        for dl in self._dataloaders:     # keep the per-step verbs in sync
            dl.next_index = ((start + n_steps) % nb) * dl.batch_size
        self._step_count += n_steps
        self._last_loss = losses[-1]
        self._last_metrics = {k: v[-1] for k, v in mets.items()}
        return losses, mets

    def _state_leaves(self) -> List[torch.Tensor]:
        """Weights and optimizer state: what a captured step updates in
        place (a change of any of them invalidates the capture)."""
        out = [w for ws in self.params.values() for w in ws.values()]
        todo = [self.opt_state]
        while todo:
            x = todo.pop()
            if isinstance(x, dict):
                todo.extend(x.values())
            elif isinstance(x, torch.Tensor):
                out.append(x)
        return out

    def fit(self, epochs: Optional[int] = None,
            batch_size: Optional[int] = None, verbose: bool = True):
        """Training loop over the attached ``SingleDataLoader``s (the JAX
        ``fit``): one step a batch, or with ``config.scan_steps`` > 0 (and
        the scan eligible) chunks of up to ``scan_steps`` steps a dispatch
        (``train_scanned``), the epoch's ragged tail one step at a time.
        Prints an ``epoch N: loss=...`` line per epoch and a final
        ``THROUGHPUT = ... samples/s`` line. The first step or chunk (and
        any kernel build or graph capture it triggers) is kept out of the
        throughput window, as in the JAX package."""
        if self.optimizer is None:
            raise RuntimeError("compile() with an optimizer first")
        if not self._dataloaders:
            raise RuntimeError("no dataloaders attached; create "
                               "SingleDataLoader(ff, tensor, data)")
        epochs = epochs or self.config.epochs
        bs = batch_size or self.config.batch_size
        if batch_size is not None:
            for dl in self._dataloaders:
                dl.batch_size = batch_size
        num_batches = min(dl.num_batches for dl in self._dataloaders)
        if num_batches <= 0:
            raise ValueError(
                f"dataset smaller than batch_size ("
                f"{min(dl.num_samples for dl in self._dataloaders)} samples "
                f"< {bs}); no full batch to train on")
        chunk_max = self.config.scan_steps
        use_scan = chunk_max > 0 and self._scan_eligible()
        t0 = time.time()
        warm = None
        total = 0
        for epoch in range(epochs):
            self._perf = PerfMetrics()
            self._reset_dataloaders()
            # (metrics, steps): device scalars for a step, (n,) stacks for
            # a scanned chunk; converted once per epoch
            epoch_mets = []
            it = 0
            while it < num_batches:
                if use_scan and num_batches - it >= chunk_max:
                    n = chunk_max
                    _, mets = self.train_scanned(n)
                else:
                    n = 1
                    _, mets = self._run_train_step(self._stage_batch())
                epoch_mets.append((mets, n))
                it += n
                total += bs * n
                if warm is None:
                    float(self._last_loss)   # waits for the first step
                    warm = time.time()
                    total = 0
            for mets, n in epoch_mets:
                vals = {k: v.cpu() for k, v in mets.items()}
                for j in range(n):
                    self._perf.update({k: float(v[j] if v.dim() else v)
                                       for k, v in vals.items()}, bs)
            if verbose:
                print(f"epoch {epoch}: loss={float(self._last_loss):.4f} "
                      + self._perf.report(self.loss_type, self.metric_types))
        self._sync()
        elapsed = time.time() - (warm or t0)
        if total and elapsed > 0 and verbose:
            print(f"epochs {epochs}, ELAPSED TIME = {elapsed:.4f}s, "
                  f"THROUGHPUT = {total / elapsed:.2f} samples/s")
        return self._perf

    def evaluate(self, batch):
        """(loss, metrics, logits) of one batch without a gradient."""
        if self.executor is None:
            raise RuntimeError("compile() with an optimizer first")
        loss, mets, logits = self.executor.eval_step(
            self.params, self._to_device(batch), self.loss_type,
            self.metric_types, self._final_tensor)
        return float(loss), {k: float(v) for k, v in mets.items()}, logits

    def predict(self, batch):
        """Label-free inference: the output of the final tensor for
        ``batch`` ({input name: array or tensor}), forward only."""
        if self.params is None:
            raise RuntimeError("compile() first")
        executor = self.executor or GraphExecutor(self)
        return executor.forward(self.params, self._to_device(batch),
                                [self._final_tensor])[0]

    # -------------------------------------------------------------- serving

    def make_serving_engine(self, **kwargs):
        """Continuous-batching serving engine (runtime/serving.py): a paged
        KV pool shared by ``serve_slots`` decode slots under the radix
        prefix cache; the host scheduler admits queued prompts into free
        slots and retires rows on eos or length. Knobs default to this
        model's FFConfig; kwargs override them per engine (see
        ServingEngine), among them ``prefix_cache``, ``kv_cache_dtype``
        ('native', 'bf16', 'int8', 'fp8') and ``weight_dtype`` ('native',
        'int8', 'fp8')."""
        from flexflow_tpu_torch.runtime.serving import ServingEngine

        return ServingEngine(self, **kwargs)

    def serve(self, prompts, max_new_tokens: int = 32, **kwargs):
        """One-shot serve: run ``prompts`` (1-D int token arrays, any mix
        of lengths) to completion and return (outputs, stats) —
        outputs[i] is prompt + generated tokens for prompts[i] (None for a
        failed request), stats the engine's summary."""
        eng = self.make_serving_engine(**kwargs)
        reqs = eng.run(prompts, max_new_tokens=max_new_tokens)
        outs = [r.output if r.state == "done" else None for r in reqs]
        return outs, eng.stats()
