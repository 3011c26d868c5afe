"""FFModel: the graph builder, the training and the serving entry points
(the JAX package's ``model.py``, the subsets the ported slices run).

The builder verbs append ops to a graph exactly as in the JAX package, so
model builders (``models/``: the Llama decoder, the encoder classifier,
the CNN zoo, BERT / GPT, ViT, DLRM) read the same; ``tie_weights`` shares
one stored weight between two ops. ``compile`` initialises the parameters
(and the ops' state, ``bn_state``) on the model's device from a
seeded ``torch.Generator``: with an optimizer for training (``fit``,
``evaluate``), without one for serving (``make_serving_engine`` /
``serve`` drive the continuous-batching engine, ``generate`` /
``generate_seq2seq`` decode with a static KV cache). Training steps one batch
a call (``fit``'s per-step path, ``_run_train_step``) or, with
``FFConfig.scan_steps`` or ``train_scanned``, n steps a dispatch (a CUDA
graph replayed on the card); ``grad_accum_steps``, ``on_nonfinite`` (the
divergence guard) and ``fused_optimizer`` select the step's variants as in
the JAX package. ``predict`` is the label-free forward. The model runs on
the card unless it is built with ``device="cpu"``.

Distribution (the JAX ``compile``'s mesh and strategies): with an
explicit ``FFConfig.mesh_shape``, or in a world of several ranks (the
port's launcher), ``compile`` imports ``import_strategy_file``, builds the
mesh (``self.mesh``, a DeviceMesh) and trains under each op's
``ParallelConfig`` as DTensor placements (``runtime/executor.py``); it
writes ``export_strategy_file``. ``fit`` / ``evaluate`` / ``predict`` then
run on every rank with the GLOBAL batch of ``batch_size``, each rank
holding its "data" rows, and report the global batch's loss and metrics.
Alone and without ``mesh_shape`` the single-device path runs unchanged.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flexflow_tpu_torch._device import resolve_device
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import (ActiMode, AggrMode, CompMode, DataType,
                                        LossType, MetricsType, OperatorType,
                                        PoolType)
from flexflow_tpu_torch.ops.attention import MultiHeadAttention
from flexflow_tpu_torch.ops.base import InputOp, Op
from flexflow_tpu_torch.ops.conv import BatchNorm, Conv2D, Flat, Pool2D
from flexflow_tpu_torch.ops.dense import BatchMatmul, Embedding, Linear
from flexflow_tpu_torch.ops.elementwise import (Cast, ElementBinary,
                                                ElementUnary, Mean)
from flexflow_tpu_torch.ops.fused import apply_fusion
from flexflow_tpu_torch.ops.moe import MoE
from flexflow_tpu_torch.ops.norm import (AddLayerNorm, Dropout, LayerNorm,
                                         RMSNorm, Softmax)
from flexflow_tpu_torch.ops.pipelined import TransformerPipelineStack
from flexflow_tpu_torch.ops.recurrent import GRU, LSTM
from flexflow_tpu_torch.ops.tensor_ops import (Concat, Gather, Pad, Reshape,
                                               Reverse, Split, TopK, Transpose)
from flexflow_tpu_torch.runtime.executor import (GraphExecutor, StepReplay,
                                                 tie_transform)
from flexflow_tpu_torch.runtime.initializer import init_weight
from flexflow_tpu_torch.runtime.loss import loss_type_from_name
from flexflow_tpu_torch.runtime.metrics import PerfMetrics, metrics_from_names
from flexflow_tpu_torch.runtime.optimizer import (FusedUpdate,
                                                  ShardedFusedUpdate,
                                                  Zero1Update)
from flexflow_tpu_torch.runtime.resilience import init_guard_state
from flexflow_tpu_torch import parallel
from flexflow_tpu_torch.parallel.strategy import (load_strategies_from_file,
                                                  save_strategies_to_file)
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
        # second outputs a training loss adds (each MoE's balance loss)
        self._aux_tensors: List[Tensor] = []
        # each op's index before apply_fusion (seeds its generator)
        self._graph_index: Optional[Dict[str, int]] = None
        self.params: Optional[Params] = None
        # (dst op, dst weight) -> (src op, src weight, transform)
        self._tied: Dict[Tuple[str, str], Tuple[str, str, str]] = {}
        # the stateful ops' state ({op: {"mean", "var"}} for BatchNorm) and
        # the drawing ops' generators (executor.init_generators)
        self.bn_state: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._generators: Dict[str, torch.Generator] = {}
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
        # generate()'s and generate_seq2seq()'s generators, by sampling
        # config (``_generators`` holds the drawing ops' torch.Generators)
        self._decoders: Dict[tuple, object] = {}
        # the compile-time elastic decision (runtime/elastic.py) and how
        # the last fit() ended: "completed" | "preempted"
        self._elastic = None
        self.last_fit_status: Optional[str] = None
        # the input pipeline fit runs (runtime/pipeline_loader.py; None
        # outside fit), the batch step_breakdown times, and fit's per-step
        # host_wait / h2d / dispatch / device breakdown
        self._pipeline = None
        self._current_batch: Dict = {}
        self.last_step_breakdown: Optional[Dict[str, float]] = None
        # the DeviceMesh of the strategy path (None: the single-device
        # path), built by compile; True while fit's loaders hand each rank
        # its own rows
        self.mesh = None
        self._loader_rows = False

    @property
    def mesh_shape(self) -> Optional[Dict[str, int]]:
        """{axis: size} of the mesh the model runs on (compiled), else of
        the one its config asks for; None on the single-device path."""
        if self.mesh is not None:
            return parallel.mesh_shape_dict(self.mesh)
        return self.config.mesh_shape

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

    def conv2d(self, input: Tensor, out_channels: int, kernel_h: int,
               kernel_w: int, stride_h: int, stride_w: int, padding_h: int,
               padding_w: int, activation: ActiMode = ActiMode.AC_MODE_NONE,
               groups: int = 1, use_bias: bool = True,
               name: Optional[str] = None) -> Tensor:
        return self._add(Conv2D(self, self._name("conv2d", name), [input],
                                out_channels, kernel_h, kernel_w, stride_h,
                                stride_w, padding_h, padding_w, activation,
                                groups, use_bias))

    def pool2d(self, input: Tensor, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int, padding_w: int,
               pool_type: PoolType = PoolType.POOL_MAX,
               activation: ActiMode = ActiMode.AC_MODE_NONE,
               name: Optional[str] = None) -> Tensor:
        return self._add(Pool2D(self, self._name("pool2d", name), [input],
                                kernel_h, kernel_w, stride_h, stride_w,
                                padding_h, padding_w, pool_type, activation))

    def batch_norm(self, input: Tensor, relu: bool = True,
                   name: Optional[str] = None) -> Tensor:
        return self._add(BatchNorm(self, self._name("batch_norm", name),
                                   [input], relu))

    def batch_matmul(self, a: Tensor, b: Tensor,
                     name: Optional[str] = None) -> Tensor:
        return self._add(BatchMatmul(self, self._name("batch_matmul", name),
                                     [a, b]))

    def flat(self, input: Tensor, name: Optional[str] = None) -> Tensor:
        return self._add(Flat(self, self._name("flat", name), [input]))

    def softmax(self, input: Tensor, axis: int = -1,
                name: Optional[str] = None) -> Tensor:
        return self._add(Softmax(self, self._name("softmax", name), [input],
                                 axis))

    def dropout(self, input: Tensor, rate: float, seed: int = 0,
                name: Optional[str] = None) -> Tensor:
        return self._add(Dropout(self, self._name("dropout", name), [input],
                                 rate, seed))

    def reshape(self, input: Tensor, shape: Sequence[int],
                name: Optional[str] = None) -> Tensor:
        return self._add(Reshape(self, self._name("reshape", name), [input],
                                 shape))

    def transpose(self, input: Tensor, perm: Sequence[int],
                  name: Optional[str] = None) -> Tensor:
        return self._add(Transpose(self, self._name("transpose", name),
                                   [input], perm))

    def reverse(self, input: Tensor, axis: int,
                name: Optional[str] = None) -> Tensor:
        return self._add(Reverse(self, self._name("reverse", name), [input],
                                 axis))

    def concat(self, tensors: Sequence[Tensor], axis: int,
               name: Optional[str] = None) -> Tensor:
        return self._add(Concat(self, self._name("concat", name),
                                list(tensors), axis))

    def split(self, input: Tensor, sizes: Union[int, Sequence[int]],
              axis: int, name: Optional[str] = None) -> List[Tensor]:
        if isinstance(sizes, int):
            d = input.dims[axis]
            if d % sizes:
                raise ValueError(f"split: dim {axis} of {input.dims} does "
                                 f"not divide into {sizes}")
            sizes = [d // sizes] * sizes
        out = self._add(Split(self, self._name("split", name), [input],
                              sizes, axis))
        return out if isinstance(out, list) else [out]

    def topk(self, input: Tensor, k: int, sorted: bool = True,
             name: Optional[str] = None) -> List[Tensor]:
        return self._add(TopK(self, self._name("topk", name), [input], k,
                              sorted))

    def gather(self, input: Tensor, index: Tensor, axis: int,
               name: Optional[str] = None) -> Tensor:
        return self._add(Gather(self, self._name("gather", name),
                                [input, index], axis))

    def cast(self, input: Tensor, dtype: DataType,
             name: Optional[str] = None) -> Tensor:
        return self._add(Cast(self, self._name("cast", name), [input],
                              dtype))

    def pad(self, input: Tensor, pads, value: float = 0.0,
            name: Optional[str] = None) -> Tensor:
        return self._add(Pad(self, self._name("pad", name), [input], pads,
                             value))

    def lstm(self, input: Tensor, hidden_size: int,
             return_sequences: bool = True,
             name: Optional[str] = None) -> Tensor:
        return self._add(LSTM(self, self._name("lstm", name), [input],
                              hidden_size, return_sequences))

    def gru(self, input: Tensor, hidden_size: int,
            return_sequences: bool = True,
            name: Optional[str] = None) -> Tensor:
        return self._add(GRU(self, self._name("gru", name), [input],
                             hidden_size, return_sequences))

    def moe(self, input: Tensor, num_experts: int, hidden_dim: int,
            k: int = 2, capacity_factor: float = 1.25,
            dispatch: str = "auto", name: Optional[str] = None) -> Tensor:
        """Mixture-of-experts FFN. Returns the main output; the
        load-balancing aux loss (the op's second output) is folded into
        the training loss. dispatch: "auto" (dense, through all-to-alls,
        when an "expert" mesh axis splits the experts, else sort-based) |
        "dense" | "sort"."""
        outs = self._add(MoE(self, self._name("moe", name), [input],
                             num_experts, hidden_dim, k, capacity_factor,
                             dispatch=dispatch))
        self._aux_tensors.append(outs[1])
        return outs[0]

    def transformer_pipeline_stack(self, input: Tensor, num_layers: int,
                                   num_heads: int, ffn_mult: int = 4,
                                   causal: bool = False,
                                   num_microbatches: Optional[int] = None,
                                   name: Optional[str] = None) -> Tensor:
        """L identical transformer blocks as one op with stacked (L, ...)
        weights, run layer by layer (ops/pipelined.py; the GPipe path
        under a pipe mesh axis comes with the mesh)."""
        return self._add(TransformerPipelineStack(
            self, self._name("transformer_pipeline_stack", name), [input],
            num_layers, num_heads, ffn_mult, causal, num_microbatches))

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

    # elementwise unary / binary (op names as the JAX builder's)

    def _unary(self, op_type: OperatorType, x: Tensor, name=None,
               scalar=None) -> Tensor:
        kind = op_type.name[3:].lower()
        return self._add(ElementUnary(self, self._name(kind, name), [x],
                                      op_type, scalar))

    def _binary(self, op_type: OperatorType, a: Tensor, b: Tensor,
                name=None) -> Tensor:
        kind = op_type.name[3:].lower()
        return self._add(ElementBinary(self, self._name(kind, name), [a, b],
                                       op_type))

    def exp(self, x, name=None):
        return self._unary(OperatorType.OP_EXP, x, name)

    def sin(self, x, name=None):
        return self._unary(OperatorType.OP_SIN, x, name)

    def cos(self, x, name=None):
        return self._unary(OperatorType.OP_COS, x, name)

    def relu(self, x, name=None):
        return self._unary(OperatorType.OP_RELU, x, name)

    def sigmoid(self, x, name=None):
        return self._unary(OperatorType.OP_SIGMOID, x, name)

    def tanh(self, x, name=None):
        return self._unary(OperatorType.OP_TANH, x, name)

    def elu(self, x, name=None):
        return self._unary(OperatorType.OP_ELU, x, name)

    def gelu(self, x, name=None):
        return self._unary(OperatorType.OP_GELU, x, name)

    def identity(self, x, name=None):
        return self._unary(OperatorType.OP_IDENTITY, x, name)

    def pow(self, x, exponent: float, name=None):
        return self._unary(OperatorType.OP_POW, x, name, scalar=exponent)

    def rsqrt(self, x, name=None):
        return self._unary(OperatorType.OP_RSQRT, x, name)

    def scalar_multiply(self, x, scalar: float, name=None):
        return self._unary(OperatorType.OP_SCALAR_MULTIPLY, x, name,
                           scalar=scalar)

    def add(self, a, b, name=None):
        return self._binary(OperatorType.OP_EW_ADD, a, b, name)

    def subtract(self, a, b, name=None):
        return self._binary(OperatorType.OP_EW_SUB, a, b, name)

    def multiply(self, a, b, name=None):
        return self._binary(OperatorType.OP_EW_MUL, a, b, name)

    def divide(self, a, b, name=None):
        return self._binary(OperatorType.OP_EW_DIV, a, b, name)

    def max(self, a, b, name=None):
        return self._binary(OperatorType.OP_EW_MAX, a, b, name)

    def min(self, a, b, name=None):
        return self._binary(OperatorType.OP_EW_MIN, a, b, name)

    def tie_weights(self, dst_op: str, dst_weight: str, src_op: str,
                    src_weight: str, transform: str = "same"):
        """Share one stored weight between two ops (a tied embedding and
        lm_head): the destination owns no leaf — the optimizer, the fused
        update and ``weight_shapes`` never see it — and the walk takes it
        from the source's leaf (transform "same" or "transpose"), so both
        uses' gradients sum into that one leaf. Call after building both
        ops, before ``compile``. Refuses what the JAX ``tie_weights``
        refuses."""
        if transform not in ("same", "transpose"):
            raise ValueError(f"transform must be 'same' or 'transpose', "
                             f"got {transform!r}")
        if self.params is not None:
            raise ValueError(
                "tie_weights must be called before compile(): the weights "
                "are already built, so a late tie would be ignored")
        s, d = self.get_op_by_name(src_op), self.get_op_by_name(dst_op)
        for nm, op in ((src_op, s), (dst_op, d)):
            if op is None:
                raise ValueError(f"tie_weights: no op named {nm!r}")
        specs_s = {w.name: w for w in s.weight_specs()}
        specs_d = {w.name: w for w in d.weight_specs()}
        if src_weight not in specs_s:
            raise ValueError(f"tie_weights: {src_op!r} has no weight "
                             f"{src_weight!r} (has {list(specs_s)})")
        if dst_weight not in specs_d:
            raise ValueError(f"tie_weights: {dst_op!r} has no weight "
                             f"{dst_weight!r} (has {list(specs_d)})")
        shape_s = tuple(specs_s[src_weight].shape)
        if transform == "transpose":
            shape_s = shape_s[::-1]
        if tuple(specs_d[dst_weight].shape) != shape_s:
            raise ValueError(
                f"tie_weights: shape mismatch — {dst_op}.{dst_weight} is "
                f"{tuple(specs_d[dst_weight].shape)} but {src_op}."
                f"{src_weight} {transform} gives {shape_s}")
        if (src_op, src_weight) in self._tied:
            raise ValueError(
                f"tie_weights: source {src_op}.{src_weight} is itself tied "
                f"— chain ties to the original storage instead")
        if (dst_op, dst_weight) in self._tied:
            prev = self._tied[(dst_op, dst_weight)]
            raise ValueError(
                f"tie_weights: {dst_op}.{dst_weight} is already tied to "
                f"{prev[0]}.{prev[1]}")
        if any((v[0], v[1]) == (dst_op, dst_weight)
               for v in self._tied.values()):
            raise ValueError(
                f"tie_weights: {dst_op}.{dst_weight} is the SOURCE of an "
                f"existing tie; it must keep its storage — reverse the tie "
                f"or chain the other ops to the same source")
        self._tied[(dst_op, dst_weight)] = (src_op, src_weight, transform)

    # -------------------------------------------------------------- compile

    def weight_shapes(self) -> Dict[str, Dict[str, Tuple[int, ...]]]:
        """{op name: {weight name: shape}} of every op that owns weights
        (a tied destination owns none)."""
        return {op.name: {w.name: tuple(w.shape) for w in op.weight_specs()
                          if (op.name, w.name) not in self._tied}
                for op in self.ops if op.weight_specs()}

    def get_weights(self, op_name: str,
                    weight_name: str = "kernel") -> np.ndarray:
        """A weight as a numpy array of its own (a tied one read through
        its source and transform): a copy, so later in-place updates of
        the weight leave it as it was, as the JAX package's immutable
        arrays do."""
        tie = self._tied.get((op_name, weight_name))
        if tie is not None:
            src_op, src_w, tf = tie
            w = tie_transform(self.params[src_op][src_w], tf)
        else:
            w = self.params[op_name][weight_name]
        return parallel.full_tensor(w.detach()).float().cpu().numpy().copy()

    def set_weights(self, op_name: str, weight_name: str, value) -> None:
        """Overwrite a weight in place (its dtype and device kept); a tied
        destination refuses — set its source."""
        tie = self._tied.get((op_name, weight_name))
        if tie is not None:
            raise ValueError(
                f"{op_name}.{weight_name} is tied to {tie[0]}.{tie[1]} — "
                f"set the source weight instead")
        w = self.params[op_name][weight_name]
        value = torch.as_tensor(np.asarray(value)).reshape(w.shape)
        with torch.no_grad():
            # every rank is given the full value and keeps its slice
            parallel.copy_full_into(w, value)

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
        self._build_mesh(optimizer)
        if self.config.perform_fusion:
            # reference: FFModel::apply_fusion (model.cc:1538-1593)
            apply_fusion(self, protected=[self._final_tensor]
                         + self._aux_tensors)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed)
        executor = GraphExecutor(self)
        self.bn_state = executor.init_state()
        if optimizer is None:
            dtype = self.compute_dtype
            self.params = {
                op.name: {w.name: init_weight(w, gen, dtype, self.device)
                          for w in op.weight_specs()
                          if (op.name, w.name) not in self._tied}
                for op in self.ops if op.weight_specs()}
            if self.mesh is not None:
                # the served weights under their placements: each rank
                # keeps its slice of the same full draw
                self.executor = executor
                self.params = executor.distribute_params(self.params)
            return
        cfg = self.config
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
        self.executor = executor
        self.params = self.executor.init_params(gen)
        if self.mesh is not None:
            # every rank draws the same full weights (the same generator),
            # so each keeps its slice: the single device's weights
            self.params = executor.distribute_params(self.params)
            executor.batch_rows = cfg.batch_size
        # the JAX compile's order (model.py:625-628): fuse, then ZeRO-1
        if cfg.fused_optimizer:
            optimizer = self._maybe_fuse_optimizer(optimizer)
        if cfg.overlap_grad_sync:
            optimizer = self._maybe_shard_optimizer(optimizer)
        self.optimizer = optimizer
        self._generators = self.executor.init_generators()
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

    def _maybe_fuse_optimizer(self, opt):
        """``FFConfig.fused_optimizer`` (the JAX ``_maybe_fuse_optimizer``):
        weights replicated everywhere (one device, pure data parallelism)
        take ``FusedUpdate``; a strategy that shards weights (TP / FSDP)
        takes ``ShardedFusedUpdate``, which flattens each rank's local
        shards. A weight whose sharded dim its mesh axes do not divide
        keeps the per-leaf update (logged, the weight named), as in JAX.
        (Placement's fall-back comes with placement, ROADMAP item 9 part
        2.)"""
        if self.mesh is None or self.mesh.size() <= 1:
            return FusedUpdate(opt)
        all_specs = self.executor.weight_specs()
        specs = {op: {w: all_specs[op][w] for w in ws}
                 for op, ws in self.params.items()}
        if not any(e is not None for ws in specs.values()
                   for sp in ws.values() for e in sp):
            return FusedUpdate(opt)
        sizes = parallel.mesh_shape_dict(self.mesh)
        for op, ws in specs.items():
            for w, sp in ws.items():
                shape = self.params[op][w].shape
                for d, e in enumerate(sp):
                    axes = e if isinstance(e, tuple) else ((e,) if e else ())
                    k = math.prod(sizes[a] for a in axes)
                    if shape[d] % k:
                        log.warning(
                            "fused_optimizer: weight %s/%s: leaf dim %d not "
                            "divisible by mesh extent %d for spec %s — "
                            "using the per-leaf update", op, w, shape[d], k,
                            sp)
                        return opt
        return ShardedFusedUpdate(opt, self.mesh, specs)

    def _maybe_shard_optimizer(self, opt):
        """``FFConfig.overlap_grad_sync`` (the JAX
        ``_maybe_shard_optimizer``): the ZeRO-1 update (``Zero1Update``)
        over the data-scattered layout the executor reduce-scatters the
        gradients into. Falls back, the reason logged, under a fused
        optimizer (its flat state keeps its own layout; the gradient
        buckets still apply) and on a mesh with no "data" axis > 1.
        (Placement's fall-back comes with placement, ROADMAP item 9 part
        2.)"""
        if isinstance(opt, FusedUpdate):
            log.warning(
                "overlap_grad_sync: fused_optimizer already stores flat "
                "state in its own layout — skipping the ZeRO-1 wrap (the "
                "gradient buckets still apply)")
            return opt
        ex = self.executor
        scatter = ex.grad_scatter_shardings() if self.mesh is not None \
            else {}
        if not scatter:
            log.info("overlap_grad_sync: no data axis > 1 on mesh %s — "
                     "nothing to scatter over", self.config.mesh_shape)
            return opt
        return Zero1Update(
            opt, {op: {w: ex.grad_placements(op, w) for w in ws}
                  for op, ws in scatter.items()},
            ex._store_placements, self.mesh)

    def _build_mesh(self, optimizer) -> None:
        """The strategy path's set-up, in the JAX ``compile``'s order
        (model.py:479-507): the strategy file imported first, then the
        mesh built — for an explicit ``mesh_shape``, or a world of
        several ranks (then ``{"data": world}`` unless given). The
        strategy table is exported (``export_strategy_file``) once built.
        With an optimizer and a ``checkpoint_dir`` the elastic policy runs
        between the two (runtime/elastic.py), as in JAX: a resume onto
        another mesh re-derives the saved table on it. A compile without
        an optimizer (serving) builds the same mesh."""
        from flexflow_tpu_torch.parallel.mesh import world_size

        cfg = self.config
        if cfg.import_strategy_file:
            self.import_strategies(cfg.import_strategy_file)
        self.mesh = None
        self._elastic = None
        if optimizer is not None and cfg.checkpoint_dir:
            from flexflow_tpu_torch.runtime.elastic import \
                apply_elastic_policy

            self._elastic = apply_elastic_policy(self)
        world = world_size()
        if cfg.mesh_shape is None and world <= 1:
            if cfg.export_strategy_file:
                self.export_strategies(cfg.export_strategy_file)
            return
        self.mesh = parallel.make_mesh(cfg.mesh_shape or {"data": world},
                                       self.device.type)
        if cfg.export_strategy_file:
            self.export_strategies(cfg.export_strategy_file)

    def export_strategies(self, filename: str) -> None:
        """Write ``FFConfig.strategies`` to ``filename`` (the text schema
        both packages read; ``parallel/strategy.py``)."""
        save_strategies_to_file(filename, self.config.strategies)

    def import_strategies(self, filename: str) -> None:
        """Read a strategy file (either package's, or the reference's)
        into ``FFConfig.strategies``."""
        self.config.strategies.update(load_strategies_from_file(filename))

    # ------------------------------------------------------------- training

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        """``batch`` on the model's device (``GraphExecutor.shard_batch``:
        a tensor already there passes through); under a mesh, this rank's
        rows of the global batch."""
        ex = self.executor or GraphExecutor(self)
        return ex.shard_batch(ex.local_batch(batch))

    def _stage_batch(self) -> Dict:
        """The loaders' next batch (under a mesh, this rank's rows)."""
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
        which needs the guard). Under a mesh ``batch`` is the global batch
        — within ``fit``, whose loaders give each rank its rows, this
        rank's rows."""
        if self.optimizer is None:
            raise RuntimeError("compile() with an optimizer first")
        if not self._loader_rows:
            batch = self.executor.local_batch(batch)
        batch = self.executor.shard_batch(batch)
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
            parallel.local(t).data_ptr() for t in self._state_leaves())
        if self._replay is None or self._replay_key != key:
            self._replay = StepReplay(self._step, staged,
                                      max(n_steps, self.config.scan_steps),
                                      self._generators.values(),
                                      capture=self.mesh is None)
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
        """Weights, optimizer state and op state: what a captured step
        updates in place (a change of any of them invalidates the
        capture)."""
        out = [w for ws in self.params.values() for w in ws.values()]
        todo = [self.opt_state, self.bn_state]
        while todo:
            x = todo.pop()
            if isinstance(x, dict):
                todo.extend(x.values())
            elif isinstance(x, torch.Tensor):
                out.append(x)
        return out

    def fit(self, epochs: Optional[int] = None,
            batch_size: Optional[int] = None, callbacks: Sequence = (),
            verbose: bool = True):
        """Training loop over the attached ``SingleDataLoader``s (the JAX
        ``fit``). Prints an ``epoch N: loss=...`` line per epoch and a
        final ``THROUGHPUT = ... samples/s`` line; the first step or chunk
        (and any kernel build or graph capture it triggers) is kept out of
        the throughput window, as in the JAX package.

        The loaders' data: staged once on the device when every loader
        fits ``device_data_budget_bytes`` (each step then slices it there),
        else host-resident — batches from the native threaded loader
        (runtime/native_loader.py; shuffled under ``dataloader_shuffle``)
        or from Python slicing. Eligibility is decided for every loader
        before any copy, and a failed staging unstages the others. With
        ``config.scan_steps`` > 0 over staged data, chunks of up to
        ``scan_steps`` steps a dispatch (``train_scanned``), the epoch's
        ragged tail one step at a time. Host-resident data runs through
        the input pipeline when ``prefetch_depth`` > 0
        (runtime/pipeline_loader.py: a worker copies batches to the
        device ahead of the step), and up to ``dispatch_ahead`` steps stay
        in flight before the loop waits on the oldest. The steps and
        their results are those of the synchronous loop
        (``prefetch_depth=0``). ``last_step_breakdown`` holds the
        per-step host_wait / h2d / dispatch / device seconds.

        ``callbacks``: objects with ``set_model``, ``on_train_begin``,
        ``on_epoch_begin``, ``on_epoch_end`` (True stops training) and
        ``on_train_end``.

        With ``config.checkpoint_dir`` a ``TrainSupervisor``
        (runtime/resilience.py) resumes from the newest intact checkpoint
        (mid-epoch: the loaders' cursors are restored, not reset; under
        the native loader the batches already trained are discarded),
        checkpoints every ``checkpoint_every`` steps (the CONSUMED
        cursors while the pipeline runs), rewinds after
        ``nonfinite_rewind_after`` non-finite steps (not under the native
        loader, whose cursor cannot seek) and turns SIGTERM into a
        checkpoint at the next step boundary and a stop. Each per-step
        dispatch is a ``step-<n>`` span tree on the "train" track and
        feeds ``ff_train_step_seconds`` (the step-time SLO's
        histogram)."""
        from flexflow_tpu_torch.runtime import flightrec, telemetry

        if self.optimizer is None:
            raise RuntimeError("compile() with an optimizer first")
        if not self._dataloaders:
            raise RuntimeError("no dataloaders attached; create "
                               "SingleDataLoader(ff, tensor, data)")
        cfg = self.config
        epochs = epochs or cfg.epochs
        bs = batch_size or cfg.batch_size
        if batch_size is not None:
            for dl in self._dataloaders:
                dl.batch_size = batch_size
        if self.mesh is not None:
            self.executor.batch_rows = bs
        num_batches = min(dl.num_batches for dl in self._dataloaders)
        if num_batches <= 0:
            raise ValueError(
                f"dataset smaller than batch_size ("
                f"{min(dl.num_samples for dl in self._dataloaders)} samples "
                f"< {bs}); no full batch to train on")
        # loader preference: staged on the device > the native threaded
        # loader > Python slicing. A pin from an earlier fit (unstage, out
        # of memory) is tried again once a fit
        native_dl = None
        for dl in self._dataloaders:
            dl._dev_failed = False
        staged = (all(dl.device_eligible() for dl in self._dataloaders)
                  and all(dl._try_stage_on_device()
                          for dl in self._dataloaders))
        if not staged:
            for dl in self._dataloaders:
                dl.unstage()
            from flexflow_tpu_torch.runtime.native_loader import \
                group_loader_for

            native_dl = group_loader_for(self)
            if native_dl is not None:
                num_batches = native_dl.num_batches
        chunk_max = cfg.scan_steps
        use_scan = (chunk_max > 0 and native_dl is None and staged
                    and self._scan_eligible())
        tm_on = cfg.telemetry != "off"
        # unconditional: how telemetry="off" reaches the recorder's gate
        flightrec.configure(cfg)
        if tm_on and cfg.metrics_port:
            telemetry.start_http_server(cfg.metrics_port)
        step_hist = (telemetry.registry().histogram(
            "ff_train_step_seconds",
            "fit() per-step wall time (host wait + h2d + dispatch)")
            if tm_on else None)
        sup = None
        start_epoch = it0 = 0
        if cfg.checkpoint_dir:
            from flexflow_tpu_torch.runtime.resilience import TrainSupervisor

            sup = TrainSupervisor(self)
            if sup.rewind_after and native_dl is not None:
                # the native loader's shuffled cursor cannot seek back, so
                # a rewind would replay steps on the wrong batches
                log.warning("nonfinite_rewind_after: rewind disabled under "
                            "the native dataloader (its cursor cannot "
                            "rewind); non-finite steps are still skipped")
                sup.rewind_after = 0
            # poll the guard's flag a step only when a prompt rewind needs
            # it; otherwise the device skip counter reconciles at finalize
            sup.poll_nonfinite = bool(sup.rewind_after)
            sup.install()
            resumed = sup.resume()
            if resumed:
                start_epoch = min(resumed // num_batches, epochs)
                it0 = resumed % num_batches
            if use_scan and sup._fault_plan().has_step_events(
                    "nan_loss", "hang"):
                log.warning("FF_FAULT schedules nan_loss/hang step events: "
                            "running per-step (scanned chunks bypass "
                            "injection)")
                use_scan = False
        # the input pipeline: host-resident data only (staged data slices
        # on the device already), not under a per-step guard poll
        use_overlap = (not use_scan and not staged
                       and cfg.prefetch_depth > 0
                       and (sup is None or not sup.poll_nonfinite))
        pipe = None
        # the dispatch-ahead ring: one completion marker a step in flight
        ring = collections.deque()
        on_card = self.device.type == "cuda"
        # per-step wall breakdown, reset at the warm-up barrier
        bd = {"host_wait": 0.0, "h2d": 0.0, "dispatch": 0.0, "device": 0.0,
              "steps": 0}
        warm = None
        total = 0

        def note_warm():
            # one barrier for every loop flavour: the first step's loss
            # (compile, builds and captures stay out of the window)
            nonlocal warm, total
            float(self._last_loss)
            warm = time.time()
            total = 0
            for k in bd:
                bd[k] = 0 if k == "steps" else 0.0
            if pipe is not None:
                pipe.reset_stats()

        for cb in callbacks:
            cb.set_model(self)
            cb.on_train_begin()
        t0 = time.time()
        stopped = False
        self._loader_rows = True
        try:
            for epoch in range(start_epoch, epochs):
                # resuming mid-epoch: the cursors were just restored
                resuming = (sup is not None and epoch == start_epoch
                            and it0 > 0)
                for cb in callbacks:
                    cb.on_epoch_begin(epoch)
                self._perf = PerfMetrics()
                if native_dl is not None:
                    # a new permutation an epoch; a resumed process's
                    # fresh loader sits on its first permutation, so a
                    # resume into epoch >= 1 resets too
                    if epoch > start_epoch or start_epoch > 0:
                        if pipe is not None:
                            pipe.epoch_break(native_dl.reset)
                        else:
                            native_dl.reset()
                    if resuming:
                        # the native cursor cannot seek: discard the
                        # batches already trained (before the pipeline
                        # starts, so it never prefetches them)
                        for _ in range(it0):
                            native_dl.next_batch()
                elif not resuming:
                    if pipe is not None:
                        pipe.epoch_break(self._reset_dataloaders)
                    else:
                        self._reset_dataloaders()
                if use_overlap and pipe is None:
                    from flexflow_tpu_torch.runtime.pipeline_loader import \
                        PipelineLoader

                    depth = cfg.prefetch_depth
                    pipe = (PipelineLoader.from_native(native_dl, self,
                                                       depth=depth)
                            if native_dl is not None else
                            PipelineLoader.from_loaders(self, depth=depth))
                    pipe.start()
                    self._pipeline = pipe
                # (metrics, steps): device scalars for a step, (n,) stacks
                # for a scanned chunk; converted once per epoch
                epoch_mets = []
                it = it0
                while it < num_batches:
                    t_b = time.perf_counter()
                    if use_scan and num_batches - it >= chunk_max:
                        n = chunk_max
                        _, mets = self.train_scanned(n)
                        if tm_on:
                            telemetry.tracer().complete(
                                "train_scan_chunk", t_b,
                                time.perf_counter() - t_b, track="train",
                                steps=n)
                    else:
                        n = 1
                        if pipe is not None:
                            # copied to the device by the worker: this
                            # wait is "input not ready yet" alone
                            batch = pipe.get()
                            t_h = t_s = time.perf_counter()
                        else:
                            batch = (native_dl.next_batch()
                                     if native_dl is not None
                                     else self._stage_batch())
                            t_h = time.perf_counter()
                            batch = self.executor.shard_batch(batch)
                            t_s = time.perf_counter()
                        self._current_batch = batch
                        loss, mets = self._run_train_step(
                            batch, inject_nan=(sup is not None
                                               and sup.nan_due()))
                        t_d = time.perf_counter()
                        bd["host_wait"] += t_h - t_b
                        bd["h2d"] += t_s - t_h
                        bd["dispatch"] += t_d - t_s
                        bd["steps"] += 1
                        if tm_on:
                            sid = f"step-{self._step_count}"
                            tr = telemetry.tracer()
                            tr.complete("train_step", t_b, t_d - t_b,
                                        trace_id=sid, track="train",
                                        step=self._step_count)
                            tr.complete("host_wait", t_b, t_h - t_b,
                                        trace_id=sid, track="train")
                            if t_s > t_h:
                                tr.complete("h2d", t_h, t_s - t_h,
                                            trace_id=sid, track="train")
                            tr.complete("dispatch", t_s, t_d - t_s,
                                        trace_id=sid, track="train")
                            step_hist.observe(t_d - t_b)
                            if sup is None:
                                flightrec.slo_monitor().maybe_evaluate()
                        if warm is not None and pipe is not None:
                            # dispatch-ahead: wait on the OLDEST step in
                            # flight once more than dispatch_ahead are —
                            # device progress, which is what the
                            # watchdog must time
                            if on_card:
                                ev = torch.cuda.Event()
                                ev.record()
                                ring.append(ev)
                            else:
                                ring.append(loss)
                            if len(ring) > cfg.dispatch_ahead:
                                old = ring.popleft()
                                t_w = time.perf_counter()
                                with (sup.watchdog.arm(
                                        f"step {self._step_count} device "
                                        f"progress",
                                        scale=cfg.dispatch_ahead + 1)
                                      if sup is not None
                                      else contextlib.nullcontext()):
                                    if on_card:
                                        old.synchronize()
                                dt_w = time.perf_counter() - t_w
                                bd["device"] += dt_w
                                if tm_on:
                                    telemetry.tracer().complete(
                                        "device_wait", t_w, dt_w,
                                        track="train")
                    epoch_mets.append((mets, n))
                    it += n
                    total += bs * n
                    if warm is None:
                        note_warm()
                    if sup is not None:
                        after = self._step_count
                        if sup.after_step():
                            stopped = True
                            break
                        if self._step_count < after:
                            # divergence rewind: drop the discarded steps
                            # from the epoch's accounting and re-run them
                            k = after - self._step_count
                            drop = min(k, len(epoch_mets))
                            if drop:
                                del epoch_mets[-drop:]
                            total = max(total - bs * k, 0)
                            it = max(it - k, 0)
                it0 = 0
                # the epoch-end conversion waits on every step dispatched
                t_sync = time.perf_counter()
                with (sup.watchdog.arm(f"epoch {epoch} metrics sync",
                                       scale=max(len(epoch_mets), 1))
                      if sup is not None else contextlib.nullcontext()):
                    for mets, n in epoch_mets:
                        vals = {k: v.cpu() for k, v in mets.items()}
                        for j in range(n):
                            self._perf.update(
                                {k: float(v[j] if v.dim() else v)
                                 for k, v in vals.items()}, bs)
                dt_sync = time.perf_counter() - t_sync
                bd["device"] += dt_sync
                if tm_on:
                    telemetry.tracer().complete(
                        "epoch_sync", t_sync, dt_sync, track="train",
                        epoch=epoch, steps=len(epoch_mets))
                ring.clear()      # everything in flight just synced
                if verbose:
                    print(f"epoch {epoch}: loss="
                          f"{float(self._last_loss):.4f} "
                          + self._perf.report(self.loss_type,
                                              self.metric_types))
                if stopped:   # preemption checkpoint written
                    break
                if any(cb.on_epoch_end(epoch) for cb in callbacks):
                    break
        finally:
            self._loader_rows = False
            if pipe is not None:
                # quiesce BEFORE the supervisor's final checkpoint: the
                # cursors go back to the consumed position
                pipe.stop()
                self._pipeline = None
            if native_dl is not None:
                native_dl.close()
            if sup is not None:
                sup.finalize()
        self._sync()
        elapsed = time.time() - (warm or t0)
        if bd["steps"]:
            wall = max(elapsed, 1e-9)
            if pipe is not None:
                # the worker's copies overlap the steps: reported, not a
                # part of the loop's wall
                bd["h2d"] = pipe.stats["h2d_s"]
            self.last_step_breakdown = dict(
                bd, wall_s=wall, overlap=pipe is not None,
                host_wait_fraction=min(bd["host_wait"] / wall, 1.0))
            log.info("fit step breakdown (%d steps, overlap=%s): host_wait "
                     "%.1f%% | h2d %.1f%%%s | dispatch %.1f%% | device "
                     "%.1f%% of %.3fs wall", bd["steps"], pipe is not None,
                     100 * bd["host_wait"] / wall, 100 * bd["h2d"] / wall,
                     " (worker, overlapped)" if pipe is not None else "",
                     100 * bd["dispatch"] / wall,
                     100 * bd["device"] / wall, wall)
        if total and elapsed > 0 and verbose:
            print(f"epochs {epochs}, ELAPSED TIME = {elapsed:.4f}s, "
                  f"THROUGHPUT = {total / elapsed:.2f} samples/s")
        self.last_fit_status = "preempted" if stopped else "completed"
        for cb in callbacks:
            cb.on_train_end()
        return self._perf

    def step_breakdown(self, batch=None, iters: int = 3) -> Dict[str, float]:
        """Per-step compute / collective / epilogue breakdown of the train
        step (runtime/profiler.py ``step_phase_breakdown``): the full
        step's and the optimizer update's device time, measured on clones
        (the model's state is left bitwise as it was), and the collective
        kernels of a profiled step. Merged into ``last_step_breakdown``
        beside fit's host-side numbers; returns the merged dict."""
        from flexflow_tpu_torch.runtime.profiler import step_phase_breakdown

        rows = step_phase_breakdown(self, batch=batch, iters=iters)
        merged = dict(self.last_step_breakdown or {})
        merged.update(rows)
        self.last_step_breakdown = merged
        return merged

    def evaluate(self, batch):
        """(loss, metrics, logits) of one batch without a gradient."""
        if self.executor is None:
            raise RuntimeError("compile() with an optimizer first")
        loss, mets, logits = self.executor.eval_step(
            self.params, self._to_device(batch), self.loss_type,
            self.metric_types, self._final_tensor)
        return (float(loss), {k: float(v) for k, v in mets.items()},
                parallel.full_tensor(logits))

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
        ServingEngine), among them ``prefix_cache``, ``host_kv_pages``,
        ``kv_cache_dtype`` ('native', 'bf16', 'int8', 'fp8'),
        ``weight_dtype`` ('native', 'int8', 'fp8'), ``adapter_pool_pages``,
        ``lora_rank`` and ``lora_targets``."""
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

    def make_serving_router(self, replicas: int = 2, **kwargs):
        """Fleet serving router (runtime/router.py ServingRouter): N
        continuous-batching replicas of this model (one set of weights),
        each driven on its own thread, with failover (a crashed or hung
        replica is fenced and its work resubmitted to survivors exactly
        once), per-request deadlines, overload shedding (``max_queue`` /
        FFConfig.serve_max_queue) and least-loaded + prefix-affinity
        placement. ``roles=`` (or FFConfig.serve_replica_roles)
        disaggregates the fleet into prefill and decode replicas joined by
        page-slab handoffs; ``replicas`` is the starting size
        (``add_replica`` / ``remove_replica`` / ``request_preempt``). Router
        kwargs (``max_queue``, ``health_timeout_s``, ``dispatch_backlog``,
        ``roles``, ``handoff_min_pages``, ``seq_parallel_shards``,
        ``start``) are split out; the rest go to every replica's
        ServingEngine."""
        from flexflow_tpu_torch.runtime.router import ServingRouter

        return ServingRouter(self, replicas=replicas, **kwargs)

    def serve_fleet(self, prompts, max_new_tokens: int = 32,
                    replicas: int = 2,
                    deadline_s: Optional[float] = None, **kwargs):
        """One-shot fleet serve: run ``prompts`` through a fresh N-replica
        ServingRouter and return (outputs, stats) — outputs[i] is prompt +
        generated tokens for prompts[i], or None for a request that
        failed, expired (``deadline_s``) or was shed; stats is the
        router's fleet ledger. Greedy fleet output equals single-engine
        serve()'s: the router moves work, never changes it."""
        router = self.make_serving_router(replicas=replicas, **kwargs)
        try:
            reqs = router.run(prompts, max_new_tokens=max_new_tokens,
                              deadline_s=deadline_s)
            outs = [r.output if r.state == "done" else None for r in reqs]
            stats = router.stats()
        finally:
            router.close()
        return outs, stats

    def dump_flight_record(self, directory: Optional[str] = None,
                           **note) -> Optional[str]:
        """Manual post-mortem bundle (runtime/flightrec.py): snapshot the
        recent trace window, the metrics registry, the log ring, the HBM
        ledger (with the card's memory stats), every engine's stats and
        the config / environment fingerprint into an atomic,
        manifest-hashed bundle directory; returns its path.
        ``directory`` overrides ``FFConfig.flight_recorder_dir`` (one of
        the two must be set). None when ``FFConfig.telemetry="off"``."""
        from flexflow_tpu_torch.runtime import flightrec

        # recorder-only configure: re-arming the SLO monitor here would
        # reset live breach state on an operator's dump
        flightrec.recorder().configure(self.config)
        return flightrec.dump("manual", directory=directory,
                              source="model", **note)

    # ----------------------------------------------------------- generation

    def generate(self, tokens, max_new_tokens: int, temperature: float = 0.0,
                 top_k: int = 0, eos_token_id: Optional[int] = None,
                 pad_token_id: int = 0, num_beams: int = 1,
                 length_penalty: float = 0.0, prompt_lengths=None,
                 quantize: Optional[str] = None, prefill_chunk: int = 0,
                 return_scores: bool = False, seed: int = 0,
                 early_exit: bool = False):
        """KV-cache decoding of a decoder-only LM (the JAX ``generate``,
        model.py:1330; runtime/generation.py). tokens: (B, S0) int prompts;
        returns (B, S0 + max_new_tokens) int32 with the new tokens in
        columns S0 onward — with ``return_scores`` a (tokens, scores)
        pair, scores the (B, max_new_tokens) per-token log-probabilities
        (pads after eos 0.0), or for beam search the best beam's (B,)
        length-penalty-normalized total. ``prompt_lengths`` (B,): ragged
        right-padded prompts. ``num_beams`` > 1: beam search
        (temperature / top_k ignored; ``length_penalty`` 0 ranks by the
        raw sum of log-probabilities, 1.0 by their mean). ``quantize``
        "int8" / "fp8": weight-only quantized decode. ``prefill_chunk``:
        chunked prefill. ``early_exit``: stop once every row has emitted
        eos (the same tokens, fewer steps). ``seed``: sampled draws are a
        pure function of (seed, row, token index).

        Each sampling config keeps a Generator (beam calls key out
        temperature and top_k), and each (max_new_tokens, ragged,
        prefill_chunk, scores | beam settings, prompt shape) keeps a
        program: static caches and, on the card, the decode step captured
        as a CUDA graph; at most FF_GEN_PROGRAM_CACHE (default 8) a
        Generator. A Generator reads ``params``; a native-width
        ``swap_weights`` on an engine of the model then moves that engine
        to a weight set of its own version and leaves ``params`` (and
        generate's tokens) as they are."""
        from flexflow_tpu_torch.runtime.generation import Generator

        if self.params is None:
            raise RuntimeError("generate() needs a compiled model "
                               "(FFModel.compile)")
        key = ((0.0, 0, eos_token_id, pad_token_id, quantize)
               if num_beams > 1
               else (temperature, top_k, eos_token_id, pad_token_id,
                     quantize))
        gen = self._decoders.get(key)
        if gen is None:
            # from the KEYED values: a Generator a beam call made must be
            # greedy if a later num_beams=1 call reuses it
            gen = self._decoders[key] = Generator(
                self, temperature=key[0], top_k=key[1], eos_id=eos_token_id,
                pad_id=pad_token_id, quantize=quantize)
        if num_beams > 1:
            return gen.beam_search(tokens, max_new_tokens, num_beams,
                                   length_penalty,
                                   prefill_chunk=prefill_chunk,
                                   return_scores=return_scores,
                                   prompt_lengths=prompt_lengths)
        return gen(tokens, max_new_tokens, seed=seed,
                   prompt_lengths=prompt_lengths, prefill_chunk=prefill_chunk,
                   return_scores=return_scores, early_exit=early_exit)

    def generate_seq2seq(self, src_tokens, tgt_prompt=None,
                         max_new_tokens: int = 32, bos_token_id: int = 1,
                         temperature: float = 0.0, top_k: int = 0,
                         eos_token_id: Optional[int] = None,
                         pad_token_id: int = 0, seed: int = 0):
        """Encoder-decoder decoding (the JAX ``generate_seq2seq``,
        model.py:1519; runtime/seq2seq_generation.py): the encoder runs
        once on ``src_tokens`` (B, S_src), cross-attention k/v are
        projected once, and the decoder's cached loop starts from
        ``tgt_prompt`` (B, T0) — a column of ``bos_token_id`` when omitted.
        Returns (B, T0 + max_new_tokens) int32."""
        from flexflow_tpu_torch.runtime.seq2seq_generation import \
            Seq2SeqGenerator

        if self.params is None:
            raise RuntimeError("generate_seq2seq() needs a compiled model "
                               "(FFModel.compile)")
        key = ("s2s", temperature, top_k, eos_token_id, pad_token_id)
        gen = self._decoders.get(key)
        if gen is None:
            gen = self._decoders[key] = Seq2SeqGenerator(
                self, temperature=temperature, top_k=top_k,
                eos_id=eos_token_id, pad_id=pad_token_id)
        src = np.asarray(src_tokens)
        if tgt_prompt is None:
            tgt_prompt = np.full((src.shape[0], 1), bos_token_id, np.int32)
        return gen(src, tgt_prompt, max_new_tokens, seed=seed)
