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
        the training loss. dispatch: "auto" (sort-based: the experts are
        not mesh-sharded in the port) | "dense" | "sort"."""
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
        """A weight as a numpy array (a tied one read through its
        source and transform)."""
        tie = self._tied.get((op_name, weight_name))
        if tie is not None:
            src_op, src_w, tf = tie
            w = tie_transform(self.params[src_op][src_w], tf)
        else:
            w = self.params[op_name][weight_name]
        return w.detach().float().cpu().numpy()

    def set_weights(self, op_name: str, weight_name: str, value) -> None:
        """Overwrite a weight in place (its dtype and device kept); a tied
        destination refuses — set its source."""
        tie = self._tied.get((op_name, weight_name))
        if tie is not None:
            raise ValueError(
                f"{op_name}.{weight_name} is tied to {tie[0]}.{tie[1]} — "
                f"set the source weight instead")
        w = self.params[op_name][weight_name]
        with torch.no_grad():
            w.copy_(torch.as_tensor(np.asarray(value)).reshape(w.shape))

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
        self.executor = executor
        self.params = self.executor.init_params(gen)
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
                                      max(n_steps, self.config.scan_steps),
                                      self._generators.values())
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
        Generator. A Generator reads ``params`` in place, so once this has
        run a native-width ``swap_weights`` on any engine of the model is
        refused."""
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
