"""FFModel: the graph builder and serving entry points (the JAX package's
``model.py``, the inference subset the serving slice runs).

The builder verbs append ops to a graph exactly as in the JAX package, so
model builders (``models/llama.py``) read the same. ``compile`` initialises
the parameters on the model's device from a seeded ``torch.Generator``;
``make_serving_engine`` / ``serve`` drive the continuous-batching engine.
The model runs on the card unless it is built with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from flexflow_tpu_torch._device import resolve_device
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import ActiMode, AggrMode, DataType, OperatorType
from flexflow_tpu_torch.ops.attention import MultiHeadAttention
from flexflow_tpu_torch.ops.base import InputOp, Op
from flexflow_tpu_torch.ops.dense import Embedding, Linear
from flexflow_tpu_torch.ops.elementwise import ElementBinary, ElementUnary
from flexflow_tpu_torch.ops.norm import RMSNorm
from flexflow_tpu_torch.tensor import Tensor

Params = Dict[str, Dict[str, torch.Tensor]]


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config or FFConfig()
        self.device = resolve_device(device)
        self.ops: List[Op] = []
        self._op_counters: Dict[str, int] = {}
        self.params: Optional[Params] = None
        self._final_tensor: Optional[Tensor] = None

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

    def _add(self, op: Op) -> Tensor:
        if self.get_op_by_name(op.name) is not None:
            raise ValueError(f"duplicate op name {op.name!r} (params key by "
                             f"name)")
        self.ops.append(op)
        return op.outputs[0]

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

    def compile(self, optimizer=None, final_tensor: Optional[Tensor] = None):
        """Inference compile: fix the output tensor and initialise every
        weight on the model's device in the compute dtype, drawn from a
        ``torch.Generator`` seeded with ``config.seed``. No strategy search
        and no optimizer in this slice."""
        if optimizer is not None:
            raise NotImplementedError(
                "training (an optimizer) is not ported yet (ROADMAP.md "
                "queue 1, items 2-4); compile(final_tensor=...) serves")
        if not self.ops:
            raise ValueError("compile() on an empty graph")
        self._final_tensor = final_tensor or self.ops[-1].outputs[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed)
        dtype = self.compute_dtype
        self.params = {
            op.name: {w.name: w.initialize(dtype, self.device, gen)
                      for w in op.weight_specs()}
            for op in self.ops if op.weight_specs()}

    # -------------------------------------------------------------- serving

    def make_serving_engine(self, **kwargs):
        """Continuous-batching serving engine (runtime/serving.py): a paged
        KV pool shared by ``serve_slots`` decode slots; the host scheduler
        admits queued prompts into free slots and retires rows on eos or
        length. Knobs default to this model's FFConfig; kwargs override
        them per engine (see ServingEngine)."""
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
