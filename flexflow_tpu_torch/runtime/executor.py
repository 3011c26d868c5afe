"""GraphExecutor: interprets the op graph for training and evaluation (the
JAX package's ``runtime/executor.py``, the single-device subset).

The JAX executor jits a fused forward + backward + update program per
step; the port runs the same walk eagerly and takes the gradient with
``torch.autograd``. Mixed precision follows the JAX package: weights are
stored in ``FFConfig.master_dtype`` and every op runs in
``FFConfig.compute_dtype`` — inputs and weights are cast at the start of
the walk, so gradients come back in the storage dtype.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.ffconst import LossType, MetricsType
from flexflow_tpu_torch.ops.base import InputOp
from flexflow_tpu_torch.runtime.loss import compute_loss
from flexflow_tpu_torch.runtime.metrics import batch_metrics

Params = Dict[str, Dict[str, torch.Tensor]]
Batch = Dict[str, torch.Tensor]


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
        return {op.name: {w.name: w.initialize(torch.float32, dev,
                                               gen).to(master)
                          for w in op.weight_specs()}
                for op in self.model.ops if op.weight_specs()}

    # ---- forward interpretation ----------------------------------------------

    def apply_graph(self, params: Params, input_values: Dict,
                    *, training: bool) -> Dict:
        """Interpret the graph in order; returns the tensor -> value map.
        With a bf16 compute dtype, f32 inputs are cast to bf16; every
        floating weight is cast to the compute dtype."""
        cdt = self.model.compute_dtype
        bf16 = cdt == torch.bfloat16
        vals = {t: (v.to(cdt) if bf16 and v.dtype == torch.float32 else v)
                for t, v in input_values.items()}
        for op in self.model.ops:
            if isinstance(op, InputOp):
                if op.outputs[0] not in vals:
                    raise ValueError(f"missing input value for {op.name}")
                continue
            p = {k: (w.to(cdt) if w.is_floating_point() and w.dtype != cdt
                     else w)
                 for k, w in params.get(op.name, {}).items()}
            outs = op.forward(p, [vals[t] for t in op.inputs],
                              training=training)
            for t, v in zip(op.outputs, outs):
                vals[t] = v
        return vals

    def _input_values(self, batch: Batch) -> Dict:
        return {op.outputs[0]: batch[op.name] for op in self.input_ops}

    def loss_and_metrics(self, params: Params, batch: Batch,
                         loss_type: LossType,
                         metric_types: Sequence[MetricsType], final_tensor,
                         *, training: bool, label_key: str = "label"
                         ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """(loss, metrics, logits) of one batch — the JAX ``_make_loss_fn``
        body."""
        vals = self.apply_graph(params, self._input_values(batch),
                                training=training)
        logits = vals[final_tensor]
        loss = compute_loss(loss_type, logits, batch[label_key])
        mets = batch_metrics(loss_type, metric_types, logits.detach(),
                             batch[label_key])
        return loss, mets, logits

    # ---- steps ---------------------------------------------------------------

    def train_step(self, params: Params, opt_state, batch: Batch, optimizer,
                   loss_type: LossType, metric_types: Sequence[MetricsType],
                   final_tensor) -> Tuple[torch.Tensor, Dict]:
        """Forward, backward and one optimizer update (in place on
        ``params`` and ``opt_state``); returns the loss and metrics as
        device scalars."""
        leaves: List[torch.Tensor] = [w for ws in params.values()
                                      for w in ws.values()]
        for w in leaves:
            w.requires_grad_(True)
        loss, mets, _ = self.loss_and_metrics(
            params, batch, loss_type, metric_types, final_tensor,
            training=True)
        flat = iter(torch.autograd.grad(loss, leaves))
        grads = {op: {k: next(flat) for k in ws} for op, ws in params.items()}
        optimizer.update(params, grads, opt_state)
        return loss.detach(), mets

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
        vals = self.apply_graph(params, self._input_values(batch),
                                training=False)
        return [vals[t] for t in finals]
