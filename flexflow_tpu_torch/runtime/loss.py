"""Loss functions (the JAX package's ``runtime/loss.py``).

Losses are forward scalars and autograd produces the gradient; the 1/B
scaling of the reference's loss kernels comes from the mean reduction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import LossType


def compute_loss(loss_type: LossType, logits: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Scalar training loss. ``labels``: int class ids for sparse CE (a
    trailing singleton dim is dropped), one-hot/dense probabilities for
    dense CE, targets for MSE."""
    if logits.dtype == torch.bfloat16:
        logits = logits.float()  # softmax/MSE numerics in f32
    if loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        lab = labels.long()
        if lab.dim() == logits.dim():
            lab = lab[..., 0]
        logp = F.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, lab[..., None])[..., 0].mean()
    if loss_type == LossType.LOSS_CATEGORICAL_CROSSENTROPY:
        return -(labels * F.log_softmax(logits, dim=-1)).sum(-1).mean()
    if loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE:
        return torch.square(logits - labels).mean()
    if loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE:
        # the reference sums over features and averages over the batch
        return torch.square(logits - labels).sum(
            dim=tuple(range(1, logits.dim()))).mean()
    if loss_type == LossType.LOSS_IDENTITY:
        return logits.mean()
    raise ValueError(f"unknown loss {loss_type}")


_KERAS_LOSS_NAMES = {
    "categorical_crossentropy": LossType.LOSS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mse": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
}


def loss_type_from_name(name) -> LossType:
    if isinstance(name, LossType):
        return name
    return _KERAS_LOSS_NAMES[name]
