"""Loss functions (the JAX package's ``runtime/loss.py``).

Losses are forward scalars and autograd produces the gradient; the 1/B
scaling of the reference's loss kernels comes from the mean reduction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import LossType


def take_class(logp: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``logp[..., ids]`` with the JAX ``take_along_axis`` semantics: a
    negative id counts from the end (-100 over a vocabulary of 128 reads
    class 28) and an id outside [-V, V) reads NaN, where ``torch.gather``
    would raise — so a pad label (``metrics_ignore_index``) trains as in
    the JAX package."""
    v = logp.shape[-1]
    idx = torch.where(ids < 0, ids + v, ids)
    ok = (idx >= 0) & (idx < v)
    got = torch.gather(logp, -1, idx.clamp(0, v - 1)[..., None])[..., 0]
    return torch.where(ok, got, torch.full_like(got, float("nan")))


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
        return -take_class(F.log_softmax(logits, dim=-1), lab).mean()
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
