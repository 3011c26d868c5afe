"""PerfMetrics and per-batch metrics (the JAX package's
``runtime/metrics.py``).

``batch_metrics`` runs on the device inside the step and returns device
scalars; ``fit`` converts them once per epoch, so the host does not wait
on the card between steps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import LossType, MetricsType


@dataclasses.dataclass
class PerfMetrics:
    train_all: int = 0
    train_correct: int = 0
    # denominator for accuracy: the number of predictions scored
    train_pred_total: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0
    start_time: float = dataclasses.field(default_factory=time.time)

    def update(self, batch_metrics: Dict[str, float], batch_size: int):
        self.train_all += batch_size
        if "accuracy_count" in batch_metrics:
            self.train_correct += int(batch_metrics["accuracy_count"])
            self.train_pred_total += int(
                batch_metrics.get("accuracy_total", batch_size))
        for k in ("cce_loss", "sparse_cce_loss", "mse_loss", "rmse_loss",
                  "mae_loss"):
            if k in batch_metrics:
                setattr(self, k,
                        getattr(self, k) + float(batch_metrics[k]) * batch_size)

    def report(self, loss_type: LossType,
               metrics: Sequence[MetricsType]) -> str:
        """Epoch summary in the reference's print style."""
        parts = [f"train_all={self.train_all}"]
        denom = self.train_pred_total or self.train_all
        if MetricsType.METRICS_ACCURACY in metrics and denom:
            acc = 100.0 * self.train_correct / denom
            parts.append(f"accuracy={acc:.2f}% ({self.train_correct}/{denom})")
        n = max(self.train_all, 1)
        if self.sparse_cce_loss:
            parts.append(f"sparse_cce_loss={self.sparse_cce_loss / n:.4f}")
        if self.cce_loss:
            parts.append(f"cce_loss={self.cce_loss / n:.4f}")
        for m in metrics:
            if m == MetricsType.METRICS_MEAN_SQUARED_ERROR and self.mse_loss:
                parts.append(f"mse={self.mse_loss / n:.4f}")
        return "[Metrics] " + " ".join(parts)

    @property
    def accuracy(self) -> float:
        return self.train_correct / max(self.train_pred_total
                                        or self.train_all, 1)


def _class_ids(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    lab = labels.long()
    return lab[..., 0] if lab.dim() == logits.dim() else lab


@torch.no_grad()
def batch_metrics(loss_type: LossType, metric_types: Sequence[MetricsType],
                  logits: torch.Tensor,
                  labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-batch metric values as device scalars. ``accuracy_total`` is
    the number of predictions (batch x positions for token-level labels),
    made on the device too (a fill, which a captured CUDA graph can hold;
    ``torch.tensor`` would copy from the host)."""
    out: Dict[str, torch.Tensor] = {}
    logits = logits.float()

    def count(n: int) -> torch.Tensor:
        return torch.full((), n, dtype=torch.int64, device=logits.device)

    for m in metric_types:
        if m == MetricsType.METRICS_ACCURACY:
            pred = torch.argmax(logits, dim=-1)
            if loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
                out["accuracy_count"] = (pred == _class_ids(labels, logits)).sum()
                out["accuracy_total"] = count(pred.numel())
            elif loss_type == LossType.LOSS_CATEGORICAL_CROSSENTROPY:
                out["accuracy_count"] = (pred == torch.argmax(labels, -1)).sum()
                out["accuracy_total"] = count(pred.numel())
            else:
                # regression "accuracy": every |err| < 0.5
                close = (logits - labels).abs() < 0.5
                out["accuracy_count"] = close.flatten(1).all(dim=1).sum()
                out["accuracy_total"] = count(logits.shape[0])
        elif m == MetricsType.METRICS_CATEGORICAL_CROSSENTROPY:
            logp = F.log_softmax(logits, dim=-1)
            out["cce_loss"] = -(labels * logp).sum(-1).mean()
        elif m == MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY:
            logp = F.log_softmax(logits, dim=-1)
            ids = _class_ids(labels, logits)
            out["sparse_cce_loss"] = -torch.gather(
                logp, -1, ids[..., None]).mean()
        elif m == MetricsType.METRICS_MEAN_SQUARED_ERROR:
            out["mse_loss"] = torch.square(logits - labels).mean()
        elif m == MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR:
            out["rmse_loss"] = torch.sqrt(torch.square(logits - labels).mean())
        elif m == MetricsType.METRICS_MEAN_ABSOLUTE_ERROR:
            out["mae_loss"] = (logits - labels).abs().mean()
    return out


_KERAS_METRIC_NAMES = {
    "accuracy": MetricsType.METRICS_ACCURACY,
    "categorical_crossentropy": MetricsType.METRICS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "mse": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "root_mean_squared_error": MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.METRICS_MEAN_ABSOLUTE_ERROR,
}


def metrics_from_names(names) -> List[MetricsType]:
    return [n if isinstance(n, MetricsType) else _KERAS_METRIC_NAMES[n]
            for n in names]
