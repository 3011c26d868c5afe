"""SingleDataLoader: a dataset on the host, or staged once on the device
(the JAX package's ``runtime/dataloader.py``).

The dataset stays a numpy array on the host. ``FFModel.fit`` stages it on
the model's device, pre-batched (num_batches, batch, ...), when it fits
``FFConfig.device_data_budget_bytes`` (and ``device_resident_data`` is on
and ``dataloader_shuffle`` off): ``next_batch`` is then a slice of the
staged copy, with no copy a step. A dataset over the budget, or one whose
staging ran out of device memory, stays on the host: ``next_batch``
slices it there and ``GraphExecutor.shard_batch`` copies the batch to the
device (``fit`` overlaps that with the step: runtime/pipeline_loader.py,
runtime/native_loader.py). Past the end of the data both paths wrap to
the first batch, as in the JAX package.
"""

from __future__ import annotations

import logging
from typing import Optional, Union

import numpy as np
import torch

log = logging.getLogger(__name__)


class SingleDataLoader:
    def __init__(self, model, tensor, full_array: np.ndarray,
                 num_samples: Optional[int] = None,
                 batch_size: Optional[int] = None):
        self.model = model
        self.tensor = tensor
        self.name = tensor.name.split(":")[0] if tensor.name else "input"
        self.data = np.asarray(full_array)
        self.num_samples = num_samples or self.data.shape[0]
        self.batch_size = batch_size or model.config.batch_size
        self.next_index = 0
        self._dev_data: Optional[torch.Tensor] = None
        self._dev_failed = False
        self._staged_bs: Optional[int] = None
        if model is not None:
            model._dataloaders.append(self)

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    def reset(self):
        self.next_index = 0

    def unstage(self):
        """Drop the device copy (its memory is freed) and pin this loader
        to the host path: ``next_batch`` must not copy again what ``fit``
        just evicted."""
        self._dev_data = None
        self._dev_failed = True

    def device_eligible(self) -> bool:
        """May this dataset live on the device? No copy is made. Shuffling
        stays on the host (the native loader reshuffles each epoch)."""
        cfg = getattr(self.model, "config", None)
        return (cfg is not None
                and getattr(self.model, "executor", None) is not None
                and not self._dev_failed
                and cfg.device_resident_data
                and not cfg.dataloader_shuffle
                and self.data.nbytes <= cfg.device_data_budget_bytes)

    def _try_stage_on_device(self) -> bool:
        """Stage the dataset on the device once, pre-batched (num_batches,
        batch, ...), as the JAX loader stages it for its scanned program.
        True when the device path is usable; out of device memory pins the
        loader to the host path."""
        if self._dev_data is not None:
            if self._staged_bs == self.batch_size:
                return True
            self._dev_data = None            # the batch size changed
        if not self.device_eligible():
            self._dev_failed = True
            return False
        b, nb = self.batch_size, self.num_batches
        if nb <= 0:
            return False
        host = self.data[:nb * b].reshape((nb, b) + self.data.shape[1:])
        try:
            self._dev_data = torch.as_tensor(host, device=self.model.device)
        except torch.OutOfMemoryError:
            log.warning("dataloader %r: staging %.2f GB on %s ran out of "
                        "device memory; it stays on the host", self.name,
                        host.nbytes / 1e9, self.model.device)
            self._dev_failed = True
            return False
        self._staged_bs = b
        return True

    def next_batch(self) -> Union[torch.Tensor, np.ndarray]:
        """The next batch: a slice of the staged device copy, else of the
        host array (numpy)."""
        b = self.batch_size
        start = self.next_index
        if start + b > self.num_samples:
            start = 0
        self.next_index = start + b
        if self._try_stage_on_device():
            return self._dev_data[(start // b) % self._dev_data.shape[0]]
        return self.data[start:start + b]


def attach_training_data(ffmodel, input_tensors, x, y, loss_type):
    """keras-style ``fit(x, y)`` plumbing: reset the model's dataloaders,
    attach one loader per graph input and one for the labels; 1-D sparse
    cross-entropy labels become the (N, 1) the label tensor expects."""
    from flexflow_tpu_torch.ffconst import LossType

    xs = x if isinstance(x, (list, tuple)) else [x]
    if len(xs) != len(input_tensors):
        raise ValueError(f"{len(xs)} input arrays for "
                         f"{len(input_tensors)} graph inputs")
    ffmodel._dataloaders = []
    for t, arr in zip(input_tensors, xs):
        SingleDataLoader(ffmodel, t, np.asarray(arr))
    y = np.asarray(y)
    if loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY \
            and y.ndim == 1:
        y = y.reshape(-1, 1)
    SingleDataLoader(ffmodel, ffmodel.label_tensor, y)
