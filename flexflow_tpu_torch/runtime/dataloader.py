"""SingleDataLoader: the whole dataset resident on the model's device (the
JAX package's ``runtime/dataloader.py``).

The dataset is copied to the model's device once, at construction;
``next_batch`` is a slice of it on the device. Past the end of the data it
wraps to the first batch, as in the JAX package. ``_try_stage_on_device``
gives the scanned steps (``FFModel.train_scanned``) the dataset as
(num_batches, batch, ...), a view of the resident copy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class SingleDataLoader:
    def __init__(self, model, tensor, full_array: np.ndarray,
                 num_samples: Optional[int] = None,
                 batch_size: Optional[int] = None):
        self.model = model
        self.tensor = tensor
        self.name = tensor.name.split(":")[0] if tensor.name else "input"
        self.data = torch.as_tensor(np.asarray(full_array)).to(model.device)
        self.num_samples = num_samples or self.data.shape[0]
        self.batch_size = batch_size or model.config.batch_size
        self.next_index = 0
        self._dev_data: Optional[torch.Tensor] = None
        model._dataloaders.append(self)

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    def reset(self):
        self.next_index = 0

    def _try_stage_on_device(self) -> bool:
        """Stage the dataset pre-batched, (num_batches, batch, ...), as the
        JAX loader stages it for its scanned program; the data already
        lies on the device, so this is a view. False when there is no
        full batch."""
        b, nb = self.batch_size, self.num_batches
        if nb <= 0:
            self._dev_data = None
            return False
        self._dev_data = self.data[:nb * b].reshape(
            (nb, b) + tuple(self.data.shape[1:]))
        return True

    def next_batch(self) -> torch.Tensor:
        b = self.batch_size
        start = self.next_index
        if start + b > self.num_samples:
            start = 0
        self.next_index = start + b
        return self.data[start:start + b]
