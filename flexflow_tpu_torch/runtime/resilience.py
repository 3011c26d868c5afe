"""The divergence guard's device state (the JAX package's
``runtime/resilience.py`` ``init_guard_state``). The rest of that module —
``TrainSupervisor``, checkpoints, fault injection — is ROADMAP.md queue 1,
item 11."""

from __future__ import annotations

from typing import Dict, Union

import torch


def init_guard_state(loss_scale: float = 1.0,
                     device: Union[str, torch.device] = "cpu"
                     ) -> Dict[str, torch.Tensor]:
    """Device-resident carry of the guarded train step
    (``GraphExecutor.guarded_train_step``): the consecutive bad- and
    good-step streaks, the loss scale and the cumulative skip count. It
    lives on the device and is updated in place, so the guard makes no
    host round trip."""
    i32 = dict(dtype=torch.int32, device=device)
    return {"bad_streak": torch.zeros((), **i32),
            "good_streak": torch.zeros((), **i32),
            "loss_scale": torch.full((), loss_scale, dtype=torch.float32,
                                     device=device),
            "skipped": torch.zeros((), **i32)}
