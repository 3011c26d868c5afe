"""The divergence guard's device state and the preemption-notice entry
point (the JAX package's ``runtime/resilience.py`` ``init_guard_state``
and ``install_sigterm``). The rest of that module — ``TrainSupervisor``,
checkpoints — is ROADMAP.md queue 1, item 11."""

from __future__ import annotations

import signal
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


def install_sigterm(handler):
    """Install ``handler`` as the SIGTERM disposition — the one
    preemption-notice entry point (``ServingRouter.install_preempt_handler``
    routes the cloud's preemption signal through here). Returns
    ``(installed, previous_disposition)`` — ``(False, None)`` off the main
    thread (the signal module's rule), where the owner must call its
    programmatic ``request_preempt()`` instead."""
    try:
        return True, signal.signal(signal.SIGTERM, handler)
    except ValueError:
        return False, None
