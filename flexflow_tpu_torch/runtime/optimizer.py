"""SGD (the JAX package's ``runtime/optimizer.py`` ``SGDOptimizer``).

The update formula is the reference kernel's (optimizer_kernel.cu:23-95):
g += wd * w; v = mom * v + g; g = nesterov ? g + mom * v : v; w -= lr * g.
The arithmetic runs in an f32 view of each weight and is cast back to the
weight's storage dtype (``FFConfig.master_dtype``), as in the JAX package.
The JAX update is functional; here weights and the momentum buffers are
updated in place, which saves a copy of every weight per step.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from flexflow_tpu_torch.config import ROADMAP_TRAIN_LOOP, not_ported

Tree = Dict[str, Dict[str, torch.Tensor]]


def _f32_view(*tensors):
    """The update's operands in f32 (a no-op for f32 storage)."""
    return tuple(None if t is None else t.float() for t in tensors)


class SGDOptimizer:
    def __init__(self, model=None, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0,
                 schedule=None):
        if schedule is not None:
            raise not_ported("learning-rate schedules", where=ROADMAP_TRAIN_LOOP)
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def init_state(self, params: Tree) -> Dict[str, Optional[Tree]]:
        v = None
        if self.momentum > 0.0:
            v = {op: {k: torch.zeros_like(w) for k, w in ws.items()}
                 for op, ws in params.items()}
        return {"v": v, "t": 0}

    @torch.no_grad()
    def update(self, params: Tree, grads: Tree, state) -> None:
        """One step, in place on ``params`` and ``state``."""
        mom, wd, lr = self.momentum, self.weight_decay, self.lr
        for op, ws in params.items():
            for k, w in ws.items():
                wf, g = _f32_view(w, grads[op][k])
                if wd:
                    g = g + wd * wf
                if mom > 0.0:
                    v = state["v"][op][k]
                    vf = mom * v.float() + g
                    v.copy_(vf)
                    g = g + mom * vf if self.nesterov else vf
                w.copy_(wf - lr * g)
        state["t"] += 1
