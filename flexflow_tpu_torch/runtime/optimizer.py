"""Optimizers: SGD (momentum / nesterov / weight decay) and Adam, each with
an lr schedule, and ``FusedUpdate`` (the JAX package's
``runtime/optimizer.py``).

The update formulas are the reference kernels' (optimizer_kernel.cu:23-95
and :188-293), in ``ops/kernels.py update_math``:

  SGD  g += wd*w; v = mom*v + g; g = nesterov ? g + mom*v : v; w -= lr*g
  Adam m, v EMAs; w -= alpha_t*m / (sqrt(v) + eps), alpha_t = alpha *
       schedule(t) * sqrt(1 - beta2^(t+1)) / (1 - beta1^(t+1))

The arithmetic runs in an f32 view of each weight and is cast back to the
weight's storage dtype (``FFConfig.master_dtype``), as in the JAX package.
The JAX update is functional; here weights and state are updated in
place, which saves a copy of every weight a step. The step counter
``state["t"]``, the scheduled lr and alpha_t are device tensors: an update
never reads a value back to the host, so a step captured as a CUDA graph
replays it as it ran (``FFModel.train_scanned``).

``update`` takes an optional 0-dim bool tensor ``finite`` (the divergence
guard's verdict): when false, weights and state keep their bits.

Under a mesh the weights and the per-leaf state are DTensors of the same
placements (FSDP divides both by the axis size); the executor hands the
update each rank's local shards, so the kernel and its arithmetic are the
single device's.

On the card both optimizers update through one kernel,
``kernels.fused_update`` (``csrc/fused_update.cu``): the per-leaf
``Optimizer`` passes its state tensors leaf by leaf, ``FusedUpdate`` its
flat vectors, one launch a dtype bucket per 128 leaves either way. On the
CPU the per-leaf optimizer runs ``update_plain`` (``apply_update_plain``
leaf by leaf), the formula in torch operators, which the kernel matches
bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.kernels import UpdateRule
from flexflow_tpu_torch.parallel import local_tree
from flexflow_tpu_torch.runtime.schedule import resolve

Tree = Dict[str, Dict[str, torch.Tensor]]


def _leaves(tree: Tree) -> List[torch.Tensor]:
    return [w for ws in tree.values() for w in ws.values()]


def _device(params: Tree):
    """The weights' device (None, the CPU, for a graph without
    weights)."""
    leaves = _leaves(params)
    return leaves[0].device if leaves else None


def _buckets(params: Tree) -> Dict[torch.dtype, List[tuple]]:
    """{storage dtype: [(op, weight name), ...]} in walk order."""
    out: Dict[torch.dtype, List[tuple]] = {}
    for op, ws in params.items():
        for k, w in ws.items():
            out.setdefault(w.dtype, []).append((op, k))
    return out


def apply_update_plain(rule: UpdateRule, w: torch.Tensor, g: torch.Tensor,
                       moments, lr: torch.Tensor,
                       finite: Optional[torch.Tensor] = None) -> None:
    """The per-leaf update of one weight in torch operators, in place on
    ``w`` and its state tensors ``moments`` (storage dtype; f32
    arithmetic): the per-leaf optimizer's CPU path, and the formula the
    card's kernel is held to bit for bit."""
    wf, gf = w.float(), g.float()
    ms = [m.float() for m in moments]
    nw, nms = kernels.update_math(rule, wf, gf, ms, lr)
    if finite is not None:
        nw = torch.where(finite, nw, wf)
        nms = [torch.where(finite, a, b) for a, b in zip(nms, ms)]
    w.copy_(nw)
    for m, x in zip(moments, nms):
        m.copy_(x)


class Optimizer:
    """Base: an ``UpdateRule`` applied leaf by leaf. Subclasses set
    ``rule``, ``schedule`` and ``lr_of(t)``: the 0-dim f32 step size the
    rule takes at step counter t."""

    rule: UpdateRule

    def lr_of(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def init_state(self, params: Tree) -> Dict:
        """Zeroed state tensors like each weight (per moment name) and the
        step counter, an int32 device tensor."""
        names = self.moment_names()
        state = {k: {op: {n: torch.zeros_like(w) for n, w in ws.items()}
                     for op, ws in params.items()} for k in names}
        if "v" not in state:
            state["v"] = None
        state["t"] = torch.zeros((), dtype=torch.int32,
                                 device=_device(local_tree(params)))
        return state

    def moment_names(self) -> tuple:
        return ("m", "v")[2 - self.rule.n_moments:]

    @torch.no_grad()
    def update(self, params: Tree, grads: Tree, state,
               finite: Optional[torch.Tensor] = None) -> None:
        """One step, in place on ``params`` and ``state``: on the card the
        fused update kernel on the per-leaf state, a launch a dtype
        bucket; on the CPU ``update_plain``."""
        dev = _device(params)
        if dev is None or not dev.type == "cuda":
            return self.update_plain(params, grads, state, finite)
        lr = self.lr_of(state["t"])
        names = self.moment_names()
        for keys in _buckets(params).values():
            kernels.fused_update(
                self.rule, [params[op][k] for op, k in keys],
                [grads[op][k] for op, k in keys],
                [[state[n][op][k] for op, k in keys] for n in names],
                lr, finite)
        _advance(state["t"], finite)

    @torch.no_grad()
    def update_plain(self, params: Tree, grads: Tree, state,
                     finite: Optional[torch.Tensor] = None) -> None:
        """``update`` in torch operators, ``apply_update_plain`` leaf by
        leaf on the per-leaf state, on any device: the CPU's step, and the
        reference the card's kernel is held to bit for bit."""
        lr = self.lr_of(state["t"])
        names = self.moment_names()
        for op, ws in params.items():
            for k, w in ws.items():
                apply_update_plain(self.rule, w, grads[op][k],
                                   [state[n][op][k] for n in names], lr,
                                   finite)
        _advance(state["t"], finite)


def _advance(t: torch.Tensor, finite: Optional[torch.Tensor]) -> None:
    """t += 1, or += finite under the guard (a skipped step keeps t)."""
    t.add_(1 if finite is None else finite.to(t.dtype))


class SGDOptimizer(Optimizer):
    def __init__(self, model=None, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0,
                 schedule=None):
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay
        # lr schedule (runtime/schedule.py): a function of the device step
        # counter. None = constant (the reference's fixed-lr kernels)
        self.schedule = resolve(schedule)
        self.rule = UpdateRule("sgd", momentum=momentum, nesterov=nesterov,
                               weight_decay=weight_decay)

    def lr_of(self, t):
        return self.lr * self.schedule(t)


class AdamOptimizer(Optimizer):
    def __init__(self, model=None, alpha: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0,
                 epsilon: float = 1e-8, schedule=None):
        self.alpha = alpha
        self.beta1 = beta1
        self.beta2 = beta2
        self.weight_decay = weight_decay
        self.epsilon = epsilon
        self.schedule = resolve(schedule)
        self.rule = UpdateRule("adam", weight_decay=weight_decay,
                               beta1=beta1, beta2=beta2, epsilon=epsilon)

    def lr_of(self, t):
        """The bias-corrected step size of the reference's
        AdamOptimizer::next() (optimizer.cc:248-254), at step t + 1."""
        t1 = (t + 1).float()
        b1 = torch.full((), self.beta1, dtype=torch.float32, device=t.device)
        b2 = torch.full((), self.beta2, dtype=torch.float32, device=t.device)
        return self.alpha * self.schedule(t) \
            * torch.sqrt(1.0 - torch.pow(b2, t1)) / (1.0 - torch.pow(b1, t1))


class FusedUpdate(Optimizer):
    """One update a dtype bucket (``FFConfig.fused_optimizer``; the JAX
    package's ``FusedUpdate``, single-device branch).

    The inner optimizer's state is stored flat, one vector a bucket of
    weights of one storage dtype, in the order the weights are walked (as
    JAX stores it); weights and gradients stay separate tensors, and
    ``kernels.fused_update`` updates a bucket in one launch (its plain
    version on the CPU), with no concatenation pass on the card — the
    kernel the per-leaf optimizer launches too, on other pointers. A
    gradient whose dtype differs from its weight's (f32 grads of bf16
    weights, as grad accumulation gives) buckets by the weight's dtype.
    Values are bitwise the per-leaf update's: the kernel rounds the same
    operations in the same order.

    The state's layout differs from the per-leaf one, as in JAX."""

    def __init__(self, inner: Optimizer):
        self.inner = inner
        self.rule = inner.rule

    # schedule, lr etc. proxied for code that introspects the optimizer
    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def lr_of(self, t):
        return self.inner.lr_of(t)

    def init_state(self, params: Tree) -> Dict:
        """Flat state vectors of each dtype bucket; under a mesh of this
        rank's local shards (the flat cross-mesh layout of the JAX
        ``ShardedFusedUpdate`` is item 9's)."""
        params = local_tree(params)
        state = {}
        for n in self.moment_names():
            state[n] = {dt: torch.zeros(
                sum(params[op][k].numel() for op, k in keys), dtype=dt,
                device=params[keys[0][0]][keys[0][1]].device)
                for dt, keys in _buckets(params).items()}
        if "v" not in state:
            state["v"] = None
        state["t"] = torch.zeros((), dtype=torch.int32,
                                 device=_device(params))
        return state

    @torch.no_grad()
    def update(self, params: Tree, grads: Tree, state,
               finite: Optional[torch.Tensor] = None) -> None:
        lr = self.lr_of(state["t"])
        names = self.moment_names()
        for dt, keys in _buckets(params).items():
            kernels.fused_update(
                self.rule, [params[op][k] for op, k in keys],
                [grads[op][k] for op, k in keys],
                [state[n][dt] for n in names], lr, finite)
        _advance(state["t"], finite)
