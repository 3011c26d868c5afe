"""Elastic recovery at resume time (the JAX package's
``runtime/elastic.py``).

``apply_elastic_policy(model)`` runs in ``FFModel.compile`` whenever
``checkpoint_dir`` is set, before the mesh is built: it reads the newest
intact checkpoint's recorded mesh and compares it with the mesh this
process builds — ``FFConfig.mesh_shape``, else ``{"data": world}`` across
ranks, else one device. An unchanged mesh resumes as it is (adopting the
saved gradient-accumulation factor). A changed one is a topology change:
``on_topology_change="abort"`` (or fewer devices than
``elastic_min_devices``) raises ``TopologyChangedError``;
"resume_resharded" re-derives the saved strategy table on the new mesh
(``_rederive_strategies``) and keeps the global batch by scaling the
accumulation factor with the data degree (``_preserve_global_batch``);
the restore then copies each rank's slice of the saved whole tensors
(runtime/checkpoint.py). What chooses a mesh with the cost model — the
ranked refit when the requested mesh needs more devices than the world
has, "research", and the ``shrink(<k>)@resume`` drill that presents
fewer devices — raises ``NotImplementedError`` naming ROADMAP item 10.

``mesh_candidates`` (the refit's search space) and ``ElasticDecision``
are the JAX package's, so the policy's arithmetic is shared.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional

import torch

from flexflow_tpu_torch.config import ROADMAP_SEARCH, not_ported
from flexflow_tpu_torch.runtime import faultinject

log = logging.getLogger("flexflow_tpu_torch")


class TopologyChangedError(RuntimeError):
    """The resuming process's topology differs from the checkpoint's and
    the configured policy refuses to adapt (``on_topology_change="abort"``
    or fewer than ``elastic_min_devices`` survivors)."""


@dataclasses.dataclass
class ElasticDecision:
    """What the elastic policy did at compile time (``model._elastic``)."""

    policy: str
    step: int
    saved_mesh: Dict[str, int]
    new_mesh: Dict[str, int]
    changed: bool
    saved_grad_accum: int
    grad_accum: int
    strategy_source: str            # "checkpoint" | "research" | "default"
    ranked_candidates: int = 0

    @property
    def saved_devices(self) -> int:
        return _prod(self.saved_mesh)

    @property
    def devices(self) -> int:
        return _prod(self.new_mesh)


def _prod(shape: Dict[str, int]) -> int:
    n = 1
    for v in shape.values():
        n *= int(v)
    return n


def visible_device_count() -> int:
    """The devices this process's mesh can span: the ranks of its process
    group (one a device), or 1 alone. A scheduled ``shrink(<k>)@resume``
    drill is refused: presenting fewer devices than the checkpoint's needs
    the cost model's ranked refit (ROADMAP item 10)."""
    if faultinject.active_plan().fire("shrink", "resume"):
        raise not_ported("the shrink@resume drill (a mesh refit onto fewer "
                         "devices, ranked by the cost model)",
                         ROADMAP_SEARCH)
    from flexflow_tpu_torch.parallel.mesh import world_size

    return max(1, world_size())


def mesh_candidates(saved_mesh: Dict[str, int], num_devices: int,
                    cap: int = 64) -> List[Dict[str, int]]:
    """All factorizations of ``num_devices`` over the saved mesh's axis
    names (axis order preserved; size-1 axes kept)."""
    axes = [a for a in saved_mesh] or ["data"]
    out: List[Dict[str, int]] = []

    def rec(i: int, remaining: int, acc: Dict[str, int]):
        if len(out) >= cap:
            return
        if i == len(axes) - 1:
            out.append({**acc, axes[i]: remaining})
            return
        d = 1
        while d <= remaining:
            if remaining % d == 0:
                rec(i + 1, remaining // d, {**acc, axes[i]: d})
            d += 1

    rec(0, max(1, int(num_devices)), {})
    return out


def _saved_mesh(meta: dict) -> Dict[str, int]:
    """The checkpoint's mesh: the recorded one, else its device count on
    one data axis (a one-device checkpoint records no mesh)."""
    mesh = {k: int(v) for k, v in (meta.get("mesh_shape") or {}).items()}
    if not mesh:
        mesh = {"data": max(1, int(meta.get("num_devices") or 1))}
    return mesh


def _current_mesh(cfg, saved: Dict[str, int], world: int) -> Dict[str, int]:
    """The mesh this process builds (``FFModel._build_mesh``'s rule): the
    configured one, ``{"data": world}`` across ranks, else one device —
    the saved axes at size 1, so a one-device resume compares equal to a
    one-device save."""
    if cfg.mesh_shape:
        return {k: int(v) for k, v in cfg.mesh_shape.items()}
    if world > 1:
        return {"data": world}
    return {k: 1 for k in saved}


def _saved_strategies(directory: str, step: int):
    """The checkpoint's strategy table (per-step ``strategy.txt``, else
    the top-level mirror), or {} when unreadable."""
    from flexflow_tpu_torch.parallel.strategy import \
        load_strategies_from_file

    per_step = os.path.join(os.path.abspath(directory), f"step_{step}",
                            "strategy.txt")
    path = per_step if os.path.exists(per_step) \
        else os.path.join(os.path.abspath(directory), "strategy.txt")
    try:
        return load_strategies_from_file(path)
    except (FileNotFoundError, ValueError) as e:
        log.warning("elastic: checkpoint strategy file unreadable (%s) — "
                    "resuming with default strategies", e)
        return {}


def _rederive_strategies(model, saved, new_mesh: Dict[str, int]):
    """Re-partition (the JAX ``_rederive_strategies``): each op keeps its
    saved axis map, restricted to the new mesh's axes, with degrees
    re-derived from the new axis sizes; an op whose map no longer divides
    falls back to the default, named in the log."""
    from flexflow_tpu_torch.ops.base import InputOp
    from flexflow_tpu_torch.parallel.pconfig import ParallelConfig

    out = {}
    for op in model.ops:
        if isinstance(op, InputOp):
            continue
        pc = saved.get(op.name)
        am = getattr(pc, "axis_map", None) if pc is not None else None
        if not am:
            continue
        am = {ax: d for ax, d in am.items() if ax in new_mesh}
        try:
            out[op.name] = ParallelConfig.from_axis_map(
                op.outputs[0].num_dims, new_mesh, am)
        except Exception as e:  # noqa: BLE001 — logged, then the default
            log.warning("elastic: saved strategy for %r does not re-derive "
                        "on mesh %s (%s) — using the default for this op",
                        op.name, new_mesh, e)
    return out


def _preserve_global_batch(cfg, meta, saved_mesh: Dict[str, int],
                           new_mesh: Dict[str, int]) -> int:
    """Global-batch preservation (the JAX ``_preserve_global_batch``):
    ``batch_size`` (the global batch) stays, and the per-device microbatch
    too, by scaling the accumulation factor with the data degree —
    accum' = accum_saved * d_old / d_new. An unchanged degree adopts the
    saved factor (it may be an earlier elastic resume's). Returns the
    factor in force (``cfg`` updated); keeps the config's, with a
    warning, when the ratio is not integral or the batch stops
    dividing."""
    saved_accum = int(meta.get("grad_accum_steps", 1))
    saved_bs = int(meta.get("batch_size", cfg.batch_size))
    if int(cfg.batch_size) != saved_bs:
        log.warning(
            "elastic: config batch_size %d differs from the checkpoint's "
            "%d — the global batch is NOT preserved across this resume "
            "(explicit config change wins)", cfg.batch_size, saved_bs)
        return cfg.grad_accum_steps
    d_old = int(saved_mesh.get("data", 1))
    d_new = int(new_mesh.get("data", 1))
    num = saved_accum * d_old
    if num % d_new == 0 and cfg.batch_size % (num // d_new) == 0:
        new_accum = num // d_new
        if new_accum != cfg.grad_accum_steps:
            log.info("elastic: data degree %d -> %d; grad_accum_steps %d "
                     "-> %d keeps the global batch at %d", d_old, d_new,
                     cfg.grad_accum_steps, new_accum, cfg.batch_size)
            cfg.grad_accum_steps = new_accum
        return new_accum
    log.warning(
        "elastic: cannot scale grad_accum_steps for data degree %d -> %d "
        "(saved accum %d, batch %d): ratio not integral — global batch is "
        "preserved but the per-device microbatch changes",
        d_old, d_new, saved_accum, cfg.batch_size)
    return cfg.grad_accum_steps


def check_saved_topology(cfg, meta: dict, step: int, directory: str,
                         current: Optional[Dict[str, int]] = None) -> bool:
    """The policy's refusals for a checkpoint whose mesh differs from
    ``current`` (default: the mesh this process builds): under "abort" or
    below ``elastic_min_devices`` ``TopologyChangedError``, under
    "research" ``NotImplementedError`` (ROADMAP item 10). Returns whether
    the topology changed ("resume_resharded" proceeds: the restore copies
    each rank's slice)."""
    saved = _saved_mesh(meta)
    if current is None:
        current = _current_mesh(cfg, saved, visible_device_count())
    if current == saved:
        return False
    if cfg.on_topology_change == "abort":
        raise TopologyChangedError(
            f"checkpoint at {directory} (step {step}) was saved on mesh "
            f"{saved} ({_prod(saved)} devices) but this process has mesh "
            f"{current} ({_prod(current)} devices) and "
            f"on_topology_change='abort' — re-provision the original "
            f"topology or set the policy to 'resume_resharded'")
    if _prod(current) < int(cfg.elastic_min_devices):
        raise TopologyChangedError(
            f"elastic resume refused: {_prod(current)} surviving devices < "
            f"elastic_min_devices={cfg.elastic_min_devices} (checkpoint "
            f"was saved on {_prod(saved)})")
    if cfg.on_topology_change == "research":
        raise not_ported("the strategy re-search of an elastic resume "
                         "(on_topology_change='research')", ROADMAP_SEARCH)
    return True


def apply_elastic_policy(model) -> Optional[ElasticDecision]:
    """Compile-time elastic hook (``FFModel.compile`` with
    ``checkpoint_dir`` set, before the mesh is built): reads the newest
    intact checkpoint's mesh, compares it with the one this process
    builds, and applies ``on_topology_change``: the config's strategies
    and accumulation factor are updated in place. Returns the decision,
    or None when there is nothing to resume."""
    from flexflow_tpu_torch.runtime.checkpoint import (latest_intact_step,
                                                       load_meta)

    cfg = model.config
    directory = cfg.checkpoint_dir
    if not directory:
        return None
    verify = bool(cfg.verify_checkpoints)
    step = latest_intact_step(directory, verify=verify)
    if step is None:
        return None
    if verify:
        # the resume paths skip re-hashing this step, for this directory
        model._elastic_verified_step = step
        model._elastic_verified_dir = os.path.abspath(directory)
    meta = load_meta(directory, step)
    saved_mesh = _saved_mesh(meta)
    avail = visible_device_count()      # where the shrink@resume drill fires
    new_mesh = _current_mesh(cfg, saved_mesh, avail)
    if _prod(new_mesh) > avail:
        raise not_ported(
            f"the ranked mesh refit (mesh {new_mesh} needs "
            f"{_prod(new_mesh)} devices, this process group has {avail}; "
            f"the cost model ranks the candidates)", ROADMAP_SEARCH)
    changed = check_saved_topology(cfg, meta, step, directory, new_mesh)
    decision = ElasticDecision(
        policy=cfg.on_topology_change, step=step, saved_mesh=saved_mesh,
        new_mesh=dict(new_mesh), changed=changed,
        saved_grad_accum=int(meta.get("grad_accum_steps", 1)),
        grad_accum=cfg.grad_accum_steps, strategy_source="default")
    if changed:
        rederived = _rederive_strategies(
            model, _saved_strategies(directory, step), new_mesh)
        if rederived:
            cfg.strategies.update(rederived)
            decision.strategy_source = "checkpoint"
        log.warning("elastic: topology changed %s (%d devices) -> %s (%d "
                    "devices); policy=%s, strategies=%s", saved_mesh,
                    _prod(saved_mesh), new_mesh, _prod(new_mesh),
                    decision.policy, decision.strategy_source)
    decision.grad_accum = _preserve_global_batch(cfg, meta, saved_mesh,
                                                 new_mesh)
    return decision
