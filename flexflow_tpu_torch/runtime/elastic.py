"""Elastic recovery at resume time (the JAX package's
``runtime/elastic.py``), for what one device can meet.

``apply_elastic_policy(model)`` runs in ``FFModel.compile`` whenever
``checkpoint_dir`` is set: it reads the newest intact checkpoint's
recorded topology and compares it with this process's, which in the port
is always one device. A checkpoint saved on one device resumes as it is
(and adopts the saved gradient-accumulation factor, as JAX's policy does
at an unchanged data degree). One saved on more devices is a topology
change: ``on_topology_change="abort"`` (or fewer survivors than
``elastic_min_devices``) raises ``TopologyChangedError``; the refit
policies ("resume_resharded", "research") need the mesh and re-sharding
of ROADMAP item 8 and raise ``NotImplementedError`` naming it, as does the
``shrink(<k>)@resume`` drill.

``mesh_candidates`` (the refit's search space) and ``ElasticDecision``
are the JAX package's, so the policy's arithmetic is shared.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional

import torch

from flexflow_tpu_torch.config import not_ported
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
    """The cards this process sees (``torch.cuda.device_count()``), or 1
    on the CPU. A model of the port runs on one of them. A scheduled
    ``shrink(<k>)@resume`` drill is refused: presenting fewer devices
    than the checkpoint's needs the mesh refit (ROADMAP item 8)."""
    if faultinject.active_plan().fire("shrink", "resume"):
        raise not_ported("the shrink@resume drill (a mesh refit onto fewer "
                         "devices)")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return max(1, n)


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
    one data axis (the port records no mesh and one device)."""
    mesh = {k: int(v) for k, v in (meta.get("mesh_shape") or {}).items()}
    if not mesh:
        mesh = {"data": max(1, int(meta.get("num_devices") or 1))}
    return mesh


def _preserve_global_batch(cfg, meta) -> int:
    """An unchanged data degree adopts the checkpoint's accumulation
    factor when it differs from the config's and the global batch is the
    same (the saved factor may be an earlier elastic resume's); returns
    the factor in force."""
    saved_accum = int(meta.get("grad_accum_steps", 1))
    saved_bs = int(meta.get("batch_size", cfg.batch_size))
    if int(cfg.batch_size) != saved_bs:
        log.warning(
            "elastic: config batch_size %d differs from the checkpoint's "
            "%d — the global batch is NOT preserved across this resume "
            "(explicit config change wins)", cfg.batch_size, saved_bs)
        return cfg.grad_accum_steps
    if saved_accum != cfg.grad_accum_steps \
            and cfg.batch_size % saved_accum == 0:
        log.info("elastic: adopting the checkpoint's grad_accum_steps %d "
                 "over the config's %d", saved_accum, cfg.grad_accum_steps)
        cfg.grad_accum_steps = saved_accum
    return cfg.grad_accum_steps


def check_saved_topology(cfg, meta: dict, step: int, directory: str):
    """Refuse a checkpoint saved on more devices than this process runs
    on: ``TopologyChangedError`` under "abort" or below
    ``elastic_min_devices``, ``NotImplementedError`` (ROADMAP item 8)
    under the refit policies. One device passes."""
    saved = _saved_mesh(meta)
    if _prod(saved) == 1:
        return
    if cfg.on_topology_change == "abort":
        raise TopologyChangedError(
            f"checkpoint at {directory} (step {step}) was saved on mesh "
            f"{saved} ({_prod(saved)} devices) but this process runs on "
            f"1 device and on_topology_change='abort' — re-provision the "
            f"original topology")
    if cfg.elastic_min_devices > 1:
        raise TopologyChangedError(
            f"elastic resume refused: 1 device < elastic_min_devices="
            f"{cfg.elastic_min_devices} (checkpoint was saved on "
            f"{_prod(saved)})")
    raise not_ported(
        f"resuming a checkpoint saved on {_prod(saved)} devices onto one "
        f"(on_topology_change={cfg.on_topology_change!r} refits the mesh)")


def apply_elastic_policy(model) -> Optional[ElasticDecision]:
    """Compile-time elastic hook (``FFModel.compile`` with
    ``checkpoint_dir`` set): reads the newest intact checkpoint's topology
    and applies ``on_topology_change`` against this process's one device.
    Returns the decision, or None when there is nothing to resume."""
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
    visible_device_count()      # where the shrink@resume drill fires
    check_saved_topology(cfg, meta, step, directory)
    decision = ElasticDecision(
        policy=cfg.on_topology_change, step=step, saved_mesh=saved_mesh,
        new_mesh={k: 1 for k in saved_mesh}, changed=False,
        saved_grad_accum=int(meta.get("grad_accum_steps", 1)),
        grad_accum=cfg.grad_accum_steps, strategy_source="default")
    decision.grad_accum = _preserve_global_batch(cfg, meta)
    return decision
