"""ffsan — static concurrency and capture-stability analysis of the
port's sources (the JAX package's ``analysis/sanitize``).

Two source-level passes over ``flexflow_tpu_torch/runtime`` (no model, no
device, no torch import in the analysis — pure ``ast``):

  concurrency     — extracts the lock graph (which locks each function
                    acquires, ``with self._lock``-style attributes
                    resolved through the declared hierarchy in
                    runtime/locks.py, propagated through the intra-repo
                    call graph) and reports acquisition-order inversions,
                    locks held across blocking calls, and raw
                    ``threading.Lock()`` creations that bypass the
                    registry.
  tracestability  — tensors made without an explicit device,
                    shape-dependent slices of device tensors in the
                    serving hot path, ``torch.*`` under a lock, and host
                    reads or collections inside a CUDA-graph capture.

By-design sites are waived with an end-of-line pragma::

    something()   # ffsan: allow(<code>) — why this is safe

and one structural waiver: the ENGINE lock is held across the whole
serving tick, its device work included (serving.py's tick contract). The
runtime sanitizer (FF_SANITIZE=1, runtime/locks.py) is the dynamic
complement.

Entry points:
  analyze_sources(paths, passes) -> Report       (library)
  python -m flexflow_tpu_torch.analysis --passes concurrency,tracestability
                                                 (CLI, see __main__)
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional

from flexflow_tpu_torch.analysis.report import Report, Violation

__all__ = ["SOURCE_PASSES", "analyze_sources", "default_paths"]

SOURCE_PASSES = ("concurrency", "tracestability")


def default_paths() -> List[str]:
    """The default analysis target: every .py file in
    flexflow_tpu_torch/runtime (the threaded, device-dispatching layer
    whose invariants these passes pin)."""
    here = os.path.dirname(os.path.abspath(__file__))
    runtime = os.path.join(os.path.dirname(os.path.dirname(here)),
                           "runtime")
    return [runtime]


def _py_files(paths: Iterable[str]) -> List[str]:
    out = []
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                if name.endswith(".py"):
                    out.append(os.path.join(p, name))
        elif p.endswith(".py"):
            out.append(p)
        else:
            raise FileNotFoundError(
                f"ffsan: {p!r} is neither a directory nor a .py file")
    return out


def analyze_sources(paths: Optional[Iterable[str]] = None,
                    passes: Iterable[str] = SOURCE_PASSES) -> Report:
    """Run the requested source passes. Same contract as analyze():
    nothing raises on bad code — everything is a Violation; an internal
    analyzer fault degrades to an ``internal-error`` warning."""
    from flexflow_tpu_torch.analysis.sanitize.concurrency import check_concurrency
    from flexflow_tpu_torch.analysis.sanitize.lockgraph import build_lockgraph
    from flexflow_tpu_torch.analysis.sanitize.tracestability import (
        check_tracestability)

    report = Report()
    files = _py_files(paths if paths is not None else default_paths())
    try:
        graph = build_lockgraph(files)
    except Exception as e:   # never let the analyzer crash the caller
        report.add(Violation(
            code="internal-error", pass_name="concurrency",
            severity="warning",
            message=f"lock-graph extraction crashed: "
                    f"{type(e).__name__}: {e}"))
        return report
    if "concurrency" in passes:
        _guard(report, "concurrency", lambda: check_concurrency(graph))
    if "tracestability" in passes:
        _guard(report, "tracestability",
               lambda: check_tracestability(graph))
    return report


def _guard(report: Report, name: str, fn) -> None:
    try:
        report.extend(fn())
    except Exception as e:
        report.add(Violation(
            code="internal-error", pass_name=name, severity="warning",
            message=f"{name} pass crashed: {type(e).__name__}: {e}"))
