"""ffsan ``tracestability`` pass — the JAX package's retrace hazards
mapped onto the port, and the two hazards of CUDA-graph capture.

Rules (codes):
  implicit-device       (warning)  A tensor made by a torch factory
        (``torch.zeros``, ``torch.tensor``, ...) without ``device=``, or
        moved with ``.cuda()`` / ``.to("cuda")`` without an index: it lands
        on the default device (the CPU, or whichever card is current on
        the calling thread), and mixing it into a step on the model's
        device copies or fails there — the JAX package's
        ``uncommitted-device-put``. Pass the device.
  shape-dependent-slice (warning)  Python-level slicing of a device
        tensor with non-constant bounds in the serving hot path
        (serving.py, router.py): each distinct bound is a new shape
        downstream (a new graph or kernel plan). Slice on the host, or
        with a fixed output shape.
  torch-under-lock      (warning)  A statement-level ``torch.*`` call while
        holding a registered lock other than the engine's: device work
        queued (and allocator traffic) inside a critical section — the
        JAX ``jnp-under-lock``. ``torch`` inside a nested ``def`` /
        ``lambda`` is not flagged: it runs later.
  host-sync-in-capture  (warning)  A host value — ``.item()``,
        ``float(t)`` / ``int(t)``, ``.cpu()`` / ``.tolist()``,
        ``torch.tensor(host)`` — inside a CUDA-graph capture (the body of
        ``with torch.cuda.graph(...)``, or reachable from the function a
        ``kernels.capture`` captures): a capture cannot read the device,
        and a host copy is frozen into the graph.
  gc-in-capture         (warning)  ``gc.collect()`` reachable inside a
        capture: a collection may free another graph, and destroying a
        graph while a stream captures invalidates the capture
        (``kernels.capture`` turns the collector off for that reason).

The runtime complement is the sentinel over the engine's program dict
(runtime/locks.py ``RetraceSentinel``).
"""

from __future__ import annotations

from typing import List

from flexflow_tpu_torch.analysis.report import Violation
from flexflow_tpu_torch.analysis.sanitize.lockgraph import LockGraph

# rule 2's scope: the serving hot paths — a shape-dependent slice in
# offline checkpoint code is not a per-tick hazard
_HOT_MODULES = ("serving", "router")
_CAPTURE_CODES = {
    "host-sync-in-capture":
        "{what} inside a CUDA-graph capture{via}: a capture cannot read "
        "the device, and a host value is frozen into the graph",
    "gc-in-capture":
        "gc.collect() reachable inside a CUDA-graph capture{via}: a "
        "collection may destroy another graph mid-capture and "
        "invalidate it",
}


def check_tracestability(graph: LockGraph) -> List[Violation]:
    out: List[Violation] = []
    seen = set()

    def emit(code, msg, path, line, qual):
        key = (code, path, line)
        if key in seen or graph.allowed_at(code, path, line):
            return
        seen.add(key)
        out.append(Violation(code=code, pass_name="tracestability",
                             severity="warning", message=msg,
                             op_name=qual, file=path, line=line))

    for info in graph.functions.values():
        for what, path, line in info.implicit_devices:
            emit("implicit-device",
                 f"{what} without an explicit device lands on the default "
                 f"device — pass device= (the model's, or 'cpu' for a "
                 f"host tensor)", path, line, info.qualname)
        if info.module in _HOT_MODULES:
            for var, path, line in info.device_slices:
                emit("shape-dependent-slice",
                     f"Python-level slice of device tensor {var!r} with "
                     f"non-constant bounds in a serving hot path: each "
                     f"distinct bound is a new downstream shape — slice "
                     f"on the host or with a fixed output shape",
                     path, line, info.qualname)
        for held, callee_key, text, path, line in info.calls_under:
            rest = [h for h in held if h != "engine"]
            if rest and text.startswith("torch."):
                emit("torch-under-lock",
                     f"{text} while holding {rest}: device work inside a "
                     f"critical section — move it outside the lock",
                     path, line, info.qualname)
        for code, what, path, line in info.capture_hazards:
            emit(code, _CAPTURE_CODES[code].format(what=what, via=""),
                 path, line, info.qualname)
        for callee_key, cpath, cline in info.captures:
            callee = graph.functions.get(callee_key) \
                if callee_key else None
            if callee is None:
                continue
            via = (f" (captured at {cpath.rsplit('/', 1)[-1]}:{cline} "
                   f"through {callee.qualname})")
            for code, what, path, line in callee.trans_hazards:
                emit(code, _CAPTURE_CODES[code].format(what=what, via=via),
                     path, line, callee.qualname)
    return out
