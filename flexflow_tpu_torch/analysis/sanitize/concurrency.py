"""ffsan ``concurrency`` pass — lock-order inversions, locks held across
blocking calls, and registry bypasses, from the static lock graph alone
(the JAX package's four rules, over the port's sources).

Rules (codes):
  lock-order-inversion  (error)   An acquisition edge A -> B whose
        declared ranks (runtime/locks.py LOCK_RANKS, the JAX table) are
        not strictly increasing — the A->B / B->A deadlock shape. Edges
        are nested ``with`` regions and calls made under a lock to a
        function whose TRANSITIVE acquisition set holds the inner lock.
        Same-name edges are skipped: an RLock re-acquire is legal, and two
        same-rank objects cannot be told apart statically (the runtime
        sanitizer catches those).
  lock-across-blocking  (warning) A blocking call — ``torch.cuda.
        synchronize``, an event's or stream's ``synchronize``, ``.item()``,
        ``.cpu()`` / ``.tolist()``, a CUDA graph's ``replay()``,
        ``torch.save`` / ``torch.load``, cv ``wait``, thread ``join``,
        ``sleep`` — reached while holding a registered lock: every other
        thread needing that lock stalls for the block's duration. A
        ``wait`` does not count against the cv it releases. Structural
        waiver: the ENGINE lock is held across the whole tick, device
        work and its host reads included (serving.py's tick contract), so
        those under the engine lock alone are by design.
  raw-lock              (error)   A ``threading.Lock/RLock/Condition``
        created directly instead of through ``locks.make_*``: invisible to
        the hierarchy, the runtime sanitizer and this pass.
  unknown-lock-name     (error)   A ``locks.make_*`` call whose name is
        not declared in LOCK_RANKS (or is not a string literal).
"""

from __future__ import annotations

from typing import List

from flexflow_tpu_torch.analysis.report import Violation
from flexflow_tpu_torch.analysis.sanitize.lockgraph import LockGraph
from flexflow_tpu_torch.runtime.locks import LOCK_RANKS

# markers the engine tick contract waives (serving.py: ONE engine lock
# across the whole tick, its device work, graph replays and host reads
# included)
_ENGINE_WAIVED = {"synchronize", "graph-replay", "host-read"}


def _v(code, severity, message, path, line, qual=None) -> Violation:
    return Violation(code=code, pass_name="concurrency",
                     severity=severity, message=message, op_name=qual,
                     file=path, line=line)


def check_concurrency(graph: LockGraph) -> List[Violation]:
    out: List[Violation] = []
    seen = set()

    def emit(code, severity, msg, path, line, qual=None):
        key = (code, path, line, msg)
        if key in seen or graph.allowed_at(code, path, line):
            return
        seen.add(key)
        out.append(_v(code, severity, msg, path, line, qual))

    # ---- registry bypasses + undeclared names ----
    for mod in graph.modules.values():
        for kind, path, line in mod.raw_locks:
            emit("raw-lock", "error",
                 f"raw threading.{kind}() bypasses the lock registry — "
                 f"create it with locks.make_{kind.lower()}(<name>) so "
                 f"it carries a declared rank", path, line)
        for why, path, line in mod.unknown_factory:
            emit("unknown-lock-name", "error",
                 f"locks.make_* with a {why}: the hierarchy can only "
                 f"rank string-literal names from LOCK_RANKS",
                 path, line)
        for scope, table in (
                [("module", mod.global_locks)]
                + [(cls, c["attr_locks"])
                   for cls, c in mod.classes.items()]):
            for var, name in table.items():
                if name not in LOCK_RANKS:
                    emit("unknown-lock-name", "error",
                         f"lock {var!r} ({scope}) uses undeclared name "
                         f"{name!r}; declare it in "
                         f"runtime/locks.py LOCK_RANKS",
                         mod.path, 1)

    # ---- acquisition-order inversions ----
    for info in graph.functions.values():
        for outer, inner, path, line in info.edges:
            _check_edge(emit, info.qualname, outer, inner, path, line,
                        via=None)
        for held, callee_key, text, path, line in info.calls_under:
            callee = graph.functions.get(callee_key) \
                if callee_key else None
            if callee is None:
                continue
            for inner, site in callee.trans_acquires.items():
                if graph.allowed_at("lock-order-inversion",
                                    site[0], site[1]):
                    continue
                for outer in held:
                    _check_edge(emit, info.qualname, outer, inner,
                                path, line,
                                via=f"{text} -> {callee.qualname} "
                                    f"({site[0].rsplit('/', 1)[-1]}:"
                                    f"{site[1]})")

    # ---- locks held across blocking calls ----
    for info in graph.functions.values():
        for held, marker, waived, path, line in info.held_blocking:
            _check_blocking(emit, info.qualname, held, marker, waived,
                            path, line, via=None)
        for held, callee_key, text, path, line in info.calls_under:
            callee = graph.functions.get(callee_key) \
                if callee_key else None
            if callee is None:
                continue
            for marker, waived, bpath, bline in callee.trans_blocking:
                if graph.allowed_at("lock-across-blocking",
                                    bpath, bline):
                    continue
                _check_blocking(
                    emit, info.qualname, held, marker, waived, path,
                    line,
                    via=f"{text} -> {bpath.rsplit('/', 1)[-1]}:{bline}")
    return out


def _check_edge(emit, qual, outer, inner, path, line, via):
    if outer == inner:
        return
    ro, ri = LOCK_RANKS.get(outer), LOCK_RANKS.get(inner)
    if ro is None or ri is None or ri > ro:
        return
    chain = f" via {via}" if via else ""
    emit("lock-order-inversion", "error",
         f"acquires {inner!r}(rank {ri}) while holding {outer!r}"
         f"(rank {ro}){chain}: the declared order is strictly "
         f"increasing rank — another thread nesting them the other way "
         f"deadlocks", path, line, qual)


def _check_blocking(emit, qual, held, marker, waived, path, line, via):
    still_held = [h for h in held if h != waived]
    if not still_held:
        return
    if still_held == ["engine"] and marker in _ENGINE_WAIVED:
        return      # documented engine tick contract
    chain = f" via {via}" if via else ""
    emit("lock-across-blocking", "warning",
         f"{marker} while holding {still_held}{chain}: every thread "
         f"needing {'that lock' if len(still_held) == 1 else 'them'} "
         f"stalls for the block's duration — release first, or pragma "
         f"the contract", path, line, qual)
