"""ffsan lock-graph extraction — the AST substrate both source passes read
(the port's counterpart of the JAX package's
``analysis/sanitize/lockgraph.py``, with the port's blocking calls and
hazards).

One parse of every target file gives a ``LockGraph``:

  * which locks exist (``locks.make_*("name")`` on module globals and
    ``self.<attr>`` assignments, resolved to their declared names) and
    where raw ``threading`` primitives bypass the registry;
  * per function / method: the locks it acquires (``with`` regions,
    ``.acquire()``), the calls it makes while holding them, its blocking
    calls (``torch.cuda.synchronize``, an event's or stream's
    ``synchronize``, ``.item()``, ``.cpu()`` / ``.tolist()``, a CUDA
    graph's ``replay()``, ``torch.save`` / ``torch.load``, cv ``wait``,
    thread ``join``, ``sleep``), its statement-level ``torch.*`` calls,
    device tensors made without an explicit device, shape-dependent
    slices of device tensors, and what it does inside a CUDA-graph
    capture (a host read, ``gc.collect()``);
  * the intra-repo call graph — ``self.method()``, module functions,
    sibling-module functions (``flightrec.trip``) and
    ``self.<attr>.method()`` where the attribute's class is known from an
    assignment — so acquisition, blocking and capture-hazard sets
    propagate transitively, and an inversion two calls deep still names
    the call site that closes the cycle.

Nested ``def`` / ``lambda`` bodies are NOT part of the enclosing
function's held-lock context: they run later.

Waivers: ``# ffsan: allow(code[,code])`` anywhere on the statement's
source lines suppresses that code there (the pragma says why).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

_FACTORIES = {"make_lock", "make_rlock", "make_condition"}
_RAW_PRIMITIVES = {"Lock", "RLock", "Condition"}
_PRAGMA_RE = re.compile(r"#\s*ffsan:\s*allow\(([^)]*)\)")


def dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for nested Attribute/Name chains, ''
    otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class FuncInfo:
    """Everything one function/method contributes to the graph."""

    def __init__(self, module: str, qualname: str, path: str, line: int):
        self.module = module
        self.qualname = qualname
        self.path = path
        self.line = line
        self.key = (module, qualname)
        # lock name -> first acquisition site (path, line)
        self.acquires: Dict[str, Tuple[str, int]] = {}
        # direct nested acquisitions: (outer, inner, path, line)
        self.edges: List[Tuple[str, str, str, int]] = []
        # calls made while holding locks:
        #   (held names tuple, callee key or None, callee text, path, line)
        self.calls_under: List[Tuple[Tuple[str, ...],
                                     Optional[Tuple[str, str]],
                                     str, str, int]] = []
        # every resolvable call (held or not) for transitive propagation
        self.calls: Set[Tuple[str, str]] = set()
        # blocking operations: (marker, waived-lock-name or None, path,
        # line); the waived name is the cv a ``wait`` releases — held
        # locks OTHER than it are still held across the block
        self.blocking: List[Tuple[str, Optional[str], str, int]] = []
        # the subset that happens while THIS function holds locks:
        # (held names, marker, waived, path, line)
        self.held_blocking: List[Tuple[Tuple[str, ...], str,
                                       Optional[str], str, int]] = []
        # device tensors made or moved without an explicit device:
        # (what, path, line)
        self.implicit_devices: List[Tuple[str, str, int]] = []
        # host reads (a value brought to the host) and gc.collect() calls,
        # lexically inside a capture or not: (what, path, line)
        self.host_reads: List[Tuple[str, str, int]] = []
        self.collects: List[Tuple[str, int]] = []
        # capture sites: (callee key or None, path, line) of the function
        # a ``kernels.capture`` captures; hazards lexically inside a
        # ``with torch.cuda.graph(...)`` body: (code, what, path, line)
        self.captures: List[Tuple[Optional[Tuple[str, str]], str, int]] = []
        self.capture_hazards: List[Tuple[str, str, str, int]] = []
        # shape-dependent slices of device arrays: (var, path, line)
        self.device_slices: List[Tuple[str, str, int]] = []

    # filled by the fixpoint
    trans_acquires: Dict[str, Tuple[str, int]]
    trans_blocking: List[Tuple[str, Optional[str], str, int]]
    # (code, what, path, line) of host reads and collections reachable
    trans_hazards: List[Tuple[str, str, str, int]]


class ModuleInfo:
    def __init__(self, name: str, path: str):
        self.name = name
        self.path = path
        self.global_locks: Dict[str, str] = {}    # var -> lock name
        # class name -> {"attr_locks": {attr: name},
        #                "attr_types": {attr: class name}}
        self.classes: Dict[str, Dict] = {}
        self.functions: Dict[str, FuncInfo] = {}  # qualname -> info
        self.aliases: Set[str] = set()            # sibling-module names
        # raw threading primitive creations: (kind, path, line)
        self.raw_locks: List[Tuple[str, str, int]] = []
        # factory calls with a non-literal / unknown name argument
        self.unknown_factory: List[Tuple[str, str, int]] = []


class LockGraph:
    def __init__(self):
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[Tuple[str, str], FuncInfo] = {}
        self.class_owner: Dict[str, str] = {}     # class name -> module
        # file -> {line -> set of allowed codes}
        self.pragmas: Dict[str, Dict[int, Set[str]]] = {}

    def allowed(self, code: str, path: str, node: ast.AST) -> bool:
        lines = self.pragmas.get(path)
        if not lines:
            return False
        lo = getattr(node, "lineno", 0)
        hi = getattr(node, "end_lineno", lo) or lo
        return any(code in lines.get(ln, ()) for ln in range(lo, hi + 1))

    def allowed_at(self, code: str, path: str, line: int) -> bool:
        lines = self.pragmas.get(path)
        return bool(lines) and code in lines.get(line, set())


def _scan_pragmas(path: str, source: str) -> Dict[int, Set[str]]:
    """Pragmas apply to their own line; a pragma on a comment-only line
    also covers the following comment lines and the FIRST code line
    after them (the idiomatic justification-block placement)."""
    out: Dict[int, Set[str]] = {}
    lines = source.splitlines()
    for i, text in enumerate(lines, 1):
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
        out.setdefault(i, set()).update(codes)
        if text.strip().startswith("#"):
            j = i + 1
            while j <= len(lines) and lines[j - 1].strip().startswith("#"):
                out.setdefault(j, set()).update(codes)
                j += 1
            if j <= len(lines):
                out.setdefault(j, set()).update(codes)
    return out


def _factory_name(call: ast.Call) -> Optional[str]:
    """'engine' for ``locks.make_rlock("engine")``; None otherwise."""
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in _FACTORIES \
            or isinstance(fn, ast.Name) and fn.id in _FACTORIES:
        if call.args and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            return call.args[0].value
        return "?"      # non-literal name: flagged separately
    return None


def _raw_primitive(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in _RAW_PRIMITIVES \
            and dotted(fn).startswith("threading."):
        return fn.attr
    return None


class _Collector(ast.NodeVisitor):
    """Pass 1 over a module: lock declarations, attribute types, raw
    primitives, imports of sibling runtime modules."""

    def __init__(self, mod: ModuleInfo, known_classes: Set[str]):
        self.mod = mod
        self.known_classes = known_classes
        self._class: Optional[str] = None

    def visit_ImportFrom(self, node: ast.ImportFrom):
        for a in node.names:
            self.mod.aliases.add(a.asname or a.name.split(".")[-1])

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            self.mod.aliases.add(a.asname or a.name.split(".")[0])

    def visit_ClassDef(self, node: ast.ClassDef):
        prev, self._class = self._class, node.name
        self.mod.classes.setdefault(
            node.name, {"attr_locks": {}, "attr_types": {}})
        self.generic_visit(node)
        self._class = prev

    def visit_Assign(self, node: ast.Assign):
        if isinstance(node.value, ast.Call):
            name = _factory_name(node.value)
            kind = _raw_primitive(node.value)
            for tgt in node.targets:
                if name is not None:
                    if name == "?":
                        self.mod.unknown_factory.append(
                            ("non-literal lock name", self.mod.path,
                             node.lineno))
                    elif isinstance(tgt, ast.Name):
                        self.mod.global_locks[tgt.id] = name
                    elif self._is_self_attr(tgt):
                        self.mod.classes[self._class]["attr_locks"][
                            tgt.attr] = name
                elif self._is_self_attr(tgt):
                    cls = dotted(node.value.func).split(".")[-1]
                    if cls in self.known_classes:
                        self.mod.classes[self._class]["attr_types"][
                            tgt.attr] = cls
            if kind is not None:
                self.mod.raw_locks.append(
                    (kind, self.mod.path, node.lineno))
            return      # the Call is consumed; don't double-count
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        kind = _raw_primitive(node)
        if kind is not None:
            self.mod.raw_locks.append((kind, self.mod.path, node.lineno))
        self.generic_visit(node)

    def _is_self_attr(self, tgt) -> bool:
        return (self._class is not None and isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self")


class _FuncWalker(ast.NodeVisitor):
    """Pass 2 over one function body: held-lock regions, calls,
    blocking ops, implicit devices, device slices, capture hazards.
    Does NOT descend into nested def/lambda (deferred execution)."""

    def __init__(self, graph: LockGraph, mod: ModuleInfo,
                 cls: Optional[str], info: FuncInfo):
        self.graph = graph
        self.mod = mod
        self.cls = cls
        self.info = info
        self.held: List[str] = []
        # vars assigned from torch calls in THIS function (device tensors
        # a Python-level slice would give a new shape a bound)
        self.device_vars: Set[str] = set()
        # depth of ``with torch.cuda.graph(...)`` bodies around the walk
        self.in_graph = 0

    # -- deferred bodies are not part of this function's lock context --
    def visit_FunctionDef(self, node):      # noqa: N802
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    # -- lock resolution --
    def _resolve_lock(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            return self.mod.global_locks.get(node.id)
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" and self.cls:
            return self.mod.classes[self.cls]["attr_locks"].get(node.attr)
        return None

    def visit_With(self, node: ast.With):
        names = []
        graph = 0
        for item in node.items:
            name = self._resolve_lock(item.context_expr)
            if name is not None:
                self._note_acquire(name, node)
                names.append(name)
            else:
                expr = item.context_expr
                if isinstance(expr, ast.Call) and dotted(expr.func) in (
                        "torch.cuda.graph", "cuda.graph"):
                    graph = 1
                self.visit(expr)
        self.held.extend(names)
        self.in_graph += graph
        for stmt in node.body:
            self.visit(stmt)
        self.in_graph -= graph
        del self.held[len(self.held) - len(names):]

    def _note_acquire(self, name: str, node: ast.AST):
        self.info.acquires.setdefault(name,
                                      (self.mod.path, node.lineno))
        for outer in self.held:
            self.info.edges.append(
                (outer, name, self.mod.path, node.lineno))

    # -- assignments: device-array provenance --
    def visit_Assign(self, node: ast.Assign):
        self.visit(node.value)
        is_dev = isinstance(node.value, ast.Call) and \
            dotted(node.value.func).startswith("torch.")
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                if is_dev:
                    self.device_vars.add(tgt.id)
                else:
                    self.device_vars.discard(tgt.id)
            else:
                self.visit(tgt)

    # -- subscripts: shape-dependent slicing of device arrays --
    def visit_Subscript(self, node: ast.Subscript):
        if isinstance(node.value, ast.Name) \
                and node.value.id in self.device_vars \
                and isinstance(node.slice, ast.Slice):
            bounds = [b for b in (node.slice.lower, node.slice.upper,
                                  node.slice.step) if b is not None]
            if bounds and not all(isinstance(b, ast.Constant)
                                  for b in bounds):
                self.info.device_slices.append(
                    (node.value.id, self.mod.path, node.lineno))
        self.generic_visit(node)

    # -- calls --
    def visit_Call(self, node: ast.Call):
        text = dotted(node.func)
        callee = self._resolve_callee(node)
        if callee is not None:
            self.info.calls.add(callee)
        if self.held:
            self.info.calls_under.append(
                (tuple(self.held), callee, text or "<dynamic>",
                 self.mod.path, node.lineno))
        self._classify(node, text)
        self.generic_visit(node)

    def _resolve_callee(self, node: ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name):        # module-level function
            if fn.id in self.mod.functions:
                return (self.mod.name, fn.id)
            return None
        if not isinstance(fn, ast.Attribute):
            return None
        base = fn.value
        if isinstance(base, ast.Name):
            if base.id == "self" and self.cls:      # self.method()
                q = f"{self.cls}.{fn.attr}"
                if q in self.mod.functions:
                    return (self.mod.name, q)
                return None
            if base.id in self.mod.aliases:         # flightrec.trip()
                target = self.graph.modules.get(base.id)
                if target and fn.attr in target.functions:
                    return (base.id, fn.attr)
            return None
        # self.<attr>.method() with a known attribute class
        if isinstance(base, ast.Attribute) \
                and isinstance(base.value, ast.Name) \
                and base.value.id == "self" and self.cls:
            cls = self.mod.classes[self.cls]["attr_types"].get(base.attr)
            if cls:
                owner = self.graph.class_owner.get(cls)
                if owner is not None:
                    q = f"{cls}.{fn.attr}"
                    if q in self.graph.modules[owner].functions:
                        return (owner, q)
        return None

    def _note_blocking(self, marker: str, waived: Optional[str],
                       path: str, line: int):
        self.info.blocking.append((marker, waived, path, line))
        if self.held:
            self.info.held_blocking.append(
                (tuple(self.held), marker, waived, path, line))

    def _hazard(self, code: str, what: str, path: str, line: int):
        if code == "host-sync-in-capture":
            self.info.host_reads.append((what, path, line))
        else:
            self.info.collects.append((path, line))
        if self.in_graph:
            self.info.capture_hazards.append((code, what, path, line))

    def _classify(self, node: ast.Call, text: str):
        path, line = self.mod.path, node.lineno
        fn = node.func
        tail = fn.attr if isinstance(fn, ast.Attribute) else \
            (fn.id if isinstance(fn, ast.Name) else "")
        nargs = len(node.args) + len(node.keywords)
        if text == "torch.cuda.synchronize" or (
                tail == "synchronize" and isinstance(fn, ast.Attribute)):
            self._note_blocking("synchronize", None, path, line)
        elif tail == "wait" and isinstance(fn, ast.Attribute):
            cv = self._resolve_lock(fn.value)
            self._note_blocking("cv-wait", cv, path, line)
        elif tail == "join" and isinstance(fn, ast.Attribute) \
                and not node.args:
            # zero positional args: a thread/timer join, not str.join
            self._note_blocking("thread-join", None, path, line)
        elif text == "time.sleep":
            self._note_blocking("sleep", None, path, line)
        elif text in ("torch.save", "torch.load"):
            self._note_blocking("torch-io", None, path, line)
        elif tail == "replay" and isinstance(fn, ast.Attribute) \
                and not nargs:
            self._note_blocking("graph-replay", None, path, line)
        elif tail in ("item", "cpu", "tolist") \
                and isinstance(fn, ast.Attribute) and not nargs:
            self._note_blocking("host-read", None, path, line)
            self._hazard("host-sync-in-capture", f".{tail}()", path, line)
        elif tail == "acquire":
            name = self._resolve_lock(fn.value) if \
                isinstance(fn, ast.Attribute) else None
            if name is not None:
                self._note_acquire(name, node)
        if isinstance(fn, ast.Name) and fn.id in ("float", "int", "bool") \
                and len(node.args) == 1 and not isinstance(
                    node.args[0], ast.Constant):
            self._hazard("host-sync-in-capture", f"{fn.id}(...)", path,
                         line)
        if text in ("torch.tensor", "torch.as_tensor"):
            self._hazard("host-sync-in-capture", f"{text}(host value)",
                         path, line)
        if text == "gc.collect":
            self._hazard("gc-in-capture", "gc.collect()", path, line)
        if tail == "capture" and isinstance(fn, ast.Attribute) \
                and dotted(fn).endswith("kernels.capture") \
                or text == "capture":
            target = node.args[2] if len(node.args) >= 3 else next(
                (kw.value for kw in node.keywords if kw.arg == "fn"), None)
            callee = None
            if target is not None:
                callee = self._resolve_callee(ast.Call(
                    func=target, args=[], keywords=[]))
            self.info.captures.append((callee, path, line))
        self._implicit_device(node, text, tail, path, line)

    def _implicit_device(self, node: ast.Call, text: str, tail: str,
                         path: str, line: int):
        kws = {kw.arg for kw in node.keywords}
        if None in kws or "pin_memory" in kws:
            return      # a ``**kw`` splat may carry it; pinned is host
        if text.startswith("torch.") and tail in _FACTORY_FNS \
                and "device" not in kws:
            self.info.implicit_devices.append((f"{text}(...)", path, line))
        elif isinstance(node.func, ast.Attribute) and tail == "cuda" \
                and not node.args and "device" not in kws:
            self.info.implicit_devices.append((".cuda()", path, line))
        elif isinstance(node.func, ast.Attribute) and tail == "to" \
                and node.args and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == "cuda":
            self.info.implicit_devices.append(('.to("cuda")', path, line))


#: torch factories whose result lands on the default device unless told
#: otherwise (``*_like`` factories and ``from_numpy`` follow their input)
_FACTORY_FNS = {"zeros", "ones", "empty", "full", "arange", "tensor",
                "rand", "randn", "randint", "randperm", "linspace", "eye",
                "as_tensor"}


def _walk_functions(graph: LockGraph, mod: ModuleInfo, tree: ast.Module):
    """Register every function/method (top-level and one class deep),
    then walk each body."""
    def register(node, qual):
        info = FuncInfo(mod.name, qual, mod.path, node.lineno)
        mod.functions[qual] = info
        graph.functions[info.key] = info
        return info

    targets = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            targets.append((None, node, register(node, node.name)))
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    targets.append(
                        (node.name, sub,
                         register(sub, f"{node.name}.{sub.name}")))
    return targets


def build_lockgraph(files: List[str]) -> LockGraph:
    graph = LockGraph()
    trees: Dict[str, ast.Module] = {}
    known_classes: Set[str] = set()

    for path in files:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        name = os.path.splitext(os.path.basename(path))[0]
        trees[name] = ast.parse(source, filename=path)
        graph.pragmas[path] = _scan_pragmas(path, source)
        graph.modules[name] = ModuleInfo(name, path)
        for node in trees[name].body:
            if isinstance(node, ast.ClassDef):
                known_classes.add(node.name)
                graph.class_owner[node.name] = name

    # pass 1: declarations; register functions (so cross-module call
    # resolution in pass 2 sees every target)
    walk_targets = []
    for name, mod in graph.modules.items():
        _Collector(mod, known_classes).visit(trees[name])
        walk_targets.append((mod, _walk_functions(graph, mod,
                                                  trees[name])))

    # pass 2: function bodies
    for mod, targets in walk_targets:
        for cls, node, info in targets:
            walker = _FuncWalker(graph, mod, cls, info)
            for stmt in node.body:
                walker.visit(stmt)

    # fixpoint: propagate acquisition + blocking sets through the call
    # graph (bounded: sets only grow, the lattice is finite)
    for info in graph.functions.values():
        info.trans_acquires = dict(info.acquires)
        info.trans_blocking = list(info.blocking)
        info.trans_hazards = (
            [("host-sync-in-capture", w, p, ln)
             for w, p, ln in info.host_reads]
            + [("gc-in-capture", "gc.collect()", p, ln)
               for p, ln in info.collects])
    changed = True
    while changed:
        changed = False
        for info in graph.functions.values():
            for callee_key in info.calls:
                callee = graph.functions.get(callee_key)
                if callee is None:
                    continue
                for lock, site in callee.trans_acquires.items():
                    if lock not in info.trans_acquires:
                        info.trans_acquires[lock] = site
                        changed = True
                have = {(m, w) for m, w, _, _ in info.trans_blocking}
                for m, w, p, ln in callee.trans_blocking:
                    if (m, w) not in have:
                        info.trans_blocking.append((m, w, p, ln))
                        changed = True
                seen = {(p, ln) for _, _, p, ln in info.trans_hazards}
                for hz in callee.trans_hazards:
                    if (hz[2], hz[3]) not in seen:
                        info.trans_hazards.append(hz)
                        changed = True
    return graph
