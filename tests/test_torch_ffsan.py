"""The port's ffsan static passes (flexflow_tpu_torch/analysis/sanitize):

  * the ``concurrency`` fixtures of tests/test_ffsan.py (direct and
    transitive inversions, a lock held across a blocking call, the engine
    waiver, a raw lock and its pragma, an undeclared name) give the same
    (code, line) findings through both packages' passes;
  * a seeded fixture for each ``tracestability`` rule of the port
    (implicit-device, shape-dependent-slice, torch-under-lock,
    host-sync-in-capture, gc-in-capture), each at its file:line, and the
    nested-def exemption;
  * the port's runtime is clean at head, and every lock in it comes from
    the registry under a declared name;
  * the CLI's tiered exit codes, its JSON format, and the graph passes
    refused as not ported.
"""

import json
import os

import pytest

from flexflow_tpu.analysis.sanitize import analyze_sources as j_analyze
from flexflow_tpu.runtime.locks import LOCK_RANKS as J_RANKS
from flexflow_tpu_torch.analysis.__main__ import main as ffsan_main
from flexflow_tpu_torch.analysis.sanitize import (analyze_sources,
                                                  default_paths)
from flexflow_tpu_torch.analysis.sanitize.lockgraph import build_lockgraph
from flexflow_tpu_torch.runtime.locks import LOCK_RANKS

# tests/test_ffsan.py's concurrency fixtures; where JAX's blocks on
# block_until_ready (no torch counterpart) the block is a sleep, which
# both packages' passes mark
CONCURRENCY = {
    "inv.py": ("""\
from flexflow_tpu.runtime import locks
_eng = locks.make_rlock("engine")
_rt = locks.make_rlock("router")

def tick():
    with _eng:
        with _rt:        # router(10) under engine(20): inverted
            pass
""", [("lock-order-inversion", 7)]),
    "trans.py": ("""\
from flexflow_tpu.runtime import locks
_eng = locks.make_rlock("engine")
_rt = locks.make_rlock("router")

def _admit():
    with _rt:
        pass

def tick():
    with _eng:
        _admit()         # acquires router(10) under engine(20)
""", [("lock-order-inversion", 11)]),
    "blk.py": ("""\
import time
from flexflow_tpu.runtime import locks
_rt = locks.make_rlock("router")

def flush():
    with _rt:
        time.sleep(0.1)
""", [("lock-across-blocking", 7)]),
    "raw.py": ("""\
import threading
_a = threading.Lock()
_b = threading.Lock()   # ffsan: allow(raw-lock) — test waiver
""", [("raw-lock", 2)]),
    "unk.py": ("""\
from flexflow_tpu.runtime import locks
_x = locks.make_lock("not-a-declared-name")
""", [("unknown-lock-name", 1)]),
}


def _seed(tmp_path, name, src):
    f = tmp_path / name
    f.write_text(src)
    return str(f)


def _found(report):
    return sorted((v.code, v.line) for v in report.violations)


@pytest.mark.parametrize("name", sorted(CONCURRENCY))
def test_concurrency_fixtures_match_jax(tmp_path, name):
    src, want = CONCURRENCY[name]
    path = _seed(tmp_path, name, src)
    passes = ("concurrency",)
    got = analyze_sources(paths=[path], passes=passes)
    assert _found(got) == _found(j_analyze(paths=[path], passes=passes)) \
        == sorted(want)
    for v in got.violations:
        assert v.file == path and v.line


def test_engine_waiver_is_structural(tmp_path):
    """The engine lock is held across the tick's device work by
    contract; any other lock in the same place is a finding."""
    src = """\
import torch
from flexflow_tpu_torch.runtime import locks
_eng = locks.make_rlock("engine")
_rt = locks.make_rlock("router")

def tick(ev, graph, t):
    with _eng:
        ev.synchronize()
        graph.replay()
        return t.item()

def route(ev):
    with _rt:
        ev.synchronize()
"""
    vs = analyze_sources(paths=[_seed(tmp_path, "waiv.py", src)],
                         passes=("concurrency",)).by_code(
        "lock-across-blocking")
    assert [v.line for v in vs] == [14]


TRACE = {
    "implicit-device": ("""\
import torch

def stage(x, dev):
    a = torch.zeros(4)                       # no device
    b = torch.zeros(4, device=dev)           # explicit: clean
    c = torch.empty(4, pin_memory=True)      # pinned host: clean
    d = x.cuda()                             # current card, implicitly
    return a, b, c, d, x.to("cuda")
""", "stage.py", [4, 7, 8]),
    "shape-dependent-slice": ("""\
import torch

def decode(n, dev):
    logits = torch.zeros(8, 16, device=dev)
    head = logits[:4]                        # constant: clean
    return logits[:n], head
""", "serving.py", [6]),
    "torch-under-lock": ("""\
import torch
from flexflow_tpu_torch.runtime import locks
_rt = locks.make_rlock("router")
_eng = locks.make_rlock("engine")

def score(x):
    with _rt:
        return torch.sum(x)                  # under the router lock

def tick(x):
    with _eng:
        y = torch.sum(x)                     # the engine's: clean
    with _rt:
        def later(y):
            return torch.sum(y)              # runs later: clean
        return y, later
""", "score.py", [8]),
    "host-sync-in-capture": ("""\
import torch

class Program:
    def _body(self, x):
        self.n = x.item()                    # reached from the capture
        return x * 2

    def capture(self, kernels, graph, stream, x):
        kernels.capture(graph, stream, self._body)
        with torch.cuda.graph(graph):
            y = float(x.sum())               # inside the graph's body
        return y, x.item()                   # after the capture: clean
""", "program.py", [5, 11]),
    "gc-in-capture": ("""\
import gc
import torch

class Program:
    def _tidy(self):
        gc.collect()

    def _body(self):
        self._tidy()

    def capture(self, kernels, graph, stream):
        kernels.capture(graph, stream, self._body)
        gc.collect()                         # outside any capture: clean
""", "tidy.py", [6]),
}


@pytest.mark.parametrize("code", sorted(TRACE))
def test_tracestability_fixture(tmp_path, code):
    src, name, lines = TRACE[code]
    path = _seed(tmp_path, name, src)
    report = analyze_sources(paths=[path], passes=("tracestability",))
    vs = report.by_code(code)
    assert sorted(v.line for v in vs) == lines, report.format_text()
    assert all(v.file == path and v.severity == "warning" for v in vs)
    assert set(report.codes()) == {code}


def test_pragma_waives_a_tracestability_site(tmp_path):
    path = _seed(tmp_path, "w.py", """\
import torch

def host():
    return torch.zeros(4)   # ffsan: allow(implicit-device) — host scratch
""")
    assert analyze_sources(paths=[path]).ok


def test_port_runtime_clean_at_head():
    report = analyze_sources()
    assert not report.errors() and not report.warnings(), \
        report.format_text()


def test_lock_inventory_pins_registry():
    [runtime] = default_paths()
    assert runtime.endswith(os.path.join("flexflow_tpu_torch", "runtime"))
    files = [os.path.join(runtime, n) for n in sorted(os.listdir(runtime))
             if n.endswith(".py")]
    graph = build_lockgraph(files)
    used = set()
    for mod in graph.modules.values():
        raw = [(p, ln) for kind, p, ln in mod.raw_locks
               if not graph.allowed_at("raw-lock", p, ln)]
        assert not raw, raw
        assert not mod.unknown_factory, mod.unknown_factory
        used.update(mod.global_locks.values())
        for cls in mod.classes.values():
            used.update(cls["attr_locks"].values())
    assert used <= set(LOCK_RANKS)
    assert LOCK_RANKS == J_RANKS
    for name in ("engine", "router", "pipeline-loader", "checkpoint-saver",
                 "watchdog", "native-loader", "telemetry-tracer"):
        assert name in used, name


def test_cli_clean_at_head(capsys):
    rc = ffsan_main(["--passes", "concurrency,tracestability",
                     "--tiered-exit"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "0 error(s), 0 warning(s)" in out


def test_cli_tiered_exit_codes_and_json(tmp_path, capsys):
    err = _seed(tmp_path, "e.py", "import threading\n_l = threading.Lock()\n")
    warn = _seed(tmp_path, "w.py",
                 "import torch\n\ndef f():\n    return torch.ones(3)\n")
    assert ffsan_main(["--passes", "concurrency", "--path", err,
                       "--tiered-exit"]) == 2
    assert ffsan_main(["--passes", "tracestability", "--path", warn,
                       "--tiered-exit"]) == 1
    assert ffsan_main(["--passes", "concurrency", "--path", err]) == 1
    assert ffsan_main(["--passes", "tracestability", "--path", warn]) == 0
    assert ffsan_main(["--passes", "tracestability", "--path", warn,
                       "--strict"]) == 1
    capsys.readouterr()
    rc = ffsan_main(["--passes", "concurrency", "--path", err,
                     "--format", "json", "--tiered-exit"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 2 and doc["num_errors"] == 1
    [v] = doc["violations"]
    assert v["code"] == "raw-lock" and v["file"] == err and v["line"] == 2
    assert ffsan_main(["--passes", "nope", "--tiered-exit"]) == 64
    with pytest.raises(NotImplementedError, match="item 10"):
        ffsan_main(["--passes", "legality"])
