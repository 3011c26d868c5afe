"""Start gloo ranks of a worker script through the port's launcher and
wait for them, for the CPU parity tests that spawn ranks. Each rank writes
to a log file of its own: a pipe read one rank at a time would block the
other rank's writes, and with them its collectives."""

import os
import signal
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(worker: str, d: str, world: int, *args):
    """``world`` ranks of ``worker`` (``--device cpu``: gloo), each given
    ``d`` and ``args``; their logs in ``d/<tag>.<rank>.log``."""
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["FF_INIT_TIMEOUT_S"] = "120"
    env.pop("FF_FAULT", None)
    tag = "-".join(["ranks", str(world)] + [str(a) for a in args])
    procs = []
    for r in range(world):
        log = open(os.path.join(d, f"{tag}.{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "flexflow_tpu_torch.launcher", worker,
             "--device", "cpu", "--num-processes", str(world),
             "--process-id", str(r), "--coordinator", f"127.0.0.1:{port}",
             "--", d, *map(str, args)],
            env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True), log))
    return procs


def kill(procs) -> None:
    for p, log in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        log.close()


def wait(procs, marker: str, timeout: float) -> None:
    """Wait for every rank (``timeout`` seconds each at most, then kill
    them all); each must exit 0 having printed ``marker``."""
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        kill(procs)
    for r, (p, log) in enumerate(procs):
        with open(log.name) as f:
            out = f.read()
        assert p.returncode == 0 and marker in out, \
            f"rank {r} failed (rc {p.returncode}):\n{out[-4000:]}"
