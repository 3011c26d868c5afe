"""The port's launcher (the JAX package's ``launcher.py``): starts a
script as one rank of a ``torch.distributed`` process group.

Each rank runs the same script (SPMD, as each JAX controller does); the
script's ``FFModel.compile`` then builds its mesh over the group's ranks.
The launcher:

  * takes the rank's place in the world from ``--num-processes``,
    ``--process-id`` and ``--coordinator host:port`` (the JAX launcher's
    surface), or from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), and exports those
    variables for the script;
  * on the card (the default) selects ``cuda:<LOCAL_RANK>`` and joins
    over NCCL; with ``--device cpu`` joins over gloo (the CPU tests);
  * joins with a bounded timeout (``FF_INIT_TIMEOUT_S``, the JAX
    launcher's variable; default 120 s), so a missing peer fails the
    rank instead of hanging it;
  * runs the script with ``runpy`` (the rendezvous's seconds in
    ``FF_RENDEZVOUS_SECONDS``) and leaves the group when it ends.

``--elastic`` and the ``shrink(<k>)@resume`` fault (``FF_FAULT``) raise
``not_ported``: fewer surviving ranks need the cost model's ranked mesh
refit (ROADMAP item 10).

Usage: python -m flexflow_tpu_torch.launcher script.py [--num-processes N]
       [--process-id I] [--coordinator host:port] [--device cuda|cpu]
       [-- script args...]
"""

from __future__ import annotations

import argparse
import datetime
import inspect
import os
import runpy
import sys
import time


def _world_from(args, parser) -> tuple:
    """(rank, world size, local rank, address, port): the flags, else
    torchrun's environment, else a world of one."""
    env = os.environ
    if args.num_processes is not None:
        n = args.num_processes
        if n > 1 and (args.process_id is None or not args.coordinator):
            parser.error("--num-processes > 1 needs --process-id and "
                         "--coordinator host:port")
        rank = args.process_id or 0
        if not 0 <= rank < n:
            parser.error(f"--process-id {rank} outside [0, {n})")
        host, port = (args.coordinator or "127.0.0.1:29500").rsplit(":", 1)
        local = int(env.get("LOCAL_RANK", rank))
        return rank, n, local, host, int(port)
    if args.coordinator or args.process_id is not None:
        parser.error("--coordinator and --process-id need --num-processes")
    if "RANK" in env and "WORLD_SIZE" in env:
        return (int(env["RANK"]), int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", env["RANK"])),
                env.get("MASTER_ADDR", "127.0.0.1"),
                int(env.get("MASTER_PORT", "29500")))
    return 0, 1, 0, "127.0.0.1", 29500


def main(argv=None):
    p = argparse.ArgumentParser(prog="flexflow_tpu_torch.launcher")
    p.add_argument("script")
    p.add_argument("--num-processes", type=int, default=None,
                   help="ranks in the world")
    p.add_argument("--process-id", type=int, default=None,
                   help="this rank")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0's rendezvous")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: NCCL, one card a rank (LOCAL_RANK); cpu: gloo")
    p.add_argument("--elastic", action="store_true",
                   help="not ported (ROADMAP item 10: the surviving "
                        "ranks need the ranked mesh refit)")
    args, rest = p.parse_known_args(argv)
    if rest and rest[0] == "--":
        rest = rest[1:]

    from flexflow_tpu_torch.config import ROADMAP_SEARCH, not_ported
    from flexflow_tpu_torch.runtime import faultinject

    if args.elastic or os.environ.get("FF_ELASTIC", "") not in ("", "0"):
        # the surviving ranks leave the config's mesh unbuildable: the
        # ranked refit picks the next one
        raise not_ported("the elastic relaunch (launcher --elastic)",
                         ROADMAP_SEARCH)
    if faultinject.active_plan().fire("shrink", "resume"):
        raise not_ported("the shrink@resume drill (a mesh refit onto fewer "
                         "devices)", ROADMAP_SEARCH)

    rank, world, local, host, port = _world_from(args, p)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(local), MASTER_ADDR=host,
                      MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launcher --device cuda: no CUDA device "
                               "(pass --device cpu for gloo on the CPU)")
        torch.cuda.set_device(local % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    timeout = float(os.environ.get("FF_INIT_TIMEOUT_S", "120") or 120)
    kw = {}
    if backend == "nccl" and "device_id" in inspect.signature(
            dist.init_process_group).parameters:
        # binds the communicator to this rank's card up front
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    dist.init_process_group(
        backend, init_method=f"tcp://{host}:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout), **kw)
    os.environ["FF_RENDEZVOUS_SECONDS"] = f"{time.perf_counter() - t0:.4f}"
    try:
        sys.argv = [args.script] + rest
        runpy.run_path(args.script, run_name="__main__")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
