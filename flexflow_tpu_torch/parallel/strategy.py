"""Strategy persistence — the reference-compatible text schema (the JAX
package's ``parallel/strategy.py``, copied; the two packages read and
write the same files).

Format (reference: src/runtime/strategy.cc:95-189):

    <num_ops>
    <op name>
    <device_type int>        # 0 = the accelerator pool, 1 = the host CPU
    <nDims>
    <dim[0]> <dim[1]> ... (tab separated, REVERSED logical order: sample last)
    <num_device_ids>
    <id0> <id1> ...

Strategies are keyed by op name (the reference hashes the name into a
Legion MappingTagID, strategy.cc:22-25).

Extension (the JAX package's, backward compatible): an optional
``@axismap`` record after an op's ids keeps the exact mesh-axis
assignment —

    @axismap <k> <axis0> <dim0> ... <axis_{k-1}> <dim_{k-1}>

with dim -1 = replicated over that axis, -2 = CONTRACT (row-parallel),
-3 = STAGE (pipeline), -4 = EXPERT. Reference-written files never contain
``@`` tokens, so they load unchanged; files with the extension are not
parseable by the reference.
"""

from __future__ import annotations

import logging
from typing import Dict

from flexflow_tpu_torch.parallel.pconfig import STAGE, ParallelConfig

log = logging.getLogger(__name__)

# Device-type serialization. The file int is a POOL, not a vendor: int 0
# is the accelerator pool — the reference writes its GPU enum there, the
# JAX package reads it as "TPU", the port as "GPU" (where it runs); int 1
# is the host CPU (the reference's hetero DLRM embeddings). "TPU" written
# by the JAX package therefore reloads here as "GPU", and the port's "GPU"
# reloads there as "TPU": every other field survives exactly.
_DEVICE_TYPE_TO_INT = {"GPU": 0, "TPU": 0, "CPU": 1}
_INT_TO_DEVICE_TYPE = {0: "GPU", 1: "CPU"}


def _ids_consistent(pc: ParallelConfig) -> bool:
    """True when pc.device_ids is representable as-is: one id a shard, or
    a stage-multiple list for STAGE strategies."""
    n = pc.num_parts()
    if len(pc.device_ids) == n:
        return True
    has_stage = bool(pc.axis_map) and any(
        d == STAGE for d in pc.axis_map.values())
    return bool(has_stage and pc.device_ids
                and len(pc.device_ids) % max(n, 1) == 0)


def save_strategies_to_file(filename: str,
                            strategies: Dict[str, ParallelConfig],
                            strict: bool = False) -> None:
    if strict:
        # validate the whole table before the first byte is written, so a
        # raise never strands a truncated file
        for name in sorted(strategies):
            pc = strategies[name]
            if pc.device_ids and not _ids_consistent(pc):
                raise ValueError(
                    f"strategy {name!r}: {len(pc.device_ids)} device_ids "
                    f"for {pc.num_parts()} partitions (degrees "
                    f"{tuple(pc.dims)}) — the schema needs exactly one id "
                    f"per shard; writing range({pc.num_parts()}) instead "
                    f"(strict mode)")
    with open(filename, "w") as f:
        f.write(f"{len(strategies)}\n")
        for name in sorted(strategies):
            pc = strategies[name]
            f.write(f"{name}\n")
            f.write(f"{_DEVICE_TYPE_TO_INT.get(pc.device_type, 0)}\n")
            f.write(f"{pc.nDims}\n")
            f.write("\t".join(str(d) for d in reversed(pc.dims)) + "\n")
            n = pc.num_parts()
            ids = pc.device_ids
            if pc.device_ids and not _ids_consistent(pc):
                log.warning(
                    "strategy %r: %d device_ids for %d partitions "
                    "(degrees %s) — the schema needs exactly one id per "
                    "shard; writing range(%d) instead",
                    name, len(pc.device_ids), n, tuple(pc.dims), n)
                ids = tuple(range(n))
            elif not ids:
                ids = tuple(range(n))
            f.write(f"{len(ids)}\n")
            f.write("\t".join(str(i) for i in ids) + "\n")
            if pc.axis_map is not None:
                # an EMPTY axis map ("explicitly replicated") still writes
                # a record: omitted, it would reload as None and fall back
                # to the greedy degree -> axis heuristic
                parts = []
                for ax, d in pc.axis_map.items():
                    parts.append(str(ax))
                    parts.append(str(-1 if d is None else d))
                f.write(f"@axismap {len(pc.axis_map)}"
                        + ("\t" + "\t".join(parts) if parts else "") + "\n")


def load_strategies_from_file(filename: str) -> Dict[str, ParallelConfig]:
    with open(filename) as f:
        tokens = f.read().split()
    pos = 0

    def take() -> str:
        nonlocal pos
        t = tokens[pos]
        pos += 1
        return t

    out: Dict[str, ParallelConfig] = {}
    num_ops = int(take())
    for _ in range(num_ops):
        name = take()
        device_type = _INT_TO_DEVICE_TYPE.get(int(take()), "GPU")
        ndims = int(take())
        rev_dims = [int(take()) for _ in range(ndims)]
        nids = int(take())
        ids = tuple(int(take()) for _ in range(nids))
        axis_map = None
        if pos < len(tokens) and tokens[pos] == "@axismap":
            take()
            k = int(take())
            axis_map = {}
            for _ in range(k):
                ax = take()
                d = int(take())
                axis_map[ax] = None if d == -1 else d
        out[name] = ParallelConfig(
            device_type=device_type,
            dims=tuple(reversed(rev_dims)),
            device_ids=ids,
            axis_map=axis_map,
        )
    return out
