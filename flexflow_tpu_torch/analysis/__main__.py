"""ffsan CLI: the source passes over the port's runtime.

    python -m flexflow_tpu_torch.analysis --passes concurrency,tracestability \
        [--path DIR_OR_FILE ...] [--format json] [--strict] [--tiered-exit]

The default target is flexflow_tpu_torch/runtime. The JAX package's
strategy / graph passes (legality, perf, schema) are not ported: naming
one raises ``NotImplementedError`` (ROADMAP item 10).

Exit codes (the JAX CLI's): 0 = clean (info notes allowed), 1 =
violations (errors; warnings too under --strict), 2 = usage. With
--tiered-exit: 0 = clean, 1 = warnings only, 2 = errors, 64 = usage.
"""

from __future__ import annotations

import argparse
import sys

from flexflow_tpu_torch.analysis import ALL_PASSES
from flexflow_tpu_torch.analysis.sanitize import (SOURCE_PASSES,
                                                  analyze_sources)
from flexflow_tpu_torch.config import ROADMAP_SEARCH, not_ported

EX_USAGE = 64       # --tiered-exit usage failure (sysexits.h)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flexflow_tpu_torch.analysis",
        description="ffsan: static concurrency / capture-stability "
                    "analysis of the port's sources")
    ap.add_argument("--passes", default=",".join(SOURCE_PASSES),
                    help="comma-separated subset of: "
                         + ",".join(SOURCE_PASSES)
                         + f" (default: {','.join(SOURCE_PASSES)})")
    ap.add_argument("--path", action="append", default=[],
                    metavar="DIR_OR_FILE",
                    help="target (repeatable; default: "
                         "flexflow_tpu_torch/runtime)")
    ap.add_argument("--strict", action="store_true",
                    help="warnings also fail (exit 1)")
    ap.add_argument("--format", choices=("text", "json"), default=None,
                    dest="fmt", help="report format on stdout (default "
                                     "text)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="alias for --format json")
    ap.add_argument("--tiered-exit", action="store_true",
                    help="severity-tiered exit codes: 0 clean, 1 warnings "
                         "only, 2 errors, 64 usage")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress info notes in text output")
    args = ap.parse_args(argv)
    as_json = args.as_json or args.fmt == "json"

    def usage(msg: str) -> int:
        if args.tiered_exit:
            print(f"fflint: {msg}", file=sys.stderr)
            return EX_USAGE
        ap.error(msg)   # exits 2

    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    graph = [p for p in passes if p in ALL_PASSES]
    if graph:
        raise not_ported(f"the strategy / graph passes {graph}",
                         ROADMAP_SEARCH)
    unknown = [p for p in passes if p not in SOURCE_PASSES]
    if unknown or not passes:
        return usage(f"unknown pass(es) {unknown}; valid: "
                     f"{SOURCE_PASSES}")
    try:
        report = analyze_sources(paths=args.path or None, passes=passes)
    except FileNotFoundError as e:
        return usage(str(e))
    if as_json:
        print(report.to_json())
    else:
        print(report.format_text(include_notes=not args.quiet))
    if args.tiered_exit:
        if report.errors():
            return 2
        if report.warnings():
            return 1
        return 0
    failed = bool(report.errors()) or (args.strict
                                       and bool(report.warnings()))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
