#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 proofbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), device, with --trace 1 breakdown,
and last the checks, each number compared beside its limit (also the last
lines of standard error).  A cell of one chip runs in this process on
cuda:0; a cell of d chips runs d ranks, one process a card on cuda:0 ..
cuda:d-1 under NCCL, rank 0 owning the clock (harness/cell.py), and this
process prints the result once every rank has ended.  Exits non-zero
with no result without a CUDA card, with fewer cards than the cell asks
for, when a rank fails, or when this process or a rank has loaded JAX or
the JAX package.  The program's kernels build into its own directory
inside the checkout at the first run there.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "groth16_tpu")


def process_start() -> float:
    """The process's start on the perf_counter clock (from /proc; the time
    this module was imported where that is unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return _T0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (whole names: groth16_tpu_torch is not groth16_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = process_start()

    import torch
    if not torch.cuda.is_available():
        print("proofbench: no CUDA device", file=sys.stderr)
        return 3
    from proofbench.harness import cell, plan
    p = plan.resolve(args.workload)
    if torch.cuda.device_count() < p.chips:
        print(f"proofbench: {args.workload} needs {p.chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 3
    out = cell.run(p, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), started)
    found = forbidden_modules()
    if found:
        print(f"proofbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 4
    cell.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
