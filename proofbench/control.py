#!/usr/bin/env python3
"""The control of the comparison that decides `correct`: the reference put
in the program's place, with one guarantee broken, must come out as not
correct.

    python3 proofbench/control.py --workload <cell> --proofs <n> --seeds <s> [<s> ...]

For each seed it makes the cell's circuit, witness pool, toxic waste and
requests as a run does, and answers the warm-up and `--proofs` requests
with the reference's own proofs of a broken witness: one nonzero private
value of each pool witness, drawn from the seed, taken as 0 (what a
prover that skips a digit it wrongly takes for zero would prove).  Then
it judges them with the run's own comparison and prints, a line a seed,
each number compared beside its limit, and last one JSON line of them
all.  It needs no card and does not run the program; the benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from proofbench.harness import cell, draw, plan as PL  # noqa: E402
from proofbench.reference.groth16 import Reference  # noqa: E402


def broken(witness: list, n_pub: int, rng) -> list:
    """The witness with one nonzero private value, drawn from rng, set to 0."""
    private = [i for i in range(n_pub + 1, len(witness)) if witness[i]]
    out = list(witness)
    out[rng.choice(private)] = 0
    return out


def control(p, seed: int, proofs: int) -> dict:
    """[value, limit] of each number compared, for the control's proofs."""
    cfg, traffic = p.config, p.traffic
    circuit = p.generator.build(cfg)
    toxic = draw.toxic(seed)
    pool = draw.pool(p.generator, circuit, cfg, seed, int(traffic["witness_pool"]))
    rng = draw.stream(seed, "control")
    ref = Reference(circuit, toxic)
    terms = [ref.terms(broken(w, circuit.n_pub, rng)) for w in pool]
    reqs = draw.requests(seed, len(pool))
    answered = []
    for _ in range(int(traffic.get("warm_proofs", 1)) + proofs):
        i, r, s = next(reqs)
        pts = ref.proof(terms[i], r, s) + (terms[i].public_io,)
        answered.append(cell.Proved(i, r, s, 0.0, 0.0, pts))
    return cell.compare(circuit, toxic, pool, answered)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The control of the correctness comparison.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--proofs", type=int, required=True, help="window proofs to answer")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    p = PL.resolve(args.workload)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control(p, seed, args.proofs)
        rows.append({"seed": seed, "checks": checks, "seconds": time.perf_counter() - t0})
        print(f"control {args.workload} seed {seed}: " + ", ".join(
            f"{k} {v} (limit {lim})" for k, (v, lim) in checks.items()), flush=True)
    print(json.dumps({"workload": args.workload, "proofs": args.proofs, "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
