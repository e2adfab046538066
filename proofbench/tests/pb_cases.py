"""Tiny cells for the CPU tests: a real cell's plan, traffic and metrics
with its configuration cut to a circuit the CPU proves in seconds."""

from proofbench.harness import plan as PL

TINY = {"num2bits16.stream": {"bits": 4, "copies": 1},
        "sqchain20.stream": {"log2": 3}}
STATED = ("constraints", "wires", "public", "log2_domain")


def tiny_plan(cell: str, **traffic) -> PL.Plan:
    p = PL.resolve(cell)
    p.config = {k: v for k, v in p.config.items() if k not in STATED} | TINY[cell]
    p.traffic = p.traffic | {"warm_proofs": 1, "traced_proofs": 1} | traffic
    return p
