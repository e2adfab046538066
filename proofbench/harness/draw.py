"""Everything a run draws from its seed, each from a stream of its own so
that one draw never shifts another: the toxic waste, the witness pool, the
requests (witness and mask of each), the stand-in quotient scalars of the
MSM count.  `random.Random` takes any whole seed, however large."""

from __future__ import annotations

import random

from ..circuits.circuit import R
from ..reference.groth16 import Toxic


def stream(seed: int, what: str) -> random.Random:
    return random.Random(f"proofbench/{int(seed)}/{what}")


def toxic(seed: int) -> Toxic:
    rng = stream(seed, "toxic")
    return Toxic(*(rng.randrange(1, R) for _ in range(5)))


def pool(generator, circuit, cfg: dict, seed: int, size: int) -> list:
    rng = stream(seed, "witness")
    return [generator.witness(circuit, cfg, rng) for _ in range(size)]


def requests(seed: int, size: int):
    """Endless (witness index, r, s): each pass over the pool in a new
    shuffled order, each request with fresh masks."""
    rng = stream(seed, "requests")
    while True:
        order = list(range(size))
        rng.shuffle(order)
        for i in order:
            yield i, rng.randrange(R), rng.randrange(R)


def uniform(seed: int, what: str, n: int) -> list:
    rng = stream(seed, what)
    return [rng.randrange(R) for _ in range(n)]
