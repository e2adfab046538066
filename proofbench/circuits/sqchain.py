"""The squaring chain w_{i+1} = w_i^2: a frozen copy of the port's
`models/circuits.py: synthetic_circuit` (the same wires and constraints),
with the chain's start drawn from the request's generator.

2^log2 - 3 constraints, so that with its two public wires and wire 0 the
domain is exactly 2^log2.  Wires: [1, out, x0, w_1 .. w_{n-1}], out = w_n
public output, x0 = w_0 public input.  Row i: w_i * w_i = w_{i+1}, one A,
one B and one C entry; every witness value is a full-width field element.
"""

from __future__ import annotations

import numpy as np

from .circuit import R, Circuit, matrix


def build(cfg: dict) -> Circuit:
    n = (1 << int(cfg["log2"])) - 3
    i = np.arange(n, dtype=np.int64)
    wire = np.where(i == 0, 2, 2 + i)                 # chain[i] -> its wire
    nxt = np.append(wire[1:], 1)                      # the last link writes `out`
    ones = np.ones(n, np.int64)
    return Circuit(name=f"sqchain{cfg['log2']}", n_constr=n, n_wires=n + 2, n_pub_out=1,
                   n_pub_in=1, a=matrix(i, wire, ones), b=matrix(i, wire, ones),
                   c=matrix(i, nxt, ones))


def witness(circuit: Circuit, cfg: dict, rng) -> list:
    n = circuit.n_constr
    x = x0 = rng.randrange(1, R)
    chain = [x0]
    append = chain.append
    for _ in range(n):
        x = x * x % R
        append(x)
    return [1, chain[-1], x0] + chain[1:n]
