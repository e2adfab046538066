"""A rank-1 constraint system in plain arrays, as the benchmark's generators
make it and both sides read it.

Wire 0 is the constant one, wires 1..n_pub the public signals, the rest
private (the circom / snarkjs order).  Each of A, B and C is a list of
entries (row, col, val): row a constraint, col a wire, val a small signed
integer coefficient (taken mod r where the field is needed).  A constraint
row i holds <A_i, w> * <B_i, w> = <C_i, w> over the BN254 scalar field.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


@dataclass
class Matrix:
    """One of A, B, C: entries sorted by row (int64 arrays of one length)."""

    row: np.ndarray
    col: np.ndarray
    val: np.ndarray

    def __len__(self) -> int:
        return len(self.row)


@dataclass
class Circuit:
    name: str
    n_constr: int
    n_wires: int
    n_pub_out: int
    n_pub_in: int
    a: Matrix
    b: Matrix
    c: Matrix

    @property
    def n_pub(self) -> int:
        return self.n_pub_out + self.n_pub_in

    @property
    def log2_domain(self) -> int:
        """snarkjs's domain: the constraints plus one dummy row for wire 0
        and each public wire, rounded up to a power of two."""
        return (self.n_constr + self.n_pub + 1 - 1).bit_length()


def matrix(row, col, val) -> Matrix:
    row, col, val = (np.asarray(x, np.int64) for x in (row, col, val))
    order = np.argsort(row, kind="stable")
    return Matrix(row[order], col[order], val[order])


def zero_one_share(values) -> float:
    """Share of witness values that are 0 or 1."""
    return sum(1 for v in values if v in (0, 1)) / len(values)
