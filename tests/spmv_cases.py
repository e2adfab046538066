"""Seeded SpMV coefficient sets for the CPU tests (tests/test_torch_spmv.py,
against the JAX package) and the card's (tests/test_torch_gpu.py, which
runs without JAX): numpy only."""

import numpy as np

from groth16_tpu_torch.ops.field import FR
from groth16_tpu_torch.ops.limbs import ints_to_limbs_bulk

R = FR.modulus

# name: (seed, n_rows, nvars, random entries, entries of each dense row)
CASES = {"sparse": (1, 16, 24, 40, 0), "dense rows": (2, 8, 12, 30, 3000),
         "one row": (3, 4, 5, 0, 700)}
# name: (seed, n_rows, nvars, Zipf exponent, longest row)
POWER_LAW = {"power law": (4, 64, 48, 2.0, 1999)}
NAMES = list(CASES) + list(POWER_LAW)


def rand_ints(rng, n, modulus):
    return [int.from_bytes(rng.bytes(32), "little") % modulus for _ in range(n)]


def coefficient_set(seed: int, n_rows: int, nvars: int, nnz: int, dense: int):
    """(witness standard limbs, matrix, row, col, coeff Montgomery limbs):
    random entries over rows 0 .. n_rows - 3 (the last two rows of A and B
    stay empty), `dense` more entries in A's row 1 and in B's row 2, columns
    repeated (nvars is small beside nnz, and the dense rows read column 0
    again and again), the witness value and one coefficient r - 1."""
    rng = np.random.default_rng(seed)
    w = rand_ints(rng, nvars, R)
    w[0], w[-1] = R - 1, 0
    matrix = np.concatenate([rng.integers(0, 2, nnz), np.zeros(dense, np.int64),
                             np.ones(dense, np.int64)]).astype(np.uint8)
    row = np.concatenate([rng.integers(0, n_rows - 2, nnz), np.full(dense, 1),
                          np.full(dense, 2)]).astype(np.uint32)
    col = np.concatenate([rng.integers(0, nvars, nnz), rng.integers(0, 3, 2 * dense)])
    col = col.astype(np.uint32)
    coeff = rand_ints(rng, nnz + 2 * dense, R)
    coeff[0] = coeff[-1] = R - 1
    order = rng.permutation(len(row))          # entries in no particular order
    return (ints_to_limbs_bulk(w), matrix[order], row[order], col[order],
            ints_to_limbs_bulk(FR.to_mont_int(c) for c in coeff)[order])


def power_law_set(seed: int, n_rows: int, nvars: int, a: float, cap: int):
    """Rows after circom's linear simplification: A's and B's rows take
    Zipf(a) lengths capped at `cap` (A's row 0 exactly `cap`), most of one
    to three entries, the last two rows of each matrix empty; a third of the
    rows read the constant-one wire (column 0) among their columns, which
    repeat (nvars is small beside the long rows).  Returns coefficient_set's
    tuple."""
    rng = np.random.default_rng(seed)
    w = rand_ints(rng, nvars, R)
    w[0], w[-1] = R - 1, 0
    lengths = np.minimum(rng.zipf(a, size=(2, n_rows)), cap)
    lengths[0, 0] = cap
    lengths[:, -2:] = 0
    matrix = np.repeat(np.array([0, 1], np.uint8), lengths.sum(axis=1))
    row = np.concatenate([np.repeat(np.arange(n_rows), n) for n in lengths]).astype(np.uint32)
    col = rng.integers(0, nvars, row.size)
    starts = np.concatenate([[0], np.cumsum(lengths.ravel())[:-1]])
    one_wire = starts[(lengths.ravel() > 0) & (rng.random(2 * n_rows) < 1 / 3)]
    col[one_wire] = 0
    coeff = rand_ints(rng, row.size, R)
    coeff[0] = coeff[-1] = R - 1
    order = rng.permutation(row.size)
    return (ints_to_limbs_bulk(w), matrix[order], row[order], col.astype(np.uint32)[order],
            ints_to_limbs_bulk(FR.to_mont_int(c) for c in coeff)[order])


def case_set(name: str):
    """(n_rows, witness, matrix, row, col, coeff) of a named set."""
    if name in POWER_LAW:
        seed, n_rows, nvars, a, cap = POWER_LAW[name]
        return (n_rows, *power_law_set(seed, n_rows, nvars, a, cap))
    seed, n_rows, nvars, nnz, dense = CASES[name]
    return (n_rows, *coefficient_set(seed, n_rows, nvars, nnz, dense))
