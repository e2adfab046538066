"""The prover's SpMV and the Fp negation, against the JAX package on the CPU.

`kernels.abc_core_plain` (the plain version) against JAX `abc_core`
(groth16_tpu/protocol/prover.py:89), and the SpMV kernel's per-row body
(csrc/bn254_spmv.cuh, built with g++ through csrc/bn254_host_shim.cpp)
against both, on seeded coefficient sets with empty rows, dense rows,
repeated columns and the values r - 1; the negation body against
`F.neg_mod` and JAX's, 0 and p - 1 included.  Tolerance 0: exact integer
arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from groth16_tpu.ops import field as JF
from groth16_tpu.protocol.prover import abc_core as jax_abc_core

from groth16_tpu_torch.ops import cuda, field as F, kernels as KN
from groth16_tpu_torch.ops.field import FP, FR
from groth16_tpu_torch.ops.limbs import ints_to_limbs_bulk, limbs_to_ints

from spmv_cases import CASES, coefficient_set, rand_ints

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

R = FR.modulus


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def case(request):
    seed, n_rows, nvars, nnz, dense = CASES[request.param]
    w, matrix, row, col, coeff = coefficient_set(seed, n_rows, nvars, nnz, dense)
    want = jax_abc_core(n_rows, JF.to_mont(JF.FR, jnp.asarray(w)), jnp.asarray(coeff),
                        jnp.asarray(row.astype(np.int32)), jnp.asarray(col.astype(np.int32)),
                        jnp.asarray(matrix))
    return n_rows, w, matrix, row, col, coeff, [np.asarray(x) for x in want]


def _host_oracle(n_rows, w, matrix, row, col, coeff):
    """Az, Bz, Cz as host ints, standard form."""
    wi = limbs_to_ints(w)
    ci = [FR.from_mont_int(c) for c in limbs_to_ints(coeff)]
    sums = [[0] * n_rows, [0] * n_rows]
    for m, r, c, v in zip(matrix, row, col, ci):
        sums[int(m != 0)][r] += v * wi[c]
    az = [x % R for x in sums[0]]
    bz = [x % R for x in sums[1]]
    return az, bz, [a * b % R for a, b in zip(az, bz)]


def test_abc_core_plain_matches_jax(case):
    n_rows, w, matrix, row, col, coeff, want = case
    got = KN.abc_core_plain(n_rows, F.to_mont(FR, torch.from_numpy(w)), torch.from_numpy(coeff),
                            torch.from_numpy(row.astype(np.int64)),
                            torch.from_numpy(col.astype(np.int64)), torch.from_numpy(matrix))
    assert all(g.dtype == torch.uint32 for g in got)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), x)
    oracle = _host_oracle(n_rows, w, matrix, row, col, coeff)
    assert [[FR.from_mont_int(v) for v in limbs_to_ints(g.numpy())] for g in got] == list(oracle)


def test_spmv_plain_and_kernel_body_match_jax(case):
    """The CSR layout the kernel reads (`spmv_rows`), through the plain
    version and through the kernel's row body on the CPU."""
    n_rows, w, matrix, row, col, coeff, want = case
    m = KN.spmv_rows(matrix, row, col, coeff, n_rows, "cpu")
    assert int(m.row_ptr[-1]) == len(row) and m.ncols == int(col.max()) + 1
    plain = KN.spmv(torch.from_numpy(w), m)            # CPU tensors: the plain version
    for g, x in zip(plain, want):
        np.testing.assert_array_equal(g.numpy(), x)
    L = cuda.host_shim()
    if L is None:
        pytest.skip("needs g++ for the kernel's host build")
    out = np.zeros((3, n_rows, 16), np.uint32)
    wc = np.ascontiguousarray(w)
    L.shim_spmv(wc.ctypes.data, m.coeff.numpy().ctypes.data, m.cols.numpy().ctypes.data,
                m.row_ptr.numpy().ctypes.data, n_rows, out.ctypes.data)
    for g, x in zip(out, want):
        np.testing.assert_array_equal(g, x)


def test_spmv_rows_layout():
    """Entries sorted by (matrix, row), stable within a row; row offsets over
    2 n rows; a matrix tag other than 0 reads as B, as JAX `abc_core` does."""
    matrix = np.array([1, 0, 2, 0, 1], np.uint8)
    row = np.array([0, 2, 1, 0, 0], np.uint32)
    col = np.array([5, 6, 7, 8, 9], np.uint32)
    coeff = np.arange(5 * 16, dtype=np.uint32).reshape(5, 16)
    m = KN.spmv_rows(matrix, row, col, coeff, 3, "cpu")
    assert m.row_ptr.tolist() == [0, 1, 1, 2, 4, 5, 5]
    assert m.cols.tolist() == [8, 6, 5, 9, 7]
    np.testing.assert_array_equal(m.coeff.numpy(), coeff[[3, 1, 0, 4, 2]])
    assert m.ncols == 10 and m.cols.dtype == torch.int32
    with pytest.raises(ValueError):
        KN.spmv_rows(matrix, row, col, coeff, 2, "cpu")          # row 2 of 2 rows
    with pytest.raises(ValueError):                                # witness too short
        KN.spmv(torch.zeros((9, 16), dtype=torch.uint32), m)


def test_kernel_wrappers_refuse_cpu_tensors():
    m = KN.spmv_rows(np.zeros(1, np.uint8), np.zeros(1, np.uint32), np.zeros(1, np.uint32),
                     np.zeros((1, 16), np.uint32), 2, "cpu")
    with pytest.raises(ValueError):
        KN.spmv_kernel(torch.zeros((1, 16), dtype=torch.uint32), m)
    with pytest.raises(ValueError):
        KN.fp_neg_kernel(torch.zeros((4, 16), dtype=torch.uint32))


def test_fp_neg_matches_jax_and_the_kernel_body():
    rng = np.random.default_rng(7)
    vals = [0, 1, FP.modulus - 1, 0] + rand_ints(rng, 60, FP.modulus)
    x = ints_to_limbs_bulk(vals)
    got = KN.fp_neg(torch.from_numpy(x))
    assert got.dtype == torch.uint32
    assert limbs_to_ints(got.numpy()) == [(-v) % FP.modulus for v in vals]
    np.testing.assert_array_equal(got.numpy(), np.asarray(JF.neg_mod(JF.FP, jnp.asarray(x))))
    # G2 coordinates [n, 2, 16] negate limb vector by limb vector
    g2 = KN.fp_neg(torch.from_numpy(x.reshape(-1, 2, 16)))
    np.testing.assert_array_equal(g2.numpy().reshape(-1, 16), got.numpy())
    L = cuda.host_shim()
    if L is None:
        pytest.skip("needs g++ for the kernel's host build")
    out = np.zeros_like(x)
    L.shim_fp_neg(x.ctypes.data, out.ctypes.data, x.shape[0])
    np.testing.assert_array_equal(out, got.numpy())
