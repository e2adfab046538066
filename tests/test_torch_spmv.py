"""The prover's SpMV and the Fp negation, against the JAX package on the CPU.

`kernels.abc_core_plain` (the plain version) against JAX `abc_core`
(groth16_tpu/protocol/prover.py:89), and the SpMV kernel's two passes (the
bodies of csrc/bn254_spmv.cuh over the schedule of `kernels.spmv_schedule`,
block by block with the warp and block scans as loops, built with g++
through csrc/bn254_host_shim.cpp) against both, at several schedules whose
small threads, warps and blocks the rows cross, on seeded coefficient sets
with empty rows, dense rows, rows of Zipf lengths, repeated columns and the
values r - 1; the schedule itself (each entry in one run, carries where a
row crosses a block, each carry in one finish block); the negation body
against `F.neg_mod` and JAX's, 0 and p - 1 included.  Tolerance 0: exact
integer arithmetic.
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

from spmv_cases import NAMES, case_set, rand_ints

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

R = FR.modulus
# schedules the host build runs: (E, lanes a warp, threads an entries block,
# rows a finish block); the card's warp is 32 (tools/bench_spmv.py sweeps
# its E and blocks)
SCHEDULES = [(2, 4, 16, 8), (3, 2, 4, 4), (1, 4, 8, 16), (4, 8, 64, 16), (8, 4, 16, 8)]


@pytest.fixture(scope="module", params=NAMES, ids=NAMES)
def case(request):
    n_rows, w, matrix, row, col, coeff = case_set(request.param)
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


@pytest.mark.parametrize("schedule", SCHEDULES, ids=[f"E{e}-W{w}-B{b}-F{f}"
                                                      for e, w, b, f in SCHEDULES])
def test_spmv_plain_and_kernel_body_match_jax(case, schedule):
    """The CSR layout the kernel reads (`spmv_rows`), through the plain
    version and through the kernel's two passes on the CPU at a schedule;
    the row-sum scratch starts as garbage, so a row read before it is
    written shows."""
    n_rows, w, matrix, row, col, coeff, want = case
    E, W, block, finish_block = schedule
    m = KN.spmv_rows(matrix, row, col, coeff, n_rows, "cpu", E=E, block=block,
                     finish_block=finish_block)
    assert int(m.row_ptr[-1]) == len(row) and m.ncols == int(col.max()) + 1
    plain = KN.spmv(torch.from_numpy(w), m)            # CPU tensors: the plain version
    for g, x in zip(plain, want):
        np.testing.assert_array_equal(g.numpy(), x)
    L = cuda.host_shim()
    if L is None:
        pytest.skip("needs g++ for the kernel's host build")
    sc = m.schedule
    out = np.zeros((3, n_rows, 16), np.uint32)
    sums = np.full((8, 2 * n_rows), 0xDEADBEEF, np.uint32)
    slots = max(sc.carry_row.numel(), 1)
    carries = np.full((8, slots), 0xDEADBEEF, np.uint32)
    wc = np.ascontiguousarray(w)
    ptrs = [t.numpy().ctypes.data for t in (m.coeff, m.cols, sc.keys, m.row_ptr, sc.carry_slot,
                                            sc.carry_row, sc.finish)]
    rc = L.shim_spmv(wc.ctypes.data, *ptrs, len(row), n_rows, E, W, block, finish_block,
                     sums.ctypes.data, carries.ctypes.data, slots, out.ctypes.data)
    assert rc == 0
    for g, x in zip(out, want):
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("schedule", [(2, 16, 8), (3, 4, 4), (4, 64, 16)],
                         ids=["E2-B16-F8", "E3-B4-F4", "E4-B64-F16"])
def test_spmv_schedule(name, schedule):
    """Each entry lies in one thread's run, runs in entry order; a block
    has a carry slot exactly where its last entry's row goes on into the
    next block, slots in block order, so a row has one carry a block
    boundary inside it; every slot lies in the one finish range of its row's
    block and side; an empty row holds no entry and no carry: it sits
    between two entries, at a boundary."""
    E, block, finish_block = schedule
    n_rows, _, matrix, row, col, coeff = case_set(name)
    sc = KN.spmv_rows(matrix, row, col, coeff, n_rows, "cpu", E=E, block=block,
                      finish_block=finish_block).schedule
    m_ptr = KN.spmv_rows(matrix, row, col, coeff, n_rows, "cpu").row_ptr.numpy()
    keys, nnz = sc.keys.numpy(), len(row)
    assert (sc.E, sc.block, sc.finish_block) == schedule
    # the keys are the sorted (matrix, row) keys, each entry in its CSR row
    np.testing.assert_array_equal(keys, np.repeat(np.arange(2 * n_rows), np.diff(m_ptr)))
    runs = [np.arange(nnz)[t * E:(t + 1) * E] for t in range(-(-nnz // E))]
    np.testing.assert_array_equal(np.concatenate(runs), np.arange(nnz))
    # carries where a row crosses an entry block's end
    span = E * block
    slot = sc.carry_slot.numpy()
    assert slot.size == -(-nnz // span)
    crossing = [b for b in range(slot.size) if (b + 1) * span < nnz
                and keys[(b + 1) * span - 1] == keys[(b + 1) * span]]
    assert [b for b in range(slot.size) if slot[b] >= 0] == crossing
    assert [int(slot[b]) for b in crossing] == list(range(len(crossing)))
    carry_row = sc.carry_row.numpy()
    np.testing.assert_array_equal(carry_row, [keys[(b + 1) * span - 1] for b in crossing])
    for k in range(2 * n_rows):
        lo, hi = m_ptr[k], m_ptr[k + 1]
        inside = ((hi - 1) // span - lo // span) if hi > lo else 0
        assert (carry_row == k).sum() == inside
        if hi == lo:                                       # an empty row
            assert k not in keys and (lo == 0 or lo == nnz or keys[lo - 1] < k < keys[lo])
    # finish block q: the slots of rows [q F, q F + F) of A, then of B
    fin = sc.finish.numpy()
    assert fin.shape == (-(-n_rows // finish_block), 4)
    seen = np.zeros(carry_row.size, np.int64)
    for q, (a0, a1, b0, b1) in enumerate(fin):
        r0, r1 = q * finish_block, min((q + 1) * finish_block, n_rows)
        for side, (c0, c1) in enumerate(((a0, a1), (b0, b1))):
            base = side * n_rows
            assert ((carry_row[c0:c1] >= base + r0) & (carry_row[c0:c1] < base + r1)).all()
            seen[c0:c1] += 1
    assert (seen == 1).all()


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
    assert m.schedule.keys.tolist() == [0, 2, 3, 3, 4]
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
