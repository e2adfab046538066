"""The roofline counts on hand-worked cases: the signed-digit Pippenger
count, its least over window widths, the peaks, the SpMV's and the
quotient's work."""

import random

import numpy as np
import pytest

from proofbench.circuits import num2bits
from proofbench.layers import counts as K

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


@pytest.mark.parametrize("scalars, adds, doublings", [
    ([3], 1, 2),          # digits (-1, 1): [4] P - P
    ([1, 1, 1], 2, 0),    # one bucket of three points
    ([2, 1], 3, 2),       # window 0 buckets 2 and 1 (2 adds), window 1 P1 (2 doublings, 1 add)
    ([0, 0], 0, 0),
])
def test_pippenger_hand_worked_at_c2(scalars, adds, doublings):
    assert K.pippenger(K.MsmCount(scalars).stats(2), 2) == (adds, doublings)


def test_zero_one_scalars_count_one_addition_a_nonzero_scalar():
    rng = random.Random(5)
    bits = [rng.getrandbits(1) for _ in range(5000)]
    nnz = sum(bits)
    count = K.MsmCount(bits)
    # every width gives the same: no reduction (one bucket), no doublings
    for c in K.widths(len(bits)):
        assert K.pippenger(count.stats(c), c) == (nnz - 1, 0)
    ops, c, nbytes, products = K.least_msm([count], "G1")
    assert ops == nnz - 1
    assert products == 6 * (nnz - 1)
    assert nbytes == nnz * 64 + len(bits) * 32
    assert K.least_msm([count], "G2")[3] == 18 * (nnz - 1)


def test_count_reads_only_the_scalars():
    """The same scalars give the same count however they are split into
    parts (the port's public / private split, its window width, its tree
    or fold path are nowhere in the count)."""
    rng = random.Random(9)
    vals = [rng.randrange(R) for _ in range(3000)] + [0, 1] * 500
    whole = K.least_msm([K.MsmCount(vals)], "G1")
    parts = K.least_msm([K.MsmCount(vals[:7]), K.MsmCount(vals[7:])], "G1")
    assert whole == parts


def test_weighted_stats_equal_the_plain_ones():
    rng = random.Random(2)
    distinct = [rng.randrange(R) for _ in range(40)] + [0, 1]
    mult = np.array([rng.randrange(1, 5) for _ in distinct], np.int64)
    spelled = [v for v, m in zip(distinct, mult) for _ in range(m)]
    w = K.words(spelled)
    for c in (2, 5, 13):
        assert K.digit_stats(K.words(distinct), c, mult) == K.digit_stats(w, c)


@pytest.mark.parametrize("n", [1 << 10, 1 << 13])
def test_walk_finds_the_full_scan_least(n):
    rng = random.Random(n)
    count = K.MsmCount([rng.randrange(R) for _ in range(n)])
    assert count.distinct > K.FULL_SCAN or n < K.FULL_SCAN
    ops = K.least_msm([count], "G1")[0]
    assert ops == min(sum(K.pippenger(count.stats(c), c)) for c in K.widths(n))


def test_digit_stats_against_host_ints():
    """Per-window (nonzero digits, largest |digit|) against a recoding on
    host ints that also rebuilds each scalar from its digits."""
    rng = random.Random(4)
    ks = [rng.randrange(R) for _ in range(30)] + [0, 1, R - 1]
    for c in (2, 3, 7, 16, 21):
        half, full = 1 << (c - 1), 1 << c
        wins = -(-K.SCALAR_BITS // c) + 1
        want = [[0, 0] for _ in range(wins)]
        for k in ks:
            total, carry = 0, 0
            for win in range(wins):
                d = ((k >> (win * c)) & (full - 1)) + carry
                carry = int(d >= half)
                d -= full * carry
                total += d << (win * c)
                if d:
                    want[win][0] += 1
                    want[win][1] = max(want[win][1], abs(d))
            assert total == k
        assert K.digit_stats(K.words(ks), c) == [tuple(x) for x in want]


def test_peak_and_least_seconds():
    assert K.FP_MUL_SLOTS == 264
    assert K.peak_products_per_s(1980) == pytest.approx(63.36e9)
    assert K.least_seconds(3.35e12, 0, 1980) == pytest.approx(1.0)
    assert K.least_seconds(0, 63.36e9, 1980) == pytest.approx(1.0)


def test_spmv_and_quotient_work_by_hand():
    c = num2bits.build({"bits": 2, "copies": 1})
    # 3 rows + 2 dummy: domain 2^3; A: 2 bits + 2 dummy; B: 2 bits + 2 times wire 0
    assert c.log2_domain == 3
    nnz = 2 + 2 + 4
    nbytes, products = K.spmv_work(c)
    assert nbytes == 36 * nnz + 8 * 9 + 32 * 4 + 96 * 8
    assert products == nnz + 2                         # rows 0 and 1 have A and B
    assert K.quotient_work(3) == (128 * 8, 3 * (8 * 3 + 8) + 8)
