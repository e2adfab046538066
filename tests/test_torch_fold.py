"""The port's fold MSM (groth16_tpu_torch.ops.msm: `fold_schedule`, the
levels of kernel K2 through their plain version)
against host ints, at sizes that give one to four fold levels, and the
level schedule itself.  Tolerance 0: exact integer arithmetic; MSM results
compare after conversion to affine (the bucket schedule changes the
projective representative).  `fold_case` also serves the K2 shim test
(test_torch_header.py) and the `gpu` test (test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

from groth16_tpu_torch.ops import curve as C, field as F, kernels as KN, msm as M
from groth16_tpu_torch.ops.limbs import ints_to_limbs
from groth16_tpu_torch.utils import hostmath as H

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


def _group(cv):
    fo = H.G1_FIELD if cv.name == "G1" else H.G2_FIELD
    return fo, (H.G1_GEN if cv.name == "G1" else H.G2_GEN)


def proj_points(cv, n, seed):
    """n projective points with Z != 1: sums of two host points."""
    fo, g = _group(cv)
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=2 * n)]
    pts = C.points_from_host(cv, [H.ec_scalar_mul(fo, k, g) for k in ks], "cpu")
    return C.point_add_plain(cv, tuple(c[:n] for c in pts), tuple(c[n:] for c in pts))


def fold_case(cv, affine, W, m, n, nb, seed):
    """One fold level's operands: n points as rows uint32[n, Rin] (affine
    with (0, 0) points, or projective), a gather order int32[W, m], sorted
    signed keys int32[W, m] with runs that cross lanes, and a bucket table
    uint32[W, nb, R] already holding sums (and infinities)."""
    rng = np.random.default_rng(seed)
    P = proj_points(cv, n, seed)
    coords = C.to_affine(cv, P) if affine else P
    rows = torch.cat([F.as_i32(c).reshape(n, -1) for c in coords], -1)
    if affine:
        rows[::7] = 0                                      # (0, 0) = infinity
    keys = np.sort(rng.integers(0, nb, size=(W, m)), axis=1)
    keys = keys * np.where(rng.integers(0, 2, size=(W, m)) > 0, 1, -1)
    order = torch.from_numpy(rng.integers(0, n, size=(W, m)).astype(np.int32))
    S = proj_points(cv, W * nb, seed + 1)
    S = C.point_select(cv, torch.arange(W * nb) % 5 == 0, C.inf_like(cv, (W * nb,), "cpu"), S)
    table = torch.cat([F.as_i32(c).reshape(W * nb, -1) for c in S], -1).reshape(W, nb, -1)
    return (F.as_u32(rows.contiguous()), order, torch.from_numpy(keys.astype(np.int32)),
            F.as_u32(table.contiguous()))


def test_fold_schedule():
    """Level 0 takes FOLD_T; every level's T divides what is left; the
    levels between take FOLD_T_PROJECTIVE and the last (one lane a window)
    what is left; a stream no longer than FOLD_T is one level."""
    for m in (32, 128, 1024, 1 << 16, 1 << 20):
        Ts = M.fold_schedule(m)
        assert Ts[0] == min(KN.FOLD_T, m) and int(np.prod(Ts)) == m
        assert all(T == M.FOLD_T_PROJECTIVE for T in Ts[1:-1])
        assert all(1 < T <= M.FOLD_T_PROJECTIVE for T in Ts[1:])
    assert M.fold_schedule(32) == [32]
    assert M.fold_schedule(1 << 16) == [32, 4, 4, 4, 4, 4, 2]      # the main path's
    assert M.fold_schedule(1 << 20) == [32] + [4] * 7 + [2]       # the 2^20 fold's


def _levels(n):
    return len(M.fold_schedule(max(KN.FOLD_T, 1 << (n - 1).bit_length())))


@pytest.mark.parametrize("n,levels", [(20, 1), (100, 2), (300, 3), (1000, 4)])
def test_fold_msm_levels_match_host(n, levels):
    """`window_sums` through the fold + Horner against host ints, n points
    with an infinity and random scalars, at sizes that give one to four
    fold levels."""
    assert _levels(n) == levels
    fo, g = _group(C.G1)
    rng = np.random.default_rng(n)
    logs = [int(x) for x in rng.integers(1, 1 << 40, size=n)]
    pts = [H.ec_scalar_mul(fo, a, g) for a in logs]
    pts[n // 3], logs[n // 3] = None, 0
    ks = [int.from_bytes(rng.bytes(32), "little") % H.R for _ in range(n)]
    c = M.pick_window_bits(n)
    sums = M.window_sums(C.G1, torch.from_numpy(ints_to_limbs(ks)),
                         C.points_from_host(C.G1, pts, "cpu"), c, affine=True)
    got = M.horner_combine(C.G1, sums, c)
    want = H.ec_scalar_mul(fo, sum(k * a for k, a in zip(ks, logs)) % H.R, g)
    assert C.points_to_host(C.G1, tuple(x[None] for x in got)) == [want]


def test_fold_levels_any_schedule():
    """The buckets do not depend on how the levels cut the stream: chains of
    fold levels (`kernels.fold_level`) under four schedules, each feeding
    the next level its trail and keys, give the same table after affine
    conversion."""
    fo, g = _group(C.G1)
    rng = np.random.default_rng(3)
    n, c = 256, 5
    pts = [H.ec_scalar_mul(fo, int(a), g) for a in rng.integers(1, 1 << 40, size=n)]
    ks = [int.from_bytes(rng.bytes(32), "little") % H.R for _ in range(n)]
    P = C.points_from_host(C.G1, pts, "cpu")
    keys = M.signed_window_digits(torch.from_numpy(ints_to_limbs(ks)), c)
    order = torch.argsort(keys.abs(), dim=1, stable=True)
    sk0 = torch.gather(keys, 1, order).to(torch.int32)
    W, nb = keys.shape[0], (1 << (c - 1)) + 1
    want = None
    for Ts in ([32, 8], [32, 2, 2, 2], [4, 64], [256]):
        table = M.bucket_table(C.G1, W, nb, "cpu")
        pts_l, o, sk = F.as_u32(M._rows((P[0], P[1]))), order.to(torch.int32), sk0
        for i, T in enumerate(Ts):
            pts_l, sk = KN.fold_level(C.G1, pts_l, o if i == 0 else None, sk, table, T,
                                      affine=i == 0, last=i == len(Ts) - 1)
        got = C.to_affine(C.G1, M._split_rows(C.G1, F.as_i32(table)))
        if want is None:
            want = got
        assert all(torch.equal(F.as_i32(a), F.as_i32(b)) for a, b in zip(got, want)), Ts
