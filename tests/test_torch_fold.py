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


# Key sets of `fold_case`: "sorted" (a few zero digits, as random digits
# have), and the zero-heavy sets: "zero_heavy" (each window's zero run covers
# whole lanes and ends mid-lane), "zero_window" (one window of zeros alone),
# "all_zero" (a stream of zero keys only) and "scattered" (the zero-heavy
# counts, the zeros put anywhere among the sorted nonzero keys).
ZERO_KEYS = ("zero_heavy", "zero_window", "all_zero", "scattered")


def fold_keys(keys: str, W, m, nb, rng) -> np.ndarray:
    """Signed keys int32-able [W, m] of the key set `keys`: nonzero runs
    sorted by |key| (they cross lanes), random signs."""
    if keys == "sorted":
        ak = np.sort(rng.integers(0, nb, size=(W, m)), axis=1)
    else:
        ak = np.sort(rng.integers(1, nb, size=(W, m)), axis=1)
        zeros = [m - 3, m // 2 + 3, m // 4 + 1] * W
        for w in range(W):
            z = {"zero_heavy": zeros[w], "scattered": zeros[w], "all_zero": m,
                 "zero_window": m if w == 1 else 0}[keys]
            if keys == "scattered":
                at = np.sort(rng.choice(m, size=z, replace=False))
                row = np.zeros(m, np.int64)
                row[np.setdiff1d(np.arange(m), at)] = ak[w, :m - z]
                ak[w] = row
            else:
                ak[w, :z] = 0
                ak[w, z:] = np.sort(ak[w, z:])
    return ak * np.where(rng.integers(0, 2, size=(W, m)) > 0, 1, -1)


def fold_case(cv, affine, W, m, n, nb, seed, keys="sorted"):
    """One fold level's operands: n points as rows uint32[n, Rin] (affine
    with (0, 0) points, or projective), a gather order int32[W, m], signed
    keys int32[W, m] of the key set `keys` (`fold_keys`) with runs that
    cross lanes, and a bucket table uint32[W, nb, R] already holding sums
    (and infinities)."""
    rng = np.random.default_rng(seed)
    P = proj_points(cv, n, seed)
    coords = C.to_affine(cv, P) if affine else P
    rows = torch.cat([F.as_i32(c).reshape(n, -1) for c in coords], -1)
    if affine:
        rows[::7] = 0                                      # (0, 0) = infinity
    keys = fold_keys(keys, W, m, nb, rng)
    order = torch.from_numpy(rng.integers(0, n, size=(W, m)).astype(np.int32))
    S = proj_points(cv, W * nb, seed + 1)
    S = C.point_select(cv, torch.arange(W * nb) % 5 == 0, C.inf_like(cv, (W * nb,), "cpu"), S)
    table = torch.cat([F.as_i32(c).reshape(W * nb, -1) for c in S], -1).reshape(W, nb, -1)
    return (F.as_u32(rows.contiguous()), order, torch.from_numpy(keys.astype(np.int32)),
            F.as_u32(table.contiguous()))


def _host_rows(cv, rows, affine) -> list:
    """Point-major rows (x|y with (0, 0) = infinity, or x|y|z) as host
    affine points."""
    nc = KN.fold_rows(cv) // 3
    r = F.as_i32(rows)
    coords = tuple(F.as_u32(r[:, j * nc:(j + 1) * nc].reshape((-1,) + cv.comp_shape))
                   for j in range(r.shape[1] // nc))
    return C.affine_to_host(cv, *coords) if affine else C.points_to_host(cv, coords)


def bucket_oracle(cv, rows, order, keys, table, affine) -> list:
    """Host ints: each bucket b >= 1 of each window, [w][b - 1]: the
    table's sum plus the points of the slots whose |key| is b, negated for a
    negative key; zero keys add nothing."""
    fo, _ = _group(cv)
    pts = _host_rows(cv, rows, affine)
    W, nb = table.shape[:2]
    want = [C.points_to_host(cv, M._split_rows(cv, F.as_i32(table[w, 1:]))) for w in range(W)]
    for w in range(W):
        for k, o in zip(keys[w].tolist(), order[w].tolist()):
            if k:
                p = pts[o]
                want[w][abs(k) - 1] = H.ec_add(fo, want[w][abs(k) - 1],
                                               H.ec_neg(fo, p) if k < 0 else p)
    return want


def test_fold_keys():
    """The zero-heavy key sets are what their names say, at the sizes the
    fold tests take: nonzero keys sorted by |key| once the zeros are left
    out, a zero run ending mid-lane, a window of zeros, zeros alone."""
    rng = np.random.default_rng(0)
    for W, m in ((3, 32), (3, 64), (4, 256)):
        for keys in ("sorted",) + ZERO_KEYS:
            k = fold_keys(keys, W, m, 6, rng)
            assert k.shape == (W, m)
            for row in np.abs(k):
                nz = row[row != 0]
                assert (np.diff(nz) >= 0).all()
        z = lambda keys: (fold_keys(keys, W, m, 6, rng) == 0).sum(1)  # noqa: E731
        assert list(z("zero_heavy")) == list(z("scattered")) == [m - 3, m // 2 + 3, m // 4 + 1] + \
            [m - 3] * (W - 3)
        assert (m - 3) % 4 and (m // 2 + 3) % 4                 # mid-lane at T = 4
        assert list(z("zero_window"))[1] == m and (z("all_zero") == m).all()


@pytest.mark.parametrize("keys", ZERO_KEYS)
@pytest.mark.parametrize("cv,affine", [(C.G1, True), (C.G1, False), (C.G2, True)],
                         ids=["G1-affine", "G1-proj", "G2-affine"])
def test_fold_skips_zero_keys(cv, affine, keys):
    """Zero-heavy key sets through chains of `fold_level_plain` levels: the
    buckets 1.. equal host ints that add only the nonzero slots, every level
    leaves bucket 0 as it was, and the tracer counts the zero slots and the
    slots of every level."""
    from groth16_tpu_torch.utils import timing
    W, m, n, nb = 3, 64, 40, 6
    rows, order, sk, table = fold_case(cv, affine, W, m, n, nb, seed=5, keys=keys)
    want = bucket_oracle(cv, rows, order, sk, table, affine)
    for Ts in ([4, 16], [2, 4, 8], [64]):
        tab = table.clone()
        pts, o, k = rows, order, sk
        for i, T in enumerate(Ts):
            last = i == len(Ts) - 1
            before = timing.counters()
            pts, k2 = KN.fold_level_plain(cv, pts, o, k, tab, T, affine and i == 0, last)
            after = timing.counters()
            assert after["msm.zero_slots"] - before.get("msm.zero_slots", 0) == int((k == 0).sum())
            assert after["msm.fold_slots"] - before.get("msm.fold_slots", 0) == k.numel()
            assert torch.equal(F.as_i32(tab[:, 0]), F.as_i32(table[:, 0])), (Ts, i)
            o, k = None, k2
        got = [C.points_to_host(cv, M._split_rows(cv, F.as_i32(tab[w, 1:]))) for w in range(W)]
        assert got == want, Ts


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


def _msm_against_host(n, rng, scalars):
    """`window_sums` through the fold + Horner against host ints: n affine
    points with an infinity, then the scalars `scalars(rng)` draws."""
    fo, g = _group(C.G1)
    logs = [int(x) for x in rng.integers(1, 1 << 40, size=n)]
    pts = [H.ec_scalar_mul(fo, a, g) for a in logs]
    pts[n // 3], logs[n // 3] = None, 0
    ks = scalars(rng)
    c = M.pick_window_bits(n)
    sums = M.window_sums(C.G1, torch.from_numpy(ints_to_limbs(ks)),
                         C.points_from_host(C.G1, pts, "cpu"), c, affine=True)
    got = M.horner_combine(C.G1, sums, c)
    want = H.ec_scalar_mul(fo, sum(k * a for k, a in zip(ks, logs)) % H.R, g)
    assert C.points_to_host(C.G1, tuple(x[None] for x in got)) == [want]


@pytest.mark.parametrize("n,levels", [(20, 1), (100, 2), (300, 3), (1000, 4)])
def test_fold_msm_levels_match_host(n, levels):
    """`window_sums` through the fold + Horner against host ints, n points
    with an infinity and random scalars, at sizes that give one to four
    fold levels."""
    assert _levels(n) == levels
    _msm_against_host(n, np.random.default_rng(n),
                      lambda rng: [int.from_bytes(rng.bytes(32), "little") % H.R
                                   for _ in range(n)])


def test_fold_msm_bit_scalars_match_host():
    """The same at n = 300 (padded to 512, three levels) over the scalars of
    a bit-decomposition witness: 97 % of them 0 or 1, the rest below 2^32,
    so most windows hold zero digits alone."""
    n = 300

    def bits(rng):
        ks = [int(x) for x in rng.integers(0, 2, size=n)]
        for i in rng.choice(n, size=9, replace=False):
            ks[i] = int(rng.integers(2, 1 << 32))
        assert sum(k in (0, 1) for k in ks) == 291
        return ks

    _msm_against_host(n, np.random.default_rng(7), bits)


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
