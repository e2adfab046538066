"""The CUDA kernels' per-thread arithmetic (csrc/bn254_field.cuh,
csrc/bn254_curve.cuh) compiled for the CPU with g++ through
csrc/bn254_host_shim.cpp, held bit-exact against the port's plain PyTorch
versions, the JAX package's field ops and host ints.  Skips without g++."""

import ctypes

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from groth16_tpu.ops import field as JF
from groth16_tpu_torch.ops import curve as C, cuda, field as F, kernels as KN
from groth16_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints
from groth16_tpu_torch.utils import hostmath as H

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shim():
    lib = cuda.host_shim()
    if lib is None:
        pytest.skip("g++ not available")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _ptrs(arrs):
    return (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])


def _rand_ints(mod, n, seed):
    rng = np.random.default_rng(seed)
    edge = [0, 1, mod - 1, mod - 2, ((1 << 16) - 1) * sum(1 << (16 * i) for i in range(16)) % mod]
    return edge + [int.from_bytes(rng.bytes(32), "little") % mod for _ in range(n - len(edge))]


def _edge_pairs(mod):
    """Every pair of edge operands of the product: 0, 1, 2, mod - 1, mod - 2,
    R mod m and R^2 mod m (R = 2^256), 2^253, and operands whose top word is
    the modulus's top word (the largest the no-carry schedule meets)."""
    top = mod >> 224 << 224
    edge = [0, 1, 2, mod - 1, mod - 2, (1 << 256) % mod, (1 << 512) % mod, 1 << 253, top,
            top | 0xFFFFFFFF, top + (mod - top) // 2, top | (mod - top - 1)]
    assert all(0 <= e < mod for e in edge) and all(e >> 224 == mod >> 224 for e in edge[8:])
    return [x for x in edge for _ in edge], [y for _ in edge for y in edge]


@pytest.mark.parametrize("field_id,name,operands",
                         [(0, "FP", "random"), (1, "FR", "random"), (0, "FP", "edge"),
                          (1, "FR", "edge")], ids=["0-FP", "1-FR", "0-FP-edge", "1-FR-edge"])
def test_field_header_matches_plain_jax_and_host(shim, field_id, name, operands):
    """The header's product (the carry-chain schedule `mont_mul`, run word
    for word by g++), add and sub vs the plain versions, the JAX field and
    host ints: random canonical operands with a few edges, or every pair of
    `_edge_pairs`."""
    fp, jfp = getattr(F, name), getattr(JF, name)
    if operands == "edge":
        xs, ys = _edge_pairs(fp.modulus)
    else:
        xs, ys = _rand_ints(fp.modulus, 200, 1), _rand_ints(fp.modulus, 200, 2)[::-1]
    a, b = ints_to_limbs(xs), ints_to_limbs(ys)
    out = np.zeros_like(a)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for op, plain, jax_fn in ((0, F.mont_mul, JF.mont_mul), (1, F.add_mod, JF.add_mod),
                              (2, F.sub_mod, JF.sub_mod)):
        shim.shim_field(field_id, op, len(xs), _ptr(a), _ptr(b), _ptr(out))
        assert np.array_equal(out, plain(fp, ta, tb).numpy())
        assert np.array_equal(out, np.asarray(jax_fn(jfp, jnp.asarray(a), jnp.asarray(b))))
    rinv = pow(1 << 256, -1, fp.modulus)
    shim.shim_field(field_id, 0, len(xs), _ptr(a), _ptr(b), _ptr(out))
    assert limbs_to_ints(out) == [x * y * rinv % fp.modulus for x, y in zip(xs, ys)]


def test_fp2_header_matches_plain(shim):
    p = F.FP.modulus
    xs, ys = _rand_ints(p, 64, 3), _rand_ints(p, 64, 4)
    a = ints_to_limbs(xs).reshape(32, 2, 16)
    b = ints_to_limbs(ys).reshape(32, 2, 16)
    out = np.zeros_like(a)
    shim.shim_field(2, 0, 32, _ptr(a), _ptr(b), _ptr(out))
    assert np.array_equal(out, C.Fp2Vec.mul(torch.from_numpy(a).long(),
                                            torch.from_numpy(b).long()).numpy())


def _points(cv, n, seed):
    """Projective points with Z != 1: sums of two host points, plus infinity,
    P = Q and P = -Q lanes."""
    fo = H.G1_FIELD if cv.name == "G1" else H.G2_FIELD
    g = H.G1_GEN if cv.name == "G1" else H.G2_GEN
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=2 * n)]
    pts = C.points_from_host(cv, [H.ec_scalar_mul(fo, k, g) for k in ks], "cpu")
    P = C.point_add_plain(cv, tuple(c[:n] for c in pts), tuple(c[n:] for c in pts))
    return P, fo


@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_point_header_matches_plain_and_host(shim, cv):
    n = 12
    P, fo = _points(cv, n, 5)
    Q, _ = _points(cv, n, 6)
    inf = C.inf_like(cv, (1,), "cpu")
    P = tuple(torch.cat([i, c[1:]]) for i, c in zip(inf, P))               # P = inf
    Q = tuple(torch.cat([q[:1], i, q[2:]]) for i, q in zip(inf, Q))         # Q = inf
    Q = tuple(torch.cat([q[:2], p[2:3], q[3:]]) for p, q in zip(P, Q))      # P = Q
    negP = C.point_neg(cv, P)
    Q = tuple(torch.cat([q[:3], m[3:4], q[4:]]) for m, q in zip(negP, Q))   # P = -Q
    ins = [c.contiguous().numpy() for c in P + Q]
    outs = [np.zeros_like(ins[0]) for _ in range(3)]
    g2 = int(cv.name == "G2")
    shim.shim_point(g2, 0, n, _ptrs(ins), _ptrs(outs))
    plain = C.point_add_plain(cv, P, Q)
    assert all(np.array_equal(o, p.numpy()) for o, p in zip(outs, plain))
    hp, hq = C.points_to_host(cv, P), C.points_to_host(cv, Q)
    got = C.points_to_host(cv, tuple(torch.from_numpy(o) for o in outs))
    assert got == [H.ec_add(fo, x, y) for x, y in zip(hp, hq)]
    shim.shim_point(g2, 1, n, _ptrs(ins[:3]), _ptrs(outs))
    plain = C.point_double_plain(cv, P)
    assert all(np.array_equal(o, p.numpy()) for o, p in zip(outs, plain))


def _shim_fold(shim, cv, rows, order, keys, table, T, affine, last):
    W, m = keys.shape
    tab = table.clone()
    trail = torch.zeros((W * (m // T), KN.fold_rows(cv)), dtype=torch.uint32)
    tkey = torch.zeros((W, m // T), dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int64)
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())  # noqa: E731
    shim.shim_fold(int(cv.name == "G2"), int(affine), ptr(rows), ptr(order), ptr(keys), ptr(tab),
                   ptr(trail), ptr(tkey), T, m, W, table.shape[1], int(last), ptr(counts))
    return tab, (None, None) if last else (trail, tkey), counts.tolist()


def _plain_fold(cv, rows, order, keys, table, T, affine, last):
    """`fold_level_plain` on a copy of the table: (the table, its result,
    what it added to the tracer's counters `msm.zero_slots` and
    `msm.fold_slots`)."""
    from groth16_tpu_torch.utils import timing
    tab = table.clone()
    before = timing.counters()
    got = KN.fold_level_plain(cv, rows, order, keys, tab, T, affine, last)
    after = timing.counters()
    return tab, got, [after[k] - before.get(k, 0) for k in ("msm.zero_slots", "msm.fold_slots")]


def _check_fold_lane(shim, cv, affine, keys):
    W, m, n, nb = 3, 32, 40, 6
    from test_torch_fold import fold_case
    rows, order, keys_, table = fold_case(cv, affine, W, m, n, nb, seed=9, keys=keys)
    zeros = int((keys_ == 0).sum())
    for T in (1, 2, 4, 32):
        last = T == m
        for o in ([order] if affine else [order, None]):
            r = rows if o is not None else rows[torch.arange(W * m) % n].contiguous()
            tab, got, counts = _shim_fold(shim, cv, r, o, keys_, table, T, affine, last)
            want_tab, want, want_counts = _plain_fold(cv, r, o, keys_, table, T, affine, last)
            assert torch.equal(F.as_i32(tab), F.as_i32(want_tab)), (T, o is None)
            assert all(g is w or torch.equal(F.as_i32(g), F.as_i32(w)) for g, w in zip(got, want))
            assert counts == want_counts == [zeros, W * m]
            assert torch.equal(F.as_i32(tab[:, 0]), F.as_i32(table[:, 0]))   # bucket 0 kept
            # T = 1: nothing closes; zeros alone: nothing at all
            assert torch.equal(F.as_i32(tab), F.as_i32(table)) == (T == 1 or keys == "all_zero")


FOLD_LANE_CASES = [(C.G1, True), (C.G1, False), (C.G2, True), (C.G2, False)]
FOLD_LANE_IDS = ["G1-affine", "G1-proj", "G2-affine", "G2-proj"]


@pytest.mark.parametrize("cv,affine", FOLD_LANE_CASES, ids=FOLD_LANE_IDS)
def test_fold_lane_header_matches_plain(shim, cv, affine):
    """K2's lane body vs `fold_level_plain` at T = 1, 2, 4 and 32 (the last,
    one lane a window, adding the open segments into the table too): the
    bucket table, the trail and its keys bit-exact, bucket 0 as it was, and
    the zero slots and slots walked the shim counts against the plain
    version's counters, with key runs that cross lanes, negative digits,
    (0, 0) points, a table that already holds sums, and, projective, the
    later levels' rows without an order."""
    _check_fold_lane(shim, cv, affine, "sorted")


@pytest.mark.parametrize("keys", ["zero_heavy", "zero_window", "all_zero", "scattered"])
@pytest.mark.parametrize("cv,affine", FOLD_LANE_CASES, ids=FOLD_LANE_IDS)
def test_fold_lane_header_skips_zero_keys(shim, cv, affine, keys):
    """The same on the zero-heavy key sets of `fold_case`: zero runs over
    whole lanes and ending mid-lane, a window of zeros, zeros alone, and
    zeros anywhere among the sorted nonzero keys."""
    _check_fold_lane(shim, cv, affine, keys)
