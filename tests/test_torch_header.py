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


@pytest.mark.parametrize("field_id,name", [(0, "FP"), (1, "FR")])
def test_field_header_matches_plain_jax_and_host(shim, field_id, name):
    fp, jfp = getattr(F, name), getattr(JF, name)
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
    pts = C.points_from_host(cv, [H.ec_scalar_mul(fo, k, g) for k in ks])
    P = C.point_add_plain(cv, tuple(c[:n] for c in pts), tuple(c[n:] for c in pts))
    return P, fo


@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_point_header_matches_plain_and_host(shim, cv):
    n = 12
    P, fo = _points(cv, n, 5)
    Q, _ = _points(cv, n, 6)
    inf = C.inf_like(cv, (1,))
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


@pytest.mark.parametrize("cv,affine", [(C.G1, True), (C.G1, False), (C.G2, True), (C.G2, False)],
                         ids=["G1-affine", "G1-proj", "G2-affine", "G2-proj"])
def test_fold_lane_header_matches_plain(shim, cv, affine):
    """K2's lane body vs `fold_level_plain`: emit and trail bit-exact, with
    runs of equal |digit|, negative digits and (0, 0) points."""
    T, lanes = 8, 5
    rng = np.random.default_rng(9)
    keys = np.sort(rng.integers(0, 6, size=(T, lanes)), axis=0)
    keys = (keys * np.where(rng.integers(0, 2, size=(T, lanes)) > 0, 1, -1)).astype(np.int32)
    P, _ = _points(cv, T * lanes, 10)
    if affine:
        P = C.to_affine(cv, P)
    rows = torch.cat([F.as_i32(c).reshape(T * lanes, -1) for c in P], -1)
    if affine:
        rows[::7] = 0
    pT = F.as_u32(rows.reshape(T, lanes, -1).permute(0, 2, 1).contiguous())
    kT = torch.from_numpy(keys)
    emit, trail = KN.fold_level_plain(cv, kT, pT, affine)
    e = np.zeros(emit.shape, np.uint32)
    t = np.zeros(trail.shape, np.uint32)
    pT_np, k_np = pT.numpy(), kT.numpy()
    shim.shim_fold(int(cv.name == "G2"), int(affine), _ptr(k_np), _ptr(pT_np), _ptr(e), _ptr(t),
                   T, lanes)
    assert np.array_equal(e, emit.numpy())
    assert np.array_equal(t, trail.numpy())
