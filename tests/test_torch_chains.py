"""K1's chains and K6's inversion on the CPU: `point_double_n` and `horner`
(groth16_tpu_torch.ops.curve) through their plain versions against host ints
(utils/hostmath.py) and the JAX package's point_double / point_add, and the
kernels' per-thread arithmetic built with g++ (csrc/bn254_host_shim.cpp:
shim_point_double_n, shim_horner, shim_field_inv, shim_tree_invert) against
the plain versions and `pow(a, p - 2, p)`; the
fused core's MSM step with its chains deferred (`msm.msm_sums`,
`msm.SideChains`) against `msm.msm`.  Tolerance 0 throughout: exact
integer arithmetic, canonical residues."""

import ctypes
import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from groth16_tpu.ops import curve as JC
from groth16_tpu_torch.ops import cuda, curve as C, field as F, kernels_tree as KT, msm as M
from groth16_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints
from groth16_tpu_torch.utils import hostmath as H
from groth16_tpu_torch.utils import timing as TR

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

P_MOD = F.FP.modulus
R = 1 << 256


@pytest.fixture(scope="module")
def shim():
    lib = cuda.host_shim()
    if lib is None:
        pytest.skip("g++ not available")
    return lib


def _group(cv):
    return (H.G1_FIELD, H.G1_GEN) if cv.name == "G1" else (H.G2_FIELD, H.G2_GEN)


def _window_sums(cv, W, seed, batch=None):
    """Host points and projective sums [W, comp] (or [batch, W, comp]) with
    Z != 1, an infinity at window 1 and two equal windows (2 and 3)."""
    fo, g = _group(cv)
    rng = random.Random(seed)
    n = W * (batch or 1)
    a = [H.ec_scalar_mul(fo, rng.randrange(1, 1 << 62), g) for _ in range(n)]
    b = [H.ec_scalar_mul(fo, rng.randrange(1, 1 << 62), g) for _ in range(n)]
    for s in range(0, n, W):
        a[s + 1] = b[s + 1] = None
        if W > 3:
            a[s + 3], b[s + 3] = a[s + 2], b[s + 2]
    S = C.point_add(cv, C.points_from_host(cv, a, "cpu"), C.points_from_host(cv, b, "cpu"))
    host = [H.ec_add(fo, x, y) for x, y in zip(a, b)]
    if batch:
        S = tuple(c.reshape((batch, W) + cv.comp_shape) for c in S)
    return S, host, fo


def _host_horner(fo, host, c):
    acc = None
    for w, pt in enumerate(host):
        acc = H.ec_add(fo, acc, H.ec_scalar_mul(fo, 1 << (c * w), pt))
    return acc


@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_double_n_and_horner_match_host(cv):
    W, c = 5, 3
    S, host, fo = _window_sums(cv, W, seed=1)
    for k in (0, 1, 4):
        got = C.points_to_host(cv, C.point_double_n(cv, S, k))
        assert got == [H.ec_scalar_mul(fo, 1 << k, pt) for pt in host]
    got = C.horner(cv, S, c)
    assert C.points_to_host(cv, tuple(x[None] for x in got)) == [_host_horner(fo, host, c)]
    assert all(torch.equal(F.as_i32(a), F.as_i32(b))
               for a, b in zip(M.horner_combine(cv, S, c), got))
    one = C.horner(cv, tuple(x[:1] for x in S), c)           # W = 1: the sum itself
    assert all(torch.equal(F.as_i32(a), F.as_i32(b[0])) for a, b in zip(one, S))


def test_horner_batch_axis_and_shape_check():
    B, W, c = 3, 4, 2
    S, host, fo = _window_sums(C.G1, W, seed=2, batch=B)
    got = C.points_to_host(C.G1, C.horner(C.G1, S, c))
    assert got == [_host_horner(fo, host[b * W:(b + 1) * W], c) for b in range(B)]
    with pytest.raises(ValueError):
        C.horner(C.G1, tuple(x[0, 0] for x in S), c)         # no window axis


def test_g1_double_n_and_horner_bit_exact_with_jax():
    """The port's chains against the JAX package's point_double loop and the
    steps of its horner_combine (groth16_tpu/ops/msm.py: window_bits
    doublings, then one add, windows high to low), on a batch of Horners so
    that JAX compiles one point shape."""
    B, W, c = 16, 3, 2
    S, _, _ = _window_sums(C.G1, W, seed=3, batch=B)
    JS = [tuple(jnp.asarray(x[:, w].numpy()) for x in S) for w in range(W)]
    acc = JS[W - 1]
    for _ in range(3):
        acc = JC.point_double(JC.G1, acc)
    got = C.point_double_n(C.G1, tuple(x[:, W - 1] for x in S), 3)
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, acc))
    acc = JS[W - 1]
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = JC.point_double(JC.G1, acc)
        acc = JC.point_add(JC.G1, acc, JS[w])
    got = C.horner(C.G1, S, c)
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, acc))


def _ptrs(arrs):
    return (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])


@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_chain_headers_match_plain(shim, cv):
    """The chain kernels' thread bodies (double_n, horner_lane) through g++
    against the plain versions, projective coordinates bit for bit."""
    B, W, c = 2, 5, 3
    S, _, _ = _window_sums(cv, W, seed=4, batch=B)
    g2 = int(cv.name == "G2")
    flat = [x.reshape((B * W,) + cv.comp_shape).contiguous().numpy() for x in S]
    for k in (0, 1, 6):
        outs = [np.zeros_like(flat[0]) for _ in range(3)]
        shim.shim_point_double_n(g2, B * W, k, _ptrs(flat), _ptrs(outs))
        plain = C.point_double_n_plain(cv, tuple(torch.from_numpy(f) for f in flat), k)
        assert all(np.array_equal(o, p.numpy()) for o, p in zip(outs, plain))
    outs = [np.zeros((B,) + cv.comp_shape, np.uint32) for _ in range(3)]
    shim.shim_horner(g2, B, W, c, _ptrs(flat), _ptrs(outs))
    plain = C.horner_plain(cv, S, c)
    assert all(np.array_equal(o, p.numpy()) for o, p in zip(outs, plain))


@pytest.mark.parametrize("cv,sizes", [(C.G1, (8, 128, 128)), (C.G2, (4, 128))],
                         ids=["G1", "G2"])
def test_side_chains_equal_msm(cv, sizes, monkeypatch):
    """The fused core's MSM step (`msm_sums`, then one `SideChains.horner`
    over MSMs of one curve, the chains deferred) gives `msm`'s points, bit
    for bit: below 128 points `msm`'s naive point passes through, MSMs at
    the fold's size share one launch (a batch of Horners); sums of two
    widths in one launch are refused.  The bucket phase and the naive MSM
    are stand-ins, sums of the points' neighbours (the fold tests and
    tests/test_torch_fused_guard.py hold the real ones; here they would
    cost seconds each).  On CPU tensors nothing forks: `msm.side_chains`
    does not move and `join` has nothing to wait for."""
    fo, g = _group(cv)
    pts, acc = [], None
    for _ in range(max(sizes)):                                 # (i + 1) G
        acc = H.ec_add(fo, acc, g)
        pts.append(acc)
    P = C.points_from_host(cv, pts, "cpu")
    rng = np.random.default_rng(5)
    cases = []
    for n in sizes:
        limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
        limbs[:, 15] &= 0x2FFF
        cases.append((torch.from_numpy(limbs), tuple(x[:n] for x in P)))

    def sums(cv, s, P, c, *args):
        W = -(-(M.NBITS + 1) // c)
        k = int(s[0, 0]) % 8                                    # other sums for other scalars
        return C.point_add(cv, tuple(x[k:k + W] for x in P), tuple(x[k + 1:k + W + 1] for x in P))

    monkeypatch.setattr(M, "msm_naive", lambda cv, s, P: tuple(x[-1].clone() for x in P))
    monkeypatch.setattr(M, "window_sums", sums)
    before = TR.counters().get("msm.side_chains", 0)
    chains = M.SideChains()
    parts = [M.msm_sums(cv, s, P, affine=True) for s, P in cases]
    assert [c for _, c in parts] == [None if n < 128 else M.pick_window_bits(n) for n in sizes]
    got = chains.horner(cv, parts)
    chains.join()
    assert chains.forked == 0 and TR.counters().get("msm.side_chains", 0) == before
    for (s, P), pt in zip(cases, got):
        want = M.msm(cv, s, P, affine=True)
        assert all(torch.equal(F.as_i32(x), F.as_i32(y)) for x, y in zip(pt, want))
    wide = (parts[-1][0], parts[-1][1] + 1)
    with pytest.raises(ValueError):
        chains.horner(cv, [parts[-1], wide])


def _field_cases(n, seed):
    rng = random.Random(seed)
    return [0, 1, P_MOD - 1, R % P_MOD] + [rng.randrange(P_MOD) for _ in range(n)]


def test_field_inv_header_matches_host_fp(shim):
    """The header's Euclid inverse on Montgomery values a R -> a^-1 R, against
    pow(a, p - 2, p) on host ints; 0 gives 0."""
    xs = _field_cases(200, 5)
    a = ints_to_limbs([x * R % P_MOD for x in xs])
    out = np.zeros_like(a)
    shim.shim_field_inv(0, len(xs), a.ctypes.data, out.ctypes.data)
    assert limbs_to_ints(out) == [pow(x, P_MOD - 2, P_MOD) * R % P_MOD for x in xs]
    assert np.array_equal(out, F.inv_mod(F.FP, torch.from_numpy(a)).numpy())


def test_field_inv_header_matches_host_fp2(shim):
    xs, ys = _field_cases(200, 6), _field_cases(200, 7)[::-1]
    xs, ys = xs + [0, 5], ys + [0, 0]                      # 0 + 0u and a real value
    a = np.stack([ints_to_limbs([x * R % P_MOD for x in xs]),
                  ints_to_limbs([y * R % P_MOD for y in ys])], 1)     # [n, 2, 16]
    a = np.ascontiguousarray(a)
    out = np.zeros_like(a)
    shim.shim_field_inv(2, len(xs), a.ctypes.data, out.ctypes.data)
    want0, want1 = [], []
    for x, y in zip(xs, ys):
        ninv = pow(x * x + y * y, P_MOD - 2, P_MOD)
        want0.append(x * ninv % P_MOD * R % P_MOD)
        want1.append(-y * ninv % P_MOD * R % P_MOD)
    assert limbs_to_ints(out[:, 0]) == want0 and limbs_to_ints(out[:, 1]) == want1


@pytest.mark.parametrize("cv,m", [(C.G1, 1), (C.G1, 127), (C.G1, 128), (C.G1, 1300),
                                  (C.G2, 1), (C.G2, 256)],
                         ids=["G1-1", "G1-127-zero", "G1-128", "G1-1300-zero", "G2-1", "G2-256"])
def test_invert_blocks_header_matches_plain(shim, cv, m):
    """K6 as its kernel runs it (block by block through g++) at ragged M, with
    zeros among the totals where M allows: equal to `invert_plain`."""
    rng = np.random.default_rng(m)
    nc = KT.ncomp(cv)
    vals = [int.from_bytes(rng.bytes(32), "little") % P_MOD or 1 for _ in range(m * nc // 16)]
    tots = torch.from_numpy(ints_to_limbs(vals).reshape(m, nc).T.copy())
    if m > 100:
        tots[:, 5] = 0
        tots[:, m - 1] = 0
    inv = torch.zeros_like(tots)
    shim.shim_tree_invert(int(cv.name == "G2"), ctypes.c_void_p(tots.data_ptr()),
                          ctypes.c_void_p(inv.data_ptr()), m)
    assert torch.equal(F.as_i32(inv), F.as_i32(KT.invert_plain(cv, tots)))
    assert torch.equal(F.as_i32(KT.invert(cv, tots)), F.as_i32(inv))


@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_to_affine_matches_host_with_infinity(cv):
    """`to_affine` through `kernels_tree.invert` on the CPU: Z = 0 gives
    (0, 0), every other lane the host's affine point."""
    S, host, _ = _window_sums(cv, 5, seed=8)
    x, y = C.to_affine(cv, S)
    assert not x[1].any() and not y[1].any()
    assert C.points_to_host(cv, S) == host
    back = C.from_affine(cv, x, y)
    assert C.points_to_host(cv, back) == host
