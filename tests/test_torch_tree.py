"""The port's merge-tree MSM (groth16_tpu_torch.ops.msm_tree, kernels_tree):
whole MSMs against host ints, one tree level against host affine additions,
the batch inversion's product tree, and the kernels' lane bodies built with
g++ (csrc/bn254_host_shim.cpp) against the plain PyTorch versions.  The port
vs JAX `msm_tree` runs in the slow lane."""

import ctypes
import random

import numpy as np
import pytest
import torch

from groth16_tpu_torch.ops import cuda, curve as C, field as F, kernels_tree as KT
from groth16_tpu_torch.ops import msm as M, msm_tree as MT
from groth16_tpu_torch.ops.field import FR
from groth16_tpu_torch.ops.limbs import ints_to_limbs
from groth16_tpu_torch.utils import hostmath as H

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


def _group(cv):
    fo = H.G1_FIELD if cv.name == "G1" else H.G2_FIELD
    return fo, (H.G1_GEN if cv.name == "G1" else H.G2_GEN)


def adversarial_case(cv, n, seed, bits=254):
    """Random points and scalars with a zero scalar, an infinity, a duplicate
    point with an equal scalar (doubling) and P, -P with equal scalars."""
    rng = random.Random(seed)
    fo, gen = _group(cv)
    pts = [H.ec_scalar_mul(fo, rng.randrange(1, 1 << 62), gen) for _ in range(n)]
    ks = [rng.randrange(min(1 << bits, FR.modulus)) for _ in range(n)]
    ks[0] = 0
    pts[1] = None
    pts[3], ks[3] = pts[2], ks[2]
    pts[5], ks[5] = H.ec_neg(fo, pts[4]), ks[4]
    return ks, pts, H.ec_msm(fo, ks, pts)


def _tree_msm(cv, ks, pts, c, group):
    P = C.points_from_host(cv, pts)
    got = MT.msm_tree(cv, torch.from_numpy(ints_to_limbs(ks)), P, c, group=group)
    return C.points_to_host(cv, tuple(x[None] for x in got))[0]


@pytest.mark.parametrize("cv,n,c,group", [(C.G1, 13, 7, 16), (C.G1, 40, 8, 16), (C.G2, 6, 8, 40)],
                         ids=["G1-uneven-groups", "G1-one-group", "G2"])
def test_tree_msm_matches_host(cv, n, c, group):
    ks, pts, want = adversarial_case(cv, n, seed=n, bits=254 if cv.name == "G1" else 62)
    assert _tree_msm(cv, ks, pts, c, group) == want


def test_tree_msm_one_bucket_and_tiny():
    """One segment from end to end (pure-node merges, root routing), and
    streams of 1 and 3 points."""
    pts = [H.ec_scalar_mul(H.G1_FIELD, 3 + i, H.G1_GEN) for i in range(8)]
    assert _tree_msm(C.G1, [5] * 8, pts, 8, 40) == H.ec_msm(H.G1_FIELD, [5] * 8, pts)
    rng = random.Random(7)
    for n in (1, 3):
        pts = [H.ec_scalar_mul(H.G1_FIELD, rng.randrange(1, 1 << 40), H.G1_GEN) for _ in range(n)]
        ks = [rng.randrange(1 << 40) for _ in range(n)]
        assert _tree_msm(C.G1, ks, pts, 6, 8) == H.ec_msm(H.G1_FIELD, ks, pts)


def test_dispatch_matches_jax():
    from groth16_tpu.ops import msm as JM
    assert M.TREE_MIN_N == JM.TREE_MIN_N
    assert MT.WINDOW_GROUP == 4
    for n in (1, 128, 65535, 65536, 1 << 20, 1 << 22):
        assert M.pick_window_bits_tree(n) == JM.pick_window_bits_tree(n)
        assert M.tree_path(n, True) == (n >= JM.TREE_MIN_N)
        assert not M.tree_path(n, False)


# ---------------------------------------------------------------------------
# one level
# ---------------------------------------------------------------------------

def _limbs(cv, pt):
    if pt is None:
        return np.zeros(2 * KT.ncomp(cv), np.uint32)
    return np.concatenate([cv.fops.const(pt[0]).reshape(-1), cv.fops.const(pt[1]).reshape(-1)])


def level_case(cv, K, seed):
    """Point pairs (A.pR, B.pL) with every group-law case, plus A.pL, B.pR
    and random flags: host points and uint32[R2, K] columns."""
    rng = np.random.default_rng(seed)
    fo, gen = _group(cv)
    pool = [H.ec_scalar_mul(fo, int(k), gen) for k in rng.integers(1, 1 << 40, size=12)]
    pick = lambda: [pool[i] for i in rng.integers(0, len(pool), size=K)]  # noqa: E731
    a, b, apl, bpr = pick(), pick(), pick(), pick()
    for i in range(K):
        case = i % 7
        if case == 1:
            b[i] = a[i]                            # doubling
        elif case == 2:
            b[i] = H.ec_neg(fo, a[i])              # cancellation
        elif case == 3:
            a[i] = None
        elif case == 4:
            b[i] = None
        elif case == 5:
            a[i] = b[i] = None
    cols = [torch.from_numpy(np.stack([_limbs(cv, p) for p in ps], 1)) for ps in (apl, a, b, bpr)]
    flags = [torch.from_numpy(rng.integers(0, 2, size=K).astype(bool)) for _ in range(3)]
    return (a, b), cols, flags


@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_level_matches_host(cv):
    """`level` on the CPU (padding K up to one tile, the plain kernels):
    mid = A.pR + B.pL by host ints, and the node-update selects."""
    K = 300
    fo, _ = _group(cv)
    (a, b), cols, (match, aP, bP) = level_case(cv, K, seed=3)
    PL, PR, EM = KT.level(cv, *cols, match, aP, bP, True)
    mid = torch.from_numpy(np.stack([_limbs(cv, H.ec_add(fo, x, y)) for x, y in zip(a, b)], 1))
    A_pl, A_pr, _, B_pr = cols
    assert torch.equal(F.as_i32(PL), torch.where(match & aP, F.as_i32(mid), F.as_i32(A_pl)))
    assert torch.equal(F.as_i32(PR), torch.where(match & bP, F.as_i32(mid), F.as_i32(B_pr)))
    assert torch.equal(F.as_i32(EM), torch.where(match, F.as_i32(mid), F.as_i32(A_pr)))
    assert KT.level(cv, *cols, match, aP, bP, False)[2] is None


def test_invert_rows_product_tree():
    """Totals wider than INV_MAXW go through one K5 halving each way."""
    rng = np.random.default_rng(5)
    M_ = 2 * KT.INV_MAXW
    tots = KT._limb_major(C.G1, torch.from_numpy(ints_to_limbs(
        [int(x) % F.FP.modulus or 1 for x in rng.integers(1, 1 << 62, size=M_)])).long())
    inv = KT.invert_rows(C.G1, tots)
    assert torch.equal(F.as_i32(inv), F.as_i32(KT.invert_plain(C.G1, tots)))
    one = KT._limb_major(C.G1, F.const(C.G1.one_limbs, "cpu").expand(M_, 16))
    assert torch.equal(F.as_i32(KT.mul_rows_plain(C.G1, inv, tots)), F.as_i32(one))


# ---------------------------------------------------------------------------
# lane bodies through g++
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shim():
    lib = cuda.host_shim()
    if lib is None:
        pytest.skip("g++ not available")
    return lib


def _p(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_tree_lane_header_matches_plain(shim, cv):
    """K4, K6 and K8 lane bodies vs `phase_a_plain`, `invert_plain` and
    `phase_b_level_plain` on one tile (M = INV_W lanes of T_SLOTS)."""
    T, M_ = KT.T_SLOTS, KT.INV_W
    _, cols, flags = level_case(cv, T * M_, seed=11)
    apl, apr, bpl, bpr = (c.reshape(c.shape[0], T, M_).contiguous() for c in cols)
    flg = (flags[0].int() | flags[1].int() << 1 | flags[2].int() << 2).reshape(T, M_).contiguous()
    g2 = int(cv.name == "G2")

    tot = torch.zeros((KT.ncomp(cv), M_), dtype=torch.uint32)
    shim.shim_tree_phase_a(g2, _p(apr), _p(bpl), _p(tot), M_)
    assert torch.equal(F.as_i32(tot), F.as_i32(KT.phase_a_plain(cv, apr, bpl)))

    tinv = torch.zeros_like(tot)
    shim.shim_tree_invert(g2, _p(tot), _p(tinv), M_)
    assert torch.equal(F.as_i32(tinv), F.as_i32(KT.invert_plain(cv, tot)))

    for want_em in (True, False):
        outs = [torch.zeros_like(apl) for _ in range(3)]
        shim.shim_tree_phase_b(g2, _p(apl), _p(apr), _p(bpl), _p(bpr), _p(flg), _p(tinv),
                               _p(outs[0]), _p(outs[1]), _p(outs[2]) if want_em else None, M_)
        plain = KT.phase_b_level_plain(cv, apl, apr, bpl, bpr, flg, tinv, want_em)
        for o, p in zip(outs, plain):
            if p is not None:
                assert torch.equal(F.as_i32(o), F.as_i32(p))


@pytest.mark.slow
def test_tree_msm_matches_jax_msm_tree():
    import jax.numpy as jnp
    from groth16_tpu.ops import curve as JC, msm_tree as JMT
    ks, pts, _ = adversarial_case(C.G1, 13, seed=21)
    got = MT.msm_tree(C.G1, torch.from_numpy(ints_to_limbs(ks)), C.points_from_host(C.G1, pts),
                      8, group=8)
    want = JMT.msm_tree(JC.G1, jnp.asarray(ints_to_limbs(ks)), JC.points_from_host(JC.G1, pts),
                        8, group=8)
    x, y = C.to_affine(C.G1, got)
    jx, jy = JC.to_affine(JC.G1, want)
    assert np.array_equal(x.numpy(), np.asarray(jx)) and np.array_equal(y.numpy(), np.asarray(jy))
