"""The port's merge-tree MSM (groth16_tpu_torch.ops.msm_tree, kernels_tree):
whole MSMs against host ints, one tree level and K7's batched mids against
host affine additions and JAX `msm_tree.level_jnp` / `mid_jnp`, the batch
inversion's product tree, and the kernels' thread bodies built with g++
(csrc/bn254_host_shim.cpp) against the plain PyTorch versions.  Tolerance 0
throughout: exact integer arithmetic.  The port vs JAX `msm_tree` runs in the
slow lane."""

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


def tree_msm(cv, s, P, c, group):
    """A whole MSM through the merge tree at window c and window group
    `group`: `window_sums_tree`, then Horner."""
    return M.horner_combine(cv, MT.window_sums_tree(cv, s, P, c, group), c)


def _tree_msm(cv, ks, pts, c, group):
    got = tree_msm(cv, torch.from_numpy(ints_to_limbs(ks)), C.points_from_host(cv, pts, "cpu"), c, group)
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
    """The tree's window and window group are the JAX package's; the
    dispatch is the port's own.  On the H100 the merge tree lost to the
    fold at every size from 2^16 to 2^21 points in G1 and in G2 alike, so
    the port's `msm` folds 2^16 affine points (and every size from 128),
    where the JAX package's dispatch takes the tree from 2^16; only
    `msm_tree.msm` takes the port's tree."""
    from groth16_tpu.ops import msm as JM
    assert JM.TREE_MIN_N == 1 << 16
    assert MT.WINDOW_GROUP == 4
    for n in (1, 128, 65535, 65536, 1 << 20, 1 << 22):
        assert MT.pick_window_bits_tree(n) == JM.pick_window_bits_tree(n)

    class Took(Exception):
        pass

    def bucket_phase(name):
        def run(cv, scalars, P, c, *args, **kwargs):
            raise Took(name, c)
        return run

    n = 1 << 16
    s = torch.zeros((n, 16), dtype=torch.uint32)
    P = C.inf_like(C.G1, (n,), "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "window_sums", bucket_phase("fold"))
        mp.setattr(MT, "window_sums_tree", bucket_phase("tree"))
        for run in (lambda: M.msm(C.G1, s, P, affine=True),
                    lambda: M.msm_sums(C.G1, s, P, affine=True)):
            with pytest.raises(Took) as took:
                run()
            assert took.value.args == ("fold", M.pick_window_bits(n))
        with pytest.raises(Took) as took:
            MT.msm(C.G1, s, P)
        assert took.value.args == ("tree", MT.pick_window_bits_tree(n))


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


@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_phase_b_plain_matches_host(cv):
    """Plain K7 on one tile of every group-law case: mid = A.pR + B.pL by
    host ints, given the lane inverses of the plain K4 / K6."""
    T, M_ = KT.T_SLOTS, KT.INV_W
    fo, _ = _group(cv)
    (a, b), cols, _ = level_case(cv, T * M_, seed=4)
    apr, bpl = (c.reshape(c.shape[0], T, M_) for c in cols[1:3])
    tinv = KT.invert_plain(cv, KT.phase_a_plain(cv, apr, bpl))
    got = KT.phase_b_plain(cv, apr, bpl, tinv).reshape(-1, T * M_)
    want = np.stack([_limbs(cv, H.ec_add(fo, x, y)) for x, y in zip(a, b)], 1)
    assert np.array_equal(got.numpy(), want)


def test_phase_b_plain_in_lane_slices(monkeypatch):
    """Plain K7 over lane slices (how it runs levels wider than
    PLAIN_LANES) equals one pass over all lanes."""
    T, M_ = KT.T_SLOTS, KT.INV_W
    _, cols, _ = level_case(C.G1, T * M_, seed=6)
    apr, bpl = (c.reshape(c.shape[0], T, M_) for c in cols[1:3])
    tinv = KT.invert_plain(C.G1, KT.phase_a_plain(C.G1, apr, bpl))
    whole = KT.phase_b_plain(C.G1, apr, bpl, tinv)
    monkeypatch.setattr(KT, "PLAIN_LANES", 48)      # slices of 48, 48 and 32 lanes
    assert torch.equal(F.as_i32(KT.phase_b_plain(C.G1, apr, bpl, tinv)), F.as_i32(whole))


def test_phase_a_plain_in_lane_slices(monkeypatch):
    """Plain K4 over lane slices (how it runs planes wider than PLAIN_LANES)
    equals one pass over all lanes."""
    T, M_ = KT.T_SLOTS, KT.INV_W
    _, cols, _ = level_case(C.G1, T * M_, seed=7)
    apr, bpl = (c.reshape(c.shape[0], T, M_) for c in cols[1:3])
    whole = KT.phase_a_plain(C.G1, apr, bpl)
    monkeypatch.setattr(KT, "PLAIN_LANES", 48)      # slices of 48, 48 and 32 lanes
    assert torch.equal(F.as_i32(KT.phase_a_plain(C.G1, apr, bpl)), F.as_i32(whole))


def test_mid_matches_jax_mid_jnp():
    """`KT.mid` (K4, K6 and K7 through their plain versions, K = 300 padded
    to one tile) against the JAX package's portable `msm_tree.mid_jnp`."""
    import jax.numpy as jnp
    from groth16_tpu.ops import curve as JC, msm_tree as JMT
    _, cols, _ = level_case(C.G1, 300, seed=3)
    got = KT.mid(C.G1, cols[1], cols[2])
    want = JMT.mid_jnp(JC.G1, jnp.asarray(cols[1].numpy()), jnp.asarray(cols[2].numpy()))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("K", [40, 600])
def test_level_matches_jax_level_jnp(K):
    """`KT.level` on the CPU (the plain K4, K6 and additions with node
    updates) against the JAX package's portable `msm_tree.level_jnp`, with
    the emission, on every group-law case and flag combination.  Tolerance
    0: the values are canonical and inverses unique."""
    import jax.numpy as jnp
    from groth16_tpu.ops import curve as JC, msm_tree as JMT
    _, cols, _ = level_case(C.G1, K, seed=K + 1)
    views, flags = level_views(cols), level_flags(K)
    got = KT.level(C.G1, *views, *flags, True)
    want = JMT.level_jnp(JC.G1, *(jnp.asarray(v.contiguous().numpy()) for v in views),
                         *(jnp.asarray(f.numpy()) for f in flags), True)
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want, strict=True))


def test_window_sums_tree_explicit_level_fn():
    """`level_fn=KT.level` given explicitly is the default; a level that
    merges nothing changes the sums."""
    ks, pts, _ = adversarial_case(C.G1, 13, seed=8)
    s, P = torch.from_numpy(ints_to_limbs(ks)), C.points_from_host(C.G1, pts, "cpu")
    want = MT.window_sums_tree(C.G1, s, P, 8, 32)
    got = MT.window_sums_tree(C.G1, s, P, 8, 32, level_fn=KT.level)
    assert all(torch.equal(F.as_i32(g), F.as_i32(w)) for g, w in zip(got, want))

    def keep(cv, A_pl, A_pr, B_pl, B_pr, match, aP, bP, want_em):
        return A_pl, B_pr, (A_pr if want_em else None)

    other = MT.window_sums_tree(C.G1, s, P, 8, 32, level_fn=keep)
    assert C.points_to_host(C.G1, other) != C.points_to_host(C.G1, want)


def test_invert_rows_product_tree():
    """The phase tool's route, halvings + narrow inversion: totals wider
    than its narrow row go through one K5 halving each way and equal
    `invert`, the tree level's one batch inversion."""
    from groth16_tpu_torch.tools import bench_tree_phases as BT
    rng = np.random.default_rng(5)
    M_ = 2 * BT.NARROW
    tots = KT._limb_major(C.G1, torch.from_numpy(ints_to_limbs(
        [int(x) % F.FP.modulus or 1 for x in rng.integers(1, 1 << 62, size=M_)])).long())
    inv = BT.invert_by_halvings(C.G1, tots)
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


def level_flags(K):
    """bool[K] flags (keys match, A pure, B pure) running through all eight
    combinations, each against every group-law case of `level_case`."""
    combo = torch.arange(K) // 7 % 8
    return [(combo >> b & 1).bool() for b in range(3)]


def level_views(cols):
    """The four operand columns as the tree hands them to a level: halves
    of PL = A.pL | B.pL and PR = A.pR | B.pR, views at limb stride 2K."""
    apl, apr, bpl, bpr = cols
    K = apl.shape[1]
    PL, PR = torch.cat([apl, bpl], 1), torch.cat([apr, bpr], 1)
    return PL[:, :K], PR[:, :K], PL[:, K:], PR[:, K:]


def _shim_level(shim, cv, views, flags, want_em):
    K, ld = KT._level_cols(cv, views)
    flg = (flags[0].to(torch.uint8) + 2 * flags[1].to(torch.uint8) + 4 * flags[2].to(torch.uint8))
    outs = [torch.zeros((2 * KT.ncomp(cv), K), dtype=torch.uint32) for _ in range(3)]
    shim.shim_tree_level(int(cv.name == "G2"), *(_p(v) for v in views), _p(flg.contiguous()),
                         _p(outs[0]), _p(outs[1]), _p(outs[2]) if want_em else None, K, ld)
    return outs[0], outs[1], (outs[2] if want_em else None)


def _same_level(got, want):
    return all((g is None and w is None) or torch.equal(F.as_i32(g), F.as_i32(w))
               for g, w in zip(got, want, strict=True))


def _shim_phase_a(shim, cv, apr, bpl):
    tot = torch.zeros((KT.ncomp(cv), apr.shape[2]), dtype=torch.uint32)
    shim.shim_tree_phase_a(int(cv.name == "G2"), _p(apr), _p(bpl), _p(tot), apr.shape[2])
    return tot


@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_tree_lane_header_matches_plain(shim, cv):
    """K4's block body (bn254_curve.cuh `lane_leaf`, the lanes' trees up to
    the root) and K6 block by block vs `phase_a_plain` and `invert_plain`
    on one tile (M = INV_W lanes of T_SLOTS), and the fused level (K8) on
    the same 2,048 additions vs `level_plain`."""
    T, M_ = KT.T_SLOTS, KT.INV_W
    _, cols, flags = level_case(cv, T * M_, seed=11)
    apl, apr, bpl, bpr = (c.reshape(c.shape[0], T, M_).contiguous() for c in cols)
    g2 = int(cv.name == "G2")

    tot = _shim_phase_a(shim, cv, apr, bpl)
    assert torch.equal(F.as_i32(tot), F.as_i32(KT.phase_a_plain(cv, apr, bpl)))

    tinv = torch.zeros_like(tot)
    shim.shim_tree_invert(g2, _p(tot), _p(tinv), M_)
    assert torch.equal(F.as_i32(tinv), F.as_i32(KT.invert_plain(cv, tot)))

    views = level_views(cols)
    for want_em in (True, False):
        assert _same_level(_shim_level(shim, cv, views, flags, want_em),
                           KT.level_plain(cv, *views, *flags, want_em))


@pytest.mark.parametrize("K", [1, 37, 512, 600, 1030])
@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_tree_level_header_matches_plain(shim, cv, K):
    """The fused level (K8) block by block vs `level_plain` at widths of one
    addition, part of a block, one block, and ragged blocks: doubling,
    cancellation and infinity slots under all eight flag combinations,
    operands read as strided views, with and without the emission."""
    _, cols, _ = level_case(cv, K, seed=K)
    views, flags = level_views(cols), level_flags(K)
    for want_em in (True, False):
        assert _same_level(_shim_level(shim, cv, views, flags, want_em),
                           KT.level_plain(cv, *views, *flags, want_em))


def _shim_mid(shim, cv, apr, bpl, tinv):
    mid = torch.zeros_like(apr)
    shim.shim_tree_mid(int(cv.name == "G2"), _p(apr), _p(bpl), _p(tinv), _p(mid), apr.shape[2])
    return mid


FULL_TILE = KT.T_SLOTS * KT.INV_W       # 128 lanes: whole blocks only


@pytest.mark.parametrize("cv,K", [(C.G1, 13 * 16 - 5), (C.G1, 21 * 16), (C.G2, 13 * 16 - 5),
                                  (C.G1, FULL_TILE), (C.G2, FULL_TILE)],
                         ids=["G1-203", "G1-336", "G2-203", "G1-tile", "G2-tile"])
def test_tree_mid_blocks_match_plain_and_jax(shim, cv, K):
    """K7's block functions (bn254_curve.cuh `mid_leaf`, the lane trees,
    `mid_store`) block by block at widths that leave a partial block of
    lanes (13 and 21 lanes, blocks of 8; the first padded with (0, 0)
    additions) and on one tile of 128 lanes, on
    every group-law case of `level_case` (doublings, equal x with y1 != y2,
    (0, 0) on either side or both): against `phase_b_plain` on the planes,
    and as whole columns against the JAX package's `msm_tree.mid_jnp`."""
    import jax.numpy as jnp
    from groth16_tpu.ops import curve as JC, msm_tree as JMT
    _, cols, _ = level_case(cv, K, seed=K)
    apr, bpl, tinv = KT.mid_planes(cv, cols[1], cols[2])
    mid = _shim_mid(shim, cv, apr, bpl, tinv)
    assert torch.equal(F.as_i32(mid), F.as_i32(KT.phase_b_plain(cv, apr, bpl, tinv)))
    jcv = JC.G1 if cv.name == "G1" else JC.G2
    want = JMT.mid_jnp(jcv, jnp.asarray(cols[1].numpy()), jnp.asarray(cols[2].numpy()))
    assert np.array_equal(mid.reshape(mid.shape[0], -1)[:, :K].numpy(), np.asarray(want))


@pytest.mark.parametrize("cv,M_", [(cv, M) for cv, L in ((C.G1, 32), (C.G2, 16))
                                   for M in (1, 7, 8, 9, L, L + 1, 8 * 16 + 3)],
                         ids=lambda v: v.name if isinstance(v, C.CurveSpec) else str(v))
def test_tree_phase_a_blocks_match_plain(shim, cv, M_):
    """K4's block body block by block (blocks of 32 lanes in G1, 16 in G2:
    widths inside one partial block, exactly one full block, one full block
    and one lane, and several blocks with a partial last one) on doubling,
    cancelling and infinity slots (`level_case`) against `phase_a_plain`;
    the total of a lane is the product of its masked denominators whatever
    the tree's order."""
    _, cols, _ = level_case(cv, KT.T_SLOTS * M_, seed=M_)
    apr, bpl = (c.reshape(c.shape[0], KT.T_SLOTS, M_).contiguous() for c in cols[1:3])
    assert torch.equal(F.as_i32(_shim_phase_a(shim, cv, apr, bpl)),
                       F.as_i32(KT.phase_a_plain(cv, apr, bpl)))


def _field_rows(cv, W, seed):
    """W canonical Fp (G1) or Fp2 (G2) values as point-major uint32[W, *comp],
    with 0, 1 (Montgomery) and p - 1 among them."""
    rng = np.random.default_rng(seed)
    vals = [int(x) % F.FP.modulus for x in rng.integers(0, 1 << 62, size=W * len(cv.comp_shape))]
    vals = [F.FP.to_mont_int(v * (1 << 190) + 12345) for v in vals]
    vals[:3] = [0, F.FP.to_mont_int(1), F.FP.modulus - 1][:len(vals)]
    return torch.from_numpy(ints_to_limbs(vals).reshape((W,) + cv.comp_shape))


def _shim_mul_rows(shim, cv, a, b, out, point_major):
    W, als, acs = KT._mul_rows_operand(cv, a, point_major)
    Wb, bls, bcs = KT._mul_rows_operand(cv, b, False)
    _, ols, ocs = KT._mul_rows_operand(cv, out, point_major)
    shim.shim_tree_mul_rows(int(cv.name == "G2"), _p(a), als, acs, _p(b), bls, bcs, Wb, _p(out),
                            ols, ocs, W)
    return out


def _rows(cv, pm):
    """point-major [W, *comp] -> limb-major row [NC, W] (contiguous)."""
    return pm.reshape(pm.shape[0], -1).T.contiguous()


@pytest.mark.parametrize("W", [1, 5, 33])
@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_tree_mul_rows_strided_matches_plain_and_jax(shim, cv, W):
    """K5's strided body element by element, every operand where it lies:
    limb-major column slices of wider rows into a column slice of a wider
    output; a transposed point-major array (limb stride 1); point-major
    arrays in and out; X and Y stacked (2W points) times one row of W, b
    read at column w mod W; an aligned row at a limb stride other than 1
    (read word by word).  Against `mul_rows_plain` on the same views and
    the JAX package's field product on the same values."""
    from groth16_tpu.ops import curve as JC
    jK = (JC.G1 if cv.name == "G1" else JC.G2).fops
    nc = KT.ncomp(cv)
    pa, pb, py = _field_rows(cv, W, 2 * W), _field_rows(cv, W, 2 * W + 1), _field_rows(cv, W, 3)
    want = np.asarray(jK.mul(pa.numpy(), pb.numpy())).reshape(W, nc)
    want_y = np.asarray(jK.mul(py.numpy(), pb.numpy())).reshape(W, nc)

    wide_a = torch.zeros((nc, W + 7), dtype=torch.uint32)
    wide_a[:, 3:3 + W] = _rows(cv, pa)
    wide_b = torch.zeros((nc, 2 * W), dtype=torch.uint32)
    wide_b[:, W:] = _rows(cv, pb)
    a, b = wide_a[:, 3:3 + W], wide_b[:, W:]
    first = torch.zeros((nc, W + 4), dtype=torch.uint32)
    first[:, :W] = _rows(cv, pb)           # aligned, limb stride W + 4: no 128-bit reads
    cases = [(a, b, torch.zeros((nc, 2 * W + 1), dtype=torch.uint32)[:, 1:1 + W], False),
             (a, first[:, :W], torch.zeros((nc, W), dtype=torch.uint32), False),
             (pa.reshape(W, nc).T, b, torch.zeros((nc, W), dtype=torch.uint32), False),
             (pa, b, torch.zeros_like(pa), True)]
    for a_, b_, out, pm in cases:
        got = _shim_mul_rows(shim, cv, a_, b_, out, pm)
        plain = KT.mul_rows_plain(cv, a_, b_, point_major=pm)
        assert torch.equal(F.as_i32(got), F.as_i32(plain))
        rows = got.reshape(W, nc) if pm else got.T
        assert np.array_equal(rows.numpy(), want)

    xy = F.as_u32(torch.stack([F.as_i32(pa), F.as_i32(py)]))
    got = _shim_mul_rows(shim, cv, xy, b, torch.zeros_like(xy), True)
    assert torch.equal(F.as_i32(got), F.as_i32(KT.mul_rows_plain(cv, xy, b, point_major=True)))
    assert np.array_equal(got.reshape(2, W, nc).numpy(), np.stack([want, want_y]))


def test_mul_rows_refuses_layouts_it_cannot_read():
    """K5's operand check (the plain version and the kernel wrapper share
    it): G2 points whose c1 is not 16 limbs after c0, point axes that do
    not fold into one column stride, and a b whose width does not divide
    a's all raise; `out` writes into a view."""
    g2 = torch.zeros((6, 16, 2), dtype=torch.uint32).transpose(-1, -2)
    with pytest.raises(ValueError):
        KT.mul_rows(C.G2, g2, torch.zeros((32, 6), dtype=torch.uint32), point_major=True)
    unfold = torch.zeros((4, 6, 16), dtype=torch.uint32)[:, :3]
    with pytest.raises(ValueError):
        KT.mul_rows(C.G1, unfold, torch.zeros((16, 12), dtype=torch.uint32), point_major=True)
    with pytest.raises(ValueError):
        KT.mul_rows(C.G1, torch.zeros((16, 6), dtype=torch.uint32),
                    torch.zeros((16, 4), dtype=torch.uint32))
    pm = _field_rows(C.G1, 4, 9)
    one = _rows(C.G1, torch.from_numpy(ints_to_limbs([F.FP.to_mont_int(1)])))
    buf = torch.zeros((16, 9), dtype=torch.uint32)
    KT.mul_rows(C.G1, _rows(C.G1, pm), one, out=buf[:, 5:])
    assert torch.equal(F.as_i32(buf[:, 5:]), F.as_i32(_rows(C.G1, pm)))
    assert not F.as_i32(buf[:, :5]).any()


@pytest.mark.slow
def test_tree_msm_matches_jax_msm_tree():
    import jax.numpy as jnp
    from groth16_tpu.ops import curve as JC, msm_tree as JMT
    ks, pts, _ = adversarial_case(C.G1, 13, seed=21)
    got = tree_msm(C.G1, torch.from_numpy(ints_to_limbs(ks)), C.points_from_host(C.G1, pts, "cpu"), 8, 8)
    want = JMT.msm_tree(JC.G1, jnp.asarray(ints_to_limbs(ks)), JC.points_from_host(JC.G1, pts),
                        8, group=8)
    x, y = C.to_affine(C.G1, got)
    jx, jy = JC.to_affine(JC.G1, want)
    assert np.array_equal(x.numpy(), np.asarray(jx)) and np.array_equal(y.numpy(), np.asarray(jy))
