"""Kernels K1-K9 on the card against their plain PyTorch versions (K1's
chains, the wide K6, K2's levels, the fused tree level K8, every K3 step of
every plan and the quotient's pointwise kernel, K4 at partial blocks, K5 on
strided and point-major operands included), the SpMV and the Fp negation
kernels, `to_affine` on the card against the CPU, the merge-tree MSM, the
chunked MSM, one small proof and a batch of proofs on the card, and the
fused path's CUDA graph (one capture per zkey, device and flavour; replays
equal to the staged proofs).  Marked `gpu`: they skip without CUDA.  On a GPU
machine (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from groth16_tpu_torch.ops import curve as C, field as F, kernels as KN, kernels_tree as KT
from groth16_tpu_torch.ops import ntt as NT
from groth16_tpu_torch.ops.limbs import ints_to_limbs

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scalars(rng, n, dev):
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    limbs[:, 15] &= 0x2FFF
    return torch.from_numpy(limbs).to(dev)


def _same(a, b):
    return all(torch.equal(F.as_i32(x), F.as_i32(y)) for x, y in zip(a, b))


def test_wrappers_refuse_cpu_tensors():
    P = C.inf_like(C.G1, (4,), "cpu")
    with pytest.raises(ValueError):
        KN.point_add(C.G1, P, P)
    with pytest.raises(ValueError):
        KN.point_double_n(C.G1, P, 3)
    with pytest.raises(ValueError):
        KN.horner(C.G1, P, 3)
    with pytest.raises(ValueError):
        NT.ntt_inner_kernel(torch.zeros((1, 4, 16), dtype=torch.uint32),
                            NT.inner_calls(2, "forward", "cpu")[0], True)
    with pytest.raises(ValueError):
        NT.quotient_pointwise_kernel(torch.zeros((3, 4, 8), dtype=torch.uint32), None, True)
    planes = torch.zeros((32, KT.T_SLOTS, 128), dtype=torch.uint32)
    with pytest.raises(ValueError):
        KT.phase_a_kernel(C.G1, planes, planes)
    with pytest.raises(ValueError):
        KT.mul_rows_kernel(C.G1, planes[:16, 0], planes[:16, 0])
    with pytest.raises(ValueError):
        KT.invert_kernel(C.G1, torch.zeros((16, 128), dtype=torch.uint32))
    with pytest.raises(ValueError):
        KT.phase_b_kernel(C.G1, planes, planes, torch.zeros((16, 128), dtype=torch.uint32))
    with pytest.raises(ValueError):
        KN.fp_mul_chain_kernel(planes[:16, 0], planes[:16, 0], 4)
    keys = torch.zeros((2, 64), dtype=torch.int32)
    table = torch.zeros((2, 5, 48), dtype=torch.uint32)
    with pytest.raises(ValueError):
        KN.fold_level_kernel(C.G1, torch.zeros((64, 32), dtype=torch.uint32), keys, keys, table,
                             32, affine=True)
    cols = torch.zeros((32, 256), dtype=torch.uint32)
    flag = torch.zeros(128, dtype=torch.bool)
    with pytest.raises(ValueError):
        KT.level_kernel(C.G1, cols[:, :128], cols[:, :128], cols[:, 128:], cols[:, 128:],
                        flag, flag, flag, True)


@pytest.mark.gpu
@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_point_kernel_matches_plain(dev, cv):
    from groth16_tpu_torch.protocol.fake_setup import fixed_base_mul
    rng = np.random.default_rng(1)
    P = fixed_base_mul(cv, _scalars(rng, 1000, dev))
    Q = fixed_base_mul(cv, _scalars(rng, 1000, dev))
    inf = C.inf_like(cv, (1000,), dev)
    P = C.point_select(cv, torch.arange(1000, device=dev) % 9 == 0, inf, P)
    Q = C.point_select(cv, torch.arange(1000, device=dev) % 7 == 0, P, Q)
    assert _same(KN.point_add(cv, P, Q), C.point_add_plain(cv, P, Q))
    assert _same(KN.point_double_n(cv, P, 1), C.point_double_plain(cv, P))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_point_chain_kernels_match_plain(dev, cv):
    """K1's doubling chain and Horner (one window axis and a batch of
    Horners) with infinities and two equal windows, bit for bit."""
    from groth16_tpu_torch.protocol.fake_setup import fixed_base_mul
    rng = np.random.default_rng(3)
    n = 600
    P = fixed_base_mul(cv, _scalars(rng, n, dev))
    P = C.point_select(cv, torch.arange(n, device=dev) % 9 == 0, C.inf_like(cv, (n,), dev), P)
    for k in (0, 1, 5):
        assert _same(KN.point_double_n(cv, P, k), C.point_double_n_plain(cv, P, k))
    B, W, c = 3, 6, 5
    S = [x[:B * W].reshape((B, W) + cv.comp_shape).clone() for x in P]
    for x in S:
        F.as_i32(x)[:, 3] = F.as_i32(x)[:, 2]
    S = tuple(S)
    assert _same(KN.horner(cv, S, c), C.horner_plain(cv, S, c))
    one = tuple(x[1] for x in S)
    assert _same(KN.horner(cv, one, c), C.horner_plain(cv, one, c))
    assert KN.horner(cv, one, c)[0].shape == cv.comp_shape
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("cv,m", [(C.G1, 1), (C.G1, 127), (C.G1, 1300), (C.G2, 1), (C.G2, 300)],
                         ids=["G1-1", "G1-127", "G1-1300", "G2-1", "G2-300"])
def test_invert_kernel_any_width(dev, cv, m):
    """The wide K6 at ragged M, zeros among the totals where M allows."""
    rng = np.random.default_rng(m)
    tots = _scalars(rng, m * KT.ncomp(cv) // 16, dev).reshape(m, -1).T.contiguous()
    if m > 100:
        F.as_i32(tots)[:, [7, m - 1]] = 0
    assert torch.equal(F.as_i32(KT.invert_kernel(cv, tots)), F.as_i32(KT.invert_plain(cv, tots)))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_to_affine_card_matches_cpu(dev, cv):
    """`to_affine` on the card (K6 inverts Z, one K5 launch multiplies X and
    Y) against `to_affine` of the same points on the CPU, an infinity among
    them."""
    from groth16_tpu_torch.protocol.fake_setup import fixed_base_mul
    n = 50
    P = fixed_base_mul(cv, _scalars(np.random.default_rng(4), n, dev))
    P = C.point_select(cv, torch.arange(n, device=dev) == 7, C.inf_like(cv, (n,), dev), P)
    before = (KT.invert_kernel.launches, KT.mul_rows_kernel.launches)
    got = C.to_affine(cv, P)
    assert (KT.invert_kernel.launches, KT.mul_rows_kernel.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    want = C.to_affine(cv, tuple(c.cpu() for c in P))
    assert _same(tuple(g.cpu() for g in got), want)
    assert not F.as_i32(got[0][7]).any() and not F.as_i32(got[1][7]).any()


@pytest.mark.gpu
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "projective"])
@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_fold_kernel_matches_plain(dev, cv, affine):
    """K2 against `fold_level_plain` at T = 1, 4 and 32 (and the last level,
    one lane a window): the table (holding sums already), the trail and its
    keys, with runs across lanes, negative digits, (0, 0) points and, in
    the projective case, rows without an order."""
    from test_torch_fold import fold_case
    W, m, n, nb = 4, 256, 300, 40
    rows, order, keys, table = (x.to(dev) for x in fold_case(cv, affine, W, m, n, nb, seed=2))
    for T, last in ((1, False), (4, False), (32, False), (m, True)):
        for o in ([order] if affine else [order, None]):
            r = rows if o is not None else F.as_u32(
                F.as_i32(rows)[torch.arange(W * m, device=dev) % n].contiguous())
            tk, tp = table.clone(), table.clone()
            got = KN.fold_level_kernel(cv, r, o, keys, tk, T, affine, last)
            want = KN.fold_level_plain(cv, r, o, keys, tp, T, affine, last)
            assert torch.equal(F.as_i32(tk), F.as_i32(tp))
            assert all(g is w or torch.equal(F.as_i32(g), F.as_i32(w)) for g, w in zip(got, want))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("log2n", [3, 10, 15])
def test_ntt_kernel_matches_plain(dev, log2n):
    """K3 at every step of every plan (the quotient's coset shift with a batch
    of three), wire or packed in, against its plain version; the NTT API on
    the card against the CPU."""
    rng = np.random.default_rng(log2n)
    eta = NT.Domain(log2n + 1).gen
    for kind in NT.KINDS:
        B = 3 if kind == "to_coset" else 1
        x = _scalars(rng, B << log2n, dev).reshape(B, 1 << log2n, 16)
        for j, s in enumerate(NT.inner_calls(log2n, kind, dev, eta)):
            xin = x if j == 0 else NT.pack(x)
            for wire_out in (False, True):
                assert torch.equal(F.as_i32(NT.ntt_inner_kernel(xin, s, wire_out)),
                                   F.as_i32(NT.ntt_inner_plain(xin, s, wire_out)))
    dom = NT.Domain(log2n)
    x = _scalars(rng, dom.size, dev)
    fwd = NT.forward_ntt(dom, x)
    assert torch.equal(F.as_i32(fwd).cpu(), F.as_i32(NT.forward_ntt(dom, x.cpu())))
    assert torch.equal(F.as_i32(NT.inverse_ntt(dom, fwd)), F.as_i32(x))


@pytest.mark.gpu
@pytest.mark.parametrize("log2n", [3, 10, 16])
def test_quotient_kernels_match_plain(dev, log2n):
    """The quotient on the card (K3 four or six times, the pointwise kernel
    once) against the plain versions on the card, both flavours."""
    from groth16_tpu_torch.protocol.prover import quotient_scalars
    from groth16_tpu_torch.protocol.types import Flavour
    rng = np.random.default_rng(20 + log2n)
    abc = [_scalars(rng, 1 << log2n, dev).to(torch.int64) for _ in range(3)]
    for flavour, steps in ((Flavour.Snarkjs, 4), (Flavour.JensGroth, 6)):
        before = (NT.ntt_inner_kernel.launches, NT.quotient_pointwise_kernel.launches)
        got = quotient_scalars(flavour, *abc, log2n)
        after = (NT.ntt_inner_kernel.launches, NT.quotient_pointwise_kernel.launches)
        assert (after[0] - before[0], after[1] - before[1]) == (steps, 1)
        want = quotient_scalars(flavour, *abc, log2n, plain=True)
        assert torch.equal(F.as_i32(got), F.as_i32(want))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_tree_kernels_match_plain(dev, cv):
    """K4, K6, K5 and K7 on planes of 2 x INV_W lanes, and the fused level K8
    at ragged widths (operands as strided views, all flag combinations)
    against their plain versions."""
    from test_torch_tree import level_case, level_flags, level_views
    T, M = KT.T_SLOTS, 2 * KT.INV_W
    _, cols, _ = level_case(cv, T * M, seed=12)
    apr, bpl = (c.reshape(c.shape[0], T, M).to(dev) for c in cols[1:3])
    tot = KT.phase_a_kernel(cv, apr, bpl)
    assert torch.equal(F.as_i32(tot), F.as_i32(KT.phase_a_plain(cv, apr, bpl)))
    tinv = KT.invert_kernel(cv, tot)
    assert torch.equal(F.as_i32(tinv), F.as_i32(KT.invert_plain(cv, tot)))
    assert torch.equal(F.as_i32(KT.mul_rows_kernel(cv, tinv, tot)),
                       F.as_i32(KT.mul_rows_plain(cv, tinv, tot)))
    assert torch.equal(F.as_i32(KT.phase_b_kernel(cv, apr, bpl, tinv)),
                       F.as_i32(KT.phase_b_plain(cv, apr, bpl, tinv)))
    for K in (1, 37, 512, 600, 1030, T * M):
        views = level_views([c[:, :K].to(dev) for c in cols])
        flags = [f.to(dev) for f in level_flags(K)]
        for want_em in (True, False):
            got = KT.level_kernel(cv, *views, *flags, want_em)
            want = KT.level_plain(cv, *views, *flags, want_em)
            assert all(g is w or torch.equal(F.as_i32(g), F.as_i32(w)) for g, w in zip(got, want))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("cv,K", [(C.G1, 13 * 16 - 5), (C.G1, 1 << 14), (C.G2, 21 * 16)],
                         ids=["G1-203", "G1-16384", "G2-336"])
def test_tree_mid_kernel_partial_blocks(dev, cv, K):
    """K7 (blocks of 8 lanes) at widths with a partial last block and a
    whole number of blocks, every group-law case, against `phase_b_plain`."""
    from test_torch_tree import level_case
    _, cols, _ = level_case(cv, K, seed=K)
    apr, bpl, tinv = KT.mid_planes(cv, cols[1].to(dev), cols[2].to(dev))
    assert torch.equal(F.as_i32(KT.phase_b_kernel(cv, apr, bpl, tinv)),
                       F.as_i32(KT.phase_b_plain(cv, apr, bpl, tinv)))


@pytest.mark.gpu
@pytest.mark.parametrize("cv,M", [(C.G1, 8192), (C.G1, 1 << 17), (C.G2, 256), (C.G1, 1),
                                  (C.G1, 9), (C.G1, 32), (C.G1, 33), (C.G2, 16), (C.G2, 17),
                                  (C.G2, 131)],
                         ids=["G1-8192", "G1-2^17", "G2-256", "G1-1", "G1-9", "G1-32", "G1-33",
                              "G2-16", "G2-17", "G2-131"])
def test_phase_a_kernel_shapes(dev, cv, M):
    """K4 (blocks of 32 lanes in G1, 16 in G2) at the smoke's shapes, at
    widths that leave a partial block, and at one full block and one full
    block and one lane, every group-law case, against `phase_a_plain`."""
    from groth16_tpu_torch.tools.bench_tree_phases import level_case, level_views
    PL, PR, _ = level_case(np.random.default_rng(M), cv, KT.T_SLOTS * M, dev)
    apr, bpl = (c.reshape(c.shape[0], KT.T_SLOTS, M).contiguous()
                for c in level_views(PL, PR)[1:3])
    assert torch.equal(F.as_i32(KT.phase_a_kernel(cv, apr, bpl)),
                       F.as_i32(KT.phase_a_plain(cv, apr, bpl)))


@pytest.mark.gpu
@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_mul_rows_kernel_layouts(dev, cv):
    """K5 at the smoke's shapes on operands where they lie, against
    `mul_rows_plain` on the same views: column slices of a row (W = 4096,
    2048, 2^16 in G1), point-major arrays (2^20 in G1), the proof's W = 1,
    b read modulo its width (X and Y stacked), and `out` a column slice."""
    rng = np.random.default_rng(15)
    nc = KT.ncomp(cv)

    def row(W):
        return _scalars(rng, W * nc // 16, dev).reshape(W, nc).T.contiguous()

    widths = (4096, 2048, 1 << 16) if cv.name == "G1" else (4096,)
    for W in widths:
        tot = row(2 * W)
        a, b = tot[:, :W], tot[:, W:]
        assert torch.equal(F.as_i32(KT.mul_rows_kernel(cv, a, b)),
                           F.as_i32(KT.mul_rows_plain(cv, a, b)))
        up = torch.zeros((nc, 2 * W), dtype=torch.uint32, device=dev)
        KT.mul_rows_kernel(cv, a, b, out=up[:, W:])
        assert torch.equal(F.as_i32(up[:, W:]), F.as_i32(KT.mul_rows_plain(cv, a, b)))
        assert not F.as_i32(up[:, :W]).any()
    for W in ((1 << 20, 1) if cv.name == "G1" else (1, 300)):
        pm = _scalars(rng, W * nc // 16, dev).reshape((W,) + cv.comp_shape)
        zinv = row(W)
        assert torch.equal(F.as_i32(KT.mul_rows_kernel(cv, pm, zinv, point_major=True)),
                           F.as_i32(KT.mul_rows_plain(cv, pm, zinv, point_major=True)))
        xy = F.as_u32(torch.stack([F.as_i32(pm), F.as_i32(pm.flip(0))]))
        assert torch.equal(F.as_i32(KT.mul_rows_kernel(cv, xy, zinv, point_major=True)),
                           F.as_i32(KT.mul_rows_plain(cv, xy, zinv, point_major=True)))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_mul_chain_kernel_matches_plain(dev):
    rng = np.random.default_rng(13)
    a, b = (_scalars(rng, 5000, dev).T.contiguous() for _ in range(2))
    for k in (0, 1, 37):
        assert torch.equal(F.as_i32(KN.fp_mul_chain_kernel(a, b, k)),
                           F.as_i32(KN.fp_mul_chain_plain(a, b, k)))


@pytest.mark.gpu
def test_msm_chunked_on_the_card(dev):
    from groth16_tpu_torch.ops import msm as M
    from groth16_tpu_torch.tools.bench_tree_phases import make_points
    n = 1 << 17
    P = make_points(n, dev)
    s = _scalars(np.random.default_rng(14), n, dev)
    want = C.to_affine(C.G1, M.msm(C.G1, s, P, affine=True))
    got = M.msm_chunked(C.G1, s.cpu().numpy(), tuple(c.cpu().numpy() for c in P), 16,
                        device=dev)
    assert _same(C.to_affine(C.G1, got), want)


@pytest.mark.gpu
def test_tree_msm_on_the_card(dev):
    from test_torch_tree import adversarial_case, tree_msm
    ks, pts, want = adversarial_case(C.G1, 40, seed=40)
    got = tree_msm(C.G1, torch.from_numpy(ints_to_limbs(ks)).to(dev),
                   C.points_from_host(C.G1, pts, dev), 8, 16)
    assert C.points_to_host(C.G1, tuple(x[None] for x in got))[0] == want


@pytest.mark.gpu
def test_small_proof_on_the_card(dev):
    import groth16_tpu_torch as G
    from groth16_tpu_torch.models.circuits import synthetic_circuit
    r1cs, wtns = synthetic_circuit(8)
    zkey = G.fake_circuit_setup(r1cs, G.ToxicWaste(3, 5, 7, 11, 13), G.Flavour.JensGroth, dev)
    before = (KN.point_add.launches, KN.fold_level_kernel.launches, NT.ntt_inner_kernel.launches)
    prf = G.generate_proof_with_mask(zkey, wtns, G.Mask(17, 19), dev)
    after = (KN.point_add.launches, KN.fold_level_kernel.launches, NT.ntt_inner_kernel.launches)
    assert all(a > b for a, b in zip(after, before))
    assert G.verify_proof(G.extract_vkey(zkey), prf)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sparse", "dense rows", "one row", "power law"])
def test_spmv_kernel_matches_plain(dev, name):
    """The SpMV kernel against its plain version on the card: empty rows,
    dense rows, Zipf row lengths, repeated columns, r - 1
    (tests/spmv_cases.py); rows crossing the card's blocks at the default
    schedule."""
    from spmv_cases import case_set
    n_rows, w, matrix, row, col, coeff = case_set(name)
    m = KN.spmv_rows(matrix, row, col, coeff, n_rows, dev)
    w = torch.from_numpy(w).to(dev)
    before = KN.spmv_kernel.launches
    got = KN.spmv(w, m)
    assert KN.spmv_kernel.launches == before + 1
    assert _same(got, KN.spmv_plain(w, m))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_fp_neg_kernel_matches_plain(dev):
    rng = np.random.default_rng(31)
    x = _scalars(rng, 1000, dev)
    F.as_i32(x)[::7] = 0                         # (0, 0) infinities stay 0
    for t in (x, x.reshape(-1, 2, 16)):
        before = KN.fp_neg_kernel.launches
        got = KN.fp_neg(t)
        assert KN.fp_neg_kernel.launches == before + 1
        assert _same((got,), (KN.fp_neg_plain(t),))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_batch_proofs_on_the_card(dev):
    """generate_proofs over two witnesses: one upload of the zkey, one SpMV
    launch a proof, each proof equal to its single proof and verifying."""
    import groth16_tpu_torch as G
    from groth16_tpu_torch.models.circuits import synthetic_circuit
    from groth16_tpu_torch.protocol import prover as PV
    r1cs = synthetic_circuit(8)[0]
    zkey = G.fake_circuit_setup(r1cs, G.ToxicWaste(3, 5, 7, 11, 13), G.Flavour.Snarkjs, dev)
    ws = [synthetic_circuit(8, seed)[1] for seed in (42, 43)]
    masks = [G.Mask(17, 19), G.Mask(23, 29)]
    builds, spmv = PV.zkey_device_args.builds, KN.spmv_kernel.launches
    batch = G.generate_proofs(zkey, ws, dev, masks)
    assert PV.zkey_device_args.builds == builds + 1
    assert KN.spmv_kernel.launches == spmv + 2
    singles = [G.generate_proof_with_mask(zkey, w, m, dev) for w, m in zip(ws, masks)]
    assert [(p.pi_a, p.pi_b, p.pi_c) for p in batch] == [(p.pi_a, p.pi_b, p.pi_c) for p in singles]
    assert all(G.verify_proof(G.extract_vkey(zkey), p) for p in batch)


@pytest.mark.gpu
@pytest.mark.parametrize("flavour", ["snarkjs", "jens-groth"])
def test_fused_graph_replays_equal_staged(dev, flavour):
    """The fused path at 2^9: the graph captured at the first proof and
    replayed for three witnesses and masks gives the fused=False proofs,
    which verify; one graph per (zkey, device, flavour), and a second zkey
    gets its own."""
    import groth16_tpu_torch as G
    from groth16_tpu_torch.models.circuits import synthetic_circuit
    from groth16_tpu_torch.ops.field import FR
    from groth16_tpu_torch.protocol import prover as PV
    r1cs = synthetic_circuit(9)[0]
    toxic = G.ToxicWaste(3, 5, 7, 11, 13)
    zkey = G.fake_circuit_setup(r1cs, toxic, G.Flavour(flavour), dev)
    ws = [synthetic_circuit(9, seed)[1] for seed in (42, 43, 44)]
    q = FR.modulus
    masks = [G.Mask(17, 19), G.Mask(0, 0), G.Mask(q - 1, q - 1)]
    captures, timings = PV.fused_graph.captures, []
    fused = G.generate_proofs(zkey, ws, dev, masks, timings)
    assert PV.fused_graph.captures == captures + 1
    assert "capture_s" in timings[0] and not any("capture_s" in t for t in timings[1:])
    staged = G.generate_proofs(zkey, ws, dev, masks, fused=False)
    assert [(p.pi_a, p.pi_b, p.pi_c) for p in fused] == [(p.pi_a, p.pi_b, p.pi_c) for p in staged]
    vkey = G.extract_vkey(zkey)
    assert all(G.verify_proof(vkey, p) for p in fused)
    graphs = [k for k in zkey.device_cache if isinstance(k, tuple) and k[0] == "fused"]
    assert graphs == [("fused", "cuda:0", flavour)]
    other = G.fake_circuit_setup(r1cs, G.ToxicWaste(2, 3, 5, 7, 9), G.Flavour(flavour), dev)
    prf = G.generate_proof_with_mask(other, ws[0], masks[0], dev, fused=True)
    assert PV.fused_graph.captures == captures + 2
    assert PV.fused_graph(zkey, dev) is zkey.device_cache[graphs[0]]
    assert G.verify_proof(G.extract_vkey(other), prf)
    assert (prf.pi_a, prf.pi_b, prf.pi_c) != (fused[0].pi_a, fused[0].pi_b, fused[0].pi_c)


@pytest.mark.gpu
def test_fused_proofs_from_two_threads(dev):
    """Two threads proving with one zkey at once from a cold cache: one
    capture, and each thread's proofs are the fused=False proofs of its own
    witnesses and masks (the graph's buffers are taken in turns)."""
    from concurrent.futures import ThreadPoolExecutor
    import threading
    import groth16_tpu_torch as G
    from groth16_tpu_torch.models.circuits import synthetic_circuit
    from groth16_tpu_torch.protocol import prover as PV
    r1cs = synthetic_circuit(9)[0]
    zkey = G.fake_circuit_setup(r1cs, G.ToxicWaste(3, 5, 7, 11, 13), G.Flavour.Snarkjs, dev)
    ws = [synthetic_circuit(9, seed)[1] for seed in (42, 43, 44, 45)]
    masks = [G.Mask(17 + i, 19 + 5 * i) for i in range(len(ws))]
    staged = [G.generate_proof_with_mask(zkey, w, m, dev, fused=False) for w, m in zip(ws, masks)]
    captures = PV.fused_graph.captures
    start = threading.Barrier(2)

    def prove(t):
        start.wait()
        return [(i, G.generate_proof_with_mask(zkey, ws[i], masks[i], dev))
                for _ in range(3) for i in (t, t + 2)]

    with ThreadPoolExecutor(2) as pool:
        runs = [f.result() for f in [pool.submit(prove, t) for t in (0, 1)]]
    assert PV.fused_graph.captures == captures + 1
    for i, prf in (pair for run in runs for pair in run):
        assert (prf.pi_a, prf.pi_b, prf.pi_c) == (staged[i].pi_a, staged[i].pi_b, staged[i].pi_c)
        assert prf.public_io == staged[i].public_io
