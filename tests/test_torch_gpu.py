"""Kernels K1-K6 and K8 on the card against their plain PyTorch versions,
the merge-tree MSM and one small proof on the card.  Marked `gpu`: they skip without CUDA.  On a GPU
machine (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from groth16_tpu_torch.ops import curve as C, field as F, kernels as KN, kernels_tree as KT
from groth16_tpu_torch.ops import msm_tree as MT, ntt as NT
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
    P = C.inf_like(C.G1, (4,))
    with pytest.raises(ValueError):
        KN.point_add(C.G1, P, P)
    with pytest.raises(ValueError):
        NT.ntt_inner_kernel(torch.zeros((16, 1, 4), dtype=torch.uint32), None,
                            NT.stage_roots(4, 1, "cpu"), False)
    planes = torch.zeros((32, KT.T_SLOTS, 128), dtype=torch.uint32)
    with pytest.raises(ValueError):
        KT.phase_a_kernel(C.G1, planes, planes)
    with pytest.raises(ValueError):
        KT.invert_kernel(C.G1, torch.zeros((16, 128), dtype=torch.uint32))


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
    assert _same(KN.point_double(cv, P), C.point_double_plain(cv, P))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "projective"])
@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_fold_kernel_matches_plain(dev, cv, affine):
    from groth16_tpu_torch.protocol.fake_setup import fixed_base_mul
    rng = np.random.default_rng(2)
    T, lanes = 32, 300
    keys = np.sort(rng.integers(0, 40, size=(T, lanes)), axis=0)
    keys = keys * np.where(rng.integers(0, 2, size=(T, lanes)) > 0, 1, -1)
    kT = torch.from_numpy(keys.astype(np.int32)).to(dev)
    P = fixed_base_mul(cv, _scalars(rng, T * lanes, dev))
    coords = C.to_affine(cv, P) if affine else P
    rows = torch.cat([F.as_i32(c).reshape(T * lanes, -1) for c in coords], -1)
    if affine:
        rows[::11] = 0
    pT = F.as_u32(rows.reshape(T, lanes, -1).permute(0, 2, 1).contiguous())
    assert _same(KN.fold_level_kernel(cv, kT, pT, affine), KN.fold_level_plain(cv, kT, pT, affine))


@pytest.mark.gpu
@pytest.mark.parametrize("log2n", [3, 10, 15])
def test_ntt_kernel_matches_plain(dev, log2n):
    rng = np.random.default_rng(log2n)
    for inverse in (False, True):
        for NB, T, tw, roots, dit in NT.inner_calls(log2n, inverse, dev):
            x = _scalars(rng, NB * T, dev).T.contiguous().reshape(16, NB, T)
            assert torch.equal(F.as_i32(NT.ntt_inner_kernel(x, tw, roots, dit)),
                               F.as_i32(NT.ntt_inner_plain(x, tw, roots, dit)))
    dom = NT.Domain(log2n)
    x = _scalars(rng, dom.size, dev)
    fwd = NT.forward_ntt(dom, x)
    assert torch.equal(F.as_i32(fwd).cpu(), F.as_i32(NT.forward_ntt(dom, x.cpu())))
    assert torch.equal(F.as_i32(NT.inverse_ntt(dom, fwd)), F.as_i32(x))


@pytest.mark.gpu
@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_tree_kernels_match_plain(dev, cv):
    from test_torch_tree import level_case
    T, M = KT.T_SLOTS, 2 * KT.INV_W
    _, cols, flags = level_case(cv, T * M, seed=12)
    apl, apr, bpl, bpr = (c.reshape(c.shape[0], T, M).to(dev) for c in cols)
    flg = (flags[0].int() | flags[1].int() << 1 | flags[2].int() << 2).reshape(T, M).to(dev)
    tot = KT.phase_a_kernel(cv, apr, bpl)
    assert torch.equal(F.as_i32(tot), F.as_i32(KT.phase_a_plain(cv, apr, bpl)))
    tinv = KT.invert_kernel(cv, tot)
    assert torch.equal(F.as_i32(tinv), F.as_i32(KT.invert_plain(cv, tot)))
    assert torch.equal(F.as_i32(KT.mul_rows_kernel(cv, tinv, tot)),
                       F.as_i32(KT.mul_rows_plain(cv, tinv, tot)))
    for want_em in (True, False):
        got = KT.phase_b_level_kernel(cv, apl, apr, bpl, bpr, flg, tinv, want_em)
        want = KT.phase_b_level_plain(cv, apl, apr, bpl, bpr, flg, tinv, want_em)
        assert all(g is w or torch.equal(F.as_i32(g), F.as_i32(w)) for g, w in zip(got, want))


@pytest.mark.gpu
def test_tree_msm_on_the_card(dev):
    from test_torch_tree import adversarial_case
    ks, pts, want = adversarial_case(C.G1, 40, seed=40)
    got = MT.msm_tree(C.G1, torch.from_numpy(ints_to_limbs(ks)).to(dev),
                      C.points_from_host(C.G1, pts, dev), 8, group=16)
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
