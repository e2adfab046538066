"""The fused one-dispatch prover on the CPU (groth16_tpu_torch/protocol/
prover.py: `prove_core_device`, its spec-point algebra, the path
selection): the core, run eagerly through the plain versions, gives the
port's staged proof of synthetic_circuit(5) (the naive MSMs) under the
masks (0, 0), a fixed pair and (q - 1, q - 1); the device algebra's
window tables and ladders equal the host-int group law for scalars 0, 1,
q - 1 and random ones, G1 and G2; `fused=True` on a CPU device raises and
`fused=None` there is the staged path.  The slow lane runs the whole
`prove_core_device` against the staged proof in both flavours at both
sizes.  tests/test_torch_fused_guard.py holds JensGroth at the fold's size
and the capture guard; tests/test_torch_gpu.py the captured graph on the
card."""

import numpy as np
import pytest
import torch

from fused_cases import CPU, MASKS, Q, STAGED_KEYS, fused_points, points, shared_msms, \
    staged_proofs
from test_snarkjs_golden import FIXED_TOXIC

import groth16_tpu_torch as T
from groth16_tpu_torch.models.circuits import synthetic_circuit
from groth16_tpu_torch.ops import curve as C
from groth16_tpu_torch.ops.limbs import ints_to_limbs
from groth16_tpu_torch.protocol import prover as PV
from groth16_tpu_torch.utils import hostmath as H

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

RNG = np.random.default_rng(11)
SCALARS = [0, 1, Q - 1] + [int.from_bytes(RNG.bytes(32), "little") % Q for _ in range(2)]


@pytest.fixture(scope="module")
def snarkjs5():
    """(zkey, witness, the staged proofs under MASKS and the first one's
    timings, the fused core's points under MASKS); the two paths share
    their MSM results where their inputs agree (`shared_msms`)."""
    r1cs, wtns = synthetic_circuit(5)
    zkey = T.fake_circuit_setup(r1cs, T.ToxicWaste(**FIXED_TOXIC), T.Flavour.Snarkjs, CPU)
    with shared_msms():
        staged, timings = staged_proofs(zkey, wtns, MASKS)
        return zkey, wtns, staged, timings, fused_points(zkey, wtns, MASKS)


@pytest.mark.parametrize("i", range(len(MASKS)), ids=["zero", "fixed", "q-1"])
def test_core_equals_staged(snarkjs5, i):
    zkey, _, staged, _, fused = snarkjs5
    assert fused[i] == points(staged[i])
    assert T.verify_proof(T.extract_vkey(zkey), staged[i])


def test_default_on_cpu_is_staged(snarkjs5):
    _, _, _, timings, _ = snarkjs5
    assert set(timings) == STAGED_KEYS


def test_fused_on_cpu_raises(snarkjs5):
    zkey, wtns, _, _, _ = snarkjs5
    with pytest.raises(ValueError):
        T.generate_proof_with_mask(zkey, wtns, MASKS[1], CPU, fused=True)
    with pytest.raises(ValueError):
        T.generate_proofs(zkey, [wtns], CPU, MASKS[:1], fused=True)
    with pytest.raises(ValueError):
        PV.FusedProof(zkey, CPU)


def _curve(name):
    return (C.G1, H.g1_mul, H.g1_add) if name == "G1" else (C.G2, H.g2_mul, H.g2_add)


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_table_mul_matches_host(name):
    cv, mul, _ = _curve(name)
    base = mul(0x5EED_1234_5678)
    table = C.window_table(cv, base, PV.SPEC_WINDOW, CPU)
    got = C.points_to_host(cv, PV.table_mul(cv, table, torch.from_numpy(ints_to_limbs(SCALARS))))
    assert got == [mul(k, base) if k else None for k in SCALARS]


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_window_mul_matches_host(name):
    cv, mul, _ = _curve(name)
    bases = [mul(7 + 3 * i) for i in range(len(SCALARS))]
    bases[1] = None                                   # 1 * infinity
    P = C.points_from_host(cv, bases, CPU)
    got = C.points_to_host(cv, PV.window_mul(cv, P, torch.from_numpy(ints_to_limbs(SCALARS))))
    assert got == [mul(k, b) if k and b is not None else None for k, b in zip(SCALARS, bases)]


def test_multiples_are_the_small_multiples():
    base = H.g2_mul(99)
    got = C.points_to_host(C.G2, C.multiples(C.G2, C.points_from_host(C.G2, [base], CPU), 3))
    assert got == [None] + [H.g2_mul(99 * d) for d in range(1, 8)]


@pytest.mark.parametrize("r,s", [(0, 0), (1, 1), (Q - 1, Q - 1), (SCALARS[3], SCALARS[4])],
                         ids=["zero", "one", "q-1", "random"])
def test_spec_algebra_matches_host(snarkjs5, r, s):
    """The algebra of prover.nim:278-302 on random MSM points, against the
    staged path's host formula."""
    zkey = snarkjs5[0]
    spec = zkey.spec
    g1 = [H.g1_mul(5 + i) for i in range(4)]
    g2 = H.g2_mul(77)
    msms = [C.points_from_host(cv, [pt], CPU) for cv, pt in
            ((C.G1, g1[0]), (C.G1, g1[1]), (C.G2, g2), (C.G1, g1[2]), (C.G1, g1[3]))]
    got = PV.proof_points(PV.proof_buffer(*PV.spec_algebra(
        PV.spec_device_args(zkey, CPU), [tuple(c[0] for c in P) for P in msms],
        torch.from_numpy(PV.mask_limbs(T.Mask(r, s))))))
    pi_a = H.g1_add(H.g1_add(spec.alpha1, H.g1_mul(r, spec.delta1)), g1[0])
    rho = H.g1_add(H.g1_add(spec.beta1, H.g1_mul(s, spec.delta1)), g1[1])
    pi_b = H.g2_add(H.g2_add(spec.beta2, H.g2_mul(s, spec.delta2)), g2)
    pi_c = H.g1_add(H.g1_mul(s, pi_a), H.g1_mul(r, rho))
    for pt in (H.g1_mul((-r * s) % Q, spec.delta1), g1[2], g1[3]):
        pi_c = H.g1_add(pi_c, pt)
    assert got == (pi_a, pi_b, pi_c)


def test_mask_limbs():
    limbs = PV.mask_limbs(T.Mask(Q + 5, 2 * Q - 3))
    assert limbs.dtype == np.uint32 and limbs.shape == (3, 16)
    got = [sum(int(v) << (16 * j) for j, v in enumerate(row)) for row in limbs]
    assert got == [5, Q - 3, (-5 * (Q - 3)) % Q]


@pytest.mark.slow
@pytest.mark.parametrize("log2", [5, 8], ids=["naive", "fold"])
@pytest.mark.parametrize("flavour", ["snarkjs", "jens-groth"])
def test_prove_core_device_equals_staged_proof(flavour, log2):
    """`prove_core_device` whole against `generate_proof_with_mask` with
    fused=False, both flavours, at the naive MSMs' size and at the fold's
    (about 30 s a case on one core)."""
    r1cs, wtns = synthetic_circuit(log2)
    zkey = T.fake_circuit_setup(r1cs, T.ToxicWaste(**FIXED_TOXIC), T.Flavour(flavour), CPU)
    staged = T.generate_proof_with_mask(zkey, wtns, MASKS[1], CPU, fused=False)
    hdr = zkey.header
    buf = PV.prove_core_device(hdr.flavour, hdr.log_domain_size, PV.zkey_device_args(zkey, CPU),
                               PV.spec_device_args(zkey, CPU), torch.from_numpy(wtns.values),
                               torch.from_numpy(PV.mask_limbs(MASKS[1])))
    assert PV.proof_points(buf) == points(staged)
