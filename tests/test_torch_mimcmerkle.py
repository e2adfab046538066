"""The benchmark's MiMCSponge Merkle batch (proofbench/circuits/mimcmerkle.py)
at a tiny size on the CPU: 2 paths of depth 2, 12 MiMC rounds a Feistel,
domain 2^9.  Its witness satisfies every row and a changed value fails one;
each root is the plain MiMCSponge Merkle root of its path; the port's CPU
proof and its core `prove_core_device` called eagerly (every MSM on the
fold; the two share each MSM's result, `fused_cases.shared_msms`) equal the
benchmark's reference proof for the same toxic waste and mask; the fake
setup is byte-identical to the JAX package's.  On a smaller instance (one
path of depth 1, 3 rounds, domain 2^5), where every MSM of both packages
takes the naive ladder, which keeps the JAX prover's compile to minutes:
the JAX package's fixed-mask proof equals the reference's and the port's,
and the fake setup is byte-identical whatever its slice size.  A fold
counts its padding."""

import random

import pytest
import torch

from fused_cases import shared_msms
from test_snarkjs_golden import FIXED_TOXIC

import groth16_tpu_torch as T
from groth16_tpu_torch.ops import curve as C
from groth16_tpu_torch.ops import msm as M
from groth16_tpu_torch.ops.limbs import ints_to_limbs
from groth16_tpu_torch.protocol import fake_setup as FS
from groth16_tpu_torch.protocol import prover as PV
from proofbench.circuits import mimcmerkle as MM
from proofbench.circuits.circuit import R
from proofbench.harness import port
from proofbench.reference.groth16 import Reference, Toxic

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

CPU = torch.device("cpu")
CFG = {"paths": 2, "depth": 2, "rounds": 12}
MICRO = {"paths": 1, "depth": 1, "rounds": 3}
MASK = (0x3C1D_92E4_5B6A_7F80_0123_4567_89AB_CDEF, 0x7E57_AB1E_F00D_5EED_1357_9BDF_0246_8ACE)


def _instance(cfg):
    c = MM.build(cfg)
    w = MM.witness(c, cfg, random.Random(2026))
    zkey = T.fake_circuit_setup(port.r1cs(c), T.ToxicWaste(**FIXED_TOXIC), T.Flavour.Snarkjs,
                                CPU)
    return c, w, zkey


@pytest.fixture(scope="module")
def tiny():
    return _instance(CFG)


@pytest.fixture(scope="module")
def micro():
    return _instance(MICRO)


def _unsatisfied(c, w) -> int:
    """Rows where <A_i, w> <B_i, w> != <C_i, w>, on host ints."""
    sums = [[0] * c.n_constr for _ in range(3)]
    for k, m in enumerate((c.a, c.b, c.c)):
        for r, col, v in zip(m.row.tolist(), m.col.tolist(), m.val.tolist()):
            sums[k][r] += v * w[col]
    return sum((a * b - cc) % R != 0 for a, b, cc in zip(*sums))


def _plain_root(leaf, siblings, bits, c):
    """tornado-core's MerkleTreeChecker on ints: DualMux, then
    MiMCSponge(2, rounds, 1) with k = 0 (circomlib's MiMCFeistel: t = xL +
    c_i, xL' = xR + t^5, xR' = xL, the last round keeping xL)."""
    def feistel(xl, xr):
        for i, ci in enumerate(c):
            t5 = pow((xl + ci) % R, 5, R)
            if i < len(c) - 1:
                xl, xr = (xr + t5) % R, xl
            else:
                xr = (xr + t5) % R
        return xl, xr

    cur = leaf
    for e, s in zip(siblings, bits):
        left, right = (e, cur) if s else (cur, e)
        xl, xr = feistel(left, 0)
        cur, _ = feistel((xl + right) % R, xr)
    return cur


def test_tiny_sizes(tiny):
    c, w, _ = tiny
    assert (c.n_constr, c.n_pub, c.log2_domain) == (2 * 2 * (3 + 6 * 12 + 1), 2, 9)
    assert len(w) == c.n_wires and w[0] == 1
    assert all(len(m.row) == len(m.col) == len(m.val) for m in (c.a, c.b, c.c))


def test_witness_satisfies_every_row(tiny):
    c, w, _ = tiny
    assert _unsatisfied(c, w) == 0


@pytest.mark.parametrize("wire", ["root", "bit", "intermediate"])
def test_a_changed_value_fails_a_row(tiny, wire):
    c, w, _ = tiny
    P, L = CFG["paths"], CFG["depth"]
    at = {"root": 1, "bit": 1 + 2 * P + P * L, "intermediate": len(w) - 1}[wire]
    bad = list(w)
    bad[at] = (bad[at] + 2) % R
    assert _unsatisfied(c, bad) > 0


def test_roots_are_plain_merkle_roots(tiny):
    _, w, _ = tiny
    P, L = CFG["paths"], CFG["depth"]
    consts = MM.constants(CFG["rounds"])
    assert consts[0] == consts[-1] == 0 and all(0 < x < R for x in consts[1:-1])
    assert consts[1:-1] == MM.constants(220)[1:CFG["rounds"] - 1]    # one stream at every size
    leaves, sib = w[1 + P:1 + 2 * P], w[1 + 2 * P:1 + 2 * P + P * L]
    bits = w[1 + 2 * P + P * L:1 + 2 * P + 2 * P * L]
    assert set(bits) <= {0, 1}
    roots = [_plain_root(leaves[p], sib[p * L:(p + 1) * L], bits[p * L:(p + 1) * L], consts)
             for p in range(P)]
    assert w[1:1 + P] == roots


def _reference_proof(c, w):
    ref = Reference(c, Toxic(**FIXED_TOXIC))
    terms = ref.terms(w)
    return terms.public_io, ref.proof(terms, *MASK)


@pytest.fixture(scope="module")
def reference_proof(tiny):
    return _reference_proof(*tiny[:2])


@pytest.fixture(scope="module")
def msms_once():
    """The CPU proof and the eager core of one witness compute each MSM
    once."""
    with shared_msms():
        yield


def test_staged_proof_equals_reference(tiny, reference_proof, msms_once):
    _, w, zkey = tiny
    prf = T.generate_proof_with_mask(zkey, port.witness(w), T.Mask(*MASK), CPU)
    assert (prf.public_io, (prf.pi_a, prf.pi_b, prf.pi_c)) == reference_proof


def test_eager_core_equals_reference(tiny, reference_proof, msms_once):
    _, w, zkey = tiny
    hdr = zkey.header
    buf = PV.prove_core_device(hdr.flavour, hdr.log_domain_size, PV.zkey_device_args(zkey, CPU),
                               PV.spec_device_args(zkey, CPU),
                               torch.from_numpy(port.witness(w).values),
                               torch.from_numpy(PV.mask_limbs(T.Mask(*MASK))))
    assert PV.proof_points(buf) == reference_proof[1]


def _jax(c, w):
    """The JAX package's R1CS, witness and fake setup of an instance."""
    from groth16_tpu.protocol import types as JT
    from groth16_tpu.protocol.fake_setup import ToxicWaste, fake_circuit_setup
    r1cs, wt = port.r1cs(c), port.witness(w)
    jr1cs = JT.R1CS(r=r1cs.r, cfg=JT.WitnessConfig(**vars(r1cs.cfg)), n_constr=r1cs.n_constr,
                    constraints=r1cs.constraints, wire_to_label=[])
    jwtns = JT.Witness(curve=wt.curve, r=wt.r, nvars=wt.nvars, values=wt.values)
    return jwtns, fake_circuit_setup(jr1cs, ToxicWaste(**FIXED_TOXIC), JT.Flavour.Snarkjs)


def test_fake_setup_byte_identical_to_jax(tiny):
    from groth16_tpu.files.zkey import zkey_bytes
    c, w, zkey = tiny
    assert T.files.zkey.zkey_bytes(zkey) == zkey_bytes(_jax(c, w)[1])


def test_proof_equals_jax(micro):
    from groth16_tpu.protocol.prover import Mask, generate_proof_with_mask
    c, w, zkey = micro
    jwtns, jzkey = _jax(c, w)
    assert jzkey.header.domain_size == 32 and jzkey.header.nvars < 128     # naive MSMs only
    want = generate_proof_with_mask(jzkey, jwtns, Mask(*MASK))
    got = T.generate_proof_with_mask(zkey, port.witness(w), T.Mask(*MASK), CPU)
    ref = _reference_proof(c, w)
    assert (want.public_io, (want.pi_a, want.pi_b, want.pi_c)) == ref
    assert (got.public_io, (got.pi_a, got.pi_b, got.pi_c)) == ref


@pytest.mark.parametrize("size", [1, 3, 7, 1 << 20])
def test_sliced_setup_is_byte_identical(micro, monkeypatch, size):
    """Slices of 1, 3, 7 and more rows than any step has (one slice a
    step) give the zkey of the default slice, with one span a slice."""
    c, _, zkey = micro
    monkeypatch.setattr(FS, "SLICE", size)
    last = max((r.index for r in T.tracer.records()), default=-1)
    got = T.fake_circuit_setup(port.r1cs(c), T.ToxicWaste(**FIXED_TOXIC), T.Flavour.Snarkjs, CPU)
    assert T.files.zkey.zkey_bytes(got) == T.files.zkey.zkey_bytes(zkey)
    slices = sum(r.index > last and r.name == "fake_setup.points.slice"
                 for r in T.tracer.records())
    n, npub = zkey.header.nvars, zkey.header.npubs
    sets = (npub + 1, n, n, n, n - npub - 1, zkey.header.domain_size)
    assert slices == sum(-(-k // size) for k in sets)


def test_fold_counts_its_padding():
    """A 300-point fold pads to 512 points: 212 of them padding."""
    rng = random.Random(300)
    scalars = torch.from_numpy(ints_to_limbs([rng.randrange(R) for _ in range(300)]))
    points = C.points_from_host(C.G1, [(1, 2)] * 300, CPU)          # the generator
    before = T.tracer.counters()
    M.window_sums(C.G1, scalars, points, M.pick_window_bits(300), affine=True)
    after = T.tracer.counters()
    got = {k: after.get(k, 0) - before.get(k, 0)
           for k in ("msm.fold", "msm.fold_points", "msm.pad_points")}
    assert got == {"msm.fold": 1, "msm.fold_points": 512, "msm.pad_points": 212}
