"""The plain reference: its pieces against direct formulas, and its proofs
against the port's at tiny sizes of both circuits (CPU; the port's staged
path there gives the same proof as its fused one on the card)."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

from proofbench.circuits import num2bits, sqchain
from proofbench.reference import bn254 as B
from proofbench.reference.groth16 import GEN28, R, Reference, Toxic, batch_inverse, lagrange_at

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_batch_inverse_at_ragged_lengths():
    rng = random.Random(1)
    for n in (1, 2, 3, 7, 64, 1000, 1025):
        x = np.array([rng.randrange(1, R) for _ in range(n)], object)
        assert all(int(a) * int(b) % R == 1 for a, b in zip(x, batch_inverse(x)))


def test_lagrange_values_interpolate():
    """sum_j L_j(tau) f(w^j) = f(tau) for a polynomial f of degree < N."""
    rng = random.Random(2)
    log2n, tau = 4, rng.randrange(R)
    n = 1 << log2n
    w = pow(GEN28, 1 << (28 - log2n), R)
    coeffs = [rng.randrange(R) for _ in range(n)]

    def f(x):
        return sum(c * pow(x, i, R) for i, c in enumerate(coeffs)) % R

    lag = lagrange_at(tau, log2n, n)
    assert sum(int(lj) * f(pow(w, j, R)) for j, lj in enumerate(lag)) % R == f(tau)
    assert list(lagrange_at(tau, log2n, 5)) == list(lag[:5])


def test_root_is_the_ports():
    from groth16_tpu_torch.ops.ntt import Domain
    for log2n in (3, 16, 20):
        assert pow(GEN28, 1 << (28 - log2n), R) == Domain(log2n).gen


@pytest.mark.parametrize("F, gen", [(B.Fp, B.G1_GEN), (B.Fp2, B.G2_GEN)])
def test_fixed_base_against_double_and_add(F, gen):
    table = B.FixedBase(F, gen)
    rng = random.Random(3)
    for k in [0, 1, 2, 255, 256, R - 1] + [rng.randrange(R) for _ in range(6)]:
        assert table(k) == B.mul(F, k, gen)
    assert table(R) is None


def _port_proof(gen, cfg, seed):
    """A tiny circuit's proof by the port on the CPU, with the reference's
    inputs: (reference, witness terms, (r, s), the port's points)."""
    from proofbench.harness import draw, port
    c = gen.build(cfg)
    toxic = draw.toxic(seed)
    w = gen.witness(c, cfg, random.Random(seed))
    zkey = port.setup(c, toxic, "snarkjs", "cpu")
    r, s = random.Random(seed + 1).randrange(R), random.Random(seed + 2).randrange(R)
    pts = port.prove(zkey, port.witness(w), r, s, "cpu")
    ref = Reference(c, toxic)
    return ref, ref.terms(w), (r, s), pts


@pytest.mark.parametrize("gen, cfg", [(num2bits, {"bits": 4, "copies": 1}),
                                      (sqchain, {"log2": 3})])
def test_reference_equals_the_ports_proof(gen, cfg):
    ref, terms, (r, s), pts = _port_proof(gen, cfg, 2**33 + 17)
    assert terms.unsatisfied == 0
    assert ref.proof(terms, r, s) == tuple(pts[:3])
    assert terms.public_io == pts[3]
    assert ref.proof(terms, r, s + 1)[1] != pts[1]      # another mask, another pi_b


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import proofbench.reference.groth16, proofbench.reference.bn254; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'groth16_tpu_torch', 'groth16_tpu', 'jax', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=120).stdout.strip()
    assert out == "[]"
