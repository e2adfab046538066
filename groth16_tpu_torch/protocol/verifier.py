"""Groth16 verifier (reference `groth16/verifier.nim:31-52`).

Host-side by design: one proof needs a handful of curve checks, one
(npub+1)-term MSM, and three pairings — O(1) work where the TPU has nothing
to accelerate.  Checks

    e(-pi_a, pi_b) * e(alpha, beta) * e(pi_c, delta2) * e(pub, gamma2) == 1

using the alphaBeta value precomputed at zkey-parse/setup time
(reference files/zkey.nim:164, fake_setup.nim:234).
"""

from __future__ import annotations

from ..utils import hostmath as H
from ..utils import pairing as PR
from .types import VKey
from .prover import Proof


def _ic_host_points(vkey: VKey) -> list:
    from ..files.zkey import _g1_host
    pa = vkey.vpoints.points_ic
    return [_g1_host(pa.x[i], pa.y[i]) for i in range(len(pa))]


def verify_proof(vkey: VKey, prf: Proof) -> bool:
    assert prf.curve == "bn128"
    assert H.ec_is_on_curve(H.G1_FIELD, prf.pi_a), "pi_a is not in G1"
    assert H.ec_is_on_curve(H.G2_FIELD, prf.pi_b), "pi_b is not in G2"
    assert H.ec_is_on_curve(H.G1_FIELD, prf.pi_c), "pi_c is not in G1"

    ic = _ic_host_points(vkey)
    assert len(ic) == len(prf.public_io), "public input length mismatch"
    pub_g1 = H.ec_msm(H.G1_FIELD, prf.public_io, ic)

    lhs = PR.pairing(H.ec_neg(H.G1_FIELD, prf.pi_a), prf.pi_b)   # < -pi_a, pi_b >
    rhs1 = vkey.spec.alpha_beta                                  # < alpha, beta >
    rhs2 = PR.pairing(prf.pi_c, vkey.spec.delta2)                # < pi_c, delta >
    rhs3 = PR.pairing(pub_g1, vkey.spec.gamma2)                  # < pub, gamma >

    eq = PR.fp12_mul(PR.fp12_mul(lhs, rhs1), PR.fp12_mul(rhs2, rhs3))
    return PR.fp12_is_one(eq)
