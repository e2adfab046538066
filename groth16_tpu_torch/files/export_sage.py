"""Export proof + vkey as a standalone SageMath verification script —
an independent-reimplementation debugging oracle (reference
`groth16/files/export_sage.nim:141-149`).

The emitted script embeds the BN254 curve, tower and ate pairing in Sage and
re-checks the 4-pairing verifier equation (export_sage.nim:67-137)."""

from __future__ import annotations

from ..protocol.prover import Proof
from ..protocol.types import VKey
from ..protocol.verifier import _ic_host_points
from ..utils.hostmath import TWIST_B

SAGE_BN128 = f"""\
# BN128 elliptic curve
p  = 21888242871839275222246405745257275088696311157297823662689037894645226208583
r  = 21888242871839275222246405745257275088548364400416034343698204186575808495617
h  = 1
Fp = GF(p)
Fr = GF(r)
A  = Fp(0)
B  = Fp(3)
E  = EllipticCurve(Fp,[A,B])
gen = E(Fp(1),Fp(2))  # subgroup generator
print("scalar field check: ", gen.additive_order() == r )

# r and trace of Frobenius from the BN parameter x
x = 4965661367192848881
bn_t=6*x^2+1

# extension tower
R.<x>   = Fp[]
Fp2.<u> = Fp.extension(x^2+1)
def mkFp2(a,b):
  return ( a + u*b )
R.<x>    = Fp2[]
Fp12.<w> = Fp2.extension(x^6 - (9+u))
E12 = E.base_extend(Fp12)

# twisted curve
B_twist = mkFp2({TWIST_B[0]}, {TWIST_B[1]})
E2 = EllipticCurve(Fp2,[0,B_twist])

# map from E2 to E12
def Psi(pt):
  pt.normalize_coordinates()
  return E12( Fp12(w^2 * pt[0]) , Fp12(w^3 * pt[1]) )

def pairing(P,Q):
  return E12(P).ate_pairing( Psi(Q), n=r, k=12, t=bn_t, q=p^12 )
"""

VERIFY_SCRIPT = """\
pubG1 = pointsIC[0]
for i in [1..len(pubIO)-1]:
  pubG1 = pubG1 + pubIO[i]*pointsIC[i]

lhs  = pairing( -piA   , piB    )
rhs1 = pairing( alpha1 , beta2  )
rhs2 = pairing( piC    , delta2 )
rhs3 = pairing( pubG1  , gamma2 )
eq = lhs * rhs1 * rhs2 * rhs3
print("verification succeeded =\\n", eq == 1)
"""


def _sage_g1(pt) -> str:
    assert pt is not None, "cannot export the point at infinity"
    return f"E(Fp({pt[0]}), Fp({pt[1]}))"


def _sage_g2(pt) -> str:
    assert pt is not None, "cannot export the point at infinity"
    (x0, x1), (y0, y1) = pt
    return f"E2(mkFp2({x0},{x1}), mkFp2({y0},{y1}))"


def sage_script(vkey: VKey, prf: Proof) -> str:
    ic = _ic_host_points(vkey)
    lines = [SAGE_BN128]
    lines.append(f"alpha1 = {_sage_g1(vkey.spec.alpha1)}")
    lines.append(f"beta2  = {_sage_g2(vkey.spec.beta2)}")
    lines.append(f"gamma2 = {_sage_g2(vkey.spec.gamma2)}")
    lines.append(f"delta2 = {_sage_g2(vkey.spec.delta2)}")
    lines.append("pointsIC = [")
    lines.append(",\n".join("  " + _sage_g1(p) for p in ic))
    lines.append("]")
    lines.append(f"piA = {_sage_g1(prf.pi_a)}")
    lines.append(f"piB = {_sage_g2(prf.pi_b)}")
    lines.append(f"piC = {_sage_g1(prf.pi_c)}")
    lines.append("pubIO = [" + ", ".join(str(v) for v in prf.public_io) + "]")
    lines.append(VERIFY_SCRIPT)
    return "\n".join(lines)


def export_sage(path: str, vkey: VKey, prf: Proof) -> None:
    with open(path, "w") as f:
        f.write(sage_script(vkey, prf))
