"""Host-side (pure Python int) BN254 arithmetic: the framework's oracle layer.

Plays the role constantine's scalar routines play in the reference: a slow,
obviously-correct implementation of field/curve arithmetic used for

* golden tests of the vectorized TPU kernels,
* one-off scalar work in the protocol layer (single point ops, inverses),
* the fake trusted setup's small-scalar plumbing.

Curve facts (reference `groth16/bn128/curves.nim:1-124`):
  G1:  y^2 = x^3 + 3           over Fp,  generator (1, 2)
  G2:  y^2 = x^3 + 3/(9+u)     over Fp2, generator hardcoded below
Points at infinity use the affine (0, 0) convention of the reference
(`curves.nim:49-50`) at the API boundary; internally we use None.
"""

from __future__ import annotations

from ..ops.field import P_FP, P_FR

P = P_FP
R = P_FR

# --- Fp ---------------------------------------------------------------------

def fp_inv(a: int) -> int:
    return pow(a, P - 2, P)


# --- Fp2 = Fp[u]/(u^2+1), elements as (c0, c1) tuples -------------------------

def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def fp2_sqr(a):
    return fp2_mul(a, a)


def fp2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], P - 2, P)
    return ((a[0] * d) % P, (-a[1] * d) % P)


def fp2_conj(a):
    return (a[0], (-a[1]) % P)


FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)

XI = (9, 1)  # the sextic nonresidue 9 + u defining the Fp12 tower

# Twist curve coefficient b' = 3 / (9 + u); equals the constants hardcoded at
# reference groth16/bn128/curves.nim:75-77 (checked in tests).
TWIST_B = fp2_mul((3, 0), fp2_inv(XI))


class _FieldOps:
    """Tiny strategy object so the same affine EC code serves Fp and Fp2."""

    __slots__ = ("zero", "one", "add", "sub", "neg", "mul", "sqr", "inv", "b")

    def __init__(self, zero, one, add, sub, neg, mul, sqr, inv, b):
        self.zero, self.one = zero, one
        self.add, self.sub, self.neg = add, sub, neg
        self.mul, self.sqr, self.inv = mul, sqr, inv
        self.b = b


G1_FIELD = _FieldOps(
    zero=0, one=1,
    add=lambda a, b: (a + b) % P, sub=lambda a, b: (a - b) % P,
    neg=lambda a: (-a) % P, mul=lambda a, b: (a * b) % P,
    sqr=lambda a: (a * a) % P, inv=fp_inv, b=3,
)

G2_FIELD = _FieldOps(
    zero=FP2_ZERO, one=FP2_ONE,
    add=fp2_add, sub=fp2_sub, neg=fp2_neg,
    mul=fp2_mul, sqr=fp2_sqr, inv=fp2_inv, b=TWIST_B,
)

# Group generators — reference groth16/bn128/curves.nim:112-124.
G1_GEN = (1, 2)
G2_GEN = (
    (0x1ADCD0ED10DF9CB87040F46655E3808F98AA68A570ACF5B0BDE23FAB1F149701,
     0x09E847E9F05A6082C3CD2A1D0A3A82E6FBFBE620F7F31269FA15D21C1C13B23B),
    (0x056C01168A5319461F7CA7AA19D4FCFD1C7CDF52DBFC4CBEE6F915250B7F6FC8,
     0x0EFE500A2D02DD77F5F401329F30895DF553B878FC3C0DADAAA86456A623235C),
)


# --- generic affine short-Weierstrass ops (y^2 = x^3 + b, a = 0) --------------

def ec_is_on_curve(F: _FieldOps, pt) -> bool:
    """Curve membership; (None) infinity is on the curve by definition
    (matches reference `checkCurveEqG1/G2`, curves.nim:54-91)."""
    if pt is None:
        return True
    x, y = pt
    lhs = F.sqr(y)
    rhs = F.add(F.mul(F.sqr(x), x), F.b)
    return lhs == rhs


def ec_neg(F: _FieldOps, pt):
    if pt is None:
        return None
    return (pt[0], F.neg(pt[1]))


def ec_add(F: _FieldOps, p1, p2):
    """Textbook affine chord-tangent addition."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == F.neg(y2):
            return None
        # doubling: lambda = 3 x^2 / 2 y
        num = F.mul(F.sqr(x1), F.add(F.add(F.one, F.one), F.one))
        den = F.inv(F.add(y1, y1))
    else:
        num = F.sub(y2, y1)
        den = F.inv(F.sub(x2, x1))
    lam = F.mul(num, den)
    x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
    y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
    return (x3, y3)


def ec_double(F: _FieldOps, p):
    return ec_add(F, p, p)


def _jac_double(F: _FieldOps, P):
    """Jacobian doubling (a = 0), no inversions."""
    if P is None:
        return None
    X, Y, Z = P
    A = F.sqr(X)
    B = F.sqr(Y)
    Cc = F.sqr(B)
    t = F.sub(F.sqr(F.add(X, B)), F.add(A, Cc))
    D = F.add(t, t)
    E = F.add(F.add(A, A), A)
    Fq = F.sqr(E)
    X3 = F.sub(Fq, F.add(D, D))
    c8 = F.add(F.add(Cc, Cc), F.add(Cc, Cc))
    c8 = F.add(c8, c8)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), c8)
    yz = F.mul(Y, Z)
    Z3 = F.add(yz, yz)
    return (X3, Y3, Z3)


def _jac_madd(F: _FieldOps, P, Q_affine):
    """Mixed jacobian + affine addition, no inversions."""
    if P is None:
        return (Q_affine[0], Q_affine[1], F.one)
    X1, Y1, Z1 = P
    X2, Y2 = Q_affine
    Z1Z1 = F.sqr(Z1)
    U2 = F.mul(X2, Z1Z1)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H = F.sub(U2, X1)
    if H == F.zero:
        if S2 == Y1:
            return _jac_double(F, P)
        return None
    HH = F.sqr(H)
    I = F.add(F.add(HH, HH), F.add(HH, HH))
    J = F.mul(H, I)
    rr = F.sub(S2, Y1)
    rr = F.add(rr, rr)
    V = F.mul(X1, I)
    X3 = F.sub(F.sub(F.sqr(rr), J), F.add(V, V))
    yj = F.mul(Y1, J)
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.add(yj, yj))
    Z3 = F.sub(F.sub(F.sqr(F.add(Z1, H)), Z1Z1), HH)
    return (X3, Y3, Z3)


def _jac_to_affine(F: _FieldOps, P):
    if P is None:
        return None
    X, Y, Z = P
    zi = F.inv(Z)
    zi2 = F.sqr(zi)
    return (F.mul(X, zi2), F.mul(Y, F.mul(zi, zi2)))


def ec_scalar_mul(F: _FieldOps, k: int, pt):
    """Scalar multiplication (host oracle for `**`, curves.nim:182-214).

    Left-to-right double-and-add over jacobian coordinates — one field
    inversion total instead of one per point addition (the affine
    chord-tangent `ec_add` stays available as the independent textbook
    oracle; this path is for bulk host work like the fake setup)."""
    k %= R
    if k == 0 or pt is None:
        return None
    acc = None
    for bit in bin(k)[2:]:
        acc = _jac_double(F, acc)
        if bit == "1":
            acc = _jac_madd(F, acc, pt)
    return _jac_to_affine(F, acc)


def ec_msm(F: _FieldOps, scalars, points):
    """Naive MSM oracle (reference msmNaiveG1/G2, bn128/msm.nim:162-198)."""
    acc = None
    for k, pt in zip(scalars, points):
        acc = ec_add(F, acc, ec_scalar_mul(F, k, pt))
    return acc


# --- G1 / G2 convenience wrappers (affine-(0,0)-as-infinity convention) ------

def g1_add(p, q):
    return ec_add(G1_FIELD, p, q)


def g2_add(p, q):
    return ec_add(G2_FIELD, p, q)


def g1_mul(k, p=G1_GEN):
    return ec_scalar_mul(G1_FIELD, k, p)


def g2_mul(k, p=G2_GEN):
    return ec_scalar_mul(G2_FIELD, k, p)


def from_zero_convention(pt, zero):
    """(0,0) -> None (infinity); reference curves.nim:95-107."""
    return None if pt == zero else pt


def to_zero_convention(pt, zero):
    return zero if pt is None else pt


G1_ZERO_AFF = (0, 0)
G2_ZERO_AFF = (FP2_ZERO, FP2_ZERO)
