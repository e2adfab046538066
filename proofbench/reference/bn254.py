"""BN254 on plain Python ints: the fields, the two groups and fixed-base
multiplication of their generators.  A frozen copy of the formulas of the
port's utils/hostmath.py (Jacobian doubling and mixed addition, a = 0),
which this package may not import.

G1:  y^2 = x^3 + 3          over Fp,  generator (1, 2)
G2:  y^2 = x^3 + 3/(9 + u)  over Fp2 = Fp[u]/(u^2 + 1)
Affine points are (x, y) tuples, an Fp2 element a (c0, c1) tuple, and None
is the point at infinity.
"""

from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


class Fp:
    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def inv(a):
        return pow(a, P - 2, P)


class Fp2:
    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

    @staticmethod
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)

    @staticmethod
    def inv(a):
        d = pow(a[0] * a[0] + a[1] * a[1], P - 2, P)
        return (a[0] * d % P, -a[1] * d % P)


G1_GEN = (1, 2)
G2_GEN = (
    (0x1ADCD0ED10DF9CB87040F46655E3808F98AA68A570ACF5B0BDE23FAB1F149701,
     0x09E847E9F05A6082C3CD2A1D0A3A82E6FBFBE620F7F31269FA15D21C1C13B23B),
    (0x056C01168A5319461F7CA7AA19D4FCFD1C7CDF52DBFC4CBEE6F915250B7F6FC8,
     0x0EFE500A2D02DD77F5F401329F30895DF553B878FC3C0DADAAA86456A623235C),
)


def jac_double(F, p):
    if p is None:
        return None
    X, Y, Z = p
    A, B = F.mul(X, X), F.mul(Y, Y)
    C = F.mul(B, B)
    t = F.sub(F.mul(F.add(X, B), F.add(X, B)), F.add(A, C))
    D = F.add(t, t)
    E = F.add(F.add(A, A), A)
    X3 = F.sub(F.mul(E, E), F.add(D, D))
    c8 = F.add(F.add(C, C), F.add(C, C))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.add(c8, c8))
    yz = F.mul(Y, Z)
    return (X3, Y3, F.add(yz, yz))


def jac_madd(F, p, q):
    """Jacobian p plus affine q (q not None)."""
    if p is None:
        return (q[0], q[1], F.one)
    X1, Y1, Z1 = p
    Z1Z1 = F.mul(Z1, Z1)
    U2 = F.mul(q[0], Z1Z1)
    S2 = F.mul(F.mul(q[1], Z1), Z1Z1)
    H = F.sub(U2, X1)
    if H == F.zero:
        return jac_double(F, p) if S2 == Y1 else None
    HH = F.mul(H, H)
    I = F.add(F.add(HH, HH), F.add(HH, HH))
    J = F.mul(H, I)
    rr = F.sub(S2, Y1)
    rr = F.add(rr, rr)
    V = F.mul(X1, I)
    X3 = F.sub(F.sub(F.mul(rr, rr), J), F.add(V, V))
    yj = F.mul(Y1, J)
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.add(yj, yj))
    Z3 = F.sub(F.sub(F.mul(F.add(Z1, H), F.add(Z1, H)), Z1Z1), HH)
    return (X3, Y3, Z3)


def to_affine(F, p):
    if p is None:
        return None
    zi = F.inv(p[2])
    zi2 = F.mul(zi, zi)
    return (F.mul(p[0], zi2), F.mul(p[1], F.mul(zi, zi2)))


def batch_to_affine(F, pts) -> list:
    """Affine of Jacobian points (none at infinity), one inversion for all."""
    pre, acc = [], F.one
    for p in pts:
        pre.append(acc)
        acc = F.mul(acc, p[2])
    inv = F.inv(acc)
    out = [None] * len(pts)
    for i in range(len(pts) - 1, -1, -1):
        zi = F.mul(inv, pre[i])
        inv = F.mul(inv, pts[i][2])
        zi2 = F.mul(zi, zi)
        out[i] = (F.mul(pts[i][0], zi2), F.mul(pts[i][1], F.mul(zi, zi2)))
    return out


def mul(F, k: int, q):
    """[k] q by double-and-add (any affine q)."""
    k %= R
    acc = None
    for bit in bin(k)[2:] if k else "":
        acc = jac_double(F, acc)
        if bit == "1":
            acc = jac_madd(F, acc, q)
    return to_affine(F, acc)


class FixedBase:
    """[k] G for a fixed generator G: byte w of k picks [d 2^(8w)] G from a
    table of 32 windows x 255 affine multiples, 32 mixed additions a
    product."""

    def __init__(self, F, gen):
        self.F = F
        jac, base = [], gen
        for _ in range(32):
            acc = None
            for _ in range(255):
                acc = jac_madd(F, acc, base)
                jac.append(acc)
            base = to_affine(F, jac_madd(F, acc, base))           # 256 base
        flat = batch_to_affine(F, jac)
        self.table = [flat[w * 255:(w + 1) * 255] for w in range(32)]

    def __call__(self, k: int):
        k %= R
        acc = None
        for w in range(32):
            d = (k >> (8 * w)) & 255
            if d:
                acc = jac_madd(self.F, acc, self.table[w][d - 1])
        return to_affine(self.F, acc)
