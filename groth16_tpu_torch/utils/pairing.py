"""Host-side BN254 pairing (verification-only path).

The reference delegates its pairing to constantine's optimized ate
implementation (`groth16/bn128/curves.nim:218-221`).  In this framework the
pairing is needed only O(1) times per proof (the 4-pairing verifier equation,
`groth16/verifier.nim:41-52`, and the one-off alphaBeta precompute at zkey
parse / fake setup), so it is deliberately a *host* component: a slow,
obviously-correct reduced Tate pairing over the Fp12 tower —

    Fp12 = Fp2[w] / (w^6 - xi),   xi = 9 + u,

with the G2 untwist  (x', y') -> (x' w^2, y' w^3)  and the full final
exponentiation  f^((p^12-1)/r)  (no hard-part decomposition: the honest
exponent, a few thousand Fp12 squarings, is fast enough in Python ints).

The Miller loop tracks numerator/denominator separately so it needs exactly
one Fp12 inversion per pairing, and special-cases the vertical-line /
point-at-infinity steps that occur at the tail of the loop over the prime
group order r.
"""

from __future__ import annotations

from .hostmath import (
    P, R, XI, FP2_ONE, FP2_ZERO,
    fp2_add, fp2_sub, fp2_neg, fp2_mul, fp2_sqr, fp2_inv,
    G1_FIELD, G2_FIELD, G1_GEN, G2_GEN, ec_is_on_curve,
)

# --- Fp12 = Fp2[w]/(w^6 - xi): elements are 6-tuples of Fp2 -----------------

FP12_ZERO = (FP2_ZERO,) * 6
FP12_ONE = (FP2_ONE,) + (FP2_ZERO,) * 5


def fp12_add(a, b):
    return tuple(fp2_add(x, y) for x, y in zip(a, b))


def fp12_neg(a):
    return tuple(fp2_neg(x) for x in a)


def fp12_mul(a, b):
    acc = [FP2_ZERO] * 11
    for i, ai in enumerate(a):
        if ai == FP2_ZERO:
            continue
        for j, bj in enumerate(b):
            if bj == FP2_ZERO:
                continue
            acc[i + j] = fp2_add(acc[i + j], fp2_mul(ai, bj))
    # reduce w^(6+k) = xi * w^k
    out = list(acc[:6])
    for k in range(6, 11):
        out[k - 6] = fp2_add(out[k - 6], fp2_mul(XI, acc[k]))
    return tuple(out)


def fp12_sqr(a):
    return fp12_mul(a, a)


def fp12_pow(a, e: int):
    result = FP12_ONE
    base = a
    while e:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_sqr(base)
        e >>= 1
    return result


# Fp6 = Fp2[v]/(v^3 - xi), used only to invert Fp12 elements: an Fp12 element
# over basis {w^0..w^5} splits as A(v) + B(v) w with v = w^2.

def _fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = fp2_mul(a0, b0), fp2_mul(a1, b1), fp2_mul(a2, b2)
    c0 = fp2_add(t0, fp2_mul(XI, fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), fp2_add(t1, t2))))
    c1 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), fp2_add(t0, t1)), fp2_mul(XI, t2))
    c2 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), fp2_add(t0, t2)), t1)
    return (c0, c1, c2)


def _fp6_inv(a):
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sqr(a0), fp2_mul(XI, fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul(XI, fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    norm = fp2_add(fp2_mul(a0, c0), fp2_mul(XI, fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2))))
    ninv = fp2_inv(norm)
    return (fp2_mul(c0, ninv), fp2_mul(c1, ninv), fp2_mul(c2, ninv))


def fp12_inv(a):
    """Tower inversion: a = A + B w with A,B in Fp6 (v = w^2);
    a^-1 = (A - B w) / (A^2 - B^2 v)."""
    A = (a[0], a[2], a[4])
    B = (a[1], a[3], a[5])
    b2v = _fp6_mul(_fp6_mul(B, B), (FP2_ZERO, FP2_ONE, FP2_ZERO))
    norm = tuple(fp2_sub(x, y) for x, y in zip(_fp6_mul(A, A), b2v))
    ninv = _fp6_inv(norm)
    An = _fp6_mul(A, ninv)
    Bn = _fp6_mul(tuple(fp2_neg(x) for x in B), ninv)
    return (An[0], Bn[0], An[1], Bn[1], An[2], Bn[2])


def fp12_is_one(a) -> bool:
    return a == FP12_ONE


def fp12_embed_fp2(c) -> tuple:
    return (c,) + (FP2_ZERO,) * 5


def fp12_embed_fp(c: int) -> tuple:
    return fp12_embed_fp2((c % P, 0))


# --- untwist: E'(Fp2) -> E(Fp12) --------------------------------------------

def untwist(q):
    """G2 affine (x', y') on the twist -> affine point on E(Fp12):
    (x' w^2, y' w^3)."""
    if q is None:
        return None
    x, y = q
    gx = (FP2_ZERO, FP2_ZERO, x, FP2_ZERO, FP2_ZERO, FP2_ZERO)
    gy = (FP2_ZERO, FP2_ZERO, FP2_ZERO, y, FP2_ZERO, FP2_ZERO)
    return (gx, gy)


# --- Miller loop (Tate): f_{r,P} evaluated at untwisted Q --------------------

def _line_eval(t, s, qx12, qy12):
    """Evaluate the line through points t, s of E(Fp) at Q' in E(Fp12), and
    return (line_value, t+s).  Handles tangent (t==s), vertical (t = -s) and
    infinity cases.  All of t, s are affine Fp points or None."""
    if t is None:
        return FP12_ONE, s
    if s is None:
        return FP12_ONE, t
    x1, y1 = t
    x2, y2 = s
    if x1 == x2 and (y1 + y2) % P == 0:
        # vertical line x - x1 ; result is infinity
        val = fp12_add(qx12, fp12_embed_fp(-x1))
        return val, None
    if t == s:
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    # l(Q) = (yQ - y1) - lam (xQ - x1)
    val = fp12_add(
        fp12_add(qy12, fp12_embed_fp(-y1)),
        fp12_neg(fp12_mul(fp12_embed_fp(lam), fp12_add(qx12, fp12_embed_fp(-x1)))),
    )
    return val, (x3, y3)


def _vertical_eval(t, qx12):
    """Vertical line at t evaluated at Q'; 1 if t is infinity."""
    if t is None:
        return FP12_ONE
    return fp12_add(qx12, fp12_embed_fp(-t[0]))


def miller_loop(p, q) -> tuple:
    """f_{r,P}(Q') for P in G1 affine, Q' = untwist(Q) — returns the full
    Miller value (numerator * denominator^-1), before final exponentiation."""
    qx12, qy12 = untwist(q)
    f_num = FP12_ONE
    f_den = FP12_ONE
    t = p
    bits = bin(R)[3:]  # MSB-first, skipping the leading 1
    for bit in bits:
        f_num = fp12_sqr(f_num)
        f_den = fp12_sqr(f_den)
        line, t = _line_eval(t, t, qx12, qy12)
        f_num = fp12_mul(f_num, line)
        f_den = fp12_mul(f_den, _vertical_eval(t, qx12))
        if bit == "1":
            line, t = _line_eval(t, p, qx12, qy12)
            f_num = fp12_mul(f_num, line)
            f_den = fp12_mul(f_den, _vertical_eval(t, qx12))
    assert t is None, "Miller loop must end at infinity (P has order r)"
    return fp12_mul(f_num, fp12_inv(f_den))


FINAL_EXP = (P ** 12 - 1) // R


def pairing(p, q) -> tuple:
    """Reduced Tate pairing e(P, Q) -> Fp12 for P in G1, Q in G2 (affine host
    points; None = infinity).  Bilinear and non-degenerate; plays the role of
    constantine's `pairing_bn` in the reference (`curves.nim:218-221`).

    Pure Python: the prover never calls it, only setup, zkey parsing and
    verification do, a few times each."""
    if p is None or q is None:
        return FP12_ONE
    assert ec_is_on_curve(G1_FIELD, p) and ec_is_on_curve(G2_FIELD, q)
    return fp12_pow(miller_loop(p, q), FINAL_EXP)
