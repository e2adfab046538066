"""The plain reference that decides `correct`: the Groth16 proof (snarkjs
flavour) that a witness and a mask must give, worked out from the
circuit, the witness, the toxic waste and the mask alone.

The benchmark draws the toxic waste (alpha, beta, gamma, delta, tau) from
the seed and hands it to the program's fake setup, so every point of the
zkey is [e] G for an exponent e that this module can compute.  A proof's
three points are then [a] G1, [b] G2 and [c] G1 with

    a = alpha + A(tau) + r delta
    b = beta  + B(tau) + s delta
    c = (K + A(tau) B(tau) - Cz(tau)) / delta + s a + r b - r s delta

where A(tau) = sum_j L_j(tau) Az_j over the rows of the domain (the
constraints and snarkjs's dummy A rows, one for wire 0 and each public
wire), B(tau) likewise, Cz(tau) = sum_j L_j(tau) Az_j Bz_j (the prover's
C vector, which vanishes with A B on the domain, so the quotient's
[h(tau) Z(tau) / delta] is this difference over delta), and K = sum over
the private wires of w_i (beta u_i(tau) + alpha v_i(tau) + w_i(tau)), the
C1 points' exponents, from the circuit's C matrix.  So the SpMV, the
quotient, the five MSMs and the spec-point algebra of a proof are all
held to three fixed-base products on the host.  L_j(tau) = Z(tau)/N
w^j / (tau - w^j), w the domain's root 5^((r-1)/2^28)^(2^(28-log2 N)).

Plain Python ints and numpy object arrays; imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bn254 import G1_GEN, G2_GEN, R, FixedBase, Fp, Fp2

GEN28 = pow(5, (R - 1) >> 28, R)


@dataclass
class Toxic:
    alpha: int
    beta: int
    gamma: int
    delta: int
    tau: int


def batch_inverse(x: np.ndarray) -> np.ndarray:
    """Inverses mod r of an object array with no zero, up a product tree
    and down again (three products an element, one pow)."""
    levels = [x]
    while len(levels[-1]) > 1:
        v = levels[-1]
        if len(v) % 2:
            v = levels[-1] = np.append(v, np.array([1], object))
        levels.append(v[0::2] * v[1::2] % R)
    inv = np.array([pow(int(levels[-1][0]), -1, R)], object)
    for v in reversed(levels[:-1]):
        inv = inv[:len(v) // 2]                     # the parent level may be padded
        out = np.empty(len(v), object)
        out[0::2] = inv * v[1::2] % R
        out[1::2] = inv * v[0::2] % R
        inv = out
    return inv[:len(x)]


def lagrange_at(tau: int, log2n: int, m: int) -> np.ndarray:
    """[L_j(tau)] for the first m points of the domain of size 2^log2n."""
    n = 1 << log2n
    w = pow(GEN28, 1 << (28 - log2n), R)
    pw = np.array([1], object)
    while len(pw) < m:
        pw = np.concatenate([pw, pw * pow(w, len(pw), R) % R])
    pw = pw[:m]
    den = (tau - pw) % R
    if not den.all():
        raise ValueError("tau lies on the domain")
    z_over_n = (pow(tau, n, R) - 1) * pow(n, -1, R) % R
    return pw * batch_inverse(den) % R * z_over_n % R


@dataclass
class WitnessTerms:
    """What one witness contributes to every proof of it."""

    a: int                 # A(tau)
    b: int                 # B(tau)
    k_c: int               # K + A(tau) B(tau) - Cz(tau), before 1/delta
    public_io: list        # [1, public wires...]
    unsatisfied: int       # rows where Az Bz != Cw


class Reference:
    """The reference for one circuit and toxic waste: the Lagrange values at
    tau of the domain's used rows and the generators' window tables are
    made once; then `terms(witness)` once a witness and `proof(terms, r,
    s)` once a proof."""

    def __init__(self, circuit, toxic: Toxic):
        self.circuit, self.toxic = circuit, toxic
        self.rows = circuit.n_constr + circuit.n_pub + 1
        self.lag = lagrange_at(toxic.tau % R, circuit.log2_domain, self.rows)
        self.g1, self.g2 = FixedBase(Fp, G1_GEN), FixedBase(Fp2, G2_GEN)
        self.delta_inv = pow(toxic.delta, -1, R)

    def _row_sums(self, m, w: np.ndarray) -> np.ndarray:
        """<M_j, w> of every row j of the domain's used rows (object)."""
        out = np.zeros(self.rows, object)
        if len(m):
            prods = m.val.astype(object) * w[m.col]
            starts = np.flatnonzero(np.r_[True, m.row[1:] != m.row[:-1]])
            out[m.row[starts]] = np.add.reduceat(prods, starts) % R
        return out

    def terms(self, witness) -> WitnessTerms:
        c = self.circuit
        w = np.array([int(v) % R for v in witness], object)
        if len(w) != c.n_wires:
            raise ValueError("witness length differs from the circuit's wires")
        npub = c.n_pub
        az, bz, cw = (self._row_sums(m, w) for m in (c.a, c.b, c.c))
        dummy = np.arange(npub + 1)
        az[c.n_constr + dummy] = w[dummy]            # snarkjs's dummy A rows
        unsat = int(((az * bz - cw) % R != 0).sum())
        lag = self.lag
        a_tau = int((lag * az).sum() % R)
        b_tau = int((lag * bz).sum() % R)
        cz_tau = int((lag * (az * bz % R)).sum() % R)

        def private_tau(m) -> int:                  # sum_j L_j <M_j, w> over private columns
            keep = m.col > npub
            return int((lag[m.row[keep]] * m.val[keep].astype(object) * w[m.col[keep]]).sum() % R)

        t = self.toxic
        k = (t.beta * private_tau(c.a) + t.alpha * private_tau(c.b) + private_tau(c.c)) % R
        return WitnessTerms(a=a_tau, b=b_tau, k_c=(k + a_tau * b_tau - cz_tau) % R,
                            public_io=[int(v) for v in w[:npub + 1]], unsatisfied=unsat)

    def exponents(self, terms: WitnessTerms, r: int, s: int) -> tuple:
        t = self.toxic
        a = (t.alpha + terms.a + r * t.delta) % R
        b = (t.beta + terms.b + s * t.delta) % R
        c = (terms.k_c * self.delta_inv + s * a + r * b - r * s * t.delta) % R
        return a, b, c

    def proof(self, terms: WitnessTerms, r: int, s: int) -> tuple:
        """(pi_a, pi_b, pi_c) as affine int tuples (None = infinity)."""
        a, b, c = self.exponents(terms, r, s)
        return self.g1(a), self.g2(b), self.g1(c)
