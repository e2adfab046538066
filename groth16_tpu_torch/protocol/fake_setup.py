"""Fake circuit-specific trusted setup (reference `groth16/fake_setup.nim`).

Counterpart of the vectorized pipeline of groth16_tpu/protocol/fake_setup.py
(fake_setup.py:164-256, 322-361): from toxic waste and an R1CS, a complete
in-memory ZKey, on any device.

  * Lagrange taus L_k(tau) of the whole domain from ONE inverse NTT of
    [tau^i] (kernel K3 on CUDA);
  * the per-wire A/B/C column taus from one gather, one Montgomery multiply
    and one int64 segment sum;
  * every point family as a windowed fixed-base ladder: 32 table gathers and
    32 complete adds (kernel K1 on CUDA) per point.

Byte-identical to the JAX package's setup for the same toxic waste.
"""

from __future__ import annotations

import functools
import secrets
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops import ntt as NT
from ..ops.kernels import segment_sum_mod
from ..ops.field import FP, FR
from ..ops.limbs import ints_to_limbs_bulk
from ..utils import hostmath as H
from ..utils import pairing as PR
from .types import (
    Coeffs, Flavour, GrothHeader, PointArray, ProverPoints, R1CS, SpecPoints,
    VerifierPoints, ZKey,
)

R = FR.modulus


@dataclass
class ToxicWaste:
    """Reference fake_setup.nim:23-29."""

    alpha: int
    beta: int
    gamma: int
    delta: int
    tau: int


def random_toxic_waste() -> ToxicWaste:
    return ToxicWaste(*(secrets.randbelow(R - 1) + 1 for _ in range(5)))


def _flatten_terms(r1cs: R1CS):
    """ONE Python pass over the constraints -> numpy term arrays:

      ((mats, rows, cols, vals_std), (c_rows, c_cols, c_vals_std))

    the A/B coefficient stream in the reference's order (per constraint A
    then B terms, then the snarkjs dummy A-rows for the public IO,
    fake_setup.nim:46-65) and the C matrix.  `*_std` are uint32[n, 16]
    standard-form limbs."""
    n = r1cs.n_constr
    p = r1cs.cfg.n_pub_in + r1cs.cfg.n_pub_out
    mats, rows, cols, vals = [], [], [], []
    crows, ccols, cvals = [], [], []
    for i, (a, b, c) in enumerate(r1cs.constraints):
        for idx, v in a:
            mats.append(0); rows.append(i); cols.append(idx); vals.append(v % R)
        for idx, v in b:
            mats.append(1); rows.append(i); cols.append(idx); vals.append(v % R)
        for idx, v in c:
            crows.append(i); ccols.append(idx); cvals.append(v % R)
    for i in range(n, n + p + 1):
        mats.append(0); rows.append(i); cols.append(i - n); vals.append(1)
    return ((np.asarray(mats, np.uint8), np.asarray(rows, np.uint32),
             np.asarray(cols, np.uint32), ints_to_limbs_bulk(vals)),
            (np.asarray(crows, np.uint32), np.asarray(ccols, np.uint32),
             ints_to_limbs_bulk(cvals)))


def r1cs_to_coeffs(r1cs: R1CS, terms=None) -> Coeffs:
    """Sparse A/B coefficients incl. the snarkjs dummy A-rows (reference
    r1csToCoeffs, fake_setup.nim:46-65), values in Montgomery form."""
    (mats, rows, cols, vals_std), _ = terms or _flatten_terms(r1cs)
    coeff = F.to_mont(FR, torch.from_numpy(vals_std)).numpy()
    return Coeffs(matrix=mats, row=rows, col=cols, coeff=coeff)


def lagrange_taus(dom: NT.Domain, tau: int, device) -> torch.Tensor:
    """[L_k(tau)]_k as uint32[N, 16] Montgomery limbs via ONE inverse NTT:
    iNTT([tau^i])_k = w^k (tau^N - 1) / (N (tau - w^k)) = L_k(tau)."""
    tau_m = F.const(FR.to_mont_limbs(tau), device)
    return NT.inverse_ntt(dom, F.powers(FR, tau_m, dom.size).to(torch.uint32))


def _column_taus(r1cs: R1CS, lag: torch.Tensor, terms):
    """Per-wire tau-evaluations of the A/B/C column polynomials (reference
    fake_setup.nim:253-266, dummy rows :159-187): int64 Montgomery [nvars, 16]
    each."""
    m = r1cs.cfg.n_wires
    dev = lag.device
    (mats, rows, cols, vals_std), (crows, ccols, cvals_std) = terms
    all_rows = torch.from_numpy(np.concatenate([rows, crows]).astype(np.int64)).to(dev)
    seg = np.concatenate([cols.astype(np.int64) + mats.astype(np.int64) * m,
                          ccols.astype(np.int64) + 2 * m])
    vals = torch.from_numpy(np.concatenate([vals_std, cvals_std])).to(dev)
    prods = F.mont_mul(FR, F.to_mont(FR, F.i64(vals)), F.i64(F.as_i32(lag)[all_rows]))
    t_all = segment_sum_mod(prods, torch.from_numpy(seg).to(dev), 3 * m)
    return t_all[:m], t_all[m:2 * m], t_all[2 * m:]


_FB_WINDOW_BITS = 8  # fixed-base window width: 32 windows x 256-entry tables


@functools.lru_cache(maxsize=None)
def _fb_table(cv_name: str, device: str) -> tuple:
    """The generator's `curve.window_table` on `device`, built once."""
    cv = C.G1 if cv_name == "G1" else C.G2
    gen = H.G1_GEN if cv_name == "G1" else H.G2_GEN
    return C.window_table(cv, gen, _FB_WINDOW_BITS, torch.device(device))


def fixed_base_mul(cv: C.CurveSpec, exps_std: torch.Tensor):
    """Projective [k_i] G for a uint32[n, 16] standard-form scalar batch:
    byte w of k_i picks T[byte, w], and 32 complete adds sum the picks one
    window at a time (a batch of n points live, whatever n)."""
    dev = exps_std.device
    table = _fb_table(cv.name, str(dev))
    d = C.window_digits(exps_std, _FB_WINDOW_BITS)
    acc = C.inf_like(cv, (d.shape[0],), dev)
    for w in range(d.shape[1]):
        acc = C.point_add(cv, acc, C.table_picks(table, d[:, w], w))
    return acc


def fixed_base_points(cv: C.CurveSpec, exps_std: torch.Tensor) -> PointArray:
    """[k_i] G as a wire-layout PointArray; zero scalars give (0, 0)."""
    x, y = C.to_affine(cv, fixed_base_mul(cv, exps_std))
    return PointArray(x=x.cpu().numpy(), y=y.cpu().numpy())


def fake_circuit_setup(r1cs: R1CS, toxic: ToxicWaste, flavour: Flavour,
                       device: torch.device) -> ZKey:
    """Reference fakeCircuitSetup (fake_setup.nim:201-326) on `device`."""
    device = torch.device(device)
    neqs = r1cs.n_constr
    npub = r1cs.cfg.n_pub_in + r1cs.cfg.n_pub_out
    log2 = max(0, (neqs + npub + 1 - 1).bit_length())
    dom_size = 1 << log2
    nvars = r1cs.cfg.n_wires

    header = GrothHeader(curve="bn128", flavour=flavour, p=FP.modulus, r=R,
                         nvars=nvars, npubs=npub, domain_size=dom_size,
                         log_domain_size=log2)
    alpha1 = H.g1_mul(toxic.alpha)
    beta2 = H.g2_mul(toxic.beta)
    spec = SpecPoints(
        alpha1=alpha1,
        beta1=H.g1_mul(toxic.beta),
        beta2=beta2,
        gamma2=H.g2_mul(toxic.gamma),
        delta1=H.g1_mul(toxic.delta),
        delta2=H.g2_mul(toxic.delta),
        alpha_beta=PR.pairing(alpha1, beta2),
    )

    def mont(x):
        return F.const(FR.to_mont_limbs(x), device)

    def std(x):
        return F.from_mont(FR, x).to(torch.uint32)

    terms = _flatten_terms(r1cs)
    dom = NT.Domain(log2)
    lag = lagrange_taus(dom, toxic.tau, device)
    ta, tb, tc = _column_taus(r1cs, lag, terms)
    combo = F.add_mod(FR, F.add_mod(FR, F.mont_mul(FR, ta, mont(toxic.beta)),
                                    F.mont_mul(FR, tb, mont(toxic.alpha))), tc)
    ic_exp = std(F.mont_mul(FR, combo[:npub + 1], mont(pow(toxic.gamma, -1, R))))
    delta_inv = pow(toxic.delta, -1, R)
    c1_exp = std(F.mont_mul(FR, combo[npub + 1:], mont(delta_inv)))
    if flavour == Flavour.JensGroth:
        # [delta^-1 tau^i Z(tau)]_1 (fake_setup.nim:292-294)
        z_tau = (pow(toxic.tau, dom_size, R) - 1) % R
        pw = F.powers(FR, mont(toxic.tau), dom_size)
        h_exp = std(F.mont_mul(FR, pw, mont(delta_inv * z_tau % R)))
    else:
        # [delta^-1 L_{2i+1}(tau)]_1 on the 2N domain (fake_setup.nim:301-304)
        lag2 = lagrange_taus(NT.Domain(log2 + 1), toxic.tau, device)
        h_exp = std(F.mont_mul(FR, F.i64(lag2[1::2]), mont(delta_inv)))

    return ZKey(header=header, spec=spec,
                vpoints=VerifierPoints(points_ic=fixed_base_points(C.G1, ic_exp)),
                ppoints=ProverPoints(fixed_base_points(C.G1, std(ta)),
                                     fixed_base_points(C.G1, std(tb)),
                                     fixed_base_points(C.G2, std(tb)),
                                     fixed_base_points(C.G1, c1_exp),
                                     fixed_base_points(C.G1, h_exp)),
                coeffs=r1cs_to_coeffs(r1cs, terms))


def create_fake_circuit_setup(r1cs: R1CS, flavour: Flavour, device: torch.device) -> ZKey:
    """Reference createFakeCircuitSetup (fake_setup.nim:330-332)."""
    return fake_circuit_setup(r1cs, random_toxic_waste(), flavour, device)
