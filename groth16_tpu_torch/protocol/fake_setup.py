"""Fake circuit-specific trusted setup (reference `groth16/fake_setup.nim`).

Counterpart of the vectorized pipeline of groth16_tpu/protocol/fake_setup.py
(fake_setup.py:164-256, 322-361): from toxic waste and an R1CS, a complete
in-memory ZKey, on any device.

  * Lagrange taus L_k(tau) of the whole domain from ONE inverse NTT of
    [tau^i] (kernel K3 on CUDA);
  * the per-wire A/B/C column taus from a gather, one Montgomery multiply
    and an int64 segment sum a slice of the R1CS's entries;
  * every point family as a windowed fixed-base ladder: 32 table gathers and
    32 complete adds (kernel K1 on CUDA) per point.

Every step whose work grows with the circuit runs in slices of SLICE rows
(entries, wires, domain points or points), so that the device memory the
set-up takes at once stays bounded whatever the circuit's size: a
Montgomery product in plain PyTorch holds about 10 KB a row while it runs.
Slices change no byte: every value is canonical.

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
from ..ops.field import FP, FR
from ..ops.limbs import ints_to_limbs_bulk
from ..utils import hostmath as H
from ..utils import pairing as PR
from ..utils import timing as T
from .types import (
    Coeffs, Flavour, GrothHeader, PointArray, ProverPoints, R1CS, SpecPoints,
    VerifierPoints, ZKey,
)

R = FR.modulus

# Rows a step of the set-up takes at once: R1CS entries, wires or domain
# points of Fr arithmetic (about 2.6 GB of a Montgomery product's
# intermediates at 2^18), or points of a fixed-base ladder.  A 2^16 circuit
# (num2bits16's 256,069 entries, the 2^17 Lagrange powers) sets up in one
# slice.
SLICE = 1 << 18


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


def _slices(n: int) -> list:
    """[start, end) of each slice of n rows (one empty slice where n = 0)."""
    return [(s, min(n, s + SLICE)) for s in range(0, max(n, 1), SLICE)]


def _by_slice(n: int, fn, device, span: str) -> torch.Tensor:
    """uint32 [n, 16] on `device`, rows [s, e) from fn(s, e), a span `span`
    (recorded always) a slice."""
    out = torch.empty((n, 16), dtype=torch.uint32, device=device)
    for s, e in _slices(n):
        with T.span(span, always=True):
            out[s:e] = fn(s, e).to(torch.uint32)
    return out


def _const(x: int, device) -> torch.Tensor:
    return F.const(FR.to_mont_limbs(x), device)


def _powers(tau: int, n: int, device) -> torch.Tensor:
    """[tau^i]_{i<n}, Montgomery uint32 [n, 16]: `field.powers` over the
    first slice, each later slice the first times tau^start."""
    first = F.powers(FR, _const(tau, device), min(n, SLICE))

    def part(s, e):
        return first[:e - s] if s == 0 else F.mont_mul(FR, first[:e - s],
                                                        _const(pow(tau, s, R), device))
    return _by_slice(n, part, device, "fake_setup.taus.slice")


def lagrange_taus(dom: NT.Domain, tau: int, device) -> torch.Tensor:
    """[L_k(tau)]_k as uint32[N, 16] Montgomery limbs via ONE inverse NTT:
    iNTT([tau^i])_k = w^k (tau^N - 1) / (N (tau - w^k)) = L_k(tau)."""
    return NT.inverse_ntt(dom, _powers(tau, dom.size, device))


def _column_taus(r1cs: R1CS, lag: torch.Tensor, terms):
    """Per-wire tau-evaluations of the A/B/C column polynomials (reference
    fake_setup.nim:253-266, dummy rows :159-187), Montgomery uint32 [nvars,
    16] each on lag's device, and the A/B coefficient stream in Montgomery
    form (uint32 [entries, 16], host; reference r1csToCoeffs,
    fake_setup.nim:46-65).  Each slice of entries takes its coefficients to
    Montgomery form, multiplies them by their rows' taus and adds the
    products into an int64 column sum; the sums are reduced a slice of
    wires at a time."""
    m = r1cs.cfg.n_wires
    dev = lag.device
    (mats, rows, cols, vals_std), (crows, ccols, cvals_std) = terms
    lag32 = F.as_i32(lag)
    acc = torch.zeros((3 * m, 16), dtype=torch.int64, device=dev)
    coeff = np.empty_like(vals_std)
    for rw, seg, vals, out in ((rows, cols.astype(np.int64) + mats.astype(np.int64) * m, vals_std,
                                coeff), (crows, ccols.astype(np.int64) + 2 * m, cvals_std, None)):
        for s, e in _slices(len(rw)):
            with T.span("fake_setup.taus.slice", always=True):
                v = F.to_mont(FR, F.i64(torch.from_numpy(vals[s:e]).to(dev)))
                if out is not None:
                    out[s:e] = v.to(torch.uint32).cpu().numpy()
                at = torch.from_numpy(rw[s:e].astype(np.int64)).to(dev)
                acc.index_add_(0, torch.from_numpy(seg[s:e]).to(dev),
                               F.mont_mul(FR, v, F.i64(lag32[at])))
    t_all = _by_slice(3 * m, lambda s, e: F.reduce_columns(FR, acc[s:e]), dev,
                      "fake_setup.taus.slice")
    return t_all[:m], t_all[m:2 * m], t_all[2 * m:], coeff


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
    window at a time (a batch of n points live: `fixed_base_points` hands
    it a slice at a time)."""
    dev = exps_std.device
    table = _fb_table(cv.name, str(dev))
    d = C.window_digits(exps_std, _FB_WINDOW_BITS)
    acc = C.inf_like(cv, (d.shape[0],), dev)
    for w in range(d.shape[1]):
        acc = C.point_add(cv, acc, C.table_picks(table, d[:, w], w))
    return acc


def fixed_base_points(cv: C.CurveSpec, exps_std: torch.Tensor) -> PointArray:
    """[k_i] G as a wire-layout PointArray; zero scalars give (0, 0).  SLICE
    points at a time go up the ladder, to affine and to the host, each
    slice the span `fake_setup.points.slice` (recorded always)."""
    xs, ys = [], []
    for s, e in _slices(exps_std.shape[0]):
        with T.span("fake_setup.points.slice", always=True):
            x, y = C.to_affine(cv, fixed_base_mul(cv, exps_std[s:e]))
            xs.append(x.cpu().numpy())
            ys.append(y.cpu().numpy())
    return PointArray(x=np.concatenate(xs), y=np.concatenate(ys))


def fake_circuit_setup(r1cs: R1CS, toxic: ToxicWaste, flavour: Flavour,
                       device: torch.device) -> ZKey:
    """Reference fakeCircuitSetup (fake_setup.nim:201-326) on `device`.
    The span `fake_setup` (recorded always) holds its steps:
    `fake_setup.spec` (host products and the pairing), `.terms`
    (`_flatten_terms`), `.taus` (the exponents and the Montgomery
    coefficients, up to a synchronization), `.points` (the six
    `fixed_base_points`) and `.coeffs`; `.taus.slice` and `.points.slice`
    are one slice each inside them.  On a CUDA device the tracer's counter
    `fake_setup.peak_bytes` keeps the largest device reserve
    (`torch.cuda.max_memory_reserved`) seen at a set-up's end."""
    device = torch.device(device)
    with T.span("fake_setup", always=True):
        neqs = r1cs.n_constr
        npub = r1cs.cfg.n_pub_in + r1cs.cfg.n_pub_out
        log2 = max(0, (neqs + npub + 1 - 1).bit_length())
        dom_size = 1 << log2
        nvars = r1cs.cfg.n_wires

        header = GrothHeader(curve="bn128", flavour=flavour, p=FP.modulus, r=R,
                             nvars=nvars, npubs=npub, domain_size=dom_size,
                             log_domain_size=log2)
        with T.span("fake_setup.spec", always=True):
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

        def std(x):
            return F.from_mont(FR, x).to(torch.uint32)

        def scaled(src, k: int):
            """std(src[s:e] * k) a slice at a time."""
            return lambda s, e: std(F.mont_mul(FR, src[s:e], _const(k, device)))

        def sliced(n, fn):
            return _by_slice(n, fn, device, "fake_setup.taus.slice")

        with T.span("fake_setup.terms", always=True):
            terms = _flatten_terms(r1cs)
        with T.span("fake_setup.taus", always=True):
            dom = NT.Domain(log2)
            lag = lagrange_taus(dom, toxic.tau, device)
            ta, tb, tc, coeff = _column_taus(r1cs, lag, terms)
            del lag
            ab = (_const(toxic.beta, device), _const(toxic.alpha, device))
            combo = sliced(nvars, lambda s, e: F.add_mod(FR, F.add_mod(
                FR, F.mont_mul(FR, ta[s:e], ab[0]), F.mont_mul(FR, tb[s:e], ab[1])), tc[s:e]))
            ic_exp = sliced(npub + 1, scaled(combo, pow(toxic.gamma, -1, R)))
            delta_inv = pow(toxic.delta, -1, R)
            c1_exp = sliced(nvars - npub - 1, scaled(combo[npub + 1:], delta_inv))
            if flavour == Flavour.JensGroth:
                # [delta^-1 tau^i Z(tau)]_1 (fake_setup.nim:292-294)
                z_tau = (pow(toxic.tau, dom_size, R) - 1) % R
                pw = _powers(toxic.tau, dom_size, device)
                h_exp = sliced(dom_size, scaled(pw, delta_inv * z_tau % R))
            else:
                # [delta^-1 L_{2i+1}(tau)]_1 on the 2N domain (fake_setup.nim:301-304)
                lag2 = lagrange_taus(NT.Domain(log2 + 1), toxic.tau, device)
                h_exp = sliced(dom_size, scaled(lag2[1::2], delta_inv))
            del combo, tc
            ta_std, tb_std = (sliced(nvars, lambda s, e, t=t: std(t[s:e])) for t in (ta, tb))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        with T.span("fake_setup.points", always=True):
            vpoints = VerifierPoints(points_ic=fixed_base_points(C.G1, ic_exp))
            ppoints = ProverPoints(fixed_base_points(C.G1, ta_std),
                                   fixed_base_points(C.G1, tb_std),
                                   fixed_base_points(C.G2, tb_std),
                                   fixed_base_points(C.G1, c1_exp),
                                   fixed_base_points(C.G1, h_exp))
        with T.span("fake_setup.coeffs", always=True):
            mats, rows, cols, _ = terms[0]
            coeffs = Coeffs(matrix=mats, row=rows, col=cols, coeff=coeff)
        if device.type == "cuda":
            T.peak("fake_setup.peak_bytes", torch.cuda.max_memory_reserved(device))
        return ZKey(header=header, spec=spec, vpoints=vpoints, ppoints=ppoints, coeffs=coeffs)


def create_fake_circuit_setup(r1cs: R1CS, flavour: Flavour, device: torch.device) -> ZKey:
    """Reference createFakeCircuitSetup (fake_setup.nim:330-332)."""
    return fake_circuit_setup(r1cs, random_toxic_waste(), flavour, device)
