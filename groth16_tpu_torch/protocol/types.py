"""Shared Groth16 protocol types (the analog of reference
`groth16/zkey_types.nim:8-105`).

Representation choices, TPU-first:

* Big point sets (IC / A1 / B1 / B2 / C1 / H1) are `PointArray`s — affine
  coordinate limb arrays in Montgomery form, uint32[n, 16] (G1) or
  uint32[n, 2, 16] (G2) per coordinate, the exact wire layout of `.zkey`
  files, ready for one bulk device transfer (the reference instead converts
  stream-element-by-element, `bn128/io.nim:228-250`).
* The six special points and the alphaBeta pairing value are tiny and live as
  host ints (`SpecPoints`, cf. zkey_types.nim:24-31).
* Sparse A/B coefficients are struct-of-arrays numpy (cf. `Coeff`,
  zkey_types.nim:43-52).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

import numpy as np


class Flavour(Enum):
    """H-points convention (reference zkey_types.nim:10-12):
    JensGroth = [delta^-1 tau^i Z(tau)]_1, Snarkjs = [delta^-1 L_{2i+1}(tau)]_1
    on the doubled domain (`files/zkey.nim:79-86`)."""

    JensGroth = "jens-groth"
    Snarkjs = "snarkjs"


@dataclass
class GrothHeader:
    """Reference zkey_types.nim:14-22."""

    curve: str
    flavour: Flavour
    p: int
    r: int
    nvars: int
    npubs: int
    domain_size: int
    log_domain_size: int


@dataclass
class PointArray:
    """Affine point batch in wire layout: Montgomery limb arrays per
    coordinate; (0,0) rows encode the point at infinity."""

    x: np.ndarray
    y: np.ndarray

    def __len__(self):
        return self.x.shape[0]

    @property
    def is_g2(self) -> bool:
        return self.x.ndim == 3


@dataclass
class SpecPoints:
    """The six ceremony points + precomputed e(alpha1, beta2)
    (reference zkey_types.nim:24-31).  Host affine ints (None = infinity)."""

    alpha1: tuple
    beta1: tuple
    beta2: tuple
    gamma2: tuple
    delta1: tuple
    delta2: tuple
    alpha_beta: tuple = None  # Fp12 element (6-tuple of Fp2 pairs)


@dataclass
class VerifierPoints:
    """Reference zkey_types.nim:33-34."""

    points_ic: PointArray


@dataclass
class ProverPoints:
    """Reference zkey_types.nim:36-41."""

    points_a1: PointArray
    points_b1: PointArray
    points_b2: PointArray
    points_c1: PointArray
    points_h1: PointArray


@dataclass
class Coeffs:
    """Sparse A/B matrix entries, struct-of-arrays (reference `Coeff`,
    zkey_types.nim:43-52).  `coeff` limbs are in (single) Montgomery form —
    the double encoding of the wire format (`files/zkey.nim:56-58`) is
    stripped at parse time."""

    matrix: np.ndarray   # uint8[ncoeffs]   0=A, 1=B (2=C never occurs in zkeys)
    row: np.ndarray      # uint32[ncoeffs]  constraint index < domain_size
    col: np.ndarray      # uint32[ncoeffs]  witness index < nvars
    coeff: np.ndarray    # uint32[ncoeffs, 16] Montgomery Fr

    def __len__(self):
        return self.matrix.shape[0]


@dataclass
class ZKey:
    """Reference zkey_types.nim:54-60."""

    header: GrothHeader
    spec: SpecPoints
    vpoints: VerifierPoints
    ppoints: ProverPoints
    coeffs: Coeffs


@dataclass
class VKey:
    """Reference zkey_types.nim:62-65."""

    header: GrothHeader
    spec: SpecPoints
    vpoints: VerifierPoints


def extract_vkey(zkey: ZKey) -> VKey:
    """Reference zkey_types.nim:69-73."""
    return VKey(header=zkey.header, spec=zkey.spec, vpoints=zkey.vpoints)


@dataclass
class Witness:
    """Reference files/witness.nim:27-32; values in STANDARD representation
    (witness.nim:57-60), flat layout
    [1 | pubout | pubin | privin | secret] (witness.nim:5-12)."""

    curve: str
    r: int
    nvars: int
    values: np.ndarray   # uint32[nvars, 16] standard-form Fr limbs


@dataclass
class WitnessConfig:
    """Reference files/r1cs.nim:62-68."""

    n_wires: int
    n_pub_out: int
    n_pub_in: int
    n_priv_in: int
    n_labels: int


@dataclass
class R1CS:
    """Reference files/r1cs.nim:74-80.  Constraints are kept sparse:
    each of A/B/C is (row, col, value) numpy triples."""

    r: int
    cfg: WitnessConfig
    n_constr: int
    constraints: list        # [(A_terms, B_terms, C_terms)] with terms = [(wire_idx, int_value)]
    wire_to_label: np.ndarray


def zkey_from_numpy(src) -> ZKey:
    """A ZKey of this package from any object with the same fields and numpy
    arrays — e.g. one built by the JAX package — so that both provers start
    from the same state."""
    h = src.header
    header = GrothHeader(curve=h.curve, flavour=Flavour(h.flavour.value), p=h.p, r=h.r,
                         nvars=h.nvars, npubs=h.npubs, domain_size=h.domain_size,
                         log_domain_size=h.log_domain_size)
    s = src.spec
    spec = SpecPoints(s.alpha1, s.beta1, s.beta2, s.gamma2, s.delta1, s.delta2,
                      alpha_beta=s.alpha_beta)

    def pa(a):
        return PointArray(x=np.array(a.x, np.uint32), y=np.array(a.y, np.uint32))

    pp = src.ppoints
    co = src.coeffs
    return ZKey(header=header, spec=spec,
                vpoints=VerifierPoints(points_ic=pa(src.vpoints.points_ic)),
                ppoints=ProverPoints(pa(pp.points_a1), pa(pp.points_b1), pa(pp.points_b2),
                                     pa(pp.points_c1), pa(pp.points_h1)),
                coeffs=Coeffs(matrix=np.array(co.matrix, np.uint8),
                              row=np.array(co.row, np.uint32),
                              col=np.array(co.col, np.uint32),
                              coeff=np.array(co.coeff, np.uint32)))
