"""`.zkey` proving/verification-key files (snarkjs Groth16 setup output).

Format (reference `groth16/files/zkey.nim:1-91`): iden3 container, magic
"zkey" version 1.  Sections:

  1: prover type (word32 == 1 for Groth16)
  2: Groth header: (n8p, p), (n8r, r), nvars, npub, domainSize, then
     alpha1:G1 beta1:G1 beta2:G2 gamma2:G2 delta1:G1 delta2:G2
  3: IC points          (npub+1) * G1
  4: sparse A/B coeffs: ncoeffs * (m:w32, row:w32, col:w32, value:Fr)
     — values are DOUBLE Montgomery encoded (zkey.nim:56-58); one Montgomery
     reduction at parse time leaves them in the single (device) form
  5/6/7: A1/B1 G1, B2 G2 points, nvars each
  8: C1 points (nvars - npub - 1)
  9: H1 points (domainSize) — snarkjs convention [delta^-1 L_{2i+1}(tau)]_1
     on the DOUBLE domain, not [delta^-1 tau^i Z(tau)]_1 (zkey.nim:79-91)

Point coordinates are 32-byte little-endian Montgomery (R = 2^256), which is
bit-identical to this framework's device limb layout — point sections are
parsed as single numpy byte reshuffles, no per-element conversion (the
reference converts element-by-element through constantine,
`bn128/io.nim:228-250`).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..ops import field as F
from ..ops.field import FP, FR
from ..ops.limbs import (below_modulus_mask, bytes_le_to_limbs,
                         limbs_to_bytes_le, N_LIMBS)
from ..protocol.types import (
    Coeffs, Flavour, GrothHeader, PointArray, ProverPoints, SpecPoints,
    VerifierPoints, ZKey,
)
from ..utils import pairing as PR
from .container import read_container, container_bytes, parse_prime_field


# --- wire <-> PointArray -----------------------------------------------------

def g1_points_from_bytes(data: bytes) -> PointArray:
    """n*64 bytes -> PointArray with x,y uint32[n,16] Montgomery limbs."""
    limbs = bytes_le_to_limbs(data).reshape(-1, 2, N_LIMBS)
    return PointArray(x=limbs[:, 0].copy(), y=limbs[:, 1].copy())


def g2_points_from_bytes(data: bytes) -> PointArray:
    """n*128 bytes -> PointArray with x,y uint32[n,2,16] (c0,c1 components)."""
    limbs = bytes_le_to_limbs(data).reshape(-1, 2, 2, N_LIMBS)
    return PointArray(x=limbs[:, 0].copy(), y=limbs[:, 1].copy())


def points_to_bytes(pa: PointArray) -> bytes:
    n = len(pa)
    if pa.is_g2:
        inter = np.stack([pa.x, pa.y], axis=1).reshape(n * 4, N_LIMBS)
    else:
        inter = np.stack([pa.x, pa.y], axis=1).reshape(n * 2, N_LIMBS)
    return limbs_to_bytes_le(inter)


def _mont_limbs_to_int(limbs, fp) -> int:
    return fp.from_mont_limbs(np.asarray(limbs))


def _g1_host(pa_row_x, pa_row_y):
    x = _mont_limbs_to_int(pa_row_x, FP)
    y = _mont_limbs_to_int(pa_row_y, FP)
    return None if (x == 0 and y == 0) else (x, y)


def _g2_host(pa_row_x, pa_row_y):
    x = (_mont_limbs_to_int(pa_row_x[0], FP), _mont_limbs_to_int(pa_row_x[1], FP))
    y = (_mont_limbs_to_int(pa_row_y[0], FP), _mont_limbs_to_int(pa_row_y[1], FP))
    return None if (x == (0, 0) and y == (0, 0)) else (x, y)


def _host_g1_to_limbs(pt) -> np.ndarray:
    if pt is None:
        return np.zeros((2, N_LIMBS), np.uint32)
    return np.stack([FP.to_mont_limbs(pt[0]), FP.to_mont_limbs(pt[1])])


def _host_g2_to_limbs(pt) -> np.ndarray:
    if pt is None:
        return np.zeros((2, 2, N_LIMBS), np.uint32)
    return np.stack([
        np.stack([FP.to_mont_limbs(pt[0][0]), FP.to_mont_limbs(pt[0][1])]),
        np.stack([FP.to_mont_limbs(pt[1][0]), FP.to_mont_limbs(pt[1][1])]),
    ])


# --- parser ------------------------------------------------------------------

def parse_zkey(path: str) -> ZKey:
    """Reference parseZKey (zkey.nim:241-246).  The reference needs three
    passes because it streams; here sections arrive as a dict so ordering is
    resolved in memory."""
    sections = read_container(path, "zkey", 1)

    # section 1: prover type
    (prover_type,) = struct.unpack_from("<I", sections[1][0], 0)
    assert prover_type == 1, "expecting `.zkey` file for a Groth16 prover"

    # section 2: Groth header + spec points
    hdr = sections[2][0]
    n8p, p, pos = parse_prime_field(hdr, 0)
    n8r, r, pos = parse_prime_field(hdr, pos)
    assert n8p == 32 and n8r == 32, "expecting 256 bit primes"
    assert p == FP.modulus and r == FR.modulus, "expecting the alt-bn128 curve"
    assert len(hdr) == 2 * 4 + n8p + n8r + 3 * 4 + 3 * 64 + 3 * 128, "unexpected section length"
    nvars, npubs, dom_size = struct.unpack_from("<III", hdr, pos)
    log2 = max(0, (dom_size - 1).bit_length())
    assert (1 << log2) == dom_size, "domain size should be a power of two"
    pos += 12

    def g1_at(o):
        limbs = bytes_le_to_limbs(hdr[o:o + 64])
        return _g1_host(limbs[0], limbs[1])

    def g2_at(o):
        limbs = bytes_le_to_limbs(hdr[o:o + 128]).reshape(2, 2, N_LIMBS)
        return _g2_host(limbs[0], limbs[1])

    assert bool(below_modulus_mask(
        bytes_le_to_limbs(hdr[pos:pos + 3 * 64 + 3 * 128]),
        FP.modulus).all()), "non-canonical spec-point coordinate"
    alpha1 = g1_at(pos); pos += 64
    beta1 = g1_at(pos); pos += 64
    beta2 = g2_at(pos); pos += 128
    gamma2 = g2_at(pos); pos += 128
    delta1 = g1_at(pos); pos += 64
    delta2 = g2_at(pos); pos += 128
    # on-curve checks for the six ceremony points (reference loadPointG1/G2
    # validate via mkG1/mkG2, bn128/io.nim:228-250)
    from ..utils import hostmath as H
    for nm, pt in (("alpha1", alpha1), ("beta1", beta1), ("delta1", delta1)):
        assert pt is None or H.ec_is_on_curve(H.G1_FIELD, pt), \
            f"spec point {nm} not on the curve"
    for nm, pt in (("beta2", beta2), ("gamma2", gamma2), ("delta2", delta2)):
        assert pt is None or H.ec_is_on_curve(H.G2_FIELD, pt), \
            f"spec point {nm} not on the twist"
    spec = SpecPoints(alpha1, beta1, beta2, gamma2, delta1, delta2,
                      alpha_beta=PR.pairing(alpha1, beta2))

    header = GrothHeader(curve="bn128", flavour=Flavour.Snarkjs, p=p, r=r,
                         nvars=nvars, npubs=npubs, domain_size=dom_size,
                         log_domain_size=log2)

    # section 4: sparse coefficients (double-Montgomery values)
    cdata = sections[4][0]
    (ncoeffs,) = struct.unpack_from("<I", cdata, 0)
    assert len(cdata) == 4 + ncoeffs * (32 + 12), "unexpected section length"
    body = np.frombuffer(cdata, dtype=np.uint8, offset=4).reshape(ncoeffs, 44)
    meta = body[:, :12].copy().view("<u4")       # [ncoeffs, 3] m,row,col
    assert int(meta[:, 0].max(initial=0)) <= 2, "invalid matrix selector"
    assert int(meta[:, 1].max(initial=0)) < dom_size, "row index out of range"
    assert int(meta[:, 2].max(initial=0)) < nvars, "column index out of range"
    raw_vals = bytes_le_to_limbs(body[:, 12:].copy().reshape(-1))
    assert bool(below_modulus_mask(raw_vals, FR.modulus).all()), \
        "non-canonical coefficient value in section 4"
    # strip one Montgomery factor: wire holds v*R^2, device form is v*R
    single = F.from_mont(FR, torch.from_numpy(raw_vals)).numpy()
    coeffs = Coeffs(matrix=meta[:, 0].astype(np.uint8), row=meta[:, 1].copy(),
                    col=meta[:, 2].copy(), coeff=single)

    # point sections
    def expect(sect, nbytes):
        assert len(sections[sect]) == 1, f"duplicate section {sect}"
        data = sections[sect][0]
        assert len(data) == nbytes, f"unexpected section {sect} length"
        # every 32-byte word is an Fp coordinate in Montgomery form; a value
        # >= p is a non-canonical encoding the reference's constantine
        # unmarshal rejects (bn128/io.nim:126-153, loadPointG1/G2)
        assert bool(below_modulus_mask(bytes_le_to_limbs(data),
                                       FP.modulus).all()), \
            f"non-canonical coordinate in section {sect}"
        return data

    ic = g1_points_from_bytes(expect(3, 64 * (npubs + 1)))
    a1 = g1_points_from_bytes(expect(5, 64 * nvars))
    b1 = g1_points_from_bytes(expect(6, 64 * nvars))
    b2 = g2_points_from_bytes(expect(7, 128 * nvars))
    c1 = g1_points_from_bytes(expect(8, 64 * (nvars - npubs - 1)))
    h1 = g1_points_from_bytes(expect(9, 64 * dom_size))

    return ZKey(header=header, spec=spec,
                vpoints=VerifierPoints(points_ic=ic),
                ppoints=ProverPoints(a1, b1, b2, c1, h1),
                coeffs=coeffs)


# --- writer (fixture generation; the reference has no zkey writer) ----------

def zkey_bytes(zkey: ZKey) -> bytes:
    hdr2 = struct.pack("<I", 32) + FP.modulus.to_bytes(32, "little")
    hdr2 += struct.pack("<I", 32) + FR.modulus.to_bytes(32, "little")
    hdr2 += struct.pack("<III", zkey.header.nvars, zkey.header.npubs,
                        zkey.header.domain_size)
    hdr2 += limbs_to_bytes_le(_host_g1_to_limbs(zkey.spec.alpha1))
    hdr2 += limbs_to_bytes_le(_host_g1_to_limbs(zkey.spec.beta1))
    hdr2 += limbs_to_bytes_le(_host_g2_to_limbs(zkey.spec.beta2).reshape(4, N_LIMBS))
    hdr2 += limbs_to_bytes_le(_host_g2_to_limbs(zkey.spec.gamma2).reshape(4, N_LIMBS))
    hdr2 += limbs_to_bytes_le(_host_g1_to_limbs(zkey.spec.delta1))
    hdr2 += limbs_to_bytes_le(_host_g2_to_limbs(zkey.spec.delta2).reshape(4, N_LIMBS))

    co = zkey.coeffs
    # re-apply the double Montgomery encoding: v*R -> v*R^2
    raw = F.to_mont(FR, torch.from_numpy(np.ascontiguousarray(co.coeff, np.uint32))).numpy()
    body = np.zeros((len(co), 44), np.uint8)
    meta = np.stack([co.matrix.astype(np.uint32), co.row, co.col], axis=1)
    body[:, :12] = np.ascontiguousarray(meta.astype("<u4")).view(np.uint8).reshape(-1, 12)
    body[:, 12:] = np.frombuffer(limbs_to_bytes_le(raw), np.uint8).reshape(-1, 32)
    sect4 = struct.pack("<I", len(co)) + body.tobytes()

    return container_bytes("zkey", 1, [
        (1, struct.pack("<I", 1)),
        (2, hdr2),
        (3, points_to_bytes(zkey.vpoints.points_ic)),
        (4, sect4),
        (5, points_to_bytes(zkey.ppoints.points_a1)),
        (6, points_to_bytes(zkey.ppoints.points_b1)),
        (7, points_to_bytes(zkey.ppoints.points_b2)),
        (8, points_to_bytes(zkey.ppoints.points_c1)),
        (9, points_to_bytes(zkey.ppoints.points_h1)),
    ])


def write_zkey(path: str, zkey: ZKey) -> None:
    with open(path, "wb") as f:
        f.write(zkey_bytes(zkey))
