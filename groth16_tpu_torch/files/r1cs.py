"""`.r1cs` constraint-system files (circom compiler output).

Format (reference `groth16/files/r1cs.nim:4-50`): iden3 container, magic
"r1cs" version 1.  Section 1 = header (n8r, r, nWires, nPubOut, nPubIn,
nPrivIn, nLabels:w64, nConstr), section 2 = constraints (A,B,C linear
combinations of (wireIdx:w32, coeff:Fr-standard) terms), section 3 = wire to
label map (w64 each).  Field elements are in STANDARD representation.
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops.field import FR
from ..protocol.types import R1CS, WitnessConfig
from .container import read_container, container_bytes, parse_prime_field


def _read_lincomb(data: bytes, pos: int):
    (nterms,) = struct.unpack_from("<I", data, pos)
    pos += 4
    terms = []
    for _ in range(nterms):
        (idx,) = struct.unpack_from("<I", data, pos)
        coeff = int.from_bytes(data[pos + 4:pos + 36], "little")
        terms.append((idx, coeff))
        pos += 36
    return terms, pos


def parse_r1cs(path: str) -> R1CS:
    """Reference parseR1CS (r1cs.nim:170-174); single pass, ordered decode."""
    sections = read_container(path, "r1cs", 1)

    hdr = sections[1][0]
    n8r, r, pos = parse_prime_field(hdr, 0)
    assert r == FR.modulus, "expecting the alt-bn128 curve"
    n_wires, n_pub_out, n_pub_in, n_priv_in = struct.unpack_from("<IIII", hdr, pos)
    (n_labels,) = struct.unpack_from("<Q", hdr, pos + 16)
    (n_constr,) = struct.unpack_from("<I", hdr, pos + 24)
    assert len(hdr) == pos + 28, "unexpected section length"
    cfg = WitnessConfig(n_wires, n_pub_out, n_pub_in, n_priv_in, n_labels)

    constraints = []
    data = sections[2][0]
    pos = 0
    for _ in range(n_constr):
        a, pos = _read_lincomb(data, pos)
        b, pos = _read_lincomb(data, pos)
        c, pos = _read_lincomb(data, pos)
        constraints.append((a, b, c))

    wire_to_label = np.zeros((0,), np.uint64)
    if 3 in sections:
        lbl = sections[3][0]
        assert len(lbl) == 8 * n_wires, "unexpected section length"
        wire_to_label = np.frombuffer(lbl, dtype="<u8").copy()

    return R1CS(r=r, cfg=cfg, n_constr=n_constr, constraints=constraints,
                wire_to_label=wire_to_label)


def _lincomb_bytes(terms) -> bytes:
    out = struct.pack("<I", len(terms))
    for idx, coeff in terms:
        out += struct.pack("<I", idx) + (coeff % FR.modulus).to_bytes(32, "little")
    return out


def r1cs_bytes(r1cs: R1CS) -> bytes:
    """Serialize back to `.r1cs` — fixture/writer counterpart."""
    cfg = r1cs.cfg
    hdr = (struct.pack("<I", 32) + FR.modulus.to_bytes(32, "little")
           + struct.pack("<IIII", cfg.n_wires, cfg.n_pub_out, cfg.n_pub_in, cfg.n_priv_in)
           + struct.pack("<Q", cfg.n_labels)
           + struct.pack("<I", r1cs.n_constr))
    cons = b"".join(
        _lincomb_bytes(a) + _lincomb_bytes(b) + _lincomb_bytes(c)
        for a, b, c in r1cs.constraints
    )
    labels = (np.asarray(r1cs.wire_to_label, dtype="<u8").tobytes()
              if len(r1cs.wire_to_label) else np.arange(cfg.n_wires, dtype="<u8").tobytes())
    return container_bytes("r1cs", 1, [(1, hdr), (2, cons), (3, labels)])


def write_r1cs(path: str, r1cs: R1CS) -> None:
    with open(path, "wb") as f:
        f.write(r1cs_bytes(r1cs))
