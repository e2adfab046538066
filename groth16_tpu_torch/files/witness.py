"""`.wtns` witness files (circom witness generators' output).

Format (reference `groth16/files/witness.nim:5-12,36-60`): iden3 container,
magic "wtns" version 2; section 1 = header (n8r, r, nvars), section 2 =
nvars 32-byte little-endian Fr values in STANDARD (non-Montgomery) form,
flat layout [1 | pubout | pubin | privin | secret].
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops.field import FR
from ..ops.limbs import (below_modulus_mask, bytes_le_to_limbs,
                         limbs_to_bytes_le, ints_to_limbs)
from ..protocol.types import Witness
from .container import read_container, container_bytes, parse_prime_field


def parse_witness(path: str) -> Witness:
    """Reference parseWitness (witness.nim:71-75); single pass, bulk decode."""
    sections = read_container(path, "wtns", 2)
    hdr = sections[1][0]
    n8r, r, pos = parse_prime_field(hdr, 0)
    assert n8r == 32, "expecting 256 bit prime"
    assert r == FR.modulus, "expecting the alt-bn128 curve"
    (nvars,) = struct.unpack_from("<I", hdr, pos)
    assert len(hdr) == pos + 4, "unexpected section length"

    data = sections[2][0]
    assert len(data) == 32 * nvars, "unexpected section length"
    values = bytes_le_to_limbs(data)
    # standard-form Fr values must be < r (reference unmarshalFrStd,
    # bn128/io.nim:141-146)
    assert bool(below_modulus_mask(values, FR.modulus).all()), \
        "non-canonical witness value (>= r)"
    return Witness(curve="bn128", r=r, nvars=nvars, values=values)


def witness_bytes(values) -> bytes:
    """Serialize a witness (iterable of ints or uint32[n,16] standard limbs)
    to `.wtns` bytes — fixture/writer counterpart (the reference has none)."""
    if isinstance(values, np.ndarray):
        limbs = values
    else:
        limbs = ints_to_limbs([v % FR.modulus for v in values])
    nvars = limbs.shape[0]
    hdr = struct.pack("<I", 32) + FR.modulus.to_bytes(32, "little") + struct.pack("<I", nvars)
    return container_bytes("wtns", 2, [(1, hdr), (2, limbs_to_bytes_le(limbs))])


def write_witness(path: str, values) -> None:
    with open(path, "wb") as f:
        f.write(witness_bytes(values))
