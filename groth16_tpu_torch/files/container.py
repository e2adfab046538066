"""iden3 binary container format (used by .zkey / .wtns / .r1cs).

Format (reference `groth16/files/container.nim:6-20`):

    magic    : word32   (4 ASCII chars, little-endian packed)
    version  : word32
    nsections: word32
    then per section:  id : word32,  size : word64,  data : size bytes

Unlike the reference's streaming callback walker, parsing here is a single
mmap-friendly pass that returns `{section_id: [bytes, ...]}` — sections are
then decoded in whatever order the format's data dependencies require (the
reference instead re-reads the file once per pass, `zkey.nim:241-246`).
A writer is included for fixture generation (the reference has no writer).
"""

from __future__ import annotations

import io
import struct


def magic_word(magic: str) -> int:
    """4-char ASCII tag -> little-endian word32 (reference container.nim:38-44)."""
    assert len(magic) == 4
    return int.from_bytes(magic.encode("ascii"), "little")


def read_container(path: str, expected_magic: str, expected_version: int) -> dict:
    """Parse a container file -> {section_id: [data_bytes, ...]}."""
    with open(path, "rb") as f:
        raw = f.read()
    return parse_container_bytes(raw, expected_magic, expected_version)


def parse_container_bytes(raw: bytes, expected_magic: str, expected_version: int) -> dict:
    assert len(raw) >= 12, "truncated container (no header)"
    magic, version, nsections = struct.unpack_from("<III", raw, 0)
    assert magic == magic_word(expected_magic), f"not a `{expected_magic}` file"
    assert version == expected_version, f"not a version {expected_version} `{expected_magic}` file"
    pos = 12
    sections: dict[int, list[bytes]] = {}
    for _ in range(nsections):
        assert pos + 12 <= len(raw), "truncated container (section header)"
        sect_id, sect_len = struct.unpack_from("<IQ", raw, pos)
        pos += 12
        assert pos + sect_len <= len(raw), \
            f"truncated container (section {sect_id} body)"
        sections.setdefault(sect_id, []).append(raw[pos:pos + sect_len])
        pos += sect_len
    return sections


def container_bytes(magic: str, version: int, sections: list) -> bytes:
    out = io.BytesIO()
    out.write(struct.pack("<III", magic_word(magic), version, len(sections)))
    for sect_id, data in sections:
        out.write(struct.pack("<IQ", sect_id, len(data)))
        out.write(data)
    return out.getvalue()


def parse_prime_field(data: bytes, pos: int) -> tuple:
    """(n8, prime_int, new_pos): word32 length + little-endian prime bytes
    (reference container.nim:48-55)."""
    (n8,) = struct.unpack_from("<I", data, pos)
    assert n8 <= 32, "at most 256 bit primes are allowed"
    p = int.from_bytes(data[pos + 4:pos + 4 + n8], "little")
    return n8, p, pos + 4 + n8
