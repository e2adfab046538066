"""Limb-vector representation of big field elements (numpy, host side).

The wire layout of the port is the JAX package's (groth16_tpu/ops/limbs.py):
a field element is a little-endian vector of ``N_LIMBS = 16`` limbs, each
holding ``LIMB_BITS = 16`` payload bits inside a ``uint32`` word, and a batch
is a ``uint32[..., 16]`` array.  The CUDA kernels pack limb pairs into eight
32-bit words on load; the plain PyTorch versions widen the limbs to int64.

The wire format of the circom ecosystem (32-byte little-endian words,
Montgomery form with R = 2**256 for `.zkey` points) maps 1:1 onto this layout,
so file parsing is a pure byte reshuffle (see reference
`groth16/bn128/io.nim:87-153` for the representation quirks we must match).
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 16
N_LIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
TOTAL_BITS = LIMB_BITS * N_LIMBS  # 256


def int_to_limbs(x: int, n_limbs: int = N_LIMBS) -> np.ndarray:
    """Python int -> uint32[n_limbs] little-endian base-2^16 limb vector."""
    if x < 0:
        raise ValueError("int_to_limbs expects a non-negative integer")
    out = np.zeros((n_limbs,), dtype=np.uint32)
    for i in range(n_limbs):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x != 0:
        raise ValueError(f"integer does not fit in {n_limbs} limbs")
    return out


def limbs_to_int(limbs: np.ndarray) -> int:
    """uint32[..., L] limb vector -> Python int (single element only)."""
    arr = np.asarray(limbs, dtype=np.uint64).reshape(-1)
    acc = 0
    for i in range(arr.shape[0] - 1, -1, -1):
        acc = (acc << LIMB_BITS) | int(arr[i])
    return acc


def ints_to_limbs(xs, n_limbs: int = N_LIMBS) -> np.ndarray:
    """Iterable of ints -> uint32[len, n_limbs]."""
    xs = list(xs)
    out = np.zeros((len(xs), n_limbs), dtype=np.uint32)
    for j, x in enumerate(xs):
        out[j] = int_to_limbs(x, n_limbs)
    return out


def ints_to_limbs_bulk(xs) -> np.ndarray:
    """Iterable of non-negative ints < 2^256 -> uint32[len, 16].

    Bulk path for big batches (the per-limb Python loop of `ints_to_limbs`
    costs ~30 s at 2^21 elements): one C-level `to_bytes` per int, then a
    single byte reshuffle."""
    buf = b"".join(x.to_bytes(32, "little") for x in xs)
    if not buf:
        return np.zeros((0, N_LIMBS), np.uint32)
    return bytes_le_to_limbs(buf)


def limbs_to_ints(arr: np.ndarray) -> list:
    """uint32[N, L] -> list of N Python ints."""
    arr = np.asarray(arr, dtype=np.uint64)
    if arr.ndim == 1:
        return [limbs_to_int(arr)]
    n, L = arr.shape
    shifts = np.arange(L, dtype=object) * LIMB_BITS
    out = []
    for j in range(n):
        acc = 0
        for i in range(L - 1, -1, -1):
            acc = (acc << LIMB_BITS) | int(arr[j, i])
        out.append(acc)
    return out


def bytes_le_to_limbs(raw: bytes | np.ndarray) -> np.ndarray:
    """Little-endian 32-byte words -> uint32[N, 16] limb array.

    `raw` is a buffer whose length is a multiple of 32; every 32-byte slice is
    one 256-bit little-endian value (the encoding used by `.zkey`, `.wtns`,
    `.r1cs` files — reference `groth16/bn128/io.nim:126-153`).
    """
    buf = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray, memoryview)) else np.asarray(raw, dtype=np.uint8)
    assert buf.size % 32 == 0, "buffer must be a multiple of 32 bytes"
    u16 = buf.reshape(-1, 32).view("<u2")  # [N, 16] little-endian 16-bit words
    return u16.astype(np.uint32)


def below_modulus_mask(limbs: np.ndarray, modulus: int) -> np.ndarray:
    """bool[n] mask: value < modulus, vectorized lexicographic compare on
    uint32[n, 16] canonical limb rows (wire-format hardening: a value >= p
    is a non-canonical encoding the reference's constantine unmarshal
    rejects, `groth16/bn128/io.nim:126-153`)."""
    arr = np.asarray(limbs, np.int64).reshape(-1, N_LIMBS)
    diff = arr - np.asarray(int_to_limbs(modulus), np.int64)[None, :]
    nz = diff != 0
    any_nz = nz.any(axis=1)
    # most significant differing limb decides; all-equal means value == p
    top = N_LIMBS - 1 - np.argmax(nz[:, ::-1], axis=1)
    top_diff = np.take_along_axis(diff, top[:, None], axis=1)[:, 0]
    return np.where(any_nz, top_diff < 0, False)


def limbs_to_bytes_le(limbs: np.ndarray) -> bytes:
    """uint32[N, 16] limb array -> concatenated 32-byte little-endian words."""
    arr = np.asarray(limbs, dtype=np.uint32)
    if arr.ndim == 1:
        arr = arr[None, :]
    assert arr.shape[-1] == N_LIMBS
    if np.any(arr > LIMB_MASK):
        raise ValueError("limbs not normalized")
    return arr.astype("<u2").tobytes()
