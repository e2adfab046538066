"""Debug value printers (reference `groth16/bn128/debug.nim:18-42` and the
decimal pretty-printing of `bn128/io.nim:22-54`, including the signed form
for small negative values)."""

from __future__ import annotations

import numpy as np

from ..ops.field import FP, FR


def _signed_decimal(x: int, modulus: int) -> str:
    """Print values close to the modulus as small negatives
    (reference io.nim:44-54)."""
    if x > modulus - (1 << 64):
        return f"-{modulus - x}"
    return str(x)


def fr_to_str(limbs_mont) -> str:
    return _signed_decimal(FR.from_mont_limbs(np.asarray(limbs_mont)), FR.modulus)


def fp_to_str(limbs_mont) -> str:
    return _signed_decimal(FP.from_mont_limbs(np.asarray(limbs_mont)), FP.modulus)


def debug_print_fr(prefix: str, limbs_mont) -> None:
    print(f"{prefix} = {fr_to_str(limbs_mont)}")


def debug_print_fr_seq(prefix: str, arr) -> None:
    arr = np.asarray(arr)
    print(f"{prefix} ({arr.shape[0]} values):")
    for i in range(arr.shape[0]):
        print(f"  [{i}] = {fr_to_str(arr[i])}")


def debug_print_g1(prefix: str, pt) -> None:
    """pt: host affine int pair or None."""
    if pt is None:
        print(f"{prefix} = <infinity>")
    else:
        print(f"{prefix} = G1(x={pt[0]}, y={pt[1]})")


def debug_print_g2(prefix: str, pt) -> None:
    if pt is None:
        print(f"{prefix} = <infinity>")
    else:
        (x0, x1), (y0, y1) = pt
        print(f"{prefix} = G2(x={x0}+{x1}u, y={y0}+{y1}u)")


def print_groth_header(hdr) -> None:
    """Reference zkey_types.nim:77-88 (full field surface incl. the primes)."""
    print("Groth16 header:")
    print(f"  curve         = {hdr.curve}")
    print(f"  flavour       = {hdr.flavour.value}")
    print(f"  |Fp|          = {hdr.p}")
    print(f"  |Fr|          = {hdr.r}")
    print(f"  nvars         = {hdr.nvars}")
    print(f"  npubs         = {hdr.npubs}")
    print(f"  domainSize    = {hdr.domain_size}")
    print(f"  logDomainSize = {hdr.log_domain_size}")


def print_coeffs(coeffs, limit: int | None = None) -> None:
    """Per-coefficient sparse-matrix listing (reference debugPrintCoeffs,
    zkey_types.nim:91-103): matrix letter, row, col, signed-decimal value."""
    n = len(coeffs)
    k = n if limit is None else min(n, limit)
    for t in range(k):
        m = "ABC"[int(coeffs.matrix[t])]
        print(f"matrix={m} | i={int(coeffs.row[t])} | j={int(coeffs.col[t])}"
              f" | val={fr_to_str(coeffs.coeff[t])}")
    if k < n:
        print(f"... ({n - k} more coefficients)")
