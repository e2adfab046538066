"""Montgomery arithmetic over the BN254 prime fields, in plain PyTorch.

Counterpart of groth16_tpu/ops/field.py.  Field elements are
``[..., 16]`` little-endian base-2^16 limb tensors in Montgomery form with
R = 2**256.  The wire dtype is uint32; every function here also takes int64
limbs, which is what the arithmetic runs in (PyTorch has no uint32 add, shift
or compare on the CPU), and returns the dtype of its first argument.  Callers
that chain many operations (curve formulas, NTT stages) stay in int64 and
convert once.

Multiplication is SOS Montgomery: the 16x16-limb column products come from
one broadcast outer product and an anti-diagonal sum, carries are resolved
by carry-save passes plus one Kogge-Stone lookahead where an exact result is
needed.  Every result is canonical (< modulus), so results are bit-identical
to the JAX package and to the CUDA kernels (csrc/bn254_field.cuh).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as tnf

from .limbs import LIMB_BITS, LIMB_MASK, N_LIMBS, int_to_limbs, limbs_to_int

# BN254 ("alt-bn128") base and scalar field moduli — reference
# groth16/bn128/fields.nim:36-37.
P_FP = 21888242871839275222246405745257275088696311157297823662689037894645226208583
P_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

R_MONT = 1 << 256  # Montgomery radix, matches the circom wire format


@dataclass(frozen=True)
class FieldParams:
    """Precomputed constants for one prime field (host ints + numpy limbs)."""

    modulus: int
    name: str = "F"

    def __post_init__(self):
        object.__setattr__(self, "mont_r", R_MONT % self.modulus)
        object.__setattr__(self, "mont_r2", (R_MONT * R_MONT) % self.modulus)
        object.__setattr__(self, "mont_r_inv", pow(R_MONT, -1, self.modulus))
        object.__setattr__(self, "p_limbs", int_to_limbs(self.modulus))
        # 2^256 - p, for the branchless conditional subtraction
        object.__setattr__(self, "pc_limbs", int_to_limbs(R_MONT - self.modulus))
        # -p^-1 mod 2^256, for the separated Montgomery reduction
        object.__setattr__(self, "pprime_limbs",
                           int_to_limbs((-pow(self.modulus, -1, R_MONT)) % R_MONT))
        object.__setattr__(self, "r2_limbs", int_to_limbs(self.mont_r2))
        object.__setattr__(self, "one_mont_limbs", int_to_limbs(self.mont_r))

    # ---- host-side (Python int) helpers ------------------------------------
    def to_mont_int(self, x: int) -> int:
        return (x * R_MONT) % self.modulus

    def from_mont_int(self, x: int) -> int:
        return (x * self.mont_r_inv) % self.modulus

    def to_mont_limbs(self, x: int) -> np.ndarray:
        """Plain integer -> Montgomery limb vector (host)."""
        return int_to_limbs(self.to_mont_int(x % self.modulus))

    def from_mont_limbs(self, limbs) -> int:
        """Montgomery limb vector -> plain integer (host)."""
        return self.from_mont_int(limbs_to_int(np.asarray(limbs)))


FP = FieldParams(P_FP, "Fp")
FR = FieldParams(P_FR, "Fr")

_CONSTS: dict = {}


def const(limbs: np.ndarray, device) -> torch.Tensor:
    """A host limb array as an int64 tensor on `device` (cached)."""
    arr = np.asarray(limbs)
    key = (arr.tobytes(), arr.shape, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.from_numpy(arr.astype(np.int64)).to(device)
    return t


def i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """Bit view of a uint32 limb tensor as int32 (limbs < 2^16 read the same),
    for the indexing, `where` and `cat` that PyTorch implements for int32 on
    every device; other dtypes pass through."""
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def as_u32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.uint32) if x.dtype == torch.int32 else x


def _like(ref: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Return r in the dtype convention of `ref` (uint32 wire or int64)."""
    return r.to(torch.uint32) if ref.dtype == torch.uint32 else r


# ---------------------------------------------------------------------------
# int64 limb helpers
# ---------------------------------------------------------------------------

def _shift_up(x: torch.Tensor, d: int = 1) -> torch.Tensor:
    """out[i] = x[i-d] along the limb axis (zero fill, top dropped)."""
    return tnf.pad(x[..., :-d], (d, 0))


def _relax(z: torch.Tensor) -> torch.Tensor:
    """One carry-save pass; value preserved mod 2^(16 * limbs)."""
    return (z & LIMB_MASK) + _shift_up(z >> LIMB_BITS)


def _carry_normalize(z: torch.Tensor):
    """Exact carry propagation of columns < 2^32 into canonical 16-bit limbs.
    Returns (limbs mod 2^(16L), carry out).

    After one carry-save step every limb t_i < 2^17 generates a carry
    of 0 or 1.  The carry out of limb i is decided by the nearest limb j <= i
    that does not merely propagate (t_j != 0xFFFF): it is that limb's own
    generate bit.  A running max of decisive indices finds j for every i at
    once — the lookahead of a Kogge-Stone adder in a handful of tensor ops."""
    L = z.shape[-1]
    c = z >> LIMB_BITS
    t = (z & LIMB_MASK) + _shift_up(c)
    G = t >> LIMB_BITS
    low = t & LIMB_MASK
    idx = _arange(L, z.device).expand_as(t)
    idx = torch.where((G > 0) | (low != LIMB_MASK), idx, -1)
    last = torch.cummax(idx, dim=-1).values
    cout = torch.where(last >= 0, G.gather(-1, last.clamp(min=0)), 0)
    return (low + _shift_up(cout)) & LIMB_MASK, c[..., -1] + cout[..., -1]


def _arange(n: int, device) -> torch.Tensor:
    key = ("arange", n, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.arange(n, device=device)
    return t


def _fit(z: torch.Tensor, cols: int) -> torch.Tensor:
    n = z.shape[-1]
    return tnf.pad(z, (0, cols - n)) if n < cols else z[..., :cols]


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Column sums z[k] = sum_{i+j=k} a_i b_j (k < 33) of two [..., 16] limb
    tensors, as an anti-diagonal sum of their outer product."""
    a, b = torch.broadcast_tensors(a, b)
    n = N_LIMBS
    prod = tnf.pad(a.unsqueeze(-1) * b.unsqueeze(-2), (0, n))  # [..., 16, 32]
    flat = prod.flatten(-2)[..., : n * (2 * n - 1)]
    cols = flat.reshape(flat.shape[:-1] + (n, 2 * n - 1)).sum(-2)
    return tnf.pad(cols, (0, 2))


def _toeplitz(limbs: np.ndarray, out_cols: int, device) -> torch.Tensor:
    key = ("toeplitz", limbs.tobytes(), out_cols, str(device))
    t = _CONSTS.get(key)
    if t is None:
        m = np.zeros((N_LIMBS, out_cols), np.float64)
        for i in range(N_LIMBS):
            for j in range(N_LIMBS):
                if i + j < out_cols:
                    m[i, i + j] = limbs[j]
        t = _CONSTS[key] = torch.from_numpy(m).to(device)
    return t


def _conv_const(a: torch.Tensor, limbs: np.ndarray, out_cols: int) -> torch.Tensor:
    """Column sums of a [..., 16] limb tensor times a constant, as one float64
    matrix product: exact while every column sum stays below 2^53."""
    return (a.to(torch.float64) @ _toeplitz(limbs, out_cols, a.device)).to(torch.int64)


def _scale(device) -> torch.Tensor:
    key = ("scale", str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor([2.0 ** (LIMB_BITS * k - 256) for k in range(N_LIMBS)],
                                        dtype=torch.float64, device=device)
    return t


def _finish(fp: FieldParams, s: torch.Tensor) -> torch.Tensor:
    """Canonical residue of a redundant [..., 16] limb vector (limbs < 2^31)
    whose value is x or 2^256 + x for some x < 2p: normalize s and s + 2^256 - p
    together, keep the second where it carried further (x >= p)."""
    both = torch.stack([s, s + const(fp.pc_limbs, s.device)])
    limbs, carry = _carry_normalize(both)
    return torch.where((carry[1] > carry[0]).unsqueeze(-1), limbs[1], limbs[0])


def _redc(fp: FieldParams, z: torch.Tensor, exact_m: bool) -> torch.Tensor:
    """z * R^-1 mod p for a [..., 33] column vector z (value < p*R, columns
    < 2^38).  `exact_m` reduces m = z * (-p^-1) mod R exactly, which bounds
    the result below 2p for any z < pR; for a product of two canonical
    values (z < p^2) two carry-save passes are enough."""
    zt = _relax(z)
    m = _relax(_conv_const(zt[..., :N_LIMBS], fp.pprime_limbs, N_LIMBS))
    m = _carry_normalize(m)[0] if exact_m else _relax(m)
    t = _conv_const(m, fp.p_limbs, 2 * N_LIMBS + 1) + zt
    # the low half of t is an exact multiple q * 2^256 with q < 2^22: its
    # float64 value divided by 2^256 rounds to q without error
    q = (t[..., :N_LIMBS].to(torch.float64) * _scale(z.device)).sum(-1).round()
    hi = t[..., N_LIMBS:2 * N_LIMBS].clone()
    hi[..., 0] += q.to(torch.int64)
    return _finish(fp, _relax(hi))     # t/R < 2p, so nothing carries past limb 15


# ---------------------------------------------------------------------------
# public field ops (uint32 or int64 limbs in, same dtype out)
# ---------------------------------------------------------------------------

def mont_mul(fp: FieldParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p."""
    return _like(a, _redc(fp, _conv(i64(a), i64(b)), exact_m=False))


def mont_reduce_wide(fp: FieldParams, t: torch.Tensor) -> torch.Tensor:
    """t * R^-1 mod p for a double-width value t ([..., 32] limbs < 2^16,
    value < p*R)."""
    return _like(t, _redc(fp, _fit(i64(t), 2 * N_LIMBS + 1), exact_m=True))


def add_mod(fp: FieldParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _like(a, _finish(fp, i64(a) + i64(b)))


def sub_mod(fp: FieldParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # a + p + (~b mod 2^256) + 1 == 2^256 + (a - b + p), with a - b + p < 2p
    a64, b64 = torch.broadcast_tensors(i64(a), i64(b))
    t = a64 + const(fp.p_limbs, a64.device) + (b64 ^ LIMB_MASK)
    t[..., 0] += 1
    return _like(a, _finish(fp, t))


def neg_mod(fp: FieldParams, a: torch.Tensor) -> torch.Tensor:
    return sub_mod(fp, torch.zeros_like(a), a)


def to_mont(fp: FieldParams, a: torch.Tensor) -> torch.Tensor:
    """Standard residue -> Montgomery form (multiply by R^2, reduce)."""
    return mont_mul(fp, a, const(fp.r2_limbs, a.device))


def from_mont(fp: FieldParams, a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> standard residue."""
    return _like(a, _redc(fp, _fit(i64(a), 2 * N_LIMBS + 1), exact_m=True))


def pow_mod(fp: FieldParams, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a ** exponent for a host int exponent (Montgomery in and out)."""
    acc = torch.broadcast_to(const(fp.one_mont_limbs, a.device), a.shape)
    base = i64(a)
    while exponent:
        if exponent & 1:
            acc = mont_mul(fp, acc, base)
        exponent >>= 1
        if exponent:
            base = mont_mul(fp, base, base)
    return _like(a, acc)


def inv_mod(fp: FieldParams, a: torch.Tensor) -> torch.Tensor:
    """Batched inverse via Fermat (a^(p-2)); the inverse of 0 is 0."""
    return pow_mod(fp, a, fp.modulus - 2)


def powers(fp: FieldParams, base: torch.Tensor, n: int) -> torch.Tensor:
    """[1, base, ..., base^(n-1)] ([n, 16], Montgomery) by log-doubling."""
    assert n >= 1
    b = i64(base)
    out = const(fp.one_mont_limbs, b.device)[None, :]
    cur = 1
    while cur < n:
        bp = mont_mul(fp, out[cur - 1], b)          # base^cur
        take = min(cur, n - cur)
        out = torch.cat([out, mont_mul(fp, out[:take], bp[None, :])], 0)
        cur += take
    return _like(base, out)


def reduce_columns(fp: FieldParams, acc: torch.Tensor) -> torch.Tensor:
    """V mod p for int64 limb columns acc [..., 16] (columns < 2^62) whose
    value V = sum_k acc_k 2^(16k) is a sum of canonical residues — a segment
    sum of Montgomery limbs, exact for up to 2^46 terms."""
    z = _fit(acc, 2 * N_LIMBS)
    for _ in range(3):
        z = _relax(z)                    # columns < 2^16 + 2^15 + 1
    z, _ = _carry_normalize(z)
    return to_mont(fp, mont_reduce_wide(fp, z))   # (V R^-1) R^2 R^-1 = V
