"""Radix-2 NTT over the BN254 scalar field: four-step orchestration in
PyTorch around the inner-transform kernel K3 (csrc/ntt.cu).

Counterpart of groth16_tpu/ops/ntt.py (domains, forward / inverse NTT,
coset shifts) and of the four-step orchestration of
groth16_tpu/ops/ntt_pallas.py (`_transform`).  N = N1 * N2: NB batched
T-point transforms run in the
kernel, the transposes, the outer-twiddle table and the final bit reversal
are torch ops.  Forward = DIF (natural -> bit-reversed) with the outer
twiddle post-multiplied, inverse = DIT (bit-reversed -> natural) with the
outer twiddle, 1/N folded in, pre-multiplied, so the only permutation is one
bit-reversal gather.

Domain semantics are the reference's (`groth16/math/domain.nim:26-46`): the
2^k root of unity comes from gen28 = 5^((r-1)/2^28).  Outputs are canonical
Montgomery values, bit-identical to the JAX package at every size.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import cuda
from . import field as F
from .field import FR
from .limbs import N_LIMBS, int_to_limbs

GEN28 = pow(5, (FR.modulus - 1) >> 28, FR.modulus)
MAX_LOG2 = 28
MAX_T = 4096  # per-factor transform length (N <= 2^24), 128 KB of shared memory


@dataclass(frozen=True)
class Domain:
    """Power-of-two evaluation domain (host constants)."""

    log2_size: int

    def __post_init__(self):
        assert 0 <= self.log2_size <= MAX_LOG2
        r = FR.modulus
        g = pow(GEN28, 1 << (MAX_LOG2 - self.log2_size), r)
        object.__setattr__(self, "size", 1 << self.log2_size)
        object.__setattr__(self, "gen", g)
        object.__setattr__(self, "gen_inv", pow(g, -1, r))
        object.__setattr__(self, "size_inv", pow(self.size, -1, r))


def _mont(x: int) -> np.ndarray:
    return int_to_limbs(x * F.R_MONT % FR.modulus)


def _bitrev_indices(n: int) -> np.ndarray:
    lg = max(0, n.bit_length() - 1)
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, np.int64)
    for b in range(lg):
        rev |= ((idx >> b) & 1) << (lg - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _stage_roots_np(T: int, root: int) -> np.ndarray:
    """uint32[max(T/2, 1), 16]: root^k in Montgomery form, k < T/2 (the
    twiddle of butterfly offset j at span h is root^(j * T/(2h)))."""
    out = np.zeros((max(T // 2, 1), N_LIMBS), np.uint32)
    acc = 1
    for k in range(T // 2):
        out[k] = _mont(acc)
        acc = acc * root % FR.modulus
    return out


_TABLES: dict = {}


def _cached(key, make):
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = make()
    return t


def stage_roots(T: int, root: int, device) -> torch.Tensor:
    return _cached(("roots", T, root, str(device)),
                   lambda: torch.from_numpy(_stage_roots_np(T, root)).to(device))


def _split(t: int):
    """N = N1 * N2 with the larger factor first (minor-axis transform)."""
    t1 = (t + 1) // 2
    return 1 << t1, 1 << (t - t1)


def _outer_table(log2n: int, inverse: bool, device) -> torch.Tensor:
    """uint32[16, N2, N1]: W[n2, k1br] = root^(n2 * rev(k1br)), with 1/N
    folded in for the inverse (the four-step outer twiddle)."""
    def make():
        dom = Domain(log2n)
        N1, N2 = _split(log2n)
        root = dom.gen_inv if inverse else dom.gen
        pw = F.powers(FR, F.const(_mont(root), device), dom.size)      # int64 [N, 16]
        if inverse:
            pw = F.mont_mul(FR, pw, F.const(_mont(dom.size_inv), device))
        exps = (np.arange(N2)[:, None] * _bitrev_indices(N1)[None, :]) % dom.size
        idx = torch.from_numpy(exps.reshape(-1)).to(device)
        return pw[idx].reshape(N2, N1, N_LIMBS).permute(2, 0, 1).contiguous().to(torch.uint32)
    return _cached(("outer", log2n, inverse, str(device)), make)


def bitrev_perm(n: int, device) -> torch.Tensor:
    return _cached(("bitrev", n, str(device)),
                   lambda: torch.from_numpy(_bitrev_indices(n)).to(device))


# ---------------------------------------------------------------------------
# K3: NB batched T-point transforms, limb-major uint32[16, NB, T]
# ---------------------------------------------------------------------------

def ntt_inner_plain(x: torch.Tensor, tw, roots: torch.Tensor, dit: bool) -> torch.Tensor:
    """Plain PyTorch version of K3 (any device).

    DIF (natural in, bit-reversed out), then `tw` post-multiplied; or, for
    `dit`, `tw` pre-multiplied, then DIT (bit-reversed in, natural out).
    `tw` is uint32[16, NB, T] or None; `roots` is `stage_roots(T, root)`."""
    _, NB, T = x.shape
    a = F.i64(x).permute(1, 2, 0)                      # [NB, T, 16]
    w_all = F.i64(roots)
    if tw is not None and dit:
        a = F.mont_mul(FR, a, F.i64(tw).permute(1, 2, 0))
    hs = []
    h = T // 2
    while h >= 1:
        hs.append(h)
        h //= 2
    for h in (reversed(hs) if dit else hs):
        v = a.reshape(NB, T // (2 * h), 2, h, N_LIMBS)
        u, b = v[:, :, 0], v[:, :, 1]
        w = w_all[torch.arange(h, device=x.device) * (T // (2 * h))]
        if dit:
            wb = F.mont_mul(FR, b, w)
            top, bot = F.add_mod(FR, u, wb), F.sub_mod(FR, u, wb)
        else:
            top, bot = F.add_mod(FR, u, b), F.mont_mul(FR, F.sub_mod(FR, u, b), w)
        a = torch.stack([top, bot], 2).reshape(NB, T, N_LIMBS)
    if tw is not None and not dit:
        a = F.mont_mul(FR, a, F.i64(tw).permute(1, 2, 0))
    return a.permute(2, 0, 1).contiguous().to(torch.uint32)


def ntt_inner_kernel(x: torch.Tensor, tw, roots: torch.Tensor, dit: bool) -> torch.Tensor:
    """K3 on CUDA tensors (see `ntt_inner_plain`)."""
    _, NB, T = x.shape
    if x.device.type != "cuda" or x.dtype != torch.uint32 or x.shape[0] != N_LIMBS:
        raise ValueError("K3 takes a uint32[16, NB, T] CUDA tensor")
    if T > MAX_T or T & (T - 1):
        raise ValueError(f"transform length {T} must be a power of two <= {MAX_T}")
    x = x.contiguous()
    if tw is not None:
        if tw.shape != x.shape or tw.dtype != torch.uint32 or tw.device != x.device:
            raise ValueError("outer twiddles must match x")
        tw = tw.contiguous()
    roots = roots.to(x.device).contiguous()
    out = torch.empty_like(x)
    rc = cuda.lib().g16_ntt(x.data_ptr(), tw.data_ptr() if tw is not None else None,
                            roots.data_ptr(), out.data_ptr(), T, NB, int(dit),
                            cuda.stream_ptr(x.device))
    cuda.check(rc, "ntt kernel")
    ntt_inner_kernel.launches += 1
    return out


ntt_inner_kernel.launches = 0


def ntt_inner(x: torch.Tensor, tw, roots: torch.Tensor, dit: bool) -> torch.Tensor:
    """K3 on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return ntt_inner_plain(x, tw, roots, dit)
    return ntt_inner_kernel(x, tw, roots, dit)


def inner_calls(log2n: int, inverse: bool, device) -> list:
    """The two K3 calls of one 2^log2n transform, in order, as
    (NB, T, outer twiddle or None, stage roots, dit)."""
    dom = Domain(log2n)
    g = dom.gen_inv if inverse else dom.gen
    N1, N2 = _split(log2n)
    W = _outer_table(log2n, inverse, device)
    r1 = stage_roots(N1, pow(g, N2, FR.modulus), device)   # N1-subgroup root
    r2 = stage_roots(N2, pow(g, N1, FR.modulus), device)
    if not inverse:
        return [(N2, N1, W, r1, False), (N1, N2, None, r2, False)]
    return [(N1, N2, None, r2, True), (N2, N1, W, r1, True)]


def _transform(x2: torch.Tensor, log2n: int, inverse: bool) -> torch.Tensor:
    """Four-step NTT on limb-major [16, N]: natural order in and out."""
    n = 1 << log2n
    dev = x2.device
    if log2n == 0:
        return x2.clone()
    N1, N2 = _split(log2n)
    (_, _, tw1, ra, dit), (_, _, tw2, rb, _) = inner_calls(log2n, inverse, dev)
    if not inverse:
        x3 = x2.reshape(N_LIMBS, N1, N2).transpose(1, 2).contiguous()  # [16, N2, N1]
        y = ntt_inner(x3, tw1, ra, dit)                                 # k1 bit-reversed
        y = y.transpose(1, 2).contiguous()                               # [16, N1br, N2]
        z = ntt_inner(y, tw2, rb, dit)                                  # k2 bit-reversed
        return F.as_u32(F.as_i32(z).reshape(N_LIMBS, n)[:, bitrev_perm(n, dev)])
    z = F.as_u32(F.as_i32(x2)[:, bitrev_perm(n, dev)]).reshape(N_LIMBS, N1, N2)
    y = ntt_inner(z.contiguous(), tw1, ra, dit)
    y = y.transpose(1, 2).contiguous()                                   # [16, N2, N1br]
    x3 = ntt_inner(y, tw2, rb, dit)                                     # [16, N2, N1]
    return x3.transpose(1, 2).reshape(N_LIMBS, n)


def forward_ntt(dom: Domain, coeffs: torch.Tensor) -> torch.Tensor:
    """Coefficients -> evaluations on the domain (reference ntt.nim:55-77);
    uint32[N, 16] Montgomery in and out."""
    assert tuple(coeffs.shape) == (dom.size, N_LIMBS)
    return _transform(coeffs.T.contiguous(), dom.log2_size, False).T.contiguous()


def inverse_ntt(dom: Domain, values: torch.Tensor) -> torch.Tensor:
    """Evaluations on the domain -> coefficients (reference ntt.nim:139-161)."""
    assert tuple(values.shape) == (dom.size, N_LIMBS)
    return _transform(values.T.contiguous(), dom.log2_size, True).T.contiguous()


def mul_by_powers(dom: Domain, xs: torch.Tensor, eta_mont: torch.Tensor) -> torch.Tensor:
    """[eta^i * xs[i]]: coset scaling (reference prover.nim:96-106)."""
    return F.mont_mul(FR, xs, F.powers(FR, eta_mont, xs.shape[0]))


def shift_eval_domain(dom: Domain, values: torch.Tensor, eta_mont: torch.Tensor) -> torch.Tensor:
    """Values on the domain -> values on the eta-shifted coset
    (iNTT, scale by eta^i, NTT); reference prover.nim:109-113."""
    return forward_ntt(dom, mul_by_powers(dom, inverse_ntt(dom, values), eta_mont))
