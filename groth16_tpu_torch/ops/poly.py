"""Dense polynomials over Fr, batched on a device.

Counterpart of groth16_tpu/ops/poly.py (the reference's
`groth16/math/poly.nim`: add, sub, scale, naive and FFT products,
vanishing-polynomial division, Lagrange evaluation).  Coefficients are
uint32 [N, 16] Montgomery limb tensors, lowest degree first; the arithmetic
is the plain field ops of `ops/field.py` and the NTT of `ops/ntt.py` (K3 on
CUDA tensors).  Library surface: the prover does not call it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as F
from . import ntt as NT
from .field import FR
from .limbs import N_LIMBS, ints_to_limbs_bulk, limbs_to_ints


def poly_from_ints(coeffs, device) -> torch.Tensor:
    """Plain int coefficients -> uint32 [N, 16] Montgomery on `device`."""
    mont = ints_to_limbs_bulk(FR.to_mont_int(c % FR.modulus) for c in coeffs)
    return torch.from_numpy(mont).to(device)


def poly_to_ints(coeffs: torch.Tensor) -> list:
    return [FR.from_mont_int(x) for x in limbs_to_ints(coeffs.cpu().numpy())]


def _padded(a: torch.Tensor, n: int) -> torch.Tensor:
    """int64 limbs of a, zero-extended to n coefficients."""
    a = F.i64(a)
    return torch.cat([a, a.new_zeros((n - a.shape[0], N_LIMBS))])


def poly_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Coefficient-wise sum, operands zero-extended to the longer length
    (reference polyAdd, poly.nim:69-80)."""
    n = max(a.shape[0], b.shape[0])
    return F.add_mod(FR, _padded(a, n), _padded(b, n)).to(torch.uint32)


def poly_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = max(a.shape[0], b.shape[0])
    return F.sub_mod(FR, _padded(a, n), _padded(b, n)).to(torch.uint32)


def poly_neg(a: torch.Tensor) -> torch.Tensor:
    return F.neg_mod(FR, a)


def poly_scale(s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """s * a for one Montgomery scalar s [16] (reference polyScale)."""
    return F.mont_mul(FR, a, s[None, :])


def poly_eval_at(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a(x) at one Montgomery point x [16] by Horner's rule, highest
    coefficient first (reference polyEvalAt, poly.nim:57-65)."""
    acc = F.i64(x).new_zeros((N_LIMBS,))
    for c in F.i64(a).flip(0):
        acc = F.add_mod(FR, F.mont_mul(FR, acc, F.i64(x)), c)
    return acc.to(torch.uint32)


def poly_mul_naive(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """O(n m) schoolbook product: one batched outer product, then each of
    b's m columns added in at its shift (reference polyMulNaive,
    poly.nim:105-122)."""
    n, m = a.shape[0], b.shape[0]
    prod = F.mont_mul(FR, F.i64(a)[:, None, :], F.i64(b)[None, :, :])     # [n, m, 16]
    out = prod.new_zeros((n + m - 1, N_LIMBS))
    for j in range(m):
        out[j:j + n] = F.add_mod(FR, out[j:j + n], prod[:, j])
    return out.to(torch.uint32)


def poly_mul_fft(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """FFT product (reference polyMulFFT, poly.nim:127-140): both operands
    zero-extended to the power of two above deg(a) + deg(b), multiplied
    pointwise on the domain, transformed back."""
    n, m = a.shape[0], b.shape[0]
    out_len = n + m - 1
    dom = NT.Domain(max(1, (out_len - 1).bit_length()))
    fa = NT.forward_ntt(dom, _padded(a, dom.size).to(torch.uint32))
    fb = NT.forward_ntt(dom, _padded(b, dom.size).to(torch.uint32))
    return NT.inverse_ntt(dom, F.mont_mul(FR, fa, fb))[:out_len]


def poly_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The naive product for small operands (n m <= 4096), else the FFT one,
    as the JAX package picks."""
    if a.shape[0] * b.shape[0] <= 1 << 12:
        return poly_mul_naive(a, b)
    return poly_mul_fft(a, b)


# ---------------------------------------------------------------------------
# Vanishing polynomial  Z(x) = x^N - 1  helpers (reference poly.nim:163-218)
# ---------------------------------------------------------------------------

def vanishing_poly(dom_size: int, device, a: int = 1, b: int = 1) -> torch.Tensor:
    """a x^N - b as Montgomery coefficients on `device` (reference
    mkVanishingPoly)."""
    r = FR.modulus
    out = np.zeros((dom_size + 1, N_LIMBS), np.uint32)
    out[0] = FR.to_mont_limbs((-b) % r)
    out[dom_size] = FR.to_mont_limbs(a % r)
    return torch.from_numpy(out).to(device)


def poly_divmod_vanishing(p: torch.Tensor, dom_size: int):
    """(quotient, remainder) of p by x^N - 1 (reference polyQuotRem,
    poly.nim:186-218): q_j = sum_{t>=1} p_{j+tN} and r_i = sum_{t>=0}
    p_{i+tN}, suffix sums over the blocks of N coefficients."""
    n, N = p.shape[0], dom_size
    if n <= N:
        return p.new_zeros((1, N_LIMBS)), _padded(p, N).to(torch.uint32)
    nb = -(-n // N)
    blocks = _padded(p, nb * N).reshape(nb, N, N_LIMBS)
    acc = blocks[nb - 1]
    q_blocks = [None] * (nb - 1)
    for blk in range(nb - 2, -1, -1):
        q_blocks[blk] = acc                      # = sum_{t > blk} blocks[t]
        acc = F.add_mod(FR, acc, blocks[blk])
    q = torch.cat(q_blocks, 0)[: n - N]
    return q.to(torch.uint32), acc.to(torch.uint32)


# ---------------------------------------------------------------------------
# Lagrange basis (reference poly.nim:223-250), host ints
# ---------------------------------------------------------------------------

def lagrange_eval_off_domain(dom: NT.Domain, k: int, zeta: int) -> int:
    """L_k(zeta) for zeta off the domain, closed form
    omega^k (zeta^N - 1) / (N (zeta - omega^k)) (reference
    evalLagrangePolyAt, poly.nim:242-250)."""
    r = FR.modulus
    wk = pow(dom.gen, k, r)
    num = wk * (pow(zeta, dom.size, r) - 1) % r
    den = dom.size * (zeta - wk) % r
    return num * pow(den, -1, r) % r


def lagrange_evals_at(dom: NT.Domain, zeta: int) -> list:
    """[L_k(zeta)] for every k of the domain."""
    r = FR.modulus
    zn = (pow(zeta, dom.size, r) - 1) % r
    out = []
    wk = 1
    for _ in range(dom.size):
        den = dom.size * (zeta - wk) % r
        out.append(wk * zn % r * pow(den, -1, r) % r)
        wk = wk * dom.gen % r
    return out
