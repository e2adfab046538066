"""BN254 G1 (over Fp) and G2 (over Fp2) point arithmetic in PyTorch.

Counterpart of groth16_tpu/ops/curve.py.  A batch of points is a tuple
``(X, Y, Z)`` of homogeneous projective coordinates, each ``uint32[..., 16]``
(G1) or ``uint32[..., 2, 16]`` (G2) Montgomery limbs; the point at infinity
is (0 : 1 : 0).  The group law is the complete RCB15 formulas, so infinity
and doubling need no branches.

`point_add`, `point_double_n` (k doublings; `point_double` is k = 1) and
`horner` dispatch to kernel K1 (csrc/point.cu): on CUDA tensors they launch
it, on CPU tensors they run the plain version (`point_add_plain`,
`point_double_n_plain`, `horner_plain`: the same formulas on int64 limbs with
the independent products of each step stacked into one multiply).  Both give
bit-identical projective results.  `to_affine` on CUDA tensors inverts Z
with the merge tree's batch-inversion kernel K6 and multiplies X and Y by
the inverses with its row-product kernel K5 (csrc/tree.cu).  `multiples`,
`window_table`, `window_digits` and `table_picks` are the windowed scalar
products of the fake setup (fixed base) and the prover's spec-point algebra.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import field as F
from .field import FP
from .limbs import N_LIMBS
from ..utils import hostmath as _host
from ..utils.hostmath import TWIST_B


# ---------------------------------------------------------------------------
# field backends on int64 limbs: Fp [..., 16] and Fp2 [..., 2, 16]
# ---------------------------------------------------------------------------

class FpVec:
    name = "Fp"
    comp_shape = (N_LIMBS,)

    @staticmethod
    def mul(a, b):
        return F.mont_mul(FP, a, b)

    @staticmethod
    def add(a, b):
        return F.add_mod(FP, a, b)

    @staticmethod
    def sub(a, b):
        return F.sub_mod(FP, a, b)

    @staticmethod
    def neg(a):
        return F.neg_mod(FP, a)

    @staticmethod
    def is_zero(a):
        return (F.as_i32(a) == 0).all(-1)

    @staticmethod
    def select(cond, a, b):
        return F.as_u32(torch.where(cond[..., None], F.as_i32(a), F.as_i32(b)))

    @staticmethod
    def const(x) -> np.ndarray:
        return FP.to_mont_limbs(x)


class Fp2Vec:
    """Fp2 = Fp[u]/(u^2+1), Karatsuba with the three Fp products stacked."""

    name = "Fp2"
    comp_shape = (2, N_LIMBS)

    @staticmethod
    def mul(a, b):
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        sa, sb = F.add_mod(FP, torch.stack([a0, b0]), torch.stack([a1, b1]))
        v0, v1, t = F.mont_mul(FP, torch.stack([a0, a1, sa]), torch.stack([b0, b1, sb]))
        c0, tv = F.sub_mod(FP, torch.stack([v0, t]), torch.stack([v1, v0]))
        return torch.stack([c0, F.sub_mod(FP, tv, v1)], -2)

    @staticmethod
    def add(a, b):
        return F.add_mod(FP, a, b)

    @staticmethod
    def sub(a, b):
        return F.sub_mod(FP, a, b)

    @staticmethod
    def neg(a):
        return F.neg_mod(FP, a)

    @staticmethod
    def is_zero(a):
        return (F.as_i32(a) == 0).all(-1).all(-1)

    @staticmethod
    def select(cond, a, b):
        return F.as_u32(torch.where(cond[..., None, None], F.as_i32(a), F.as_i32(b)))

    @staticmethod
    def const(x) -> np.ndarray:
        return np.stack([FP.to_mont_limbs(x[0]), FP.to_mont_limbs(x[1])])


@dataclass(frozen=True)
class CurveSpec:
    """One curve group: G1 over Fp or G2 over Fp2."""

    name: str

    @property
    def fops(self):
        return FpVec if self.name == "G1" else Fp2Vec

    @property
    def comp_shape(self):
        return self.fops.comp_shape

    @property
    def b(self):
        return 3 if self.name == "G1" else TWIST_B

    @functools.cached_property
    def b3_limbs(self) -> np.ndarray:
        b = self.b
        b3 = (3 * b) % FP.modulus if self.name == "G1" else (
            3 * b[0] % FP.modulus, 3 * b[1] % FP.modulus)
        return self.fops.const(b3)

    @functools.cached_property
    def one_limbs(self) -> np.ndarray:
        return self.fops.const(1 if self.name == "G1" else (1, 0))



G1 = CurveSpec("G1")
G2 = CurveSpec("G2")


def _i64(P):
    return tuple(F.i64(c) for c in P)


def _wire(P):
    return tuple(c.to(torch.uint32) for c in P)


def _bcast(*pts):
    shape = torch.broadcast_shapes(*(c.shape for P in pts for c in P))
    return tuple(tuple(c.expand(shape) for c in P) for P in pts)


# ---------------------------------------------------------------------------
# RCB15 formulas (a = 0), stage-stacked: bit-identical to the one-product-at-
# a-time sequence of curve.py::rcb_add in the JAX package and to
# csrc/bn254_curve.cuh, with a third of the tensor operations
# ---------------------------------------------------------------------------

def _st(*xs):
    return torch.stack(torch.broadcast_tensors(*xs))


def rcb_add(K, P, Q, b3):
    """Complete projective addition (RCB15 algorithm 7)."""
    (X1, Y1, Z1), (X2, Y2, Z2) = _bcast(P, Q)
    s = K.add(_st(X1, Y1, X1, X2, Y2, X2), _st(Y1, Z1, Z1, Y2, Z2, Z2))
    t0, t1, t2, t3, t4, X3 = K.mul(_st(X1, Y1, Z1, s[0], s[1], s[2]),
                                   _st(X2, Y2, Z2, s[3], s[4], s[5]))
    u = K.add(_st(t0, t1, t0, t0), _st(t1, t2, t2, t0))
    t3, t4, Y3 = K.sub(_st(t3, t4, X3), u[:3])
    t0 = K.add(u[3], t0)
    t2, Y3 = K.mul(_st(t2, Y3), b3)
    Z3 = K.add(t1, t2)
    t1 = K.sub(t1, t2)
    m = K.mul(_st(t4, t3, Y3, t1, t0, Z3), _st(Y3, t1, t0, Z3, t3, t4))
    Y3, Z3 = K.add(_st(m[3], m[5]), _st(m[2], m[4]))
    return (K.sub(m[1], m[0]), Y3, Z3)


def rcb_add_mixed(K, P, Q_affine, b3):
    """Projective + affine addition (RCB15 algorithm 8); the affine operand
    must not be infinity (callers select around (0, 0))."""
    (X1, Y1, Z1), (X2, Y2) = _bcast(P, Q_affine)
    s = K.add(_st(X2, X1), _st(Y2, Y1))
    t0, t1, t3, yz, xz, t2 = K.mul(_st(X1, Y1, s[0], Y2, X2, Z1),
                                   _st(X2, Y2, s[1], Z1, Z1, b3))
    u = K.add(_st(t0, yz, xz, t0, t1), _st(t1, Y1, X1, t0, t2))
    t4, Y3, Z3 = u[1], u[2], u[4]
    t3, t1 = K.sub(_st(t3, t1), _st(u[0], t2))
    t0 = K.add(u[3], t0)
    Y3 = K.mul(Y3, b3)
    m = K.mul(_st(t4, t3, Y3, t1, t0, Z3), _st(Y3, t1, t0, Z3, t3, t4))
    Y3, Z3 = K.add(_st(m[3], m[5]), _st(m[2], m[4]))
    return (K.sub(m[1], m[0]), Y3, Z3)


def rcb_double(K, P, b3):
    """Complete projective doubling (RCB15 algorithm 9)."""
    X, Y, Z = P
    t0, t1, xy, t2 = K.mul(_st(Y, Y, X, Z), _st(Y, Z, Y, Z))
    t2 = K.mul(t2, b3)
    z2 = K.add(t0, t0)
    z4, Y3, d2 = K.add(_st(z2, t0, t2), _st(z2, t2, t2))
    Z3, d3 = K.add(_st(z4, d2), _st(z4, t2))
    t0 = K.sub(t0, d3)
    m = K.mul(_st(t2, t1, t0, t0), _st(Z3, Z3, Y3, xy))
    X3, Y3 = K.add(_st(m[3], m[0]), _st(m[3], m[2]))
    return (X3, Y3, m[1])


def _b3(cv, device):
    return F.const(cv.b3_limbs, device)


def point_add_plain(cv: CurveSpec, P, Q):
    """Plain PyTorch version of K1's add (any device)."""
    return _wire(rcb_add(cv.fops, _i64(P), _i64(Q), _b3(cv, P[0].device)))


def point_double_plain(cv: CurveSpec, P):
    """Plain PyTorch version of K1's double (any device)."""
    return _wire(rcb_double(cv.fops, _i64(P), _b3(cv, P[0].device)))


def point_add(cv: CurveSpec, P, Q):
    """Batched complete addition: K1 on CUDA tensors, plain on CPU."""
    from . import kernels
    (P, Q) = _bcast(P, Q)
    if P[0].device.type == "cpu":
        return point_add_plain(cv, P, Q)
    return kernels.point_add(cv, P, Q)


def point_double_n_plain(cv: CurveSpec, P, k: int):
    """Plain PyTorch version of K1's doubling chain (any device): k times
    `point_double_plain`."""
    for _ in range(k):
        P = point_double_plain(cv, P)
    return tuple(P)


def point_double_n(cv: CurveSpec, P, k: int):
    """2^k P of a batch: one K1 launch on CUDA tensors, plain on CPU."""
    from . import kernels
    if P[0].device.type == "cpu":
        return point_double_n_plain(cv, P, k)
    return kernels.point_double_n(cv, P, k)


def point_double(cv: CurveSpec, P):
    """Batched complete doubling: `point_double_n` with k = 1."""
    return point_double_n(cv, P, 1)


def horner_plain(cv: CurveSpec, sums, c: int):
    """Plain PyTorch version of K1's Horner (any device): window sums
    [..., W, comp] -> sum_w 2^(c w) S_w of [..., comp], high window first:
    acc = S[W-1]; for w = W-2 .. 0: c doublings, then + S[w]."""
    axis = -1 - len(cv.comp_shape)
    W = sums[0].shape[axis]
    acc = tuple(s.select(axis, W - 1) for s in sums)
    for w in range(W - 2, -1, -1):
        acc = point_double_n_plain(cv, acc, c)
        acc = point_add_plain(cv, acc, tuple(s.select(axis, w) for s in sums))
    return tuple(acc)


def horner(cv: CurveSpec, sums, c: int):
    """Horner over window sums: one K1 launch on CUDA tensors, plain on CPU."""
    from . import kernels
    if sums[0].device.type == "cpu":
        kernels.horner_shape(cv, sums)
        return horner_plain(cv, sums, c)
    return kernels.horner(cv, sums, c)


def point_neg(cv: CurveSpec, P):
    X, Y, Z = P
    return (X, cv.fops.neg(Y), Z)


def point_select(cv: CurveSpec, cond, P, Q):
    return tuple(cv.fops.select(cond, p, q) for p, q in zip(*_bcast(P, Q)))


def inf_like(cv: CurveSpec, shape, device) -> tuple:
    """Batch of points at infinity (0 : 1 : 0), uint32 Montgomery limbs."""
    full = tuple(shape) + cv.comp_shape
    zero = torch.zeros(full, dtype=torch.uint32, device=device)
    one = F.const(cv.one_limbs, device).to(torch.uint32).expand(full)
    return (zero, one.contiguous(), zero.clone())


# ---------------------------------------------------------------------------
# affine conversions: (0, 0) <-> (0 : 1 : 0)
# ---------------------------------------------------------------------------

def from_affine(cv: CurveSpec, x, y):
    """Affine batch -> projective; (0, 0) maps to (0 : 1 : 0)."""
    K = cv.fops
    inf = K.is_zero(x) & K.is_zero(y)
    one = F.as_u32(F.const(cv.one_limbs, x.device).to(F.as_i32(x).dtype)).expand(x.shape)
    zero = torch.zeros_like(x)
    return (K.select(inf, zero, x), K.select(inf, one, y), K.select(inf, zero, one))


def to_affine(cv: CurveSpec, P):
    """Projective batch -> affine (x, y); infinity maps to (0, 0).  All Z
    share one batch inversion, as one limb-major row through
    `kernels_tree.invert`, and X and Y, stacked point-major, take their
    products with that row of inverses in one `kernels_tree.mul_rows`: on
    CUDA tensors kernels K6 and K5, on CPU tensors their plain versions (a
    batched Fermat ladder, Fp2 through the norm; plain products).  The
    inverse of Z = 0 is 0, so infinity needs no select: X * 0 = Y * 0 = 0."""
    from . import kernels_tree
    X, Y, Z = _wire(P)
    row = Z.reshape(-1, kernels_tree.ncomp(cv)).T.contiguous()
    zinv = kernels_tree.invert(cv, row)
    xy = F.as_u32(torch.stack([F.as_i32(X), F.as_i32(Y)]))
    x, y = kernels_tree.mul_rows(cv, xy, zinv, point_major=True)
    return x, y


# ---------------------------------------------------------------------------
# scalar multiplication and sums
# ---------------------------------------------------------------------------

def scalar_bits(scalars_std: torch.Tensor, nbits: int = 256) -> torch.Tensor:
    """[..., 16] standard-form limbs -> bool[nbits, ...] bit planes, LSB first."""
    s = F.i64(scalars_std)
    shifts = torch.arange(16, device=s.device)
    bits = (s[..., None] >> shifts) & 1                  # [..., 16 limbs, 16 bits]
    bits = bits.flatten(-2)[..., :nbits]
    return bits.movedim(-1, 0) > 0


def scalar_mul(cv: CurveSpec, scalars_std: torch.Tensor, P, nbits: int = 256):
    """Batched variable-base [k_i] P_i, right to left: one complete add and
    one doubling per bit, every step a K1 launch on CUDA tensors."""
    bits = scalar_bits(scalars_std, nbits)
    acc = inf_like(cv, scalars_std.shape[:-1], scalars_std.device)
    base = tuple(c.expand(acc[0].shape) for c in P)
    for i in range(nbits):
        acc = point_select(cv, bits[i], point_add(cv, acc, base), acc)
        if i + 1 < nbits:
            base = point_double(cv, base)
    return acc


def tree_sum(cv: CurveSpec, P):
    """Sum over the leading axis by pairwise halving; trailing batch dims
    ride along."""
    X, Y, Z = P
    n = X.shape[0]
    while n > 1:
        half = (n + 1) // 2
        if half * 2 > n:
            infs = inf_like(cv, (1,) + tuple(X.shape[1:X.ndim - len(cv.comp_shape)]),
                            X.device)
            X, Y, Z = (F.as_u32(torch.cat([F.as_i32(c), F.as_i32(i)], 0))
                       for c, i in zip((X, Y, Z), infs))
        X, Y, Z = point_add(cv, (X[:half], Y[:half], Z[:half]),
                            (X[half:], Y[half:], Z[half:]))
        n = half
    return (X[0], Y[0], Z[0])


def cat_points(parts) -> tuple:
    """Point batches concatenated along their leading axis."""
    return tuple(F.as_u32(torch.cat([F.as_i32(p[j]) for p in parts])) for j in range(3))


def multiples(cv: CurveSpec, P, bits: int) -> tuple:
    """[d P for d < 2^bits] of a point batch P [...] as [2^bits, ...]: row
    0 is infinity, row 1 is P, and each of bits - 1 rounds doubles the
    last power of two and adds it to every row so far (two K1 launches a
    round on CUDA tensors)."""
    batch = tuple(P[0].shape[:P[0].ndim - len(cv.comp_shape)])
    table = cat_points([inf_like(cv, (1,) + batch, P[0].device), tuple(c[None] for c in P)])
    pk = P
    for _ in range(1, bits):
        pk = point_double(cv, pk)
        table = cat_points([table, point_add(cv, table, tuple(c[None] for c in pk))])
    return table


def window_digits(scalars_std: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 [n, 256 // bits]: window w of each standard-form scalar
    (uint32 [n, 16]), bits [bits w, bits (w + 1)); `bits` divides 16."""
    s = F.i64(scalars_std)
    shifts = torch.arange(0, 16, bits, device=s.device)
    return ((s[..., None] >> shifts) & ((1 << bits) - 1)).reshape(s.shape[0], -1)


def window_table(cv: CurveSpec, point, bits: int, device) -> tuple:
    """The fixed-base table of a host point Q (affine ints, None =
    infinity): T[d, w] = d 2^(bits w) Q for d < 2^bits and the 256 / bits
    windows of a scalar, projective on `device`.  The window bases come
    from host doublings, the multiples from `multiples`."""
    add = _host.g1_add if cv.name == "G1" else _host.g2_add
    bases, b = [], point
    for _ in range(256 // bits):
        bases.append(b)
        for _ in range(bits):
            b = add(b, b)
    return multiples(cv, points_from_host(cv, bases, device), bits)


def table_picks(table, digits: torch.Tensor, windows) -> tuple:
    """T[digits[..., w], w] of a `window_table` for window indices
    `windows` that broadcast against `digits` (int64)."""
    return tuple(F.as_u32(F.as_i32(t)[digits, windows]) for t in table)


# ---------------------------------------------------------------------------
# host <-> device points
# ---------------------------------------------------------------------------

def points_from_host(cv: CurveSpec, pts, device) -> tuple:
    """Host affine points (ints / int pairs, None = infinity) -> projective."""
    n = len(pts)
    xs = np.zeros((n,) + cv.comp_shape, np.uint32)
    ys = np.zeros_like(xs)
    for i, pt in enumerate(pts):
        if pt is not None:
            xs[i] = cv.fops.const(pt[0])
            ys[i] = cv.fops.const(pt[1])
    return from_affine(cv, torch.from_numpy(xs).to(device),
                       torch.from_numpy(ys).to(device))


def points_to_host(cv: CurveSpec, P) -> list:
    """Projective batch -> host affine points (None = infinity)."""
    return affine_to_host(cv, *to_affine(cv, P))


def affine_to_host(cv: CurveSpec, x, y) -> list:
    """Affine batch ((0, 0) = infinity) -> host affine points (None = infinity)."""
    x = x.cpu().numpy().reshape((-1,) + cv.comp_shape)
    y = y.cpu().numpy().reshape((-1,) + cv.comp_shape)
    out = []
    for i in range(x.shape[0]):
        if not x[i].any() and not y[i].any():
            out.append(None)
        elif cv.name == "G1":
            out.append((FP.from_mont_limbs(x[i]), FP.from_mont_limbs(y[i])))
        else:
            out.append(((FP.from_mont_limbs(x[i][0]), FP.from_mont_limbs(x[i][1])),
                        (FP.from_mont_limbs(y[i][0]), FP.from_mont_limbs(y[i][1]))))
    return out
