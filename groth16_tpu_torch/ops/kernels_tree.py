"""One level of the batched-affine merge tree: kernels K4, K5, K6 and K8
(csrc/tree.cu), their plain PyTorch versions and `level`, one whole tree level.

Counterpart of groth16_tpu/ops/kernels_tree.py.  A level of K affine
additions mid = A.pR + B.pL is padded to a multiple of T_SLOTS * INV_W and
viewed as [R2, T_SLOTS, M] limb-major fused x|y columns (M = K / T_SLOTS
lanes, lane axis minor); (0, 0) is infinity.  The slope denominators of the
whole level share one batch inversion:

  K4 `phase_a`        per-lane product of the T_SLOTS masked denominators;
  K5 `mul_rows`       pairwise products that halve the totals down to
                      INV_MAXW lanes (and multiply back up afterwards);
  K6 `invert`         per-lane inverses of at most INV_MAXW totals;
  K8 `phase_b_level`  per-addition inverses, the affine additions and the
                      node updates PL', PR' and EM0.

Each kernel wrapper (`*_kernel`) takes CUDA tensors only and counts its
launches (`<wrapper>.launches`); the dispatchers without the suffix run the
plain version (`*_plain`) on CPU tensors.  Every value is a canonical
residue and inverses are unique, so kernel and plain version agree bit for
bit whatever order their products take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tnf

from . import cuda
from . import field as F
from .curve import CurveSpec
from .field import FP
from .kernels import _cuda_inputs

T_SLOTS = 16     # additions per lane (bn254_curve.cuh TREE_T)
INV_W = 128      # lanes of the inversion kernel (INV_W)
INV_MAXW = 2048  # widest totals row K6 takes (INV_W * INV_MAX_CHUNKS)


def ncomp(cv: CurveSpec) -> int:
    """uint32 words per field element: 16 (Fp) / 32 (Fp2)."""
    return 16 if cv.name == "G1" else 32


def _g2(cv: CurveSpec) -> int:
    return int(cv.name == "G2")


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _elems(cv: CurveSpec, x: torch.Tensor) -> torch.Tensor:
    """uint32 limb-major [ncomp, ...] -> int64 field elements [..., comp]."""
    lead = tuple(x.shape[1:])
    return F.i64(x).movedim(0, -1).reshape(lead + cv.comp_shape)


def _limb_major(cv: CurveSpec, e: torch.Tensor) -> torch.Tensor:
    """int64 field elements [..., comp] -> uint32 limb-major [ncomp, ...]."""
    lead = tuple(e.shape[:e.ndim - len(cv.comp_shape)])
    return e.reshape(lead + (-1,)).movedim(-1, 0).to(torch.uint32).contiguous()


def _eq(cv: CurveSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).flatten(a.ndim - len(cv.comp_shape)).all(-1)


def _slots(cv: CurveSpec, apr: torch.Tensor, bpl: torch.Tensor):
    """Every slot's operands, group-law cases and masked denominator."""
    K = cv.fops
    nc = ncomp(cv)
    x1, y1 = _elems(cv, apr[:nc]), _elems(cv, apr[nc:])
    x2, y2 = _elems(cv, bpl[:nc]), _elems(cv, bpl[nc:])
    i1 = K.is_zero(x1) & K.is_zero(y1)
    i2 = K.is_zero(x2) & K.is_zero(y2)
    eqx, eqy = _eq(cv, x1, x2), _eq(cv, y1, y2)
    dbl = eqx & eqy & ~i1
    one = F.const(cv.one_limbs, apr.device).expand(x1.shape)
    den = K.select(dbl, K.add(y1, y1), K.sub(x2, x1))
    den = K.select((eqx & ~eqy) | i1 | i2, one, den)
    return (x1, y1, x2, y2, i1, i2, eqx, eqy, dbl), den, one


def _inclusive_products(K, d: torch.Tensor) -> torch.Tensor:
    """Running products along axis 0 (log-depth, Hillis-Steele)."""
    n, s = d.shape[0], 1
    while s < n:
        d = torch.cat([d[:s], K.mul(d[s:], d[:n - s])], 0)
        s *= 2
    return d


def phase_a_plain(cv: CurveSpec, apr: torch.Tensor, bpl: torch.Tensor) -> torch.Tensor:
    """Plain K4: uint32[R2, T, M] x2 -> per-lane denominator products [R, M]."""
    _, den, _ = _slots(cv, apr, bpl)
    return _limb_major(cv, _inclusive_products(cv.fops, den)[-1])


def mul_rows_plain(cv: CurveSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain K5: elementwise products of two uint32[R, W] rows."""
    return _limb_major(cv, cv.fops.mul(_elems(cv, a), _elems(cv, b)))


def invert_plain(cv: CurveSpec, tots: torch.Tensor) -> torch.Tensor:
    """Plain K6: per-lane inverses of nonzero uint32[R, M] totals (Fermat;
    Fp2 through the norm)."""
    e = _elems(cv, tots)
    if cv.name == "G1":
        return _limb_major(cv, F.inv_mod(FP, e))
    d0, d1 = e[..., 0, :], e[..., 1, :]
    n0, n1 = F.mont_mul(FP, torch.stack([d0, d1]), torch.stack([d0, d1]))
    a, b = F.mont_mul(FP, torch.stack([d0, d1]), F.inv_mod(FP, F.add_mod(FP, n0, n1)))
    return _limb_major(cv, torch.stack([a, F.neg_mod(FP, b)], -2))


def phase_b_level_plain(cv: CurveSpec, apl, apr, bpl, bpr, flg, tinv, want_em: bool):
    """Plain K8: the level's affine additions and node updates.  Point planes
    uint32[R2, T, M], flg int32[T, M] (bit 0 keys match, 1 A pure, 2 B pure),
    tinv uint32[R, M] the inverse of each lane's denominator product.
    Returns (PL', PR', EM0), EM0 None unless `want_em`."""
    K = cv.fops
    (x1, y1, x2, y2, i1, i2, eqx, eqy, dbl), den, one = _slots(cv, apr, bpl)
    # 1/den[t] = tinv * (product of the lane's other denominators)
    pre = torch.cat([one[:1], _inclusive_products(K, den)[:-1]], 0)
    suf = _inclusive_products(K, den.flip(0)).flip(0)
    suf = torch.cat([suf[1:], one[:1]], 0)
    inv = K.mul(K.mul(pre, suf), _elems(cv, tinv)[None])
    x1sq = K.mul(x1, x1)
    num = K.select(dbl, K.add(K.add(x1sq, x1sq), x1sq), K.sub(y2, y1))
    lam = K.mul(num, inv)
    x3 = K.sub(K.sub(K.mul(lam, lam), x1), x2)
    y3 = K.sub(K.mul(lam, K.sub(x1, x3)), y1)
    cancel = eqx & ~eqy
    zero = torch.zeros_like(x3)
    x3 = K.select(i2, x1, K.select(i1, x2, K.select(cancel, zero, x3)))
    y3 = K.select(i2, y1, K.select(i1, y2, K.select(cancel, zero, y3)))
    mid = F.as_i32(torch.cat([_limb_major(cv, x3), _limb_major(cv, y3)], 0))
    match, aP, bP = (flg & 1) != 0, (flg & 2) != 0, (flg & 4) != 0

    def sel(cond, other):
        return F.as_u32(torch.where(cond[None], mid, F.as_i32(other)))

    return (sel(match & aP, apl), sel(match & bP, bpr),
            sel(match, apr) if want_em else None)


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _plane_check(cv: CurveSpec, *planes) -> tuple:
    R2 = 2 * ncomp(cv)
    shape = tuple(planes[0].shape)
    if len(shape) != 3 or shape[0] != R2 or shape[1] != T_SLOTS:
        raise ValueError(f"{cv.name} tree planes must be [{R2}, {T_SLOTS}, M], got {shape}")
    if any(tuple(p.shape) != shape for p in planes):
        raise ValueError("tree planes must share one shape")
    return shape


def phase_a_kernel(cv: CurveSpec, apr: torch.Tensor, bpl: torch.Tensor) -> torch.Tensor:
    """K4 (see `phase_a_plain`)."""
    _, _, M = _plane_check(cv, apr, bpl)
    apr, bpl = _cuda_inputs([apr, bpl])
    tot = torch.empty((ncomp(cv), M), dtype=torch.uint32, device=apr.device)
    rc = cuda.lib().g16_tree_phase_a(_g2(cv), apr.data_ptr(), bpl.data_ptr(), tot.data_ptr(),
                                     M, cuda.stream_ptr(apr.device))
    cuda.check(rc, "tree phase A kernel")
    phase_a_kernel.launches += 1
    return tot


phase_a_kernel.launches = 0


def mul_rows_kernel(cv: CurveSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K5 (see `mul_rows_plain`)."""
    if a.shape != b.shape or a.ndim != 2 or a.shape[0] != ncomp(cv):
        raise ValueError(f"mul_rows takes two [{ncomp(cv)}, W] rows")
    a, b = _cuda_inputs([a, b])
    out = torch.empty_like(a)
    rc = cuda.lib().g16_tree_mul_rows(_g2(cv), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                      a.shape[1], cuda.stream_ptr(a.device))
    cuda.check(rc, "tree mul_rows kernel")
    mul_rows_kernel.launches += 1
    return out


mul_rows_kernel.launches = 0


def invert_kernel(cv: CurveSpec, tots: torch.Tensor) -> torch.Tensor:
    """K6 (see `invert_plain`); M a multiple of INV_W, at most INV_MAXW."""
    M = tots.shape[-1]
    if tots.ndim != 2 or tots.shape[0] != ncomp(cv) or M % INV_W or M > INV_MAXW:
        raise ValueError(f"invert takes [{ncomp(cv)}, M], M a multiple of {INV_W} "
                         f"<= {INV_MAXW}, got {tuple(tots.shape)}")
    (tots,) = _cuda_inputs([tots])
    inv = torch.empty_like(tots)
    rc = cuda.lib().g16_tree_invert(_g2(cv), tots.data_ptr(), inv.data_ptr(), M,
                                    cuda.stream_ptr(tots.device))
    cuda.check(rc, "tree invert kernel")
    invert_kernel.launches += 1
    return inv


invert_kernel.launches = 0


def phase_b_level_kernel(cv: CurveSpec, apl, apr, bpl, bpr, flg, tinv, want_em: bool):
    """K8 (see `phase_b_level_plain`)."""
    shape = _plane_check(cv, apl, apr, bpl, bpr)
    M = shape[2]
    if tuple(flg.shape) != (T_SLOTS, M) or tuple(tinv.shape) != (ncomp(cv), M):
        raise ValueError("flags must be [T, M] and lane inverses [R, M]")
    apl, apr, bpl, bpr, tinv = _cuda_inputs([apl, apr, bpl, bpr, tinv])
    (flg,) = _cuda_inputs([flg], torch.int32)
    outs = [torch.empty(shape, dtype=torch.uint32, device=apl.device)
            for _ in range(3 if want_em else 2)]
    em = outs[2].data_ptr() if want_em else None
    rc = cuda.lib().g16_tree_phase_b(_g2(cv), apl.data_ptr(), apr.data_ptr(), bpl.data_ptr(),
                                     bpr.data_ptr(), flg.data_ptr(), tinv.data_ptr(),
                                     outs[0].data_ptr(), outs[1].data_ptr(), em, M,
                                     cuda.stream_ptr(apl.device))
    cuda.check(rc, "tree phase B kernel")
    phase_b_level_kernel.launches += 1
    return outs[0], outs[1], (outs[2] if want_em else None)


phase_b_level_kernel.launches = 0


# ---------------------------------------------------------------------------
# dispatch by device, and one whole level
# ---------------------------------------------------------------------------

def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def phase_a(cv, apr, bpl):
    return phase_a_plain(cv, apr, bpl) if _on_cpu(apr) else phase_a_kernel(cv, apr, bpl)


def mul_rows(cv, a, b):
    return mul_rows_plain(cv, a, b) if _on_cpu(a) else mul_rows_kernel(cv, a, b)


def invert(cv, tots):
    return invert_plain(cv, tots) if _on_cpu(tots) else invert_kernel(cv, tots)


def phase_b_level(cv, apl, apr, bpl, bpr, flg, tinv, want_em):
    fn = phase_b_level_plain if _on_cpu(apl) else phase_b_level_kernel
    return fn(cv, apl, apr, bpl, bpr, flg, tinv, want_em)


def invert_rows(cv: CurveSpec, tots: torch.Tensor) -> torch.Tensor:
    """Inverses of uint32[R, M] lane totals: product-tree halvings (K5) down
    to INV_MAXW lanes, one K6, then the mirrored walk back up (K5)."""
    stack = []
    x = tots
    while x.shape[-1] > INV_MAXW and (x.shape[-1] // 2) % INV_W == 0:
        w = x.shape[-1] // 2
        stack.append(x)
        x = mul_rows(cv, x[:, :w], x[:, w:])
    inv = invert(cv, x)
    for lv in reversed(stack):
        w = lv.shape[-1] // 2
        inv = F.as_u32(torch.cat([F.as_i32(mul_rows(cv, inv, lv[:, w:])),
                                  F.as_i32(mul_rows(cv, inv, lv[:, :w]))], -1))
    return inv


def level(cv: CurveSpec, A_pl, A_pr, B_pl, B_pr, match, aP, bP, want_em: bool):
    """One tree level (groth16_tpu/ops/kernels_tree.py::level_pallas): point
    columns uint32[R2, K], bool[K] flag planes.  Returns (PL', PR', EM0) as
    uint32[R2, K], EM0 None unless `want_em` (level 1 never emits)."""
    R2, K = A_pl.shape
    tile = T_SLOTS * INV_W
    Kp = -(-K // tile) * tile
    M = Kp // T_SLOTS

    def planes(x):   # pad with (0, 0) additions: den 1, mid (0, 0)
        return F.as_u32(tnf.pad(F.as_i32(x), (0, Kp - K)).reshape(R2, T_SLOTS, M))

    flg = match.to(torch.int32) | (aP.to(torch.int32) << 1) | (bP.to(torch.int32) << 2)
    flg = tnf.pad(flg, (0, Kp - K)).reshape(T_SLOTS, M)
    apl, apr, bpl, bpr = (planes(x) for x in (A_pl, A_pr, B_pl, B_pr))
    tinv = invert_rows(cv, phase_a(cv, apr, bpl))
    outs = phase_b_level(cv, apl, apr, bpl, bpr, flg, tinv, want_em)
    return tuple(None if o is None else o.reshape(R2, Kp)[:, :K] for o in outs)
