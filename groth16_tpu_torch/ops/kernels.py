"""Launch wrappers of the point kernel (K1) and the segmented-fold kernel (K2).

Counterpart of groth16_tpu/ops/kernels.py (`_point_call`, `_fold_call`).
The wrappers here take CUDA tensors only: they check device, dtype and
shape, allocate outputs with `torch.empty`, launch on the current stream,
raise on a launch error, and count their launches (`<wrapper>.launches`).
The plain PyTorch versions sit beside them: `curve.point_add_plain` /
`point_double_plain` and `fold_level_plain` here; `curve.point_add` /
`point_double` and `fold_level` here dispatch by the device of their input.
"""

from __future__ import annotations

import torch

from . import curve as C
from . import field as F
from . import cuda

FOLD_T = 32  # sequential elements per lane at level 0


def _cuda_inputs(tensors, dtype=torch.uint32):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got {dev}")
    out = []
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"expected {dtype} on {dev}, got {t.dtype} on {t.device}")
        out.append(t.contiguous())
    return out


def _point_shape(cv, P):
    shape = P[0].shape
    nc = len(cv.comp_shape)
    if tuple(shape[len(shape) - nc:]) != cv.comp_shape or any(c.shape != shape for c in P):
        raise ValueError(f"{cv.name} coordinates must share a [..., {cv.comp_shape}] shape")
    n = 1
    for d in shape[:len(shape) - nc]:
        n *= d
    return shape, n


def point_add(cv: C.CurveSpec, P, Q):
    """K1 add: complete RCB15 addition of two same-shape CUDA point batches."""
    shape, n = _point_shape(cv, tuple(P) + tuple(Q))
    ins = _cuda_inputs(tuple(P) + tuple(Q))
    outs = [torch.empty(shape, dtype=torch.uint32, device=ins[0].device) for _ in range(3)]
    rc = cuda.lib().g16_point_add(int(cv.name == "G2"), *(t.data_ptr() for t in ins + outs),
                                  n, cuda.stream_ptr(ins[0].device))
    cuda.check(rc, "point_add kernel")
    point_add.launches += 1
    return tuple(outs)


point_add.launches = 0


def point_double(cv: C.CurveSpec, P):
    """K1 double: complete RCB15 doubling of a CUDA point batch."""
    shape, n = _point_shape(cv, tuple(P))
    ins = _cuda_inputs(tuple(P))
    outs = [torch.empty(shape, dtype=torch.uint32, device=ins[0].device) for _ in range(3)]
    rc = cuda.lib().g16_point_double(int(cv.name == "G2"), *(t.data_ptr() for t in ins + outs),
                                     n, cuda.stream_ptr(ins[0].device))
    cuda.check(rc, "point_double kernel")
    point_double.launches += 1
    return tuple(outs)


point_double.launches = 0


def fold_rows(cv) -> int:
    """Wire words per projective point: 3 coordinates x 16 (G1) or 32 (G2)."""
    return 48 if cv.name == "G1" else 96


def _fold_check(cv, kT, pT, affine):
    T, lanes = kT.shape
    nc = fold_rows(cv) // 3
    rin = (2 if affine else 3) * nc
    if pT.shape != (T, rin, lanes):
        raise ValueError(f"pT must be [T={T}, {rin}, lanes={lanes}], got {tuple(pT.shape)}")
    return T, lanes


def fold_level_kernel(cv: C.CurveSpec, kT: torch.Tensor, pT: torch.Tensor,
                      affine: bool = False):
    """K2: one fold level over CUDA tensors (see `fold_level_plain`)."""
    T, lanes = _fold_check(cv, kT, pT, affine)
    (kT,) = _cuda_inputs([kT], torch.int32)
    (pT,) = _cuda_inputs([pT])
    R = fold_rows(cv)
    emit = torch.empty((T, R, lanes), dtype=torch.uint32, device=pT.device)
    trail = torch.empty((R, lanes), dtype=torch.uint32, device=pT.device)
    rc = cuda.lib().g16_fold(int(cv.name == "G2"), int(affine), kT.data_ptr(), pT.data_ptr(),
                             emit.data_ptr(), trail.data_ptr(), T, lanes,
                             cuda.stream_ptr(pT.device))
    cuda.check(rc, "fold kernel")
    fold_level_kernel.launches += 1
    return emit, trail


fold_level_kernel.launches = 0


def fold_level_plain(cv: C.CurveSpec, kT: torch.Tensor, pT: torch.Tensor,
                     affine: bool = False):
    """Plain PyTorch version of K2 (any device).

    kT int32[T, lanes]: digit-sorted signed keys per lane; bucket identity is
    |key| and a negative key negates y.  pT uint32[T, Rin, lanes]: the lane
    streams as fused limb rows, x|y (affine, (0, 0) = infinity, mixed
    addition) or x|y|z.  Returns emit uint32[T, R, lanes], where emit[t] is
    each lane's running segment just before element t (emit[0] = infinity),
    and trail uint32[R, lanes], the running segment after the last element.
    """
    T, lanes = _fold_check(cv, kT, pT, affine)
    K = cv.fops
    comp = cv.comp_shape
    nc = fold_rows(cv) // 3
    pts = F.i64(pT).permute(0, 2, 1)                      # [T, lanes, Rin]

    def coord(j):
        return pts[:, :, j * nc:(j + 1) * nc].reshape((T, lanes) + comp)

    x, y = coord(0), coord(1)
    y = K.select(kT < 0, K.neg(y), y)
    b3 = F.const(cv.b3_limbs, pT.device)
    if affine:
        inf = (pts[:, :, :2 * nc] == 0).all(-1)
        one = F.const(cv.one_limbs, pT.device).expand(x.shape)
        zero = torch.zeros_like(x)
        fresh = (K.select(inf, zero, x), K.select(inf, one, y), K.select(inf, zero, one))
    else:
        fresh = (x, y, coord(2))
    ak = kT.abs()
    run = tuple(c[0] for c in fresh)
    emit = [tuple(F.i64(c) for c in C.inf_like(cv, (lanes,), pT.device))]
    for t in range(1, T):
        emit.append(run)
        if affine:
            added = C.rcb_add_mixed(K, run, (x[t], y[t]), b3)
            added = tuple(K.select(inf[t], r, a) for r, a in zip(run, added))
        else:
            added = C.rcb_add(K, run, tuple(c[t] for c in fresh), b3)
        new = ak[t] != ak[t - 1]
        run = tuple(K.select(new, f[t], a) for f, a in zip(fresh, added))

    def rows(P):   # (X, Y, Z) [..., lanes, comp] -> [..., R, lanes]
        fused = torch.cat([F.i64(c).flatten(-len(comp)) for c in P], -1)
        return fused.transpose(-1, -2).to(torch.uint32)

    emit_t = rows(tuple(torch.stack([e[j] for e in emit]) for j in range(3)))
    return emit_t.contiguous(), rows(run).contiguous()


def fold_level(cv: C.CurveSpec, kT: torch.Tensor, pT: torch.Tensor,
               affine: bool = False):
    """One fold level: K2 on CUDA tensors, the plain version on CPU."""
    if pT.device.type == "cpu":
        return fold_level_plain(cv, kT, pT, affine)
    return fold_level_kernel(cv, kT, pT, affine)
