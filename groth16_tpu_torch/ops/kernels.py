"""Launch wrappers of the point kernels (K1: add, doubling chain, Horner),
the segmented-fold kernel (K2) and the chained-product kernel (K9).

Counterpart of groth16_tpu/ops/kernels.py (`_point_call`, `_fold_call`) and
of the kernel of tools/bench_mul_kernels.py (`make_call`).
The wrappers here take CUDA tensors only: they check device, dtype, shape
and alignment, allocate outputs with `torch.empty`, launch on the current
stream, raise on a launch error, and count their launches
(`<wrapper>.launches`).  The plain PyTorch versions sit beside them:
`curve.point_add_plain` / `point_double_n_plain` / `horner_plain`,
`fold_level_plain` and `fp_mul_chain_plain` here; `curve.point_add` /
`point_double_n` / `horner`, `fold_level` and `fp_mul_chain` here dispatch
by the device of their input.
"""

from __future__ import annotations

import torch

from . import curve as C
from . import field as F
from . import cuda
from .field import FP

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


def _aligned(tensors) -> list:
    """Data pointers for K1's 128-bit loads and stores: 16-byte aligned or
    the call raises."""
    ptrs = [t.data_ptr() for t in tensors]
    if any(p % 16 for p in ptrs):
        raise ValueError("point kernel tensors must be 16-byte aligned")
    return ptrs


def _k1_launch(fn_name: str, cv, ins, out_shape, *tail):
    """Allocate three output coordinates, launch one K1 function on the
    current stream and raise on a launch error."""
    dev = ins[0].device
    outs = [torch.empty(out_shape, dtype=torch.uint32, device=dev) for _ in range(3)]
    rc = getattr(cuda.lib(), fn_name)(int(cv.name == "G2"), *_aligned(ins + outs), *tail,
                                      cuda.stream_ptr(dev))
    cuda.check(rc, f"{fn_name} kernel")
    return tuple(outs)


def point_add(cv: C.CurveSpec, P, Q):
    """K1 add: complete RCB15 addition of two same-shape CUDA point batches."""
    shape, n = _point_shape(cv, tuple(P) + tuple(Q))
    out = _k1_launch("g16_point_add", cv, _cuda_inputs(tuple(P) + tuple(Q)), shape, n)
    point_add.launches += 1
    return out


point_add.launches = 0


def point_double_n(cv: C.CurveSpec, P, k: int):
    """K1 doubling chain: 2^k P of a CUDA point batch in one launch (each
    thread doubles its point k times in registers; k = 1 is the doubling).
    Replaces groth16_tpu/ops/kernels.py:288 `_point_call` as the bucket
    reduce drives it (k traced calls in one program there); on the MSM's few
    points it is bound by the latency of one thread's k x 9 serial products.
    Plain version: `curve.point_double_n_plain`."""
    if k < 0:
        raise ValueError(f"point_double_n takes k >= 0, got {k}")
    shape, n = _point_shape(cv, tuple(P))
    out = _k1_launch("g16_point_double_n", cv, _cuda_inputs(tuple(P)), shape, n, k)
    point_double_n.launches += 1
    return out


point_double_n.launches = 0


def horner_shape(cv: C.CurveSpec, sums) -> tuple:
    """(batch shape, W) of window sums [..., W, comp]."""
    shape, _ = _point_shape(cv, tuple(sums))
    lead = tuple(shape[:len(shape) - len(cv.comp_shape)])
    if not lead or lead[-1] < 1:
        raise ValueError(f"horner takes {cv.name} sums of [..., W >= 1, comp], got {tuple(shape)}")
    return lead[:-1], lead[-1]


def horner(cv: C.CurveSpec, sums, c: int):
    """K1 Horner: sum_w 2^(c w) S_w of CUDA window sums [W, comp] (or
    [B, W, comp]: one thread per independent Horner) in one launch.
    Replaces groth16_tpu/ops/kernels.py:288 `_point_call` as
    groth16_tpu/ops/msm.py:515 `horner_combine` drives it (one `lax.scan` in
    one program there); bound on this card by the latency of one thread's
    (W - 1)(9 c + 14) serial products.  Plain version: `curve.horner_plain`."""
    if c < 0:
        raise ValueError(f"horner takes c >= 0, got {c}")
    batch, W = horner_shape(cv, sums)
    B = 1
    for d in batch:
        B *= d
    out = _k1_launch("g16_horner", cv, _cuda_inputs(tuple(sums)), batch + cv.comp_shape, B, W, c)
    horner.launches += 1
    return out


horner.launches = 0


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


def _chain_check(a: torch.Tensor, b: torch.Tensor, k: int) -> None:
    if a.shape != b.shape or a.ndim != 2 or a.shape[0] != 16 or k < 0:
        raise ValueError(f"fp_mul_chain takes two uint32[16, n] rows and k >= 0, "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}, k={k}")


def fp_mul_chain_kernel(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """K9 on CUDA tensors (see `fp_mul_chain_plain`)."""
    _chain_check(a, b, k)
    a, b = _cuda_inputs([a, b])
    out = torch.empty_like(a)
    rc = cuda.lib().g16_fp_mul_chain(a.data_ptr(), b.data_ptr(), out.data_ptr(), k,
                                     a.shape[1], cuda.stream_ptr(a.device))
    cuda.check(rc, "fp mul chain kernel")
    fp_mul_chain_kernel.launches += 1
    return out


fp_mul_chain_kernel.launches = 0


def fp_mul_chain_plain(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of K9 (any device): k chained Montgomery products
    x <- x * b * R^-1 mod p, x starting at a, of limb-major Fp elements
    uint32[16, n] (element i is column i)."""
    _chain_check(a, b, k)
    x, y = F.i64(a).T, F.i64(b).T
    for _ in range(k):
        x = F.mont_mul(FP, x, y)
    return x.T.to(torch.uint32).contiguous()


def fp_mul_chain(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """k chained Fp products: K9 on CUDA tensors, the plain version on CPU."""
    if a.device.type == "cpu":
        return fp_mul_chain_plain(a, b, k)
    return fp_mul_chain_kernel(a, b, k)
