"""One level of the batched-affine merge tree: kernels K4, K5, K6, K7 and K8
(csrc/tree.cu), their plain PyTorch versions, `level`, one whole tree level,
and `mid`, one batch of affine additions.

Counterpart of groth16_tpu/ops/kernels_tree.py.  A level is K affine
additions mid = A.pR + B.pL on limb-major fused x|y columns uint32[R2, K]
((0, 0) is infinity) whose slope denominators share one batch inversion:

  K8 `level_kernel`   the whole level in ONE launch: blocks of 128 threads x
                      4 additions, each block its own batch inversion, then
                      the additions and the node updates PL', PR' and EM0;
                      it reads the four operand columns where they lie
                      (views at one limb stride);
  K6 `invert`         inverses of any number M >= 1 of totals in one launch
                      (0 gives 0); `curve.to_affine` inverts its Z with it;
  K4 `phase_a`        per-lane product of T_SLOTS masked denominators, on
                      the additions padded and viewed as [R2, T_SLOTS, M]
                      planes (M = K / T_SLOTS lanes, lane axis minor), one
                      thread a slot and each lane's product tree in shared
                      memory;
  K7 `phase_b`        the mids alone on those planes, given the lane
                      inverses, one thread an addition and each lane's
                      inverses through a product tree in shared memory
                      (`mid`, which only tools/bench_tree_phases.py calls,
                      through `mid_planes`: K4, K6, K7);
  K5 `mul_rows`       elementwise products a[w] * b[w mod Wb] of operands
                      where they lie (limb-major rows and column slices,
                      point-major arrays): `curve.to_affine`'s X and Y times
                      the Z inverses in one launch, and the halvings of a
                      product tree that tools/bench_tree_phases.py times
                      beside the one wide K6 launch.

`level_plain` composes the plain K4, K6 and the plain additions with node
updates (`phase_b_level_plain`) on the planes.  Each kernel wrapper
(`*_kernel`) takes CUDA tensors only and counts its launches
(`<wrapper>.launches`); the dispatchers without the suffix run the plain
version (`*_plain`) on CPU tensors.  Every value is a canonical residue and
inverses are unique, so kernel and plain version agree bit for bit whatever
order their products take.
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
INV_W = 128      # threads of a K6 block (INV_THREADS); each chains 4 totals
PLAIN_LANES = 8192  # lanes per slice of the plain K4 and K7
PLAIN_COLS = T_SLOTS * PLAIN_LANES  # additions per slice of `level_plain`


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
    """Plain K4: uint32[R2, T, M] x2 -> per-lane denominator products [R, M],
    in slices of PLAIN_LANES lanes on wide planes (as `phase_b_plain`)."""
    M = apr.shape[2]
    if M > PLAIN_LANES:
        return torch.cat([phase_a_plain(cv, apr[:, :, s:s + PLAIN_LANES],
                                        bpl[:, :, s:s + PLAIN_LANES])
                          for s in range(0, M, PLAIN_LANES)], 1)
    _, den, _ = _slots(cv, apr, bpl)
    return _limb_major(cv, _inclusive_products(cv.fops, den)[-1])


def mul_rows_plain(cv: CurveSpec, a: torch.Tensor, b: torch.Tensor, out=None,
                   point_major: bool = False) -> torch.Tensor:
    """Plain K5 (see `mul_rows`): out[w] = a[w] * b[w mod Wb]."""
    (W, _, _), (Wb, _, _) = _mul_rows_check(cv, a, b, out, point_major)
    ea = F.i64(a).reshape((W,) + cv.comp_shape) if point_major else _elems(cv, a)
    eb = _elems(cv, b)
    if Wb != W:
        eb = eb.repeat((W // Wb,) + (1,) * len(cv.comp_shape))
    prod = cv.fops.mul(ea, eb)
    res = prod.to(torch.uint32).reshape(a.shape) if point_major else _limb_major(cv, prod)
    if out is None:
        return res
    F.as_i32(out).copy_(F.as_i32(res))
    return out


def invert_plain(cv: CurveSpec, tots: torch.Tensor) -> torch.Tensor:
    """Plain K6: per-lane inverses of uint32[R, M] totals, 0 for 0 (Fermat;
    Fp2 through the norm)."""
    e = _elems(cv, tots)
    if cv.name == "G1":
        return _limb_major(cv, F.inv_mod(FP, e))
    d0, d1 = e[..., 0, :], e[..., 1, :]
    n0, n1 = F.mont_mul(FP, torch.stack([d0, d1]), torch.stack([d0, d1]))
    a, b = F.mont_mul(FP, torch.stack([d0, d1]), F.inv_mod(FP, F.add_mod(FP, n0, n1)))
    return _limb_major(cv, torch.stack([a, F.neg_mod(FP, b)], -2))


def phase_b_plain(cv: CurveSpec, apr, bpl, tinv) -> torch.Tensor:
    """Plain K7: mid = A.pR + B.pL of every slot, uint32[R2, T, M], from the
    point planes uint32[R2, T, M] and tinv uint32[R, M], the inverse of each
    lane's denominator product.  Lanes are independent, so wide levels run
    in slices of PLAIN_LANES lanes, which bounds the int64 intermediates."""
    M = apr.shape[2]
    if M > PLAIN_LANES:
        return torch.cat([phase_b_plain(cv, apr[:, :, s:s + PLAIN_LANES],
                                        bpl[:, :, s:s + PLAIN_LANES], tinv[:, s:s + PLAIN_LANES])
                          for s in range(0, M, PLAIN_LANES)], 2)
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
    return torch.cat([_limb_major(cv, x3), _limb_major(cv, y3)], 0)


def phase_b_level_plain(cv: CurveSpec, apl, apr, bpl, bpr, flg, tinv, want_em: bool):
    """The level's affine additions (`phase_b_plain`) and node updates, on
    point planes uint32[R2, T, M], flg int32[T, M] (bit 0 keys match, 1 A
    pure, 2 B pure), tinv uint32[R, M].  Returns (PL', PR', EM0), EM0 None
    unless `want_em`."""
    mid = F.as_i32(phase_b_plain(cv, apr, bpl, tinv))
    match, aP, bP = (flg & 1) != 0, (flg & 2) != 0, (flg & 4) != 0

    def sel(cond, other):
        return F.as_u32(torch.where(cond[None], mid, F.as_i32(other)))

    return (sel(match & aP, apl), sel(match & bP, bpr),
            sel(match, apr) if want_em else None)


def _tiles(K: int) -> int:
    """K additions padded to whole lanes of T_SLOTS."""
    return -(-K // T_SLOTS) * T_SLOTS


def _planes(x: torch.Tensor, Kp: int) -> torch.Tensor:
    """uint32[R2, K] columns -> [R2, T_SLOTS, Kp / T_SLOTS] planes, padded
    with (0, 0) additions (den 1, mid (0, 0))."""
    R2, K = x.shape
    return F.as_u32(tnf.pad(F.as_i32(x), (0, Kp - K)).reshape(R2, T_SLOTS, Kp // T_SLOTS))


def level_plain(cv: CurveSpec, A_pl, A_pr, B_pl, B_pr, match, aP, bP, want_em: bool):
    """Plain K8 (any device): one tree level (see `level`) as the plain K4,
    K6 and `phase_b_level_plain` on planes padded to whole lanes.  Levels
    wider than PLAIN_COLS run in column slices (each slice's lanes invert on
    their own), which bounds the int64 intermediates."""
    R2, K = A_pl.shape
    if K > PLAIN_COLS:
        parts = [level_plain(cv, *(x[:, s:s + PLAIN_COLS] for x in (A_pl, A_pr, B_pl, B_pr)),
                             *(f[s:s + PLAIN_COLS] for f in (match, aP, bP)), want_em)
                 for s in range(0, K, PLAIN_COLS)]
        return tuple(None if p[0] is None else F.as_u32(torch.cat([F.as_i32(x) for x in p], 1))
                     for p in zip(*parts))
    Kp = _tiles(K)
    flg = match.to(torch.int32) | (aP.to(torch.int32) << 1) | (bP.to(torch.int32) << 2)
    flg = tnf.pad(flg, (0, Kp - K)).reshape(T_SLOTS, Kp // T_SLOTS)
    apl, apr, bpl, bpr = (_planes(x, Kp) for x in (A_pl, A_pr, B_pl, B_pr))
    tinv = invert_plain(cv, phase_a_plain(cv, apr, bpl))
    outs = phase_b_level_plain(cv, apl, apr, bpl, bpr, flg, tinv, want_em)
    return tuple(None if o is None else o.reshape(R2, Kp)[:, :K].contiguous() for o in outs)


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
    """K4 (see `phase_a_plain`): blocks of 32 lanes (G1; 16 in G2) x
    T_SLOTS slots, one thread a slot, each lane's denominators multiplied up
    a product tree in shared memory.  Replaces
    groth16_tpu/ops/kernels_tree.py:120 `_phase_a_call`; bound by the bytes
    of the two operand points of each slot, read once (csrc/tree.cu)."""
    _, _, M = _plane_check(cv, apr, bpl)
    apr, bpl = _cuda_inputs([apr, bpl])
    tot = torch.empty((ncomp(cv), M), dtype=torch.uint32, device=apr.device)
    rc = cuda.lib().g16_tree_phase_a(_g2(cv), apr.data_ptr(), bpl.data_ptr(), tot.data_ptr(),
                                     M, cuda.stream_ptr(apr.device))
    cuda.check(rc, "tree phase A kernel")
    phase_a_kernel.launches += 1
    return tot


phase_a_kernel.launches = 0


def _mul_rows_operand(cv: CurveSpec, x: torch.Tensor, point_major: bool) -> tuple:
    """(W, limb stride, column stride) in words of a K5 operand as it lies:
    a limb-major row uint32[NC, W] at any strides (a column slice, a
    transposed point-major array), or, `point_major`, an array [..., *comp]
    whose leading axes fold into one column stride, its words at one limb
    stride (in G2 c1 sixteen limbs after c0).  Raises on anything else."""
    nc, k = ncomp(cv), len(cv.comp_shape)
    if not point_major:
        if x.ndim != 2 or x.shape[0] != nc:
            raise ValueError(f"{cv.name} rows must be [{nc}, W], got {tuple(x.shape)}")
        ls, cs, W = x.stride(0), x.stride(1), x.shape[1]
    else:
        if x.ndim < k or tuple(x.shape[x.ndim - k:]) != cv.comp_shape:
            raise ValueError(f"{cv.name} points must be [..., {cv.comp_shape}], "
                             f"got {tuple(x.shape)}")
        ls = x.stride(-1)
        if k == 2 and x.stride(-2) != 16 * ls:
            raise ValueError(f"G2 points need c1 16 limbs after c0, got strides {x.stride()}")
        lead = [(n, st) for n, st in zip(x.shape[:x.ndim - k], x.stride()[:x.ndim - k]) if n != 1]
        if any(s0 != n1 * s1 for (_, s0), (n1, s1) in zip(lead, lead[1:])):
            raise ValueError(f"point axes {tuple(x.shape)} at strides {x.stride()} do not fold "
                             "into one column stride")
        W = x.numel() // nc
        cs = lead[-1][1] if lead else nc * ls
    if ls == 0:
        raise ValueError("a K5 operand needs a nonzero limb stride")
    return W, ls, cs


def _mul_rows_check(cv: CurveSpec, a, b, out, point_major: bool) -> tuple:
    """`_mul_rows_operand` of a and of b in a K5 call, checked: b's width
    divides a's (W products), and out, if given, has a's shape."""
    ga, gb = _mul_rows_operand(cv, a, point_major), _mul_rows_operand(cv, b, False)
    if gb[0] < 1 or ga[0] % gb[0]:
        raise ValueError(f"b's width {gb[0]} must divide a's {ga[0]}")
    if out is not None and out.shape != a.shape:
        raise ValueError(f"out must be {tuple(a.shape)}, got {tuple(out.shape)}")
    return ga, gb


def mul_rows_kernel(cv: CurveSpec, a: torch.Tensor, b: torch.Tensor, out=None,
                    point_major: bool = False) -> torch.Tensor:
    """K5 (see `mul_rows`): one launch, every operand read or written where
    it lies (strides checked, nothing copied).  Replaces
    groth16_tpu/ops/kernels_tree.py:166 `_mul_rows_call`; bound by the bytes
    of its operands, or at the proof's width by one launch (csrc/tree.cu)."""
    (W, als, acs), (Wb, bls, bcs) = _mul_rows_check(cv, a, b, out, point_major)
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got {dev}")
    if out is None:
        out = torch.empty(a.shape, dtype=torch.uint32, device=dev)
    for t in (a, b, out):
        if t.device != dev or t.dtype != torch.uint32:
            raise ValueError(f"expected uint32 on {dev}, got {t.dtype} on {t.device}")
    _, ols, ocs = _mul_rows_operand(cv, out, point_major)
    if W > 1 and ocs == 0:
        raise ValueError("out needs a nonzero column stride")
    if W:
        rc = cuda.lib().g16_tree_mul_rows(_g2(cv), a.data_ptr(), als, acs, b.data_ptr(), bls,
                                          bcs, Wb, out.data_ptr(), ols, ocs, W,
                                          cuda.stream_ptr(dev))
        cuda.check(rc, "tree mul_rows kernel")
        mul_rows_kernel.launches += 1
    return out


mul_rows_kernel.launches = 0


def invert_kernel(cv: CurveSpec, tots: torch.Tensor) -> torch.Tensor:
    """K6 (see `invert_plain`): any M, one launch of ceil(M / (4 * INV_W))
    blocks with one inversion each.  Replaces
    groth16_tpu/ops/kernels_tree.py:202 `_invert_call`; bound by the latency
    of one inversion and two short product chains (csrc/tree.cu)."""
    M = tots.shape[-1]
    if tots.ndim != 2 or tots.shape[0] != ncomp(cv):
        raise ValueError(f"invert takes [{ncomp(cv)}, M], got {tuple(tots.shape)}")
    (tots,) = _cuda_inputs([tots])
    inv = torch.empty_like(tots)
    rc = cuda.lib().g16_tree_invert(_g2(cv), tots.data_ptr(), inv.data_ptr(), M,
                                    cuda.stream_ptr(tots.device))
    cuda.check(rc, "tree invert kernel")
    invert_kernel.launches += 1
    return inv


invert_kernel.launches = 0


def _tinv_check(cv: CurveSpec, tinv: torch.Tensor, M: int) -> None:
    if tuple(tinv.shape) != (ncomp(cv), M):
        raise ValueError(f"lane inverses must be [{ncomp(cv)}, {M}], got {tuple(tinv.shape)}")


def phase_b_kernel(cv: CurveSpec, apr, bpl, tinv) -> torch.Tensor:
    """K7 (see `phase_b_plain`): blocks of 8 lanes x T_SLOTS additions, one
    thread an addition.  Replaces groth16_tpu/ops/kernels_tree.py:292
    `_phase_b_call`; bound by the bytes of the two operand points and the
    mid of each addition, each moved once (csrc/tree.cu)."""
    shape = _plane_check(cv, apr, bpl)
    _tinv_check(cv, tinv, shape[2])
    apr, bpl, tinv = _cuda_inputs([apr, bpl, tinv])
    mid = torch.empty(shape, dtype=torch.uint32, device=apr.device)
    rc = cuda.lib().g16_tree_mid(_g2(cv), apr.data_ptr(), bpl.data_ptr(), tinv.data_ptr(),
                                 mid.data_ptr(), shape[2], cuda.stream_ptr(apr.device))
    cuda.check(rc, "tree mid kernel")
    phase_b_kernel.launches += 1
    return mid


phase_b_kernel.launches = 0


def _level_cols(cv: CurveSpec, cols) -> tuple:
    """(K, limb stride) of a level's four operand columns: uint32[R2, K]
    views of one column stride 1 and one limb stride, 16-bit limbs in
    32-bit words (the previous level's outputs, sliced in halves)."""
    R2, K = 2 * ncomp(cv), cols[0].shape[-1]
    ld = cols[0].stride(0)
    for c in cols:
        if c.dtype != torch.uint32 or tuple(c.shape) != (R2, K) or c.stride() != (ld, 1):
            raise ValueError(f"{cv.name} level operands must be uint32[{R2}, {K}] views of one "
                             f"limb stride, got {c.dtype} {tuple(c.shape)} strides {c.stride()}")
    return K, ld


def level_kernel(cv: CurveSpec, A_pl, A_pr, B_pl, B_pr, match, aP, bP, want_em: bool):
    """K8: one whole tree level in one launch (see `level`).  Replaces
    groth16_tpu/ops/kernels_tree.py:370 `_phase_b_level_call` as
    `level_pallas` drives it (with K4 and K6 before it); bound on this card
    by one block's latency (its inversion and chains) on narrow levels and
    by the waves of such blocks on wide ones (csrc/tree.cu)."""
    cols = (A_pl, A_pr, B_pl, B_pr)
    K, ld = _level_cols(cv, cols)
    dev = A_pl.device
    if dev.type != "cuda" or any(c.device != dev for c in cols):
        raise ValueError(f"kernel inputs must be CUDA tensors on one device, got {dev}")
    flg = match.to(torch.uint8).add_(aP, alpha=2).add_(bP, alpha=4)
    outs = [torch.empty((2 * ncomp(cv), K), dtype=torch.uint32, device=dev)
            for _ in range(3 if want_em else 2)]
    em = outs[2].data_ptr() if want_em else None
    rc = cuda.lib().g16_tree_level(_g2(cv), *(c.data_ptr() for c in cols), flg.data_ptr(),
                                   outs[0].data_ptr(), outs[1].data_ptr(), em, K, ld,
                                   cuda.stream_ptr(dev))
    cuda.check(rc, "tree level kernel")
    level_kernel.launches += 1
    return outs[0], outs[1], (outs[2] if want_em else None)


level_kernel.launches = 0


# ---------------------------------------------------------------------------
# dispatch by device, and one whole level
# ---------------------------------------------------------------------------

def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def phase_a(cv, apr, bpl):
    return phase_a_plain(cv, apr, bpl) if _on_cpu(apr) else phase_a_kernel(cv, apr, bpl)


def mul_rows(cv, a, b, out=None, point_major: bool = False):
    """Elementwise products out[w] = a[w] * b[w mod Wb] of Fp (G1) or Fp2
    (G2) values: a is a limb-major row uint32[NC, W] (any strides: column
    slices of a wider row), or, `point_major`, points [..., *comp] (W of
    them) as curve ops hold coordinates; b is a limb-major row [NC, Wb]
    whose width divides W.  The result has a's shape, contiguous, or goes
    into `out` (a's shape, any strides a view allows).  K5 on CUDA tensors,
    `mul_rows_plain` on CPU tensors."""
    fn = mul_rows_plain if _on_cpu(a) else mul_rows_kernel
    return fn(cv, a, b, out, point_major)


def invert(cv, tots):
    return invert_plain(cv, tots) if _on_cpu(tots) else invert_kernel(cv, tots)


def phase_b(cv, apr, bpl, tinv):
    return phase_b_plain(cv, apr, bpl, tinv) if _on_cpu(apr) else phase_b_kernel(cv, apr, bpl, tinv)


def level(cv: CurveSpec, A_pl, A_pr, B_pl, B_pr, match, aP, bP, want_em: bool):
    """One tree level (groth16_tpu/ops/kernels_tree.py::level_pallas): the
    operand columns A.pL, A.pR, B.pL, B.pR uint32[R2, K] (views of one limb
    stride on CUDA), bool[K] flags (keys match, A pure, B pure).  Returns
    (PL', PR', EM0) as uint32[R2, K]: PL' = match & aP ? mid : A.pL, PR' =
    match & bP ? mid : B.pR, EM0 = match ? mid : A.pR, or None unless
    `want_em` (level 1 never emits); mid = A.pR + B.pL.  K8 on CUDA tensors,
    `level_plain` on CPU."""
    fn = level_plain if _on_cpu(A_pl) else level_kernel
    return fn(cv, A_pl, A_pr, B_pl, B_pr, match, aP, bP, want_em)


def mid_planes(cv: CurveSpec, a_cols: torch.Tensor, b_cols: torch.Tensor) -> tuple:
    """K7's inputs in `mid`: the columns as planes padded to whole lanes and
    their lane inverses (K4, then the batch inversion K6)."""
    Kp = _tiles(a_cols.shape[1])
    apr, bpl = _planes(a_cols, Kp), _planes(b_cols, Kp)
    return apr, bpl, invert(cv, phase_a(cv, apr, bpl))


def mid(cv: CurveSpec, a_cols: torch.Tensor, b_cols: torch.Tensor) -> torch.Tensor:
    """Batched affine additions mid = A + B of limb-major fused x|y columns
    uint32[R2, K] (groth16_tpu/ops/kernels_tree.py::mid_pallas, the
    counterpart of msm_tree.mid_jnp): `mid_planes`, then K7."""
    R2, K = a_cols.shape
    return phase_b(cv, *mid_planes(cv, a_cols, b_cols)).reshape(R2, -1)[:, :K]
