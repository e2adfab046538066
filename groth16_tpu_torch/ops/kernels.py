"""Launch wrappers of the point kernels (K1: add, doubling chain, Horner),
the segmented-fold kernel (K2), the chained-product kernel (K9), the
prover's SpMV and the Fp negation.

Counterpart of groth16_tpu/ops/kernels.py (`_point_call`, `_fold_call`), of
the kernel of tools/bench_mul_kernels.py (`make_call`), and of two functions
the JAX package leaves to XLA: `abc_core` (groth16_tpu/protocol/prover.py:89)
and the y negation of `window_sums_tree` (groth16_tpu/ops/msm_tree.py).
The wrappers here take CUDA tensors only: they check device, dtype, shape
and alignment, allocate outputs with `torch.empty`, launch on the current
stream, raise on a launch error, and count their launches
(`<wrapper>.launches`).  The plain PyTorch versions sit beside them:
`curve.point_add_plain` / `point_double_n_plain` / `horner_plain`,
`fold_level_plain`, `fp_mul_chain_plain`, `spmv_plain` and `fp_neg_plain`
here; `curve.point_add` / `point_double_n` / `horner`, `fold_level`,
`fp_mul_chain`, `spmv` and `fp_neg` here dispatch by the device of their
input.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import curve as C
from . import field as F
from . import cuda
from .field import FP, FR
from .limbs import N_LIMBS
from ..utils import timing

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


def _k1_launch(fn_name: str, cv, ins, out_shape, *tail, out=None):
    """Launch one K1 function on the current stream into `out` (three
    contiguous uint32 coordinates of `out_shape` on the inputs' device;
    allocated here where None) and raise on a launch error."""
    dev = ins[0].device
    if out is None:
        out = [torch.empty(out_shape, dtype=torch.uint32, device=dev) for _ in range(3)]
    elif len(out) != 3 or any(o.shape != torch.Size(out_shape) or o.dtype != torch.uint32
                              or o.device != dev or not o.is_contiguous() for o in out):
        raise ValueError(f"{fn_name} writes three contiguous uint32 coordinates of "
                         f"{tuple(out_shape)} on {dev}")
    outs = list(out)
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


def horner(cv: C.CurveSpec, sums, c: int, out=None):
    """K1 Horner: sum_w 2^(c w) S_w of CUDA window sums [W, comp] (or
    [B, W, comp]: one thread per independent Horner) in one launch, into
    `out` where given (three coordinates of [..., comp]; allocated here
    where None).  Replaces groth16_tpu/ops/kernels.py:288 `_point_call` as
    groth16_tpu/ops/msm.py:515 `horner_combine` drives it (one `lax.scan` in
    one program there); bound on this card by the latency of one thread's
    (W - 1)(9 c + 14) serial products.  Plain version: `curve.horner_plain`."""
    if c < 0:
        raise ValueError(f"horner takes c >= 0, got {c}")
    batch, W = horner_shape(cv, sums)
    B = 1
    for d in batch:
        B *= d
    out = _k1_launch("g16_horner", cv, _cuda_inputs(tuple(sums)), batch + cv.comp_shape, B, W, c,
                     out=out)
    horner.launches += 1
    return out


horner.launches = 0


def fold_rows(cv) -> int:
    """Wire words per projective point: 3 coordinates x 16 (G1) or 32 (G2)."""
    return 48 if cv.name == "G1" else 96


def _fold_check(cv, rows, order, keys, table, T, affine):
    """(W, m, nb) of one fold level's operands, or raise."""
    W, m = keys.shape
    R = fold_rows(cv)
    rin = 2 * R // 3 if affine else R
    if T < 1 or m % T:
        raise ValueError(f"a fold level takes T >= 1 dividing the stream length {m}, got {T}")
    if rows.ndim != 2 or rows.shape[1] != rin:
        raise ValueError(f"rows must be [n, {rin}], got {tuple(rows.shape)}")
    if order is None and rows.shape[0] != W * m:
        raise ValueError(f"without an order the rows are the {W} x {m} stream, got {rows.shape[0]}")
    if order is not None and order.shape != keys.shape:
        raise ValueError(f"order must be [{W}, {m}] like the keys, got {tuple(order.shape)}")
    if table.ndim != 3 or table.shape[0] != W or table.shape[2] != R:
        raise ValueError(f"the bucket table must be [{W}, nb, {R}], got {tuple(table.shape)}")
    return W, m, table.shape[1]


_fold_counts = threading.local()


@contextlib.contextmanager
def fold_counts(counts: torch.Tensor):
    """Inside the block, every K2 launch on this thread adds into `counts`
    (int64 [2] on the launch's device) the slots it skipped, whose key was
    0, and the slots it walked: one atomic add of each a block.  Outside
    one, K2 counts nothing.  The fused proof opens one around its core, so
    that its graph records the counters' address (`prover.FusedProof`)."""
    if counts.dtype != torch.int64 or counts.shape != (2,) or not counts.is_contiguous():
        raise ValueError("the fold counters are a contiguous int64 tensor of 2")
    before = getattr(_fold_counts, "counts", None)
    _fold_counts.counts = counts
    try:
        yield counts
    finally:
        _fold_counts.counts = before


def fold_level_kernel(cv: C.CurveSpec, rows, order, keys, table, T: int,
                      affine: bool = False, last: bool = False):
    """K2: one fold level over CUDA tensors (see `fold_level_plain`).
    Replaces groth16_tpu/ops/kernels.py:416 `_fold_call`: one launch over
    every window's lanes, each thread gathering its points through `order`
    and adding the segments that close into `table` in place (csrc/fold.cu).
    Counts its slots where a `fold_counts` block is open."""
    W, m, nb = _fold_check(cv, rows, order, keys, table, T, affine)
    (rows,) = _cuda_inputs([rows])
    keys = _cuda_inputs([keys], torch.int32)[0]
    order = None if order is None else _cuda_inputs([order], torch.int32)[0]
    if table.device != rows.device or table.dtype != torch.uint32 or not table.is_contiguous():
        raise ValueError("the bucket table must be a contiguous uint32 tensor on the rows' device")
    counts = getattr(_fold_counts, "counts", None)
    if counts is not None and counts.device != rows.device:
        raise ValueError("the fold counters must lie on the rows' device")
    dev, lanes, R = rows.device, m // T, fold_rows(cv)
    trail = None if last else torch.empty((W * lanes, R), dtype=torch.uint32, device=dev)
    tkey = None if last else torch.empty((W, lanes), dtype=torch.int32, device=dev)
    rows_p, table_p = _aligned([rows, table])
    rc = cuda.lib().g16_fold(int(cv.name == "G2"), int(affine), rows_p,
                             None if order is None else order.data_ptr(), keys.data_ptr(),
                             table_p, None if last else _aligned([trail])[0],
                             None if last else tkey.data_ptr(), T, m, W, nb, int(last),
                             None if counts is None else counts.data_ptr(),
                             cuda.stream_ptr(dev))
    cuda.check(rc, "fold kernel")
    fold_level_kernel.launches += 1
    return trail, tkey


fold_level_kernel.launches = 0


def fold_level_plain(cv: C.CurveSpec, rows, order, keys, table, T: int,
                     affine: bool = False, last: bool = False):
    """Plain PyTorch version of K2 (any device): one level of the segmented
    fold, closed segments added into their buckets.

    keys int32[W, m]: each window's signed digits, sorted by |digit| (bucket
    identity; a negative digit negates y).  rows uint32[n, Rin]: the points,
    point-major, x|y (affine, (0, 0) = infinity) or x|y|z; sorted position j
    of window w is row order[w, j], or row w*m + j when `order` is None.
    table uint32[W, nb, R]: bucket sums, updated IN PLACE.  Lane l of window
    w takes positions l*T .. l*T+T-1.  A slot whose digit is 0 contributes
    nothing: bucket 0 has weight 0 in the bucket reduce, so the table's
    bucket 0 is not maintained and keeps what it held.  The lane's first
    nonzero slot opens its segment at its point; where |digit| changes at a
    later nonzero slot, the bucket of the nonzero slot before it becomes
    (bucket + segment), every other nonzero slot (segment + point), one
    complete add each.  Returns the lanes' open segments (trail uint32[W *
    m/T, R], their |digit| int32[W, m/T]; infinity under 0 where a lane
    holds zero digits alone), or, at the `last` level, adds them into their
    buckets too and returns (None, None).  Adds the level's zero slots to
    the tracer's counter `msm.zero_slots` and its W * m slots to
    `msm.fold_slots`, as K2 counts them on the card."""
    W, m, nb = _fold_check(cv, rows, order, keys, table, T, affine)
    K, comp, dev = cv.fops, cv.comp_shape, keys.device
    R = fold_rows(cv)
    nc = R // 3
    lanes = m // T
    lane = torch.arange(W * lanes, device=dev)
    base = lane // lanes * m + lane % lanes * T
    bucket0 = lane // lanes * nb
    flat_k = keys.reshape(-1).to(torch.int64)
    flat_o = None if order is None else order.reshape(-1).to(torch.int64)
    tab = F.as_i32(table).view(W * nb, R)
    b3 = F.const(cv.b3_limbs, dev)
    timing.count("msm.zero_slots", int((flat_k == 0).sum()))
    timing.count("msm.fold_slots", W * m)

    def split(r):      # int64 [n, R] -> (X, Y, Z) of [n, comp]
        return tuple(r[:, j * nc:(j + 1) * nc].reshape((-1,) + comp) for j in range(r.shape[1] // nc))

    def fuse(P):       # (X, Y, Z) -> int32 [n, R]
        return torch.cat([F.i64(c).reshape(c.shape[0], -1) for c in P], -1).to(torch.int32)

    def sel(mask, P, Q):
        return tuple(K.select(mask, p, q) for p, q in zip(P, Q))

    run = tuple(F.i64(c) for c in C.inf_like(cv, (W * lanes,), dev))
    ap = torch.zeros(W * lanes, dtype=torch.int64, device=dev)   # 0: no segment open
    for t in range(T):
        k = flat_k[base + t]
        ak, live = k.abs(), k != 0
        p = F.i64(F.as_i32(rows)[base + t if flat_o is None else flat_o[base + t]])
        x, y = split(p)[:2]
        y = K.select(k < 0, K.neg(y), y)
        if affine:
            inf = (p == 0).all(-1)
            one = F.const(cv.one_limbs, dev).expand(x.shape)
            zero = torch.zeros_like(x)
            fresh = (K.select(inf, zero, x), K.select(inf, one, y), K.select(inf, zero, one))
        else:
            fresh = (x, y, split(p)[2])
        close = live & (ap != 0) & (ak != ap)
        dst = bucket0 + ap
        S = C.rcb_add(K, sel(close, split(F.i64(tab[dst])), run), sel(close, run, fresh), b3)
        tab[dst[close]] = fuse(S)[close]
        run = sel(live & ((ap == 0) | close), fresh, sel(live, S, run))
        ap = torch.where(live, ak, ap)
    if last:
        dst = bucket0 + ap
        S = fuse(C.rcb_add(K, split(F.i64(tab[dst])), run, b3))
        tab[dst[ap != 0]] = S[ap != 0]
        return None, None
    return F.as_u32(fuse(run)), ap.to(torch.int32).reshape(W, lanes)


def fold_level(cv: C.CurveSpec, rows, order, keys, table, T: int,
               affine: bool = False, last: bool = False):
    """One fold level: K2 on CUDA tensors, the plain version on CPU."""
    fn = fold_level_plain if keys.device.type == "cpu" else fold_level_kernel
    return fn(cv, rows, order, keys, table, T, affine, last)


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


# ---------------------------------------------------------------------------
# the prover's SpMV (csrc/spmv.cu g16_spmv)
# ---------------------------------------------------------------------------

# The SpMV's schedule (csrc/spmv.cu): entries a thread of the entries pass,
# threads a block of it, rows a block of the finish pass; chosen by the sweep
# of tools/bench_spmv.py on an H100 (PERF.md: E = 1 in blocks of 256 is the
# fastest at the 2^16 proof's rows of one entry and at rows of Zipf lengths,
# and within 10 % of the fastest on a 65,538-entry row)
SPMV_E = 1
SPMV_BLOCK = 256
SPMV_FINISH_BLOCK = 128
SPMV_ES = (1, 2, 3, 4, 8)   # the E the kernels are built for


@dataclass
class SpmvSchedule:
    """How the SpMV kernel splits a key's entries, built once per key
    (`spmv_schedule`): thread t of the entries pass holds entries [t E,
    t E + E) of `block` threads a block; a block whose last row goes on past
    it leaves a carry in slot `carry_slot[block]` (-1: none) for row
    `carry_row[slot]`; finish block q (`finish_block` rows) adds the carries
    [finish[q, 0], finish[q, 1]) to its A rows and [finish[q, 2], finish[q,
    3]) to its B rows."""

    E: int
    block: int
    finish_block: int
    keys: torch.Tensor        # int32 [nnz]: each entry's row in the CSR over 2 n_rows
    carry_slot: torch.Tensor  # int32 [entry blocks]
    carry_row: torch.Tensor   # int32 [slots], sorted
    finish: torch.Tensor      # int32 [finish blocks, 4]


@dataclass
class SpmvRows:
    """A zkey's A and B entries as the SpMV reads them: sorted by (matrix,
    row), CSR over 2 n_rows rows (A's row r is row r, B's is n_rows + r),
    with the kernel's schedule."""

    n_rows: int
    coeff: torch.Tensor     # uint32 [nnz, 16], Montgomery
    cols: torch.Tensor      # int32 [nnz], witness index
    row_ptr: torch.Tensor   # int64 [2 n_rows + 1]
    ncols: int              # 1 + the largest column: the witness length it needs
    schedule: SpmvSchedule


def spmv_schedule(keys, n_rows: int, device, E: int = SPMV_E, block: int = SPMV_BLOCK,
                  finish_block: int = SPMV_FINISH_BLOCK) -> SpmvSchedule:
    """The SpmvSchedule of sorted entry keys (numpy, CSR over 2 n_rows): a
    carry slot for every entry block whose last entry's row goes on into the
    next block, and each finish block's range of slots (their rows are
    sorted, so a block's rows take a contiguous range)."""
    if E not in SPMV_ES or block < 1 or finish_block < 1:
        raise ValueError(f"SpMV schedule: E in {SPMV_ES}, blocks >= 1; got {E}, {block}, "
                         f"{finish_block}")
    keys = np.asarray(keys, np.int64)
    span = E * block
    starts = np.arange(span, keys.size, span)          # each later block's first entry
    goes_on = keys[starts - 1] == keys[starts]
    carry_slot = np.full(-(-keys.size // span), -1, np.int64)
    carry_slot[:starts.size][goes_on] = np.arange(int(goes_on.sum()))
    carry_row = keys[starts[goes_on] - 1]
    lo = np.arange(0, n_rows, finish_block)
    hi = np.minimum(lo + finish_block, n_rows)
    finish = np.stack([np.searchsorted(carry_row, x) for x in (lo, hi, n_rows + lo, n_rows + hi)],
                      axis=1)

    def dev32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return SpmvSchedule(E=E, block=block, finish_block=finish_block, keys=dev32(keys),
                        carry_slot=dev32(carry_slot), carry_row=dev32(carry_row),
                        finish=dev32(finish.reshape(-1, 4)))


def spmv_rows(matrix, row, col, coeff, n_rows: int, device, **schedule) -> SpmvRows:
    """The SpmvRows of sparse entries (numpy; matrix 0 = A, any other = B,
    as the JAX `abc_core` reads it) on `device`, with the kernel's schedule
    (`spmv_schedule`'s keyword arguments)."""
    row = np.asarray(row, np.int64)
    if row.size and (row.min() < 0 or row.max() >= n_rows):
        raise ValueError(f"SpMV rows must lie in [0, {n_rows})")
    key = (np.asarray(matrix) != 0).astype(np.int64) * n_rows + row
    order = np.argsort(key, kind="stable")
    row_ptr = np.zeros(2 * n_rows + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=2 * n_rows), out=row_ptr[1:])
    cols = np.asarray(col, np.int64)[order]
    return SpmvRows(n_rows=n_rows,
                    coeff=torch.from_numpy(np.ascontiguousarray(
                        np.asarray(coeff, np.uint32)[order])).to(device),
                    cols=torch.from_numpy(cols.astype(np.int32)).to(device),
                    row_ptr=torch.from_numpy(row_ptr).to(device),
                    ncols=int(cols.max()) + 1 if cols.size else 0,
                    schedule=spmv_schedule(key[order], n_rows, device, **schedule))


def segment_sum_mod(vals_mont: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """int64 [n, 16]: the modular sum of Montgomery values by segment index."""
    acc = torch.zeros((n, vals_mont.shape[-1]), dtype=torch.int64, device=vals_mont.device)
    acc.index_add_(0, seg, F.i64(vals_mont))
    return F.reduce_columns(FR, acc)


def abc_core_plain(n_rows: int, witness_mont, coeff_mont, rows, cols, matrix_sel):
    """Az, Bz, Cz = Az .* Bz (reference buildABC, prover.nim:56-73; the JAX
    package's `abc_core`, with its arguments), uint32 Montgomery [n_rows, 16]
    each: gather, one Montgomery product, an int64 segment sum (exact to
    2^46 entries a row), the pointwise product.  `matrix_sel` is 0 for A
    entries, anything else for B."""
    w = F.as_i32(witness_mont)[cols]
    prod = F.mont_mul(FR, F.i64(coeff_mont), F.i64(w))
    seg = (matrix_sel != 0).to(torch.int64) * n_rows + F.i64(rows)
    sums = segment_sum_mod(prod, seg, 2 * n_rows)
    az, bz = sums[:n_rows], sums[n_rows:]
    return tuple(x.to(torch.uint32) for x in (az, bz, F.mont_mul(FR, az, bz)))


def _spmv_check(witness_std: torch.Tensor, m: SpmvRows) -> None:
    if witness_std.ndim != 2 or witness_std.shape[1] != N_LIMBS:
        raise ValueError(f"the witness must be [nvars, 16], got {tuple(witness_std.shape)}")
    if witness_std.shape[0] < m.ncols:
        raise ValueError(f"the SpMV reads witness column {m.ncols - 1}, "
                         f"the witness has {witness_std.shape[0]}")


def spmv_plain(witness_std: torch.Tensor, m: SpmvRows):
    """Plain PyTorch version of the SpMV kernel (any device): Az, Bz, Cz of
    the standard-form witness (uint32 [nvars, 16]), uint32 Montgomery
    [n_rows, 16] each, through `abc_core_plain`."""
    _spmv_check(witness_std, m)
    n = m.n_rows
    seg = torch.repeat_interleave(torch.arange(2 * n, device=m.row_ptr.device),
                                  torch.diff(m.row_ptr))
    return abc_core_plain(n, F.to_mont(FR, witness_std), m.coeff, seg % n, m.cols.long(),
                          seg // n)


def spmv_kernel(witness_std: torch.Tensor, m: SpmvRows):
    """The SpMV on CUDA tensors (see `spmv_plain`): the entries pass and
    the finish over the rows' schedule (csrc/spmv.cu), one call and two
    launches; replaces the XLA `abc_core` (groth16_tpu/protocol/prover.py:89)."""
    _spmv_check(witness_std, m)
    (w,) = _cuda_inputs([witness_std])
    dev, sc = w.device, m.schedule
    if any(t.device != dev for t in (m.coeff, m.cols, m.row_ptr, sc.keys, sc.carry_slot,
                                     sc.carry_row, sc.finish)):
        raise ValueError("the SpMV rows must lie on the witness's device")
    n = m.n_rows
    out = torch.empty((3, n, N_LIMBS), dtype=torch.uint32, device=dev)
    sums = torch.empty((8, 2 * n), dtype=torch.uint32, device=dev)   # word planes
    slots = max(sc.carry_row.numel(), 1)
    carries = torch.empty((8, slots), dtype=torch.uint32, device=dev)
    rc = cuda.lib().g16_spmv(*_aligned([w, m.coeff]), m.cols.data_ptr(), sc.keys.data_ptr(),
                             m.row_ptr.data_ptr(), sc.carry_slot.data_ptr(),
                             sc.carry_row.data_ptr(), sc.finish.data_ptr(), m.cols.numel(), n,
                             sc.E, sc.block, sc.finish_block, sums.data_ptr(), carries.data_ptr(),
                             slots, *_aligned([out]), cuda.stream_ptr(dev))
    cuda.check(rc, "spmv kernel")
    spmv_kernel.launches += 1
    return out[0], out[1], out[2]


spmv_kernel.launches = 0


def spmv(witness_std: torch.Tensor, m: SpmvRows):
    """Az, Bz, Cz: the SpMV kernel on CUDA tensors, the plain version on CPU."""
    fn = spmv_plain if witness_std.device.type == "cpu" else spmv_kernel
    return fn(witness_std, m)


# ---------------------------------------------------------------------------
# Fp negation (csrc/spmv.cu g16_fp_neg)
# ---------------------------------------------------------------------------

def fp_neg_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the negation kernel (any device): -x mod p of
    uint32 Fp elements [..., 16]; 0 stays 0."""
    return F.neg_mod(FP, x)


def fp_neg_kernel(x: torch.Tensor) -> torch.Tensor:
    """-x mod p of uint32 Fp elements [..., 16] on the card, one launch
    (csrc/spmv.cu); replaces the XLA `F.neg_mod` of the y coordinates in
    `window_sums_tree` (groth16_tpu/ops/msm_tree.py)."""
    if x.shape[-1] != N_LIMBS:
        raise ValueError(f"fp_neg takes [..., 16] limbs, got {tuple(x.shape)}")
    (x,) = _cuda_inputs([x])
    out = torch.empty_like(x)
    rc = cuda.lib().g16_fp_neg(*_aligned([x, out]), x.numel() // N_LIMBS,
                               cuda.stream_ptr(x.device))
    cuda.check(rc, "fp neg kernel")
    fp_neg_kernel.launches += 1
    return out


fp_neg_kernel.launches = 0


def fp_neg(x: torch.Tensor) -> torch.Tensor:
    """-x mod p: the negation kernel on CUDA tensors, the plain version on CPU."""
    return fp_neg_plain(x) if x.device.type == "cpu" else fp_neg_kernel(x)
