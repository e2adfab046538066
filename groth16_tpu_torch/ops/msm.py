"""Multi-scalar multiplication (Pippenger, signed windows).

Counterpart of groth16_tpu/ops/msm.py.  The bucket phase takes one of two
paths, chosen as the JAX package chooses on the TPU (`tree_path`): affine
MSMs of TREE_MIN_N (2^16) points and more go through the batched-affine
merge tree (ops/msm_tree.py, kernels K4-K6 and K8); the rest through the
segmented fold:

  1. signed (wNAF-style) window digits, |d| <= 2^(c-1), so a window has
     2^(c-1) + 1 buckets and a negative digit negates the point;
  2. per window, the points sorted by |digit|; every window's stream is cut
     into lanes of FOLD_T elements and ONE fold launch (kernel K2) per level
     accumulates the running segments of all windows' lanes at once; the
     segments that close inside a lane are routed to their bucket from the
     keys alone (an index scatter, then one row gather), the lanes' trailing
     partials form the next, FOLD_T-times shorter level;
  3. the weighted bucket sum sum_b b * B_b of all windows at once through the
     [Q, L] factorization b = q*L + l (tree sums and log-depth suffix sums);
  4. Horner over the windows.

Every projective point operation goes through `curve.point_add` /
`point_double` (kernel K1 on CUDA tensors).  Below 128 points the batched
double-and-add ladder (`msm_naive`) runs instead.  Results are projective; their affine forms equal
the JAX package's for the same inputs.
"""

from __future__ import annotations

import torch

from . import curve as C
from . import field as F
from .curve import CurveSpec
from .kernels import FOLD_T, fold_level, fold_rows
from .limbs import LIMB_BITS, N_LIMBS

NBITS = 254  # BN254 scalars fit 254 bits


def pick_window_bits(n: int) -> int:
    """Pippenger window heuristic c ~ log2(n) - 3, clamped to [4, 16]."""
    return max(4, min(16, max(1, n).bit_length() - 3))


def pick_window_bits_tree(n: int) -> int:
    """The merge tree's window: one bit narrower than the fold's."""
    return max(4, min(16, max(1, n).bit_length() - 4))


TREE_MIN_N = 1 << 16   # tree / fold crossover of groth16_tpu/ops/msm.py


def tree_path(n: int, affine: bool) -> bool:
    """Whether an n-point MSM takes the merge tree (affine points only)."""
    return affine and n >= TREE_MIN_N


def _window_digits(s: torch.Tensor, w: int, c: int) -> torch.Tensor:
    """Digit w (bits [w*c, (w+1)*c)) of int64 [N, 16] standard-form limbs."""
    pos = w * c
    limb, off = divmod(pos, LIMB_BITS)
    lo = s[:, limb] >> off
    got = LIMB_BITS - off
    while got < c and limb + 1 < N_LIMBS:
        limb += 1
        lo = lo | (s[:, limb] << got)
        got += LIMB_BITS
    return lo & ((1 << c) - 1)


def signed_window_digits(scalars_std: torch.Tensor, c: int) -> torch.Tensor:
    """int64[W, N] digits in [-(2^(c-1)) + 1, 2^(c-1)] with
    sum_w d_w 2^(cw) == scalar; W = ceil(255 / c) absorbs the last carry."""
    s = F.i64(scalars_std)
    W = -(-(NBITS + 1) // c)
    half = 1 << (c - 1)
    carry = torch.zeros(s.shape[0], dtype=torch.int64, device=s.device)
    digits = []
    for w in range(W):
        d = _window_digits(s, w, c) + carry
        carry = (d > half).to(torch.int64)
        digits.append(d - (carry << c))
    return torch.stack(digits)


def _rows(P) -> torch.Tensor:
    """(X, Y, Z) of [n, ...comp] -> int32 fused rows [n, R]."""
    n = P[0].shape[0]
    return torch.cat([F.as_i32(c).reshape(n, -1) for c in P], -1)


def _split_rows(cv: CurveSpec, rows: torch.Tensor):
    """int32 fused rows [..., R] -> uint32 (X, Y, Z) of [..., comp]."""
    nc = fold_rows(cv) // 3
    lead = rows.shape[:-1]
    return tuple(F.as_u32(rows[..., j * nc:(j + 1) * nc].reshape(lead + cv.comp_shape))
                 for j in range(3))


def _window_buckets(cv: CurveSpec, keys: torch.Tensor, rows: torch.Tensor,
                    n_buckets: int, affine: bool):
    """Bucket sums of every window: keys int64[W, m] signed digits (m a power
    of two >= FOLD_T), rows int32[m, Rin] the points (x|y affine with (0, 0)
    = infinity, or x|y|z).  Returns (X, Y, Z) of [n_buckets, W, comp]."""
    W, m = keys.shape
    R = fold_rows(cv)
    dev = keys.device
    order = torch.argsort(keys.abs(), dim=1, stable=True)
    cur_k = torch.gather(keys, 1, order)            # signed, sorted by |d|
    inf_row = _rows(C.inf_like(cv, (1,), dev))      # [1, R]
    win_base = torch.arange(W, device=dev) * (n_buckets + 1)
    total = None
    trail = None
    first = True
    while True:
        T = min(FOLD_T, m)
        lanes = m // T
        kT = cur_k.reshape(W, lanes, T).permute(2, 0, 1).reshape(T, W * lanes)
        if first:
            idx = order.reshape(W, lanes, T).permute(2, 0, 1).reshape(-1)
            pT = rows[idx].reshape(T, W * lanes, -1).transpose(1, 2)
        else:
            pT = trail.reshape(R, W, lanes, T).permute(3, 0, 1, 2).reshape(T, R, W * lanes)
        emit, trail = fold_level(cv, kT.to(torch.int32).contiguous(),
                                 F.as_u32(pT.contiguous()), affine=affine and first)
        emit, trail = F.as_i32(emit), F.as_i32(trail)
        ak = kT.abs()

        # route closed segments: slot t of a lane holds the segment of key
        # ak[t-1] when the key changes at t; one real write per bucket
        dst = torch.full((T, W * lanes), n_buckets, dtype=torch.int64, device=dev)
        dst[1:] = torch.where(ak[1:] != ak[:-1], ak[:-1], n_buckets)
        dst = dst + win_base.repeat_interleave(lanes)
        n_emit = T * W * lanes
        slot = torch.full((W * (n_buckets + 1),), n_emit, dtype=torch.int64, device=dev)
        slot.scatter_(0, dst.reshape(-1), torch.arange(n_emit, device=dev))
        emit_rows = torch.cat([emit.permute(0, 2, 1).reshape(n_emit, R), inf_row], 0)
        level = _split_rows(cv, emit_rows[slot].reshape(W, n_buckets + 1, R))
        total = level if total is None else C.point_add(cv, total, level)

        if lanes == 1:   # one trailing segment per window: scatter it directly
            slot = torch.full((W * (n_buckets + 1),), W, dtype=torch.int64, device=dev)
            slot.scatter_(0, ak[-1] + win_base, torch.arange(W, device=dev))
            trail_rows = torch.cat([trail.T, inf_row], 0)
            last = _split_rows(cv, trail_rows[slot].reshape(W, n_buckets + 1, R))
            total = C.point_add(cv, total, last)
            break
        cur_k = ak[-1].reshape(W, lanes)
        m = lanes
        first = False
    return tuple(c[:, :n_buckets].transpose(0, 1) for c in total)


def _tri_sum(cv: CurveSpec, seq):
    """sum_{i>=1} i * seq[i] over the leading axis: log-depth suffix sums
    (Hillis-Steele), then one tree sum."""
    x = tuple(c[1:] for c in seq)
    n = x[0].shape[0]
    d = 1
    while d < n:
        head = C.point_add(cv, tuple(c[:n - d] for c in x), tuple(c[d:] for c in x))
        x = tuple(F.as_u32(torch.cat([F.as_i32(h), F.as_i32(c[n - d:])], 0))
                  for h, c in zip(head, x))
        d *= 2
    return C.tree_sum(cv, x)


def _weighted_bucket_reduce(cv: CurveSpec, buckets, n_buckets: int):
    """sum_b b * bucket_b over the leading axis (trailing window axis rides
    along), via b = q*L + l: L * sum_q q*Row_q + sum_l l*Col_l.  n_buckets is
    a power of two or 2^k + 1 (the signed-digit top bucket, weight 2^k =
    k doublings)."""
    if n_buckets & (n_buckets - 1):
        k = (n_buckets - 1).bit_length() - 1
        assert n_buckets == (1 << k) + 1, n_buckets
        top = tuple(b[n_buckets - 1] for b in buckets)
        for _ in range(k):
            top = C.point_double(cv, top)
        base = _weighted_bucket_reduce(cv, tuple(b[:n_buckets - 1] for b in buckets), 1 << k)
        return C.point_add(cv, base, top)
    lq = max(1, (n_buckets.bit_length() - 1) // 2)
    Q = 1 << lq
    L = n_buckets // Q
    G = tuple(b.reshape((Q, L) + b.shape[1:]) for b in buckets)
    rows = C.tree_sum(cv, tuple(g.transpose(0, 1) for g in G))   # [Q, W]
    cols = C.tree_sum(cv, G)                                      # [L, W]
    Sq = _tri_sum(cv, rows)
    Sl = _tri_sum(cv, cols)
    for _ in range(L.bit_length() - 1):
        Sq = C.point_double(cv, Sq)
    return C.point_add(cv, Sq, Sl)


def window_sums(cv: CurveSpec, scalars_std: torch.Tensor, P, c: int,
                affine: bool = False):
    """Per-window Pippenger sums (X, Y, Z) of [W, comp], before Horner."""
    n = scalars_std.shape[0]
    dev = scalars_std.device
    keys = signed_window_digits(scalars_std, c)
    m = max(FOLD_T, 1 << max(0, (n - 1).bit_length()))
    if affine:
        # x|y rows, (0, 0) = infinity (from_affine encodes it as (0 : 1 : 0))
        y = cv.fops.select(cv.fops.is_zero(P[2]), torch.zeros_like(P[1]), P[1])
        rows = _rows((P[0], y))
        pad = torch.zeros((m - n, rows.shape[1]), dtype=torch.int32, device=dev)
    else:
        rows = _rows(P)
        pad = _rows(C.inf_like(cv, (1,), dev)).expand(m - n, -1)
    rows = torch.cat([rows, pad], 0)
    keys = torch.nn.functional.pad(keys, (0, m - n))
    n_buckets = (1 << (c - 1)) + 1
    buckets = _window_buckets(cv, keys, rows, n_buckets, affine)
    return _weighted_bucket_reduce(cv, buckets, n_buckets)


def horner_combine(cv: CurveSpec, sums, c: int):
    """acc = sum_w 2^(c*w) * S_w, windows high to low."""
    W = sums[0].shape[0]
    acc = tuple(s[W - 1] for s in sums)
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = C.point_double(cv, acc)
        acc = C.point_add(cv, acc, tuple(s[w] for s in sums))
    return acc


def msm(cv: CurveSpec, scalars_std: torch.Tensor, P, affine: bool = False):
    """sum_i scalar_i * P_i -> one projective point.

    `scalars_std`: uint32[N, 16] standard (non-Montgomery) form.  `P`:
    projective batch; `affine=True` when every Z is 0 or Montgomery 1 (the
    zkey's wire-format points): from TREE_MIN_N points the merge tree runs,
    below it the first fold level runs mixed adds on x|y rows."""
    n = scalars_std.shape[0]
    if n < 128:
        return msm_naive(cv, scalars_std, P)
    if tree_path(n, affine):
        from .msm_tree import msm_tree
        return msm_tree(cv, scalars_std, P)
    c = pick_window_bits(n)
    return horner_combine(cv, window_sums(cv, scalars_std, P, c, affine), c)


def msm_naive(cv: CurveSpec, scalars_std: torch.Tensor, P):
    """Batched double-and-add, then a tree sum (reference msmNaiveG1/G2)."""
    return C.tree_sum(cv, C.scalar_mul(cv, scalars_std, P))
