"""Multi-scalar multiplication (Pippenger, signed windows).

Counterpart of groth16_tpu/ops/msm.py.  The bucket phase is the segmented
fold, at every size from 128 points up.  The JAX package takes the
batched-affine merge tree (ops/msm_tree.py) on the TPU from 2^16 affine
points; on the H100 the fold was the faster at every measured size from
2^16 to 2^21 in both groups, so the tree is only `msm_tree.msm`, which
nothing on the proof's path calls.  The fold:

  1. signed (wNAF-style) window digits, |d| <= 2^(c-1), so a window has
     2^(c-1) + 1 buckets and a negative digit negates the point;
  2. per window, the points sorted by |digit|; every window's stream is cut
     into lanes of T elements and ONE fold launch (kernel K2) per level
     walks all windows' lanes at once, gathering its points through the
     sort order and adding every segment that closes inside a lane into
     its bucket of a [W, buckets] table in place (a zero digit, of the
     padding or of a small scalar's high windows, costs a key read and no
     add); the lanes' open segments form the next, T-times shorter level,
     and the last level (one lane a window) adds them into the table too.
     T is FOLD_T at level 0 and FOLD_T_PROJECTIVE after it
     (`fold_schedule`);
  3. the weighted bucket sum sum_b b * B_b of all windows at once through the
     [Q, L] factorization b = q*L + l (tree sums and log-depth suffix sums);
  4. Horner over the windows.

Every projective point operation goes through `curve.point_add`,
`point_double_n` and `horner` (kernel K1 on CUDA tensors: the doubling
chains of the bucket reduce and the whole Horner are one launch each).  Below 128 points the batched
double-and-add ladder (`msm_naive`) runs instead.  `msm_chunked` streams
point sets larger than one device segment.  The prover stops each
MSM before step 4 (`msm_sums`) and runs the Horners beside the next MSMs'
bucket phases (`SideChains`).  Results are projective; their affine forms
equal the JAX package's for the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve as C
from . import field as F
from .curve import CurveSpec
from . import kernels as KN
from .kernels import FOLD_T, fold_level, fold_rows
from .limbs import LIMB_BITS, N_LIMBS
from ..utils import timing as T

NBITS = 254  # BN254 scalars fit 254 bits


def pick_window_bits(n: int) -> int:
    """Pippenger window heuristic c ~ log2(n) - 3, clamped to [4, 16]."""
    return max(4, min(16, max(1, n).bit_length() - 3))


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


# T of the fold's projective levels (tools/bench_fold_phases.py sweeps T over
# them on the card).  They are latency-bound at the main path's shapes (2,048
# elements a window after level 0 at 2^16, 32,768 at 2^20), so the chain of
# T complete adds a thread runs decides: T = 4 was fastest in G1 at both
# sizes, and in G2 (whose add is three times as long) T = 2 and T = 4 tied,
# T = 4 with fewer launches.
FOLD_T_PROJECTIVE = 4


def fold_schedule(m: int) -> list:
    """T of every fold level of sorted streams of m elements (m a power of
    two): FOLD_T at level 0, whose lanes fill the card, then
    FOLD_T_PROJECTIVE; the last level takes what is left in one lane a
    window."""
    Ts = [min(FOLD_T, m)]
    m //= Ts[0]
    while m > 1:
        Ts.append(min(FOLD_T_PROJECTIVE, m))
        m //= Ts[-1]
    return Ts


def bucket_table(cv: CurveSpec, W: int, n_buckets: int, device) -> torch.Tensor:
    """uint32[W, n_buckets, R] point-major bucket sums, all at infinity."""
    inf_row = _rows(C.inf_like(cv, (1,), device))
    return F.as_u32(inf_row.expand(W * n_buckets, -1).reshape(W, n_buckets, -1).contiguous())


def window_buckets(cv: CurveSpec, keys: torch.Tensor, rows: torch.Tensor, n_buckets: int,
                   affine: bool):
    """Bucket sums of every window: keys int64[W, m] signed digits (m a power
    of two), rows int32[m, Rin] the points (x|y affine with (0, 0) =
    infinity, or x|y|z).  One fold level (`kernels.fold_level`) per entry of
    `fold_schedule`, all adding into one bucket table.  Returns (X, Y, Z) of
    [n_buckets, W, comp].  A zero digit (the padding's, a small scalar's
    high windows) adds nothing: bucket 0, which has weight 0 in
    `_weighted_bucket_reduce`, stays at infinity and is not a sum of the
    window's zero-digit points."""
    W, m = keys.shape
    Ts = fold_schedule(m)
    order = torch.argsort(keys.abs(), dim=1, stable=True)
    sk = torch.gather(keys, 1, order).to(torch.int32)
    table = bucket_table(cv, W, n_buckets, keys.device)
    pts, order = F.as_u32(rows), order.to(torch.int32)
    for i, T in enumerate(Ts):
        pts, sk = fold_level(cv, pts, order if i == 0 else None, sk, table, T,
                             affine=affine and i == 0, last=i == len(Ts) - 1)
    return tuple(c.transpose(0, 1) for c in _split_rows(cv, F.as_i32(table)))


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
        top = C.point_double_n(cv, tuple(b[n_buckets - 1] for b in buckets), k)
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
    return C.point_add(cv, C.point_double_n(cv, Sq, L.bit_length() - 1), Sl)


def window_sums(cv: CurveSpec, scalars_std: torch.Tensor, P, c: int, affine: bool = False):
    """Per-window Pippenger sums (X, Y, Z) of [W, comp], before Horner,
    through the fold.  Adds 1 to the tracer's counter `msm.fold`, the m
    points it folds (n padded to a power of two) to `msm.fold_points` and
    the m - n padding points to `msm.pad_points` (once a capture on the
    fused path, where Python runs only while the graph is recorded)."""
    n = scalars_std.shape[0]
    T.count("msm.fold", 1)
    dev = scalars_std.device
    keys = signed_window_digits(scalars_std, c)
    m = max(FOLD_T, 1 << max(0, (n - 1).bit_length()))
    T.count("msm.fold_points", m)
    T.count("msm.pad_points", m - n)
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
    buckets = window_buckets(cv, keys, rows, n_buckets, affine)
    return _weighted_bucket_reduce(cv, buckets, n_buckets)


def horner_combine(cv: CurveSpec, sums, c: int):
    """acc = sum_w 2^(c*w) * S_w of window sums [W, comp], windows high to
    low: one launch of K1's Horner on CUDA tensors (`curve.horner`)."""
    return C.horner(cv, sums, c)


def msm(cv: CurveSpec, scalars_std: torch.Tensor, P, affine: bool = False):
    """sum_i scalar_i * P_i -> one projective point.

    `scalars_std`: uint32[N, 16] standard (non-Montgomery) form.  `P`:
    projective batch; `affine=True` when every Z is 0 or Montgomery 1 (the
    zkey's wire-format points): the first fold level runs mixed adds on x|y
    rows."""
    n = scalars_std.shape[0]
    if n < 128:
        return msm_naive(cv, scalars_std, P)
    c = pick_window_bits(n)
    return horner_combine(cv, window_sums(cv, scalars_std, P, c, affine), c)


def msm_sums(cv: CurveSpec, scalars_std: torch.Tensor, P, affine: bool = False):
    """`msm` up to its Horner: (window sums (X, Y, Z) of [W, comp], their
    width c) where a bucket phase runs, or (`msm`'s point, None) below 128
    points, where no Horner follows."""
    n = scalars_std.shape[0]
    if n < 128:
        return msm(cv, scalars_std, P, affine), None
    c = pick_window_bits(n)
    return window_sums(cv, scalars_std, P, c, affine), c


class SideChains:
    """The Horner chains of several MSMs, run beside the bucket phases that
    follow them.

    `horner(cv, parts)` takes `msm_sums` results of one curve, ready on the
    current stream, and returns each MSM's point: the Horners of the parts
    with window sums come from one K1 launch (so their sums must share one
    width), the finished points pass through.  On CUDA
    tensors each launch forks a side stream of its own from the current
    stream, so that no chain queues behind another (a G2 chain beside K2
    can outlast the next two bucket phases); the side streams come from
    the high-priority pool, apart from the default-priority streams a
    capture or a warm-up runs on, so a fork never lands on the stream it
    forks from (the priority itself did not move a replay's time on an
    H100).  The sums are
    stacked and the outputs allocated on the current stream before the
    fork, so no side stream allocates (in a CUDA graph's pool every stream
    that allocates gets segments of its own), and both are held until the
    last `join`, so that no later allocation on the current stream takes
    their blocks while a chain reads or writes them.  `join(k)` makes the
    current stream wait for the chains of the first k points `horner`
    returned, `join()` for all of them: call it before reading a point,
    and `join()` before a capture ends.  Each launch adds its chains to the
    tracer's counter `msm.side_chains` (once a capture on the fused path).
    `marks`, where given, is a pair of timing events recorded on the side
    streams, before the first launch and after the last chain ends.  On
    CPU tensors nothing forks: the same launches run inline, through the
    plain version."""

    def __init__(self, marks=None):
        self.marks = marks
        self.forked = 0           # chains forked
        self.launches: list = []  # (side stream, event after its launch)
        self.source: list = []    # the index in `launches` of each point returned, or None
        self.held: list = []      # what the launches since the last full join read and write

    def horner(self, cv: CurveSpec, parts) -> list:
        out = [x for x, _ in parts]
        todo = [i for i, (_, c) in enumerate(parts) if c is not None]
        source = [None] * len(parts)
        if todo:
            got = self._launch(cv, [parts[i] for i in todo])
            for k, i in enumerate(todo):
                out[i] = got if len(todo) == 1 else tuple(x[k] for x in got)
                source[i] = len(self.launches) - 1 if got[0].is_cuda else None
        self.source += source
        return out

    def _launch(self, cv: CurveSpec, parts) -> tuple:
        """One Horner launch over the window sums of `parts` (one width)."""
        c = parts[0][1]
        if any(w != c for _, w in parts):
            raise ValueError(f"one Horner launch takes sums of one width, got "
                             f"{[w for _, w in parts]}")
        if len(parts) == 1:
            sums = tuple(x.contiguous() for x in parts[0][0])
        else:
            sums = tuple(F.as_u32(torch.stack([F.as_i32(x[j]) for x, _ in parts]))
                         for j in range(3))
        dev = sums[0].device
        if dev.type == "cpu":
            return C.horner(cv, sums, c)
        got = tuple(torch.empty(sums[0].shape[:-1 - len(cv.comp_shape)] + cv.comp_shape,
                                dtype=torch.uint32, device=dev) for _ in range(3))
        side = self._fork(dev)
        self.held += [sums, got]
        if self.marks is not None and not self.launches:
            self.marks[0].record(side)
        with torch.cuda.stream(side):
            KN.horner(cv, sums, c, out=got)
        done = torch.cuda.Event()
        done.record(side)
        self.launches.append((side, done))
        self.forked += len(parts)
        T.count("msm.side_chains", len(parts))
        return got

    def _fork(self, dev) -> torch.cuda.Stream:
        """A side stream, after the current stream's work so far."""
        side = torch.cuda.Stream(dev, priority=-1)
        side.wait_stream(torch.cuda.current_stream(dev))
        return side

    def join(self, k: int | None = None) -> None:
        """The current stream waits for the chains of the first k points
        `horner` returned, or for every chain where k is None (the side
        streams join into the last one, which records the end mark)."""
        if k is not None:
            for i in sorted({i for i in self.source[:k] if i is not None}):
                side, done = self.launches[i]
                torch.cuda.current_stream(side.device).wait_event(done)
            return
        if not self.held:
            return
        side, _ = self.launches[-1]
        for _, done in self.launches[:-1]:
            side.wait_event(done)
        if self.marks is not None:
            self.marks[1].record(side)
        torch.cuda.current_stream(side.device).wait_stream(side)
        self.held.clear()


def _on(device, x) -> torch.Tensor:
    """A host numpy array or a tensor, on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def msm_chunked(cv: CurveSpec, scalars_std, P, chunk_log2: int = 20, *, device):
    """MSM of an affine (wire-format) point set streamed to `device` in
    segments of 2^chunk_log2 points (groth16_tpu/ops/msm.py:msm_chunked):
    each segment runs the whole bucket phase at a segment's window, the
    per-window sums add across segments (one batched point add each), and
    one Horner finishes.

    `scalars_std` / `P` may be host numpy arrays or tensors; each segment is
    copied to `device` in turn.  At n <= 2^chunk_log2 this is `msm` of the
    whole set.  n must be a multiple of the segment size."""
    n = scalars_std.shape[0]
    chunk = 1 << chunk_log2
    if n <= chunk:
        return msm(cv, _on(device, scalars_std), tuple(_on(device, t) for t in P), affine=True)
    if n % chunk:
        raise ValueError(f"msm_chunked: {n} points is not a multiple of the "
                         f"segment size 2^{chunk_log2}; pad the MSM")
    c = pick_window_bits(chunk)
    total = None
    for s in range(0, n, chunk):
        sums = window_sums(cv, _on(device, scalars_std[s:s + chunk]),
                           tuple(_on(device, t[s:s + chunk]) for t in P), c, affine=True)
        total = sums if total is None else C.point_add(cv, total, sums)
    return horner_combine(cv, total, c)


def msm_naive(cv: CurveSpec, scalars_std: torch.Tensor, P):
    """Batched double-and-add, then a tree sum (reference msmNaiveG1/G2)."""
    return C.tree_sum(cv, C.scalar_mul(cv, scalars_std, P))
