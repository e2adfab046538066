"""Batched-affine merge-tree MSM bucket accumulation.

Counterpart of groth16_tpu/ops/msm_tree.py, the bucket phase of affine MSMs
from TREE_MIN_N (2^16) points up (`msm.tree_path`).  Per window the points
are sorted by |digit|; a binary segmented merge tree over the sorted stream
keeps every partial sum affine, so each addition is a chord / tangent at
about 7 field products and one batch inversion per level serves all of the
level's additions (kernels K4, K5, K6 and K8, ops/kernels_tree.py).

Tree invariants, per window over its sorted stream of length m:

  * a node at level l covers 2^l consecutive elements and carries two
    affine partials: pL, the sum of its leftmost segment, and pR, of its
    rightmost (equal when the node is one segment, "pure");
  * merging nodes A | B computes mid = A.pR + B.pL once (used when the
    boundary keys match) and emits every segment that closes inside the
    merged node;
  * each bucket's segment closes exactly once in the whole tree or survives
    to the root, so the buckets are assembled with one index scatter and one
    gather over the emissions.

Nodes live in global bit-reversed storage order over a window group's
concatenated streams, so the merge partners of every level are the two
contiguous halves of the arrays and the boundary keys are four contiguous
slices of the bit-reversed sorted keys.  Infinity is (0, 0).
"""

from __future__ import annotations

import torch

from . import curve as C
from . import field as F
from . import kernels_tree as KT
from .curve import CurveSpec
from .field import FP
from .ntt import bitrev_perm

WINDOW_GROUP = 4   # windows per tree (groth16_tpu/ops/msm.py window_sums)


def group_buckets_tree(cv: CurveSpec, sk: torch.Tensor, cols: torch.Tensor,
                       n_buckets: int) -> torch.Tensor:
    """Merge-tree bucket sums of one group of G windows.

    sk: int64[G, m], each window's |digits| in sorted order (G, m powers of
    two).  cols: uint32[R2, G*m], the limb-major affine x|y columns of the
    sorted streams, signs applied, in global bit-reversed order.  Returns
    int32[G, n_buckets, R2] affine bucket rows; bucket 0 collects the digit-0
    points and is weighted 0 by the caller."""
    G, m = sk.shape
    R2, N = cols.shape
    dev = cols.device
    PL = PR = cols
    sk_st = sk.reshape(-1)[bitrev_perm(N, dev)]
    ems, acts, keys, wins = [], [], [], []
    K, s = N // 2, 1
    while s < m:
        A_pl, A_pr, B_pl, B_pr = PL[:, :K], PR[:, :K], PL[:, K:], PR[:, K:]
        kAL, kAR = sk_st[:K], sk_st[N - 2 * K:N - K]
        kBL, kBR = sk_st[K:2 * K], sk_st[N - K:]
        match, aP, bP = kAR == kBL, kAL == kAR, kBL == kBR
        # level 1 merges single elements, which are always pure: nothing closes
        want_em = s > 1
        PL, PR, em0 = KT.level(cv, A_pl, A_pr, B_pl, B_pr, match, aP, bP, want_em)
        if want_em:
            # slot 0: the mid, or A.pR when the segment ended at A's right
            # edge; slot 1: B.pL when it ended at B's left edge
            ems += [em0, B_pl]
            acts += [~aP & torch.where(match, ~bP, True), ~match & ~bP]
            keys += [kAR, kBL]
            # window of storage merge k: the low log2(G) bits of k, reversed
            w = bitrev_perm(G, dev)[torch.arange(K, device=dev) % G]
            wins += [w, w]
        K //= 2
        s *= 2

    # roots, one per window at storage column bitrev(g): pL always routes,
    # pR only when the root is impure
    brg = bitrev_perm(G, dev)
    kL, kR = sk[:, 0][brg], sk[:, m - 1][brg]
    ems += [PL, PR]
    acts += [torch.ones(G, dtype=torch.bool, device=dev), kL != kR]
    keys += [kL, kR]
    wins += [brg, brg]

    EM = torch.cat([F.as_i32(e) for e in ems], 1)
    ACT, KEY, WIN = torch.cat(acts), torch.cat(keys), torch.cat(wins)
    S = EM.shape[1]
    sent = G * n_buckets
    dst = torch.where(ACT, WIN * n_buckets + KEY, sent)
    slot = torch.full((sent + 1,), S, dtype=torch.int64, device=dev)
    slot.scatter_(0, dst, torch.arange(S, device=dev))
    EMx = torch.cat([EM, torch.zeros((R2, 1), dtype=torch.int32, device=dev)], 1)
    return EMx[:, slot[:sent]].T.reshape(G, n_buckets, R2)


def _pow2_groups(W: int, cap: int) -> list:
    """W windows in power-of-two groups of at most `cap`, largest first."""
    out, rem = [], W
    while rem:
        g = min(cap, 1 << (rem.bit_length() - 1))
        out.append(g)
        rem -= g
    return out


def window_sums_tree(cv: CurveSpec, scalars_std: torch.Tensor, P, c: int,
                     group: int = WINDOW_GROUP):
    """Per-window Pippenger sums (X, Y, Z) of [W, comp] through the merge
    tree.  P is projective with Z in {0, Montgomery 1} (wire-format affine
    points); windows go through the tree in power-of-two groups of at most
    `group`, so that one inversion per level serves the whole group."""
    from .msm import _weighted_bucket_reduce, signed_window_digits
    nb = (1 << (c - 1)) + 1
    n = scalars_std.shape[0]
    dev = scalars_std.device
    npad = 1 << max(1, (n - 1).bit_length())
    digits = torch.nn.functional.pad(signed_window_digits(scalars_std, c), (0, npad - n))
    W = digits.shape[0]
    K = cv.fops
    nc = KT.ncomp(cv)

    # x|y rows and x|-y rows, (0, 0) = infinity: the digit's sign picks the
    # row, so the one gather below also applies the signs
    y = K.select(K.is_zero(P[2]), torch.zeros_like(P[1]), P[1])
    x_r = F.as_i32(P[0]).reshape(n, nc)
    y_r = F.as_i32(y).reshape(n, nc)
    ny_r = F.as_i32(F.neg_mod(FP, y)).reshape(n, nc)
    pad = torch.zeros((npad - n, 2 * nc), dtype=torch.int32, device=dev)
    rows2 = torch.cat([torch.cat([x_r, y_r], 1), pad, torch.cat([x_r, ny_r], 1), pad], 0)

    groups, g0 = [], 0
    for G in _pow2_groups(W, 1 << (group.bit_length() - 1)):
        dg = digits[g0:g0 + G]
        g0 += G
        # sign packed into the key's low bit: one sort groups equal |d|
        key = (dg.abs() << 1) | (dg < 0).to(torch.int64)
        sk2, order = torch.sort(key, dim=1, stable=True)
        idx = order + (sk2 & 1) * npad
        idx_st = idx.reshape(-1)[bitrev_perm(G * npad, dev)]
        cols = F.as_u32(rows2[idx_st].T.contiguous())          # [R2, G*npad]
        groups.append(group_buckets_tree(cv, sk2 >> 1, cols, nb))

    brows = torch.cat(groups, 0)                                # [W, nb, R2]
    shape = (W, nb) + cv.comp_shape
    bx = F.as_u32(brows[..., :nc].reshape(shape))
    by = F.as_u32(brows[..., nc:].reshape(shape))
    buckets = tuple(b.transpose(0, 1) for b in C.from_affine(cv, bx, by))  # [nb, W, comp]
    return _weighted_bucket_reduce(cv, buckets, nb)


def msm_tree(cv: CurveSpec, scalars_std: torch.Tensor, P, window_bits: int = 0,
             group: int = WINDOW_GROUP):
    """Full MSM through the merge tree, at the window width of the tree
    dispatch unless `window_bits` is given."""
    from .msm import horner_combine, pick_window_bits_tree
    c = window_bits or pick_window_bits_tree(scalars_std.shape[0])
    return horner_combine(cv, window_sums_tree(cv, scalars_std, P, c, group), c)
