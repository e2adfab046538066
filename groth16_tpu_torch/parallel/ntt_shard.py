"""The four-step NTT with its rows sharded over the ranks of a `Mesh`.

Counterpart of groth16_tpu/parallel/ntt_shard.py.  N = N1 * N2 (the JAX
package's `_split`: d ranks, a power of two, and both factors multiples of
d); input index i = n1 * N2 + n2, output index k = k1 + N1 * k2, and

  X[k1 + N1 k2] = sum_{n2} w_N2^{n2 k2} [ w_N^{n2 k1} sum_{n1} x[n1 N2 + n2] w_N1^{n1 k1} ].

A transform is two K3 steps (ops/ntt.py `Step`) and one all_to_all between
them.  Rank r holds its data in one of two layouts:

  columns  the N1 values of n1 for its N2 / d values n2 = r N2/d + n2l,
           local [n1][n2l];
  rows     the N2 values of k2 for its N1 / d values k1 = r N1/d + k1l,
           local [k2][k1l].

Step 1 runs the N2 / d length-N1 transforms of the columns, multiplies by
the rank's slab of the outer twiddle w_N^{n2 k1} (with 1/N for the
inverse) and writes each destination's block where the all_to_all sends it
(K3's split output stride); step 2 reads the blocks from every rank where
they landed (K3's split input stride), runs the N1 / d length-N2 transforms
and writes the rows, multiplied where asked by a per-element table (eta^k,
eta^-k): the JAX package's `swapaxes` and `mul_by_powers` are K3 strides and
tables.  An inverse uses the factors the other way round (N1 and N2
swapped), so a transform's rows are the next transform's columns, element
for element: the quotient's chained transforms need one all_to_all each
and no copy.

`four_step_ntt` / `four_step_intt` take and return the rank's contiguous
natural-order slab, bit-exact with ops/ntt.py `forward_ntt` / `inverse_ntt`
on the gathered vector: one all_to_all more on each side (three a
transform, as in the JAX package), each beside a transposing copy, since a
collective's blocks land contiguously and no kernel runs before the first
or after the last.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import field as F
from ..ops import ntt as NT
from ..ops.field import FR
from .mesh import Mesh, all_to_all_rows

KINDS = ("forward", "inverse", "inverse_to_coset", "inverse_from_coset_std")


def _split(log2n: int, d: int) -> tuple:
    """(l1, l2): N = 2^l1 * 2^l2 with N1 = 2^l1 the column-transform length;
    both must be multiples of the power-of-two rank count d (the JAX
    package's `_split`)."""
    ld = max(0, (d - 1).bit_length())
    if d < 1 or (1 << ld) != d:
        raise ValueError(f"the rank count must be a power of two, got {d}")
    l1 = max(ld, log2n // 2)
    if log2n - l1 < ld:
        raise ValueError(f"domain 2^{log2n} too small for {d} ranks")
    return l1, log2n - l1


def factors(log2n: int, d: int, inverse: bool) -> tuple:
    """(l1, l2) of a forward transform (`_split`), swapped for an inverse."""
    l1, l2 = _split(log2n, d)
    if max(l1, l2) > NT.MAX_T.bit_length() - 1:
        raise ValueError(f"a factor of 2^{log2n} exceeds K3's {NT.MAX_T} points")
    return (l2, l1) if inverse else (l1, l2)


def layout_indices(log2n: int, d: int, r: int, low: int) -> np.ndarray:
    """int64 [2^log2n / d]: the global index of each local element of rank
    r, for a layout that gives each rank the indices whose bits [low - ld,
    low) equal r, in order of the rest (local = hi * 2^low / d + lo).  A
    forward transform's rows and an inverse's columns are low = l1, a
    forward's columns and an inverse's rows low = l2 (l1, l2 = `_split`)."""
    ld = max(0, (d - 1).bit_length())
    blk = 1 << (low - ld)
    local = np.arange(1 << (log2n - ld), dtype=np.int64)
    return (local // blk << low) + r * blk + local % blk


def _outer_twiddles(log2n: int, d: int, r: int, inverse: bool, device) -> torch.Tensor:
    """packed [N2/d * N1]: entry (i, p) = w^(n2 * rev(p)), n2 = r N2/d + i, w
    the N-th root (its inverse, times 1/N, for the inverse): step 1's post."""
    def make():
        l1, l2 = factors(log2n, d, inverse)
        dom = NT.Domain(log2n)
        root = dom.gen_inv if inverse else dom.gen
        pw = NT._powers(root, dom.size, F.R_MONT * (dom.size_inv if inverse else 1))
        c2 = (1 << l2) // d
        n2 = r * c2 + np.arange(c2, dtype=np.int64)
        exps = (n2[:, None] * NT._bitrev_indices(1 << l1)[None, :]) % dom.size
        return NT._packed([pw[e] for e in exps.reshape(-1).tolist()], device)
    return NT._cached(("shard twiddles", log2n, d, r, inverse, str(device)), make)


def _row_scale(log2n: int, d: int, r: int, inverse: bool, base: int, standard: bool,
               device) -> torch.Tensor:
    """packed [N1/d * N2]: entry (i, p) = base^k at the global index k =
    r N1/d + i + N1 rev(p) of step 2's output, Montgomery unless `standard`."""
    def make():
        l1, l2 = factors(log2n, d, inverse)
        n1 = 1 << l1
        pw = NT._powers(base, 1 << log2n, 1 if standard else F.R_MONT)
        k1 = r * (n1 // d) + np.arange(n1 // d, dtype=np.int64)
        exps = k1[:, None] + n1 * NT._bitrev_indices(1 << l2)[None, :]
        return NT._packed([pw[e] for e in exps.reshape(-1).tolist()], device)
    return NT._cached(("shard scale", log2n, d, r, inverse, base, standard, str(device)), make)


def steps(log2n: int, d: int, r: int, kind: str, B: int, device, eta: int | None = None):
    """The two K3 steps of rank r's part of one sharded transform of B
    vectors: "forward", "inverse", "inverse_to_coset" (the inverse, then
    eta^k, Montgomery) and "inverse_from_coset_std" (the inverse, then
    eta^-k in standard form).  Step 1 reads the columns [B][n1][n2l] and
    writes [dest][B][n2l][k1l]; step 2 reads what the all_to_all leaves,
    [src][B][n2l][k1l], and writes the rows [B][k2][k1l]."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}")

    def make():
        inverse = kind != "forward"
        l1, l2 = factors(log2n, d, inverse)
        N1, N2 = 1 << l1, 1 << l2
        R1, C2 = N1 // d, N2 // d
        chunk = R1 * C2                       # elements a rank sends each rank, per vector
        dom = NT.Domain(log2n)
        w, r_ = (dom.gen_inv if inverse else dom.gen), FR.modulus
        s1 = NT.Step(N1, C2, False, 1, C2, R1, 1, NT.stage_roots(N1, pow(w, N2, r_), device),
                     post=_outer_twiddles(log2n, d, r, inverse, device), ob=chunk,
                     hbits=l1 - (d - 1).bit_length(), hx=B * chunk - R1)
        post = None
        if kind == "inverse_to_coset":
            post = _row_scale(log2n, d, r, True, eta, False, device)
        elif kind == "inverse_from_coset_std":
            post = _row_scale(log2n, d, r, True, pow(eta, -1, r_), True, device)
        s2 = NT.Step(N2, R1, False, 1, R1, 1, R1, NT.stage_roots(N2, pow(w, N1, r_), device),
                     post=post, xb=chunk, gbits=l2 - (d - 1).bit_length(),
                     gx=(B - 1) * chunk)
        return s1, s2
    return NT._cached(("shard steps", log2n, d, r, kind, B, eta, str(device)), make)


def transform(mesh: Mesh, x: torch.Tensor, log2n: int, kind: str, eta: int | None = None,
              wire_out: bool = False) -> torch.Tensor:
    """Rank `mesh.rank`'s part of one sharded transform of the B vectors of
    x (uint32 [B, 2^log2n / d, 16 or 8], in the columns of this transform):
    step 1, the all_to_all, step 2 (K3 on CUDA tensors, its plain version on
    CPU tensors); returns the rows, packed (wire if `wire_out`)."""
    B = x.shape[0]
    s1, s2 = steps(log2n, mesh.size, mesh.rank, kind, B, x.device, eta)
    y = NT.ntt_inner(x, s1, False)
    y = all_to_all_rows(mesh, y.reshape(-1, NT.PACKED)).reshape(y.shape)
    return NT.ntt_inner(y, s2, wire_out)


def _natural(dom: NT.Domain, mesh: Mesh, x_local: torch.Tensor, inverse: bool) -> torch.Tensor:
    d = mesh.size
    l1, l2 = factors(dom.log2_size, d, inverse)
    R1, C2 = (1 << l1) // d, (1 << l2) // d
    W = x_local.shape[-1]
    if tuple(x_local.shape) != (dom.size // d, W):
        raise ValueError(f"a rank's slab of 2^{dom.log2_size} is [{dom.size // d}, 16]")
    # slab m = mh N2 + j N2/d + ml: rank j's columns come from (mh, ml)
    send = F.as_u32(F.as_i32(x_local).view(R1, d, C2, W).transpose(0, 1).reshape(-1, W))
    cols = all_to_all_rows(mesh, send)
    rows = transform(mesh, cols[None], dom.log2_size, "inverse" if inverse else "forward",
                     wire_out=True)[0]
    # rows [k2][k1l]: k2's blocks go to the ranks whose slab they are
    back = F.as_i32(all_to_all_rows(mesh, rows))
    return F.as_u32(back.view(d, C2, R1, W).transpose(0, 1).reshape(-1, W))


def four_step_ntt(dom: NT.Domain, mesh: Mesh, x_local: torch.Tensor) -> torch.Tensor:
    """Forward NTT of the vector whose rank-r slab x_local (uint32 [N / d,
    16], Montgomery, natural order) each rank holds; returns the rank's
    slab of the result, bit-exact with ops/ntt.py `forward_ntt`."""
    return _natural(dom, mesh, x_local, False)


def four_step_intt(dom: NT.Domain, mesh: Mesh, x_local: torch.Tensor) -> torch.Tensor:
    """Inverse NTT of the rank's slab, bit-exact with `inverse_ntt`."""
    return _natural(dom, mesh, x_local, True)
