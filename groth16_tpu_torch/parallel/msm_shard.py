"""The MSM with its points sharded over the ranks of a `Mesh`.

Counterpart of groth16_tpu/parallel/msm_shard.py, the map-reduce of the
reference's chunked MSM (`groth16/bn128/msm.nim:89-158`) across processes:

  * each rank holds a contiguous slab of the (scalar, point) pairs (slabs
    may be uneven; `mesh.shard_range`) and runs the whole MSM on it with
    ops/msm.py `msm`, the naive ladder or the fold by the slab's size,
    Horner included;
  * `all_gather_rows` brings every rank's one projective point to every
    rank; they are summed with K1 point adds (`curve.tree_sum`) and taken
    to affine (K6 and one K5 launch, `curve.to_affine`).

Point addition is no reduction a collective computes, so the collective is
an all_gather of one point a rank and the sum is local; the payload is one
point a rank whatever the slab's size, so nothing is padded.
"""

from __future__ import annotations

import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..ops.curve import CurveSpec
from .mesh import Mesh, all_gather_rows


def msm_sharded(cv: CurveSpec, mesh: Mesh, scalars_slab: torch.Tensor, P_slab,
                affine: bool = False):
    """sum_i s_i P_i over every rank's slab (scalars uint32 [n_r, 16],
    standard form; P projective, `affine` as `msm.msm` takes it) -> the
    affine point (x, y) of [1, comp], (0, 0) for infinity, the same on every
    rank."""
    if scalars_slab.shape[0]:
        local = M.msm(cv, scalars_slab, P_slab, affine)
    else:
        local = tuple(c[0] for c in C.inf_like(cv, (1,), scalars_slab.device))
    row = torch.cat([F.as_i32(c.to(torch.uint32)).reshape(-1) for c in local])
    X, Y, Z = (F.as_u32(g.reshape((mesh.size,) + cv.comp_shape))
               for g in all_gather_rows(mesh, row).chunk(3, dim=1))
    total = C.tree_sum(cv, (X, Y, Z))
    return C.to_affine(cv, tuple(c[None] for c in total))
