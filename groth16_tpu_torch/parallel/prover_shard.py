"""The Groth16 proof with its rows and points sharded over the ranks of a
`Mesh`.

Counterpart of groth16_tpu/parallel/prover_shard.py
(`prove_staged_sharded`).  Every rank runs:

  1. the SpMV on its rows only (kernels.spmv over `zkey_shard_args`' rows):
     the rows the first sharded transform's columns hold, in that order,
     so Az, Bz and Cz never cross ranks; the witness is replicated;
  2. the quotient (`quotient_scalars_sharded`): the coset shift as a
     sharded inverse and forward transform (parallel/ntt_shard.py, one
     all_to_all each), eta^i in the inverse's last K3 table; A*B - C, 1/Z
     and the move out of Montgomery form in the pointwise kernel on the
     rank's slab; JensGroth's interpolation and eta^-i un-shift as one more
     sharded inverse.  A, B and C share every launch and every all_to_all;
     no plain field arithmetic runs on the card;
  3. the five MSMs point-sharded (`msm_sharded`): A1, B1, B2 and C1 over the
     rank's contiguous slab of the witness, H1 over the H points of the
     domain indices whose scalars the quotient left on the rank, so nothing
     is regathered; one all_gather of one point an MSM;
  4. the spec-point algebra and the affine conversion on the device
     (`prover.spec_algebra`, `prover.proof_buffer`), as the single-device
     proof runs them.

Every rank returns the same proof, byte-identical to
`generate_proof_with_mask` for the same mask.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops import kernels as KN
from ..ops import ntt as NT
from ..ops.field import FR
from ..protocol import prover as PV
from ..protocol.prover import Mask, Proof, device_key, to_device
from ..protocol.types import Flavour, Witness, ZKey
from .mesh import Mesh, shard_range
from .msm_shard import msm_sharded
from .ntt_shard import factors, layout_indices, transform


@dataclass
class ShardZKey:
    """A rank's part of a zkey's proof inputs on its device: the SpMV rows
    it computes (local order = the inverse transform's columns), the slabs
    [lo, hi) of the witness-indexed point sets (A1, B1, B2 over the witness,
    C1 over its private part) and its H1 points in the order of its
    quotient scalars."""

    rows: KN.SpmvRows
    witness_slab: tuple
    c1_slab: tuple
    a1: tuple
    b1: tuple
    b2: tuple
    c1: tuple
    h1: tuple


def h1_indices(log2n: int, d: int, r: int, flavour: Flavour) -> np.ndarray:
    """The domain indices of rank r's quotient scalars, in their order: the
    rows of the forward transform (Snarkjs) or of JensGroth's last inverse."""
    l1, l2 = factors(log2n, d, False)
    return layout_indices(log2n, d, r, l1 if flavour == Flavour.Snarkjs else l2)


def zkey_shard_args(zkey: ZKey, mesh: Mesh) -> ShardZKey:
    """Rank mesh.rank's part of the zkey on mesh.device, built at the first
    call and kept in `zkey.device_cache` under the device, the rank, the
    rank count and the flavour (as `prover.zkey_device_args` keeps the whole
    zkey).  `zkey_shard_args.builds` counts the uploads."""
    hdr = zkey.header
    key = ("shard", device_key(mesh.device), mesh.rank, mesh.size, hdr.flavour)
    cached = zkey.device_cache.get(key)
    if cached is not None:
        return cached
    dev, d, r = mesh.device, mesh.size, mesh.rank
    t = hdr.log_domain_size
    co, pp = zkey.coeffs, zkey.ppoints
    # SpMV rows: those the inverse transform's columns hold (`layout_indices`
    # of the forward's rows), renumbered to their local positions
    l1, _ = factors(t, d, False)
    ld = (d - 1).bit_length()
    row = np.asarray(co.row, np.int64)
    lo_bits = row & ((1 << l1) - 1)
    mine = (lo_bits >> (l1 - ld)) == r
    blk = 1 << (l1 - ld)
    local = (row[mine] >> l1) * blk + (lo_bits[mine] & (blk - 1))
    rows = KN.spmv_rows(np.asarray(co.matrix)[mine], local, np.asarray(co.col)[mine],
                        np.asarray(co.coeff)[mine], hdr.domain_size // d, dev)

    def points(cv, pa, sel):
        return C.from_affine(cv, to_device(pa.x[sel], dev), to_device(pa.y[sel], dev))

    ws = shard_range(hdr.nvars, r, d)
    cs = shard_range(hdr.nvars - hdr.npubs - 1, r, d)
    wsl, csl = slice(*ws), slice(*cs)
    cached = ShardZKey(rows=rows, witness_slab=ws, c1_slab=cs,
                       a1=points(C.G1, pp.points_a1, wsl), b1=points(C.G1, pp.points_b1, wsl),
                       b2=points(C.G2, pp.points_b2, wsl), c1=points(C.G1, pp.points_c1, csl),
                       h1=points(C.G1, pp.points_h1, h1_indices(t, d, r, hdr.flavour)))
    zkey.device_cache[key] = cached
    zkey_shard_args.builds += 1
    return cached


zkey_shard_args.builds = 0


def quotient_scalars_sharded(flavour: Flavour, mesh: Mesh, az, bz, cz, log2n: int) -> torch.Tensor:
    """Rank mesh.rank's H-points MSM scalars (standard form, uint32 [N / d,
    16], at the domain indices `h1_indices` gives) from its Az, Bz, Cz
    (Montgomery, uint32 [N / d, 16], the inverse transform's columns, as
    the SpMV over `zkey_shard_args`' rows leaves them).  The K3 launches
    and the pointwise kernel are those of `prover.quotient_scalars` (four
    and one, Snarkjs; six and one, JensGroth) with one all_to_all a
    transform between them; on CPU tensors their plain versions."""
    eta = NT.Domain(log2n + 1).gen
    x = F.as_u32(torch.stack([F.as_i32(v.to(torch.uint32)) for v in (az, bz, cz)]))
    x = transform(mesh, x, log2n, "inverse_to_coset", eta)
    ev = transform(mesh, x, log2n, "forward")
    if flavour == Flavour.Snarkjs:
        return NT.quotient_pointwise(ev, None, True)
    r = FR.modulus
    inv_z1 = pow(pow(eta, 1 << log2n, r) - 1, -1, r)
    ys = NT.quotient_pointwise(ev, inv_z1, False)
    return transform(mesh, ys, log2n, "inverse_from_coset_std", eta, wire_out=True)[0]


def generate_proof_sharded(zkey: ZKey, wtns: Witness, mask: Mask, mesh: Mesh,
                           timings: dict | None = None) -> Proof:
    """Reference generateProofWithMask (prover.nim:215-304) sharded over the
    ranks of `mesh`, each on mesh.device; every rank calls it with the same
    zkey, witness and mask and gets the same Proof.  The device waits at
    the end of each phase, for its time: `timings` gets upload_s (the
    rank's part of the zkey at its first proof, the witness), spmv_s,
    quotient_s (with its all_to_alls), msm_a1_s, msm_b1_s, msm_b2_s,
    msm_h1_s and msm_c1_s (each with its all_gather), algebra_s (the
    spec-point algebra and the proof points to the host), total_s, and
    comm_s, the seconds inside the collectives where mesh.timed is set."""
    hdr, dev = zkey.header, mesh.device
    comm0 = mesh.comm_s
    pub = PV.public_io(zkey, wtns)
    marks = [time.perf_counter()]

    def mark():
        PV.sync(dev)
        marks.append(time.perf_counter())

    static = zkey_shard_args(zkey, mesh)
    spec = PV.spec_args(zkey, dev)
    w = to_device(wtns.values, dev)                  # uint32, standard form
    mark()
    az, bz, cz = KN.spmv(w, static.rows)
    mark()
    qs = quotient_scalars_sharded(hdr.flavour, mesh, az, bz, cz, hdr.log_domain_size)
    mark()
    w_slab = w[slice(*static.witness_slab)]
    zs_slab = w[hdr.npubs + 1:][slice(*static.c1_slab)]
    msms = []
    for cv, sc, P in ((C.G1, w_slab, static.a1), (C.G1, w_slab, static.b1),
                      (C.G2, w_slab, static.b2), (C.G1, qs, static.h1),
                      (C.G1, zs_slab, static.c1)):
        x, y = msm_sharded(cv, mesh, sc, P, affine=True)
        msms.append(tuple(c[0] for c in C.from_affine(cv, x, y)))
        mark()
    mask_std = to_device(PV.mask_limbs(mask), dev)
    buf = PV.proof_buffer(*PV.spec_algebra(spec, msms, mask_std))
    pi_a, pi_b, pi_c = PV.proof_points(buf.cpu())
    marks.append(time.perf_counter())
    if timings is not None:
        steps = ("upload_s", "spmv_s", "quotient_s", "msm_a1_s", "msm_b1_s", "msm_b2_s",
                 "msm_h1_s", "msm_c1_s", "algebra_s")
        timings.update({k: b - a for k, a, b in zip(steps, marks, marks[1:])})
        timings.update(total_s=marks[-1] - marks[0], comm_s=mesh.comm_s - comm0)
    return Proof(public_io=pub, pi_a=pi_a, pi_b=pi_b, pi_c=pi_c)
