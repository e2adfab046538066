"""Groth16 prover (the analog of reference `groth16/prover.nim`), in PyTorch.

Counterpart of the staged path of groth16_tpu/protocol/prover.py
(`generate_proof_with_mask`, prover.py:510-574).  One proof on one device:

  1. SpMV: gather witness columns, one Montgomery multiply, an int64
     segment sum into rows (exact for up to 2^46 terms a row), Cz = Az .* Bz
     (`abc_core`, reference prover.nim:56-73);
  2. quotient scalars: the three coset shifts (iNTT, scale by eta^i, NTT)
     as four batched K3 launches, then A .* B - C in one pointwise kernel;
     JensGroth also scales by 1/Z there, interpolates and un-shifts in two
     more K3 launches (reference prover.nim:118-181);
  3. five MSMs: G1 over A1, B1, H1 and C1, G2 over B2, each on the path the
     JAX package picks: H1 (as many points as the domain, 2^16 and up at
     real sizes) through the merge tree (kernels K4-K6, K8), the others
     through the fold (K2), with K1 for the bucket reduce and Horner;
  4. the O(1) spec-point algebra on host ints (prover.nim:278-302).

The device comes from the caller; nothing falls back to another device.
"""

from __future__ import annotations

import secrets
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..ops import ntt as NT
from ..ops.field import FR
from ..ops.limbs import limbs_to_ints
from ..utils import hostmath as H
from .types import Flavour, PointArray, Witness, ZKey


@dataclass
class Proof:
    """Reference prover.nim:37-43."""

    public_io: list      # plain ints, [1, pubout..., pubin...]
    pi_a: tuple          # host affine G1 (None = infinity)
    pi_b: tuple          # host affine G2
    pi_c: tuple          # host affine G1
    curve: str = "bn128"


@dataclass
class Mask:
    """Zero-knowledge masking coefficients (reference prover.nim:210-213)."""

    r: int
    s: int


def random_mask() -> Mask:
    """Masks from the OS CSPRNG."""
    return Mask(r=secrets.randbelow(FR.modulus), s=secrets.randbelow(FR.modulus))


def _dev(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# ABC: sparse SpMV + pointwise product
# ---------------------------------------------------------------------------

def segment_sum_mod(vals_mont: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """int64 [n, 16]: the modular sum of Montgomery values by segment index."""
    acc = torch.zeros((n, vals_mont.shape[-1]), dtype=torch.int64, device=vals_mont.device)
    acc.index_add_(0, seg, F.i64(vals_mont))
    return F.reduce_columns(FR, acc)


def abc_core(n_rows: int, witness_mont, coeff_mont, rows, cols, matrix_sel):
    """Az, Bz, Cz = Az .* Bz (reference buildABC, prover.nim:56-73), int64
    Montgomery [n_rows, 16].  `matrix_sel` is 0 for A entries, 1 for B."""
    w = F.as_i32(witness_mont)[cols]
    prod = F.mont_mul(FR, F.i64(coeff_mont), F.i64(w))
    sums = segment_sum_mod(prod, F.i64(matrix_sel) * n_rows + rows, 2 * n_rows)
    az, bz = sums[:n_rows], sums[n_rows:]
    return az, bz, F.mont_mul(FR, az, bz)


def build_abc(zkey: ZKey, witness_mont: torch.Tensor):
    co = zkey.coeffs
    dev = witness_mont.device
    return abc_core(zkey.header.domain_size, witness_mont, _dev(co.coeff, dev),
                    _dev(co.row.astype(np.int64), dev), _dev(co.col.astype(np.int64), dev),
                    _dev(co.matrix, dev))


# ---------------------------------------------------------------------------
# quotient scalars
# ---------------------------------------------------------------------------

def quotient_scalars(flavour: Flavour, az, bz, cz, log2n: int, plain: bool = False) -> torch.Tensor:
    """The H-points MSM scalars, per flavour (reference prover.nim:118-181),
    in standard form, uint32 [N, 16].  A, B and C go through the coset
    shift together (four K3 steps), then one pointwise pass takes A * B - C
    out of Montgomery form (Snarkjs), or scales it by 1/Z for JensGroth's
    interpolation and un-shift (two more K3 steps, eta^-i in standard form
    as the last post-multiply).  `plain` runs the plain versions on any
    device, to hold the kernels against them."""
    eta = NT.Domain(log2n + 1).gen
    inner = NT.ntt_inner_plain if plain else NT.ntt_inner
    pointwise = NT.quotient_pointwise_plain if plain else NT.quotient_pointwise
    x = torch.stack([az, bz, cz]).to(torch.uint32)
    ev = NT.transform(x, log2n, "to_coset", eta, wire_out=False, inner=inner)
    if flavour == Flavour.Snarkjs:
        # H points are shifted Lagrange bases: the coset values ARE the scalars
        return pointwise(ev, None, True)
    # JensGroth: divide by Z on the coset, (eta w^j)^N - 1 = eta^N - 1, then
    # interpolate and un-shift
    r = FR.modulus
    inv_z1 = pow(pow(eta, 1 << log2n, r) - 1, -1, r)
    ys = pointwise(ev, inv_z1, False)
    return NT.transform(ys, log2n, "from_coset_std", eta, inner=inner)[0]


# ---------------------------------------------------------------------------
# proof assembly
# ---------------------------------------------------------------------------

def _msm_to_host(cv: C.CurveSpec, scalars_std: torch.Tensor, pa: PointArray):
    dev = scalars_std.device
    P = C.from_affine(cv, _dev(pa.x, dev), _dev(pa.y, dev))
    res = M.msm(cv, scalars_std, P, affine=True)   # wire points are affine
    return C.points_to_host(cv, tuple(x[None] for x in res))[0]


def generate_proof_with_mask(zkey: ZKey, wtns: Witness, mask: Mask, device: torch.device,
                             timings: dict | None = None) -> Proof:
    """Reference generateProofWithMask (prover.nim:215-304) on `device`, a
    torch.device the caller names: the proof runs there and nowhere else."""
    hdr = zkey.header
    spec = zkey.spec
    pts = zkey.ppoints
    if hdr.curve != wtns.curve or hdr.nvars != wtns.nvars:
        raise ValueError("witness does not match the zkey")
    nvars, npubs = hdr.nvars, hdr.npubs
    if not (nvars == len(pts.points_a1) == len(pts.points_b1) == len(pts.points_b2)
            and hdr.domain_size == len(pts.points_h1)
            and nvars - npubs - 1 == len(pts.points_c1)):
        raise ValueError("zkey point sections do not match its header")
    device = torch.device(device)
    public_io = limbs_to_ints(wtns.values[: npubs + 1])

    t0 = time.perf_counter()
    witness_std = _dev(wtns.values, device)          # uint32, standard form
    witness_mont = F.to_mont(FR, witness_std)
    az, bz, cz = build_abc(zkey, witness_mont)
    _sync(device)
    t1 = time.perf_counter()

    qs_std = quotient_scalars(hdr.flavour, az, bz, cz, hdr.log_domain_size)
    _sync(device)
    t2 = time.perf_counter()

    zs_std = witness_std[npubs + 1:]
    r, s = mask.r % FR.modulus, mask.s % FR.modulus
    marks = [t2]

    def timed(fn, *args):
        out = fn(*args)
        marks.append(time.perf_counter())
        return out

    # pi_a = alpha1 + r*delta1 + MSM(w, A1)            (prover.nim:278-282)
    msm_a = timed(_msm_to_host, C.G1, witness_std, pts.points_a1)
    pi_a = H.g1_add(H.g1_add(spec.alpha1, H.g1_mul(r, spec.delta1)), msm_a)
    # rho = beta1 + s*delta1 + MSM(w, B1)              (prover.nim:285-288)
    msm_b1 = timed(_msm_to_host, C.G1, witness_std, pts.points_b1)
    rho = H.g1_add(H.g1_add(spec.beta1, H.g1_mul(s, spec.delta1)), msm_b1)
    # pi_b = beta2 + s*delta2 + MSM(w, B2)             (prover.nim:290-294)
    msm_b2 = timed(_msm_to_host, C.G2, witness_std, pts.points_b2)
    pi_b = H.g2_add(H.g2_add(spec.beta2, H.g2_mul(s, spec.delta2)), msm_b2)
    # pi_c = s*pi_a + r*rho - rs*delta1 + MSM(qs, H1) + MSM(zs, C1)
    msm_h = timed(_msm_to_host, C.G1, qs_std, pts.points_h1)
    msm_c = timed(_msm_to_host, C.G1, zs_std, pts.points_c1)
    pi_c = H.g1_mul(s, pi_a)
    pi_c = H.g1_add(pi_c, H.g1_mul(r, rho))
    pi_c = H.g1_add(pi_c, H.g1_mul((-r * s) % FR.modulus, spec.delta1))
    pi_c = H.g1_add(pi_c, msm_h)
    pi_c = H.g1_add(pi_c, msm_c)
    t3 = time.perf_counter()

    if timings is not None:
        timings.update({
            "spmv_s": t1 - t0, "quotient_s": t2 - t1,
            "msm_a1_s": marks[1] - marks[0], "msm_b1_s": marks[2] - marks[1],
            "msm_b2_s": marks[3] - marks[2], "msm_h1_s": marks[4] - marks[3],
            "msm_c1_s": marks[5] - marks[4], "total_s": t3 - t0,
        })
    return Proof(public_io=public_io, pi_a=pi_a, pi_b=pi_b, pi_c=pi_c)


def generate_proof(zkey: ZKey, wtns: Witness, device: torch.device, timings=None) -> Proof:
    """Reference prover.nim:312-319 (random masks)."""
    return generate_proof_with_mask(zkey, wtns, random_mask(), device, timings)
