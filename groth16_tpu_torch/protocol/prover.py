"""Groth16 prover (the analog of reference `groth16/prover.nim`), in PyTorch.

Counterpart of the staged path of groth16_tpu/protocol/prover.py
(`generate_proof_with_mask`, prover.py:510-574) and of its batch mode
(`generate_proofs`).  One proof on one device:

  0. the zkey's circuit-static inputs (the SpMV's sorted entries, the five
     point sets) go to the device once and stay cached on the zkey, keyed
     by device (`zkey_device_args`); a proof uploads only its witness;
  1. SpMV: Az, Bz, Cz = Az .* Bz in one kernel launch, the witness taken to
     Montgomery form inside it (`kernels.spmv`; reference prover.nim:56-73);
  2. quotient scalars: the three coset shifts (iNTT, scale by eta^i, NTT)
     as four batched K3 launches, then A .* B - C in one pointwise kernel;
     JensGroth also scales by 1/Z there, interpolates and un-shifts in two
     more K3 launches (reference prover.nim:118-181);
  3. five MSMs: G1 over A1, B1, H1 and C1, G2 over B2, each on the path the
     JAX package picks: H1 (as many points as the domain, 2^16 and up at
     real sizes) through the merge tree (kernel K8 a level, the negation
     kernel for its signed rows), the others through the fold (K2), with K1
     for the bucket reduce and Horner;
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
from ..ops import kernels as KN
from ..ops import msm as M
from ..ops import ntt as NT
from ..ops.field import FR
from ..ops.limbs import limbs_to_ints
from ..utils import hostmath as H
from .types import Flavour, Witness, ZKey


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
# the device-resident zkey
# ---------------------------------------------------------------------------

@dataclass
class DeviceZKey:
    """A zkey's circuit-static proof inputs on one device: the SpMV's rows
    and the five point sets, projective (Z in {0, Montgomery 1}) as
    `msm.msm` takes them."""

    rows: KN.SpmvRows
    a1: tuple
    b1: tuple
    b2: tuple
    c1: tuple
    h1: tuple


def _device_key(device) -> str:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def zkey_device_args(zkey: ZKey, device) -> DeviceZKey:
    """The zkey's proof inputs on `device`, uploaded at the first call for
    that device and kept in `zkey.device_cache` under it, so that a batch
    of proofs (`generate_proofs`) copies only its witnesses (reference: the
    JAX package's `zkey_device_args`, groth16_tpu/protocol/prover.py:374).
    The cache assumes the zkey's arrays do not change after the first
    proof.  `zkey_device_args.builds` counts the uploads."""
    key = _device_key(device)
    cached = zkey.device_cache.get(key)
    if cached is not None:
        return cached
    dev = torch.device(key)
    co, pp = zkey.coeffs, zkey.ppoints

    def points(cv, pa):
        return C.from_affine(cv, _dev(pa.x, dev), _dev(pa.y, dev))

    cached = DeviceZKey(
        rows=KN.spmv_rows(co.matrix, co.row, co.col, co.coeff, zkey.header.domain_size, dev),
        a1=points(C.G1, pp.points_a1), b1=points(C.G1, pp.points_b1),
        b2=points(C.G2, pp.points_b2), c1=points(C.G1, pp.points_c1),
        h1=points(C.G1, pp.points_h1))
    zkey.device_cache[key] = cached
    zkey_device_args.builds += 1
    return cached


zkey_device_args.builds = 0


# ---------------------------------------------------------------------------
# quotient scalars
# ---------------------------------------------------------------------------

def quotient_scalars(flavour: Flavour, az, bz, cz, log2n: int, plain: bool = False) -> torch.Tensor:
    """The H-points MSM scalars, per flavour (reference prover.nim:118-181),
    in standard form, uint32 [N, 16], of Az, Bz, Cz in Montgomery form
    (uint32 [N, 16] as the SpMV leaves them; other integer dtypes are
    cast).  A, B and C go through the coset
    shift together (four K3 steps), then one pointwise pass takes A * B - C
    out of Montgomery form (Snarkjs), or scales it by 1/Z for JensGroth's
    interpolation and un-shift (two more K3 steps, eta^-i in standard form
    as the last post-multiply).  `plain` runs the plain versions on any
    device, to hold the kernels against them."""
    eta = NT.Domain(log2n + 1).gen
    inner = NT.ntt_inner_plain if plain else NT.ntt_inner
    pointwise = NT.quotient_pointwise_plain if plain else NT.quotient_pointwise
    x = F.as_u32(torch.stack([F.as_i32(v.to(torch.uint32)) for v in (az, bz, cz)]))
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

def _msm_to_host(cv: C.CurveSpec, scalars_std: torch.Tensor, P):
    res = M.msm(cv, scalars_std, P, affine=True)   # wire points are affine
    return C.points_to_host(cv, tuple(x[None] for x in res))[0]


def generate_proof_with_mask(zkey: ZKey, wtns: Witness, mask: Mask, device: torch.device,
                             timings: dict | None = None) -> Proof:
    """Reference generateProofWithMask (prover.nim:215-304) on `device`, a
    torch.device the caller names: the proof runs there and nowhere else.
    The zkey's inputs are uploaded at its first proof on the device and
    reused after (`zkey_device_args`)."""
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
    static = zkey_device_args(zkey, device)
    witness_std = _dev(wtns.values, device)          # uint32, standard form
    _sync(device)
    tz = time.perf_counter()
    az, bz, cz = KN.spmv(witness_std, static.rows)
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
    msm_a = timed(_msm_to_host, C.G1, witness_std, static.a1)
    pi_a = H.g1_add(H.g1_add(spec.alpha1, H.g1_mul(r, spec.delta1)), msm_a)
    # rho = beta1 + s*delta1 + MSM(w, B1)              (prover.nim:285-288)
    msm_b1 = timed(_msm_to_host, C.G1, witness_std, static.b1)
    rho = H.g1_add(H.g1_add(spec.beta1, H.g1_mul(s, spec.delta1)), msm_b1)
    # pi_b = beta2 + s*delta2 + MSM(w, B2)             (prover.nim:290-294)
    msm_b2 = timed(_msm_to_host, C.G2, witness_std, static.b2)
    pi_b = H.g2_add(H.g2_add(spec.beta2, H.g2_mul(s, spec.delta2)), msm_b2)
    # pi_c = s*pi_a + r*rho - rs*delta1 + MSM(qs, H1) + MSM(zs, C1)
    msm_h = timed(_msm_to_host, C.G1, qs_std, static.h1)
    msm_c = timed(_msm_to_host, C.G1, zs_std, static.c1)
    pi_c = H.g1_mul(s, pi_a)
    pi_c = H.g1_add(pi_c, H.g1_mul(r, rho))
    pi_c = H.g1_add(pi_c, H.g1_mul((-r * s) % FR.modulus, spec.delta1))
    pi_c = H.g1_add(pi_c, msm_h)
    pi_c = H.g1_add(pi_c, msm_c)
    t3 = time.perf_counter()

    if timings is not None:
        timings.update({
            "upload_s": tz - t0, "spmv_s": t1 - tz, "quotient_s": t2 - t1,
            "msm_a1_s": marks[1] - marks[0], "msm_b1_s": marks[2] - marks[1],
            "msm_b2_s": marks[3] - marks[2], "msm_h1_s": marks[4] - marks[3],
            "msm_c1_s": marks[5] - marks[4], "total_s": t3 - t0,
        })
    return Proof(public_io=public_io, pi_a=pi_a, pi_b=pi_b, pi_c=pi_c)


def generate_proof_with_trivial_mask(zkey: ZKey, wtns: Witness, device: torch.device,
                                     timings: dict | None = None) -> Proof:
    """Reference prover.nim:308-310: the masks r = s = 0 (no zero knowledge;
    the proof is a function of the zkey and the witness alone)."""
    return generate_proof_with_mask(zkey, wtns, Mask(0, 0), device, timings)


def generate_proof(zkey: ZKey, wtns: Witness, device: torch.device, timings=None) -> Proof:
    """Reference prover.nim:312-319 (random masks)."""
    return generate_proof_with_mask(zkey, wtns, random_mask(), device, timings)


def generate_proofs(zkey: ZKey, witnesses, device: torch.device, masks=None,
                    timings: list | None = None) -> list:
    """Batch mode: one proof of each witness against one zkey on `device`,
    the zkey's inputs uploaded once for the batch (`zkey_device_args`).
    `masks` gives each proof's Mask (random masks where it is None);
    `timings`, where given, gets one dict of phase times per proof."""
    out = []
    for i, w in enumerate(witnesses):
        mask = masks[i] if masks is not None else random_mask()
        sink = {} if timings is not None else None
        out.append(generate_proof_with_mask(zkey, w, mask, device, sink))
        if timings is not None:
            timings.append(sink)
    return out
