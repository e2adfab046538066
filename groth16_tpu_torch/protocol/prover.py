"""Groth16 prover (the analog of reference `groth16/prover.nim`), in PyTorch.

Counterpart of groth16_tpu/protocol/prover.py: the staged path
(`generate_proof_with_mask`, prover.py:510-574), the fused one-dispatch
prover (`prove_core_device` :205-282, `_generate_proof_fused` :429-459, the
selection of :476-509) and batch mode (`generate_proofs`).  One proof on one
device:

  0. the zkey's circuit-static inputs (the SpMV's sorted entries, the five
     point sets) go to the device once and stay cached on the zkey, keyed
     by device (`zkey_device_args`); a proof uploads only its witness and
     masks;
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
  4. the O(1) spec-point algebra (prover.nim:278-302).

Two paths run these steps.  The staged path (`prove_phases`) synchronizes
after each phase, brings each MSM's point to the host and runs step 4 on
host ints.  The fused path (`prove_core_device`) runs steps 1-4 and the
affine conversion on the device with no host round trip and no branch on
device data; on a CUDA device it is captured once per (zkey, device,
flavour) as a CUDA graph (`FusedProof`, which also holds the spec points
and the window tables of delta1 and delta2 on the device), and a proof is
one replay, whose only device-to-host traffic is the three proof points.  `fused=None` takes
the fused path on a CUDA device and the staged one on the CPU, where no
graph exists; both give the same proof for the same mask.

The device comes from the caller; nothing falls back to another device or
path.
"""

from __future__ import annotations

import secrets
import threading
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
from ..ops.limbs import ints_to_limbs, limbs_to_ints
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
# the spec-point algebra on the device
# ---------------------------------------------------------------------------

SPEC_WINDOW = 4                       # bits a window of the algebra's scalar products
PROOF_WORDS = 128                     # uint32 words of the affine pi_a, pi_c, pi_b


@dataclass
class DeviceSpec:
    """The spec points of the fused path's algebra on one device: alpha1
    and beta1 as one G1 batch of two, beta2, and the fixed-base window
    tables of delta1 and delta2 (`curve.window_table`, SPEC_WINDOW bits)."""

    alpha1_beta1: tuple
    beta2: tuple
    delta1: tuple
    delta2: tuple


def spec_device_args(zkey: ZKey, device) -> DeviceSpec:
    """The zkey's spec points on `device` (the JAX package's
    zkey_device_args, groth16_tpu/protocol/prover.py:400-406, with window
    tables for delta): a few host doublings, 2 (SPEC_WINDOW - 1) K1
    launches a table on CUDA.  `FusedProof` keeps them, so the staged path
    never builds them."""
    dev, spec = torch.device(_device_key(device)), zkey.spec
    return DeviceSpec(alpha1_beta1=C.points_from_host(C.G1, [spec.alpha1, spec.beta1], dev),
                      beta2=C.points_from_host(C.G2, [spec.beta2], dev),
                      delta1=C.window_table(C.G1, spec.delta1, SPEC_WINDOW, dev),
                      delta2=C.window_table(C.G2, spec.delta2, SPEC_WINDOW, dev))


def table_mul(cv: C.CurveSpec, table, scalars_std: torch.Tensor) -> tuple:
    """[k_i] Q of a SPEC_WINDOW `window_table` of Q: each window's digit
    picks one entry of its column, and one K1 `tree_sum` adds the picks
    (log2 of the window count launches on CUDA tensors).  Returns [n]
    projective."""
    d = C.window_digits(scalars_std, SPEC_WINDOW).T                    # [W, n]
    w = torch.arange(d.shape[0], device=d.device)[:, None]
    return C.tree_sum(cv, C.table_picks(table, d, w))


def window_mul(cv: C.CurveSpec, P, scalars_std: torch.Tensor) -> tuple:
    """Batched variable-base [k_i] P_i of a point batch P [n]: the multiples
    of each P_i (`curve.multiples`), one pick a window, and one K1 `horner`
    over the picks (one thread a point)."""
    U = C.multiples(cv, P, SPEC_WINDOW)                                 # [2^c, n]
    d = C.window_digits(scalars_std, SPEC_WINDOW)                       # [n, W]
    i = torch.arange(d.shape[0], device=d.device)[:, None]
    return C.horner(cv, C.table_picks(U, d, i), SPEC_WINDOW)


def mask_limbs(mask: Mask) -> np.ndarray:
    """uint32 [3, 16]: the standard-form limbs of r, s and (-r s) mod q, the
    mask buffer of `prove_core_device` (rs from the host ints: O(1) work
    that leaves the plain field products off the device)."""
    r, s = mask.r % FR.modulus, mask.s % FR.modulus
    return ints_to_limbs([r, s, (-r * s) % FR.modulus])


def spec_algebra(spec: DeviceSpec, msms, mask_std: torch.Tensor) -> tuple:
    """The masked spec-point algebra of reference prover.nim:278-302 on the
    device (the JAX package's prove_core_device, prover.py:231-281), of the
    five MSM results (A1, B1, B2, H1, C1; projective, no batch axis) and the
    mask buffer (`mask_limbs`):

        pi_a = alpha1 + r delta1 + MSM_A
        rho  = beta1 + s delta1 + MSM_B1
        pi_b = beta2 + s delta2 + MSM_B2
        pi_c = s pi_a + r rho - rs delta1 + MSM_H + MSM_C

    r delta1, s delta1, -rs delta1 and s delta2 from the window tables
    (`table_mul`), s pi_a and r rho as one batch of two (`window_mul`).
    Returns projective (pi_a, pi_b, pi_c)."""
    msm_a, msm_b1, msm_b2, msm_h, msm_c = (tuple(c[None] for c in P) for P in msms)
    fixed = table_mul(C.G1, spec.delta1, mask_std)                     # r, s, -rs delta1
    s_delta2 = table_mul(C.G2, spec.delta2, mask_std[1:2])
    a_rho = C.point_add(C.G1, spec.alpha1_beta1, tuple(c[:2] for c in fixed))
    a_rho = C.point_add(C.G1, a_rho, C.cat_points([msm_a, msm_b1]))   # pi_a, rho
    pi_b = C.point_add(C.G2, C.point_add(C.G2, spec.beta2, s_delta2), msm_b2)
    s_r = F.as_u32(torch.stack([F.as_i32(mask_std[1]), F.as_i32(mask_std[0])]))
    post = window_mul(C.G1, a_rho, s_r)                                  # s pi_a, r rho
    pi_c = C.tree_sum(C.G1, C.cat_points([post, tuple(c[2:] for c in fixed), msm_h, msm_c]))
    return tuple(c[0] for c in a_rho), tuple(c[0] for c in pi_b), pi_c


def proof_buffer(pi_a, pi_b, pi_c) -> torch.Tensor:
    """uint32 [PROOF_WORDS]: the affine Montgomery limbs of pi_a and pi_c
    (one `to_affine` of the G1 pair) and of pi_b (one of G2), x before y."""
    g1 = C.to_affine(C.G1, C.cat_points([tuple(c[None] for c in P) for P in (pi_a, pi_c)]))
    g2 = C.to_affine(C.G2, tuple(c[None] for c in pi_b))
    return F.as_u32(torch.cat([F.as_i32(c).reshape(-1) for c in g1 + g2]))


def proof_points(buf) -> tuple:
    """Host affine (pi_a, pi_b, pi_c) of a `proof_buffer` (a tensor or a
    numpy array on the host; None = infinity)."""
    b = torch.as_tensor(np.asarray(buf).view(np.int32)).reshape(-1)
    pi_a, pi_c = C.affine_to_host(C.G1, b[:32].reshape(2, 16), b[32:64].reshape(2, 16))
    (pi_b,) = C.affine_to_host(C.G2, b[64:96].reshape(1, 2, 16), b[96:].reshape(1, 2, 16))
    return pi_a, pi_b, pi_c


def core_msms(flavour: Flavour, log2n: int, static: DeviceZKey,
              witness_std: torch.Tensor) -> tuple:
    """The SpMV, the quotient and the five MSMs of one proof (projective A1,
    B1, B2, H1, C1 sums), each MSM on the path the staged proof takes.  The
    public part of the witness is what C1 does not cover."""
    az, bz, cz = KN.spmv(witness_std, static.rows)
    qs = quotient_scalars(flavour, az, bz, cz, log2n)
    zs = witness_std[witness_std.shape[0] - static.c1[0].shape[0]:]
    return (M.msm(C.G1, witness_std, static.a1, affine=True),
            M.msm(C.G1, witness_std, static.b1, affine=True),
            M.msm(C.G2, witness_std, static.b2, affine=True),
            M.msm(C.G1, qs, static.h1, affine=True),
            M.msm(C.G1, zs, static.c1, affine=True))


def prove_core_device(flavour: Flavour, log2n: int, static: DeviceZKey, spec: DeviceSpec,
                      witness_std: torch.Tensor, mask_std: torch.Tensor) -> torch.Tensor:
    """One whole proof's device work (the JAX package's prove_core_device,
    groth16_tpu/protocol/prover.py:205-282): SpMV, quotient, five MSMs, the
    spec-point algebra and the affine conversion, with no host round trip
    and no branch on device data, so that a CUDA graph can capture it.
    `static` and `spec` the zkey's `zkey_device_args` and
    `spec_device_args`; `witness_std` uint32 [nvars, 16] standard form;
    `mask_std` the mask buffer (`mask_limbs`) on the same device.  Returns
    the `proof_buffer`.
    It runs eagerly on any device: on CPU tensors through the plain
    versions of the kernels."""
    return proof_buffer(*spec_algebra(spec, core_msms(flavour, log2n, static, witness_std),
                                      mask_std))


# ---------------------------------------------------------------------------
# proof assembly
# ---------------------------------------------------------------------------

def _msm_to_host(cv: C.CurveSpec, scalars_std: torch.Tensor, P):
    res = M.msm(cv, scalars_std, P, affine=True)   # wire points are affine
    return C.points_to_host(cv, tuple(x[None] for x in res))[0]


def _public_io(zkey: ZKey, wtns: Witness) -> list:
    """The proof's public IO, after checking the witness against the zkey
    and the zkey's point sections against its header."""
    hdr, pts = zkey.header, zkey.ppoints
    if hdr.curve != wtns.curve or hdr.nvars != wtns.nvars:
        raise ValueError("witness does not match the zkey")
    nvars, npubs = hdr.nvars, hdr.npubs
    if not (nvars == len(pts.points_a1) == len(pts.points_b1) == len(pts.points_b2)
            and hdr.domain_size == len(pts.points_h1)
            and nvars - npubs - 1 == len(pts.points_c1)):
        raise ValueError("zkey point sections do not match its header")
    return limbs_to_ints(wtns.values[: npubs + 1])


def prove_phases(zkey: ZKey, wtns: Witness, mask: Mask, device: torch.device, static_args,
                 quotient, msms, timings: dict | None = None) -> Proof:
    """The proof's phases on `device`, shared by `generate_proof_with_mask`
    and the sharded prover (parallel/prover_shard.py): the zkey and witness
    checks, the witness upload, the SpMV, the quotient, the five MSMs and
    the spec-point algebra on host ints (prover.nim:278-302).  The callers
    differ in three callables: `static_args()` gives the zkey's device
    inputs (with the SpMV `rows`), `quotient(az, bz, cz)` the H1 scalars,
    and `msms(static, witness_std, qs_std)` yields the five MSMs' host
    points in the order A1, B1, B2, H1, C1.  `timings` gets upload_s,
    spmv_s, quotient_s, msm_*_s (each to its host point), algebra_s (the
    spec-point algebra on host ints) and total_s."""
    spec = zkey.spec
    public_io = _public_io(zkey, wtns)

    t0 = time.perf_counter()
    static = static_args()
    witness_std = _dev(wtns.values, device)          # uint32, standard form
    _sync(device)
    tz = time.perf_counter()
    az, bz, cz = KN.spmv(witness_std, static.rows)
    _sync(device)
    t1 = time.perf_counter()
    qs_std = quotient(az, bz, cz)
    _sync(device)
    marks = [time.perf_counter()]
    host = []
    for pt in msms(static, witness_std, qs_std):
        host.append(pt)
        marks.append(time.perf_counter())
    msm_a, msm_b1, msm_b2, msm_h, msm_c = host

    r, s = mask.r % FR.modulus, mask.s % FR.modulus
    # pi_a = alpha1 + r*delta1 + MSM(w, A1)            (prover.nim:278-282)
    pi_a = H.g1_add(H.g1_add(spec.alpha1, H.g1_mul(r, spec.delta1)), msm_a)
    # rho = beta1 + s*delta1 + MSM(w, B1)              (prover.nim:285-288)
    rho = H.g1_add(H.g1_add(spec.beta1, H.g1_mul(s, spec.delta1)), msm_b1)
    # pi_b = beta2 + s*delta2 + MSM(w, B2)             (prover.nim:290-294)
    pi_b = H.g2_add(H.g2_add(spec.beta2, H.g2_mul(s, spec.delta2)), msm_b2)
    # pi_c = s*pi_a + r*rho - rs*delta1 + MSM(qs, H1) + MSM(zs, C1)
    pi_c = H.g1_mul(s, pi_a)
    pi_c = H.g1_add(pi_c, H.g1_mul(r, rho))
    pi_c = H.g1_add(pi_c, H.g1_mul((-r * s) % FR.modulus, spec.delta1))
    pi_c = H.g1_add(pi_c, msm_h)
    pi_c = H.g1_add(pi_c, msm_c)
    t3 = time.perf_counter()

    if timings is not None:
        timings.update({
            "upload_s": tz - t0, "spmv_s": t1 - tz, "quotient_s": marks[0] - t1,
            "msm_a1_s": marks[1] - marks[0], "msm_b1_s": marks[2] - marks[1],
            "msm_b2_s": marks[3] - marks[2], "msm_h1_s": marks[4] - marks[3],
            "msm_c1_s": marks[5] - marks[4], "algebra_s": t3 - marks[5], "total_s": t3 - t0,
        })
    return Proof(public_io=public_io, pi_a=pi_a, pi_b=pi_b, pi_c=pi_c)


# ---------------------------------------------------------------------------
# the fused proof: one CUDA graph replay a proof
# ---------------------------------------------------------------------------

class FusedProof:
    """`prove_core_device` of one zkey and flavour captured as a CUDA graph
    on one device (the port's counterpart of the JAX package's one jitted
    program a proof, groth16_tpu/protocol/prover.py:429-459).  It holds the
    zkey's spec points (`spec_device_args`), the static witness and mask
    buffers the graph reads, the proof buffer it writes, pinned host
    buffers for both ends, and the graph.  Its life: `warm_up()` runs the
    core once eagerly on a side stream (the kernel library, the constant
    and NTT-table caches, the sorts' scratch space), `capture()` records
    one more run, and each proof is `load(wtns, mask)` then `replay()`,
    both under the object's `lock`, so that threads proving with one zkey
    take turns with its buffers.  A failed capture or replay raises.
    The graph's memory pool keeps one proof's intermediates (about 0.3 GiB
    at 2^16) for as long as the object lives."""

    def __init__(self, zkey: ZKey, device):
        self.device = torch.device(_device_key(device))
        if self.device.type != "cuda":
            raise ValueError(f"a fused proof captures a CUDA graph: it needs a CUDA device, "
                             f"not {self.device}")
        hdr = zkey.header
        self.flavour, self.log2n = hdr.flavour, hdr.log_domain_size
        self.static = zkey_device_args(zkey, self.device)
        self.spec = spec_device_args(zkey, self.device)
        shape = (hdr.nvars, 16)
        self.witness = torch.zeros(shape, dtype=torch.uint32, device=self.device)
        self.mask = torch.zeros((3, 16), dtype=torch.uint32, device=self.device)
        self.host_witness = torch.empty(shape, dtype=torch.int32, pin_memory=True)
        self.host_mask = torch.empty((3, 16), dtype=torch.int32, pin_memory=True)
        self.host_out = torch.empty(PROOF_WORDS, dtype=torch.int32, pin_memory=True)
        self.graph = None
        self.out = None
        self.lock = threading.Lock()

    def _core(self) -> torch.Tensor:
        return prove_core_device(self.flavour, self.log2n, self.static, self.spec, self.witness,
                                 self.mask)

    def warm_up(self) -> None:
        """One eager run of the core on a side stream (PyTorch's recipe
        before a capture), so that nothing of the capture allocates host
        memory or copies from the host."""
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._core()
            main.wait_stream(side)
            torch.cuda.synchronize()

    def capture(self) -> None:
        """Record the core into the graph; its output is the proof buffer
        that every replay rewrites."""
        with torch.cuda.device(self.device):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self._core()
            self.graph, self.out = graph, out

    def load(self, wtns: Witness, mask: Mask) -> None:
        """Copy a witness and its masks into the static buffers, from pinned
        host memory, on the current stream (no synchronization)."""
        self.host_witness.numpy().view(np.uint32)[...] = wtns.values
        self.host_mask.numpy().view(np.uint32)[...] = mask_limbs(mask)
        with torch.cuda.device(self.device):
            F.as_i32(self.witness).copy_(self.host_witness, non_blocking=True)
            F.as_i32(self.mask).copy_(self.host_mask, non_blocking=True)

    def replay(self) -> np.ndarray:
        """Replay the graph on the loaded buffers and return the proof
        buffer, copied to the host (the one synchronization of a proof)."""
        if self.graph is None:
            raise RuntimeError("replay before capture")
        with torch.cuda.device(self.device):
            self.graph.replay()
            self.host_out.copy_(F.as_i32(self.out), non_blocking=True)
            torch.cuda.current_stream().synchronize()
        return self.host_out.numpy().view(np.uint32).copy()


_FUSED_LOCK = threading.Lock()   # one capture at a time, and one per key


def _fused_key(zkey: ZKey, device) -> tuple:
    return ("fused", _device_key(device), zkey.header.flavour.value)


def fused_graph(zkey: ZKey, device) -> FusedProof:
    """The zkey's FusedProof on `device` for the flavour its header names,
    warmed up and captured at the first call and kept in
    `zkey.device_cache` beside its DeviceZKey; `fused_graph.captures`
    counts the captures.  Threads that ask for one key at once wait for
    its one capture."""
    key = _fused_key(zkey, device)
    fp = zkey.device_cache.get(key)
    if fp is not None:
        return fp
    with _FUSED_LOCK:
        fp = zkey.device_cache.get(key)
        if fp is None:
            fp = FusedProof(zkey, device)
            fp.warm_up()
            fp.capture()
            zkey.device_cache[key] = fp
            fused_graph.captures += 1
    return fp


fused_graph.captures = 0


def _generate_proof_fused(zkey: ZKey, wtns: Witness, mask: Mask, device,
                          timings: dict | None) -> Proof:
    """One proof as one replay of the zkey's graph, its buffers held under
    the graph's lock from the load to the copy back.
    `timings` gets upload_s (the zkey's upload at its first proof on the
    device, then the witness and masks queued into the static buffers),
    capture_s (the spec points, warm-up and capture, on the proof that
    captured), device_core_s (the replay up to the proof buffer on the
    host) and total_s."""
    public_io = _public_io(zkey, wtns)
    t0 = time.perf_counter()
    zkey_device_args(zkey, device)
    t1 = time.perf_counter()
    captured = _fused_key(zkey, device) not in zkey.device_cache
    fp = fused_graph(zkey, device)
    t2 = time.perf_counter()
    with fp.lock:
        fp.load(wtns, mask)
        t3 = time.perf_counter()
        buf = fp.replay()
    t4 = time.perf_counter()
    pi_a, pi_b, pi_c = proof_points(buf)
    if timings is not None:
        timings.update({"upload_s": (t1 - t0) + (t3 - t2), "device_core_s": t4 - t3,
                        "total_s": time.perf_counter() - t0})
        if captured:
            timings["capture_s"] = t2 - t1
    return Proof(public_io=public_io, pi_a=pi_a, pi_b=pi_b, pi_c=pi_c)


def _use_fused(fused: bool | None, device: torch.device) -> bool:
    """The path of a proof on `device`: `fused=None` is fused on a CUDA
    device and staged on the CPU, where no graph exists (the JAX package's
    fused-on-the-TPU default); `fused=True` on a CPU device raises."""
    if fused is None:
        return device.type == "cuda"
    if fused and device.type != "cuda":
        raise ValueError(f"fused=True needs a CUDA device (a CUDA graph a proof), not {device}")
    return bool(fused)


def generate_proof_with_mask(zkey: ZKey, wtns: Witness, mask: Mask, device: torch.device,
                             timings: dict | None = None, fused: bool | None = None) -> Proof:
    """Reference generateProofWithMask (prover.nim:215-304) on `device`, a
    torch.device the caller names: the proof runs there and nowhere else.
    The zkey's inputs are uploaded at its first proof on the device and
    reused after (`zkey_device_args`).  `fused` picks the path
    (`_use_fused`): the fused one is one replay of a CUDA graph captured
    at the zkey's first fused proof on the device (`fused_graph`); the
    staged one is `prove_phases`.  Both give the same proof."""
    device = torch.device(device)
    if _use_fused(fused, device):
        return _generate_proof_fused(zkey, wtns, mask, device, timings)
    hdr = zkey.header

    def msms(static, w, qs):
        for cv, sc, P in ((C.G1, w, static.a1), (C.G1, w, static.b1), (C.G2, w, static.b2),
                          (C.G1, qs, static.h1), (C.G1, w[hdr.npubs + 1:], static.c1)):
            yield _msm_to_host(cv, sc, P)

    return prove_phases(zkey, wtns, mask, device, lambda: zkey_device_args(zkey, device),
                        lambda az, bz, cz: quotient_scalars(hdr.flavour, az, bz, cz,
                                                            hdr.log_domain_size),
                        msms, timings)


def generate_proof_with_trivial_mask(zkey: ZKey, wtns: Witness, device: torch.device,
                                     timings: dict | None = None,
                                     fused: bool | None = None) -> Proof:
    """Reference prover.nim:308-310: the masks r = s = 0 (no zero knowledge;
    the proof is a function of the zkey and the witness alone)."""
    return generate_proof_with_mask(zkey, wtns, Mask(0, 0), device, timings, fused)


def generate_proof(zkey: ZKey, wtns: Witness, device: torch.device, timings=None,
                   fused: bool | None = None) -> Proof:
    """Reference prover.nim:312-319 (random masks)."""
    return generate_proof_with_mask(zkey, wtns, random_mask(), device, timings, fused)


def generate_proofs(zkey: ZKey, witnesses, device: torch.device, masks=None,
                    timings: list | None = None, fused: bool | None = None) -> list:
    """Batch mode: one proof of each witness against one zkey on `device`,
    the zkey's inputs uploaded once for the batch (`zkey_device_args`); on
    the fused path the first proof captures the graph and every later one
    is a replay.  `masks` gives each proof's Mask (random masks where it is
    None); `timings`, where given, gets one dict of phase times per proof."""
    out = []
    for i, w in enumerate(witnesses):
        mask = masks[i] if masks is not None else random_mask()
        sink = {} if timings is not None else None
        out.append(generate_proof_with_mask(zkey, w, mask, device, sink, fused))
        if timings is not None:
            timings.append(sink)
    return out
