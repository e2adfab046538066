"""Groth16 prover (the analog of reference `groth16/prover.nim`), in PyTorch.

Counterpart of groth16_tpu/protocol/prover.py: the one-dispatch prover
(`prove_core_device` :205-282, `_generate_proof_fused` :429-459) and batch
mode (`generate_proofs`).  One proof on one device:

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
  3. five MSMs: G1 over A1, B1, H1 and C1, G2 over B2, each through the
     fold (K2; `msm.msm_sums`), with K1 for the bucket reduce and Horner;
  4. the O(1) spec-point algebra (prover.nim:278-302) and the affine
     conversion of the three proof points.

`prove_core_device` runs steps 1-4 on the device with no host round trip
and no branch on device data.  Every proof runs it; the device type says
how.  On a CUDA device it is captured once per (zkey, device, flavour) as a
CUDA graph (`FusedProof`, which also holds the spec points and the window
tables of delta1 and delta2 on the device), and a proof is one replay,
whose only device-to-host traffic is the three proof points; there the
MSMs' Horner chains run on side streams beside the next bucket phases
(`core_msms`, `msm.SideChains`).  On the CPU, where no graph exists, it is
one eager call through the plain versions of the kernels.

The device comes from the caller; nothing falls back to another device.
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
from ..utils import timing as T
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


def to_device(a, device) -> torch.Tensor:
    """A host numpy array as a tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
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


def device_key(device) -> str:
    """The name a device's entries take in `zkey.device_cache` ("cuda" with
    its index)."""
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
    proof.  `zkey_device_args.builds` counts the uploads; each is the span
    `upload`, recorded always, up to a synchronization."""
    key = device_key(device)
    cached = zkey.device_cache.get(key)
    if cached is not None:
        return cached
    dev = torch.device(key)
    co, pp = zkey.coeffs, zkey.ppoints

    def points(cv, pa):
        return C.from_affine(cv, to_device(pa.x, dev), to_device(pa.y, dev))

    with T.span("upload", always=True):
        cached = DeviceZKey(
            rows=KN.spmv_rows(co.matrix, co.row, co.col, co.coeff, zkey.header.domain_size, dev),
            a1=points(C.G1, pp.points_a1), b1=points(C.G1, pp.points_b1),
            b2=points(C.G2, pp.points_b2), c1=points(C.G1, pp.points_c1),
            h1=points(C.G1, pp.points_h1))
        sync(dev)
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
    launches a table on CUDA.  Built with a device's first proof: a
    `FusedProof` holds them on a CUDA device, `zkey.device_cache` on the CPU
    (`spec_args`)."""
    dev, spec = torch.device(device_key(device)), zkey.spec
    return DeviceSpec(alpha1_beta1=C.points_from_host(C.G1, [spec.alpha1, spec.beta1], dev),
                      beta2=C.points_from_host(C.G2, [spec.beta2], dev),
                      delta1=C.window_table(C.G1, spec.delta1, SPEC_WINDOW, dev),
                      delta2=C.window_table(C.G2, spec.delta2, SPEC_WINDOW, dev))


def spec_args(zkey: ZKey, device) -> DeviceSpec:
    """`spec_device_args` of the zkey on `device`, built at the first call
    and kept in `zkey.device_cache` under ("spec", device)."""
    key = ("spec", device_key(device))
    spec = zkey.device_cache.get(key)
    if spec is None:
        spec = zkey.device_cache[key] = spec_device_args(zkey, device)
    return spec


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


def spec_algebra(spec: DeviceSpec, msms, mask_std: torch.Tensor, join=None) -> tuple:
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
    What reads only the masks and the spec points runs first, then what
    reads A1 and B1, the ladder among it, then the rest.  `join(k)`, where
    given, is called before the first read of the first k MSM results
    (`msm.SideChains.join`: k = 2, then every result), so that the ladder
    runs while the last chains may still run.  Returns projective (pi_a,
    pi_b, pi_c)."""
    join = join or _no_join
    fixed = table_mul(C.G1, spec.delta1, mask_std)                     # r, s, -rs delta1
    s_delta2 = table_mul(C.G2, spec.delta2, mask_std[1:2])
    a_rho = C.point_add(C.G1, spec.alpha1_beta1, tuple(c[:2] for c in fixed))
    b_s = C.point_add(C.G2, spec.beta2, s_delta2)
    s_r = F.as_u32(torch.stack([F.as_i32(mask_std[1]), F.as_i32(mask_std[0])]))
    msm_a, msm_b1, msm_b2, msm_h, msm_c = (tuple(c[None] for c in P) for P in msms)
    join(2)
    a_rho = C.point_add(C.G1, a_rho, C.cat_points([msm_a, msm_b1]))   # pi_a, rho
    post = window_mul(C.G1, a_rho, s_r)                                  # s pi_a, r rho
    join()
    pi_b = C.point_add(C.G2, b_s, msm_b2)
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


def _no_mark(phase: str) -> None:
    pass


def _no_join(k: int | None = None) -> None:
    pass


# The Horner launches of the five MSMs, in the order their window sums are
# ready: A1 and B1 share one (one n, so one width); H1 and C1 differ in
# width at 2^16, and each launch forks a side stream of its own, so they go
# apart.
CHAIN_LAUNCHES = (("msm_a1", "msm_b1"), ("msm_b2",), ("msm_h1",), ("msm_c1",))


def core_msms(flavour: Flavour, log2n: int, static: DeviceZKey,
              witness_std: torch.Tensor, mark=None, chains=None) -> tuple:
    """The SpMV, the quotient and the five MSMs of one proof (projective A1,
    B1, B2, H1, C1 sums), each bucket phase through `msm.msm_sums`.  The
    public part of the witness is what C1 does not cover.  `mark(phase)`,
    where given, is called as each phase of `timing.PHASES` ends: an MSM's
    phase is its bucket phase (`msm.msm_sums`).  The Horner chains go to
    `chains` (an `msm.SideChains`) one launch of CHAIN_LAUNCHES at a time,
    as its window sums are ready, so that on CUDA tensors they run beside
    the bucket phases that follow; the caller joins `chains` before it
    reads a result.  Without `chains` they run in one of its own, joined
    before the return."""
    mark = mark or _no_mark
    own = chains is None
    if own:
        chains = M.SideChains()
    az, bz, cz = KN.spmv(witness_std, static.rows)
    mark("spmv")
    qs = quotient_scalars(flavour, az, bz, cz, log2n)
    mark("quotient")
    zs = witness_std[witness_std.shape[0] - static.c1[0].shape[0]:]
    sets = {"msm_a1": (C.G1, witness_std, static.a1), "msm_b1": (C.G1, witness_std, static.b1),
            "msm_b2": (C.G2, witness_std, static.b2), "msm_h1": (C.G1, qs, static.h1),
            "msm_c1": (C.G1, zs, static.c1)}
    out = []
    for launch in CHAIN_LAUNCHES:
        parts = []
        for phase in launch:
            cv, scalars, P = sets[phase]
            parts.append(M.msm_sums(cv, scalars, P, affine=True))
            mark(phase)
        out += chains.horner(cv, parts)
    if own:
        chains.join()
    return tuple(out)


def prove_core_device(flavour: Flavour, log2n: int, static: DeviceZKey, spec: DeviceSpec,
                      witness_std: torch.Tensor, mask_std: torch.Tensor,
                      mark=None, chains=None) -> torch.Tensor:
    """One whole proof's device work (the JAX package's prove_core_device,
    groth16_tpu/protocol/prover.py:205-282): SpMV, quotient, five MSMs, the
    spec-point algebra and the affine conversion, with no host round trip
    and no branch on device data, so that a CUDA graph can capture it.
    `static` and `spec` the zkey's `zkey_device_args` and
    `spec_device_args`; `witness_std` uint32 [nvars, 16] standard form;
    `mask_std` the mask buffer (`mask_limbs`) on the same device.  Returns
    the `proof_buffer`.
    It runs eagerly on any device: on CPU tensors through the plain
    versions of the kernels.  `mark(phase)`, where given, is called as each
    phase of `timing.PHASES` ends (the fused graph records a timing event
    there, the CPU proof reads the host clock).  The MSMs' Horner chains run
    in `chains` (an `msm.SideChains`; one of its own where None), on side
    streams on CUDA tensors, joined inside the phase `algebra`."""
    mark = mark or _no_mark
    chains = chains if chains is not None else M.SideChains()
    msms = core_msms(flavour, log2n, static, witness_std, mark, chains)
    pts = spec_algebra(spec, msms, mask_std, chains.join)
    mark("algebra")
    buf = proof_buffer(*pts)
    mark("affine")
    return buf


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
    at 2^16) for as long as the object lives.
    The core records a timing event (`events`) before it and at the end of
    each phase of `timing.PHASES`, in every capture; the graph holds them
    as event-record nodes, which take no pool memory.  The MSMs' Horner
    chains run on side streams (`msm.SideChains`), between a pair of timing
    events of their own (`side_marks`); `side_chains` is the number of
    chains the last run of the core forked.  While tracing is
    on, `replay()` reads each phase's device seconds into `phases` and the
    tracer, and the side branch's, first launch to last, into
    `side_chains_s` and the tracer (`timing.record_side_chains`), and K2's
    device counters (`fold_counts`: the slots its launches skipped for a
    zero key and the slots they walked, zeroed at the start of every run of
    the core) into the tracer's `msm.zero_slots` and `msm.fold_slots`; off,
    it reads nothing."""

    def __init__(self, zkey: ZKey, device):
        self.device = torch.device(device_key(device))
        if self.device.type != "cuda":
            raise ValueError(f"a fused proof captures a CUDA graph: it needs a CUDA device, "
                             f"not {self.device}")
        hdr = zkey.header
        self.flavour, self.log2n = hdr.flavour, hdr.log_domain_size
        self.static = zkey_device_args(zkey, self.device)
        with T.span("capture.spec", always=True):
            self.spec = spec_device_args(zkey, self.device)
            sync(self.device)
        shape = (hdr.nvars, 16)
        self.witness = torch.zeros(shape, dtype=torch.uint32, device=self.device)
        self.mask = torch.zeros((3, 16), dtype=torch.uint32, device=self.device)
        self.host_witness = torch.empty(shape, dtype=torch.int32, pin_memory=True)
        self.host_mask = torch.empty((3, 16), dtype=torch.int32, pin_memory=True)
        self.host_out = torch.empty(PROOF_WORDS, dtype=torch.int32, pin_memory=True)
        self.graph = None
        self.out = None
        self.lock = threading.Lock()
        self.events = [torch.cuda.Event(enable_timing=True, external=True)
                       for _ in range(len(T.PHASES) + 1)]
        self.phases: dict = {}
        self.side_marks = tuple(torch.cuda.Event(enable_timing=True, external=True)
                                for _ in range(2))
        self.side_chains = 0
        self.side_chains_s = None
        self.fold_counts = torch.zeros(2, dtype=torch.int64, device=self.device)

    def _mark(self, phase: str) -> None:
        self.events[T.PHASES.index(phase) + 1].record()

    def _core(self) -> torch.Tensor:
        self.fold_counts.zero_()
        self.events[0].record()
        chains = M.SideChains(self.side_marks)
        with KN.fold_counts(self.fold_counts):
            out = prove_core_device(self.flavour, self.log2n, self.static, self.spec,
                                    self.witness, self.mask, self._mark, chains)
        self.side_chains = chains.forked
        return out

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
        host memory, on the current stream (no synchronization): the spans
        `load.stage` (into the pinned buffers) and `load.enqueue` (the two
        copies queued)."""
        with T.span("load.stage"):
            self.host_witness.numpy().view(np.uint32)[...] = wtns.values
            self.host_mask.numpy().view(np.uint32)[...] = mask_limbs(mask)
        with T.span("load.enqueue"), torch.cuda.device(self.device):
            F.as_i32(self.witness).copy_(self.host_witness, non_blocking=True)
            F.as_i32(self.mask).copy_(self.host_mask, non_blocking=True)

    def replay(self) -> np.ndarray:
        """Replay the graph on the loaded buffers and return the proof
        buffer, copied to the host (the one synchronization of a proof):
        the spans `replay` (the launch) and `copy_back` (the copy and the
        synchronization).  While tracing is on, each phase's device seconds
        then go to `phases` and to the tracer under the open proof's id, the
        side branch's to `side_chains_s` and the tracer, and K2's counters
        to the tracer's `msm.zero_slots` and `msm.fold_slots`."""
        if self.graph is None:
            raise RuntimeError("replay before capture")
        with torch.cuda.device(self.device):
            with T.span("replay"):
                self.graph.replay()
            with T.span("copy_back"):
                self.host_out.copy_(F.as_i32(self.out), non_blocking=True)
                torch.cuda.current_stream().synchronize()
        ev = self.events
        self.phases = {p: ev[i].elapsed_time(ev[i + 1]) / 1e3
                       for i, p in enumerate(T.PHASES)} if T.on() else {}
        self.side_chains_s = None
        if self.phases:
            T.record_phases(self.phases)
            if self.side_chains:
                self.side_chains_s = self.side_marks[0].elapsed_time(self.side_marks[1]) / 1e3
                T.record_side_chains(self.side_chains_s)
            zeros, walked = self.fold_counts.tolist()
            T.count("msm.zero_slots", zeros)
            T.count("msm.fold_slots", walked)
        return self.host_out.numpy().view(np.uint32).copy()


_FUSED_LOCK = threading.Lock()   # one capture at a time, and one per key


def _fused_key(zkey: ZKey, device) -> tuple:
    return ("fused", device_key(device), zkey.header.flavour.value)


def fused_graph(zkey: ZKey, device) -> FusedProof:
    """The zkey's FusedProof on `device` for the flavour its header names,
    warmed up and captured at the first call and kept in
    `zkey.device_cache` beside its DeviceZKey; `fused_graph.captures`
    counts the captures.  Threads that ask for one key at once wait for
    its one capture.  The span `capture` (recorded always) holds
    `capture.spec`, `capture.warm_up` and `capture.graph`; the counter
    `graph.pool_bytes` adds the device memory the capture reserved, the
    graph's private pool (torch.cuda.graph empties the allocator's cache
    before a capture; so does this, before it reads the reserve)."""
    key = _fused_key(zkey, device)
    fp = zkey.device_cache.get(key)
    if fp is not None:
        return fp
    with _FUSED_LOCK:
        fp = zkey.device_cache.get(key)
        if fp is None:
            with T.span("capture", always=True):
                fp = FusedProof(zkey, device)
                with T.span("capture.warm_up", always=True):
                    fp.warm_up()
                with T.span("capture.graph", always=True):
                    torch.cuda.empty_cache()
                    before = torch.cuda.memory_reserved(fp.device)
                    fp.capture()
                    T.count("graph.pool_bytes", torch.cuda.memory_reserved(fp.device) - before)
            zkey.device_cache[key] = fp
            fused_graph.captures += 1
    return fp


fused_graph.captures = 0


# ---------------------------------------------------------------------------
# one proof on any device
# ---------------------------------------------------------------------------

def public_io(zkey: ZKey, wtns: Witness) -> list:
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


def _replay(zkey: ZKey, wtns: Witness, mask: Mask, device, t: dict) -> tuple:
    """The core as one replay of the zkey's graph on a CUDA device, its
    buffers held under the graph's lock from the load to the copy back:
    (the proof buffer on the host, the replay's phase seconds).  Puts
    capture_s (the spec points, warm-up and capture) into `t` on the proof
    that captured."""
    captured = _fused_key(zkey, device) not in zkey.device_cache
    t0 = time.perf_counter()
    fp = fused_graph(zkey, device)
    if captured:
        t["capture_s"] = time.perf_counter() - t0
    with fp.lock:
        with T.span("load", t, "load_s"):
            fp.load(wtns, mask)
        with T.span("device_core", t, "device_core_s"):
            buf = fp.replay()
        return buf, fp.phases


def _eager(zkey: ZKey, wtns: Witness, mask: Mask, device, t: dict) -> tuple:
    """The core as one eager call, where no graph exists (the CPU), with the
    zkey's `spec_args`: (the proof buffer, the phase seconds).  The core is
    synchronous there, so `mark` reads the host clock; while tracing is on
    each phase's seconds go to the tracer, as a replay's do."""
    hdr = zkey.header
    spec = spec_args(zkey, device)
    with T.span("load", t, "load_s"):
        witness_std = to_device(wtns.values, device)
        mask_std = to_device(mask_limbs(mask), device)
    clock = [time.perf_counter()]
    with T.span("device_core", t, "device_core_s"):
        buf = prove_core_device(hdr.flavour, hdr.log_domain_size, zkey_device_args(zkey, device),
                                spec, witness_std, mask_std,
                                lambda phase: clock.append(time.perf_counter()))
    phases = {p: b - a for p, a, b in zip(T.PHASES, clock, clock[1:])} if T.on() else {}
    if phases:
        T.record_phases(phases)
    return buf, phases


def _prove(zkey: ZKey, wtns: Witness, mask: Mask, device, timings: dict | None, core) -> Proof:
    """One proof with `core` (`_replay` or `_eager`) running the device
    work.  `timings` gets upload_s (the zkey's upload at its first proof on
    the device, then the witness and masks), device_core_s (the core up to
    the proof buffer on the host) and total_s, capture_s on the proof that
    captured a graph, and while tracing is on `<phase>_device_s`, the
    seconds of each phase of `timing.PHASES` inside the core.  Traced, the
    proof is the root span `proof` over `public_io`, `load`, `device_core`
    and `proof_points`, all under one proof id."""
    t: dict = {}
    with T.proof():
        with T.span("public_io"):
            pub = public_io(zkey, wtns)
        t0 = time.perf_counter()
        zkey_device_args(zkey, device)
        t1 = time.perf_counter()
        buf, phases = core(zkey, wtns, mask, device, t)
        with T.span("proof_points"):
            pi_a, pi_b, pi_c = proof_points(buf)
        total_s = time.perf_counter() - t0
    if timings is not None:
        timings.update({"upload_s": (t1 - t0) + t["load_s"], "device_core_s": t["device_core_s"],
                        "total_s": total_s})
        if "capture_s" in t:
            timings["capture_s"] = t["capture_s"]
        timings.update({f"{p}_device_s": sec for p, sec in phases.items()})
    return Proof(public_io=pub, pi_a=pi_a, pi_b=pi_b, pi_c=pi_c)


def generate_proof_with_mask(zkey: ZKey, wtns: Witness, mask: Mask, device: torch.device,
                             timings: dict | None = None) -> Proof:
    """Reference generateProofWithMask (prover.nim:215-304) on `device`, a
    torch.device the caller names: the proof runs there and nowhere else.
    The zkey's inputs are uploaded at its first proof on the device and
    reused after (`zkey_device_args`).  On a CUDA device the proof is one
    replay of the graph captured at the zkey's first proof there
    (`fused_graph`); elsewhere one eager call of `prove_core_device`.  Both
    give the same proof; `timings` as `_prove` fills it."""
    device = torch.device(device)
    return _prove(zkey, wtns, mask, device, timings, _replay if device.type == "cuda" else _eager)


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
    the zkey's inputs uploaded once for the batch (`zkey_device_args`); on a
    CUDA device the first proof captures the graph and every later one is a
    replay.  `masks` gives each proof's Mask (random masks where it is
    None); `timings`, where given, gets one dict of phase times per proof."""
    out = []
    for i, w in enumerate(witnesses):
        mask = masks[i] if masks is not None else random_mask()
        sink = {} if timings is not None else None
        out.append(generate_proof_with_mask(zkey, w, mask, device, sink))
        if timings is not None:
            timings.append(sink)
    return out
