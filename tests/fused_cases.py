"""Shared parts of the prover tests (tests/test_torch_fused.py,
tests/test_torch_fused_guard.py, tests/test_torch_batch_jax.py,
tests/test_torch_gpu.py): the masks, the timings keys of a proof, the
test-side oracle of a proof (`oracle_proofs`: the masked spec-point algebra
on host ints over the port's MSM points), the CPU proofs of one witness
under several masks (`cpu_proofs`), `shared_msms`, which lets several
proofs of one witness compute each MSM once, and `no_host_sync`, the guard
that shows the core could be captured as a CUDA graph.  Imports no jax."""

import contextlib
import functools

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

import groth16_tpu_torch as T
from groth16_tpu_torch.ops import curve as C
from groth16_tpu_torch.ops import kernels as KN
from groth16_tpu_torch.ops import kernels_tree as KT
from groth16_tpu_torch.ops import msm as M
from groth16_tpu_torch.ops import ntt as NT
from groth16_tpu_torch.ops.field import FR
from groth16_tpu_torch.protocol import prover as PV
from groth16_tpu_torch.utils import hostmath as H
from groth16_tpu_torch.utils import timing as TR

CPU = torch.device("cpu")
Q = FR.modulus
# (0, 0), a fixed pair, and (q - 1, q - 1)
MASKS = (T.Mask(0, 0),
         T.Mask(0x2B1A_5E7F_0123_4567_89AB_CDEF_FEDC_BA98, 0x1357_9BDF_2468_ACE0_0FED_CBA9_8765_4321),
         T.Mask(Q - 1, Q - 1))
# the timings of a traced proof on either device, but for capture_s on the
# proof that captured a graph
PROOF_KEYS = {"upload_s", "device_core_s", "total_s"} | {f"{p}_device_s" for p in TR.PHASES}


def points(p) -> tuple:
    return p.pi_a, p.pi_b, p.pi_c


def oracle_proofs(zkey, wtns, masks) -> list:
    """The proofs of `wtns` under each mask by the masked algebra of
    reference prover.nim:278-302 on host ints (utils/hostmath), over the
    five MSM points the port's `msm.msm` gives for the witness on the CPU
    (its SpMV and quotient give the H1 scalars)."""
    hdr, spec = zkey.header, zkey.spec
    static = PV.zkey_device_args(zkey, CPU)
    w = torch.from_numpy(wtns.values)
    qs = PV.quotient_scalars(hdr.flavour, *KN.spmv(w, static.rows), hdr.log_domain_size)
    msm_a, msm_b1, msm_b2, msm_h, msm_c = (
        C.points_to_host(cv, tuple(x[None] for x in M.msm(cv, sc, P, affine=True)))[0]
        for cv, sc, P in ((C.G1, w, static.a1), (C.G1, w, static.b1), (C.G2, w, static.b2),
                          (C.G1, qs, static.h1), (C.G1, w[hdr.npubs + 1:], static.c1)))
    public_io = PV.public_io(zkey, wtns)
    out = []
    for mask in masks:
        r, s = mask.r % Q, mask.s % Q
        pi_a = H.g1_add(H.g1_add(spec.alpha1, H.g1_mul(r, spec.delta1)), msm_a)
        rho = H.g1_add(H.g1_add(spec.beta1, H.g1_mul(s, spec.delta1)), msm_b1)
        pi_b = H.g2_add(H.g2_add(spec.beta2, H.g2_mul(s, spec.delta2)), msm_b2)
        pi_c = H.g1_add(H.g1_mul(s, pi_a), H.g1_mul(r, rho))
        for pt in (H.g1_mul((-r * s) % Q, spec.delta1), msm_h, msm_c):
            pi_c = H.g1_add(pi_c, pt)
        out.append(T.Proof(public_io=public_io, pi_a=pi_a, pi_b=pi_b, pi_c=pi_c))
    return out


def cpu_proofs(zkey, wtns, masks) -> tuple:
    """(`generate_proof_with_mask` of `wtns` under each mask on the CPU, the
    first proof's timings, taken with tracing on)."""
    timings: dict = {}
    TR.enable()
    try:
        proofs = [T.generate_proof_with_mask(zkey, wtns, masks[0], CPU, timings)]
    finally:
        TR.disable()
    proofs += [T.generate_proof_with_mask(zkey, wtns, m, CPU) for m in masks[1:]]
    return proofs, timings


@contextlib.contextmanager
def shared_msms():
    """Inside the block `msm.msm` and `msm.msm_sums` remember each result by
    the function, its curve, the point set it was given (the zkey's cached
    device arguments, which every proof of the zkey shares), the scalars'
    bytes and its options, so that several proofs of one witness compute
    each MSM once (the naive MSMs of synthetic_circuit(5) take seconds each
    on the CPU).  A proof that handed them other scalars or points would
    miss and compute its own result, so the proofs still compare their
    inputs.  The key is read with any dispatch mode off, so that a guard
    around a call sees only the MSM's own ops."""
    memo = {}

    def remember(real):
        @functools.wraps(real)
        def run(cv, scalars, P, *args, **kwargs):
            with _disable_current_modes():
                key = (real.__name__, cv.name, id(P[0]), scalars.numpy().tobytes(), args,
                       tuple(sorted(kwargs.items())))
            if key not in memo:
                memo[key] = (P, real(cv, scalars, P, *args, **kwargs))   # P held: its id stays
            return memo[key][1]
        return run

    with pytest.MonkeyPatch.context() as mp:
        for name in ("msm", "msm_sums"):
            mp.setattr(M, name, remember(getattr(M, name)))
        yield


aten = torch.ops.aten
# ops that read a device value on the host or size their output by the data
HOST_SYNC_OPS = {aten._local_scalar_dense, aten.item, aten.is_nonzero, aten.equal,
                 aten.allclose, aten.nonzero, aten.argwhere, aten.masked_select,
                 aten.masked_scatter, aten.masked_scatter_, aten.unique_consecutive,
                 aten.unique_dim, aten._unique, aten._unique2, aten.bincount,
                 aten.histc, aten.lift_fresh, aten.lift_fresh_copy}
INDEX_OPS = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_}
# the plain versions of the kernels: on the card the kernels run instead
PLAIN_VERSIONS = ((C, "point_add_plain"), (C, "point_double_n_plain"), (C, "horner_plain"),
                  (KN, "fold_level_plain"), (KN, "spmv_plain"), (KN, "fp_neg_plain"),
                  (KT, "level_plain"), (KT, "invert_plain"), (KT, "mul_rows_plain"),
                  (NT, "ntt_inner_plain"), (NT, "quotient_pointwise_plain"))


class HostSyncError(AssertionError):
    pass


class _NoHostSync(TorchDispatchMode):
    """Raises at any op that synchronizes with the host or has a
    data-dependent shape (HOST_SYNC_OPS, repeat_interleave by a tensor,
    indexing with a boolean mask); records every op it passes."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        bad = packet in HOST_SYNC_OPS
        if packet is aten.repeat_interleave:
            bad = isinstance(args[1] if len(args) > 1 else args[0], torch.Tensor) and \
                kwargs.get("output_size") is None
        if packet in INDEX_OPS:
            bad = any(t is not None and t.dtype in (torch.bool, torch.uint8) for t in args[1])
        if bad:
            raise HostSyncError(f"{func} synchronizes with the host or sizes its output by "
                                "the data: a CUDA graph cannot capture it")
        self.ops.add(str(packet))
        return func(*args, **kwargs)


@contextlib.contextmanager
def no_host_sync():
    """Inside the block every op outside the kernels' plain versions (the
    glue that runs on the card between kernel launches) goes through
    `_NoHostSync`; the plain versions run unguarded, as on the card their
    kernels run instead.  Yields the mode (its `ops`)."""
    def unguarded(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return run

    mode = _NoHostSync()
    with pytest.MonkeyPatch.context() as mp:
        for module, name in PLAIN_VERSIONS:
            mp.setattr(module, name, unguarded(getattr(module, name)))
        with mode:
            yield mode
