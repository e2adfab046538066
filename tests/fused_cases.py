"""Shared parts of the fused-prover tests (tests/test_torch_fused.py,
tests/test_torch_fused_guard.py, tests/test_torch_batch_jax.py): the masks,
the port's staged proofs of one witness under several masks, the fused
core's proofs under the same masks, `shared_msms`, which lets the two
paths of one witness compute each MSM once, and `no_host_sync`, the guard
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

CPU = torch.device("cpu")
Q = FR.modulus
# (0, 0), a fixed pair, and (q - 1, q - 1)
MASKS = (T.Mask(0, 0),
         T.Mask(0x2B1A_5E7F_0123_4567_89AB_CDEF_FEDC_BA98, 0x1357_9BDF_2468_ACE0_0FED_CBA9_8765_4321),
         T.Mask(Q - 1, Q - 1))
STAGED_KEYS = {"upload_s", "spmv_s", "quotient_s", "msm_a1_s", "msm_b1_s", "msm_b2_s",
               "msm_h1_s", "msm_c1_s", "algebra_s", "total_s"}


def points(p) -> tuple:
    return p.pi_a, p.pi_b, p.pi_c


def staged_proofs(zkey, wtns, masks) -> tuple:
    """(the port's staged proofs of `wtns` under each mask, the first
    proof's timings): the first through `generate_proof_with_mask` with the
    default path on the CPU, its five MSM points recorded as the staged path
    brings them to the host; the others through `prove_phases` with those
    points, since the MSMs do not depend on the mask."""
    recorded = []
    real = PV._msm_to_host

    def record(*args):
        recorded.append(real(*args))
        return recorded[-1]

    timings = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PV, "_msm_to_host", record)
        proofs = [T.generate_proof_with_mask(zkey, wtns, masks[0], CPU, timings)]
    hdr = zkey.header
    for mask in masks[1:]:
        proofs.append(PV.prove_phases(
            zkey, wtns, mask, CPU, lambda: PV.zkey_device_args(zkey, CPU),
            lambda az, bz, cz: PV.quotient_scalars(hdr.flavour, az, bz, cz, hdr.log_domain_size),
            lambda *_: iter(recorded)))
    return proofs, timings


def fused_buffers(static, spec, flavour, log2n: int, witness_std, masks_std) -> list:
    """The fused core's proof buffers of one witness under each mask buffer,
    eagerly: `prove_core_device`'s two parts, the MSMs once and the algebra
    and affine conversion once a mask."""
    msms = PV.core_msms(flavour, log2n, static, witness_std)
    return [PV.proof_buffer(*PV.spec_algebra(spec, msms, m)) for m in masks_std]


def fused_points(zkey, wtns, masks) -> list:
    """The fused core's host (pi_a, pi_b, pi_c) of `wtns` under each mask on
    the CPU (`fused_buffers`)."""
    hdr = zkey.header
    bufs = fused_buffers(PV.zkey_device_args(zkey, CPU), PV.spec_device_args(zkey, CPU),
                         hdr.flavour, hdr.log_domain_size, torch.from_numpy(wtns.values),
                         [torch.from_numpy(PV.mask_limbs(m)) for m in masks])
    return [PV.proof_points(b) for b in bufs]


@contextlib.contextmanager
def shared_msms():
    """Inside the block `msm.msm` remembers each result by its curve, the
    point set it was given (the zkey's cached device arguments, which both
    paths share), the scalars' bytes and its options, so that the staged
    proof and the fused core of one witness compute each MSM once (the
    naive MSMs of synthetic_circuit(5) take seconds each on the CPU).  A
    path that handed `msm` other scalars or points would miss and compute
    its own result, so the proofs still compare the two paths' inputs."""
    memo = {}
    real = M.msm

    def msm(cv, scalars, P, *args, **kwargs):
        key = (cv.name, id(P[0]), scalars.numpy().tobytes(), args, tuple(sorted(kwargs.items())))
        if key not in memo:
            memo[key] = (P, real(cv, scalars, P, *args, **kwargs))   # P held: its id stays
        return memo[key][1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "msm", msm)
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
