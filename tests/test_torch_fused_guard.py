"""The core at the fold's size, and the guard that shows it can be
captured as a CUDA graph, on the CPU.

synthetic_circuit(8) in the JensGroth flavour (every MSM of 252 to 256
points takes the fold): with the caches warm, the CPU proofs under the
masks (0, 0), a fixed pair and (q - 1, q - 1) run their core
(`prove_core_device`: the MSMs and the algebra) under
`fused_cases.no_host_sync`, which fails at any op of the glue between the
kernels that reads a device value on the host or sizes its output by the
data (the kernels' plain versions run unguarded: on the card the kernels
run instead); the proofs equal the host-int oracle's, and no cache of
host-made constants or tables grows, so a capture would copy nothing from
the host; the merge tree's glue passes the same guard on 32 points.  A
file of its own beside tests/test_torch_fused.py so that the two run side
by side."""

import numpy as np
import pytest
import torch

from fused_cases import CPU, MASKS, HostSyncError, no_host_sync, oracle_proofs, points, \
    shared_msms

import groth16_tpu_torch as T
from groth16_tpu_torch.models.circuits import synthetic_circuit
from groth16_tpu_torch.ops import curve as C
from groth16_tpu_torch.ops import field as F
from groth16_tpu_torch.ops import msm as M
from groth16_tpu_torch.ops import msm_tree as MT
from groth16_tpu_torch.ops import ntt as NT
from groth16_tpu_torch.ops.limbs import ints_to_limbs
from groth16_tpu_torch.protocol import prover as PV
from groth16_tpu_torch.utils import hostmath as H

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

TOXIC = dict(alpha=0x1DEA, beta=0xBEEF, gamma=0x6A33A, delta=0xDE17A, tau=0x7A0)


def _cache_sizes() -> tuple:
    return len(F._CONSTS), len(NT._TABLES), PV.zkey_device_args.builds


@pytest.fixture(scope="module")
def jensgroth8():
    """(zkey, the oracle's proofs under MASKS, the CPU proofs under MASKS,
    the ops the guard passed, whether a cache grew): the oracle and the
    zkey's spec points warm the caches, then each CPU proof runs its core
    under `no_host_sync`; the proofs share their MSM results
    (`shared_msms`), the first computing them under the guard."""
    r1cs, wtns = synthetic_circuit(8)
    zkey = T.fake_circuit_setup(r1cs, T.ToxicWaste(**TOXIC), T.Flavour.JensGroth, CPU)
    oracle = oracle_proofs(zkey, wtns, MASKS)
    spec = PV.spec_args(zkey, CPU)
    infs = [C.inf_like(cv, (), CPU) for cv in (C.G1, C.G1, C.G2, C.G1, C.G1)]
    PV.proof_buffer(*PV.spec_algebra(spec, infs, torch.from_numpy(PV.mask_limbs(MASKS[1]))))
    ops: set = set()
    real = PV.prove_core_device

    def guarded(*args, **kwargs):
        with no_host_sync() as guard:
            out = real(*args, **kwargs)
        ops.update(guard.ops)
        return out

    before = _cache_sizes()
    with shared_msms(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(PV, "prove_core_device", guarded)
        cpu = [T.generate_proof_with_mask(zkey, wtns, m, CPU) for m in MASKS]
    grown = _cache_sizes() != before
    return zkey, oracle, cpu, ops, grown


@pytest.mark.parametrize("i", range(len(MASKS)), ids=["zero", "fixed", "q-1"])
def test_core_equals_staged_fold(jensgroth8, i):
    """The CPU proof, its core guarded, equals the host-int oracle's and
    verifies."""
    zkey, oracle, cpu, _, _ = jensgroth8
    assert min(zkey.header.nvars, zkey.header.domain_size) >= 128   # the fold, not the ladder
    assert points(cpu[i]) == points(oracle[i])
    assert T.verify_proof(T.extract_vkey(zkey), cpu[i])


def test_core_has_no_host_sync(jensgroth8):
    _, _, _, ops, grown = jensgroth8
    assert not grown
    assert "aten.sort" in ops or "aten.argsort" in ops       # the fold's glue ran guarded


def test_tree_glue_has_no_host_sync():
    """The merge tree's bucket phase (`msm_tree.window_sums_tree`, which
    the JAX package gives H1 at 2^16 points) and Horner over its window sums, on 32
    points at c = 4 in one group of all 64 windows (one batch inversion a
    level: the plain inversion is the slow part on the CPU), warm, then
    guarded."""
    rng = np.random.default_rng(3)
    n, c = 32, 4
    ks = [int.from_bytes(rng.bytes(32), "little") % H.R for _ in range(n)]
    pts = [H.g1_mul(i + 1) for i in range(n)]
    P = C.points_from_host(C.G1, pts, CPU)
    s = torch.from_numpy(ints_to_limbs(ks))

    def tree_msm():
        return M.horner_combine(C.G1, MT.window_sums_tree(C.G1, s, P, c, group=64), c)

    tree_msm()
    before = _cache_sizes()
    with no_host_sync():
        got = tree_msm()
    assert _cache_sizes() == before
    want = None
    for k, pt in zip(ks, pts):
        want = H.g1_add(want, H.g1_mul(k, pt))
    assert C.points_to_host(C.G1, tuple(x[None] for x in got)) == [want]


def test_guard_catches_host_syncs():
    x = torch.arange(6)
    for fn in (lambda: x.sum().item(), lambda: x[x > 2], lambda: torch.nonzero(x),
               lambda: bool(x.any()), lambda: torch.repeat_interleave(x, x),
               lambda: torch.unique(x), lambda: torch.tensor([1, 2])):
        with pytest.raises(HostSyncError):
            with no_host_sync():
                fn()
    with no_host_sync():                       # a plain version runs unguarded
        P = C.inf_like(C.G1, (2,), CPU)
        C.point_add(C.G1, P, P)
