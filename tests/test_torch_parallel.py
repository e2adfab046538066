"""The port's sharded NTT, MSM and quotient (groth16_tpu_torch/parallel) on
gloo ranks on the CPU, against the JAX package and host ints.

One `launch.spawn` of four ranks, as a module-scoped fixture whose ranks
run every case (tests/parallel_cases.py), the ranks below each world size
(2, 3, 4) as a group of their own, and pickle their results; each case is
then an assertion of its own.  The sharded NTT
at 2^6 against JAX `four_step_ntt` / `four_step_intt` on a 2-device mesh and
at 2^8 against JAX `forward_ntt` / `inverse_ntt` (0 and r - 1 among the
inputs); the G1 MSM of 21 points over 2 and 3 ranks (uneven slabs, a zero
scalar, an infinity, P beside -P) and the G2 MSM of 9 against host ints; a
2^10 affine MSM on the fold path against the port's `msm`; the quotient at
2^6 on 2 ranks and at 2^7 on 4 (N1 = 2^3, N2 = 2^4) against the port's
plain `quotient_scalars` and JAX's.  Tolerance 0:
field values bit-equal, curve points compared after affine conversion.
The 2^9 proofs are in tests/test_torch_parallel_proof.py."""

import random
import threading

import numpy as np
import pytest
import torch

import parallel_cases as PC

from groth16_tpu_torch.ops import curve as C
from groth16_tpu_torch.ops import msm as M
from groth16_tpu_torch.ops.limbs import ints_to_limbs_bulk
from groth16_tpu_torch.parallel import launch, ntt_shard
from groth16_tpu_torch.protocol.prover import quotient_scalars
from groth16_tpu_torch.protocol.types import Flavour
from groth16_tpu_torch.utils import hostmath as H

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

R = PC.R
rng = random.Random(9)


def _points(F, gen, n):
    return [H.ec_scalar_mul(F, rng.randrange(1, 1 << 62), gen) for _ in range(n)]


def _msm_case(F, gen, n):
    """n (scalar, point) pairs: a zero scalar, an infinity, P beside -P."""
    pts = _points(F, gen, n)
    ks = [rng.randrange(R) for _ in range(n)]
    ks[0] = 0
    pts[1] = None
    pts[5] = H.ec_neg(F, pts[4])
    return ks, pts


G1_CASE = _msm_case(H.G1_FIELD, H.G1_GEN, 21)
G2_CASE = _msm_case(H.G2_FIELD, H.G2_GEN, 9)
FOLD_N = 1 << 10
FOLD_CASE = ([rng.randrange(R) for _ in range(FOLD_N)], _points(H.G1_FIELD, H.G1_GEN, FOLD_N))
QLOG2 = 6
QLOG2_4 = 7                   # at 4 ranks: N1 != N2, so the split's sides differ


RANK_CASES = {
    2: [("ntt", (6, 60)), ("ntt", (8, 80)),
        ("msm", ("g1", "G1", *G1_CASE)), ("msm", ("g2", "G2", *G2_CASE)),
        ("msm", ("fold", "G1", *FOLD_CASE, True)), ("quotient", (QLOG2, 600))],
    3: [("msm", ("g1", "G1", *G1_CASE))],
    4: [("ntt", (8, 80)), ("quotient", (QLOG2_4, 600))],
}


def _abc(log2n=QLOG2):
    return [PC.rand_mont(1 << log2n, 600 + j) for j in range(3)]


def _jax_references() -> dict:
    """The JAX package's results on the cases' inputs."""
    import jax.numpy as jnp
    from groth16_tpu.ops import field as JF
    from groth16_tpu.ops import ntt as JNT
    from groth16_tpu.parallel.mesh import make_mesh
    from groth16_tpu.parallel.ntt_shard import four_step_intt, four_step_ntt
    from groth16_tpu.protocol.prover import quotient_scalars as jax_quotient
    from groth16_tpu.protocol.types import Flavour as JFlavour
    x6, x8 = jnp.asarray(PC.ntt_input(6, 60)), jnp.asarray(PC.ntt_input(8, 80))
    mesh, dom6, dom8 = make_mesh(2), JNT.Domain(6), JNT.Domain(8)
    out = {("ntt6", 0): four_step_ntt(dom6, mesh, x6), ("ntt6", 1): four_step_intt(dom6, mesh, x6),
           ("ntt8", 0): JNT.forward_ntt(dom8, x8), ("ntt8", 1): JNT.inverse_ntt(dom8, x8)}
    for log2n in (QLOG2, QLOG2_4):
        for name in ("Snarkjs", "JensGroth"):
            q = jax_quotient(getattr(JFlavour, name), *[jnp.asarray(x) for x in _abc(log2n)],
                             log2n)
            out["quotient", log2n, name] = JF.from_mont(JF.FR, q)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world size's cases (one spawn of four ranks) on one thread and
    `dryrun_multichip(2)` on another, while this process computes the JAX
    references; returns ({world: results directory}, references)."""
    outs = {w: str(tmp_path_factory.mktemp(f"w{w}")) for w in RANK_CASES}
    errors = []

    def guarded(fn):
        def run():
            try:
                fn()
            except BaseException as e:      # re-raised in the test process below
                errors.append(e)
        return threading.Thread(target=run)

    def ranks():
        launch.spawn(PC.worlds_rank, max(RANK_CASES), "gloo", ["cpu"], outs, RANK_CASES)

    threads = [guarded(ranks), guarded(lambda: launch.dryrun_multichip(2, "cpu"))]
    for th in threads:
        th.start()
    try:
        refs = _jax_references()
    finally:
        for th in threads:
            th.join()
    if errors:
        raise errors[0]
    return outs, refs


def _gathered(out, name, world, j):
    return np.concatenate([r[j] for r in PC.load(out, name, world)])


@pytest.mark.parametrize("direction", [0, 1])
def test_ntt_2e6_equals_jax_four_step(runs, direction):
    outs, refs = runs
    assert np.array_equal(_gathered(outs[2], "ntt6", 2, direction), refs["ntt6", direction])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("direction", [0, 1])
def test_ntt_2e8_equals_jax(runs, world, direction):
    outs, refs = runs
    assert np.array_equal(_gathered(outs[world], "ntt8", world, direction),
                          refs["ntt8", direction])


def test_split_raises():
    with pytest.raises(ValueError):
        ntt_shard.factors(6, 3, False)          # not a power of two
    with pytest.raises(ValueError):
        ntt_shard.factors(3, 4, False)          # 2^3 too small for 4 ranks
    assert ntt_shard.factors(6, 4, False) == (3, 3)
    assert ntt_shard.factors(7, 2, True) == (4, 3)


@pytest.mark.parametrize("world", [2, 3])
def test_msm_g1_uneven_slabs_equal_host(runs, world):
    want = H.ec_msm(H.G1_FIELD, *G1_CASE)
    assert all(g == want for g in PC.load(runs[0][world], "g1", world))


def test_msm_g2_equals_host(runs):
    want = H.ec_msm(H.G2_FIELD, *G2_CASE)
    assert all(g == want for g in PC.load(runs[0][2], "g2", 2))


def test_msm_fold_path_equals_port_msm(runs):
    ks, pts = FOLD_CASE
    sc = torch.from_numpy(ints_to_limbs_bulk(ks).reshape(-1, 16))
    P = C.points_from_host(C.G1, pts, torch.device("cpu"))
    assert FOLD_N // 2 >= 128                  # each slab takes the fold
    want = C.points_to_host(C.G1, tuple(c[None] for c in M.msm(C.G1, sc, P, affine=True)))[0]
    assert all(g == want for g in PC.load(runs[0][2], "fold", 2))


def _quotient_full(out, flavour, world=2, log2n=QLOG2):
    full = np.zeros((1 << log2n, 16), np.uint32)
    for res in PC.load(out, f"quotient{log2n}", world):
        idx, q = res[flavour.value]
        full[idx] = q
    return full


def _quotient_plain(flavour, log2n):
    abc = [torch.from_numpy(x) for x in _abc(log2n)]
    return quotient_scalars(getattr(Flavour, flavour), *abc, log2n, plain=True).numpy()


@pytest.mark.parametrize("flavour", ["Snarkjs", "JensGroth"])
def test_quotient_equals_port_plain(runs, flavour):
    assert np.array_equal(_quotient_full(runs[0][2], getattr(Flavour, flavour)),
                          _quotient_plain(flavour, QLOG2))


@pytest.mark.parametrize("flavour", ["Snarkjs", "JensGroth"])
def test_quotient_equals_jax(runs, flavour):
    assert np.array_equal(_quotient_full(runs[0][2], getattr(Flavour, flavour)),
                          runs[1]["quotient", QLOG2, flavour])


@pytest.mark.parametrize("flavour", ["Snarkjs", "JensGroth"])
def test_quotient_four_ranks_equals_port_plain(runs, flavour):
    got = _quotient_full(runs[0][4], getattr(Flavour, flavour), 4, QLOG2_4)
    assert np.array_equal(got, _quotient_plain(flavour, QLOG2_4))


@pytest.mark.parametrize("flavour", ["Snarkjs", "JensGroth"])
def test_quotient_four_ranks_equals_jax(runs, flavour):
    assert ntt_shard.factors(QLOG2_4, 4, False) == (3, 4)
    got = _quotient_full(runs[0][4], getattr(Flavour, flavour), 4, QLOG2_4)
    assert np.array_equal(got, runs[1]["quotient", QLOG2_4, flavour])


def test_dryrun_multichip_two_ranks(runs):
    """`dryrun_multichip(2)` ran on the fixture's thread: every rank's proof
    verified, or the fixture raised."""
    assert runs[0]


@pytest.fixture(scope="module")
def shim():
    from groth16_tpu_torch.ops import cuda
    lib = cuda.host_shim()
    if lib is None:
        pytest.skip("g++ not available")
    return lib


@pytest.mark.parametrize("world,log2n", [(2, 8), (4, 8), (2, 9)])
def test_shim_split_steps_match_plain(shim, world, log2n):
    """K3's block body (csrc/bn254_ntt.cuh through the g++ shim) at the last
    rank's split-stride steps of every sharded transform, against the plain
    version on the same inputs."""
    import ctypes
    from groth16_tpu_torch.ops import ntt as NT

    def p(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())

    eta = NT.Domain(log2n + 1).gen
    m = (1 << log2n) // world
    for kind, B in (("inverse_to_coset", 3), ("forward", 3), ("inverse_from_coset_std", 1)):
        for j, s in enumerate(ntt_shard.steps(log2n, world, world - 1, kind, B, "cpu", eta)):
            x = torch.from_numpy(PC.rand_mont(B * m, 7 * j + B).reshape(B, m, 16))
            x = x if j == 0 else NT.pack(x)
            xb, ob = s.batch_strides()
            out = torch.zeros((B, m, 8), dtype=torch.uint32)
            strides = (ctypes.c_long * 10)(s.si, s.sq, s.oi, s.ok, xb, ob, s.gbits, s.gx,
                                           s.hbits, s.hx)
            shim.shim_ntt_step(p(x), p(out), p(s.pre), p(s.post), p(s.roots), strides,
                               s.T, s.NB, B, int(s.dit), int(x.shape[2] == 16), 0)
            assert torch.equal(out, NT.ntt_inner_plain(x, s, False)), (kind, j)


@pytest.mark.parametrize("world,log2n", [(2, 8), (4, 8), (4, 9)])
def test_step_reach_matches_addresses(world, log2n):
    """`Step.reach`, which bounds K3's launches, is the least and the
    largest offset of the plain version's addresses, on every rank's split
    steps of every sharded transform."""
    from groth16_tpu_torch.ops import ntt as NT
    eta = NT.Domain(log2n + 1).gen
    for r in range(world):
        for kind, B in (("inverse_to_coset", 3), ("forward", 3), ("inverse_from_coset_std", 1)):
            for s in ntt_shard.steps(log2n, world, r, kind, B, "cpu", eta):
                src, dst = NT._addresses(s, "cpu")
                assert s.reach == ((int(src.min()), int(src.max())),
                                   (int(dst.min()), int(dst.max())))
