"""The port's sharded proof (groth16_tpu_torch/parallel/prover_shard.py) on
two gloo ranks on the CPU at 2^9 constraints, both flavours, from JAX
fake-setup zkeys (fixed toxic waste) through `zkey_from_numpy`: every
rank's proof must be byte-identical to the port's single-device proof for
the same mask (`generate_proof_with_mask`) and pass the JAX verifier.  At
2^9 every rank's slab of every MSM takes the fold path (>= 128 points).
One `launch.spawn` of four ranks: first all four build their sharded
proof inputs (the SpMV rows, the quotient scalars, the H1 points, at
N1 = 2^4, N2 = 2^5), which must be the single-device proof's at the
rank's indices; then two prove both flavours sharded over the two of
them, while the other two prove the single-device proofs.  The slow lane
holds the whole sharded proof on four ranks against the single one (its
slabs take the naive ladder, slow on the CPU), the sharded proof against
JAX `prove_staged_sharded` at 2^4 on a 2-device mesh, and `msm_sharded`
against JAX's."""

import numpy as np
import pytest
import torch

import parallel_cases as PC
from test_snarkjs_golden import FIXED_TOXIC

import groth16_tpu_torch as T
from groth16_tpu_torch.ops import curve as C
from groth16_tpu_torch.ops import kernels as KN
from groth16_tpu_torch.parallel import launch, ntt_shard
from groth16_tpu_torch.protocol.prover import quotient_scalars, zkey_device_args

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

LOG2 = 9
MASK = (0x0DDC_0FFE_E15_BADC_0DE5, 0x5EED_F00D_CAFE_BEEF_0123)
FLAVOURS = ("Snarkjs", "JensGroth")


def _jax_zkeys(log2n):
    from groth16_tpu.models.circuits import synthetic_circuit as jax_circuit
    from groth16_tpu.protocol.fake_setup import ToxicWaste, fake_circuit_setup
    from groth16_tpu.protocol.types import Flavour as JFlavour
    r1cs, wtns = jax_circuit(log2n)
    return wtns, [fake_circuit_setup(r1cs, ToxicWaste(**FIXED_TOXIC), getattr(JFlavour, f))
                  for f in FLAVOURS]


def _port_witness(jw):
    return T.Witness(curve=jw.curve, r=jw.r, nvars=jw.nvars, values=np.asarray(jw.values))


@pytest.fixture(scope="module")
def proofs(tmp_path_factory):
    """Four spawned ranks: all four build each zkey's sharded proof inputs
    over the four of them; then ranks 0 and 1 prove both zkeys sharded over
    the two of them, ranks 2 and 3 the single-device proofs of the Snarkjs
    and the JensGroth zkey meanwhile."""
    out = str(tmp_path_factory.mktemp("proofs"))
    jwtns, jzkeys = _jax_zkeys(LOG2)
    zkeys = [T.zkey_from_numpy(z) for z in jzkeys]
    wtns = _port_witness(jwtns)
    assert min(z.header.nvars - z.header.npubs - 1 for z in zkeys) // 2 >= 128
    launch.spawn(PC.cases_rank, 2 + len(zkeys), "gloo", ["cpu"], out,
                 [("inputs", (zkeys, wtns)), ("proofs", (zkeys, wtns, MASK, 2))])
    res = PC.load(out, "proofs", 2 + len(zkeys))
    return (jzkeys, jwtns, res[:2], [r[0] for r in res[2:]],
            (zkeys, wtns, PC.load(out, "inputs", 2 + len(zkeys))))


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("flavour", range(len(FLAVOURS)))
def test_sharded_proof_equals_single(proofs, flavour, rank):
    _, _, sharded, single, _ = proofs
    assert sharded[rank][flavour] == single[flavour]


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("flavour", range(len(FLAVOURS)))
def test_four_rank_inputs_equal_single(proofs, flavour, rank):
    """Rank `rank` of four: its SpMV output is the single SpMV's at the
    inverse transform's columns, its quotient scalars the single quotient's
    at `h1_indices`, its H1 points the zkey's at those indices and its A1
    and C1 points the zkey's over its slabs."""
    zkeys, wtns, inputs = proofs[4]
    zk, got = zkeys[flavour], inputs[rank][flavour]
    hdr, pp = zk.header, zk.ppoints
    t = hdr.log_domain_size
    assert ntt_shard.factors(t, 4, False) == (4, 5)
    w = torch.from_numpy(np.ascontiguousarray(wtns.values))
    abc = KN.spmv(w, zkey_device_args(zk, "cpu").rows)
    cols = ntt_shard.layout_indices(t, 4, rank, 4)
    assert np.array_equal(got["abc"], torch.stack(list(abc)).numpy()[:, cols])
    q = quotient_scalars(hdr.flavour, *abc, t, plain=True).numpy()
    assert np.array_equal(got["q"], q[got["idx"]])

    def points(pa, sel):
        return [c.numpy() for c in C.from_affine(C.G1, torch.from_numpy(pa.x[sel]),
                                                 torch.from_numpy(pa.y[sel]))]
    (wlo, whi), (clo, chi) = got["slabs"]
    for name, want in (("h1", points(pp.points_h1, got["idx"])),
                       ("a1", points(pp.points_a1, slice(wlo, whi))),
                       ("c1", points(pp.points_c1, slice(clo, chi)))):
        assert all(np.array_equal(g, x) for g, x in zip(got[name], want)), name
    assert sorted(np.concatenate([r[flavour]["idx"] for r in inputs]).tolist()) == \
        list(range(hdr.domain_size))


@pytest.mark.parametrize("flavour", range(len(FLAVOURS)))
def test_sharded_proof_verifies_with_jax(proofs, flavour):
    from groth16_tpu.ops.limbs import limbs_to_ints
    from groth16_tpu.protocol.prover import Proof
    from groth16_tpu.protocol.types import extract_vkey
    from groth16_tpu.protocol.verifier import verify_proof
    jzkeys, jwtns, sharded, _, _ = proofs
    public_io = limbs_to_ints(np.asarray(jwtns.values[: jzkeys[flavour].header.npubs + 1]))
    assert verify_proof(extract_vkey(jzkeys[flavour]), Proof(public_io, *sharded[0][flavour]))


@pytest.mark.slow
def test_sharded_proof_four_ranks_equals_single(tmp_path):
    """The 2^9 proofs, both flavours, sharded over four ranks while two
    more prove the single-device proofs: equal on every rank."""
    jwtns, jzkeys = _jax_zkeys(LOG2)
    zkeys = [T.zkey_from_numpy(z) for z in jzkeys]
    launch.spawn(PC.cases_rank, 4 + len(zkeys), "gloo", ["cpu"], str(tmp_path),
                 [("proofs", (zkeys, _port_witness(jwtns), MASK, 4))])
    res = PC.load(str(tmp_path), "proofs", 4 + len(zkeys))
    single = [r[0] for r in res[4:]]
    assert all(r == single for r in res[:4])


@pytest.mark.slow
def test_sharded_proof_equals_jax_prove_staged_sharded(tmp_path):
    """The JAX package's staged sharded prover at 2^4 on a 2-device mesh
    (the pattern of tests/test_parallel.py) against the port's on two
    ranks, Snarkjs."""
    from groth16_tpu.parallel.mesh import make_mesh
    from groth16_tpu.parallel.prover_shard import prove_staged_sharded
    from groth16_tpu.protocol.device_inputs import prove_core_inputs
    from groth16_tpu.protocol.prover import Mask
    jwtns, jzkeys = _jax_zkeys(4)
    flavour, log2n, args = prove_core_inputs(jzkeys[0], jwtns, Mask(*MASK))
    want = prove_staged_sharded(make_mesh(2), flavour, log2n, 0, *args)
    launch.spawn(PC.cases_rank, 2, "gloo", ["cpu"], str(tmp_path),
                 [("proofs", ([T.zkey_from_numpy(jzkeys[0])], _port_witness(jwtns), MASK, 2))])
    assert all(r[0] == tuple(want) for r in PC.load(str(tmp_path), "proofs", 2))


@pytest.mark.slow
def test_msm_sharded_equals_jax(tmp_path):
    """The G1 case of tests/test_torch_parallel.py against JAX
    `msm_sharded` on a 2-device mesh, after affine conversion."""
    from groth16_tpu.ops import curve as JC
    from groth16_tpu.ops.limbs import ints_to_limbs
    from groth16_tpu.parallel.mesh import make_mesh
    from groth16_tpu.parallel.msm_shard import msm_sharded
    from test_torch_parallel import G1_CASE
    ks, pts = G1_CASE
    res = msm_sharded(JC.G1, make_mesh(2), ints_to_limbs(ks), JC.points_from_host(JC.G1, pts))
    want = JC.points_to_host(JC.G1, tuple(x[None] for x in res))[0]
    launch.spawn(PC.cases_rank, 2, "gloo", ["cpu"], str(tmp_path),
                 [("msm", ("g1", "G1", ks, pts))])
    assert all(g == want for g in PC.load(str(tmp_path), "g1", 2))
