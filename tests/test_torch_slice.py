"""The slice end to end on the CPU at 2^9 constraints: a zkey from the JAX
package's fake setup (its host path, fixed toxic waste) is proved by the port
on the fold path (every MSM has >= 128 points) and passes the JAX verifier;
the port's own setup of the same circuit is byte-identical.  The full port
vs JAX proof comparison at 2^9 runs in the slow lane."""

import numpy as np
import pytest

from test_snarkjs_golden import FIXED_TOXIC

import groth16_tpu_torch as T
from groth16_tpu_torch.models.circuits import synthetic_circuit
import torch

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

LOG2 = 9
MASK = (0x0DDC_0FFE_E15_BADC_0DE5, 0x5EED_F00D_CAFE_BEEF_0123)


@pytest.fixture(scope="module")
def jax_zkey():
    from groth16_tpu.models.circuits import synthetic_circuit as jax_circuit
    from groth16_tpu.protocol.fake_setup import ToxicWaste, fake_circuit_setup
    from groth16_tpu.protocol.types import Flavour
    r1cs, wtns = jax_circuit(LOG2)
    return wtns, fake_circuit_setup(r1cs, ToxicWaste(**FIXED_TOXIC), Flavour.Snarkjs)


def test_port_proves_jax_zkey_on_fold_path(jax_zkey):
    from groth16_tpu.protocol.prover import Proof
    from groth16_tpu.protocol.types import extract_vkey
    from groth16_tpu.protocol.verifier import verify_proof
    jwtns, jzkey = jax_zkey
    assert jzkey.header.nvars - jzkey.header.npubs - 1 >= 128      # no naive MSM
    prf = T.generate_proof_with_mask(T.zkey_from_numpy(jzkey), jwtns, T.Mask(*MASK),
                                     torch.device("cpu"))
    assert verify_proof(extract_vkey(jzkey), Proof(prf.public_io, prf.pi_a, prf.pi_b, prf.pi_c))


def test_port_setup_byte_identical_to_jax(jax_zkey):
    from groth16_tpu.files.zkey import zkey_bytes
    _, jzkey = jax_zkey
    got = T.fake_circuit_setup(synthetic_circuit(LOG2)[0], T.ToxicWaste(**FIXED_TOXIC),
                               T.Flavour.Snarkjs, torch.device("cpu"))
    assert T.files.zkey.zkey_bytes(got) == zkey_bytes(jzkey)
    assert np.array_equal(got.vpoints.points_ic.y, jzkey.vpoints.points_ic.y)


@pytest.mark.slow
def test_port_proof_equals_jax_at_2_9(jax_zkey):
    from groth16_tpu.protocol.prover import Mask, generate_proof_with_mask
    jwtns, jzkey = jax_zkey
    want = generate_proof_with_mask(jzkey, jwtns, Mask(*MASK))
    got = T.generate_proof_with_mask(T.zkey_from_numpy(jzkey), jwtns, T.Mask(*MASK),
                                     torch.device("cpu"))
    assert (got.pi_a, got.pi_b, got.pi_c) == (want.pi_a, want.pi_b, want.pi_c)
