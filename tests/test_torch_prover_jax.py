"""One proof of the product circuit under a fixed non-trivial mask, by the
JAX package and by the port from the same zkey: identical proof points.  A
file of its own because the JAX prover's point formulas take about a minute
of XLA:CPU compile."""

import torch

from test_snarkjs_golden import FIXED_TOXIC

import groth16_tpu_torch as T

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

MASK = (0x2B1A_5E7F_0123_4567_89AB_CDEF_FEDC_BA98, 0x1357_9BDF_2468_ACE0_0FED_CBA9_8765_4321)


def test_fixed_mask_proof_equals_jax():
    from groth16_tpu.models.circuits import product_circuit
    from groth16_tpu.protocol.fake_setup import ToxicWaste, fake_circuit_setup
    from groth16_tpu.protocol.prover import Mask, generate_proof_with_mask
    from groth16_tpu.protocol.types import Flavour
    r1cs, wtns = product_circuit()
    zkey = fake_circuit_setup(r1cs, ToxicWaste(**FIXED_TOXIC), Flavour.Snarkjs)
    want = generate_proof_with_mask(zkey, wtns, Mask(*MASK))
    got = T.generate_proof_with_mask(T.zkey_from_numpy(zkey), wtns, T.Mask(*MASK),
                                     torch.device("cpu"))
    assert (got.public_io, got.pi_a, got.pi_b, got.pi_c) == (
        want.public_io, want.pi_a, want.pi_b, want.pi_c)
