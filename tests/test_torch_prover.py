"""The port's prover and fake setup on the product circuit vs the JAX package:
the pinned snarkjs proof JSON reproduces, a proof under a fixed non-trivial
mask passes the JAX verifier, and the setups are byte-identical.  The
fixed-mask proof equals the JAX package's in test_torch_prover_jax.py."""

import numpy as np
import pytest

from test_snarkjs_golden import FIXED_TOXIC, PROOF_JSON_GOLDEN

import groth16_tpu_torch as T
from groth16_tpu_torch.files.export_json import proof_json, public_io_json
from groth16_tpu_torch.models.circuits import product_circuit
import torch

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

MASK = (0x2B1A_5E7F_0123_4567_89AB_CDEF_FEDC_BA98, 0x1357_9BDF_2468_ACE0_0FED_CBA9_8765_4321)


@pytest.fixture(scope="module")
def jax_product():
    from groth16_tpu.models.circuits import product_circuit as jax_circuit
    from groth16_tpu.protocol.fake_setup import ToxicWaste, fake_circuit_setup
    from groth16_tpu.protocol.types import Flavour
    r1cs, wtns = jax_circuit()
    return r1cs, wtns, fake_circuit_setup(r1cs, ToxicWaste(**FIXED_TOXIC), Flavour.Snarkjs)


@pytest.fixture(scope="module")
def port_product():
    r1cs, wtns = product_circuit()
    return wtns, T.fake_circuit_setup(r1cs, T.ToxicWaste(**FIXED_TOXIC), T.Flavour.Snarkjs,
                                 torch.device("cpu"))


def test_golden_proof_json_reproduces(port_product):
    wtns, zkey = port_product
    prf = T.generate_proof_with_mask(zkey, wtns, T.Mask(0, 0), torch.device("cpu"))
    assert proof_json(prf) == PROOF_JSON_GOLDEN
    assert public_io_json(prf) == ["2023", "1022"]
    assert T.verify_proof(T.extract_vkey(zkey), prf)


def test_fixed_mask_proof_passes_jax_verifier(jax_product):
    from groth16_tpu.protocol.prover import Proof
    from groth16_tpu.protocol.types import extract_vkey
    from groth16_tpu.protocol.verifier import verify_proof
    _, jwtns, jzkey = jax_product
    prf = T.generate_proof_with_mask(T.zkey_from_numpy(jzkey), jwtns, T.Mask(*MASK),
                                     torch.device("cpu"))
    assert verify_proof(extract_vkey(jzkey), Proof(prf.public_io, prf.pi_a, prf.pi_b, prf.pi_c))
    bad = Proof([1, 2024, 1022], prf.pi_a, prf.pi_b, prf.pi_c)
    assert not verify_proof(extract_vkey(jzkey), bad)



@pytest.mark.parametrize("flavour", ["Snarkjs", "JensGroth"])
def test_fake_setup_byte_identical_to_jax(jax_product, flavour):
    from groth16_tpu.files.zkey import zkey_bytes
    from groth16_tpu.protocol.fake_setup import ToxicWaste, fake_circuit_setup
    from groth16_tpu.protocol.types import Flavour
    r1cs = jax_product[0]
    want = fake_circuit_setup(r1cs, ToxicWaste(**FIXED_TOXIC), getattr(Flavour, flavour))
    got = T.fake_circuit_setup(product_circuit()[0], T.ToxicWaste(**FIXED_TOXIC),
                               getattr(T.Flavour, flavour), torch.device("cpu"))
    assert T.files.zkey.zkey_bytes(got) == zkey_bytes(want)
    assert got.spec == T.zkey_from_numpy(want).spec
    assert np.array_equal(got.vpoints.points_ic.x, want.vpoints.points_ic.x)
