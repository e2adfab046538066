"""Batch mode and the trivial mask against the JAX package on the CPU: the
first proof of `generate_proofs` over `synthetic_circuit(5, seed)`
witnesses equals the JAX package's staged proof from the same zkey file
under the same mask, and `generate_proof_with_trivial_mask` equals JAX's.
A file of its own because the JAX prover's point formulas take minutes of
XLA:CPU compile (tests/test_torch_batch.py holds the batch against single
proofs)."""

import pytest
import torch

import groth16_tpu_torch as T

from test_torch_batch import CPU, MASKS, points, zkey_file

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_setup(tmp_path_factory):
    """(port zkey, JAX zkey, witnesses) from one zkey file."""
    from groth16_tpu.files.zkey import parse_zkey as jax_parse_zkey
    path, witnesses = zkey_file(tmp_path_factory.mktemp("batch_jax"))
    return T.parse_zkey(path), jax_parse_zkey(path), witnesses


def test_first_batch_proof_equals_jax_staged(jax_setup):
    from groth16_tpu.protocol import prover as JP
    zkey, jzkey, witnesses = jax_setup
    got = T.generate_proofs(zkey, witnesses[:1], CPU, MASKS[:1])[0]
    want = JP.generate_proof_with_mask(jzkey, witnesses[0], JP.Mask(MASKS[0].r, MASKS[0].s),
                                       fused=False)
    assert points(got) == points(want)


def test_trivial_mask_equals_jax(jax_setup):
    from groth16_tpu.protocol import prover as JP
    zkey, jzkey, witnesses = jax_setup
    want = JP.generate_proof_with_trivial_mask(jzkey, witnesses[1])
    got = T.generate_proof_with_trivial_mask(zkey, witnesses[1], CPU)
    assert points(got) == points(want)
    assert T.verify_proof(T.extract_vkey(zkey), got)
