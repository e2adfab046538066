"""Batch mode, the trivial mask and the fused core against the JAX package
on the CPU: the first proof of `generate_proofs` over
`synthetic_circuit(5, seed)` witnesses equals the JAX package's staged
proof from the same zkey file under the same mask,
`generate_proof_with_trivial_mask` equals JAX's, and the port's fused core
(`prove_core_device`, run eagerly) equals JAX's staged proof and, in the
slow lane, JAX's own fused `prove_core_device`.
A file of its own because the JAX prover's point formulas take minutes of
XLA:CPU compile (tests/test_torch_batch.py holds the batch against single
proofs)."""

import pytest
import torch

import groth16_tpu_torch as T
from groth16_tpu_torch.protocol import prover as PV

from fused_cases import shared_msms
from test_torch_batch import CPU, MASKS, points, zkey_file

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _msms_once():
    """The port's staged and fused runs of one witness compute each MSM
    once (`fused_cases.shared_msms`)."""
    with shared_msms():
        yield


@pytest.fixture(scope="module")
def jax_setup(tmp_path_factory):
    """(port zkey, JAX zkey, witnesses) from one zkey file."""
    from groth16_tpu.files.zkey import parse_zkey as jax_parse_zkey
    path, witnesses = zkey_file(tmp_path_factory.mktemp("batch_jax"))
    return T.parse_zkey(path), jax_parse_zkey(path), witnesses


@pytest.fixture(scope="module")
def jax_staged(jax_setup):
    """The JAX package's staged proof of witness i under a mask, computed
    once for the module (a JAX proof takes most of a minute here)."""
    from groth16_tpu.protocol import prover as JP
    _, jzkey, witnesses = jax_setup
    memo = {}

    def proof(i, mask):
        key = (i, mask.r, mask.s)
        if key not in memo:
            memo[key] = JP.generate_proof_with_mask(jzkey, witnesses[i], JP.Mask(mask.r, mask.s),
                                                    fused=False)
        return memo[key]
    return proof


def test_first_batch_proof_equals_jax_staged(jax_setup, jax_staged):
    zkey, _, witnesses = jax_setup
    got = T.generate_proofs(zkey, witnesses[:1], CPU, MASKS[:1])[0]
    assert points(got) == points(jax_staged(0, MASKS[0]))


def test_trivial_mask_equals_jax(jax_setup):
    from groth16_tpu.protocol import prover as JP
    zkey, jzkey, witnesses = jax_setup
    want = JP.generate_proof_with_trivial_mask(jzkey, witnesses[1])
    got = T.generate_proof_with_trivial_mask(zkey, witnesses[1], CPU)
    assert points(got) == points(want)
    assert T.verify_proof(T.extract_vkey(zkey), got)


def _port_fused(zkey, wtns, mask):
    hdr = zkey.header
    return PV.proof_points(PV.prove_core_device(
        hdr.flavour, hdr.log_domain_size, PV.zkey_device_args(zkey, CPU),
        PV.spec_device_args(zkey, CPU), torch.from_numpy(wtns.values),
        torch.from_numpy(PV.mask_limbs(mask))))


def test_fused_core_equals_jax_staged(jax_setup, jax_staged):
    zkey, _, witnesses = jax_setup
    assert _port_fused(zkey, witnesses[0], MASKS[0]) == points(jax_staged(0, MASKS[0]))[1:]


@pytest.mark.slow
def test_fused_core_equals_jax_fused(jax_setup):
    """JAX's one-dispatch `prove_core_device` on the inputs of
    `device_inputs.prove_core_inputs`, its points taken to affine as
    `_generate_proof_fused` takes them (one XLA:CPU module of the whole
    proof: minutes of compile)."""
    import jax.numpy as jnp
    from groth16_tpu.ops import curve as JC
    from groth16_tpu.protocol import prover as JP
    from groth16_tpu.protocol.device_inputs import prove_core_inputs
    zkey, jzkey, witnesses = jax_setup
    flavour, log2n, args = prove_core_inputs(jzkey, witnesses[0],
                                             JP.Mask(MASKS[0].r, MASKS[0].s))
    pi_a, pi_b, pi_c = JP.prove_core_device(flavour, log2n, *args)
    pa, pc = JC.points_to_host(JC.G1, tuple(jnp.stack([a, c]) for a, c in zip(pi_a, pi_c)))
    pb = JC.points_to_host(JC.G2, tuple(x[None] for x in pi_b))[0]
    assert _port_fused(zkey, witnesses[0], MASKS[0]) == (pa, pb, pc)
