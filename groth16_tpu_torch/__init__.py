"""groth16_tpu_torch — the Groth16 (BN254) prover of `groth16_tpu`, ported to
PyTorch with hand-written CUDA kernels for one NVIDIA H100.

The JAX package `groth16_tpu` is the reference; this package imports torch
and never jax.  Field elements keep the wire layout uint32[..., 16] (16-bit
limbs, Montgomery form, R = 2^256) at every public function, so arrays
compare directly with the JAX package's.

The main path is one proof from a zkey and a witness on one device:

    from groth16_tpu_torch import (
        parse_zkey, parse_witness, generate_proof_with_mask, Mask,
        extract_vkey, verify_proof,
    )
    zkey, wtns = parse_zkey("c.zkey"), parse_witness("c.wtns")
    prf = generate_proof_with_mask(zkey, wtns, Mask(r, s), torch.device("cuda"))
    assert verify_proof(extract_vkey(zkey), prf)

On CUDA tensors the point, fold, NTT and merge-tree steps run kernels K1-K6
and K8 (groth16_tpu_torch/csrc, built by nvcc at first use); on CPU tensors
their plain PyTorch versions run.
"""

from .protocol.types import Flavour, VKey, ZKey, Witness, R1CS, extract_vkey, zkey_from_numpy
from .protocol.prover import Mask, Proof, generate_proof, generate_proof_with_mask
from .protocol.verifier import verify_proof
from .protocol.fake_setup import ToxicWaste, create_fake_circuit_setup, fake_circuit_setup
from .files.witness import parse_witness, write_witness
from .files.zkey import parse_zkey, write_zkey
from .files.export_json import export_proof, export_public_io

__all__ = [
    "Flavour", "VKey", "ZKey", "Witness", "R1CS", "extract_vkey", "zkey_from_numpy",
    "Mask", "Proof", "generate_proof", "generate_proof_with_mask", "verify_proof",
    "ToxicWaste", "create_fake_circuit_setup", "fake_circuit_setup",
    "parse_witness", "write_witness", "parse_zkey", "write_zkey",
    "export_proof", "export_public_io",
]
