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

On a CUDA device the proof is one replay of a CUDA graph captured at the
zkey's first proof there (`fused=None`, the default; `fused=False` takes
the staged path, the default on the CPU).  A batch of proofs against one
zkey, the zkey's inputs uploaded to the card once and its graph captured
once: `generate_proofs(zkey, witnesses, device, masks)`.  The command line:
`python -m groth16_tpu_torch --setup --prove --verify -r c.r1cs -w c.wtns`
(`--device cpu` without a card).

On CUDA tensors a proof runs these kernels (groth16_tpu_torch/csrc, built by
nvcc at first use): the SpMV, K1 (point adds, doubling chains, Horner), K2
(the fold MSMs), K3 and the quotient's pointwise kernel, K8 (the merge
tree's levels) with the Fp negation of its signed rows, and K6 and K5 only
in `to_affine`; on CPU tensors their plain PyTorch versions run.
"""

from .protocol.types import Flavour, VKey, ZKey, Witness, R1CS, extract_vkey, zkey_from_numpy
from .protocol.prover import (
    Mask, Proof, generate_proof, generate_proof_with_mask,
    generate_proof_with_trivial_mask, generate_proofs,
)
from .protocol.verifier import verify_proof
from .protocol.fake_setup import ToxicWaste, create_fake_circuit_setup, fake_circuit_setup
from .files.witness import parse_witness, write_witness
from .files.zkey import parse_zkey, write_zkey
from .files.r1cs import parse_r1cs, write_r1cs
from .files.export_json import export_proof, export_public_io
from .files.export_sage import export_sage

__all__ = [
    "Flavour", "VKey", "ZKey", "Witness", "R1CS", "extract_vkey", "zkey_from_numpy",
    "Mask", "Proof", "generate_proof", "generate_proof_with_mask",
    "generate_proof_with_trivial_mask", "generate_proofs", "verify_proof",
    "ToxicWaste", "create_fake_circuit_setup", "fake_circuit_setup",
    "parse_witness", "write_witness", "parse_zkey", "write_zkey",
    "parse_r1cs", "write_r1cs", "export_proof", "export_public_io",
    "export_sage",
]
