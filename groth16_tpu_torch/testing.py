"""Test helpers: parse -> prove -> verify round trips in one call.

Counterpart of groth16_tpu/testing.py (the reference's
`groth16/test_proof.nim`: `testProveAndVerify` :18-35,
`testFakeSetupAndVerify` :39-66), on the device the caller names.
"""

from __future__ import annotations

import time

import torch

from .files.r1cs import parse_r1cs
from .files.witness import parse_witness
from .files.zkey import parse_zkey
from .protocol.fake_setup import create_fake_circuit_setup
from .protocol.prover import Proof, generate_proof
from .protocol.types import Flavour, extract_vkey
from .protocol.verifier import verify_proof


def test_prove_and_verify(zkey_file: str, wtns_file: str, device: torch.device,
                          verbose: bool = True) -> Proof:
    """Parse a .zkey and a .wtns, prove on `device`, verify; returns the
    proof, or raises if it does not verify."""
    t0 = time.perf_counter()
    zkey = parse_zkey(zkey_file)
    wtns = parse_witness(wtns_file)
    t1 = time.perf_counter()
    proof = generate_proof(zkey, wtns, device)
    t2 = time.perf_counter()
    ok = verify_proof(extract_vkey(zkey), proof)
    t3 = time.perf_counter()
    if verbose:
        print(f"parse {t1 - t0:.3f}s  prove {t2 - t1:.3f}s  "
              f"verify {t3 - t2:.3f}s  ok={ok}")
    if not ok:
        raise AssertionError("proof failed to verify")
    return proof


def test_fake_setup_and_verify(r1cs_file: str, wtns_file: str, device: torch.device,
                               flavour: Flavour = Flavour.Snarkjs,
                               verbose: bool = True) -> Proof:
    """Parse a .r1cs and a .wtns, run the fake trusted setup and prove on
    `device`, verify; returns the proof, or raises if it does not verify."""
    t0 = time.perf_counter()
    r1cs = parse_r1cs(r1cs_file)
    wtns = parse_witness(wtns_file)
    zkey = create_fake_circuit_setup(r1cs, flavour, device)
    t1 = time.perf_counter()
    proof = generate_proof(zkey, wtns, device)
    t2 = time.perf_counter()
    ok = verify_proof(extract_vkey(zkey), proof)
    t3 = time.perf_counter()
    if verbose:
        print(f"setup {t1 - t0:.3f}s  prove {t2 - t1:.3f}s  "
              f"verify {t3 - t2:.3f}s  flavour={flavour.name}  ok={ok}")
    if not ok:
        raise AssertionError("proof failed to verify")
    return proof
