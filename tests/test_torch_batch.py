"""Batch mode and the device-resident zkey, on the CPU.

`generate_proofs` over three witnesses of `synthetic_circuit(5, seed)`
(seeds 42-44: one constraint system, three witnesses) with fixed masks
equals three `generate_proof_with_mask` calls (tests/test_torch_batch_jax.py
holds the first, and the trivial mask, against the JAX package: a file of
its own, so that the JAX prover's compile runs beside these proofs).  The
zkey's device cache is built once for the batch, is kept per zkey and keyed
by device, and changes neither the zkey file nor what a ZKey compares."""

import dataclasses

import pytest
import torch

from test_snarkjs_golden import FIXED_TOXIC

import groth16_tpu_torch as T
from groth16_tpu_torch.models.circuits import synthetic_circuit
from groth16_tpu_torch.protocol import prover as PV
from groth16_tpu_torch.files.zkey import zkey_bytes

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

CPU = torch.device("cpu")
SEEDS = (42, 43, 44)
MASKS = [T.Mask(0x2B1A5E7F + i, 0x13579BDF + 7 * i) for i in range(len(SEEDS))]


def zkey_file(directory) -> tuple:
    """(zkey file, witnesses): the port's fake setup of synthetic_circuit(5)
    with fixed toxic waste, written to a file in `directory`."""
    r1cs = synthetic_circuit(5)[0]
    zkey = T.fake_circuit_setup(r1cs, T.ToxicWaste(**FIXED_TOXIC), T.Flavour.Snarkjs, CPU)
    path = str(directory / "c.zkey")
    T.write_zkey(path, zkey)
    return path, [synthetic_circuit(5, seed)[1] for seed in SEEDS]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return zkey_file(tmp_path_factory.mktemp("batch"))


def points(p):
    return (p.public_io, p.pi_a, p.pi_b, p.pi_c)


def test_batch_equals_single_proofs(setup):
    path, witnesses = setup
    zkey = T.parse_zkey(path)
    builds = PV.zkey_device_args.builds
    timings = []
    batch = T.generate_proofs(zkey, witnesses, CPU, MASKS, timings)
    assert PV.zkey_device_args.builds == builds + 1          # one upload for the batch
    assert len(timings) == len(SEEDS) and all("total_s" in t for t in timings)
    singles = [T.generate_proof_with_mask(zkey, w, m, CPU) for w, m in zip(witnesses, MASKS)]
    assert PV.zkey_device_args.builds == builds + 1
    assert [points(p) for p in batch] == [points(p) for p in singles]
    assert len({p.pi_a for p in batch}) == len(SEEDS)           # three witnesses, three proofs
    vkey = T.extract_vkey(zkey)
    assert all(T.verify_proof(vkey, p) for p in batch)


def test_cache_is_per_zkey_and_keyed_by_device(setup):
    path, witnesses = setup
    z1, z2 = T.parse_zkey(path), T.parse_zkey(path)
    assert z1.device_cache is not z2.device_cache and not z1.device_cache
    raw = zkey_bytes(z1)
    first = PV.zkey_device_args(z1, "cpu")
    assert PV.zkey_device_args(z1, CPU) is first and list(z1.device_cache) == ["cpu"]
    assert not z2.device_cache                                # parsed twice: two caches
    # an entry under a CUDA device is never handed to a CPU proof, nor the reverse
    sentinel = object()
    z1.device_cache["cuda:0"] = sentinel
    assert PV.zkey_device_args(z1, "cuda:0") is sentinel
    assert PV.zkey_device_args(z1, "cpu") is first
    assert PV.device_key(torch.device("cuda", 1)) == "cuda:1"
    del z1.device_cache["cuda:0"]
    # the cache is no part of the key: same file bytes, not compared, not shown
    assert zkey_bytes(z1) == raw
    field = {f.name: f for f in dataclasses.fields(z1)}["device_cache"]
    assert not field.compare and not field.repr and "device_cache" not in repr(z1)
    assert first.rows.coeff.device == CPU and first.h1[0].shape[0] == z1.header.domain_size
