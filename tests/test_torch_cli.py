"""The port's command line (`python -m groth16_tpu_torch`, `cli.main`) on
the CPU (`--device cpu`), on the product example: setup -> prove -> verify
from the `.r1cs`; the `--nomask` proof equals the checked-in snarkjs-format
JSON; a tampered witness exits 2, a missing file or `--setup` with `-z`
exits 1; the `--sage` script equals the JAX package's `export_sage` and the
`-d` listing the JAX CLI's."""

import json
import os
import subprocess
import sys

import pytest
import torch

from groth16_tpu_torch import cli
from groth16_tpu_torch.files.witness import write_witness
from groth16_tpu_torch.models.circuits import product_circuit

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "examples", "product")
ZKEY, WTNS, R1CS = (os.path.join(EX, f"product.{x}") for x in ("zkey", "wtns", "r1cs"))


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def test_setup_prove_verify_from_r1cs(tmp_path):
    """The module entry point in a subprocess, as a user runs it."""
    out = subprocess.run(
        [sys.executable, "-m", "groth16_tpu_torch", "--setup", "--prove", "--verify", "-t",
         "-r", R1CS, "-w", WTNS, "-o", str(tmp_path / "proof.json"),
         "-i", str(tmp_path / "public.json"), "--write-zkey", str(tmp_path / "c.zkey"),
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "verification succeeded = True" in out.stdout
    assert _json(tmp_path / "public.json") == ["2023", "1022"]
    assert _json(tmp_path / "proof.json")["protocol"] == "groth16"
    assert (tmp_path / "c.zkey").stat().st_size > 0


@pytest.fixture(scope="module")
def nomask_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("nomask")
    rc = cli.main(["--prove", "--verify", "--nomask", "-z", ZKEY, "-w", WTNS,
                   "-o", str(d / "proof.json"), "-i", str(d / "public.json"),
                   "--sage", str(d / "verify.sage"), "--device", "cpu"])
    return rc, d


def test_nomask_proof_equals_expected_json(nomask_run):
    rc, d = nomask_run
    assert rc == 0
    assert _json(d / "proof.json") == _json(os.path.join(EX, "expected_proof.json"))
    assert _json(d / "public.json") == _json(os.path.join(EX, "expected_public.json"))


def test_sage_script_equals_jax(nomask_run, tmp_path):
    from groth16_tpu.files.export_sage import export_sage as jax_export_sage
    from groth16_tpu.files.zkey import parse_zkey as jax_parse_zkey
    from groth16_tpu.protocol.prover import Proof as JaxProof
    from groth16_tpu.protocol.types import extract_vkey as jax_extract_vkey
    _, d = nomask_run
    prf = _json(d / "proof.json")

    def g1(p):
        return (int(p[0]), int(p[1]))

    jprf = JaxProof(public_io=[1] + [int(x) for x in _json(d / "public.json")],
                    pi_a=g1(prf["pi_a"]), pi_c=g1(prf["pi_c"]),
                    pi_b=tuple((int(c[0]), int(c[1])) for c in prf["pi_b"][:2]))
    jax_export_sage(str(tmp_path / "j.sage"), jax_extract_vkey(jax_parse_zkey(ZKEY)), jprf)
    assert (d / "verify.sage").read_text() == (tmp_path / "j.sage").read_text()


def test_tampered_witness_exits_2(tmp_path, capsys):
    values = product_circuit()[1].values.copy()
    values[1, 0] += 1                        # public output 2023 -> 2024
    bad = str(tmp_path / "bad.wtns")
    write_witness(bad, values)
    assert cli.main(["--prove", "--verify", "-z", ZKEY, "-w", bad, "--device", "cpu"]) == 2
    assert "verification succeeded = False" in capsys.readouterr().out


@pytest.mark.parametrize("argv,message", [
    (["--prove", "-z", ZKEY, "-w", "missing.wtns"], "does not exist"),
    (["--setup", "-r", R1CS, "-z", ZKEY], "don't specify the zkey file"),
    (["--setup"], "r1cs file is required"),
    (["--prove", "-z", ZKEY], "missing witness"),
    (["--verify", "-z", ZKEY], "no proof was generated"),
], ids=["missing file", "setup with zkey", "setup without r1cs", "prove without witness",
        "verify without proof"])
def test_refusals_exit_1(argv, message, capsys):
    assert cli.main(argv + ["--device", "cpu"]) == 1
    assert message in capsys.readouterr().out


def test_debug_listing_equals_jax_cli(capsys):
    from groth16_tpu import cli as jax_cli
    assert jax_cli.main(["-d", "-v", "-z", ZKEY]) == 0
    want = capsys.readouterr().out
    assert cli.main(["-d", "-v", "-z", ZKEY, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and "ncoeffs =" in got and "matrix=A" in got


def test_default_device_needs_a_card(capsys):
    """Without `--device` the CLI runs on the card; where there is none it
    stops with exit code 1 instead of running on the CPU."""
    rc = cli.main(["-d", "-z", ZKEY])
    if torch.cuda.is_available():
        assert rc == 0
    else:
        assert rc == 1 and "--device cpu" in capsys.readouterr().out
