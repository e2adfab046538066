"""A CPU rehearsal of a tiny cell through the harness's own import path,
in a process of its own: the run is correct, prints its metrics and
checks, and leaves no JAX in sys.modules; run.py refuses without a card."""

import json
import os
import subprocess
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.dirname(os.path.abspath(__file__))

REHEARSAL = f"""
import json, sys, time
sys.path[:0] = [{ROOT!r}, {HERE!r}]
from proofbench import run
from proofbench.harness import cell
from pb_cases import tiny_plan
out = cell.run(tiny_plan("num2bits16.stream"), 2**31 + 977, 0, False, "cpu", run.process_start())
out["loaded"] = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def rehearsal():
    done = subprocess.run([sys.executable, "-c", REHEARSAL], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_tiny_cell_is_correct_and_reports(rehearsal):
    assert rehearsal["correct"] is True
    assert rehearsal["attempted"] == 2 and rehearsal["failed"] == 0
    assert set(rehearsal["metrics"]) == {"proofs_per_s", "latency_p95_ms", "setup_s"}
    assert list(rehearsal)[-2] == "checks"          # last key of a result line (before "loaded")
    assert all(c["value"] <= c["limit"] for c in rehearsal["checks"].values())


def test_rehearsal_loads_no_jax(rehearsal):
    """Whole top-level names: groth16_tpu_torch is not groth16_tpu."""
    loaded = set(rehearsal["loaded"])
    assert "groth16_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "groth16_tpu"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from proofbench import run
    monkeypatch.setitem(sys.modules, "groth16_tpu_torch_like", types.ModuleType("x"))
    base = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "groth16_tpu.protocol", types.ModuleType("y"))
    assert run.forbidden_modules() == sorted(set(base) | {"groth16_tpu"})


def test_run_refuses_without_a_card():
    done = subprocess.run([sys.executable, "proofbench/run.py", "--workload", "num2bits16.stream",
                           "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout == ""
    assert "no CUDA device" in done.stderr
