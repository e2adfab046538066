"""On the card: one short run of each cell through run.py, as the driver
runs it, comes out correct with its end-to-end metrics.  Skips without a
CUDA card."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell, metrics", [
    ("num2bits16.stream", {"proofs_per_s", "latency_p95_ms", "peak_device_gib", "setup_s"}),
    ("sqchain20.stream", {"proofs_per_s", "peak_device_gib", "setup_s"}),
])
def test_cell_on_the_card(card, cell, metrics):
    done = subprocess.run([sys.executable, "proofbench/run.py", "--workload", cell, "--seed",
                           str(2**31 + 99), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == metrics
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
