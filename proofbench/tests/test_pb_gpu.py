"""On the card: one short run of each cell through run.py, as the driver
runs it, comes out correct with its end-to-end metrics; a small plan on
two NCCL ranks, one a card, does too.  Skips without the cards."""

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


@pytest.fixture
def two_cards():
    import torch
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")


@pytest.mark.gpu
def test_two_nccl_ranks_on_the_cards(two_cards):
    """A 2^16 squaring chain on two NCCL ranks, one a card, through
    `cell.run`: correct, every rank's proofs equal to rank 0's, the device
    count two and the peak the fuller card's."""
    import time

    import torch

    from pb_cases import tiny_plan
    from proofbench.harness import cell
    p = tiny_plan("sqchain20.stream")
    p.config["log2"] = 16
    p.chips = 2
    out = cell.run(p, 2**31 + 101, 2, False, torch.device("cuda", 0), time.perf_counter())
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"proofs_per_s", "peak_device_gib", "setup_s"}
    assert out["checks"]["rank_mismatched_proofs"] == {"value": 0, "limit": 0}
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 2
    assert dev["memory_peak_bytes"] == max(dev["rank_memory_peak_bytes"]) > 0
    assert len(dev["rank_device_used_bytes"]) == 2
