"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped, the program's setup and proofs are
replaced by a tiny cell's real proofs, replayed, and altered where they
are produced."""

import pytest

from proofbench.harness import cell, port
from pb_cases import tiny_plan

SEED = 2**32 + 5


@pytest.fixture(scope="module")
def recorded():
    """The real proofs of a tiny run, in the order the run asked for them."""
    got = []
    real = port.prove

    def record(*args, **kwargs):
        got.append(real(*args, **kwargs))
        return got[-1]

    port.prove = record
    try:
        out = cell.run(tiny_plan("sqchain20.stream"), SEED, 0, False, "cpu", 0.0)
    finally:
        port.prove = real
    assert out["correct"] is True and len(got) == 2
    return got


def _replay(monkeypatch, recorded, alter):
    calls = []

    def prove(zkey, wtns, r, s, device, timings=None):
        calls.append(recorded[len(calls)])
        return alter(calls)

    monkeypatch.setattr(port, "setup", lambda *a, **k: None)
    monkeypatch.setattr(port, "prove", prove)
    return cell.run(tiny_plan("sqchain20.stream"), SEED, 0, False, "cpu", 0.0)


def test_replayed_proofs_are_correct(monkeypatch, recorded):
    assert _replay(monkeypatch, recorded, lambda calls: calls[-1])["correct"] is True


@pytest.mark.parametrize("fault", ["point_altered", "public_io_altered", "state_unchanged"])
def test_fault_comes_out_not_correct(monkeypatch, recorded, fault):
    def alter(calls):
        pi_a, pi_b, pi_c, pub = calls[-1]
        if fault == "point_altered":            # pi_c replaced where it is produced
            return pi_a, pi_b, pi_a, pub
        if fault == "public_io_altered":
            return pi_a, pi_b, pi_c, [pub[0], pub[1] + 1] + pub[2:]
        return calls[0]                         # every request answered with the first proof

    out = _replay(monkeypatch, recorded, alter)
    assert out["correct"] is False
    bad = out["checks"]["mismatched_proofs"]["value"]
    assert bad >= 1 and out["failed"] == bad
