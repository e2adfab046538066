"""The cell mimcmerkle22.stream: the generator at the configured scale, the
plan that resolves it, its two readers on a stub tracer, and a tiny
instance through the harness on the CPU."""

import json
import os
import types

import pytest

from proofbench import run
from proofbench.circuits import mimcmerkle
from proofbench.harness import cell, plan as PL
from proofbench.harness import port

CELL = "mimcmerkle22.stream"
READERS = ("msm.pad_pct", "setup.fake_peak_gib")
STATED = ("constraints", "wires", "public", "log2_domain")


def _json(*parts):
    with open(os.path.join(PL.PKG, *parts)) as f:
        return json.load(f)


def test_configured_sizes():
    cfg = _json("configs", "mimcmerkle22.json")
    c = mimcmerkle.build(cfg)
    assert (c.n_constr, c.n_wires, c.n_pub, c.log2_domain) == (3177600, 3180121, 120, 22)
    assert [cfg[k] for k in STATED] == [3177600, 3180121, 120, 22]
    cell.check_sizes(c, cfg)
    assert cfg["reduced"] == [] and (cfg["paths"], cfg["depth"], cfg["rounds"]) == (120, 20, 220)


def test_plan_resolves_the_cell():
    p = PL.resolve(CELL)
    assert p.chips == 1 and p.generator.__name__.endswith("mimcmerkle")
    assert p.traffic == _json("traffic", "stream2.json")
    assert [m.name for m in p.end_to_end] == ["proofs_per_s", "peak_device_gib", "setup_s"]
    assert [m.name for m in p.per_layer] == list(READERS) + ["msm.zero_skip_pct"]
    assert {m.layer for m in p.per_layer} == {"MSMs and the spec-point algebra", "Set-up"}


def _stub(monkeypatch, counters):
    tracer = types.SimpleNamespace(counters=lambda: dict(counters))
    monkeypatch.setattr(port, "G", types.SimpleNamespace(tracer=tracer))


def _reader(name):
    return PL._load(os.path.join(PL.PKG, "layers", name + ".py"), name)


def test_readers_on_a_stub_tracer(monkeypatch):
    _stub(monkeypatch, {"msm.pad_points": 212, "msm.fold_points": 512,
                        "fake_setup.peak_bytes": 3 * 2**29})
    assert {n: _reader(n)(None) for n in READERS} == pytest.approx(
        {"msm.pad_pct": 100 * 212 / 512, "setup.fake_peak_gib": 1.5})


@pytest.mark.parametrize("counters", [{}, {"msm.pad_points": 0, "msm.fold_points": 0}, None],
                         ids=["empty", "no_fold", "no_tracer"])
def test_readers_give_none_without_counters(monkeypatch, counters):
    if counters is None:
        monkeypatch.setattr(port, "G", types.SimpleNamespace())     # a program without a tracer
    else:
        _stub(monkeypatch, counters)
    assert {n: _reader(n)(None) for n in READERS} == dict.fromkeys(READERS)


def test_tiny_instance_through_the_harness():
    """Two paths of depth 1, 12 rounds (a 2^8 domain, every MSM folded)
    through `cell.run` on the CPU, traced: every proof equals the
    reference's, and the padding share is read from the program's
    counters."""
    p = PL.resolve(CELL)
    p.config = {k: v for k, v in p.config.items() if k not in STATED} | {
        "paths": 2, "depth": 1, "rounds": 12}
    p.traffic = p.traffic | {"warm_proofs": 1, "traced_proofs": 1}
    out = cell.run(p, 2**31 + 1601, 0, True, "cpu", run.process_start())
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] == 3
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    assert 0 < out["metrics"]["msm.pad_pct"]["value"] < 100
    assert "setup.fake_peak_gib" not in out["metrics"]            # a CPU run has no device peak
