"""The readers of the program's own spans, phases and counters
(proofbench/layers: algebra.device_ms, msm_witness.device_ms,
msm_h1.device_ms, msm_b2.device_ms, load.host_ms, graph.pool_gib,
setup.fake_s, setup.upload_s, setup.capture_s) on a stub tracer, and None
where it holds nothing or the program has no tracer."""

import os
import types
from collections import namedtuple

import pytest

from proofbench.harness import plan as PL
from proofbench.harness import port

Rec = namedtuple("Rec", "index name start_ns end_ns parent proof")
NAMES = ("algebra.device_ms", "msm_witness.device_ms", "msm_h1.device_ms", "msm_b2.device_ms",
         "load.host_ms", "graph.pool_gib", "setup.fake_s", "setup.upload_s", "setup.capture_s")
PHASES = ("spmv", "quotient", "msm_a1", "msm_b1", "msm_b2", "msm_h1", "msm_c1", "algebra",
          "affine")


def reader(name):
    return PL._load(os.path.join(PL.PKG, "layers", name + ".py"), name)


def stub(records=(), phases=(), counters=None):
    return types.SimpleNamespace(records=lambda: list(records), phases=lambda: list(phases),
                                 counters=lambda: dict(counters or {}))


def tracer_with(monkeypatch, tracer):
    monkeypatch.setattr(port, "G", types.SimpleNamespace(tracer=tracer))


def test_readers_on_a_stub_tracer(monkeypatch):
    # two proofs; phase i takes i + 1 ms in the first and twice that in the second
    phases = [(p, {ph: k * 1e-3 * (i + 1) for i, ph in enumerate(PHASES)})
              for k, p in ((1, 1), (2, 2))]
    ms = 1_000_000
    records = [Rec(0, "fake_setup", 0, 7_000 * ms, None, None),
               Rec(1, "upload", 0, 500 * ms, None, None),
               Rec(2, "capture", 0, 1_500 * ms, None, None),
               Rec(3, "load", 0, 2 * ms, 5, 1), Rec(4, "load", 10 * ms, 14 * ms, 6, 2),
               Rec(5, "load", 0, 50 * ms, None, None)]          # outside any proof: not read
    tracer_with(monkeypatch, stub(records, phases, {"graph.pool_bytes": 3 * 2**29}))
    got = {n: reader(n)(None) for n in NAMES}
    mean = 1.5          # of the two proofs' factors 1 and 2
    want = {"algebra.device_ms": mean * (8 + 9), "msm_witness.device_ms": mean * (3 + 4 + 7),
            "msm_h1.device_ms": mean * 6, "msm_b2.device_ms": mean * 5, "load.host_ms": 3.0,
            "graph.pool_gib": 1.5, "setup.fake_s": 7.0, "setup.upload_s": 0.5,
            "setup.capture_s": 1.5}
    assert got == pytest.approx(want)


@pytest.mark.parametrize("tracer", [stub(), None], ids=["empty", "no_tracer"])
def test_readers_give_none_without_records(monkeypatch, tracer):
    if tracer is None:
        monkeypatch.setattr(port, "G", types.SimpleNamespace())     # a program without a tracer
    else:
        tracer_with(monkeypatch, tracer)
    assert {n: reader(n)(None) for n in NAMES} == dict.fromkeys(NAMES)


def test_the_cells_report_the_readers():
    for cell in ("num2bits16.stream", "sqchain20.stream"):
        names = [m.name for m in PL.resolve(cell).per_layer]
        assert set(NAMES) <= set(names)


def test_phases_are_the_programs():
    """The readers name the phases the program records."""
    from groth16_tpu_torch import tracer
    assert tracer.PHASES == PHASES
