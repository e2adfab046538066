"""The port's tracer (groth16_tpu_torch/utils/timing.py) on the CPU: off,
a span fills its sink and records nothing; under torch.profiler or after
`enable()`, spans record their parents and one proof id a proof, on the
profiler's clock; set-up spans are recorded always; the recorder is
bounded; counters add from 0; device phases go under the open proof's
id.  The prover's own spans and phases: tests/test_torch_fused.py."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from groth16_tpu_torch import tracer as T

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts with tracing off and an empty recorder."""
    T.disable()
    T.clear()
    yield
    T.disable()
    T.clear()


def test_off_fills_the_sink_and_records_nothing(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not T.on()
    sink: dict = {}
    with T.span("load", sink, "load_s"):
        with T.span("load.stage"):
            pass
    with T.proof():
        pass
    assert sink["load_s"] >= 0.0 and list(sink) == ["load_s"]
    assert T.records() == [] and T.phases() == []
    # no sink: the one shared null context
    assert T.span("a") is T.span("b") is T.proof()


def test_profiler_on_records_parents_and_one_proof_id_a_proof():
    with profile(activities=[ProfilerActivity.CPU]):
        assert T.on()
        for _ in range(2):
            with T.proof():
                with T.span("load"):
                    with T.span("load.stage"):
                        pass
                with T.span("proof_points"):
                    pass
    assert not T.on()
    recs = T.records()
    assert [r.name for r in recs] == ["load.stage", "load", "proof_points", "proof"] * 2
    by_index = {r.index: r for r in recs}
    ids = []
    for run in (recs[:4], recs[4:]):
        stage, load, points, root = run
        assert (stage.parent, load.parent, points.parent, root.parent) == \
            (load.index, root.index, root.index, None)
        assert len({r.proof for r in run}) == 1 and root.proof is not None
        for r in run[:3]:
            outer = by_index[r.parent]
            assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
        ids.append(root.proof)
    assert ids[0] != ids[1]


def test_record_times_on_the_profilers_clock():
    """A record's start and end fall within 100 us of the profiler's own
    event for the same span (the first record_function of a session is
    slow, so one span warms up)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with T.span("warm.up"):
            pass
        for i in range(3):
            with T.span(f"clock.{i}"):
                sum(range(2000))
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    recs = {r.name: r for r in T.records()}
    for i in range(3):
        e, r = events[f"clock.{i}"], recs[f"clock.{i}"]
        assert abs(r.start_ns - e.start_ns()) < 100_000
        assert abs(r.end_ns - e.end_ns()) < 100_000


def test_enable_and_disable(monkeypatch):
    """Enabled with no profiler, spans are recorded but open no
    record_function (nothing would receive it)."""
    def refused(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler")

    T.enable()
    assert T.on()
    with monkeypatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refused)
        with T.span("cli.step"):
            pass
    T.disable()
    assert not T.on()
    with T.span("after"):
        pass
    assert [r.name for r in T.records()] == ["cli.step"]


def test_setup_spans_are_recorded_always():
    assert not T.on()
    sink: dict = {}
    with T.span("fake_setup", always=True):
        with T.span("fake_setup.terms", sink, always=True):
            pass
    terms, root = T.records()
    assert (terms.name, root.name) == ("fake_setup.terms", "fake_setup")
    assert terms.parent == root.index and root.parent is None and root.proof is None
    assert sink["fake_setup.terms"] >= 0.0


def test_recorder_is_bounded():
    T.enable()
    for i in range(T.LIMIT + 10):
        with T.span("s"):
            pass
    recs = T.records()
    assert len(recs) == T.LIMIT
    assert recs[-1].index - recs[0].index == T.LIMIT - 1


def test_counters_start_at_zero_and_add():
    T.count("graph.pool_bytes", 5)
    T.count("graph.pool_bytes", 7)
    T.count("other", 3)
    assert T.counters() == {"graph.pool_bytes": 12, "other": 3}
    T.clear()
    assert T.counters() == {}


def test_phases_go_under_the_open_proofs_id():
    T.enable()
    with T.proof():
        T.record_phases({"spmv": 1e-3})
        pid = T.current_proof()
    T.record_phases({"spmv": 2e-3})
    assert pid is not None and T.current_proof() is None
    assert T.phases() == [(pid, {"spmv": 1e-3}), (None, {"spmv": 2e-3})]
    assert T.PHASES == ("spmv", "quotient", "msm_a1", "msm_b1", "msm_b2", "msm_h1", "msm_c1",
                        "algebra", "affine")
