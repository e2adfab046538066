"""The reduction of a traced stretch: busy time as the union of device
operations, idle gaps named by the innermost span open at their middle."""

import pytest

from proofbench.harness.profile import reduce, short_name, union


def test_union_merges_overlaps():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]


def test_reduce_busy_window_and_gaps():
    spans = [("request", 0, 100), ("load", 0, 10), ("copy_back", 10, 90), ("replay", 10, 12),
             ("proof_points", 90, 100), ("request", 100, 200), ("load", 100, 130)]
    dev = [("k1<int>(x)", 10, 50), ("k2", 40, 80), ("Memcpy HtoD (Pinned -> Device)", 120, 125),
           ("k1<int>(x)", 140, 190), ("outside", 300, 400)]
    tr = reduce(dev, spans, proofs=2)
    assert tr.window_s == pytest.approx(200e-6)
    assert tr.busy_s == pytest.approx((70 + 5 + 50) * 1e-6)
    assert tr.ops["k1"] == [2, pytest.approx(90e-6)]
    assert tr.ops["Memcpy HtoD"][0] == 1 and "outside" not in tr.ops
    names = [n for n, _ in tr.gaps]
    # gaps, longest first: 80-120 (its middle, 100, in the second request's
    # load), 125-140 (after that load), 0-10 (the first load), 190-200
    assert names == ["load", "request", "load", "request"]
    assert [t for _, t in tr.gaps] == pytest.approx([40e-6, 15e-6, 10e-6, 10e-6])


def test_short_names():
    assert short_name("void at::native::(anonymous namespace)::k<float>(int)") == "at::native::k"
    assert short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
