"""A cell of d > 1 chips through `cell.run`: d gloo ranks on the CPU, each
proving every request through the program's sharded entry, rank 0 on the
clock.  The run is correct, reports what the one-card run reports with
the rank count as its device count, and rank 0's proofs are the one-card
run's, byte for byte; a rank whose proof differs from rank 0's fails
`rank_mismatched_proofs`; a rank whose reader loads the JAX package ends
the run with no result."""

import sys
import types

import pytest
import torch

from proofbench.harness import cell, plan as PL
from pb_cases import tiny_plan

SEED = 2**32 + 41
LOG2 = 4                     # the smallest domain four ranks can split


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Each rank takes the caller's thread count: one, so that four ranks
    do not oversubscribe the CPU."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _plan(chips: int):
    p = tiny_plan("sqchain20.stream")
    p.config["log2"] = LOG2
    p.chips = chips
    return p


def _run(monkeypatch, chips: int, trace: bool = False):
    """The run's result and the proofs compared with the reference."""
    seen = []
    real = cell.compare

    def compare(circuit, toxic, pool, proofs):
        seen.extend(proofs)
        return real(circuit, toxic, pool, proofs)

    monkeypatch.setattr(cell, "compare", compare)
    return cell.run(_plan(chips), SEED, 0, trace, "cpu", 0.0), seen


@pytest.fixture(scope="module")
def one_card():
    mp = pytest.MonkeyPatch()
    try:
        return _run(mp, 1)
    finally:
        mp.undo()


@pytest.mark.parametrize("ranks", [2, 4])
def test_ranks_run_matches_one_card(monkeypatch, one_card, ranks):
    base, base_proofs = one_card
    out, proofs = _run(monkeypatch, ranks)
    assert base["correct"] is True and out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == set(base["metrics"]) == {"proofs_per_s", "setup_s"}
    assert out["device"]["count"] == ranks and base["device"]["count"] == 1
    assert out["checks"]["rank_mismatched_proofs"] == {"value": 0, "limit": 0}
    assert set(out["checks"]) == set(base["checks"]) | {"rank_mismatched_proofs"}
    assert list(out)[-1] == "checks" and out["attempted"] == len(proofs) == len(base_proofs)
    assert [(p.witness, p.r, p.s) for p in proofs] == [(p.witness, p.r, p.s) for p in base_proofs]
    assert [p.points for p in proofs] == [p.points for p in base_proofs]


def test_ranks_traced_run(monkeypatch):
    out, proofs = _run(monkeypatch, 2, trace=True)
    assert out["correct"] is True and out["device"]["count"] == 2
    assert out["attempted"] == len(proofs) == 3          # warm-up, window, traced
    assert "busy_s" in out["device"] and "breakdown" in out


def _proved(witness, points):
    return cell.Proved(witness, 5, 9, 0.0, 1.0, points)


@pytest.mark.parametrize("forge, bad", [
    (lambda ps: ps, 0),
    (lambda ps: [ps[0], _proved(1, ((1, 2), ps[1].points[1], ps[1].points[2], [3]))], 1),
    (lambda ps: ps[:1], 1),
    (lambda ps: [_proved(0, ps[1].points), ps[1]], 1),
])
def test_forged_rank_proof_fails_rank_check(forge, bad):
    head = [_proved(0, ((7, 8), ((1, 2), (3, 4)), (5, 6), [3])),
            _proved(1, ((9, 10), ((1, 2), (3, 4)), (11, 12), [3]))]
    assert cell.rank_mismatches([head, list(head), forge(list(head))]) == bad


def _load_jax_package(ctx):
    """A reader that loads a stub named as the JAX package and reads nothing."""
    sys.modules.setdefault("groth16_tpu", types.ModuleType("groth16_tpu"))
    return None


def rank_with_a_jax_reader(mesh, *args):
    """`cell.rank_main` with one more end-to-end reader in the rank's plan,
    `_load_jax_package`."""
    real = PL.resolve

    def resolve(name):
        p = real(name)
        p.end_to_end.append(PL.Metric("loads_jax", "1", "lower", _load_jax_package))
        return p

    PL.resolve = resolve
    cell.rank_main(mesh, *args)


def test_rank_reader_loading_jax_ends_the_run(monkeypatch):
    monkeypatch.setattr(cell, "rank_main", rank_with_a_jax_reader)
    with pytest.raises(Exception, match="rank 0: the process loaded groth16_tpu"):
        cell.run(_plan(2), SEED, 0, False, "cpu", 0.0)
