"""The control (proofbench/control.py) at a size a test run holds: the
reference in the program's place, with one nonzero private witness value
taken as 0, fails the comparison on every proof."""

import pytest

from proofbench import control
from pb_cases import tiny_plan


@pytest.mark.parametrize("cell_name", ["num2bits16.stream", "sqchain20.stream"])
@pytest.mark.parametrize("seed", [3, 2**31 + 1])
def test_control_fails_every_proof(cell_name, seed):
    p = tiny_plan(cell_name)
    checks = control.control(p, seed, proofs=5)
    assert checks["mismatched_proofs"] == [6, 0]       # one warm-up and five window proofs
    assert checks["unsatisfied_rows"][1] == 0


def test_broken_witness_differs_in_one_private_value():
    import random
    w = [1, 5, 0, 7, 0, 9]
    b = control.broken(w, 1, random.Random(0))
    diff = [i for i, (x, y) in enumerate(zip(w, b)) if x != y]
    assert len(diff) == 1 and diff[0] in (3, 5) and b[diff[0]] == 0
