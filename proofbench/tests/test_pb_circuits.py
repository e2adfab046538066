"""The benchmark's circuit generators: sizes at the configured scale, the
witness against every constraint at a small one, the share of 0/1 values,
and the squaring chain against the port's synthetic_circuit it copies."""

import json
import os
import random

import pytest

from proofbench.circuits import num2bits, sqchain
from proofbench.circuits.circuit import R, zero_one_share

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def _config(name):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name, gen, sizes", [
    ("num2bits16", num2bits, (65505, 65506, 16, 1)),
    ("sqchain20", sqchain, (1048573, 1048575, 20, 2)),
])
def test_configured_sizes(name, gen, sizes):
    c = gen.build(_config(name))
    assert (c.n_constr, c.n_wires, c.log2_domain, c.n_pub) == sizes
    cfg = _config(name)
    assert (cfg["constraints"], cfg["wires"], cfg["log2_domain"], cfg["public"]) == sizes


def _unsatisfied(c, w) -> int:
    """Rows where <A_i, w> <B_i, w> != <C_i, w>, row by row on host ints."""
    sums = [[0] * c.n_constr for _ in range(3)]
    for k, m in enumerate((c.a, c.b, c.c)):
        for r, col, v in zip(m.row.tolist(), m.col.tolist(), m.val.tolist()):
            sums[k][r] += v * w[col]
    return sum((a * b - cc) % R != 0 for a, b, cc in zip(*sums))


@pytest.mark.parametrize("gen, cfg", [
    (num2bits, {"bits": 32, "copies": 5}),
    (num2bits, {"bits": 4, "copies": 2}),
    (sqchain, {"log2": 7}),
])
def test_witness_satisfies_every_constraint(gen, cfg):
    c = gen.build(cfg)
    w = gen.witness(c, cfg, random.Random(11))
    assert len(w) == c.n_wires and w[0] == 1
    assert _unsatisfied(c, w) == 0
    bad = list(w)
    bad[-1] = (bad[-1] + 1) % R
    assert _unsatisfied(c, bad) > 0


def test_zero_one_shares():
    cfg = _config("num2bits16")
    c = num2bits.build(cfg)
    share = zero_one_share(num2bits.witness(c, cfg, random.Random(3)))
    assert 0.969 < share < 0.971                      # 32 bits of every 33 wires, and wire 0
    cs = sqchain.build({"log2": 10})
    assert zero_one_share(sqchain.witness(cs, {"log2": 10}, random.Random(3))) < 0.01


def test_num2bits_rows_as_the_template_writes_them():
    c = num2bits.build({"bits": 3, "copies": 2})
    # copy 1's wires: in_1 = 2, bits 6, 7, 8; its rows 4, 5, 6 (booleanity), 7 (sum)
    assert list(zip(c.a.row[3:], c.a.col[3:], c.a.val[3:])) == [(4, 6, 1), (5, 7, 1), (6, 8, 1)]
    brow = [(r, col, v) for r, col, v in zip(c.b.row, c.b.col, c.b.val) if r == 5]
    assert sorted(brow) == [(5, 0, -1), (5, 7, 1)]
    crow = sorted((col, v) for r, col, v in zip(c.c.row, c.c.col, c.c.val) if r == 7)
    assert crow == [(2, -1), (6, 1), (7, 2), (8, 4)]


def test_sqchain_is_the_ports_synthetic_circuit():
    from groth16_tpu_torch.models.circuits import synthetic_circuit
    from proofbench.harness import port

    ours = port.r1cs(sqchain.build({"log2": 6}))
    theirs, _ = synthetic_circuit(6)
    assert ours.n_constr == theirs.n_constr and ours.cfg == theirs.cfg
    assert ours.constraints == theirs.constraints
