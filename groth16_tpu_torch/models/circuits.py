"""Circuit fixtures and synthetic circuit generators.

The "models" of this domain are R1CS constraint systems (SURVEY.md: circuits
play the role model families play in an ML framework).  This module provides:

* `product_circuit()` — the reference's hand-crafted 3-constraint fixture
  proving 7*11*13 + 1022 == 2023 (reference tests/groth16/testProver.nim:17-55)
* `synthetic_circuit(log2_constraints)` — parameterized multiplication-chain
  circuits of any power-of-two size for benchmarks (BASELINE.md eval configs
  2-5), with witness generation.
"""

from __future__ import annotations

from ..ops.field import FR
from ..protocol.types import R1CS, Witness, WitnessConfig
from ..files.witness import witness_bytes
from ..ops.limbs import ints_to_limbs_bulk

R = FR.modulus


def make_witness(values) -> Witness:
    return Witness(curve="bn128", r=R, nvars=len(values),
                   values=ints_to_limbs_bulk(v % R for v in values))


def product_circuit():
    """(r1cs, witness): the reference's fixture circuit
    `7*11*13 + 1022 == 2023` (testProver.nim:17-55).

    Wires: [1, out=2023, pubin=1022, 7, 11, 13, 77, 1001]."""
    cfg = WitnessConfig(n_wires=8, n_pub_out=1, n_pub_in=1, n_priv_in=3, n_labels=0)
    minus_one = R - 1
    constraints = [
        # 0 * 0 == -out + pubin + w7   (2023 == 1022 + 1001)
        ([], [], [(1, minus_one), (2, 1), (7, 1)]),
        # w3 * w4 == w6                 (7*11 == 77)
        ([(3, 1)], [(4, 1)], [(6, 1)]),
        # w5 * w6 == w7                 (13*77 == 1001)
        ([(5, 1)], [(6, 1)], [(7, 1)]),
    ]
    r1cs = R1CS(r=R, cfg=cfg, n_constr=3, constraints=constraints,
                wire_to_label=[])
    witness = make_witness([1, 2023, 1022, 7, 11, 13, 7 * 11, 7 * 11 * 13])
    return r1cs, witness


def synthetic_circuit(log2_constraints: int, seed: int = 42):
    """(r1cs, witness): a multiplication-chain circuit with 2^log2 - 2
    constraints (domain size exactly 2^log2 after the public-IO dummy rows).

    Chain: w_{i+1} = w_i * w_i starting from a random private input; the
    public output is the chain end.  Every constraint is a real quadratic
    constraint, so Az/Bz/Cz, the quotient and all five MSMs are fully
    exercised at size 2^log2.
    """
    # domain = 2^ceil(log2(n_constr + npub + 1)); npub = 2 here, so this is
    # the largest constraint count whose domain is exactly 2^log2_constraints
    n_constr = (1 << log2_constraints) - 3
    x0 = (pow(5, seed + 3, R) + 7) % R
    chain = [x0]
    for _ in range(n_constr):
        chain.append(chain[-1] * chain[-1] % R)
    out = chain[-1]

    # wires: [1, out, x0, chain[1..n_constr-1]] (chain end IS the out wire)
    n_wires = n_constr + 2
    cfg = WitnessConfig(n_wires=n_wires, n_pub_out=1, n_pub_in=1,
                        n_priv_in=0, n_labels=0)

    def wire(i):  # chain[i] -> wire index
        return 2 if i == 0 else 2 + i

    constraints = []
    for i in range(n_constr - 1):
        constraints.append(([(wire(i), 1)], [(wire(i), 1)], [(wire(i + 1), 1)]))
    # last link writes the public output wire
    constraints.append(([(wire(n_constr - 1), 1)], [(wire(n_constr - 1), 1)], [(1, 1)]))

    r1cs = R1CS(r=R, cfg=cfg, n_constr=n_constr, constraints=constraints,
                wire_to_label=[])
    witness = make_witness([1, out, x0] + chain[1:n_constr])
    return r1cs, witness
