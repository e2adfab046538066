"""snarkjs-compatible JSON export of proofs and public inputs
(reference `groth16/files/export_json.nim`).

Output shapes match the reference exactly:
  * public IO: a JSON array of quoted decimal strings, SKIPPING the constant-1
    slot (export_json.nim:25-44)
  * proof: {"protocol": "groth16", "curve": "bn128", pi_a, pi_b, pi_c} with
    G1 = [x, y, "1"] and G2 = [[x0,x1],[y0,y1],["1","0"]] projective padding
    (export_json.nim:48-80)
"""

from __future__ import annotations

import json

from ..protocol.prover import Proof


def _g1_json(pt) -> list:
    if pt is None:
        return ["0", "1", "0"]
    return [str(pt[0]), str(pt[1]), "1"]


def _g2_json(pt) -> list:
    if pt is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    return [[str(pt[0][0]), str(pt[0][1])],
            [str(pt[1][0]), str(pt[1][1])],
            ["1", "0"]]


def proof_json(prf: Proof) -> dict:
    return {
        "protocol": "groth16",
        "curve": "bn128",
        "pi_a": _g1_json(prf.pi_a),
        "pi_b": _g2_json(prf.pi_b),
        "pi_c": _g1_json(prf.pi_c),
    }


def public_io_json(prf: Proof) -> list:
    """Skips the constant-1 slot (reference export_json.nim:40-41)."""
    assert len(prf.public_io) > 0 and prf.public_io[0] == 1
    return [str(v) for v in prf.public_io[1:]]


def export_proof(path: str, prf: Proof) -> None:
    with open(path, "w") as f:
        json.dump(proof_json(prf), f, indent=1)
        f.write("\n")


def export_public_io(path: str, prf: Proof) -> None:
    with open(path, "w") as f:
        json.dump(public_io_json(prf), f, indent=1)
        f.write("\n")
