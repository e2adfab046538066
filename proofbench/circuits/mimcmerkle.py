"""A batch of tornado-core's MerkleTreeChecker(levels) (circuits/merkleTree.circom):
`paths` membership checks, each with its own public root, every hash
circomlib's MiMCSponge(2, rounds, 1) with k = 0, every constraint as the
templates write it after circom's --O1, which substitutes each equality
between two signals, or a signal and a constant (`xR[i] <== xL[i-1]`,
`xL_out`, `k <== 0`, the sponge's `ins` and `outs`, `root === hash`).

A level of a path: DualMux, then HashLeftRight of its two outputs.

    s (1 - s) = 0               A: s;  B: 1 - s
    (in1 - in0) s = out0 - in0
    (in0 - in1) s = out1 - in1

Each MiMCFeistel round i, t = xL[i-1] + c_i (round 0: t = xL_in; c_0 and
c_{rounds-1} are 0), aux = xR[i-1] = xL[i-2] (round 0: xR_in, round 1:
xL_in):

    t t = t2;  t2 t2 = t4;  t4 t = xL[i] - aux     (the last round: xR_out)

The sponge's second Feistel takes xL_in = xL_out(first) + in1 (one linear
row: A = B = 0) and xR_in = xR_out(first); its xL_out is the level's
hash, and the last level's is the path's public root.  So a level has
3 + 6 rounds + 1 rows (1,324 at 220 rounds).

Wires: 0 the one, the roots (public inputs), then the private inputs
(every path's leaf, then its siblings, then its index bits), then each
path's intermediates, level by level: out0, out1, the first Feistel's
(t2, t4, out) of each round, the second's xL_in, its rounds.

circomlib's round constants come from keccak and are not in the
repository: `constants` draws full field elements from a fixed stream, the
same for every run.  The witness draws each path's leaf, siblings and bits
uniform from the request's generator.
"""

from __future__ import annotations

import random

import numpy as np

from .circuit import R, Circuit, Matrix

ONE, IN0, SIB, BIT, LOCAL = range(5)        # where an entry's wire comes from


def constants(rounds: int) -> list:
    """c_0 .. c_{rounds-1}: 0 at both ends, full field elements between,
    each the same at every size (a prefix of one fixed stream)."""
    rng = random.Random("proofbench/mimcmerkle/constants")
    inner = [rng.randrange(R) for _ in range(rounds - 2)]
    return [0] + inner + [0]


def _sizes(cfg: dict) -> tuple:
    return int(cfg["paths"]), int(cfg["depth"]), int(cfg["rounds"])


def _level_slots(rounds: int) -> tuple:
    """(local wires a level, the local wire of its hash, the first local
    wire of the second Feistel's rounds)."""
    second = 2 + 3 * rounds + 1
    return second + 3 * rounds, second + 3 * (rounds - 2) + 2, second


def _level_template(rounds: int) -> list:
    """One level's entries, each matrix's sorted by row: [A, B, C] of
    (local row, wire kind, local wire, coefficient) lists."""
    c = constants(rounds)
    mats = ([], [], [])
    row = 0

    def put(m, *entries):
        for kind, k, v in entries:
            mats[m].append((row, kind, k, v))

    # DualMux: s (1 - s) = 0, then out0 and out1 (local wires 0, 1)
    put(0, (BIT, 0, 1)); put(1, (ONE, 0, 1), (BIT, 0, -1)); row += 1
    put(0, (SIB, 0, 1), (IN0, 0, -1)); put(1, (BIT, 0, 1))
    put(2, (LOCAL, 0, 1), (IN0, 0, -1)); row += 1
    put(0, (IN0, 0, 1), (SIB, 0, -1)); put(1, (BIT, 0, 1))
    put(2, (LOCAL, 1, 1), (SIB, 0, -1)); row += 1

    def feistel(base, xl_in, xr_in):
        """Rounds whose (t2, t4, out) are local wires base + 3 i + (0, 1, 2);
        xl_in, xr_in: (kind, k) or None for the constant 0."""
        nonlocal row
        for i in range(rounds):
            xl = xl_in if i == 0 else (LOCAL, base + 3 * (i - 1) + 2)
            aux = xr_in if i == 0 else xl_in if i == 1 else (LOCAL, base + 3 * (i - 2) + 2)
            t = [(*xl, 1)] + ([(ONE, 0, c[i])] if c[i] else [])
            t2, t4, out = base + 3 * i, base + 3 * i + 1, base + 3 * i + 2
            put(0, *t); put(1, *t); put(2, (LOCAL, t2, 1)); row += 1
            put(0, (LOCAL, t2, 1)); put(1, (LOCAL, t2, 1)); put(2, (LOCAL, t4, 1)); row += 1
            put(0, (LOCAL, t4, 1)); put(1, *t)
            put(2, (LOCAL, out, 1), *([(*aux, -1)] if aux else [])); row += 1

    feistel(2, (LOCAL, 0), None)
    first_xl_out, first_xr_out = 2 + 3 * (rounds - 2) + 2, 2 + 3 * (rounds - 1) + 2
    _, _, second = _level_slots(rounds)
    put(2, (LOCAL, second - 1, 1), (LOCAL, first_xl_out, -1), (LOCAL, 1, -1)); row += 1
    feistel(second, (LOCAL, second - 1), (LOCAL, first_xr_out))
    return list(mats)


def _layout(cfg: dict) -> dict:
    """Global wire numbers: roots [P], leaves [P], siblings and bits [P, L],
    local [P, L, S] (the last level's hash is the root) and the row count
    of a level."""
    P, L, rounds = _sizes(cfg)
    S, hash_slot, _ = _level_slots(rounds)
    roots = 1 + np.arange(P, dtype=np.int64)
    leaves = 1 + P + np.arange(P, dtype=np.int64)
    sib = 1 + 2 * P + np.arange(P * L, dtype=np.int64).reshape(P, L)
    bits = sib + P * L
    keep = np.ones((P, L, S), bool)
    keep[:, L - 1, hash_slot] = False
    local = 1 + 2 * P + 2 * P * L + np.cumsum(keep.ravel()).reshape(P, L, S) - 1
    local[:, L - 1, hash_slot] = roots
    return {"roots": roots, "leaves": leaves, "sib": sib, "bits": bits, "local": local,
            "rows": 3 + 6 * rounds + 1, "wires": 1 + 2 * P + 2 * P * L + int(keep.sum())}


def build(cfg: dict) -> Circuit:
    P, L, rounds = _sizes(cfg)
    lay = _layout(cfg)
    _, hash_slot, _ = _level_slots(rounds)
    in0 = np.concatenate([lay["leaves"][:, None], lay["local"][:, :-1, hash_slot]], 1)
    wires = {ONE: np.zeros((P, L), np.int64), IN0: in0, SIB: lay["sib"], BIT: lay["bits"]}
    level_row = (np.arange(P * L, dtype=np.int64) * lay["rows"]).reshape(P, L)
    out = []
    for entries in _level_template(rounds):
        lrow, kind, k, val = (np.array(x, dtype=object if j == 3 else np.int64)
                              for j, x in enumerate(zip(*entries)))
        col = np.empty((P, L, len(entries)), np.int64)
        for kd in (ONE, IN0, SIB, BIT):
            col[:, :, kind == kd] = wires[kd][:, :, None]
        col[:, :, kind == LOCAL] = lay["local"][:, :, k[kind == LOCAL]]
        row = level_row[:, :, None] + lrow[None, None, :]
        out.append(Matrix(row.ravel(), col.ravel(), np.tile(val, P * L)))
    return Circuit(name=f"mimcmerkle{P}x{L}x{rounds}", n_constr=P * L * lay["rows"],
                   n_wires=lay["wires"], n_pub_out=0, n_pub_in=P, a=out[0], b=out[1], c=out[2])


def _feistel(xl: int, xr: int, c: list, sink: list) -> tuple:
    """MiMCFeistel with k = 0 on ints: appends each round's t2, t4 and out
    to `sink` and returns (xL_out, xR_out)."""
    a, b = xr, xl                                   # aux, xL[i-1]
    for ci in c:
        t = (b + ci) % R
        t2 = t * t % R
        t4 = t2 * t2 % R
        out = (a + t4 * t) % R
        sink += (t2, t4, out)
        a, b = b, out
    return a, out


def witness(circuit: Circuit, cfg: dict, rng) -> list:
    P, L, rounds = _sizes(cfg)
    c = constants(rounds)
    _, hash_slot, _ = _level_slots(rounds)
    leaves = [rng.randrange(R) for _ in range(P)]
    sib = [[rng.randrange(R) for _ in range(L)] for _ in range(P)]
    bits = [[rng.getrandbits(1) for _ in range(L)] for _ in range(P)]
    roots, inner = [], []
    for p in range(P):
        cur = leaves[p]
        for lvl in range(L):
            s, e = bits[p][lvl], sib[p][lvl]
            out0, out1 = (e, cur) if s else (cur, e)
            vals = [out0, out1]
            xl, xr = _feistel(out0, 0, c, vals)
            xl_in = (xl + out1) % R
            vals.append(xl_in)
            cur, _ = _feistel(xl_in, xr, c, vals)
            if lvl == L - 1:
                del vals[hash_slot]
            inner += vals
        roots.append(cur)
    return ([1] + roots + leaves + [v for row in sib for v in row]
            + [v for row in bits for v in row] + inner)
