"""K copies of circomlib's Num2Bits(n) (circuits/bitify.circom), each
constraint as the template writes it:

    out[i] * (out[i] - 1) === 0      A: out[i];  B: out[i], -1 on wire 0
    lc1 === in                        A = B = 0;  C: sum 2^i out[i], -in

Wires: 0 the one, 1..K the copies' inputs (the first copy's public, the
rest private), then each copy's n bits.  Copy k's rows are k (n + 1) + i
for its booleanity constraints and k (n + 1) + n for its sum.  The
witness draws each input uniform in [0, 2^n), so all but one wire in
n + 1 of a copy hold 0 or 1.
"""

from __future__ import annotations

import numpy as np

from .circuit import Circuit, matrix


def build(cfg: dict) -> Circuit:
    n, K = int(cfg["bits"]), int(cfg["copies"])
    k = np.arange(K, dtype=np.int64)[:, None]
    i = np.arange(n, dtype=np.int64)[None, :]
    bit = (1 + K + k * n + i).ravel()                 # wire of out[i] of copy k
    brow = (k * (n + 1) + i).ravel()                  # its booleanity row
    lin = np.arange(K, dtype=np.int64) * (n + 1) + n  # each copy's sum row
    ones = np.ones(K * n, np.int64)
    a = matrix(brow, bit, ones)
    b = matrix(np.concatenate([brow, brow]), np.concatenate([bit, np.zeros(K * n, np.int64)]),
               np.concatenate([ones, -ones]))
    c = matrix(np.concatenate([np.repeat(lin, n), lin]),
               np.concatenate([bit, 1 + np.arange(K, dtype=np.int64)]),
               np.concatenate([np.tile(np.int64(1) << np.arange(n, dtype=np.int64), K),
                               -np.ones(K, np.int64)]))
    return Circuit(name=f"num2bits{n}x{K}", n_constr=K * (n + 1), n_wires=1 + K + K * n,
                   n_pub_out=0, n_pub_in=1, a=a, b=b, c=c)


def witness(circuit: Circuit, cfg: dict, rng) -> list:
    n, K = int(cfg["bits"]), int(cfg["copies"])
    ins = np.array([rng.getrandbits(n) for _ in range(K)], np.uint64)
    bits = (ins[:, None] >> np.arange(n, dtype=np.uint64)[None, :]) & np.uint64(1)
    return [1] + ins.tolist() + bits.ravel().tolist()
