"""Wall times of one proof and of the G1 MSMs at 2^16 and 2^20, for
comparing two trees of this package on one card in one run.

    python3 -m groth16_tpu_torch.tools.bench_proof_msm

It uses only entry points that every tree of the port has (`msm(path=)`,
`fake_circuit_setup`, `generate_proof_with_mask`, the phase tool's
`make_points`), so the same file can time another checkout: run it by path
from that checkout's root with `PYTHONPATH=.`, and the package imported is
that checkout's.  Alternate the trees (parent, change, change, parent):
host-bound times differ from one machine to the next, and only times taken
in one run compare.

Prints, each a mean after one warm-up: msm(path="tree") and msm(path="fold")
at 2^16 points (5 runs, CUDA events) and at 2^20 (3 runs), each with the
peak device memory one call allocates above what was allocated before it
(`max_memory_allocated`); Horner alone on
the 2^16 tree's window sums; three proofs of synthetic_circuit(16) in each
flavour on the host clock around a synchronize, with the quotient phase of
each, all phase times of the last and a digest of its proof points (the
toxic waste and the mask are fixed, so trees that prove alike print the
same digest).
One JSON line at the end.  Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_proof_msm: needs a CUDA device", file=sys.stderr)
        return 2
    import groth16_tpu_torch as G
    from groth16_tpu_torch.models.circuits import synthetic_circuit
    from groth16_tpu_torch.ops import cuda, curve as C, msm as M
    from groth16_tpu_torch.tools import measure
    from groth16_tpu_torch.tools.bench_tree_phases import make_points

    dev = torch.device("cuda", 0)
    cuda.lib()
    res = {"tool": "bench_proof_msm", "card": measure.card_line(dev), "package": G.__file__}
    rng = np.random.default_rng(5)
    for log2n, reps in ((16, 5), (20, 3)):
        n = 1 << log2n
        P = make_points(n, dev)
        limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
        limbs[:, 15] &= 0x2FFF
        s = torch.from_numpy(limbs).to(dev)
        for path in ("tree", "fold"):
            res[f"msm_{path}_2^{log2n}_ms"] = measure.time_ms(
                lambda: M.msm(C.G1, s, P, affine=True, path=path), dev, reps)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            M.msm(C.G1, s, P, affine=True, path=path)
            res[f"msm_{path}_2^{log2n}_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        if log2n == 16:
            c = M.pick_window_bits_tree(n)
            sums = M.window_sums(C.G1, s, P, c, True, "tree")
            res["horner_2^16_ms"] = measure.time_ms(lambda: M.horner_combine(C.G1, sums, c),
                                                    dev, reps)
    r1cs, wtns = synthetic_circuit(16)
    mask = G.Mask(0x1234567890ABCDEF, 0xFEDCBA0987654321)
    for flavour in (G.Flavour.Snarkjs, G.Flavour.JensGroth):
        zkey = G.fake_circuit_setup(r1cs, G.ToxicWaste(0x1DEA, 0xBEEF, 0x6A33A, 0xDE17A, 0x7A0),
                                    flavour, dev)
        walls, quotient, tm = [], [], {}
        for i in range(4):
            tm = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prf = G.generate_proof_with_mask(zkey, wtns, mask, dev, tm)
            torch.cuda.synchronize()
            if i:
                walls.append(time.perf_counter() - t0)
                quotient.append(tm["quotient_s"])
        if not G.verify_proof(G.extract_vkey(zkey), prf):
            raise AssertionError(f"the {flavour.value} proof does not verify")
        res[f"proof_s_{flavour.value}"] = walls
        res[f"quotient_s_{flavour.value}"] = quotient
        res[f"proof_phases_s_{flavour.value}"] = tm
        # fixed toxic waste and mask: two trees that prove alike print one digest
        pts = repr((prf.pi_a, prf.pi_b, prf.pi_c)).encode()
        res[f"proof_digest_{flavour.value}"] = hashlib.sha256(pts).hexdigest()[:16]
    for k, v in res.items():
        print(f"{k:24s} {v}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
