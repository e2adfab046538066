"""K4, K5 and `curve.to_affine` alone on the GPU, for comparing two trees of
this package on one card in one run.

    python3 -m groth16_tpu_torch.tools.bench_tree_kernels

It uses only entry points of the package (`kernels_tree.phase_a_kernel`,
`kernels_tree.mul_rows_kernel` on two rows of one shape, `curve.to_affine`,
the phase tool's `level_case`, `measure.time_ms` and
`measure.device_kernels`), so the same file can time another checkout that
has them: run it by path from that checkout's root with `PYTHONPATH=.`,
and the package imported is that checkout's.
Alternate the trees (parent, change, change, parent): small kernels' times
differ from one machine to the next, and only times taken in one run
compare.

For each shape it prints the CUDA-event time (mean of 20 after a warm-up)
and, from torch.profiler over one more call (`measure.device_kernels`), every
device kernel and copy that call ran, with its launches and device time:

  K4 at G1 M = 8192 and 2^17 (the level-1 lanes of the 2^16 and 2^20
  trees) and G2 M = 256;
  K5 on two column views of one row at W = 4096, 2048 and 2^16 (G1), as the
  halvings of tools/bench_tree_phases.py hand them over;
  `to_affine` of one point in G1 and G2 (a proof's call, five a proof) and
  of 2^20 G1 points (`bench_tree_phases.make_points`).

One JSON line at the end.  Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys

K4_SHAPES = (("G1", 8192), ("G1", 1 << 17), ("G2", 256))
K5_VIEWS = (4096, 2048, 1 << 16)
AFFINE_SHAPES = (("G1", 1), ("G2", 1), ("G1", 1 << 20))
REPS = 20


def run(device="cuda") -> dict:
    import numpy as np
    import torch
    from groth16_tpu_torch.ops import curve as C, kernels_tree as KT
    from groth16_tpu_torch.protocol.fake_setup import fixed_base_mul
    from groth16_tpu_torch.tools import measure
    from groth16_tpu_torch.tools.bench_tree_phases import level_case, level_views

    dev = torch.device(device)
    rng = np.random.default_rng(11)
    curves = {"G1": C.G1, "G2": C.G2}
    res = {"tool": "bench_tree_kernels", "card": measure.card_line(dev), "shapes": {}}

    def time(label, fn, kernel):
        fn()
        ms = measure.time_ms(fn, dev, REPS)
        kernels = measure.short(measure.device_kernels(fn, expect={kernel: 1}))
        res["shapes"][label] = {"ms": ms, "device": kernels}
        print(f"{label:36s} {ms:9.4f} ms  device " + json.dumps(kernels), flush=True)

    def scalars(n):
        limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
        limbs[:, 15] &= 0x2FFF
        return torch.from_numpy(limbs).to(dev)

    for name, M in K4_SHAPES:
        cv = curves[name]
        PL, PR, _ = level_case(rng, cv, KT.T_SLOTS * M, dev)
        apr, bpl = (c.reshape(c.shape[0], KT.T_SLOTS, M).contiguous()
                    for c in level_views(PL, PR)[1:3])
        time(f"K4 {name} M={M}", lambda: KT.phase_a_kernel(cv, apr, bpl), "tree_phase_a_kernel")
    for W in K5_VIEWS:
        row = scalars(2 * W).T.contiguous()
        a, b = row[:, :W], row[:, W:]
        time(f"K5 G1 W={W} views", lambda: KT.mul_rows_kernel(C.G1, a, b), "tree_mul_rows_kernel")
    for name, n in AFFINE_SHAPES:
        cv = curves[name]
        P = fixed_base_mul(cv, scalars(n))
        time(f"to_affine {name} n={n}", lambda: C.to_affine(cv, P), "tree_invert_kernel")
    print(json.dumps(res))
    return res


def main(argv=None) -> int:
    import torch
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("bench_tree_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    if args:
        print("bench_tree_kernels: takes no arguments", file=sys.stderr)
        return 2
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
