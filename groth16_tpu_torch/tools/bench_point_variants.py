"""Build options of the point kernels (K1), the fold (K2), the batch
inversion (K6) and the fused tree level (K8), timed against each other on
one card in one run; and the ptxas line of every kernel of a checkout.

    python3 -m groth16_tpu_torch.tools.bench_point_variants
    python3 -m groth16_tpu_torch.tools.bench_point_variants --ptxas [csrc ...]

`--ptxas` builds every kernel source (ops/cuda.py KERNEL_SOURCES) of each
csrc directory given (default: this package's; another checkout's
groth16_tpu_torch/csrc compares two trees in one run) with `-Xptxas -v`,
all builds started together, and prints each kernel instantiation's
registers, spill store and load bytes and stack frame, then one JSON line.

csrc/point.cu, csrc/tree.cu and csrc/fold.cu are built once per option
set (both builds started together), each with `-Xptxas -v`:

  default        the flags of ops/cuda.py: the Fp product is one function
                 that the formulas branch to (BN254_NOINLINE_MUL, which the
                 three sources define);
  inline-mul     -DG16_INLINE_MUL: the Fp product inlined everywhere.

For each build it prints the registers and spill bytes ptxas reports for
every instantiation of those kernels, and the times, with CUDA events
through the package's own wrappers, of: K1 add and doubling at 2^16 points,
the doubling chain (k = 12 on 20 points) and Horner (W = 20, c = 13) in G1
and G2, K6 in G1 at M = 2,048 and 2^17, K2 at every fold level of the main
path's MSMs in G1 and G2 (bench_fold_phases.fold_case: 2^16 points, c = 13,
the levels of `fold_schedule`), and K8 at the smoke's shapes (LEVEL_SHAPES),
on operands as the tree hands them over (bench_tree_phases.level_case).
The builds are timed in turn, PASSES times, so that neither is alone in
meeting a cold card; each time printed is the least of its passes.  Every
build's outputs must equal the default's.  One JSON line at the end.  Needs
one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

VARIANTS = {"default": (), "inline-mul": ("-DG16_INLINE_MUL",)}
PASSES = 2     # the builds are timed in turn, this many times; each keeps its least time
# K8: (curve, K additions, emission), as chip_smoke.LEVEL_SHAPES: the H1
# MSM's levels 1 and 2, a narrow level, the 2^20 tree's level 1, a G2 level
LEVEL_SHAPES = (("G1", 1 << 17, False), ("G1", 1 << 16, True), ("G1", 64, True),
                ("G1", 1 << 21, False), ("G2", 4096, True))
SOURCES = ("point.cu", "tree.cu", "fold.cu")
KERNELS = ("point_add_kernel", "point_double_n_kernel", "horner_kernel", "tree_invert_kernel",
           "tree_level_kernel", "fold_kernel")
# every kernel of the library, for --ptxas
ALL_KERNELS = KERNELS + ("ntt_step_kernel", "quotient_pointwise_kernel", "tree_phase_a_kernel",
                         "tree_mul_rows_kernel", "tree_mid_kernel", "fp_mul_chain_kernel",
                         "issue_rate_kernel", "spmv_entries_kernel", "spmv_finish_kernel",
                         "fp_neg_kernel")
_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PROPS = re.compile(r"Function properties for (\w+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_KIND = re.compile(r"ILi(\d+)E")


def _label(sym: str, kernels) -> str | None:
    kern = next((k for k in kernels if k in sym), None)
    if kern is None:
        return None
    curve = " G2" if "G2" in sym else " G1" if "G1" in sym else ""
    kind = " affine" if "Lb1E" in sym else " projective" if "Lb0E" in sym else ""
    m = _KIND.search(sym)
    return kern + curve + kind + (f" {m.group(1)}" if m else "")


def ptxas_table(log: str, kernels=KERNELS) -> dict:
    """{kernel and curve: (registers, spill store bytes, spill load bytes,
    stack frame bytes)} from `nvcc -Xptxas -v` output, for the kernels named
    in `kernels`."""
    frames, used, entry, prop = {}, {}, None, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            continue
        m = _PROPS.search(line)
        if m:
            prop = m.group(1)
            continue
        m = _FRAME.search(line)
        if m and prop:
            frames[prop] = tuple(int(g) for g in m.groups())
            prop = None
            continue
        m = _USED.search(line)
        if m and entry:
            used[entry] = int(m.group(1))
            entry = None
    out = {}
    for sym, regs in used.items():
        name = _label(sym, kernels)
        if name:
            stack, st, ld = frames.get(sym, (0, 0, 0))
            out[name] = (regs, st, ld, stack)
    return out


def ptxas_report(dirs) -> dict:
    """{csrc directory: ptxas_table of every kernel} for the kernel sources
    of each directory (those of KERNEL_SOURCES it has: an older checkout
    lacks the newer ones), built with -Xptxas -v (again where a build is
    cached, so that ptxas reports), all builds started together."""
    from groth16_tpu_torch.ops import cuda

    def build(d):
        sources = [f for f in cuda.KERNEL_SOURCES if os.path.exists(os.path.join(d, f))]
        return cuda.compile_library(sources, ("-Xptxas", "-v"), csrc=d, rebuild=True)

    with ThreadPoolExecutor(len(dirs)) as pool:
        builds = list(pool.map(build, dirs))
    return {d: ptxas_table(log, ALL_KERNELS) for d, (_, log, _) in zip(dirs, builds)}


def measure_variant(dev) -> tuple:
    """(times in ms, outputs) of the loaded library's K1, K6, K8 and K2 at
    the shapes in the module docstring."""
    import numpy as np
    import torch
    from groth16_tpu_torch.ops import curve as C, kernels as KN, kernels_tree as KT
    from groth16_tpu_torch.ops import msm as M
    from groth16_tpu_torch.tools.bench_fold_phases import fold_case
    from groth16_tpu_torch.tools.bench_tree_phases import level_case, level_views
    from groth16_tpu_torch.protocol.fake_setup import fixed_base_mul
    from groth16_tpu_torch.tools.measure import time_ms
    rng = np.random.default_rng(11)

    def scalars(n):
        limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
        limbs[:, 15] &= 0x2FFF
        return torch.from_numpy(limbs).to(dev)

    ms, outs = {}, []

    def run(name, fn, reps):
        outs.append(fn())
        ms[name] = time_ms(fn, dev, reps)

    for cv in (C.G1, C.G2):
        P, Q = (fixed_base_mul(cv, scalars(1 << 16)) for _ in range(2))
        S = tuple(c[:20].contiguous() for c in P)
        run(f"{cv.name} add 2^16", lambda: KN.point_add(cv, P, Q), 20)
        run(f"{cv.name} double 2^16", lambda: KN.point_double_n(cv, P, 1), 20)
        run(f"{cv.name} double_n k=12 n=20", lambda: KN.point_double_n(cv, S, 12), 20)
        run(f"{cv.name} horner W=20 c=13", lambda: KN.horner(cv, S, 13), 5)
    for width in (2048, 1 << 17):
        tots = scalars(width).T.contiguous()
        run(f"G1 invert M={width}", lambda: (KT.invert_kernel(C.G1, tots),), 10)
    for name, K, want_em in LEVEL_SHAPES:
        cv = C.G1 if name == "G1" else C.G2
        PL, PR, flags = level_case(rng, cv, K, dev)
        args = level_views(PL, PR) + tuple(flags) + (want_em,)
        run(f"{cv.name} level K={K} emit={want_em}",
            lambda: tuple(o for o in KT.level_kernel(cv, *args) if o is not None), 10)
    for cv in (C.G1, C.G2):
        pts, order, keys, table = fold_case(cv, 16, dev)
        m = keys.shape[1]
        Ts = M.fold_schedule(m)
        for i, T in enumerate(Ts):
            kw = dict(T=T, affine=i == 0, last=i == len(Ts) - 1)
            tab, scratch = table.clone(), table.clone()
            out = KN.fold_level_kernel(cv, pts, order, keys, tab, **kw)
            outs.append((tab,) + tuple(x for x in out if x is not None))
            ms[f"{cv.name} K2 level {i} T={T}"] = time_ms(
                lambda: KN.fold_level_kernel(cv, pts, order, keys, scratch, **kw), dev, 5)
            table, (pts, keys), order = tab, out, None
    return ms, outs


def main(argv=None) -> int:
    import torch
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("bench_point_variants: needs a CUDA device", file=sys.stderr)
        return 2
    from groth16_tpu_torch.ops import cuda, field as F
    from groth16_tpu_torch.tools import measure
    dev = torch.device("cuda", 0)
    print(measure.card_line(dev))
    if args and args[0] == "--ptxas":
        rep = ptxas_report(args[1:] or [cuda.CSRC])
        for d, table in rep.items():
            print(d)
            for k, (regs, st, ld, stack) in sorted(table.items()):
                print(f"  ptxas {k:40s} {regs:4d} registers, spill {st} / {ld} bytes, "
                      f"stack frame {stack} bytes")
        print(json.dumps({"tool": "bench_point_variants", "card": measure.card_line(dev),
                          "ptxas": rep}))
        return 0
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        builds = dict(zip(VARIANTS, pool.map(
            lambda flags: cuda.compile_library(SOURCES, flags + ("-Xptxas", "-v"), rebuild=True),
            VARIANTS.values())))
    res, ref = {}, None
    for _ in range(PASSES):
        for name, (path, log, seconds) in builds.items():
            cuda.use_library(path)
            ms, outs = measure_variant(dev)
            torch.cuda.synchronize()
            if ref is None:
                ref = outs
            elif not all(torch.equal(F.as_i32(a), F.as_i32(b))
                         for x, y in zip(outs, ref) for a, b in zip(x, y)):
                raise AssertionError(f"build {name!r} gives other results than the default build")
            del outs
            best = res.setdefault(name, {"build_s": seconds, "registers_spill": ptxas_table(log),
                                         "ms": ms})["ms"]
            for k, v in ms.items():
                best[k] = min(best[k], v)
    for name, r in res.items():
        print(f"{name} (built in {r['build_s']:.1f} s)")
        for k, v in r["registers_spill"].items():
            print(f"  ptxas {k:32s} {v[0]:4d} registers, spill {v[1]} / {v[2]} bytes, "
                  f"stack frame {v[3]} bytes")
        for k, v in r["ms"].items():
            print(f"  {k:32s} {v:10.4f} ms")
    print(json.dumps({"tool": "bench_point_variants", "card": measure.card_line(dev),
                      "variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
