"""Phase by phase, where the time of a fold MSM goes on the GPU, and the
sweep that picks the fold's T per level.

    python3 -m groth16_tpu_torch.tools.bench_fold_phases [log2n]
    python3 -m groth16_tpu_torch.tools.bench_fold_phases levels

`run`: a G1 MSM of 2^log2n points (default 2^20) through the fold, at the
fold's window (c = 16 at 2^20), on the phase tool's points (bench_tree_phases
`make_points`).  Each phase is timed with CUDA events, mean of 3 after a
warm-up: signed digits (all windows); the sort (|digit| argsort and the
sorted keys); the bucket table's set-up; each K2 level of `fold_schedule`
with its T, lanes and closes; all levels together (`window_buckets`, table
in and out); the bucket reduce; Horner; msm.msm, whose peak device
memory is read around one call.  The levels' outputs feed each other as in
the MSM, and the result must equal msm.msm's.

`sweep`: the fold's projective levels (level 1 onwards) at the main path's
shapes, G1 and G2 at 2^16 - 1 points (c = 13, 20 windows, 2,048 elements a
window after level 0) and G1 at 2^20 (c = 16, 16 windows, 32,768), timed as
one chain (CUDA events, mean of 3 after a warm-up) with T = 2, 4, 8, 16 and
32 at every level (the last level takes the rest), and with
`fold_schedule`'s choice.  More levels cost launches; a larger T costs one
thread's chain of T complete adds where the lanes do not fill the card.

`levels`: each K2 level alone, at 2^16 and 2^20 points, G1 and G2, on
full-width scalars and on a bit-decomposition witness's (97 % 0 or 1),
beside its bound (`levels`); nothing else.

Each prints one line a phase and one JSON line with the card's name and
power limit.  Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys

SWEEP_T = (2, 4, 8, 16, 32)
# (curve, log2 of the stream length, windows): the projective fold levels of
# the main path's MSMs (A1, B1, C1 in G1, B2 in G2) and of the 2^20 MSM
SWEEP_SHAPES = (("G1", 16, 20), ("G2", 16, 20), ("G1", 20, 16))


def _scalars(n: int, device, seed: int):
    import numpy as np
    import torch
    limbs = np.random.default_rng(seed).integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    limbs[:, 15] &= 0x2FFF
    return torch.from_numpy(limbs).to(device)


def _bit_scalars(n: int, device, seed: int):
    """n scalars as a bit-decomposition witness has them: 97 % 0 or 1, the
    rest below 2^32."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    limbs = np.zeros((n, 16), dtype=np.uint32)
    limbs[:, 0] = rng.integers(0, 2, size=n)
    wide = rng.random(n) < 0.03
    limbs[wide, :2] = rng.integers(0, 1 << 16, size=(int(wide.sum()), 2))
    return torch.from_numpy(limbs).to(device)


SCALARS = {"full": _scalars, "bits": _bit_scalars}


def _affine_rows(cv, P):
    """x|y rows int32[n, Rin] of wire-form points, (0, 0) = infinity, as
    `msm.window_sums` builds them."""
    import torch
    from groth16_tpu_torch.ops import msm as M
    y = cv.fops.select(cv.fops.is_zero(P[2]), torch.zeros_like(P[1]), P[1])
    return M._rows((P[0], y))


def _uniform(m: int, T: int) -> list:
    Ts = []
    while m > 1:
        Ts.append(min(T, m))
        m //= Ts[-1]
    return Ts


def _points(cv, n, device):
    """n wire-form points of `cv`: the phase tool's G1 points, or G2
    multiples of the generator by random 31-bit scalars."""
    from groth16_tpu_torch.ops import curve as C
    from groth16_tpu_torch.tools.bench_tree_phases import make_points
    if cv.name == "G1":
        return make_points(n, device)
    from groth16_tpu_torch.protocol.fake_setup import fixed_base_mul
    import torch
    s = _scalars(n, device, 9)
    s[:, 2:] = 0
    x, y = C.to_affine(cv, fixed_base_mul(cv, s))
    return C.from_affine(cv, x, y)


def fold_case(cv, log2n: int, device, scalars: str = "full") -> tuple:
    """A fold MSM's level-0 operands at the window of 2^log2n - 1 points (the
    main path's MSMs are 2^16 - 1 points, padded to 2^16): x|y rows of
    2^log2n wire-form points, the |digit| sort order int32[W, m], the sorted
    signed digits int32[W, m] of random scalars (`SCALARS`: "full" width,
    or a bit-decomposition witness's "bits"), and an infinity bucket table
    uint32[W, nb, R]."""
    import torch
    from groth16_tpu_torch.ops import field as F, msm as M
    n = 1 << log2n
    c = M.pick_window_bits(n - 1)
    keys = M.signed_window_digits(SCALARS[scalars](n, device, 4), c)
    W = keys.shape[0]
    nb = (1 << (c - 1)) + 1
    order = torch.argsort(keys.abs(), dim=1, stable=True)
    sk = torch.gather(keys, 1, order).to(torch.int32)
    rows = F.as_u32(_affine_rows(cv, _points(cv, n, device)))
    return rows, order.to(torch.int32), sk, M.bucket_table(cv, W, nb, device)


def _level1(cv, log2n: int, device):
    """The inputs of a fold MSM's first projective level: (keys int32[W, m],
    trail rows, the bucket table), after its level 0 at T = FOLD_T."""
    from groth16_tpu_torch.ops import kernels as KN
    rows, order, sk, table = fold_case(cv, log2n, device)
    trail, tkey = KN.fold_level(cv, rows, order, sk, table, KN.FOLD_T, affine=True)
    return tkey, trail, table


def sweep(device="cuda", reps: int = 3) -> dict:
    """The projective fold levels as one chain at every T of SWEEP_T and at
    `fold_schedule`'s, per shape of SWEEP_SHAPES; print and return the ms."""
    from groth16_tpu_torch.ops import curve as C, kernels as KN, msm as M
    from groth16_tpu_torch.tools import measure
    out = {}
    for name, log2n, W in SWEEP_SHAPES:
        cv = C.G1 if name == "G1" else C.G2
        keys, rows, table = _level1(cv, log2n, device)
        m = keys.shape[1]
        rule = M.fold_schedule(1 << log2n)[1:]

        def chain(Ts):
            pts, sk = rows, keys
            for i, T in enumerate(Ts):
                pts, sk = KN.fold_level(cv, pts, None, sk, table, T, last=i == len(Ts) - 1)

        row = {}
        for T in SWEEP_T:
            Ts = _uniform(m, T)
            row[str(T)] = {"Ts": Ts, "ms": measure.time_ms(lambda: chain(Ts), device, reps)}
        row["rule"] = {"Ts": rule, "ms": measure.time_ms(lambda: chain(rule), device, reps)}
        key = f"{name} 2^{log2n} W={W} m={m}"
        out[key] = row
        for T, v in row.items():
            print(f"sweep {key} T={T:>4s} levels {v['Ts']}: {v['ms']:.3f} ms", flush=True)
    return out


LEVEL_CASES = tuple((cv, log2n, sc) for log2n in (16, 20) for cv in ("G1", "G2")
                    for sc in ("full", "bits"))


def levels(device="cuda", reps: int = 5) -> list:
    """Each K2 level of `fold_schedule` at 2^16 and 2^20 points, G1 and G2,
    on full-width and on bit-decomposition scalars (`LEVEL_CASES`), each
    level fed by the one before and timed on a scratch copy of its table
    (CUDA events, mean of `reps` after a warm-up), beside its bound
    (`measure.work` of the level's `fold_shape` at the card's clock); print
    a line a level and return the rows."""
    from groth16_tpu_torch.ops import curve as C, kernels as KN, msm as M
    from groth16_tpu_torch.tools import measure
    clock = measure.sm_clock_max_mhz()
    out = []
    for name, log2n, sc in LEVEL_CASES:
        cv = C.G1 if name == "G1" else C.G2
        pts, order, keys, table = fold_case(cv, log2n, device, sc)
        W, m = keys.shape
        Ts = M.fold_schedule(m)
        for i, T in enumerate(Ts):
            kw = dict(T=T, affine=i == 0, last=i == len(Ts) - 1)
            shape = measure.fold_shape(keys.cpu().numpy(), T)
            scratch = table.clone()
            ms = measure.time_ms(lambda: KN.fold_level(cv, pts, order, keys, scratch, **kw),
                                 device, reps)
            bound, by = measure.bound_ms(*measure.work(
                "fold_level_kernel", name, lanes=W * (m // T), order=order is not None,
                **kw, **shape), clock)
            row = {"curve": name, "log2n": log2n, "scalars": sc, "level": i, "T": T,
                   "lanes": W * (m // T), **shape, "ms": ms, "bound_ms": bound, "bound_by": by}
            out.append(row)
            print(f"levels {name} 2^{log2n} {sc:4s} level {i} T={T} lanes={row['lanes']} "
                  f"zeros={shape['zeros']} closes={shape['closes']}: {ms:.4f} ms "
                  f"(bound {bound:.5f} ms, {by})", flush=True)
            pts, keys = KN.fold_level(cv, pts, order, keys, table, **kw)
            order, m = None, m // T
    return out


def run(log2n: int = 20, device="cuda", reps: int = 3) -> dict:
    """Time the phases of a G1 fold MSM of 2^log2n points on `device` (its
    plain versions on a CPU device); print and return them."""
    import torch
    from groth16_tpu_torch.ops import curve as C, field as F, kernels as KN, msm as M
    from groth16_tpu_torch.tools import measure
    from groth16_tpu_torch.tools.bench_tree_phases import make_points

    dev = torch.device(device)
    cv = C.G1
    n = 1 << log2n
    c = M.pick_window_bits(n)
    nb = (1 << (c - 1)) + 1
    sc = _scalars(n, dev, 3)
    P = make_points(n, dev)
    ms, levels = {}, []

    def phase(name, fn):
        out = []

        def call():
            out[:] = [fn()]

        ms[name] = measure.time_ms(call, dev, reps)
        print(f"{name:56s} {ms[name]:10.3f} ms", flush=True)
        return out[0]

    keys = phase("signed digits (all windows)", lambda: M.signed_window_digits(sc, c))
    W, m = keys.shape

    def sort():
        order = torch.argsort(keys.abs(), dim=1, stable=True)
        return order.to(torch.int32), torch.gather(keys, 1, order).to(torch.int32)

    order, sk = phase(f"sort ({W} windows)", sort)
    table = phase("bucket table set-up", lambda: M.bucket_table(cv, W, nb, dev))
    rows = F.as_u32(_affine_rows(cv, P))
    Ts = M.fold_schedule(m)
    pts, lk, lo = rows, sk, order
    for i, T in enumerate(Ts):
        last = i == len(Ts) - 1
        closes = measure.fold_shape(lk.cpu().numpy(), T)["closes"]
        args = (pts, lo, lk, T, i == 0, last)
        # the level's output from a fresh table, then its time on a scratch copy
        out = KN.fold_level(cv, pts, lo, lk, table, T, affine=i == 0, last=last)
        scratch = table.clone()
        name = f"K2 level {i} (T={T}, lanes={W * (m // T)}, closes={closes})"
        phase(name, lambda a=args: KN.fold_level(cv, a[0], a[1], a[2], scratch, a[3],
                                                 affine=a[4], last=a[5]))
        levels.append({"T": T, "lanes": W * (m // T), "closes": closes, "affine": i == 0,
                       "last": last, "ms": ms[name]})
        pts, lk, lo = out[0], out[1], None
        m //= T
    buckets = tuple(x.transpose(0, 1) for x in M._split_rows(cv, F.as_i32(table)))
    phase("window_buckets (all levels, table in and out)",
          lambda: M.window_buckets(cv, keys, F.as_i32(rows), nb, True))
    sums = phase("bucket reduce", lambda: M._weighted_bucket_reduce(cv, buckets, nb))
    got = phase("horner combine", lambda: M.horner_combine(cv, sums, c))

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) / 2**30 if on_card else None
    want = M.msm(cv, sc, P, affine=True)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None
    phase("msm.msm", lambda: M.msm(cv, sc, P, affine=True))
    same = all(torch.equal(F.as_i32(a), F.as_i32(b))
               for a, b in zip(C.to_affine(cv, got), C.to_affine(cv, want)))
    if not same:
        raise AssertionError("the phases' result differs from msm.msm")
    print(f"phases == msm.msm (c = {c}, levels {Ts}); peak device memory of the fold "
          "MSM " + ("not measured (cpu)" if peak is None
                    else f"{peak:.3f} GiB ({base:.3f} GiB allocated before it)"))
    res = {"tool": "bench_fold_phases", "card": measure.card_line(dev), "log2n": log2n, "c": c,
           "schedule": Ts, "levels": levels, "phases_ms": ms, "peak_gib_msm_fold": peak,
           "allocated_gib_before": base, "same_point": same}
    print(json.dumps(res))
    return res


def main(argv=None) -> int:
    import torch
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("bench_fold_phases: needs a CUDA device", file=sys.stderr)
        return 2
    from groth16_tpu_torch.tools import measure
    print(measure.card_line("cuda"))
    if args and args[0] == "levels":
        print(json.dumps({"tool": "bench_fold_phases", "card": measure.card_line("cuda"),
                          "levels": levels()}))
        return 0
    run(int(args[0]) if args else 20)
    print(json.dumps({"tool": "bench_fold_phases", "sweep": sweep()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
