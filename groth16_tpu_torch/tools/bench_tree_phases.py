"""Phase by phase, where the time of a merge-tree MSM goes on the GPU.

    python3 -m groth16_tpu_torch.tools.bench_tree_phases [log2n] [group]
    python3 -m groth16_tpu_torch.tools.bench_tree_phases crossover [G1,G2] [16,18,20,21] [bits]

Counterpart of tools/bench_tree_phases.py.  A G1 MSM of 2^log2n points
(default 2^20) at the tree's window (c = 16 at 2^20), windows in groups of
`group` (default 4), on points made on the device as bench.py makes them
(the generator times random 31-bit integers, then wire-form affine), with
full-width scalars from a seed (`draw_scalars`).  Each
phase is timed with CUDA events, mean of 3 after a warm-up:

  signed digits (all windows);
  sort + sign-packed key + bit-reversed row gather, one group;
  argsort only, one group;
  row gather + transpose, one group;
  glue core: the level loop with an xor in place of the mid, no emissions;
  tree glue: group_buckets_tree with a no-op level (all the glue, no kernel);
  one `kernels_tree.mid` at the level-1 shape (K4, K6, K7), its output
  then held against the plain K7 on the same planes and lane inverses;
  the level-1 totals' batch inversion two ways: one wide K6 launch, and
  halvings + narrow inversion (`invert_by_halvings`: K5 products down to
  2,048 lanes, K6 on those, K5 back up); the outputs must be equal;
  one group through the real levels (K8, one launch a level);
  window_sums_tree over all windows;
  Horner;
  the tree's whole MSM (`msm_tree.msm`);
  the fold's (`msm.msm`) at the same n, the JAX tool's "(e)".

`run` checks that the tree and the fold give one affine point, then prints one line per phase and one JSON line of the phase times
with the card's name and power limit and the peak device memory of the tree
MSM.  The JAX tool's `lax.gather` offset-first variant is left out: it
compared two XLA formulations of one gather, and PyTorch has one.

`crossover` times the two bucket phases against each other, the sizes and
the curves (G1, G2) on its command line, scalars full width or of `bits`
bits: milliseconds and peak memory reserved of `msm.msm` (the fold) and
`msm_tree.msm` at each size, the measurement behind the fold being the
port's one bucket phase.  Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys


def make_points(n: int, device, seed: int = 7, cv=None):
    """n points k_i G of `cv` (default G1), k_i random 31-bit from a numpy
    seed, in wire form (projective with Z = Montgomery 1).  The ladder runs
    on K1; the affine conversion is `curve.to_affine` (K6, then one K5
    launch; no Z is 0)."""
    import numpy as np
    import torch
    from groth16_tpu_torch.ops import curve as C
    from groth16_tpu_torch.utils.hostmath import G1_GEN, G2_GEN
    cv = C.G1 if cv is None else cv
    rng = np.random.default_rng(seed)
    ks = rng.integers(1, 1 << 31, size=n, dtype=np.uint32)
    scal = np.zeros((n, 16), np.uint32)
    scal[:, 0], scal[:, 1] = ks & 0xFFFF, ks >> 16
    gen = C.points_from_host(cv, [G1_GEN if cv.name == "G1" else G2_GEN], device)
    P = C.scalar_mul(cv, torch.from_numpy(scal).to(device), gen, 32)
    return C.from_affine(cv, *C.to_affine(cv, P))


R_TOP = 0x3064   # the top 16-bit limb of the BN254 group order r


def draw_scalars(n: int, seed: int, bits: int = 254):
    """uint32[n, 16] standard-form scalars (16-bit limbs) from a numpy seed:
    at bits = 254 full width, uniform below R_TOP * 2^240 < r; below that,
    uniform `bits`-bit."""
    import numpy as np
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    if bits >= 254:
        limbs[:, 15] = rng.integers(0, R_TOP, size=n, dtype=np.uint32)
        return limbs
    full, rest = divmod(bits, 16)
    limbs[:, full] &= (1 << rest) - 1
    limbs[:, full + 1:] = 0
    return limbs


def level_case(rng, cv, K: int, device) -> tuple:
    """A merge-tree level of K affine additions of `cv` as the tree hands it
    over: PL = A.pL | B.pL and PR = A.pR | B.pR, uint32[R2, 2K], from 256
    random points, their negations and the infinity (0, 0), with doubling,
    cancellation and infinity slots between A.pR and B.pL, and three random
    bool[K] flags (keys match, A pure, B pure).  `rng` is a numpy Generator."""
    import numpy as np
    import torch
    from groth16_tpu_torch.ops import curve as C, field as F, kernels_tree as KT
    from groth16_tpu_torch.protocol.fake_setup import fixed_base_mul
    nc, npts = KT.ncomp(cv), 256
    limbs = rng.integers(0, 1 << 16, size=(npts, 16), dtype=np.uint32)
    limbs[:, 15] &= 0x2FFF            # < r
    x, y = C.to_affine(cv, fixed_base_mul(cv, torch.from_numpy(limbs).to(device)))
    xr = F.as_i32(x).reshape(npts, nc)
    yr = F.as_i32(y).reshape(npts, nc)
    nyr = F.as_i32(F.neg_mod(F.FP, y)).reshape(npts, nc)
    zero = torch.zeros((1, 2 * nc), dtype=torch.int32, device=device)
    pool = torch.cat([torch.cat([xr, yr], 1), torch.cat([xr, nyr], 1), zero], 0)
    inf = 2 * npts
    case = np.arange(K) % 7
    ia, ib = rng.integers(0, npts, size=K), rng.integers(0, npts, size=K)
    ib = np.where(case == 1, ia, ib)                          # doubling
    ib = np.where(case == 2, ia + npts, ib)                   # P + (-P)
    ia = np.where((case == 3) | (case == 5), inf, ia)
    ib = np.where((case == 4) | (case == 5), inf, ib)
    apl, bpr = rng.integers(0, inf + 1, size=K), rng.integers(0, inf + 1, size=K)

    def cols(i, j):
        idx = torch.from_numpy(np.concatenate([i, j])).to(device)
        return F.as_u32(pool[idx].T.contiguous())

    flags = [torch.from_numpy(rng.integers(0, 2, size=K).astype(bool)).to(device)
             for _ in range(3)]
    return cols(apl, ib), cols(ia, bpr), flags


def level_views(PL, PR) -> tuple:
    """A.pL, A.pR, B.pL, B.pR: the halves of a level's PL and PR, as views."""
    K = PL.shape[1] // 2
    return PL[:, :K], PR[:, :K], PL[:, K:], PR[:, K:]


NARROW = 2048   # lanes of the narrow inversion of `invert_by_halvings`


def invert_by_halvings(cv, tots):
    """Inverses of uint32[R, M] lane totals by a product tree of K5 launches:
    halve the row by pairwise products of its two halves (views) down to
    NARROW lanes, invert those (K6), and multiply back up, two K5 launches a
    halving, each writing its half of the level's one output.  The route a
    tree level took while K6 was one block of at most NARROW lanes; kept
    here to be timed against the one wide K6 launch."""
    import torch
    from groth16_tpu_torch.ops import kernels_tree as KT
    stack = []
    x = tots
    while x.shape[-1] > NARROW and x.shape[-1] % 2 == 0:
        w = x.shape[-1] // 2
        stack.append(x)
        x = KT.mul_rows(cv, x[:, :w], x[:, w:])
    inv = KT.invert(cv, x)
    for lv in reversed(stack):
        w = lv.shape[-1] // 2
        up = torch.empty_like(lv)
        KT.mul_rows(cv, inv, lv[:, w:], out=up[:, :w])
        KT.mul_rows(cv, inv, lv[:, :w], out=up[:, w:])
        inv = up
    return inv


def noop_level(cv, A_pl, A_pr, B_pl, B_pr, match, aP, bP, want_em):
    """A tree level with an xor in place of the mid: the glue's reads and
    selects, no field arithmetic."""
    import torch
    from groth16_tpu_torch.ops import field as F
    mid = F.as_i32(A_pr) ^ F.as_i32(B_pl)

    def sel(cond, other):
        return F.as_u32(torch.where(cond[None], mid, F.as_i32(other)))

    return sel(match & aP, A_pl), sel(match & bP, B_pr), (sel(match, A_pr) if want_em else None)


def run(log2n: int = 20, group: int = 4, device="cuda", reps: int = 3) -> dict:
    """Time the phases of a G1 MSM of 2^log2n points on `device` (its plain
    versions on a CPU device); check tree == fold; print and return
    the phase times."""
    import numpy as np
    import torch
    from groth16_tpu_torch.ops import curve as C, field as F, kernels_tree as KT
    from groth16_tpu_torch.ops import msm as M, msm_tree as MT
    from groth16_tpu_torch.ops.field import FP
    from groth16_tpu_torch.ops.ntt import bitrev_perm
    from groth16_tpu_torch.tools import measure

    dev = torch.device(device)
    cv, K = C.G1, C.G1.fops
    n = 1 << log2n
    c = MT.pick_window_bits_tree(n)
    nb = (1 << (c - 1)) + 1
    rng = np.random.default_rng(3)
    sc = torch.from_numpy(draw_scalars(n, 3)).to(dev)
    P = make_points(n, dev)
    ms = {}

    def phase(name, fn):
        """Time fn; return the output of its last call."""
        out = []

        def call():
            out[:] = [fn()]

        ms[name] = measure.time_ms(call, dev, reps)
        print(f"{name:48s} {ms[name]:10.3f} ms", flush=True)
        return out[0]

    # the first group's columns, as window_sums_tree makes them
    W = -(-(M.NBITS + 1) // c)
    G = MT._pow2_groups(W, 1 << (group.bit_length() - 1))[0]

    def sort_gather():
        digits = M.signed_window_digits(sc, c)[:G]
        y = K.select(K.is_zero(P[2]), torch.zeros_like(P[1]), P[1])
        x_r, y_r = F.as_i32(P[0]), F.as_i32(y)
        ny_r = F.as_i32(F.neg_mod(FP, y))
        rows2 = torch.cat([torch.cat([x_r, y_r], 1), torch.cat([x_r, ny_r], 1)], 0)
        key = (digits.abs() << 1) | (digits < 0).to(torch.int64)
        sk2, order = torch.sort(key, dim=1, stable=True)
        idx_st = (order + (sk2 & 1) * n).reshape(-1)[bitrev_perm(G * n, dev)]
        return sk2 >> 1, F.as_u32(rows2[idx_st].T.contiguous()), rows2, idx_st

    sk, cols, rows2, idx_st = sort_gather()
    phase("signed digits (all windows)", lambda: M.signed_window_digits(sc, c))
    phase(f"sort + gather + sign ({G} windows)", sort_gather)
    dig = torch.from_numpy(rng.integers(0, 1 << 15, size=(G, n))).to(dev)
    phase(f"argsort only ({G} windows)", lambda: torch.argsort(dig, dim=1))
    phase("row gather + transpose", lambda: rows2[idx_st].T.contiguous())

    def glue_core():
        G, m = sk.shape
        N = G * m
        PL = PR = F.as_i32(cols)
        sk_st = sk.reshape(-1)[bitrev_perm(N, dev)]
        Kl, s = N // 2, 1
        while s < m:
            A_pl, A_pr, B_pl, B_pr = PL[:, :Kl], PR[:, :Kl], PL[:, Kl:], PR[:, Kl:]
            kAL, kAR = sk_st[:Kl], sk_st[N - 2 * Kl:N - Kl]
            kBL, kBR = sk_st[Kl:2 * Kl], sk_st[N - Kl:]
            match, aP, bP = kAR == kBL, kAL == kAR, kBL == kBR
            mid = A_pr ^ B_pl
            PL = torch.where((match & aP)[None], mid, A_pl)
            PR = torch.where((match & bP)[None], mid, B_pr)
            Kl //= 2
            s *= 2
        return PL, PR

    phase("glue core (no emissions or routing)", glue_core)
    phase("tree glue (no-op level)", lambda: MT.group_buckets_tree(cv, sk, cols, nb, noop_level))
    half = cols.shape[1] // 2
    a_cols, b_cols = cols[:, :half], cols[:, half:]
    mid = phase(f"kernels_tree.mid, level 1 (K={half})", lambda: KT.mid(cv, a_cols, b_cols))
    # K7's output against its plain version on the same planes and lane inverses
    apr, bpl, tinv = KT.mid_planes(cv, a_cols, b_cols)
    want = KT.phase_b_plain(cv, apr, bpl, tinv).reshape(mid.shape[0], -1)
    mid_err = int((F.i64(mid) - F.i64(want[:, :half])).abs().max())
    if mid_err:
        raise AssertionError(f"level-1 mid differs from the plain K7 (max abs err {mid_err})")
    tots = KT.phase_a(cv, apr, bpl)
    wide = phase(f"batch inversion, one K6 launch (M={tots.shape[1]})",
                 lambda: KT.invert(cv, tots))
    narrow = phase(f"halvings + narrow inversion (M={tots.shape[1]})",
                   lambda: invert_by_halvings(cv, tots))
    if not torch.equal(F.as_i32(wide), F.as_i32(narrow)):
        raise AssertionError("halvings + narrow inversion differs from the one wide K6 launch")
    phase(f"one group ({G} windows), real levels", lambda: MT.group_buckets_tree(cv, sk, cols, nb))
    sums = phase("window_sums_tree (all windows)",
                 lambda: MT.window_sums_tree(cv, sc, P, c, group))
    phase("horner combine", lambda: M.horner_combine(cv, sums, c))

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) / 2**30 if on_card else None
    tree = phase("msm_tree.msm", lambda: MT.msm(cv, sc, P))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None
    fold = phase("msm.msm", lambda: M.msm(cv, sc, P, affine=True))
    if not all(torch.equal(F.as_i32(u), F.as_i32(v))
               for u, v in zip(C.to_affine(cv, tree), C.to_affine(cv, fold))):
        raise AssertionError("the fold gives another point than the tree")
    print(f"tree and fold give one point (c = {c} tree, "
          f"{M.pick_window_bits(n)} fold); peak device memory of the tree MSM "
          + ("not measured (cpu)" if peak is None
             else f"{peak:.3f} GiB ({base:.3f} GiB allocated before it)"))
    res = {"tool": "bench_tree_phases", "card": measure.card_line(dev), "log2n": log2n,
           "group": group, "c": c, "phases_ms": ms, "peak_gib_msm_tree": peak,
           "allocated_gib_before": base, "same_point": True, "mid_lanes": want.shape[1] // KT.T_SLOTS,
           "mid_max_abs_err": mid_err}
    print(json.dumps(res))
    return res


def crossover(log2ns=(16, 18, 20, 21), curves=("G1", "G2"), bits: int = 254, device="cuda",
              reps: int = 3) -> dict:
    """The tree/fold crossover: `msm.msm` (the fold) against `msm_tree.msm`
    of affine points at each 2^log2n of `log2ns`, in each curve of `curves`,
    scalars of `bits` bits from a seed (`draw_scalars`).  Each path: mean
    milliseconds of `reps` calls after a warm-up (CUDA events), and on a card
    the peak memory reserved over its calls (`max_memory_reserved`, the
    allocator's cache emptied and its peak reset before) beside what the
    inputs hold.  Both must give one point; `auto` marks the fold, the
    path `msm.msm` takes.  Prints one line a size
    and path and one JSON line with the card and the rows; returns it."""
    import torch
    from groth16_tpu_torch.ops import curve as C, field as F
    from groth16_tpu_torch.ops import msm as M, msm_tree as MT
    from groth16_tpu_torch.tools import measure

    dev = torch.device(device)
    msms = {"fold": lambda cv, sc, P: M.msm(cv, sc, P, affine=True), "tree": MT.msm}
    on_card = dev.type == "cuda"
    rows = []
    for name in curves:
        cv = getattr(C, name)
        for log2n in log2ns:
            n = 1 << log2n
            P = make_points(n, dev, cv=cv)
            sc = torch.from_numpy(draw_scalars(n, 11 + log2n, bits)).to(dev)
            points = []
            for path, msm in msms.items():
                out = []
                if on_card:
                    torch.cuda.synchronize(dev)
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats(dev)
                inputs = torch.cuda.memory_allocated(dev) / 2**30 if on_card else None
                ms = measure.time_ms(lambda: out.append(msm(cv, sc, P)), dev, reps)
                peak = torch.cuda.max_memory_reserved(dev) / 2**30 if on_card else None
                points.append(C.to_affine(cv, out[-1]))
                del out
                c = MT.pick_window_bits_tree(n) if path == "tree" else M.pick_window_bits(n)
                rows.append(dict(curve=name, log2n=log2n, path=path, c=c, ms=ms,
                                 peak_reserved_gib=peak, inputs_gib=inputs,
                                 auto=path == "fold"))
                print(f"{name} 2^{log2n} {path:4s} c={c:2d} {ms:10.3f} ms, peak reserved "
                      + ("not measured (cpu)" if peak is None
                         else f"{peak:.3f} GiB ({inputs:.3f} GiB inputs)"), flush=True)
            if not all(torch.equal(F.as_i32(u), F.as_i32(v)) for u, v in zip(*points)):
                raise AssertionError(f"{name} 2^{log2n}: the tree and the fold give two points")
            del P, sc, points
    res = {"tool": "bench_tree_phases.crossover", "card": measure.card_line(dev), "bits": bits,
           "reps": reps, "rows": rows}
    print(json.dumps(res))
    return res


USAGE = """usage: bench_tree_phases [log2n] [group]
       bench_tree_phases crossover [G1,G2] [16,18,20,21] [bits]"""


def main(argv=None) -> int:
    import torch
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("bench_tree_phases: needs a CUDA device", file=sys.stderr)
        return 2
    if args and args[0] == "crossover":
        curves = args[1].split(",") if len(args) > 1 else ("G1", "G2")
        log2ns = [int(v) for v in args[2].split(",")] if len(args) > 2 else (16, 18, 20, 21)
        if set(curves) - {"G1", "G2"}:
            print(USAGE, file=sys.stderr)
            return 2
        crossover(log2ns, curves, int(args[3]) if len(args) > 3 else 254)
        return 0
    run(int(args[0]) if args else 20, int(args[1]) if len(args) > 1 else 4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
