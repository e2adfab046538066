#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (groth16_tpu_torch) once on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, in order; any failure raises and the script exits non-zero:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from csrc/ with nvcc (sm_90a) and print the build time;
  3. hold every kernel against its plain PyTorch version on the card at the
     main path's shapes, bit-exact (tolerance 0: exact integer arithmetic),
     and time both with CUDA events;
  4. the main path: synthetic_circuit(16) (65,533 constraints, domain 2^16),
     the port's fake setup on the card, write_zkey / write_witness to a temp
     directory, parse_zkey / parse_witness, generate_proof_with_mask with a
     fixed mask, in both flavours; each proof must pass verify_proof, and
     every kernel must have launched during the proofs;
  5. the H1 MSM (2^16 points) through the merge tree and through the fold,
     timed against each other; both must give the same point.

It prints the phase times, the launch counts, one JSON line of kernels and,
last, {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 20261016
MASK = (0x1234567890ABCDEF1234567890ABCDEF, 0xFEDCBA0987654321FEDCBA0987654321)
TOXIC = dict(alpha=0x1DEA, beta=0xBEEF, gamma=0x6A33A, delta=0xDE17A, tau=0x7A0)
LOG2 = 16
K1_POINTS = 1 << 16
# K2 launches of the fold MSMs at 2^16 - 1 points (A1, B1, C1 in G1, B2 in
# G2): c = 13, 20 windows; level 0 is affine over 20 x 2048 lanes, level 1
# projective over 20 x 64 lanes.  (curve, affine, lanes, digit bound)
K2_SHAPES = (("G1", True, 20 * 2048, 1 << 12), ("G1", False, 20 * 64, 1 << 12),
             ("G2", True, 20 * 2048, 1 << 12), ("G2", False, 20 * 64, 1 << 12))
NTT_SIZES = (10, 15, 16, 17)
# Merge-tree launches of the H1 MSM (2^16 points, c = 13, groups of 4
# windows, 2^18 elements a group): level 1 is 2^17 additions = 8192 lanes of
# 16; K5 halves 8192 -> 4096 -> 2048 lanes; K6 takes 2048.
TREE_M = 8192


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    """Largest |a - b| over matching uint32 tensors (tuples compare pairwise,
    None only with None); raise unless 0."""
    import torch
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b, strict=True))
    if a is None or b is None:
        if a is not b:
            raise AssertionError("kernel and plain version disagree on an absent output")
        return 0
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    if err:
        raise AssertionError(f"kernel differs from its plain version (max abs err {err})")
    return err


def _cat(xs):
    import torch
    from groth16_tpu_torch.ops.field import as_i32, as_u32
    return as_u32(torch.cat([as_i32(x) for x in xs]))


def random_scalars(rng, n, dev):
    import numpy as np
    import torch
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    limbs[:, 15] &= 0x2FFF            # < r
    return torch.from_numpy(limbs).to(dev)


def record(results, name, variant, err, ms, plain_ms):
    results.setdefault(name, []).append((variant, err, ms, plain_ms))


def check_point_kernel(rng, dev, results):
    """K1 add and double, G1 and G2, on 2^16 random projective points with
    infinity, P = Q and P = -Q lanes."""
    import torch
    from groth16_tpu_torch.ops import curve as C, kernels as KN
    from groth16_tpu_torch.protocol.fake_setup import fixed_base_mul
    n = K1_POINTS
    for cv in (C.G1, C.G2):
        P = fixed_base_mul(cv, random_scalars(rng, n, dev))
        Q = list(fixed_base_mul(cv, random_scalars(rng, n, dev)))
        inf = C.inf_like(cv, (64,), dev)
        P = tuple(_cat([i, c[64:]]) for i, c in zip(inf, P))               # P = inf
        Q = [_cat([c[:64], i, c[128:]]) for i, c in zip(inf, Q)]             # Q = inf
        for j in range(3):
            Q[j][128:192] = P[j][128:192]                                    # P = Q
        negP = C.point_neg(cv, tuple(c[192:256] for c in P))
        for j in range(3):
            Q[j][192:256] = negP[j].to(torch.uint32)                         # P = -Q
        Q = tuple(Q)
        e_add = max_abs_err(KN.point_add(cv, P, Q), C.point_add_plain(cv, P, Q))
        e_dbl = max_abs_err(KN.point_double(cv, P), C.point_double_plain(cv, P))
        t_add = cuda_ms(lambda: KN.point_add(cv, P, Q), 20)
        t_add_p = cuda_ms(lambda: C.point_add_plain(cv, P, Q), 2)
        t_dbl = cuda_ms(lambda: KN.point_double(cv, P), 20)
        t_dbl_p = cuda_ms(lambda: C.point_double_plain(cv, P), 2)
        print(f"K1 {cv.name} n={n}: add {t_add:.4f} ms (plain {t_add_p:.2f} ms), "
              f"double {t_dbl:.4f} ms (plain {t_dbl_p:.2f} ms), max_abs_err {max(e_add, e_dbl)}")
        record(results, "point_add", f"{cv.name} n={n}", e_add, t_add, t_add_p)
        record(results, "point_double", f"{cv.name} n={n}", e_dbl, t_dbl, t_dbl_p)


def _stream(rng, T, lanes, kmax, dev):
    """int32[T, lanes] keys sorted by |key| per lane, with runs and signs."""
    import numpy as np
    import torch
    start = rng.integers(0, kmax - T, size=(1, lanes))
    steps = rng.integers(0, 2, size=(T, lanes)).cumsum(0)
    sign = np.where(rng.integers(0, 2, size=(T, lanes)) > 0, 1, -1)
    return torch.from_numpy(((start + steps) * sign).astype(np.int32)).to(dev)


def check_fold_kernel(rng, dev, results):
    """K2 at every template and stream shape the fold MSMs of the main path
    launch (K2_SHAPES)."""
    import torch
    from groth16_tpu_torch.ops import curve as C, field as F, kernels as KN
    from groth16_tpu_torch.protocol.fake_setup import fixed_base_mul
    T = KN.FOLD_T
    for name, affine, lanes, kmax in K2_SHAPES:
        cv = C.G1 if name == "G1" else C.G2
        kT = _stream(rng, T, lanes, kmax, dev)
        pts = fixed_base_mul(cv, random_scalars(rng, 4096, dev))
        coords = C.to_affine(cv, pts) if affine else pts
        rows = torch.cat([F.as_i32(c).reshape(4096, -1) for c in coords], -1)
        if affine:
            rows[:64] = 0                                     # (0, 0) = infinity
        idx = torch.from_numpy(rng.integers(0, 4096, size=(T, lanes))).to(dev)
        pT = F.as_u32(rows[idx].permute(0, 2, 1).contiguous())   # [T, Rin, lanes]
        err = max_abs_err(KN.fold_level_kernel(cv, kT, pT, affine),
                          KN.fold_level_plain(cv, kT, pT, affine))
        t_k = cuda_ms(lambda: KN.fold_level_kernel(cv, kT, pT, affine), 5)
        t_p = cuda_ms(lambda: KN.fold_level_plain(cv, kT, pT, affine), 1)
        kind = "affine" if affine else "projective"
        print(f"K2 {cv.name} {kind} T={T} lanes={lanes}: {t_k:.3f} ms "
              f"(plain {t_p:.1f} ms), max_abs_err {err}")
        record(results, "fold_level_kernel", f"{cv.name} {kind} lanes={lanes}", err, t_k, t_p)


def check_ntt_kernel(rng, dev, results):
    """K3 at each of the four inner-transform calls of a forward and an
    inverse NTT at 2^10, 2^15, 2^16 and 2^17, plus the round trip through
    forward_ntt / inverse_ntt."""
    from groth16_tpu_torch.ops import ntt as NT
    for log2n in NTT_SIZES:
        err = 0
        for inverse in (False, True):
            for NB, T, tw, roots, dit in NT.inner_calls(log2n, inverse, dev):
                x = random_scalars(rng, NB * T, dev).T.contiguous().reshape(16, NB, T)
                e = max_abs_err(NT.ntt_inner_kernel(x, tw, roots, dit),
                                NT.ntt_inner_plain(x, tw, roots, dit))
                err = max(err, e)
                if log2n == LOG2:
                    t_k = cuda_ms(lambda: NT.ntt_inner_kernel(x, tw, roots, dit), 20)
                    t_p = cuda_ms(lambda: NT.ntt_inner_plain(x, tw, roots, dit), 2)
                    kind = ("DIT" if dit else "DIF") + (" +twiddle" if tw is not None else "")
                    print(f"K3 2^{log2n} {kind} T={T} NB={NB}: {t_k:.4f} ms (plain {t_p:.2f} ms)")
                    record(results, "ntt_inner_kernel", f"2^{log2n} {kind}", e, t_k, t_p)
        dom = NT.Domain(log2n)
        x = random_scalars(rng, dom.size, dev)
        max_abs_err(NT.inverse_ntt(dom, NT.forward_ntt(dom, x)), x)   # round trip
        print(f"K3 2^{log2n}: four inner calls bit-exact (max_abs_err {err}), round trip exact")
        record(results, "ntt_inner_kernel", f"2^{log2n} all calls", err, None, None)


def tree_planes(rng, cv, M, dev):
    """A level of 16 * M affine additions on the card: uint32[R2, 16, M]
    planes A.pL, A.pR, B.pL, B.pR with doubling, cancellation and infinity
    lanes, and int32[16, M] random flags."""
    import numpy as np
    import torch
    from groth16_tpu_torch.ops import curve as C, field as F, kernels_tree as KT
    from groth16_tpu_torch.protocol.fake_setup import fixed_base_mul
    T, nc, npts = KT.T_SLOTS, KT.ncomp(cv), 256
    x, y = C.to_affine(cv, fixed_base_mul(cv, random_scalars(rng, npts, dev)))
    xr = F.as_i32(x).reshape(npts, nc)
    yr = F.as_i32(y).reshape(npts, nc)
    nyr = F.as_i32(F.neg_mod(F.FP, y)).reshape(npts, nc)
    zero = torch.zeros((1, 2 * nc), dtype=torch.int32, device=dev)
    pool = torch.cat([torch.cat([xr, yr], 1), torch.cat([xr, nyr], 1), zero], 0)
    inf = 2 * npts
    K = T * M
    case = np.arange(K) % 7
    ia, ib = rng.integers(0, npts, size=K), rng.integers(0, npts, size=K)
    ib = np.where(case == 1, ia, ib)                          # doubling
    ib = np.where(case == 2, ia + npts, ib)                   # P + (-P)
    ia = np.where((case == 3) | (case == 5), inf, ia)
    ib = np.where((case == 4) | (case == 5), inf, ib)
    idx = [rng.integers(0, inf + 1, size=K), ia, ib, rng.integers(0, inf + 1, size=K)]
    planes = [F.as_u32(pool[torch.from_numpy(i).to(dev)].T.reshape(2 * nc, T, M).contiguous())
              for i in idx]
    flg = torch.from_numpy(rng.integers(0, 8, size=(T, M)).astype(np.int32)).to(dev)
    return planes, flg


def check_tree_kernels(rng, dev, results):
    """K4, K5, K6 and K8 (G1) at the level shapes of the H1 MSM."""
    from groth16_tpu_torch.ops import curve as C, kernels_tree as KT
    cv = C.G1
    (apl, apr, bpl, bpr), flg = tree_planes(rng, cv, TREE_M, dev)

    tot = KT.phase_a_kernel(cv, apr, bpl)
    err = max_abs_err(tot, KT.phase_a_plain(cv, apr, bpl))
    t_k = cuda_ms(lambda: KT.phase_a_kernel(cv, apr, bpl), 10)
    t_p = cuda_ms(lambda: KT.phase_a_plain(cv, apr, bpl), 1)
    print(f"K4 G1 M={TREE_M}: {t_k:.4f} ms (plain {t_p:.2f} ms), max_abs_err {err}")
    record(results, "phase_a_kernel", f"G1 M={TREE_M}", err, t_k, t_p)

    w = TREE_M // 2
    for W in (w, w // 2):
        a, b = tot[:, :W], tot[:, W:2 * W]
        err = max_abs_err(KT.mul_rows_kernel(cv, a, b), KT.mul_rows_plain(cv, a, b))
        t_k = cuda_ms(lambda: KT.mul_rows_kernel(cv, a, b), 20)
        t_p = cuda_ms(lambda: KT.mul_rows_plain(cv, a, b), 2)
        print(f"K5 G1 W={W}: {t_k:.4f} ms (plain {t_p:.2f} ms), max_abs_err {err}")
        record(results, "mul_rows_kernel", f"G1 W={W}", err, t_k, t_p)

    small = tot[:, :KT.INV_MAXW].contiguous()
    err = max_abs_err(KT.invert_kernel(cv, small), KT.invert_plain(cv, small))
    t_k = cuda_ms(lambda: KT.invert_kernel(cv, small), 5)
    t_p = cuda_ms(lambda: KT.invert_plain(cv, small), 1)
    print(f"K6 G1 M={KT.INV_MAXW}: {t_k:.4f} ms (plain {t_p:.2f} ms), max_abs_err {err}")
    record(results, "invert_kernel", f"G1 M={KT.INV_MAXW}", err, t_k, t_p)

    tinv = KT.invert_rows(cv, tot)
    for M, want_em in ((TREE_M, False), (TREE_M // 2, True)):
        args = [p[:, :, :M].contiguous() for p in (apl, apr, bpl, bpr)]
        args += [flg[:, :M].contiguous(), tinv[:, :M].contiguous(), want_em]
        err = max_abs_err(KT.phase_b_level_kernel(cv, *args), KT.phase_b_level_plain(cv, *args))
        t_k = cuda_ms(lambda: KT.phase_b_level_kernel(cv, *args), 10)
        t_p = cuda_ms(lambda: KT.phase_b_level_plain(cv, *args), 1)
        print(f"K8 G1 M={M} emit={want_em}: {t_k:.4f} ms (plain {t_p:.2f} ms), "
              f"max_abs_err {err}")
        record(results, "phase_b_level_kernel", f"G1 M={M} emit={want_em}", err, t_k, t_p)


WRAPPERS = (("point_add", "kernels"), ("point_double", "kernels"),
            ("fold_level_kernel", "kernels"), ("ntt_inner_kernel", "ntt"),
            ("phase_a_kernel", "kernels_tree"), ("mul_rows_kernel", "kernels_tree"),
            ("invert_kernel", "kernels_tree"), ("phase_b_level_kernel", "kernels_tree"))


def _wrappers():
    import importlib
    return [getattr(importlib.import_module(f"groth16_tpu_torch.ops.{mod}"), name)
            for name, mod in WRAPPERS]


def main_path(dev):
    """Setup on the card, zkey/wtns round trip through files, one proof per
    flavour.  Returns the launch counts of the two proofs and the Snarkjs
    zkey."""
    import groth16_tpu_torch as G
    from groth16_tpu_torch.models.circuits import synthetic_circuit

    r1cs, wtns = synthetic_circuit(LOG2)
    inputs = []
    with tempfile.TemporaryDirectory() as tmp:
        for flavour in (G.Flavour.Snarkjs, G.Flavour.JensGroth):
            t0 = time.perf_counter()
            zk = G.fake_circuit_setup(r1cs, G.ToxicWaste(**TOXIC), flavour, dev)
            t1 = time.perf_counter()
            zpath = os.path.join(tmp, f"{flavour.value}.zkey")
            wpath = os.path.join(tmp, "circuit.wtns")
            G.write_zkey(zpath, zk)
            G.write_witness(wpath, wtns.values)
            zkey, w = G.parse_zkey(zpath), G.parse_witness(wpath)
            zkey.header.flavour = flavour      # the .zkey format carries no flavour tag
            print(f"setup {flavour.value}: {t1 - t0:.2f} s on the card, "
                  f"file round trip {time.perf_counter() - t1:.2f} s "
                  f"(nvars {zkey.header.nvars}, domain 2^{zkey.header.log_domain_size})")
            inputs.append((flavour, zkey, w))

    wrappers = _wrappers()
    for fn in wrappers:
        fn.launches = 0
    proofs = []
    for flavour, zkey, w in inputs:
        tm = {}
        prf = G.generate_proof_with_mask(zkey, w, G.Mask(*MASK), dev, tm)
        proofs.append((flavour, zkey, prf))
        print(f"prove {flavour.value}: " + ", ".join(f"{k} {v:.3f}" for k, v in tm.items()))
    counts = {fn.__name__: fn.launches for fn in wrappers}

    for flavour, zkey, prf in proofs:
        if prf.pi_a is None or prf.pi_b is None or prf.pi_c is None:
            raise AssertionError(f"{flavour.value}: proof has a point at infinity")
        if not G.verify_proof(G.extract_vkey(zkey), prf):
            raise AssertionError(f"{flavour.value}: proof does not verify")
        print(f"verify {flavour.value}: ok")
    print("launches during the two proofs: " + json.dumps(counts))
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"kernel wrapper {name} was not launched by the main path")
    return counts, inputs[0][1]


def h1_tree_vs_fold(rng, dev, zkey):
    """The H1 MSM (2^16 points) of the Snarkjs zkey through the merge tree,
    as the main path runs it, and through the fold; same point, both timed."""
    import torch
    from groth16_tpu_torch.ops import curve as C, msm as M
    pa = zkey.ppoints.points_h1
    P = C.from_affine(C.G1, torch.from_numpy(pa.x).to(dev), torch.from_numpy(pa.y).to(dev))
    s = random_scalars(rng, pa.x.shape[0], dev)
    c_fold = M.pick_window_bits(s.shape[0])
    runs = {"tree": lambda: M.msm(C.G1, s, P, affine=True),
            "fold": lambda: M.horner_combine(
                C.G1, M.window_sums(C.G1, s, P, c_fold, affine=True), c_fold)}
    out, ms = {}, {}
    for name, fn in runs.items():
        out[name] = C.to_affine(C.G1, fn())
        ms[name] = cuda_ms(fn, 3)
    max_abs_err(out["tree"], out["fold"])
    print(f"H1 MSM n={s.shape[0]}: tree {ms['tree']:.1f} ms, fold {ms['fold']:.1f} ms, "
          "same point")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    import numpy as np
    from groth16_tpu_torch.ops import cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cuda.lib()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc {cuda.build_seconds:.1f} s)")

    rng = np.random.default_rng(SEED)
    results = {}
    check_point_kernel(rng, dev, results)
    check_fold_kernel(rng, dev, results)
    check_ntt_kernel(rng, dev, results)
    check_tree_kernels(rng, dev, results)

    counts, zkey = main_path(dev)
    h1_tree_vs_fold(rng, dev, zkey)

    src = "groth16_tpu_torch/csrc/"
    table = {"point_add": ("point.cu", "groth16_tpu/ops/kernels.py:288"),
             "point_double": ("point.cu", "groth16_tpu/ops/kernels.py:288"),
             "fold_level_kernel": ("fold.cu", "groth16_tpu/ops/kernels.py:416"),
             "ntt_inner_kernel": ("ntt.cu", "groth16_tpu/ops/ntt_pallas.py:232"),
             "phase_a_kernel": ("tree.cu", "groth16_tpu/ops/kernels_tree.py:120"),
             "mul_rows_kernel": ("tree.cu", "groth16_tpu/ops/kernels_tree.py:166"),
             "invert_kernel": ("tree.cu", "groth16_tpu/ops/kernels_tree.py:202"),
             "phase_b_level_kernel": ("tree.cu", "groth16_tpu/ops/kernels_tree.py:370")}
    kernels = []
    for name, (source, replaces) in table.items():
        rows = results[name]
        timed = [r for r in rows if r[2] is not None]
        variant, _, ms, plain_ms = timed[0]          # the first main-path shape checked
        kernels.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": max(r[1] for r in rows), "ms": ms, "plain_ms": plain_ms,
                        "shape": variant})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
