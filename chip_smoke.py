#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (groth16_tpu_torch) once on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, in order; any failure raises and the script exits non-zero:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from csrc/ with nvcc (sm_90a) and print the build time;
  3. hold every kernel against its plain PyTorch version on the card at the
     main path's shapes, bit-exact (tolerance 0: exact integer arithmetic),
     and time both with CUDA events: K1's add, doubling chain and Horner, K2
     at every fold level of the main path's MSMs (G1 and G2, level 0 affine
     through the sort order, the projective levels of `fold_schedule`), K3
     at every step of every plan (the quotient's batched coset shift and
     un-shift, the forward and inverse NTT) and the quotient's pointwise
     kernel at 2^10-2^20, K4 at the level-1 lanes of the H1 and 2^20 trees
     and a G2 level, K5 at a proof's `to_affine` (G1, G2), on column views
     of a row (W = 4096, 2048, 2^16) and on 2^20 point-major coordinates
     (profiled in step 16), the batch
     inversion K6 at widths from 1 to 2^17 (a zero among the totals), the
     fused tree level K8 at the H1 MSM's levels 1 and 2, a narrow level, the
     2^20 tree's level 1 and a G2 level, and `to_affine` on the card (one K6
     and one K5 launch) against the CPU;
  4. the main path: synthetic_circuit(16) (65,533 constraints, domain 2^16),
     the port's fake setup on the card, write_zkey / write_witness to a temp
     directory, parse_zkey / parse_witness, and a proof with a fixed mask
     from the core run eagerly on the card (`prove_core_device`'s two
     parts, no graph), in both flavours; each proof must pass verify_proof,
     every kernel of the proof path must have launched during the proofs,
     a proof must call torch.cummax (the plain field arithmetic's carry
     scan) 0 times, a proof's MSMs (`core_msms`) must call the SpMV kernel
     once, Horner 4 times (`prover.CHAIN_LAUNCHES`), at most 10 doubling
     chains, fewer than 400 K1 kernels in all, no tree kernel (K4, K8, the
     Fp negation), no K6 or K5, K2 once a fold level of each of the five
     MSMs, and K3 4 times (Snarkjs) or 6 times (JensGroth) with one
     pointwise kernel, and its algebra K6 and K5 twice each (`to_affine`);
     the SpMV kernel (one wrapper
     call, two launches) against its plain version on the card at the 2^16
     proof's coefficients, at a seeded set with an empty row, a 2^16-entry
     row and repeated columns, and at a seeded power-law set (2^16 rows of
     Zipf lengths up to 2^15, about 2^19 entries), and the Fp negation at
     2^16 G1 coordinates with infinities, bit-exact and timed beside their
     bounds; one 2^16 quotient per flavour and `points_to_host` of a
     proof's five MSM results registered for the profiles (step 16); and
     the quotient on the card against its plain version on the card at
     2^16 and 2^20, both flavours, timed beside its bound; then the proof's
     CUDA graph in both flavours (`fused_phase`, prover.FusedProof: one
     graph a proof): the capture's launches must be those of the eager
     core's two parts; replays through generate_proof_with_mask (the main
     witness and BATCH_SEEDS') call no kernel wrapper and no torch.cummax
     and equal the eager core's proofs (`eager_proof`), which verify;
     replays and the eager core timed in turns, the capture and the
     algebra timed; and one Snarkjs proof at 2^18 (`fused_big_phase`,
     above the JAX package's fused cap of 2^16) equal to the eager core's,
     both timed;
  5. K7 (the tree's mid kernel) against its plain version, G1 at the H1
     level-1 shape and at the 2^20 one, G2 at a small one, K4 timed beside
     it on the same planes;
  6. the Fp-product path: tools/bench_mul_kernels.run, K9 against its plain
     version and host ints, timed, with the opcode mix of one product read
     from K9's SASS, the multiply issue rates an SM a clock that the bound
     rests on (mad.lo, mad.wide, the carry-chain pair, mad.hi);
  7. the tree-phase path: tools/bench_tree_phases.run at 2^20 G1 points, the
     merge tree's phases timed (K4, K7; K5 in the halvings); its level-1 mid
     must equal the plain K7 on the same inputs, the halvings (K5 on views,
     into halves of one output) + narrow inversion must equal the one wide
     K6 launch on the level-1 totals, and the tree (`msm_tree.msm`) and the
     fold (`msm.msm`) must give one point;
  8. the fold-phase path: tools/bench_fold_phases at 2^20 G1 points (each K2
     level, the bucket reduce, Horner, the fold MSM's peak memory; the
     phases must give msm.msm's point);
  9. msm_chunked at 2^21 points from host numpy in two segments of 2^20,
     equal to the unchunked MSM at 2^21;
 10. batch mode: generate_proofs over four witnesses of the 2^16 circuit
     (seeds 42-45) with fixed masks against a freshly parsed zkey: each
     proof verifies and equals generate_proof_with_mask of its witness and
     mask and the eager core's proof, and the zkey goes to the card once;
     each proof's time, the first apart, and the batch's proofs/s, with
     the card's name and power limit;
 11. K3 at rank 1's local steps of a two-rank sharded quotient at 2^16 and
     2^20 (parallel/ntt_shard.steps: split strides, table slabs) against
     its plain version on the card, bit-exact, timed;
 12. the sharded proof (parallel/prover_shard.generate_proof_sharded) of
     the 2^16 circuit, both flavours, from the zkey and wtns files, on two
     gloo ranks sharing the card (launch.spawn; collectives host-staged),
     then 13. on torch.cuda.device_count() NCCL ranks, one a card: every
     rank's proof must equal the single-card proof of step 4 and verify,
     call torch.cummax 0 times and launch the sharded path's kernels; each
     rank's phase and collective times, launches and peak device memory
     against the single proof's are printed;
 14. the sharded NTT (four_step_ntt / four_step_intt) and G1 msm_sharded at
     2^20 on two gloo ranks sharing the card, equal to the single-card
     transform and MSM, timed with CUDA events with the collectives' share;
 15. the CLI: the 2^16 circuit's .r1cs and .wtns written with the port's
     writers, `python3 -m groth16_tpu_torch --setup --prove --verify -t ...
     --write-zkey c.zkey` as a subprocess on the card must exit 0 with
     `verification succeeded = True`, `--prove --verify -z c.zkey` on a
     witness with its public output changed must exit 2, and the sharded
     proof of c.zkey under torchrun (`-m groth16_tpu_torch.parallel.launch
     --verify`, NCCL, one rank a card) must exit 0;
 16. the profiles, last: every call registered above runs once, then each
     under torch.profiler on its own (the profiler traces nothing in a
     process once a CUDA module has loaded after its first session): K5 at
     each shape must trace one K5 launch and nothing else; the SpMV at each
     set its two launches and nothing else (device time against the bound);
     the quotient each of its K3 and pointwise launches, and
     `points_to_host` K6 and K5 5 times each (one of them G2), with nothing
     but copies and memsets beside them (and, in `points_to_host`, the
     copies to the host), so no `cummax` and no plain field-arithmetic
     kernel; one replay of each flavour's fused graph must trace the
     capture's launches and no copy to or from the host, and its device
     busy share, idle gaps and time by kernel are printed; one replay of a
     graph of the algebra alone gives its device time.

Each path (the two proofs, the tree-phase run, the Fp-product run, each
rank's sharded proofs) runs with every kernel wrapper's launch count set
to 0 and read just after; a wrapper that its own path never launched
fails the run.  It prints the
phase times, the launch counts, each kernel's bound (tools/measure.py), one
JSON line of kernels and, last, {"ok": true, "device": {...}}.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

SEED = 20261016
MASK = (0x1234567890ABCDEF1234567890ABCDEF, 0xFEDCBA0987654321FEDCBA0987654321)
TOXIC = dict(alpha=0x1DEA, beta=0xBEEF, gamma=0x6A33A, delta=0xDE17A, tau=0x7A0)
LOG2 = 16
K1_POINTS = 1 << 16
# K2 runs the fold MSMs at 2^16 - 1 and 2^16 points (A1, B1, C1 and H1 in
# G1, B2 in G2) as c = 13, 20 windows, streams of 2^16: level 0 affine at
# T = FOLD_T, then the projective levels of msm.fold_schedule
FOLD_LOG2 = 16
FOLD_MSMS_PER_PROOF = 5
NTT_SIZES = (10, 15, 16, 17, 20)
NTT_TIMED = (16, 20)
QUOTIENT_SIZES = (16, 20)
# K3 launches and pointwise launches of one proof's quotient, per flavour
QUOTIENT_LAUNCHES = {"snarkjs": (4, 1), "jens-groth": (6, 1)}
# K4 and K7 at the H1 MSM's level 1 (2^16 points, c = 13, groups of 4
# windows, 2^18 elements a group): 2^17 additions = 8192 lanes of 16
TREE_M = 8192
# level 1 of the 2^20-point tree (c = 16, groups of 4 windows): 2^21 additions
TREE_M_2E20 = 1 << 17
# K4 (curve, M lanes of 16): the H1 and 2^20 trees' level 1, a G2 level
K4_SHAPES = (("G1", TREE_M), ("G1", TREE_M_2E20), ("G2", 256))
# K5 (curve, W, layout): a proof's to_affine (X and Y of one point times its
# Z inverse, first: the main path's shape), the halvings' column views (of
# the H1 level-1 totals: 4096, 2048; of the 2^20 ones: 2^16) and
# make_points' 2^20 point-major coordinates times a row of Z inverses
K5_SHAPES = (("G1", 1, "proof"), ("G2", 1, "proof"), ("G1", 4096, "views"),
             ("G1", 2048, "views"), ("G1", 1 << 16, "views"), ("G1", 1 << 20, "point-major"))
# The fused tree level (K8): (curve, K additions, emission); the H1 MSM's
# levels 1 and 2, a narrow level, the 2^20 tree's level 1 (c = 16, groups of
# 4 windows: 2^21 additions) and a G2 level
LEVEL_SHAPES = (("G1", 1 << 17, False), ("G1", 1 << 16, True), ("G1", 64, True),
                ("G1", 1 << 21, False), ("G2", 4096, True))
TO_AFFINE_PER_PROOF = 2   # pi_a and pi_c in one G1 batch, pi_b in G2
# K6 widths held against the plain version (curve, M, a zero among the
# totals); timed at 2048 (the widest row of the one-block K6 it replaced) and
# at the 2^20 tree's level 1
K6_WIDTHS = (("G1", 2048, False), ("G1", 1 << 17, False), ("G1", 1, False), ("G1", 127, True),
             ("G1", 128, False), ("G1", 8192, False), ("G2", 1, False), ("G2", 256, False))
K6_TIMED = (2048, 1 << 17)
# K1 chains: the bucket reduce doubles the top bucket (k = 12) and Sq (k = 6)
# of c = 13's 20 windows; Horner runs W = 20, c = 13 (2^16) and W = 16,
# c = 16 (2^20)
DOUBLE_N_SHAPES = ((20, 12), (20, 6))
HORNER_SHAPES = ((20, 13), (16, 16))
# K1 as the fused proof's spec-point algebra drives it (prover.spec_algebra,
# its tables prover.spec_device_args; SPEC_WINDOW = 4 bits, 64 windows):
# Horner over two points' 64 picks; doublings of the 64 window bases (G1,
# G2) and of the two points (G1); the widest add round of the 16-entry
# tables (4 rows of the 64 columns, or of the 2 points, plus the next power
# of two) and of tree_sum over 64 picks (of 3 G1 points, of 1 G2 point)
ALGEBRA_HORNER = (2, 64, 4)                    # B, W, c (G1)
ALGEBRA_DOUBLES = (("G1", 64), ("G2", 64), ("G1", 2))
ALGEBRA_ADDS = (("G1", (4, 64), (1, 64)), ("G2", (4, 64), (1, 64)), ("G1", (4, 2), (1, 2)),
                ("G1", (32, 3), (32, 3)), ("G2", (32, 1), (32, 1)))
K1_MAX_PER_PROOF = 400
LOG2_FOLD_PHASES = 20  # the fold-phase run
LOG2_PHASES = 20      # the tree-phase run
LOG2_CHUNKED = 21     # msm_chunked: two segments of 2^20
NEG_POINTS = 1 << 16  # the Fp negation: the H1 tree's y coordinates
BATCH_SEEDS = (42, 43, 44, 45)


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds of fn() on the card, CUDA events, after one warm-up
    (unless `warmup` is False)."""
    from groth16_tpu_torch.tools.measure import time_ms
    return time_ms(fn, "cuda", reps, warmup)


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


def record(results, name, variant, err, ms, plain_ms, shape=None):
    """One checked shape of a kernel; `shape` (curve and sizes, as
    tools/measure.work takes them) gives its bound."""
    results.setdefault(name, []).append((variant, err, ms, plain_ms, shape))


def check_point_kernel(rng, dev, results):
    """K1 on 2^16 random projective points with infinity, P = Q and P = -Q
    lanes, G1 and G2: the add, the doubling chain (k = 1 and 3 there, k = 12
    and 6 on 20 points as the bucket reduce runs it) and Horner (W = 20,
    c = 13 and W = 16, c = 16 on sums with an infinity and two equal
    windows); then at the spec-point algebra's shapes (`check_algebra_k1`)."""
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
        err = max_abs_err(KN.point_add(cv, P, Q), C.point_add_plain(cv, P, Q))
        t_k = cuda_ms(lambda: KN.point_add(cv, P, Q), 20)
        t_p = cuda_ms(lambda: C.point_add_plain(cv, P, Q), 2)
        print(f"K1 {cv.name} add n={n}: {t_k:.4f} ms (plain {t_p:.2f} ms), max_abs_err {err}")
        record(results, "point_add", f"{cv.name} n={n}", err, t_k, t_p, dict(curve=cv.name, n=n))

        # window sums as the MSM hands them over: an infinity, two equal windows
        S = [c[60:80].clone() for c in P]
        for c in S:
            c[7] = c[6]
        chains = [(tuple(S), k) for _, k in DOUBLE_N_SHAPES] + [(P, 1), (P, 3)]
        for pts, k in chains:
            m = pts[0].shape[0]
            err = max_abs_err(KN.point_double_n(cv, pts, k), C.point_double_n_plain(cv, pts, k))
            t_k = cuda_ms(lambda: KN.point_double_n(cv, pts, k), 20)
            t_p = cuda_ms(lambda: C.point_double_n_plain(cv, pts, k), 2)
            print(f"K1 {cv.name} double_n n={m} k={k}: {t_k:.4f} ms (plain {t_p:.2f} ms), "
                  f"max_abs_err {err}")
            record(results, "point_double_n", f"{cv.name} n={m} k={k}", err, t_k, t_p,
                   dict(curve=cv.name, n=m, k=k))
        for W, c in HORNER_SHAPES:
            sums = tuple(x[:W].contiguous() for x in S)
            err = max_abs_err(KN.horner(cv, sums, c), C.horner_plain(cv, sums, c))
            t_k = cuda_ms(lambda: KN.horner(cv, sums, c), 5)
            t_p = cuda_ms(lambda: C.horner_plain(cv, sums, c), 1)
            print(f"K1 {cv.name} horner W={W} c={c}: {t_k:.4f} ms (plain {t_p:.2f} ms), "
                  f"max_abs_err {err}")
            record(results, "horner", f"{cv.name} W={W} c={c}", err, t_k, t_p,
                   dict(curve=cv.name, B=1, W=W, c=c))
        check_algebra_k1(cv, P, results)


def check_algebra_k1(cv, P, results):
    """K1 at the fused proof's spec-point algebra's shapes (ALGEBRA_*), on
    random points of P (its first 64 are infinity) as the algebra hands
    them over: Horner's picks with infinities among them, the adds'
    second operand broadcast along the rows as `curve.multiples` gives
    it; each against its plain version on the same inputs."""
    from groth16_tpu_torch.ops import curve as C

    def pts(start, shape):
        n = 1
        for d in shape:
            n *= d
        return tuple(c[start:start + n].reshape(shape + cv.comp_shape) for c in P)

    if cv.name == "G1":
        B, W, c = ALGEBRA_HORNER
        sums = pts(60, (B, W))
        err = max_abs_err(C.horner(cv, sums, c), C.horner_plain(cv, sums, c))
        t_k = cuda_ms(lambda: C.horner(cv, sums, c), 5)
        t_p = cuda_ms(lambda: C.horner_plain(cv, sums, c), 1)
        print(f"K1 {cv.name} horner B={B} W={W} c={c} (the algebra's): {t_k:.4f} ms "
              f"(plain {t_p:.2f} ms), max_abs_err {err}")
        record(results, "horner", f"{cv.name} B={B} W={W} c={c}", err, t_k, t_p,
               dict(curve=cv.name, B=B, W=W, c=c))
    for name, n in ALGEBRA_DOUBLES:
        if name == cv.name:
            x = pts(32, (n,))
            err = max_abs_err(C.point_double(cv, x), C.point_double_n_plain(cv, x, 1))
            t_k = cuda_ms(lambda: C.point_double(cv, x), 20)
            t_p = cuda_ms(lambda: C.point_double_n_plain(cv, x, 1), 2)
            print(f"K1 {cv.name} double_n n={n} k=1 (the algebra's): {t_k:.4f} ms "
                  f"(plain {t_p:.2f} ms), max_abs_err {err}")
            record(results, "point_double_n", f"{cv.name} n={n} k=1 (algebra)", err, t_k, t_p,
                   dict(curve=cv.name, n=n, k=1))
    for name, sa, sb in ALGEBRA_ADDS:
        if name == cv.name:
            a, b = pts(40, sa), pts(1000, sb)
            err = max_abs_err(C.point_add(cv, a, b), C.point_add_plain(cv, a, b))
            t_k = cuda_ms(lambda: C.point_add(cv, a, b), 20)
            t_p = cuda_ms(lambda: C.point_add_plain(cv, a, b), 2)
            n = sa[0] * sa[1]
            print(f"K1 {cv.name} add {list(sa)} + {list(sb)} (the algebra's): {t_k:.4f} ms "
                  f"(plain {t_p:.2f} ms), max_abs_err {err}")
            record(results, "point_add", f"{cv.name} {list(sa)} + {list(sb)}", err, t_k, t_p,
                   dict(curve=cv.name, n=n))


def check_fold_kernel(dev, results):
    """K2 at every level the fold MSMs of the main path launch, G1 and G2
    (bench_fold_phases.fold_case: 2^16 points, c = 13, 20 windows; level 0
    affine through the sort order, then the projective levels of
    `fold_schedule`, each fed by the one before): the bucket table, the
    trail and its keys bit-exact against the plain version on the same
    inputs, the table starting from the level before's sums; both timed."""
    from groth16_tpu_torch.ops import curve as C, kernels as KN, msm as M
    from groth16_tpu_torch.tools import bench_fold_phases as BF, measure
    for cv in (C.G1, C.G2):
        pts, order, keys, table = BF.fold_case(cv, FOLD_LOG2, dev)
        W, m = keys.shape
        Ts = M.fold_schedule(m)
        for i, T in enumerate(Ts):
            args = (pts, order, keys)
            kw = dict(T=T, affine=i == 0, last=i == len(Ts) - 1)
            tab_k, tab_p, scratch = table.clone(), table.clone(), table.clone()
            got = KN.fold_level_kernel(cv, *args, tab_k, **kw)
            err = max_abs_err((tab_k,) + got,
                              (tab_p,) + KN.fold_level_plain(cv, *args, tab_p, **kw))
            t_k = cuda_ms(lambda: KN.fold_level_kernel(cv, *args, scratch, **kw), 5)
            t_p = cuda_ms(lambda: KN.fold_level_plain(cv, *args, scratch, **kw), 1)
            shape = measure.fold_shape(keys.cpu().numpy(), T)
            kind = "affine" if kw["affine"] else "projective"
            lanes = W * (m // T)
            print(f"K2 {cv.name} level {i} {kind} T={T} lanes={lanes} closes={shape['closes']} "
                  f"zeros={shape['zeros']}: {t_k:.4f} ms (plain {t_p:.1f} ms), max_abs_err {err}")
            record(results, "fold_level_kernel", f"{cv.name} level {i} {kind} T={T} lanes={lanes}",
                   err, t_k, t_p, dict(curve=cv.name, affine=kw["affine"], T=T, lanes=lanes,
                                       **shape, order=order is not None, last=kw["last"]))
            table, (pts, keys), order, m = tab_k, got, None, m // T
        if not all(x is None for x in got):
            raise AssertionError("the last fold level must leave no trail")


def check_ntt_kernel(rng, dev, results):
    """K3 at every step of every plan (the quotient's coset shift on a batch
    of three and its un-shift, the forward and the inverse NTT) and the
    quotient's pointwise kernel in both of its uses, at 2^10, 2^15, 2^16,
    2^17 and 2^20, against their plain versions on the same inputs; timed at
    2^16 and 2^20.  Each plan's steps run on the previous step's output, and
    the forward / inverse round trip must give the input back."""
    from groth16_tpu_torch.ops import ntt as NT
    for log2n in NTT_SIZES:
        n, err = 1 << log2n, 0
        timed = log2n in NTT_TIMED
        eta = NT.Domain(log2n + 1).gen
        for kind in ("to_coset", "from_coset_std", "forward", "inverse"):
            B = 3 if kind == "to_coset" else 1
            x = random_scalars(rng, B * n, dev).reshape(B, n, 16)
            if kind == "from_coset_std":
                x = NT.pack(x)                 # as the pointwise kernel leaves it
            steps = NT.inner_calls(log2n, kind, dev, eta)
            for j, st in enumerate(steps):
                wire_out = kind != "to_coset" and j == len(steps) - 1
                got = NT.ntt_inner_kernel(x, st, wire_out)
                plain = {}
                t_p = cuda_ms(lambda: plain.setdefault("out", NT.ntt_inner_plain(x, st, wire_out)),
                              1, warmup=False)
                e = max_abs_err(got, plain["out"])
                err = max(err, e)
                if timed:
                    t_k = cuda_ms(lambda: NT.ntt_inner_kernel(x, st, wire_out), 20)
                    tabs = "+pre" * (st.pre is not None) + "+post" * (st.post is not None)
                    fmt = ("wire" if x.shape[2] == 16 else "packed") + "->" + (
                        "wire" if wire_out else "packed")
                    name = (f"2^{log2n} {kind} step {j + 1} {'DIT' if st.dit else 'DIF'}{tabs} "
                            f"T={st.T} NB={st.NB} B={B} {fmt}")
                    print(f"K3 {name}: {t_k:.4f} ms (plain {t_p:.2f} ms), max_abs_err {e}")
                    record(results, "ntt_inner_kernel", name, e, t_k, t_p,
                           dict(T=st.T, NB=st.NB, B=B, pre=st.pre is not None,
                                post=st.post is not None, wire_in=x.shape[2] == 16,
                                wire_out=wire_out))
                x = got
        for scale, standard in ((None, True), (0x1234567, False)):
            ev = NT.pack(random_scalars(rng, 3 * n, dev).reshape(3, n, 16))
            e = max_abs_err(NT.quotient_pointwise_kernel(ev, scale, standard),
                            NT.quotient_pointwise_plain(ev, scale, standard))
            err = max(err, e)
            if timed:
                t_k = cuda_ms(lambda: NT.quotient_pointwise_kernel(ev, scale, standard), 20)
                t_p = cuda_ms(lambda: NT.quotient_pointwise_plain(ev, scale, standard), 2)
                use = "Snarkjs (out of Montgomery form)" if standard else "JensGroth (x 1/Z)"
                print(f"pointwise 2^{log2n} {use}: {t_k:.4f} ms (plain {t_p:.2f} ms), "
                      f"max_abs_err {e}")
                record(results, "quotient_pointwise_kernel", f"2^{log2n} {use}", e, t_k, t_p,
                       dict(n=n, scale=scale is not None, standard=standard))
        dom = NT.Domain(log2n)
        x = random_scalars(rng, n, dev)
        max_abs_err(NT.inverse_ntt(dom, NT.forward_ntt(dom, x)), x)   # round trip
        print(f"K3 2^{log2n}: every step of every plan and the pointwise kernel bit-exact "
              f"(max_abs_err {err}), round trip exact")
        record(results, "ntt_inner_kernel", f"2^{log2n} all steps", err, None, None)


def quotient_phase(rng, dev, results):
    """prover.quotient_scalars on the card (the kernels) against its plain
    versions on the card, both flavours, at 2^16 and 2^20 on random Az, Bz,
    Cz: bit-exact; both timed with CUDA events, the kernels' time beside the
    bound of the whole quotient (tools/measure.py `work("quotient")`)."""
    from groth16_tpu_torch.protocol.prover import quotient_scalars
    from groth16_tpu_torch.protocol.types import Flavour
    for log2n in QUOTIENT_SIZES:
        abc = [random_scalars(rng, 1 << log2n, dev) for _ in range(3)]   # as the SpMV leaves them
        for flavour in (Flavour.Snarkjs, Flavour.JensGroth):
            got = quotient_scalars(flavour, *abc, log2n)
            plain = {}
            t_p = cuda_ms(lambda: plain.setdefault("out", quotient_scalars(flavour, *abc, log2n,
                                                                           plain=True)),
                          1, warmup=False)
            err = max_abs_err(got, plain["out"])
            t_k = cuda_ms(lambda: quotient_scalars(flavour, *abc, log2n), 10)
            print(f"quotient 2^{log2n} {flavour.value}: {t_k:.4f} ms (plain {t_p:.1f} ms), "
                  f"max_abs_err {err}")
            record(results, "quotient", f"2^{log2n} {flavour.value}", err, t_k, t_p,
                   dict(log2n=log2n, flavour=flavour.value))


def profile_quotient(rng, dev):
    """torch.profiler around one 2^16 quotient per flavour (in the profiles
    phase), each kernel's launches and device time printed:
    the trace must hold every launch of the two quotient kernels
    (`measure.quotient_launches`), and the device may run nothing else but
    copies (the stack of Az, Bz, Cz) and memsets; a host round trip
    (`Memcpy`), a `cummax` or any other plain field-arithmetic kernel fails
    the run."""
    import functools
    from groth16_tpu_torch.protocol.prover import quotient_scalars
    from groth16_tpu_torch.protocol.types import Flavour
    from groth16_tpu_torch.tools import measure
    abc = [random_scalars(rng, 1 << LOG2, dev) for _ in range(3)]
    for flavour in (Flavour.Snarkjs, Flavour.JensGroth):
        steps = [n for n, _ in measure.quotient_launches(LOG2, flavour.value)]
        defer_profile(f"quotient 2^{LOG2} {flavour.value}",
                      functools.partial(quotient_scalars, flavour, *abc, LOG2),
                      {"ntt_step_kernel": steps.count("ntt_inner_kernel"),
                       "quotient_pointwise_kernel": steps.count("quotient_pointwise_kernel")},
                      ("copy", "memset"))


def only_kernels(what, fn, expect: dict, allow: tuple) -> dict:
    """torch.profiler around one call of fn(): print each device kernel's
    launches and device time, and raise unless the trace holds `expect`'s
    launches of the kernels it names (a part of the name: launches; a trace
    that differs is taken again, `measure.device_kernels`) and every other
    device event's name holds one of `allow` (lower case); a `cummax` scan
    fails the run whatever `allow` says, and every torch.cummax call is also
    counted on the host, where no trace can miss it, and none may run."""
    from groth16_tpu_torch.tools import measure
    from groth16_tpu_torch.tools.measure import CUMMAX_KERNEL, cummax_callers
    with cummax_callers() as scans:
        names = measure.device_kernels(fn, expect)
    if scans:
        raise AssertionError(f"{what} ran cummax scans: {scans}")
    print(f"profiled {what}, device kernels (launches, device ms): "
          + "; ".join(f"{n} x {k[:60]} {us / 1e3:.4f}" for k, (n, us) in names.items()))
    bad = [k for k in names if CUMMAX_KERNEL in k or not (
        any(o in k for o in expect) or any(c in k.lower() for c in allow))]
    if bad:
        raise AssertionError(f"{what} ran plain kernels: {bad}")
    return names


# torch.profiler traces nothing on the card in a process once a CUDA module
# has loaded after its first session there (seen on an H100 after a kernel
# library's runtime started up, and after the phases between the K5 checks
# and the proofs), so the checks register the calls they profile
# (`defer_profile`) and the profiles phase warms every one up before its
# first session (`run_profiles`)
DEFERRED = []


def defer_profile(what, fn, expect: dict | None, allow: tuple, report=None) -> None:
    """Register one `only_kernels` check; report(names), if given, reads
    its trace.  With `expect` None the call is traced unchecked and
    report(device events, fn's value) reads the trace."""
    DEFERRED.append((what, fn, expect, allow, report))


def run_profiles() -> None:
    """Each registered call once (nothing new loads after the first
    session), then its `only_kernels` check and report."""
    import torch
    from groth16_tpu_torch.tools import measure
    for _, fn, _, _, _ in DEFERRED:
        fn()
    torch.cuda.synchronize()
    for what, fn, expect, allow, report in DEFERRED:
        if expect is None:
            report(*measure.device_trace(fn))
            continue
        names = only_kernels(what, fn, expect, allow)
        if report is not None:
            report(names)


def profile_to_host(rng, dev, zkey):
    """torch.profiler (in the profiles phase) around `points_to_host` of the
    five MSM results of a proof (random scalars over the zkey's A1, B1, B2,
    C1 and H1 points, each MSM as the prover runs it): the trace must hold
    K6 and K5 once for each
    result, the G1 instantiations 4 times and the G2 ones once, and the
    device may run nothing else but copies, memsets and the copies to the
    host (`Memcpy DtoH`); no `cummax`, no plain field kernel."""
    import torch
    from groth16_tpu_torch.ops import curve as C, msm as M
    pp = zkey.ppoints
    res = []
    for cv, pa in ((C.G1, pp.points_a1), (C.G1, pp.points_b1), (C.G2, pp.points_b2),
                   (C.G1, pp.points_c1), (C.G1, pp.points_h1)):
        P = C.from_affine(cv, torch.from_numpy(pa.x).to(dev), torch.from_numpy(pa.y).to(dev))
        res.append((cv, M.msm(cv, random_scalars(rng, pa.x.shape[0], dev), P, affine=True)))
    n_g2 = sum(cv is C.G2 for cv, _ in res)
    defer_profile("points_to_host of the five MSM results",
                  lambda: [C.points_to_host(cv, tuple(x[None] for x in r)) for cv, r in res],
                  {f"{k}<bn254::{g}>": n for k in ("tree_invert_kernel", "tree_mul_rows_kernel")
                   for g, n in (("G1", len(res) - n_g2), ("G2", n_g2))},
                  ("copy", "memset", "memcpy dtoh"))


def tree_planes(rng, cv, M, dev):
    """The planes uint32[R2, 16, M] of A.pR and B.pL that K4 and K7 take,
    from a level of 16 * M additions (bench_tree_phases.level_case)."""
    from groth16_tpu_torch.ops import kernels_tree as KT
    from groth16_tpu_torch.tools.bench_tree_phases import level_case, level_views
    _, apr, bpl, _ = level_views(*level_case(rng, cv, KT.T_SLOTS * M, dev)[:2])
    return tuple(c.reshape(c.shape[0], KT.T_SLOTS, M).contiguous() for c in (apr, bpl))


def check_invert_kernel(rng, dev, results):
    """K6 against `invert_plain` at every width of K6_WIDTHS (random
    254-bit totals, a zero among them where the entry says so), timed at K6_TIMED;
    the bound counts the Euclid steps of this run's block roots."""
    from groth16_tpu_torch.ops import curve as C, field as F, kernels_tree as KT
    from groth16_tpu_torch.tools import measure
    for name, M, zero in K6_WIDTHS:
        cv = C.G1 if name == "G1" else C.G2
        tots = random_scalars(rng, M * KT.ncomp(cv) // 16, dev).reshape(M, -1).T.contiguous()
        if zero:
            F.as_i32(tots)[:, M // 2] = 0
        err = max_abs_err(KT.invert_kernel(cv, tots), KT.invert_plain(cv, tots))
        if name == "G1" and M in K6_TIMED:
            t_k = cuda_ms(lambda: KT.invert_kernel(cv, tots), 10)
            t_p = cuda_ms(lambda: KT.invert_plain(cv, tots), 1)
            ops = sum(measure.euclid_ops(r) for r in measure.invert_block_roots(tots.cpu().numpy()))
            print(f"K6 {name} M={M}: {t_k:.4f} ms (plain {t_p:.2f} ms), max_abs_err {err}")
            record(results, "invert_kernel", f"{name} M={M}", err, t_k, t_p,
                   dict(curve=name, M=M, inv_ops=ops))
        else:
            print(f"K6 {name} M={M}" + (" with a zero" if zero else "") + f": max_abs_err {err}")
            record(results, "invert_kernel", f"{name} M={M}", err, None, None)


def check_to_affine(rng, dev):
    """`to_affine` on the card (Z inverted by K6, X and Y multiplied by one
    K5 launch) against `to_affine` of the same points on the CPU, G1 and G2,
    an infinity among them."""
    from groth16_tpu_torch.ops import curve as C, kernels_tree as KT
    from groth16_tpu_torch.protocol.fake_setup import fixed_base_mul
    for cv in (C.G1, C.G2):
        P = fixed_base_mul(cv, random_scalars(rng, 96, dev))
        P = tuple(_cat([i, c[1:]]) for i, c in zip(C.inf_like(cv, (1,), dev), P))
        before = (KT.invert_kernel.launches, KT.mul_rows_kernel.launches)
        got = C.to_affine(cv, P)
        if (KT.invert_kernel.launches - before[0], KT.mul_rows_kernel.launches - before[1]) != (1, 1):
            raise AssertionError("to_affine on the card must launch K6 once and K5 once")
        err = max_abs_err(tuple(g.cpu() for g in got), C.to_affine(cv, tuple(c.cpu() for c in P)))
        print(f"to_affine {cv.name} n=96 with an infinity, card against CPU: max_abs_err {err}")


def check_phase_a_kernel(rng, dev, results):
    """K4 against `phase_a_plain` at every shape of K4_SHAPES, timed."""
    from groth16_tpu_torch.ops import curve as C, kernels_tree as KT
    for name, M in K4_SHAPES:
        cv = C.G1 if name == "G1" else C.G2
        apr, bpl = tree_planes(rng, cv, M, dev)
        err = max_abs_err(KT.phase_a_kernel(cv, apr, bpl), KT.phase_a_plain(cv, apr, bpl))
        t_k = cuda_ms(lambda: KT.phase_a_kernel(cv, apr, bpl), 10)
        t_p = cuda_ms(lambda: KT.phase_a_plain(cv, apr, bpl), 1)
        print(f"K4 {name} M={M}: {t_k:.4f} ms (plain {t_p:.2f} ms), max_abs_err {err}")
        record(results, "phase_a_kernel", f"{name} M={M}", err, t_k, t_p, dict(curve=name, M=M))


def mul_rows_case(rng, cv, W, layout, dev) -> tuple:
    """K5's operands at one shape of K5_SHAPES: (a, b, point_major, W
    products, b's width)."""
    import torch
    from groth16_tpu_torch.ops import kernels_tree as KT
    from groth16_tpu_torch.ops.field import as_i32, as_u32
    nc = KT.ncomp(cv)

    def row(n):
        return random_scalars(rng, n * nc // 16, dev).reshape(n, nc).T.contiguous()

    def points(n):
        return random_scalars(rng, n * nc // 16, dev).reshape((n,) + cv.comp_shape)

    if layout == "proof":
        xy = as_u32(torch.stack([as_i32(points(W)), as_i32(points(W))]))
        return xy, row(W), True, 2 * W, W
    if layout == "views":
        tot = row(2 * W)
        return tot[:, :W], tot[:, W:], False, W, W
    return points(W), row(W), True, W, W


def check_mul_rows_kernel(rng, dev, results):
    """K5 against `mul_rows_plain` at every shape of K5_SHAPES, on operands
    where they lie; timed with CUDA events and, over one more call in the
    profiles phase, by torch.profiler, which must show one K5 launch and
    nothing else (no copy of a view or a point-major array)."""
    import functools
    from groth16_tpu_torch.ops import curve as C, kernels_tree as KT
    for name, W, layout in K5_SHAPES:
        cv = C.G1 if name == "G1" else C.G2
        a, b, pm, n, nb = mul_rows_case(rng, cv, W, layout, dev)
        err = max_abs_err(KT.mul_rows_kernel(cv, a, b, point_major=pm),
                          KT.mul_rows_plain(cv, a, b, point_major=pm))
        fn = functools.partial(KT.mul_rows_kernel, cv, a, b, point_major=pm)
        t_k = cuda_ms(fn, 20)
        t_p = cuda_ms(lambda: KT.mul_rows_plain(cv, a, b, point_major=pm), 2)
        print(f"K5 {name} W={W} {layout}: {t_k:.4f} ms events (plain {t_p:.2f} ms), "
              f"max_abs_err {err}")
        defer_profile(f"K5 {name} W={W} {layout}", fn, {"tree_mul_rows_kernel": 1}, ())
        record(results, "mul_rows_kernel", f"{name} W={W} {layout}", err, t_k, t_p,
               dict(curve=name, W=n, Wb=nb))


def check_tree_kernels(rng, dev, results):
    """K4 and K5 at their shapes, K6 at its widths, and the fused level K8
    at every shape of LEVEL_SHAPES against `level_plain` (in column slices
    at 2^21), operands as the tree's strided views; the bound of K8 counts
    the Euclid steps of this run's block roots."""
    from groth16_tpu_torch.ops import curve as C, kernels_tree as KT
    from groth16_tpu_torch.tools import measure
    from groth16_tpu_torch.tools.bench_tree_phases import level_case, level_views
    check_phase_a_kernel(rng, dev, results)
    check_mul_rows_kernel(rng, dev, results)
    check_invert_kernel(rng, dev, results)
    for name, K, want_em in LEVEL_SHAPES:
        cv = C.G1 if name == "G1" else C.G2
        PL, PR, flags = level_case(rng, cv, K, dev)
        args = level_views(PL, PR) + tuple(flags) + (want_em,)
        got = KT.level_kernel(cv, *args)
        t_p = cuda_ms(lambda: KT.level_plain(cv, *args), 1, warmup=False)
        err = max_abs_err(got, KT.level_plain(cv, *args))
        t_k = cuda_ms(lambda: KT.level_kernel(cv, *args), 10)
        ops = sum(measure.euclid_ops(r) for r in measure.level_block_roots(
            name, args[1].cpu().numpy(), args[2].cpu().numpy()))
        print(f"K8 {name} K={K} emit={want_em}: {t_k:.4f} ms (plain {t_p:.2f} ms), "
              f"max_abs_err {err}")
        record(results, "level_kernel", f"{name} K={K} emit={want_em}", err, t_k, t_p,
               dict(curve=name, K=K, emit=want_em, inv_ops=ops))


def check_tree_mid_kernel(rng, dev, results):
    """K7 against its plain version: G1 at the H1 level-1 shape (M = 8192),
    G2 at M = 256, and G1 at the 2^20 level-1 shape (M = 2^17: K = 2^21
    additions), where the plain version runs in lane slices of
    kernels_tree.PLAIN_LANES; K4 timed on the same planes beside it."""
    from groth16_tpu_torch.ops import curve as C, kernels_tree as KT
    from groth16_tpu_torch.tools import measure
    for cv, M in ((C.G1, TREE_M), (C.G2, 256), (C.G1, TREE_M_2E20)):
        apr, bpl = tree_planes(rng, cv, M, dev)
        tinv = KT.invert_kernel(cv, KT.phase_a_kernel(cv, apr, bpl))
        err = max_abs_err(KT.phase_b_kernel(cv, apr, bpl, tinv),
                          KT.phase_b_plain(cv, apr, bpl, tinv))
        t_k = cuda_ms(lambda: KT.phase_b_kernel(cv, apr, bpl, tinv), 10)
        t_p = cuda_ms(lambda: KT.phase_b_plain(cv, apr, bpl, tinv), 1)
        t_a = cuda_ms(lambda: KT.phase_a_kernel(cv, apr, bpl), 10)
        print(f"K7 {cv.name} M={M}: {t_k:.4f} ms (plain {t_p:.2f} ms; K4 on the same planes "
              f"{t_a:.4f} ms), max_abs_err {err}")
        record(results, "phase_b_kernel", f"{cv.name} M={M}", err, t_k, t_p,
               dict(curve=cv.name, M=M, dbl=measure.mid_doublings(apr, bpl)))


# (wrapper, module, the path that must launch it)
WRAPPERS = (("point_add", "kernels", "proof"), ("point_double_n", "kernels", "proof"),
            ("horner", "kernels", "proof"),
            ("fold_level_kernel", "kernels", "proof"), ("ntt_inner_kernel", "ntt", "proof"),
            ("quotient_pointwise_kernel", "ntt", "proof"),
            ("phase_a_kernel", "kernels_tree", "tree phases"),
            ("mul_rows_kernel", "kernels_tree", "proof"),
            ("invert_kernel", "kernels_tree", "proof"),
            ("level_kernel", "kernels_tree", "tree phases"),
            ("phase_b_kernel", "kernels_tree", "tree phases"),
            ("fp_mul_chain_kernel", "kernels", "fp products"),
            ("spmv_kernel", "kernels", "proof"), ("fp_neg_kernel", "kernels", "tree phases"))


def _wrappers():
    import importlib
    return [getattr(importlib.import_module(f"groth16_tpu_torch.ops.{mod}"), name)
            for name, mod, _ in WRAPPERS]


def reset_counts():
    for fn in _wrappers():
        fn.launches = 0


def read_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


def check_launched(counts: dict, path: str) -> None:
    """Raise unless every wrapper of `path` was launched in its run."""
    print(f"launches during the {path} run: " + json.dumps(counts))
    for name, _, p in WRAPPERS:
        if p == path and counts[name] == 0:
            raise AssertionError(f"kernel wrapper {name} was not launched by the {path} path")


def eager_proof(zkey, w, mask, dev):
    """The proof of witness `w` under `mask` from the core run eagerly on
    the card (`prove_core_device`, no graph): the reference the replays are
    held against."""
    import groth16_tpu_torch as G
    from groth16_tpu_torch.protocol import prover as PV
    hdr = zkey.header
    buf = PV.prove_core_device(hdr.flavour, hdr.log_domain_size, PV.zkey_device_args(zkey, dev),
                               PV.spec_args(zkey, dev), PV.to_device(w.values, dev),
                               PV.to_device(PV.mask_limbs(mask), dev))
    pi_a, pi_b, pi_c = PV.proof_points(buf.cpu())
    return G.Proof(public_io=PV.public_io(zkey, w), pi_a=pi_a, pi_b=pi_b, pi_c=pi_c)


def main_path(dev):
    """Setup on the card, zkey/wtns round trip through files, the zkey's
    upload (timed, its launches printed apart), then per flavour one proof
    from the core run eagerly on the card in its two parts, each with the
    launch counts set to 0 before it and read after it: `core_msms` (the
    SpMV, the quotient and the five MSMs) and the spec-point algebra with
    the affine conversion.  No torch.cummax call in either; each proof's
    peak device memory above what was allocated before the upload.
    Returns the launch counts of the two proofs, per flavour (flavour,
    zkey, witness, proof, peak GiB), and each flavour's `core_msms`
    launches."""
    import torch
    import groth16_tpu_torch as G
    from groth16_tpu_torch.models.circuits import synthetic_circuit
    from groth16_tpu_torch.ops import msm as M
    from groth16_tpu_torch.protocol import prover as PV
    from groth16_tpu_torch.tools.measure import cummax_callers
    r1cs, wtns = synthetic_circuit(LOG2)
    fold_launches = FOLD_MSMS_PER_PROOF * len(M.fold_schedule(1 << FOLD_LOG2))
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

    proofs, msm_counts = [], {}
    counts = {name: 0 for name, _, _ in WRAPPERS}
    for flavour, zkey, w in inputs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        static = PV.zkey_device_args(zkey, dev)
        spec = PV.spec_args(zkey, dev)
        torch.cuda.synchronize()
        print(f"upload {flavour.value}: {time.perf_counter() - t0:.3f} s (the SpMV's rows and "
              "schedule, the five point sets, the spec points' tables), launches "
              + json.dumps({k: v for k, v in read_counts().items() if v}))
        hdr = zkey.header
        witness = PV.to_device(w.values, dev)
        mask = PV.to_device(PV.mask_limbs(G.Mask(*MASK)), dev)
        reset_counts()
        t0 = time.perf_counter()
        with cummax_callers() as scans:
            msms = PV.core_msms(hdr.flavour, hdr.log_domain_size, static, witness)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            during = read_counts()
            reset_counts()
            buf = PV.proof_buffer(*PV.spec_algebra(spec, msms, mask))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        alg = read_counts()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        if scans:
            raise AssertionError(f"{flavour.value}: a proof called torch.cummax: {scans}")
        pi_a, pi_b, pi_c = PV.proof_points(buf.cpu())
        prf = G.Proof(public_io=PV.public_io(zkey, w), pi_a=pi_a, pi_b=pi_b, pi_c=pi_c)
        proofs.append((flavour, zkey, w, prf, peak))
        print(f"prove {flavour.value}, the core eagerly: SpMV, quotient and MSMs {t1 - t0:.3f} s, "
              f"algebra and affine {t2 - t1:.3f} s; peak device memory {peak:.4f} GiB above "
              f"the {base / 2**30:.4f} GiB allocated before (the zkey's upload included)")
        msm_counts[flavour.value] = during
        for k in counts:
            counts[k] += during[k] + alg[k]
        print(f"launches during the {flavour.value} proof's core_msms: " + json.dumps(during)
              + "; its algebra: " + json.dumps({k: v for k, v in alg.items() if v}))
        k1 = during["point_add"] + during["point_double_n"] + during["horner"]
        if (during["horner"] != len(PV.CHAIN_LAUNCHES) or during["point_double_n"] > 10
                or k1 >= K1_MAX_PER_PROOF):
            raise AssertionError(f"{flavour.value}: a proof's MSMs launch Horner "
                                 f"{len(PV.CHAIN_LAUNCHES)} times, at most 10 doubling chains "
                                 f"and fewer than {K1_MAX_PER_PROOF} K1 kernels (got {k1})")
        k3, pointwise = QUOTIENT_LAUNCHES[flavour.value]
        want = {"spmv_kernel": 1, "fp_neg_kernel": 0, "level_kernel": 0, "phase_a_kernel": 0,
                "invert_kernel": 0, "mul_rows_kernel": 0, "fold_level_kernel": fold_launches,
                "ntt_inner_kernel": k3, "quotient_pointwise_kernel": pointwise}
        if any(during[k] != v for k, v in want.items()):
            raise AssertionError(f"{flavour.value}: a proof's MSMs launch {want}, got "
                                 + json.dumps({k: during[k] for k in want}))
        if alg["invert_kernel"] != TO_AFFINE_PER_PROOF or alg["mul_rows_kernel"] != TO_AFFINE_PER_PROOF:
            raise AssertionError(f"{flavour.value}: the algebra runs `to_affine` "
                                 f"{TO_AFFINE_PER_PROOF} times (K6, K5), got "
                                 + json.dumps({k: alg[k] for k in ("invert_kernel",
                                                                   "mul_rows_kernel")}))

    for flavour, zkey, _, prf, _ in proofs:
        if prf.pi_a is None or prf.pi_b is None or prf.pi_c is None:
            raise AssertionError(f"{flavour.value}: proof has a point at infinity")
        if not G.verify_proof(G.extract_vkey(zkey), prf):
            raise AssertionError(f"{flavour.value}: proof does not verify")
        print(f"verify {flavour.value}: ok")
    check_launched(counts, "proof")
    return counts, proofs, msm_counts


# the profiler's kernel names of each wrapper a proof launches (one SpMV
# call is two launches)
KERNEL_NAMES = {"point_add": ("point_add_kernel",), "point_double_n": ("point_double_n_kernel",),
                "horner": ("horner_kernel",), "fold_level_kernel": ("fold_kernel",),
                "ntt_inner_kernel": ("ntt_step_kernel",),
                "quotient_pointwise_kernel": ("quotient_pointwise_kernel",),
                "invert_kernel": ("tree_invert_kernel",),
                "mul_rows_kernel": ("tree_mul_rows_kernel",),
                "level_kernel": ("tree_level_kernel",),
                "spmv_kernel": ("spmv_entries_kernel", "spmv_finish_kernel"),
                "fp_neg_kernel": ("fp_neg_kernel",)}
FUSED_RUNS = 5      # replays and eager cores timed in turns, each
LOG2_FUSED_BIG = 18  # one fused proof above the JAX package's fused cap (2^16)
FUSED_BIG_RUNS = 3
TOP_GAPS = 5        # idle gaps of a replay printed


def expect_kernels(counts: dict) -> dict:
    """The launches a trace must hold of each kernel name, from wrapper
    launch counts."""
    return {k: counts[w] for w, names in KERNEL_NAMES.items() for k in names}


def no_copies(what):
    """A report that fails if a trace holds a copy between host and card."""
    def report(names):
        copies = [k for k in names if "htod" in k.lower() or "dtoh" in k.lower()]
        if copies:
            raise AssertionError(f"{what} copied between host and card: {copies}")
    return report


def replay_report(what):
    """A report of one traced replay: the device's busy time (the union of
    its kernel and copy intervals) against the span from its first start
    to its last end and against the host's wall time of the call, the idle
    gaps between them and device time by kernel."""
    from groth16_tpu_torch.tools.measure import busy_us

    def report(events, wall):
        iv = sorted((e.time_range.start, e.time_range.end, e.name) for e in events)
        busy = busy_us((a, b) for a, b, _ in iv)
        gaps, end, prev = [], iv[0][1], iv[0][2]
        for a, b, name in iv[1:]:
            if a > end:
                gaps.append((a - end, prev, name))
            if b >= end:
                end, prev = b, name
        span = end - iv[0][0]
        by_name = {}
        for a, b, name in iv:
            key = name.split("(")[0].replace("void ", "")[:48]
            n, t = by_name.get(key, (0, 0.0))
            by_name[key] = (n + 1, t + (b - a))
        print(f"{what}: device busy {busy / 1e3:.4f} ms of a {span / 1e3:.4f} ms device span "
              f"({100 * busy / span:.1f} %), {wall * 1e3:.3f} ms host wall under the profiler "
              f"({100 * busy / 1e3 / (wall * 1e3):.1f} %); {len(iv)} device events, {len(gaps)} "
              f"idle gaps, {sum(g for g, _, _ in gaps) / 1e3:.4f} ms idle in all; largest: "
              + "; ".join(f"{g:.1f} us after {p.split('(')[0][:40]} before {q.split('(')[0][:40]}"
                          for g, p, q in sorted(gaps, reverse=True)[:TOP_GAPS]))
        print(f"{what}, device ms by kernel (launches): "
              + "; ".join(f"{k} {t / 1e3:.4f} ({n})"
                          for k, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])))
    return report


def fused_phase(dev, singles, msm_counts):
    """The proof's CUDA graph (prover.FusedProof: one graph a proof) of the
    2^16 proof in both flavours:
      - a FusedProof warmed up, then captured with every launch count set to
        0 just before: the capture must launch what `core_msms` launched in
        `main_path` plus what the spec-point algebra and its two
        `to_affine` launch, counted on their own over the core's MSM
        results; no torch.cummax; the capture's time and the memory
        allocated after it printed;
      - the algebra alone: CUDA events around an eager call and around the
        replay of a graph of it, and its device time from the profiles;
      - proofs through generate_proof_with_mask on its default path: the
        first captures the zkey's graph (capture_s), then the main witness
        under MASK and BATCH_SEEDS' witnesses under their masks replay it,
        each with no kernel wrapper called and no torch.cummax, each
        byte-equal to the proof of the core run eagerly on the card
        (`eager_proof`) and verifying; one capture a flavour;
      - proof wall times through the entry point (a replay) and of the core
        run eagerly, FUSED_RUNS each, in turns;
      - one replay registered for the profiles phase twice: its kernels must
        be the capture's launches with no host copy, and its busy share,
        idle gaps and device time by kernel are printed.
    Returns the captures' launch counts, summed over the flavours."""
    import statistics
    import torch
    import groth16_tpu_torch as G
    from groth16_tpu_torch.models.circuits import synthetic_circuit
    from groth16_tpu_torch.protocol import prover as PV
    from groth16_tpu_torch.tools import measure
    from groth16_tpu_torch.tools.measure import cummax_callers
    ws = [synthetic_circuit(LOG2, seed)[1] for seed in BATCH_SEEDS]
    masks = [G.Mask(MASK[0] + i, MASK[1] + 3 * i) for i in range(len(ws))]
    total = {}
    for flavour, zkey, w, prf, _ in singles:
        name = flavour.value
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base, pool = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        fp = PV.FusedProof(zkey, dev)
        fp.warm_up()
        t1 = time.perf_counter()
        reset_counts()
        with cummax_callers() as scans:
            fp.capture()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        captured = read_counts()
        held = (torch.cuda.memory_allocated() - base) / 2**30
        pool = (torch.cuda.memory_reserved() - pool) / 2**30
        if scans:
            raise AssertionError(f"{name}: the capture called torch.cummax: {scans}")
        for k, v in captured.items():
            total[k] = total.get(k, 0) + v

        msms = PV.core_msms(fp.flavour, fp.log2n, fp.static, fp.witness)

        def algebra(fp=fp, msms=msms):
            return PV.proof_buffer(*PV.spec_algebra(fp.spec, msms, fp.mask))

        algebra()
        reset_counts()
        algebra()
        alg = read_counts()
        want = {k: msm_counts[name][k] + alg[k] for k in captured}
        print(f"fused {name}: warm-up {t1 - t0:.3f} s, capture {t2 - t1:.3f} s; after it "
              f"{held:.4f} GiB more allocated (the static buffers and the proof buffer), "
              f"{pool:.4f} GiB more reserved (with the graph's pool); "
              f"launches at capture " + json.dumps({k: v for k, v in captured.items() if v})
              + "; the algebra's " + json.dumps({k: v for k, v in alg.items() if v}))
        if captured != want:
            raise AssertionError(f"{name}: the capture launched {captured}, not core_msms' "
                                 f"plus the algebra's {want}")
        t_eager = cuda_ms(algebra, 10)
        g_alg = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g_alg):
            algebra()
        t_graph = cuda_ms(g_alg.replay, 20)
        print(f"fused {name}: the spec-point algebra {t_eager:.4f} ms eager, {t_graph:.4f} ms "
              "as a graph replay (CUDA events)")

        def alg_report(names, name=name):
            no_copies(f"the {name} algebra")(names)
            print(f"fused {name}: the spec-point algebra {sum(us for _, us in names.values()) / 1e3:.4f}"
                  f" ms device time (kernels of one graph replay)")

        defer_profile(f"the spec-point algebra ({name}), one graph replay", g_alg.replay,
                      expect_kernels(alg), ("",), alg_report)

        captures = PV.fused_graph.captures
        tm = {}
        first = G.generate_proof_with_mask(zkey, w, G.Mask(*MASK), dev, tm)
        if (first.pi_a, first.pi_b, first.pi_c) != (prf.pi_a, prf.pi_b, prf.pi_c):
            raise AssertionError(f"{name}: the first fused proof differs from the eager core's")
        print(f"fused {name}, first proof through the entry point (captures): "
              + ", ".join(f"{k} {v:.4f}" for k, v in tm.items())
              + f" s; {torch.cuda.memory_allocated() / 2**30:.4f} GiB allocated after it")
        vkey = G.extract_vkey(zkey)
        for i, (wi, mi) in enumerate([(w, G.Mask(*MASK))] + list(zip(ws, masks))):
            reset_counts()
            with cummax_callers() as scans:
                got = G.generate_proof_with_mask(zkey, wi, mi, dev)
            called = {k: v for k, v in read_counts().items() if v}
            if called or scans:
                raise AssertionError(f"{name}: replay {i} called wrappers {called} or "
                                     f"torch.cummax {scans}")
            want_prf = prf if i == 0 else eager_proof(zkey, wi, mi, dev)
            if (got.pi_a, got.pi_b, got.pi_c) != (want_prf.pi_a, want_prf.pi_b, want_prf.pi_c):
                raise AssertionError(f"{name}: replay {i} differs from the eager core's proof")
            if not G.verify_proof(vkey, got):
                raise AssertionError(f"{name}: replay {i} does not verify")
        if PV.fused_graph.captures != captures + 1:
            raise AssertionError(f"{name}: {PV.fused_graph.captures - captures} captures, not 1")
        print(f"fused {name}: {1 + len(ws)} replays (main witness, seeds {BATCH_SEEDS}) equal "
              "the eager core's proofs and verify; no wrapper call, no cummax; one capture")

        walls = {"fused": [], "eager core": []}
        for _ in range(FUSED_RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            G.generate_proof_with_mask(zkey, w, G.Mask(*MASK), dev)
            torch.cuda.synchronize()
            walls["fused"].append(time.perf_counter() - t)
            torch.cuda.synchronize()
            t = time.perf_counter()
            PV.prove_core_device(fp.flavour, fp.log2n, fp.static, fp.spec, fp.witness, fp.mask)
            issued = time.perf_counter() - t
            torch.cuda.synchronize()
            walls["eager core"].append(time.perf_counter() - t)
            walls.setdefault("eager issue", []).append(issued)
        med = {k: statistics.median(v) for k, v in walls.items()}
        print(measure.card_line(dev))
        print(f"fused {name}: proof wall s, in turns: replay "
              + ", ".join(f"{t:.4f}" for t in walls["fused"]) + "; the core eagerly "
              + ", ".join(f"{t:.4f}" for t in walls["eager core"])
              + f" (launches issued in {med['eager issue']:.4f} s); medians "
              f"{med['fused']:.4f} / {med['eager core']:.4f} s "
              f"({med['eager core'] / med['fused']:.2f}x)")

        fp.load(w, G.Mask(*MASK))

        def replay(fp=fp):
            t = time.perf_counter()
            fp.graph.replay()
            torch.cuda.synchronize()
            return time.perf_counter() - t

        defer_profile(f"one replay of the fused {name} proof", replay, expect_kernels(captured),
                      ("",), no_copies(f"the {name} replay"))
        defer_profile(f"one replay of the fused {name} proof (timeline)", replay, None, (),
                      replay_report(f"replay {name}"))
    return total


def fused_big_phase(dev):
    """One Snarkjs proof of synthetic_circuit(LOG2_FUSED_BIG), above the
    JAX package's fused-module cap of 2^16, through the entry point (one
    graph replay) against the core run eagerly on the card: equal and
    verifying; the setup, the capture and the memory the graph's pool
    reserves printed, and FUSED_BIG_RUNS proofs of each timed in turns."""
    import statistics
    import torch
    import groth16_tpu_torch as G
    from groth16_tpu_torch.models.circuits import synthetic_circuit
    r1cs, w = synthetic_circuit(LOG2_FUSED_BIG)
    t0 = time.perf_counter()
    zkey = G.fake_circuit_setup(r1cs, G.ToxicWaste(**TOXIC), G.Flavour.Snarkjs, dev)
    setup_s = time.perf_counter() - t0
    eager = eager_proof(zkey, w, G.Mask(*MASK), dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool = torch.cuda.memory_reserved()
    tm = {}
    fused = G.generate_proof_with_mask(zkey, w, G.Mask(*MASK), dev, tm)
    pool = (torch.cuda.memory_reserved() - pool) / 2**30
    if (fused.pi_a, fused.pi_b, fused.pi_c) != (eager.pi_a, eager.pi_b, eager.pi_c):
        raise AssertionError(f"the fused 2^{LOG2_FUSED_BIG} proof differs from the eager core's")
    if not G.verify_proof(G.extract_vkey(zkey), fused):
        raise AssertionError(f"the fused 2^{LOG2_FUSED_BIG} proof does not verify")
    runs = {"eager core": lambda: eager_proof(zkey, w, G.Mask(*MASK), dev),
            "fused": lambda: G.generate_proof_with_mask(zkey, w, G.Mask(*MASK), dev)}
    walls = {k: [] for k in runs}
    for _ in range(FUSED_BIG_RUNS):
        for kind, fn in runs.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t)
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(f"fused 2^{LOG2_FUSED_BIG} snarkjs (nvars {zkey.header.nvars}; setup {setup_s:.2f} s on "
          f"the card): equals the eager core's proof and verifies; first fused proof "
          + ", ".join(f"{k} {v:.4f}" for k, v in tm.items())
          + f" s, {pool:.4f} GiB more reserved; proof wall s, in turns: the core eagerly "
          + ", ".join(f"{t:.4f}" for t in walls["eager core"]) + "; fused "
          + ", ".join(f"{t:.4f}" for t in walls["fused"])
          + f"; medians {med['eager core']:.4f} / {med['fused']:.4f} s "
          f"({med['eager core'] / med['fused']:.2f}x)")


def fp_product_path(dev, results):
    """tools/bench_mul_kernels.run with the launch counts around it."""
    from groth16_tpu_torch.tools import bench_mul_kernels as BM, measure
    reset_counts()
    res = BM.run(256, device=dev)
    counts = read_counts()
    check_launched(counts, "fp products")
    record(results, "fp_mul_chain_kernel", f"k={res['k']} n={res['n']}", res["max_abs_err"],
           res["ms"], res["plain_ms"], dict(k=res["k"], n=res["n"]))
    print(f"K9 phase: {res['gproducts_per_s']:.2f} G products/s; one product is "
          f"{res['sass_imad_class']} IMAD-class opcodes ({res['sass_multiplies']} multiplies) of "
          f"{res['sass_instructions']}; issues an SM a clock "
          + json.dumps({k: round(v, 2) for k, v in res["issue_rates_per_sm_clock"].items()})
          + f", widening products {res['wide_per_sm_clock']:.2f} (the bound takes "
          f"{measure.WIDE_PER_SM_PER_CLOCK})")
    return counts, res


def tree_phase_path(dev, results):
    """tools/bench_tree_phases.run at 2^20 with the launch counts around it;
    the run holds its level-1 mid (K7) against the plain version and the
    halvings (K5) + narrow inversion against the one wide K6 launch."""
    from groth16_tpu_torch.tools import bench_tree_phases as BT
    reset_counts()
    res = BT.run(LOG2_PHASES, 4, dev)
    counts = read_counts()
    check_launched(counts, "tree phases")
    record(results, "phase_b_kernel", f"G1 M={res['mid_lanes']} in the 2^20 run",
           res["mid_max_abs_err"], None, None)
    return counts


def fold_phase_path(dev):
    """tools/bench_fold_phases.run: the 2^20 fold MSM phase by phase (its
    result must equal msm.msm's)."""
    from groth16_tpu_torch.tools import bench_fold_phases as BF
    return BF.run(LOG2_FOLD_PHASES, dev)


def chunked_msm(rng, dev):
    """msm_chunked over 2^21 host-numpy points in segments of 2^20 against the
    unchunked msm on the device; each timed on the host clock around a
    synchronize after one warm-up run, the chunked one with its host-to-device
    copies."""
    import torch
    from groth16_tpu_torch.ops import curve as C, field as F, msm as M
    from groth16_tpu_torch.tools.bench_tree_phases import make_points
    n = 1 << LOG2_CHUNKED
    P = make_points(n, dev)
    s = random_scalars(rng, n, dev)
    host_s, host_P = s.cpu().numpy(), tuple(c.cpu().numpy() for c in P)
    runs = {"msm": lambda: M.msm(C.G1, s, P, affine=True),
            "msm_chunked": lambda: M.msm_chunked(C.G1, host_s, host_P, chunk_log2=20,
                                                 device=dev)}
    out = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[name] = C.to_affine(C.G1, res)
        print(f"{name} n=2^{LOG2_CHUNKED}: {wall * 1e3:.1f} ms, peak device memory "
              f"{peak:.3f} GiB ({base:.3f} GiB allocated before)")
    if not all(torch.equal(F.as_i32(a), F.as_i32(b))
               for a, b in zip(out["msm"], out["msm_chunked"])):
        raise AssertionError("msm_chunked differs from the unchunked msm")
    c_seg, c_all = M.pick_window_bits(1 << 20), M.pick_window_bits(n)
    print(f"msm_chunked == msm at 2^{LOG2_CHUNKED} (c = {c_seg} per segment, {c_all} unchunked)")


def torch_from(a, dev):
    import torch
    return torch.from_numpy(a).to(dev)


def check_spmv_kernel(rng, dev, results, zkey, wtns):
    """The SpMV kernel against `spmv_plain` on the card, bit-exact, at the
    2^16 proof's coefficients (the zkey's device cache, the proof's witness)
    and at the seeded dense and power-law sets of tools/bench_spmv.py; each
    timed with CUDA events, the plain version timed, the bound, its share
    and the longest row printed, and its device time (both launches) from
    one profiled call that may run nothing else, in the profiles phase;
    then the Fp negation
    against `fp_neg_plain` at NEG_POINTS G1 coordinates, every 16th an
    infinity (0), and on G2-shaped coordinates."""
    import torch
    from groth16_tpu_torch.ops import kernels as KN
    from groth16_tpu_torch.protocol.prover import zkey_device_args
    import functools
    from groth16_tpu_torch.tools import bench_spmv, measure
    clock = measure.sm_clock_max_mhz()
    cases = [("2^16 proof", torch_from(wtns.values, dev), zkey_device_args(zkey, dev).rows),
             bench_spmv.rows_on(dev, bench_spmv.dense_set(rng, **bench_spmv.DENSE)),
             bench_spmv.rows_on(dev, bench_spmv.power_law_set(rng, **bench_spmv.POWER_LAW))]
    for name, w, m in cases:
        err = max_abs_err(KN.spmv_kernel(w, m), KN.spmv_plain(w, m))
        fn = functools.partial(KN.spmv_kernel, w, m)
        t_k = cuda_ms(fn, 20)
        t_p = cuda_ms(lambda: KN.spmv_plain(w, m), 2)
        st = bench_spmv.set_stats(w, m)
        shape = dict(n_rows=st["n_rows"], nnz=st["nnz"], nvars=st["nvars"])
        b, side = measure.bound_ms(*measure.work("spmv_kernel", **shape), clock)
        sc = m.schedule
        print(f"SpMV {name}: {st['n_rows']} rows, {st['nnz']} entries, witness {st['nvars']}, "
              f"longest row {st['longest']}, empty rows {st['empty']}, E={sc.E} "
              f"block={sc.block} finish={sc.finish_block}, {sc.carry_row.numel()} carries: "
              f"{t_k:.4f} ms events (plain {t_p:.2f} ms), bound {b:.5f} ms ({side}), "
              f"{100 * b / t_k:.1f} % of the bound by events, max_abs_err {err}")

        def report(names, name=name, b=b):
            dev_ms = sum(us for _, us in names.values()) / 1e3
            print(f"SpMV {name}: {dev_ms:.4f} ms device, both launches; bound {b:.5f} ms, "
                  f"{100 * b / dev_ms:.1f} % of the bound by device time")

        defer_profile(f"SpMV {name}", fn, {"spmv_entries_kernel": 1, "spmv_finish_kernel": 1},
                      (), report)
        record(results, "spmv_kernel", f"{name} rows={m.n_rows} nnz={st['nnz']}", err, t_k, t_p,
               shape)
    y = random_scalars(rng, NEG_POINTS, dev)
    y.view(torch.int32)[::16] = 0
    for shape in ((NEG_POINTS, 16), (NEG_POINTS // 2, 2, 16)):
        x = y.reshape(shape)
        err = max_abs_err(KN.fp_neg_kernel(x), KN.fp_neg_plain(x))
        print(f"Fp negation {tuple(shape)} with infinities: max_abs_err {err}")
    t_k = cuda_ms(lambda: KN.fp_neg_kernel(y), 20)
    t_p = cuda_ms(lambda: KN.fp_neg_plain(y), 5)
    print(f"Fp negation G1 n={NEG_POINTS}: {t_k:.4f} ms (plain {t_p:.2f} ms)")
    record(results, "fp_neg_kernel", f"G1 n={NEG_POINTS}", err, t_k, t_p, dict(n=NEG_POINTS))


def batch_phase(dev, zkey):
    """generate_proofs over BATCH_SEEDS' witnesses with fixed masks against
    a fresh parse of the zkey's file (the first proof captures the graph,
    the rest replay it): one upload, each proof verified and equal to its
    single proof and to the eager core's proof (`eager_proof`); per-proof
    times and proofs/s printed."""
    import groth16_tpu_torch as G
    import torch
    from groth16_tpu_torch.models.circuits import synthetic_circuit
    from groth16_tpu_torch.protocol.prover import zkey_device_args
    from groth16_tpu_torch.tools import measure
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "c.zkey")
        G.write_zkey(path, zkey)
        fresh = G.parse_zkey(path)
    fresh.header.flavour = zkey.header.flavour
    ws = [synthetic_circuit(LOG2, seed)[1] for seed in BATCH_SEEDS]
    masks = [G.Mask(MASK[0] + i, MASK[1] + 3 * i) for i in range(len(ws))]
    builds = zkey_device_args.builds
    timings = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = G.generate_proofs(fresh, ws, dev, masks, timings)
    wall = time.perf_counter() - t0
    if zkey_device_args.builds != builds + 1:
        raise AssertionError(f"the batch uploaded the zkey {zkey_device_args.builds - builds} "
                             "times, not once")
    vkey = G.extract_vkey(fresh)
    for i, (w, m, prf) in enumerate(zip(ws, masks, batch)):
        if not G.verify_proof(vkey, prf):
            raise AssertionError(f"batch proof {i} does not verify")
        one = G.generate_proof_with_mask(fresh, w, m, dev)
        eager = eager_proof(fresh, w, m, dev)
        if not ((prf.pi_a, prf.pi_b, prf.pi_c) == (one.pi_a, one.pi_b, one.pi_c)
                == (eager.pi_a, eager.pi_b, eager.pi_c)):
            raise AssertionError(f"batch proof {i} differs from its single proof or from the "
                                 "eager core's")
    if len({prf.pi_a for prf in batch}) != len(batch):
        raise AssertionError("the batch's witnesses gave equal proofs")
    print(measure.card_line(dev))
    totals = [t["total_s"] for t in timings]
    first = ", ".join(f"{k} {timings[0][k]:.4f}" for k in ("upload_s", "capture_s")
                      if k in timings[0])
    print(f"batch of {len(batch)} 2^{LOG2} proofs ({fresh.header.flavour.value}): "
          f"first {totals[0]:.4f} s ({first}), then "
          + ", ".join(f"{t:.4f}" for t in totals[1:]) + " s (uploads "
          + ", ".join(f"{t['upload_s']:.4f}" for t in timings[1:])
          + f" s); {len(batch) / wall:.2f} proofs/s over the batch's {wall:.3f} s, "
          f"{(len(batch) - 1) / sum(totals[1:]):.2f} proofs/s after the first")
    print("each batch proof verifies and equals its single proof and the eager core's; "
          "one zkey upload")


# The sharded phases (groth16_tpu_torch/parallel): the kernels every
# rank's proof must launch
SHARD_KERNELS = ("spmv_kernel", "ntt_inner_kernel", "quotient_pointwise_kernel", "point_add",
                 "horner", "fold_level_kernel", "invert_kernel", "mul_rows_kernel")
GLOO_RANKS = 2            # ranks sharing the one card over gloo
LOG2_SHARD = 20           # the sharded NTT and MSM
SHARD_STEP_SIZES = (16, 20)


def sharded_proof_rank(mesh, zpaths, wpath, out):
    """One rank of a sharded-proof phase: for each flavour's zkey file, two
    proofs sharded over the ranks with MASK, the first uploading the rank's
    part of the zkey and building its tables, the second with every launch
    count set to 0 before it and read after it and torch.cummax counted;
    the collectives timed (`mesh.timed`); the peak device memory over both
    above what was allocated before them.  The rank verifies its proof and
    writes what it saw to out/rank<r>.json."""
    import torch
    import groth16_tpu_torch as G
    from groth16_tpu_torch.parallel.prover_shard import generate_proof_sharded
    from groth16_tpu_torch.tools.measure import cummax_callers
    mesh.timed = True
    w = G.parse_witness(wpath)
    res = {}
    for value, zpath in zpaths:
        zkey = G.parse_zkey(zpath)
        zkey.header.flavour = G.Flavour(value)
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        base = torch.cuda.memory_allocated(mesh.device)
        cold, warm = {}, {}
        generate_proof_sharded(zkey, w, G.Mask(*MASK), mesh, cold)
        reset_counts()
        with cummax_callers() as scans:
            prf = generate_proof_sharded(zkey, w, G.Mask(*MASK), mesh, warm)
        counts = read_counts()
        res[value] = dict(proof=repr((prf.pi_a, prf.pi_b, prf.pi_c)), cold=cold, warm=warm,
                          counts=counts, cummax=sum(scans.values()),
                          verifies=G.verify_proof(G.extract_vkey(zkey), prf),
                          peak_gib=(torch.cuda.max_memory_allocated(mesh.device) - base) / 2**30)
    with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as fh:
        json.dump(res, fh)


def sharded_proof_phase(singles, backend, world, devices, tmp) -> dict:
    """The 2^16 proof of both flavours sharded over `world` ranks
    (`sharded_proof_rank`, launch.spawn): every rank's proof must equal the
    single-card proof and verify, call torch.cummax 0 times and launch the
    sharded path's kernels.  Prints each rank's phase times, collective
    times, launches and peak memory against the single proof's.  Returns
    rank 0's launches, summed over the flavours."""
    import groth16_tpu_torch as G
    from groth16_tpu_torch.parallel import launch
    wpath = os.path.join(tmp, "circuit.wtns")
    if not os.path.exists(wpath):
        G.write_witness(wpath, singles[0][2].values)
    zpaths = []
    for flavour, zkey, _, _, _ in singles:
        zpaths.append((flavour.value, os.path.join(tmp, f"{flavour.value}.zkey")))
        if not os.path.exists(zpaths[-1][1]):
            G.write_zkey(zpaths[-1][1], zkey)
    out = tempfile.mkdtemp(dir=tmp)
    launch.spawn(sharded_proof_rank, world, backend, devices, zpaths, wpath, out)
    route = "host-staged" if backend == "gloo" else "on the card"
    total = {}
    for rank in range(world):
        with open(os.path.join(out, f"rank{rank}.json")) as fh:
            res = json.load(fh)
        for flavour, _, _, prf, peak in singles:
            r = res[flavour.value]
            want = repr((prf.pi_a, prf.pi_b, prf.pi_c))
            if r["proof"] != want or not r["verifies"]:
                raise AssertionError(f"rank {rank}/{world} {flavour.value}: the sharded proof "
                                     "differs from the single-card proof or does not verify")
            if r["cummax"]:
                raise AssertionError(f"rank {rank}/{world} {flavour.value}: {r['cummax']} "
                                     "torch.cummax calls")
            missing = [k for k in SHARD_KERNELS if not r["counts"][k]]
            if missing:
                raise AssertionError(f"rank {rank}/{world} {flavour.value}: {missing} not launched")
            w = r["warm"]
            print(f"rank {rank}/{world} {backend} ({devices[rank % len(devices)]}) "
                  f"{flavour.value}: proof equals the single-card proof, verifies, 0 cummax; "
                  + ", ".join(f"{k} {v:.4f}" for k, v in w.items())
                  + f" s (comm_s: backend {backend}, {route}; first proof "
                  f"{r['cold']['total_s']:.4f} s, upload {r['cold']['upload_s']:.4f} s); peak "
                  f"device memory {r['peak_gib']:.4f} GiB against the single proof's "
                  f"{peak:.4f} GiB")
            print(f"launches, rank {rank}/{world} {flavour.value}: "
                  + json.dumps({k: v for k, v in r["counts"].items() if v}))
            if rank == 0:
                for k, v in r["counts"].items():
                    total[k] = total.get(k, 0) + v
    return total


def sharded_ntt_msm_rank(mesh, out):
    """One rank of the 2^LOG2_SHARD phase: four_step_ntt / four_step_intt
    of its slab against ops/ntt.py `transform` of the whole vector, and the
    G1 msm_sharded of its slab of 2^LOG2_SHARD affine points against the
    single-card msm, after affine; each timed with CUDA events (mean of 3
    after a warm-up) beside the single-card call, with the collectives'
    share of the sharded time."""
    import numpy as np
    import torch
    from groth16_tpu_torch.ops import curve as C, msm as M, ntt as NT
    from groth16_tpu_torch.parallel import msm_shard, ntt_shard
    from groth16_tpu_torch.parallel.mesh import shard_range
    from groth16_tpu_torch.tools.bench_tree_phases import make_points
    dev, n = mesh.device, 1 << LOG2_SHARD
    dom = NT.Domain(LOG2_SHARD)
    lo, hi = shard_range(n, mesh.rank, mesh.size)
    mesh.timed = True
    x = random_scalars(np.random.default_rng(SEED + 1), n, dev)
    res = {}

    def timed(fn):
        mesh.comm_s = 0.0
        ms = cuda_ms(fn, 3)
        return ms, mesh.comm_s * 1e3 / 4 / ms        # four calls: the warm-up and three

    for kind, fn in (("forward", ntt_shard.four_step_ntt), ("inverse", ntt_shard.four_step_intt)):
        want = NT.transform(x[None], LOG2_SHARD, kind)[0][lo:hi]
        exact = torch.equal(fn(dom, mesh, x[lo:hi]).view(torch.int32), want.view(torch.int32))
        ms, share = timed(lambda: fn(dom, mesh, x[lo:hi]))
        single = cuda_ms(lambda: NT.transform(x[None], LOG2_SHARD, kind), 3)
        res[kind] = dict(exact=exact, ms=ms, comm_share=share, single_ms=single)
    P = make_points(n, dev)
    s = random_scalars(np.random.default_rng(SEED + 2), n, dev)
    want = C.to_affine(C.G1, tuple(c[None] for c in M.msm(C.G1, s, P, affine=True)))
    slab = tuple(c[lo:hi] for c in P)
    got = msm_shard.msm_sharded(C.G1, mesh, s[lo:hi], slab, affine=True)
    exact = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want))
    ms, share = timed(lambda: msm_shard.msm_sharded(C.G1, mesh, s[lo:hi], slab, affine=True))
    single = cuda_ms(lambda: C.to_affine(C.G1, tuple(c[None] for c in M.msm(C.G1, s, P,
                                                                            affine=True))), 3)
    res["msm G1"] = dict(exact=exact, ms=ms, comm_share=share, single_ms=single)
    with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as fh:
        json.dump(res, fh)


def sharded_ntt_msm_phase(dev, tmp):
    """`sharded_ntt_msm_rank` on GLOO_RANKS ranks sharing the card: each
    result must equal the single-card one bit for bit."""
    from groth16_tpu_torch.parallel import launch
    out = tempfile.mkdtemp(dir=tmp)
    launch.spawn(sharded_ntt_msm_rank, GLOO_RANKS, "gloo", [dev], out)
    for rank in range(GLOO_RANKS):
        with open(os.path.join(out, f"rank{rank}.json")) as fh:
            res = json.load(fh)
        for what, r in res.items():
            if not r["exact"]:
                raise AssertionError(f"rank {rank}: the sharded {what} at 2^{LOG2_SHARD} differs "
                                     "from the single-card result")
            print(f"sharded {what} 2^{LOG2_SHARD}, rank {rank}/{GLOO_RANKS} (gloo, host-staged, "
                  f"both ranks on one card): {r['ms']:.3f} ms events, collectives "
                  f"{100 * r['comm_share']:.1f} %; single card {r['single_ms']:.3f} ms; equal")


def check_sharded_steps(rng, dev, results):
    """K3 at rank 1's local steps of two ranks (parallel/ntt_shard.steps: the
    split strides, the slabs of the outer twiddles and of the eta tables)
    for the sharded quotient's transforms at 2^16 and 2^20, against
    `ntt_inner_plain` on the card on the same inputs, bit-exact; timed."""
    from groth16_tpu_torch.ops import ntt as NT
    from groth16_tpu_torch.parallel import ntt_shard
    d, r = 2, 1
    for log2n in SHARD_STEP_SIZES:
        eta = NT.Domain(log2n + 1).gen
        m = (1 << log2n) // d
        for kind, B in (("inverse_to_coset", 3), ("forward", 3), ("inverse_from_coset_std", 1)):
            for j, st in enumerate(ntt_shard.steps(log2n, d, r, kind, B, dev, eta)):
                wire_in = kind == "inverse_to_coset" and j == 0
                wire_out = kind == "inverse_from_coset_std" and j == 1
                x = random_scalars(rng, B * m, dev).reshape(B, m, 16)
                x = x if wire_in else NT.pack(x)
                got = NT.ntt_inner_kernel(x, st, wire_out)
                plain = {}
                t_p = cuda_ms(lambda: plain.setdefault("out", NT.ntt_inner_plain(x, st, wire_out)),
                              1, warmup=False)
                err = max_abs_err(got, plain["out"])
                t_k = cuda_ms(lambda: NT.ntt_inner_kernel(x, st, wire_out), 10)
                name = (f"sharded 2^{log2n} rank {r} of {d} {kind} step {j + 1} T={st.T} "
                        f"NB={st.NB} B={B}")
                print(f"K3 {name}: {t_k:.4f} ms (plain {t_p:.2f} ms), max_abs_err {err}")
                record(results, "ntt_inner_kernel", name, err, t_k, t_p,
                       dict(T=st.T, NB=st.NB, B=B, pre=False, post=st.post is not None,
                            wire_in=wire_in, wire_out=wire_out))


def cli_phase():
    """The CLI as a user runs it, in a subprocess on the card: setup, prove
    and verify from the 2^16 circuit's files (exit 0), then a tampered
    witness against the written zkey (exit 2), then the sharded proof of the
    written zkey under torchrun, one NCCL rank a card (exit 0)."""
    import subprocess
    import torch
    import groth16_tpu_torch as G
    from groth16_tpu_torch.models.circuits import synthetic_circuit
    r1cs, wtns = synthetic_circuit(LOG2)
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        f = {k: os.path.join(tmp, k) for k in ("c.r1cs", "c.wtns", "bad.wtns", "c.zkey",
                                              "proof.json", "public.json")}
        G.write_r1cs(f["c.r1cs"], r1cs)
        G.write_witness(f["c.wtns"], wtns.values)
        bad = wtns.values.copy()
        bad[1, 0] = (bad[1, 0] + 1) & 0xFFFF          # the public output changed
        G.write_witness(f["bad.wtns"], bad)
        cli = [sys.executable, "-m", "groth16_tpu_torch"]
        torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                    f"--nproc-per-node={torch.cuda.device_count()}", "-m",
                    "groth16_tpu_torch.parallel.launch"]
        runs = (("setup, prove, verify", 0,
                 cli + ["--setup", "--prove", "--verify", "-t", "-r", f["c.r1cs"], "-w",
                        f["c.wtns"], "-o", f["proof.json"], "-i", f["public.json"],
                        "--write-zkey", f["c.zkey"]]),
                ("tampered witness", 2,
                 cli + ["--prove", "--verify", "-t", "-z", f["c.zkey"], "-w", f["bad.wtns"]]),
                ("sharded proof under torchrun, NCCL, one rank a card", 0,
                 torchrun + ["--zkey", f["c.zkey"], "--wtns", f["c.wtns"], "--verify"]))
        for what, want, args in runs:
            t0 = time.perf_counter()
            out = subprocess.run(args, cwd=root, capture_output=True, text=True, timeout=600)
            lines = [ln for ln in out.stdout.splitlines()
                     if "took" in ln or "succeeded" in ln or "proof in" in ln]
            print(f"CLI {what}: exit {out.returncode} in {time.perf_counter() - t0:.1f} s; "
                  + "; ".join(lines))
            ok = f"verification succeeded = {want == 0}" in out.stdout
            if out.returncode != want or not ok:
                raise AssertionError(f"CLI {what}: exit {out.returncode}, want {want}\n"
                                     f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    import numpy as np
    from groth16_tpu_torch.ops import cuda
    from groth16_tpu_torch.tools import measure

    dev = torch.device("cuda", 0)
    print(measure.card_line(dev))         # nvidia-smi: name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cuda.lib()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc {cuda.build_seconds:.1f} s)")

    rng = np.random.default_rng(SEED)
    results = {}
    counts = {}

    def phase(name, fn):
        t = time.perf_counter()
        out = fn()
        print(f"phase {name}: {time.perf_counter() - t:.1f} s wall", flush=True)
        return out

    phase("K1 check", lambda: check_point_kernel(rng, dev, results))
    phase("K2 check", lambda: check_fold_kernel(dev, results))
    phase("K3 check", lambda: check_ntt_kernel(rng, dev, results))
    phase("K4-K6, K8 check", lambda: check_tree_kernels(rng, dev, results))
    phase("to_affine check", lambda: check_to_affine(rng, dev))
    counts["proof"], singles, msm_counts = phase("proofs", lambda: main_path(dev))
    counts["fused"] = phase("fused proofs", lambda: fused_phase(dev, singles, msm_counts))
    phase(f"fused proof at 2^{LOG2_FUSED_BIG}", lambda: fused_big_phase(dev))
    zkey, wtns = singles[0][1], singles[0][2]
    phase("SpMV and Fp negation check", lambda: check_spmv_kernel(rng, dev, results, zkey, wtns))
    phase("quotient profile", lambda: profile_quotient(rng, dev))
    phase("points_to_host profile", lambda: profile_to_host(rng, dev, zkey))
    phase("quotient 2^16 and 2^20", lambda: quotient_phase(rng, dev, results))
    phase("K7 check", lambda: check_tree_mid_kernel(rng, dev, results))
    counts["fp products"], k9 = phase("K9 Fp-product run", lambda: fp_product_path(dev, results))
    counts["tree phases"] = phase("2^20 tree-phase run", lambda: tree_phase_path(dev, results))
    phase("2^20 fold-phase run", lambda: fold_phase_path(dev))
    phase("msm_chunked 2^21", lambda: chunked_msm(rng, dev))
    phase("batch of four proofs", lambda: batch_phase(dev, zkey))
    phase("K3 at rank 1's sharded steps", lambda: check_sharded_steps(rng, dev, results))
    with tempfile.TemporaryDirectory() as tmp:
        counts["sharded"] = phase(
            f"sharded proof, {GLOO_RANKS} ranks on one card (gloo)",
            lambda: sharded_proof_phase(singles, "gloo", GLOO_RANKS, [dev], tmp))
        n_cards = torch.cuda.device_count()
        phase("sharded proof, NCCL, world = device_count",
              lambda: sharded_proof_phase(singles, "nccl", n_cards,
                                          [torch.device("cuda", i) for i in range(n_cards)], tmp))
        phase(f"sharded NTT and MSM at 2^{LOG2_SHARD}, {GLOO_RANKS} ranks",
              lambda: sharded_ntt_msm_phase(dev, tmp))
    phase("CLI", cli_phase)
    phase("profiles", run_profiles)

    clock = k9["sm_clock_max_mhz"]
    print(f"bounds: an Fp product {measure.FP_MUL_WIDE} widening multiplies at "
          f"{measure.WIDE_PER_SM_PER_CLOCK} and {measure.FP_MUL_LOW} low ones at "
          f"{measure.MUL_PER_SM_PER_CLOCK} an SM a clock ({measure.FP_MUL_MULTIPLIES} issue slots), "
          f"{measure.SMS} SMs, SM clock {clock:.0f} MHz; {measure.HBM_BYTES_PER_S / 1e12:.2f} TB/s")

    def bound(name, shape):
        return measure.bound_ms(*measure.work(name, **shape), clock)

    for name, rows in results.items():
        for variant, _, ms, plain_ms, shape in rows:
            if shape is not None:
                b, side = bound(name, shape)
                print(f"bound {name} {variant}: kernel {ms:.4f} ms, bound {b:.5f} ms "
                      f"({side}), plain " + ("not run" if plain_ms is None else f"{plain_ms:.2f} ms"))

    src = "groth16_tpu_torch/csrc/"
    table = {"point_add": ("point.cu", "groth16_tpu/ops/kernels.py:288"),
             "point_double_n": ("point.cu", "groth16_tpu/ops/kernels.py:288"),
             "horner": ("point.cu", "groth16_tpu/ops/kernels.py:288"),
             "fold_level_kernel": ("fold.cu", "groth16_tpu/ops/kernels.py:416"),
             "ntt_inner_kernel": ("ntt.cu", "groth16_tpu/ops/ntt_pallas.py:232"),
             "quotient_pointwise_kernel": ("ntt.cu", "groth16_tpu/protocol/prover.py:150"),
             "phase_a_kernel": ("tree.cu", "groth16_tpu/ops/kernels_tree.py:120"),
             "mul_rows_kernel": ("tree.cu", "groth16_tpu/ops/kernels_tree.py:166"),
             "invert_kernel": ("tree.cu", "groth16_tpu/ops/kernels_tree.py:202"),
             "level_kernel": ("tree.cu", "groth16_tpu/ops/kernels_tree.py:370"),
             "phase_b_kernel": ("tree.cu", "groth16_tpu/ops/kernels_tree.py:292"),
             "fp_mul_chain_kernel": ("mul_chain.cu", "tools/bench_mul_kernels.py:30"),
             "spmv_kernel": ("spmv.cu", "groth16_tpu/protocol/prover.py:89"),
             "fp_neg_kernel": ("spmv.cu", "groth16_tpu/ops/msm_tree.py:329")}
    paths = {name: path for name, _, path in WRAPPERS}
    kernels = []
    for name, (source, replaces) in table.items():
        rows = results[name]
        timed = [r for r in rows if r[2] is not None]
        variant, _, ms, plain_ms, shape = timed[0]   # the first main-path shape checked
        b, side = bound(name, shape)
        kernels.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": replaces, "launches": counts[paths[name]][name],
                        "path": paths[name], "launches_sharded": counts["sharded"].get(name, 0),
                        "launches_fused": counts["fused"].get(name, 0),
                        "max_abs_err": max(r[1] for r in rows if r[1] is not None),
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": side,
                        "library_ms": None, "shape": variant})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
