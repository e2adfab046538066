"""Timing, the profiler's device kernels of a call, the card's identity and
the least time a kernel could take.

Shared by chip_smoke.py and the tools (bench_tree_phases, bench_fold_phases,
bench_mul_kernels, bench_point_variants, bench_tree_kernels); chip_smoke's
count of torch.cummax calls (`cummax_callers`) is here too.  A kernel's
bound is the larger of two times:

  bytes        each input read once and each output written once, over the
               H100's 3.35 TB/s;
  operations   the Fp products the work needs, times the issue slots of the
               multiply pipe one product needs (FP_MUL_MULTIPLIES), over
               132 SMs x 64 slots an SM a clock (MUL_PER_SM_PER_CLOCK) x
               the card's maximum SM clock (nvidia-smi clocks.max.sm).

An Fp product (the header's Montgomery product on eight 32-bit limbs) needs
128 widening 32 x 32 -> 64 multiplies (a_j * b_i and q * p_j) and 8 low
ones (q = t_0 * n').  A low multiply (IMAD) takes one slot: the CUDA C++
Programming Guide's table gives 64 32-bit multiplies or multiply-adds an
SM a clock for compute capability 9.0, and tools/bench_mul_kernels.py
measures 62.06 on the H100.  A widening multiply takes two slots
(WIDE_PER_SM_PER_CLOCK = 32 an SM a clock): `bench_mul_kernels.issue_rates`
measures IMAD.HI.U32 alone at 31.58, and IMAD.WIDE.U32, the form the
product's (lo, hi) pairs compile to, at about two slots each.  So one
takes MUL_PER_SM_PER_CLOCK / WIDE_PER_SM_PER_CLOCK slots.  Carry adds and moves
are not counted: the function needs them, but not on the multiply pipe.
An Fp2 product counts as the 3 Fp products of the header's Karatsuba
multiply; a squaring as a product.  `work` gives (bytes, Fp products) of
each kernel wrapper at a shape, counted from the kernel sources.  The
multiplies a compile actually issues are read from the SASS of kernel K9's
loop (`sass_text`, `loop_opcodes`), whose body is one product.
"""

from __future__ import annotations

import contextlib
import re
import shutil
import subprocess
import time
import traceback

HBM_BYTES_PER_S = 3.35e12
SMS = 132
MUL_PER_SM_PER_CLOCK = 64     # IMAD issue slots an SM a clock (CUDA C++ Programming Guide)
# widening 32 x 32 -> 64 multiplies an SM issues a clock: two slots each.
# tools/bench_mul_kernels.py `issue_rates` on an H100 80GB HBM3 at 700 W:
# IMAD.HI.U32 alone 31.58 a clock, IMAD.WIDE.U32 26.18 beside 3 moves per 8
WIDE_PER_SM_PER_CLOCK = 32
FP_MUL_WIDE, FP_MUL_LOW = 2 * 8 * 8, 8     # a_j * b_i and q * p_j; q = t_0 * n'
# issue slots of one Fp product at MUL_PER_SM_PER_CLOCK
FP_MUL_MULTIPLIES = FP_MUL_WIDE * MUL_PER_SM_PER_CLOCK // WIDE_PER_SM_PER_CLOCK + FP_MUL_LOW

_P_FP = 21888242871839275222246405745257275088696311157297823662689037894645226208583
INV_BLOCK = 128 * 4    # totals a K6 block inverts (bn254_curve.cuh INV_THREADS * INV_CHUNK)


def euclid_ops(a: int) -> int:
    """32-bit integer operations that the binary Euclid of
    csrc/bn254_curve.cuh::field_inv needs at least for the residue a: its
    steps replayed on host ints, 16 operations a halving (the eight words of
    u and of x1 shifted) and 16 more a subtraction (u - v, x1 - x2).  The
    compares, the conditional + p and the swaps are left out, which keeps the
    count a least one; additions and shifts run at the multiplies' rate
    (64 a clock per SM, the same table)."""
    u, v, ops = a % _P_FP, _P_FP, 0
    while u:
        if u & 1:
            if u < v:
                u, v = v, u
            u -= v
            ops += 16
        u >>= 1
        ops += 16
    return ops


def invert_block_roots(tots) -> list:
    """The values K6's blocks invert for G1 totals uint32[16, M] (a numpy
    array, Montgomery limbs): per block of INV_BLOCK totals the Montgomery
    residue of their product, zeros counted as one."""
    from groth16_tpu_torch.ops.limbs import limbs_to_ints
    vals = limbs_to_ints(tots.T)
    r = (1 << 256) % _P_FP
    rinv = pow(r, -1, _P_FP)
    roots = []
    for s in range(0, len(vals), INV_BLOCK):
        acc = r
        for a in vals[s:s + INV_BLOCK]:
            acc = acc * (a or r) * rinv % _P_FP
        roots.append(acc)
    return roots


def _ints(limbs) -> list:
    """uint32[N, 16] wire limbs (16 bits a word) -> N Python ints."""
    import numpy as np
    a = np.ascontiguousarray(limbs, dtype=np.uint32)
    buf = (a[:, 0::2] | (a[:, 1::2] << 16)).astype("<u4").tobytes()
    return [int.from_bytes(buf[i:i + 32], "little") for i in range(0, len(buf), 32)]


def level_block_roots(curve: str, apr, bpl) -> list:
    """The values the fused tree level's blocks invert (csrc/tree.cu
    `g16_tree_level`) for operand columns A.pR, B.pL uint32[R2, K] (numpy):
    per block of INV_BLOCK additions the Montgomery residue of the product of
    their masked slope denominators (`tree_den`: 2 y1 when doubling, x2 - x1
    otherwise, one on the cancellation and infinity slots); in G2 the norm
    of that Fp2 product, which `field_inv` inverts."""
    p, r = _P_FP, (1 << 256) % _P_FP
    rinv = pow(r, -1, p)
    nc = 16 if curve == "G1" else 32

    def elems(cols, j):     # coordinate j of every column, a tuple per Fp component
        comps = [_ints(cols[j * nc + 16 * c:j * nc + 16 * (c + 1)].T) for c in range(nc // 16)]
        return list(zip(*comps))

    x1, y1, x2, y2 = elems(apr, 0), elems(apr, 1), elems(bpl, 0), elems(bpl, 1)
    one = (r,) + (0,) * (nc // 16 - 1)
    zero = (0,) * (nc // 16)

    def mul(a, b):          # Montgomery product in Fp or Fp2 = Fp[u]/(u^2 + 1)
        if len(a) == 1:
            return (a[0] * b[0] * rinv % p,)
        return ((a[0] * b[0] - a[1] * b[1]) * rinv % p, (a[0] * b[1] + a[1] * b[0]) * rinv % p)

    roots = []
    for s in range(0, len(x1), INV_BLOCK):
        acc = one
        for i in range(s, min(s + INV_BLOCK, len(x1))):
            eqx, eqy = x1[i] == x2[i], y1[i] == y2[i]
            i1, i2 = x1[i] == zero and y1[i] == zero, x2[i] == zero and y2[i] == zero
            if (eqx and not eqy) or i1 or i2:
                continue
            if eqx and eqy:
                den = tuple(2 * v % p for v in y1[i])
            else:
                den = tuple((b - a) % p for a, b in zip(x1[i], x2[i]))
            acc = mul(acc, den)
        roots.append(acc[0] if len(acc) == 1 else (acc[0] * acc[0] + acc[1] * acc[1]) * rinv % p)
    return roots


def fold_shape(keys, T: int) -> dict:
    """What one fold level's lanes of T do over keys [W, m] (numpy), the
    shape `work("fold_level_kernel", ...)` takes: `zeros`, the slots whose
    key is 0, which do no work; `opened`, the lanes with a nonzero key,
    whose first one opens a segment; `closes`, the segments that close
    inside the lanes (nonzero slots whose |key| differs from the lane's
    nonzero slot before them)."""
    import numpy as np
    ak = np.abs(np.asarray(keys)).reshape(-1, T)
    live = ak != 0
    at = np.maximum.accumulate(np.where(live, np.arange(T), -1), axis=1)
    prev = np.zeros_like(ak)
    prev[:, 1:] = np.where(at[:, :-1] >= 0,
                           np.take_along_axis(ak, np.maximum(at[:, :-1], 0), axis=1), 0)
    return {"zeros": int((~live).sum()), "opened": int(live.any(axis=1).sum()),
            "closes": int((live & (prev != 0) & (ak != prev)).sum())}


def time_ms(fn, device, reps: int = 3, warmup: bool = True) -> float:
    """Mean milliseconds of fn(): on a CUDA device CUDA events over `reps`
    calls after one warm-up call (unless `warmup` is False); on the CPU the
    host clock over `reps` calls."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    if warmup:
        fn()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_trace(fn):
    """(device events, value) of the second of two calls of fn(), the one
    under torch.profiler (CPU and CUDA activity); the first warms up
    outside it (on an H100 a profiler schedule with a warm-up step dropped
    whole traces now and then, sometimes several in a row; a session of its
    own around the one call did not)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA], out


def device_kernels(fn, expect: dict, tries: int = 3) -> dict:
    """{name: (launches, device microseconds)} of every kernel and copy that
    one call of fn() runs on the card (`device_trace`).  `expect` maps a
    part of a kernel's name to the launches the call makes of the kernels
    so named; a trace whose launches differ is taken again, `tries` times in
    all, and raises AssertionError if the last still differs."""
    for _ in range(tries):
        names: dict = {}
        for e in device_trace(fn)[0]:
            n, us = names.get(e.name, (0, 0.0))
            names[e.name] = (n + 1, us + e.time_range.elapsed_us())
        traced = {part: sum(n for k, (n, _) in names.items() if part in k) for part in expect}
        if traced == dict(expect):
            return names
    raise AssertionError(f"the profiler traced launches {traced}, not {dict(expect)}: {names}")


# the CUDA kernel behind torch.cummax along the last axis (its profiler name)
CUMMAX_KERNEL = "scan_innermost_dim_with_indices"


@contextlib.contextmanager
def cummax_callers():
    """Inside the block every torch.cummax call (one scan kernel on the card)
    is counted under its callers in the package, the innermost three frames
    outside ops/field.py: yields that {callers: calls} dict."""
    import torch
    callers: dict = {}
    scan = torch.cummax

    def traced(*args, **kwargs):
        frames = [f"{f.filename.split('groth16_tpu_torch/')[-1]}:{f.lineno} {f.name}"
                  for f in reversed(traceback.extract_stack()[:-1])
                  if "groth16_tpu_torch" in f.filename and "ops/field.py" not in f.filename]
        key = " < ".join(frames[:3]) or "(no frame of the package)"
        callers[key] = callers.get(key, 0) + 1
        return scan(*args, **kwargs)

    torch.cummax = traced
    try:
        yield callers
    finally:
        torch.cummax = scan


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals, microseconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def short(names: dict) -> dict:
    """Profiler names cut to the kernel's own name: {name: [launches, us]}."""
    out = {}
    for name, (n, us) in names.items():
        key = name.split("(")[0].split("<")[0].replace("void ", "").strip()[:60]
        prev = out.get(key, [0, 0.0])
        out[key] = [prev[0] + n, round(prev[1] + us, 3)]
    return out


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    import torch
    return _smi("name,power.limit") if torch.device(device).type == "cuda" else "cpu"


def sm_clock_max_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    return float(_smi("clocks.max.sm").split()[0])


def peak_products_per_s(clock_mhz: float, rate: float = MUL_PER_SM_PER_CLOCK,
                        count: float = FP_MUL_MULTIPLIES) -> float:
    """Fp products a second at the card's multiply peak: `count` issue slots
    a product at `rate` slots an SM a clock."""
    return SMS * rate * clock_mhz * 1e6 / count


# ---------------------------------------------------------------------------
# SASS: the instructions of one Fp product
# ---------------------------------------------------------------------------

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def loop_opcodes(sass: str, function: str) -> dict:
    """Opcode counts of the body of the loop of `function` in cuobjdump -sass
    text: the instructions from the target of a backward branch up to the
    branch (the loop with the most multiplies, if several)."""
    sections = re.split(r"\n\s*Function : ", sass)
    body = next((sec for sec in sections[1:] if function in sec.split("\n", 1)[0]), None)
    if body is None:
        raise ValueError(f"no SASS for a function named like {function!r}")
    insns, labels, pending = [], {}, []
    for line in body.splitlines():
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            insns.append((addr, m.group(2), m.group(3)))
    best = None
    for addr, op, args in insns:
        if not op.startswith("BRA"):
            continue
        tgt = re.search(r"`\((\.L_x_\d+)\)", args)
        target = labels.get(tgt.group(1)) if tgt else None
        if target is None:
            hexa = re.search(r"0x([0-9a-f]+)", args)
            target = int(hexa.group(1), 16) if hexa else None
        if target is None or target > addr:
            continue
        counts: dict = {}
        for a, o, _ in insns:
            if target <= a <= addr:
                counts[o] = counts.get(o, 0) + 1
        if best is None or multiply_count(counts) > multiply_count(best):
            best = counts
    if best is None:
        raise ValueError(f"no loop found in the SASS of {function!r}")
    return best


def multiply_count(opcodes: dict) -> int:
    """Instructions that multiply: IMAD, IMAD.WIDE*, IMAD.HI* (not the
    moves, carry adds and shifts the compiler also places on the IMAD
    pipe: IMAD.MOV, IMAD.X, IMAD.IADD, IMAD.SHL)."""
    return sum(n for op, n in opcodes.items()
               if op == "IMAD" or op.startswith(("IMAD.WIDE", "IMAD.HI")))


def sass_text(lib_path: str) -> str:
    """The SASS of a built kernel library (cuobjdump -sass); K9's loop body
    in it is one Fp product (`loop_opcodes(sass, "fp_mul_chain_kernel")`)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout


# ---------------------------------------------------------------------------
# work of each kernel wrapper: (bytes moved, Fp products)
# ---------------------------------------------------------------------------

def _geom(curve: str):
    """(wire words per coordinate, Fp products per field product)."""
    return (16, 1) if curve == "G1" else (32, 3)


def work(name: str, curve: str = "G1", **shape) -> tuple:
    """(bytes, Fp products) of one launch of wrapper `name` at `shape`:
    point_add (n), point_double_n (n, k), horner (B, W, c), fold_level_kernel
    (affine, T, lanes: of all windows, zeros, opened, closes: `fold_shape` of
    the level's keys, order: level 0 gathers through one, last), ntt_inner_kernel (T, NB,
    B, pre, post, wire_in, wire_out), quotient_pointwise_kernel (n, scale,
    standard), quotient (log2n, flavour: the whole of
    `prover.quotient_scalars`), phase_a_kernel (M), phase_b_kernel (M, dbl), level_kernel (K, emit,
    inv_ops), spmv_kernel (n_rows, nnz, nvars), fp_neg_kernel (n), mul_rows_kernel (W, Wb: b's width, W by default), invert_kernel
    (M, inv_ops), where inv_ops
    is the sum of `euclid_ops` over the run's block roots (one issue slot
    each), counted as inv_ops / FP_MUL_MULTIPLIES products;
    fp_mul_chain_kernel (k, n)."""
    nc, f = _geom(curve)
    s = shape
    if name == "point_add":                       # 6 coordinates in, 3 out
        return 4 * 9 * nc * s["n"], 14 * f * s["n"]
    if name == "point_double_n":                  # k x 9 products a point
        return 4 * 6 * nc * s["n"], s["k"] * 9 * f * s["n"]
    if name == "horner":                          # W sums in, one point out
        B, W, c = s["B"], s["W"], s["c"]
        return 4 * 3 * nc * (W + 1) * B, (W - 1) * (9 * c + 14) * f * B
    if name == "fold_level_kernel":
        # keys read once; the order's indices and the points of the nonzero
        # slots read once (a zero key does no work); a lane's open segment
        # and its key written once, or added into its bucket at the last
        # level where it holds one; a close reads and writes its bucket.  A
        # slot that joins a running segment is one add (mixed in the affine
        # level), a close one complete add, a slot that opens a segment none.
        T, lanes, zeros, opened, closes = (s["T"], s["lanes"], s["zeros"], s["opened"],
                                           s["closes"])
        slots = T * lanes
        rin = (2 if s["affine"] else 3) * nc
        adds = closes + (opened if s["last"] else 0)
        words = slots + (slots - zeros) * (int(s["order"]) + rin) + 2 * 3 * nc * adds
        if not s["last"]:
            words += lanes * (3 * nc + 1)
        joins = slots - zeros - opened - closes
        return 4 * words, ((13 if s["affine"] else 14) * joins + 14 * adds) * f
    if name == "ntt_inner_kernel":
        # B x NB transforms: each element read and written once (64 bytes
        # wire, 32 packed), the packed tables read once (pre, post [NB, T],
        # the stage roots [T]); log2(T) stages of T/2 products, one product
        # an element for each table
        T, NB, B, tabs = s["T"], s["NB"], s["B"], int(s["pre"]) + int(s["post"])
        elem = (64 if s["wire_in"] else 32) + (64 if s["wire_out"] else 32)
        nbytes = B * NB * T * elem + 32 * (tabs * NB * T + T)
        return nbytes, B * NB * ((T // 2) * (T.bit_length() - 1) + tabs * T)
    if name == "quotient_pointwise_kernel":
        # A, B, C packed in; the result out (wire if standard, else packed);
        # A * B, the scale and the product that leaves Montgomery form
        n, sc, std = s["n"], int(s["scale"]), int(s["standard"])
        return 3 * 32 * n + 32 * sc + (64 if std else 32) * n, n * (1 + sc + std)
    if name == "quotient":
        # prover.quotient_scalars: Az, Bz, Cz in (uint32 [N, 16], as the
        # SpMV leaves them), the scalars out (wire); the products of its
        # launches
        N = 1 << s["log2n"]
        prods = sum(work(n, **sh)[1] for n, sh in quotient_launches(s["log2n"], s["flavour"]))
        return 3 * 64 * N + 64 * N, prods
    if name == "spmv_kernel":
        # the sorted entries (a 64-byte coefficient, a 4-byte column), the
        # row offsets and the witness read once, Az, Bz, Cz written; one Fr
        # product an entry, two a row into Montgomery form, one for Cz (the
        # kernel gathers a witness value an entry, reads each entry's key
        # and passes row sums and block carries between its two launches:
        # how it does the work, which this does not count)
        n, nnz = s["n_rows"], s["nnz"]
        return 68 * nnz + 8 * (2 * n + 1) + 64 * s["nvars"] + 3 * 64 * n, nnz + 3 * n
    if name == "fp_neg_kernel":                   # n elements in and out, no product
        return 2 * 64 * s["n"], 0
    if name == "phase_a_kernel":
        # two points a slot read, a total a lane written; the product of a
        # lane's 16 denominators is 15 products
        M = s["M"]
        return 4 * (2 * 2 * nc * 16 * M + nc * M), 15 * f * M
    if name == "mul_rows_kernel":                 # a and out W wide, b Wb
        W = s["W"]
        return 4 * nc * (2 * W + s.get("Wb", W)), f * W
    if name == "invert_kernel":
        # per total one product down and two back; per block the tree of its
        # 128 thread products (127 up, 254 down), the product by R^3 (and the
        # norm's 4 in Fp2) and the Euclid steps of its root
        M = s["M"]
        blocks = -(-M // INV_BLOCK)
        per_block = 3 * 127 * f + 1 + (4 if curve == "G2" else 0)
        return 4 * 2 * nc * M, 3 * f * M + blocks * per_block + s["inv_ops"] / FP_MUL_MULTIPLIES
    if name == "phase_b_kernel":
        # a lane's product tree: 14 products up (the root's is not needed),
        # 30 down; 3 an addition, and the square of x1 on its `dbl` doubling
        # slots (count them with `mid_doublings`)
        M = s["M"]
        return 4 * (3 * 2 * nc * 16 * M + nc * M), ((14 + 30 + 16 * 3) * M + s["dbl"]) * f
    if name == "level_kernel":
        # per addition four operand points and a flag byte read, two or
        # three points written, 7 products (1 down the chain, 2 back, 4 in
        # the affine add); per block K6's tree, its root's inversion
        K = s["K"]
        blocks = -(-K // INV_BLOCK)
        per_block = 3 * 127 * f + 1 + (4 if curve == "G2" else 0)
        nbytes = 4 * (4 + 2 + int(s["emit"])) * 2 * nc * K + K
        return nbytes, 7 * f * K + blocks * per_block + s["inv_ops"] / FP_MUL_MULTIPLIES
    if name == "fp_mul_chain_kernel":
        return 4 * 3 * 16 * s["n"], s["k"] * s["n"]
    raise ValueError(f"no work count for {name!r}")


def mid_doublings(apr, bpl) -> int:
    """Slots of K7's planes uint32[2*NC, T, M] (A.pR, B.pL) that double: the
    two points equal and not the (0, 0) infinity."""
    import torch
    a, b = apr.view(torch.int32), bpl.view(torch.int32)
    return int(((a == b).all(0) & (a != 0).any(0)).sum())


def quotient_launches(log2n: int, flavour: str) -> list:
    """(wrapper, shape) of every launch of `prover.quotient_scalars` at
    2^log2n: the coset shift's four K3 steps (A, B and C in one batch), the
    pointwise step, and for JensGroth the two steps of the un-shift."""
    from groth16_tpu_torch.ops import ntt as NT
    eta = NT.Domain(log2n + 1).gen
    jens = flavour == "jens-groth"

    def steps(kind, B, wire_in, wire_out):
        calls = NT.inner_calls(log2n, kind, "cpu", eta)
        return [("ntt_inner_kernel", dict(T=c.T, NB=c.NB, B=B, pre=c.pre is not None,
                                          post=c.post is not None, wire_in=wire_in and j == 0,
                                          wire_out=wire_out and j == len(calls) - 1))
                for j, c in enumerate(calls)]

    out = steps("to_coset", 3, True, False)
    out.append(("quotient_pointwise_kernel", dict(n=1 << log2n, scale=jens, standard=not jens)))
    if jens:
        out += steps("from_coset_std", 1, False, True)
    return out


def bound_ms(nbytes: int, products: int, clock_mhz: float) -> tuple:
    """(least milliseconds, "bytes" or "operations") for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = products / peak_products_per_s(clock_mhz)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
