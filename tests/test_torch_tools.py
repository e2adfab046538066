"""The port's tools on the CPU: bench_tree_phases, bench_fold_phases and
bench_mul_kernels run end to end through the plain versions at 2^8 points
(the tree, the fold and the "auto" MSM give one point; the fold's phases give
the fold MSM's point; K9's plain version agrees with host ints), their
command lines refuse to run without CUDA, bench_point_variants' reading of
ptxas, bench_spmv's seeded sets, and tools/measure.py's SASS reading, work
counts (the quotient's launches included) and kernel bounds.
Tolerance 0: exact integer arithmetic."""

import numpy as np
import pytest
import torch

from groth16_tpu_torch.ops import msm_tree as MT
from groth16_tpu_torch.tools import bench_fold_phases as BF, bench_mul_kernels as BM
from groth16_tpu_torch.tools import bench_point_variants as BV, bench_tree_phases as BT
from groth16_tpu_torch.tools import bench_spmv as BS, bench_tree_kernels as BK
from groth16_tpu_torch.tools import measure

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


def test_tree_phases_run_on_the_cpu(monkeypatch):
    """Every phase once.  The tree's window group is widened to 64
    here only to keep the plain levels few (each pays one plain Fermat
    inversion); on the card the tool runs the default group."""
    monkeypatch.setattr(MT, "WINDOW_GROUP", 64)
    res = BT.run(8, 64, "cpu", reps=1)
    assert res["same_point"] and res["card"] == "cpu" and res["peak_gib_msm_tree"] is None
    assert len(res["phases_ms"]) == 14


def test_tree_crossover_runs_on_the_cpu(monkeypatch):
    """The crossover sweep at 2^7 G1 points through the plain versions: a
    fold row and a tree row, the fold the path "auto" takes, one point."""
    monkeypatch.setattr(MT, "WINDOW_GROUP", 64)
    res = BT.crossover([7], ["G1"], 254, "cpu", reps=1)
    assert res["card"] == "cpu" and res["bits"] == 254
    assert [(r["curve"], r["log2n"], r["path"], r["auto"]) for r in res["rows"]] == \
        [("G1", 7, "fold", True), ("G1", 7, "tree", False)]
    assert [r["c"] for r in res["rows"]] == [5, 4]
    assert all(r["peak_reserved_gib"] is None for r in res["rows"])


@pytest.mark.parametrize("bits", [254, 32, 40])
def test_draw_scalars_width(bits):
    """draw_scalars: a seed gives the same scalars; full width stays below
    r with its top limb in use; `bits` bits stay below 2^bits and reach its
    top half."""
    from groth16_tpu_torch.ops.limbs import limbs_to_ints
    from groth16_tpu_torch.utils.hostmath import R
    a, b = BT.draw_scalars(4096, 5, bits), BT.draw_scalars(4096, 5, bits)
    assert a.shape == (4096, 16) and a.dtype == np.uint32 and np.array_equal(a, b)
    ks = limbs_to_ints(a)
    top = R if bits >= 254 else 1 << bits
    assert max(ks) < top and max(ks) >= top // 2


def test_mul_kernels_run_on_the_cpu():
    res = BM.run(8, 256, "cpu", reps=1)
    assert res["max_abs_err"] == 0 and "sass_multiplies" not in res


def test_fold_phases_run_on_the_cpu():
    """Every phase once, the levels of `fold_schedule` with their closes."""
    res = BF.run(8, "cpu", reps=1)
    assert res["same_point"] and res["card"] == "cpu" and res["peak_gib_msm_fold"] is None
    assert [lv["T"] for lv in res["levels"]] == res["schedule"]
    assert len(res["phases_ms"]) == 7 + len(res["schedule"])
    assert res["levels"][0]["affine"] and res["levels"][-1]["last"]


def test_level_case_slots():
    """bench_tree_phases.level_case, the operands the smoke and
    bench_point_variants hand K8: PL and PR differ, and A.pR / B.pL hold a
    doubling, a cancellation and the three infinity cases every 7 slots."""
    from groth16_tpu_torch.ops import curve as C, field as F
    K = 21
    PL, PR, flags = BT.level_case(np.random.default_rng(2), C.G1, K, "cpu")
    assert PL.shape == PR.shape == (32, 2 * K) and [f.shape for f in flags] == [(K,)] * 3
    _, apr, bpl, _ = (F.as_i32(v) for v in BT.level_views(PL, PR))
    x, y = slice(0, 16), slice(16, 32)
    assert not torch.equal(F.as_i32(PL), F.as_i32(PR))
    for s in range(K):
        case = s % 7
        a_inf, b_inf = not apr[:, s].any(), not bpl[:, s].any()
        assert (a_inf, b_inf) == (case in (3, 5), case in (4, 5)), s
        if case == 1:
            assert torch.equal(apr[:, s], bpl[:, s])
        if case == 2:
            assert torch.equal(apr[x, s], bpl[x, s]) and not torch.equal(apr[y, s], bpl[y, s])


@pytest.mark.parametrize("tool", [BT, BM, BF, BK, BS],
                         ids=["bench_tree_phases", "bench_mul_kernels", "bench_fold_phases",
                              "bench_tree_kernels", "bench_spmv"])
def test_main_needs_cuda(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tool.main([]) != 0
    assert "needs a CUDA device" in capsys.readouterr().err


SASS = """
\tcode for sm_90a
\t\tFunction : _Z7other_kPj
        /*0000*/                   IMAD R1, R2, R3, R4 ;      /* 0x000 */
        /*0010*/                   BRA 0x0 ;                  /* 0x000 */
\t\tFunction : _Z19fp_mul_chain_kernelPKjS0_Pjil
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x000 */
        /*0010*/                   IMAD.MOV.U32 R4, RZ, RZ, R5 ; /* 0x000 */
.L_x_0:
        /*0020*/                   IMAD.WIDE.U32 R2, R4, R5, RZ ; /* 0x000 */
        /*0030*/                   IADD3 R6, P0, R2, R7, RZ ; /* 0x000 */
        /*0040*/                   IMAD.X R8, R3, 0x1, R9, P0 ; /* 0x000 */
        /*0050*/              @!P1 BRA `(.L_x_0) ;            /* 0x000 */
        /*0060*/                   IMAD R1, R2, R3, R4 ;      /* 0x000 */
        /*0070*/               @P2 BRA 0x60 ;                 /* 0x000 */
        /*0080*/                   EXIT ;                     /* 0x000 */
"""


def test_tree_kernels_tool_names_kernels_short():
    """measure.short, which bench_tree_kernels prints the profiler's kernels
    through, folds the names of one kernel (template arguments, parameters)
    into one entry and keeps copies apart."""
    names = {"void tree_mul_rows_kernel<bn254::G1>(bn254::MulRowsIO)": (1, 2.5),
             "void tree_mul_rows_kernel<bn254::G2>(bn254::MulRowsIO)": (2, 1.0),
             "Memcpy DtoH (Device -> Pageable)": (1, 0.75)}
    assert measure.short(names) == {"tree_mul_rows_kernel": [3, 3.5],
                               "Memcpy DtoH": [1, 0.75]}


def test_device_kernels_takes_a_trace_again_until_its_launches_match(monkeypatch):
    """measure.device_kernels counts each name's launches and device time;
    a trace that misses a launch the caller expects (a part of the name:
    launches) is taken again, and one that never holds them raises."""
    from types import SimpleNamespace

    def event(name, us):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(elapsed_us=lambda: us))

    full = [event("void tree_invert_kernel<bn254::G1>(x)", 2.0),
            event("void tree_invert_kernel<bn254::G1>(x)", 3.0),
            event("void tree_invert_kernel<bn254::G2>(x)", 5.0),
            event("Memcpy DtoH (Device -> Pageable)", 1.0)]
    traces = [full[1:], full]
    monkeypatch.setattr(measure, "device_trace", lambda fn: (traces.pop(0), fn()))
    expect = {"tree_invert_kernel<bn254::G1>": 2, "tree_invert_kernel<bn254::G2>": 1}
    names = measure.device_kernels(lambda: None, expect)
    assert not traces
    assert names == {"void tree_invert_kernel<bn254::G1>(x)": (2, 5.0),
                     "void tree_invert_kernel<bn254::G2>(x)": (1, 5.0),
                     "Memcpy DtoH (Device -> Pageable)": (1, 1.0)}
    monkeypatch.setattr(measure, "device_trace", lambda fn: (full[1:], fn()))
    with pytest.raises(AssertionError, match="traced launches"):
        measure.device_kernels(lambda: None, expect, tries=2)


def test_cummax_callers_counts_scans_and_restores():
    """measure.cummax_callers counts each torch.cummax call under its
    callers in the package (a plain Montgomery product scans once, in
    ops/field.py, which the frames skip) and puts torch.cummax back."""
    from groth16_tpu_torch.ops import field as F
    from groth16_tpu_torch.tools.measure import cummax_callers
    scan = torch.cummax
    a = torch.arange(32, dtype=torch.int64).reshape(2, 16)
    with cummax_callers() as calls:
        F.mont_mul(F.FP, a, a)
    assert sum(calls.values()) >= 1 and torch.cummax is scan
    assert all("ops/field.py" not in k for k in calls)


def test_mid_doublings_counts_equal_finite_slots():
    """K7's doubling slots: both points equal and not (0, 0); equal (0, 0)
    points and equal x with other y do not double."""
    apr = torch.zeros((4, 2, 3), dtype=torch.int32)
    bpl = apr.clone()                       # every slot (0, 0) + (0, 0)
    apr[:, 0, 0] = bpl[:, 0, 0] = torch.tensor([1, 2, 3, 4])      # doubling
    apr[:, 1, 2] = bpl[:, 1, 2] = torch.tensor([0, 0, 0, 9])      # doubling, x = 0
    apr[:, 0, 1], bpl[:, 0, 1] = torch.tensor([1, 2, 3, 4]), torch.tensor([1, 2, 3, 5])
    assert measure.mid_doublings(apr.view(torch.uint32), bpl.view(torch.uint32)) == 2


def test_compile_library_rebuild_runs_the_compiler_again(monkeypatch, tmp_path):
    """A cached library is returned without a compile, and with an empty
    log; `rebuild` runs the compilers again so that their output (ptxas's
    report) comes back."""
    from groth16_tpu_torch.ops import cuda
    calls = []

    def fake_run(cmds):
        calls.append(cmds)
        for c in cmds:
            open(c[c.index("-o") + 1], "w").close()
        return "ptxas info    : Used 40 registers\n" if "-c" in cmds[0] else ""

    monkeypatch.setattr(cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda, "_run", fake_run)
    so, log, _ = cuda.compile_library(("mul_chain.cu",), ("-Xptxas", "-v"))
    assert "40 registers" in log and len(calls) == 2
    assert cuda.compile_library(("mul_chain.cu",), ("-Xptxas", "-v"))[:2] == (so, "")
    assert len(calls) == 2
    so2, log2, _ = cuda.compile_library(("mul_chain.cu",), ("-Xptxas", "-v"), rebuild=True)
    assert so2 == so and "40 registers" in log2 and len(calls) == 4


def test_sass_loop_body_count():
    """The loop with the most multiplies, in labelled or address form, of
    the named function only; moves and carry adds are not multiplies."""
    ops = measure.loop_opcodes(SASS, "fp_mul_chain_kernel")
    assert ops == {"IMAD.WIDE.U32": 1, "IADD3": 1, "IMAD.X": 1, "BRA": 1}
    assert measure.multiply_count(ops) == 1
    assert measure.multiply_count({"IMAD.MOV.U32": 3, "IMAD.HI.U32": 2, "IMAD": 1}) == 3
    assert measure.multiply_count(measure.loop_opcodes(SASS, "other_k")) == 1
    with pytest.raises(ValueError):
        measure.loop_opcodes(SASS, "missing_kernel")


def test_kernel_work_and_bounds():
    """Products and bytes counted from the kernel sources, and the bound as
    the larger side."""
    M = 8192
    # K7: 14 products up a lane's tree, 30 down, 3 an addition, 1 a doubling
    assert measure.work("phase_b_kernel", "G1", M=M, dbl=0)[1] == 92 * M
    assert measure.work("phase_b_kernel", "G2", M=M, dbl=5)[1] == 3 * (92 * M + 5)
    # K4: two points a slot in, a total a lane out; 15 products a lane's tree
    assert measure.work("phase_a_kernel", "G1", M=M) == (4 * (64 * 16 + 16) * M, 15 * M)
    assert measure.work("phase_a_kernel", "G2", M=M)[1] == 3 * 15 * M
    # K5: a and out W wide, b Wb wide (read at w mod Wb); a product each
    assert measure.work("mul_rows_kernel", "G1", W=M) == (4 * 16 * 3 * M, M)
    assert measure.work("mul_rows_kernel", "G2", W=2, Wb=1) == (4 * 32 * 5, 6)
    assert measure.work("level_kernel", "G1", K=16 * M, emit=False, inv_ops=0)[1] == (
        7 * 16 * M + 16 * M // 512 * (3 * 127 + 1))
    assert measure.work("fp_mul_chain_kernel", k=256, n=10) == (4 * 48 * 10, 2560)
    # K6: 3 products a total, per block the tree (3 x 127), the R^3 product and
    # the Euclid steps of its root (16 operations a halving or subtraction)
    assert measure.euclid_ops(0) == 0
    assert all(0 < measure.euclid_ops(a) <= 16 * 3 * 256 and measure.euclid_ops(a) % 16 == 0
               for a in (1, 6, measure._P_FP - 1))
    slots = measure.FP_MUL_MULTIPLIES
    assert measure.work("invert_kernel", "G1", M=2048, inv_ops=4 * slots * 50)[1] == (
        3 * 2048 + 4 * (3 * 127 + 1) + 4 * 50)
    assert measure.work("invert_kernel", "G1", M=1, inv_ops=0)[1] == 3 + 3 * 127 + 1
    assert measure.work("point_double_n", "G1", n=20, k=12)[1] == 12 * 9 * 20
    assert measure.work("horner", "G2", B=1, W=20, c=13) == (4 * 3 * 32 * 21, 19 * (9 * 13 + 14) * 3)
    assert measure.FP_MUL_WIDE + measure.FP_MUL_LOW == 136
    ms, side = measure.bound_ms(3_350_000_000, 1, 1980)
    assert side == "bytes" and abs(ms - 1.0) < 1e-9
    ms, side = measure.bound_ms(0, 132 * 64 * 1980 * 1000 // slots, 1980)
    assert side == "operations" and abs(ms - 1.0) < 1e-6


@pytest.mark.parametrize("rate,count", [(64, 136), (64, 264), (32, 136), (62.06, 200.5)])
def test_peak_products_follow_rate_and_count(rate, count):
    """The multiply peak is SMs x rate x clock over the issue slots a
    product takes: twice the rate doubles it, twice the slots halve it."""
    peak = measure.peak_products_per_s(1980, rate, count)
    assert abs(peak - 132 * rate * 1980e6 / count) < 1e-3 * peak
    assert abs(measure.peak_products_per_s(1980, 2 * rate, count) - 2 * peak) < 1e-3 * peak
    assert abs(measure.peak_products_per_s(1980, rate, 2 * count) - peak / 2) < 1e-3 * peak
    assert abs(measure.peak_products_per_s(990, rate, count) - peak / 2) < 1e-3 * peak


def test_wide_per_clock_takes_the_fastest_form():
    """A widening product counts once a mul.wide.u32, once a mul.hi.u32 and
    once a pair of carry-chain instructions."""
    rates = dict(zip(BM.RATE_KINDS.values(), (62.0, 26.2, 43.2, 31.6)))
    assert BM.wide_per_clock(rates) == 31.6
    rates[BM.RATE_KINDS[2]] = 70.0
    assert BM.wide_per_clock(rates) == 35.0


def test_bound_slots_follow_the_wide_rate():
    """The default product costs its 8 low multiplies one slot each and its
    128 widening ones 64 / WIDE_PER_SM_PER_CLOCK slots each; the default peak
    is that count at 64 slots a clock."""
    w = measure.WIDE_PER_SM_PER_CLOCK
    assert measure.FP_MUL_MULTIPLIES == 128 * 64 // w + 8
    assert measure.peak_products_per_s(1980) == measure.peak_products_per_s(
        1980, 64, measure.FP_MUL_MULTIPLIES)


def test_fold_and_level_work_counts():
    """K2: a slot that joins a segment is one add (13 products mixed, 14
    complete), a close one complete add that reads and writes its bucket;
    the last level adds every open segment into its bucket; a zero key is
    read and does nothing else (no order, no point, no add), and a lane of
    zero keys opens no segment.  K8: four points and a flag byte read, two
    or three points written, 7 products an addition, K6's tree and the
    Euclid steps a block."""
    keys = np.array([[1, 1, 2, -2, 3, 3, 3, 4]])
    assert measure.fold_shape(keys, 4) == {"zeros": 0, "opened": 2, "closes": 2}
    assert measure.fold_shape(keys, 8) == {"zeros": 0, "opened": 1, "closes": 3}
    assert measure.fold_shape(keys, 1) == {"zeros": 0, "opened": 8, "closes": 0}
    b, p = measure.work("fold_level_kernel", "G1", affine=True, T=4, lanes=2,
                        **measure.fold_shape(keys, 4), order=True, last=False)
    assert p == 13 * (8 - 2 - 2) + 14 * 2
    assert b == 4 * (8 * (1 + 1 + 32) + 2 * 48 * 2 + 2 * (48 + 1))
    b, p = measure.work("fold_level_kernel", "G2", affine=False, T=8, lanes=1,
                        **measure.fold_shape(keys, 8), order=False, last=True)
    assert p == 3 * (14 * (8 - 1 - 3) + 14 * 4)
    assert b == 4 * (8 * (1 + 96) + 2 * 96 * 4)
    zkeys = np.array([[0, 0, 0, 0, 0, 2, 0, -3]])
    assert measure.fold_shape(zkeys, 4) == {"zeros": 6, "opened": 1, "closes": 1}
    assert measure.fold_shape(zkeys, 8) == {"zeros": 6, "opened": 1, "closes": 1}
    b, p = measure.work("fold_level_kernel", "G1", affine=True, T=4, lanes=2,
                        **measure.fold_shape(zkeys, 4), order=True, last=False)
    assert p == 14 * 1
    assert b == 4 * (8 + 2 * (1 + 32) + 2 * 48 * 1 + 2 * (48 + 1))
    b, p = measure.work("fold_level_kernel", "G1", affine=False, T=8, lanes=1,
                        **measure.fold_shape(zkeys, 8), order=False, last=True)
    assert p == 14 * 2
    assert b == 4 * (8 + 2 * 48 + 2 * 48 * 2)
    b, p = measure.work("level_kernel", "G2", K=600, emit=True,
                        inv_ops=measure.FP_MUL_MULTIPLIES * 2)
    assert b == 4 * 7 * 64 * 600 + 600
    assert p == 7 * 3 * 600 + 2 * (3 * 127 * 3 + 1 + 4) + 2


def test_ntt_step_and_pointwise_work_counts():
    """K3: every element read and written once (64 bytes wire, 32 packed),
    the packed tables once, log2(T) stages of T/2 products and one product
    an element a table; the pointwise step: A * B, the scale, the product
    out of Montgomery form."""
    b, p = measure.work("ntt_inner_kernel", T=256, NB=256, B=3, pre=True, post=True,
                        wire_in=False, wire_out=False)
    assert p == 3 * 256 * (128 * 8 + 2 * 256)
    assert b == 3 * 65536 * 64 + 32 * (2 * 65536 + 256)
    b, p = measure.work("ntt_inner_kernel", T=512, NB=256, B=1, pre=False, post=False,
                        wire_in=True, wire_out=False)
    assert (b, p) == (2**17 * 96 + 32 * 512, 256 * 256 * 9)
    assert measure.work("ntt_inner_kernel", T=1, NB=4, B=1, pre=False, post=False,
                        wire_in=True, wire_out=True) == (4 * 128 + 32, 0)
    assert measure.work("quotient_pointwise_kernel", n=10, scale=True, standard=False) == (
        960 + 32 + 320, 20)
    assert measure.work("quotient_pointwise_kernel", n=10, scale=False, standard=True) == (
        960 + 640, 20)


def test_quotient_work_and_bound():
    """The whole quotient at 2^16: four K3 steps (A, B, C in one batch) and
    the pointwise step, JensGroth two more steps; Az, Bz, Cz read as the
    SpMV leaves them (uint32 wire, 64 bytes an element); its bound (about
    0.03 ms at 136 issue slots a product, scaled by the slots a product
    takes; operations) counts the products of every launch."""
    kinds = [(n, sh.get("B")) for n, sh in measure.quotient_launches(16, "snarkjs")]
    assert kinds == [("ntt_inner_kernel", 3)] * 4 + [("quotient_pointwise_kernel", None)]
    assert len(measure.quotient_launches(16, "jens-groth")) == 7
    N, butterflies = 1 << 16, 2 * (1 << 15) * 16
    b, p = measure.work("quotient", log2n=16, flavour="snarkjs")
    assert (b, p) == (3 * 64 * N + 64 * N, 3 * (butterflies + 3 * N) + 2 * N)
    _, pj = measure.work("quotient", log2n=16, flavour="jens-groth")
    assert pj == 3 * (butterflies + 3 * N) + 2 * N + butterflies // 2 + 2 * N
    ms, side = measure.bound_ms(b, p, 1980)
    scale = measure.FP_MUL_MULTIPLIES / 136
    assert side == "operations" and 0.03 * scale < ms < 0.033 * scale
    assert abs(ms - 1e3 * p / measure.peak_products_per_s(1980)) < 1e-12


@pytest.mark.parametrize("cv_name", ["G1", "G2"])
def test_level_block_roots(cv_name):
    """The fused level's block roots multiply to the product of every masked
    denominator of the level, which the plain K4 gives lane by lane (in G2
    the norms multiply, the norm being multiplicative)."""
    from groth16_tpu_torch.ops import curve as C, kernels_tree as KT
    from test_torch_tree import level_case
    cv = getattr(C, cv_name)
    K = 600
    _, cols, _ = level_case(cv, K, seed=5)
    roots = measure.level_block_roots(cv_name, cols[1].numpy(), cols[2].numpy())
    assert len(roots) == 2
    p = measure._P_FP
    rinv = pow(1 << 256, -1, p)
    tots = KT.phase_a_plain(cv, *(KT._planes(c, KT._tiles(K)) for c in cols[1:3]))
    vals = measure._ints(tots.T.reshape(-1, 16).numpy())
    prod = (1 << 256) % p if cv_name == "G1" else ((1 << 256) % p, 0)
    for i in range(tots.shape[1]):
        if cv_name == "G1":
            prod = prod * vals[i] * rinv % p
        else:
            a, b = vals[2 * i], vals[2 * i + 1]
            prod = ((prod[0] * a - prod[1] * b) * rinv % p, (prod[0] * b + prod[1] * a) * rinv % p)
    if cv_name == "G2":
        prod = (prod[0] * prod[0] + prod[1] * prod[1]) * rinv % p
    assert roots[0] * roots[1] * rinv % p == prod


PTXAS = """
ptxas info    : Compiling entry function '_ZN5bn25411fold_kernelINS_2G2ELb1EEEvPKjPKiS5_PjS6_Piilii' for 'sm_90a'
ptxas info    : Function properties for _ZN5bn25411fold_kernelINS_2G2ELb1EEEvPKjPKiS5_PjS6_Piilii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 0 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z17tree_level_kernelI2G1EvN5bn2547LevelIOE' for 'sm_90a'
ptxas info    : Function properties for _Z17tree_level_kernelI2G1EvN5bn2547LevelIOE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16384 bytes smem
"""


def test_ptxas_table_names_every_instantiation():
    assert BV.ptxas_table(PTXAS) == {"fold_kernel G2 affine": (168, 4, 4, 8),
                                     "tree_level_kernel G1": (128, 0, 0, 0)}


SPMV_PTXAS = """
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119spmv_entries_kernelILi4EEEvPKjS2_PKiS4_lS4_PjS5_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119spmv_entries_kernelILi4EEEvPKjS2_PKiS4_lS4_PjS5_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 120 registers, used 1 barriers, 1152 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118spmv_finish_kernelEPKjS1_PKiS3_PKllPj' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118spmv_finish_kernelEPKjS1_PKiS3_PKllPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 17536 bytes smem
"""


def test_ptxas_table_names_the_spmv_passes():
    """Each E of the entries pass is its own line, the finish pass one."""
    assert BV.ptxas_table(SPMV_PTXAS, BV.ALL_KERNELS) == {
        "spmv_entries_kernel 4": (120, 0, 0, 0), "spmv_finish_kernel": (80, 0, 0, 0)}


def test_bench_spmv_sets():
    """The smoke's SpMV sets at their full size: the dense set's one row of
    2^16 entries over the first 64 wires (and a few random ones) and its
    empty last rows; the
    power-law set's 2^16 rows of A and B, every row 1 to 2^15 entries long,
    most of one to three, A's row 0 the longest, about 2^19 entries in all,
    column 0 in about a quarter of the rows."""
    rng = np.random.default_rng(BS.SEED)
    name, w, matrix, row, col, coeff, n = BS.dense_set(rng, **BS.DENSE)
    key = (matrix != 0) * n + row
    lengths = np.bincount(key, minlength=2 * n)
    assert 1 << 16 < int(lengths.max()) < (1 << 16) + 16 and int(lengths.argmax()) == 1
    assert lengths[n - 1] == lengths[2 * n - 1] == 0
    assert ((key == 1) & (col < 64)).sum() >= 1 << 16
    assert w.shape == (n, 16) and coeff.shape == (len(row), 16)
    name, w, matrix, row, col, coeff, n = BS.power_law_set(rng, **BS.POWER_LAW)
    assert n == 1 << 16 and coeff.shape == (len(row), 16) and w.shape == (1 << 16, 16)
    key = matrix.astype(np.int64) * n + row
    lengths = np.bincount(key, minlength=2 * n)
    assert lengths.min() == 1 and lengths.max() == 1 << 15 and lengths[0] == 1 << 15
    assert (lengths <= 3).mean() > 0.8
    assert 1 << 18 < len(row) < 1 << 20
    with_one = np.zeros(2 * n, bool)
    with_one[key[col == 0]] = True
    assert 0.2 < with_one.mean() < 0.3
    assert (coeff[:, 15] <= 0x3064).all() and (w[:, 15] <= 0x3064).all()   # below r


def test_spmv_and_negation_work():
    """The SpMV reads each entry's coefficient and column, the row offsets
    and the witness once and writes Az, Bz, Cz: bytes-bound at the 2^16
    proof's shape; one product an entry and three a row.  The negation moves
    its elements in and out and multiplies nothing."""
    n, nnz, nvars = 1 << 16, 131069, 65535
    b, p = measure.work("spmv_kernel", n_rows=n, nnz=nnz, nvars=nvars)
    assert (b, p) == (68 * nnz + 8 * (2 * n + 1) + 64 * nvars + 192 * n, nnz + 3 * n)
    assert measure.bound_ms(b, p, 1980)[1] == "bytes"
    assert measure.work("fp_neg_kernel", n=10) == (1280, 0)
    assert measure.bound_ms(1280, 0, 1980) == (1e3 * 1280 / measure.HBM_BYTES_PER_S, "bytes")
