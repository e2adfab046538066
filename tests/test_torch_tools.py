"""The port's tools on the CPU: bench_tree_phases and bench_mul_kernels run
end to end through the plain versions at 2^8 points (the tree, the fold and
the "auto" MSM give one point; K9's plain version agrees with host ints),
their command lines refuse to run without CUDA, and tools/measure.py's SASS
reading and kernel bounds.  Tolerance 0: exact integer arithmetic."""

import pytest
import torch

from groth16_tpu_torch.ops import msm_tree as MT
from groth16_tpu_torch.tools import bench_mul_kernels as BM, bench_tree_phases as BT
from groth16_tpu_torch.tools import measure

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


def test_tree_phases_run_on_the_cpu(monkeypatch):
    """Every phase once.  msm(path="tree")'s window group is widened to 64
    here only to keep the plain levels few (each pays one plain Fermat
    inversion); on the card the tool runs the default group."""
    monkeypatch.setattr(MT, "WINDOW_GROUP", 64)
    res = BT.run(8, 64, "cpu", reps=1)
    assert res["same_point"] and res["card"] == "cpu" and res["peak_gib_msm_tree"] is None
    assert len(res["phases_ms"]) == 14


def test_mul_kernels_run_on_the_cpu():
    res = BM.run(8, 256, "cpu", reps=1)
    assert res["max_abs_err"] == 0 and "sass_multiplies" not in res


@pytest.mark.parametrize("tool", [BT, BM], ids=["bench_tree_phases", "bench_mul_kernels"])
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
    assert measure.work("phase_b_kernel", "G1", M=M)[1] == 112 * M
    assert measure.work("phase_b_kernel", "G2", M=M)[1] == 3 * 112 * M
    assert measure.work("phase_b_level_kernel", "G1", M=M, emit=False)[1] == 112 * M
    assert measure.work("fp_mul_chain_kernel", k=256, n=10) == (4 * 48 * 10, 2560)
    # K6: 3 products a total, per block the tree (3 x 127), the R^3 product and
    # the Euclid steps of its root (16 operations a halving or subtraction)
    assert measure.euclid_ops(0) == 0
    assert all(0 < measure.euclid_ops(a) <= 16 * 3 * 256 and measure.euclid_ops(a) % 16 == 0
               for a in (1, 6, measure._P_FP - 1))
    assert measure.work("invert_kernel", "G1", M=2048, inv_ops=4 * 136 * 50)[1] == (
        3 * 2048 + 4 * (3 * 127 + 1) + 4 * 50)
    assert measure.work("invert_kernel", "G1", M=1, inv_ops=0)[1] == 3 + 3 * 127 + 1
    assert measure.work("point_double_n", "G1", n=20, k=12)[1] == 12 * 9 * 20
    assert measure.work("horner", "G2", B=1, W=20, c=13) == (4 * 3 * 32 * 21, 19 * (9 * 13 + 14) * 3)
    assert measure.FP_MUL_MULTIPLIES == 136
    ms, side = measure.bound_ms(3_350_000_000, 1, 1980)
    assert side == "bytes" and abs(ms - 1.0) < 1e-9
    ms, side = measure.bound_ms(0, 132 * 64 * 1980 * 1000 // 136, 1980)
    assert side == "operations" and abs(ms - 1.0) < 1e-6
