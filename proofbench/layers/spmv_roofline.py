"""SpMV: the least time of Az, Bz, Cz = Az Bz (counts.spmv_work: bytes at
the HBM peak or products at the multiply peak) over the SpMV kernels'
device time a traced proof, percent."""

from proofbench.layers import counts as K


def read(ctx):
    s = ctx.kernel_seconds(*K.SPMV_KERNELS)
    if s is None or ctx.clock_mhz is None:
        return None
    return 100.0 * K.least_seconds(*K.spmv_work(ctx.circuit), ctx.clock_mhz) / s
