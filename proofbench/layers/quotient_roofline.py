"""Quotient: the least time of the snarkjs quotient (counts.quotient_work)
over the NTT steps' and pointwise kernel's device time a traced proof,
percent."""

from proofbench.layers import counts as K


def read(ctx):
    s = ctx.kernel_seconds(*K.QUOTIENT_KERNELS)
    if s is None or ctx.clock_mhz is None:
        return None
    return 100.0 * K.least_seconds(*K.quotient_work(ctx.circuit.log2_domain), ctx.clock_mhz) / s
