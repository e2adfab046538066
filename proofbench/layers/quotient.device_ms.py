"""Quotient: device time a traced proof of the NTT steps and the
pointwise kernel, milliseconds."""

from proofbench.layers import counts as K


def read(ctx):
    s = ctx.kernel_seconds(*K.QUOTIENT_KERNELS)
    return None if s is None else 1e3 * s
