"""MSMs and the spec-point algebra: a traced proof's device time (every
kernel, memset and on-device copy) less the SpMV's and the quotient's
kernels and the copies to and from the host, milliseconds."""

from proofbench.layers import counts as K


def read(ctx):
    s = K.msm_seconds(ctx)
    return None if s is None else 1e3 * s
