"""MSMs: the five MSMs' least time for the traced proofs' own scalars
(counts.msm_least_seconds) over msm.device_ms, percent."""

from proofbench.layers import counts as K


def read(ctx):
    s = K.msm_seconds(ctx)
    least = K.msm_least_seconds(ctx)
    if s is None or least is None:
        return None
    return 100.0 * least / s
