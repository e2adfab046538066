"""Whole proof: the products the proof needs at least (the SpMV's, the
quotient's and the five MSMs' counts) at the card's multiply peak, over
the wall time a traced proof (the traced stretch over its proofs),
percent."""

from proofbench.layers import counts as K


def read(ctx):
    tr = ctx.trace
    products = K.proof_products(ctx)
    if tr is None or tr.window_s <= 0 or products is None or ctx.clock_mhz is None:
        return None
    return 100.0 * products / K.peak_products_per_s(ctx.clock_mhz) / (tr.window_s / tr.proofs)
