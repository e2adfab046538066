"""The 95th percentile of every window proof's latency, from the request's
start to the proof's points on the host, milliseconds (host clock)."""

from proofbench.harness.cell import quantile


def read(ctx):
    return 1e3 * quantile([p.latency_s for p in ctx.window], 0.95)
