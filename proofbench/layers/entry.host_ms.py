"""Entry: the host's work around a replay, the mean over the window's
proofs of the program's timings total_s - device_core_s, milliseconds."""


def read(ctx):
    vals = [p.timings["total_s"] - p.timings["device_core_s"] for p in ctx.window
            if "total_s" in p.timings and "device_core_s" in p.timings]
    return 1e3 * sum(vals) / len(vals) if vals else None
