"""The card's peak reserved memory from the zkey's first proof on (its
upload, the program's graph and the window), GiB: the peak counters are
reset after the fake setup."""


def read(ctx):
    return None if ctx.peak_reserved is None else ctx.peak_reserved / 2**30
