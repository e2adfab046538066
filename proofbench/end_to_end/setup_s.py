"""From the process's start to the window's start, seconds: imports, the
circuit and the witness pool, the fake setup, the zkey's upload and the
graph's capture (and on a checkout's first run the kernels' build)."""


def read(ctx):
    return ctx.setup_s
