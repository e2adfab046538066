"""Proofs returned in the window over the window's seconds (host clock;
the window ends at the last proof's return)."""


def read(ctx):
    return len(ctx.window) / ctx.window_s
