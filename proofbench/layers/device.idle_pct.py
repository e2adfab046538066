"""Device: the share of the traced stretch (from the first traced proof's
start to the last one's return) in which no kernel, copy or memset runs
on the card, percent."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
