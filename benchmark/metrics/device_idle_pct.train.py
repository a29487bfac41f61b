"""The share of the traced training window in which no operation ran on the card."""


def read(ctx):
    if ctx.kind != "train" or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
