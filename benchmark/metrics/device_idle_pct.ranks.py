"""The share of the traced window in which no operation ran on the card
(ranks cells)."""


def read(ctx):
    if ctx.kind != "ranks" or ctx.window_s <= 0 or not ctx.ops:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
