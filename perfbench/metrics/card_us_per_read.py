"""card_us_per_read (device trace): the union of the card's activity
intervals (kernels, copies, memsets) over the window, per read."""


def read(ctx):
    if not ctx.card or ctx.card["busy_s"] <= 0:
        return None
    return ctx.card["busy_s"] * 1e6 / ctx.reads
