"""reads_per_s (host clock): every read whose records came back in the
window, over the window's seconds (the window ends in a synchronize)."""


def read(ctx):
    return ctx.reads / ctx.seconds
