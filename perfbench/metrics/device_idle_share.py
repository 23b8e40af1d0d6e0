"""device_idle_share (device trace): the traced window's time with no
activity on the card, over the window, in %."""


def read(ctx):
    if not ctx.host or not ctx.card or ctx.card["busy_s"] <= 0:
        return None
    return 100.0 * ctx.host["idle_s"] / ctx.host["window_s"]
