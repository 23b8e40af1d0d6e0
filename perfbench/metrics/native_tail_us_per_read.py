"""native_tail_us_per_read (program span): the program's ``native_tail``
stage (the C++ tail: dedup, pairing, mate rescue, records), per read."""


def read(ctx):
    s = ctx.stage_s.get("native_tail")
    return None if s is None else s * 1e6 / ctx.reads
