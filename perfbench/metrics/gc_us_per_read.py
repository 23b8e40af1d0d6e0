"""gc_us_per_read (program span): the collector's passes in the window (the
program's ``gc`` spans, every generation; each also lies inside the stage
it interrupted), per read."""


def read(ctx):
    s = ctx.stage_s.get("gc")
    return None if s is None else s * 1e6 / ctx.reads
