"""device_pipeline_us_per_read (program span): the program's
``device_pipeline`` stage (the fused path's host glue, launches, copies
and the staged sub-batch), per read: the stage's own total, which holds
the stages nested in it (recorded under ``device_pipeline.<stage>``)."""


def read(ctx):
    s = ctx.stage_s.get("device_pipeline")
    return None if s is None else s * 1e6 / ctx.reads
