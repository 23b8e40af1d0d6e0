"""device_pipeline_us_per_read (program span): the program's
``device_pipeline`` stage (the fused path's host glue, launches, copies
and the staged sub-batch; its inner stages are paused), per read."""


def read(ctx):
    s = ctx.stage_s.get("device_pipeline")
    return None if s is None else s * 1e6 / ctx.reads
