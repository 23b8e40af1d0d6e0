"""fused_copy_back_us_per_read (program span): the fused path's blocking
copies back (the program's stages under ``device_pipeline.`` whose path
ends in ``.copy_back``: the wait on the kernels before each, and the
copy), per read."""


def read(ctx):
    s = [v for k, v in ctx.stage_s.items()
         if k.startswith("device_pipeline.") and k.endswith(".copy_back")]
    return sum(s) * 1e6 / ctx.reads if s else None
