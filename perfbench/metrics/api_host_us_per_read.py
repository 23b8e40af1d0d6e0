"""api_host_us_per_read (program span): the window's host seconds outside
the program's ``device_pipeline`` and ``native_tail`` stages (the API,
``_records_fast`` and the harness's loop), per read."""


def read(ctx):
    inner = ctx.stage_s.get("device_pipeline", 0.0) + ctx.stage_s.get(
        "native_tail", 0.0)
    return (ctx.seconds - inner) * 1e6 / ctx.reads
