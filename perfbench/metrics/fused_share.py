"""fused_share (program counter): reads that stayed on the fused device
path over all reads the path saw (``FUSED_STATS``), in %."""


def read(ctx):
    n = ctx.fused["device_reads"] + ctx.fused["host_reads"]
    return None if n == 0 else 100.0 * ctx.fused["device_reads"] / n
