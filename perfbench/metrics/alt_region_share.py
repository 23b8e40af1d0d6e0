"""alt_region_share (program counter): of the regions that the extension
returned in the window (before dedup, fused and staged alike), the share
on an ALT contig, in % (``FUSED_STATS.alt_regions`` over
``FUSED_STATS.regions``, both reset at the window's start).  None where the
program has no such counts or returned no region."""


def read(ctx):
    try:
        from bwamem_tpu_torch.engine.pipeline_device import FUSED_STATS
    except ImportError:
        return None
    n = getattr(FUSED_STATS, "regions", None)
    alt = getattr(FUSED_STATS, "alt_regions", None)
    if not n or alt is None:
        return None
    return 100.0 * alt / n
