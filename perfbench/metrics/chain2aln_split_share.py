"""chain2aln_split_share (program counter): of the chains that the loop
kernel ran in the window (the fused path's reads), the share that ran as
chain items, a heavy read's chains on many warps, in %
(``FUSED_STATS.split_chains`` over ``FUSED_STATS.chains``, both reset at
the window's start).  None where the program has no such counts or ran no
chain."""


def read(ctx):
    try:
        from bwamem_tpu_torch.engine.pipeline_device import FUSED_STATS
    except ImportError:
        return None
    n = getattr(FUSED_STATS, "chains", None)
    split = getattr(FUSED_STATS, "split_chains", None)
    if not n or split is None:
        return None
    return 100.0 * split / n
