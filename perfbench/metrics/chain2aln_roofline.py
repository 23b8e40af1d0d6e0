"""chain2aln_roofline (device trace): the least time the window's chain
extension could take on the card, over ``chain2aln_kernel``'s summed
device time, in %.

The work is the band cells of bwa's ``ksw_extend2`` that the plain
reference computes on the traffic's fixed work sample (``perfbench/work.py``),
per read, times the window's reads, at 10 integer operations a cell; the
bytes are each read's bases once.
"""
from perfbench.peaks import bound_s, kernel_s

NEEDS_WORK = True
OPS_PER_CELL = 10


def read(ctx):
    if not ctx.card or not ctx.work:
        return None
    t = kernel_s(ctx.card["by_name"], "chain2aln_kernel")
    if t <= 0:
        return None
    cells = ctx.work["cells"] * ctx.reads / ctx.work["reads"]
    b = bound_s(ctx.kind, ctx.reads * ctx.read_len, OPS_PER_CELL * cells)
    return None if b is None else 100.0 * b / t
