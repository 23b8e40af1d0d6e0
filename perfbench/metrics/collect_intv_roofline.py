"""collect_intv_roofline (device trace): the least time the window's
seeding work could take on the card, over ``collect_intv_kernel``'s summed
device time, in %.

The work is the plain reference's on the traffic's fixed work sample
(``perfbench/work.py``), per read, times the window's reads: each
``bwt_extend`` reads one or two 48-byte occurrence lines and counts a
symbol over the 16-base words of its blocks up to its rows, at about 14
integer operations a word, plus 20 for the interval arithmetic; each SMEM
interval out is 40 bytes, each read's bases are read once.  Lines are
counted at most once: no more than the whole table.
"""
from perfbench.peaks import bound_s, kernel_s

NEEDS_WORK = True
LINE_BYTES = 48
OPS_PER_WORD = 14
OPS_PER_EXTEND = 20
INTERVAL_BYTES = 40


def read(ctx):
    if not ctx.card or not ctx.work:
        return None
    t = kernel_s(ctx.card["by_name"], "collect_intv_kernel")
    if t <= 0:
        return None
    w, scale = ctx.work, ctx.reads / ctx.work["reads"]
    table = (ctx.seq_len + 1) / 128 * LINE_BYTES
    nbytes = (ctx.reads * ctx.read_len
              + w["intervals"] * scale * INTERVAL_BYTES
              + min(LINE_BYTES * w["lines"] * scale, table))
    ops = (OPS_PER_WORD * w["words"] + OPS_PER_EXTEND * w["extends"]) * scale
    b = bound_s(ctx.kind, nbytes, ops)
    return None if b is None else 100.0 * b / t
