"""gc_idle_share (program span): of the card's idle time inside the window,
the share that lies inside a pass of the collector, in %.

The passes are the program's ``gc`` spans (``TIMERS.spans()``), mapped onto
the profiler's timeline by ``TIMERS.to_profiler_ns``; the card's busy
intervals are the traced run's (``ctx.card["busy"]``, the same ns).  The
window is the envelope of the busy intervals, no longer than the run's
``ctx.host["window_s"]``.  None where the program keeps no spans, where
its ring dropped some, or where it holds no pass."""
import bisect


def share(busy, passes, window_ns):
    """Of the idle time in the envelope of ``busy`` (sorted, disjoint
    (start, end) ns intervals) clipped to ``window_ns``, the share inside
    ``passes`` (disjoint (start, end) intervals), in %; None without idle
    time."""
    w0 = busy[0][0]
    w1 = min(max(b for _, b in busy), w0 + window_ns)
    starts = [a for a, _ in busy]

    def busy_in(lo, hi):
        t, i = 0, max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(busy) and busy[i][0] < hi:
            t += max(0, min(hi, busy[i][1]) - max(lo, busy[i][0]))
            i += 1
        return t

    idle = (w1 - w0) - busy_in(w0, w1)
    if idle <= 0:
        return None
    in_gc = 0
    for a, b in passes:
        a, b = max(a, w0), min(b, w1)
        if a < b:
            in_gc += (b - a) - busy_in(a, b)
    return 100.0 * in_gc / idle


def read(ctx):
    if not ctx.card or not ctx.host or not ctx.card["busy"]:
        return None
    try:
        from bwamem_tpu_torch.utils.timers import TIMERS
    except ImportError:
        return None
    if not hasattr(TIMERS, "spans") or TIMERS.dropped:
        return None
    ns = TIMERS.to_profiler_ns
    passes = [(ns(s.start_ns), ns(s.end_ns)) for s in TIMERS.spans()
              if s.path == "gc"]
    if not passes:
        return None
    return share(ctx.card["busy"], passes, ctx.host["window_s"] * 1e9)
