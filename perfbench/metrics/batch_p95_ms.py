"""batch_p95_ms (host clock): the 95th percentile over all the window's
``align_seqs`` calls, each timed from hand-over to records on the host."""
import statistics


def read(ctx):
    if len(ctx.latencies_s) < 2:
        return None
    return statistics.quantiles(ctx.latencies_s, n=100,
                                method="inclusive")[94] * 1e3
