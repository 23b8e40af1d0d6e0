#!/usr/bin/env python3
"""What bwamem_tpu_torch's always-on spans (utils/timers.py) cost, and how
many a batch makes.

    python3 tools/span_cost.py [--cell ecoli.pe150 --seed N --seconds S]

On the host alone: ns a span takes to open and close (top-level, and
nested under another), and ns the collector hook adds to a pass (a
generation-0 ``gc.collect`` timed with the hook installed and without).
With ``--cell``, one window of that benchmark cell (``perfbench``'s
harness, on the card it asks for) and then, from the program's ring: the
batches, the stage spans and collector passes a batch, the passes by
generation with their seconds and by the stage each fell in, the ring's
length and its drops.  The last line is one JSON object.  Nothing of JAX
is imported.
"""
import argparse
import bisect
import gc
import json
import os
import statistics
import sys
import time
from collections import Counter
from contextlib import nullcontext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bwamem_tpu_torch.utils.timers import GC, StageTimers  # noqa: E402


def _ns_per(fn, n: int, reps: int = 7) -> float:
    """The median over ``reps`` of ``fn(n)``'s ns per iteration."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        fn(n)
        out.append((time.perf_counter_ns() - t0) / n)
    return statistics.median(out)


def host_costs(n: int = 200_000) -> dict:
    t = StageTimers()

    def flat(k):
        for _ in range(k):
            with t.stage("a"):
                pass

    def nested(k):
        with t.stage("outer"):
            for _ in range(k):
                with t.stage("a"):
                    pass

    def empty(k):
        for _ in range(k):
            with nullcontext():
                pass

    def passes(k):
        for _ in range(k):
            gc.collect(0)

    out = dict(span_ns=_ns_per(flat, n), nested_span_ns=_ns_per(nested, n),
               nullcontext_ns=_ns_per(empty, n))
    t.reset()
    out["gc0_pass_with_hook_ns"] = _ns_per(passes, 20_000)
    t.enabled = False
    out["gc0_pass_without_hook_ns"] = _ns_per(passes, 20_000)
    out["hook_ns_per_pass"] = (out["gc0_pass_with_hook_ns"]
                               - out["gc0_pass_without_hook_ns"])
    return out


def _passes_by_stage(spans, passes) -> dict:
    """The collector's seconds by the innermost stage each pass fell in (on
    the pass's thread; ``-`` outside every stage)."""
    stages = sorted((s for s in spans if s.path != GC),
                    key=lambda s: s.start_ns)
    starts = [s.start_ns for s in stages]
    out = Counter()
    for p in passes:
        at, where = bisect.bisect_right(starts, p.start_ns) - 1, "-"
        while at >= 0:
            s = stages[at]
            if s.thread == p.thread and s.end_ns >= p.end_ns:
                where = s.path
                break
            at -= 1
        out[where] += (p.end_ns - p.start_ns) / 1e9
    return dict(out.most_common())


def cell_counts(name: str, seed: int, seconds: float) -> dict:
    from perfbench import harness
    from bwamem_tpu_torch.utils.timers import TIMERS

    cell = harness.load_cell(name)
    harness.set_threads(cell["config"])
    result = harness.run_cell(cell, seed, seconds, trace=False)
    spans = TIMERS.spans()  # the window's, and the reference check's after
    end = max(s.end_ns for s in spans if s.path != GC)
    window = [s for s in spans if s.end_ns <= end]
    batches = {s.batch for s in window if s.path != GC}
    passes = [s for s in window if s.path == GC]
    by_gen = Counter(s.generation for s in passes)
    secs = Counter()
    for s in passes:
        secs[s.generation] += (s.end_ns - s.start_ns) / 1e9
    nb = max(len(batches), 1)
    return dict(
        correct=result["correct"], metrics=result["metrics"],
        batches=len(batches),
        stage_spans_per_batch=(len(window) - len(passes)) / nb,
        passes_per_batch=len(passes) / nb,
        passes_by_generation=dict(sorted(by_gen.items())),
        pass_seconds_by_generation=dict(sorted(secs.items())),
        pass_seconds_by_stage=_passes_by_stage(window, passes),
        ring=len(spans), dropped=TIMERS.dropped,
        stage_calls=TIMERS.calls())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell")
    ap.add_argument("--seed", type=int, default=2**31 + 5)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args()
    out = dict(host=host_costs())
    print(json.dumps(out["host"]), flush=True)
    if args.cell:
        out["cell"] = cell_counts(args.cell, args.seed, args.seconds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
