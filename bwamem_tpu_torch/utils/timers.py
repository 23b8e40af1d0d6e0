"""Per-stage timing / tracing.

The reference has no observability at all — the glue silences engine
logging (bwa_verbose = 0, jnibwa.c:163).  Here per-stage timers
(seed/chain/extend/finalize/pair) are first-class (SURVEY.md section 5):
cheap enough to stay on, queryable programmatically, and printable.
For device-level traces use torch.profiler around align_seqs calls.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class StageTimers:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.enabled = True

    @contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @contextmanager
    def paused(self):
        """No stage opened inside is recorded: an outer stage that spans
        code with stages of its own keeps the totals disjoint."""
        was, self.enabled = self.enabled, False
        try:
            yield
        finally:
            self.enabled = was

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def snapshot(self) -> Dict[str, float]:
        return dict(self.totals)

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-12
        lines = ["stage            time_s   calls   share"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:<16s} {t:7.3f} {self.counts[name]:7d} {100*t/total:6.1f}%"
            )
        return "\n".join(lines)


# process-global timers used by the engine pipeline
TIMERS = StageTimers()
