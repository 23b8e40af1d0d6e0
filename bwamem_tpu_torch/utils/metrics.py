"""Structured metrics + device tracing (SURVEY.md section 5).

The port's counterpart of bwamem_tpu/utils/metrics.py, with the same
counters, snapshot and sinks; only the trace differs:

  * counters — reads aligned, records emitted, batches, device waves —
    accumulate process-wide alongside the per-stage timers
    (utils/timers.py) and are queryable as one JSON-able snapshot via
    :func:`snapshot` (surfaced as ``bwamem_tpu_torch.metrics()``);
  * ``BWAMEM_TPU_METRICS=<path|->`` dumps the snapshot after every
    ``align_seqs`` batch (``-`` = stderr) — a scrape surface for
    production monitoring;
  * ``BWAMEM_TPU_TRACE=<dir>`` wraps each ``align_seqs`` batch in
    ``torch.profiler.profile`` (CPU activities, and CUDA ones where a card
    is present) and writes the batch's Chrome trace into ``<dir>`` as
    ``batch-<pid>-<n>.json``, so the kernels show up in Perfetto or
    chrome://tracing.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

from .timers import TIMERS

_lock = threading.Lock()
_counters: Dict[str, int] = defaultdict(int)
_traces = itertools.count()


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] += n


def snapshot() -> Dict:
    """One JSON-able view: counters + per-stage wall times."""
    with _lock:
        counters = dict(_counters)
    return {
        "counters": counters,
        "stage_seconds": {k: round(v, 6) for k, v in TIMERS.totals.items()},
        "stage_calls": dict(TIMERS.counts),
    }


def reset() -> None:
    with _lock:
        _counters.clear()
    TIMERS.reset()


def _dump(sink: str) -> None:
    payload = json.dumps(snapshot())
    if sink == "-":
        print(payload, file=sys.stderr)
    else:
        with open(sink, "w") as fh:
            fh.write(payload + "\n")


@contextmanager
def _trace(trace_dir: str):
    """One batch under torch.profiler; its Chrome trace is written into
    ``trace_dir`` when the batch ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    with _lock:
        n = next(_traces)
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"batch-{os.getpid()}-{n}.json"))


@contextmanager
def batch_scope():
    """Wraps one align_seqs batch: optional torch.profiler trace + metrics
    dump, both gated on env so the default path stays zero-overhead."""
    trace_dir = os.environ.get("BWAMEM_TPU_TRACE")
    if trace_dir:
        with _trace(trace_dir):
            yield
    else:
        yield
    sink = os.environ.get("BWAMEM_TPU_METRICS")
    if sink:
        _dump(sink)
