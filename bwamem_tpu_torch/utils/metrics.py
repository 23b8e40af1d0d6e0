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
    chrome://tracing; the batch's spans (``TIMERS.spans()``, collector
    passes included) are appended to it as complete events on their
    threads, on the profiler's timeline.
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
_local = threading.local()


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] += n


def snapshot() -> Dict:
    """One JSON-able view: counters + per-stage wall times."""
    with _lock:
        counters = dict(_counters)
    return {
        "counters": counters,
        "stage_seconds": {k: round(v, 6) for k, v in TIMERS.snapshot().items()},
        "stage_calls": TIMERS.calls(),
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


def _append_spans(path: str, batch: int) -> None:
    """The spans of ``batch`` as complete events of the Chrome trace at
    ``path``, on the host threads that ran them."""
    with open(path) as fh:
        trace = json.load(fh)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    for s in TIMERS.spans():
        if s.batch != batch:
            continue
        args = {"id": s.id, "parent": s.parent, "batch": s.batch}
        if s.generation is not None:
            args["generation"] = s.generation
        events.append({
            "ph": "X", "cat": "bwamem_tpu_torch.span", "name": s.path,
            "pid": pid, "tid": s.thread,
            "ts": (TIMERS.to_profiler_ns(s.start_ns) - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    with open(path, "w") as fh:
        json.dump(trace, fh)


@contextmanager
def _trace(trace_dir: str, batch: int):
    """One batch under torch.profiler; its Chrome trace, with the batch's
    spans, is written into ``trace_dir`` when the batch ends."""
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
    path = os.path.join(trace_dir, f"batch-{os.getpid()}-{n}.json")
    prof.export_chrome_trace(path)
    _append_spans(path, batch)


@contextmanager
def batch_scope():
    """Wraps one align_seqs batch: its ordinal for the spans
    (``TIMERS.begin_batch``), an optional torch.profiler trace and metrics
    dump, both gated on env so the default path stays zero-overhead.  A
    scope opened inside another on the same thread is part of it."""
    if getattr(_local, "open", False):
        yield
        return
    _local.open = True
    batch = TIMERS.begin_batch()
    try:
        trace_dir = os.environ.get("BWAMEM_TPU_TRACE")
        if trace_dir:
            with _trace(trace_dir, batch):
                yield
        else:
            yield
    finally:
        TIMERS.end_batch()
        _local.open = False
    sink = os.environ.get("BWAMEM_TPU_METRICS")
    if sink:
        _dump(sink)
