"""Spans of the host's work: where a batch's seconds go.

The reference has no observability at all — the glue silences engine
logging (bwa_verbose = 0, jnibwa.c:163).  Here every stage of the host's
work is a span (SURVEY.md section 5), cheap enough to stay on:

  * ``TIMERS.stage(name)`` opens a span on the calling thread.  Spans nest
    per thread: a span's path is its parent's path, a dot and its name
    (``device_pipeline.seed.copy_back``); a span opened on a thread with no
    open span (a mesh shard's, a second aligner's) is top-level there, so
    totals are thread-seconds where threads overlap.  On one thread the
    top-level paths are disjoint and a nested path subdivides its parent.
  * Each pass of the collector is a top-level span ``gc`` with its
    generation (a ``gc.callbacks`` hook, installed while ``enabled``).  A
    pass also lies inside whatever span it interrupted: ``gc`` is not
    disjoint from the other top-level paths.
  * Totals by path are always kept (``snapshot``, ``calls``); the spans
    themselves go into a bounded ring, oldest dropped and counted
    (``spans``, ``dropped``), each with its parent, its thread and the
    ordinal of the ``align_seqs`` batch it belongs to
    (``utils.metrics.batch_scope``).
  * Span times are ``time.perf_counter_ns()``; ``to_profiler_ns`` maps them
    onto the wall-clock ns that ``torch.profiler`` stamps its events with
    (the offset is read again at ``reset`` and at each batch's start).  The
    program opens no profiler range of its own: ``utils.metrics`` writes a
    traced batch's spans into its Chrome trace after the batch.
"""
from __future__ import annotations

import gc
import itertools
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional

# spans the ring keeps: a 51 s window of 66,666-read batches (~60 of them
# at E. coli size) made ~20 stage spans and ~290 collector passes a batch,
# 17,754 spans in all (PERF.md section 3): a fifteenth of this
CAPACITY = 1 << 18
GC = "gc"


class Span(NamedTuple):
    path: str
    id: int
    parent: Optional[int]  # the id of the enclosing span on the same thread
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    batch: int  # the align_seqs batch's ordinal; -1 before the first
    thread: int  # threading.get_native_id(): the profiler's tid
    generation: Optional[int]  # a collector pass's generation, else None


class _Thread:
    """A thread's open spans, its batch and the spans it closed last."""

    def __init__(self):
        self.stack: List[tuple] = []  # (id, path) of the open spans
        self.batch: Optional[int] = None
        self.tid = threading.get_native_id()
        self.last: Dict[str, int] = {}  # name -> ns of the last one closed


class StageTimers:
    def __init__(self, capacity: int = CAPACITY):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._batches = itertools.count()
        self._batch = -1  # the process's latest batch
        # the ring holds plain tuples of ints and strings, which the
        # collector stops tracking: a full ring adds nothing to its scans
        self._ring: deque = deque(maxlen=capacity)
        self._ns: Dict[str, int] = defaultdict(int)
        self._calls: Dict[str, int] = defaultdict(int)
        self._pushed = 0
        # written only by the hook: passes never overlap
        self._gc_t0 = 0
        self._gc_ns = 0
        self._gc_calls = 0
        self._gc_pushed = 0
        self._hook = self._on_gc
        self._enabled = False
        self.enabled = True
        self.reset()

    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, on: bool) -> None:
        on = bool(on)
        if on and not self._enabled:
            gc.callbacks.append(self._hook)
        elif self._enabled and not on:
            gc.callbacks.remove(self._hook)
        self._enabled = on

    def _thread(self) -> _Thread:
        try:
            return self._local.t
        except AttributeError:
            self._local.t = t = _Thread()
            return t

    @contextmanager
    def stage(self, name: str):
        if not self._enabled:
            yield
            return
        th = self._thread()
        parent = th.stack[-1] if th.stack else None
        path = name if parent is None else f"{parent[1]}.{name}"
        sid = next(self._ids)
        th.stack.append((sid, path))
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            th.stack.pop()
            th.last[name] = t1 - t0
            span = (path, sid, None if parent is None else parent[0], t0, t1,
                    self._batch if th.batch is None else th.batch, th.tid,
                    None)
            with self._lock:
                self._ns[path] += t1 - t0
                self._calls[path] += 1
                self._pushed += 1
                self._ring.append(span)

    def _on_gc(self, phase: str, info: dict) -> None:
        t = time.perf_counter_ns()
        if phase == "start":
            self._gc_t0 = t
            return
        th = self._thread()
        self._gc_ns += t - self._gc_t0
        self._gc_calls += 1
        self._gc_pushed += 1
        self._ring.append((GC, next(self._ids), None, self._gc_t0, t,
                           self._batch if th.batch is None else th.batch,
                           th.tid, info["generation"]))

    def take(self, name: str) -> float:
        """Seconds of the span named ``name`` (its last part) that this
        thread closed last, forgotten once taken: 0.0 when none closed
        since, or while the timers are off."""
        ns = self._thread().last.pop(name, 0)
        return ns / 1e9 if self._enabled else 0.0

    def begin_batch(self) -> int:
        """A new ``align_seqs`` batch on this thread: its ordinal, which
        the spans opened until ``end_batch`` carry (spans of threads
        outside a batch carry the process's latest)."""
        n = next(self._batches)
        self._batch = self._thread().batch = n
        self._sync_clock()
        return n

    def end_batch(self) -> None:
        self._thread().batch = None

    def _sync_clock(self) -> None:
        self._offset_ns = time.time_ns() - time.perf_counter_ns()

    def to_profiler_ns(self, t: int) -> int:
        """A span time on ``torch.profiler``'s timeline (Unix ns)."""
        return t + self._offset_ns

    def reset(self) -> None:
        with self._lock:
            self._ns.clear()
            self._calls.clear()
            self._ring.clear()
            self._pushed = 0
        self._gc_ns = self._gc_calls = self._gc_pushed = 0
        self._sync_clock()

    @property
    def dropped(self) -> int:
        """Spans the ring let go since ``reset``, oldest first."""
        return self._pushed + self._gc_pushed - len(self._ring)

    def spans(self) -> List[Span]:
        """The ring's spans, in the order they closed."""
        return [Span(*s) for s in list(self._ring)]

    def snapshot(self) -> Dict[str, float]:
        """Seconds by path, ``gc`` included once a pass was seen."""
        with self._lock:
            out = {k: v / 1e9 for k, v in self._ns.items()}
        if self._gc_calls:
            out[GC] = self._gc_ns / 1e9
        return out

    def calls(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._calls)
        if self._gc_calls:
            out[GC] = self._gc_calls
        return out


# process-global timers used by the engine pipeline
TIMERS = StageTimers()
