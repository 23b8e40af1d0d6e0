"""The cyclic collector paused around one build of a batch's records.

A batch's records are ~350,000 tracked containers at 66,666 reads (a list
a read; a ``BwaMemAlignment`` a record and its ``__dict__``; the assembly's
tuples), all alive until the assembly returns.  With the collector running,
every tenth young pass promotes them, and once a quarter of the oldest
generation's size has been promoted CPython runs a full pass over every
object the process holds: ~2 such passes a batch, ~140 ms each on an
H100 machine's host, none of which can free a record, since the record
assemblies make no reference cycles (reference counting frees a batch when
its caller drops it).  ``collector_paused`` keeps the automatic passes out
of one build:

* it calls ``gc.disable()`` and, on every way out, ``gc.enable()``, but
  only where the collector was enabled when the pause was taken: a caller
  that turned it off keeps it off;
* one build at a time holds the pause (a non-blocking try of a module
  lock, since the collector's switch is the process's); a thread that
  finds it held builds without pausing, so no group of threads (aligners
  one per thread, a mesh's shards) keeps the collector off for longer than
  one build;
* nothing is skipped: the allocation counts run on while the collector is
  off, so cyclic garbage made meanwhile on any thread is collected by the
  first pass after the resume.
"""
from __future__ import annotations

import gc
import threading
from contextlib import contextmanager

_held = threading.Lock()


@contextmanager
def collector_paused():
    """Runs the body with the automatic collector off; yields True where
    this call took the pause, False where it found the collector already
    off or the pause held by another thread (the body then runs as is)."""
    if not _held.acquire(blocking=False):
        yield False
        return
    try:
        if not gc.isenabled():
            yield False
            return
        gc.disable()
        try:
            yield True
        finally:
            gc.enable()
    finally:
        _held.release()
