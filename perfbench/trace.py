"""Device activity of a run's window, read from ``torch.profiler``.

Every run profiles its window: with ``--trace 0`` the device activities
alone (kernels, copies, memsets: no CPU operators, shapes or stacks), for
the card's busy time; with ``--trace 1`` the host too, with a labelled
range around the window, each ``align_seqs`` call and each open stage of
the program's ``TIMERS``, so that idle time on the card can be named by
what the host was doing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch

WINDOW = "perfbench.window"
BATCH = "perfbench.align_seqs"
STAGE = "perfbench.stage."


def profiler(host: bool, card: bool = True):
    acts = [torch.profiler.ProfilerActivity.CUDA] if card else []
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    return torch.profiler.profile(activities=acts)


@contextmanager
def stage_ranges(timers):
    """While open, every stage the program's ``timers`` record is also a
    labelled range in the profile.  The instance's ``stage`` is wrapped for
    this run only; the program is not edited."""
    inner = timers.stage

    @contextmanager
    def stage(name):
        if not timers.enabled:
            with inner(name):
                yield
            return
        with torch.profiler.record_function(STAGE + name), inner(name):
            yield

    timers.stage = stage
    try:
        yield
    finally:
        del timers.stage


def _events(prof):
    return prof.profiler.kineto_results.events()


def _is_device(ev) -> bool:
    """A kernel, copy or memset on the card (the profiler also mirrors the
    host's labelled ranges onto the device's timeline: those are not)."""
    return (ev.device_type() == torch.autograd.DeviceType.CUDA
            and not ev.name().startswith("perfbench."))


def short_name(name: str) -> str:
    """A device operation's name without its argument list and namespaces:
    ``void (anonymous namespace)::k<T>(int, long)`` -> ``k<T>``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i and name[i - 1] not in " ":
            return name[:i]
    return name


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def device_summary(prof) -> dict:
    """Busy seconds (the union of device activity) and seconds by name."""
    iv, by_name = [], defaultdict(int)
    for ev in _events(prof):
        if _is_device(ev):
            a = ev.start_ns()
            b = a + ev.duration_ns()
            iv.append((a, b))
            by_name[ev.name()] += b - a
    busy = _union(iv)
    return dict(busy_s=sum(b - a for a, b in busy) / 1e9,
                by_name={k: v / 1e9 for k, v in by_name.items()},
                events=len(iv), busy=busy)


def host_summary(prof, busy: List[Tuple[int, int]]) -> dict:
    """The window's length, and its idle time on the card named by the
    innermost labelled host range open at the time: a program stage, else
    ``api_and_records`` inside an ``align_seqs`` call, else ``harness``."""
    ranges, window = [], None
    for ev in _events(prof):
        if _is_device(ev):
            continue
        name = ev.name()
        a = ev.start_ns()
        b = a + ev.duration_ns()
        if name == WINDOW:
            window = (a, b)
        elif name == BATCH:
            ranges.append((a, b, "api_and_records"))
        elif name.startswith(STAGE):
            ranges.append((a, b, name[len(STAGE):]))
    if window is None:
        raise RuntimeError("the profile holds no window range")
    w0, w1 = window
    gaps, t = [], w0
    for a, b in busy:
        a, b = max(a, w0), min(b, w1)
        if a >= b:
            continue
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    # sweep the labelled ranges: between two boundaries the label is the
    # most recently opened range still open
    points = []
    for a, b, label in ranges:
        points.append((a, 1, label))
        points.append((b, 0, label))
    points.sort(key=lambda p: (p[0], p[1]))
    idle: Dict[str, float] = defaultdict(float)
    open_: List[str] = []
    gap_starts = [g[0] for g in gaps]
    prev = w0

    def charge(lo, hi, label):
        if hi <= lo:
            return
        i = max(bisect.bisect_right(gap_starts, lo) - 1, 0)
        while i < len(gaps) and gaps[i][0] < hi:
            ov = min(hi, gaps[i][1]) - max(lo, gaps[i][0])
            if ov > 0:
                idle[label] += ov / 1e9
            i += 1

    for when, is_open, label in points:
        when = min(max(when, w0), w1)
        charge(prev, when, open_[-1] if open_ else "harness")
        prev = when
        if is_open:
            open_.append(label)
        else:
            for k in range(len(open_) - 1, -1, -1):
                if open_[k] == label:
                    del open_[k]
                    break
    charge(prev, w1, open_[-1] if open_ else "harness")
    return dict(window_s=(w1 - w0) / 1e9, idle_by_stage=dict(idle),
                idle_s=sum(b - a for a, b in gaps) / 1e9)
