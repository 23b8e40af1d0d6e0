"""The readers of the program's spans, on hand-made contexts: the records'
and the collector's seconds per read, the fused path's copies back, and the
card's idle time that lies inside the collector's passes."""
from __future__ import annotations

import gc
from types import SimpleNamespace

import pytest
from perfbench_tiny import ROOT

from perfbench import harness

def _reader(name):
    return harness.metric_module(ROOT, name)


def _ctx(stage_s, reads=1_000_000, card=None, host=None):
    return SimpleNamespace(stage_s=stage_s, reads=reads, card=card, host=host)


STAGES = {"device_pipeline": 2.0, "device_pipeline.seed": 0.8,
          "device_pipeline.seed.copy_back": 0.25,
          "device_pipeline.chain2aln": 0.5,
          "device_pipeline.chain2aln.copy_back": 0.5,
          "device_pipeline.staged.extend.extend_wave": 0.1,
          "seed.copy_back": 9.0,  # a staged route's, outside the fused path
          "native_tail": 4.0, "records": 9.0, "gc": 4.0}


@pytest.mark.parametrize("name, want", (
    ("records_us_per_read", 9.0), ("gc_us_per_read", 4.0),
    ("fused_copy_back_us_per_read", 0.75)))
def test_span_totals_per_read(name, want):
    assert _reader(name).read(_ctx(STAGES)) == pytest.approx(want)
    # a program without the span (the parent of the change) reads nothing
    assert _reader(name).read(_ctx({"device_pipeline": 2.0})) is None


def test_gc_idle_share_joins_passes_with_the_cards_idle_time():
    share = _reader("gc_idle_share").share
    busy = [(100, 200), (400, 500), (800, 900)]
    # envelope 100-900: 300 busy, 500 idle; the passes: 150-300 (100 idle,
    # 50 busy), 450-700 (200 idle), 880-1000 (outside past 900)
    passes = [(150, 300), (450, 700), (880, 1000), (0, 50)]
    assert share(busy, passes, 10_000) == pytest.approx(100.0 * 300 / 500)
    # the window's length clips the envelope: 100-600, 300 idle, 200 of it
    # in the passes
    assert share(busy, passes, 500) == pytest.approx(100.0 * 200 / 300)
    assert share(busy, [], 10_000) == 0.0
    assert share([(0, 10)], [(0, 10)], 100) is None  # no idle time


class _FakeTimers:
    def __init__(self, spans, dropped=0, offset=1_000):
        self._spans, self.dropped, self.offset = spans, dropped, offset

    def spans(self):
        return self._spans

    def to_profiler_ns(self, t):
        return t + self.offset


def _span(path, a, b):
    return SimpleNamespace(path=path, start_ns=a, end_ns=b)


def test_gc_idle_share_reads_the_programs_ring(monkeypatch):
    from bwamem_tpu_torch.utils import timers

    reader = _reader("gc_idle_share")
    card = dict(busy=[(1_100, 1_200), (1_400, 1_500)])
    ctx = _ctx({}, card=card, host=dict(window_s=1.0))
    spans = [_span("gc", 250, 350), _span("records", 200, 450)]
    monkeypatch.setattr(timers, "TIMERS", _FakeTimers(spans))
    # the pass mapped to 1,250-1,350: 100 of the 200 idle ns
    assert reader.read(ctx) == pytest.approx(50.0)
    monkeypatch.setattr(timers, "TIMERS", _FakeTimers(spans, dropped=3))
    assert reader.read(ctx) is None  # the ring let spans go
    monkeypatch.setattr(timers, "TIMERS", _FakeTimers(spans[1:]))
    assert reader.read(ctx) is None  # no pass
    monkeypatch.setattr(timers, "TIMERS", _FakeTimers(spans))
    assert reader.read(_ctx({}, card=dict(busy=[]),
                            host=dict(window_s=1.0))) is None
    assert reader.read(_ctx({})) is None  # an untraced run


def test_gc_idle_share_on_the_real_timers():
    """The program's own ring: a pass forced between two busy intervals
    placed around it on the profiler's timeline."""
    from bwamem_tpu_torch.utils.timers import TIMERS

    TIMERS.reset()
    gc.collect()
    (p,) = [s for s in TIMERS.spans() if s.path == "gc" and s.generation == 2]
    a, b = TIMERS.to_profiler_ns(p.start_ns), TIMERS.to_profiler_ns(p.end_ns)
    n = b - a
    card = dict(busy=[(a - n, a), (b, b + n)])
    ctx = _ctx({}, card=card, host=dict(window_s=3 * n / 1e9))
    assert _reader("gc_idle_share").read(ctx) == pytest.approx(100.0)
