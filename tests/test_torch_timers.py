"""The port's spans (utils/timers.py): paths that nest per thread, totals by
path, collector passes as spans, the bounded ring, the profiler's clock,
and the fused path's step seconds taken from its spans."""
import gc
import threading
import time

import pytest
import torch

from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex
from bwamem_tpu_torch.engine.pipeline_device import FUSED_STATS
from bwamem_tpu_torch.utils.timers import GC, TIMERS, StageTimers
from test_torch_sam import ROTAVIRUS
from test_torch_wire import _batch, rotavirus_genome


@pytest.fixture()
def timers():
    t = StageTimers()
    yield t
    t.enabled = False  # takes its collector hook out


def test_paths_nest_and_totals_are_kept_by_path(timers):
    with timers.stage("a"):
        with timers.stage("b"):
            with timers.stage("c"):
                time.sleep(0.002)
        with timers.stage("b"):
            pass
    with timers.stage("b"):
        pass
    snap, calls = timers.snapshot(), timers.calls()
    stages = {k: v for k, v in snap.items() if k != GC}
    assert set(stages) == {"a", "a.b", "a.b.c", "b"}
    assert calls["a.b"] == 2 and calls["a"] == calls["b"] == 1
    assert snap["a"] >= snap["a.b"] >= snap["a.b.c"] >= 0.002
    by_path = {}
    for s in timers.spans():
        by_path.setdefault(s.path, []).append(s)
    (a,), (c,) = by_path["a"], by_path["a.b.c"]
    assert a.parent is None and by_path["b"][0].parent is None
    assert all(s.parent == a.id for s in by_path["a.b"])
    assert c.parent == by_path["a.b"][0].id
    assert a.start_ns <= c.start_ns <= c.end_ns <= a.end_ns
    assert {s.thread for s in timers.spans()} == {threading.get_native_id()}
    assert timers.take("b") > 0 and timers.take("b") == 0.0


def test_threads_nest_on_their_own_and_never_switch_the_timers_off(timers):
    """Two threads inside stages at once, leaving them out of order: each
    keeps its own parents and totals, and nothing is switched off (the
    pause that this replaces left ``enabled`` False for good)."""
    inside = threading.Barrier(2)
    leave_b = threading.Event()

    def work(name, first):
        with timers.stage(name):
            inside.wait()
            with timers.stage("inner"):
                if not first:
                    leave_b.wait()
                time.sleep(0.001)
        if first:
            leave_b.set()

    threads = [threading.Thread(target=work, args=("outer_a", True)),
               threading.Thread(target=work, args=("outer_b", False))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert timers.enabled
    calls = timers.calls()
    for name in ("outer_a", "outer_b"):
        assert calls[name] == calls[f"{name}.inner"] == 1
    spans = {s.path: s for s in timers.spans()}
    for name in ("outer_a", "outer_b"):
        outer, inner = spans[name], spans[f"{name}.inner"]
        assert inner.parent == outer.id and inner.thread == outer.thread
    assert spans["outer_a"].thread != spans["outer_b"].thread
    with timers.stage("after"):
        pass
    assert timers.calls()["after"] == 1


def test_a_collection_inside_a_stage_is_a_gc_span(timers):
    with timers.stage("work"):
        gc.collect()
    passes = [s for s in timers.spans() if s.path == GC]
    assert any(s.generation == 2 for s in passes)
    assert all(s.parent is None for s in passes)
    work = next(s for s in timers.spans() if s.path == "work")
    full = next(s for s in passes if s.generation == 2)
    assert work.start_ns <= full.start_ns <= full.end_ns <= work.end_ns
    assert timers.snapshot()[GC] > 0 and timers.calls()[GC] >= 1
    timers.enabled = False
    n = len(timers.spans())
    gc.collect()
    with timers.stage("off"):
        pass
    assert len(timers.spans()) == n and "off" not in timers.snapshot()


def test_spans_map_onto_the_profilers_clock(timers):
    """A ``record_function`` opened inside a span lies inside the span's
    times mapped by ``to_profiler_ns``, within a millisecond."""
    from torch.profiler import ProfilerActivity, profile, record_function

    timers.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with timers.stage(f"span{i}"):
                with record_function(f"probe{i}"):
                    torch.ones(64).sum()
                time.sleep(0.002)
    spans = {s.path: s for s in timers.spans()}
    probes = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("probe")}
    assert len(probes) == 3
    for i in range(3):
        s, ev = spans[f"span{i}"], probes[f"probe{i}"]
        a, b = timers.to_profiler_ns(s.start_ns), timers.to_profiler_ns(s.end_ns)
        assert a - 1_000_000 <= ev.start_ns()
        assert ev.start_ns() + ev.duration_ns() <= b + 1_000_000


def test_the_ring_keeps_its_capacity_and_counts_drops():
    t = StageTimers(capacity=8)
    gc.disable()  # no collector pass in the count
    try:
        for i in range(20):
            with t.stage(f"s{i}"):
                pass
        spans = t.spans()
        assert len(spans) == 8 and t.dropped == 12
        assert [s.path for s in spans] == [f"s{i}" for i in range(12, 20)]
        assert t.calls()["s0"] == 1  # totals outlive the ring
        t.reset()
        assert t.spans() == [] and t.dropped == 0 and t.snapshot() == {}
    finally:
        gc.enable()
        t.enabled = False


@pytest.mark.parametrize("staged", (False, True), ids=("fused", "staged"))
def test_fused_step_seconds_are_the_spans_sums(staged):
    """``FUSED_STATS.seconds`` is filled from the fused path's spans: each
    step equals its paths' totals under ``device_pipeline``.  Reads of 800
    bases leave the fused path (``fcs_noop`` false) for the staged one."""
    seqs = _batch(12)
    if staged:
        fwd = rotavirus_genome()
        for s in (50, 250):
            read = fwd[s: s + 800].copy()
            read[[40, 760]] = (read[[40, 760]] + 1) % 4  # extended both ways
            seqs += [bytes(b"ACGT"[c] for c in read)]
    index = BwaMemIndex(ROTAVIRUS)
    try:
        a = BwaMemAligner(index, device="cpu", device_pipeline=True)
        a.align_pairs()
        a.align_seqs(_batch(4))
        TIMERS.reset()
        FUSED_STATS.reset()
        for _ in range(2):
            a.align_seqs(seqs)
    finally:
        index.close()
    snap = TIMERS.snapshot()
    dp = "device_pipeline."
    assert (FUSED_STATS.host_reads > 0) == staged == (dp + "staged" in snap)
    want = {"seed_sa": snap[dp + "seed"] + snap[dp + "sa_lookup"],
            "chain": snap[dp + "chain"], "chain2aln": snap[dp + "chain2aln"],
            "decode": snap[dp + "decode"],
            "staged": snap.get(dp + "staged", 0.0)}
    assert FUSED_STATS.seconds == pytest.approx(want, rel=1e-9, abs=1e-12)
    assert snap[dp + "chain2aln.copy_back"] <= snap[dp + "chain2aln"]
    assert snap[dp + "seed.copy_back"] <= snap[dp + "seed"]
    for top in ("encode", "device_pipeline", "native_tail", "records"):
        assert TIMERS.calls()[top] >= 2
    children = {k: v for k, v in snap.items() if k.startswith(dp)}
    for parent in ("device_pipeline",) + tuple(children):
        inner = sum(v for k, v in children.items()
                    if k.rsplit(".", 1)[0] == parent)
        assert inner <= snap[parent]
    if staged:
        for step in ("chain", "flt", "extend", "extend.extend_wave"):
            assert TIMERS.calls()[f"{dp}staged.{step}"] >= 2


def test_no_total_is_lost_under_thread_switches(timers):
    """More threads than cores, switching every microsecond, each nesting
    stages: every total and count comes out exact, and every span is in the
    ring or counted as dropped."""
    import sys

    n_threads, reps = 16, 300
    errors = []

    def work(i):
        try:
            for _ in range(reps):
                with timers.stage("outer"):
                    with timers.stage("inner"):
                        pass
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    calls = timers.calls()
    assert calls["outer"] == calls["outer.inner"] == n_threads * reps
    assert set(calls) - {GC} == {"outer", "outer.inner"}
    stage_spans = [s for s in timers.spans() if s.path != GC]
    assert len(stage_spans) == 2 * n_threads * reps and timers.dropped == 0
    ids = {s.id: s for s in stage_spans}
    for s in stage_spans:
        if s.path == "outer.inner":
            assert ids[s.parent].path == "outer"
            assert ids[s.parent].thread == s.thread
