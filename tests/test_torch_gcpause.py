"""The collector paused around a batch's record assembly (utils/gcpause.py,
``api/aligner.py`` ``_records_stage``): after every public call the
collector is in the state the caller left it, exceptions and eight threads
included; the assemblies run with it off; one build holds the pause at a
time; a cycle made meanwhile is collected by the collector's own next pass;
``records_gc_paused`` counts one a batch."""
import gc
import sys
import threading
import weakref

import pytest

from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex
from bwamem_tpu_torch.api import aligner as aligner_mod
from bwamem_tpu_torch.engine import native_pipeline
from bwamem_tpu_torch.utils import metrics
from bwamem_tpu_torch.utils.gcpause import collector_paused
from test_torch_sam import ROTAVIRUS
from test_torch_wire import _batch

# the record assembly each public call reaches, by the name the aligner
# calls it
ASSEMBLIES = {"align_seqs": (aligner_mod, "_records_fast"),
              "align_seqs_raw": (native_pipeline, "records_from_arrays")}


@pytest.fixture()
def index():
    idx = BwaMemIndex(ROTAVIRUS)
    yield idx
    if idx.is_open():
        idx.close()


@pytest.fixture()
def collector():
    """The collector as the test found it, restored after the test."""
    was = gc.isenabled()
    yield
    (gc.enable if was else gc.disable)()


def _aligner(index, mode: str) -> BwaMemAligner:
    a = BwaMemAligner(index, device="cpu")
    if mode == "pe":
        a.align_pairs()
    return a


def _counters():
    c = metrics.snapshot()["counters"]
    return c.get("records_gc_paused", 0), c.get("records_gc_shared", 0)


class Boom(RuntimeError):
    pass


@pytest.mark.parametrize("raises", (False, True), ids=("returns", "raises"))
@pytest.mark.parametrize("enabled", (True, False), ids=("on", "off"))
@pytest.mark.parametrize("call", sorted(ASSEMBLIES))
def test_collector_back_as_the_caller_left_it(index, collector, monkeypatch,
                                              call, enabled, raises):
    """The assembly runs with the collector off; afterwards, returned or
    raised, the collector is as the caller had it, the pause is free again
    and the build is counted as paused (collector on) or shared (off)."""
    mod, name = ASSEMBLIES[call]
    assemble = getattr(mod, name)
    seen = []

    def spy(*args, **kw):
        seen.append(gc.isenabled())
        if raises:
            raise Boom("record assembly failed")
        return assemble(*args, **kw)

    monkeypatch.setattr(mod, name, spy)
    a = _aligner(index, "pe")
    seqs = _batch(4)
    metrics.reset()
    (gc.enable if enabled else gc.disable)()
    if raises:
        with pytest.raises(Boom):
            getattr(a, call)(seqs)
    else:
        out = getattr(a, call)(seqs)
        assert len(out) == len(seqs)
    assert gc.isenabled() is enabled
    assert seen == [False]
    assert _counters() == ((1, 0) if enabled else (0, 1))
    gc.enable()
    with collector_paused() as paused:
        assert paused and not gc.isenabled()
    assert gc.isenabled()


@pytest.mark.parametrize("mode", ("se", "pe"))
@pytest.mark.parametrize("call", sorted(ASSEMBLIES))
def test_records_gc_paused_counts_one_a_batch(index, collector, call, mode):
    gc.enable()
    a = _aligner(index, mode)
    seqs = _batch(6)
    metrics.reset()
    for _ in range(3):
        getattr(a, call)(seqs)
    assert _counters() == (3, 0)
    assert metrics.snapshot()["counters"]["batches"] == 3
    assert gc.isenabled()


@pytest.mark.parametrize("call", sorted(ASSEMBLIES))
def test_eight_threads_one_aligner_each(index, collector, call):
    """Eight aligners on one index, one a thread, building at once: each
    thread's records equal the same reads aligned alone, every build is
    counted once (paused or shared), and the collector is left on."""
    gc.enable()
    seqs = _batch(8)
    want = getattr(_aligner(index, "pe"), call)(seqs)
    n_threads, reps = 8, 4
    start = threading.Barrier(n_threads, timeout=60)
    results, errors = {}, []

    def worker(tid):
        try:
            a = _aligner(index, "pe")
            start.wait()
            results[tid] = [getattr(a, call)(seqs) for _ in range(reps)]
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    metrics.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert gc.isenabled()
    assert len(results) == n_threads
    assert all(r == want for rs in results.values() for r in rs)
    paused, shared = _counters()
    assert paused + shared == n_threads * reps and paused >= 1


class _Node:
    pass


def test_cycle_made_during_a_pause_is_collected_after_it(collector):
    """A cycle made and dropped on another thread while the pause is held
    survives the pause, however much that thread allocates, and is freed
    by the collector's own next pass once it ends (no ``gc.collect()``)."""
    gc.enable()
    threshold = max(gc.get_threshold()[0], 1)
    ref, kept = [], []

    def other():
        a, b = _Node(), _Node()
        a.peer, b.peer = b, a
        ref.append(weakref.ref(a))
        del a, b
        kept.append([[] for _ in range(10 * threshold)])  # past any threshold

    with collector_paused() as paused:
        assert paused
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        assert ref[0]() is not None
    assert gc.isenabled()
    for _ in range(100):
        if ref[0]() is None:
            break
        kept.append([[] for _ in range(2 * threshold)])
    assert ref[0]() is None
