"""The port's metrics surface (utils/metrics.py, ``bwamem_tpu_torch.metrics()``)
against the JAX package's: the counters after a batch, a JSON-able snapshot
of the same shape, the ``BWAMEM_TPU_METRICS`` sink (a file, or ``-`` for
stderr), the engine's counters at their counterparts of the JAX engine's
places, and ``BWAMEM_TPU_TRACE`` writing a Chrome trace of each batch on the
CPU without changing its records."""
import dataclasses
import glob
import json

import pytest

import bwamem_tpu
import bwamem_tpu_torch
from bwamem_tpu.utils import metrics as j_metrics
from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex
from bwamem_tpu_torch.utils import metrics
from test_torch_sam import ROTAVIRUS
from test_torch_wire import _batch

READ_L1 = b"GGCTTTTAATGCTTTTCAGTGGTTGCTGCTCAAGATGGAGTCTACTCAGCAGATGGTAAGCTCTATTATT"


@pytest.fixture()
def index():
    idx = BwaMemIndex(ROTAVIRUS)
    yield idx
    idx.close()


def test_counters_and_snapshot(index):
    metrics.reset()
    BwaMemAligner(index, device="cpu").align_seqs([READ_L1])
    snap = bwamem_tpu_torch.metrics()
    assert snap["counters"]["batches"] == 1
    assert snap["counters"]["reads"] == 1
    assert snap["counters"]["records"] >= 1
    assert isinstance(snap["stage_seconds"], dict)
    assert snap["stage_calls"]["native_tail"] == 1
    assert set(snap) == set(bwamem_tpu.metrics())
    json.dumps(snap)  # JSON-able


@pytest.mark.parametrize("raw", (False, True), ids=("align_seqs", "raw"))
@pytest.mark.parametrize("mode", ("se", "pe"))
def test_batch_counters_equal_the_jax_aligners(index, mode, raw):
    """batches, reads and records after the same two batches through each
    package's aligner (``align_seqs`` or ``align_seqs_raw``)."""
    seqs = _batch(12)
    got = []
    for top, m in ((bwamem_tpu, j_metrics), (bwamem_tpu_torch, metrics)):
        idx = top.BwaMemIndex(ROTAVIRUS)
        a = (top.BwaMemAligner(idx) if top is bwamem_tpu
             else top.BwaMemAligner(idx, device="cpu"))
        if mode == "pe":
            a.align_pairs()
        m.reset()
        for _ in range(2):
            (a.align_seqs_raw if raw else a.align_seqs)(seqs)
        c = top.metrics()["counters"]
        got.append({k: c[k] for k in ("batches", "reads", "records")})
        idx.close()
    assert got[0] == got[1] and got[1]["batches"] == 2
    assert got[1]["reads"] == 2 * len(seqs)


def test_metrics_dump_sink(index, tmp_path, monkeypatch):
    sink = tmp_path / "metrics.json"
    monkeypatch.setenv("BWAMEM_TPU_METRICS", str(sink))
    metrics.reset()
    BwaMemAligner(index, device="cpu").align_seqs(
        [b"ACGTACGTACGTACGTACGTACGTACGTACGTACGT"])
    payload = json.loads(sink.read_text())
    assert "counters" in payload and "stage_seconds" in payload
    assert payload["counters"]["reads"] == 1


def test_metrics_dump_to_stderr(index, monkeypatch, capsys):
    monkeypatch.setenv("BWAMEM_TPU_METRICS", "-")
    metrics.reset()
    BwaMemAligner(index, device="cpu").align_seqs_raw([READ_L1, READ_L1])
    payload = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert payload["counters"]["batches"] == 1
    assert payload["counters"]["reads"] == 2


def test_engine_counters(index):
    """The wave driver's counters (the JAX engine's extend_batch.py), the
    fused path's (pipeline_device.py) and the device seeding's
    (seed_device.py), on the plain versions on the CPU."""
    seqs = _batch(12)
    waves = BwaMemAligner(index, device="cpu", min_device_jobs=1,
                          device_stages=("seed",))
    waves._exec_cfg = dataclasses.replace(waves._exec_cfg, force_waves=True)
    metrics.reset()
    waves.align_seqs(seqs)
    c = metrics.snapshot()["counters"]
    assert c["extend_waves"] == c["device_extend_waves"] > 0
    assert c["device_extend_jobs"] == c["extend_jobs"] > 0
    assert c["device_seed_fused_batches"] == 1
    assert "device_fused_pipeline_batches" not in c
    fused = BwaMemAligner(index, device="cpu", device_pipeline=True)
    metrics.reset()
    fused.align_seqs(seqs)
    fused.align_seqs(seqs)
    c = metrics.snapshot()["counters"]
    assert c["device_fused_pipeline_batches"] == 2
    assert c["device_seed_fused_batches"] == 2
    assert "extend_waves" not in c  # no read left the fused path
    host = BwaMemAligner(index, device="cpu")
    metrics.reset()
    host.align_seqs(seqs)
    assert set(metrics.snapshot()["counters"]) == {"batches", "reads",
                                                   "records",
                                                   "records_gc_paused"}


def test_trace_writes_chrome_trace(index, tmp_path, monkeypatch):
    seqs = _batch(2)
    a = BwaMemAligner(index, device="cpu", device_pipeline=True)
    a.align_pairs()
    plain = a.align_seqs(seqs)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("BWAMEM_TPU_TRACE", str(trace_dir))
    traced = a.align_seqs(seqs)
    a.align_seqs_raw(seqs)
    assert [[vars(x) for x in r] for r in traced] == [[vars(x) for x in r]
                                                      for r in plain]
    files = sorted(glob.glob(str(trace_dir / "batch-*.json")))
    assert len(files) == 2
    for f in files:
        with open(f) as fh:
            events = json.load(fh)["traceEvents"]
        assert any(e.get("ph") == "X" for e in events)


def test_trace_carries_the_batch_spans(index, tmp_path, monkeypatch):
    """A traced batch's file holds its spans as complete events on the
    profiler's timeline: ``native_tail`` and ``records`` fall inside the
    extent of the profiler's own events, on the thread that ran them."""
    import threading

    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("BWAMEM_TPU_TRACE", str(trace_dir))
    a = BwaMemAligner(index, device="cpu", device_pipeline=True)
    a.align_pairs()
    a.align_seqs(_batch(4))
    (f,) = glob.glob(str(trace_dir / "batch-*.json"))
    with open(f) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "bwamem_tpu_torch.span"]
    own = [e for e in events if e.get("ph") == "X" and e not in spans]
    lo = min(e["ts"] for e in own)
    hi = max(e["ts"] + e["dur"] for e in own)
    names = {e["name"] for e in spans}
    assert {"encode", "device_pipeline", "device_pipeline.chain2aln.copy_back",
            "native_tail", "records"} <= names
    assert len({e["args"]["batch"] for e in spans}) == 1
    for e in spans:
        if e["name"] in ("native_tail", "records"):
            assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi
            assert e["tid"] == threading.get_native_id()
