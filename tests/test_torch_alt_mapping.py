"""bwa's ALT-aware mapping on a reference assembly of the shape of the
benchmark's ``grch38-chr6-mhc`` configuration (a primary contig and seven
ALT haplotypes of one region of it, made by ``perfbench/genome.py``), cut
to a primary of 300 kbp: reads drawn mostly from the region and its copies
go through the port's normal path (``build_index``, the ``.alt`` file read
by ``read_alt_into``, the image, ``BwaMemAligner.align_seqs``) on each CPU
route, and every record equals the plain reference's (``perfbench/
reference``), field by field.  What the ALT path did is counted as the
reference counts it on the same reads: the regions the extension returned
and those on an ALT contig (``FUSED_STATS``), and the C++ tail's ALT reads,
``alt_sc`` primaries, ALT entries of XA and the ends of proper pairs whose
best ALT hit stays primary (``metrics()`` counters); the tail's XA time for
reads with an ALT hit is the ``native_tail.alt_xa`` path of ``TIMERS``.
Nothing is counted on a genome without ALT contigs, and the window's resets
start the counts again.
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex, BwaMemPairEndStats
from bwamem_tpu_torch.engine.pipeline_device import FUSED_STATS
from bwamem_tpu_torch.index import image
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.index.bwtfile import read_alt_into
from bwamem_tpu_torch.utils import metrics
from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig
from bwamem_tpu_torch.utils.timers import TIMERS
from perfbench import check, genome as genome_mod, harness
from perfbench import traffic as traffic_mod
from perfbench.reference import pair as ref_pair
from perfbench.reference import records as ref_records

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "chr6mhc.pe150"
PRIMARY = 300_000
REGION = (100_000, 130_000)
N_UNITS = 60  # pairs, or single reads
TAIL_COUNTS = ("alt_reads", "alt_sc_primaries", "alt_xa_entries",
               "alt_pair_primary_ends")
# the routes of align_seqs on the CPU: the whole-batch host route, the
# extension waves, the fused path (through the plain versions of its
# kernels) and the Python tail (the C++ tail library switched off)
ROUTES = {"host": {}, "waves": dict(force_waves=True),
          "fused": dict(device_pipeline=True), "python": dict(python=True)}


def _cell():
    return harness.load_cell(CELL, ROOT)


def _tiny(cfg: dict) -> dict:
    """The configuration's contigs, the primary cut to ``PRIMARY`` bases
    and each haplotype a copy of ``REGION``."""
    cfg = json.loads(json.dumps(cfg))
    for c in cfg["genome"]["contigs"]:
        if "alt_of" in c:
            c["alt_of"].update(start=REGION[0], end=REGION[1])
        else:
            c["length"] = PRIMARY
    return cfg


def _regions(traffic: dict, full: dict, genome) -> list:
    """The traffic's regions on the cut assembly: the whole primary, its
    ALT region, each whole haplotype, with the traffic's weights."""
    primary = full["genome"]["contigs"][0]
    alt_of = full["genome"]["contigs"][1]["alt_of"]
    out = []
    for r in traffic["regions"]:
        r = dict(r)
        if r["contig"] != primary["name"]:
            r.update(start=0, end=len(genome[r["contig"]]))
        elif (r["start"], r["end"]) == (0, primary["length"]):
            r.update(start=0, end=PRIMARY)
        else:
            assert (r["start"], r["end"]) == (alt_of["start"], alt_of["end"])
            r.update(start=REGION[0], end=REGION[1])
        out.append(r)
    return out


def _index(genome, path: str) -> BwaMemIndex:
    """The port's image of ``genome``, its ALT contigs named in a ``.alt``
    file and flagged by ``read_alt_into``, as a deployment builds one."""
    idx = build_index(Fasta([FastaContig(name, "", codes)
                             for name, codes in genome.contigs]))
    if genome.alt:
        with open(path + ".alt", "w") as f:
            f.writelines(f"{name}\n" for name, _ in genome.contigs
                         if name in genome.alt)
        read_alt_into(path + ".alt", idx.bns)
    image.write_image(path, idx)
    return BwaMemIndex(path)


class _Assembly:
    def __init__(self, cfg, traffic, tmp):
        self.genome = genome_mod.load(cfg, str(tmp))
        self.index = _index(self.genome, str(tmp / "ref.img"))
        self.ref = check.reference_index(self.genome, "cpu")
        self.traffic = traffic
        src = (traffic_mod.Regions(traffic["regions"], self.genome, traffic)
               if "regions" in traffic
               else traffic_mod.source(traffic, self.genome))
        self.codes = traffic_mod.simulate(src, np.random.default_rng(2**31 + 5),
                                          N_UNITS, traffic)
        self.alt_names = set(self.genome.alt)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mhc(tmp_path_factory):
    cell = _cell()
    cfg = _tiny(cell["config"])
    tmp = tmp_path_factory.mktemp("mhc")
    genome = genome_mod.load(cfg, str(tmp))
    traffic = dict(cell["traffic"],
                   regions=_regions(cell["traffic"], cell["config"], genome))
    return _Assembly(cfg, traffic, tmp)


@pytest.fixture(scope="module")
def one_contig(tmp_path_factory):
    with open(os.path.join(ROOT, "perfbench/configs/ecoli-k12.json")) as f:
        cfg = json.load(f)
    cfg["genome"]["length"] = PRIMARY
    traffic = dict(_cell()["traffic"])
    del traffic["regions"]
    return _Assembly(cfg, traffic, tmp_path_factory.mktemp("one"))


def _traffic(asm, mode: str) -> dict:
    return dict(asm.traffic, paired=mode == "pe")


def _reads(asm, mode: str):
    """The mode's reads: the pairs, or their first mates as single reads."""
    codes = asm.codes if mode == "pe" else asm.codes[0::2]
    return codes, traffic_mod.Batch(codes).seqs


def _reference(asm, mode: str, monkeypatch):
    """The reference's records of the mode's reads, and its own counts of
    what the ALT path did, taken where it does it: the regions the
    extension returned as they go into dedup, the ends its paired branch
    takes, and the ``alt_sc`` of the records it writes."""
    tally = Counter()
    anns = asm.ref.bns.anns
    dedup = ref_records.sort_dedup_patch
    try_pair = ref_pair._try_pair_output
    to_record = ref_records.aln_to_record

    def counted_dedup(opt, idx, query, regs):
        n_alt = sum(anns[r.rid].is_alt for r in regs)
        tally.update(regions=len(regs), alt_regions=n_alt,
                     alt_reads=int(n_alt > 0))
        return dedup(opt, idx, query, regs)

    def counted_pair(opt, eng, pes, pair_id, seqs, regs2, n_pri):
        out = try_pair(opt, eng, pes, pair_id, seqs, regs2, n_pri)
        for i in range(2 if out is not None else 0):
            if n_pri[i] < len(regs2[i]):
                p = regs2[i][n_pri[i]]
                tally["alt_pair_primary_ends"] += int(
                    bool(p.is_alt) and p.secondary < 0 and p.score >= opt.T)
        return out

    def counted_record(p, m):
        tally["alt_sc_primaries"] += int(
            p.alt_sc > 0 and not p.flag & (0x100 | 0x800 | 0x10000))
        return to_record(p, m)

    monkeypatch.setattr(ref_records, "sort_dedup_patch", counted_dedup)
    monkeypatch.setattr(ref_pair, "_try_pair_output", counted_pair)
    monkeypatch.setattr(ref_records, "aln_to_record", counted_record)
    tr = _traffic(asm, mode)
    codes, _ = _reads(asm, mode)
    per = 2 if mode == "pe" else 1
    want = ref_records.align_batch(check.options(tr), ref_records.Engine(
        asm.ref), list(codes), list(range(len(codes) // per)),
        check.pe_stats(tr))
    monkeypatch.undo()
    tally["alt_xa_entries"] = _alt_xa_entries(want, asm.alt_names)
    return want, tally


def _alt_xa_entries(records, alt_names) -> int:
    xa = ref_records.RECORD_FIELDS.index("xa_tag")
    return sum(entry.split(",")[0] in alt_names
               for recs in records for rec in recs if rec[xa]
               for entry in rec[xa].split(";")[:-1])


def _port(asm, mode: str, route: str, monkeypatch):
    """The port's records of the mode's reads on ``route``, from reset
    counts, and what it counted."""
    opts = dict(ROUTES[route])
    if opts.pop("python", False):
        monkeypatch.setenv("BWAMEM_TPU_NATIVE_TAIL", "0")
    waves = opts.pop("force_waves", False)
    aligner = BwaMemAligner(asm.index, device="cpu", min_device_jobs=1, **opts)
    if waves:
        aligner._exec_cfg = dataclasses.replace(aligner._exec_cfg,
                                                force_waves=True)
    if mode == "pe":
        p = asm.traffic["pe_stats"]
        aligner.align_pairs()
        aligner.set_proper_pair_end_stats(BwaMemPairEndStats.of(
            p["average"], p["std"], p["low"], p["high"]))
    before = metrics.snapshot()["counters"]
    FUSED_STATS.reset()
    TIMERS.reset()
    out = aligner.align_seqs(_reads(asm, mode)[1])
    monkeypatch.delenv("BWAMEM_TPU_NATIVE_TAIL", raising=False)
    after = metrics.snapshot()["counters"]
    counts = {k: after.get(k, 0) - before.get(k, 0) for k in TAIL_COUNTS}
    counts.update(regions=FUSED_STATS.regions,
                  alt_regions=FUSED_STATS.alt_regions)
    return [check.fields(recs) for recs in out], counts, TIMERS.snapshot()


@pytest.fixture(scope="module")
def reference_runs(mhc):
    mp = pytest.MonkeyPatch()
    try:
        return {mode: _reference(mhc, mode, mp) for mode in ("pe", "se")}
    finally:
        mp.undo()


@pytest.mark.parametrize("mode", ["pe", "se"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_alt_records_and_counts_equal_the_references(mhc, reference_runs,
                                                     route, mode,
                                                     monkeypatch):
    want, tally = reference_runs[mode]
    got, counts, spans = _port(mhc, mode, route, monkeypatch)
    assert got == want
    assert counts["regions"] == tally["regions"] > 0
    assert counts["alt_regions"] == tally["alt_regions"]
    # the ALT copies do most of the extension's work here, as in the cell
    assert 2 * tally["alt_regions"] > tally["regions"]
    if route == "python":  # the Python tail counts the regions alone
        assert all(counts[k] == 0 for k in TAIL_COUNTS)
        assert "native_tail.alt_xa" not in spans
        return
    assert {k: counts[k] for k in TAIL_COUNTS} == {
        k: tally[k] for k in TAIL_COUNTS}
    assert counts["alt_reads"] > 0 and counts["alt_xa_entries"] > 0
    assert spans["native_tail.alt_xa"] > 0


def test_the_reads_exercise_every_alt_count(reference_runs):
    """The reads reach each count: primaries with an ALT shadow, XA naming
    the haplotypes, and proper pairs with a primary ALT hit beside them."""
    pe, se = reference_runs["pe"][1], reference_runs["se"][1]
    assert pe["alt_sc_primaries"] + se["alt_sc_primaries"] > 0
    assert pe["alt_xa_entries"] > 0 and se["alt_xa_entries"] > 0
    assert pe["alt_pair_primary_ends"] > 0
    assert se["alt_pair_primary_ends"] == 0


@pytest.mark.parametrize("mode", ["pe", "se"])
def test_nothing_is_counted_without_alt_contigs(one_contig, mode,
                                                monkeypatch):
    got, counts, spans = _port(one_contig, mode, "host", monkeypatch)
    assert counts["regions"] > 0
    assert counts["alt_regions"] == 0
    assert all(counts[k] == 0 for k in TAIL_COUNTS)
    assert not any(path.endswith("alt_xa") for path in spans)


def test_the_counts_start_again_at_the_windows_resets(mhc, monkeypatch):
    _, once, _ = _port(mhc, "pe", "host", monkeypatch)
    aligner = BwaMemAligner(mhc.index, device="cpu")
    aligner.align_seqs(_reads(mhc, "se")[1])
    assert FUSED_STATS.regions > once["regions"]
    FUSED_STATS.reset()
    TIMERS.reset()
    assert FUSED_STATS.regions == FUSED_STATS.alt_regions == 0
    assert "native_tail.alt_xa" not in TIMERS.snapshot()
    _, again, _ = _port(mhc, "pe", "host", monkeypatch)
    assert again == once


def test_alt_region_share_reads_the_window_counts(mhc, monkeypatch):
    share = harness.metric_module(ROOT, "alt_region_share").read
    _, counts, _ = _port(mhc, "pe", "host", monkeypatch)
    assert share(None) == pytest.approx(
        100.0 * counts["alt_regions"] / counts["regions"])
    FUSED_STATS.reset()
    assert share(None) is None  # no region in the window
    from bwamem_tpu_torch.engine import pipeline_device

    # a program without the counts (one older than them) reads nothing
    monkeypatch.setattr(pipeline_device, "FUSED_STATS", object())
    assert share(None) is None


def test_the_cell_loads_with_its_metrics_and_alt_contigs():
    cell = _cell()
    assert {m["name"] for m in cell["end_to_end"]} == {"card_us_per_read",
                                                       "setup_s"}
    assert [m["name"] for m in cell["per_layer"]] == ["alt_region_share",
                                                     "chain2aln_split_share"]
    assert cell["workload"]["chips"] == 1
    contigs = cell["config"]["genome"]["contigs"]
    alts = [c for c in contigs if "alt_of" in c]
    assert [c["name"] for c in alts] == [
        f"chr6_GL0002{k}v2_alt" for k in range(50, 57)]
    assert [c["name"] for c in contigs if "alt_of" not in c] == ["chr6"]
    assert all(c["alt_of"] == dict(contig="chr6", start=28_510_120,
                                   end=33_410_120) for c in alts)
    weights = {(r["contig"], r["start"]): r["weight"]
               for r in cell["traffic"]["regions"]}
    assert weights[("chr6", 0)] == 0.25
    assert weights[("chr6", 28_510_120)] == 0.40
    assert [weights[(c["name"], 0)] for c in alts] == [0.05] * 7
