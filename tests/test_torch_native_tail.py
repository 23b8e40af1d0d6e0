"""The port's host C++ whole-batch pipeline and its tail.

Record-level equality, every field of every record (flags, coordinates,
MAPQ, NM, CIGAR, MD, XA, scores):

* the whole-batch host route (``device="cpu"``, no device stage:
  ``native_pipeline.pipeline_batch_arrays``) against the port's Python
  route (the same aligner with ``BWAMEM_TPU_NATIVE_TAIL=0``) and against
  bwamem_tpu's aligner (its ``_align_seqs_fast``), as
  tests/test_native_tail.py holds the reference's, its cases rebuilt on
  tests/fixtures/rotavirus.bwa.img and on a reference with a duplicated
  block and an ALT contig (its ``rich_img``);
* the tail entry (``bwamem_tail_batch``) under the wave, staged and fused
  routes against the Python tail (``python_tail``, ``pair.sam_pe``) on the
  same routes' regions: SE and PE, inferred, ``DO_NOT_INFER`` and caller PE
  stats, MEM_F_PRIMARY5;
* the vectorized record assembly (``_records_fast``) against the
  per-object path (tests/test_fast_records.py), the fused host
  chain+extend core and native seeding against the reference's
  (tests/test_native_engine.py), and the wave scheduler of the whole-batch
  route (BWAMEM_TPU_WAVE_TAIL=1) against its sequential driver
  (tests/test_wave_tail.py).

Each package opens its own index on the same image.  The tail library
builds at first use (``utils/nativebuild.py``, build and rename), so the
workers of a parallel run share it.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import bwamem_tpu
from bwamem_tpu.engine import native_core as j_native_core
from bwamem_tpu.engine import native_pipeline as j_native_pipeline
from bwamem_tpu.engine import pipeline as j_pipeline
from bwamem_tpu_torch import (MEM_F_PRIMARY5, BwaMemAligner, BwaMemIndex,
                              BwaMemPairEndStats)
from bwamem_tpu_torch.api.aligner import _aln_to_record, python_tail
from bwamem_tpu_torch.api.exceptions import InvalidInputException
from bwamem_tpu_torch.api.options import MemOptions
from bwamem_tpu_torch.engine import native_core, native_pipeline
from bwamem_tpu_torch.engine import pair as pair_mod
from bwamem_tpu_torch.engine import pipeline
from bwamem_tpu_torch.engine.exec_ctx import ExecConfig
from bwamem_tpu_torch.engine.extend_batch import STATS
from bwamem_tpu_torch.index import image
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.utils.encoding import revcomp_codes, seq_to_codes_batch
from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig
from bwamem_tpu_torch.utils.synth import simulate_pairs, synthetic_genome
from bwamem_tpu_torch.utils.timers import TIMERS

ROTAVIRUS = os.path.join(os.path.dirname(__file__), "fixtures",
                         "rotavirus.bwa.img")
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
ALL = ("seed", "sa_lookup", "chain")
# the routes with a device stage, on the CPU through the plain versions
ROUTES = {"waves": dict(force_waves=True), "staged": dict(device_stages=ALL),
          "fused": dict(device_pipeline=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rec_key(a):
    return (a.flag, a.rid, a.pos, a.is_rev, a.is_alt, a.mapq, a.NM,
            tuple(a.cigar), a.md, a.score, a.sub, a.alt_sc, a.XA)


def _keys(raw):
    """align_seqs_raw's records of either package, with each mate's key."""
    return [[(_rec_key(a), m and _rec_key(m)) for a, m in r] for r in raw]


def _records(recs):
    return [[vars(a) for a in r] for r in recs]


class _Indexes:
    """One image opened by each package."""

    def __init__(self, path):
        self.port = BwaMemIndex(path)
        self.ref = bwamem_tpu.BwaMemIndex(path)

    def close(self):
        self.port.close()
        self.ref.close()


def _aligner(index, route=None, **kw):
    """The port's CPU aligner; ``route`` names one of ``ROUTES`` (None: no
    device stage, the whole-batch host route)."""
    opts = dict(ROUTES[route]) if route else {}
    waves = opts.pop("force_waves", False)
    a = BwaMemAligner(index, device="cpu", min_device_jobs=1, **opts, **kw)
    if waves:
        a._exec_cfg = dataclasses.replace(a._exec_cfg, force_waves=True)
    return a


def _setup(a, mode, stats=(250, 25), pe_cls=BwaMemPairEndStats):
    if mode == "se":
        return a
    a.align_pairs()
    if mode == "provided":
        a.set_proper_pair_end_stats(pe_cls.of(*stats))
    elif mode == "dont_infer":
        a.dont_infer_pair_end_stats()
    return a


def _run_both(indexes, reads, mode, monkeypatch, **stats):
    """The whole-batch route's records and the Python route's, both of the
    port; each also held equal to bwamem_tpu's aligner, record for record
    (``align_seqs_raw``) and as API records (``align_seqs``, its
    ``_align_seqs_fast``)."""
    ref = _setup(bwamem_tpu.BwaMemAligner(indexes.ref), mode,
                 pe_cls=bwamem_tpu.BwaMemPairEndStats, **stats)
    want_raw, want = _keys(ref.align_seqs_raw(reads)), _records(
        ref.align_seqs(reads))
    out = {}
    for tail in ("1", "0"):
        monkeypatch.setenv("BWAMEM_TPU_NATIVE_TAIL", tail)
        a = _setup(_aligner(indexes.port), mode, **stats)
        TIMERS.reset()
        out[tail] = _keys(a.align_seqs_raw(reads))
        assert ("native_tail" in TIMERS.snapshot()) == (tail == "1")
        assert _records(a.align_seqs(reads)) == want
        assert out[tail] == want_raw
    monkeypatch.delenv("BWAMEM_TPU_NATIVE_TAIL")
    return out["1"], out["0"]


def _sim_pairs(rng, ref_codes, n, rlen=100, mean=250, std=25, err=0.01):
    reads = []
    L = len(ref_codes)
    for _ in range(n):
        isize = max(rlen + 20, min(int(rng.normal(mean, std)), L - 2))
        start = int(rng.integers(0, L - isize - 1))
        r1 = ref_codes[start: start + rlen].copy()
        r2 = (3 - ref_codes[start + isize - rlen: start + isize])[::-1].copy()
        for r in (r1, r2):
            for p in rng.integers(0, rlen, rng.binomial(rlen, err)):
                r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        reads.append(BASES[r1].tobytes())
        reads.append(BASES[r2].tobytes())
    return reads


@pytest.fixture(scope="module")
def rota():
    index = _Indexes(ROTAVIRUS)
    idx = index.port._require().idx
    yield index, np.minimum(idx.get_seq(0, idx.bns.l_pac), 3)
    index.close()


@pytest.fixture(scope="module")
def rich(tmp_path_factory):
    """40 kb: two contigs with a duplicated block (multimap/XA), an ALT
    contig carrying part of contig 0 with one changed base, and contig
    junctions in range of PE windows (tests/test_native_tail.py
    ``rich_img``)."""
    rng = np.random.default_rng(2024)
    c0 = rng.integers(0, 4, 30_000).astype(np.uint8)
    c0[20_000:20_400] = c0[5_000:5_400]  # exact repeat -> XA
    alt = np.concatenate(
        [c0[8_000:8_600], rng.integers(0, 4, 400).astype(np.uint8)])
    alt[300] = (alt[300] + 1) % 4
    idx = build_index(Fasta([
        FastaContig("c0", "", c0),
        FastaContig("c1", "", rng.integers(0, 4, 6_000).astype(np.uint8)),
        FastaContig("c0_alt", "", alt),
    ]))
    idx.bns.anns[2].is_alt = 1
    img = str(tmp_path_factory.mktemp("rich") / "rich.img")
    image.write_image(img, idx)
    index = _Indexes(img)
    yield index, c0
    index.close()


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    codes = synthetic_genome(200_000, np.random.default_rng(77))
    img = str(tmp_path_factory.mktemp("synth") / "ref.img")
    image.write_image(img, build_index(Fasta([FastaContig("chr", "", codes)])))
    index = _Indexes(img)
    yield index, codes
    index.close()


def _rich_pairs(c0):
    """Simulated pairs plus pairs from the repeat block, the ALT block and
    near the junctions."""
    reads = _sim_pairs(np.random.default_rng(99), c0, 50)
    for s in (5_050, 20_050, 8_100, 29_850, 50):
        reads.append(BASES[c0[s: s + 100]].tobytes())
        reads.append(BASES[(3 - c0[s + 120: s + 220])[::-1]].tobytes())
    return reads


def _rich_single(c0):
    """Reads with 2 % errors, a chimera, a random read and a read of the
    repeat block."""
    rng = np.random.default_rng(41)
    reads = []
    for _ in range(40):
        s = int(rng.integers(0, len(c0) - 120))
        r = c0[s: s + 120].copy()
        for p in rng.integers(0, 120, rng.binomial(120, 0.02)):
            r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        reads.append(BASES[r].tobytes())
    reads.append(BASES[np.concatenate([c0[100:160], c0[9000:9060]])].tobytes())
    reads.append(BASES[rng.integers(0, 4, 80)].tobytes())
    reads.append(BASES[c0[5_100:5_250]].tobytes())
    return reads


# ----------------------------------------- the whole-batch host route

L1 = b"GGCTTTTAATGCTTTTCAGTGGTTGCTGCTCAAGATGGAGTCTACTCAGCAGATGGTAAGCTCTATTATT"
P2 = b"TTGTTTTTAACACCAGAGTCATCCATCACATAATCAAATTTACTTTTAACTCTGGTAAATACTTCATTGT"


def test_pe_rotavirus_goldens(rota, monkeypatch):
    native, oracle = _run_both(rota[0], [L1, P2], "provided", monkeypatch,
                               stats=(200, 10, 1, 600))
    assert native == oracle
    (flag, _, pos, *_), _ = native[0][0]
    assert flag == 0x63 and pos == 0


def test_pe_simulated_batch_infer_mode(rota, monkeypatch):
    """Insert-size inference, rescue and pairing over a simulated batch."""
    index, fwd = rota
    reads = _sim_pairs(np.random.default_rng(7), fwd, 60, rlen=70, mean=300,
                       std=30)
    native, oracle = _run_both(index, reads, "infer", monkeypatch)
    assert native == oracle


@pytest.mark.parametrize("mode", ["provided", "dont_infer"])
def test_pe_rich_reference_all_modes(rich, monkeypatch, mode):
    """Repeats (XA), the ALT contig, contig junctions."""
    index, c0 = rich
    native, oracle = _run_both(index, _rich_pairs(c0), mode, monkeypatch)
    assert native == oracle


def test_se_batch_with_chimeras_and_unmapped(rich, monkeypatch):
    index, c0 = rich
    native, oracle = _run_both(index, _rich_single(c0), "se", monkeypatch)
    assert native == oracle
    assert native[-2][0][0][0] & 0x4  # the random read is unmapped


def test_se_fuzz_heavy_errors(rota, monkeypatch):
    """High error and indel reads stress band retries, dedup and patching."""
    index, fwd = rota
    rng = np.random.default_rng(17)
    reads = []
    for _ in range(60):
        L = int(rng.integers(40, 200))
        s = int(rng.integers(0, len(fwd) - L))
        r = fwd[s: s + L].copy()
        for _ in range(int(rng.integers(0, 8))):
            p = int(rng.integers(0, len(r)))
            op = rng.integers(0, 3)
            if op == 0:
                r[p] = (r[p] + 1) % 4
            elif op == 1 and len(r) > 30:
                r = np.delete(r, p)
            else:
                r = np.insert(r, p, rng.integers(0, 4))
        if rng.integers(0, 2):
            r = (3 - r)[::-1].copy()
        reads.append(BASES[r].tobytes())
    native, oracle = _run_both(index, reads, "se", monkeypatch)
    assert native == oracle


def test_long_reads_native_tail(rota, monkeypatch):
    """Long and chimeric reads (the mem_flt_chained_seeds regime)."""
    index, fwd = rota
    rng = np.random.default_rng(77)
    reads = []
    for _ in range(25):
        L = int(rng.integers(700, 1000))
        s = int(rng.integers(0, len(fwd) - L))
        r = fwd[s: s + L].copy()
        for p in rng.integers(0, L, rng.binomial(L, 0.02)):
            r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, len(r)))
            if rng.integers(0, 2):
                r = np.delete(r, slice(p, p + int(rng.integers(1, 8))))
            else:
                r = np.insert(r, p, rng.integers(0, 4, int(rng.integers(1, 8))))
        reads.append(BASES[np.minimum(r, 3)].tobytes())
    for _ in range(10):  # half forward, half the reverse complement elsewhere
        reads.append(BASES[np.concatenate([fwd[0:380],
                                           (3 - fwd[600:980])[::-1]])].tobytes())
    native, oracle = _run_both(index, reads, "se", monkeypatch)
    assert native == oracle and any(len(r) >= 700 for r in reads)


def test_wave_tail_record_equal(synth, monkeypatch):
    """BWAMEM_TPU_WAVE_TAIL=1 (the whole-batch route's coroutine wave
    extension) gives the records of its sequential driver."""
    index, codes = synth
    reads = simulate_pairs(codes, np.random.default_rng(6), 150)
    out = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("BWAMEM_TPU_WAVE_TAIL", mode)
        a = _setup(_aligner(index.port), "provided", stats=(350, 35))
        out[mode] = _records(a.align_seqs(reads))
    assert out["0"] == out["1"]


# ------------------------------------------------ fast record assembly

@pytest.mark.parametrize("route", [None, "waves"], ids=("whole", "tail"))
@pytest.mark.parametrize("paired", [True, False], ids=("pe", "se"))
def test_fast_equals_slow(synth, paired, route):
    """``_records_fast`` over the C++ arrays gives the records of
    ``align_seqs_raw`` through ``_aln_to_record``: paired and unpaired,
    mapped and unmapped, with XA and supplementary records."""
    index, codes = synth
    rng = np.random.default_rng(99)
    reads = simulate_pairs(codes, rng, 100, read_len=120, isize_mean=300)
    junk = bytes(rng.integers(65, 91, size=100, dtype=np.uint8))
    nrich = b"ACGT" * 10 + b"N" * 40 + b"ACGT" * 10
    reads = list(reads) + [junk, reads[0][:60] + reads[3][60:120], nrich,
                           reads[1]]
    a = _aligner(index.port, route)
    if paired:
        _setup(a, "provided", stats=(300, 30))
    fast = a.align_seqs(reads)
    slow = [[_aln_to_record(p, m) for p, m in r] for r in a.align_seqs_raw(reads)]
    assert _records(fast) == _records(slow)
    ref = bwamem_tpu.BwaMemAligner(index.ref)
    if paired:
        _setup(ref, "provided", stats=(300, 30),
               pe_cls=bwamem_tpu.BwaMemPairEndStats)
    assert _records(fast) == _records(ref.align_seqs(reads))


# ------------------------------- the tail entry against the Python tail

MODES = ("se", "infer", "dont_infer", "provided", "primary5")


def _tail_case(rich, mode):
    index, c0 = rich
    if mode in ("se", "primary5"):
        reads = _rich_single(c0)[::2] + [
            BASES[np.concatenate([c0[0:60], c0[15_000:15_060]])].tobytes(),
            BASES[np.concatenate([c0[15_000:15_060], c0[0:60]])].tobytes()]
    else:
        reads = _rich_pairs(c0)[20:]
    return index, reads


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("route", ROUTES)
def test_tail_matches_python_route(rich, monkeypatch, route, mode):
    """Each route's records through ``bwamem_tail_batch`` equal the Python
    tail's on the same route's regions; the C++ tail ran in its timed
    ``native_tail`` stage, with no dedup in Python and no ``pair.sam_pe``."""
    index, reads = _tail_case(rich, mode)
    a = _setup(_aligner(index.port, route), "se" if mode == "primary5" else mode)
    if mode == "primary5":
        a.options.flag |= MEM_F_PRIMARY5
    calls = []
    sam_pe = pair_mod.sam_pe
    monkeypatch.setattr(pair_mod, "sam_pe",
                        lambda *x, **k: calls.append(1) or sam_pe(*x, **k))
    TIMERS.reset()
    raw = a.align_seqs_raw(reads)
    stages = TIMERS.snapshot()
    assert not calls and "native_tail" in stages and "dedup" not in stages
    fast = a.align_seqs(reads)
    assert not calls
    eng = index.port._require()
    codes = seq_to_codes_batch(reads)
    regs = pipeline.align_regs_batch(a.options, eng, codes, a._exec_cfg)
    py = python_tail(a.options, eng, codes, regs, a._pe_stats)
    assert bool(calls) == (mode not in ("se", "primary5"))
    assert _keys(raw) == _keys(py)
    assert _records(fast) == _records(
        [[_aln_to_record(p, m) for p, m in r] for r in py])
    assert any(key[12] for r in _keys(raw) for key, _ in r)  # an XA tag


@pytest.mark.parametrize("mode", ["se", "infer", "provided"])
def test_tail_entry_composes_the_two_reference_entries(rich, mode):
    """``bwamem_tail_batch`` on the reference's ``bwamem_align_regs_batch``
    rows gives, byte for byte, what ``bwamem_pipeline_batch`` gives from the
    seeds, in either package's library."""
    index, c0 = rich
    reads = seq_to_codes_batch(_rich_pairs(c0))
    opt = MemOptions()
    pes = None
    if mode != "se":
        opt.flag |= 0x2
    if mode == "provided":
        pes = pair_mod.default_pes()
        pes[1] = pair_mod.PeStat(low=150, high=350, failed=0, avg=250.0, std=25.0)
    eng = index.port._require()
    table = pipeline.native_seed_sa(opt, eng, reads)
    whole = native_pipeline.pipeline_batch_arrays(
        opt, eng.idx, reads, *table, is_pe=mode != "se", pes=pes)
    rows, n_reg = pipeline.regs_to_rows(
        native_core.align_regs_batch_core(opt, eng.idx, reads, *table))
    tail = native_pipeline.tail_batch_arrays(opt, eng.idx, reads, rows, n_reg,
                                             is_pe=mode != "se", pes=pes)
    j_eng = index.ref._require()
    j_whole = j_native_pipeline.pipeline_batch_arrays(
        opt, j_eng.idx, reads, *j_pipeline.native_seed_sa(opt, j_eng, reads),
        is_pe=mode != "se", pes=pes)
    for got in (tail, j_whole):
        assert np.array_equal(got[0], whole[0])
        assert np.array_equal(got[1], whole[1])
        assert _texts(got[0], got[2]) == _texts(whole[0], whole[2])
    assert len(whole[0]) >= len(reads)


def _texts(rows, sbuf):
    """Each record's MD, XA and CIGAR text in the string buffer (the rest
    of the buffer, sized for the longest CIGAR text, is not written)."""
    return [(sbuf[r[13]: r[13] + r[14]], sbuf[r[15]: r[15] + r[16]],
             sbuf[r[18]: r[18] + r[19]]) for r in rows.tolist()]


def test_tail_entry_without_regions(rich):
    """Reads with no region at all (random sequence): one unmapped record
    each, paired and not."""
    index, _ = rich
    reads = list(np.random.default_rng(3).integers(0, 4, (6, 90)).astype(np.uint8))
    eng = index.port._require()
    for is_pe in (False, True):
        opt = MemOptions()
        rows, cig, sbuf = native_pipeline.tail_batch_arrays(
            opt, eng.idx, reads, np.zeros((0, 11), np.int64),
            np.zeros(len(reads), np.int64), is_pe=is_pe)
        assert rows[:, 0].tolist() == list(range(len(reads)))
        assert all(rows[:, 1] & 0x4)
    with pytest.raises(ValueError):
        native_pipeline.tail_batch_arrays(
            opt, eng.idx, reads, np.zeros((2, 11), np.int64),
            np.zeros(len(reads), np.int64), is_pe=False)


def test_tail_library_that_fails_raises(monkeypatch, rich):
    """The tail entry raises when its library does not build or load; a
    CPU aligner then takes the Python tail, records unchanged."""
    index, c0 = rich
    reads = _rich_pairs(c0)[:40]
    want = _records(_setup(_aligner(index.port, "waves"), "infer").align_seqs(reads))
    monkeypatch.setattr(native_pipeline, "_ensure_built", lambda: False)
    with pytest.raises(RuntimeError):
        native_pipeline.tail_batch_arrays(
            MemOptions(), index.port._require().idx, [], np.zeros((0, 11)),
            np.zeros(0), is_pe=False)
    TIMERS.reset()
    a = _setup(_aligner(index.port, "waves"), "infer")
    assert _records(a.align_seqs(reads)) == want
    assert "native_tail" not in TIMERS.snapshot()


def test_odd_pair_count_raises_on_the_tail_route(rich):
    index, c0 = rich
    a = _setup(_aligner(index.port, "waves"), "infer")
    with pytest.raises(InvalidInputException):
        a.align_seqs(_rich_pairs(c0)[:3])


# ------------------------------- native seeding and the fused host core

def _messy_reads(fwd, rng, n):
    reads = []
    for _ in range(n):
        rlen = int(rng.integers(40, 280))
        start = int(rng.integers(0, len(fwd) - rlen - 10))
        r = fwd[start: start + rlen].copy()
        for p in rng.integers(0, rlen, rng.binomial(rlen, 0.03)):
            r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        if rng.random() < 0.3:
            pos = int(rng.integers(10, rlen - 10))
            ln = int(rng.integers(1, 5))
            if rng.random() < 0.5:
                r = np.concatenate([r[:pos], r[pos + ln:]])
            else:
                r = np.concatenate(
                    [r[:pos], rng.integers(0, 4, ln).astype(np.uint8), r[pos:]])
        if rng.random() < 0.5:
            r = revcomp_codes(r)
        if rng.random() < 0.1:
            r[int(rng.integers(0, len(r)))] = 4
        reads.append(r)
    reads.append(rng.integers(0, 4, 100).astype(np.uint8))  # unalignable
    return reads


def _reg_key(a):
    return (a.rb, a.re, a.qb, a.qe, a.rid, a.score, a.truesc, a.w, a.seedcov,
            a.seedlen0, a.frac_rep, a.sub, a.csub, a.sub_n, a.alt_sc,
            a.secondary, a.is_alt, a.n_comp)


def test_native_seed_sa_matches_reference(synth):
    index, codes = synth
    reads = _messy_reads(codes, np.random.default_rng(1), 30)
    opt = MemOptions()
    got = pipeline.native_seed_sa(opt, index.port._require(), reads)
    want = j_pipeline.native_seed_sa(opt, index.ref._require(), reads)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_fused_core_end_to_end_matches_oracle(synth):
    """The host-only configuration runs the fused chain+extend core; its
    regions equal the wave driver's (``force_waves``) and, raw, the
    reference's core's."""
    index, codes = synth
    reads = _messy_reads(codes, np.random.default_rng(3), 25)
    opt = MemOptions()
    eng = index.port._require()
    assert native_core.available()
    TIMERS.reset()
    STATS.reset()
    core = pipeline.align_regs_batch(opt, eng, reads, ExecConfig(device="cpu"))
    assert "chain+extend" in TIMERS.snapshot() and STATS.host_extend_jobs == 0
    waves = pipeline.align_regs_batch(
        opt, eng, reads, ExecConfig(device="cpu", force_waves=True))
    assert STATS.host_extend_jobs > 0
    assert [[_reg_key(a) for a in r] for r in core] == [
        [_reg_key(a) for a in r] for r in waves]
    j_eng = index.ref._require()
    table = pipeline.native_seed_sa(opt, eng, reads)
    raw = native_core.align_regs_batch_core(opt, eng.idx, reads, *table)
    j_raw = j_native_core.align_regs_batch_core(opt, j_eng.idx, reads, *table)
    assert [[_reg_key(a) for a in r] for r in raw] == [
        [_reg_key(a) for a in r] for r in j_raw]
    rows, n_reg = pipeline.regs_to_rows(raw)
    assert [[_reg_key(a) for a in r] for r in pipeline.regs_from_rows(
        rows, n_reg)] == [[_reg_key(a) for a in r] for r in raw]


def test_whole_batch_route_only_without_device_stages(synth):
    """``native_pipeline_ok``: the host-only configuration, never one with
    a device stage, ``force_waves`` or the fused path."""
    index, codes = synth
    eng = index.port._require()
    reads = _messy_reads(codes, np.random.default_rng(4), 3)
    assert pipeline.native_pipeline_ok(eng, reads, ExecConfig(device="cpu"))
    for kw in (dict(force_waves=True), dict(device_seed=True),
               dict(device_sa_lookup=True), dict(device_chain=True),
               dict(device_pipeline=True)):
        cfg = ExecConfig(device="cpu", **kw)
        assert cfg.any_device_stage() and not pipeline.native_pipeline_ok(
            eng, reads, cfg)
    card = ExecConfig(device="cuda")
    assert card.want_force_waves() and card.any_device_stage()
