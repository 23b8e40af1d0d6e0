"""The port's aligner with every stage set (no device stage, which takes
the whole-batch host route; no device stage with the extension waves kept,
``force_waves``; ("seed",), ("chain",), all three, and the fused device
path), on the CPU through the plain PyTorch versions, against bwamem_tpu's
host aligner: equal records on
inputs beyond 150-base pairs of a one-contig genome: pairs of 300 bases,
single reads of 161-1,500 bases, reads across the borders of a short middle
contig, reads with N runs, all N, 15 and 19 bases, homopolymers and
dinucleotide repeats, a chimeric read, and the synthetic ALT-contig and
MEM_F_PRIMARY5 cases of tests/test_alt_contigs.py.  Each package opens its
own index on the same image.
"""
import dataclasses

import numpy as np
import pytest
import torch

import bwamem_tpu
from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex, BwaMemPairEndStats
from bwamem_tpu_torch.api.options import MEM_F_PRIMARY5
from bwamem_tpu_torch.engine.pipeline_device import FUSED_STATS
from bwamem_tpu_torch.index import image
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig
from bwamem_tpu_torch.utils.synth import simulate_pairs, synthetic_genome

ALL = ("seed", "sa_lookup", "chain")
ROUTES = {"host": dict(), "waves": dict(force_waves=True),
          "seed": dict(device_stages=("seed",)),
          "chain": dict(device_stages=("chain",)), "all": dict(device_stages=ALL),
          "fused": dict(device_pipeline=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(codes) -> bytes:
    return bytes(b"ACGTN"[c] for c in codes)


def _rc(r):
    return np.where(r < 4, 3 - r, 4)[::-1].copy()


class _Genome:
    """One image opened by each package, the reference's records per input
    made once."""

    def __init__(self, path, contigs, alt=()):
        idx = build_index(Fasta([FastaContig(f"c{i}", "", c)
                                 for i, c in enumerate(contigs)]))
        for i in alt:
            idx.bns.anns[i].is_alt = 1
        image.write_image(path, idx)
        self.port, self.ref = BwaMemIndex(path), bwamem_tpu.BwaMemIndex(path)
        self.contigs = contigs
        self._want = {}

    def close(self):
        self.port.close()
        self.ref.close()

    def check(self, name, reads, route, pe=None, flag=0):
        """The port's records by ``route`` equal the reference's."""
        def setup(a, stats_cls):
            a.options.flag |= flag
            if pe:
                a.align_pairs()
                a.set_proper_pair_end_stats(stats_cls.of(*pe))

        if name not in self._want:
            host = bwamem_tpu.BwaMemAligner(self.ref)
            setup(host, bwamem_tpu.BwaMemPairEndStats)
            self._want[name] = [[vars(a) for a in r]
                                for r in host.align_seqs(reads)]
        kw = dict(ROUTES[route])
        waves = kw.pop("force_waves", False)
        port = BwaMemAligner(self.port, device="cpu", min_device_jobs=1, **kw)
        if waves:
            port._exec_cfg = dataclasses.replace(port._exec_cfg,
                                                 force_waves=True)
        setup(port, BwaMemPairEndStats)
        FUSED_STATS.reset()
        got = [[vars(a) for a in r] for r in port.align_seqs(reads)]
        assert got == self._want[name]
        if route == "fused":
            assert FUSED_STATS.device_reads + FUSED_STATS.host_reads == len(reads)
        return got


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """150 kbp of the repeat-rich generator as three contigs, the middle one
    700 bases."""
    codes = synthetic_genome(150_000, np.random.default_rng(21))
    g = _Genome(str(tmp_path_factory.mktemp("g") / "g.img"),
                [codes[:90_000], codes[90_000:90_700], codes[90_700:]])
    yield g, codes
    g.close()


@pytest.mark.parametrize("route", ROUTES)
def test_pairs_of_300_bases(genome, route):
    g, codes = genome
    reads = simulate_pairs(codes[:90_000], np.random.default_rng(22), 12,
                           read_len=300, isize_mean=700)
    g.check("pe300", reads, route, pe=(700, 70))


@pytest.mark.parametrize("route", ROUTES)
def test_single_reads_of_161_to_1500_bases(genome, route):
    g, codes = genome
    rng = np.random.default_rng(23)
    reads = []
    for L in (161, 200, 333, 480, 699, 760, 900, 1500):
        s = int(rng.integers(0, 88_000 - L))
        r = codes[s: s + L].copy()
        r[r > 3] = 0
        for p in rng.integers(0, L, L // 50):
            r[p] = (r[p] + 1) % 4
        reads.append(_seq(_rc(r) if rng.random() < 0.5 else r))
    g.check("long", reads, route)
    if route == "fused":  # reads of ~740 bases and more leave the fused path
        assert FUSED_STATS.fcs_reads + FUSED_STATS.host_seeded >= 3
        assert FUSED_STATS.device_reads >= 3


@pytest.mark.parametrize("route", ROUTES)
def test_reads_across_a_short_middle_contig(genome, route):
    g, codes = genome
    reads = []
    for s in (89_900, 89_960, 90_000, 90_500, 90_620, 90_690, 89_950):
        L = 150 if s != 89_950 else 900  # the last spans the whole contig
        r = codes[s: s + L].copy()
        r[r > 3] = 1
        reads += [_seq(r), _seq(_rc(r))]
    g.check("borders", reads, route)
    g.check("borders_pe", reads[:12], route, pe=(300, 30))


@pytest.mark.parametrize("route", ROUTES)
def test_odd_reads(genome, route):
    """N runs, all N, reads under the seed length, low-complexity reads and
    a chimeric read."""
    g, codes = genome
    rng = np.random.default_rng(24)
    base = codes[40_000:40_150].copy()
    base[base > 3] = 2
    with_n = base.copy()
    with_n[30:36] = 4
    with_n[100] = 4
    chimera = np.concatenate([codes[10_000:10_080], _rc(codes[70_000:70_090])])
    chimera[chimera > 3] = 3
    reads = [_seq(with_n), b"N" * 80, _seq(base[:15]), _seq(base[:19]),
             _seq(base[:20]), b"A" * 100, b"T" * 151, b"AC" * 60, b"ACG" * 40,
             _seq(chimera), _seq(base), _seq(_rc(base)),
             _seq(rng.integers(0, 4, 120).astype(np.uint8))]
    g.check("odd", reads, route)


@pytest.fixture(scope="module")
def alt_genome(tmp_path_factory):
    """tests/test_alt_contigs.py's genome: a 2,000-base contig and an ALT
    contig that copies 300 bases of it with one changed base, plus a unique
    tail."""
    rng = np.random.default_rng(777)
    chrom = rng.integers(0, 4, 2000).astype(np.uint8)
    block = chrom[500:800].copy()
    block[150] = (block[150] + 1) % 4
    alt = np.concatenate([block, rng.integers(0, 4, 300).astype(np.uint8)])
    g = _Genome(str(tmp_path_factory.mktemp("alt") / "alt.img"), [chrom, alt],
                alt=(1,))
    yield g
    g.close()


@pytest.mark.parametrize("route", ROUTES)
def test_alt_contig_and_primary5_cases(alt_genome, route):
    g = alt_genome
    chrom, alt = g.contigs
    reads = [_seq(chrom[510:580]), _seq(alt[100:170]), _seq(alt[350:420]),
             _seq(_rc(alt[90:200])), _seq(chrom[1200:1300])]
    got = g.check("alt", reads, route)
    assert got[0][0]["ref_id"] == 0 and "c1," in got[0][0]["xa_tag"]
    assert [a["ref_id"] for a in got[1]] == [0, 1]  # ALT hit as supplementary
    assert got[2][0]["ref_id"] == 1
    split = [_seq(np.concatenate([chrom[0:60], chrom[1500:1560]])),
             _seq(np.concatenate([chrom[1500:1560], chrom[0:60]]))]
    got = g.check("primary5", split, route, flag=MEM_F_PRIMARY5)
    assert len(got[0]) >= 2 and got[0][0]["ref_start"] == 0
    g.check("no_primary5", split, route)
