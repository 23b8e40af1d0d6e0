"""The port's per-read host entry (engine/pipeline.py ``align1_regs``,
``_regs_from_intervals`` and ``align_se``, [EXT] mem_align1_core and
mem_reg2sam) against bwamem_tpu's, exactly: regions and records field for
field, and the SAM lines each package's ``aln2sam`` makes of them.  The
cases mirror tests/test_sam.py and the per-read cases of
tests/test_advice_fixes.py (forward, reverse, unmapped, supplementary and
secondary reads, XA, MEM_F_PRIMARY5, a junction between two contigs) on
the rotavirus image, which both packages open, and on a small synthetic
genome that each package indexes, with N bases and reads of 150 and 300
bases."""
import dataclasses
import os

import numpy as np
import pytest

import bwamem_tpu
import bwamem_tpu_torch
from bwamem_tpu.api import options as j_options
from bwamem_tpu.api import sam as j_sam
from bwamem_tpu.engine import chain as j_chain
from bwamem_tpu.engine import pipeline as j_pipeline
from bwamem_tpu.engine import seed as j_seed
from bwamem_tpu.index import build as j_build
from bwamem_tpu.utils import fasta as j_fasta
from bwamem_tpu_torch.api import options as p_options
from bwamem_tpu_torch.api import sam as p_sam
from bwamem_tpu_torch.engine import chain as p_chain
from bwamem_tpu_torch.engine import pipeline as p_pipeline
from bwamem_tpu_torch.engine import seed as p_seed
from bwamem_tpu_torch.index import build as p_build
from bwamem_tpu_torch.utils import fasta as p_fasta
from bwamem_tpu_torch.utils.encoding import revcomp_codes, seq_to_codes
from bwamem_tpu_torch.utils.synth import simulate_pairs, synthetic_genome

ROTAVIRUS = os.path.join(os.path.dirname(__file__), "fixtures",
                         "rotavirus.bwa.img")
READ_L1 = "GGCTTTTAATGCTTTTCAGTGGTTGCTGCTCAAGATGGAGTCTACTCAGCAGATGGTAAGCTCTATTATT"


class Pkg:
    def __init__(self, top, options, pipeline, seed, chain, build, fasta, sam):
        self.__dict__.update(locals())


JAX = Pkg(bwamem_tpu, j_options, j_pipeline, j_seed, j_chain, j_build, j_fasta,
          j_sam)
PORT = Pkg(bwamem_tpu_torch, p_options, p_pipeline, p_seed, p_chain, p_build,
           p_fasta, p_sam)
PKGS = (JAX, PORT)


def _fields(x):
    """An object of either package as plain data."""
    if dataclasses.is_dataclass(x):
        return tuple(_fields(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return [_fields(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _synth_contigs():
    """200 kbp of bench.py's generator with an exact 3 kbp duplicate (a
    secondary hit) and a run of N, and a 30 kbp second contig."""
    rng = np.random.default_rng(41)
    a = synthetic_genome(200_000, rng)
    a = np.where(a > 3, 0, a).astype(np.uint8)
    a[150_000:153_000] = a[20_000:23_000]
    a[90_000:90_050] = 4
    return [a, rng.integers(0, 4, 30_000).astype(np.uint8)]


def _two_contigs():
    """tests/test_advice_fixes.py's two 400 bp contigs."""
    rng = np.random.default_rng(99)
    return [rng.integers(0, 4, 400).astype(np.uint8),
            rng.integers(0, 4, 400).astype(np.uint8)]


def _built(pkg, contigs):
    return pkg.pipeline.Engine(pkg.build.build_index(pkg.fasta.Fasta(
        [pkg.fasta.FastaContig(f"c{i}", "", c.copy())
         for i, c in enumerate(contigs)])))


@pytest.fixture(scope="module")
def engines():
    """Per genome, per package: its engine."""
    out = {}
    idx = [pkg.top.BwaMemIndex(ROTAVIRUS) for pkg in PKGS]
    out["rotavirus"] = [i._require() for i in idx]
    for name, contigs in (("synth", _synth_contigs()),
                          ("two", _two_contigs())):
        out[name] = [_built(pkg, contigs) for pkg in PKGS]
    yield out
    for i in idx:
        i.close()


def _fwd(eng, beg, end):
    return np.asarray(eng.idx.get_seq(beg, end), np.uint8).copy()


def _mutate(q, every, start=5):
    q = q.copy()
    for p in range(start, len(q), every):
        q[p] = (q[p] + 1) % 4
    return q


def _sim(eng, n, read_len, seed):
    """``n`` pairs of ``read_len`` bases from contig 0, as codes."""
    l0 = eng.idx.bns.anns[0].length
    codes = np.where(_fwd(eng, 0, l0) > 3, 0, _fwd(eng, 0, l0))
    seqs = simulate_pairs(codes, np.random.default_rng(seed), n,
                          read_len=read_len, isize_mean=2 * read_len + 100)
    return [seq_to_codes(s.decode()) for s in seqs]


# name -> (genome, options' flag, the reads given that genome's port engine)
CASES = {
    "forward": ("rotavirus", 0, lambda e: [seq_to_codes(READ_L1)]),
    "reverse": ("rotavirus", 0,
                lambda e: [revcomp_codes(seq_to_codes(READ_L1))]),
    "unmapped": ("rotavirus", 0, lambda e: [
        np.random.default_rng(5).integers(0, 4, 70).astype(np.uint8)]),
    "supplementary": ("rotavirus", 0, lambda e: [np.concatenate(
        [_fwd(e, 0, 60), _fwd(e, 500, 560)])]),
    "supplementary_no_multi": ("rotavirus", "no_multi", lambda e: [
        np.concatenate([_fwd(e, 0, 60), _fwd(e, 500, 560)])]),
    "primary5": ("rotavirus", "primary5", lambda e: [np.concatenate(
        [_fwd(e, 600, 660), _fwd(e, 100, 190)])]),
    "mid_length_seed": ("rotavirus", 0, lambda e: [_fwd(e, 0, 400)]),
    "n_bases": ("rotavirus", 0, lambda e: [np.where(
        np.arange(100) % 17 == 3, 4, _fwd(e, 300, 400)).astype(np.uint8)]),
    "secondary_all": ("synth", "all", lambda e: [_fwd(e, 20_500, 20_650),
                                                 _fwd(e, 151_000, 151_300)]),
    "xa": ("synth", 0, lambda e: [_fwd(e, 20_500, 20_650),
                                  revcomp_codes(_fwd(e, 151_000, 151_300))]),
    "across_n_run": ("synth", 0, lambda e: [_fwd(e, 89_900, 90_200)]),
    "second_contig": ("synth", 0, lambda e: [revcomp_codes(_fwd(
        e, 200_000 + 1_000, 200_000 + 1_300))]),
    "reads_150": ("synth", 0, lambda e: _sim(e, 3, 150, 7)),
    "reads_300": ("synth", 0, lambda e: _sim(e, 2, 300, 8)),
    "reads_300_mutated": ("synth", 0, lambda e: [
        _mutate(r, 23) for r in _sim(e, 1, 300, 9)]),
    # tests/test_advice_fixes.py: the anchor near ctgA's end, the mate with
    # its seeds killed, a mate whose window crosses into ctgB
    "junction_anchor": ("two", 0, lambda e: [_fwd(e, 300, 370)]),
    "junction_mate": ("two", 0, lambda e: [
        _mutate(revcomp_codes(_fwd(e, 500, 570)), 12)]),
    "rescue_pair": ("two", 0, lambda e: [
        _fwd(e, 0, 70), revcomp_codes(_mutate(_fwd(e, 200, 270), 12))]),
}


def _opt(pkg, flag):
    o = pkg.options
    bits = {0: 0, "all": o.MEM_F_ALL, "no_multi": o.MEM_F_NO_MULTI,
            "primary5": o.MEM_F_PRIMARY5}[flag]
    return o.MemOptions(flag=bits)


@pytest.mark.parametrize("case", sorted(CASES))
def test_align1_regs_and_align_se_match(engines, case):
    """Regions of ``align1_regs``, records of ``align_se`` and their SAM
    lines: the port's equal the reference's."""
    genome, flag, make = CASES[case]
    engs = engines[genome]
    reads = make(engs[1])
    got = []
    for pkg, eng in zip(PKGS, engs):
        opt = _opt(pkg, flag)
        regs = [_fields(pkg.pipeline.align1_regs(opt, eng, q)) for q in reads]
        recs, lines = [], []
        for i, q in enumerate(reads):
            alns = pkg.pipeline.align_se(opt, eng, q, i)
            recs.append(_fields(alns))
            lines.append([pkg.sam.aln2sam(opt, eng.idx.bns.anns, f"r{i}", q,
                                          None, a, k, records=alns)
                          for k, a in enumerate(alns)])
        got.append((regs, recs, lines))
    assert got[0] == got[1]
    regs, recs, lines = got[1]
    assert len(recs) == len(reads) and all(recs)
    flags = [r[2] for rs in recs for r in rs]
    if case == "unmapped":
        assert flags == [4]
    elif case == "reverse":
        assert flags[0] & 0x10
    elif case.startswith("supplementary"):
        assert len(recs[0]) >= 2
        assert recs[0][1][2] & (0x10000 if case.endswith("multi") else 0x800)
        assert "\tSA:Z:" in lines[0][0] or case.endswith("multi")
    elif case == "secondary_all":
        assert any(f & 0x100 for f in flags)
    elif case == "xa":
        assert any(r[12] for rs in recs for r in rs)
    elif case.startswith("reads_"):
        assert all(not (rs[0][2] & 4) for rs in recs)
        if case == "reads_300":
            assert {len(q) for q in reads} == {300}


@pytest.mark.parametrize("genome", ("rotavirus", "synth"))
def test_regs_from_intervals_with_given_positions(engines, genome):
    """``_regs_from_intervals`` with each interval's SA positions given (the
    batched pipeline's form) equals ``align1_regs``, in both packages."""
    engs = engines[genome]
    reads = (_sim(engs[1], 2, 150, 11) + _sim(engs[1], 1, 300, 12)
             if genome == "synth" else
             [seq_to_codes(READ_L1), _fwd(engs[1], 200, 500)])
    got = []
    for pkg, eng in zip(PKGS, engs):
        opt = pkg.options.MemOptions()
        per_read = []
        for q in reads:
            ivs = pkg.seed.collect_intv(opt, eng.fm, q)
            rbegs = [eng.fm.sa_lookup(np.asarray(pkg.chain.sample_ks(
                p, opt.max_occ), np.int64)) for p in ivs]
            given = _fields(pkg.pipeline._regs_from_intervals(
                opt, eng, q, ivs, rbegs))
            assert given == _fields(pkg.pipeline.align1_regs(opt, eng, q))
            per_read.append(given)
        got.append(per_read)
    assert got[0] == got[1] and all(got[0])
