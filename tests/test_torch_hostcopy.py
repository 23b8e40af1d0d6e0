"""The port's own copies of the host layer against bwamem_tpu's originals,
layer by layer on seeded inputs, exactly: index files and images byte for
byte, seeding intervals, chains, extension regions, deduplicated regions,
paired records, and the golden reads of the rotavirus image; with the host
C++ natives and without them.  Objects of the two packages are never
``==`` (their classes differ), so fields are compared.  Each package
builds its own index from the same genome.
"""
import dataclasses
import os

import numpy as np
import pytest

import bwamem_tpu
import bwamem_tpu_torch
from bwamem_tpu.api import options as j_options
from bwamem_tpu.engine import chain as j_chain
from bwamem_tpu.engine import extend as j_extend
from bwamem_tpu.engine import finalize as j_finalize
from bwamem_tpu.engine import native_fm as j_native_fm
from bwamem_tpu.engine import pair as j_pair
from bwamem_tpu.engine import pipeline as j_pipeline
from bwamem_tpu.engine import seed as j_seed
from bwamem_tpu.index import build as j_build
from bwamem_tpu.index import bwa_img as j_bwa_img
from bwamem_tpu.index import bwtfile as j_bwtfile
from bwamem_tpu.index import image as j_image
from bwamem_tpu.utils import encoding as j_encoding
from bwamem_tpu.utils import fasta as j_fasta
from bwamem_tpu.utils import synth as j_synth
from bwamem_tpu_torch.api import options as p_options
from bwamem_tpu_torch.engine import chain as p_chain
from bwamem_tpu_torch.engine import extend as p_extend
from bwamem_tpu_torch.engine import finalize as p_finalize
from bwamem_tpu_torch.engine import native_fm as p_native_fm
from bwamem_tpu_torch.engine import pair as p_pair
from bwamem_tpu_torch.engine import pipeline as p_pipeline
from bwamem_tpu_torch.engine import seed as p_seed
from bwamem_tpu_torch.index import build as p_build
from bwamem_tpu_torch.index import bwa_img as p_bwa_img
from bwamem_tpu_torch.index import bwtfile as p_bwtfile
from bwamem_tpu_torch.index import image as p_image
from bwamem_tpu_torch.utils import encoding as p_encoding
from bwamem_tpu_torch.utils import fasta as p_fasta
from bwamem_tpu_torch.utils import synth as p_synth

ROTAVIRUS = os.path.join(os.path.dirname(__file__), "fixtures",
                         "rotavirus.bwa.img")
READ_L1 = b"GGCTTTTAATGCTTTTCAGTGGTTGCTGCTCAAGATGGAGTCTACTCAGCAGATGGTAAGCTCTATTATT"
READ_SNV = b"GGCTTTTAATGCTTTTCAGTGCTAGGTGCTCAAGATGGAGTCTACTCAGCAGATGGTAAGCTCTATTATT"
READ_RC = b"AATAATAGAGCTTACCATCTGCTGAGTAGACTCCATCTTGAGCAGCAACCACTGAAAAGCATTAAAAGCC"
READ_DEL = b"AATACTTCTTTTGAAGCTGCAGTTGTTGCTGCCTTCAACATTAGAATTAATGGGTATTCAATATGATT"
READ_P2 = b"TTGTTTTTAACACCAGAGTCATCCATCACATAATCAAATTTACTTTTAACTCTGGTAAATACTTCATTGT"


class Pkg:
    """One package's host layer under common names."""

    def __init__(self, top, options, build, bwtfile, image, bwa_img, fasta,
                 encoding, synth, seed, chain, extend, finalize, pair, pipeline,
                 native_fm):
        self.__dict__.update(locals())


JAX = Pkg(bwamem_tpu, j_options, j_build, j_bwtfile, j_image, j_bwa_img,
          j_fasta, j_encoding, j_synth, j_seed, j_chain, j_extend, j_finalize,
          j_pair, j_pipeline, j_native_fm)
PORT = Pkg(bwamem_tpu_torch, p_options, p_build, p_bwtfile, p_image, p_bwa_img,
           p_fasta, p_encoding, p_synth, p_seed, p_chain, p_extend, p_finalize,
           p_pair, p_pipeline, p_native_fm)
PKGS = (JAX, PORT)


def _genome():
    """40 kbp in two contigs, with a repeat and a run of N (an .amb hole)."""
    rng = np.random.default_rng(31)
    a = rng.integers(0, 4, 30_000).astype(np.uint8)
    a[20_000:20_400] = a[3_000:3_400]
    a[9_000:9_040] = 4
    return [a, rng.integers(0, 4, 10_000).astype(np.uint8)]


def _index(pkg, sa_intv=32):
    return pkg.build.build_index(pkg.fasta.Fasta(
        [pkg.fasta.FastaContig(f"c{i}", "", c.copy())
         for i, c in enumerate(_genome())]), sa_intv=sa_intv)


@pytest.fixture(scope="module")
def engines():
    """Per package: the index, the engine and the default options."""
    return [(pkg, pkg.pipeline.Engine(_index(pkg)), pkg.options.MemOptions())
            for pkg in PKGS]


@pytest.fixture(scope="module")
def reads():
    contigs = _genome()
    pairs = p_synth.simulate_pairs(
        np.where(contigs[0] > 3, 0, contigs[0]), np.random.default_rng(32), 12)
    return p_encoding.seq_to_codes_batch(pairs)


def _files(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


def _fields(x):
    """An object of either package as plain data: dataclasses and objects
    by field, arrays as lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _fields(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_fields(v) for v in x]
    if hasattr(x, "__dict__") and not isinstance(x, type):
        return {k: _fields(v) for k, v in vars(x).items()
                if not k.startswith("_")}
    return x


@pytest.mark.parametrize("sa_intv", (8, 32))
def test_index_files_and_images_are_byte_equal(tmp_path, sa_intv):
    """build_index -> the five bwa files, the image and the bwa-format
    image: the same bytes from both packages; and each reads the other's."""
    made = []
    for pkg, name in zip(PKGS, ("jax", "port")):
        d = tmp_path / name
        d.mkdir()
        idx = _index(pkg, sa_intv)
        pkg.bwtfile.write_index_files(str(d / "g"), idx)
        pkg.image.write_image(str(d / "g.img"), idx)
        pkg.bwa_img.write_bwa_image(str(d / "g.bwa.img"), idx)
        made.append(_files(d))
    assert sorted(made[0]) == sorted(made[1]) and len(made[0]) >= 7
    for f in made[0]:
        assert made[0][f] == made[1][f], f
    back = [pkg.bwtfile.read_index_files(str(tmp_path / other / "g"))
            for pkg, other in zip(PKGS, ("port", "jax"))]
    assert _fields(back[0].bns) == _fields(back[1].bns)
    for a, b in zip(*[[idx.bwt.bwt, idx.bwt.sa, idx.pac] for idx in back]):
        assert np.array_equal(a, b)
    imgs = [pkg.image.read_image(str(tmp_path / other / "g.img"))
            for pkg, other in zip(PKGS, ("port", "jax"))]
    assert _fields(imgs[0].bns) == _fields(imgs[1].bns) == _fields(back[0].bns)
    assert np.array_equal(imgs[0].bwt.sa, imgs[1].bwt.sa)


def test_rotavirus_image_loads_alike():
    a, b = (pkg.bwa_img.read_bwa_image(ROTAVIRUS) for pkg in PKGS)
    assert _fields(a.bns) == _fields(b.bns)
    assert a.bns.l_pac == 1074 and [x.name for x in b.bns.anns] == ["rotavirus"]
    for x, y in ((a.bwt.bwt, b.bwt.bwt), (a.bwt.sa, b.bwt.sa), (a.pac, b.pac)):
        assert np.array_equal(x, y)


def _natives(monkeypatch, on: bool):
    monkeypatch.setenv("BWAMEM_TPU_DISABLE_NATIVE", "0" if on else "1")


@pytest.mark.parametrize("natives", (True, False), ids=("natives", "python"))
def test_collect_intv_matches(engines, reads, monkeypatch, natives):
    """The per-read oracle, and the batch entry of the host C++ (or the
    lockstep oracle without it)."""
    _natives(monkeypatch, natives)
    got = []
    for pkg, eng, opt in engines:
        per_read = [[tuple(p) for p in pkg.seed.collect_intv(opt, eng.fm, q)]
                    for q in reads]
        if natives:
            assert pkg.native_fm.available()
            batch = pkg.native_fm.collect_intv_batch(opt, eng.fm, reads)
        else:
            from importlib import import_module
            batch = import_module(pkg.top.__name__ + ".engine.seed_batch"
                                  ).collect_intv_batch(opt, eng.fm, reads)
        assert [[tuple(p) for p in iv] for iv in batch] == per_read
        got.append(per_read)
    assert got[0] == got[1] and sum(map(len, got[0])) > len(reads)


def _chains(pkg, eng, opt, q):
    return pkg.chain.chain_flt(opt, pkg.chain.mem_chain(
        opt, eng.fm, eng.idx.bns, len(q), pkg.seed.collect_intv(opt, eng.fm, q)))


def test_mem_chain_and_chain_flt_match(engines, reads):
    got = [[_fields(_chains(pkg, eng, opt, q)) for q in reads]
           for pkg, eng, opt in engines]
    assert got[0] == got[1] and any(len(c) > 1 for c in got[0])


def test_chain2aln_and_sort_dedup_patch_match(engines, reads):
    got = []
    for pkg, eng, opt in engines:
        per_read = []
        for q in reads:
            regs = []
            for c in _chains(pkg, eng, opt, q):
                pkg.extend.chain2aln(opt, eng.idx, len(q), q, c, regs)
            raw = _fields(regs)
            per_read.append((raw, _fields(pkg.finalize.sort_dedup_patch(
                opt, eng.idx, q, regs))))
        got.append(per_read)
    assert got[0] == got[1] and all(raw for raw, _ in got[0])


@pytest.mark.parametrize("natives", (True, False), ids=("natives", "python"))
def test_sam_pe_records_match(engines, reads, monkeypatch, natives):
    """Regions of every read, the inferred PE statistics and each pair's
    engine records (mate rescue, pairing, MAPQ, CIGAR, MD, XA)."""
    _natives(monkeypatch, natives)
    got = []
    for pkg, eng, opt in engines:
        opt = opt.copy()
        opt.flag |= pkg.options.MEM_F_PE
        regs = []
        for q in reads:
            r = []
            for c in _chains(pkg, eng, opt, q):
                pkg.extend.chain2aln(opt, eng.idx, len(q), q, c, r)
            regs.append(pkg.pipeline._flag_alt_regs(
                eng.idx.bns, pkg.finalize.sort_dedup_patch(opt, eng.idx, q, r)))
        pes = pkg.pair.pestat(opt, eng.idx.bns.l_pac, regs)
        recs = [pkg.pair.sam_pe(opt, eng, pes, i, (reads[2 * i], reads[2 * i + 1]),
                                [regs[2 * i], regs[2 * i + 1]])
                for i in range(len(reads) // 2)]
        got.append((_fields(pes), _fields(recs)))
    assert got[0] == got[1]
    assert all(a and b for a, b in got[0][1])


@pytest.mark.parametrize("natives", (True, False), ids=("natives", "python"))
@pytest.mark.parametrize("mode", ("se", "pe"))
def test_golden_reads_match(monkeypatch, mode, natives):
    """The four golden reads single-end and the PE pair of the rotavirus
    image through each package's aligner with every stage on the host."""
    _natives(monkeypatch, natives)
    got = []
    for pkg in PKGS:
        index = pkg.top.BwaMemIndex(ROTAVIRUS)
        aligner = (pkg.top.BwaMemAligner(index) if pkg is JAX else
                   pkg.top.BwaMemAligner(index, device="cpu",
                                         min_device_jobs=1 << 30))
        if mode == "pe":
            aligner.align_pairs()
            seqs = [READ_L1, READ_P2]
        else:
            seqs = [READ_L1, READ_SNV, READ_RC, READ_DEL]
        got.append([[dataclasses.astuple(a) for a in r]
                    for r in aligner.align_seqs(seqs)])
        index.close()
    assert got[0] == got[1]
    if mode == "se":
        assert [r[0][10] for r in got[1]] == ["70M", "70M", "70M", "32M2D36M"]
    else:
        assert [r[0][-1] for r in got[1]] == [210, -210]


def test_options_pack_alike():
    a, b = j_options.MemOptions(), p_options.MemOptions()
    assert _fields(a) == _fields(b) and a.pack() == b.pack()
    a.set_intra_ctg()
    b.set_intra_ctg()
    assert a.pack() == b.pack()
