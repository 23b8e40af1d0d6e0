"""The port's fused device path (engine/pipeline_device.py
``regs_batch_fused`` on the CPU, where ``ops.pipeline_fused.chain2aln`` runs
its plain PyTorch version) against the JAX package's one-dispatch program
(bwamem_tpu/engine/pipeline_device.py ``regs_batch_fused``, on the CPU) and
the host oracle (collect_intv -> mem_chain -> chain_flt -> chain2aln):
regions field by field and in order, tolerance 0 (integers; ``frac_rep`` to
1e-9, as the reference's own test compares it).  The CUDA kernels are held
against the plain version in test_torch_cuda.py.

The cases are those of tests/test_pipeline_fused_adversarial.py (a repeat
field, non-default options, contig borders and genome ends) and of
tests/test_pipeline_fused.py (two contigs; the rotavirus case on
tests/fixtures/rotavirus.bwa.img), at smaller read counts: the JAX program
compiles once per shape on the CPU.  Each package gets its own index, built
from the same seeded genome.
"""
import os

import numpy as np
import pytest
import torch

import bwamem_tpu
import bwamem_tpu_torch
from bwamem_tpu.api.options import MemOptions as JaxOptions
from bwamem_tpu.engine import chain as jax_chain
from bwamem_tpu.engine import extend as jax_extend
from bwamem_tpu.engine import seed as jax_seed
from bwamem_tpu.engine.pipeline import Engine as JaxEngine
from bwamem_tpu.engine.pipeline_device import regs_batch_fused as jax_fused
from bwamem_tpu.index import build as jax_build
from bwamem_tpu.utils import fasta as jax_fasta
from bwamem_tpu_torch.api.options import MemOptions
from bwamem_tpu_torch.engine.exec_ctx import ExecConfig
from bwamem_tpu_torch.engine.pipeline import Engine
from bwamem_tpu_torch.engine.pipeline_device import FUSED_STATS, regs_batch_fused
from bwamem_tpu_torch.index import build as port_build
from bwamem_tpu_torch.ops import pipeline_fused as fo
from bwamem_tpu_torch.utils import fasta as port_fasta

ROTAVIRUS = os.path.join(os.path.dirname(__file__), "fixtures",
                         "rotavirus.bwa.img")
FIELDS = ("rb", "re", "qb", "qe", "rid", "score", "truesc", "w", "seedcov",
          "seedlen0")
CPU = ExecConfig(device="cpu", min_device_jobs=1, device_pipeline=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops lose to thread start-up, and the suite runs several
    workers at once: keep torch to one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(contigs):
    """(the JAX package's engine, the port's) on the same contigs."""
    def make(build, fasta, engine_cls):
        return engine_cls(build.build_index(fasta.Fasta(
            [fasta.FastaContig(f"t{i}", "", c.copy())
             for i, c in enumerate(contigs)])))

    return (make(jax_build, jax_fasta, JaxEngine),
            make(port_build, port_fasta, Engine))


def _oracle(jopt, jeng, read):
    intervals = jax_seed.collect_intv(jopt, jeng.fm, read)
    chains = jax_chain.chain_flt(jopt, jax_chain.mem_chain(
        jopt, jeng.fm, jeng.idx.bns, len(read), intervals, None))
    jax_chain.flt_chained_seeds(jopt, jeng.idx, len(read), read, chains)
    regs = []
    for c in chains:
        jax_extend.chain2aln(jopt, jeng.idx, len(read), read, c, regs)
    return regs


def _same(got, want, ctx):
    assert len(got) == len(want), (ctx, len(got), len(want))
    for g, w in zip(got, want):
        for f in FIELDS:
            assert getattr(g, f) == getattr(w, f), (ctx, f, g, w)
        assert abs(g.frac_rep - w.frac_rep) < 1e-9, (ctx, g, w)


def _cmp_all(kw, engines, reads, ctx):
    """The port's fused path = the oracle = the JAX fused path, on every
    read; returns the oracle's regions."""
    jeng, eng = engines
    jopt, opt = JaxOptions(), MemOptions()
    for k, v in kw.items():
        setattr(jopt, k, v)
        setattr(opt, k, v)
    FUSED_STATS.reset()
    before = dict(fo.LAUNCHES)
    got = regs_batch_fused(opt, eng, reads, CPU)
    assert fo.LAUNCHES == before  # the CPU launches no kernel
    assert FUSED_STATS.device_reads + FUSED_STATS.host_reads == len(reads)
    want = [_oracle(jopt, jeng, r) for r in reads]
    ref = jax_fused(jopt, jeng, reads)
    for i in range(len(reads)):
        _same(got[i], want[i], (ctx, "oracle", i))
        _same(got[i], ref[i], (ctx, "jax", i))
    return want


def _fwd(eng):
    return eng.idx.get_seq(0, eng.idx.bns.l_pac)


def _rc(r):
    return np.where(r < 4, 3 - r, 4)[::-1].copy()


@pytest.fixture(scope="module")
def eng_repeat():
    rng = np.random.default_rng(17)
    motif = rng.integers(0, 4, 60).astype(np.uint8)
    parts = []
    for _ in range(400):
        parts.append(motif)
        parts.append(rng.integers(0, 4, 25).astype(np.uint8))
    parts.append(rng.integers(0, 4, 30_000).astype(np.uint8))
    return _engines([np.concatenate(parts)])


@pytest.fixture(scope="module")
def eng_tiny_contigs():
    rng = np.random.default_rng(19)
    return _engines([rng.integers(0, 4, n).astype(np.uint8)
                     for n in (900, 450, 12_000, 300)])


def test_repeat_field(eng_repeat):
    """Reads inside a field of 400 copies of a motif (many regions a read,
    seeds pruned against them) beside reads of the unique region."""
    fwd = _fwd(eng_repeat[1])
    rng = np.random.default_rng(23)
    reads = []
    for _ in range(10):
        s = int(rng.integers(0, 30_000))
        reads.append(fwd[s: s + 120].copy())
    for _ in range(10):
        s = int(rng.integers(len(fwd) - 28_000, len(fwd) - 200))
        reads.append(fwd[s: s + 150].copy())
    want = _cmp_all({}, eng_repeat, reads, "repeat field")
    assert FUSED_STATS.device_reads == len(reads)
    assert max(len(w) for w in want) > 8 and FUSED_STATS.pruned > 0


def test_nondefault_options(eng_tiny_contigs):
    fwd = _fwd(eng_tiny_contigs[1])
    rng = np.random.default_rng(29)
    reads = []
    for _ in range(40):
        L = int(rng.integers(40, 151))
        s = int(rng.integers(0, len(fwd) - L))
        r = fwd[s: s + L].copy()
        for p in rng.integers(0, L, rng.integers(0, 6)):
            r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        reads.append(_rc(r) if rng.integers(0, 2) else r)
    _cmp_all(dict(w=50, zdrop=25, pen_clip5=2, pen_clip3=9, min_seed_len=15,
                  max_occ=40), eng_tiny_contigs, reads, "nondefault opts")
    assert FUSED_STATS.device_reads == len(reads)


def test_contig_borders_and_genome_ends(eng_tiny_contigs):
    eng = eng_tiny_contigs[1]
    bns = eng.idx.bns
    fwd = _fwd(eng)
    reads = []
    for a in bns.anns:  # reads across every contig junction
        for off in (-80, -40, -10):
            s = a.offset + a.length + off
            if 0 <= s and s + 100 <= bns.l_pac:
                reads.append(fwd[s: s + 100].copy())
    reads += [fwd[:90].copy(), fwd[-90:].copy(), _rc(fwd[-120:])]
    _cmp_all({}, eng_tiny_contigs, reads, "contig borders")


def _reads_for(rng, fwd, n):
    """tests/test_pipeline_fused.py's read generator: substitutions, spliced
    loci, N runs, both strands."""
    reads = []
    for _ in range(n):
        L = int(rng.integers(30, 151))
        s = int(rng.integers(0, len(fwd) - L))
        r = fwd[s: s + L].copy()
        for p in rng.integers(0, L, rng.integers(0, 5)):
            r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        if rng.integers(0, 5) == 0:
            s2 = int(rng.integers(0, len(fwd) - L))
            cut = int(rng.integers(5, L - 5))
            r = np.concatenate([r[:cut], fwd[s2: s2 + (L - cut)]])
        if rng.integers(0, 4) == 0:
            p = int(rng.integers(0, len(r)))
            r[p: p + int(rng.integers(1, 3))] = 4
        reads.append((_rc(r) if rng.integers(0, 2) else r).astype(np.uint8))
    return reads


def test_two_contigs():
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, 60_000).astype(np.uint8)
    codes[30_000:30_400] = codes[5_000:5_400]  # repeat field
    codes[45_000:45_050] = codes[5_000:5_050]
    engines = _engines([codes[:40_000], codes[40_000:]])
    reads = _reads_for(np.random.default_rng(9), _fwd(engines[1]), 60)
    want = _cmp_all({}, engines, reads, "two contigs")
    assert sum(len(w) > 1 for w in want) >= 3


def test_rotavirus_image():
    """The rotavirus case of the reference's test, on the fixture image:
    each package opens it with its own loader."""
    jidx, idx = bwamem_tpu.BwaMemIndex(ROTAVIRUS), bwamem_tpu_torch.BwaMemIndex(
        ROTAVIRUS)
    try:
        engines = (jidx._require(), idx._require())
        reads = _reads_for(np.random.default_rng(7), _fwd(engines[1]), 60)
        _cmp_all({}, engines, reads, "rotavirus")
    finally:
        jidx.close()
        idx.close()
