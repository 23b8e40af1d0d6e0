"""The plain PyTorch version of the chain-to-region stage
(ops/pipeline_fused.py ``chain2aln_torch``) alone against the JAX package's
host oracle (bwamem_tpu/engine/extend.py ``chain2aln``) on the same chains,
field for field, tolerance 0: forced band retries, windows at the strand
boundary, reads of 800 bases and more, reads from both strands of a
three-contig genome with repeats.  Then the parts around it: the windows
against the wave runner's, the budget rules of ``regs_batch_fused`` (reads
with ``fcs`` active and reads flagged by C take the staged path and are
counted by cause), the band preamble, the device reference, the gather of
flagged reads' rows, the opt-in bench hooks, and the loop kernel's limits
and read order, which its wrapper computes on the host side.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from bwamem_tpu.api.options import MemOptions as JaxOptions
from bwamem_tpu.engine import chain as jax_chain
from bwamem_tpu.engine import extend as jax_extend
from bwamem_tpu.engine import pipeline_device as jax_pd
from bwamem_tpu.engine import seed_device as jax_sd
from bwamem_tpu.index import build as jax_build
from bwamem_tpu.utils import fasta as jax_fasta
from bwamem_tpu_torch.api.options import MemOptions
from bwamem_tpu_torch.engine import chain as port_chain
from bwamem_tpu_torch.engine import exec_ctx, extend_batch, native_chain, native_fm
from bwamem_tpu_torch.engine import pipeline, pipeline_device
from bwamem_tpu_torch.engine import seed as port_seed
from bwamem_tpu_torch.engine.exec_ctx import ExecConfig
from bwamem_tpu_torch.engine.extend import chain2aln as port_chain2aln
from bwamem_tpu_torch.engine.extend import ksw_extend2
from bwamem_tpu_torch.engine.pipeline import Engine
from bwamem_tpu_torch.engine.pipeline_device import FUSED_STATS, regs_batch_fused
from bwamem_tpu_torch.engine.state import (device_contigs, device_ref,
                                           device_scoring)
from bwamem_tpu_torch.index import build as port_build
from bwamem_tpu_torch.ops import chain as co
from bwamem_tpu_torch.ops import extend as ext
from bwamem_tpu_torch.ops import pipeline_fused as fo
from bwamem_tpu_torch.ops.seed import pad_reads
from bwamem_tpu_torch.utils import chain_cases, fused_cases
from bwamem_tpu_torch.utils import fasta as port_fasta

FIELDS = ("rb", "re", "qb", "qe", "rid", "score", "truesc", "w", "seedcov",
          "seedlen0", "frac_rep")
CPU = ExecConfig(device="cpu", min_device_jobs=1, device_pipeline=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """(the JAX package's index, the port's engine, the contigs) on the chain
    cases' three-contig genome; the last contig is ALT."""
    contigs = chain_cases.genome(np.random.default_rng(7))

    def make(build, fasta):
        idx = build.build_index(fasta.Fasta(
            [fasta.FastaContig(f"c{i}", "", c.copy())
             for i, c in enumerate(contigs)]))
        idx.bns.anns[2].is_alt = 1
        return idx

    return make(jax_build, jax_fasta), Engine(make(port_build, port_fasta)), contigs


def _chains(eng, opt, reads):
    """The reads' chains on the CPU as ``ops.chain.Chains``, from seeds of
    the port's host oracle, and the same chains as ``Chain`` lists."""
    ivs = [port_seed.collect_intv(opt, eng.fm, q) for q in reads]
    rbs = [[eng.fm.sa_lookup(np.asarray(port_chain.sample_ks(p, opt.max_occ),
                                        dtype=np.int64)) for p in iv]
           for iv in ivs]
    tab = co.SeedTable.from_numpy(
        "cpu", *chain_cases.seed_table(ivs, rbs, [len(r) for r in reads]))
    ctg = device_contigs(eng.idx.bns, "cpu")
    params = co.ChainParams.from_opt(opt)
    lists, _ = co.chains_device_batch(ctg, tab, params)
    return co.chain_torch(ctg, tab, params), lists


def _plain(eng, opt, reads, chains, run=None):
    qseq, qlen = pad_reads(reads, "cpu")
    if run is None:
        run = torch.ones(len(reads), dtype=torch.bool)
    return fo.chain2aln(
        device_contigs(eng.idx.bns, "cpu"), device_ref(eng.idx, "cpu"), chains,
        qseq, qlen, run, fo.ExtendParams.from_opt(opt),
        device_scoring(opt, "cpu").mat)


def _rows(regs: fo.Regions):
    """Per read its regions as tuples in FIELDS order."""
    rows = regs.compact().numpy()
    frac = rows[:, 2].copy().view(np.float64)
    out, k = [], 0
    for n in regs.nregs.tolist():
        out.append([(int(r[0]), int(r[1]), int(r[3]), int(r[4]), int(r[10]),
                     int(r[5]), int(r[6]), int(r[7]), int(r[8]), int(r[9]),
                     float(f)) for r, f in zip(rows[k: k + n], frac[k: k + n])])
        k += n
    return out


def _jax_oracle(jidx, jopt, reads, lists):
    """bwamem_tpu's chain2aln over the same chains, as tuples."""
    out = []
    for q, chains in zip(reads, lists):
        regs = []
        for c in chains:
            jc = jax_chain.Chain(
                rid=c.rid, is_alt=c.is_alt, frac_rep=c.frac_rep, w=c.w,
                kept=c.kept, first=c.first,
                seeds=[jax_chain.Seed(rbeg=s.rbeg, qbeg=s.qbeg, len=s.len,
                                      score=s.score) for s in c.seeds])
            jax_extend.chain2aln(jopt, jidx, len(q), q, jc, regs)
        out.append([tuple(getattr(a, f) for f in FIELDS) for a in regs])
    return out


def _opts(**kw):
    return fused_cases.options(JaxOptions(), kw), fused_cases.options(
        MemOptions(), kw)


_rc = fused_cases.revcomp
CASES = fused_cases.CASES


@pytest.mark.parametrize("case", CASES)
def test_chain2aln_torch_matches_oracle(engines, case):
    jidx, eng, contigs = engines
    kw, make = CASES[case]
    jopt, opt = _opts(**kw)
    reads = make(contigs)
    chains, lists = _chains(eng, opt, reads)
    before = dict(fo.LAUNCHES)
    regs = _plain(eng, opt, reads, chains)
    assert fo.LAUNCHES == before  # the CPU launches no kernel
    got, want = _rows(regs), _jax_oracle(jidx, jopt, reads, lists)
    assert got == want
    work = regs.work.numpy()
    assert work[:, fo.W_TASKS].tolist() == [len(w) for w in want]
    assert (work[:, fo.W_TASKS] + work[:, fo.W_PRUNED]).tolist() == [
        sum(len(c.seeds) for c in cl) for cl in lists]
    if case == "fuzz":  # the genome must exercise the pruning and its veto
        assert work[:, fo.W_PRUNED].sum() > 0
        assert any(len(w) > 2 for w in want)
    if case == "band_retry":
        assert sum(any(r[7] == 2 * opt.w for r in w) for w in want) >= 5
    if case == "long_reads":
        assert all(not pipeline_device.fcs_noop(opt, len(r)) for r in reads)


@pytest.mark.parametrize("case", ["band_retry", "clips_zdrop"])
def test_chain2aln_torch_counts_cells_and_rows(engines, monkeypatch, case):
    """``work``'s band cells and target rows per read equal the sums over
    the read's extension jobs (band retries included) of the scalar
    recurrence's counts, each job taken from the host oracle's own calls."""
    from test_torch_warp_models import scalar_extend

    from bwamem_tpu_torch.engine import extend as host_extend

    _, eng, contigs = engines
    kw, make = CASES[case]
    _, opt = _opts(**kw)
    reads = make(contigs)[:24]
    chains, lists = _chains(eng, opt, reads)
    regs = _plain(eng, opt, reads, chains)
    orig, tally = host_extend.ksw_extend2, [0, 0]

    def counted(q, t, mat, o_del, e_del, o_ins, e_ins, w, bonus, zdrop, h0):
        res = orig(q, t, mat, o_del, e_del, o_ins, e_ins, w, bonus, zdrop, h0)
        w_adj = int(ext.band_width(*(torch.tensor([v], dtype=torch.int32)
                                     for v in (len(q), w, bonus)),
                                   max(mat), o_del, e_del, o_ins, e_ins))
        got = scalar_extend([int(x) for x in q], [int(x) for x in t], h0, w_adj,
                            np.reshape(mat, (5, 5)).tolist(), o_del, e_del,
                            o_ins, e_ins, zdrop)
        assert got["score"] == res.score
        tally[0] += got["cells"]
        tally[1] += got["rows"]
        return res

    monkeypatch.setattr(host_extend, "ksw_extend2", counted)
    want = []
    for q, cl in zip(reads, lists):
        tally[:] = [0, 0]
        out = []
        for c in cl:
            port_chain2aln(opt, eng.idx, len(q), q, c, out)
        want.append(tuple(tally))
    work = regs.work.numpy()
    assert list(zip(work[:, fo.W_CELLS].tolist(),
                    work[:, fo.W_ROWS].tolist())) == want
    assert work[:, fo.W_JOBS].sum() > len(reads)


def test_run_mask_leaves_reads_out(engines):
    _, eng, contigs = engines
    opt = MemOptions()
    reads = chain_cases.reads(contigs, np.random.default_rng(13), 10)
    chains, _ = _chains(eng, opt, reads)
    run = torch.arange(len(reads)) % 2 == 0
    full, part = _plain(eng, opt, reads, chains), _plain(eng, opt, reads, chains,
                                                         run)
    assert part.nregs.tolist() == [n if i % 2 == 0 else 0
                                   for i, n in enumerate(full.nregs.tolist())]
    assert _rows(part)[::2] == _rows(full)[::2]


def test_windows_match_the_wave_runner(engines):
    """Per chain [rmax0, rmax1] and the srt order, against the host wave
    runner's preparation (engine/extend_batch.py ``_prep_read``), with reads
    at both ends of the genome and of each contig."""
    _, eng, contigs = engines
    opt = MemOptions()
    reads = chain_cases.reads(contigs, np.random.default_rng(14), 40)
    reads += fused_cases.boundary_reads(contigs)
    chains, lists = _chains(eng, opt, reads)
    lay = fo._layout(chains)
    _, qlen = pad_reads(reads, "cpu")
    r0, r1, perm, _ = fo.chain_windows(
        device_contigs(eng.idx.bns, "cpu"), chains, lay, qlen,
        fo.ExtendParams.from_opt(opt))
    ci = 0
    l_pac = eng.idx.bns.l_pac
    at_boundary = 0
    for q, cl in zip(reads, lists):
        st = extend_batch._prep_read(opt, eng.idx, q, cl)
        for k, c in enumerate(cl):
            assert (int(r0[ci]), int(r1[ci])) == st.rmax[k]
            off, ns = int(lay.chain_seed_off[ci]), len(c.seeds)
            assert (perm[off: off + ns] - off).tolist() == st.srt[k]
            at_boundary += l_pac in st.rmax[k]
            ci += 1
    assert ci == chains.chain_rows.shape[0] and at_boundary >= 3


def test_max_gap_is_the_oracles(engines):
    for kw in (dict(), dict(a=2, o_del=5, e_del=3, o_ins=7, e_ins=2, w=37)):
        _, opt = _opts(**kw)
        x = torch.arange(-5, 700)
        got = fo.max_gap(x, fo.ExtendParams.from_opt(opt))
        assert got.tolist() == [opt.max_gap(int(v)) for v in x]


@pytest.mark.parametrize("natives", (True, False), ids=("natives", "oracle"))
def test_fcs_and_c_flagged_reads_take_the_staged_path(engines, monkeypatch,
                                                      natives):
    """Reads of 800 bases and more (mem_flt_chained_seeds would act) and
    reads that need more than C chain slots leave the fused path, are counted
    by cause and equal the full host oracle."""
    jidx, eng, contigs = engines
    if not natives:
        monkeypatch.setattr(native_fm, "available", lambda: False)
        monkeypatch.setattr(native_chain, "available", lambda: False)
    opt = MemOptions()
    reads = chain_cases.reads(contigs, np.random.default_rng(15), 12)
    long_reads = [contigs[0][6_000:6_800].copy(), _rc(contigs[0][15_000:15_900])]
    for r in long_reads:
        r[::70] = (r[::70] + 1) % 4
    reads = reads[:6] + long_reads + reads[6:]
    monkeypatch.setattr(pipeline_device.chainops, "chain",
                        functools.partial(co.chain, C=2))

    def oracle(q):
        chains = port_chain.chain_flt(opt, port_chain.mem_chain(
            opt, eng.fm, eng.idx.bns, len(q), port_seed.collect_intv(
                opt, eng.fm, q), None))
        port_chain.flt_chained_seeds(opt, eng.idx, len(q), q, chains)
        regs = []
        for c in chains:
            port_chain2aln(opt, eng.idx, len(q), q, c, regs)
        return regs

    FUSED_STATS.reset()
    got = regs_batch_fused(opt, eng, reads, CPU)
    for g, q in zip(got, reads):
        assert ([dataclasses.astuple(a) for a in g]
                == [dataclasses.astuple(a) for a in oracle(q)])
    st = FUSED_STATS
    assert st.c_overflows > 0 and st.fcs_reads + st.host_seeded >= 2
    assert st.host_reads == st.c_overflows + st.fcs_reads + st.host_seeded
    assert st.device_reads + st.host_reads == len(reads) and st.device_reads > 0


def test_reads_past_the_loop_kernels_limit_take_the_staged_path(engines,
                                                                monkeypatch):
    """With the loop kernel's read-length limit cut below some reads of a
    batch, those reads leave the fused path as a counted cause of their own
    (the batch does not raise), and every read's regions still equal the
    host oracle's."""
    _, eng, contigs = engines
    opt = MemOptions()
    reads = chain_cases.reads(contigs, np.random.default_rng(17), 16)
    reads = [r[: 2 * len(r) // 3] if i % 2 else r for i, r in enumerate(reads)]
    limit = max(len(r) for r in reads[1::2])
    assert limit < min(len(r) for r in reads[::2])
    monkeypatch.setattr(fo, "MAX_QLEN", limit)

    def oracle(q):
        chains = port_chain.chain_flt(opt, port_chain.mem_chain(
            opt, eng.fm, eng.idx.bns, len(q), port_seed.collect_intv(
                opt, eng.fm, q), None))
        port_chain.flt_chained_seeds(opt, eng.idx, len(q), q, chains)
        regs = []
        for c in chains:
            port_chain2aln(opt, eng.idx, len(q), q, c, regs)
        return regs

    FUSED_STATS.reset()
    got = regs_batch_fused(opt, eng, reads, CPU)
    for g, q in zip(got, reads):
        assert ([dataclasses.astuple(a) for a in g]
                == [dataclasses.astuple(a) for a in oracle(q)])
    st = FUSED_STATS
    assert st.long_reads == sum(len(r) > limit for r in reads) > 0
    assert st.host_reads == (st.c_overflows + st.fcs_reads + st.host_seeded
                             + st.long_reads)
    assert st.device_reads == len(reads) - st.host_reads > 0


def test_fcs_gate_and_window_budget_are_the_references():
    for kw in (dict(), dict(min_chain_weight=30), dict(w=50, a=2)):
        jopt, opt = _opts(**kw)
        for qlen in (0, 1, 19, 150, 400, 699, 700, 720, 1500, 20_000):
            assert pipeline_device.fcs_noop(opt, qlen) == jax_pd._fcs_noop(
                jopt, qlen)
        for longest in (1, 64, 65, 150, 192, 300, 513, 1100):
            L = jax_sd._bucket(longest, jax_sd._L_BUCKETS)
            assert pipeline_device.ref_t_cap(opt, longest) == jax_pd._t_cap(jopt, L)
    assert (pipeline_device.REF_S_SLOTS, pipeline_device.REF_C_SLOTS,
            pipeline_device.REF_R_SLOTS) == (jax_pd.S_SLOTS, jax_pd.C_SLOTS,
                                             jax_pd.R_SLOTS)


def test_band_width_is_ksw_extend2s_preamble():
    """``band_width`` (floor division, the formula csrc/extend.cuh
    ``ksw_band_width`` repeats) against the oracle's truncated float
    quotient, negative numerators included; and through ``ksw_extend2``:
    a job whose band the preamble cuts scores as the oracle's."""
    rng = np.random.default_rng(3)
    for max_sc, o_del, e_del, o_ins, e_ins in ((1, 6, 1, 6, 1), (2, 9, 3, 4, 2),
                                               (1, 40, 7, 55, 5)):
        qlen = torch.from_numpy(rng.integers(0, 200, 500)).int()
        w = torch.from_numpy(rng.integers(1, 250, 500)).int()
        bonus = torch.from_numpy(rng.integers(0, 12, 500)).int()
        got = ext.band_width(qlen, w, bonus, max_sc, o_del, e_del, o_ins, e_ins)
        for q, w_, b, g in zip(qlen.tolist(), w.tolist(), bonus.tolist(),
                               got.tolist()):
            max_ins = int((q * max_sc + b - o_ins) / e_ins + 1.0)
            max_del = int((q * max_sc + b - o_del) / e_del + 1.0)
            assert g == min(w_, max(max_ins, 1), max(max_del, 1))
    opt = MemOptions()
    q = rng.integers(0, 4, 12).astype(np.uint8)
    t = np.concatenate([q[:6], rng.integers(0, 4, 30).astype(np.uint8), q[6:]])
    want = ksw_extend2(q, t, opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                       100, 5, opt.zdrop, 40)
    sc = device_scoring(opt, "cpu")
    got = ext.ksw_extend_torch(
        torch.from_numpy(q)[None], torch.from_numpy(t)[None],
        *(torch.tensor([v], dtype=torch.int32) for v in (12, len(t), 40, 100, 5)),
        sc.mat, sc.o_del, sc.e_del, sc.o_ins, sc.e_ins, sc.zdrop, sc.max_sc)
    assert {k: int(v) for k, v in got.items()} == vars(want)


def test_device_ref_reads_both_strands(engines):
    _, eng, _ = engines
    idx = eng.idx
    ref = device_ref(idx, "cpu")
    assert device_ref(idx, "cpu") is ref  # kept on the index object
    assert ref.pac.dtype == torch.uint8 and ref.l_pac == idx.bns.l_pac
    l_pac = idx.bns.l_pac
    rng = np.random.default_rng(8)
    for beg, end in [(0, 70), (l_pac - 33, l_pac), (l_pac, l_pac + 41),
                     (2 * l_pac - 29, 2 * l_pac)] + [
            (int(b), int(b) + 57) for b in rng.integers(0, l_pac - 60, 6)] + [
            (int(b), int(b) + 57) for b in rng.integers(l_pac, 2 * l_pac - 60, 6)]:
        got = fo.ref_codes(ref, torch.arange(beg, end))
        assert got.tolist() == idx.get_seq(beg, end).tolist(), (beg, end)
    ctg = device_contigs(idx.bns, "cpu")
    assert ctg.ctg_off.tolist() == [a.offset for a in idx.bns.anns]
    assert (ctg.ctg_end - ctg.ctg_off).tolist() == [a.length for a in idx.bns.anns]


def test_gather_reads_copies_only_the_named_reads(engines):
    _, eng, contigs = engines
    opt = MemOptions()
    reads = chain_cases.reads(contigs, np.random.default_rng(16), 20)
    ivs = [port_seed.collect_intv(opt, eng.fm, q) for q in reads]
    rbs = [[eng.fm.sa_lookup(np.asarray(port_chain.sample_ks(p, opt.max_occ),
                                        dtype=np.int64)) for p in iv]
           for iv in ivs]
    tab = co.SeedTable.from_numpy(
        "cpu", *chain_cases.seed_table(ivs, rbs, [len(r) for r in reads]))
    which = np.asarray([3, 4, 11, 19])
    got = pipeline.gather_reads(tab, which)
    want = chain_cases.seed_table([ivs[i] for i in which],
                                  [rbs[i] for i in which],
                                  [len(reads[i]) for i in which])[1:]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    for g in pipeline.gather_reads(tab, np.zeros(0, dtype=np.int64)):
        assert g.size == 0


def test_bench_hooks_are_opt_in(engines, monkeypatch):
    """Without ``exec_ctx.KEEP_LARGEST`` no stats object keeps a batch's
    tensors or job lists; with it each keeps its largest."""
    _, eng, contigs = engines
    opt = MemOptions()
    reads = chain_cases.reads(contigs, np.random.default_rng(17), 8)
    stats = ((pipeline.SA_STATS, "largest_rows"),
             (pipeline.CHAIN_STATS, "largest_table"),
             (extend_batch.STATS, "largest_wave"), (FUSED_STATS, "largest_batch"))
    stages = ExecConfig(device="cpu", min_device_jobs=1, device_seed=True,
                        device_sa_lookup=True, device_chain=True)
    for keep in (False, True):
        monkeypatch.setattr(exec_ctx, "KEEP_LARGEST", keep)
        for s, _ in stats:
            s.reset()
        pipeline.align_regs_batch(opt, eng, reads, stages)
        pipeline.align_regs_batch(opt, eng, reads, CPU)
        assert [getattr(s, name) is not None for s, name in stats] == [keep] * 4
    for s, _ in stats:
        s.reset()


def test_kernel_limits_and_read_order():
    """The loop kernel's limits, checked before a launch on the longest
    read it runs (reads left out of ``run`` do not count): scores in
    int8, reads of up to ``MAX_QLEN`` bases, every H of a job below
    ``MAX_H`` (the card's shared memory is a limit only there); and the
    order its warps take reads in, heaviest first."""
    mat = torch.from_numpy(np.asarray(MemOptions().mat, np.int32).reshape(5, 5))
    assert fo.kernel_max_qlen(mat, "cpu") == fo.MAX_QLEN
    assert fo.kernel_max_qlen(torch.where(mat > 0, 127, mat), "cpu") == min(
        fo.MAX_QLEN, (fo.MAX_H - 1) // 127 - 1)
    with pytest.raises(ValueError):
        fo.kernel_max_qlen(mat * 200, "cpu")
    qlen = torch.tensor([150, 5000, 90], dtype=torch.int32)
    run = torch.tensor([True, False, True])
    assert fo.kernel_query_len(qlen, run, mat) == 150
    with pytest.raises(ValueError):
        fo.kernel_query_len(qlen, torch.ones(3, dtype=torch.bool), mat)
    with pytest.raises(ValueError):
        fo.kernel_query_len(qlen, run, mat * 200)
    with pytest.raises(ValueError):  # (150 + 1) x 4,000 >= 2^19
        fo.kernel_query_len(qlen, run, torch.where(mat > 0, 4000, mat))
    n_seed = torch.tensor([3, 9, 9, 0, 40])
    order = fo.work_items(n_seed, torch.tensor([100, 150, 150, 150, 10]),
                          torch.tensor([True, True, True, True, False]),
                          torch.tensor([0, 1, 2, 4], dtype=torch.int32),
                          torch.zeros(5, dtype=torch.bool))
    assert order.dtype == torch.int32 and order.tolist() == [1, 2, 0, 3, 4]
