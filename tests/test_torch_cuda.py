"""The port on the card: the CUDA kernels (SW extension, occ4, bwt_extend,
SA walk, backward search, op probe, the seeding kernels smem1a, strategy1,
collect_intv and sample_ks, the chain kernels and the chain-to-region
kernels) against their plain PyTorch versions on the same CUDA tensors,
exactly, the FM, seeding, chain and chain-to-region kernels also against the
host oracles, and the aligner with device="cuda" (with and without the device
seed, SA and chain stages, and with the fused device path) against the
port's aligner with every stage on the host.

Imports nothing of JAX and nothing of bwamem_tpu, so that it runs where JAX
is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Skipped where torch.cuda.is_available() is false (checked at test time).
"""
import numpy as np
import pytest
import torch

from bwamem_tpu_torch.benchmarks import op_probe
from bwamem_tpu_torch.ops import chain as co
from bwamem_tpu_torch.ops import extend as ext
from bwamem_tpu_torch.ops import fmindex as fmops
from bwamem_tpu_torch.ops import pipeline_fused as fo
from bwamem_tpu_torch.ops import seed as so
from bwamem_tpu_torch.utils import chain_cases, fused_cases, seed_cases
from bwamem_tpu_torch.utils.extend_cases import ARRAYS, CASES, jobs, make_case

needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_matches_plain(name):
    case = make_case(name)
    args = [torch.from_numpy(case[k]).cuda() for k in ARRAYS]
    before = ext.LAUNCHES
    got = ext.ksw_extend(*args, **case["statics"])
    assert ext.LAUNCHES == before + 1
    plain = ext.ksw_extend_torch(*args, **case["statics"])
    for k in ext.KEYS:
        assert torch.equal(got[k], plain[k]), k


@pytest.mark.cuda
@needs_card
def test_cuda_wave_entry_matches_host_ksw():
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine import native_ksw
    from bwamem_tpu_torch.engine.state import device_scoring

    case = make_case("edges")
    js, h0s, ws, bons = jobs(case)
    opt = MemOptions()
    got = ext.ksw_extend_batch_np([q for q, _ in js], [t for _, t in js],
                                  device_scoring(opt, "cuda"), h0s, ws, bons)
    host = native_ksw.extend_batch(js, opt.mat, opt.o_del, opt.e_del, opt.o_ins,
                                   opt.e_ins, opt.zdrop, h0s, ws, bons)
    assert got == host


@pytest.fixture(scope="module", params=(8, 32), ids=("intv8", "intv32"))
def host_fm(request):
    from bwamem_tpu_torch.engine.fmindex import FMIndex
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

    rng = np.random.default_rng(44)
    codes = rng.integers(0, 4, 20000).astype(np.uint8)
    codes[5000:5300] = codes[100:400]
    return FMIndex(build_index(Fasta([FastaContig("c", "", codes)]),
                               sa_intv=request.param))


def _rows(fm, lo, n, seed):
    rng = np.random.default_rng(seed)
    edges = [0, 1, fm.primary - 1, fm.primary, fm.primary + 1, fm.seq_len - 1,
             fm.seq_len] + ([-1] if lo < 0 else [])
    return np.concatenate([edges, rng.integers(lo, fm.seq_len + 1, n)])


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("span", (128, 256, 512))
def test_cuda_fm_kernels_match_plain_and_host(host_fm, span):
    fm = host_fm
    dfm = fmops.DeviceFMIndex.from_host(fm, "cuda", span=span)
    ks = _rows(fm, -1, 5000, 1)
    kt = torch.from_numpy(ks).cuda()
    before = dict(fmops.LAUNCHES)
    got = fmops.occ4(dfm, kt)
    assert torch.equal(got, fmops.occ4_torch(dfm, kt))
    assert np.array_equal(got.cpu().numpy(), fm.occ4(ks))
    rows = _rows(fm, 0, 5000, 2)
    rt = torch.from_numpy(rows).cuda()
    got = fmops.sa_lookup(dfm, rt)
    assert torch.equal(got, fmops.sa_lookup_torch(dfm, rt))
    assert np.array_equal(got.cpu().numpy(), fm.sa_lookup(rows))
    rng = np.random.default_rng(3)
    x0, x1, s = fm.set_intv(rng.integers(0, 4, 2000))
    for is_back in (False, True, False, True):
        args = [torch.from_numpy(np.asarray(a, np.int64)).cuda()
                for a in (x0, x1, s)]
        got = fmops.extend(dfm, *args, is_back)
        plain = fmops.extend_torch(dfm, *args, is_back)
        exp = fm.extend(x0, x1, s, is_back)
        for g, p_, e in zip(got, plain, exp):
            assert torch.equal(g, p_)
            assert np.array_equal(g.cpu().numpy(), e)
        c = rng.integers(0, 4, len(x0))
        ar = np.arange(len(x0))
        keep = exp[2][ar, c] > 0
        x0 = np.where(keep, exp[0][ar, c], x0)
        x1 = np.where(keep, exp[1][ar, c], x1)
        s = np.where(keep, exp[2][ar, c], s)
    # backward search: reads of the genome (some with a changed base or an
    # N, some shorter than the batch's width), right-aligned
    text = fm.idx.get_seq(0, fm.idx.bns.l_pac)
    reads = []
    for i in range(300):
        st = int(rng.integers(0, len(text) - 64))
        r = text[st: st + int(rng.integers(1, 65))].copy()
        if i % 3 == 0:
            r[int(rng.integers(0, len(r)))] = int(rng.integers(0, 5))
        reads.append(r)
    qseq, qlen = fmops.right_align_reads(reads, "cuda")
    got = fmops.backward_search(dfm, qseq, qlen)
    for g, p_ in zip(got, fmops.backward_search_torch(dfm, qseq, qlen)):
        assert torch.equal(g, p_)
    assert {k: fmops.LAUNCHES[k] - before[k] for k in before} == {
        "occ4": 1, "bwt_extend": 4, "sa_lookup": 1, "backward_search": 1}


@pytest.mark.cuda
@needs_card
def test_cuda_fm_kernels_raise_on_bad_rows(host_fm):
    import dataclasses

    fm = host_fm
    dfm = fmops.DeviceFMIndex.from_host(fm, "cuda")
    with pytest.raises(ValueError):
        fmops.occ4_cuda(dfm, torch.tensor([0, fm.seq_len + 1], device="cuda"))
    with pytest.raises(ValueError):
        fmops.sa_lookup_cuda(dfm, torch.tensor([-1], device="cuda"))
    # an all-A BWT with L2[0] = -1 and no sentinel row maps k to k: the
    # walk never reaches a sample and stops after seq_len steps
    L2 = dfm.L2.clone()
    L2[0] = -1
    broken = dataclasses.replace(dfm, lines=torch.zeros_like(dfm.lines), L2=L2,
                                 primary=fm.seq_len + 1)
    with pytest.raises(RuntimeError):
        fmops.sa_lookup_cuda(broken, torch.tensor([5], device="cuda"))


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("name", [p.name for p in op_probe.PROBES])
def test_cuda_op_probe_matches_plain(name):
    p = next(q for q in op_probe.PROBES if q.name == name)
    x = torch.from_numpy(np.random.default_rng(5).integers(
        -5000, 5000, p.shape)).to(p.dtype).cuda()
    before = op_probe.LAUNCHES
    got = op_probe.run_probe(p, x, 64)
    assert op_probe.LAUNCHES == before + 1
    assert torch.equal(got, op_probe.probe_torch(p, x, 64))


@pytest.fixture(scope="module")
def seed_data():
    """The seeding cases' genome (sa_intv 8) and reads; the last read
    overflows the K-slot budget."""
    from bwamem_tpu_torch.engine.fmindex import FMIndex
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

    rng = np.random.default_rng(404)
    contigs, kread = seed_cases.genome(rng)
    fasta = Fasta([FastaContig(f"c{i}", "", c) for i, c in enumerate(contigs)])
    fm = FMIndex(build_index(fasta, sa_intv=8))
    return fm, seed_cases.reads(contigs, kread, rng)


def _seed_lanes(reads, seed):
    lanes = seed_cases.lanes(reads, seed)
    qseq, qlen = so.pad_reads([reads[i] for i, _, _ in lanes], "cuda")
    x = torch.tensor([x for _, x, _ in lanes], dtype=torch.int32, device="cuda")
    mi = torch.tensor([m for _, _, m in lanes], dtype=torch.int64, device="cuda")
    return lanes, qseq, qlen, x, mi


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("K", (so.K_SLOTS, so.K_MAX), ids=("k24", "kmax"))
def test_cuda_smem1a_and_strategy1_match_plain_and_oracle(seed_data, K):
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.seed import seed_strategy1, smem1a

    fm, reads = seed_data
    opt = MemOptions()
    dfm = fmops.DeviceFMIndex.from_host(fm, "cuda")
    lanes, qseq, qlen, x, mi = _seed_lanes(reads, 1)
    before = dict(so.LAUNCHES)
    got = so.smem1a(dfm, qseq, qlen, x, mi, K)
    for g, p in zip(got, so.smem1a_torch(dfm, qseq, qlen, x, mi, K)):
        assert torch.equal(g, p)
    assert bool(got.ovf.any()) == (K == so.K_SLOTS)  # the K-overflow read
    hit = so.strategy1(dfm, qseq, qlen, x, opt.min_seed_len, opt.max_mem_intv)
    for g, p in zip(hit, so.strategy1_torch(dfm, qseq, qlen, x, opt.min_seed_len,
                                            opt.max_mem_intv)):
        assert torch.equal(g, p)
    assert {k: so.LAUNCHES[k] - before[k] for k in ("smem1a", "strategy1")} == {
        "smem1a": 1, "strategy1": 1}
    got = [t.cpu().numpy() for t in got]
    hit = [t.cpu().numpy() for t in hit]
    for b, (i, xs, m) in enumerate(lanes):
        if xs >= len(reads[i]) or reads[i][xs] > 3:
            assert got[0][b] == xs + 1 and got[6][b] == 0 and not hit[0][b]
            continue
        ret, mems = smem1a(fm, reads[i], xs, m)
        assert got[0][b] == ret
        if not got[7][b]:
            mine = [tuple(int(v[b, j]) for v in got[1:6]) for j in range(got[6][b])]
            assert mine[::-1] == [tuple(p) for p in mems], b
        nxt, h = seed_strategy1(fm, reads[i], xs, opt.min_seed_len,
                                opt.max_mem_intv)
        assert hit[6][b] == nxt and bool(hit[0][b]) == (h is not None)
        if h is not None:
            assert tuple(int(v[b]) for v in hit[1:6]) == tuple(h)


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("M,K", ((so.M_SLOTS, so.K_SLOTS), (4, so.K_SLOTS),
                                 (so.M_SLOTS, so.K_MAX)),
                         ids=("m48k24", "m4k24", "m48kmax"))
def test_cuda_seed_sa_matches_plain_and_oracle(seed_data, M, K):
    """collect_intv + sample_ks + the SA walk on the card against the plain
    chain on the card and the host oracle, per read; M = 4 forces
    M-overflows, K = 24 the K-overflow read's."""
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.chain import sample_ks
    from bwamem_tpu_torch.engine.seed import collect_intv

    fm, reads = seed_data
    opt = MemOptions()
    params = so.SeedParams.from_opt(opt)
    dfm = fmops.DeviceFMIndex.from_host(fm, "cuda")
    qseq, qlen = so.pad_reads(reads, "cuda")
    before = dict(so.LAUNCHES)
    got = so.seed_sa(dfm, qseq, qlen, params, M, K=K)
    assert {k: so.LAUNCHES[k] - before[k]
            for k in ("collect_intv", "sample_ks")} == {
        "collect_intv": 1, "sample_ks": 1}
    plain = so.seed_sa_torch(dfm, qseq, qlen, params, M, K=K)
    ovf = got.intervals.ovf
    assert torch.equal(ovf, plain.intervals.ovf)
    ok = ~ovf
    assert torch.equal(got.intervals.n[ok], plain.intervals.n[ok])
    assert torch.equal(got.intervals.rows[ok], plain.intervals.rows[ok])
    assert torch.equal(got.intervals.nks, plain.intervals.nks)
    for g, p in zip(got[1:], plain[1:]):
        assert torch.equal(g, p)
    rbegs = fmops.sa_lookup(dfm, got.ks)  # as the pipeline walks them
    assert torch.equal(rbegs, fmops.sa_lookup_torch(dfm, plain.ks))
    n = got.intervals.n.cpu().numpy()
    ovf = ovf.cpu().numpy()
    flat, rbegs = got.flat.cpu().numpy(), rbegs.cpu().numpy()
    expect_ovf = [len(collect_intv(opt, fm, r)) > M for r in reads]
    expect_ovf[-1] = expect_ovf[-1] or K == so.K_SLOTS
    assert ovf.tolist() == expect_ovf
    row, k = 0, 0
    for r, read in enumerate(reads):
        if ovf[r]:
            continue
        exp = collect_intv(opt, fm, read)
        assert [tuple(v) for v in flat[row: row + n[r]].tolist()] == [
            tuple(p) for p in exp], r
        row += n[r]
        for p in exp:
            ks = np.asarray(sample_ks(p, opt.max_occ), np.int64)
            assert np.array_equal(rbegs[k: k + len(ks)], fm.sa_lookup(ks)), r
            k += len(ks)
    assert (row, k) == (len(flat), len(rbegs))


@pytest.fixture(scope="module")
def chain_data():
    """The chain cases' genome (three contigs, the last ALT) as the port's
    engine, reads, and their seeds by the host oracle."""
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.chain import sample_ks
    from bwamem_tpu_torch.engine.pipeline import Engine
    from bwamem_tpu_torch.engine.seed import collect_intv
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

    contigs = chain_cases.genome(np.random.default_rng(7))
    idx = build_index(Fasta([FastaContig(f"c{i}", "", c)
                             for i, c in enumerate(contigs)]))
    idx.bns.anns[2].is_alt = 1
    eng = Engine(idx)
    opt = MemOptions()
    reads = chain_cases.reads(contigs, np.random.default_rng(11), 150)
    reads += [np.ones(5, np.uint8), np.zeros(19, np.uint8)]
    ivs = [collect_intv(opt, eng.fm, q) for q in reads]
    rbs = [[eng.fm.sa_lookup(np.asarray(sample_ks(p, opt.max_occ), np.int64))
            for p in iv] for iv in ivs]
    return eng, opt, reads, ivs, rbs


def _chain_key(c):
    return (c.rid, c.w, c.kept, c.first, c.frac_rep, c.is_alt,
            tuple((s.rbeg, s.qbeg, s.len, s.score) for s in c.seeds))


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("C", (co.C_MAX, 3), ids=("c128", "c3"))
def test_cuda_chain_matches_plain_and_oracle(chain_data, C):
    """The chain kernels against the plain version on the card, field for
    field (C = 3 flags the multi-chain reads), and the rebuilt chains
    against the host oracle."""
    from bwamem_tpu_torch.engine.chain import chain_flt, mem_chain
    from bwamem_tpu_torch.engine.state import device_contigs

    eng, opt, reads, ivs, rbs = chain_data
    ctg = device_contigs(eng.idx.bns, "cuda")
    tab = co.SeedTable.from_numpy(
        "cuda", *chain_cases.seed_table(ivs, rbs, [len(r) for r in reads]))
    params = co.ChainParams.from_opt(opt)
    before = dict(co.LAUNCHES)
    got = co.chain(ctg, tab, params, C)
    assert {k: co.LAUNCHES[k] - before[k] for k in before} == {
        "chain": 1, "chain_emit": 1}
    for g, p in zip(got, co.chain_torch(ctg, tab, params, C)):
        assert torch.equal(g, p)
    assert bool(got.ovf.any()) == (C == 3)
    lists, (ovf, _, _) = co.chains_device_batch(ctg, tab, params, C)
    for i, (q, iv, rb) in enumerate(zip(reads, ivs, rbs)):
        if ovf[i]:
            assert lists[i] is None
            continue
        exp = chain_flt(opt, mem_chain(opt, eng.fm, eng.idx.bns, len(q), iv, rb))
        assert [_chain_key(c) for c in lists[i]] == [_chain_key(c) for c in exp], i


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("ratio", (0.5, 0.3), ids=("half", "three_tenths"))
def test_cuda_chain_float_boundaries_follow_the_oracle(ratio):
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.chain import chain_flt, mem_chain
    from bwamem_tpu_torch.engine.seed import SmemIntv
    from bwamem_tpu_torch.index.build import BntAnn, Bntseq

    opt = MemOptions(mask_level=ratio, drop_ratio=ratio)
    ivs, rbs, qlens, l_pac = chain_cases.boundary_table(ratio, ratio)
    bns = Bntseq(l_pac=l_pac, anns=[BntAnn(offset=0, name="c", length=l_pac)])
    lists, (ovf, _, _) = co.chains_device_batch(
        co.DeviceContigs.from_host(bns, "cuda"),
        co.SeedTable.from_numpy("cuda", *chain_cases.seed_table(ivs, rbs, qlens)),
        co.ChainParams.from_opt(opt))
    assert not ovf.any()
    for i, (n, iv, rb) in enumerate(zip(qlens, ivs, rbs)):
        exp = chain_flt(opt, mem_chain(opt, None, bns, n,
                                       [SmemIntv(*p) for p in iv], rb))
        assert [_chain_key(c) for c in lists[i]] == [_chain_key(c) for c in exp], i


@pytest.mark.cuda
@needs_card
def test_cuda_chain_raises_on_seeds_outside_rbegs(chain_data):
    from bwamem_tpu_torch.engine.state import device_contigs

    eng, opt, reads, ivs, rbs = chain_data
    tab = co.SeedTable.from_numpy(
        "cuda", *chain_cases.seed_table(ivs, rbs, [len(r) for r in reads]))
    with pytest.raises(ValueError):
        co.chain_cuda(device_contigs(eng.idx.bns, "cuda"),
                      tab._replace(rbeg_off=tab.rbeg_off + 1),
                      co.ChainParams.from_opt(opt))


ALL = ("seed", "sa_lookup", "chain")


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize(
    "stages", [(), ("sa_lookup",), ("seed",), ("seed", "sa_lookup"), ("chain",),
               ("seed", "chain"), ALL],
    ids=("host_sa", "card_sa", "card_seed", "card_seed_sa", "card_chain",
         "card_seed_chain", "card_all"))
def test_cuda_aligner_matches_host(tmp_path, stages):
    from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex
    from bwamem_tpu_torch.engine.extend_batch import STATS
    from bwamem_tpu_torch.engine.pipeline import CHAIN_STATS, SA_STATS
    from bwamem_tpu_torch.engine.seed_device import SEED_STATS
    from bwamem_tpu_torch.index import image
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig
    from bwamem_tpu_torch.utils.synth import simulate_pairs, synthetic_genome

    codes = synthetic_genome(200_000, np.random.default_rng(7))
    img = str(tmp_path / "g.img")
    image.write_image(img, build_index(Fasta([FastaContig("chr", "", codes)])))
    index = BwaMemIndex(img)
    reads = simulate_pairs(codes, np.random.default_rng(9), 200)
    # the oracle: every stage in the port's host C++
    host = BwaMemAligner(index, device="cpu", min_device_jobs=1 << 30)
    port = BwaMemAligner(index, device="cuda", min_device_jobs=1,
                         device_stages=stages)
    for a in (host, port):
        a.align_pairs()
    STATS.reset()
    SA_STATS.reset()
    SEED_STATS.reset()
    CHAIN_STATS.reset()
    before = ext.LAUNCHES
    sa_before = fmops.LAUNCHES["sa_lookup"]
    seed_before = so.LAUNCHES["collect_intv"]
    chain_before = dict(co.LAUNCHES)
    got = port.align_seqs(reads)
    assert ext.LAUNCHES - before == STATS.device_extend_waves > 0
    if "sa_lookup" in stages:
        assert fmops.LAUNCHES["sa_lookup"] > sa_before
        assert SA_STATS.device_sa_rows > 0 and SA_STATS.host_sa_rows == 0
    else:
        assert SA_STATS.device_sa_rows == 0
    if "seed" in stages:
        assert so.LAUNCHES["collect_intv"] > seed_before
        assert SEED_STATS.device_reads + SEED_STATS.host_reads == len(reads)
        assert SEED_STATS.device_reads >= 0.95 * len(reads)
    else:
        assert so.LAUNCHES["collect_intv"] == seed_before
        assert SEED_STATS.device_reads == SEED_STATS.host_reads == 0
    if "chain" in stages:
        assert all(co.LAUNCHES[k] > chain_before[k] for k in chain_before)
        assert CHAIN_STATS.device_reads + CHAIN_STATS.host_reads == len(reads)
        assert CHAIN_STATS.device_reads >= 0.95 * len(reads)
    else:
        assert co.LAUNCHES == chain_before
        assert CHAIN_STATS.device_reads == CHAIN_STATS.host_reads == 0
    ref = host.align_seqs(reads)
    assert got == ref
    index.close()


@pytest.fixture(scope="module")
def fused_engine():
    """The chain cases' genome (three contigs, the last ALT) as the port's
    engine."""
    from bwamem_tpu_torch.engine.pipeline import Engine
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

    contigs = chain_cases.genome(np.random.default_rng(7))
    idx = build_index(Fasta([FastaContig(f"c{i}", "", c)
                             for i, c in enumerate(contigs)]))
    idx.bns.anns[2].is_alt = 1
    return Engine(idx), contigs


def _fused_operands(eng, opt, reads):
    """The reads' chains on the card (seeds by the host oracle, chained by
    the chain kernels), the same chains as ``Chain`` lists, and the other
    operands of ``chain2aln``."""
    from bwamem_tpu_torch.engine.chain import sample_ks
    from bwamem_tpu_torch.engine.seed import collect_intv
    from bwamem_tpu_torch.engine.state import (device_contigs, device_ref,
                                               device_scoring)

    ivs = [collect_intv(opt, eng.fm, q) for q in reads]
    rbs = [[eng.fm.sa_lookup(np.asarray(sample_ks(p, opt.max_occ), np.int64))
            for p in iv] for iv in ivs]
    tab = co.SeedTable.from_numpy(
        "cuda", *chain_cases.seed_table(ivs, rbs, [len(r) for r in reads]))
    ctg = device_contigs(eng.idx.bns, "cuda")
    params = co.ChainParams.from_opt(opt)
    lists, _ = co.chains_device_batch(ctg, tab, params)
    qseq, qlen = so.pad_reads(reads, "cuda")
    run = torch.ones(len(reads), dtype=torch.bool, device="cuda")
    return lists, (ctg, device_ref(eng.idx, "cuda"), co.chain(ctg, tab, params),
                   qseq, qlen, run, fo.ExtendParams.from_opt(opt),
                   device_scoring(opt, "cuda").mat)


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("case", fused_cases.CASES)
def test_cuda_chain2aln_matches_plain_and_oracle(fused_engine, case):
    """The chain-to-region kernels against the plain version on the card,
    field for field, and against the host oracle ``chain2aln`` on the same
    chains; a window budget of 300 bases sets the same ``ref_t`` marks."""
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.extend import chain2aln

    eng, contigs = fused_engine
    kw, make = fused_cases.CASES[case]
    opt = fused_cases.options(MemOptions(), kw)
    reads = make(contigs)
    lists, args = _fused_operands(eng, opt, reads)
    before = dict(fo.LAUNCHES)
    got = fo.chain2aln(*args, 300)
    assert {k: fo.LAUNCHES[k] - before[k] for k in before} == {
        "chain2aln_prep": 1, "chain2aln": 1}
    plain = fo.chain2aln_torch(*args, 300)
    for name in ("reg_c", "reg_i", "nregs", "seed_off"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    assert torch.equal(got.work[:, :4], plain.work[:, :4])
    assert int(got.work[:, fo.W_CELLS].sum()) > 0
    rows = got.compact().cpu().numpy()
    frac = rows[:, 2].copy().view(np.float64)
    k = 0
    for q, chains, n in zip(reads, lists, got.nregs.tolist()):
        regs = []
        for c in chains:
            chain2aln(opt, eng.idx, len(q), q, c, regs)
        mine = [(int(r[0]), int(r[1]), int(r[3]), int(r[4]), int(r[5]),
                 int(r[6]), int(r[7]), int(r[8]), int(r[9]), int(r[10]), float(f))
                for r, f in zip(rows[k: k + n], frac[k: k + n])]
        assert mine == [(a.rb, a.re, a.qb, a.qe, a.score, a.truesc, a.w,
                         a.seedcov, a.seedlen0, a.rid, a.frac_rep) for a in regs]
        k += n
    assert k == len(rows)
    # leaving reads out, and running twice on the same scratch
    run = torch.arange(len(reads), device="cuda") % 2 == 0
    part = fo.chain2aln(*args[:5], run, *args[6:])
    assert part.nregs.tolist() == [n if i % 2 == 0 else 0
                                   for i, n in enumerate(got.nregs.tolist())]


@pytest.mark.cuda
@needs_card
def test_cuda_chain2aln_flags_impossible_states(fused_engine):
    """A window that does not hold its seeds, and fewer region rows than a
    read needs, set the kernel's flag bits; the wrapper's reader raises."""
    from bwamem_tpu_torch.api.options import MemOptions

    eng, contigs = fused_engine
    opt = MemOptions()
    reads = chain_cases.reads(contigs, np.random.default_rng(3), 20)
    _, (ctg, ref, chains, qseq, qlen, run, p, mat) = _fused_operands(
        eng, opt, reads)
    chains, lay, qseq, qlen, run = fo.prepare(ctg, ref, chains, qseq, qlen, run)
    i32, i64 = torch.int32, torch.int64
    B, L = qseq.shape
    Nc, Ns = chains.chain_rows.shape[0], chains.seed_rows.shape[0]

    def launch(rmax, n_seed):
        out = dict(
            eh=torch.empty((2, L + 1, B), dtype=i32, device="cuda"),
            reg_c=torch.zeros((Ns, 3), dtype=i64, device="cuda"),
            reg_i=torch.zeros((Ns, 8), dtype=i32, device="cuda"),
            nregs=torch.zeros(B, dtype=i32, device="cuda"),
            work=torch.zeros((B, 6), dtype=i64, device="cuda"),
            err=torch.zeros(1, dtype=i32, device="cuda"))
        fo.chain2aln_launch(
            ref, chains, lay, chains.n_chain, n_seed, lay.chain_off,
            lay.seed_off, rmax, srt, alive, run, qseq, qlen, mat.contiguous(), p,
            fo.NO_T_CAP, **out)
        return int(out["err"].item())

    rmax = torch.empty((Nc, 2), dtype=i64, device="cuda")
    srt = torch.empty(Ns, dtype=i32, device="cuda")
    alive = torch.empty(Ns, dtype=torch.uint8, device="cuda")
    err = torch.zeros(1, dtype=i32, device="cuda")
    fo.chain2aln_prep_launch(ctg, chains, lay, qlen, p, rmax, srt, err)
    assert int(err.item()) == 0 and launch(rmax, chains.n_seed) == 0
    assert launch(torch.zeros_like(rmax), chains.n_seed) == fo.ERR_WINDOW
    assert launch(rmax, torch.zeros_like(chains.n_seed)) == fo.ERR_ROWS
    for bit in (fo.ERR_WINDOW, fo.ERR_ROWS, fo.ERR_CONTIG):
        with pytest.raises(RuntimeError):
            fo.raise_flags(bit)
    with pytest.raises(ValueError):  # tensors on the CPU never reach the kernel
        fo.chain2aln_cuda(ctg, ref, chains, qseq.cpu(), qlen, run, p, mat)


@pytest.mark.cuda
@needs_card
def test_cuda_band_width_matches_band_width():
    """``ksw_band_width`` of csrc/extend.cuh, which the chain-to-region kernel
    computes per job, against ``ops.extend.band_width``."""
    rng = np.random.default_rng(3)
    for max_sc, o_del, e_del, o_ins, e_ins in ((1, 6, 1, 6, 1), (2, 9, 3, 4, 2),
                                               (1, 40, 7, 55, 5)):
        qlen, w, bonus = (torch.from_numpy(rng.integers(lo, hi, 4000)).int().cuda()
                          for lo, hi in ((0, 200), (1, 250), (0, 12)))
        args = (qlen, w, bonus, max_sc, o_del, e_del, o_ins, e_ins)
        assert torch.equal(fo.band_width_cuda(*args), ext.band_width(*args))


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("mode", ("pe", "se"))
def test_cuda_fused_aligner_matches_host(tmp_path, mode):
    """device_pipeline=True: records equal to the host oracle's, all four
    kernel stages launched, every read on the fused path and no extension
    wave."""
    from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex
    from bwamem_tpu_torch.engine.extend_batch import STATS
    from bwamem_tpu_torch.engine.pipeline_device import FUSED_STATS
    from bwamem_tpu_torch.index import image
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig
    from bwamem_tpu_torch.utils.synth import simulate_pairs, synthetic_genome

    codes = synthetic_genome(200_000, np.random.default_rng(7))
    img = str(tmp_path / "g.img")
    image.write_image(img, build_index(Fasta([FastaContig("chr", "", codes)])))
    index = BwaMemIndex(img)
    reads = simulate_pairs(codes, np.random.default_rng(9), 200)
    host = BwaMemAligner(index, device="cpu", min_device_jobs=1 << 30)
    port = BwaMemAligner(index, device="cuda", device_pipeline=True)
    if mode == "pe":
        for a in (host, port):
            a.align_pairs()
    STATS.reset()
    FUSED_STATS.reset()
    before = (dict(so.LAUNCHES), dict(co.LAUNCHES), dict(fo.LAUNCHES),
              fmops.LAUNCHES["sa_lookup"], ext.LAUNCHES)
    got = port.align_seqs(reads)
    for now, was in zip((so.LAUNCHES, co.LAUNCHES, fo.LAUNCHES), before):
        assert all(now[k] == was[k] + 1 for k in was
                   if k not in ("smem1a", "strategy1")), (now, was)
    assert fmops.LAUNCHES["sa_lookup"] == before[3] + 1
    assert FUSED_STATS.device_reads + FUSED_STATS.host_reads == len(reads)
    assert FUSED_STATS.device_reads >= 0.95 * len(reads)
    if FUSED_STATS.host_reads == 0:
        assert ext.LAUNCHES == before[4]
        assert STATS.device_extend_waves + STATS.host_extend_waves == 0
    assert got == host.align_seqs(reads)
    index.close()
