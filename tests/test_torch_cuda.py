"""The port on the card: the CUDA kernels (SW extension, occ4, bwt_extend,
SA walk, backward search, op probe, the seeding kernels smem1a, strategy1,
collect_intv and sample_ks, the chain kernels and the chain-to-region
kernels) against their plain PyTorch versions on the same CUDA tensors,
exactly, the FM, seeding, chain and chain-to-region kernels also against the
host oracles, and the aligner with device="cuda" (with and without the device
seed, SA and chain stages, and with the fused device path) against the
port's whole-batch host route, each card route's records through the host
C++ tail against the Python tail's on the same regions, and a card aligner
whose tail library fails raising.

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
        "occ4": 1, "bwt_extend": 4, "sa_lookup": 1, "backward_search": 1,
        "line_chase": 0, "occ4_sharded": 0, "sa_lookup_sharded": 0}


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


@pytest.fixture(scope="module", params=(5, 8, 32),
                ids=("intv5", "intv8", "intv32"))
def walk_fm(request):
    """A 20 kbp genome's index with sampled interval 5 (the SA kernel's
    division path; build_bwt takes any interval), 8 or 32."""
    import dataclasses

    from bwamem_tpu_torch.engine.fmindex import FMIndex
    from bwamem_tpu_torch.index.build import build_bwt, build_index
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

    rng = np.random.default_rng(45)
    codes = rng.integers(0, 4, 20000).astype(np.uint8)
    codes[5000:5300] = codes[100:400]
    idx = build_index(Fasta([FastaContig("c", "", codes)]), sa_intv=8)
    if request.param != 8:
        idx = dataclasses.replace(idx, bwt=build_bwt(codes, request.param))
    return FMIndex(idx)


def _walk_lengths(dfm, k):
    """Each row's walk length, by the plain walk's steps."""
    steps = torch.zeros_like(k)
    idx = torch.arange(k.numel(), device=k.device)
    while True:
        live = k % dfm.sa_intv != 0
        idx, k = idx[live], k[live]
        if not idx.numel():
            return steps
        steps[idx] += 1
        k = fmops._lf(dfm, k)


@pytest.mark.cuda
@needs_card
def test_cuda_sa_lookup_edges_at_any_interval(walk_fm):
    """The SA kernel (mask and shift at 8 and 32, division at 5) on row 0,
    the primary row, seq_len, sampled rows (no step), the longest walk of
    the index, an empty batch, and its two flags: against the plain
    version and the host FMIndex; a span past 512 is refused."""
    import dataclasses

    fm = walk_fm
    dfm = fmops.DeviceFMIndex.from_host(fm, "cuda")
    assert dfm.sa_shift == {5: -1, 8: 3, 32: 5}[fm.sa_intv]
    every = torch.arange(fm.seq_len + 1, device="cuda")
    steps = _walk_lengths(dfm, every)
    longest = int(torch.argmax(steps))
    sampled = np.arange(0, fm.seq_len + 1, fm.sa_intv)[1:60]
    rows = np.concatenate([[0, fm.primary, fm.seq_len, longest], sampled])
    rt = torch.from_numpy(rows).cuda()
    before = fmops.LAUNCHES["sa_lookup"]
    got = fmops.sa_lookup(dfm, rt)
    assert fmops.LAUNCHES["sa_lookup"] == before + 1
    assert torch.equal(got, fmops.sa_lookup_torch(dfm, rt))
    assert np.array_equal(got.cpu().numpy(), fm.sa_lookup(rows))
    # every row of the index, one launch
    assert torch.equal(fmops.sa_lookup(dfm, every),
                       fmops.sa_lookup_torch(dfm, every))
    empty = fmops.sa_lookup_cuda(dfm, torch.zeros(0, dtype=torch.int64,
                                                  device="cuda"))
    assert empty.shape == (0,) and fmops.LAUNCHES["sa_lookup"] == before + 2
    for bad in (-1, fm.seq_len + 1):
        with pytest.raises(ValueError):
            fmops.sa_lookup_cuda(dfm, torch.tensor([bad], device="cuda"))
    with pytest.raises(ValueError):  # the kernel takes spans up to 512
        fmops.sa_lookup_cuda(fmops.DeviceFMIndex.from_host(fm, "cuda", span=1024),
                             rt)
    # an all-A BWT with L2[0] = -1 maps row 6 to itself, never sampled
    L2 = dfm.L2.clone()
    L2[0] = -1
    broken = dataclasses.replace(dfm, lines=torch.zeros_like(dfm.lines), L2=L2,
                                 primary=fm.seq_len + 1)
    with pytest.raises(RuntimeError):
        fmops.sa_lookup_cuda(broken, torch.tensor([6], device="cuda"))


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("span", (128, 256, 512))
def test_cuda_line_chase_follows_its_hash(host_fm, span):
    """The line-chase kernel visits the lines a host model of its hash
    visits."""
    dfm = fmops.DeviceFMIndex.from_host(host_fm, "cuda", span=span)
    lines = dfm.lines.cpu().numpy().view(np.uint32)
    nb = lines.shape[0]
    li = 3 % nb
    for s in range(50):
        h = s
        for x in lines[li]:
            h ^= int(x)
        h = (h * 0x9E3779B1) & 0xFFFFFFFF
        li = (h * nb) >> 32
    out = torch.zeros(1, dtype=torch.int64, device="cuda")
    fmops.line_chase_launch(dfm, 3 % nb, 50, out)
    assert int(out.item()) == li


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
    overflows the K-slot budget.  Then reads of 161 to 1,500 bases."""
    from bwamem_tpu_torch.engine.fmindex import FMIndex
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

    rng = np.random.default_rng(404)
    contigs, kread = seed_cases.genome(rng)
    fasta = Fasta([FastaContig(f"c{i}", "", c) for i, c in enumerate(contigs)])
    fm = FMIndex(build_index(fasta, sa_intv=8))
    return fm, seed_cases.reads(contigs, kread, rng), seed_cases.long_reads(
        contigs, rng)


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

    fm, reads, _ = seed_data
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
    chain on the card and the host oracle, per read, reads of up to 1,500
    bases among them; M = 4 forces M-overflows (so do the long reads at
    M = 48), K = 24 the K-overflow read's.  The work table (calls, rank
    queries, cause, slots needed) equals the plain version's, column by
    column."""
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.chain import sample_ks
    from bwamem_tpu_torch.engine.seed import collect_intv

    fm, reads, long = seed_data
    reads = reads[:-1] + long + reads[-1:]  # the K-overflow read stays last
    opt = MemOptions()
    params = so.SeedParams.from_opt(opt)
    dfm = fmops.DeviceFMIndex.from_host(fm, "cuda")
    qseq, qlen = so.pad_reads(reads, "cuda")
    work = torch.zeros((len(reads), 5), dtype=torch.int32, device="cuda")
    before = dict(so.LAUNCHES)
    got = so.seed_sa(dfm, qseq, qlen, params, M, K=K, work=work)
    assert {k: so.LAUNCHES[k] - before[k]
            for k in ("collect_intv", "sample_ks")} == {
        "collect_intv": 1, "sample_ks": 1}
    plain_work = torch.zeros_like(work)
    plain = so.seed_sa_torch(dfm, qseq, qlen, params, M, K=K, work=plain_work)
    assert torch.equal(work, plain_work)
    cause = work[:, 3].cpu().numpy()
    assert ((cause != 0) == got.intervals.ovf.cpu().numpy()).all()
    assert (cause == 2).any() and (cause[-1] == 1) == (K == so.K_SLOTS)
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
    # flagged: more intervals than M, or a call that needs more than K slots
    peak = work[:, 4].cpu().numpy()
    expect_ovf = [len(collect_intv(opt, fm, r)) > M or peak[i] > K
                  for i, r in enumerate(reads)]
    assert expect_ovf[-1] == (K == so.K_SLOTS)
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
                         device_stages=stages, device_pipeline=False)
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
def fused_engines():
    """The chain-to-region cases' genomes as the port's engines, each built
    on first use from seed 7: chain_cases' three contigs (the last ALT) and
    fused_cases' repeat genome."""
    from bwamem_tpu_torch.engine.pipeline import Engine
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

    made = {}

    def get(make):
        if make not in made:
            contigs = make(np.random.default_rng(7))
            idx = build_index(Fasta([FastaContig(f"c{i}", "", c)
                                     for i, c in enumerate(contigs)]))
            if make is chain_cases.genome:
                idx.bns.anns[2].is_alt = 1
            made[make] = (Engine(idx), contigs)
        return made[make]

    return get


@pytest.fixture(scope="module")
def fused_engine(fused_engines):
    """The chain cases' genome (three contigs, the last ALT) as the port's
    engine."""
    return fused_engines(chain_cases.genome)


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
@pytest.mark.parametrize("case", fused_cases.CARD_CASES)
def test_cuda_chain2aln_matches_plain_and_oracle(fused_engines, case):
    """The chain-to-region kernels against the plain version on the card,
    field for field, and against the host oracle ``chain2aln`` on the same
    chains; a window budget of 300 bases sets the same ``ref_t`` marks.
    The cases include reads of 161 to 1,500 bases at a band of 1,000 (rows
    of up to ten passes of a warp) and reads of 100 tasks each."""
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.extend import chain2aln

    kw, make, genome = fused_cases.CARD_CASES[case]
    eng, contigs = fused_engines(genome)
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
    assert torch.equal(got.work, plain.work)
    assert int(got.work[:, fo.W_CELLS].sum()) > 0
    if case == "repeat_copies":
        assert int(got.work[:, fo.W_TASKS].min()) >= 90
    if case == "wide_band":
        assert max(len(r) for r in reads) == 1500
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
    B = qseq.shape[0]
    Nc, Ns = chains.chain_rows.shape[0], chains.seed_rows.shape[0]

    def launch(rmax, n_seed):
        out = dict(
            order=fo.work_items(n_seed, qlen, run, lay.chain_read,
                                torch.zeros_like(run, dtype=torch.bool)),
            Q=fo.kernel_query_len(qlen, run, mat),
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
def test_cuda_chain2aln_read_order_does_not_change_results(fused_engine):
    """The loop kernel's warps take reads heaviest first; the same reads
    taken in the reverse order, and the batch itself reversed, give the
    same rows for every read."""
    from bwamem_tpu_torch.api.options import MemOptions

    eng, contigs = fused_engine
    opt = MemOptions()
    reads = chain_cases.reads(contigs, np.random.default_rng(21), 80)
    args = _fused_operands(eng, opt, reads)[1]
    got = fo.chain2aln(*args)
    ctg, ref, chains, qseq, qlen, run, p, mat = args
    chains_p, lay, q8, ql, run8 = fo.prepare(ctg, ref, chains, qseq, qlen, run)
    B, Nc, Ns = q8.shape[0], chains_p.chain_rows.shape[0], chains_p.seed_rows.shape[0]
    i32, i64 = torch.int32, torch.int64
    rmax = torch.empty((Nc, 2), dtype=i64, device="cuda")
    srt = torch.empty(Ns, dtype=i32, device="cuda")
    alive = torch.empty(Ns, dtype=torch.uint8, device="cuda")
    err = torch.zeros(1, dtype=i32, device="cuda")
    out = dict(reg_c=torch.zeros((Ns, 3), dtype=i64, device="cuda"),
               reg_i=torch.zeros((Ns, 8), dtype=i32, device="cuda"),
               nregs=torch.zeros(B, dtype=i32, device="cuda"),
               work=torch.zeros((B, 6), dtype=i64, device="cuda"), err=err)
    fo.chain2aln_prep_launch(ctg, chains_p, lay, ql, p, rmax, srt, err)
    fo.chain2aln_launch(ref, chains_p, lay, chains_p.n_chain, chains_p.n_seed,
                        lay.chain_off, lay.seed_off, rmax, srt, alive, run8, q8,
                        ql, mat.to(i32).contiguous(), p, fo.NO_T_CAP,
                        fo.work_items(chains_p.n_seed, ql, run8, lay.chain_read,
                                      torch.zeros_like(run8, dtype=torch.bool)
                                      ).flip(0),
                        fo.kernel_query_len(ql, run8, mat), **out)
    assert int(err.item()) == 0
    for name in ("reg_c", "reg_i", "nregs", "work"):
        assert torch.equal(out[name], getattr(got, name)), name
    back = fo.chain2aln(*_fused_operands(eng, opt, reads[::-1])[1])
    per_read = [r for r in _regions_per_read(got)]
    assert _regions_per_read(back) == per_read[::-1]
    assert torch.equal(back.work, got.work.flip(0))


def _split_modes(chains, qlen, run):
    """The split sets the card tests hold the kernel to: derived as the
    wrapper derives it, every read of two chains or more, and none."""
    return {"derived": None, "every": chains.n_chain >= 2,
            "none": torch.zeros_like(run, dtype=torch.bool)}


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("case", fused_cases.CARD_CASES)
def test_cuda_chain2aln_split_matches_plain(fused_engines, case):
    """Heavy reads' chains on many warps: with the split set derived, with
    every read of two chains or more split, and with none, the kernel's
    rows and ``work`` equal the plain version's field by field, one loop
    kernel a call, and its counts (the reads and chains split, the chains
    the commit decided otherwise and their own runs' discarded cells) equal
    those of the plain version's split route on the same set."""
    from bwamem_tpu_torch.api.options import MemOptions

    kw, make, genome = fused_cases.CARD_CASES[case]
    eng, contigs = fused_engines(genome)
    opt = fused_cases.options(MemOptions(), kw)
    reads = make(contigs)
    _, args = _fused_operands(eng, opt, reads)
    plain = fo.chain2aln_torch(*args, 300)
    chains, qlen, run = args[2], args[4], args[5]
    for mode, split in _split_modes(chains, qlen, run).items():
        before = dict(fo.LAUNCHES)
        got = fo.chain2aln(*args, 300, split)
        assert {k: fo.LAUNCHES[k] - before[k] for k in before} == {
            "chain2aln_prep": 1, "chain2aln": 1}, mode
        for name in ("reg_c", "reg_i", "nregs", "seed_off", "work"):
            assert torch.equal(getattr(got, name), getattr(plain, name)), (
                mode, name)
        if split is None:
            continue
        mirror = fo.chain2aln_torch(*args, 300, split)
        assert got.split.tolist() == mirror.split.tolist(), mode
        assert int(got.split[1]) == int(split.sum()), mode


@pytest.mark.cuda
@needs_card
def test_cuda_chain2aln_split_built_chains(fused_engine):
    """Hand-made chains (``fused_cases.split_reads_cases``), every read
    split: later chains whose seeds an earlier chain's region holds are
    decided otherwise at the commit; the rows and work equal the plain
    version's, the regions the host oracle's, and the counts those of the
    plain split route."""
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.chain import Chain, Seed
    from bwamem_tpu_torch.engine.extend import chain2aln
    from bwamem_tpu_torch.engine.state import (device_contigs, device_ref,
                                               device_scoring)

    eng, contigs = fused_engine
    opt = MemOptions()
    names, reads, cl = fused_cases.split_reads_cases(contigs,
                                                     eng.idx.bns.l_pac)
    qseq, qlen = so.pad_reads(reads, "cuda")
    run = torch.ones(len(reads), dtype=torch.bool, device="cuda")
    args = (device_contigs(eng.idx.bns, "cuda"), device_ref(eng.idx, "cuda"),
            fused_cases.chains_table(cl, "cuda"), qseq, qlen, run,
            fo.ExtendParams.from_opt(opt), device_scoring(opt, "cuda").mat)
    plain = fo.chain2aln_torch(*args)
    got = fo.chain2aln(*args, split=run)
    for name in ("reg_c", "reg_i", "nregs", "seed_off", "work"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    mirror = fo.chain2aln_torch(*args, split=run)
    assert got.split.tolist() == mirror.split.tolist()
    assert int(got.split[3]) >= 3
    want = []
    for q, chains in zip(reads, cl):
        regs = []
        for c in chains:
            chain2aln(opt, eng.idx, len(q), q,
                      Chain(rid=0, seeds=[Seed(*map(int, s)) for s in c]), regs)
        want.append([[a.rb, a.re, 0, a.qb, a.qe, a.score, a.truesc, a.w,
                      a.seedcov, a.seedlen0, a.rid] for a in regs])
    mine = _regions_per_read(got)
    assert [[r[:2] + r[3:] for r in rr] for rr in mine] == [
        [r[:2] + r[3:] for r in rr] for rr in want]


@pytest.mark.cuda
@needs_card
def test_cuda_chain2aln_split_order_and_flags(fused_engine):
    """With every read of two chains or more split, the work items taken in
    the reverse order give the same rows, and the flag bits fire as without
    a split: a window that does not hold its seeds, fewer region rows than a
    read needs."""
    from bwamem_tpu_torch.api.options import MemOptions

    eng, contigs = fused_engine
    opt = MemOptions()
    reads = chain_cases.reads(contigs, np.random.default_rng(21), 80)
    args = _fused_operands(eng, opt, reads)[1]
    got = fo.chain2aln(*args)
    ctg, ref, chains, qseq, qlen, run, p, mat = args
    chains_p, lay, q8, ql, run8 = fo.prepare(ctg, ref, chains, qseq, qlen, run)
    B, Nc, Ns = q8.shape[0], chains_p.chain_rows.shape[0], chains_p.seed_rows.shape[0]
    i32, i64 = torch.int32, torch.int64
    split = chains_p.n_chain >= 2
    assert int(split.sum()) > 0
    items = fo.work_items(chains_p.n_seed, ql, run8, lay.chain_read, split)
    k = int((items >= 0).sum())
    rmax = torch.empty((Nc, 2), dtype=i64, device="cuda")
    srt = torch.empty(Ns, dtype=i32, device="cuda")
    alive = torch.empty(Ns, dtype=torch.uint8, device="cuda")
    err = torch.zeros(1, dtype=i32, device="cuda")
    fo.chain2aln_prep_launch(ctg, chains_p, lay, ql, p, rmax, srt, err)

    def launch(order, rmax, n_seed):
        out = dict(reg_c=torch.zeros((Ns, 3), dtype=i64, device="cuda"),
                   reg_i=torch.zeros((Ns, 8), dtype=i32, device="cuda"),
                   nregs=torch.zeros(B, dtype=i32, device="cuda"),
                   work=torch.zeros((B, 6), dtype=i64, device="cuda"),
                   err=torch.zeros(1, dtype=i32, device="cuda"))
        fo.chain2aln_launch(ref, chains_p, lay, chains_p.n_chain, n_seed,
                            lay.chain_off, lay.seed_off, rmax, srt, alive,
                            run8, q8, ql, mat.to(i32).contiguous(), p,
                            fo.NO_T_CAP, order, fo.kernel_query_len(ql, run8, mat),
                            **out)
        return out

    for order in (items, torch.cat([items[:k].flip(0), items[k:]])):
        out = launch(order, rmax, chains_p.n_seed)
        assert int(out["err"].item()) == 0
        for name in ("reg_c", "reg_i", "nregs", "work"):
            assert torch.equal(out[name], getattr(got, name)), name
    assert int(launch(items, torch.zeros_like(rmax), chains_p.n_seed)[
        "err"].item()) == fo.ERR_WINDOW
    assert int(launch(items, rmax, torch.zeros_like(chains_p.n_seed))[
        "err"].item()) == fo.ERR_ROWS


@pytest.mark.cuda
@needs_card
def test_cuda_loop_kernel_limit_routes_long_reads(fused_engine):
    """The loop kernel's read-length limit on this card is where its warps'
    shared memory stops fitting a block: the kernel configures at the limit
    and refuses one base more.  A batch with a read past it (kept from the
    ``fcs`` rule by a large min_chain_weight) does not raise: that read
    takes the staged path, counted under its first cause (its many SMEMs
    may already flag it for host seeding), and every read's regions equal
    the host oracle's."""
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.chain import (chain_flt, flt_chained_seeds,
                                               mem_chain)
    from bwamem_tpu_torch.engine.exec_ctx import ExecConfig
    from bwamem_tpu_torch.engine.extend import chain2aln
    from bwamem_tpu_torch.engine.pipeline_device import (FUSED_STATS, fcs_noop,
                                                         regs_batch_fused)
    from bwamem_tpu_torch.engine.seed import collect_intv
    from bwamem_tpu_torch.engine.state import device_scoring

    opt = MemOptions()
    limit = fo.kernel_max_qlen(device_scoring(opt, "cuda").mat, "cuda")
    assert 1500 <= limit < fo.MAX_QLEN
    assert fo.warps_per_sm(limit) > 0
    assert fo.warps_per_sm(limit + 1) == -1
    eng, contigs = fused_engine
    opt.min_chain_weight = 300
    long_read = contigs[0][2_000: 2_000 + limit + 50].copy()
    long_read[::90] = (long_read[::90] + 1) % 4
    reads = chain_cases.reads(contigs, np.random.default_rng(23), 8)
    reads = reads[:4] + [long_read] + reads[4:]
    assert all(fcs_noop(opt, len(r)) for r in reads)
    FUSED_STATS.reset()
    got = regs_batch_fused(opt, eng, reads,
                           ExecConfig(device="cuda", device_pipeline=True))
    st = FUSED_STATS
    assert st.host_reads == st.host_seeded + st.long_reads == 1, vars(st)
    for g, q in zip(got, reads):
        chains = chain_flt(opt, mem_chain(opt, eng.fm, eng.idx.bns, len(q),
                                          collect_intv(opt, eng.fm, q), None))
        flt_chained_seeds(opt, eng.idx, len(q), q, chains)
        want = []
        for c in chains:
            chain2aln(opt, eng.idx, len(q), q, c, want)
        assert g == want


def _regions_per_read(regs):
    rows = regs.compact().cpu().numpy().tolist()
    out, k = [], 0
    for n in regs.nregs.tolist():
        out.append(rows[k: k + n])
        k += n
    return out


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("name", CASES)
def test_cuda_ksw_kernel_matches_host_ksw(name):
    """P1, the wave kernel (a job on a lane group, csrc/extend.cuh
    `ksw_extend_group`): every result of every job of each case equal to the
    host C++ ksw_extend2 (max error 0)."""
    from bwamem_tpu_torch.engine import native_ksw

    case = make_case(name)
    got = ext.ksw_extend(*[torch.from_numpy(case[k]).cuda() for k in ARRAYS],
                         **case["statics"])
    js, h0s, ws, bons = jobs(case)
    st = case["statics"]
    host = native_ksw.extend_batch(js, case["mat"].ravel().tolist(), st["o_del"],
                                   st["e_del"], st["o_ins"], st["e_ins"],
                                   st["zdrop"], h0s, ws, bons)
    for k in ext.KEYS:
        assert got[k].cpu().tolist() == [h[k] for h in host], k


def _ksw_wave(rng, qlens, tlens, h0s):
    """Jobs whose targets share most of their query (so the band holds
    real scores) at the given lengths and h0, as (qseq, tseq) arrays."""
    out = []
    for ql, tl in zip(qlens, tlens):
        q = rng.integers(0, 5 if rng.random() < 0.2 else 4, ql).astype(np.uint8)
        t = np.resize(q, tl).copy()
        for p in rng.integers(0, max(tl, 1), tl // 12):
            t[p] = (t[p] + 1) % 4
        if tl > 40 and rng.random() < 0.3:
            t = np.insert(t, tl // 2, rng.integers(0, 4, 3).astype(np.uint8))[:tl]
        out.append((q, t))
    return out


def _ksw_wave_tensors(js, h0s, w, bonus):
    B = len(js)
    Q = max([len(q) for q, _ in js] + [1])
    T = max([len(t) for _, t in js] + [1])
    qa, ta = np.zeros((B, Q), np.uint8), np.zeros((B, T), np.uint8)
    for b, (q, t) in enumerate(js):
        qa[b, :len(q)], ta[b, :len(t)] = q, t
    per = [[len(q) for q, _ in js], [len(t) for _, t in js], h0s, [w] * B,
           [bonus] * B]
    return [torch.from_numpy(qa).cuda(), torch.from_numpy(ta).cuda()] + [
        torch.tensor(v, dtype=torch.int32).cuda() for v in per]


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("shape", ("ragged", "one", "empty"))
def test_cuda_ksw_wave_scalar_path_and_edges(shape):
    """P1 on a ragged wave whose jobs include queries of 4,095 bases (the
    group DP's limit), 4,096-4,200 bases and an h0 that could take H to
    2^19 (those take the kernel's scalar path, counted), on a wave of one
    job and on a wave of none: every result of every job equal to the
    plain version and the host C++ ksw_extend2 (difference 0)."""
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine import native_ksw
    from bwamem_tpu_torch.engine.state import device_scoring

    rng = np.random.default_rng(23)
    opt = MemOptions()
    if shape == "ragged":
        ql = rng.integers(1, 300, 60).tolist() + [4095, 4096, 4150, 4200, 50, 120]
        tl = rng.integers(1, 400, 60).tolist() + [260, 300, 200, 150, 80, 130]
        h0 = rng.integers(0, 80, 60).tolist() + [30, 30, 30, 30,
                                                 (1 << 19) - 40, (1 << 19) - 600]
        n_scalar = 4  # 4,096-4,200 bases, and 2^19 - 40 + 50 x 1
    else:
        n = 1 if shape == "one" else 0
        ql, tl, h0, n_scalar = [140] * n, [260] * n, [35] * n, 0
    js = _ksw_wave(rng, ql, tl, h0)
    args = _ksw_wave_tensors(js, h0, opt.w, opt.pen_clip3)
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop, opt.a)
    mat = torch.tensor(opt.mat, dtype=torch.int32).reshape(5, 5).cuda()
    before, scalar = ext.LAUNCHES, ext.SCALAR_JOBS
    got = ext.ksw_extend(*args, mat, *sc)
    assert ext.LAUNCHES == before + (len(js) > 0)  # no launch for no job
    assert ext.SCALAR_JOBS - scalar == n_scalar
    plain = ext.ksw_extend_torch(*args, mat, *sc)
    host = native_ksw.extend_batch(js, opt.mat, *sc[:5], h0,
                                   [opt.w] * len(js), [opt.pen_clip3] * len(js))
    for k in ext.KEYS:
        assert torch.equal(got[k], plain[k]), k
        assert got[k].cpu().tolist() == [h[k] for h in host], k
    # the wave entry on the same jobs
    assert ext.ksw_extend_batch_np(
        [q for q, _ in js], [t for _, t in js], device_scoring(opt, "cuda"), h0,
        [opt.w] * len(js), [opt.pen_clip3] * len(js)) == host


@pytest.mark.cuda
@needs_card
def test_cuda_ksw_wave_scores_past_int8_take_the_scalar_path():
    """A matrix with a score past int8: every job of the wave runs on the
    kernel's scalar path and equals the plain version."""
    rng = np.random.default_rng(29)
    js = _ksw_wave(rng, rng.integers(1, 200, 40).tolist(),
                   rng.integers(1, 250, 40).tolist(), [0] * 40)
    h0 = rng.integers(0, 300, 40).tolist()
    args = _ksw_wave_tensors(js, h0, 60, 5)
    mat = torch.full((5, 5), -90, dtype=torch.int32)
    mat.fill_diagonal_(200)
    mat[4], mat[:, 4] = -1, -1
    scalar = ext.SCALAR_JOBS
    got = ext.ksw_extend(*args, mat.cuda(), 300, 10, 300, 10, 500, 200)
    assert ext.SCALAR_JOBS - scalar == 40
    plain = ext.ksw_extend_torch(*args, mat.cuda(), 300, 10, 300, 10, 500, 200)
    for k in ext.KEYS:
        assert torch.equal(got[k], plain[k]), k


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("opts", ({}, {"min_chain_weight": 30,
                                       "max_chain_extend": 3}),
                         ids=("default", "weight30_extend3"))
def test_cuda_chain_warp_cases(opts):
    """chain_kernel on the reads that drive its warp steps to their edges
    (``chain_cases.warp_table``: equal keys past a 32-lane chunk, equal
    weights in key against creation order, the shadowing breaks, 128 and
    129 chains): every column of ``Chains`` (the chain rows' rid, is_alt,
    n_seeds, frac_rep bits, w, kept, first; the seed rows; the counts and
    flags) equal to the plain version, and the chains equal to the host
    oracle's and, in what the host C++ chain_batch sets (frac_rep, ALT
    flag, seeds, in output order), to its chains."""
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine import native_chain
    from bwamem_tpu_torch.engine.chain import chain_flt, mem_chain
    from bwamem_tpu_torch.engine.seed import SmemIntv
    from bwamem_tpu_torch.index.build import BntAnn, Bntseq

    opt = MemOptions(**opts)
    names, ivs, rbs, qlens = chain_cases.warp_table(np.random.default_rng(5))
    bns = Bntseq(l_pac=chain_cases.WARP_L_PAC, anns=[
        BntAnn(offset=o, name=f"c{i}", length=n, is_alt=a)
        for i, (o, n, a) in enumerate(chain_cases.WARP_CONTIGS)])
    flat = chain_cases.seed_table(ivs, rbs, qlens)
    tab = co.SeedTable.from_numpy("cuda", *flat)
    ctg = co.DeviceContigs.from_host(bns, "cuda")
    params = co.ChainParams.from_opt(opt)
    got = co.chain(ctg, tab, params)
    for g, p in zip(got, co.chain_torch(ctg, tab, params)):
        assert torch.equal(g, p)
    lists, (ovf, _, nslots) = co.chain_lists(got)
    assert [names[i] for i in np.flatnonzero(ovf)] == ["c129"]
    assert nslots[names.index("c128")] == 128
    host = native_chain.chain_batch(opt, bns, *flat)
    for i, name in enumerate(names):
        if ovf[i]:
            continue
        exp = chain_flt(opt, mem_chain(opt, None, bns, qlens[i],
                                       [SmemIntv(*p) for p in ivs[i]], rbs[i]))
        assert [_chain_key(c) for c in lists[i]] == [_chain_key(c) for c in exp], name
        assert [_chain_key(c)[4:] for c in lists[i]] == [
            _chain_key(c)[4:] for c in host[i]], name


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("opts", ({}, {"min_chain_weight": 30,
                                       "max_chain_extend": 3}),
                         ids=("default", "weight30_extend3"))
def test_cuda_chain_emit_is_idempotent_and_order_free(opts):
    """On every ``warp_table`` read: the emit pass launched twice on the
    same operands writes the same rows (it writes no scratch), equal to the
    plain version's; and both kernels taking the reads in another order
    than ``read_order`` give the same outputs."""
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.index.build import BntAnn, Bntseq

    opt = MemOptions(**opts)
    names, ivs, rbs, qlens = chain_cases.warp_table(np.random.default_rng(5))
    bns = Bntseq(l_pac=chain_cases.WARP_L_PAC, anns=[
        BntAnn(offset=o, name=f"c{i}", length=n, is_alt=a)
        for i, (o, n, a) in enumerate(chain_cases.WARP_CONTIGS)])
    ctg = co.DeviceContigs.from_host(bns, "cuda")
    tab, cnt, off = co.prepare(ctg, co.SeedTable.from_numpy(
        "cuda", *chain_cases.seed_table(ivs, rbs, qlens)))
    params = co.ChainParams.from_opt(opt)
    plain = co.chain_torch(ctg, tab, params)
    B, T = len(names), int(cnt.sum())
    i32, i64 = torch.int32, torch.int64
    orders = {"read_order": co.read_order(cnt),
              "reversed": co.read_order(cnt).flip(0).contiguous(),
              "shuffled": torch.from_numpy(np.random.default_rng(1).permutation(
                  B).astype(np.int32)).cuda()}
    for how, order in orders.items():
        assign, slot_dst = (torch.full((T,), -9, dtype=i32, device="cuda")
                            for _ in range(2))
        crec = torch.full((T, 5), -9, dtype=i32, device="cuda")
        n_chain, n_seed = (torch.zeros(B, dtype=i64, device="cuda")
                           for _ in range(2))
        ovf, nslots = (torch.zeros(B, dtype=i32, device="cuda") for _ in range(2))
        frac = torch.empty(B, dtype=torch.float64, device="cuda")
        err = torch.zeros(1, dtype=i32, device="cuda")
        co.chain_launch(ctg, tab, off, params, co.C_MAX, order, assign,
                        slot_dst, crec, n_chain, n_seed, frac, ovf, nslots, err)
        assert int(err.item()) == 0
        assert torch.equal(n_chain, plain.n_chain), how
        assert torch.equal(ovf.bool(), plain.ovf), how
        chain_off = torch.cumsum(n_chain, 0) - n_chain
        seed_dst = torch.cumsum(n_seed, 0) - n_seed
        scratch = [t.clone() for t in (assign, slot_dst, crec)]
        outs = []
        for _ in range(2):
            rows = (torch.full((int(n_chain.sum()), 7), -5, dtype=i64,
                               device="cuda"),
                    torch.full((int(n_seed.sum()), 4), -5, dtype=i64,
                               device="cuda"))
            before = co.LAUNCHES["chain_emit"]
            co.chain_emit_launch(ctg, tab, off, order, assign, slot_dst, crec,
                                 n_chain, frac, chain_off, seed_dst, *rows)
            assert co.LAUNCHES["chain_emit"] == before + 1
            outs.append(rows)
        for t, t0 in zip((assign, slot_dst, crec), scratch):
            assert torch.equal(t, t0), how  # the emit pass wrote no scratch
        for rows in outs:
            assert torch.equal(rows[0], plain.chain_rows), how
            assert torch.equal(rows[1], plain.seed_rows), how


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


# kernels the fused path on one card never launches: the per-lane seeding
# kernels (their functions run inside collect_intv_kernel) and the sharded
# seeding kernel
ONE_CARD_IDLE = ("smem1a", "strategy1", "collect_intv_sharded")


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
        assert all(now[k] == was[k] + (k not in ONE_CARD_IDLE) for k in was
                   ), (now, was)
    assert fmops.LAUNCHES["sa_lookup"] == before[3] + 1
    assert FUSED_STATS.device_reads + FUSED_STATS.host_reads == len(reads)
    assert FUSED_STATS.device_reads >= 0.95 * len(reads)
    if FUSED_STATS.host_reads == 0:
        assert ext.LAUNCHES == before[4]
        assert STATS.device_extend_waves + STATS.host_extend_waves == 0
    assert got == host.align_seqs(reads)
    index.close()


def _prep_on_card(ctg, chains, qlen, params):
    """The prep kernel launched twice on the same buffers (the second on
    rmax/srt holding the first's output, srt's places set to -1 before it):
    (rmax, srt, the flag word) of the second launch; both launches'
    outputs equal."""
    i32, i64 = torch.int32, torch.int64
    chains = chains._replace(
        chain_rows=chains.chain_rows.to(i64).contiguous(),
        seed_rows=chains.seed_rows.to(i64).contiguous(),
        n_chain=chains.n_chain.to(i64).contiguous(),
        n_seed=chains.n_seed.to(i64).contiguous())
    lay = fo._layout(chains)
    ql = qlen.to(i32).contiguous()
    rmax = torch.empty((chains.chain_rows.shape[0], 2), dtype=i64, device="cuda")
    srt = torch.empty(chains.seed_rows.shape[0], dtype=i32, device="cuda")
    err = torch.zeros(1, dtype=i32, device="cuda")
    before = fo.LAUNCHES["chain2aln_prep"]
    fo.chain2aln_prep_launch(ctg, chains, lay, ql, params, rmax, srt, err)
    first = (rmax.clone(), srt.clone())
    srt.fill_(-1)
    fo.chain2aln_prep_launch(ctg, chains, lay, ql, params, rmax, srt, err)
    torch.cuda.synchronize()
    assert fo.LAUNCHES["chain2aln_prep"] == before + 2
    assert torch.equal(rmax, first[0]) and torch.equal(srt, first[1])
    return rmax, srt, int(err.item()), lay


def _windows(ctg, chains, lay, qlen, params):
    r0, r1, perm, c_of = fo.chain_windows(ctg, chains, lay, qlen, params)
    return torch.stack([r0, r1], 1), perm - lay.chain_seed_off[c_of[perm]]


@pytest.mark.cuda
@needs_card
def test_cuda_prep_matches_chain_windows_on_chain_case_reads(fused_engine):
    """The prep kernel's own outputs, each chain's window [rmax0, rmax1] and
    its seed order (indices within the chain, ascending by (score,
    index)), against the plain version's ``chain_windows`` on the chains
    of chain_cases reads (both strands, repeats, the ALT contig, reads at
    the genome's ends), launched twice on the same buffers."""
    from bwamem_tpu_torch.api.options import MemOptions

    eng, contigs = fused_engine
    opt = MemOptions()
    reads = chain_cases.reads(contigs, np.random.default_rng(33), 120)
    reads += fused_cases.boundary_reads(contigs)
    _, (ctg, _, chains, _, qlen, _, p, _) = _fused_operands(eng, opt, reads)
    rmax, srt, err, lay = _prep_on_card(ctg, chains, qlen, p)
    assert err == 0
    exp_rmax, exp_srt = _windows(ctg, chains, lay, qlen, p)
    assert torch.equal(rmax, exp_rmax) and torch.equal(srt.long(), exp_srt)
    assert int(chains.n_chain.max()) >= 2


@pytest.mark.cuda
@needs_card
def test_cuda_prep_on_hand_built_chains():
    """chain_cases.prep_table: a chain of equal scores (ties keep index
    order), chains of 1, 31, 32, 33 and 600 seeds (two full 256-score tiles
    of shared memory and a part), windows cut at the strand boundary on the
    first seed's side, a read of three chains; then a first seed in no
    contig sets ERR_CONTIG where the plain version raises."""
    from bwamem_tpu_torch.api.options import MemOptions

    l_pac = chain_cases.WARP_L_PAC
    ctg = co.DeviceContigs(
        torch.tensor([o + n for o, n, _ in chain_cases.WARP_CONTIGS],
                     device="cuda"),
        torch.tensor([a for _, _, a in chain_cases.WARP_CONTIGS],
                     dtype=torch.int32, device="cuda"),
        l_pac, torch.tensor([o for o, _, _ in chain_cases.WARP_CONTIGS],
                            device="cuda"))
    p = fo.ExtendParams.from_opt(MemOptions())

    def table(no_contig):
        names, crow, srow, n_chain, n_seed, qlen = chain_cases.prep_table(
            np.random.default_rng(31), no_contig)
        z = torch.zeros(len(names), dtype=torch.int64, device="cuda")
        up = [torch.from_numpy(a).cuda() for a in (crow, srow, n_chain, n_seed)]
        return names, co.Chains(*up, z, z.bool(), z.int()), torch.from_numpy(
            qlen).cuda()

    names, chains, qlen = table(False)
    rmax, srt, err, lay = _prep_on_card(ctg, chains, qlen, p)
    assert err == 0
    exp_rmax, exp_srt = _windows(ctg, chains, lay, qlen, p)
    assert torch.equal(rmax, exp_rmax) and torch.equal(srt.long(), exp_srt)
    ns = lay.ns.tolist()
    assert max(ns) == 600 and {1, 31, 32, 33} <= set(ns)
    k = names.index("strand_fwd")
    assert int(rmax[k, 1]) == l_pac and int(rmax[k + 1, 0]) == l_pac
    eq = names.index("equal_scores")
    assert srt[:ns[eq]].tolist() == list(range(ns[eq]))
    _, chains, qlen = table(True)
    rmax, _, err, lay = _prep_on_card(ctg, chains, qlen, p)
    assert err == fo.ERR_CONTIG and rmax[-1].tolist() == [0, 0]
    with pytest.raises(RuntimeError):
        fo.chain_windows(ctg, chains, lay, qlen, p)
    with pytest.raises(RuntimeError):
        fo.raise_flags(err)


def _sample_ks_rows(rng, nrows, M=48, max_occ=500):
    """Rows [B, M, 5] on the card with sizes below, at and past max_occ."""
    B = len(nrows)
    rows = np.zeros((B, M, 5), np.int64)
    rows[:, :, 0] = rng.integers(0, 1 << 40, (B, M))
    rows[:, :, 2] = rng.choice([1, 2, 33, max_occ - 1, max_occ, max_occ + 1,
                                2 * max_occ + 7, 100_003], (B, M))
    rows[:, :, 1] = rows[:, :, 0] + rows[:, :, 2]
    rows[:, :, 3] = rng.integers(0, 100, (B, M))
    rows[:, :, 4] = rows[:, :, 3] + 25
    n = torch.tensor(nrows, dtype=torch.int32, device="cuda")
    r = torch.from_numpy(rows).cuda()
    valid = torch.arange(M, device="cuda")[None, :] < n[:, None]
    nks = torch.where(valid, r[:, :, 2].clamp(max=max_occ), 0).sum(1)
    return r, n, nks


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("max_occ", (500, 7))
def test_cuda_sample_ks_edges(max_occ):
    """sample_ks on the card against sample_ks_torch: reads of 0, 1, 32, 33
    and 48 rows at M = 48 (two rounds of the warp scan), rows below, at and
    past max_occ (the step path), the kernel launched twice on the same
    buffers; and empty batches (no read, no row), which launch nothing."""
    rng = np.random.default_rng(max_occ + 1)
    nrows = [0, 1, 32, 33, 48, 0] + rng.integers(0, 49, 40).tolist()
    rows, n, nks = _sample_ks_rows(rng, nrows, max_occ=max_occ)
    before = so.LAUNCHES["sample_ks"]
    flat, ks = so.sample_ks(rows, n, nks, max_occ)
    assert so.LAUNCHES["sample_ks"] == before + 1
    pflat, pks = so.sample_ks_torch(rows, n, nks, max_occ)
    assert torch.equal(flat, pflat) and torch.equal(ks, pks)
    s = rows[:, :, 2][torch.arange(48, device="cuda")[None, :] < n[:, None]]
    assert bool((s < max_occ).any() and (s == max_occ).any()
                and (s > max_occ).any())
    row_off, ks_off, _, _ = so._scan_offsets(n, nks)
    flat.fill_(-1)
    ks.fill_(-1)
    for _ in range(2):
        so.sample_ks_launch(rows, n, row_off, ks_off, max_occ, flat, ks)
        torch.cuda.synchronize()
        assert torch.equal(flat, pflat) and torch.equal(ks, pks)
    assert so.LAUNCHES["sample_ks"] == before + 3
    for B in (0, 5):
        rows, n, nks = _sample_ks_rows(rng, [0] * B, max_occ=max_occ)
        flat, ks = so.sample_ks(rows, n, nks, max_occ)
        assert flat.shape == (0, 5) and ks.shape == (0,)
    assert so.LAUNCHES["sample_ks"] == before + 3


@pytest.fixture(scope="module")
def tail_genome(tmp_path_factory):
    from bwamem_tpu_torch import BwaMemIndex
    from bwamem_tpu_torch.index import image
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig
    from bwamem_tpu_torch.utils.synth import simulate_pairs, synthetic_genome

    codes = synthetic_genome(200_000, np.random.default_rng(7))
    img = str(tmp_path_factory.mktemp("tail") / "g.img")
    image.write_image(img, build_index(Fasta([FastaContig("chr", "", codes)])))
    index = BwaMemIndex(img)
    yield index, simulate_pairs(codes, np.random.default_rng(9), 200)
    index.close()


# a card aligner takes the fused path unless told otherwise: the waves and
# the stage routes say device_pipeline=False
WAVES = dict(device_pipeline=False)
CARD_ROUTES = {"default": WAVES,
               "sa": dict(WAVES, device_stages=("sa_lookup",)),
               "seed_sa": dict(WAVES, device_stages=("seed", "sa_lookup")),
               "chain": dict(WAVES, device_stages=("chain",)),
               "staged": dict(WAVES, device_stages=("seed", "sa_lookup", "chain")),
               "fused": dict(device_pipeline=True)}


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("mode", ("se", "pe"))
@pytest.mark.parametrize("route", CARD_ROUTES)
def test_cuda_native_tail_matches_python_tail(tail_genome, route, mode):
    """Each card route: its records through the C++ tail (timed as
    ``native_tail``; no Python dedup, no ``pair.sam_pe``) equal the Python
    tail's on the same route's regions, and the host whole-batch route's."""
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.api.aligner import _aln_to_record, python_tail
    from bwamem_tpu_torch.engine import pair as pair_mod
    from bwamem_tpu_torch.engine.pipeline import align_regs_batch
    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch
    from bwamem_tpu_torch.utils.timers import TIMERS

    index, reads = tail_genome
    port = BwaMemAligner(index, device="cuda", **CARD_ROUTES[route])
    host = BwaMemAligner(index, device="cpu")
    if mode == "pe":
        for a in (port, host):
            a.align_pairs()
    sam_pe, calls = pair_mod.sam_pe, []
    pair_mod.sam_pe = lambda *x, **k: calls.append(1) or sam_pe(*x, **k)
    try:
        TIMERS.reset()
        got = port.align_seqs(reads)
        stages = TIMERS.snapshot()
    finally:
        pair_mod.sam_pe = sam_pe
    assert not calls and "native_tail" in stages and "dedup" not in stages
    eng = index._require()
    codes = seq_to_codes_batch(reads)
    py = python_tail(port.options, eng, codes, align_regs_batch(
        port.options, eng, codes, port._exec_cfg), port._pe_stats)
    want = [[vars(_aln_to_record(p, m)) for p, m in r] for r in py]
    assert [[vars(a) for a in r] for r in got] == want
    assert [[vars(a) for a in r] for r in host.align_seqs(reads)] == want


@pytest.mark.cuda
@needs_card
def test_cuda_aligner_raises_without_its_tail_library(tail_genome, monkeypatch):
    """A card aligner whose tail library does not build or load raises; it
    does not hand the batch to the Python tail."""
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.engine import native_pipeline

    index, reads = tail_genome
    monkeypatch.setattr(native_pipeline, "_ensure_built", lambda: False)
    for kw in CARD_ROUTES.values():
        port = BwaMemAligner(index, device="cuda", **kw)
        with pytest.raises(RuntimeError):
            port.align_seqs(reads[:20])
        with pytest.raises(RuntimeError):
            port.align_seqs_raw(reads[:20])


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A 200 kbp genome's image and 200 simulated pairs as FASTQ files."""
    from bwamem_tpu_torch.index import image
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig
    from bwamem_tpu_torch.utils.synth import simulate_pairs, synthetic_genome

    d = tmp_path_factory.mktemp("cli")
    codes = synthetic_genome(200_000, np.random.default_rng(7))
    img = str(d / "g.img")
    image.write_image(img, build_index(Fasta([FastaContig("chr", "", codes)])))
    reads = simulate_pairs(codes, np.random.default_rng(9), 200)
    paths = [str(d / "r1.fq"), str(d / "r2.fq")]
    with open(paths[0], "w") as f1, open(paths[1], "w") as f2:
        for i in range(len(reads) // 2):
            for f, s in ((f1, reads[2 * i]), (f2, reads[2 * i + 1])):
                f.write(f"@p{i}\n{s.decode()}\n+\n{'I' * len(s)}\n")
    return img, paths


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("mode", ("se", "pe"))
@pytest.mark.parametrize("route", ((), ("--no-device-pipeline",)),
                         ids=("fused", "waves"))
def test_cuda_cli_sam_equals_the_host_routes(cli_files, mode, route):
    """``mem`` with no device flag (the card, the fused path) and with
    ``--no-device-pipeline`` prints the host route's SAM byte for byte;
    the fused run launches the chain-to-region kernels; shards merge."""
    import contextlib
    import io

    from bwamem_tpu_torch import __main__ as cli

    img, (r1, r2) = cli_files
    argv = ["mem", img, r1] + ([r2, "--insert-mean", "350", "--insert-std",
                                "35"] if mode == "pe" else [])

    def run(*extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli.main(argv + list(extra)) == 0
        return out.getvalue()

    before = fo.LAUNCHES["chain2aln"]
    card = run(*route)
    assert (fo.LAUNCHES["chain2aln"] > before) == (not route)
    assert card == run("--device", "cpu")
    body = [ln for ln in card.splitlines() if not ln.startswith("@")]
    shards = [ln for i in range(2) for ln in run(*route, "--shard", f"{i}/2")
              .splitlines() if not ln.startswith("@")]
    assert sorted(shards) == sorted(body)


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("route", CARD_ROUTES)
def test_cuda_threads_with_own_aligners(tail_genome, route):
    """Two threads, each with its own card aligner on one index (the
    device state cached on the index objects, the stats objects shared):
    each thread's records equal the host whole-batch route's."""
    import threading

    from bwamem_tpu_torch import BwaMemAligner

    index, reads = tail_genome
    want = [[vars(a) for a in r]
            for r in BwaMemAligner(index, device="cpu").align_seqs(reads)]
    got, errors = {}, []

    def worker(tid):
        try:
            a = BwaMemAligner(index, device="cuda", **CARD_ROUTES[route])
            for _ in range(3):
                got[tid] = [[vars(x) for x in r] for r in a.align_seqs(reads)]
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert got[0] == want and got[1] == want


# ---------------------------------------------------------- several devices

@pytest.fixture(scope="module")
def small_fm():
    from bwamem_tpu_torch.engine.fmindex import FMIndex
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 200_000).astype(np.uint8)
    codes[150_000:150_500] = codes[1_000:1_500]
    fm = FMIndex(build_index(Fasta([FastaContig("c", "", codes)]), sa_intv=8))
    reads = [codes[i: i + 150].copy() for i in range(0, 190_000, 1_900)]
    return fm, reads


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("n_shards", (1, 2, 3, 8))
def test_cuda_sharded_kernels_match_plain(small_fm, n_shards):
    """The sharded instantiations of occ4, the SA walk and collect_intv
    (shards as separate allocations on cuda:0) against their plain versions
    (the owner gathers) and the unsharded kernels; tolerance 0."""
    fm, reads = small_fm
    sfm = fmops.ShardedFMIndex.from_host(fm, ["cuda"] * n_shards)
    cpu = fmops.ShardedFMIndex.from_host(fm, ["cpu"] * n_shards)
    dfm = fmops.DeviceFMIndex.from_host(fm, "cuda")
    rng = np.random.default_rng(n_shards)
    ks = torch.from_numpy(rng.integers(-1, fm.seq_len + 1, 20_000))
    rows = torch.from_numpy(rng.integers(0, fm.seq_len + 1, 20_000))
    before = dict(fmops.LAUNCHES)
    occ = fmops.occ4_sharded(sfm, ks.cuda())
    assert torch.equal(occ.cpu(), fmops.occ4_torch(cpu, ks))
    assert torch.equal(occ, fmops.occ4(dfm, ks.cuda()))
    pos = fmops.sa_lookup_sharded(sfm, rows.cuda())
    assert torch.equal(pos.cpu(), fmops.sa_lookup_torch(cpu, rows))
    assert fmops.LAUNCHES["occ4_sharded"] == before["occ4_sharded"] + 1
    assert fmops.LAUNCHES["sa_lookup_sharded"] == before["sa_lookup_sharded"] + 1
    p = so.SeedParams.from_opt(_opt())
    q, ql = so.pad_reads(reads, "cuda")
    got, gpos = so.seed_sa_walk(sfm, q, ql, p)
    want, wpos = so.seed_sa_walk(dfm, q, ql, p)
    plain, ppos = so.seed_sa_walk(cpu, q.cpu(), ql.cpu(), p)
    for a, b, c in zip((*got.intervals, got.flat, got.ks, gpos),
                       (*want.intervals, want.flat, want.ks, wpos),
                       (*plain.intervals, plain.flat, plain.ks, ppos)):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def _opt():
    from bwamem_tpu_torch.api.options import MemOptions

    return MemOptions()


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("route", ("fused", "waves", "staged"))
def test_cuda_mesh_aligner_on_a_virtual_mesh(tail_genome, route):
    """BwaMemAligner(mesh=...) on cuda:0 twice (and on the real cards)
    gives the host whole-batch route's records."""
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.parallel.mesh import make_mesh

    index, reads = tail_genome
    kw = {"fused": dict(device_pipeline=True), "waves": WAVES,
          "staged": dict(WAVES, device_stages=("seed", "sa_lookup", "chain"))}

    def run(**k):
        al = BwaMemAligner(index, **k)
        al.align_pairs()
        return [[vars(a) for a in r] for r in al.align_seqs(reads)]

    want = run(device="cpu")
    for mesh in (make_mesh(devices=["cuda:0"] * 2), make_mesh()):
        assert run(mesh=mesh, **kw[route]) == want


@pytest.mark.cuda
@needs_card
def test_cuda_device_sa_equals_sais_and_builds_the_same_index(monkeypatch):
    from bwamem_tpu_torch.index import native_sais
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.ops.sa import suffix_array_device
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig
    from bwamem_tpu_torch.utils.synth import synthetic_genome

    g = synthetic_genome(300_000, np.random.default_rng(2))
    codes = np.where(g > 3, 0, g).astype(np.uint8)
    assert np.array_equal(suffix_array_device(codes, "cuda"),
                          native_sais.suffix_array(codes))
    fa = Fasta([FastaContig("c", "", g)])
    host = build_index(fa)
    monkeypatch.setenv("BWAMEM_TPU_DEVICE_SA", "1")
    dev = build_index(fa)
    assert host.bwt.primary == dev.bwt.primary
    assert np.array_equal(host.bwt.bwt, dev.bwt.bwt)
    assert np.array_equal(host.bwt.sa, dev.bwt.sa)


# ---------------------------------------------------- 300-base reads (midlen)

@pytest.fixture(scope="module")
def midlen_genome(tmp_path_factory):
    """bench.py's "midlen" shape at a small size: 24 pairs of 300 bases,
    insert 700, on a 200 kbp genome of the bench's generator."""
    from bwamem_tpu_torch import BwaMemIndex
    from bwamem_tpu_torch.index import image
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig
    from bwamem_tpu_torch.utils.synth import simulate_pairs, synthetic_genome

    codes = synthetic_genome(200_000, np.random.default_rng(1234))
    img = str(tmp_path_factory.mktemp("midlen") / "g.img")
    image.write_image(img, build_index(Fasta([FastaContig("chr", "", codes)]),
                                       sa_intv=8))
    index = BwaMemIndex(img)
    yield index, simulate_pairs(codes, np.random.default_rng(1235), 24,
                                read_len=300, isize_mean=700)
    index.close()


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("kernel", ("seed_sa", "chain", "chain2aln", "ksw"))
def test_cuda_path_kernels_match_plain_at_300_bases(midlen_genome, kernel):
    """Each kernel of the path on 300-base reads (Q = 300) against its plain
    version on the card, every output: the seeding kernels and the SA walk
    on the reads, the chain kernels on their device seed table, the
    chain-to-region kernels on their chains, and the wave kernel on jobs of
    300-base queries."""
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine import pipeline
    from bwamem_tpu_torch.engine.exec_ctx import ExecConfig
    from bwamem_tpu_torch.engine.pipeline_device import ref_t_cap
    from bwamem_tpu_torch.engine.state import (device_contigs, device_fm,
                                               device_ref, device_scoring)
    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch

    index, seqs = midlen_genome
    eng = index._require()
    opt = MemOptions()
    reads = seq_to_codes_batch(seqs)
    assert {len(r) for r in reads} == {300}
    if kernel == "ksw":
        rng = np.random.default_rng(300)
        js = _ksw_wave(rng, [300] * 40 + list(rng.integers(150, 300, 24)),
                       list(rng.integers(300, 520, 64)), [0] * 64)
        args = _ksw_wave_tensors(js, list(rng.integers(0, 60, 64)), 100, 5)
        sc = device_scoring(opt, "cuda")
        full = args + [sc.mat, sc.o_del, sc.e_del, sc.o_ins, sc.e_ins,
                       sc.zdrop, sc.max_sc]
        got, plain = ext.ksw_extend_cuda(*full), ext.ksw_extend_torch(*full)
        assert args[0].shape[1] == 300
        for k in ext.KEYS:
            assert torch.equal(got[k], plain[k]), k
        return
    if kernel == "seed_sa":
        dfm = device_fm(eng.fm, "cuda")
        params = so.SeedParams.from_opt(opt)
        qseq, qlen = so.pad_reads(reads, "cuda")
        got = so.seed_sa(dfm, qseq, qlen, params, K=so.K_MAX)
        plain = so.seed_sa_torch(dfm, qseq, qlen, params, K=so.K_MAX)
        ok = ~got.intervals.ovf
        assert torch.equal(got.intervals.ovf, plain.intervals.ovf)
        assert torch.equal(got.intervals.rows[ok], plain.intervals.rows[ok])
        for g, p in zip(got[1:], plain[1:]):
            assert torch.equal(g, p)
        assert torch.equal(fmops.sa_lookup(dfm, got.ks),
                           fmops.sa_lookup_torch(dfm, plain.ks))
        assert got.ks.numel() > len(reads)
        return
    qlens = np.asarray([len(r) for r in reads], dtype=np.int32)
    tab, _, _, _ = pipeline._device_table(opt, eng, reads, qlens, ExecConfig(
        device="cuda", device_seed=True, device_sa_lookup=True,
        device_chain=True))
    ctg = device_contigs(eng.idx.bns, "cuda")
    params = co.ChainParams.from_opt(opt)
    chains = co.chain_cuda(ctg, tab, params)
    if kernel == "chain":
        for g, p in zip(chains, co.chain_torch(ctg, tab, params)):
            assert torch.equal(g, p)
        assert int(chains.n_chain.sum()) >= len(reads)
        return
    qseq, qlen = so.pad_reads(reads, "cuda")
    args = (ctg, device_ref(eng.idx, "cuda"), chains, qseq, qlen, ~chains.ovf,
            fo.ExtendParams.from_opt(opt), device_scoring(opt, "cuda").mat,
            ref_t_cap(opt, 300))
    got, plain = fo.chain2aln_cuda(*args), fo.chain2aln_torch(*args)
    for name in ("reg_c", "reg_i", "nregs", "seed_off", "work"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    assert int(got.work[:, fo.W_CELLS].sum()) > 0


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("route", ("fused", "staged", "default"))
def test_cuda_midlen_routes_match_host(midlen_genome, route):
    """300-base pairs with the bench's fixed statistics (700 +- 70) on
    each card route: the host whole-batch route's records."""
    from bwamem_tpu_torch import BwaMemAligner, BwaMemPairEndStats

    index, reads = midlen_genome
    kw = {"fused": dict(device_pipeline=True),
          "staged": dict(WAVES, device_stages=ALL), "default": WAVES}[route]

    def run(**k):
        al = BwaMemAligner(index, min_device_jobs=1, **k)
        al.align_pairs()
        al.set_proper_pair_end_stats(BwaMemPairEndStats.of(700, 70))
        return [[vars(a) for a in r] for r in al.align_seqs(reads)]

    assert run(device="cuda", **kw) == run(device="cpu")


# ------------------------------------------- reference positions past 2^32

@pytest.mark.cuda
@needs_card
def test_cuda_chain_and_chain2aln_past_2_32():
    """The chain and chain-to-region kernels on ``utils.big_ref``'s reads of
    a 2.2 Gbp one-contig pac (zero but around the reads; forward reads past
    2^31, reverse ones past 2^32): equal to the plain versions on the card
    and to the host oracle."""
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.pipeline_device import ref_t_cap
    from bwamem_tpu_torch.engine.state import (device_contigs, device_ref,
                                               device_scoring)
    from bwamem_tpu_torch.utils import big_ref

    l_pac = 2_200_000_000
    rng = np.random.default_rng(2038)
    plan = big_ref.plan(l_pac, rng, 32)
    idx = big_ref.big_index(l_pac, rng, plan, dense=False)
    big = big_ref.draw(idx, plan, rng)
    opt = MemOptions()
    ctg = device_contigs(idx.bns, "cuda")
    tab = big_ref.seed_table(big, "cuda")
    params = co.ChainParams.from_opt(opt)
    before = dict(co.LAUNCHES)
    chains = co.chain(ctg, tab, params)
    assert {k: co.LAUNCHES[k] - before[k] for k in before} == {
        "chain": 1, "chain_emit": 1}
    for g, p in zip(chains, co.chain_torch(ctg, tab, params)):
        assert torch.equal(g, p)
    qseq, qlen = so.pad_reads(big.reads, "cuda")
    args = (ctg, device_ref(idx, "cuda"), chains, qseq, qlen, ~chains.ovf,
            fo.ExtendParams.from_opt(opt), device_scoring(opt, "cuda").mat,
            ref_t_cap(opt, 300))
    got, plain = fo.chain2aln_cuda(*args), fo.chain2aln_torch(*args)
    for name in ("reg_c", "reg_i", "nregs", "seed_off", "work"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    want = big_ref.oracle_regions(opt, idx, big, range(len(big.reads)))
    lists, _ = co.chain_lists(chains)
    assert [[(c.rid, c.w, c.kept, c.first, [(s.rbeg, s.qbeg, s.len)
                                            for s in c.seeds]) for c in cl]
            for cl in lists] == [[(c.rid, c.w, c.kept, c.first,
                                   [(s.rbeg, s.qbeg, s.len) for s in c.seeds])
                                  for c in w] for w, _ in want]
    rows = got.compact().cpu().numpy()
    mine = [(int(r[0]), int(r[1]), int(r[3]), int(r[4]), int(r[5]))
            for r in rows]
    assert mine == [(a.rb, a.re, a.qb, a.qe, a.score)
                    for _, regs in want for a in regs]
    assert int(tab.rbegs.max()) >= 1 << 32 and max(r[0] for r in mine) >= 1 << 32


@pytest.mark.cuda
@needs_card
def test_cuda_concurrent_launches_with_different_shared_memory():
    """Threads that launch the wave kernel at once with different query
    lengths (so different dynamic shared memory a block, as a mesh's shards
    do) all launch: the kernel's shared-memory limit only rises
    (csrc/smem_limit.cuh), where a thread setting a smaller one could make
    another's launch fail with cudaErrorInvalidValue.  Each thread's results
    equal the same wave's run alone."""
    from concurrent.futures import ThreadPoolExecutor

    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.state import device_scoring

    rng = np.random.default_rng(77)
    sc = device_scoring(MemOptions(), "cuda")
    waves = []
    for ql in (40, 300, 1200, 2400):
        js = _ksw_wave(rng, [ql] * 48, [ql + 80] * 48, [0] * 48)
        waves.append(_ksw_wave_tensors(js, [20] * 48, 100, 5)
                     + [sc.mat, sc.o_del, sc.e_del, sc.o_ins, sc.e_ins,
                        sc.zdrop, sc.max_sc])
    want = [ext.ksw_extend_cuda(*w) for w in waves]

    def run(i):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            for _ in range(40):
                got = ext.ksw_extend_cuda(*waves[i % len(waves)])
            stream.synchronize()
        return i, got

    with ThreadPoolExecutor(8) as pool:
        for i, got in pool.map(run, range(16)):
            for k in ext.KEYS:
                assert torch.equal(got[k], want[i % len(waves)][k]), k
