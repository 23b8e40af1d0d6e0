"""The port's chaining (ops/chain.py) against the JAX package's device
program (ops/chain_tpu.py, on the CPU) and the host oracle
(engine/chain.py ``chain_flt(mem_chain(...))``), exactly (integers and
bit-equal doubles, no tolerance): chain for chain and seed for seed,
including ``w``, ``kept``, ``first``, ``frac_rep`` and the order.  On the CPU
the dispatcher runs the plain PyTorch version; the CUDA kernels are held
against it in test_torch_cuda.py.

Each package gets its own index, built from the same seeded genome.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem_tpu.api.options import MemOptions as JaxOptions
from bwamem_tpu.engine import seed as jax_seed
from bwamem_tpu.engine.pipeline import Engine as JaxEngine
from bwamem_tpu.index import build as jax_build
from bwamem_tpu.ops import chain_tpu
from bwamem_tpu.utils import fasta as jax_fasta
from bwamem_tpu_torch.api.options import MemOptions
from bwamem_tpu_torch.engine import chain as port_chain
from bwamem_tpu_torch.engine import native_chain, pipeline
from bwamem_tpu_torch.engine import seed as port_seed
from bwamem_tpu_torch.engine.exec_ctx import ExecConfig
from bwamem_tpu_torch.engine.pipeline import CHAIN_STATS, Engine
from bwamem_tpu_torch.engine.state import device_contigs
from bwamem_tpu_torch.index import build as port_build
from bwamem_tpu_torch.ops import chain as co
from bwamem_tpu_torch.utils import chain_cases
from bwamem_tpu_torch.utils import fasta as port_fasta


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops lose to thread start-up, and the suite runs several
    workers at once: keep torch to one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(build, fasta, engine_cls, contigs):
    idx = build.build_index(fasta.Fasta(
        [fasta.FastaContig(n, "", c.copy())
         for n, c in zip(("c0", "c1", "c2_alt"), contigs)]))
    idx.bns.anns[2].is_alt = 1
    return engine_cls(idx)


@pytest.fixture(scope="module")
def engines():
    """(the JAX package's engine, the port's) on the same genome."""
    contigs = chain_cases.genome(np.random.default_rng(7))
    return (_engine(jax_build, jax_fasta, JaxEngine, contigs),
            _engine(port_build, port_fasta, Engine, contigs), contigs)


def _seeded(eng, opt, reads):
    """Each read's intervals and per-interval reference starts, by the
    port's host oracle."""
    ivs = [port_seed.collect_intv(opt, eng.fm, q) for q in reads]
    rbs = [[eng.fm.sa_lookup(np.asarray(port_chain.sample_ks(p, opt.max_occ),
                                        dtype=np.int64)) for p in iv]
           for iv in ivs]
    return ivs, rbs


def _jax_intervals(ivs):
    """The same intervals as the JAX package's objects (its seeding is held
    equal to the port's in test_torch_hostcopy.py)."""
    return [[jax_seed.SmemIntv(*p) for p in iv] for iv in ivs]


def _key(c):
    return (c.rid, c.w, c.kept, c.first, c.frac_rep, c.is_alt,
            tuple((s.rbeg, s.qbeg, s.len, s.score) for s in c.seeds))


def _keys(chains_list):
    return [[_key(c) for c in chains] for chains in chains_list]


def _opts(**kw):
    return JaxOptions(**kw), MemOptions(**kw)


def _table(eng, ivs, rbs, reads):
    return co.SeedTable.from_numpy(
        "cpu", *chain_cases.seed_table(ivs, rbs, [len(r) for r in reads]))


CASES = {
    "fuzz": (dict(), 11, 100, 120),
    "low_max_occ": (dict(max_occ=3, min_seed_len=15), 12, 40, 90),
    "mask_drop_gap": (dict(mask_level=0.3, drop_ratio=0.7, max_chain_gap=60),
                      14, 40, 120),
    "chain_weight_extend": (dict(min_chain_weight=40, max_chain_extend=1), 15,
                            40, 120),
}


@pytest.mark.parametrize("case", CASES)
def test_chains_device_batch_matches_jax_and_oracle(engines, case):
    jeng, eng, contigs = engines
    kw, seed, n, read_len = CASES[case]
    jopt, opt = _opts(**kw)
    reads = chain_cases.reads(contigs, np.random.default_rng(seed), n, read_len)
    reads += [np.ones(5, np.uint8), np.zeros(19, np.uint8)]  # short reads
    ivs, rbs = _seeded(eng, opt, reads)
    oracle = [port_chain.chain_flt(opt, port_chain.mem_chain(
        opt, eng.fm, eng.idx.bns, len(q), iv, rb))
        for q, iv, rb in zip(reads, ivs, rbs)]
    before = dict(co.LAUNCHES)
    got, (ovf, seed_cnt, nslots) = co.chains_device_batch(
        device_contigs(eng.idx.bns, "cpu"), _table(eng, ivs, rbs, reads),
        co.ChainParams.from_opt(opt))
    assert co.LAUNCHES == before  # the CPU launches no kernel
    assert not ovf.any()
    assert _keys(got) == _keys(oracle)
    assert seed_cnt.tolist() == [sum(len(r) for r in rb) for rb in rbs]
    ref = chain_tpu.chains_device_batch(jopt, jeng.fm, jeng.idx.bns, reads,
                                        _jax_intervals(ivs), rbs)
    assert _keys(got) == _keys(ref)
    if case == "fuzz":  # the genome must exercise these paths
        assert sum(len(c) > 1 for c in oracle) >= 4
        assert any(c.kept in (1, 2) for cs in oracle for c in cs)
        assert any(c.is_alt for cs in oracle for c in cs)
    if case == "low_max_occ":
        assert any(c.frac_rep > 0 for cs in oracle for c in cs)


def _jax_kernel(jeng, jopt, ivs, rbs, reads, C):
    """``chain_kernel`` on the packed [B, S] seeds, and per unflagged read
    its chains in the port's layout: [(rid, n_seeds, w, kept, first,
    seeds)]."""
    seeds = [np.asarray([(rb, p.qb, p.qe - p.qb) for p, r in zip(iv, rr)
                         for rb in r.tolist()], np.int64).reshape(-1, 3)
             for iv, rr in zip(ivs, rbs)]
    B, S = len(reads), max(max(len(s) for s in seeds), 1)
    packed = np.zeros((3, B, S), np.int32)
    for i, s in enumerate(seeds):
        packed[:, i, :len(s)] = s.T
    bns = jeng.idx.bns
    out = chain_tpu.chain_kernel(
        *(jnp.asarray(a) for a in packed),
        jnp.asarray([len(s) for s in seeds], jnp.int32),
        jnp.asarray([len(r) for r in reads], jnp.int32),
        jnp.asarray([a.offset + a.length for a in bns.anns], jnp.int32),
        jnp.asarray([a.is_alt for a in bns.anns], jnp.int32),
        jnp.int32(jopt.w), jnp.int32(jopt.max_chain_gap),
        jnp.int32(jopt.min_chain_weight), jnp.int32(jopt.min_seed_len),
        jnp.int32(jopt.max_chain_extend), jnp.float32(jopt.mask_level),
        jnp.float32(jopt.drop_ratio), S=S, C=C, l_pac=int(bns.l_pac))
    assign, crid, weight, nch, order, kept, first, emit, ovf = (
        np.asarray(a) for a in out)
    chains = []
    for i in range(B):
        per_slot = {}
        for t in range(len(seeds[i])):
            if assign[i, t] >= 0:
                per_slot.setdefault(int(assign[i, t]), []).append(
                    tuple(seeds[i][t]) + (int(seeds[i][t][2]),))
        chains.append([
            (int(crid[i, order[i, j]]), len(per_slot[int(order[i, j])]),
             int(weight[i, order[i, j]]), int(kept[i, j]), int(first[i, j]),
             per_slot[int(order[i, j])])
            for j in range(C) if emit[i, j]])
    return chains, nch, ovf


def _port_rows(out: co.Chains):
    """``chain``'s flat output per read, in ``_jax_kernel``'s layout."""
    crow, srow = out.chain_rows.tolist(), out.seed_rows.tolist()
    chains, ci, si = [], 0, 0
    for n in out.n_chain.tolist():
        per = []
        for rid, _, ns, _, w, kept, first in crow[ci: ci + n]:
            per.append((rid, ns, w, kept, first,
                        [tuple(s) for s in srow[si: si + ns]]))
            si += ns
        ci += n
        chains.append(per)
    assert (ci, si) == (len(crow), len(srow))
    return chains


@pytest.mark.parametrize("C", (128, 32, 3), ids=("c128", "c32", "c3"))
def test_chain_torch_matches_chain_kernel(engines, C):
    """``chain_torch`` against the JAX ``chain_kernel`` on the same seeds
    with the same C, field by field; with C = 3 the overflow flags are
    equal, and a flagged read yields nothing in the port."""
    jeng, eng, contigs = engines
    jopt, opt = _opts()
    reads = chain_cases.reads(contigs, np.random.default_rng(13), 30)
    ivs, rbs = _seeded(eng, opt, reads)
    ref, nch, ovf = _jax_kernel(jeng, jopt, _jax_intervals(ivs), rbs, reads, C)
    out = co.chain_torch(device_contigs(eng.idx.bns, "cpu"),
                         _table(eng, ivs, rbs, reads),
                         co.ChainParams.from_opt(opt), C)
    assert out.ovf.tolist() == ovf.tolist()
    assert bool(ovf.any()) == (C == 3)
    got = _port_rows(out)
    for i in range(len(reads)):
        if ovf[i]:
            assert got[i] == [] and out.nslots[i] == C + 1
        else:
            assert got[i] == ref[i], i
            assert out.nslots[i] == nch[i]
    assert out.n_seed.tolist() == [sum(c[1] for c in cs) for cs in got]


@pytest.mark.parametrize("natives", (True, False), ids=("natives", "oracle"))
def test_c_overflow_reads_take_the_host_route(engines, monkeypatch, natives):
    """The pipeline's chain step with a C budget of 3: the flagged reads are
    chained on the host (the C++, or the oracle without it), every read
    equals the oracle, and ``CHAIN_STATS`` counts both kinds."""
    _, eng, contigs = engines
    opt = MemOptions()
    if not natives:
        monkeypatch.setattr(native_chain, "available", lambda: False)
    monkeypatch.setattr(pipeline.chainops, "chains_device_batch",
                        functools.partial(co.chains_device_batch, C=3))
    reads = chain_cases.reads(contigs, np.random.default_rng(13), 30)
    ivs, rbs = _seeded(eng, opt, reads)
    oracle = [port_chain.chain_flt(opt, port_chain.mem_chain(
        opt, eng.fm, eng.idx.bns, len(q), iv, rb))
        for q, iv, rb in zip(reads, ivs, rbs)]
    CHAIN_STATS.reset()
    got = pipeline._chains(opt, eng, reads,
                           ExecConfig(device="cpu", device_chain=True))

    def host_key(c):  # the host C++ leaves w, kept and first unset
        return _key(c)[:1] + _key(c)[4:]

    for i, (g, o) in enumerate(zip(got, oracle)):
        assert [host_key(c) for c in g] == [host_key(c) for c in o], i
    assert CHAIN_STATS.c_overflows == CHAIN_STATS.host_reads > 0
    assert CHAIN_STATS.device_reads + CHAIN_STATS.host_reads == len(reads)
    assert CHAIN_STATS.launches == 0  # the CPU launches no kernel


@pytest.mark.parametrize("mask_level,drop_ratio", ((0.5, 0.5), (0.3, 0.3)),
                         ids=("half", "three_tenths"))
def test_float_boundaries_follow_the_oracle(mask_level, drop_ratio):
    """Overlaps and weights on and beside ``min_l * mask_level`` and
    ``w * drop_ratio``: the port compares in float64 and equals the oracle
    on every read.  With 0.3 the JAX program's float32 compare parts from
    the oracle, and only on reads where the two roundings disagree."""
    jopt, opt = _opts(mask_level=mask_level, drop_ratio=drop_ratio)
    ivs, rbs, qlens, l_pac = chain_cases.boundary_table(mask_level, drop_ratio)
    reads = [np.zeros(n, np.uint8) for n in qlens]

    def bns(build):
        return build.Bntseq(l_pac=l_pac, anns=[
            build.BntAnn(offset=0, name="c", length=l_pac)])

    def intervals(seed_mod):
        return [[seed_mod.SmemIntv(*p) for p in iv] for iv in ivs]

    oracle = [port_chain.chain_flt(opt, port_chain.mem_chain(
        opt, None, bns(port_build), n, iv, rb))
        for n, iv, rb in zip(qlens, intervals(port_seed), rbs)]
    got, (ovf, _, _) = co.chains_device_batch(
        co.DeviceContigs.from_host(bns(port_build), "cpu"),
        co.SeedTable.from_numpy("cpu", *chain_cases.seed_table(ivs, rbs, qlens)),
        co.ChainParams.from_opt(opt))
    assert not ovf.any()
    assert _keys(got) == _keys(oracle)
    # apart, overlapping and shadowed second chains all occur
    assert {cs[1].kept for cs in oracle} == {1, 2, 3}
    ref = chain_tpu.chains_device_batch(jopt, None, bns(jax_build), reads,
                                        intervals(jax_seed), rbs)
    differ = [i for i, (a, b) in enumerate(zip(_keys(ref), _keys(oracle)))
              if a != b]

    def roundings_disagree(iv):
        (qa, ea), (qb, eb) = [(p[3], p[4]) for p in iv]
        ov, min_l = min(ea, eb) - max(qa, qb), min(ea - qa, eb - qb)
        w_hi, w_lo = max(ea - qa, eb - qb), min_l
        f32 = np.float32
        return ((ov >= min_l * mask_level)
                != (f32(ov) >= f32(min_l) * f32(mask_level))
                or (w_lo < w_hi * drop_ratio)
                != (f32(w_lo) < f32(w_hi) * f32(drop_ratio)))

    assert all(roundings_disagree(ivs[i]) for i in differ)
    assert bool(differ) == (mask_level == 0.3)


def test_cpu_dispatch_budget_and_table_checks(engines):
    _, eng, contigs = engines
    opt = MemOptions()
    reads = chain_cases.reads(contigs, np.random.default_rng(3), 4)
    ivs, rbs = _seeded(eng, opt, reads)
    ctg = device_contigs(eng.idx.bns, "cpu")
    tab = _table(eng, ivs, rbs, reads)
    params = co.ChainParams.from_opt(opt)
    before = dict(co.LAUNCHES)
    plain = co.chain_torch(ctg, tab, params)
    for g, p in zip(co.chain(ctg, tab, params), plain):
        assert torch.equal(g, p)
    assert co.LAUNCHES == before
    with pytest.raises(ValueError):
        co.chain_cuda(ctg, tab, params)  # CPU tensors never reach the kernel
    for C in (0, co.C_MAX + 1):
        with pytest.raises(ValueError):
            co.chain(ctg, tab, params, C)
    with pytest.raises(ValueError):  # seeds past the end of rbegs
        co.chain(ctg, tab._replace(rbeg_off=tab.rbeg_off + 1), params)
    with pytest.raises(ValueError):
        co.chain(ctg, tab._replace(cnt=tab.cnt[:-1]), params)
    empty = co.SeedTable.from_numpy(
        "cpu", *chain_cases.seed_table([], [], []))
    out = co.chain(ctg, empty, params)
    assert out.chain_rows.shape == (0, 7) and out.seed_rows.shape == (0, 4)


def test_contig_tables_live_on_the_index_object(engines):
    """``device_contigs`` caches per device on the ``Bntseq`` itself, so a
    new index never inherits another genome's tables."""
    _, eng, _ = engines
    bns = eng.idx.bns
    ctg = device_contigs(bns, "cpu")
    assert device_contigs(bns, "cpu") is ctg
    assert ctg.ctg_end.tolist() == [a.offset + a.length for a in bns.anns]
    assert ctg.ctg_alt.tolist() == [0, 0, 1] and ctg.l_pac == bns.l_pac
    other = dataclasses.replace(bns, anns=bns.anns[:2])
    assert device_contigs(other, "cpu").ctg_end.numel() == 2
    assert device_contigs(bns, "cpu") is ctg


@pytest.mark.parametrize("seeds,slots,expect", (
    ([10, 40, 64], [5, 33, 3], (0, 0)),       # S = 64, C = 128
    ([10, 32, 20], [5, 33, 3], (0, 1)),       # S = 64, C = 32: 33 needs > 32
    ([10, 33, 20], [5, 33, 3], (0, 0)),
    ([10, 300, 2000], [5, 129, 3], (2, 0)),   # past every S bucket: S = 64
    ([10, 300, 1000], [129, 129, 3], (0, 2)),
    ([], [], (0, 0)),
))
def test_ref_overflows_follow_the_jax_buckets(seeds, slots, expect):
    assert co.ref_overflows(np.asarray(seeds, np.int64),
                            np.asarray(slots, np.int64)) == expect
