"""Heavy reads on many warps (ops/pipeline_fused.py ``split_reads``,
``work_items`` and the split route of ``chain2aln_torch``).

``split_reads`` picks the reads whose chains the loop kernel runs as chain
items: a read of two chains or more whose ``n_seed x qlen`` is above the
batch's total over ``SPLIT_LINE`` times the kernel's resident warps.  The plain version's split
route mirrors what the kernel does with them: each chain alone against its
own regions, then the read committed chain by chain in bwa's order, each
chain decided again against the read's earlier regions, with its own run's
extension of every seed both runs extend.  Its regions and ``work`` counts
must be the plain route's and the host oracle's (engine/extend.py
``chain2aln``) read by read: on the chain-to-region cases, on hand-made
chains whose later seeds an earlier chain's region holds (so the commit
decides them otherwise), on two chains on one locus at different
diagonals, on reads whose every chain splits, and on the error states.
"""
import numpy as np
import pytest
import torch

from bwamem_tpu_torch.api.options import MemOptions
from bwamem_tpu_torch.engine import chain as port_chain
from bwamem_tpu_torch.engine import seed as port_seed
from bwamem_tpu_torch.engine.extend import chain2aln as host_chain2aln
from bwamem_tpu_torch.engine.pipeline import Engine
from bwamem_tpu_torch.engine.state import (device_contigs, device_ref,
                                           device_scoring)
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.ops import chain as co
from bwamem_tpu_torch.ops import pipeline_fused as fo
from bwamem_tpu_torch.ops.seed import pad_reads
from bwamem_tpu_torch.utils import chain_cases, fused_cases
from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

FIELDS = ("rb", "re", "qb", "qe", "score", "truesc", "w", "seedcov",
          "seedlen0", "rid", "frac_rep")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """The chain cases' genome (three contigs, the last ALT) and the repeat
    genome, each as the port's engine with its contigs, built on first use."""
    made = {}

    def get(make):
        if make not in made:
            contigs = make(np.random.default_rng(7))
            idx = build_index(Fasta([FastaContig(f"c{i}", "", c.copy())
                                     for i, c in enumerate(contigs)]))
            if make is chain_cases.genome:
                idx.bns.anns[2].is_alt = 1
            made[make] = (Engine(idx), contigs)
        return made[make]

    return get


def _seeded_chains(eng, opt, reads):
    """The reads' chains on the CPU from the host oracle's seeds, and the
    same chains as ``Chain`` lists."""
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


def _built_chains(eng, contigs):
    """``fused_cases.split_reads_cases`` as ``Chains`` and ``Chain`` lists."""
    names, reads, chains = fused_cases.split_reads_cases(
        contigs, eng.idx.bns.l_pac)
    lists = [[port_chain.Chain(rid=0, seeds=[port_chain.Seed(*map(int, s))
                                             for s in c]) for c in cl]
             for cl in chains]
    return names, reads, fused_cases.chains_table(chains), lists


def _args(eng, opt, reads, chains):
    qseq, qlen = pad_reads(reads, "cpu")
    return (device_contigs(eng.idx.bns, "cpu"), device_ref(eng.idx, "cpu"),
            chains, qseq, qlen, torch.ones(len(reads), dtype=torch.bool),
            fo.ExtendParams.from_opt(opt), device_scoring(opt, "cpu").mat)


def _rows(regs: fo.Regions):
    """Per read its regions as tuples in FIELDS order."""
    rows = regs.compact().numpy()
    frac = rows[:, 2].copy().view(np.float64)
    out, k = [], 0
    for n in regs.nregs.tolist():
        out.append([tuple(int(v) for v in r[[0, 1, 3, 4, 5, 6, 7, 8, 9, 10]])
                    + (float(f),) for r, f in zip(rows[k: k + n],
                                                  frac[k: k + n])])
        k += n
    return out


def _oracle(opt, eng, reads, lists):
    out = []
    for q, cl in zip(reads, lists):
        regs = []
        for c in cl:
            host_chain2aln(opt, eng.idx, len(q), q, c, regs)
        out.append([tuple(getattr(a, f) for f in FIELDS) for a in regs])
    return out


def _same(a: fo.Regions, b: fo.Regions):
    for name in ("reg_c", "reg_i", "nregs", "seed_off", "work"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# -------------------------------------------------------------- split_reads

def _shapes(est_reads, n_chain=None, run=None):
    """Reads of 100 bases whose ``n_seed`` gives each the work estimate."""
    B = len(est_reads)
    n_seed = torch.tensor([e // 100 for e in est_reads], dtype=torch.int64)
    qlen = torch.full((B,), 100, dtype=torch.int32)
    n_chain = (torch.full((B,), 3, dtype=torch.int64) if n_chain is None
               else torch.tensor(n_chain, dtype=torch.int64))
    run = (torch.ones(B, dtype=torch.bool) if run is None
           else torch.tensor(run, dtype=torch.bool))
    return n_seed, n_chain, qlen, run


def test_split_reads_none_when_all_are_light():
    """1,000 equal reads at 100 warps: each is under a share of the line."""
    assert 100 * fo.SPLIT_LINE < 1_000
    got = fo.split_reads(*_shapes([2_000] * 1_000), 100)
    assert not got.any()


def test_split_reads_single_chain_never_splits():
    shapes = _shapes([100_000] + [1_000] * 99, n_chain=[1] + [3] * 99)
    assert not fo.split_reads(*shapes, 10).any()
    shapes = _shapes([100_000] + [1_000] * 99, n_chain=[2] + [3] * 99)
    assert fo.split_reads(*shapes, 10).tolist() == [True] + [False] * 99


@pytest.mark.parametrize("warps,light,splits", [
    (1, 299, True),      # 100,000 x 4 > 399,000
    (1, 300, False),     # one more light read: 400,000 = 400,000
    (10, 3_899, True),   # more warps lower the line
    (10, 3_900, False),
    (1_000, 100_000, True),
    (1_000, 400_000, False)])
def test_split_reads_line_moves_with_total_and_warps(warps, light, splits):
    """The line is the batch's total estimate over ``SPLIT_LINE`` times the
    resident warps: more warps lower it, more reads raise it."""
    assert fo.SPLIT_LINE == 4
    got = fo.split_reads(*_shapes([100_000] + [1_000] * light), warps)
    assert bool(got[0]) == splits
    assert not got[1:].any()


def test_split_reads_leaves_out_reads_not_run():
    """A read left out of ``run`` neither splits nor counts in the total."""
    est = [100_000, 50_000, 1_000, 1_000]
    got = fo.split_reads(*_shapes(est, run=[False, True, True, True]), 2)
    assert got.tolist() == [False, True, False, False]


def test_work_items_order():
    """Reads heaviest first; a split read's chains in order at its read's
    rank; reads left out of ``run`` after the rest; a -1 for the split read
    itself, last; with no read split, the B reads alone, heaviest first."""
    n_seed = torch.tensor([2, 9, 5, 7])
    qlen = torch.tensor([100, 100, 100, 100], dtype=torch.int32)
    run = torch.tensor([True, True, True, False])
    chain_read = torch.tensor([0, 1, 1, 1, 2, 2, 3], dtype=torch.int32)
    split = torch.tensor([False, True, False, False])
    got = fo.work_items(n_seed, qlen, run, chain_read, split).tolist()
    B = 4
    assert got == [B + 1, B + 2, B + 3, 2, 0, 3, -1]
    both = fo.work_items(n_seed, qlen, run, chain_read,
                         torch.tensor([False, True, True, False])).tolist()
    assert both == [B + 1, B + 2, B + 3, B + 4, B + 5, 0, 3, -1, -1]
    none = fo.work_items(n_seed, qlen, run, chain_read,
                         torch.zeros(4, dtype=torch.bool))
    assert none.dtype == torch.int32 and none.tolist() == [1, 2, 0, 3]


# ------------------------------------------------------------- split route

@pytest.mark.parametrize("case", fused_cases.CASES)
def test_split_route_matches_plain_and_oracle(engines, case):
    """Every read of two chains or more split, and the split set
    ``split_reads`` derives at a few warps: the plain route's regions and
    work read by read, and the host oracle's regions."""
    eng, contigs = engines(chain_cases.genome)
    kw, make = fused_cases.CASES[case]
    opt = fused_cases.options(MemOptions(), kw)
    reads = make(contigs)
    chains, lists = _seeded_chains(eng, opt, reads)
    args = _args(eng, opt, reads, chains)
    plain = fo.chain2aln(*args)
    assert plain.split.tolist()[1:] == [0, 0, 0, 0]
    every = chains.n_chain >= 2
    derived = fo.split_reads(chains.n_seed, chains.n_chain, args[4], args[5], 4)
    for split in (every, derived):
        got = fo.chain2aln(*args, split=split)
        _same(got, plain)
        counts = dict(zip(fo.SPLIT_COUNTS, got.split.tolist()))
        assert counts["chains"] == int(chains.n_chain.sum())
        assert counts["split_reads"] == int(split.sum())
        assert counts["split_chains"] == int(chains.n_chain[split].sum())
    assert int(every.sum()) > 0
    assert _rows(plain) == _oracle(opt, eng, reads, lists)


def test_split_route_built_chains(engines):
    """Hand-made chains, every read split: later chains whose seeds an
    earlier chain's region holds are decided otherwise at the commit (the
    cells of their own runs' discarded extensions counted); chains at
    distinct copies keep their own runs' decisions; the regions are the
    oracle's and the work the plain route's, read by read."""
    eng, contigs = engines(chain_cases.genome)
    opt = MemOptions()
    names, reads, chains, lists = _built_chains(eng, contigs)
    args = _args(eng, opt, reads, chains)
    plain = fo.chain2aln(*args)
    every = torch.ones(len(reads), dtype=torch.bool)
    got = fo.chain2aln(*args, split=every)
    _same(got, plain)
    assert _rows(got) == _oracle(opt, eng, reads, lists)
    counts = dict(zip(fo.SPLIT_COUNTS, got.split.tolist()))
    assert counts["split_reads"] == len(reads)
    assert counts["split_chains"] == counts["chains"] == int(chains.n_chain.sum())
    assert counts["split_reruns"] >= 3 and counts["split_wasted_cells"] > 0
    pruned = dict(zip(names, plain.work[:, fo.W_PRUNED].tolist()))
    assert pruned["held_later"] == 2 and pruned["several_seeds"] == 3
    assert pruned["repeat_copies"] == 0
    assert plain.nregs.tolist()[names.index("repeat_copies")] == 5
    # one read at a time: the chains decided again belong to the reads whose
    # earlier chains hold later seeds
    reruns = {}
    for i, name in enumerate(names):
        one = torch.zeros(len(reads), dtype=torch.bool)
        one[i] = True
        part = fo.chain2aln(*args, split=one)
        _same(part, plain)
        reruns[name] = int(part.split[3])
    assert reruns["held_later"] == 2 and reruns["several_seeds"] == 1
    assert reruns["repeat_copies"] == 0
    assert sum(reruns.values()) == counts["split_reruns"]


def test_split_route_every_chain_of_a_hundred(engines):
    """The repeat unit's reads: 100 chains of one seed each, none held by
    another's region, all run as chain items and every own run kept."""
    eng, contigs = engines(fused_cases.repeat_genome)
    opt = MemOptions()
    reads = fused_cases.repeat_reads(contigs)
    chains, lists = _seeded_chains(eng, opt, reads)
    args = _args(eng, opt, reads, chains)
    plain = fo.chain2aln(*args)
    got = fo.chain2aln(*args, split=torch.ones(len(reads), dtype=torch.bool))
    _same(got, plain)
    assert chains.n_chain.min() >= 90
    assert got.split.tolist()[3] == 0
    assert _rows(got) == _oracle(opt, eng, reads, lists)


def test_split_route_error_states(engines, monkeypatch):
    """A seed outside its chain's window raises on both routes (the chain
    run alone stops there, its commit runs it with no own run and raises); a read
    with fewer rows than its chains' regions raises at the commit, as the
    loop kernel flags it."""
    eng, contigs = engines(chain_cases.genome)
    opt = MemOptions()
    _, reads, chains, _ = _built_chains(eng, contigs)
    args = list(_args(eng, opt, reads, chains))
    every = torch.ones(len(reads), dtype=torch.bool)
    windows = fo.chain_windows

    def shut(*a):
        r0, r1, perm, c_of = windows(*a)
        return r0, r0.clone(), perm, c_of

    monkeypatch.setattr(fo, "chain_windows", shut)
    for split in (None, every):
        with pytest.raises(RuntimeError, match="outside its chain's window"):
            fo.chain2aln(*args, split=split)
    monkeypatch.setattr(fo, "chain_windows", windows)
    # the last read ("reverse_strand": two regions) given one row
    n_seed = chains.n_seed.clone()
    n_seed[-1] = 1
    args[2] = chains._replace(n_seed=n_seed)
    one = torch.zeros(len(reads), dtype=torch.bool)
    one[-1] = True
    with pytest.raises(RuntimeError, match="past the read's rows"):
        fo.chain2aln(*args, split=one)
