"""Reference positions past 2^32 (GRCh38's doubled-strand domain is ~6.2e9):
the plain versions of the chain kernels and of the chain-to-region kernels
(``ops.chain.chain_torch``, ``ops.pipeline_fused.chain2aln_torch``) on
``utils.big_ref``'s reads against the port's host oracle and bwamem_tpu's,
exactly: chains with their weights and flags, and regions before dedup.
The pac is one contig of 2^32 + 2^28 bases, zero pages but for random
bases around the reads, so the CPU touches a few MB of it; forward reads
start past 2^31, reverse ones past 2^32."""
import numpy as np
import pytest
import torch

from bwamem_tpu.engine import chain as j_chain
from bwamem_tpu.engine import extend as j_extend
from bwamem_tpu.index import build as j_build
from bwamem_tpu_torch.api.options import MemOptions
from bwamem_tpu_torch.engine.pipeline_device import ref_t_cap
from bwamem_tpu_torch.engine.state import (device_contigs, device_ref,
                                           device_scoring)
from bwamem_tpu_torch.ops import chain as co
from bwamem_tpu_torch.ops import pipeline_fused as fo
from bwamem_tpu_torch.ops import seed as so
from bwamem_tpu_torch.utils import big_ref

L_PAC = (1 << 32) + (1 << 28)
N_READS = 12


@pytest.fixture(scope="module")
def big():
    """The sparse index, its reads, and the plain versions' chains and
    regions of every read on the CPU."""
    rng = np.random.default_rng(2032)
    plan = big_ref.plan(L_PAC, rng, N_READS)
    idx = big_ref.big_index(L_PAC, rng, plan, dense=False)
    reads = big_ref.draw(idx, plan, rng)
    opt = MemOptions()
    cpu = torch.device("cpu")
    ctg = device_contigs(idx.bns, cpu)
    tab = big_ref.seed_table(reads, cpu)
    chains = co.chain_torch(ctg, tab, co.ChainParams.from_opt(opt))
    qseq, qlen = so.pad_reads(reads.reads, cpu)
    run = ~chains.ovf
    regs = fo.chain2aln_torch(
        ctg, device_ref(idx, cpu), chains, qseq, qlen, run,
        fo.ExtendParams.from_opt(opt), device_scoring(opt, cpu).mat,
        ref_t_cap(opt, max(len(r) for r in reads.reads)))
    return dict(idx=idx, reads=reads, opt=opt, chains=chains, regs=regs)


def _chain_key(c):
    return (c.rid, c.is_alt, c.frac_rep, c.w, c.kept, c.first,
            tuple((s.rbeg, s.qbeg, s.len, s.score) for s in c.seeds))


def _reg_key(a):
    return (a.rb, a.re, a.qb, a.qe, a.score, a.truesc, a.w, a.seedcov,
            a.seedlen0, a.rid, a.frac_rep)


def _regions(regs):
    """``Regions`` -> per read its region keys."""
    rows = regs.compact().numpy()
    frac = rows[:, 2].copy().view(np.float64).tolist()
    flat = [tuple(r[:2]) + tuple(r[3:]) + (f,) for r, f in zip(rows.tolist(),
                                                              frac)]
    out, k = [], 0
    for n in regs.nregs.tolist():
        out.append(flat[k: k + n])
        k += n
    return out


def _jax_index(idx):
    """bwamem_tpu's index over the same pac and contig."""
    bns = j_build.Bntseq(l_pac=idx.bns.l_pac, anns=[j_build.BntAnn(
        offset=0, name="big", length=idx.bns.l_pac)])
    jidx = j_build.BwaIndex(bns=bns, pac=idx.pac, bwt=None)
    object.__setattr__(jidx, "_UNPACK_CACHE_MAX", 0)
    return jidx


def test_reads_reach_past_2_32(big):
    reads, idx = big["reads"], big["idx"]
    rbegs = [at for seeds in reads.seeds for _, _, ats in seeds for at in ats]
    assert all(len(s) >= 2 for s in reads.seeds)
    assert max(rbegs) >= 1 << 32 and min(reads.rb[::2]) >= 1 << 31
    assert all(rb >= 1 << 32 for rb in reads.rb[1::2])
    # every seed is an exact match of the read at its positions
    for q, seeds in zip(reads.reads, reads.seeds):
        for qb, ln, ats in seeds:
            for at in ats:
                assert np.array_equal(idx.get_seq(at, at + ln), q[qb: qb + ln])


@pytest.mark.parametrize("oracle", ("port", "jax"))
def test_chains_and_regions_match_the_oracles(big, oracle):
    """The plain versions' chains and regions of every read equal the host
    oracle's (the port's copy, or bwamem_tpu's own on the same pac)."""
    reads, opt = big["reads"], big["opt"]
    if oracle == "port":
        want = big_ref.oracle_regions(opt, big["idx"], reads, range(N_READS))
    else:
        want = big_ref.oracle_regions(opt, _jax_index(big["idx"]), reads,
                                      range(N_READS), j_chain, j_extend)
    lists, (ovf, _, _) = co.chain_lists(big["chains"])
    assert not ovf.any()
    assert [[_chain_key(c) for c in cl] for cl in lists] == [
        [_chain_key(c) for c in chains] for chains, _ in want]
    assert _regions(big["regs"]) == [[_reg_key(a) for a in regs]
                                     for _, regs in want]
    assert int(big["regs"].nregs.sum()) >= N_READS
    # regions and decoy chains on both strands, past 2^32
    rbs = [r[0] for rs in _regions(big["regs"]) for r in rs]
    assert max(rbs) >= 1 << 32 and min(rbs) < L_PAC
    assert any(len(cl) > 1 for cl in lists)
