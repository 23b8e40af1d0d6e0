"""Seed chaining ([EXT] bwamem.c: mem_chain, test_and_merge, mem_chain_flt).

Converts SMEM intervals into reference-anchored seeds (sampled-SA lookups,
at most max_occ occurrences per interval) and greedily merges them into
chains keyed by the first seed's reference start — the b-tree predecessor
lookup of the reference engine is a bisect over a sorted list here.  Chain
filtering reproduces the weight sort + overlap shadowing (kept codes 0/1/2/3)
that feeds mem_chain2aln.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List

import numpy as np

from .options import MemOptions
from .seed import SmemIntv


@dataclass
class Seed:
    """[EXT] mem_seed_t."""

    rbeg: int
    qbeg: int
    len: int
    score: int


@dataclass
class Chain:
    """[EXT] mem_chain_t."""

    rid: int
    seeds: List[Seed] = field(default_factory=list)
    is_alt: int = 0
    frac_rep: float = 0.0
    w: int = 0  # weight, set by chain_flt
    kept: int = 0
    first: int = -1

    @property
    def pos(self) -> int:
        return self.seeds[0].rbeg

    @property
    def qbeg(self) -> int:
        return self.seeds[0].qbeg

    @property
    def qend(self) -> int:
        s = self.seeds[-1]
        return s.qbeg + s.len


def _test_and_merge(
    opt: MemOptions, l_pac: int, c: Chain, p: Seed, seed_rid: int
) -> bool:
    """Try to append seed p to chain c ([EXT] test_and_merge).

    True = merged (or contained, i.e. dropped); False = request a new chain.
    """
    last = c.seeds[-1]
    qend = last.qbeg + last.len
    rend = last.rbeg + last.len
    if seed_rid != c.rid:
        return False
    if (
        p.qbeg >= c.seeds[0].qbeg
        and p.qbeg + p.len <= qend
        and p.rbeg >= c.seeds[0].rbeg
        and p.rbeg + p.len <= rend
    ):
        return True  # contained seed; do nothing
    if (last.rbeg < l_pac or c.seeds[0].rbeg < l_pac) and p.rbeg >= l_pac:
        return False  # different strand
    x = p.qbeg - last.qbeg  # non-negative (seeds sorted by qbeg)
    y = p.rbeg - last.rbeg
    if (
        y >= 0
        and x - y <= opt.w
        and y - x <= opt.w
        and x - last.len < opt.max_chain_gap
        and y - last.len < opt.max_chain_gap
    ):
        c.seeds.append(p)
        return True
    return False


def sample_ks(p: SmemIntv, max_occ: int) -> List[int]:
    """BWT rows sampled from an interval ([EXT] mem_chain's step logic)."""
    step = p.s // max_occ if p.s > max_occ else 1
    ks = []
    k = 0
    count = 0
    while k < p.s and count < max_occ:
        ks.append(p.x0 + k)
        k += step
        count += 1
    return ks


def mem_chain(
    opt: MemOptions,
    fm: "RefIndex",
    bns: "RefIndex",
    qlen: int,
    intervals: List[SmemIntv],
    rbegs_per_intv: List[np.ndarray] | None = None,
) -> List[Chain]:
    """Seeds -> chains; returns chains in reference-position order.

    rbegs_per_intv: optional precomputed suffix-array positions for each
    interval's sampled rows (the batched pipeline resolves them across all
    reads in one sa_lookup call).
    """
    if qlen < opt.min_seed_len:
        return []
    chains: List[Chain] = []  # kept sorted by .pos (b-tree stand-in)
    keys: List[int] = []
    for pi, p in enumerate(intervals):
        slen = p.qlen
        if rbegs_per_intv is not None:
            rbegs = rbegs_per_intv[pi]
        else:
            ks = sample_ks(p, opt.max_occ)
            if not ks:
                continue
            rbegs = fm.sa_lookup(np.asarray(ks, dtype=np.int64))
        for rbeg in rbegs.tolist():
            rid = bns.intv_to_rid(rbeg, rbeg + slen)
            if rid < 0:
                continue  # bridges contigs or the strand boundary
            seed = Seed(rbeg=rbeg, qbeg=p.qb, len=slen, score=slen)
            to_add = True
            if chains:
                i = bisect.bisect_right(keys, rbeg) - 1
                if i >= 0 and _test_and_merge(opt, bns.l_pac, chains[i], seed, rid):
                    to_add = False
            if to_add:
                c = Chain(rid=rid, seeds=[seed], is_alt=bns.anns[rid].is_alt)
                i = bisect.bisect_right(keys, rbeg)
                chains.insert(i, c)
                keys.insert(i, rbeg)
    # repetition fraction (bwamem.c mem_chain tail): fraction of the query
    # covered by over-occurring intervals, shared by every chain
    b = e = l_rep = 0
    for p in intervals:
        if p.s <= opt.max_occ:
            continue
        if p.qb > e:
            l_rep += e - b
            b, e = p.qb, p.qe
        else:
            e = max(e, p.qe)
    l_rep += e - b
    for c in chains:
        c.frac_rep = l_rep / qlen
    return chains


MEM_SHORT_EXT = 50
MEM_SHORT_LEN = 200
MEM_HSP_COEF = 1.1
MEM_MINSC_COEF = 5.5
MEM_SEEDSW_COEF = 0.05


def _seed_sw(opt: MemOptions, idx, qlen: int, query: np.ndarray, s: Seed) -> int:
    """[EXT] mem_seed_sw: local SW of a short seed's neighborhood, to judge
    whether the seed can support a decent alignment.  -1 = seed long enough
    to trust without SW."""
    from .pair import sw_local

    bns = idx.bns
    l_pac = bns.l_pac
    if s.len >= MEM_SHORT_LEN:
        return -1
    qb, qe = s.qbeg, s.qbeg + s.len
    rb, re = s.rbeg, s.rbeg + s.len
    mid = (rb + re) >> 1
    qb = max(qb - MEM_SHORT_EXT, 0)
    qe = min(qe + MEM_SHORT_EXT, qlen)
    rb = max(rb - MEM_SHORT_EXT, 0)
    re = min(re + MEM_SHORT_EXT, l_pac << 1)
    if rb < l_pac < re:
        if mid < l_pac:
            re = l_pac
        else:
            rb = l_pac
    # window guard is opt.w<<2, NOT MEM_SHORT_LEN ([EXT] mem_seed_sw: "the
    # seed seems good enough; no need to do SW")
    if qe - qb >= opt.w << 2 or re - rb >= opt.w << 2:
        return -1
    rseq, rb, re, _rid = idx.fetch_seq(rb, mid, re)
    hit = sw_local(
        query[qb:qe], rseq, opt.mat, opt.o_del, opt.e_del, opt.o_ins,
        opt.e_ins, (qe - qb) * opt.a,
    )
    return hit.score


def flt_chained_seeds(
    opt: MemOptions, idx, qlen: int, query: np.ndarray, chains: List[Chain]
) -> None:
    """[EXT] mem_flt_chained_seeds: drop poorly-scoring seeds inside chains.

    A no-op for reads shorter than ~700bp (the min_l > 0.05*l guard) —
    exactly like the reference; it matters for long-read chimeric input.
    """
    import math

    min_l = (
        MEM_HSP_COEF * opt.min_chain_weight
        if opt.min_chain_weight
        else MEM_MINSC_COEF * math.log(qlen)
    )
    min_hsp_score = int(opt.a * min_l + 0.499)
    if min_l > MEM_SEEDSW_COEF * qlen:
        return
    for c in chains:
        kept = []
        for s in c.seeds:
            score = _seed_sw(opt, idx, qlen, query, s)
            if score < 0 or score >= min_hsp_score:
                s.score = s.len * opt.a if score < 0 else score
                kept.append(s)
        c.seeds = kept


def chain_weight(c: Chain) -> int:
    """[EXT] mem_chain_weight: min(query coverage, reference coverage)."""
    w_q = 0
    end = 0
    for s in c.seeds:
        if s.qbeg >= end:
            w_q += s.len
        elif s.qbeg + s.len > end:
            w_q += s.qbeg + s.len - end
        end = max(end, s.qbeg + s.len)
    w_r = 0
    end = 0
    for s in c.seeds:
        if s.rbeg >= end:
            w_r += s.len
        elif s.rbeg + s.len > end:
            w_r += s.rbeg + s.len - end
        end = max(end, s.rbeg + s.len)
    return int(min(min(w_q, w_r), (1 << 30) - 1))


def chain_flt(opt: MemOptions, chains: List[Chain]) -> List[Chain]:
    """[EXT] mem_chain_flt: weight filter + overlap shadowing.

    kept codes: 3 = primary, 2 = kept with large overlap, 1 = shadowed mate
    retained for MAPQ accuracy, 0 = dropped.
    """
    if not chains:
        return []
    chains = [c for c in chains if (setattr(c, "w", chain_weight(c)) or True)]
    chains = [c for c in chains if c.w >= opt.min_chain_weight]
    if not chains:
        return []
    for c in chains:
        c.kept = 0
        c.first = -1
    # sort by weight desc; stable to keep reference-position order on ties
    chains.sort(key=lambda c: -c.w)
    chains[0].kept = 3
    kept_idx = [0]
    for i in range(1, len(chains)):
        ci = chains[i]
        large_ovlp = False
        broke = False
        for j in kept_idx:
            cj = chains[j]
            b_max = max(cj.qbeg, ci.qbeg)
            e_min = min(cj.qend, ci.qend)
            if e_min > b_max and not (cj.is_alt and not ci.is_alt):
                li = ci.qend - ci.qbeg
                lj = cj.qend - cj.qbeg
                min_l = min(li, lj)
                if e_min - b_max >= min_l * opt.mask_level and min_l < opt.max_chain_gap:
                    large_ovlp = True
                    if cj.first < 0:
                        cj.first = i  # first shadowed hit, for sub-score/MAPQ
                    if (
                        ci.w < cj.w * opt.drop_ratio
                        and cj.w - ci.w >= opt.min_seed_len << 1
                    ):
                        broke = True
                        break
        if not broke:
            kept_idx.append(i)
            ci.kept = 2 if large_ovlp else 3
    # retain the first shadowed chain of each kept chain (kept=1)
    for j in kept_idx:
        if chains[j].first >= 0:
            chains[chains[j].first].kept = max(chains[chains[j].first].kept, 1)
    out = [c for c in chains if c.kept > 0]
    # cap the number of fully-extended chains ([EXT] max_chain_extend): keep
    # at most that many kept==3/2 chains (default 1<<30 never trims)
    n_ext = 0
    trimmed = []
    for c in out:
        if c.kept >= 2:
            n_ext += 1
            if n_ext > opt.max_chain_extend:
                continue
        trimmed.append(c)
    return trimmed
