"""Alignment finalization ([EXT] bwamem.c second half + bwa.c helpers).

mem_sort_dedup_patch -> mem_mark_primary_se -> mem_approx_mapq_se ->
mem_reg2aln (bwa_gen_cigar2 CIGAR/NM/MD) -> per-read record list with the
same field content the reference's fmt_BAMish emits (jnibwa.c:43-97).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .options import MemOptions
from .extend import AlnReg, ksw_global2

MEM_MAPQ_COEF = 30.0
PATCH_MAX_R_BW = 0.05
PATCH_MIN_SC_RATIO = 0.90


@dataclass
class Aln:
    """[EXT] mem_aln_t: one output alignment record."""

    pos: int = -1  # 0-based, contig-local
    rid: int = -1
    flag: int = 0
    is_rev: int = 0
    is_alt: int = 0
    mapq: int = 0
    NM: int = -1
    cigar: List[tuple] = field(default_factory=list)  # (op, len), MIDSH coding
    md: str = ""
    score: int = 0
    sub: int = -1
    alt_sc: int = 0
    XA: Optional[str] = None

    def cigar_reflen(self) -> int:
        return sum(ln for op, ln in self.cigar if op == 0 or op == 2)

    def cigar_qlen(self) -> int:
        return sum(ln for op, ln in self.cigar if op in (0, 1, 3, 4))


def hash_64(key: int) -> int:
    """[EXT] hash_64 (Wang hash) — tie-break parity for primary marking."""
    mask = (1 << 64) - 1
    key = (key + (~(key << 32) & mask)) & mask
    key ^= key >> 22
    key = (key + (~(key << 13) & mask)) & mask
    key ^= key >> 8
    key = (key + (key << 3)) & mask
    key ^= key >> 15
    key = (key + (~(key << 27) & mask)) & mask
    key ^= key >> 31
    return key


def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    """[EXT] infer_bw."""
    if l1 == l2 and l1 * a - score < (q + r - a) << 1:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def gen_cigar2(
    opt: MemOptions,
    idx,
    w_: int,
    query: np.ndarray,
    rb: int,
    re: int,
):
    """[EXT] bwa_gen_cigar2: global aln of [rb,re) vs query -> (score, cigar,
    NM, MD).  Reverse-strand pairs are flipped so indels left-align."""
    l_pac = idx.bns.l_pac
    l_query = len(query)
    if l_query <= 0 or rb >= re or (rb < l_pac and re > l_pac):
        return 0, None, -1, ""
    rseq = idx.get_seq(rb, re)
    rlen = len(rseq)
    q = query
    if rb >= l_pac:  # flip both so indels go leftmost on the forward strand
        q = query[::-1].copy()
        rseq = rseq[::-1].copy()
    if l_query == re - rb and w_ == 0:
        # no gap possible; straight diagonal (vectorized score)
        cigar = [(0, l_query)]
        score = int(opt.mat5[rseq.astype(np.int64), q.astype(np.int64)].sum())
    else:
        max_sc = opt.mat[0]
        max_ins = int((((l_query + 1) >> 1) * max_sc - opt.o_ins) / opt.e_ins + 1.0)
        max_del = int((((l_query + 1) >> 1) * max_sc - opt.o_del) / opt.e_del + 1.0)
        max_gap = max(max(max_ins, max_del), 1)
        w = (max_gap + abs(rlen - l_query) + 1) >> 1
        w = min(w, w_)
        min_w = abs(rlen - l_query) + 3
        w = max(w, min_w)
        score, cigar = ksw_global2(
            q, rseq, opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w
        )
    # NM / MD over the (possibly flipped) sequences (M runs vectorized)
    int2base = "ACGTN" if rb < l_pac else "TGCAN"
    md = []
    x = y = u = 0
    n_mm = 0
    for k, (op, ln) in enumerate(cigar):
        if op == 0:  # match
            qs = q[x : x + ln]
            rs = rseq[y : y + ln]
            mism = np.nonzero(qs != rs)[0]
            n_mm += len(mism)
            prev = -1
            for i in mism.tolist():
                md.append(str(u + i - prev - 1))
                md.append(int2base[int(rs[i])])
                u = 0  # bwa_gen_cigar2 resets the match count per mismatch
                prev = i
            u = (u + ln) if len(mism) == 0 else (ln - 1 - int(mism[-1]))
            x += ln
            y += ln
        elif op == 2:  # deletion
            if 0 < k < len(cigar) - 1:  # MD only for interior deletions
                md.append(str(u))
                md.append("^")
                md.extend(int2base[int(rseq[y + i])] for i in range(ln))
                u = 0
            y += ln
            n_mm += ln
        elif op == 1:  # insertion
            x += ln
            n_mm += ln
    md.append(str(u))
    return score, cigar, n_mm, "".join(md)


def gen_cigar_retry(opt: MemOptions, idx, qslice: np.ndarray, rb: int, re: int,
                    w0: int, truesc: int):
    """mem_reg2aln's band-doubling retry loop around gen_cigar2.
    -> (score, cigar, NM, md)."""
    w2 = w0
    last_sc = -(1 << 30)
    i = 0
    while True:
        w2 = min(w2, opt.w << 2)
        score, cigar, NM, md = gen_cigar2(opt, idx, w2, qslice, rb, re)
        if score == last_sc or w2 == opt.w << 2:
            break
        last_sc = score
        w2 <<= 1
        i += 1
        if not (i < 3 and score < truesc - opt.a):
            break
    return score, cigar, NM, md


def sort_dedup_patch(
    opt: MemOptions, idx, query: Optional[np.ndarray], regs: List[AlnReg]
) -> List[AlnReg]:
    """[EXT] mem_sort_dedup_patch."""
    if len(regs) <= 1:
        return regs
    regs.sort(key=lambda r: r.re)  # mem_ars2: by end position
    for r in regs:
        r.n_comp = 1
    for i in range(1, len(regs)):
        p = regs[i]
        if p.rid != regs[i - 1].rid or p.rb >= regs[i - 1].re + opt.max_chain_gap:
            continue
        j = i - 1
        while j >= 0 and p.rid == regs[j].rid and p.rb < regs[j].re + opt.max_chain_gap:
            q = regs[j]
            j -= 1
            if q.qe == q.qb:
                continue  # excluded
            o_r = q.re - p.rb  # ref overlap (may be <= 0 within max_chain_gap)
            o_q = (q.qe - p.qb) if q.qb < p.qb else (p.qe - q.qb)
            m_r = min(q.re - q.rb, p.re - p.rb)
            m_q = min(q.qe - q.qb, p.qe - p.qb)
            # redundancy needs overlap on BOTH axes, strictly above the
            # mask_level_redun fraction ([EXT] mem_sort_dedup_patch); the
            # patch branch also runs for non-overlapping colinear hits
            if o_r > m_r * opt.mask_level_redun and o_q > m_q * opt.mask_level_redun:
                if p.score < q.score:
                    p.qe = p.qb
                    break
                else:
                    q.qe = q.qb
            elif q.rb < p.rb and query is not None:
                score, w = _patch_reg(opt, idx, query, q, p)
                if score > 0:
                    p.n_comp += q.n_comp + 1
                    p.seedcov = max(p.seedcov, q.seedcov)
                    p.sub = max(p.sub, q.sub)
                    p.csub = max(p.csub, q.csub)
                    p.qb, p.rb = q.qb, q.rb
                    p.truesc = p.score = score
                    p.w = w
                    q.qe = q.qb
    regs = [r for r in regs if r.qe > r.qb]
    # mem_ars: score desc, then rb asc, then qb asc
    regs.sort(key=lambda r: (-r.score, r.rb, r.qb))
    for i in range(1, len(regs)):
        if (
            regs[i].score == regs[i - 1].score
            and regs[i].rb == regs[i - 1].rb
            and regs[i].qb == regs[i - 1].qb
        ):
            regs[i].qe = regs[i].qb
    return [r for i, r in enumerate(regs) if i == 0 or r.qe > r.qb]


def _patch_reg(opt: MemOptions, idx, query: np.ndarray, a: AlnReg, b: AlnReg):
    """[EXT] mem_patch_reg: can regions a,b (a.rb <= b.rb) merge across a gap?"""
    l_pac = idx.bns.l_pac
    if a.rb < l_pac <= b.rb:
        return 0, 0
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return 0, 0  # not colinear
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs(
        (a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb)
    )
    if a.re < b.rb or a.qe < b.qb:  # no overlap
        if w > opt.w << 1 or r >= PATCH_MAX_R_BW:
            return 0, 0
    elif w > opt.w << 2 or r >= PATCH_MAX_R_BW * 2.0:
        return 0, 0
    w += max(a.w, b.w)
    w = min(w, opt.w << 2)
    score, _, _, _ = gen_cigar2(opt, idx, w, query[a.qb : b.qe], a.rb, b.re)
    q_s = int((b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb)) * (b.score + a.score) + 0.499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb)) * (b.score + a.score) + 0.499)
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return 0, 0
    return score, w


SECONDARY_INT_MAX = (1 << 31) - 1  # INT_MAX sentinel ([EXT] mem_mark_primary_se)


def mark_primary_se(opt: MemOptions, regs: List[AlnReg], read_id: int) -> int:
    """[EXT] mem_mark_primary_se; returns count of primary (non-ALT) regions.

    Sorts regs in place and fills sub/sub_n/secondary/secondary_all.  With
    ALT hits present, the second marking round runs over the non-ALT prefix
    only, ALT hits become unconditional secondaries (INT_MAX sentinel), and
    secondary_all is remapped through the re-sort so XA grouping still sees
    every shadowing relationship.
    """
    if not regs:
        return 0
    n = len(regs)
    n_pri = 0
    for i, r in enumerate(regs):
        r.sub = r.alt_sc = 0
        r.sub_n = 0
        r.secondary = r.secondary_all = -1
        r.hash = hash_64((read_id + i) & ((1 << 64) - 1))
        if not r.is_alt:
            n_pri += 1
    regs.sort(key=lambda r: (-r.score, r.is_alt, r.hash))  # mem_ars_hash
    _mark_primary_core(opt, regs)
    for i, r in enumerate(regs):
        r.secondary_all = i  # keep the rank in the first round
        if not r.is_alt and r.secondary >= 0 and regs[r.secondary].is_alt:
            r.alt_sc = regs[r.secondary].score
    if n_pri < n:  # ALT hits present: re-mark on the primary assembly only
        if n_pri > 0:
            regs.sort(key=lambda r: (r.is_alt, -r.score, r.hash))  # mem_ars_hash2
        z = [0] * n
        for i, r in enumerate(regs):
            z[r.secondary_all] = i  # old first-round rank -> new index
        for r in regs:
            if r.secondary >= 0:
                r.secondary_all = z[r.secondary]
                if r.is_alt:
                    r.secondary = SECONDARY_INT_MAX
            else:
                r.secondary_all = -1
        if n_pri > 0:
            for r in regs[:n_pri]:
                r.sub = 0
                r.secondary = -1
            _mark_primary_core(opt, regs[:n_pri])
    else:
        for r in regs:
            r.secondary_all = r.secondary
    return n_pri


def _mark_primary_core(opt: MemOptions, regs: List[AlnReg]) -> None:
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z = [0]
    for i in range(1, len(regs)):
        found = -1
        for k in z:
            b_max = max(regs[k].qb, regs[i].qb)
            e_min = min(regs[k].qe, regs[i].qe)
            if e_min > b_max:
                min_l = min(regs[i].qe - regs[i].qb, regs[k].qe - regs[k].qb)
                if e_min - b_max >= min_l * opt.mask_level:
                    if regs[k].sub == 0:
                        regs[k].sub = regs[i].score
                    if regs[k].score - regs[i].score <= tmp and (
                        regs[k].is_alt or not regs[i].is_alt
                    ):
                        regs[k].sub_n += 1
                    found = k
                    break
        if found < 0:
            z.append(i)
        else:
            regs[i].secondary = found


def approx_mapq_se(opt: MemOptions, a: AlnReg) -> int:
    """[EXT] mem_approx_mapq_se."""
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(a.csub, sub)
    if sub >= a.score:
        return 0
    length = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - float(length * opt.a - a.score) / (opt.a + opt.b) / length
    if a.score == 0:
        mapq = 0
    elif opt.mapq_coef_len > 0:
        tmp = 1.0 if length < opt.mapq_coef_len else opt.mapq_coef_fac / math.log(length)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499)
    else:
        mapq = int(MEM_MAPQ_COEF * (1.0 - float(sub) / a.score) * math.log(a.seedcov) + 0.499)
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    return int(mapq * (1.0 - a.frac_rep) + 0.499)


def reg2aln(
    opt: MemOptions, idx, qlen: int, query: np.ndarray, ar: Optional[AlnReg]
) -> Aln:
    """[EXT] mem_reg2aln: region -> positioned alignment with CIGAR/NM/MD."""
    a = Aln()
    if ar is None or ar.rb < 0 or ar.re < 0:
        a.rid = -1
        a.pos = -1
        a.flag |= 0x4
        return a
    qb, qe = ar.qb, ar.qe
    rb, re = ar.rb, ar.re
    a.mapq = approx_mapq_se(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    w2 = max(
        infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del),
        infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins, opt.e_ins),
    )
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    score, cigar, NM, md = gen_cigar_retry(
        opt, idx, query[qb:qe], rb, re, w2, ar.truesc
    )
    a.NM = NM
    a.md = md
    pos, is_rev = idx.bns.depos(rb if rb < idx.bns.l_pac else re - 1)
    a.is_rev = is_rev
    cigar = list(cigar) if cigar else []
    if cigar:  # squeeze out leading/trailing deletions
        if cigar[0][0] == 2:
            pos += cigar[0][1]
            cigar = cigar[1:]
        elif cigar[-1][0] == 2:
            cigar = cigar[:-1]
    if qb != 0 or qe != qlen:  # soft clips (op 3 in MIDSH coding)
        clip5 = qlen - qe if is_rev else qb
        clip3 = qb if is_rev else qlen - qe
        if clip5:
            cigar = [(3, clip5)] + cigar
        if clip3:
            cigar = cigar + [(3, clip3)]
    a.cigar = cigar
    a.rid = idx.bns.pos_to_rid(pos)
    assert a.rid == ar.rid, (a.rid, ar.rid)
    a.pos = pos - idx.bns.anns[a.rid].offset
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    a.is_alt = ar.is_alt
    a.alt_sc = ar.alt_sc
    return a
