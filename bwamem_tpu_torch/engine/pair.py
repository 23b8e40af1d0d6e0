"""Paired-end machinery ([EXT] bwamem_pair.c: mem_pestat, mem_pair,
mem_matesw, mem_sam_pe; ksw.c: ksw_align2 for mate rescue).

The PE-stats contract mirrors the JNI layer's marshalling
(org_..._BwaMemIndex.c:21-40): four orientation slots FF/FR/RF/RR; a
caller-provided BwaMemPairEndStats populates only slot 1 (FR), the rest stay
failed.  tlen reproduces bwa's idiosyncratic 5'/3'-delta rule faithfully
(jnibwa.c:83-95), since SAM equality is the metric.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..api.options import MEM_F_NOPAIRING, MEM_F_NO_RESCUE, MemOptions
from .extend import AlnReg
from .finalize import Aln, approx_mapq_se, hash_64, mark_primary_se, reg2aln
from .pipeline import Engine, gen_alt_xa, reg2sam_records, _fix_flags

MIN_RATIO = 0.8
MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0


@dataclass
class PeStat:
    """[EXT] mem_pestat_t (mirrored in Java by BwaMemPairEndStats)."""

    low: int = 0
    high: int = 0
    failed: int = 1
    avg: float = 0.0
    std: float = 0.0


def default_pes() -> List[PeStat]:
    return [PeStat() for _ in range(4)]


def raw_mapq(diff: int, a: int) -> int:
    return int(6.02 * diff / a + 0.499)


def infer_dir(l_pac: int, b1: int, b2: int) -> Tuple[int, int]:
    """[EXT] mem_infer_dir -> (dir 0=FF/1=FR/2=RF/3=RR, distance)."""
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), dist


def _cal_sub(opt: MemOptions, regs: List[AlnReg]) -> int:
    for j in range(1, len(regs)):
        b_max = max(regs[j].qb, regs[0].qb)
        e_min = min(regs[j].qe, regs[0].qe)
        if e_min > b_max:
            min_l = min(regs[j].qe - regs[j].qb, regs[0].qe - regs[0].qb)
            if e_min - b_max >= min_l * opt.mask_level:
                return regs[j].score
    return opt.min_seed_len * opt.a


def pestat(opt: MemOptions, l_pac: int, regs_pairs: List[List[AlnReg]]) -> List[PeStat]:
    """[EXT] mem_pestat: infer the insert-size distribution per orientation.

    regs_pairs is the flat per-read region list (read 2i and 2i+1 mated).
    """
    pes = default_pes()
    isize: List[List[int]] = [[], [], [], []]
    n = len(regs_pairs)
    for i in range(n >> 1):
        r0 = regs_pairs[i << 1]
        r1 = regs_pairs[i << 1 | 1]
        if not r0 or not r1:
            continue
        if _cal_sub(opt, r0) > MIN_RATIO * r0[0].score:
            continue
        if _cal_sub(opt, r1) > MIN_RATIO * r1[0].score:
            continue
        if r0[0].rid != r1[0].rid:
            continue
        d, dist = infer_dir(l_pac, r0[0].rb, r1[0].rb)
        if dist and dist <= opt.max_ins:
            isize[d].append(dist)
    for d in range(4):
        q = sorted(isize[d])
        r = pes[d]
        if len(q) < MIN_DIR_CNT:
            r.failed = 1
            continue
        r.failed = 0
        p25 = q[int(0.25 * len(q) + 0.499)]
        p50 = q[int(0.50 * len(q) + 0.499)]
        p75 = q[int(0.75 * len(q) + 0.499)]
        r.low = max(int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499), 1)
        r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
        vals = [x for x in q if r.low <= x <= r.high]
        r.avg = sum(vals) / len(vals)
        r.std = math.sqrt(sum((x - r.avg) ** 2 for x in vals) / len(vals))
        r.low = int(p25 - MAPPING_BOUND * (p75 - p25) + 0.499)
        r.high = int(p75 + MAPPING_BOUND * (p75 - p25) + 0.499)
        if r.low > r.avg - MAX_STDDEV * r.std:
            r.low = int(r.avg - MAX_STDDEV * r.std + 0.499)
        if r.high < r.avg + MAX_STDDEV * r.std:
            r.high = int(r.avg + MAX_STDDEV * r.std + 0.499)
        r.low = max(r.low, 1)
    mx = max(len(x) for x in isize)
    for d in range(4):
        if pes[d].failed == 0 and len(isize[d]) < mx * MIN_DIR_RATIO:
            pes[d].failed = 1
    return pes


# ----------------------------------------------------------- local SW (mate)


@dataclass
class SwHit:
    score: int = 0
    qb: int = -1
    qe: int = -1  # inclusive, bwa kswr_t convention
    tb: int = -1
    te: int = -1
    score2: int = 0
    te2: int = -1


def sw_local(
    qseq: np.ndarray,
    tseq: np.ndarray,
    mat: List[int],
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    minsc: int,
) -> SwHit:
    """Full local SW with end/start and suboptimal score ([EXT] ksw_align2).

    Vectorized per target row; the horizontal-gap (F) recurrence uses the
    prefix-max closed form, exact for affine gaps with o >= 0.
    """
    qlen, tlen = len(qseq), len(tseq)
    r = SwHit()
    if qlen == 0 or tlen == 0:
        return r
    mat5 = np.asarray(mat, dtype=np.int32).reshape(5, 5)
    qprof = mat5[:, qseq.astype(np.int64)]  # [5, qlen]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    jj = np.arange(qlen, dtype=np.int32)
    H, E, rowmax = _sw_forward(qprof, tseq, oe_del, e_del, oe_ins, e_ins, jj)
    # gmax / te / qe: first strict improvement scanning rows ascending
    gmax, te, qe = 0, -1, -1
    bscores: List[int] = []
    brows: List[int] = []
    for i in range(tlen):
        imax = int(rowmax[i])
        if imax >= minsc:
            if not brows or brows[-1] + 1 != i:
                bscores.append(imax)
                brows.append(i)
            elif bscores[-1] < imax:
                bscores[-1] = imax
                brows[-1] = i
        if imax > gmax:
            gmax, te = imax, i
    if gmax == 0:
        return r
    r.score = gmax
    r.te = te
    # recompute qe: argmax in row te
    Hrow = _sw_row(qprof, tseq, oe_del, e_del, oe_ins, e_ins, jj, te)
    r.qe = int(np.argmax(Hrow))
    # score2: best run-max at rows outside [te - qlen, te + qlen]
    low, high = te - qlen, te + qlen
    for sc, e in zip(bscores, brows):
        if (e < low or e > high) and sc > r.score2:
            r.score2, r.te2 = sc, e
    # start via reverse pass stopping at the known score
    rq = qseq[: r.qe + 1][::-1].copy()
    rt = tseq[: r.te + 1][::-1].copy()
    qprof_r = mat5[:, rq.astype(np.int64)]
    jr = np.arange(len(rq), dtype=np.int32)
    _, _, rmax_r = _sw_forward(qprof_r, rt, oe_del, e_del, oe_ins, e_ins, jr)
    for i in range(len(rt)):
        if int(rmax_r[i]) == gmax:
            Hr = _sw_row(qprof_r, rt, oe_del, e_del, oe_ins, e_ins, jr, i)
            jrev = int(np.argmax(Hr))
            r.tb = r.te - i
            r.qb = r.qe - jrev
            break
    return r


def _sw_forward(qprof, tseq, oe_del, e_del, oe_ins, e_ins, jj):
    qlen = qprof.shape[1]
    tlen = len(tseq)
    H = np.zeros(qlen, dtype=np.int32)
    E = np.zeros(qlen, dtype=np.int32)
    rowmax = np.zeros(tlen, dtype=np.int32)
    for i in range(tlen):
        H, E = _sw_step(qprof, int(tseq[i]), H, E, oe_del, e_del, oe_ins, e_ins, jj)
        rowmax[i] = H.max()
    return H, E, rowmax


def _sw_step(qprof, tc, Hprev, Eprev, oe_del, e_del, oe_ins, e_ins, jj):
    q = qprof[tc]
    Hdiag = np.empty_like(Hprev)
    Hdiag[0] = 0
    Hdiag[1:] = Hprev[:-1]
    M = Hdiag + q
    E = np.maximum(Eprev - e_del, Hprev - oe_del)
    E = np.maximum(E, 0)
    Hbase = np.maximum(np.maximum(M, E), 0)
    # F(j) = max_{k<j} Hbase(k) - oe_ins - (j-1-k) e_ins, via prefix max
    A = Hbase + jj * e_ins
    P = np.maximum.accumulate(A)
    F = np.empty_like(Hbase)
    F[0] = 0
    F[1:] = P[:-1] - oe_ins - (jj[1:] - 1) * e_ins
    F = np.maximum(F, 0)
    H = np.maximum(Hbase, F)
    return H, E


def _sw_row(qprof, tseq, oe_del, e_del, oe_ins, e_ins, jj, row):
    """Recompute H of a single row (for argmax extraction)."""
    qlen = qprof.shape[1]
    H = np.zeros(qlen, dtype=np.int32)
    E = np.zeros(qlen, dtype=np.int32)
    for i in range(row + 1):
        H, E = _sw_step(qprof, int(tseq[i]), H, E, oe_del, e_del, oe_ins, e_ins, jj)
    return H


# --------------------------------------------------------------- mate rescue


def matesw(
    opt: MemOptions,
    eng: Engine,
    pes: List[PeStat],
    a: AlnReg,
    mseq: np.ndarray,
    ma: List[AlnReg],
) -> int:
    """[EXT] mem_matesw: SW the mate into each plausible window."""
    l_pac = eng.idx.bns.l_pac
    l_ms = len(mseq)
    skip = [1 if pes[r].failed else 0 for r in range(4)]
    for reg in ma:
        r, dist = infer_dir(l_pac, a.rb, reg.rb)
        if not pes[r].failed and pes[r].low <= dist <= pes[r].high:
            skip[r] = 1
    if sum(skip) == 4:
        return 0
    n = 0
    for r in range(4):
        if skip[r]:
            continue
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        if is_rev:
            seq = np.where(mseq < 4, 3 - mseq, mseq)[::-1].copy()
        else:
            seq = mseq
        if not is_rev:
            rb = a.rb + pes[r].low if is_larger else a.rb - pes[r].high
            re = (a.rb + pes[r].high if is_larger else a.rb - pes[r].low) + l_ms
        else:
            rb = (a.rb + pes[r].low if is_larger else a.rb - pes[r].high) - l_ms
            re = a.rb + pes[r].high if is_larger else a.rb - pes[r].low
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        if rb >= re:
            continue
        # bns_fetch_seq clamps the window to the contig containing its
        # midpoint; mem_matesw then skips the SW unless that contig is a's
        # and the clamped window can still hold a seed ([EXT] bwamem_pair.c
        # mem_matesw / bntseq.c bns_fetch_seq)
        ref, rb, re, rid = eng.idx.fetch_seq(rb, (rb + re) >> 1, re)
        if rid != a.rid or re - rb < opt.min_seed_len:
            continue
        hit = sw_local(
            seq, ref, opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            opt.min_seed_len * opt.a,
        )
        if hit.score >= opt.min_seed_len and hit.qb >= 0:
            b = AlnReg()
            b.rid = a.rid
            b.is_alt = a.is_alt
            b.qb = l_ms - (hit.qe + 1) if is_rev else hit.qb
            b.qe = l_ms - hit.qb if is_rev else hit.qe + 1
            b.rb = (l_pac << 1) - (rb + hit.te + 1) if is_rev else rb + hit.tb
            b.re = (l_pac << 1) - (rb + hit.tb) if is_rev else rb + hit.te + 1
            b.score = hit.score
            b.truesc = hit.score
            b.csub = hit.score2
            b.secondary = -1
            b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
            # insert keeping ma sorted by score desc (bwa's manual insertion)
            pos = len(ma)
            for i, x in enumerate(ma):
                if x.score < b.score:
                    pos = i
                    break
            ma.insert(pos, b)
        n += 1
    return n


# -------------------------------------------------------------------- pairing


def mem_pair(
    opt: MemOptions,
    l_pac: int,
    pes: List[PeStat],
    regs: List[List[AlnReg]],
    pair_id: int,
    n_pri: List[int],
):
    """[EXT] mem_pair -> (score, sub, n_sub, z[2]) or (0, 0, 0, None)."""
    v = []  # (x, y) like pair64_t
    for r in range(2):
        for i in range(n_pri[r]):
            e = regs[r][i]
            x = e.rb if e.rb < l_pac else (l_pac << 1) - 1 - e.rb
            y = (e.score << 32) | (i << 2) | ((e.rb >= l_pac) << 1) | r
            v.append((x, y))
    v.sort()
    y_last = [-1, -1, -1, -1]
    u = []
    for i in range(len(v)):
        for r in range(2):
            d = (r << 1) | ((v[i][1] >> 1) & 1)
            if pes[d].failed:
                continue
            which = (r << 1) | (((v[i][1]) & 1) ^ 1)
            if y_last[which] < 0:
                continue
            for k in range(y_last[which], -1, -1):
                if (v[k][1] & 3) != which:
                    continue
                dist = v[i][0] - v[k][0]
                if dist > pes[d].high:
                    break
                if dist < pes[d].low:
                    continue
                ns = (dist - pes[d].avg) / pes[d].std
                q = int(
                    (v[i][1] >> 32)
                    + (v[k][1] >> 32)
                    + 0.721 * math.log(2.0 * math.erfc(abs(ns) * (0.5 ** 0.5))) * opt.a
                    + 0.499
                )
                q = max(q, 0)
                yy = (k << 32) | i
                u.append(((q << 32) | (hash_64(yy ^ (pair_id << 8)) & 0xFFFFFFFF), yy))
        y_last[v[i][1] & 3] = i
    if not u:
        return 0, 0, 0, None
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    u.sort()
    i = u[-1][1] >> 32
    k = u[-1][1] & 0xFFFFFFFF
    z = [0, 0]
    z[v[i][1] & 1] = (v[i][1] & 0xFFFFFFFF) >> 2
    z[v[k][1] & 1] = (v[k][1] & 0xFFFFFFFF) >> 2
    ret = u[-1][0] >> 32
    sub = (u[-2][0] >> 32) if len(u) > 1 else 0
    n_sub = sum(1 for x in u[:-1] if sub - (x[0] >> 32) <= tmp)
    return ret, sub, n_sub, z


def sam_pe(
    opt: MemOptions,
    eng: Engine,
    pes: List[PeStat],
    pair_id: int,
    seqs: Tuple[np.ndarray, np.ndarray],
    regs2: List[List[AlnReg]],
) -> Tuple[List[Aln], List[Aln]]:
    """[EXT] mem_sam_pe: full PE output for one read pair."""
    l_pac = eng.idx.bns.l_pac
    if not (opt.flag & MEM_F_NO_RESCUE):
        # mate rescue using near-best hits of each end
        cand = [
            [r for r in regs2[i] if regs2[i] and r.score >= regs2[i][0].score - opt.pen_unpaired]
            for i in range(2)
        ]
        for i in range(2):
            for j, b in enumerate(cand[i]):
                if j >= opt.max_matesw:
                    break
                matesw(opt, eng, pes, b, seqs[1 - i], regs2[1 - i])
    n_pri = [
        mark_primary_se(opt, regs2[0], (pair_id << 1) | 0),
        mark_primary_se(opt, regs2[1], (pair_id << 1) | 1),
    ]
    extra_flag = 1
    if not (opt.flag & MEM_F_NOPAIRING):
        paired = _try_pair_output(opt, eng, pes, pair_id, seqs, regs2, n_pri)
        if paired is not None:
            return paired
    # ------------------------------------------------- no_pairing fallback
    h: List[Aln] = []
    for i in range(2):
        which = None
        if regs2[i] and regs2[i][0].score >= opt.T:
            which = 0
        if which is not None:
            h.append(reg2aln(opt, eng.idx, len(seqs[i]), seqs[i], regs2[i][which]))
        else:
            h.append(reg2aln(opt, eng.idx, len(seqs[i]), seqs[i], None))
    if h[0].rid == h[1].rid and h[0].rid >= 0 and regs2[0] and regs2[1]:
        d, dist = infer_dir(l_pac, regs2[0][0].rb, regs2[1][0].rb)
        if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
            extra_flag |= 2
    out0 = reg2sam_records(opt, eng, seqs[0], regs2[0], 0x40 | extra_flag, h[1])
    out1 = reg2sam_records(opt, eng, seqs[1], regs2[1], 0x80 | extra_flag, h[0])
    return out0, out1


def _try_pair_output(opt, eng, pes, pair_id, seqs, regs2, n_pri):
    """The proper-pairing branch of mem_sam_pe; None -> fall through."""
    l_pac = eng.idx.bns.l_pac
    if not (n_pri[0] and n_pri[1]):
        return None
    o, subo, n_sub, z = mem_pair(opt, l_pac, pes, regs2, pair_id, n_pri)
    if o <= 0:
        return None
    # if either end still has multiple good primary hits, give up pairing
    for i in range(2):
        for j in range(1, n_pri[i]):
            if regs2[i][j].secondary < 0 and regs2[i][j].score >= opt.T:
                return None
    score_un = regs2[0][0].score + regs2[1][0].score - opt.pen_unpaired
    if o <= score_un:  # unpaired alignment preferred
        z = [0, 0]
        q_se = [approx_mapq_se(opt, regs2[0][0]), approx_mapq_se(opt, regs2[1][0])]
        extra_flag = 1
    else:
        subo = max(subo, score_un)
        q_pe = raw_mapq(o - subo, opt.a)
        if n_sub > 0:
            q_pe -= int(4.343 * math.log(n_sub + 1) + 0.499)
        q_pe = min(max(q_pe, 0), 60)
        q_pe = int(
            q_pe * (1.0 - 0.5 * (regs2[0][0].frac_rep + regs2[1][0].frac_rep)) + 0.499
        )
        q_se = [0, 0]
        c = [regs2[0][z[0]], regs2[1][z[1]]]
        for i in range(2):
            if c[i].secondary >= 0:
                c[i].secondary = -2
                q_se[i] = 0
            else:
                q_se[i] = approx_mapq_se(opt, c[i])
        q_se[0] = q_se[0] if q_se[0] > q_pe else min(q_pe, q_se[0] + 40)
        q_se[1] = q_se[1] if q_se[1] > q_pe else min(q_pe, q_se[1] + 40)
        q_se[0] = min(q_se[0], raw_mapq(c[0].score - c[0].csub, opt.a))
        q_se[1] = min(q_se[1], raw_mapq(c[1].score - c[1].csub, opt.a))
        extra_flag = 3
    h = []
    xa = [
        gen_alt_xa(opt, eng, regs2[i], len(seqs[i]), seqs[i])
        if not (opt.flag & 0x8)
        else [None] * len(regs2[i])
        for i in range(2)
    ]
    for i in range(2):
        ai = reg2aln(opt, eng.idx, len(seqs[i]), seqs[i], regs2[i][z[i]])
        ai.mapq = q_se[i]
        ai.flag |= (0x40 << i) | extra_flag
        ai.XA = xa[i][z[i]]
        h.append(ai)
    _fix_flags(h[0], h[1])
    _fix_flags(h[1], h[0])
    return [h[0]], [h[1]]
