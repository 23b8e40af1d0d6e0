"""Banded affine-gap Smith-Waterman ([EXT] ksw.c: ksw_extend2 / ksw_global2)
and chain extension ([EXT] bwamem.c: mem_chain2aln).

These are the reference engine's hot loops (SURVEY.md section 3.3).  This
module is the exact-semantics host oracle — every comparison and tie-break
mirrors the scalar definition of the SSE2 kernels, because CIGAR/score parity
depends on them.  The TPU wavefront kernel (ops/extend_pallas.py) is
validated cell-for-cell against this.

Provenance: ksw_extend2's loop structure/trackers follow upstream bwa's
ksw.c (MIT license, (c) 2011 by Attractive Chaos); parity with that exact
routine is the spec (see LICENSES.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..api.options import MemOptions
from .chain import Chain

MINUS_INF = -0x40000000
MAX_BAND_TRY = 2


@dataclass
class ExtendResult:
    score: int
    qle: int
    tle: int
    gtle: int
    gscore: int
    max_off: int


def ksw_extend2(
    qseq: np.ndarray,
    tseq: np.ndarray,
    mat: List[int],
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    w: int,
    end_bonus: int,
    zdrop: int,
    h0: int,
) -> ExtendResult:
    """Banded SW *extension* from a seed with score h0.

    Exact [EXT] ksw_extend2 semantics: adaptive band shrink, Z-drop early
    termination, gscore tracking of to-query-end extensions.
    """
    qlen, tlen = len(qseq), len(tseq)
    m = 5
    mat = np.asarray(mat, dtype=np.int64).reshape(m, m)
    qp = mat[:, qseq.astype(np.int64)]  # [5, qlen] query profile
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    eh_h = np.zeros(qlen + 1, dtype=np.int64)
    eh_e = np.zeros(qlen + 1, dtype=np.int64)
    # first row
    eh_h[0] = h0
    if qlen > 0:
        eh_h[1] = h0 - oe_ins if h0 > oe_ins else 0
        j = 2
        while j <= qlen and eh_h[j - 1] > e_ins:
            eh_h[j] = eh_h[j - 1] - e_ins
            j += 1
    # adjust w if too large
    max_sc = int(mat.max())
    max_ins = int((qlen * max_sc + end_bonus - o_ins) / e_ins + 1.0)
    w = min(w, max(max_ins, 1))
    max_del = int((qlen * max_sc + end_bonus - o_del) / e_del + 1.0)
    w = min(w, max(max_del, 1))
    # DP
    maxv, max_i, max_j = h0, -1, -1
    max_ie, gscore = -1, -1
    max_off = 0
    beg, end = 0, qlen
    for i in range(tlen):
        f = 0
        mrow = 0
        mj = -1
        q = qp[int(tseq[i])]
        if beg < i - w:
            beg = i - w
        if end > i + w + 1:
            end = i + w + 1
        if end > qlen:
            end = qlen
        if beg == 0:
            h1 = h0 - (o_del + e_del * (i + 1))
            if h1 < 0:
                h1 = 0
        else:
            h1 = 0
        for j in range(beg, end):
            # eh[j] = {H(i-1,j-1), E(i,j)}, f = F(i,j), h1 = H(i,j-1)
            M = int(eh_h[j])
            e = int(eh_e[j])
            eh_h[j] = h1
            M = M + int(q[j]) if M else 0  # can't extend from a zeroed cell
            h = M if M > e else e
            h = h if h > f else f
            h1 = h
            mj = mj if mrow > h else j
            mrow = mrow if mrow > h else h
            t = M - oe_del
            t = t if t > 0 else 0
            e -= e_del
            e = e if e > t else t
            eh_e[j] = e
            t = M - oe_ins
            t = t if t > 0 else 0
            f -= e_ins
            f = f if f > t else t
        eh_h[end] = h1
        eh_e[end] = 0
        if end == qlen:  # reached the end of the query
            if gscore <= h1:
                max_ie = i
                gscore = h1
        if mrow == 0:
            break
        if mrow > maxv:
            maxv, max_i, max_j = mrow, i, mj
            if max_off < abs(mj - i):
                max_off = abs(mj - i)
        elif zdrop > 0:
            if (i - max_i) > (mj - max_j):
                if maxv - mrow - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if maxv - mrow - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
        # shrink the band
        j = beg
        while j < end and eh_h[j] == 0 and eh_e[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and eh_h[j] == 0 and eh_e[j] == 0:
            j -= 1
        end = min(j + 2, qlen)
    return ExtendResult(
        score=int(maxv),
        qle=max_j + 1,
        tle=max_i + 1,
        gtle=max_ie + 1,
        gscore=int(gscore),
        max_off=int(max_off),
    )


def ksw_global2(
    qseq: np.ndarray,
    tseq: np.ndarray,
    mat: List[int],
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    w: int,
    want_cigar: bool = True,
):
    """Banded global (NW) alignment with traceback -> (score, cigar).

    cigar is a list of (op, len) with op 0=M, 1=I (query-only), 2=D
    (target-only).  Exact [EXT] ksw_global2 semantics including tie-breaks.
    """
    qlen, tlen = len(qseq), len(tseq)
    m = 5
    mat = np.asarray(mat, dtype=np.int64).reshape(m, m)
    qp = mat[:, qseq.astype(np.int64)]
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    n_col = qlen if qlen < 2 * w + 1 else 2 * w + 1
    z = np.zeros((tlen, n_col), dtype=np.uint8) if want_cigar else None
    eh_h = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    eh_e = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    eh_h[0] = 0
    eh_e[0] = MINUS_INF
    for j in range(1, min(qlen, w) + 1):
        eh_h[j] = -(o_ins + e_ins * j)
        eh_e[j] = MINUS_INF
    for i in range(tlen):
        f = MINUS_INF
        q = qp[int(tseq[i])]
        beg = i - w if i > w else 0
        end = i + w + 1 if i + w + 1 < qlen else qlen
        h1 = -(o_del + e_del * (i + 1)) if beg == 0 else MINUS_INF
        for j in range(beg, end):
            M = int(eh_h[j])
            e = int(eh_e[j])
            eh_h[j] = h1
            M += int(q[j])
            d = 0 if M >= e else 1
            h = M if M >= e else e
            d = d if h >= f else 2
            h = h if h >= f else f
            h1 = h
            t = M - oe_del
            e -= e_del
            d |= (1 << 2) if e > t else 0
            e = e if e > t else t
            eh_e[j] = e
            t = M - oe_ins
            f -= e_ins
            d |= (2 << 4) if f > t else 0
            f = f if f > t else t
            if z is not None:
                z[i, j - beg] = d
        eh_h[end] = h1
        eh_e[end] = MINUS_INF
    score = int(eh_h[qlen])
    if not want_cigar:
        return score, None
    # backtrack
    cigar: List[list] = []

    def push(op, ln):
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += ln
        else:
            cigar.append([op, ln])

    which = 0
    i = tlen - 1
    k = (i + w + 1 if i + w + 1 < qlen else qlen) - 1
    while i >= 0 and k >= 0:
        beg = i - w if i > w else 0
        which = (int(z[i, k - beg]) >> (which << 1)) & 3
        if which == 0:
            push(0, 1)
            i -= 1
            k -= 1
        elif which == 1:
            push(2, 1)
            i -= 1
        else:
            push(1, 1)
            k -= 1
    if i >= 0:
        push(2, i + 1)
    if k >= 0:
        push(1, k + 1)
    cigar.reverse()
    return score, [(op, ln) for op, ln in cigar]


@dataclass
class AlnReg:
    """[EXT] mem_alnreg_t."""

    rb: int = 0
    re: int = 0
    qb: int = 0
    qe: int = 0
    rid: int = -1
    score: int = 0
    truesc: int = 0
    sub: int = 0
    alt_sc: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    secondary_all: int = -1
    seedlen0: int = 0
    n_comp: int = 1
    is_alt: int = 0
    frac_rep: float = 0.0
    hash: int = 0


def chain2aln(
    opt: MemOptions,
    idx,  # BwaIndex
    qlen: int,
    query: np.ndarray,
    c: Chain,
    regs: List[AlnReg],
) -> None:
    """Extend a chain's seeds into alignment regions ([EXT] mem_chain2aln).

    Appends to regs in-place, preserving the reference engine's seed
    processing order and redundant-extension pruning.
    """
    if not c.seeds:
        return
    bns = idx.bns
    l_pac = bns.l_pac
    # max possible span
    rmax0, rmax1 = l_pac << 1, 0
    for t in c.seeds:
        b = t.rbeg - (t.qbeg + opt.max_gap(t.qbeg))
        e = t.rbeg + t.len + ((qlen - t.qbeg - t.len) + opt.max_gap(qlen - t.qbeg - t.len))
        rmax0 = min(rmax0, b)
        rmax1 = max(rmax1, e)
    rmax0 = max(rmax0, 0)
    rmax1 = min(rmax1, l_pac << 1)
    if rmax0 < l_pac < rmax1:  # crossing the strand boundary: pick one side
        if c.seeds[0].rbeg < l_pac:
            rmax1 = l_pac
        else:
            rmax0 = l_pac
    # clamp to the contig holding the first seed ([EXT] bns_fetch_seq)
    fwd_mid, is_rev = bns.depos(c.seeds[0].rbeg)
    rid = bns.pos_to_rid(fwd_mid)
    far_beg = bns.anns[rid].offset
    far_end = far_beg + bns.anns[rid].length
    if is_rev:
        far_beg, far_end = (l_pac << 1) - far_end, (l_pac << 1) - far_beg
    rmax0 = max(rmax0, far_beg)
    rmax1 = min(rmax1, far_end)
    rseq = idx.get_seq(rmax0, rmax1)

    # seeds by score asc; process from highest (ties: higher index first)
    srt = sorted(range(len(c.seeds)), key=lambda i: (c.seeds[i].score, i))
    srt_alive = [True] * len(srt)
    for k in range(len(srt) - 1, -1, -1):
        s = c.seeds[srt[k]]
        # has this seed's neighborhood already been extended?
        contained = False
        for p in regs:
            if (
                s.rbeg < p.rb
                or s.rbeg + s.len > p.re
                or s.qbeg < p.qb
                or s.qbeg + s.len > p.qe
            ):
                continue
            if s.len - p.seedlen0 > 0.1 * qlen:
                continue
            qd, rd = s.qbeg - p.qb, s.rbeg - p.rb
            w = min(opt.max_gap(min(qd, rd)), p.w)
            if qd - rd < w and rd - qd < w:
                contained = True
                break
            qd, rd = p.qe - (s.qbeg + s.len), p.re - (s.rbeg + s.len)
            w = min(opt.max_gap(min(qd, rd)), p.w)
            if qd - rd < w and rd - qd < w:
                contained = True
                break
        if contained:
            # confirm no overlapping same-chain seed suggests a different aln
            diff = False
            for i2 in range(k + 1, len(srt)):
                if not srt_alive[i2]:
                    continue
                t = c.seeds[srt[i2]]
                if t.len < s.len * 0.95:
                    continue
                if (
                    s.qbeg <= t.qbeg
                    and s.qbeg + s.len - t.qbeg >= s.len >> 2
                    and t.qbeg - s.qbeg != t.rbeg - s.rbeg
                ):
                    diff = True
                    break
                if (
                    t.qbeg <= s.qbeg
                    and t.qbeg + t.len - s.qbeg >= s.len >> 2
                    and s.qbeg - t.qbeg != s.rbeg - t.rbeg
                ):
                    diff = True
                    break
            if not diff:
                srt_alive[k] = False
                continue
        a = AlnReg()
        a.w = aw0 = aw1 = opt.w
        a.score = a.truesc = -1
        a.rid = c.rid
        if s.qbeg:  # left extension
            qs = query[: s.qbeg][::-1].copy()
            tmp = s.rbeg - rmax0
            rs = rseq[:tmp][::-1].copy()
            res = None
            for i2 in range(MAX_BAND_TRY):
                prev = a.score
                aw0 = opt.w << i2
                res = ksw_extend2(
                    qs, rs, opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                    aw0, opt.pen_clip5, opt.zdrop, s.len * opt.a,
                )
                a.score = res.score
                if a.score == prev or res.max_off < (aw0 >> 1) + (aw0 >> 2):
                    break
            if res.gscore <= 0 or res.gscore <= a.score - opt.pen_clip5:
                a.qb = s.qbeg - res.qle
                a.rb = s.rbeg - res.tle
                a.truesc = a.score
            else:
                a.qb = 0
                a.rb = s.rbeg - res.gtle
                a.truesc = res.gscore
        else:
            a.score = a.truesc = s.len * opt.a
            a.qb = 0
            a.rb = s.rbeg
        if s.qbeg + s.len != qlen:  # right extension
            sc0 = a.score
            qe = s.qbeg + s.len
            re_off = s.rbeg + s.len - rmax0
            res = None
            for i2 in range(MAX_BAND_TRY):
                prev = a.score
                aw1 = opt.w << i2
                res = ksw_extend2(
                    query[qe:], rseq[re_off:], opt.mat, opt.o_del, opt.e_del,
                    opt.o_ins, opt.e_ins, aw1, opt.pen_clip3, opt.zdrop, sc0,
                )
                a.score = res.score
                if a.score == prev or res.max_off < (aw1 >> 1) + (aw1 >> 2):
                    break
            if res.gscore <= 0 or res.gscore <= a.score - opt.pen_clip3:
                a.qe = qe + res.qle
                a.re = rmax0 + re_off + res.tle
                a.truesc += a.score - sc0
            else:
                a.qe = qlen
                a.re = rmax0 + re_off + res.gtle
                a.truesc += res.gscore - sc0
        else:
            a.qe = qlen
            a.re = s.rbeg + s.len
        a.seedcov = 0
        for t in c.seeds:
            if (
                t.qbeg >= a.qb
                and t.qbeg + t.len <= a.qe
                and t.rbeg >= a.rb
                and t.rbeg + t.len <= a.re
            ):
                a.seedcov += t.len
        a.w = max(aw0, aw1)
        a.seedlen0 = s.len
        a.frac_rep = c.frac_rep
        regs.append(a)
