"""The reference's per-read and per-pair entries: bwa-mem's
``mem_align1_core`` (seeds to deduplicated regions), ``mem_reg2sam`` and
``mem_sam_pe`` (records), and the record fields as the port's
``BwaMemAlignment`` carries them, computed on ``fm.RefIndex``.  The
functions are frozen copies of the port's host oracle (the per-read Python
engine that its tests hold record-equal to the JAX package and to bwa), so
that a change to the program cannot move the yardstick.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .chain import chain_flt, flt_chained_seeds, mem_chain
from .extend import AlnReg, chain2aln
from .finalize import Aln, mark_primary_se, reg2aln, sort_dedup_patch
from .options import MEM_F_ALL, MEM_F_NO_MULTI, MEM_F_PE, MemOptions
from .seed import collect_intv

BAM_CIGAR_CHARS = "MIDNSHP=XB"
RECORD_FIELDS = (
    "sam_flag", "ref_id", "ref_start", "ref_end", "seq_start", "seq_end",
    "map_qual", "n_mismatches", "aligner_score", "suboptimal_score", "cigar",
    "md_tag", "xa_tag", "mate_ref_id", "mate_ref_start", "template_len",
)


class Engine:
    """An index as both halves of the host engine see it."""

    def __init__(self, ref):
        self.idx = ref
        self.fm = ref


def align1_regs(opt: MemOptions, eng: Engine, query: np.ndarray) -> List[AlnReg]:
    """mem_align1_core: read codes -> deduplicated regions."""
    intervals = collect_intv(opt, eng.fm, query)
    eng.idx.work.intervals += len(intervals)
    return _regs_from_intervals(opt, eng, query, intervals)


def _regs_from_intervals(opt, eng, query, intervals):
    qlen = len(query)
    chains = mem_chain(opt, eng.fm, eng.idx.bns, qlen, intervals)
    chains = chain_flt(opt, chains)
    flt_chained_seeds(opt, eng.idx, qlen, query, chains)
    regs: List[AlnReg] = []
    for c in chains:
        chain2aln(opt, eng.idx, qlen, query, c, regs)
    regs = sort_dedup_patch(opt, eng.idx, query, regs)
    return _flag_alt_regs(eng.idx.bns, regs)



def _flag_alt_regs(bns, regs: List[AlnReg]) -> List[AlnReg]:
    """[EXT] mem_align1_core tail: regs on ALT contigs get is_alt=1."""
    anns = bns.anns
    for r in regs:
        if r.rid >= 0 and anns[r.rid].is_alt:
            r.is_alt = 1
    return regs


def gen_alt_xa(
    opt: MemOptions, eng: Engine, regs: List[AlnReg], qlen: int, query: np.ndarray
) -> List[Optional[str]]:
    """[EXT] mem_gen_alt: XA alternative-hit strings, indexed by primary reg.

    Returns a list parallel to regs; XA[k] is the alt-hit string for the
    primary region at index k (None when there are no alternates or the
    count exceeds max_XA_hits).
    """
    n = len(regs)
    xa: List[Optional[str]] = [None] * n

    def pri_idx(i: int) -> int:
        k = regs[i].secondary_all
        if k >= 0 and regs[i].score >= regs[k].score * opt.xa_drop_ratio:
            return k
        return -1

    cnt = [0] * n
    has_alt = [False] * n
    tot = 0
    for i in range(n):
        r = pri_idx(i)
        if r >= 0:
            cnt[r] += 1
            tot += 1
            if regs[i].is_alt:
                has_alt[r] = True
    if tot == 0:
        return xa
    parts: List[List[str]] = [[] for _ in range(n)]
    for i in range(n):
        r = pri_idx(i)
        if r < 0:
            continue
        if cnt[r] > opt.max_xa_hits_alt or (not has_alt[r] and cnt[r] > opt.max_xa_hits):
            continue
        t = reg2aln(opt, eng.idx, qlen, query, regs[i])
        cig = "".join(f"{ln}{'MIDSH'[op]}" for op, ln in t.cigar)
        parts[r].append(
            f"{eng.idx.bns.anns[t.rid].name},{'+-'[t.is_rev]}{t.pos + 1},{cig},{t.NM};"
        )
    for k in range(n):
        if parts[k]:
            xa[k] = "".join(parts[k])
    return xa


def reg2sam_records(
    opt: MemOptions,
    eng: Engine,
    query: np.ndarray,
    regs: List[AlnReg],
    extra_flag: int = 0,
    mate: Optional[Aln] = None,
) -> List[Aln]:
    """[EXT] mem_reg2sam: regions -> final per-read record list.

    mark_primary_se must already have run on regs.  Flag assembly mirrors
    mem_aln2sam's bit fixes, and the internal 0x10000 'secondary-style
    supplementary' bit maps to SAM 0x100 exactly as fmt_BAMish does
    (jnibwa.c:50-51).
    """
    qlen = len(query)
    xa = (
        gen_alt_xa(opt, eng, regs, qlen, query)
        if not (opt.flag & MEM_F_ALL)
        else [None] * len(regs)
    )
    out: List[Aln] = []
    for k, p in enumerate(regs):
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and (p.is_alt or not (opt.flag & MEM_F_ALL)):
            continue
        if (
            p.secondary >= 0
            and p.secondary < (1 << 30)
            and p.score < regs[p.secondary].score * opt.drop_ratio
        ):
            continue
        q = reg2aln(opt, eng.idx, qlen, query, p)
        q.XA = xa[k]
        q.flag |= extra_flag
        if p.secondary >= 0:
            q.sub = -1  # don't output subopt score for secondaries
        if out and p.secondary < 0:  # supplementary
            q.flag |= 0x10000 if (opt.flag & MEM_F_NO_MULTI) else 0x800
        if out and not p.is_alt and q.mapq > out[0].mapq:
            q.mapq = out[0].mapq
        out.append(q)
    if not out:
        t = reg2aln(opt, eng.idx, qlen, query, None)
        t.flag |= extra_flag
        out.append(t)
    # mem_aln2sam flag fixes for each record
    for q in out:
        _fix_flags(q, mate)
    return out


def _fix_flags(p: Aln, m: Optional[Aln]) -> None:
    """Flag assembly from mem_aln2sam ([EXT] bwamem.c)."""
    p.flag |= 0x1 if m is not None else 0
    p.flag |= 0x4 if p.rid < 0 else 0
    p.flag |= 0x8 if (m is not None and m.rid < 0) else 0
    if p.rid < 0 and m is not None and m.rid >= 0:  # copy mate pos to unmapped
        p.rid, p.pos, p.is_rev = m.rid, m.pos, m.is_rev
        p.cigar = []
    p.flag |= 0x10 if p.is_rev else 0
    p.flag |= 0x20 if (m is not None and m.is_rev) else 0



def aln_to_record(p: Aln, m: Optional[Aln]) -> tuple:
    """Engine record -> the API record's fields in ``RECORD_FIELDS`` order,
    as fmt_BAMish (jnibwa.c:43-97) and the Java parse
    (BwaMemAligner.java:215-311) make them."""
    flag = p.flag
    if flag & 0x10000:
        flag |= 0x100
    flag &= 0xFFFF
    if flag & 0x4:  # unmapped
        ref_id = ref_start = ref_end = seq_start = seq_end = -1
        nm = score = sub = 0
        cigar = ""
        md = xa = None
    else:
        ref_id = p.rid
        ref_start = p.pos
        # cigar in BAM MIDNSH coding, with correct N/H rendering
        cigar = "".join(f"{ln}{BAM_CIGAR_CHARS[op + 1 if op > 2 else op]}"
                        for op, ln in p.cigar)
        ref_len = sum(ln for op, ln in p.cigar if op in (0, 2))
        seq_start = p.cigar[0][1] if p.cigar and p.cigar[0][0] == 3 else 0
        seq_len = sum(ln for op, ln in p.cigar if op in (0, 1))
        if not p.cigar:
            seq_start = seq_len = 0
            ref_end = ref_start
        else:
            ref_end = ref_start + ref_len
        seq_end = seq_start + seq_len
        nm = p.NM
        score = p.score
        sub = p.sub
        md = p.md
        xa = p.XA
    # mate block only when paired with a mapped mate ((flag & 0x9) == 1)
    if (p.flag & 0x9) == 1 and m is not None:
        mate_rid = m.rid
        mate_pos = m.pos
        if (p.flag & 0x4) or p.rid != m.rid:
            tlen = 0
        else:
            p0 = p.pos + (p.cigar_reflen() - 1 if p.is_rev else 0)
            m0 = m.pos + (m.cigar_reflen() - 1 if m.is_rev else 0)
            tlen = m0 - p0 + (-1 if p0 > m0 else (1 if p0 < m0 else 0))
    else:
        mate_rid, mate_pos, tlen = -1, -1, 0
    return (flag, ref_id, ref_start, ref_end, seq_start, seq_end, p.mapq,
            nm, score, sub, cigar, md, xa, mate_rid, mate_pos, tlen)


def align_batch(opt: MemOptions, eng: Engine, reads: Sequence[np.ndarray],
                ids: Sequence[int], pes=None) -> List[List[tuple]]:
    """Records of reads (SE) or of pairs (PE, ``reads`` interleaved), read
    or pair ``j`` with the batch ordinal ``ids[j]`` (the input of bwa's hash
    tie-breaks); PE with ``pes`` (``pair.PeStat`` by orientation).  Per read
    a list of record field tuples."""
    from . import pair as pair_mod

    out: List[List[tuple]] = []
    if not opt.flag & MEM_F_PE:
        for q, rid in zip(reads, ids):
            regs = align1_regs(opt, eng, q)
            mark_primary_se(opt, regs, rid)
            out.append([aln_to_record(a, None)
                        for a in reg2sam_records(opt, eng, q, regs)])
        return out
    for j, pid in enumerate(ids):
        q0, q1 = reads[2 * j], reads[2 * j + 1]
        regs2 = [align1_regs(opt, eng, q0), align1_regs(opt, eng, q1)]
        a0, a1 = pair_mod.sam_pe(opt, eng, pes, pid, (q0, q1), regs2)
        m0 = a0[0] if a0 else None
        m1 = a1[0] if a1 else None
        out.append([aln_to_record(a, m1) for a in a0])
        out.append([aln_to_record(a, m0) for a in a1])
    return out
