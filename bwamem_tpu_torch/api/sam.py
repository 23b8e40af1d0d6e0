"""SAM text emission ([EXT] bwamem.c mem_aln2sam semantics).

The reference's JNI path bypasses SAM text (fmt_BAMish binary records), but
bwa-mem SAM equality is this framework's parity metric (BASELINE.md), so we
implement the full text path: flag fixing, hard-clip conversion for
supplementary alignments, reverse-strand SEQ/QUAL flipping, and the
NM/MD/AS/XS/XA tag block, byte-compatible with bwa mem 0.7.x output.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..engine.finalize import Aln
from ..utils.encoding import CODE_TO_BASE
from .options import MEM_F_SOFTCLIP, MemOptions

_FWD = "ACGTN"
_REV = "TGCAN"


def sam_header(contigs: Sequence, extra_pg: str = "") -> str:
    """@SQ/@PG header block."""
    lines = [f"@SQ\tSN:{a.name}\tLN:{a.length}" for a in contigs]
    pg = "@PG\tID:bwamem_tpu\tPN:bwamem_tpu\tVN:0.1"
    if extra_pg:
        pg += "\t" + extra_pg
    lines.append(pg)
    return "\n".join(lines) + "\n"


def aln2sam(
    opt: MemOptions,
    contigs: Sequence,
    name: str,
    seq_codes: np.ndarray,
    qual: Optional[str],
    p_in: Aln,
    which: int,
    m_in: Optional[Aln] = None,
    records: Optional[Sequence[Aln]] = None,
) -> str:
    """One SAM line for alignment `p_in` of the read (mem_aln2sam).

    ``records`` is the read's full output list (mem_aln2sam's ``list``/``n``);
    when given, the SA:Z tag is emitted for split/supplementary reporting
    exactly like the reference engine ([EXT] bwamem.c mem_aln2sam).
    """
    p = _copy(p_in)
    m = _copy(m_in) if m_in is not None else None
    l_seq = len(seq_codes)
    # flag fixing
    p.flag |= 0x1 if m else 0
    p.flag |= 0x4 if p.rid < 0 else 0
    p.flag |= 0x8 if (m and m.rid < 0) else 0
    if p.rid < 0 and m and m.rid >= 0:
        p.rid, p.pos, p.is_rev = m.rid, m.pos, m.is_rev
        p.cigar = []
    if m and m.rid < 0 and p.rid >= 0:
        m.rid, m.pos, m.is_rev = p.rid, p.pos, p.is_rev
        m.cigar = []
    p.flag |= 0x10 if p.is_rev else 0
    p.flag |= 0x20 if (m and m.is_rev) else 0

    out = [name, str((p.flag & 0xFFFF) | (0x100 if p.flag & 0x10000 else 0))]
    if p.rid >= 0:
        out.append(contigs[p.rid].name)
        out.append(str(p.pos + 1))
        out.append(str(p.mapq))
        if p.cigar:
            cig = []
            for op, ln in p.cigar:
                c = op
                if not (opt.flag & MEM_F_SOFTCLIP) and not p.is_alt and c in (3, 4):
                    c = 4 if which else 3  # hard-clip supplementary
                cig.append(f"{ln}{'MIDSH'[c]}")
            out.append("".join(cig))
        else:
            out.append("*")
    else:
        out.extend(["*", "0", "0", "*"])
    # mate columns
    if m and m.rid >= 0:
        out.append("=" if p.rid == m.rid else contigs[m.rid].name)
        out.append(str(m.pos + 1))
        if p.rid == m.rid and p.cigar and m.cigar:
            p0 = p.pos + (p.cigar_reflen() - 1 if p.is_rev else 0)
            p1 = m.pos + (m.cigar_reflen() - 1 if m.is_rev else 0)
            out.append(str(-(p0 - p1 + (1 if p0 > p1 else (-1 if p0 < p1 else 0)))))
        else:
            out.append("0")
    else:
        out.extend(["*", "0", "0"])
    # SEQ / QUAL
    if p.flag & 0x100:
        out.extend(["*", "*"])
    else:
        qb, qe = 0, l_seq
        clip_hard = (
            p.cigar and which and not (opt.flag & MEM_F_SOFTCLIP) and not p.is_alt
        )
        if not p.is_rev:
            if clip_hard:
                if p.cigar[0][0] in (3, 4):
                    qb += p.cigar[0][1]
                if p.cigar[-1][0] in (3, 4):
                    qe -= p.cigar[-1][1]
            out.append(
                CODE_TO_BASE[np.minimum(seq_codes[qb:qe], 4)].tobytes().decode()
            )
            out.append(qual[qb:qe] if qual else "*")
        else:
            if clip_hard:
                if p.cigar[0][0] in (3, 4):
                    qe -= p.cigar[0][1]
                if p.cigar[-1][0] in (3, 4):
                    qb += p.cigar[-1][1]
            sub = seq_codes[qb:qe]
            rc = np.where(sub < 4, 3 - sub, 4)[::-1]
            out.append("".join(_FWD[c] for c in rc))
            out.append(qual[qb:qe][::-1] if qual else "*")
    line = "\t".join(out)
    # tags
    if p.cigar:
        line += f"\tNM:i:{p.NM}\tMD:Z:{p.md}"
    if p.score >= 0:
        line += f"\tAS:i:{p.score}"
    if p.sub >= 0:
        line += f"\tXS:i:{max(p.sub, p.alt_sc)}"
    if not (p_in.flag & 0x100):  # not a shadowed multi-hit
        others = [
            r
            for i, r in enumerate(records or [])
            if i != which and not (r.flag & 0x100) and r.rid >= 0 and r.cigar
        ]
        if others:  # other primary hits -> SA:Z (split-alignment chain)
            sa = []
            for r in others:
                cig = "".join(f"{ln}{'MIDSH'[op]}" for op, ln in r.cigar)
                sa.append(
                    f"{contigs[r.rid].name},{r.pos + 1},{'+-'[r.is_rev]},"
                    f"{cig},{r.mapq},{r.NM};"
                )
            line += "\tSA:Z:" + "".join(sa)
        if p.alt_sc > 0:
            line += f"\tpa:f:{p.score / p.alt_sc:.3f}"
    if p.XA:
        line += f"\tXA:Z:{p.XA}"
    return line


def _copy(a: Aln) -> Aln:
    return Aln(
        pos=a.pos, rid=a.rid, flag=a.flag, is_rev=a.is_rev, is_alt=a.is_alt,
        mapq=a.mapq, NM=a.NM, cigar=list(a.cigar), md=a.md, score=a.score,
        sub=a.sub, alt_sc=a.alt_sc, XA=a.XA,
    )
