"""Binary wire-format codec: the reference's exact buffer layouts.

These are the de-facto contracts of the JNI boundary (SURVEY.md section
2.4), preserved byte-for-byte so a consumer of the reference's buffers can
interoperate directly:

  * input sequence buffer  [int32 nSeqs][bases... NUL]*   (parsed by
    jnibwa.c:200-212, built by BwaMemAligner.java:198-209)
  * output alignment buffer (fmt_BAMish, jnibwa.c:43-97; spec in
    org_..._BwaMemIndex.c:115-141; parsed BwaMemAligner.java:215-311)
  * contig-names buffer    [int32 n][int32 len, bytes]*   (jnibwa.c:174-195)

All little-endian (native order on every supported platform).
"""
from __future__ import annotations

import struct
from typing import List, Sequence

from ..engine.finalize import Aln
from .alignment import BwaMemAlignment


def encode_seqs(seqs: Sequence[bytes]) -> bytes:
    """[int32 nSeqs][seq bytes + NUL]* — the createAlignments input."""
    out = [struct.pack("<i", len(seqs))]
    for s in seqs:
        if b"\x00" in s:
            raise ValueError("sequence contains NUL")
        out.append(bytes(s))
        out.append(b"\x00")
    return b"".join(out)


def decode_seqs(buf: bytes) -> List[bytes]:
    (n,) = struct.unpack_from("<i", buf, 0)
    seqs = []
    pos = 4
    for _ in range(n):
        end = buf.index(b"\x00", pos)
        seqs.append(buf[pos:end])
        pos = end + 1
    return seqs


def encode_contig_names(names: Sequence[str]) -> bytes:
    """[int32 n][int32 len, name bytes]* (jnibwa_getRefContigNames)."""
    out = [struct.pack("<i", len(names))]
    for name in names:
        raw = name.encode()
        out.append(struct.pack("<i", len(raw)))
        out.append(raw)
    return b"".join(out)


def decode_contig_names(buf: bytes) -> List[str]:
    """The parse in BwaMemIndex.java:337-350."""
    (n,) = struct.unpack_from("<i", buf, 0)
    pos = 4
    names = []
    for _ in range(n):
        (ln,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        names.append(buf[pos : pos + ln].decode())
        pos += ln
    return names


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def encode_alignments(per_seq: Sequence[Sequence[Aln]]) -> bytes:
    """Emit the fmt_BAMish record stream for a batch of reads.

    Exact layout per jnibwa.c:43-97: per seq an int32 nAligns; per aln
    int32 flag<<16|mapq (internal 0x10000 -> SAM 0x100); if mapped: refId,
    pos, NM, AS, XS, nCigar, cigar words (len<<4|op, BAM MIDNSH coding),
    MD len + padded chars, XA len + padded chars; if paired with mapped
    mate: mate refId, mate pos, tlen (bwa's 5'/3' outie rule).
    """
    out = []
    for alns in per_seq:
        out.append(struct.pack("<i", len(alns)))
        # mate of record k is the primary of the other end, pre-resolved by
        # the caller into each Aln's mate fields; here we reproduce the
        # formatter given (p, m) pairs
        for p, m in alns:
            flag = p.flag
            if flag & 0x10000:
                flag |= 0x100
            out.append(struct.pack("<i", ((flag & 0xFFFF) << 16) | (p.mapq & 0xFF)))
            if not (p.flag & 0x4):
                out.append(
                    struct.pack(
                        "<5i", p.rid, p.pos, p.NM, p.score,
                        p.sub if p.sub is not None else -1,
                    )
                )
                out.append(struct.pack("<i", len(p.cigar)))
                for op, ln in p.cigar:
                    bam_op = op + 1 if op > 2 else op  # MIDSH -> MIDNSH
                    out.append(struct.pack("<I", (ln << 4) | bam_op))
                md = p.md.encode() if p.md else b""
                out.append(struct.pack("<i", len(md)))
                if md:
                    out.append(md.ljust(_pad4(len(md)), b"\x00"))
                xa = p.XA.encode() if p.XA else b""
                out.append(struct.pack("<i", len(xa)))
                if xa:
                    out.append(xa.ljust(_pad4(len(xa)), b"\x00"))
            if (p.flag & 0x9) == 0x1 and m is not None:
                if (p.flag & 0x4) or p.rid != m.rid:
                    tlen = 0
                else:
                    p0 = p.pos + (p.cigar_reflen() - 1 if p.is_rev else 0)
                    m0 = m.pos + (m.cigar_reflen() - 1 if m.is_rev else 0)
                    tlen = m0 - p0 + (-1 if p0 > m0 else (1 if p0 < m0 else 0))
                out.append(struct.pack("<3i", m.rid, m.pos, tlen))
    return b"".join(out)


def decode_alignments(buf: bytes, n_seqs: int) -> List[List[BwaMemAlignment]]:
    """The exact parse loop of BwaMemAligner.alignSeqs (java :215-311),
    with N/H CIGAR ops rendered correctly instead of '?'."""
    pos = 0
    out: List[List[BwaMemAlignment]] = []
    cigar_chars = "MIDNSHP=X"
    for _ in range(n_seqs):
        (n_aligns,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        alns = []
        for _ in range(n_aligns):
            (flag_mapq,) = struct.unpack_from("<i", buf, pos)
            pos += 4
            flags = (flag_mapq >> 16) & 0xFFFF
            mapq = flag_mapq & 0xFF
            if flags & 0x4:
                rid = rs = re_ = ss = se = -1
                nm = score = sub = 0
                cigar, md, xa = "", None, None
            else:
                rid, rs, nm, score, sub, n_cig = struct.unpack_from(
                    "<6i", buf, pos
                )
                pos += 24
                cig_parts = []
                ref_len = seq_len = 0
                ss = 0
                for ci in range(n_cig):
                    (lenop,) = struct.unpack_from("<I", buf, pos)
                    pos += 4
                    ln, op = lenop >> 4, lenop & 0xF
                    ch = cigar_chars[op]
                    cig_parts.append(f"{ln}{ch}")
                    if ci == 0 and ch in "SH":
                        ss = ln
                    if ch in "MDN":
                        ref_len += ln
                    if ch in "MI":
                        seq_len += ln
                cigar = "".join(cig_parts)
                re_ = rs + ref_len
                se = ss + seq_len
                (nmd,) = struct.unpack_from("<i", buf, pos)
                pos += 4
                md = buf[pos : pos + nmd].decode() if nmd else None
                pos += _pad4(nmd)
                (nxa,) = struct.unpack_from("<i", buf, pos)
                pos += 4
                xa = buf[pos : pos + nxa].decode() if nxa else None
                pos += _pad4(nxa)
            if (flags & 0x1) and not (flags & 0x8):
                mrid, mpos, tlen = struct.unpack_from("<3i", buf, pos)
                pos += 12
            else:
                mrid, mpos, tlen = -1, -1, 0
            alns.append(
                BwaMemAlignment(
                    sam_flag=flags, ref_id=rid, ref_start=rs, ref_end=re_,
                    seq_start=ss, seq_end=se, map_qual=mapq, n_mismatches=nm,
                    aligner_score=score, suboptimal_score=sub, cigar=cigar,
                    md_tag=md, xa_tag=xa, mate_ref_id=mrid,
                    mate_ref_start=mpos, template_len=tlen,
                )
            )
        out.append(alns)
    return out
