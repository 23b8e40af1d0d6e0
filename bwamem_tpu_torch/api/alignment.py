"""Immutable alignment result record.

Field-for-field parity with the reference's BwaMemAlignment
(BwaMemAlignment.java:9-24): samFlag, refId, refStart/End, seqStart/End,
mapQual, NM, AS, XS, cigar, MD, XA, mate info, template length.

Deliberate improvement (SURVEY.md section 2.4): CIGAR strings render N and H
correctly instead of '?' (the reference's decode table
"MID?S???????????", BwaMemAligner.java:256, garbles ops 3 and 5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

BAM_CIGAR_CHARS = "MIDNSHP=X"


@dataclass(frozen=True)
class BwaMemAlignment:
    sam_flag: int
    ref_id: int
    ref_start: int
    ref_end: int
    seq_start: int
    seq_end: int
    map_qual: int
    n_mismatches: int
    aligner_score: int
    suboptimal_score: int
    cigar: str
    md_tag: Optional[str]
    xa_tag: Optional[str]
    mate_ref_id: int
    mate_ref_start: int
    template_len: int

    # Java-style accessors (BwaMemAlignment.java getters) for drop-in reads
    def getSamFlag(self) -> int:
        return self.sam_flag

    def getRefId(self) -> int:
        return self.ref_id

    def getRefStart(self) -> int:
        return self.ref_start

    def getRefEnd(self) -> int:
        return self.ref_end

    def getSeqStart(self) -> int:
        return self.seq_start

    def getSeqEnd(self) -> int:
        return self.seq_end

    def getMapQual(self) -> int:
        return self.map_qual

    def getNMismatches(self) -> int:
        return self.n_mismatches

    def getAlignerScore(self) -> int:
        return self.aligner_score

    def getSuboptimalScore(self) -> int:
        return self.suboptimal_score

    def getCigar(self) -> str:
        return self.cigar

    def getMDTag(self) -> Optional[str]:
        return self.md_tag

    def getXATag(self) -> Optional[str]:
        return self.xa_tag

    def getMateRefId(self) -> int:
        return self.mate_ref_id

    def getMateRefStart(self) -> int:
        return self.mate_ref_start

    def getTemplateLen(self) -> int:
        return self.template_len
