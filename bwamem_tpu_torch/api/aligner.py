"""BwaMemAligner for the port: per-batch alignment front end.

Usage-pattern parity with BwaMemAligner.java, as the JAX package's aligner
(bwamem_tpu/api/aligner.py): construct on an open BwaMemIndex, tweak options
(the Java-style accessors), pick a PE-stats mode, call align_seqs on batches,
close (or use as a context manager).  One per thread.  The extension waves,
and optionally the seeding, the sampled-SA walks and the chaining (or, with
``device_pipeline``, everything from seeding to regions), run on an explicit
torch device.

Record assembly reproduces the reference's binary record semantics
(fmt_BAMish, jnibwa.c:43-97) at the Python object level, including the
internal-flag 0x10000 -> SAM 0x100 mapping and bwa's idiosyncratic outie
tlen rule (jnibwa.c:79-96).

Every batch goes through the port's ``align_regs_batch``; the JAX package's
shortcut that aligns the whole batch in host C++ is not in the port.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, TypeVar

import torch

from ..engine import pair as pair_mod
from ..engine.exec_ctx import HOST_FALLBACK_JOBS, ExecConfig
from ..engine.finalize import Aln, mark_primary_se, reorder_primary5
from ..engine.pipeline import align_regs_batch, reg2sam_records
from ..utils.encoding import seq_to_codes_batch
from .alignment import BAM_CIGAR_CHARS, BwaMemAlignment
from .exceptions import InvalidInputException
from .index import BwaMemIndex
from .options import MEM_F_PE, MEM_F_PRIMARY5, MemOptions
from .pestats import DO_NOT_INFER, BwaMemPairEndStats

T = TypeVar("T")
DEVICE_STAGES = ("seed", "sa_lookup", "chain")


def _aln_to_record(p: Aln, m: Optional[Aln]) -> BwaMemAlignment:
    """Engine record -> API record, mirroring fmt_BAMish + the Java parse
    (BwaMemAligner.java:215-311)."""
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
    return BwaMemAlignment(
        sam_flag=flag,
        ref_id=ref_id,
        ref_start=ref_start,
        ref_end=ref_end,
        seq_start=seq_start,
        seq_end=seq_end,
        map_qual=p.mapq,
        n_mismatches=nm,
        aligner_score=score,
        suboptimal_score=sub,
        cigar=cigar,
        md_tag=md,
        xa_tag=xa,
        mate_ref_id=mate_rid,
        mate_ref_start=mate_pos,
        template_len=tlen,
    )


class BwaMemAligner:
    def __init__(self, index: BwaMemIndex, options: Optional[MemOptions] = None,
                 *, device, min_device_jobs: int = HOST_FALLBACK_JOBS,
                 device_stages=(), device_pipeline: bool = False):
        """device: where the extension waves run ("cuda", "cuda:1", "cpu").
        A CUDA device with no card present raises; there is no fallback.
        min_device_jobs: waves with fewer jobs run on the host C++.
        device_stages: further stages to run on ``device``, by the JAX
        package's names: "seed" (the three seeding rounds of a batch in the
        seeding kernels), "sa_lookup" (every sampled-SA walk of a batch in
        one kernel call) and "chain" (mem_chain + chain_flt of every read
        in the chain kernels; with all three, seeds go from seeding to
        chaining without leaving the device).
        device_pipeline: the fused device path (the JAX package's field of
        that name): seeding, the walks, chaining and the whole chain
        extension run on ``device`` whatever ``device_stages`` says, and
        regions come back; only reads that a budget flags take the staged
        path (``engine.pipeline_device``)."""
        stages = set(device_stages)
        unknown = stages - set(DEVICE_STAGES)
        if unknown:
            raise ValueError(f"unknown device stages: {sorted(unknown)}")
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               "available")
        if not index.is_open():
            raise RuntimeError(
                "Can't create aligner: bwa-mem index has been closed"
            )
        self._index = index
        self.options = options.copy() if options else MemOptions()
        self._pe_stats: Optional[BwaMemPairEndStats] = None
        self._open = True
        self._exec_cfg = ExecConfig(device=dev, min_device_jobs=min_device_jobs,
                                    device_sa_lookup="sa_lookup" in stages,
                                    device_seed="seed" in stages,
                                    device_chain="chain" in stages,
                                    device_pipeline=bool(device_pipeline))

    # ------------------------------------------------------------ lifecycle

    def is_open(self) -> bool:
        return self._open

    def close(self) -> None:
        self._open = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def index(self) -> BwaMemIndex:
        return self._index

    # ------------------------------------------------------------- PE modes

    def align_pairs(self) -> None:
        """Interleaved paired alignment (BwaMemAligner.alignPairs, :73)."""
        self.options.flag |= MEM_F_PE

    def infer_pair_end_stats(self) -> None:
        self._pe_stats = None

    def dont_infer_pair_end_stats(self) -> None:
        self._pe_stats = DO_NOT_INFER

    def set_proper_pair_end_stats(self, stats: BwaMemPairEndStats) -> None:
        self._pe_stats = stats

    # -------------------------------------------------------------- aligning

    def align_seqs(self, sequences: Iterable[T],
                   func: Callable[[T], bytes] = lambda x: x,
                   ) -> List[List[BwaMemAlignment]]:
        """Align a batch; one result list per input sequence
        (BwaMemAligner.alignSeqs, :181-311)."""
        raw = self.align_seqs_raw([func(s) for s in sequences])
        return [[_aln_to_record(p, m) for p, m in per_read] for per_read in raw]

    def align_seqs_raw(self, sequences: List[bytes]):
        """Per read a list of (Aln, mate Aln | None) engine records."""
        if not self._open:
            raise RuntimeError("The aligner has been closed.")
        opt = self.options
        self._index.ref_index()
        try:
            eng = self._index._require()
            reads = seq_to_codes_batch(sequences)
            if opt.flag & MEM_F_PE:
                return self._align_pe(eng, opt, reads)
            return self._align_se(eng, opt, reads)
        finally:
            self._index.de_ref_index()

    def _align_se(self, eng, opt, reads):
        out = []
        regs_all = align_regs_batch(opt, eng, reads, self._exec_cfg)
        for i, (read, regs) in enumerate(zip(reads, regs_all)):
            mark_primary_se(opt, regs, i)
            if opt.flag & MEM_F_PRIMARY5:
                reorder_primary5(opt.T, regs)
            out.append([(a, None) for a in reg2sam_records(opt, eng, read, regs)])
        return out

    def _align_pe(self, eng, opt, reads):
        if len(reads) % 2:
            raise InvalidInputException(
                "paired alignment requires an even number of sequences"
            )
        regs = align_regs_batch(opt, eng, reads, self._exec_cfg)
        pes = self._resolve_pes(opt, eng, regs)
        out = []
        for i in range(len(reads) // 2):
            alns0, alns1 = pair_mod.sam_pe(
                opt, eng, pes, i, (reads[2 * i], reads[2 * i + 1]),
                [regs[2 * i], regs[2 * i + 1]],
            )
            m0 = alns0[0] if alns0 else None
            m1 = alns1[0] if alns1 else None
            out.append([(a, m1) for a in alns0])
            out.append([(a, m0) for a in alns1])
        return out

    def _resolve_pes(self, opt, eng, regs) -> List[pair_mod.PeStat]:
        """PE-stats mode resolution, mirroring the JNI marshalling
        (org_..._BwaMemIndex.c:21-40): caller stats fill slot 1 (FR) only."""
        if self._pe_stats is None:  # infer from the batch
            return pair_mod.pestat(opt, eng.idx.bns.l_pac, regs)
        pes = pair_mod.default_pes()
        s = self._pe_stats
        if not s.failed:
            pes[1] = pair_mod.PeStat(
                low=s.low, high=s.high, failed=0, avg=s.average, std=s.std
            )
        return pes

    # --------------------------------------------- Java-style option surface

    def get_opts_size(self) -> int:
        return len(self.options.pack())

    def get_expected_opts_size(self) -> int:
        return 168

    # Java-style aliases for the full accessor surface
    alignSeqs = align_seqs
    alignPairs = align_pairs
    inferPairEndStats = infer_pair_end_stats
    dontInferPairEndStats = dont_infer_pair_end_stats
    setProperPairEndStats = set_proper_pair_end_stats
    getOptsSize = get_opts_size
    getExpectedOptsSize = get_expected_opts_size

    def set_intra_ctg_options(self) -> None:
        self.options.set_intra_ctg()

    setIntraCtgOptions = set_intra_ctg_options


# Generate the ~40 Java-style option accessors (BwaMemAligner.java:46-138)
_OPTION_ACCESSORS = {
    "MatchScoreOption": "a",
    "MismatchPenaltyOption": "b",
    "DGapOpenPenaltyOption": "o_del",
    "DGapExtendPenaltyOption": "e_del",
    "IGapOpenPenaltyOption": "o_ins",
    "IGapExtendPenaltyOption": "e_ins",
    "UnpairedPenaltyOption": "pen_unpaired",
    "Clip5PenaltyOption": "pen_clip5",
    "Clip3PenaltyOption": "pen_clip3",
    "BandwidthOption": "w",
    "ZDropOption": "zdrop",
    "MaxMemIntvOption": "max_mem_intv",
    "OutputScoreThresholdOption": "T",
    "FlagOption": "flag",
    "MinSeedLengthOption": "min_seed_len",
    "MinChainWeightOption": "min_chain_weight",
    "MaxChainExtendOption": "max_chain_extend",
    "SplitFactorOption": "split_factor",
    "SplitWidthOption": "split_width",
    "MaxSeedOccurencesOption": "max_occ",
    "MaxChainGapOption": "max_chain_gap",
    "NThreadsOption": "n_threads",
    "ChunkSizeOption": "chunk_size",
    "MaskLevelOption": "mask_level",
    "DropRatioOption": "drop_ratio",
    "XADropRatio": "xa_drop_ratio",
    "MaskLevelRedunOption": "mask_level_redun",
    "MapQCoefLenOption": "mapq_coef_len",
    "MapQCoefFacOption": "mapq_coef_fac",
    "MaxInsOption": "max_ins",
    "MaxMateSWOption": "max_matesw",
    "MaxXAHitsOption": "max_xa_hits",
    "MaxXAHitsAltOption": "max_xa_hits_alt",
    "ScoringMatrixOption": "mat",
}


def _make_accessors():
    for jname, field in _OPTION_ACCESSORS.items():
        def getter(self, _f=field):
            return getattr(self.options, _f)

        def setter(self, value, _f=field):
            setattr(self.options, _f, value)
            if _f in ("a", "b"):
                self.options.refresh_matrix()

        setattr(BwaMemAligner, f"get{jname}", getter)
        setattr(BwaMemAligner, f"set{jname}", setter)


_make_accessors()
