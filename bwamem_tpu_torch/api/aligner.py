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

Routes, as the JAX package's aligner takes them:

* the whole-batch host route: ``device="cpu"`` with no ``device_stages``
  and no ``device_pipeline`` aligns the batch from seeds to records in one
  host C++ call (``engine.native_pipeline.pipeline_batch_arrays``), the
  reference's shortcut when no device stage is asked for;
* every other route (``device="cuda"``, where the extension waves are on the
  card; any ``device_stages``; ``device_pipeline``) makes the batch's
  regions by ``engine.pipeline.align_regs_raw`` and hands them, before
  dedup, to the host C++ tail (``native_pipeline.tail_batch_arrays``):
  dedup, pairing with mate rescue, MAPQ and the records, timed as the
  ``native_tail`` stage.  On a card a tail library that does not build or
  load raises;
* on the CPU only, where the tail library is not available, the Python tail
  (``python_tail``: ``mark_primary_se``, ``pair.sam_pe``,
  ``reg2sam_records``) on ``align_regs_batch``'s regions.  The tests call it
  as the oracle of the C++ tail.

``align_seqs`` assembles its records from the C++ tail's flat arrays
(``_records_fast``); ``align_seqs_raw`` builds ``Aln`` lists from them
(``native_pipeline.records_from_arrays``), and ``align_seqs_packed`` encodes
those in the reference's binary layout (``api/wire.py``).  Each batch of
``align_seqs``/``align_seqs_raw`` runs under ``utils.metrics.batch_scope``
(the ``BWAMEM_TPU_METRICS`` dump and the ``BWAMEM_TPU_TRACE`` profile) and
counts ``batches``, ``reads`` and ``records``.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, TypeVar

import numpy as np
import torch

from ..engine import native_pipeline
from ..engine import pair as pair_mod
from ..engine.exec_ctx import HOST_FALLBACK_JOBS, ExecConfig, mesh_exec
from ..engine.finalize import Aln, mark_primary_se, reorder_primary5
from ..engine.pipeline import (align_regs_batch, align_regs_raw,
                               native_pipeline_ok, native_seed_sa,
                               reg2sam_records)
from ..utils import metrics as _metrics
from ..utils.encoding import seq_to_codes_batch
from ..utils.timers import TIMERS
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


def _records_fast(
    n_reads: int, rows: np.ndarray, cig: np.ndarray, sbuf: bytes, is_pe: bool
) -> List[List[BwaMemAlignment]]:
    """Flat native record arrays -> BwaMemAlignment lists, vectorized.

    Produces exactly what _aln_to_record(records_from_arrays(...)) would —
    the fmt_BAMish semantics (flag 0x10000->0x100 mapping, outie tlen,
    jnibwa.c:43-97) computed column-wise instead of per object."""
    out: List[List[BwaMemAlignment]] = [[] for _ in range(n_reads)]
    nr = rows.shape[0]
    if nr == 0:
        return out
    text = sbuf.decode("latin-1")
    ridx = rows[:, 0]
    flag_i = rows[:, 1]
    flag = np.where(flag_i & 0x10000, flag_i | 0x100, flag_i) & 0xFFFF
    mapped = (flag & 0x4) == 0
    reflen = rows[:, 20]
    ref_id = np.where(mapped, rows[:, 2], -1)
    ref_start = np.where(mapped, rows[:, 3], -1)
    ref_end = np.where(mapped, rows[:, 3] + reflen, -1)
    seq_start = np.where(mapped, rows[:, 21], -1)
    seq_end = np.where(mapped, rows[:, 21] + rows[:, 22], -1)
    nm = np.where(mapped, rows[:, 7], 0)
    score = np.where(mapped, rows[:, 8], 0)
    sub = np.where(mapped, rows[:, 9], 0)
    # mate block only when paired with a mapped mate ((flag & 0x9) == 1);
    # the mate's representative is its first (primary) record
    counts = np.bincount(ridx, minlength=n_reads)
    starts = np.zeros(n_reads, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    if is_pe:
        mate_read = (ridx ^ 1).astype(np.int64)
        has_mate = ((flag_i & 0x9) == 1) & (counts[mate_read] > 0)
        m_idx = starts[mate_read]
        m_rid = rows[m_idx, 2]
        m_pos = rows[m_idx, 3]
        mate_rid = np.where(has_mate, m_rid, -1)
        mate_pos = np.where(has_mate, m_pos, -1)
        p0 = rows[:, 3] + np.where(rows[:, 4] != 0, reflen - 1, 0)
        m_reflen = rows[m_idx, 20]
        m0 = m_pos + np.where(rows[m_idx, 4] != 0, m_reflen - 1, 0)
        tlen = m0 - p0 + np.sign(m0 - p0)
        tlen = np.where(
            has_mate & mapped & (rows[:, 2] == m_rid), tlen, 0
        )
    else:
        mate_rid = mate_pos = np.full(nr, -1, dtype=np.int64)
        tlen = np.zeros(nr, dtype=np.int64)
    cs_off = rows[:, 18].tolist()
    cs_len = rows[:, 19].tolist()
    md_off = rows[:, 13].tolist()
    md_len = rows[:, 14].tolist()
    xa_off = rows[:, 15].tolist()
    xa_len = rows[:, 16].tolist()
    has_xa = rows[:, 17].tolist()
    cols = list(
        zip(
            flag.tolist(), ref_id.tolist(), ref_start.tolist(),
            ref_end.tolist(), seq_start.tolist(), seq_end.tolist(),
            rows[:, 6].tolist(), nm.tolist(), score.tolist(), sub.tolist(),
            mate_rid.tolist(), mate_pos.tolist(), tlen.tolist(),
        )
    )
    mapped_l = mapped.tolist()
    ridx_l = ridx.tolist()
    new = object.__new__
    cls = BwaMemAlignment
    for k in range(nr):
        (fl, rid, rs, re_, ss, se, mq, nmv, sc, sb, mrid, mpos, tl) = cols[k]
        if mapped_l[k]:
            co = cs_off[k]
            cigar = text[co : co + cs_len[k]]
            mo = md_off[k]
            md = text[mo : mo + md_len[k]]
            if has_xa[k]:
                xo = xa_off[k]
                xa = text[xo : xo + xa_len[k]]
            else:
                xa = None
        else:
            cigar = ""
            md = xa = None
        a = new(cls)
        a.__dict__.update(
            sam_flag=fl, ref_id=rid, ref_start=rs, ref_end=re_,
            seq_start=ss, seq_end=se, map_qual=mq, n_mismatches=nmv,
            aligner_score=sc, suboptimal_score=sb, cigar=cigar, md_tag=md,
            xa_tag=xa, mate_ref_id=mrid, mate_ref_start=mpos,
            template_len=tl,
        )
        out[ridx_l[k]].append(a)
    return out


def resolve_pes(opt, eng, regs, pe_stats) -> List[pair_mod.PeStat]:
    """PE-stats mode resolution, mirroring the JNI marshalling
    (org_..._BwaMemIndex.c:21-40): ``pe_stats`` None infers from the
    batch's deduplicated ``regs``; caller stats (or ``DO_NOT_INFER``, which
    is failed) fill slot 1 (FR) only."""
    if pe_stats is None:  # infer from the batch
        return pair_mod.pestat(opt, eng.idx.bns.l_pac, regs)
    pes = pair_mod.default_pes()
    if not pe_stats.failed:
        pes[1] = pair_mod.PeStat(low=pe_stats.low, high=pe_stats.high,
                                 failed=0, avg=pe_stats.average,
                                 std=pe_stats.std)
    return pes


def python_tail(opt, eng, reads, regs, pe_stats=None, id_base: int = 0,
                id_stride: int = 1):
    """The Python tail on deduplicated regions (``align_regs_batch``'s):
    SE primary marking and records, or PE statistics (``pe_stats`` as
    ``resolve_pes`` takes it), pairing with mate rescue and records.  Per
    read a list of (Aln, mate Aln | None).  The oracle of the C++ tail, and
    the route on the CPU where the tail library is not available.  Read
    (SE) or pair (PE) ``i`` has the ordinal ``id_base + i * id_stride``,
    the input of the hash tie-breaks, as the C++ takes them."""
    out = []
    if not opt.flag & MEM_F_PE:
        for i, (read, r) in enumerate(zip(reads, regs)):
            mark_primary_se(opt, r, id_base + i * id_stride)
            if opt.flag & MEM_F_PRIMARY5:
                reorder_primary5(opt.T, r)
            out.append([(a, None) for a in reg2sam_records(opt, eng, read, r)])
        return out
    pes = resolve_pes(opt, eng, regs, pe_stats)
    for i in range(len(reads) // 2):
        alns0, alns1 = pair_mod.sam_pe(
            opt, eng, pes, id_base + i * id_stride,
            (reads[2 * i], reads[2 * i + 1]),
            [regs[2 * i], regs[2 * i + 1]],
        )
        out.extend(_with_mates(alns0, alns1))
    return out


def _with_mates(alns0, alns1):
    """One pair's two record lists, each record beside its mate's first."""
    m0 = alns0[0] if alns0 else None
    m1 = alns1[0] if alns1 else None
    return [[(a, m1) for a in alns0], [(a, m0) for a in alns1]]


class BwaMemAligner:
    def __init__(self, index: BwaMemIndex, options: Optional[MemOptions] = None,
                 *, device=None, min_device_jobs: int = HOST_FALLBACK_JOBS,
                 device_stages=(), device_pipeline: Optional[bool] = None,
                 mesh=None):
        """device: where the extension waves run ("cuda", the default,
        "cuda:1", "cpu").  A CUDA device with no card present raises; there
        is no fallback.  ``device="cpu"`` with no ``device_stages`` is the
        whole-batch host route.
        mesh: a ``parallel.mesh.Mesh`` (``make_mesh``) to align over several
        devices (``engine.exec_ctx.mesh_exec``): with ``device_pipeline``
        the fused path runs a sub-batch of reads on each mesh device;
        otherwise the extension waves are split over the mesh by jobs and
        the ``device_stages`` by reads.  ``device`` is then the mesh's first
        device (another raises).  The records are the single-device
        route's.
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
        path (``engine.pipeline_device``).  None (the default) takes it on
        a CUDA device and not on the CPU; False keeps a card aligner on the
        extension waves (and ``device_stages``)."""
        stages = set(device_stages)
        unknown = stages - set(DEVICE_STAGES)
        if unknown:
            raise ValueError(f"unknown device stages: {sorted(unknown)}")
        if mesh is not None:
            dev = mesh.flat[0]
            if device is not None and torch.device(device) != dev:
                raise ValueError(f"device {device!r} is not the mesh's first "
                                 f"device {dev}")
        else:
            dev = torch.device("cuda" if device is None else device)
        if device_pipeline is None:
            device_pipeline = dev.type == "cuda"
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
        if mesh is not None:
            self._exec_cfg = mesh_exec(mesh, stages, min_device_jobs,
                                       bool(device_pipeline))
        else:
            self._exec_cfg = ExecConfig(
                device=dev, min_device_jobs=min_device_jobs,
                device_sa_lookup="sa_lookup" in stages,
                device_seed="seed" in stages, device_chain="chain" in stages,
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
                   func: Callable[[T], bytes] = lambda x: x, *,
                   id_base: int = 0) -> List[List[BwaMemAlignment]]:
        """Align a batch; one result list per input sequence
        (BwaMemAligner.alignSeqs, :181-311).  ``id_base``: the ordinal of
        the first read (SE) or pair (PE), the input of the hash
        tie-breaks, for a caller that aligns one shard of a larger batch
        (``parallel.distributed.align_shard``)."""
        with _metrics.batch_scope():
            with TIMERS.stage("encode"):
                seqs = [func(s) for s in sequences]
            fast = self._align_seqs_fast(seqs, id_base)
            if fast is not None:
                return fast
            with TIMERS.stage("encode"):
                reads = seq_to_codes_batch(seqs)
            raw = self._align_codes_raw(reads, id_base)
            return [[_aln_to_record(p, m) for p, m in per_read]
                    for per_read in raw]

    def _align_seqs_fast(self, seqs: List[bytes], id_base: int = 0):
        """Vectorized record assembly over the C++ tail's flat arrays (the
        whole-batch route's or ``bwamem_tail_batch``'s), the same records as
        the Aln path.  Returns None when only the Python tail can serve this
        batch (on the CPU, without the tail library)."""
        if not self._open:
            raise RuntimeError("The aligner has been closed.")
        opt = self.options
        is_pe = bool(opt.flag & MEM_F_PE)
        if is_pe and len(seqs) % 2:
            raise InvalidInputException(
                "paired alignment requires an even number of sequences"
            )
        if self._python_tail_only():
            return None
        self._index.ref_index()
        try:
            eng = self._index._require()
            with TIMERS.stage("encode"):
                reads = seq_to_codes_batch(seqs)
            arrays = self._native_arrays(eng, opt, reads, is_pe,
                                         id_base=id_base)
            with TIMERS.stage("records"):
                out = _records_fast(len(reads), *arrays, is_pe=is_pe)
            _metrics.count("batches")
            _metrics.count("reads", len(reads))
            _metrics.count("records", sum(len(r) for r in out))
            return out
        finally:
            self._index.de_ref_index()

    def align_seqs_raw(self, sequences: List[bytes]):
        """Per read a list of (Aln, mate Aln | None) engine records — the
        substrate of the object API and of the binary wire codec
        (api/wire.py)."""
        if not self._open:
            raise RuntimeError("The aligner has been closed.")
        return self._align_codes_raw(seq_to_codes_batch(sequences))

    def align_seqs_packed(self, seqs_buf: bytes) -> bytes:
        """Binary in, binary out: the reference's createAlignments contract
        ([int32 n][seq NUL]* -> fmt_BAMish record stream; SURVEY.md 2.4)."""
        from . import wire

        raw = self.align_seqs_raw(wire.decode_seqs(seqs_buf))
        return wire.encode_alignments(raw)

    def _align_codes_raw(self, reads, id_base: int = 0, id_stride: int = 1):
        """``align_seqs_raw`` on reads already encoded (codes 0-4), read
        (SE) or pair (PE) ``i`` with the ordinal ``id_base + i *
        id_stride``: a streaming or sharded caller (the CLI) passes the
        original stream ordinals, so its output does not depend on the
        chunking or the partition."""
        if not self._open:
            raise RuntimeError("The aligner has been closed.")
        opt = self.options
        with _metrics.batch_scope():
            self._index.ref_index()
            try:
                eng = self._index._require()
                ids = dict(id_base=id_base, id_stride=id_stride)
                out = (self._align_pe(eng, opt, reads, **ids)
                       if opt.flag & MEM_F_PE
                       else self._align_se(eng, opt, reads, **ids))
            finally:
                self._index.de_ref_index()
            _metrics.count("batches")
            _metrics.count("reads", len(reads))
            _metrics.count("records", sum(len(r) for r in out))
        return out

    def _python_tail_only(self) -> bool:
        """Only the Python tail can serve a batch: a CPU aligner without
        the tail library (on a card its absence raises)."""
        return (self._exec_cfg.device.type == "cpu"
                and not native_pipeline.available())

    def _native_arrays(self, eng, opt, reads, is_pe: bool, id_base: int = 0,
                       id_stride: int = 1):
        """The batch's flat record arrays from the C++: the whole-batch
        route where it applies, else the C++ tail on ``align_regs_raw``'s
        regions; None on the CPU when the tail library is not available
        (on a card its absence raises).  ``id_base``/``id_stride`` as
        ``_align_codes_raw`` takes them."""
        ids = dict(id_base=id_base, id_stride=id_stride)
        if native_pipeline_ok(eng, reads, self._exec_cfg):
            return self._align_native_arrays(eng, opt, reads, is_pe, **ids)
        if self._python_tail_only():
            return None
        rows, n_reg = align_regs_raw(opt, eng, reads, self._exec_cfg)
        with TIMERS.stage("native_tail"):
            return native_pipeline.tail_batch_arrays(
                opt, eng.idx, reads, rows, n_reg, is_pe=is_pe,
                pes=self._caller_pes(opt, eng, is_pe), **ids)

    def _caller_pes(self, opt, eng, is_pe: bool):
        """PE stats for the C++: None to infer them from the batch, else the
        caller's mode resolved (``resolve_pes``)."""
        if is_pe and self._pe_stats is not None:
            return resolve_pes(opt, eng, None, self._pe_stats)
        return None

    def _align_native_arrays(self, eng, opt, reads, is_pe: bool,
                             id_base: int = 0, id_stride: int = 1):
        """Full native pipeline (seeds -> flat record arrays in one C
        call); engine/native/pipeline.cpp, the mem_process_seqs
        equivalent."""
        arrays = native_seed_sa(opt, eng, reads)
        with TIMERS.stage("native_tail"):
            return native_pipeline.pipeline_batch_arrays(
                opt, eng.idx, reads, *arrays, is_pe=is_pe,
                pes=self._caller_pes(opt, eng, is_pe), id_base=id_base,
                id_stride=id_stride)

    def _align_native(self, eng, opt, reads, is_pe: bool, id_base: int = 0,
                      id_stride: int = 1):
        """Like _native_arrays but returns per-read Aln lists (None where
        _native_arrays is None)."""
        arrays = self._native_arrays(eng, opt, reads, is_pe, id_base=id_base,
                                     id_stride=id_stride)
        if arrays is None:
            return None
        with TIMERS.stage("records"):
            return native_pipeline.records_from_arrays(len(reads), *arrays)

    def _align_se(self, eng, opt, reads, id_base: int = 0, id_stride: int = 1):
        recs = self._align_native(eng, opt, reads, is_pe=False,
                                  id_base=id_base, id_stride=id_stride)
        if recs is not None:
            return [[(a, None) for a in alns] for alns in recs]
        return python_tail(opt, eng, reads,
                           align_regs_batch(opt, eng, reads, self._exec_cfg),
                           id_base=id_base, id_stride=id_stride)

    def _align_pe(self, eng, opt, reads, id_base: int = 0, id_stride: int = 1):
        if len(reads) % 2:
            raise InvalidInputException(
                "paired alignment requires an even number of sequences"
            )
        recs = self._align_native(eng, opt, reads, is_pe=True,
                                  id_base=id_base, id_stride=id_stride)
        if recs is not None:
            out = []
            for i in range(len(reads) // 2):
                out.extend(_with_mates(recs[2 * i], recs[2 * i + 1]))
            return out
        regs = align_regs_batch(opt, eng, reads, self._exec_cfg)
        return python_tail(opt, eng, reads, regs, self._pe_stats,
                           id_base=id_base, id_stride=id_stride)

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
