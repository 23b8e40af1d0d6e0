"""ctypes binding for the full native pipeline tail (native/pipeline.cpp).

One C call runs seeds -> chains -> extension -> dedup -> primary marking ->
(PE: pestat / pairing / mate rescue) -> final records, the
mem_process_seqs-equivalent host runtime ([EXT] bwamem.c worker1/worker2;
anchored at jnibwa.c:214).  The python modules engine/{finalize,pair,
pipeline}.py remain the semantic oracle; tests/test_torch_native_tail.py
holds this path to record-level equality with them.

``tail_batch_arrays`` is the port's own entry (``bwamem_tail_batch``): the
same tail from regions before dedup, in ``bwamem_align_regs_batch``'s row
layout, so that regions made by any route (the card's fused path, the
extension waves) meet the same C++ dedup, pairing and record code.

Both entries also hand back what the batch's ALT-aware mapping did
(``ALT_COUNTS``), which each call adds up where a window reads it: the
regions the extension returned and those on an ALT contig to
``FUSED_STATS.regions`` and ``FUSED_STATS.alt_regions``, the reads, records
and ends to the ``utils.metrics`` counters of the same names, and the
thread-seconds of XA generation for reads with an ALT hit to ``TIMERS`` as
``alt_xa`` under the caller's open span (``native_tail.alt_xa``).

Env: BWAMEM_TPU_NATIVE_TAIL=0 disables this path where ``available`` is
asked (the oracle path runs); BWAMEM_TPU_DISABLE_NATIVE=1 disables all
native code there.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

from ..utils import metrics as _metrics
from ..utils.nativebuild import compile_shared, lib_path, stale
from ..utils.timers import TIMERS

from .finalize import Aln
from .pipeline_device import FUSED_STATS

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "pipeline.cpp")
_DEPS = [
    os.path.join(_HERE, "native", "ksw.cpp"),
    os.path.join(_HERE, "native", "align_core.cpp"),
]
# BWAMEM_TPU_NATIVE_DIR: load prebuilt natives from this directory and
# never compile (the LIBBWA_PATH analog, BwaMemIndex.java:438-441)
_NATIVE_DIR = os.environ.get("BWAMEM_TPU_NATIVE_DIR")
_LIB = lib_path("libbwamem_pipeline.so")

_lock = threading.Lock()
_lib = None
_build_failed = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I8P = ctypes.POINTER(ctypes.c_int8)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_F64P = ctypes.POINTER(ctypes.c_double)
_CHARP = ctypes.POINTER(ctypes.c_char)

# must match the OI_* / OF_* enums in pipeline.cpp
_OPT_I_FIELDS = (
    "w", "max_chain_gap", "min_chain_weight", "min_seed_len",
    "max_chain_extend", "max_occ", "o_del", "e_del", "o_ins", "e_ins",
    "zdrop", "pen_clip5", "pen_clip3", "a", "b", "pen_unpaired", "T",
    "max_matesw", "max_ins", "flag", "max_xa_hits", "max_xa_hits_alt",
    "mapq_coef_fac",
)
_OPT_F_FIELDS = (
    "mask_level", "drop_ratio", "xa_drop_ratio", "mask_level_redun",
    "mapq_coef_len",
)
# record row fields (RF_* enum in pipeline.cpp)
_RF_N = 23
# region row fields (bwamem_align_regs_batch, align_core.cpp): rb re qb qe
# rid score truesc w seedcov seedlen0 frac_rep_bits
REG_COLS = 11
# a batch's ALT tallies (AC_* enum in pipeline.cpp): the regions the
# extension returned (before dedup) and those on an ALT contig; reads with
# one of those; primary records with alt_sc > 0; XA entries of the records
# that name an ALT contig; ends of a proper pair whose best ALT hit stays
# primary after the ALT round (where bwa's paired branch is recalled to
# write a 0x800 record); ns of XA generation for reads with an ALT hit
ALT_COUNTS = ("regions", "alt_regions", "alt_reads", "alt_sc_primaries",
              "alt_xa_entries", "alt_pair_primary_ends", "alt_xa_ns")

# the reference, bns arrays and names; the reads; the options, is_pe,
# pes_in, id_base, id_stride, pes_out; the six outputs
_HEAD = [_U8P, ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, _I32P,
         _CHARP, _I64P, ctypes.c_int64, _U8P, _I64P, _I32P]
_TAIL = [_I64P, _F64P, _I8P,
         ctypes.c_int32, _F64P, ctypes.c_int64, ctypes.c_int64, _F64P,
         ctypes.POINTER(_I64P), _I64P,
         ctypes.POINTER(_U32P), _I64P,
         ctypes.POINTER(_CHARP), _I64P, _I64P]


def _ensure_built() -> bool:
    global _lib, _build_failed
    if _lib is not None:
        return True
    if _build_failed:
        return False
    with _lock:
        if _lib is not None:
            return True
        if _build_failed:
            return False
        try:
            if _NATIVE_DIR is None and stale(_LIB, [_SRC] + _DEPS):
                compile_shared([_SRC], _LIB)
            lib = ctypes.CDLL(_LIB)
            lib.bwamem_buf_free.restype = None
            lib.bwamem_buf_free.argtypes = [ctypes.c_void_p]
            lib.bwamem_pipeline_batch.restype = None
            lib.bwamem_pipeline_batch.argtypes = (
                _HEAD + [_I64P] * 6 + _TAIL)
            lib.bwamem_tail_batch.restype = None
            lib.bwamem_tail_batch.argtypes = _HEAD + [_I64P] * 2 + _TAIL
            _lib = lib
            return True
        except (OSError, subprocess.CalledProcessError, AttributeError):
            _build_failed = True
            return False


def available() -> bool:
    if os.environ.get("BWAMEM_TPU_DISABLE_NATIVE") == "1":
        return False
    if os.environ.get("BWAMEM_TPU_NATIVE_TAIL") == "0":
        return False
    return _ensure_built()


def _p(a, t):
    return a.ctypes.data_as(t)


class _BnsTail:
    """Cached flat arrays + name buffer for one Bntseq."""

    def __init__(self, bns):
        self.off = np.asarray([a.offset for a in bns.anns], dtype=np.int64)
        self.len = np.asarray([a.length for a in bns.anns], dtype=np.int64)
        self.is_alt = np.asarray([a.is_alt for a in bns.anns], dtype=np.int32)
        names = [a.name.encode() for a in bns.anns]
        self.name_off = np.zeros(len(names) + 1, dtype=np.int64)
        np.cumsum([len(n) for n in names], out=self.name_off[1:])
        joined = b"".join(names) or b"\x00"
        self.name_buf = np.frombuffer(joined, dtype=np.uint8).copy()


def _get_tail_arrays(bns) -> _BnsTail:
    cached = getattr(bns, "_tail_arrays", None)
    if cached is None:
        cached = _BnsTail(bns)
        bns._tail_arrays = cached
    return cached


def _call(entry, opt, idx, ref_fwd, reads, middle, is_pe, pes, id_base,
          id_stride):
    """One call of ``entry`` (bwamem_pipeline_batch or bwamem_tail_batch):
    the arguments both share around ``middle`` (the entry's own arrays), the
    output buffers copied out and freed."""
    bns = idx.bns
    if not (isinstance(ref_fwd, np.ndarray) and ref_fwd.flags.c_contiguous):
        ref_fwd = np.ascontiguousarray(ref_fwd, dtype=np.uint8)
    b = _get_tail_arrays(bns)
    n = len(reads)
    roff = np.zeros(n, dtype=np.int64)
    rlen = np.zeros(n, dtype=np.int32)
    pos = 0
    for i, r in enumerate(reads):
        roff[i] = pos
        rlen[i] = len(r)
        pos += len(r)
    rbuf = np.empty(max(pos, 1), dtype=np.uint8)
    for i, r in enumerate(reads):
        rbuf[roff[i] : roff[i] + rlen[i]] = r
    opt_i = np.asarray([getattr(opt, f) for f in _OPT_I_FIELDS], dtype=np.int64)
    opt_f = np.asarray([getattr(opt, f) for f in _OPT_F_FIELDS], dtype=np.float64)
    mat8 = np.asarray(opt.mat, dtype=np.int8)
    pes_arr = None
    if is_pe and pes is not None:
        pes_arr = np.zeros((4, 5), dtype=np.float64)
        for d, p in enumerate(pes):
            pes_arr[d] = (p.low, p.high, p.failed, p.avg, p.std)
    middle = [np.ascontiguousarray(a, dtype=np.int64) for a in middle]

    rows_p = _I64P()
    n_rec = ctypes.c_int64()
    cig_p = _U32P()
    cig_len = ctypes.c_int64()
    str_p = _CHARP()
    str_len = ctypes.c_int64()
    counts = np.zeros(len(ALT_COUNTS), dtype=np.int64)
    entry(
        _p(ref_fwd, _U8P), bns.l_pac, len(bns.anns),
        _p(b.off, _I64P), _p(b.len, _I64P), _p(b.is_alt, _I32P),
        ctypes.cast(_p(b.name_buf, _U8P), _CHARP), _p(b.name_off, _I64P),
        n, _p(rbuf, _U8P), _p(roff, _I64P), _p(rlen, _I32P),
        *[_p(a, _I64P) for a in middle],
        _p(opt_i, _I64P), _p(opt_f, _F64P), _p(mat8, _I8P),
        1 if is_pe else 0,
        _p(pes_arr, _F64P) if pes_arr is not None else None,
        id_base, id_stride, None,
        ctypes.byref(rows_p), ctypes.byref(n_rec),
        ctypes.byref(cig_p), ctypes.byref(cig_len),
        ctypes.byref(str_p), ctypes.byref(str_len), _p(counts, _I64P),
    )
    _add_alt_counts(dict(zip(ALT_COUNTS, counts.tolist())))
    try:
        nr = int(n_rec.value)
        rows = np.ctypeslib.as_array(rows_p, shape=(max(nr, 1), _RF_N))[
            :nr
        ].copy()
        cig = np.ctypeslib.as_array(
            cig_p, shape=(max(int(cig_len.value), 1),)
        )[: int(cig_len.value)].copy()
        sbuf = ctypes.string_at(str_p, int(str_len.value)) if str_len.value else b""
        return rows, cig, sbuf
    finally:
        _lib.bwamem_buf_free(rows_p)
        _lib.bwamem_buf_free(cig_p)
        _lib.bwamem_buf_free(str_p)


def _add_alt_counts(c: dict) -> None:
    """One batch's ALT tallies, added where a window reads them (the
    module docstring says where)."""
    FUSED_STATS.regions += c["regions"]
    FUSED_STATS.alt_regions += c["alt_regions"]
    for name in ("alt_reads", "alt_sc_primaries", "alt_xa_entries",
                 "alt_pair_primary_ends"):
        if c[name]:
            _metrics.count(name, c[name])
    TIMERS.add("alt_xa", c["alt_xa_ns"])


def pipeline_batch_arrays(
    opt,
    idx,
    reads: List[np.ndarray],
    intv_rows: np.ndarray,
    intv_off: np.ndarray,
    n_intv: np.ndarray,
    rbegs: np.ndarray,
    rbeg_off: np.ndarray,
    n_rbeg: np.ndarray,
    is_pe: bool,
    pes: Optional[List] = None,  # list[PeStat] or None -> infer
    id_base: int = 0,
    id_stride: int = 1,
):
    """Seed intervals -> flat record arrays, all native; no Python-object
    churn (the array substrate behind both the Aln path and the
    vectorized BwaMemAlignment assembly in api/aligner.py).

    Returns (rows [nr, _RF_N] int64, cig [cig_len] uint32, sbuf bytes)."""
    if not _ensure_built():
        raise RuntimeError("native pipeline unavailable")
    return _call(_lib.bwamem_pipeline_batch, opt, idx, idx.unpacked_fwd(),
                 reads, (intv_rows, intv_off, n_intv, rbegs, rbeg_off, n_rbeg),
                 is_pe, pes, id_base, id_stride)


def tail_batch_arrays(
    opt,
    idx,
    reads: List[np.ndarray],
    reg_rows: np.ndarray,  # [Nr, REG_COLS] int64, read after read
    n_reg: np.ndarray,  # [len(reads)] int64
    is_pe: bool,
    pes: Optional[List] = None,  # list[PeStat] or None -> infer
    id_base: int = 0,
    id_stride: int = 1,
):
    """Regions before dedup -> the flat record arrays of
    ``pipeline_batch_arrays``: dedup, ALT flags, pestat, pairing with mate
    rescue or SE primary marking, and the records, all native.  Raises when
    the library cannot be built or loaded; there is no Python fallback here.

    Returns (rows [nr, _RF_N] int64, cig [cig_len] uint32, sbuf bytes)."""
    if not _ensure_built():
        raise RuntimeError("native pipeline unavailable")
    n_reg = np.asarray(n_reg, dtype=np.int64)
    if len(n_reg) != len(reads):
        raise ValueError("n_reg must have one count a read")
    reg_rows = np.asarray(reg_rows, dtype=np.int64).reshape(-1, REG_COLS)
    if reg_rows.shape[0] != int(n_reg.sum()):
        raise ValueError("reg_rows must hold n_reg.sum() rows")
    if not len(reg_rows):
        reg_rows = np.zeros((1, REG_COLS), dtype=np.int64)
    return _call(_lib.bwamem_tail_batch, opt, idx,
                 idx._fwd_codes(0, idx.bns.l_pac), reads, (reg_rows, n_reg),
                 is_pe, pes, id_base, id_stride)


def records_from_arrays(n: int, rows, cig, sbuf) -> List[List[Aln]]:
    """Flat record arrays -> per-read Aln lists (the object form used by
    the wire codec, SAM renderer and oracle-equality tests)."""
    out: List[List[Aln]] = [[] for _ in range(n)]
    if not len(rows):
        return out
    text = sbuf.decode("latin-1")
    ops = (cig & 0xF).astype(np.int64)
    lens = (cig >> 4).astype(np.int64)
    cols = rows.T.tolist()
    (ridx, flag, rid, pos, is_rev, is_alt, mapq, nm, score, sub, alt_sc,
     n_cig, cig_off, md_off, md_len, xa_off, xa_len, has_xa,
     _cs_off, _cs_len, _reflen, _sstart, _slen) = cols
    ops_l = ops.tolist()
    lens_l = lens.tolist()
    for k in range(len(ridx)):
        co = cig_off[k]
        ce = co + n_cig[k]
        cigar = list(zip(ops_l[co:ce], lens_l[co:ce]))
        mo = md_off[k]
        md = text[mo : mo + md_len[k]]
        if has_xa[k]:
            xo = xa_off[k]
            xa = text[xo : xo + xa_len[k]]
        else:
            xa = None
        out[ridx[k]].append(
            Aln(
                pos=pos[k], rid=rid[k], flag=flag[k], is_rev=is_rev[k],
                is_alt=is_alt[k], mapq=mapq[k], NM=nm[k], cigar=cigar,
                md=md, score=score[k], sub=sub[k], alt_sc=alt_sc[k], XA=xa,
            )
        )
    return out


def pipeline_batch(
    opt,
    idx,
    reads: List[np.ndarray],
    intv_rows: np.ndarray,
    intv_off: np.ndarray,
    n_intv: np.ndarray,
    rbegs: np.ndarray,
    rbeg_off: np.ndarray,
    n_rbeg: np.ndarray,
    is_pe: bool,
    pes: Optional[List] = None,
    id_base: int = 0,
    id_stride: int = 1,
) -> List[List[Aln]]:
    """Seed intervals -> final per-read Aln record lists, all native."""
    rows, cig, sbuf = pipeline_batch_arrays(
        opt, idx, reads, intv_rows, intv_off, n_intv, rbegs, rbeg_off,
        n_rbeg, is_pe=is_pe, pes=pes, id_base=id_base, id_stride=id_stride,
    )
    return records_from_arrays(len(reads), rows, cig, sbuf)
