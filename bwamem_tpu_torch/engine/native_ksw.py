"""ctypes binding for the native batched SW extension (native/ksw.cpp)."""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List

import numpy as np

from ..utils.nativebuild import compile_shared, lib_path, stale

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "ksw.cpp")
# BWAMEM_TPU_NATIVE_DIR: load prebuilt natives from this directory and
# never compile (the LIBBWA_PATH analog, BwaMemIndex.java:438-441)
_NATIVE_DIR = os.environ.get("BWAMEM_TPU_NATIVE_DIR")
_LIB = lib_path("libbwamem_ksw.so")

_lock = threading.Lock()
_lib = None
_build_failed = False


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
            if _NATIVE_DIR is None and stale(_LIB, [_SRC]):
                compile_shared([_SRC], _LIB)
            lib = ctypes.CDLL(_LIB)
            lib.bwamem_ksw_extend_batch.restype = None
            lib.bwamem_ksw_extend_batch.argtypes = [
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int8),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.bwamem_reg2aln_one.restype = None
            lib.bwamem_reg2aln_one.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int8),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ]
            lib.bwamem_reg2aln_batch.restype = None
            lib.bwamem_reg2aln_batch.argtypes = [
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int8),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ]
            lib.bwamem_ksw_global.restype = ctypes.c_int32
            lib.bwamem_ksw_global.argtypes = [
                ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int8),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
            return True
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            return False


def available() -> bool:
    """Native path availability.

    BWAMEM_TPU_DISABLE_NATIVE=1 forces the pure-Python engine — the analog
    of the reference's LIBBWA_PATH native-library override
    (BwaMemIndex.java:438-441), pointed at "no native code"."""
    if os.environ.get("BWAMEM_TPU_DISABLE_NATIVE") == "1":
        return False
    return _ensure_built()


def _p(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def extend_batch(
    jobs: List[tuple],  # (qseq, tseq) uint8 arrays
    mat: List[int],
    o_del: int, e_del: int, o_ins: int, e_ins: int, zdrop: int,
    h0s, ws, bonuses,
) -> List[dict]:
    """Batched exact ksw_extend2; one C call, OpenMP across jobs."""
    if not _ensure_built():
        raise RuntimeError("native ksw unavailable")
    n = len(jobs)
    qoff = np.zeros(n, dtype=np.int64)
    toff = np.zeros(n, dtype=np.int64)
    qlen = np.zeros(n, dtype=np.int32)
    tlen = np.zeros(n, dtype=np.int32)
    pos_q = pos_t = 0
    for i, (q, t) in enumerate(jobs):
        qoff[i], toff[i] = pos_q, pos_t
        qlen[i], tlen[i] = len(q), len(t)
        pos_q += len(q)
        pos_t += len(t)
    qbuf = np.empty(max(pos_q, 1), dtype=np.uint8)
    tbuf = np.empty(max(pos_t, 1), dtype=np.uint8)
    for i, (q, t) in enumerate(jobs):
        qbuf[qoff[i] : qoff[i] + qlen[i]] = q
        tbuf[toff[i] : toff[i] + tlen[i]] = t
    mat8 = np.asarray(mat, dtype=np.int8)
    h0a = np.asarray(h0s, dtype=np.int32)
    wa = np.asarray(ws, dtype=np.int32)
    ba = np.asarray(bonuses, dtype=np.int32)
    out = np.empty((n, 6), dtype=np.int32)
    _lib.bwamem_ksw_extend_batch(
        n,
        _p(qbuf, ctypes.c_uint8), _p(qoff, ctypes.c_int64), _p(qlen, ctypes.c_int32),
        _p(tbuf, ctypes.c_uint8), _p(toff, ctypes.c_int64), _p(tlen, ctypes.c_int32),
        _p(mat8, ctypes.c_int8),
        o_del, e_del, o_ins, e_ins, zdrop,
        _p(h0a, ctypes.c_int32), _p(wa, ctypes.c_int32), _p(ba, ctypes.c_int32),
        _p(out, ctypes.c_int32),
    )
    keys = ("score", "qle", "tle", "gtle", "gscore", "max_off")
    return [dict(zip(keys, row)) for row in out.tolist()]


def ksw_global(
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
    """Exact native twin of engine/extend.py::ksw_global2 -> (score, cigar).

    Falls back to the python oracle when the native lib is unavailable or
    BWAMEM_TPU_DISABLE_NATIVE=1 is set.
    """
    if not available():
        from .extend import ksw_global2

        return ksw_global2(qseq, tseq, mat, o_del, e_del, o_ins, e_ins, w,
                           want_cigar)
    qlen, tlen = len(qseq), len(tseq)
    q = np.ascontiguousarray(qseq, dtype=np.uint8)
    t = np.ascontiguousarray(tseq, dtype=np.uint8)
    mat8 = np.asarray(mat, dtype=np.int8)
    cap = max(qlen + tlen, 1)
    cig = np.empty(cap, dtype=np.uint32)
    n_cig = np.zeros(1, dtype=np.int32)
    score = _lib.bwamem_ksw_global(
        qlen, _p(q, ctypes.c_uint8), tlen, _p(t, ctypes.c_uint8),
        _p(mat8, ctypes.c_int8), o_del, e_del, o_ins, e_ins, w,
        1 if want_cigar else 0,
        _p(cig, ctypes.c_uint32), _p(n_cig, ctypes.c_int32),
    )
    if not want_cigar:
        return int(score), None
    n = int(n_cig[0])
    cigar = [(int(v & 0xF), int(v >> 4)) for v in cig[:n]]
    return int(score), cigar


def reg2aln_cigar_batch(opt, ref_fwd: np.ndarray, l_pac: int, jobs):
    """Batched mem_reg2aln CIGAR core: per job the band-doubling retry loop
    around bwa_gen_cigar2 ([EXT] bwamem.c mem_reg2aln, bwa.c bwa_gen_cigar2),
    native with OpenMP across jobs.

    jobs: list of (query_slice uint8[:], rb, re, w0, truesc).
    Returns list of (score, cigar [(op, len)] | None, NM, md str).
    """
    n = len(jobs)
    if n == 0:
        return []
    qoff = np.zeros(n, dtype=np.int64)
    qlen = np.zeros(n, dtype=np.int32)
    rbs = np.zeros(n, dtype=np.int64)
    res = np.zeros(n, dtype=np.int64)
    w0s = np.zeros(n, dtype=np.int64)
    tsc = np.zeros(n, dtype=np.int64)
    cig_off = np.zeros(n, dtype=np.int64)
    md_off = np.zeros(n, dtype=np.int64)
    pos_q = cig_pos = md_pos = 0
    for i, (q, rb, re, w0, truesc) in enumerate(jobs):
        lq, lr = len(q), max(re - rb, 0)
        qoff[i] = pos_q
        qlen[i] = lq
        rbs[i], res[i], w0s[i], tsc[i] = rb, re, w0, truesc
        cig_off[i] = cig_pos
        md_off[i] = md_pos
        pos_q += lq
        cig_pos += lq + lr + 4
        md_pos += 2 * (lq + lr) + 32
    qbuf = np.empty(max(pos_q, 1), dtype=np.uint8)
    for i, (q, *_rest) in enumerate(jobs):
        qbuf[qoff[i] : qoff[i] + qlen[i]] = q
    cig_buf = np.empty(max(cig_pos, 1), dtype=np.uint32)
    md_buf = np.empty(max(md_pos, 1), dtype=np.uint8)
    n_cig = np.zeros(n, dtype=np.int32)
    n_md = np.zeros(n, dtype=np.int32)
    score = np.zeros(n, dtype=np.int32)
    nm = np.zeros(n, dtype=np.int32)
    mat8 = np.asarray(opt.mat, dtype=np.int8)
    fwd = np.ascontiguousarray(ref_fwd, dtype=np.uint8)
    _lib.bwamem_reg2aln_batch(
        n,
        _p(qbuf, ctypes.c_uint8), _p(qoff, ctypes.c_int64), _p(qlen, ctypes.c_int32),
        _p(rbs, ctypes.c_int64), _p(res, ctypes.c_int64),
        _p(w0s, ctypes.c_int64), _p(tsc, ctypes.c_int64),
        _p(fwd, ctypes.c_uint8), l_pac,
        _p(mat8, ctypes.c_int8),
        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w, opt.a,
        _p(cig_buf, ctypes.c_uint32), _p(cig_off, ctypes.c_int64),
        _p(n_cig, ctypes.c_int32),
        _p(md_buf, ctypes.c_uint8), _p(md_off, ctypes.c_int64),
        _p(n_md, ctypes.c_int32),
        _p(score, ctypes.c_int32), _p(nm, ctypes.c_int32),
    )
    out = []
    for i in range(n):
        nc = int(n_cig[i])
        if nc == 0 and int(nm[i]) < 0:
            out.append((int(score[i]), None, -1, ""))
            continue
        ops = cig_buf[cig_off[i] : cig_off[i] + nc]
        cigar = [(int(v & 0xF), int(v >> 4)) for v in ops]
        md = md_buf[md_off[i] : md_off[i] + int(n_md[i])].tobytes().decode()
        out.append((int(score[i]), cigar, int(nm[i]), md))
    return out


class _Reg2AlnScratch(threading.local):
    """Per-thread reusable output buffers for reg2aln_cigar_one."""

    def __init__(self):
        self.cap = 0
        self.cig = None
        self.md = None
        self.n_cig = np.zeros(1, dtype=np.int32)
        self.n_md = np.zeros(1, dtype=np.int32)
        self.score = np.zeros(1, dtype=np.int32)
        self.nm = np.zeros(1, dtype=np.int32)
        self.mat_id = None
        self.mat8 = None

    def ensure(self, cap):
        if cap > self.cap:
            self.cap = max(cap, 4096)
            self.cig = np.empty(self.cap, dtype=np.uint32)
            self.md = np.empty(2 * self.cap + 32, dtype=np.uint8)


_scratch = _Reg2AlnScratch()


def reg2aln_cigar_one(opt, ref_fwd: np.ndarray, l_pac: int, qslice, rb, re,
                      w0, truesc):
    """Single-job mem_reg2aln CIGAR core (native, zero allocation per call).

    -> (score, cigar, NM, md).  Caller guarantees native availability and an
    unpacked reference buffer.
    """
    s = _scratch
    lq = len(qslice)
    s.ensure(lq + max(re - rb, 0) + 4)
    if s.mat_id != id(opt.mat):
        s.mat8 = np.asarray(opt.mat, dtype=np.int8)
        s.mat_id = id(opt.mat)
    q = qslice if qslice.flags["C_CONTIGUOUS"] else np.ascontiguousarray(qslice)
    _lib.bwamem_reg2aln_one(
        _p(q, ctypes.c_uint8), lq, rb, re, w0, truesc,
        _p(ref_fwd, ctypes.c_uint8), l_pac, _p(s.mat8, ctypes.c_int8),
        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w, opt.a,
        _p(s.cig, ctypes.c_uint32), _p(s.n_cig, ctypes.c_int32),
        _p(s.md, ctypes.c_uint8), _p(s.n_md, ctypes.c_int32),
        _p(s.score, ctypes.c_int32), _p(s.nm, ctypes.c_int32),
    )
    nc = int(s.n_cig[0])
    nm = int(s.nm[0])
    if nc == 0 and nm < 0:
        return int(s.score[0]), None, -1, ""
    cigar = [(int(v & 0xF), int(v >> 4)) for v in s.cig[:nc]]
    md = s.md[: int(s.n_md[0])].tobytes().decode()
    return int(s.score[0]), cigar, nm, md
