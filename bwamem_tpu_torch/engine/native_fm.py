"""ctypes binding for the native FM-index/SMEM engine (native/fmindex.cpp)."""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List

import numpy as np

from ..utils.nativebuild import compile_shared, lib_path, stale

from .seed import SmemIntv

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "fmindex.cpp")
# BWAMEM_TPU_NATIVE_DIR: load prebuilt natives from this directory and
# never compile (the LIBBWA_PATH analog, BwaMemIndex.java:438-441)
_NATIVE_DIR = os.environ.get("BWAMEM_TPU_NATIVE_DIR")
_LIB = lib_path("libbwamem_fm.so")

_lock = threading.Lock()
_lib = None
_build_failed = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


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
            lib.bwamem_collect_intv_batch.restype = None
            lib.bwamem_collect_intv_batch.argtypes = [
                _U8P, _I64P, _I64P,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, _U8P, _I64P, _I32P,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                _I64P, _I64P, _I64P,
            ]
            lib.bwamem_sa_batch.restype = None
            lib.bwamem_sa_batch.argtypes = [
                _U8P, _I64P, _I64P,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, _I64P, _I64P,
            ]
            lib.bwamem_collect_intv_batch_alloc.restype = ctypes.c_void_p
            lib.bwamem_collect_intv_batch_alloc.argtypes = [
                _U8P, _I64P, _I64P,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, _U8P, _I64P, _I32P,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                _I64P,
            ]
            lib.bwamem_free.restype = None
            lib.bwamem_free.argtypes = [ctypes.c_void_p]
            lib.bwamem_set_threads.restype = None
            lib.bwamem_set_threads.argtypes = [ctypes.c_int]
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


class _FmArrays:
    """Keeps C-contiguous views of an FMIndex's arrays + ctypes pointers.

    The occ structures are FUSED into one 64-byte record per 128-base
    block — [4 x int64 checkpoint | 8 x uint32 packed chars] — so every
    native rank query costs exactly one cache line (bwa interleaves for
    the same reason; split ckpt/words arrays cost two misses per query).
    The record array is 64-byte aligned by construction."""

    def __init__(self, fm):
        ckpt = np.ascontiguousarray(fm.ckpt, dtype="<i8").reshape(-1, 4)
        words = np.ascontiguousarray(fm.words, dtype="<u4").reshape(-1, 8)
        nb = len(words)
        raw = np.empty(nb * 16 + 16, dtype=np.uint32)
        off = (-raw.ctypes.data % 64) // 4
        fused = raw[off : off + nb * 16].reshape(nb, 16)
        fused[:, :8] = ckpt[:nb].view("<u4")
        fused[:, 8:] = words
        self._raw = raw  # owns the aligned storage
        self.fused = fused
        self.L2 = np.ascontiguousarray(fm.L2, dtype=np.int64)
        self.sa = np.ascontiguousarray(fm.sa, dtype=np.int64)
        from ..utils.hugepages import advise_hugepages

        advise_hugepages(raw)  # rank queries: random 64B reads over ~GBs
        advise_hugepages(self.sa)  # sampled-SA walks: random int64 reads
        self.primary = int(fm.primary)
        self.seq_len = int(fm.seq_len)
        self.sa_intv = int(fm.sa_intv)

    def ptrs(self):
        return (
            self.fused.ctypes.data_as(_U8P),
            self.L2.ctypes.data_as(_I64P),
            self.sa.ctypes.data_as(_I64P),
            self.primary,
            self.seq_len,
            self.sa_intv,
        )


def get_arrays(fm) -> _FmArrays:
    cached = getattr(fm, "_native_arrays", None)
    if cached is None:
        cached = _FmArrays(fm)
        fm._native_arrays = cached
    return cached


def set_threads(n: int) -> None:
    """Cap OpenMP worker threads ([EXT] n_threads/kt_for analog).

    n > 1 applies an explicit cap; n <= 1 keeps the OpenMP default (all
    cores) — the reference's default of 1 reflects its CLI-era tuning and
    callers like GATK always raise it."""
    if n > 1 and _ensure_built():
        _lib.bwamem_set_threads(int(n))


def collect_intv_batch_raw(opt, fm, reads: List[np.ndarray]):
    """Native three-round seeding; returns (rows [N,5] int64, n_out [n]).

    Row layout (x0, x1, s, qb, qe); rows grouped per read in order.  The
    array form feeds the native chaining stage without object churn."""
    if not _ensure_built():
        raise RuntimeError("native fmindex unavailable")
    set_threads(getattr(opt, "n_threads", 0))
    arr = get_arrays(fm)
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
    n_out = np.zeros(n, dtype=np.int64)
    base = arr.ptrs()
    buf_ptr = _lib.bwamem_collect_intv_batch_alloc(
        *base, n,
        rbuf.ctypes.data_as(_U8P), roff.ctypes.data_as(_I64P),
        rlen.ctypes.data_as(_I32P),
        opt.min_seed_len, opt.split_len, opt.split_width, opt.max_mem_intv,
        n_out.ctypes.data_as(_I64P),
    )
    if not buf_ptr:
        raise MemoryError("native seeding allocation failed")
    try:
        total = int(n_out.sum())
        flat = np.ctypeslib.as_array(
            ctypes.cast(buf_ptr, _I64P), shape=(max(total, 1), 5)
        )
        rows = flat[:total].copy()
    finally:
        _lib.bwamem_free(buf_ptr)
    return rows, n_out


def collect_intv_batch(opt, fm, reads: List[np.ndarray]) -> List[List[SmemIntv]]:
    """Native three-round seeding for a batch of reads (object form)."""
    rows, n_out = collect_intv_batch_raw(opt, fm, reads)
    rows_all = rows.tolist()
    res: List[List[SmemIntv]] = []
    pos = 0
    for i in range(len(reads)):
        cnt = int(n_out[i])
        res.append([SmemIntv(*row) for row in rows_all[pos : pos + cnt]])
        pos += cnt
    return res


def sa_batch(fm, ks: np.ndarray) -> np.ndarray:
    if not _ensure_built():
        raise RuntimeError("native fmindex unavailable")
    arr = get_arrays(fm)
    ks = np.ascontiguousarray(ks, dtype=np.int64)
    out = np.empty(len(ks), dtype=np.int64)
    _lib.bwamem_sa_batch(
        *arr.ptrs(), len(ks),
        ks.ctypes.data_as(_I64P), out.ctypes.data_as(_I64P),
    )
    return out
