"""ctypes binding for the fused native align core (native/align_core.cpp +
native/ksw.cpp): chaining + chain extension in one OpenMP batch call."""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List

import numpy as np

from ..utils.nativebuild import compile_shared, lib_path, stale

from .extend import AlnReg
from .native_chain import get_bns_arrays

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_HERE, "native", "align_core.cpp"),
    os.path.join(_HERE, "native", "ksw.cpp"),
]
# BWAMEM_TPU_NATIVE_DIR: load prebuilt natives from this directory and
# never compile (the LIBBWA_PATH analog, BwaMemIndex.java:438-441)
_NATIVE_DIR = os.environ.get("BWAMEM_TPU_NATIVE_DIR")
_LIB = lib_path("libbwamem_core.so")

_lock = threading.Lock()
_lib = None
_build_failed = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I8P = ctypes.POINTER(ctypes.c_int8)
_U8P = ctypes.POINTER(ctypes.c_uint8)


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
            if _NATIVE_DIR is None and stale(_LIB, list(_SRCS)):
                compile_shared(list(_SRCS), _LIB)
            lib = ctypes.CDLL(_LIB)
            lib.bwamem_align_regs_batch.restype = None
            lib.bwamem_align_regs_batch.argtypes = [
                _U8P, ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, _I32P,
                ctypes.c_int64, _U8P, _I64P, _I32P,
                _I64P, _I64P, _I64P, _I64P, _I64P, _I64P,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double, ctypes.c_double, ctypes.c_int64, _I8P,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _I64P, _I64P, _I64P,
            ]
            _lib = lib
            return True
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            return False


def available() -> bool:
    if os.environ.get("BWAMEM_TPU_DISABLE_NATIVE") == "1":
        return False
    return _ensure_built()


def _p(a, t):
    return a.ctypes.data_as(t)


def align_regs_batch_core(
    opt, idx, reads: List[np.ndarray],
    intv_rows: np.ndarray, intv_off: np.ndarray, n_intv: np.ndarray,
    rbegs: np.ndarray, rbeg_off: np.ndarray, n_rbeg: np.ndarray,
) -> List[List[AlnReg]]:
    """Fused chain+extend; returns un-deduped regions per read (the
    chain2aln output order, ready for sort_dedup_patch)."""
    if not _ensure_built():
        raise RuntimeError("native align core unavailable")
    bns = idx.bns
    ref_fwd = idx._fwd_codes(0, bns.l_pac)
    if not (isinstance(ref_fwd, np.ndarray) and ref_fwd.flags.c_contiguous):
        ref_fwd = np.ascontiguousarray(ref_fwd, dtype=np.uint8)
    b = get_bns_arrays(bns)
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
    mat8 = np.asarray(opt.mat, dtype=np.int8)
    n_reg = np.zeros(n, dtype=np.int64)
    intv_rows = np.ascontiguousarray(intv_rows, dtype=np.int64)
    rbegs = np.ascontiguousarray(rbegs, dtype=np.int64)
    rbeg_off = np.ascontiguousarray(rbeg_off, dtype=np.int64)
    n_rbeg = np.ascontiguousarray(n_rbeg, dtype=np.int64)
    intv_off = np.ascontiguousarray(intv_off, dtype=np.int64)
    n_intv = np.ascontiguousarray(n_intv, dtype=np.int64)
    args = (
        _p(ref_fwd, _U8P), bns.l_pac, b.n, _p(b.off, _I64P), _p(b.len, _I64P),
        _p(b.is_alt, _I32P),
        n, _p(rbuf, _U8P), _p(roff, _I64P), _p(rlen, _I32P),
        _p(intv_rows, _I64P), _p(intv_off, _I64P), _p(n_intv, _I64P),
        _p(rbegs, _I64P), _p(rbeg_off, _I64P), _p(n_rbeg, _I64P),
        opt.w, opt.max_chain_gap, opt.min_chain_weight, opt.min_seed_len,
        opt.max_chain_extend, opt.mask_level, opt.drop_ratio, opt.max_occ,
        _p(mat8, _I8P),
        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
        opt.pen_clip5, opt.pen_clip3, opt.a,
        _p(n_reg, _I64P),
    )
    null = ctypes.cast(None, _I64P)
    _lib.bwamem_align_regs_batch(*args, null, null)
    reg_off = np.zeros(n, dtype=np.int64)
    np.cumsum(n_reg[:-1], out=reg_off[1:])
    total = int(n_reg.sum())
    rows = np.zeros((max(total, 1), 11), dtype=np.int64)
    _lib.bwamem_align_regs_batch(*args, _p(reg_off, _I64P), _p(rows, _I64P))
    frac = rows[:, 10].copy().view(np.float64)
    out: List[List[AlnReg]] = []
    pos = 0
    for i in range(n):
        regs = []
        for k in range(int(n_reg[i])):
            r = rows[pos + k]
            a = AlnReg(
                rb=int(r[0]), re=int(r[1]), qb=int(r[2]), qe=int(r[3]),
                rid=int(r[4]), score=int(r[5]), truesc=int(r[6]),
                w=int(r[7]), seedcov=int(r[8]), seedlen0=int(r[9]),
                frac_rep=float(frac[pos + k]),
            )
            regs.append(a)
        pos += int(n_reg[i])
        out.append(regs)
    return out
