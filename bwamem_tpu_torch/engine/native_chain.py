"""ctypes binding for the native chaining stage (native/chain.cpp)."""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List

import numpy as np

from ..utils.nativebuild import compile_shared, lib_path, stale

from .chain import Chain, Seed

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "chain.cpp")
# BWAMEM_TPU_NATIVE_DIR: load prebuilt natives from this directory and
# never compile (the LIBBWA_PATH analog, BwaMemIndex.java:438-441)
_NATIVE_DIR = os.environ.get("BWAMEM_TPU_NATIVE_DIR")
_LIB = lib_path("libbwamem_chain.so")

_lock = threading.Lock()
_lib = None
_build_failed = False

_I64P = ctypes.POINTER(ctypes.c_int64)
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
            lib.bwamem_chain_batch.restype = None
            lib.bwamem_chain_batch.argtypes = [
                ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, _I32P,
                ctypes.c_int64, _I32P, _I64P, _I64P, _I64P,
                _I64P, _I64P, _I64P,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double, ctypes.c_double, ctypes.c_int64,
                _I64P, _I64P, _I64P, _I64P, _I64P, _I64P,
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


class _BnsArrays:
    def __init__(self, bns):
        self.off = np.asarray([a.offset for a in bns.anns], dtype=np.int64)
        self.len = np.asarray([a.length for a in bns.anns], dtype=np.int64)
        self.is_alt = np.asarray([a.is_alt for a in bns.anns], dtype=np.int32)
        self.l_pac = bns.l_pac
        self.n = len(bns.anns)


def get_bns_arrays(bns) -> _BnsArrays:
    cached = getattr(bns, "_native_arrays", None)
    if cached is None:
        cached = _BnsArrays(bns)
        bns._native_arrays = cached
    return cached


def _p(a, t):
    return a.ctypes.data_as(t)


def chain_batch(
    opt,
    bns,
    qlens: np.ndarray,  # [n_reads] int32
    intv_rows: np.ndarray,  # [N, 5] int64 (x0, x1, s, qb, qe)
    intv_off: np.ndarray,  # [n_reads] int64 first row per read
    n_intv: np.ndarray,  # [n_reads] int64
    rbegs: np.ndarray,  # flat int64
    rbeg_off: np.ndarray,  # [N] int64 global offset per interval row
    n_rbeg: np.ndarray,  # [N] int64
) -> List[List[Chain]]:
    """Native mem_chain + chain_flt for a batch; rebuilds Chain objects."""
    if not _ensure_built():
        raise RuntimeError("native chain unavailable")
    b = get_bns_arrays(bns)
    n = len(qlens)
    n_chain = np.zeros(n, dtype=np.int64)
    n_seed = np.zeros(n, dtype=np.int64)
    intv_rows = np.ascontiguousarray(intv_rows, dtype=np.int64)
    rbegs = np.ascontiguousarray(rbegs, dtype=np.int64)
    rbeg_off = np.ascontiguousarray(rbeg_off, dtype=np.int64)
    n_rbeg = np.ascontiguousarray(n_rbeg, dtype=np.int64)
    qlens = np.ascontiguousarray(qlens, dtype=np.int32)
    intv_off = np.ascontiguousarray(intv_off, dtype=np.int64)
    n_intv = np.ascontiguousarray(n_intv, dtype=np.int64)
    args = (
        b.l_pac, b.n, _p(b.off, _I64P), _p(b.len, _I64P), _p(b.is_alt, _I32P),
        n, _p(qlens, _I32P), _p(intv_rows, _I64P), _p(intv_off, _I64P),
        _p(n_intv, _I64P), _p(rbegs, _I64P), _p(rbeg_off, _I64P),
        _p(n_rbeg, _I64P),
        opt.w, opt.max_chain_gap, opt.min_chain_weight, opt.min_seed_len,
        opt.max_chain_extend, opt.mask_level, opt.drop_ratio, opt.max_occ,
        _p(n_chain, _I64P), _p(n_seed, _I64P),
    )
    null = ctypes.cast(None, _I64P)
    _lib.bwamem_chain_batch(*args, null, null, null, null)
    chain_off = np.zeros(n, dtype=np.int64)
    seed_off = np.zeros(n, dtype=np.int64)
    np.cumsum(n_chain[:-1], out=chain_off[1:])
    np.cumsum(n_seed[:-1], out=seed_off[1:])
    tc = int(n_chain.sum())
    ts = int(n_seed.sum())
    chain_rows = np.zeros((max(tc, 1), 4), dtype=np.int64)
    seed_rows = np.zeros((max(ts, 1), 4), dtype=np.int64)
    _lib.bwamem_chain_batch(
        *args, _p(chain_off, _I64P), _p(seed_off, _I64P),
        _p(chain_rows, _I64P), _p(seed_rows, _I64P),
    )
    out: List[List[Chain]] = []
    frac_bits = chain_rows[:, 3].copy().view(np.float64)
    for i in range(n):
        chains = []
        srow = int(seed_off[i])
        for ci in range(int(n_chain[i])):
            row = chain_rows[int(chain_off[i]) + ci]
            ns = int(row[2])
            seeds = [
                Seed(rbeg=int(sr[0]), qbeg=int(sr[1]), len=int(sr[2]),
                     score=int(sr[3]))
                for sr in seed_rows[srow : srow + ns]
            ]
            srow += ns
            c = Chain(rid=int(row[0]), seeds=seeds, is_alt=int(row[1]),
                      frac_rep=float(frac_bits[int(chain_off[i]) + ci]))
            chains.append(c)
        out.append(chains)
    return out
