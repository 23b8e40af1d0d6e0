"""ctypes binding for the C++ SA-IS constructor (native/sais.cpp).

Builds the shared library on first use with g++ (no pip deps).  Falls back
gracefully — callers check ``available()`` and use the numpy constructor when the
toolchain is missing.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..utils.nativebuild import compile_shared, lib_path, stale

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "sais.cpp")
_SRC40 = os.path.join(_HERE, "native", "sais40.cpp")
_HDR = os.path.join(_HERE, "native", "sais_core.h")
# BWAMEM_TPU_NATIVE_DIR: load prebuilt natives from this directory and
# never compile (the LIBBWA_PATH analog, BwaMemIndex.java:438-441)
_NATIVE_DIR = os.environ.get("BWAMEM_TPU_NATIVE_DIR")
_LIB = lib_path("libbwamem_sais.so")

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
            if _NATIVE_DIR is None and stale(_LIB, [_SRC, _SRC40, _HDR]):
                compile_shared([_SRC, _SRC40], _LIB)
            lib = ctypes.CDLL(_LIB)
            lib.bwamem_sais.restype = ctypes.c_int
            lib.bwamem_sais.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.bwamem_bwt_from_sa.restype = ctypes.c_int
            lib.bwamem_bwt_from_sa.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.bwamem_build_bwt40.restype = ctypes.c_int
            lib.bwamem_build_bwt40.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.bwamem_interleave_bwt.restype = None
            lib.bwamem_interleave_bwt.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint32),
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


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """SA of codes+sentinel via the native SA-IS; length n+1."""
    if not _ensure_built():
        raise RuntimeError("native SA-IS unavailable")
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    sa = np.empty(n + 1, dtype=np.int64)
    rc = _lib.bwamem_sais(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise MemoryError("native SA-IS failed")
    return sa


def build_bwt_pac40(
    pac: np.ndarray, l_pac: int, sa_intv: int
) -> tuple[np.ndarray, int, np.ndarray, int]:
    """Memory-frugal genome-scale FM-index core (native/sais40.cpp).

    From the 2-bit ``pac`` alone, produces (bwt_codes, primary, sampled_sa,
    n1) of the doubled fwd+rc text — byte-identical to the in-RAM path but
    with a 40-bit packed suffix array and 2-bit text (the package's
    ``Algorithm.RB2`` bounded-memory axis; BwaMemIndex.java:66-71).

    Raises RuntimeError when the reduced problem exceeds int32 (adversarial
    inputs only; callers fall back to the int64 constructor).
    """
    if not _ensure_built():
        raise RuntimeError("native SA-IS unavailable")
    pac = np.ascontiguousarray(pac, dtype=np.uint8)
    n = 2 * l_pac
    bwt = np.empty(n, dtype=np.uint8)
    n_sa = (n + sa_intv) // sa_intv
    sa_samp = np.empty(n_sa, dtype=np.int64)
    primary = ctypes.c_int64(-1)
    n1 = ctypes.c_int64(-1)
    rc = _lib.bwamem_build_bwt40(
        pac.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(l_pac),
        bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(primary),
        sa_samp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(sa_intv),
        ctypes.byref(n1),
    )
    if rc == 1:
        raise MemoryError("frugal FM-index build failed to allocate")
    if rc != 0:
        raise RuntimeError(f"frugal FM-index build unavailable (rc={rc})")
    return bwt, int(primary.value), sa_samp, int(n1.value)


def interleave_bwt(bwt_codes: np.ndarray) -> np.ndarray:
    """bwa .bwt body interleave via the parallel native pass.

    Output layout identical to index/build.py's numpy formulation (pinned by
    the reference's ref.fa.bwt fixture); this exists because the numpy
    version is minutes-scale on a whole-genome stored BWT."""
    if not _ensure_built():
        raise RuntimeError("native interleave unavailable")
    bwt_codes = np.ascontiguousarray(bwt_codes, dtype=np.uint8)
    n = len(bwt_codes)
    n_blocks = max(1, (n + 127) // 128)
    last_words = (n - (n_blocks - 1) * 128 + 15) // 16
    total = 16 * (n_blocks - 1) + 8 + last_words + 8
    out = np.empty(total, dtype=np.uint32)
    _lib.bwamem_interleave_bwt(
        bwt_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out


def bwt_from_sa(codes: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """Stored-form BWT (sentinel row removed) + primary, via the native gather."""
    if not _ensure_built():
        raise RuntimeError("native SA-IS unavailable")
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    n = len(codes)
    if len(sa) != n + 1:
        raise ValueError("sa must have n+1 entries")
    bwt = np.empty(n, dtype=np.uint8)
    primary = ctypes.c_int64(-1)
    rc = _lib.bwamem_bwt_from_sa(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
        bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(primary),
    )
    if rc != 0:
        raise ValueError("sa has no row 0 (not a suffix array of codes+sentinel)")
    return bwt, int(primary.value)
