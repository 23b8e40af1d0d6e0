"""Best-effort transparent-hugepage advice for the hot multi-GB tables.

At genome scale the engine's inner loops are TLB-bound: every rank query
is a random 64-byte read into a ~3 GB fused occ table, every sampled-SA
walk a random read into a ~1.5 GB array, and the unpacked-reference cache
feeds extension with random windows of a ~3 GB buffer.  2 MB mappings cut
dTLB misses on all three (the same advice bought +21% on the index
constructor's induce passes, index/native/sais40.cpp).

Advisory only — any failure (non-Linux, THP disabled, small arrays) is
silently ignored.
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np

_MADV_HUGEPAGE = 14
_HUGE = 2 << 20
_libc = None
_failed = False


def advise_hugepages(arr: np.ndarray) -> None:
    """MADV_HUGEPAGE over the 2 MB-aligned interior of ``arr``'s pages."""
    global _libc, _failed
    if _failed or not sys.platform.startswith("linux"):
        return
    if arr.nbytes < 2 * _HUGE:
        return  # nothing a hugepage could cover reliably
    try:
        if _libc is None:
            _libc = ctypes.CDLL(None, use_errno=True)
        addr = arr.ctypes.data
        lo = (addr + _HUGE - 1) & ~(_HUGE - 1)
        hi = (addr + arr.nbytes) & ~(_HUGE - 1)
        if hi > lo:
            _libc.madvise(
                ctypes.c_void_p(lo), ctypes.c_size_t(hi - lo), _MADV_HUGEPAGE
            )
    except Exception:
        _failed = True
