"""Suffix array construction.

Native equivalents of the reference engine's constructors ([EXT] is.c — Yuta
Mori's IS algorithm — and [EXT] rope.c/rle.c ropebwt2; selected by
``BwaMemIndex.Algorithm``, BwaMemIndex.java:46-80).

Strategy here:
  * ``suffix_array_numpy``   — prefix-doubling with numpy sorts, O(n log^2 n).
    Robust, pure-Python, fine up to tens of Mbp.
  * ``suffix_array_native``  — C++ SA-IS (index/native/sais.cpp via ctypes),
    linear time, for chromosome/genome scale.
``suffix_array`` picks the native constructor when available, and with
``BWAMEM_TPU_DEVICE_SA=1`` (the JAX package's switch) the device builder
``ops.sa.suffix_array_device`` on the card, which raises without one.

The returned SA is over ``codes + [sentinel]`` where the sentinel is strictly
smaller than every symbol; length n+1 with SA[0] == n.
"""
from __future__ import annotations

import os

import numpy as np

from . import native_sais


def suffix_array_numpy(codes: np.ndarray) -> np.ndarray:
    """SA of codes+sentinel by prefix doubling (numpy argsort)."""
    n = len(codes)
    # rank 0 reserved for the sentinel; shift codes up by 1
    rank = np.zeros(n + 1, dtype=np.int64)
    rank[:n] = np.asarray(codes, dtype=np.int64) + 1
    sa = np.argsort(rank, kind="stable").astype(np.int64)
    # order within equal first chars is positional; fix by doubling
    k = 1
    total = n + 1
    tmp = np.empty(total, dtype=np.int64)
    while True:
        # key = (rank[i], rank[i+k]) ; out-of-range -> -1 (smaller than all)
        second = np.full(total, -1, dtype=np.int64)
        idx = np.arange(total) + k
        valid = idx < total
        second[valid] = rank[idx[valid]]
        order = np.lexsort((second, rank))
        sa = order
        # re-rank
        tmp[sa[0]] = 0
        prev_r = rank[sa[:-1]]
        cur_r = rank[sa[1:]]
        prev_s = second[sa[:-1]]
        cur_s = second[sa[1:]]
        bump = (cur_r != prev_r) | (cur_s != prev_s)
        tmp[sa[1:]] = np.cumsum(bump)
        rank, tmp = tmp.copy(), rank
        if rank[sa[-1]] == total - 1:
            break
        k <<= 1
    return sa


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """SA of codes+sentinel. Uses the C++ SA-IS when available.

    BWAMEM_TPU_DEVICE_SA=1 builds it on the card by prefix doubling
    (ops/sa.py); there is no host fallback when the card is missing."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if os.environ.get("BWAMEM_TPU_DEVICE_SA") == "1":
        from ..ops.sa import suffix_array_device

        return suffix_array_device(codes, "cuda")
    if native_sais.available():
        return native_sais.suffix_array(codes)
    return suffix_array_numpy(codes)


def bwt_from_sa(codes: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """Stored-form BWT (sentinel row removed) + primary, bwa conventions.

    The conceptual (n+1)-row BWT of codes+sentinel has the sentinel character
    at row ``primary`` (the row whose suffix starts at text position 0).  bwa
    stores only the n real characters, with that row elided; Occ queries
    re-insert it by index adjustment (see fmindex.py).  Contract anchored at
    the reference's .bwt fixture (src/test/resources/ref.fa.bwt) and the
    mmap'd image consumed via jnibwa.c:154-165.
    """
    n = len(codes)
    assert len(sa) == n + 1
    if native_sais.available():
        return native_sais.bwt_from_sa(codes, sa)
    primary = int(np.nonzero(sa == 0)[0][0])
    full_bwt_src = sa - 1  # char at codes[sa[i]-1]; row with sa[i]==0 is sentinel
    keep = sa != 0
    bwt = np.asarray(codes, dtype=np.uint8)[full_bwt_src[keep]]
    return bwt, primary
