"""FM-index query layer (host/numpy, exact bwa semantics).

Implements the runtime side of the reference engine's [EXT] bwt.c (anchored
in-tree by the `mem_process_seqs` call at jnibwa.c:214): Occ rank queries
over the checkpointed BWT, bidirectional interval extension (bwt_extend
semantics), and sampled-SA position lookup.  All query entry points are
vectorized over numpy arrays so the same code services whole batches; the
TPU path (ops/fmindex_tpu.py) mirrors these semantics and is tested against
this module.

Conceptual coordinates follow bwa: row indices k range over the full
(seq_len+1)-row sorted-rotation matrix whose row `primary` carries the
implicit sentinel; the stored BWT elides that one character, so physical
indices are k - (k >= primary).
"""
from __future__ import annotations

import numpy as np

from ..index.build import OCC_INTERVAL, BwaIndex

_M55 = np.uint32(0x55555555)
_M33 = np.uint32(0x33333333)
_M0F = np.uint32(0x0F0F0F0F)


def _popcount32(x: np.ndarray) -> np.ndarray:
    x = x - ((x >> np.uint32(1)) & _M55)
    x = (x & _M33) + ((x >> np.uint32(2)) & _M33)
    x = (x + (x >> np.uint32(4))) & _M0F
    return (x * np.uint32(0x01010101)) >> np.uint32(24)


class FMIndex:
    """Query-ready FM-index derived from a BwaIndex."""

    def __init__(self, idx: BwaIndex):
        self.idx = idx
        bwt = idx.bwt
        self.primary = bwt.primary
        self.seq_len = bwt.seq_len
        self.L2 = bwt.L2.astype(np.int64)
        self.sa_intv = bwt.sa_intv
        self.sa = bwt.sa
        n_blocks = (self.seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
        self.n_blocks = n_blocks
        # de-interleave the bwa layout into two flat arrays (vectorized):
        #   ckpt[b, c]  counts of c in stored bwt before block b (plus final row)
        #   words[b, w] 8 packed uint32 words (16 chars each) per block
        data = np.asarray(bwt.bwt, dtype=np.uint32)
        ckpt = np.zeros((n_blocks + 1, 4), dtype=np.int64)
        words = np.zeros((n_blocks, 8), dtype=np.uint32)
        words_per_block = np.full(n_blocks, 8, dtype=np.int64)
        last_chars = self.seq_len - (n_blocks - 1) * OCC_INTERVAL
        words_per_block[-1] = (last_chars + 15) // 16
        block_starts = np.zeros(n_blocks, dtype=np.int64)
        np.cumsum(8 + words_per_block[:-1], out=block_starts[1:])
        cidx = (block_starts[:, None] + np.arange(8)[None, :]).reshape(-1)
        ckpt[:n_blocks] = (
            data[cidx].reshape(n_blocks, 8).view(np.uint64).astype(np.int64)
        )
        final_pos = int(block_starts[-1]) + 8 + int(words_per_block[-1])
        ckpt[n_blocks] = (
            data[final_pos : final_pos + 8].view(np.uint64).astype(np.int64)
        )
        if n_blocks > 1:
            didx = ((block_starts[:-1, None] + 8) + np.arange(8)[None, :]).reshape(-1)
            words[: n_blocks - 1] = data[didx].reshape(n_blocks - 1, 8)
        lw = int(words_per_block[-1])
        lb = int(block_starts[-1]) + 8
        words[n_blocks - 1, :lw] = data[lb : lb + lw]
        self.ckpt = ckpt
        self.words = words
        # 4-bit "pattern" per symbol for xor-matching in packed words
        self._patterns = np.array(
            [c * 0x55555555 & 0xFFFFFFFF for c in range(4)], dtype=np.uint32
        )

    # ------------------------------------------------------------------ occ

    def _count_block_prefix(self, block: np.ndarray, nchars: np.ndarray, c: np.ndarray):
        """Count symbol c among the first ``nchars`` chars of each block.

        Vectorized over queries.  Chars are MSB-first 2-bit pairs within each
        of the 8 words per block.
        """
        w = self.words[block]  # [Q, 8]
        pat = self._patterns[c][:, None]  # [Q, 1]
        x = w ^ pat
        # pair==00 means a match: both bits clear
        match = (~x) & ((~x) >> np.uint32(1)) & _M55  # 1 bit per matching char
        # mask chars >= nchars: char j occupies bits {31-2j, 30-2j}; the match
        # bit sits at 30-2j.  For word wi, chars [16wi, 16wi+16).
        nch = nchars[:, None].astype(np.int64)  # [Q, 1]
        word_base = (np.arange(8, dtype=np.int64) * 16)[None, :]  # [1, 8]
        # number of valid chars in each word, clamped to [0, 16]
        valid = np.clip(nch - word_base, 0, 16).astype(np.uint32)
        # keep match bits for the first `valid` chars: bits 30, 28, ... 30-2(valid-1)
        # mask = set bits {30-2j : j < valid}; for valid==16 that is all of _M55
        shift = (np.uint32(32) - np.uint32(2) * valid).astype(np.uint32)
        full = np.uint32(0xFFFFFFFF)
        keep = np.where(
            valid == 0,
            np.uint32(0),
            (full << shift.clip(max=31)).astype(np.uint32),
        )
        keep = np.where(valid == 16, full, keep)
        return _popcount32(match & keep).sum(axis=1).astype(np.int64)

    def occ(self, k: np.ndarray, c: np.ndarray) -> np.ndarray:
        """bwa bwt_occ: count of c among conceptual BWT chars [0..k] inclusive.

        k may be -1 (returns 0) or seq_len (returns total count of c).
        Vectorized; k,c broadcast together.
        """
        k = np.asarray(k, dtype=np.int64)
        c = np.asarray(c, dtype=np.int64)
        k, c = np.broadcast_arrays(k, c)
        k = k.ravel()
        cf = c.ravel()
        out = np.zeros(len(k), dtype=np.int64)
        is_all = k == self.seq_len
        is_none = k == -1
        mid = ~(is_all | is_none)
        out[is_all] = (self.L2[cf[is_all] + 1] - self.L2[cf[is_all]]).astype(np.int64)
        if mid.any():
            kk = k[mid] - (k[mid] >= self.primary)
            block = kk >> 7
            within = (kk & 127) + 1  # inclusive count
            base = self.ckpt[block, cf[mid]]
            out[mid] = base + self._count_block_prefix(block, within, cf[mid])
        return out.reshape(c.shape)

    def occ4(self, k: np.ndarray) -> np.ndarray:
        """Counts of all four symbols among conceptual chars [0..k]; [Q, 4].

        Single gather of the checkpoint row + block words, then all four
        symbol counts from two bit-planes ([EXT] bwt_occ4's job, done SWAR).
        """
        k = np.asarray(k, dtype=np.int64).ravel()
        n = len(k)
        out = np.zeros((n, 4), dtype=np.int64)
        is_all = k == self.seq_len
        is_none = k == -1
        mid = ~(is_all | is_none)
        if is_all.any():
            out[is_all] = (self.L2[1:5] - self.L2[0:4])[None, :]
        if mid.any():
            kk = k[mid] - (k[mid] >= self.primary)
            block = kk >> 7
            within = (kk & 127) + 1  # inclusive count
            base = self.ckpt[block]  # [M, 4] one gather
            w = self.words[block]  # [M, 8] one gather
            # keep-mask for the first `within` chars (bit at 30-2j per char)
            word_base = (np.arange(8, dtype=np.int64) * 16)[None, :]
            valid = np.clip(within[:, None] - word_base, 0, 16).astype(np.uint32)
            shift = (np.uint32(32) - np.uint32(2) * valid).astype(np.uint32)
            full = np.uint32(0xFFFFFFFF)
            keep = np.where(
                valid == 0,
                np.uint32(0),
                (full << shift.clip(max=31)).astype(np.uint32),
            )
            keep = np.where(valid == 16, full, keep)
            keep &= _M55
            hi = (w >> np.uint32(1)) & _M55
            lo = w & _M55
            nhi = ~hi & _M55
            nlo = ~lo & _M55
            cnt = np.empty((kk.shape[0], 4), dtype=np.int64)
            cnt[:, 0] = _popcount32(nhi & nlo & keep).sum(axis=1)
            cnt[:, 1] = _popcount32(nhi & lo & keep).sum(axis=1)
            cnt[:, 2] = _popcount32(hi & nlo & keep).sum(axis=1)
            cnt[:, 3] = _popcount32(hi & lo & keep).sum(axis=1)
            out[mid] = base + cnt
        return out

    # -------------------------------------------------------- interval ops

    def set_intv(self, c: np.ndarray):
        """Initial bi-interval for a single base c ([EXT] bwt_set_intv macro).

        Returns (x0, x1, s): x0 = interval start for the pattern, x1 = start
        for its reverse complement, s = size.
        """
        c = np.asarray(c, dtype=np.int64)
        x0 = self.L2[c] + 1
        x1 = self.L2[3 - c] + 1
        s = self.L2[c + 1] - self.L2[c]
        return x0, x1, s

    def extend(self, x0, x1, s, is_back: bool):
        """Bidirectional extension ([EXT] bwt_extend): all 4 next symbols.

        Input: bi-intervals (x0, x1, s) as int64 arrays [Q] where x0 is the
        pattern interval start, x1 the reverse-complement interval start and
        s the shared size.  Returns (ox0, ox1, osz), each [Q, 4], indexed by
        the *queried-space* symbol exactly like bwa's ok[] array: for
        backward extension (is_back=True) index c is the pattern prepended
        with c; for forward extension (is_back=False) index c is the pattern
        appended with complement(c) — callers append base b by using index
        3-b, mirroring bwamem.c's ``c = 3 - q[i]``.
        """
        x0 = np.asarray(x0, dtype=np.int64)
        x1 = np.asarray(x1, dtype=np.int64)
        s = np.asarray(s, dtype=np.int64)
        nq = len(x0)
        xq = x0 if is_back else x1  # coordinate we Occ-query
        xo = x1 if is_back else x0  # the co-interval coordinate
        tk = self.occ4(xq - 1)  # [Q,4]
        tl = self.occ4(xq - 1 + s)  # [Q,4]
        new_q = self.L2[None, :4] + 1 + tk  # new starts, queried space
        sz = tl - tk  # new sizes per queried symbol
        # the implicit sentinel occupies row `primary`; it precedes symbol 3's
        # slice when stacking co-intervals iff it falls inside [xq, xq+s)
        has_sentinel = ((xq <= self.primary) & (xq + s - 1 >= self.primary)).astype(
            np.int64
        )
        new_o = np.empty((nq, 4), dtype=np.int64)
        new_o[:, 3] = xo + has_sentinel
        new_o[:, 2] = new_o[:, 3] + sz[:, 3]
        new_o[:, 1] = new_o[:, 2] + sz[:, 2]
        new_o[:, 0] = new_o[:, 1] + sz[:, 1]
        if is_back:
            return new_q, new_o, sz
        return new_o, new_q, sz

    def extend_pattern(self, x0, x1, s, c, is_back: bool):
        """Extend by one pattern-space symbol c; returns (x0, x1, s) arrays."""
        ox0, ox1, sz = self.extend(x0, x1, s, is_back)
        c = np.asarray(c, dtype=np.int64)
        idx = c if is_back else 3 - c  # bwa's ok[] index convention
        q = np.arange(len(idx))
        return ox0[q, idx], ox1[q, idx], sz[q, idx]

    # ------------------------------------------------------------ SA lookup

    def sa_lookup(self, k: np.ndarray) -> np.ndarray:
        """Text position of conceptual row k ([EXT] bwt_sa), vectorized."""
        k = np.asarray(k, dtype=np.int64).copy()
        steps = np.zeros_like(k)
        done = np.zeros(len(k), dtype=bool)
        out = np.zeros_like(k)
        while True:
            at_sample = (k % self.sa_intv == 0) & ~done
            if at_sample.any():
                # sa[0] == -1 is load-bearing: a walk that passes the primary
                # row (SA value 0) wraps to row 0, and steps + (-1) yields the
                # correct position mod (seq_len+1) — bwa bwt_sa()'s trick.
                sval = self.sa[k[at_sample] // self.sa_intv]
                out[at_sample] = sval + steps[at_sample]
                done |= at_sample
            if done.all():
                break
            act = ~done
            k[act] = self._inv_psi(k[act])
            steps[act] += 1
        return out

    def _inv_psi(self, k: np.ndarray) -> np.ndarray:
        """LF step ([EXT] bwt_invPsi): row of the predecessor character."""
        k = np.asarray(k, dtype=np.int64)
        kk = k - (k > self.primary)
        c = self._bwt_char(kk)
        res = self.L2[c] + self.occ(k, c)
        return np.where(k == self.primary, np.int64(0), res)

    def _bwt_char(self, phys: np.ndarray) -> np.ndarray:
        """Stored BWT char at physical index (vectorized)."""
        phys = np.asarray(phys, dtype=np.int64)
        block = phys >> 7
        within = phys & 127
        word = self.words[block, within >> 4]
        shift = (np.uint32(30) - np.uint32(2) * (within & 15).astype(np.uint32)).astype(
            np.uint32
        )
        return ((word >> shift) & np.uint32(3)).astype(np.int64)
