"""The reference's own index of a genome: bwa's doubled text, its full
suffix array and a full rank table, built from the raw genome codes.

Nothing here comes from the program under test.  The text is what
``bwa index`` indexes: the contigs' forward strands, every ambiguous base
replaced as bwa replaces it (``srand48(11)``, then ``lrand48() & 3`` a base),
followed by the reverse complement of the whole.  The rows are the suffixes
of that text plus a sentinel in sorted order, so row ``k``'s position is
``sa[k]`` and the rank queries of bwa's ``bwt_extend``/``bwt_occ4`` read one
row of ``occ``.  The suffix array is built by prefix doubling with
``torch.sort`` (on the card when one is given, else on the CPU); the tables
then live on the host, where the per-read reference reads them.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


class _Lrand48:
    """drand48-family LCG: bwa seeds ``srand48(11)`` and replaces each
    non-ACGT base with ``lrand48() & 3``."""

    MASK = (1 << 48) - 1

    def __init__(self, seed: int):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def next(self) -> int:
        self.x = (0x5DEECE66D * self.x + 0xB) & self.MASK
        return self.x >> 17


def suffix_array(text: np.ndarray, device) -> torch.Tensor:
    """Suffix array of ``text`` (codes 0-3) with a sentinel smaller than every
    code appended: int64 [len(text) + 1], entry 0 the sentinel's position."""
    n = len(text) + 1
    rank = torch.zeros(n, dtype=torch.int64, device=device)
    rank[:-1] = torch.from_numpy(text.astype(np.int64)).to(device) + 1
    k = 1
    while True:
        nxt = torch.zeros(n, dtype=torch.int64, device=device)
        nxt[: n - k] = rank[k:] + 1
        key = rank * (n + 2) + nxt
        del nxt
        skey, sa = torch.sort(key)
        del key
        new = torch.zeros(n, dtype=torch.int64, device=device)
        new[1:] = torch.cumsum((skey[1:] != skey[:-1]).to(torch.int64), 0)
        del skey
        rank.scatter_(0, sa, new)
        if int(new[-1]) == n - 1:
            return sa
        del new, sa
        k <<= 1


class RefIndex:
    """bwa's index semantics over full tables: contig layout (``bns``),
    sequence fetches, bi-interval extension and suffix-array positions."""

    def __init__(self, contigs: Sequence[Tuple[str, np.ndarray]], device="cpu"):
        rng = _Lrand48(11)
        fwd_parts: List[np.ndarray] = []
        self.anns = []
        offset = 0
        for name, codes in contigs:
            codes = np.array(codes, dtype=np.uint8)
            for i in np.flatnonzero(codes > 3).tolist():
                codes[i] = rng.next() & 3
            self.anns.append(_Ann(offset, name, len(codes)))
            fwd_parts.append(codes)
            offset += len(codes)
        self.l_pac = offset
        self.fwd = np.concatenate(fwd_parts)
        text = np.concatenate([self.fwd, 3 - self.fwd[::-1]])
        self.seq_len = len(text)
        counts = np.bincount(text, minlength=4).astype(np.int64)
        self.L2 = [0] + np.cumsum(counts).tolist()
        sa = suffix_array(text, device)
        t = torch.from_numpy(text).to(device)
        prev = torch.where(sa > 0, sa - 1, torch.zeros_like(sa))
        bwt = torch.where(sa > 0, t[prev].to(torch.int64), torch.full_like(sa, 4))
        del prev, t
        self.primary = int(torch.nonzero(sa == 0)[0, 0])
        occ = torch.zeros((len(sa) + 1, 4), dtype=torch.int32, device=device)
        for c in range(4):
            occ[1:, c] = torch.cumsum((bwt == c).to(torch.int32), 0)
        del bwt
        self.sa = sa.cpu().numpy()
        self.occ = occ.cpu().numpy()
        self.bns = self
        self.work = Work()

    # ------------------------------------------------------------ contigs

    @property
    def n_seqs(self) -> int:
        return len(self.anns)

    def pos_to_rid(self, pos: int) -> int:
        """Contig holding forward position ``pos``, or -1."""
        for rid, a in enumerate(self.anns):
            if a.offset <= pos < a.offset + a.length:
                return rid
        return -1

    def intv_to_rid(self, rb: int, re: int) -> int:
        """bwa's ``bns_intv2rid``: the contig of [rb, re) on the doubled
        text, -1 if it bridges contigs or the strands."""
        if (rb < self.l_pac) != (re <= self.l_pac):
            return -1
        fb = rb if rb < self.l_pac else (self.l_pac << 1) - 1 - (re - 1)
        fe = (re - 1) if rb < self.l_pac else (self.l_pac << 1) - 1 - rb
        rid = self.pos_to_rid(fb)
        if rid < 0 or rid != self.pos_to_rid(fe):
            return -1
        return rid

    def depos(self, pos: int) -> Tuple[int, bool]:
        """bwa's ``bns_depos``: doubled position -> (forward position, is_rev)."""
        is_rev = pos >= self.l_pac
        if is_rev:
            pos = (self.l_pac << 1) - 1 - pos
        return pos, is_rev

    def get_seq(self, beg: int, end: int) -> np.ndarray:
        """Codes of [beg, end) on the doubled text (one strand)."""
        l_pac = self.l_pac
        if beg >= l_pac:
            seg = self.fwd[2 * l_pac - end: 2 * l_pac - beg]
            return (3 - seg[::-1]).astype(np.uint8)
        assert end <= l_pac, "interval spans the strand boundary"
        return self.fwd[beg:end]

    def fetch_seq(self, beg: int, mid: int, end: int):
        """bwa's ``bns_fetch_seq``: [beg, end) clamped to the contig that
        holds ``mid``, on mid's strand -> (codes, beg, end, rid)."""
        l_pac = self.l_pac
        if end < beg:
            beg, end = end, beg
        fpos, is_rev = self.depos(mid)
        rid = self.pos_to_rid(fpos)
        far_beg = self.anns[rid].offset
        far_end = far_beg + self.anns[rid].length
        if is_rev:
            far_beg, far_end = (l_pac << 1) - far_end, (l_pac << 1) - far_beg
        beg = max(beg, far_beg)
        end = min(end, far_end)
        return self.get_seq(beg, end), beg, end, rid

    # -------------------------------------------------------- FM queries

    def set_intv1(self, c: int) -> Tuple[int, int, int]:
        """bwa's ``bwt_set_intv``: the bi-interval of the one-base pattern c."""
        L2 = self.L2
        return L2[c] + 1, L2[3 - c] + 1, L2[c + 1] - L2[c]

    def extend1(self, x0: int, x1: int, s: int, is_back: bool):
        """bwa's ``bwt_extend`` on one bi-interval: (x0[4], x1[4], s[4]),
        indexed as bwa's ``ok[]`` (backward: the pattern prepended with c;
        forward: appended with the complement of c)."""
        xq, xo = (x0, x1) if is_back else (x1, x0)
        self.work.count_extend(xq - 1, xq + s - 1)
        tk = self.occ[xq].tolist()
        tl = self.occ[xq + s].tolist()
        L2 = self.L2
        new_q = [L2[c] + 1 + tk[c] for c in range(4)]
        sz = [tl[c] - tk[c] for c in range(4)]
        o3 = xo + (1 if xq <= self.primary <= xq + s - 1 else 0)
        o2 = o3 + sz[3]
        o1 = o2 + sz[2]
        new_o = [o1 + sz[1], o1, o2, o3]
        if is_back:
            return new_q, new_o, sz
        return new_o, new_q, sz

    def sa_lookup(self, ks) -> np.ndarray:
        """Text positions of rows ``ks``."""
        return self.sa[np.asarray(ks, dtype=np.int64)]


class Work:
    """What the reference computed, as the card's kernels must compute it
    too: ``bwt_extend`` calls and SMEM intervals of seeding, and band cells
    of the chain extension's DP.

    A ``bwt_extend`` counts occurrences at two rows, k and l, as bwa's
    ``bwt_2occ4`` does on its 128-row blocks: a block's 48-byte line (four
    32-bit counts and 128 bases at two bits) holds the counts at its start,
    and the bases of the block up to the row are counted in 16-base words,
    ``(row % 128) // 16 + 1`` of them.  Where k and l share a block, one
    line is read and the count runs on from k to l; otherwise two lines."""

    def __init__(self):
        self.extends = 0
        self.lines = 0
        self.words = 0
        self.cells = 0
        self.intervals = 0

    def count_extend(self, k: int, l: int) -> None:
        self.extends += 1
        if k >= 0 and k >> 7 == l >> 7:
            self.lines += 1
            self.words += ((l & 127) >> 4) + 1
            return
        for row in (k, l):
            if row >= 0:
                self.lines += 1
                self.words += ((row & 127) >> 4) + 1

    def as_dict(self) -> dict:
        return dict(extends=self.extends, lines=self.lines, words=self.words,
                    cells=self.cells, intervals=self.intervals)


class _Ann:
    """One contig: offset on the forward text, name, length."""

    __slots__ = ("offset", "name", "length", "is_alt")

    def __init__(self, offset: int, name: str, length: int):
        self.offset = offset
        self.name = name
        self.length = length
        self.is_alt = 0
