"""SMEM seeding ([EXT] bwt_smem1a / bwt_seed_strategy1 / mem_collect_intv).

Produces, per read, the set of super-maximal exact match intervals used to
seed chaining — three rounds, exactly as the reference engine does on the
path under mem_process_seqs (jnibwa.c:214):

  1. all SMEMs with length >= min_seed_len,
  2. re-seeding inside long (>= split_len) low-occurrence SMEMs from their
     middle base with min interval size occ+1,
  3. (if max_mem_intv > 0) LAST-like forward seeds: the first extension from
     each start whose interval drops below max_mem_intv with length >=
     min_seed_len.

Intervals carry (x0, x1, s) bi-interval coordinates plus query [qb, qe).
This is the host oracle; the batched TPU path mirrors it in ops/.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from ..api.options import MemOptions
from .fmindex import FMIndex


class SmemIntv(NamedTuple):
    """Bi-interval + query span ([EXT] bwtintv_t; info = qb<<32|qe)."""

    x0: int
    x1: int
    s: int
    qb: int
    qe: int

    @property
    def qlen(self) -> int:
        return self.qe - self.qb


def _ext1(fm: FMIndex, iv, base: int, is_back: bool):
    """Extend a single (x0, x1, s) by queried-space symbol index, bwa-style.

    For forward extension bwa uses index c = 3 - base into ok[]; for
    backward it uses the base directly.  Returns the full ok[] table
    as three [4] arrays, matching bwt_extend.
    """
    ox0, ox1, sz = fm.extend(
        np.array([iv[0]]), np.array([iv[1]]), np.array([iv[2]]), is_back
    )
    return ox0[0], ox1[0], sz[0]


def smem1a(
    fm: FMIndex,
    q: np.ndarray,
    x: int,
    min_intv: int,
    max_intv: int = 0,
) -> tuple[int, List[SmemIntv]]:
    """All SMEMs covering position x ([EXT] bwt_smem1a).

    Returns (next_x, smems).  q is the read in 2-bit codes with 4 = ambiguous.
    """
    length = len(q)
    if q[x] > 3:
        return x + 1, []
    mems: List[SmemIntv] = []
    x0, x1, s = fm.set_intv(np.array([int(q[x])]))
    ik = [int(x0[0]), int(x1[0]), int(s[0]), x + 1]  # x0, x1, s, info=end
    curr: List[list] = []
    # --- forward extension, collecting intervals where the size changes ---
    i = x + 1
    while i < length:
        if ik[2] < max_intv:  # small enough; stop (3rd-round style)
            curr.append(ik)
            break
        if q[i] < 4:
            c = 3 - int(q[i])  # ok[] index for appending base q[i]
            ox0, ox1, sz = _ext1(fm, ik, c, is_back=False)
            if int(sz[c]) != ik[2]:
                curr.append(ik)
                if int(sz[c]) < min_intv:
                    break
            ik = [int(ox0[c]), int(ox1[c]), int(sz[c]), i + 1]
        else:
            curr.append(ik)
            break
        i += 1
    if i == length:
        curr.append(ik)
    ret = curr[-1][3] if curr else x + 1  # longest forward extension's end
    curr.reverse()  # longest match first, like bwt_reverse_intvs
    prev = curr
    # --- backward extension ---
    i = x - 1
    while i >= -1:
        c = -1 if i < 0 or q[i] > 3 else int(q[i])
        curr = []
        for p in prev:
            if c >= 0 and p[2] >= max_intv:
                ox0, ox1, sz = _ext1(fm, p, c, is_back=True)
            else:
                ox0 = ox1 = sz = None
            if c < 0 or p[2] < max_intv or int(sz[c]) < min_intv:
                # keep the SMEM only for the longest interval at this end
                if not curr:
                    if not mems or i + 1 < mems[-1].qb:
                        mems.append(SmemIntv(p[0], p[1], p[2], i + 1, p[3]))
            elif not curr or int(sz[c]) != curr[-1][2]:
                curr.append([int(ox0[c]), int(ox1[c]), int(sz[c]), p[3]])
        if not curr:
            break
        prev = curr
        i -= 1
    mems.reverse()  # left-to-right by start position
    return ret, mems


def seed_strategy1(
    fm: FMIndex, q: np.ndarray, x: int, min_len: int, max_intv: int
) -> tuple[int, SmemIntv | None]:
    """LAST-like greedy seed ([EXT] bwt_seed_strategy1)."""
    length = len(q)
    if q[x] > 3:
        return x + 1, None
    x0, x1, s = fm.set_intv(np.array([int(q[x])]))
    ik = [int(x0[0]), int(x1[0]), int(s[0])]
    i = x + 1
    while i < length:
        if q[i] < 4:
            c = 3 - int(q[i])
            ox0, ox1, sz = _ext1(fm, ik + [0], c, is_back=False)
            if int(sz[c]) < max_intv and i - x >= min_len:
                return i + 1, SmemIntv(int(ox0[c]), int(ox1[c]), int(sz[c]), x, i + 1)
            ik = [int(ox0[c]), int(ox1[c]), int(sz[c])]
        else:
            return i + 1, None
        i += 1
    return length, None


def collect_intv(opt: MemOptions, fm: FMIndex, q: np.ndarray) -> List[SmemIntv]:
    """Three-round seeding ([EXT] mem_collect_intv), sorted by (qb, qe)."""
    length = len(q)
    mems: List[SmemIntv] = []
    # round 1: all SMEMs
    x = 0
    while x < length:
        if q[x] < 4:
            x, found = smem1a(fm, q, x, 1, 0)
            mems.extend(m for m in found if m.qlen >= opt.min_seed_len)
        else:
            x += 1
    # round 2: re-seed long, low-occurrence SMEMs from the middle
    split_len = opt.split_len
    old = list(mems)
    for p in old:
        if p.qlen < split_len or p.s > opt.split_width:
            continue
        _, found = smem1a(fm, q, (p.qb + p.qe) >> 1, p.s + 1, 0)
        mems.extend(m for m in found if m.qlen >= opt.min_seed_len)
    # round 3: LAST-like
    if opt.max_mem_intv > 0:
        x = 0
        while x < length:
            if q[x] < 4:
                x, m = seed_strategy1(fm, q, x, opt.min_seed_len, opt.max_mem_intv)
                if m is not None and m.s > 0:
                    mems.append(m)
            else:
                x += 1
    # sort by info = qb<<32 | qe (ks_introsort mem_intv)
    mems.sort(key=lambda m: (m.qb << 32) | m.qe)
    return mems
