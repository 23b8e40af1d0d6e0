"""Lockstep-batched SMEM seeding.

Same SMEM semantics as engine/seed.py (bwt_smem1a / bwt_seed_strategy1 /
mem_collect_intv), restructured for throughput: every read runs its own
state machine as a generator that *yields* bidirectional-extension requests;
a lockstep loop batches all pending requests across reads into one
vectorized FMIndex.extend call per direction per tick.  This turns the
reference's per-read Occ() random-access loop (SURVEY.md hot loop #1) into
wide batched rank queries — the same data layout the TPU occ kernel
(ops/fmindex_tpu.py) consumes.

Exactness: validated against the per-read path on random reads
(tests/test_seed_batch.py).
"""
from __future__ import annotations

from typing import Generator, List, Tuple

import numpy as np

from ..api.options import MemOptions
from .fmindex import FMIndex
from .seed import SmemIntv

# a request is (is_back, x0, x1, s); the response is (ox0[4], ox1[4], sz[4])
Request = Tuple[bool, int, int, int]


def _set_intv(fm: FMIndex, c: int):
    x0 = int(fm.L2[c]) + 1
    x1 = int(fm.L2[3 - c]) + 1
    s = int(fm.L2[c + 1] - fm.L2[c])
    return x0, x1, s


def smem1a_gen(fm: FMIndex, q: np.ndarray, x: int, min_intv: int, max_intv: int):
    """Generator form of [EXT] bwt_smem1a; returns (next_x, smems)."""
    length = len(q)
    if q[x] > 3:
        return x + 1, []
    mems: List[SmemIntv] = []
    x0, x1, s = _set_intv(fm, int(q[x]))
    ik = [x0, x1, s, x + 1]
    curr: List[list] = []
    i = x + 1
    while i < length:
        if ik[2] < max_intv:
            curr.append(ik)
            break
        if q[i] < 4:
            c = 3 - int(q[i])
            ox0, ox1, sz = yield (False, ik[0], ik[1], ik[2])
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
    ret = curr[-1][3] if curr else x + 1
    curr.reverse()  # longest match first
    prev = curr
    i = x - 1
    while i >= -1:
        c = -1 if i < 0 or q[i] > 3 else int(q[i])
        curr = []
        for p in prev:
            if c >= 0 and p[2] >= max_intv:
                ox0, ox1, sz = yield (True, p[0], p[1], p[2])
            else:
                ox0 = ox1 = sz = None
            if c < 0 or p[2] < max_intv or int(sz[c]) < min_intv:
                if not curr:
                    if not mems or i + 1 < mems[-1].qb:
                        mems.append(SmemIntv(p[0], p[1], p[2], i + 1, p[3]))
            elif not curr or int(sz[c]) != curr[-1][2]:
                curr.append([int(ox0[c]), int(ox1[c]), int(sz[c]), p[3]])
        if not curr:
            break
        prev = curr
        i -= 1
    mems.reverse()
    return ret, mems


def seed_strategy1_gen(fm: FMIndex, q: np.ndarray, x: int, min_len: int, max_intv: int):
    """Generator form of [EXT] bwt_seed_strategy1; returns (next_x, seed|None)."""
    length = len(q)
    if q[x] > 3:
        return x + 1, None
    ik = list(_set_intv(fm, int(q[x])))
    i = x + 1
    while i < length:
        if q[i] < 4:
            c = 3 - int(q[i])
            ox0, ox1, sz = yield (False, ik[0], ik[1], ik[2])
            if int(sz[c]) < max_intv and i - x >= min_len:
                return i + 1, SmemIntv(int(ox0[c]), int(ox1[c]), int(sz[c]), x, i + 1)
            ik = [int(ox0[c]), int(ox1[c]), int(sz[c])]
        else:
            return i + 1, None
        i += 1
    return length, None


def collect_intv_gen(opt: MemOptions, fm: FMIndex, q: np.ndarray):
    """Generator form of [EXT] mem_collect_intv; returns sorted SmemIntv list."""
    length = len(q)
    mems: List[SmemIntv] = []
    x = 0
    while x < length:
        if q[x] < 4:
            x, found = yield from smem1a_gen(fm, q, x, 1, 0)
            mems.extend(m for m in found if m.qlen >= opt.min_seed_len)
        else:
            x += 1
    split_len = opt.split_len
    old = list(mems)
    for p in old:
        if p.qlen < split_len or p.s > opt.split_width:
            continue
        _, found = yield from smem1a_gen(fm, q, (p.qb + p.qe) >> 1, p.s + 1, 0)
        mems.extend(m for m in found if m.qlen >= opt.min_seed_len)
    if opt.max_mem_intv > 0:
        x = 0
        while x < length:
            if q[x] < 4:
                x, m = yield from seed_strategy1_gen(
                    fm, q, x, opt.min_seed_len, opt.max_mem_intv
                )
                if m is not None and m.s > 0:
                    mems.append(m)
            else:
                x += 1
    mems.sort(key=lambda m: (m.qb << 32) | m.qe)
    return mems


def run_lockstep(fm: FMIndex, gens: List[Generator]):
    """Drive generators to completion, batching their extend requests.

    Returns the list of generator return values (same order).
    """
    n = len(gens)
    results = [None] * n
    pending: List[Tuple[int, Request]] = []
    for idx, g in enumerate(gens):
        try:
            req = g.send(None)
            pending.append((idx, req))
        except StopIteration as st:
            results[idx] = st.value
    while pending:
        responses = _serve(fm, [r for _, r in pending])
        nxt: List[Tuple[int, Request]] = []
        for (idx, _), resp in zip(pending, responses):
            try:
                req = gens[idx].send(resp)
                nxt.append((idx, req))
            except StopIteration as st:
                results[idx] = st.value
        pending = nxt
    return results


def _serve(fm: FMIndex, reqs: List[Request]):
    """One tick: batch all requests into <=2 vectorized extend calls."""
    out = [None] * len(reqs)
    for want_back in (False, True):
        idxs = [i for i, r in enumerate(reqs) if r[0] == want_back]
        if not idxs:
            continue
        x0 = np.array([reqs[i][1] for i in idxs], dtype=np.int64)
        x1 = np.array([reqs[i][2] for i in idxs], dtype=np.int64)
        s = np.array([reqs[i][3] for i in idxs], dtype=np.int64)
        ox0, ox1, sz = fm.extend(x0, x1, s, want_back)
        for row, i in enumerate(idxs):
            out[i] = (ox0[row], ox1[row], sz[row])
    return out


def collect_intv_batch(
    opt: MemOptions, fm: FMIndex, reads: List[np.ndarray]
) -> List[List[SmemIntv]]:
    """Three-round seeding for a batch of reads, occ queries batched."""
    gens = [collect_intv_gen(opt, fm, q) for q in reads]
    return run_lockstep(fm, gens)
