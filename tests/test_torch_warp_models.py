"""Numpy models of the warp-level reformulations in the port's CUDA kernels,
held against the scalar recurrences they replace.

* ``ksw_extend_warp`` (csrc/extend.cuh): a target row's band over 32 lanes
  of 1, 2, 3 or 5 cells a pass, F as a max-plus prefix scan (lane-local
  scan, scan of the lane totals, carry across passes), H(i, j-1) from the
  lane below, the row max at its last column as one reduction of a packed
  (h, j), the band shrink from the first and last live cells.  Against the scalar ``ksw_extend_core`` written out here
  (rows and band cells included) and ``ops.extend.ksw_extend_torch``.
* ``smem1a_warp``'s backward step (csrc/seed.cu): the intervals of prev a
  lane each, survivors kept when their size differs from the previous
  survivor's, at most one SMEM a step (prev[0]).  Against the serial list
  logic of ``engine.seed.smem1a`` on random lists, and a whole smem1a built
  on it against ``engine.seed.smem1a`` on the seeding cases' reads.
* ``collect_intv_kernel``'s rank sort against the stable (qb, qe) sort.

These are models of the kernels' arithmetic for the CPU, where no kernel
runs; nothing on the port's path imports them.  Integers, tolerance 0.
"""
import numpy as np
import pytest
import torch

from bwamem_tpu_torch.engine.fmindex import FMIndex
from bwamem_tpu_torch.engine.seed import smem1a
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.ops import extend as ext
from bwamem_tpu_torch.utils import seed_cases
from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

LANES, CHUNK = 32, 5  # csrc/extend.cuh: lanes of a warp, most cells a lane
PASS = LANES * CHUNK
NO_PREFIX = -(1 << 30)
BIG = 1 << 40
KEYS = ("score", "qle", "tle", "gtle", "gscore", "max_off", "rows", "cells")


# ------------------------------------------------------------ ksw extension

def scalar_extend(q, t, h0, w, mat, o_del, e_del, o_ins, e_ins, zdrop,
                  why=None, widths=None):
    """csrc/extend.cuh ``ksw_extend_core`` line for line (``w`` after
    ``band_width``): the six results, rows and band cells; ``why`` (a list)
    gets the cause of an early stop ("zero" or "zdrop"), ``widths`` each
    row's band width."""
    qlen, tlen = len(q), len(t)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    H = [h0] + [max(h0 - oe_ins - (j - 1) * e_ins, 0) for j in range(1, qlen + 1)]
    E = [0] * (qlen + 1)
    maxv, max_i, max_j, max_ie, gscore, max_off = h0, -1, -1, -1, -1, 0
    beg, end, cells, i = 0, qlen, 0, 0
    while i < tlen:
        qp = mat[t[i]]
        f = m = 0
        mj = -1
        beg = max(beg, i - w)
        end = min(end, i + w + 1, qlen)
        h1 = max(h0 - (o_del + e_del * (i + 1)), 0) if beg == 0 else 0
        if end > beg:
            cells += end - beg
        widths is None or widths.append(end - beg)
        for j in range(beg, end):
            M, e = H[j], E[j]
            H[j] = h1
            M = M + qp[q[j]] if M else 0
            h = max(M, e, f)
            h1 = h
            if h >= m:
                m, mj = h, j
            e = max(e - e_del, M - oe_del, 0)
            E[j] = e
            f = max(f - e_ins, M - oe_ins, 0)
        H[end], E[end] = h1, 0
        if end == qlen and gscore <= h1:
            max_ie, gscore = i, h1
        if m == 0:
            why is None or why.append("zero")
            break
        if m > maxv:
            maxv, max_i, max_j = m, i, mj
            max_off = max(max_off, abs(mj - i))
        elif zdrop > 0:
            di, dj = i - max_i, mj - max_j
            gap = (di - dj) * e_del if di > dj else (dj - di) * e_ins
            if maxv - m - gap > zdrop:
                why is None or why.append("zdrop")
                break
        j = beg
        while j < end and H[j] == 0 and E[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and H[j] == 0 and E[j] == 0:
            j -= 1
        end = min(j + 2, qlen)
        i += 1
    return dict(score=maxv, qle=max_j + 1, tle=max_i + 1, gtle=max_ie + 1,
                gscore=gscore, max_off=max_off, rows=min(i + 1, tlen), cells=cells)


def chunk_for(n, lanes=LANES):
    """ksw_extend_group's cells a lane for a row of ``n`` cells on a group of
    ``lanes``: the least of 1, 2, 3, 5 that covers the row in one pass, else
    160 / lanes (at least 5) and passes."""
    big = max(CHUNK, PASS // lanes)
    return np.where(n <= lanes, 1, np.where(n <= 2 * lanes, 2, np.where(
        n <= 3 * lanes, 3, np.where(n <= 5 * lanes, 5, big))))


def warp_extend(qs, ts, qlens, tlens, h0, w, mat, o_del, e_del, o_ins, e_ins,
                zdrop, lanes=LANES):
    """``ksw_extend_group`` (a group of ``lanes``; ``ksw_extend_warp``: 32)
    on J jobs at once: per row and pass, each job's cells [base, base +
    lanes C) as [J, lanes, C] (lane l's C cells, the rest masked), C by
    ``chunk_for``; every step a lane takes is a step here along the lane
    axes.  ``qs`` [J, Q], ``ts`` [J, T] codes, ``w`` after ``band_width``;
    int64 throughout."""
    LANES = lanes
    CHUNK = max(5, PASS // lanes)
    J, Q = qs.shape
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    jj = np.arange(Q + 2)
    H = np.where(jj == 0, h0[:, None],
                 np.maximum(h0[:, None] - oe_ins - (jj - 1) * e_ins, 0))
    E = np.zeros((J, Q + 2), np.int64)
    beg, end = np.zeros(J, np.int64), qlens.copy()
    maxv, max_off = h0.copy(), np.zeros(J, np.int64)
    max_i, max_j, max_ie, gscore = (np.full(J, -1, np.int64) for _ in range(4))
    cells, rows = np.zeros(J, np.int64), tlens.copy()
    done = tlens <= 0
    lane = np.arange(LANES)[None, :, None]
    kk = np.arange(CHUNK)[None, None, :]
    for i in range(int(tlens.max(initial=0))):
        a = np.flatnonzero(~done & (i < tlens))
        if not a.size:
            break
        A = a.size
        r = np.arange(A)
        srow = mat[ts[a, i]]  # [A, 5]: the row's scores, one a query code
        b = np.maximum(beg[a], i - w[a])
        e = np.minimum(np.minimum(end[a], i + w[a] + 1), qlens[a])
        h1 = np.where(b == 0, np.maximum(h0[a] - (o_del + e_del * (i + 1)), 0), 0)
        n = e - b
        cells[a] += np.maximum(n, 0)
        C = chunk_for(n, LANES)[:, None, None]
        hc, pc = h1.copy(), np.full(A, NO_PREFIX)
        key, hl = np.full((A, LANES), -1), np.full((A, LANES), -1)
        lo, hi = np.full((A, LANES), BIG), np.full((A, LANES), -1)
        n_pass = int(np.max(-(-n // (LANES * C[:, 0, 0])), initial=0))
        for p in range(n_pass):
            j = (b + p * LANES * C[:, 0, 0])[:, None, None] + lane * C + kk
            ok = (kk < C) & (j < e[:, None, None])  # [A, LANES, CHUNK]
            jc = np.clip(j, 0, Q)
            raw = H[a[:, None, None], jc]
            sc = srow[r[:, None, None], qs[a[:, None, None], np.minimum(jc, Q - 1)]]
            Mv = np.where(ok & (raw != 0), raw + sc, 0)
            Ev = np.where(ok, E[a[:, None, None], jc], 0)
            v = np.where(ok, np.maximum(Mv - oe_ins, 0) + j * e_ins, NO_PREFIX)
            # exclusive max scan of the lane totals after the earlier passes
            inc = np.maximum.accumulate(v.max(2), axis=1)
            run0 = np.maximum(np.concatenate(
                [np.full((A, 1), NO_PREFIX), inc[:, :-1]], 1), pc[:, None])
            pc = np.maximum(pc, inc[:, -1])
            local = np.concatenate([np.full((A, LANES, 1), NO_PREFIX),
                                    np.maximum.accumulate(v, axis=2)[:, :, :-1]], 2)
            run = np.maximum(run0[:, :, None], local)
            f = run - (j - 1) * e_ins  # F at beg may be anything <= 0: E >= 0
            h = np.where(ok, np.maximum(np.maximum(Mv, Ev), f), 0)
            En = np.where(ok, np.maximum(Ev - e_del, np.maximum(Mv - oe_del, 0)), 0)
            # H(i, j-1): the lane's previous cell, or the lane below's last
            last_of = np.take_along_axis(h, C - 1, 2)[:, :, 0]  # [A, LANES]
            below = np.concatenate([hc[:, None], last_of[:, :-1]], 1)
            hp = np.concatenate([below[:, :, None], h[:, :, :-1]], 2)
            ra, la, ka = np.nonzero(ok)
            H[a[ra], j[ra, la, ka]] = hp[ra, la, ka]
            E[a[ra], j[ra, la, ka]] = En[ra, la, ka]
            live = ok & ((hp | En) != 0)
            key = np.maximum(key, np.where(ok, h << 12 | j, -1).max(2))
            hl = np.maximum(hl, np.where(ok & (j == e[:, None, None] - 1), h, -1).max(2))
            lo = np.minimum(lo, np.where(live, j, BIG).min(2))
            hi = np.maximum(hi, np.where(live, j, -1).max(2))
            hc = last_of[:, -1]
        # the warp reductions: the packed row max, H(i, end-1), live cells
        has = n > 0
        k = key.max(1)
        m, mj = np.where(has, k >> 12, 0), np.where(has, k & 4095, -1)
        h_last = np.where(has, hl.max(1), h1)
        first = np.where(has, np.minimum(lo.min(1), e), e)
        last = np.where(has, hi.max(1), -1)
        H[a, e], E[a, e] = h_last, 0
        g = (e == qlens[a]) & (gscore[a] <= h_last)
        max_ie[a[g]], gscore[a[g]] = i, h_last[g]
        stop = m == 0
        better = ~stop & (m > maxv[a])
        up = a[better]
        maxv[up], max_i[up], max_j[up] = m[better], i, mj[better]
        max_off[up] = np.maximum(max_off[up], np.abs(mj[better] - i))
        if zdrop > 0:
            di, dj = i - max_i[a], mj - max_j[a]
            gap = np.where(di > dj, (di - dj) * e_del, (dj - di) * e_ins)
            stop |= ~stop & ~better & (maxv[a] - m - gap > zdrop)
        rows[a[stop]] = i + 1
        done[a[stop]] = True
        # the band shrink: first live cell of [beg, end), last of [beg, end]
        jl = np.where(h_last != 0, e, np.where(last >= 0, last, first - 1))
        beg[a], end[a] = first, np.minimum(jl + 2, qlens[a])
    return dict(score=maxv, qle=max_j + 1, tle=max_i + 1, gtle=max_ie + 1,
                gscore=gscore, max_off=max_off, rows=rows, cells=cells)


def _jobs(rng, n, qmax):
    """``n`` jobs: targets that are mutated copies of the query (long
    high-scoring extensions, indels that move the band) or random, h0 from
    0 (no ramp) to past the gap penalties, bands from 1 to wider than the
    query (up to 300 on long jobs: rows of several passes)."""
    jobs = []
    for _ in range(n):
        ql = int(rng.integers(1, qmax + 1))
        q = rng.integers(0, 5 if rng.random() < 0.2 else 4, ql)
        if rng.random() < 0.7:
            t = q.copy()
            for _ in range(int(rng.integers(0, 1 + ql // 15))):
                p, k = int(rng.integers(0, len(t) + 1)), int(rng.integers(1, 8))
                r = rng.random()
                if r < 0.4:
                    t[min(p, len(t) - 1)] = rng.integers(0, 4)
                elif r < 0.7:
                    t = np.concatenate([t[:p], rng.integers(0, 4, k), t[p:]])
                else:
                    t = np.concatenate([t[:p], t[p + k:]])
            t = np.concatenate([t, rng.integers(0, 4, int(rng.integers(0, 40)))])
        else:
            t = rng.integers(0, 4, int(rng.integers(1, qmax + 40)))
        h0 = int(rng.choice([0, 1, 5, 19, 30, 60, 150, 400, 900]))
        w = int(rng.integers(1, 130 if qmax <= 150 else 300))
        jobs.append((q.astype(np.int64), t.astype(np.int64), h0, w,
                     int(rng.integers(0, 12))))
    return jobs


SCORINGS = {  # (mat from a, b; o_del, e_del, o_ins, e_ins; zdrop)
    "bwa": (1, 4, 6, 1, 6, 1, 100),
    "zdrop_tight": (1, 4, 6, 1, 6, 1, 8),
    "no_zdrop": (2, 5, 9, 3, 4, 2, 0),
}


def _mat(a, b):
    m = np.full((5, 5), -b, np.int64)
    np.fill_diagonal(m, a)
    m[4, :] = m[:, 4] = -1
    return m


def _run(jobs, scoring):
    a, b, o_del, e_del, o_ins, e_ins, zdrop = SCORINGS[scoring]
    mat = _mat(a, b)
    J = len(jobs)
    Q = max(len(q) for q, *_ in jobs)
    T = max(len(t) for _, t, *_ in jobs)
    qs, ts = np.full((J, Q), 4, np.int64), np.zeros((J, T), np.int64)
    for k, (q, t, *_) in enumerate(jobs):
        qs[k, : len(q)], ts[k, : len(t)] = q, t
    qlens = np.array([len(q) for q, *_ in jobs], np.int64)
    tlens = np.array([len(t) for _, t, *_ in jobs], np.int64)
    h0 = np.array([j[2] for j in jobs], np.int64)
    w = np.array([j[3] for j in jobs], np.int64)
    bonus = np.array([j[4] for j in jobs], np.int64)
    tt = [torch.from_numpy(x).int() for x in (qlens, w, bonus)]
    w_adj = ext.band_width(*tt, int(mat.max()), o_del, e_del, o_ins,
                           e_ins).long().numpy()
    got = warp_extend(qs, ts, qlens, tlens, h0, w_adj, mat, o_del, e_del, o_ins,
                      e_ins, zdrop)
    plain = ext.ksw_extend_torch(
        torch.from_numpy(qs).int(), torch.from_numpy(ts).int(), *(
            torch.from_numpy(x).int() for x in (qlens, tlens, h0, w, bonus)),
        torch.from_numpy(mat).int(), o_del, e_del, o_ins, e_ins, zdrop,
        int(mat.max()), count=True)
    return got, plain, mat, w_adj, (o_del, e_del, o_ins, e_ins, zdrop)


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_warp_row_step_matches_scalar_extension(scoring):
    """900 seeded jobs of up to 150 bases (one pass a row, 1 to 5 cells a
    lane) and 12 of up to 1,500 (rows of several passes): every result,
    rows and band cells included, equals the plain version's; all of them
    equal the scalar recurrence's, on every long job and a sample of the
    short ones."""
    rng = np.random.default_rng(sorted(SCORINGS).index(scoring) + 70)
    torch.set_num_threads(1)
    for jobs, every in ((_jobs(rng, 300, 150), 12), (_jobs(rng, 4, 1500), 1)):
        got, plain, mat, w_adj, pen = _run(jobs, scoring)
        for k in ext.KEYS + ("rows", "cells"):
            assert np.array_equal(got[k], plain[k].long().numpy()), k
        for n in range(0, len(jobs), every):
            q, t, h0, _, _ = jobs[n]
            ref = scalar_extend(q, t, h0, int(w_adj[n]), mat, *pen)
            assert {k: int(got[k][n]) for k in KEYS} == ref, n


def test_warp_row_step_covers_its_cases():
    """The seeded jobs reach what the row step has to get right: rows of
    each chunk size and of several passes, z-drop and m == 0 breaks, a band
    that regrows past its last end (over stale cells), and h0 ramps."""
    rng = np.random.default_rng(71)
    jobs = _jobs(rng, 300, 150) + _jobs(rng, 4, 1500)
    seen = dict(c1=0, c2=0, c3=0, c5=0, passes=0, zdrop=0, zero=0, regrow=0,
                ramp=0)
    for n, (q, t, h0, w, bonus) in enumerate(jobs):
        a, b, o_del, e_del, o_ins, e_ins, zdrop = SCORINGS[
            "zdrop_tight" if n % 2 else "bwa"]
        mat = _mat(a, b)
        w = int(ext.band_width(*(torch.tensor([v]) for v in (len(q), w, bonus)),
                               a, o_del, e_del, o_ins, e_ins)[0])
        why, widths = [], []
        scalar_extend(q, t, h0, w, mat, o_del, e_del, o_ins, e_ins, zdrop, why,
                      widths)
        widths = np.asarray(widths)
        c = chunk_for(widths[widths > 0])
        for k in (1, 2, 3, 5):
            seen[f"c{k}"] += int((c == k).sum())
        seen["passes"] += int((widths > PASS).sum())
        seen["ramp"] += h0 > o_ins + e_ins
        for cause in why:
            seen[cause] += 1
        seen["regrow"] += _regrows(q, t, h0, w, mat, o_del, e_del, o_ins, e_ins)
    assert all(v > 0 for v in seen.values()), str(seen)


def _regrows(q, t, h0, w, mat, o_del, e_del, o_ins, e_ins):
    """Whether the band's end ever grows past where it stood (the scalar's
    shrink rule ``end = min(j + 2, qlen)``), so stale cells are read."""
    qlen = len(q)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    H = [h0] + [max(h0 - oe_ins - (j - 1) * e_ins, 0) for j in range(1, qlen + 1)]
    E = [0] * (qlen + 1)
    beg, end = 0, qlen
    for i in range(len(t)):
        beg, end = max(beg, i - w), min(end, i + w + 1, qlen)
        h1 = max(h0 - (o_del + e_del * (i + 1)), 0) if beg == 0 else 0
        f = m = 0
        for j in range(beg, end):
            M, e = H[j], E[j]
            H[j] = h1
            M = M + mat[t[i]][q[j]] if M else 0
            h1 = max(M, e, f)
            m = max(m, h1)
            E[j] = max(e - e_del, M - oe_del, 0)
            f = max(f - e_ins, M - oe_ins, 0)
        H[end], E[end] = h1, 0
        if m == 0:
            return False
        j = beg
        while j < end and H[j] == 0 and E[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and H[j] == 0 and E[j] == 0:
            j -= 1
        if min(j + 2, qlen) > end + 1:
            return True
        end = min(j + 2, qlen)
    return False


# ------------------------------------------------------- smem1a backward step

def serial_step(sizes, dead, gate):
    """``engine.seed.smem1a``'s backward step over prev's extended sizes:
    (whether an SMEM is emitted, the indices of prev kept in curr)."""
    kept, emitted = [], False
    for j in range(len(sizes)):
        if dead[j]:
            if not kept and gate:
                emitted, gate = True, False  # the next SMEM must start left
        elif not kept or sizes[j] != sizes[kept[-1]]:
            kept.append(j)
    return emitted, kept


def warp_step(sizes, dead, gate):
    """``smem1a_warp``'s backward step: prev in rounds of 32 lanes; a
    survivor is kept when its size differs from the previous survivor's
    (the highest surviving lane below it, else the last survivor of an
    earlier round), the slot of a kept one is a popcount of the ballot; the
    one SMEM is prev[0]'s, when it dies and the gate is open."""
    sizes, dead = np.asarray(sizes), np.asarray(dead, bool)
    n = len(sizes)
    emitted = bool(n and dead[0] and gate)
    kept, seen, last_s = [], False, 0
    for j0 in range(0, n, LANES):
        lane = np.arange(min(LANES, n - j0))
        s, surv = sizes[j0 + lane], ~dead[j0 + lane]
        below = np.maximum.accumulate(np.where(surv, lane, -1))
        below = np.concatenate([[-1], below[:-1]])  # highest survivor under each lane
        ps = np.where(below >= 0, s[np.maximum(below, 0)], last_s)
        keep = surv & np.where(below >= 0, s != ps, ~np.array(seen) | (s != last_s))
        kept += (j0 + lane[keep]).tolist()
        if surv.any():
            seen, last_s = True, int(s[np.flatnonzero(surv)[-1]])
    return emitted, kept


def test_warp_backward_step_matches_serial_on_random_lists():
    """Lists of 1 to 100 intervals (up to four rounds of 32) with sizes
    drawn from a few values, so that runs of equal sizes span dead entries
    and round boundaries."""
    rng = np.random.default_rng(72)
    for _ in range(3000):
        n = int(rng.integers(1, 101))
        sizes = rng.integers(1, int(rng.integers(2, 6)), n)
        dead = rng.random(n) < rng.random()
        gate = bool(rng.random() < 0.7)
        assert warp_step(sizes, dead, gate) == serial_step(sizes, dead, gate)


def smem1a_model(fm, q, x, min_intv):
    """smem1a with ``warp_step`` for the backward pass, as ``smem1a_warp``
    runs it (max_intv = 0): (next start, SMEMs in ascending qb, intervals
    extended)."""
    if x >= len(q) or q[x] > 3:
        return x + 1, [], 0
    x0, x1, s = (int(v[0]) for v in fm.set_intv(np.array([int(q[x])])))
    ik, curr, n_ext, i = (x0, x1, s, x + 1), [], 0, x + 1
    while i < len(q):
        if q[i] > 3:
            curr.append(ik)
            break
        c = 3 - int(q[i])
        ox0, ox1, sz = fm.extend(*(np.array([v]) for v in ik[:3]), False)
        n_ext += 1
        if int(sz[0, c]) != ik[2]:
            curr.append(ik)
            if int(sz[0, c]) < min_intv:
                break
        ik = (int(ox0[0, c]), int(ox1[0, c]), int(sz[0, c]), i + 1)
        i += 1
    if i == len(q):
        curr.append(ik)
    ret, prev, mems = curr[-1][3], curr[::-1], []
    for i in range(x - 1, -2, -1):
        c = -1 if i < 0 or q[i] > 3 else int(q[i])
        if c >= 0:
            ox0, ox1, sz = fm.extend(*(np.array([p[k] for p in prev]) for k in range(3)),
                                     True)
            n_ext += len(prev)
            nxt = [(int(ox0[k, c]), int(ox1[k, c]), int(sz[k, c]), p[3])
                   for k, p in enumerate(prev)]
        else:
            nxt = [None] * len(prev)
        dead = [c < 0 or v[2] < min_intv for v in nxt]
        gate = not mems or i + 1 < mems[-1][3]
        emitted, kept = warp_step([0 if v is None else v[2] for v in nxt], dead, gate)
        if emitted:
            p = prev[0]
            mems.append((p[0], p[1], p[2], i + 1, p[3]))
        if not kept:
            break
        prev = [nxt[k] for k in kept]
    return ret, mems[::-1], n_ext


@pytest.fixture(scope="module")
def seed_data():
    rng = np.random.default_rng(404)
    contigs, kread = seed_cases.genome(rng)
    fm = FMIndex(build_index(Fasta([FastaContig(f"c{i}", "", c)
                                    for i, c in enumerate(contigs)]), sa_intv=32))
    return fm, seed_cases.reads(contigs, kread, rng)


def test_warp_backward_step_matches_smem1a_on_reads(seed_data):
    """smem1a built on the warp step equals engine.seed.smem1a on half the
    seeding cases' lanes (reads from 0, from a random start, from the
    middle with a larger minimum interval), and extends as many intervals
    as the oracle does."""
    fm, reads = seed_data
    calls = [0]
    extend = fm.extend

    def counted(x0, *args):
        calls[0] += len(x0)
        return extend(x0, *args)

    for i, x, m in seed_cases.lanes(reads, 5)[::2]:
        ret, mems, n_ext = smem1a_model(fm, reads[i], x, m)
        if x >= len(reads[i]) or reads[i][x] > 3:
            assert (ret, mems, n_ext) == (x + 1, [], 0)
            continue
        calls[0] = 0
        fm.extend = counted
        try:
            exp_ret, exp = smem1a(fm, reads[i], x, m)
        finally:
            del fm.extend
        assert (ret, mems, n_ext) == (exp_ret, [tuple(p) for p in exp], calls[0])


# ----------------------------------------------------------------- rank sort

def test_rank_sort_matches_stable_sort():
    """A row's slot is the rows with a smaller (qb, qe) plus the rows of an
    equal key before it: the stable sort's order, ties included."""
    rng = np.random.default_rng(73)
    for _ in range(500):
        n = int(rng.integers(0, 49))
        qb, qe = rng.integers(0, 8, n), rng.integers(0, 4, n)
        rank = [int(np.sum((qb < qb[a]) | ((qb == qb[a]) & (qe < qe[a])))
                    + np.sum((qb[:a] == qb[a]) & (qe[:a] == qe[a])))
                for a in range(n)]
        order = sorted(range(n), key=lambda a: (qb[a], qe[a]))
        assert sorted(range(n), key=lambda a: rank[a]) == order
        assert sorted(rank) == list(range(n))
