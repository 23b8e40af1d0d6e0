"""Seeded genomes, reads and seed tables for holding the chain kernels against
their references.

Two kinds of case.  ``genome``/``reads`` are a 41 kbp three-contig genome
with interspersed and tandem repeat families (multi-chain reads, kept codes
below 3) and an ALT contig, and reads from both strands with substitutions
and N runs; ``seed_table`` seeds them with any package's host oracle and
lays the seeds out flat.  ``boundary_table`` needs no index: single-seed
chains whose overlaps and weights land on and beside the ``mask_level`` and
``drop_ratio`` products, where a float32 compare and the oracle's float64
compare part ways.  The same values feed ``bwamem_tpu``'s device program and
host oracle, the port's plain version and its CUDA kernels.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def genome(rng) -> List[np.ndarray]:
    """Three contigs (30, 9 and 2 kbp; the last is the ALT one): a 300 bp
    unit copied to four places of the first, and nine tandem copies of a
    100 bp piece of the first in the second."""
    c0 = rng.integers(0, 4, 30_000).astype(np.uint8)
    c1 = rng.integers(0, 4, 9_000).astype(np.uint8)
    c2 = rng.integers(0, 4, 2_000).astype(np.uint8)
    unit = c0[1000:1300].copy()
    for at in (5_000, 12_000, 21_000, 27_500):
        c0[at: at + 300] = unit
    c1[2_000:2_900] = np.tile(c0[400:500], 9)
    return [c0, c1, c2]


def reads(contigs, rng, n: int, read_len: int = 120) -> List[np.ndarray]:
    """``n`` reads of up to ``read_len`` bases from either strand of the
    contigs, with 2 % substitutions and, in 15 % of them, an N run; then a
    read from inside each repeat copy and one from the tandem block."""
    out = []
    for _ in range(n):
        c = contigs[int(rng.integers(0, len(contigs)))]
        L = min(read_len, len(c) - 1)
        st = int(rng.integers(0, len(c) - L))
        r = c[st: st + L].copy()
        for p in rng.integers(0, L, rng.binomial(L, 0.02)):
            r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        if rng.random() < 0.15:
            p = int(rng.integers(0, L - 3))
            r[p: p + 3] = 4
        if rng.random() < 0.5:
            r = np.where(r < 4, 3 - r, 4)[::-1].copy()
        out.append(r.astype(np.uint8))
    for at in (5_050, 12_080, 21_100):
        out.append(contigs[0][at: at + read_len].copy())
    out.append(contigs[1][2_100: 2_100 + read_len].copy())
    return out


def seed_table(intervals_list, rbegs_list, read_lens):
    """Per-read interval lists (tuples or objects with x0, x1, s, qb, qe in
    that order) and their per-interval reference starts, laid out flat as
    ``engine.native_chain.chain_batch`` takes them: (qlens, rows [N, 5],
    intv_off, n_intv, rbegs, rbeg_off, cnt)."""
    rows = np.asarray([tuple(p) for iv in intervals_list for p in iv],
                      dtype=np.int64).reshape(-1, 5)
    n_intv = np.asarray([len(iv) for iv in intervals_list], dtype=np.int64)
    per = [np.asarray(rb, dtype=np.int64) for rbs in rbegs_list for rb in rbs]
    cnt = np.asarray([len(rb) for rb in per], dtype=np.int64)
    rbegs = np.concatenate(per) if per else np.zeros(0, dtype=np.int64)
    return (np.asarray(read_lens, dtype=np.int32), rows,
            np.cumsum(n_intv) - n_intv, n_intv, rbegs, np.cumsum(cnt) - cnt, cnt)


def boundary_table(mask_level: float, drop_ratio: float, min_seed_len: int = 19):
    """Reads of two single-seed chains 40 kbp apart on one 100 kbp contig.

    Chain A covers query [0, la) with weight la.  In an "overlap" read,
    chain B has weight lb = la - 20 and overlaps A by the integers around
    ``lb * mask_level``; in a "drop" read, B lies inside A's span with the
    weights around ``la * drop_ratio``.  ``la`` runs over 80..150, so the
    products include values that float32 and float64 round apart.  Returns
    (intervals_list, rbegs_list, read_lens, l_pac): intervals as
    (x0, x1, s, qb, qe) tuples in (qb, qe) order, one seed each."""
    ivs, rbs = [], []
    qlen, l_pac = 250, 100_000

    def read(a: Tuple[int, int], b: Tuple[int, int]):
        spans = sorted([(a, 10_000), (b, 50_000)])
        ivs.append([(0, 0, 1, qb, qe) for (qb, qe), _ in spans])
        rbs.append([np.asarray([r], dtype=np.int64) for _, r in spans])

    for la in range(80, 151):
        for d in (-1, 0, 1):
            lb = la - 20
            ov = int(lb * mask_level) + d
            if 0 < ov <= lb:
                read((0, la), (la - ov, la - ov + lb))
            wb = int(la * drop_ratio) + d
            if min_seed_len <= wb <= la - 2 * min_seed_len:
                read((0, la), (1, 1 + wb))
    return ivs, rbs, [qlen] * len(ivs), l_pac
