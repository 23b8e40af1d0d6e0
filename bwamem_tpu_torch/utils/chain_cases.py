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


# three contigs of the warp cases' reference (offset, length, is_alt)
WARP_CONTIGS = ((0, 300_000, 0), (300_000, 80_000, 0), (380_000, 20_000, 1))
WARP_L_PAC = 400_000


def warp_table(rng, n_random: int = 40):
    """Reads whose seeds drive ``chain_kernel``'s warp steps to their edges,
    on the reference ``WARP_CONTIGS`` (no index: seeds are given).  Returns
    (names, intervals_list, rbegs_list, read_lens) as ``boundary_table``
    does, one name a read:

    * "equal_keys": 40 chains of one key (past a 32-lane chunk), a seed
      that joins the last of them (bisect_right), one that opens a chain
      before them all, one that opens a chain after them;
    * "key_vs_creation": chains of equal weight created in another order
      than their keys', and unequal weights among them;
    * "break_first", "break_last", "large_no_break", "alt_skip": the
      shadowing walk breaking at its first kept chain, at its last, not
      breaking with large overlaps on two chains, and skipping an ALT one;
    * "c128", "c129": 128 chains (the budget), then one more (flagged);
    * "short", "empty": a read below min_seed_len, a read with no seeds;
    * "random_*": seeds from both strands and all contigs (some across a
      contig end), repeats past max_occ, equal starts, 30-400 seeds."""
    names, ivs, rbs, qlens = [], [], [], []

    def read(name, seeds, qlen):
        """seeds: (qb, len, [rbeg, ...], s) a seed interval each."""
        names.append(name)
        ivs.append([(0, 0, s, qb, qb + ln) for qb, ln, _, s in seeds])
        rbs.append([np.asarray(r, dtype=np.int64) for _, _, r, _ in seeds])
        qlens.append(qlen)

    eq = [(200 * k, 25, [1000], 1) for k in range(40)]
    eq += [(8_050, 25, [1_230], 1), (8_400, 25, [500], 1),
           (8_800, 25, [1_000], 1), (9_000, 30, [1_000, 2_000], 2)]
    read("equal_keys", eq, 9_100)
    read("key_vs_creation",
         [(0, 30, [30_000], 1), (50, 30, [10_000], 1), (100, 30, [20_000], 1),
          (150, 45, [5_000], 1), (200, 30, [25_000], 1), (250, 20, [40_000], 1)],
         400)
    read("break_first", [(0, 100, [10_000], 1), (0, 40, [50_000], 1)], 150)
    read("break_last", [(0, 100, [10_000], 1), (200, 100, [50_000], 1),
                        (210, 40, [90_000], 1)], 320)
    read("large_no_break", [(0, 120, [10_000], 1), (120, 110, [50_000], 1),
                            (70, 100, [90_000], 1), (60, 20, [130_000], 1)], 250)
    read("alt_skip", [(0, 100, [385_000], 1), (10, 40, [10_000], 1),
                      (20, 30, [50_000], 1)], 150)
    for n in (128, 129):
        read(f"c{n}", [(200 * k, 30, [1_000 * (k + 1)], 1) for k in range(n)],
             200 * n + 100)
    read("short", [(0, 15, [1_000], 1)], 18)
    read("empty", [], 150)
    l_pac = WARP_L_PAC
    for r in range(n_random):
        n_intv = int(rng.integers(10, 60))
        qlen = int(rng.integers(150, 400))
        anchors = rng.integers(0, 2 * l_pac, int(rng.integers(1, 6)))
        seeds = []
        for qb in np.sort(rng.integers(0, qlen - 20, n_intv)):
            ln = int(rng.integers(19, min(60, qlen - qb) + 1))
            s = int(rng.choice([1, 2, 3, 8, 600]))
            k = min(s, int(rng.integers(1, 12)))
            base = anchors[rng.integers(0, len(anchors), k)] + qb
            jitter = rng.integers(-150, 150, k) * (rng.random(k) < 0.5)
            rb = np.clip(base + jitter, 0, 2 * l_pac - ln)
            if rng.random() < 0.1:  # across the end of a contig
                end = WARP_CONTIGS[int(rng.integers(0, 3))]
                rb[0] = end[0] + end[1] - ln // 2
            seeds.append((int(qb), ln, rb.tolist(), s))
        read(f"random_{r}", seeds, qlen)
    return names, ivs, rbs, qlens


def prep_table(rng, no_contig: bool = False):
    """Chains, built by hand, that drive the chain-to-region prep kernel's
    steps to their edges, on the reference ``WARP_CONTIGS`` (no index).
    Returns (names, chain_rows [Nc, 7], seed_rows [Ns, 4], n_chain [B],
    n_seed [B], qlen [B]) as numpy int64 arrays (qlen int32), one name a
    read:

    * "equal_scores": a chain of 40 seeds of one score (ties keep index
      order, across a 32-lane round);
    * "n1", "n31", "n32", "n33": chains of 1, 31, 32 and 33 seeds;
    * "two_tiles": a chain of 600 seeds, past two 256-score tiles of shared
      memory, scores from a narrow range (many ties);
    * "strand_fwd", "strand_rev": seeds on both sides of l_pac, the first
      on the forward and on the reverse strand (the window is cut at l_pac
      on the first seed's side);
    * "three_chains": a read of chains of 5, 70 and 2 seeds;
    * with ``no_contig``, "no_contig" too: a first seed past 2 l_pac, in
      no contig.

    Chain rows carry (0, 0, n_seeds, 0, 0, 1, 0); the prep kernel reads
    only the seed count."""
    l_pac = WARP_L_PAC
    names, chains, qlens = [], [], []

    def seeds(n, anchor, lo=19, hi=30, qlen=300):
        qb = np.sort(rng.integers(0, qlen - 20, n))
        ln = rng.integers(19, 21, n)
        rb = anchor + qb + rng.integers(-40, 40, n)
        return np.stack([rb, qb, ln, rng.integers(lo, hi, n)], 1)

    def read(name, cl, qlen=300):
        names.append(name)
        chains.append(cl)
        qlens.append(qlen)

    eq = seeds(40, 10_000)
    eq[:, 3] = 25
    read("equal_scores", [eq])
    for n in (1, 31, 32, 33):
        read(f"n{n}", [seeds(n, 50_000 + 1_000 * n)])
    read("two_tiles", [seeds(600, 120_000, 20, 24, qlen=2_000)], 2_000)
    for name, first in (("strand_fwd", l_pac - 150), ("strand_rev", l_pac + 60)):
        s = seeds(12, l_pac - 100)
        s[0, 0] = first
        read(name, [s])
    read("three_chains", [seeds(5, 200_000), seeds(70, 250_000),
                          seeds(2, 2 * l_pac - 5_000)])
    if no_contig:
        s = seeds(3, 100_000)
        s[0, 0] = 2 * l_pac + 10
        read("no_contig", [s])
    chain_rows = [(0, 0, len(s), 0, 0, 1, 0) for cl in chains for s in cl]
    return (names, np.asarray(chain_rows, np.int64).reshape(-1, 7),
            np.concatenate([s for cl in chains for s in cl]).astype(np.int64),
            np.asarray([len(cl) for cl in chains], np.int64),
            np.asarray([sum(len(s) for s in cl) for cl in chains], np.int64),
            np.asarray(qlens, np.int32))
