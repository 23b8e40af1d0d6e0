"""A one-contig reference whose doubled-strand coordinates pass 2^32, with
reads drawn from it and their exact-match seeds, for holding the chain and
chain-to-region kernels against their references at GRCh38's size.

GRCh38's ``2 * l_pac`` is ~6.2e9: a reverse-strand position (``rb >=
l_pac``) passes 2^32 there, and a forward one passes 2^31.  Building the
FM-index of such a genome takes an hour, but the chain kernels and the
loop kernel of ``ops.pipeline_fused`` never read the index: they take a
seed table (query span and reference start of each seed) and the 2-bit
pac.  So ``big_index`` makes the pac alone (random 2-bit bases, one
contig, no BWT), ``plan``/``draw`` place reads on it (forward ones past
2^31, reverse ones past 2^32 where ``l_pac`` allows) with substitutions
and one indel each, and ``seed_table`` lays out the runs of exact matches
between each read and its source as seeds at their known ``rbeg``: what
seeding would have found, without an index.  ``oracle_regions`` runs the
host oracle (mem_chain, chain_flt, flt_chained_seeds, chain2aln) on the
same seeds and pac.

With ``dense=False`` the pac is zero pages (``np.zeros``, which the host
maps lazily) but for random bases around the planned reads: a CPU test
then gets positions past 2^32 for the few MB it touches.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from ..index.build import BntAnn, Bntseq, BwaIndex

# random bases on each side of a read's source in a sparse pac: past any
# extension window (read length + max gap) the kernels or the oracle read
MARGIN = 4096


class ReadPlan(NamedTuple):
    """Where each read comes from: its forward start and strand, and a
    second position (doubled domain) that one of its seeds also occurs
    at, or -1."""

    fwd: np.ndarray  # [n] int64
    rev: np.ndarray  # [n] bool
    length: np.ndarray  # [n] int64
    decoy: np.ndarray  # [n] int64


class BigReads(NamedTuple):
    reads: List[np.ndarray]  # codes, uint8
    seeds: List[List[Tuple[int, int, List[int]]]]  # (qbeg, len, rbegs)
    rb: np.ndarray  # [n] int64, the source's start on its strand


def plan(l_pac: int, rng, n: int, lengths: Sequence[int] = (150, 300)
         ) -> ReadPlan:
    """``n`` reads, their lengths in turn from ``lengths``, every other one
    on the reverse strand; forward reads start past 2^31 and reverse ones
    end (in the doubled domain) past 2^32 wherever ``l_pac`` leaves room,
    else anywhere.  Every fourth read has a decoy: a second place, on the
    reverse strand, where its first seed also occurs."""
    length = np.asarray([lengths[i % len(lengths)] for i in range(n)], np.int64)
    rev = np.arange(n) % 2 == 1
    span = length + 1 + 2 * MARGIN
    hi = l_pac - span
    lo_fwd = np.where(hi > (1 << 31) + MARGIN, (1 << 31) + MARGIN, MARGIN)
    # reverse: rb = 2 l_pac - fwd - len - 1 >= 2^32  <=>  fwd <= 2 l_pac - 2^32 - len - 1
    hi_rev = np.minimum(2 * l_pac - (1 << 32) - length - 1 - MARGIN, hi)
    hi_rev = np.where(hi_rev > MARGIN, hi_rev, hi)
    top = np.where(rev, hi_rev, hi)
    low = np.where(rev, MARGIN, lo_fwd)
    fwd = low + (rng.random(n) * (top - low)).astype(np.int64)
    decoy = np.full(n, -1, np.int64)
    has = np.arange(n) % 4 == 0
    d_fwd = MARGIN + (rng.random(int(has.sum())) * (hi_rev[has] - MARGIN)
                      ).astype(np.int64)
    decoy[has] = 2 * l_pac - d_fwd - length[has]  # a reverse-strand start
    return ReadPlan(fwd, rev, length, decoy)


def _windows(l_pac: int, p: ReadPlan):
    """The forward spans (with margins) that the plan's reads and decoys
    read."""
    out = [(int(f) - MARGIN, int(f + n + 1) + MARGIN)
           for f, n in zip(p.fwd, p.length)]
    for d, n in zip(p.decoy, p.length):
        if d >= 0:
            f = 2 * l_pac - int(d) - int(n)
            out.append((f - MARGIN, f + int(n) + MARGIN))
    return [(max(a, 0), min(b, l_pac)) for a, b in out]


def big_index(l_pac: int, rng, p: ReadPlan = None, dense: bool = True
              ) -> BwaIndex:
    """One contig of ``l_pac`` random bases as a ``BwaIndex`` with no BWT
    (``bwt`` None; the chain and extension oracles never read it).  Dense:
    every byte random; else zero but the plan's windows."""
    n_bytes = (l_pac + 3) // 4
    if dense:
        pac = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    else:
        pac = np.zeros(n_bytes, dtype=np.uint8)
        for a, b in _windows(l_pac, p):
            pac[a // 4: (b + 3) // 4] = rng.integers(
                0, 256, (b + 3) // 4 - a // 4, dtype=np.uint8)
    if l_pac % 4:  # bwa leaves the last byte's unused bases 0
        pac[-1] &= np.uint8((0xFF << (2 * (4 - l_pac % 4))) & 0xFF)
    bns = Bntseq(l_pac=l_pac, anns=[BntAnn(offset=0, name="big",
                                           length=l_pac)])
    idx = BwaIndex(bns=bns, pac=pac, bwt=None)
    # read windows from the pac: an unpacked copy would be l_pac bytes
    object.__setattr__(idx, "_UNPACK_CACHE_MAX", 0)
    return idx


def _runs(breaks, lo: int, hi: int):
    """The runs of [lo, hi) between the positions ``breaks``."""
    out, at = [], lo
    for b in sorted(x for x in breaks if lo <= x < hi) + [hi]:
        if b > at:
            out.append((at, b))
        at = b + 1
    return out


def draw(idx: BwaIndex, p: ReadPlan, rng, min_seed_len: int = 19) -> BigReads:
    """Each planned read: its source on its strand (``len + 1`` bases from
    ``rb``), one base deleted or one inserted near the middle, and two
    substitutions a 100 bases; its seeds the runs of at least
    ``min_seed_len`` exact matches, each at its known ``rbeg`` (and the
    first also at the plan's decoy, where that window is overwritten with
    the seed's bases)."""
    l_pac = idx.bns.l_pac
    reads, seeds, rbs = [], [], []
    for i in range(len(p.fwd)):
        n, f = int(p.length[i]), int(p.fwd[i])
        rb = 2 * l_pac - f - n - 1 if p.rev[i] else f
        src = np.asarray(idx.get_seq(rb, rb + n + 1), np.uint8)
        k = n // 3 + int(rng.integers(0, n // 3))
        if i % 2:  # a deletion: read base j >= k is source base j + 1
            read = np.concatenate([src[:k], src[k + 1: n + 1]])
            shift = 1
        else:  # an insertion at k: read base j > k is source base j - 1
            read = np.concatenate([src[:k], rng.integers(0, 4, 1).astype(
                np.uint8), src[k: n - 1]])
            shift = -1
        subs = rng.choice(n, max(2 * n // 100, 1), replace=False)
        for s in subs:
            read[s] = (read[s] + 1 + rng.integers(0, 3)) % 4
        cut = set(subs.tolist()) | {k}
        mine = []
        for a, b in _runs(cut, 0, k) + _runs(cut, k, n):
            if b - a >= min_seed_len:
                mine.append((a, b - a, [rb + a + (shift if a > k else 0)]))
        if p.decoy[i] >= 0 and mine:
            qb, ln, at = mine[0]
            d = int(p.decoy[i])
            fb = 2 * l_pac - d - ln  # write the seed's bases at the decoy
            codes = (3 - read[qb: qb + ln])[::-1]
            _put(idx.pac, fb, codes)
            mine[0] = (qb, ln, at + [d])
        reads.append(read.astype(np.uint8))
        seeds.append(mine)
        rbs.append(rb)
    return BigReads(reads, seeds, np.asarray(rbs, np.int64))


def _put(pac: np.ndarray, beg: int, codes: np.ndarray):
    """Write 2-bit ``codes`` into ``pac`` from forward position ``beg``."""
    for j, c in enumerate(codes.tolist()):
        q, r = divmod(beg + j, 4)
        sh = 2 * (3 - r)
        pac[q] = (int(pac[q]) & ~(3 << sh) & 0xFF) | (c << sh)


def seed_table(big: BigReads, device):
    """The reads' seeds as ``ops.chain.SeedTable`` on ``device``: one
    interval a seed (size its occurrence count, 1 or 2), its positions in
    ``rbegs``."""
    from ..ops.chain import SeedTable

    rows, n_intv, rbegs, cnt = [], [], [], []
    for mine in big.seeds:
        n_intv.append(len(mine))
        for qb, ln, at in mine:
            rows.append((len(rows), len(rows), len(at), qb, qb + ln))
            rbegs += at
            cnt.append(len(at))
    n_intv = np.asarray(n_intv, np.int64)
    cnt = np.asarray(cnt, np.int64)
    return SeedTable.from_numpy(
        device, [len(r) for r in big.reads], np.asarray(rows, np.int64),
        np.cumsum(n_intv) - n_intv, n_intv, np.asarray(rbegs, np.int64),
        np.cumsum(cnt) - cnt, cnt)


def oracle_regions(opt, idx: BwaIndex, big: BigReads, which: Sequence[int],
                   chain_mod=None, extend_mod=None):
    """Per read of ``which``: its chains (mem_chain + chain_flt) and its
    regions before dedup (flt_chained_seeds, then chain2aln of each chain),
    by the host oracle: the port's, or the modules given (another
    package's ``engine.chain`` and ``engine.extend``, on an index of its
    own over the same pac)."""
    from ..engine.seed import SmemIntv

    if chain_mod is None:
        from ..engine import chain as chain_mod
    if extend_mod is None:
        from ..engine import extend as extend_mod
    out = []
    for i in which:
        q = big.reads[i]
        ivs = [SmemIntv(k, k, len(at), qb, qb + ln)
               for k, (qb, ln, at) in enumerate(big.seeds[i])]
        rbegs = [np.asarray(at, np.int64) for _, _, at in big.seeds[i]]
        chains = chain_mod.chain_flt(opt, chain_mod.mem_chain(
            opt, None, idx.bns, len(q), ivs, rbegs))
        chain_mod.flt_chained_seeds(opt, idx, len(q), q, chains)
        regs = []
        for c in chains:
            extend_mod.chain2aln(opt, idx, len(q), q, c, regs)
        out.append((chains, regs))
    return out
