"""Seeded reads and options for holding the chain-to-region stage
(``ops.pipeline_fused``) against its references, on the three-contig genome
of ``chain_cases.genome``.  Each case is (option overrides, reads maker):
the same values feed the host oracles, the plain PyTorch version and the
CUDA kernels.
"""
from __future__ import annotations

from typing import List

import numpy as np

from . import chain_cases


def revcomp(r: np.ndarray) -> np.ndarray:
    return np.where(r < 4, 3 - r, 4)[::-1].copy()


def indel_reads(contigs, rng, n: int, L: int = 140) -> List[np.ndarray]:
    """Reads with one insertion or deletion of 6-12 bases in the middle
    third: with a narrow band the first attempt's max_off reaches 3/4 of the
    band and the job runs again at twice the band."""
    out = []
    for _ in range(n):
        st = int(rng.integers(2_000, 4_000))
        r = contigs[0][st: st + L + 20].copy()
        at, k = int(rng.integers(L // 3, 2 * L // 3)), int(rng.integers(6, 13))
        if rng.random() < 0.5:
            r = np.concatenate([r[:at], r[at + k:]])
        else:
            r = np.concatenate([r[:at], rng.integers(0, 4, k).astype(np.uint8),
                                r[at:]])
        r = r[:L]
        out.append(revcomp(r) if rng.random() < 0.5 else r)
    return out


def boundary_reads(contigs) -> List[np.ndarray]:
    """Reads at both ends of the genome on both strands (windows cut at the
    strand boundary and at 0) and one that joins the two strands."""
    c0, c2 = contigs[0], contigs[-1]
    return [c2[-100:].copy(), revcomp(c2[-110:]), c0[:95].copy(),
            revcomp(c0[:120]), np.concatenate([c2[-60:], revcomp(c2[-60:])])]


def long_reads(contigs) -> List[np.ndarray]:
    """Reads of 800 bases and more, a substitution every ~60 bases: the
    lengths at which mem_flt_chained_seeds acts."""
    c0, c1 = contigs[0], contigs[1]
    reads = [c0[6_000:6_800].copy(), revcomp(c0[13_000:14_100]),
             np.concatenate([c0[1_000:1_500], c1[3_000:3_400]])]
    rng = np.random.default_rng(5)
    for r in reads:
        for p in rng.integers(0, len(r), len(r) // 60):
            r[p] = (r[p] + 1) % 4
    return reads


CASES = {
    "fuzz": (dict(), lambda c: chain_cases.reads(c, np.random.default_rng(11), 60)
             + [np.ones(5, np.uint8), np.zeros(19, np.uint8)]),
    "band_retry": (dict(w=10),
                   lambda c: indel_reads(c, np.random.default_rng(31), 24)),
    "clips_zdrop": (dict(w=40, zdrop=20, pen_clip5=1, pen_clip3=11, a=2, b=5),
                    lambda c: chain_cases.reads(c, np.random.default_rng(12), 30)),
    "strand_boundary": (dict(), boundary_reads),
    "long_reads": (dict(), long_reads),
}


def repeat_genome(rng) -> List[np.ndarray]:
    """One 60 kbp contig: 20 kbp of random bases, then 100 copies of a
    150-base unit between random 100-base spacers, then random bases.  The
    base on each side of every copy is an A, so a match of the unit in a
    read whose flanks differ there stops at the unit's ends in every copy."""
    unit = rng.integers(0, 4, 150).astype(np.uint8)
    parts = [rng.integers(0, 4, 20_000).astype(np.uint8)]
    for _ in range(100):
        parts[-1][-1] = 0
        spacer = rng.integers(0, 4, 100).astype(np.uint8)
        spacer[0] = 0
        parts += [unit, spacer]
    parts.append(rng.integers(0, 4, 15_000).astype(np.uint8))
    return [np.concatenate(parts)]


def repeat_reads(contigs) -> List[np.ndarray]:
    """The repeat unit between 20 random bases on each side (a C next to
    the unit), on both strands: one SMEM of 100 occurrences, so 100 chains
    of one seed that no region of another contains, each extended into the
    flanks, 100 tasks a read."""
    rng = np.random.default_rng(41)
    left, right = (rng.integers(0, 4, 20).astype(np.uint8) for _ in range(2))
    left[-1] = right[0] = 1
    read = np.concatenate([left, contigs[0][20_000:20_150], right])
    return [read, revcomp(read)]


def wide_reads(contigs) -> List[np.ndarray]:
    """Reads of 161 to 1,500 bases from the random part of the repeat
    genome, with a substitution every ~70 bases and one insertion or
    deletion: at a band of 1,000, rows of up to ten passes of a warp on the
    card."""
    c = contigs[0]
    rng = np.random.default_rng(42)
    out = []
    for L in (161, 250, 480, 777, 1_100, 1_500):
        st = int(rng.integers(0, 20_000 - L - 20))
        r = c[st: st + L + 8].copy()
        for p in rng.integers(0, len(r), len(r) // 70):
            r[p] = (r[p] + 1) % 4
        at = int(rng.integers(L // 4, 3 * L // 4))
        r = (np.concatenate([r[:at], r[at + 8:]]) if L % 2 else
             np.concatenate([r[:at], rng.integers(0, 4, 8).astype(np.uint8), r[at:]]))
        r = r[:L]
        out.append(revcomp(r) if L % 3 == 0 else r)
    return out


# the card tests' cases: those above on chain_cases' genome, and two on the
# repeat genome (the third field makes the genome)
CARD_CASES = {name: (kw, make, chain_cases.genome) for name, (kw, make)
              in CASES.items()}
CARD_CASES["repeat_copies"] = (dict(), repeat_reads, repeat_genome)
CARD_CASES["wide_band"] = (dict(w=1000), wide_reads, repeat_genome)


def options(opt, kw: dict):
    """``opt`` (any package's ``MemOptions``) with the case's overrides."""
    for k, v in kw.items():
        setattr(opt, k, v)
    if "a" in kw or "b" in kw:
        opt.refresh_matrix()
    return opt


def split_reads_cases(contigs, l_pac: int):
    """Reads of the first contig of ``chain_cases.genome`` with hand-made
    chains for the loop kernel's chain items, each chain a list of seeds
    (rbeg, qbeg, len, score) in the doubled domain of a pac of ``l_pac``
    bases: (names, reads, chains a read).  The cases: later chains whose
    seeds an earlier chain's region holds (the read's run prunes them, a
    chain run alone extends them); two chains on one locus at diagonals 20
    apart (a deletion), in both orders; chains at the five copies of the
    repeat unit, which no other copy's region holds; a chain of three seeds
    after a chain that holds them all; and a reverse-strand read."""
    c0 = contigs[0]
    names, reads, chains = [], [], []

    def add(name, read, cl):
        names.append(name)
        reads.append(read)
        chains.append([np.asarray(c, np.int64).reshape(-1, 4) for c in cl])

    s = 15_000
    add("held_later", c0[s: s + 150].copy(),
        [[(s, 0, 40, 40)], [(s + 80, 80, 30, 30)], [(s + 100, 100, 25, 25)]])
    s = 16_000
    dele = np.concatenate([c0[s: s + 70], c0[s + 90: s + 170]])
    add("deletion_left_first", dele, [[(s, 0, 60, 60)], [(s + 100, 80, 60, 60)]])
    add("deletion_right_first", dele.copy(),
        [[(s + 100, 80, 60, 60)], [(s, 0, 60, 60)]])
    unit = c0[1_000:1_150].copy()
    add("repeat_copies", unit,
        [[(at, 0, 150, 150)] for at in (1_000, 5_000, 12_000, 21_000, 27_500)])
    s = 17_000
    r = c0[s: s + 150].copy()
    r[75] = (r[75] + 1) % 4
    add("several_seeds", r, [[(s, 0, 70, 70)],
                    [(s + 10, 10, 50, 50), (s + 90, 90, 60, 60),
                     (s + 41, 40, 30, 30)]])
    s = 18_000
    add("reverse_strand", revcomp(c0[s: s + 150]),
        [[(2 * l_pac - s - 150, 0, 50, 50)],
         [(2 * l_pac - s - 150 + 90, 90, 40, 40)],
         [(2 * l_pac - 20_000 - 150, 0, 30, 30)]])
    return names, reads, chains


def chains_table(chains, device="cpu"):
    """Hand-made chains (a list a read of seed arrays a chain) as
    ``ops.chain.Chains`` on ``device``: one contig id 0, no ALT, frac_rep 0."""
    import torch

    from ..ops.chain import Chains

    flat = [c for cl in chains for c in cl]
    rows = np.asarray([(0, 0, len(c), 0, int(c[:, 2].sum()), 3, -1)
                       for c in flat], np.int64).reshape(-1, 7)
    seeds = np.concatenate(flat).astype(np.int64)
    n_chain = np.asarray([len(cl) for cl in chains], np.int64)
    n_seed = np.asarray([sum(len(c) for c in cl) for cl in chains], np.int64)
    B = len(chains)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Chains(t(rows), t(seeds), t(n_chain), t(n_seed), t(n_seed),
                  t(np.zeros(B, bool)), t(n_chain.astype(np.int32)))
