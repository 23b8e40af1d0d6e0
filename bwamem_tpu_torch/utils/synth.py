"""Repeat-rich synthetic genome generator for benchmarks and scale tests.

Uniform-random sequence is the easiest possible input for an FM-index
aligner (every 19-mer unique, max_occ/XA paths idle).  Real genomes are
~50% repeats; this generator composes the repeat classes that stress the
engine the way GRCh38 does:

  * interspersed repeat families (SINE/LINE-like): a few consensus
    elements re-inserted thousands of times with per-copy divergence —
    drives high-occ seeds, re-seeding, XA and mapq collapse;
  * segmental duplications: multi-kb blocks copied with low divergence —
    drives mate rescue and near-equal secondary hits;
  * tandem repeats / microsatellites and homopolymer runs — degenerate
    seeding neighborhoods;
  * N gaps — ambiguity holes (amb records, seeding breaks).
"""
from __future__ import annotations

import numpy as np


def synthetic_genome(
    length: int,
    rng: np.random.Generator,
    repeat_fraction: float = 0.45,
    n_gap_every: int = 2_000_000,
) -> np.ndarray:
    """Generate ``length`` 2-bit codes (with a few 4=N gaps)."""
    if length > 1_500_000_000:
        # slice the base-noise fill: rng.integers returns int64 (8x) before
        # the uint8 cast — a whole-GRCh38 draw would be a ~25 GB temporary.
        # (Kept unchunked below this size so existing seeds reproduce.)
        out = np.empty(length, dtype=np.uint8)
        step = 1 << 28
        for lo in range(0, length, step):
            hi = min(lo + step, length)
            out[lo:hi] = rng.integers(0, 4, hi - lo).astype(np.uint8)
    else:
        out = rng.integers(0, 4, length).astype(np.uint8)
    # --- interspersed repeat families ---
    families = []
    for ln in (300, 1_500, 6_000):  # Alu-, L1-fragment-, L1-like sizes
        families.append(rng.integers(0, 4, ln).astype(np.uint8))
    budget = int(length * repeat_fraction * 0.7)
    placed = 0
    while placed < budget:
        fam = families[int(rng.integers(0, len(families)))]
        # fragmented copies like real interspersed repeats
        cut = int(rng.integers(len(fam) // 3, len(fam) + 1))
        copy = fam[:cut].copy()
        div = rng.random() * 0.15 + 0.02  # 2-17% divergence per copy
        nmut = rng.binomial(len(copy), div)
        for p in rng.integers(0, len(copy), nmut):
            copy[p] = (copy[p] + 1 + rng.integers(0, 3)) % 4
        pos = int(rng.integers(0, length - len(copy)))
        out[pos : pos + len(copy)] = copy
        placed += len(copy)
    # --- segmental duplications (low divergence) ---
    budget = int(length * repeat_fraction * 0.2)
    placed = 0
    while placed < budget and length > 50_000:
        ln = int(rng.integers(10_000, min(100_000, length // 8)))
        src = int(rng.integers(0, length - ln))
        dst = int(rng.integers(0, length - ln))
        block = out[src : src + ln].copy()
        for p in rng.integers(0, ln, rng.binomial(ln, 0.01)):
            block[p] = (block[p] + 1 + rng.integers(0, 3)) % 4
        out[dst : dst + ln] = block
        placed += ln
    # --- tandem repeats / microsatellites ---
    for _ in range(max(length // 100_000, 1)):
        unit = rng.integers(0, 4, int(rng.integers(2, 12))).astype(np.uint8)
        reps = int(rng.integers(10, 60))
        tr = np.tile(unit, reps)
        pos = int(rng.integers(0, length - len(tr)))
        out[pos : pos + len(tr)] = tr
    # --- homopolymer runs ---
    for _ in range(max(length // 150_000, 1)):
        run = int(rng.integers(15, 60))
        pos = int(rng.integers(0, length - run))
        out[pos : pos + run] = rng.integers(0, 4)
    # --- N gaps ---
    for pos in range(n_gap_every, length - 1_000, n_gap_every):
        gap = int(rng.integers(50, 500))
        out[pos : pos + gap] = 4
    return out


def simulate_pairs(
    codes: np.ndarray,
    rng: np.random.Generator,
    n_pairs: int,
    read_len: int = 150,
    isize_mean: float = 350.0,
    isize_std: float = 35.0,
    err: float = 0.005,
    return_truth: bool = False,
):
    """Proper FR pairs with sequencing errors; returns base-string reads.

    With ``return_truth`` also returns, per read, the simulated
    ``(ref_start, is_reverse)`` for coordinate audits at scales where no
    golden oracle is practical."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    L = len(codes)
    reads = []
    truth = []
    lo_ins = read_len + 40
    while len(reads) < 2 * n_pairs:
        isize = int(np.clip(rng.normal(isize_mean, isize_std), lo_ins, 3 * isize_mean))
        start = int(rng.integers(0, L - isize - 1))
        r1 = codes[start : start + read_len].copy()
        r2 = codes[start + isize - read_len : start + isize]
        if (r1 > 3).any() or (r2 > 3).any():
            continue  # resample reads that fall into N gaps
        r2 = (3 - r2)[::-1].copy()
        for r in (r1, r2):
            for p in rng.integers(0, read_len, rng.binomial(read_len, err)):
                r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        reads.append(bases[r1].tobytes())
        reads.append(bases[r2].tobytes())
        truth.append((start, False))
        truth.append((start + isize - read_len, True))
    if return_truth:
        return reads, truth
    return reads
