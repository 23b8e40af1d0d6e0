"""The reference genomes of the configurations: a frozen copy of the port's
repeat-rich synthetic generator (``utils/synth.py`` ``synthetic_genome``),
so that a change to the program cannot change the yardstick's genome.

Uniform-random sequence is the easiest input for an FM-index aligner; this
generator composes the repeat classes that stress the engine the way real
genomes do: interspersed repeat families (SINE/LINE-like, 2-17 %
divergence), segmental duplications (1 % divergence), tandem repeats,
homopolymer runs and N gaps.  A configuration fixes its length and its own
seed, so the genome never depends on a run's ``--seed``; it is made once in
a checkout and cached beside the index image.
"""
from __future__ import annotations

import os

import numpy as np


def genome_codes(cfg: dict, cache_dir: str) -> np.ndarray:
    """The configuration's genome (codes 0-3, 4 = N), from the cache or made
    and cached."""
    g = cfg["genome"]
    path = os.path.join(cache_dir, "genome.npy")
    if os.path.exists(path):
        return np.load(path)
    codes = synthetic_genome(g["length"], np.random.default_rng(g["seed"]))
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, codes)
    os.replace(tmp, path)
    return codes


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
