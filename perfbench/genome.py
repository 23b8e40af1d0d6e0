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

A configuration's ``genome`` takes one of two forms:

* one contig: ``{"contig", "length", "seed"}``, cached as ``genome.npy``;
* a reference assembly: ``{"contigs": [...]}``, in the FASTA's and the
  image's order, each entry either a primary contig ``{"name", "length",
  "seed"}``, made by ``synthetic_genome`` as above, or an ALT haplotype
  ``{"name", "alt_of": {"contig", "start", "end"}, "snv", "indel",
  "seed"}``: a copy of that region of an earlier primary contig with
  substitutions at rate ``snv`` and indels of 1-10 bases at rate
  ``indel``, drawn from its own seed, so that reads map to both copies and
  set off bwa's ALT-aware mapping.  Contig ``i`` is cached as
  ``contig.<i>.npy``.
"""
from __future__ import annotations

import os

import numpy as np


class Genome:
    """A configuration's contigs (codes 0-3, 4 = N) in the FASTA's order,
    and the names of those that are ALT haplotypes."""

    def __init__(self, contigs, alt=()):
        self.contigs = list(contigs)
        self.alt = frozenset(alt)

    def __getitem__(self, name: str) -> np.ndarray:
        for n, codes in self.contigs:
            if n == name:
                return codes
        raise KeyError(f"no contig {name!r} in the configuration")


def load(cfg: dict, cache_dir: str) -> Genome:
    """The configuration's genome, from the cache or made and cached."""
    g = cfg["genome"]
    if "contigs" not in g:
        return Genome([(g["contig"], genome_codes(cfg, cache_dir))])
    made = {}
    for i, c in enumerate(g["contigs"]):
        made[c["name"]] = _cached(os.path.join(cache_dir, f"contig.{i}.npy"),
                                  lambda: _contig(c, made))
    return Genome(made.items(), [c["name"] for c in g["contigs"]
                                 if "alt_of" in c])


def _contig(c: dict, made: dict) -> np.ndarray:
    """A primary contig, or an ALT haplotype of one made before it."""
    rng = np.random.default_rng(c["seed"])
    if "alt_of" not in c:
        return synthetic_genome(c["length"], rng)
    src = c["alt_of"]
    if src["contig"] not in made:
        raise ValueError(f"ALT contig {c['name']!r}: {src['contig']!r} is "
                         "not an earlier contig of the list")
    return alt_haplotype(made[src["contig"]][src["start"]:src["end"]],
                         c["snv"], c["indel"], rng)


def genome_codes(cfg: dict, cache_dir: str) -> np.ndarray:
    """The one-contig form's genome (codes 0-3, 4 = N), from the cache or
    made and cached."""
    g = cfg["genome"]
    return _cached(os.path.join(cache_dir, "genome.npy"),
                   lambda: synthetic_genome(g["length"],
                                            np.random.default_rng(g["seed"])))


def _cached(path: str, make) -> np.ndarray:
    if os.path.exists(path):
        return np.load(path)
    codes = make()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, codes)
    os.replace(tmp, path)
    return codes


def alt_haplotype(region: np.ndarray, snv: float, indel: float,
                  rng: np.random.Generator) -> np.ndarray:
    """A diverged copy of ``region``: each base (not N) substituted with
    probability ``snv``; before each base, with probability ``indel``, an
    indel of 1-10 bases, an insertion of random bases or a deletion of the
    bases that follow, one or the other with equal odds."""
    out = region.copy()
    hit = (rng.random(len(out)) < snv) & (out <= 3)
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()),
                                        dtype=np.uint8)) % 4
    at = np.flatnonzero(rng.random(len(out)) < indel)
    size = rng.integers(1, 11, len(at))
    ins = rng.random(len(at)) < 0.5
    keep = np.ones(len(out), dtype=bool)
    for p, n in zip(at[~ins].tolist(), size[~ins].tolist()):
        keep[p:p + n] = False
    where = np.repeat(at[ins], size[ins])
    bases = rng.integers(0, 4, len(where), dtype=np.uint8)
    out = np.insert(out, where, bases)
    keep = np.insert(keep, where, True)
    return out[keep]


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
