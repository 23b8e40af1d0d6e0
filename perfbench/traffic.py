"""The one traffic generator: a traffic file's parameters and a run's seed
give the batches a run hands to the aligner.

Reads are drawn as the port's ``utils/synth.py`` ``simulate_pairs`` draws
them, with the same parameters (an insert from a normal distribution
clipped to [read length + 40, 3 x mean], a start drawn uniformly, pairs
that touch an N drawn again, the second mate reverse-complemented, and
substitutions at ``error_rate``), vectorised over a batch so that making
a batch takes milliseconds, not seconds: each base is substituted
independently with probability ``error_rate`` (the frozen loop drew a
binomial count of positions with replacement).  Single-end traffic takes
the same reads as single reads, so both strands come in turn.

A traffic file holds:

* ``read_len``, ``insert_mean``, ``insert_std``, ``error_rate``: the reads;
* ``paired``: interleaved pairs (``align_pairs``) or single reads;
* ``batch_bases``: bases a batch, as bwa's ``-K``: a batch has
  ``batch_bases // read_len`` reads (rounded down to pairs);
* ``pe_stats``: the insert-size statistics handed to the aligner
  (``average``, ``std``, ``low``, ``high``), as ``bwa mem -I`` gives them;
* ``pool_batches``: distinct batches made in set-up; the window hands them
  over in turn, again from the first when they run out;
* ``reads_seed``: the reads are drawn from it, the same in every run, and
  the run's seed only orders them (the batches, and the pairs or reads in
  each), so that the work does not change with the seed: the card's time
  per batch follows its heaviest reads, and the host's its records;
* ``work_sample``: pairs (or reads) of the pool on which the plain
  reference counts the work that the rooflines divide: the first of the
  pool's first batch as ``reads_seed`` draws it, the same in every run;
* ``warmup_batches``: whole batches aligned in set-up before the window
  (and one more under the profiler), after ``warmup_staged_reads`` reads of
  the first batch on the staged route;
* ``sample``: pairs (or reads) of the window checked against the plain
  reference, drawn uniformly from all that the window answered;
* ``regions`` (optional): ``[{"contig", "start", "end", "weight"}]``, where
  the reads come from, as a capture panel or a targeted run gives them:
  each pair (or, in single-end traffic, each pair whose mates are taken as
  single reads) first picks a region with probability proportional to its
  weight, then draws its insert and start inside it, so that it never
  crosses the region's end.  Without ``regions`` the reads come from the
  whole of a genome of one contig, drawn as before; a genome of several
  contigs needs them.
"""
from __future__ import annotations

from typing import List

import numpy as np

BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)


class Batch:
    """One batch: its reads as ASCII bases and as codes (0-3)."""

    __slots__ = ("seqs", "codes")

    def __init__(self, codes: np.ndarray):
        self.codes = codes
        n, read_len = codes.shape
        buf = BASES[codes].tobytes()
        self.seqs = [buf[i * read_len:(i + 1) * read_len] for i in range(n)]

    def __len__(self) -> int:
        return len(self.seqs)


def reads_per_batch(traffic: dict) -> int:
    n = traffic["batch_bases"] // traffic["read_len"]
    return n - n % 2


class Regions:
    """A traffic's ``regions`` laid end to end in one array: region ``k``
    is ``text[offset[k]:offset[k] + length[k]]``."""

    def __init__(self, regions: list, genome, traffic: dict):
        parts = []
        for r in regions:
            contig = genome[r["contig"]]
            if not 0 <= r["start"] < r["end"] <= len(contig):
                raise ValueError(f"region {r} lies outside its contig")
            if r["end"] - r["start"] < 3 * traffic["insert_mean"] + 2:
                raise ValueError(f"region {r} is shorter than an insert")
            parts.append(contig[r["start"]:r["end"]])
        self.text = np.concatenate(parts)
        self.length = np.array([len(p) for p in parts], dtype=np.int64)
        self.offset = np.cumsum(self.length) - self.length
        w = np.array([r["weight"] for r in regions], dtype=np.float64)
        self.p = w / w.sum()

    def starts(self, rng: np.random.Generator,
               isize: np.ndarray) -> np.ndarray:
        """A start in ``text`` for each insert: a region picked by weight,
        then a start inside it."""
        k = rng.choice(len(self.p), len(isize), p=self.p)
        return self.offset[k] + rng.integers(0, self.length[k] - isize - 1)


def source(traffic: dict, genome):
    """What the traffic draws from: the one contig's codes, or its
    ``regions``."""
    if "regions" in traffic:
        return Regions(traffic["regions"], genome, traffic)
    if len(genome.contigs) != 1:
        raise ValueError("traffic over a genome of several contigs names "
                         "its regions")
    return genome.contigs[0][1]


def simulate(src, rng: np.random.Generator, n_pairs: int,
             traffic: dict) -> np.ndarray:
    """``n_pairs`` pairs as codes [2 * n_pairs, read_len], mates
    interleaved, from ``source``'s codes or regions."""
    read_len = traffic["read_len"]
    mean, std = traffic["insert_mean"], traffic["insert_std"]
    span = np.arange(read_len)
    out = np.empty((n_pairs, 2, read_len), dtype=np.uint8)
    regions = src if isinstance(src, Regions) else None
    text = src if regions is None else regions.text
    filled = 0
    while filled < n_pairs:
        m = n_pairs - filled
        isize = np.clip(rng.normal(mean, std, m), read_len + 40,
                        3 * mean).astype(np.int64)
        start = (rng.integers(0, len(text) - isize - 1) if regions is None
                 else regions.starts(rng, isize))
        r1 = text[start[:, None] + span]
        r2 = text[(start + isize - read_len)[:, None] + span]
        ok = (r1 <= 3).all(axis=1) & (r2 <= 3).all(axis=1)
        k = int(ok.sum())
        out[filled:filled + k, 0] = r1[ok]
        out[filled:filled + k, 1] = 3 - r2[ok][:, ::-1]
        filled += k
    out = out.reshape(2 * n_pairs, read_len)
    hit = rng.random(out.shape) < traffic["error_rate"]
    shift = rng.integers(1, 4, out.shape, dtype=np.uint8)
    return np.where(hit, (out + shift) % 4, out).astype(np.uint8)


def _drawn(traffic: dict, genome, batches: int) -> List[np.ndarray]:
    """The pool's first ``batches`` batches as ``reads_seed`` draws them."""
    rng = np.random.default_rng(traffic["reads_seed"])
    n_pairs = reads_per_batch(traffic) // 2
    src = source(traffic, genome)
    return [simulate(src, rng, n_pairs, traffic) for _ in range(batches)]


def make_pool(traffic: dict, genome, seed: int) -> List[Batch]:
    """The run's distinct batches: the same reads in every run, drawn from
    ``reads_seed``; ``seed`` orders them: the batches, and the pairs (or
    reads) within each batch."""
    pool = _drawn(traffic, genome, traffic["pool_batches"])
    order = np.random.default_rng(seed)
    per = 2 if traffic["paired"] else 1
    for i, codes in enumerate(pool):
        units = codes.reshape(len(codes) // per, per, -1)
        pool[i] = units[order.permutation(len(units))].reshape(codes.shape)
    return [Batch(pool[i]) for i in order.permutation(len(pool))]


def work_units(traffic: dict, genome) -> np.ndarray:
    """The reads of the work sample, as codes (mates interleaved), the same
    in every run: the first ``work_sample`` pairs (or reads) of the pool's
    first batch as ``reads_seed`` draws it, a uniform sample of the reads
    every window aligns."""
    per = 2 if traffic["paired"] else 1
    return _drawn(traffic, genome, 1)[0][:per * traffic["work_sample"]]
