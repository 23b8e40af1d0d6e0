"""Seeded genomes, reads and lanes for holding the seeding kernels against
their references.

The genome has repeats that make round 2 re-seed and a block that makes one
read overflow the K-slot budget; the reads cover both strands, substitutions,
N runs and the edges (all N, 20 bp, each contig's ends).  The same values
feed ``bwamem_tpu``'s device programs and host oracle, the port's plain
versions and its CUDA kernels.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

READ_LEN = 150


def genome(rng) -> Tuple[List[np.ndarray], np.ndarray]:
    """Two contigs of random bases with a two-copy and a three-copy repeat
    (round-2 re-seeding), and the K-overflow block: a read's prefixes of 30
    lengths (20, 24, ..., 136), each followed by random bases, so that its
    forward extension from x = 0 changes size more than 24 times.  Returns
    the contigs and the overflow read."""
    a = rng.integers(0, 4, 24_000).astype(np.uint8)
    a[15_000:16_000] = a[2_000:3_000]
    a[20_000:20_300] = a[2_000:2_300]
    kread = rng.integers(0, 4, READ_LEN).astype(np.uint8)
    block = [kread]
    for n in range(20, 140, 4):
        block += [kread[:n], rng.integers(0, 4, 12).astype(np.uint8)]
    b = np.concatenate([rng.integers(0, 4, 6_000).astype(np.uint8), *block,
                        rng.integers(0, 4, 3_000).astype(np.uint8)])
    return [a, b], kread


def sample_reads(contigs, rng, n: int, read_len: int = READ_LEN):
    """``n`` reads of 20 to ``read_len`` bases from either strand of the
    contigs, with 2 % substitutions and, in 30 % of them, an N run."""
    reads = []
    for _ in range(n):
        c = contigs[int(rng.integers(0, len(contigs)))]
        L = int(rng.integers(20, read_len + 1))
        st = int(rng.integers(0, len(c) - L))
        r = c[st: st + L].copy()
        for p in rng.integers(0, L, rng.binomial(L, 0.02)):
            r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        if rng.random() < 0.3:
            p = int(rng.integers(0, L))
            r[p: p + int(rng.integers(1, 4))] = 4
        if rng.random() < 0.5:
            r = np.where(r < 4, 3 - r, 4)[::-1].copy()
        reads.append(r.astype(np.uint8))
    return reads


def edge_reads(contigs, read_len: int = READ_LEN) -> List[np.ndarray]:
    """A read with an N run, an all-N read, a 20 bp read and a read at each
    end of each contig."""
    a = contigs[0]
    n_run = a[500: 500 + read_len].copy()
    n_run[60:75] = 4
    out = [n_run, np.full(40, 4, np.uint8), a[9_000:9_020].copy()]
    for c in contigs:
        out += [c[:read_len].copy(), c[-read_len:].copy()]
    return out


def reads(contigs, kread, rng, n: int = 36) -> List[np.ndarray]:
    """``sample_reads`` and the edge reads, then one read across the end of
    the three-copy repeat (round 2 re-seeds it) and, last, the K-overflow
    read."""
    a = contigs[0]
    return (sample_reads(contigs, rng, n) + edge_reads(contigs)
            + [a[2_200:2_350].copy(), kread.copy()])


def lanes(reads, seed) -> List[Tuple[int, int, int]]:
    """(read, start, min_intv) lanes for single smem1a / strategy-1 calls:
    every read from 0, from a random start and from the middle with a
    larger minimum interval (as round 2 calls it), and one start past a
    read's end."""
    rng = np.random.default_rng(seed)
    out = []
    for i, r in enumerate(reads):
        L = len(r)
        out += [(i, 0, 1), (i, int(rng.integers(0, L)), 1),
                (i, L // 2, int(rng.integers(2, 5)))]
    out.append((0, len(reads[0]), 1))
    return out
