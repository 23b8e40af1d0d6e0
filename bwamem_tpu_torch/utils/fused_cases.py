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


def options(opt, kw: dict):
    """``opt`` (any package's ``MemOptions``) with the case's overrides."""
    for k, v in kw.items():
        setattr(opt, k, v)
    if "a" in kw or "b" in kw:
        opt.refresh_matrix()
    return opt
