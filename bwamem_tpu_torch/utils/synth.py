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
    return reads


def synthetic_fmindex(seq_len: int, rng, sa_intv: int = 4096):
    """A structurally consistent FM-index over a RANDOM BWT, built in
    seconds at gigabase scale (no suffix-array construction).

    The random packed words ARE a real 2-bit char sequence; the checkpoint
    rows are its true prefix counts and L2 its true totals, so every
    rank-query / interval-extension identity that the engine relies on
    holds exactly — device kernels and the host oracle must agree on it
    just as on a built index.  What it is NOT is the BWT of any particular
    text, which none of the occ/extend/SA-walk arithmetic depends on.
    Used to exercise the >2^31 (int64-coordinate, [EXT] bwt.h bwtint_t)
    device domain without paying a gigabase SA-IS build.

    The sampled SA holds random positions (sa[0] = -1 as always); walks
    terminate at sampled rows exactly like the oracle's, so device-vs-
    oracle SA equivalence is meaningful, while the values themselves are
    arbitrary.
    """
    from ..engine.fmindex import FMIndex, OCC_INTERVAL

    assert seq_len % OCC_INTERVAL == 0, "keep the tail simple"
    assert (seq_len // OCC_INTERVAL) % 2 == 0, "need an even block count"
    nb = seq_len // OCC_INTERVAL
    # bidirectional-index invariant: the engine's bi-interval arithmetic
    # (set_intv / bwt_extend) relies on count(c) == count(3-c), which a
    # doubled fwd+revcomp reference guarantees.  Complementing the second
    # half of the random chars (3-c == bitwise NOT of the 2-bit pair)
    # restores exactly that global symmetry.
    words = np.empty((nb, 8), dtype=np.uint32)
    words[: nb // 2] = rng.integers(
        0, 1 << 32, size=(nb // 2, 8), dtype=np.uint32
    )
    np.bitwise_not(words[: nb // 2], out=words[nb // 2 :])
    # true per-block symbol counts via the two bit-planes (vectorized
    # SWAR), chunked with preallocated scratch: fresh gigabyte temporaries
    # can fault slowly on some hypervisors, so reuse the same buffers
    # across chunks
    M55 = np.uint32(0x55555555)
    M33 = np.uint32(0x33333333)
    M0F = np.uint32(0x0F0F0F0F)
    per_block = np.empty((nb, 4), dtype=np.int64)
    CH = 1 << 21
    hi = np.empty((CH, 8), np.uint32)
    lo = np.empty((CH, 8), np.uint32)
    sel = np.empty((CH, 8), np.uint32)
    t = np.empty((CH, 8), np.uint32)
    for lo_r in range(0, nb, CH):
        hi_r = min(nb, lo_r + CH)
        m = hi_r - lo_r
        w = words[lo_r:hi_r]
        h, l, s, tt = hi[:m], lo[:m], sel[:m], t[:m]
        np.right_shift(w, 1, out=h)
        h &= M55
        np.bitwise_and(w, M55, out=l)
        for c in range(4):
            np.bitwise_xor(h, M55 if not (c >> 1) else np.uint32(0), out=s)
            np.bitwise_xor(l, M55 if not (c & 1) else np.uint32(0), out=tt)
            s &= tt
            # popcount32 in place on s
            np.right_shift(s, 1, out=tt)
            tt &= M55
            s -= tt
            np.right_shift(s, 2, out=tt)
            tt &= M33
            s &= M33
            s += tt
            np.right_shift(s, 4, out=tt)
            s += tt
            s &= M0F
            s *= np.uint32(0x01010101)
            np.right_shift(s, 24, out=s)
            per_block[lo_r:hi_r, c] = s.sum(axis=1, dtype=np.int64)
    del hi, lo, sel, t
    ckpt = np.zeros((nb + 1, 4), dtype=np.int64)
    np.cumsum(per_block, axis=0, out=ckpt[1:])
    totals = ckpt[-1]
    L2 = np.zeros(5, dtype=np.int64)
    np.cumsum(totals, out=L2[1:])
    n_sa = (seq_len + sa_intv) // sa_intv
    sa = rng.integers(0, seq_len, size=n_sa, dtype=np.int64)
    sa[0] = -1
    fm = FMIndex.__new__(FMIndex)
    fm.idx = None
    fm.primary = int(rng.integers(1, seq_len))
    fm.seq_len = int(seq_len)
    fm.L2 = L2
    fm.sa_intv = int(sa_intv)
    fm.sa = sa
    fm.n_blocks = nb
    fm.ckpt = ckpt
    fm.words = words
    fm._patterns = np.array(
        [c * 0x55555555 & 0xFFFFFFFF for c in range(4)], dtype=np.uint32
    )
    return fm
