"""Reference index construction.

Builds the same logical index the reference's engine builds via
``bwa_idx_build`` (invoked from the JNI layer at
org_broadinstitute_hellbender_utils_bwa_BwaMemIndex.c:59):

  * ``pac``  — 2-bit packed forward reference ([EXT] bntseq.c semantics)
  * ``ann``/``amb`` metadata — contig names/offsets + ambiguous-base holes
  * BWT of forward+reverse-complement (length 2*l_pac) with interleaved
    Occ checkpoints every 128 bases (bwa .bwt layout, validated byte-exact
    against src/test/resources/ref.fa.bwt)
  * sampled suffix array, interval 32 (bwa .sa layout)

Layout compatibility matters because (a) the reference's checked-in rotavirus
index files are our construction oracle and (b) we accept prebuilt bwa index
files exactly like ``BwaMemIndex.createIndexImageFromIndexFiles``
(BwaMemIndex.java:195-216).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..utils.encoding import pack_2bit, revcomp_codes, unpack_2bit
from ..utils.fasta import Fasta
from . import native_sais
from .sais import bwt_from_sa, suffix_array

OCC_INTERVAL = 0x80  # 128 bases per checkpoint block (bwa bwt.h)
SA_INTERVAL = 32  # bwa default suffix-array sampling


@dataclass
class BntAnn:
    """One contig's metadata ([EXT] bntann1_t)."""

    offset: int
    name: str
    anno: str = ""
    length: int = 0
    n_ambs: int = 0
    gi: int = 0
    is_alt: int = 0


@dataclass
class BntAmb:
    """One ambiguous-base hole ([EXT] bntamb1_t)."""

    offset: int
    length: int
    amb: str  # the original character


@dataclass
class Bntseq:
    """Reference metadata ([EXT] bntseq_t): .ann + .amb content."""

    l_pac: int = 0
    seed: int = 11
    anns: List[BntAnn] = field(default_factory=list)
    ambs: List[BntAmb] = field(default_factory=list)

    @property
    def n_seqs(self) -> int:
        return len(self.anns)

    def pos_to_rid(self, pos: int) -> int:
        """Contig id containing forward-strand position pos, or -1."""
        lo, hi = 0, len(self.anns)
        while lo < hi:
            mid = (lo + hi) // 2
            a = self.anns[mid]
            if pos < a.offset:
                hi = mid
            elif pos >= a.offset + a.length:
                lo = mid + 1
            else:
                return mid
        return -1

    def intv_to_rid(self, rb: int, re: int) -> int:
        """rid if [rb, re) sits inside one contig on one strand, else -1.

        Semantics of [EXT] bns_intv2rid as used by mem_chain (anchored via
        jnibwa.c:214's mem_process_seqs call): coordinates are on the
        2*l_pac doubled domain.
        """
        if (rb < self.l_pac) != (re <= self.l_pac):
            return -1  # crosses the forward/reverse boundary
        fb = rb if rb < self.l_pac else (self.l_pac << 1) - 1 - (re - 1)
        fe = (re - 1) if rb < self.l_pac else (self.l_pac << 1) - 1 - rb
        rid = self.pos_to_rid(fb)
        if rid < 0 or rid != self.pos_to_rid(fe):
            return -1
        return rid

    def depos(self, pos: int) -> tuple[int, bool]:
        """Doubled-domain position -> (forward position, is_rev).

        [EXT] bns_depos semantics: reverse positions map to
        (l_pac<<1) - 1 - pos.
        """
        is_rev = pos >= self.l_pac
        if is_rev:
            pos = (self.l_pac << 1) - 1 - pos
        return pos, is_rev


@dataclass
class BwtIndex:
    """FM-index core ([EXT] bwt_t): packed BWT + Occ checkpoints + sampled SA."""

    primary: int
    L2: np.ndarray  # int64[5], cumulative symbol counts (L2[0] == 0)
    seq_len: int  # 2 * l_pac
    bwt: np.ndarray  # uint32, interleaved ckpt/data (bwa .bwt body layout)
    sa_intv: int
    sa: np.ndarray  # int64[n_sa]; sa[0] is -1 (unused)

    @property
    def n_sa(self) -> int:
        return (self.seq_len + self.sa_intv) // self.sa_intv


@dataclass
class BwaIndex:
    bns: Bntseq
    pac: np.ndarray  # uint8, ceil(l_pac/4) packed forward bases
    bwt: BwtIndex

    # references up to this size keep an unpacked uint8 cache for O(slice)
    # get_seq (1 byte/base) — the zero-copy buffer behind the native fast
    # paths.  Sized to the host: an eighth of physical RAM, at least 256 Mbp
    # (GRCh38 needs ~3.1 GB on a >=25 GB host).  BWAMEM_TPU_UNPACK_MAX
    # overrides (bytes).
    _UNPACK_CACHE_MAX = 256_000_000
    try:
        _UNPACK_CACHE_MAX = max(
            _UNPACK_CACHE_MAX,
            (os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")) // 8,
        )
    except (ValueError, OSError, AttributeError):  # non-POSIX fallback
        pass
    try:
        _UNPACK_CACHE_MAX = int(
            os.environ.get("BWAMEM_TPU_UNPACK_MAX", _UNPACK_CACHE_MAX)
        )
    except ValueError:  # malformed override: keep the host-sized default
        pass

    def get_seq(self, beg: int, end: int) -> np.ndarray:
        """Fetch codes for [beg, end) on the doubled 2*l_pac domain.

        Forward positions read pac directly; reverse positions are the
        reverse complement mirrored at (l_pac<<1)-1-pos ([EXT] bns_get_seq).
        Caller must not span the strand boundary.
        """
        l_pac = self.bns.l_pac
        assert 0 <= beg <= end <= 2 * l_pac
        if beg >= l_pac:  # fully reverse strand
            fwd_beg = 2 * l_pac - end
            fwd_end = 2 * l_pac - beg
            seg = self._fwd_codes(fwd_beg, fwd_end)
            return revcomp_codes(seg)
        assert end <= l_pac, "interval spans the strand boundary"
        return self._fwd_codes(beg, end)

    def fetch_seq(self, beg: int, mid: int, end: int):
        """[EXT] bns_fetch_seq: clamp [beg, end) to the contig containing
        ``mid`` (on mid's strand in the doubled domain), then fetch.

        Returns (codes, beg, end, rid) with the clamped bounds; callers
        (mem_matesw / mem_seed_sw analogs) must check rid themselves.
        """
        bns = self.bns
        l_pac = bns.l_pac
        if end < beg:
            beg, end = end, beg
        assert beg <= mid < end
        fpos, is_rev = bns.depos(mid)
        rid = bns.pos_to_rid(fpos)
        ann = bns.anns[rid]
        far_beg = ann.offset
        far_end = far_beg + ann.length
        if is_rev:  # flip the contig span to the reverse strand
            far_beg, far_end = (l_pac << 1) - far_end, (l_pac << 1) - far_beg
        beg = max(beg, far_beg)
        end = min(end, far_end)
        return self.get_seq(beg, end), beg, end, rid

    def unpacked_fwd(self):
        """Unpacked forward codes cache (None above the size cutoff) — the
        zero-copy reference buffer for the native kernels."""
        cache = getattr(self, "_unpacked", None)
        if cache is None and self.bns.l_pac <= self._UNPACK_CACHE_MAX:
            cache = unpack_2bit(np.asarray(self.pac), self.bns.l_pac)
            from ..utils.hugepages import advise_hugepages

            advise_hugepages(cache)  # random extension windows over ~GBs
            object.__setattr__(self, "_unpacked", cache)
        return cache

    def _fwd_codes(self, beg: int, end: int) -> np.ndarray:
        cache = self.unpacked_fwd()
        if cache is not None:
            return cache[beg:end]
        byte_beg = beg >> 2
        byte_end = (end + 3) >> 2
        codes = unpack_2bit(self.pac[byte_beg:byte_end], (byte_end << 2) - (byte_beg << 2))
        return codes[beg - (byte_beg << 2) : end - (byte_beg << 2)]


class _Lrand48:
    """drand48-family LCG, used to match bwa's ambiguous-base replacement.

    bwa seeds srand48(bns->seed) (seed 11, recorded in .ann line 1) and
    replaces each non-ACGT base with lrand48() & 3.
    """

    MASK = (1 << 48) - 1
    A = 0x5DEECE66D
    C = 0xB

    def __init__(self, seed: int):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def next(self) -> int:
        self.x = (self.A * self.x + self.C) & self.MASK
        return self.x >> 17  # 31-bit non-negative long


def interleave_bwt(bwt_codes: np.ndarray) -> np.ndarray:
    """Pack stored-BWT codes into bwa's interleaved .bwt body (vectorized).

    Per 128-base block: 4 x int64 cumulative counts (of stored chars before
    the block), then 8 x uint32 of 2-bit packed chars (16/word, MSB-first
    pairs); a final count record follows the last block.

    Word packing and per-block counting run in bounded slices so the
    temporaries stay ~100 MB regardless of genome size (a whole-GRCh38
    stored BWT is 6.2 G codes; full-size uint32 temps would be ~25 GB).
    """
    n = len(bwt_codes)
    if n >= (1 << 22) and native_sais.available():
        # whole-genome stored BWTs: the parallel native pass (seconds where
        # the numpy formulation below is minutes); output bit-identical
        return native_sais.interleave_bwt(bwt_codes)
    n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)
    words_all = np.empty(n_blocks * 8, dtype=np.uint32)
    per_block = np.empty((n_blocks, 4), dtype=np.int64)
    CHUNK_BLOCKS = 1 << 21  # 256 Mbases per slice
    for b0 in range(0, n_blocks, CHUNK_BLOCKS):
        b1 = min(b0 + CHUNK_BLOCKS, n_blocks)
        lo, hi = b0 * OCC_INTERVAL, b1 * OCC_INTERVAL
        if hi <= n:
            seg = np.ascontiguousarray(bwt_codes[lo:hi], dtype=np.uint32)
        else:
            seg = np.zeros(hi - lo, dtype=np.uint32)
            seg[: n - lo] = bwt_codes[lo:n]
        words_all[b0 * 8 : b1 * 8] = (
            (seg.reshape(-1, 16) << shifts)
            .astype(np.uint32)
            .sum(axis=1, dtype=np.uint32)
        )
        blocks = seg.reshape(b1 - b0, OCC_INTERVAL)
        for c in range(4):
            per_block[b0:b1, c] = (blocks == c).sum(axis=1, dtype=np.int64)
    if n % OCC_INTERVAL:  # zero-padding counted as symbol 0: remove it
        per_block[-1, 0] -= n_blocks * OCC_INTERVAL - n
    ckpt = np.zeros((n_blocks + 1, 4), dtype=np.int64)
    np.cumsum(per_block, axis=0, out=ckpt[1:])
    # assemble: per full block 8 ckpt words + 8 data words; last block may
    # carry fewer data words; final checkpoint appended
    words_per_block = np.full(n_blocks, 8, dtype=np.int64)
    last_chars = n - (n_blocks - 1) * OCC_INTERVAL
    words_per_block[-1] = (last_chars + 15) // 16
    total = int(8 * n_blocks + words_per_block.sum() + 8)
    out = np.empty(total, dtype=np.uint32)
    block_starts = np.zeros(n_blocks, dtype=np.int64)
    np.cumsum(8 + words_per_block[:-1], out=block_starts[1:])
    ck32 = ckpt.view(np.uint32).reshape(n_blocks + 1, 8)
    # checkpoint words
    idx = block_starts[:, None] + np.arange(8)[None, :]
    out[idx.reshape(-1)] = ck32[:n_blocks].reshape(-1)
    # data words (full blocks vectorized; last block separately)
    if n_blocks > 1:
        didx = (block_starts[:-1, None] + 8) + np.arange(8)[None, :]
        out[didx.reshape(-1)] = words_all[: 8 * (n_blocks - 1)]
    lb = int(block_starts[-1]) + 8
    lw = int(words_per_block[-1])
    out[lb : lb + lw] = words_all[8 * (n_blocks - 1) : 8 * (n_blocks - 1) + lw]
    out[lb + lw : lb + lw + 8] = ck32[n_blocks]
    return out


def deinterleave_bwt(data: np.ndarray, seq_len: int) -> np.ndarray:
    """Inverse of interleave_bwt: recover stored-BWT codes (uint8)."""
    data = np.asarray(data, dtype=np.uint32)
    n_blocks = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
    codes = np.empty(seq_len, dtype=np.uint8)
    pos = 0
    for b in range(n_blocks):
        pos += 8  # skip checkpoint counts (4 x int64 = 8 words)
        beg = b * OCC_INTERVAL
        end = min(beg + OCC_INTERVAL, seq_len)
        n_words = (end - beg + 15) // 16
        words = data[pos : pos + n_words]
        pos += n_words
        expand = np.empty(n_words * 16, dtype=np.uint8)
        for k in range(16):
            expand[k::16] = (words >> np.uint32(30 - 2 * k)) & 3
        codes[beg:end] = expand[: end - beg]
    return codes


def build_bns_and_pac(fasta: Fasta, seed: int = 11, consume: bool = False):
    """FASTA -> (Bntseq, pac bytes, forward codes with ambiguity replaced).

    ``consume=True`` mutates/releases the caller's contig arrays as it goes
    (ambiguity replacement happens in place and ``contig.codes`` is dropped)
    — the genome-scale discipline: no second copy of the reference."""
    bns = Bntseq(seed=seed)
    rng = _Lrand48(seed)
    all_codes: List[np.ndarray] = []
    offset = 0
    for contig in fasta.contigs:
        codes = contig.codes if consume else contig.codes.copy()
        if consume:
            contig.codes = None
        n_ambs = 0
        # record maximal runs of ambiguous bases, replace with pseudo-random
        amb = codes >= 4
        if amb.any():
            idx = np.nonzero(amb)[0]
            run_start = None
            prev = None
            for i in idx.tolist():
                if run_start is None:
                    run_start = i
                elif i != prev + 1:
                    bns.ambs.append(
                        BntAmb(offset + run_start, prev - run_start + 1, "N")
                    )
                    n_ambs += 1
                    run_start = i
                prev = i
                codes[i] = rng.next() & 3
            bns.ambs.append(BntAmb(offset + run_start, prev - run_start + 1, "N"))
            n_ambs += 1
        bns.anns.append(
            BntAnn(
                offset=offset,
                name=contig.name,
                anno=contig.comment,
                length=len(codes),
                n_ambs=n_ambs,
            )
        )
        all_codes.append(codes)
        offset += len(codes)
    bns.l_pac = offset
    if not all_codes:
        fwd = np.zeros(0, dtype=np.uint8)
    elif len(all_codes) == 1:
        fwd = all_codes[0]  # avoid the gigabyte-scale concatenate copy
    else:
        fwd = np.concatenate(all_codes)
    pac = pack_2bit(fwd)
    return bns, pac, fwd


def build_bwt(fwd_codes: np.ndarray, sa_intv: int = SA_INTERVAL) -> BwtIndex:
    """Build the FM-index over forward + reverse-complement."""
    S = np.concatenate([fwd_codes, revcomp_codes(fwd_codes)]).astype(np.uint8)
    seq_len = len(S)
    sa_full = suffix_array(S)  # length seq_len+1, sa_full[0] == seq_len
    bwt_codes, primary = bwt_from_sa(S, sa_full)
    counts = np.bincount(S, minlength=4).astype(np.int64)
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = np.cumsum(counts[:4])
    # sample the SA first and release the full array (8 bytes/position —
    # 50 GB for whole-GRCh38) before the interleave pass allocates
    n_sa = (seq_len + sa_intv) // sa_intv
    sa = np.empty(n_sa, dtype=np.int64)
    sa[:] = sa_full[np.arange(n_sa) * sa_intv]
    sa[0] = -1  # bwa convention: row 0 (sentinel) is never resolved via sa[0]
    del sa_full
    data = interleave_bwt(bwt_codes)
    return BwtIndex(
        primary=primary, L2=L2, seq_len=seq_len, bwt=data, sa_intv=sa_intv, sa=sa
    )


def _int64_build_fits_ram(l_pac: int) -> bool:
    """Would the in-RAM int64 constructor fit comfortably on this host?

    Measured peak is ~19 bytes/symbol over the doubled text (116 GB for
    GRCh38, BENCH_GRCH38_r02.json).  ``auto`` keeps the faster in-RAM
    constructor when that fits in ~60% of physical RAM and falls back to the
    bounded-memory constructor otherwise — the same speed/memory split bwa's
    AUTO makes between is and rb2 (BwaMemIndex.java:56-71)."""
    try:
        phys = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return False  # unknown host: choose the bounded-memory constructor
    return 19 * 2 * l_pac <= 0.6 * phys


def _pac_code_counts(pac: np.ndarray, l_pac: int) -> np.ndarray:
    """Per-code counts (int64[4]) of the forward strand, from pac bytes.

    One 256-entry LUT contraction over a byte histogram — O(1) extra memory
    at any genome size (the frugal path never unpacks the reference)."""
    lut = np.zeros((256, 4), dtype=np.int64)
    for b in range(256):
        for k in range(4):
            lut[b, (b >> (2 * (3 - k))) & 3] += 1
    byte_hist = np.bincount(np.asarray(pac, dtype=np.uint8), minlength=256)
    counts = byte_hist.astype(np.int64) @ lut
    counts[0] -= 4 * len(pac) - l_pac  # zero-padding in the last byte
    return counts


def build_bwt_frugal(pac: np.ndarray, l_pac: int,
                     sa_intv: int = SA_INTERVAL) -> BwtIndex:
    """FM-index over fwd+rc straight from the 2-bit pac, in bounded memory.

    The package's ``Algorithm.RB2`` axis (BwaMemIndex.java:66-71): same
    output as :func:`build_bwt`, but via the 40-bit packed-SA / 2-bit-text
    constructor (native/sais40.cpp) — ~44 GB peak for a 3.1 Gbp reference where
    the int64 in-RAM path needs ~116 GB.  Raises if the native library is
    unavailable; callers fall back to :func:`build_bwt`.
    """
    bwt_codes, primary, sa, _n1 = native_sais.build_bwt_pac40(
        pac, l_pac, sa_intv
    )
    fwd_counts = _pac_code_counts(pac, l_pac)
    counts = fwd_counts + fwd_counts[::-1]  # doubled text: fwd + revcomp
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = np.cumsum(counts)
    sa[0] = -1  # bwa convention: row 0 (sentinel) is never resolved via sa[0]
    data = interleave_bwt(bwt_codes)
    return BwtIndex(
        primary=primary, L2=L2, seq_len=2 * l_pac, bwt=data, sa_intv=sa_intv,
        sa=sa,
    )


def build_index(fasta: Fasta, seed: int = 11, sa_intv: int = None,
                algo: str = "auto", consume: bool = False) -> BwaIndex:
    """Build the full index.  ``algo`` mirrors BwaMemIndex.Algorithm
    (BwaMemIndex.java:46-80): ``auto`` picks the in-RAM constructor below 2 Gbp
    and the bounded-memory constructor above it (bwa's is/rb2 split), ``is``
    forces in-RAM, ``rb2`` forces bounded-memory.  ``consume=True`` releases
    the caller's contig arrays during construction (see build_bns_and_pac).

    ``sa_intv`` is the sampled-suffix-array density — a pure space/time
    knob with NO effect on alignment output (every SA walk lands on the
    same exact value; a denser sample just shortens the walk).  Default:
    env ``BWAMEM_TPU_SA_INTV`` if set, else bwa's 32 ([EXT] bwtindex.c),
    which keeps exported .sa files byte-identical to bwa's.  The full SA
    exists during construction, so denser sampling is free at build time;
    8 quarters the average walk for 4x the sample storage."""
    if sa_intv is None:
        sa_intv = int(os.environ.get("BWAMEM_TPU_SA_INTV", SA_INTERVAL))
    if sa_intv < 1 or (sa_intv & (sa_intv - 1)):
        from ..api.exceptions import InvalidInputException

        raise InvalidInputException("sa_intv must be a positive power of two")
    bns, pac, fwd = build_bns_and_pac(fasta, seed, consume=consume)
    if bns.l_pac == 0:
        from ..api.exceptions import CouldNotCreateIndexException

        raise CouldNotCreateIndexException("reference contains no bases")
    frugal = algo == "rb2" or (
        algo == "auto"
        and 2 * bns.l_pac + 1 >= 2**31
        and not _int64_build_fits_ram(bns.l_pac)
    )
    if frugal and native_sais.available():
        fwd = None  # the frugal path never needs unpacked codes
        try:
            bwt = build_bwt_frugal(pac, bns.l_pac, sa_intv)
            return BwaIndex(bns=bns, pac=pac, bwt=bwt)
        except RuntimeError:  # adversarial reduced problem: int64 fallback
            fwd = unpack_2bit(np.asarray(pac), bns.l_pac)
    bwt = build_bwt(fwd, sa_intv)
    return BwaIndex(bns=bns, pac=pac, bwt=bwt)
