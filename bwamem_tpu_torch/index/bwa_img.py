"""Reference `.img` interop: the flat ``bwa_idx2mem`` blob format.

The reference flattens the whole ``bwaidx_t`` into one contiguous buffer
(``bwa_idx2mem``), writes it in <=1 GiB chunks (jnibwa.c:126-152), and
restores it with pointer fix-ups after a read-only mmap (``bwa_mem2idx``,
jnibwa.c:154-165).  Every existing GATK deployment has this blob on disk,
so we read it directly — and can write it, so images we build open in the
reference stack too.

Blob layout (bwa.c bwa_idx2mem / bwa_mem2idx at the pinned engine commit,
x86-64 LP64 little-endian):

  [bwt_t               1120 B]  primary, L2[5], seq_len, bwt_size,
                                bwt*, cnt_table[256], sa_intv, n_sa, sa*
  [bwt words    bwt_size x u32]  interleaved occ-checkpoint body
  [sa               n_sa x u64]  sampled SA incl. sa[0] == (bwtint_t)-1
  [bntseq_t              48 B]  l_pac, n_seqs, seed, anns*, n_holes,
                                ambs*, fp_pac
  [ambs          n_holes x 16]  bntamb1_t {offset i64, len i32, amb char}
  [anns           n_seqs x 40]  bntann1_t {offset i64, len, n_ambs, gi,
                                is_alt, name*, anno*}
  [name\\0 anno\\0 per contig  ]
  [pac            l_pac/4 + 1]

Pointer fields inside the structs are stale heap addresses from the
writing process — ``bwa_mem2idx`` overwrites them, and so do we.
"""
from __future__ import annotations

import struct

import numpy as np

from ..api.exceptions import CouldNotReadImageException, InvalidFileFormatException
from .build import BntAmb, BntAnn, Bntseq, BwaIndex, BwtIndex

BWT_T_SIZE = 1120
BNTSEQ_T_SIZE = 48
BNTANN1_T_SIZE = 40
BNTAMB1_T_SIZE = 16


def write_bwa_image(path: str, idx: BwaIndex) -> None:
    """Serialize ``idx`` as a reference-compatible ``bwa_idx2mem`` blob."""
    bwt = idx.bwt
    bns = idx.bns
    out = bytearray()
    # ---- bwt_t ----
    L2 = np.zeros(5, dtype="<u8")
    L2[:] = bwt.L2
    bwt_words = np.ascontiguousarray(bwt.bwt, dtype="<u4")
    buf = bytearray(BWT_T_SIZE)
    struct.pack_into("<Q", buf, 0, bwt.primary)
    for i in range(5):
        struct.pack_into("<Q", buf, 8 + 8 * i, int(L2[i]))
    struct.pack_into("<Q", buf, 48, bwt.seq_len)
    struct.pack_into("<Q", buf, 56, len(bwt_words))  # bwt_size
    # bwt* pointer at 64: stale, zero
    # cnt_table[256] at 72: bwa regenerates it only at index build; the
    # image carries whatever the writer had — fill with the canonical
    # occ-count table so the blob round-trips deterministically
    cnt = _gen_cnt_table()
    buf[72 : 72 + 1024] = cnt.tobytes()
    struct.pack_into("<i", buf, 1096, bwt.sa_intv)
    struct.pack_into("<Q", buf, 1104, bwt.n_sa)
    out += buf
    # ---- bwt words + sa ----
    out += bwt_words.tobytes()
    sa = np.ascontiguousarray(bwt.sa, dtype="<i8").view("<u8")
    assert len(sa) == bwt.n_sa
    out += sa.tobytes()
    # ---- bntseq_t ----
    buf = bytearray(BNTSEQ_T_SIZE)
    struct.pack_into("<q", buf, 0, bns.l_pac)
    struct.pack_into("<i", buf, 8, bns.n_seqs)
    struct.pack_into("<I", buf, 12, bns.seed)
    struct.pack_into("<i", buf, 24, len(bns.ambs))
    out += buf
    # ---- ambs ----
    for h in bns.ambs:
        buf = bytearray(BNTAMB1_T_SIZE)
        struct.pack_into("<q", buf, 0, h.offset)
        struct.pack_into("<i", buf, 8, h.length)
        struct.pack_into("<b", buf, 12, ord(h.amb[0]) if h.amb else 0)
        out += buf
    # ---- anns + strings ----
    for a in bns.anns:
        buf = bytearray(BNTANN1_T_SIZE)
        struct.pack_into("<q", buf, 0, a.offset)
        struct.pack_into("<i", buf, 8, a.length)
        struct.pack_into("<i", buf, 12, a.n_ambs)
        struct.pack_into("<I", buf, 16, a.gi)
        struct.pack_into("<i", buf, 20, a.is_alt)
        out += buf
    for a in bns.anns:
        out += a.name.encode() + b"\x00"
        # a reference-produced blob (bwa_idx_load -> bwa_idx2mem) carries
        # the literal "(null)" token for empty annos, because bns_restore
        # keeps the .ann placeholder verbatim; mirror that byte-exactly
        out += (a.anno or "(null)").encode() + b"\x00"
    # ---- pac: l_pac/4 + 1 bytes ----
    n_pac = bns.l_pac // 4 + 1
    pac = np.zeros(n_pac, dtype=np.uint8)
    avail = min(len(idx.pac), n_pac)
    pac[:avail] = idx.pac[:avail]
    out += pac.tobytes()
    with open(path, "wb") as fh:
        mv = memoryview(out)
        while mv:  # <=1 GiB write chunks like jnibwa_createIndexFile
            fh.write(mv[: 1 << 30])
            mv = mv[1 << 30 :]


def looks_like_bwa_image(path: str) -> bool:
    """Cheap sniff: consistent bwt_t header fields at the blob start."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(BWT_T_SIZE)
    except OSError:
        return False
    if len(head) < BWT_T_SIZE:
        return False
    primary = struct.unpack_from("<Q", head, 0)[0]
    L2 = struct.unpack_from("<5Q", head, 8)
    seq_len = struct.unpack_from("<Q", head, 48)[0]
    bwt_size = struct.unpack_from("<Q", head, 56)[0]
    if L2[0] != 0 or L2[4] != seq_len or seq_len == 0:
        return False
    if not (primary <= seq_len):
        return False
    # interleaved body: 8 ckpt words per 128-char block + data + final ckpt
    return bwt_size * 16 >= seq_len


def read_bwa_image(path: str) -> BwaIndex:
    """Open a reference-produced ``.img`` blob (bwa_mem2idx semantics).

    A malformed or truncated blob (a corrupted GATK image) raises the
    typed InvalidFileFormatException — never a bare numpy/struct error
    (image validation contract, BwaMemIndex.java:232-249).
    """
    try:
        mem = np.fromfile(path, dtype=np.uint8)
    except OSError as exc:
        raise CouldNotReadImageException(path, str(exc)) from exc
    buf = mem.tobytes()

    def need(cond, msg):
        if not cond:
            raise InvalidFileFormatException(path, f"bwa image {msg}")

    need(len(buf) >= BWT_T_SIZE + BNTSEQ_T_SIZE, "truncated")
    try:
        return _parse_bwa_image(buf, need)
    except InvalidFileFormatException:
        raise
    except (struct.error, ValueError, IndexError, OverflowError,
            MemoryError, UnicodeDecodeError) as exc:
        raise InvalidFileFormatException(path, f"malformed: {exc}") from exc


def _parse_bwa_image(buf: bytes, need) -> BwaIndex:
    k = 0
    primary = struct.unpack_from("<Q", buf, 0)[0]
    L2 = np.asarray(struct.unpack_from("<5Q", buf, 8), dtype=np.int64)
    seq_len = struct.unpack_from("<Q", buf, 48)[0]
    bwt_size = struct.unpack_from("<Q", buf, 56)[0]
    sa_intv = struct.unpack_from("<i", buf, 1096)[0]
    n_sa = struct.unpack_from("<Q", buf, 1104)[0]
    need(0 < seq_len < (1 << 40), "seq_len out of range")
    need(L2[0] == 0 and L2[4] == seq_len, "L2 inconsistent")
    need(all(L2[i] <= L2[i + 1] for i in range(4)), "L2 not monotone")
    need(primary <= seq_len, "primary out of range")
    need(sa_intv > 0, "sa_intv not positive")
    k = BWT_T_SIZE
    need(bwt_size * 4 + k <= len(buf), "bwt body truncated")
    need(bwt_size * 16 >= seq_len, "bwt_size too small for seq_len")
    words = np.frombuffer(buf, dtype="<u4", count=bwt_size, offset=k).copy()
    k += bwt_size * 4
    need(n_sa > 0 and k + n_sa * 8 <= len(buf), "sampled SA truncated")
    sa = (
        np.frombuffer(buf, dtype="<u8", count=n_sa, offset=k)
        .astype(np.int64, copy=True)
    )
    sa[0] = -1  # stored as (bwtint_t)-1
    k += n_sa * 8
    need(k + BNTSEQ_T_SIZE <= len(buf), "bntseq header truncated")
    l_pac = struct.unpack_from("<q", buf, k)[0]
    n_seqs = struct.unpack_from("<i", buf, k + 8)[0]
    seed = struct.unpack_from("<I", buf, k + 12)[0]
    n_holes = struct.unpack_from("<i", buf, k + 24)[0]
    k += BNTSEQ_T_SIZE
    need(l_pac > 0 and 2 * l_pac == seq_len, "l_pac/seq_len mismatch")
    need(n_seqs > 0, "n_seqs not positive")
    need(n_holes >= 0, "n_holes negative")
    need(k + n_holes * BNTAMB1_T_SIZE + n_seqs * BNTANN1_T_SIZE <= len(buf),
         "ann/amb records truncated")
    bns = Bntseq(l_pac=l_pac, seed=seed)
    for _ in range(n_holes):
        off = struct.unpack_from("<q", buf, k)[0]
        ln = struct.unpack_from("<i", buf, k + 8)[0]
        amb = chr(buf[k + 12]) if buf[k + 12] else "N"
        bns.ambs.append(BntAmb(off, ln, amb))
        k += BNTAMB1_T_SIZE
    ann_meta = []
    for _ in range(n_seqs):
        off = struct.unpack_from("<q", buf, k)[0]
        ln = struct.unpack_from("<i", buf, k + 8)[0]
        n_ambs = struct.unpack_from("<i", buf, k + 12)[0]
        gi = struct.unpack_from("<I", buf, k + 16)[0]
        is_alt = struct.unpack_from("<i", buf, k + 20)[0]
        ann_meta.append((off, ln, n_ambs, gi, is_alt))
        k += BNTANN1_T_SIZE
    for off, ln, n_ambs, gi, is_alt in ann_meta:
        end = buf.find(b"\x00", k)
        need(end >= 0, "contig name strings truncated")
        name = buf[k:end].decode()
        k = end + 1
        end = buf.find(b"\x00", k)
        need(end >= 0, "contig anno strings truncated")
        anno = buf[k:end].decode()
        k = end + 1
        if anno == "(null)":
            anno = ""
        bns.anns.append(
            BntAnn(offset=off, name=name, anno=anno, length=ln,
                   n_ambs=n_ambs, gi=gi, is_alt=is_alt)
        )
    n_pac_img = l_pac // 4 + 1
    need(k + n_pac_img <= len(buf), "pac truncated")
    n_pac = (l_pac + 3) >> 2
    pac = np.frombuffer(buf, dtype=np.uint8, count=n_pac, offset=k).copy()
    bwt = BwtIndex(
        primary=primary, L2=L2, seq_len=seq_len, bwt=words,
        sa_intv=sa_intv, sa=sa,
    )
    need(bwt.n_sa == n_sa, "n_sa inconsistent")
    return BwaIndex(bns=bns, pac=pac, bwt=bwt)


def _gen_cnt_table() -> np.ndarray:
    """[EXT] bwt_gen_cnt_table: counts of symbols 0..3 within one packed
    byte, 8 bits per symbol."""
    tbl = np.zeros(256, dtype="<u4")
    for i in range(256):
        v = 0
        for j in range(4):
            c = (i >> (2 * j)) & 3
            v += 1 << (8 * c)
        tbl[i] = v
    return tbl
