"""Base encoding utilities.

bwa's 2-bit alphabet: A=0, C=1, G=2, T=3, anything else (N, IUPAC) = 4.
Packed ``pac`` layout matches bwa's: base i lives in byte ``i >> 2`` at bit
offset ``(~i & 3) << 1`` (big-endian within the byte), per the reference's
[EXT] bntseq.c contract (anchored by jnibwa.c:174-195 coordinate handling).
"""
from __future__ import annotations

import numpy as np

# ASCII -> 2-bit code lookup (256 entries), 4 = ambiguous.
NST_NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    NST_NT4_TABLE[ord(_ch)] = _code
    NST_NT4_TABLE[ord(_ch.lower())] = _code

CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def seq_to_codes(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes in {0..4}."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        arr = np.asarray(seq, dtype=np.uint8)
    return NST_NT4_TABLE[arr]


def seq_to_codes_batch(seqs) -> list:
    """Batch seq_to_codes: one table lookup over the joined buffer, then
    per-read views (no per-read numpy dispatch overhead)."""
    enc = [s.encode("ascii") if isinstance(s, str) else s for s in seqs]
    if not all(isinstance(s, (bytes, bytearray, memoryview)) for s in enc):
        return [seq_to_codes(s) for s in seqs]
    joined = b"".join(bytes(s) for s in enc)
    codes = NST_NT4_TABLE[np.frombuffer(joined, dtype=np.uint8)]
    out = []
    pos = 0
    for s in enc:
        n = len(s)
        out.append(codes[pos : pos + n])
        pos += n
    return out


def codes_to_seq(codes: np.ndarray) -> bytes:
    return CODE_TO_BASE[np.asarray(codes, dtype=np.uint8)].tobytes()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space; ambiguous (4) stays 4."""
    codes = np.asarray(codes)
    out = np.where(codes < 4, 3 - codes, codes)
    return out[::-1].copy()


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack codes (<4 only) into bwa pac byte layout (4 bases/byte, MSB first)."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    padded = np.zeros((n + 3) & ~3, dtype=np.uint8)
    padded[:n] = codes
    quads = padded.reshape(-1, 4)
    return (
        (quads[:, 0] << 6) | (quads[:, 1] << 4) | (quads[:, 2] << 2) | quads[:, 3]
    ).astype(np.uint8)


def unpack_2bit(pac: np.ndarray, n: int) -> np.ndarray:
    """Unpack bwa pac bytes back to ``n`` codes."""
    pac = np.asarray(pac, dtype=np.uint8)
    quads = np.empty((len(pac), 4), dtype=np.uint8)
    quads[:, 0] = (pac >> 6) & 3
    quads[:, 1] = (pac >> 4) & 3
    quads[:, 2] = (pac >> 2) & 3
    quads[:, 3] = pac & 3
    return quads.reshape(-1)[:n]
