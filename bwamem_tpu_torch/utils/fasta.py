"""FASTA parsing + format sniffing.

Mirrors the reference's pre-flight validation behavior
(BwaMemIndex.java:289-310: sniff '>' within the first 4 KiB before the first
non-blank line) but parses host-side in Python instead of delegating to the
native engine.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import List

import numpy as np

from .encoding import seq_to_codes
from ..api.exceptions import CouldNotReadReferenceException, InvalidFileFormatException


@dataclass
class FastaContig:
    name: str
    comment: str
    codes: np.ndarray  # uint8 in {0..4}

    def __len__(self) -> int:
        return len(self.codes)


@dataclass
class Fasta:
    contigs: List[FastaContig] = field(default_factory=list)

    @property
    def total_len(self) -> int:
        return sum(len(c) for c in self.contigs)


def _open_maybe_gzip(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def sniff_fasta(path: str) -> None:
    """Raise unless the file plausibly is FASTA (first non-blank char '>').

    Reference behavior: BwaMemIndex.java:289-310 scans the first 4 KiB.
    """
    try:
        with _open_maybe_gzip(path) as fh:
            head = fh.read(4096)
    except OSError as exc:
        raise CouldNotReadReferenceException(path, str(exc)) from exc
    for ch in head:
        if ch in (0x20, 0x09, 0x0A, 0x0D):
            continue
        if ch == ord(">"):
            return
        break
    raise InvalidFileFormatException(
        path, "does not look like a FASTA file (no '>' at start)"
    )


def read_fasta(path: str) -> Fasta:
    sniff_fasta(path)
    contigs: List[FastaContig] = []
    name = None
    comment = ""
    chunks: List[bytes] = []

    def flush():
        if name is not None:
            seq = b"".join(chunks)
            contigs.append(FastaContig(name, comment, seq_to_codes(seq)))

    try:
        with _open_maybe_gzip(path) as fh:
            for raw in fh:
                line = raw.strip()
                if not line:
                    continue
                if line.startswith(b">"):
                    flush()
                    header = line[1:].decode("ascii", "replace").strip()
                    parts = header.split(None, 1)
                    name = parts[0] if parts else ""
                    comment = parts[1] if len(parts) > 1 else ""
                    chunks = []
                else:
                    if name is None:
                        raise InvalidFileFormatException(path, "sequence before header")
                    chunks.append(line)
    except OSError as exc:
        raise CouldNotReadReferenceException(path, str(exc)) from exc
    flush()
    if not contigs:
        raise InvalidFileFormatException(path, "no sequences found")
    return Fasta(contigs)
