"""FASTQ/FASTA read streaming.

The reference's API drops read names and base qualities (bseq1_t built with
empty names, jnibwa.c:199-210); we accept and carry them — a deliberate
improvement noted in SURVEY.md section 7.4 — since SAM output needs both.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, Optional

from ..api.exceptions import InvalidFileFormatException


@dataclass
class Read:
    name: str
    seq: bytes
    qual: Optional[str] = None
    comment: str = ""


def _open(path: str):
    with open(path, "rb") as fh:
        if fh.read(2) == b"\x1f\x8b":
            return gzip.open(path, "rb")
    return open(path, "rb")


def read_fastx(path: str) -> Iterator[Read]:
    """Stream reads from FASTQ or FASTA (auto-detected, gzip ok)."""
    with _open(path) as fh:
        first = fh.readline()
        if not first:
            return
        if first.startswith(b"@"):  # FASTQ
            line = first
            while line:
                if not line.startswith(b"@"):
                    raise InvalidFileFormatException(path, "bad FASTQ header")
                hdr = line[1:].rstrip(b"\n").decode()
                parts = hdr.split(None, 1)
                seq = fh.readline().strip()
                plus = fh.readline()
                if not plus.startswith(b"+"):
                    raise InvalidFileFormatException(path, "missing '+' line")
                qual = fh.readline().strip().decode()
                yield Read(
                    name=parts[0] if parts else "",
                    seq=bytes(seq),
                    qual=qual or None,
                    comment=parts[1] if len(parts) > 1 else "",
                )
                line = fh.readline()
        elif first.startswith(b">"):  # FASTA
            name = None
            comment = ""
            chunks = []
            line = first
            while line:
                if line.startswith(b">"):
                    if name is not None:
                        yield Read(name, b"".join(chunks), None, comment)
                    hdr = line[1:].rstrip(b"\n").decode()
                    parts = hdr.split(None, 1)
                    name = parts[0] if parts else ""
                    comment = parts[1] if len(parts) > 1 else ""
                    chunks = []
                else:
                    chunks.append(line.strip())
                line = fh.readline()
            if name is not None:
                yield Read(name, b"".join(chunks), None, comment)
        else:
            raise InvalidFileFormatException(path, "not FASTA/FASTQ")
