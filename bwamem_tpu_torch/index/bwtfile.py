"""Readers/writers for bwa's on-disk index file formats (.bwt/.sa/.pac/.ann/.amb).

These formats are the input contract of
``BwaMemIndex.createIndexImageFromIndexFiles`` (BwaMemIndex.java:195-216):
users hand us indexes built by stock ``bwa index`` and we must load them.
They are also our construction oracle — the reference checks the rotavirus
index files into src/test/resources/, so our constructor is validated byte-exact
against them (see tests/test_index_build.py).

Binary layout (verified against the fixtures):
  .bwt: uint64 primary; uint64 L2[1..4]; interleaved body
        (per 128-base block: 4x uint64 counts then 2-bit packed chars,
         16 per uint32 word; final counts appended)
  .sa:  uint64 primary; uint64 L2[1..4]; uint64 sa_intv; uint64 seq_len;
        uint64 sa[1..n_sa-1]  (sa[0] == -1 is not stored)
  .pac: ceil(l/4) packed bytes; +0x00 pad byte iff l%4==0; final byte l%4
  .ann/.amb: text, see Bntseq docstring
"""
from __future__ import annotations

import os

import numpy as np

from ..api.exceptions import CouldNotReadIndexException, InvalidFileFormatException
from .build import Bntseq, BntAnn, BntAmb, BwaIndex, BwtIndex


def write_bwt(path: str, bwt: BwtIndex) -> None:
    with open(path, "wb") as fh:
        np.asarray([bwt.primary], dtype="<u8").tofile(fh)
        np.asarray(bwt.L2[1:5], dtype="<u8").tofile(fh)
        np.asarray(bwt.bwt, dtype="<u4").tofile(fh)


def read_bwt(path: str, sa_path: str | None = None) -> BwtIndex:
    try:
        raw = np.fromfile(path, dtype="<u4")
    except OSError as exc:
        raise CouldNotReadIndexException(path, str(exc)) from exc
    if len(raw) < 10:
        raise InvalidFileFormatException(path, "truncated .bwt")
    head = raw[:10].view("<u8")
    primary = int(head[0])
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = head[1:5].astype(np.int64)
    seq_len = int(L2[4])
    body = raw[10:].astype(np.uint32)
    bwt = BwtIndex(
        primary=primary,
        L2=L2,
        seq_len=seq_len,
        bwt=body,
        sa_intv=0,
        sa=np.zeros(0, dtype=np.int64),
    )
    if sa_path is not None:
        read_sa_into(sa_path, bwt)
    return bwt


def write_sa(path: str, bwt: BwtIndex) -> None:
    with open(path, "wb") as fh:
        np.asarray([bwt.primary], dtype="<u8").tofile(fh)
        np.asarray(bwt.L2[1:5], dtype="<u8").tofile(fh)
        np.asarray([bwt.sa_intv, bwt.seq_len], dtype="<u8").tofile(fh)
        np.asarray(bwt.sa[1:], dtype="<u8").tofile(fh)


def read_sa_into(path: str, bwt: BwtIndex) -> None:
    try:
        raw = np.fromfile(path, dtype="<u8")
    except OSError as exc:
        raise CouldNotReadIndexException(path, str(exc)) from exc
    if len(raw) < 7:
        raise InvalidFileFormatException(path, "truncated .sa")
    primary = int(raw[0])
    if primary != bwt.primary:
        raise InvalidFileFormatException(path, ".sa/.bwt primary mismatch")
    sa_intv = int(raw[5])
    seq_len = int(raw[6])
    if seq_len != bwt.seq_len:
        raise InvalidFileFormatException(path, ".sa/.bwt seq_len mismatch")
    n_sa = (seq_len + sa_intv) // sa_intv
    vals = raw[7:]
    if len(vals) != n_sa - 1:
        raise InvalidFileFormatException(path, ".sa entry count mismatch")
    sa = np.empty(n_sa, dtype=np.int64)
    sa[0] = -1
    sa[1:] = vals.astype(np.int64)
    bwt.sa_intv = sa_intv
    bwt.sa = sa


def write_pac(path: str, pac: np.ndarray, l_pac: int) -> None:
    with open(path, "wb") as fh:
        np.asarray(pac, dtype=np.uint8).tofile(fh)
        if l_pac % 4 == 0:
            fh.write(b"\x00")
        fh.write(bytes([l_pac % 4]))


def read_pac(path: str, l_pac: int) -> np.ndarray:
    try:
        raw = np.fromfile(path, dtype=np.uint8)
    except OSError as exc:
        raise CouldNotReadIndexException(path, str(exc)) from exc
    n_bytes = (l_pac + 3) >> 2
    if len(raw) < n_bytes:
        raise InvalidFileFormatException(path, "truncated .pac")
    return raw[:n_bytes].copy()


def write_ann(path: str, bns: Bntseq) -> None:
    with open(path, "w") as fh:
        fh.write(f"{bns.l_pac} {bns.n_seqs} {bns.seed}\n")
        for a in bns.anns:
            anno = a.anno if a.anno else "(null)"
            fh.write(f"{a.gi} {a.name} {anno}\n")
            fh.write(f"{a.offset} {a.length} {a.n_ambs}\n")


def read_ann(path: str) -> Bntseq:
    try:
        with open(path) as fh:
            lines = fh.read().splitlines()
    except OSError as exc:
        raise CouldNotReadIndexException(path, str(exc)) from exc
    try:
        l_pac, n_seqs, seed = (int(x) for x in lines[0].split())
        bns = Bntseq(l_pac=l_pac, seed=seed)
        for i in range(n_seqs):
            hdr = lines[1 + 2 * i].split(None, 2)
            gi = int(hdr[0])
            name = hdr[1]
            anno = hdr[2] if len(hdr) > 2 else ""
            if anno == "(null)":
                anno = ""
            offset, length, n_ambs = (int(x) for x in lines[2 + 2 * i].split())
            bns.anns.append(
                BntAnn(offset=offset, name=name, anno=anno, length=length, n_ambs=n_ambs, gi=gi)
            )
    except (IndexError, ValueError) as exc:
        raise InvalidFileFormatException(path, f"bad .ann: {exc}") from exc
    return bns


def write_amb(path: str, bns: Bntseq) -> None:
    with open(path, "w") as fh:
        fh.write(f"{bns.l_pac} {bns.n_seqs} {len(bns.ambs)}\n")
        for h in bns.ambs:
            fh.write(f"{h.offset} {h.length} {h.amb}\n")


def read_amb_into(path: str, bns: Bntseq) -> None:
    try:
        with open(path) as fh:
            lines = fh.read().splitlines()
    except OSError as exc:
        raise CouldNotReadIndexException(path, str(exc)) from exc
    try:
        l_pac, n_seqs, n_holes = (int(x) for x in lines[0].split())
        if l_pac != bns.l_pac or n_seqs != bns.n_seqs:
            raise InvalidFileFormatException(path, ".amb/.ann mismatch")
        for i in range(n_holes):
            parts = lines[1 + i].split()
            bns.ambs.append(BntAmb(int(parts[0]), int(parts[1]), parts[2]))
    except (IndexError, ValueError) as exc:
        raise InvalidFileFormatException(path, f"bad .amb: {exc}") from exc


def read_alt_into(path: str, bns: Bntseq) -> None:
    """Parse ``{prefix}.alt`` and set ``is_alt`` on matching contigs.

    Mirrors [EXT] bntseq.c bns_restore's .alt handling: the file is SAM-ish
    text; the first tab-delimited token of each non-'@' line names an ALT
    contig.  Unknown names are ignored (same as the reference engine).
    """
    by_name = {a.name: a for a in bns.anns}
    try:
        with open(path) as fh:
            lines = fh.read().splitlines()
    except OSError as exc:
        raise CouldNotReadIndexException(path, str(exc)) from exc
    for line in lines:
        if not line or line.startswith("@"):
            continue
        name = line.split("\t", 1)[0]  # token up to tab/eol, like bns_restore
        a = by_name.get(name)
        if a is not None:
            a.is_alt = 1


def write_alt(path: str, bns: Bntseq) -> None:
    """Write a minimal ``.alt`` file naming the ALT contigs (round-trip aid;
    stock bwa ships this file with the reference rather than generating it)."""
    with open(path, "w") as fh:
        for a in bns.anns:
            if a.is_alt:
                fh.write(f"{a.name}\t4\t*\t0\t0\t*\t*\t0\t0\n")


def write_index_files(prefix: str, idx: BwaIndex) -> None:
    """Write the full bwa-format index file set at ``prefix``."""
    write_bwt(prefix + ".bwt", idx.bwt)
    write_sa(prefix + ".sa", idx.bwt)
    write_pac(prefix + ".pac", idx.pac, idx.bns.l_pac)
    write_ann(prefix + ".ann", idx.bns)
    write_amb(prefix + ".amb", idx.bns)
    if any(a.is_alt for a in idx.bns.anns):
        write_alt(prefix + ".alt", idx.bns)


def read_index_files(prefix: str) -> BwaIndex:
    """Load a prebuilt bwa-format index (the createIndexImageFromIndexFiles path)."""
    for ext in (".amb", ".ann", ".bwt", ".pac", ".sa"):
        p = prefix + ext
        if not (os.path.isfile(p) and os.path.getsize(p) > 0):
            raise CouldNotReadIndexException(p, "missing or empty index file")
    bns = read_ann(prefix + ".ann")
    read_amb_into(prefix + ".amb", bns)
    if os.path.isfile(prefix + ".alt"):
        read_alt_into(prefix + ".alt", bns)  # ALT-aware mapping (bns_restore)
    bwt = read_bwt(prefix + ".bwt", prefix + ".sa")
    pac = read_pac(prefix + ".pac", bns.l_pac)
    return BwaIndex(bns=bns, pac=pac, bwt=bwt)
