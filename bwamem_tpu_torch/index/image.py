"""Index image: one flat, mmap-able file holding the whole index.

TPU-native analog of the reference's .img format — there, the entire
bwaidx_t is flattened by [EXT] bwa_idx2mem, written in <=1 GiB chunks
(jnibwa.c:126-152) and later restored zero-copy from a single read-only mmap
(jnibwa.c:154-165) so the OS page cache shares it across processes.  We keep
those properties: sections are 64-byte aligned raw arrays loaded via
np.memmap (no deserialization of the bulk data), with a small JSON metadata
block for contig names/holes.

Layout (little-endian):
  [0:8)    magic  b"BWATPU01"
  [8:4096) header JSON (padded with NULs): l_pac, seq_len, primary, sa_intv,
           L2, seed, section offsets/lengths, ann/amb metadata
  sections: bwt (uint32 interleaved), sa (uint64), pac (uint8)
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..api.exceptions import CouldNotCreateIndexImageException, CouldNotReadImageException
from .build import Bntseq, BntAnn, BntAmb, BwaIndex, BwtIndex

MAGIC = b"BWATPU01"
HEADER_SIZE = 4096
ALIGN = 64
WRITE_CHUNK = 1 << 30  # parity with the reference's <=1 GiB write chunks


def _align(n: int) -> int:
    return (n + ALIGN - 1) & ~(ALIGN - 1)


def write_image(path: str, idx: BwaIndex) -> None:
    # zero-copy byte views (ascontiguousarray is a no-op for the constructors'
    # native-endian arrays): a genome-scale image is ~5 GB of sections, and
    # every avoided copy also avoids a fresh first-touch pass
    bwt_arr = np.ascontiguousarray(idx.bwt.bwt, dtype="<u4")
    sa_arr = np.ascontiguousarray(idx.bwt.sa, dtype="<i8")
    pac_arr = np.ascontiguousarray(np.asarray(idx.pac), dtype=np.uint8)
    bwt_bytes = memoryview(bwt_arr).cast("B")
    sa_bytes = memoryview(sa_arr).cast("B")
    pac_bytes = memoryview(pac_arr).cast("B")
    off = HEADER_SIZE
    sections = {}
    for name, blob in (("bwt", bwt_bytes), ("sa", sa_bytes), ("pac", pac_bytes)):
        off = _align(off)
        sections[name] = {"offset": off, "length": len(blob)}
        off += len(blob)
    header = {
        "version": 1,
        "l_pac": idx.bns.l_pac,
        "seq_len": idx.bwt.seq_len,
        "primary": idx.bwt.primary,
        "sa_intv": idx.bwt.sa_intv,
        "L2": [int(x) for x in idx.bwt.L2],
        "seed": idx.bns.seed,
        "sections": sections,
        "anns": [
            {
                "name": a.name,
                "anno": a.anno,
                "offset": a.offset,
                "length": a.length,
                "n_ambs": a.n_ambs,
                "gi": a.gi,
                "is_alt": a.is_alt,
            }
            for a in idx.bns.anns
        ],
        "ambs": [
            {"offset": h.offset, "length": h.length, "amb": h.amb}
            for h in idx.bns.ambs
        ],
    }
    hdr_json = json.dumps(header).encode()
    meta_bytes = b""
    if len(hdr_json) > HEADER_SIZE - len(MAGIC):
        # large contig/hole counts (many-contig FASTAs, gigabase genomes
        # with hundreds of N gaps): spill anns/ambs into their own section
        # and re-point the header at it (version 2).  Small indexes keep
        # the v1 single-block header byte-for-byte.
        meta_bytes = json.dumps(
            {"anns": header.pop("anns"), "ambs": header.pop("ambs")}
        ).encode()
        header["version"] = 2
        off = _align(off)
        sections["meta"] = {"offset": off, "length": len(meta_bytes)}
        off += len(meta_bytes)
        hdr_json = json.dumps(header).encode()
        if len(hdr_json) > HEADER_SIZE - len(MAGIC):
            raise CouldNotCreateIndexImageException(
                path, f"header too large ({len(hdr_json)} bytes)"
            )
    blobs = {"bwt": bwt_bytes, "sa": sa_bytes, "pac": pac_bytes, "meta": meta_bytes}
    try:
        with open(path, "wb") as fh:
            fh.write(MAGIC)
            fh.write(hdr_json.ljust(HEADER_SIZE - len(MAGIC), b"\x00"))
            pos = HEADER_SIZE
            for name in ("bwt", "sa", "pac", "meta"):
                if name not in sections:
                    continue
                sec = sections[name]
                fh.write(b"\x00" * (sec["offset"] - pos))
                blob = blobs[name]
                for i in range(0, len(blob), WRITE_CHUNK):
                    fh.write(blob[i : i + WRITE_CHUNK])
                pos = sec["offset"] + sec["length"]
    except OSError as exc:
        raise CouldNotCreateIndexImageException(path, str(exc)) from exc


def read_image(path: str) -> BwaIndex:
    """Open an image with zero-copy mmap of the bulk arrays."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as fh:
            head = fh.read(HEADER_SIZE)
    except OSError as exc:
        raise CouldNotReadImageException(path, str(exc)) from exc
    if len(head) < HEADER_SIZE or head[: len(MAGIC)] != MAGIC:
        raise CouldNotReadImageException(path, "bad magic (not a bwamem_tpu image)")
    try:
        hdr = json.loads(head[len(MAGIC) :].rstrip(b"\x00").decode())
    except (ValueError, UnicodeDecodeError) as exc:
        raise CouldNotReadImageException(path, f"corrupt header: {exc}") from exc
    sec = hdr["sections"]
    for s in sec.values():
        if s["offset"] + s["length"] > size:
            raise CouldNotReadImageException(path, "truncated image")
    if "meta" in sec:  # v2: anns/ambs spilled out of the header block
        try:
            with open(path, "rb") as fh:
                fh.seek(sec["meta"]["offset"])
                meta = json.loads(fh.read(sec["meta"]["length"]).decode())
        except (OSError, ValueError, UnicodeDecodeError) as exc:
            raise CouldNotReadImageException(
                path, f"corrupt metadata section: {exc}"
            ) from exc
        hdr["anns"] = meta["anns"]
        hdr["ambs"] = meta["ambs"]
    bwt_arr = np.memmap(
        path, dtype="<u4", mode="r", offset=sec["bwt"]["offset"],
        shape=(sec["bwt"]["length"] // 4,),
    )
    sa_arr = np.memmap(
        path, dtype="<i8", mode="r", offset=sec["sa"]["offset"],
        shape=(sec["sa"]["length"] // 8,),
    )
    pac_arr = np.memmap(
        path, dtype=np.uint8, mode="r", offset=sec["pac"]["offset"],
        shape=(sec["pac"]["length"],),
    )
    bns = Bntseq(l_pac=hdr["l_pac"], seed=hdr["seed"])
    for a in hdr["anns"]:
        bns.anns.append(
            BntAnn(
                offset=a["offset"], name=a["name"], anno=a["anno"],
                length=a["length"], n_ambs=a["n_ambs"], gi=a["gi"],
                is_alt=a["is_alt"],
            )
        )
    for h in hdr["ambs"]:
        bns.ambs.append(BntAmb(h["offset"], h["length"], h["amb"]))
    bwt = BwtIndex(
        primary=hdr["primary"],
        L2=np.asarray(hdr["L2"], dtype=np.int64),
        seq_len=hdr["seq_len"],
        bwt=bwt_arr,
        sa_intv=hdr["sa_intv"],
        sa=sa_arr,
    )
    return BwaIndex(bns=bns, pac=pac_arr, bwt=bwt)
