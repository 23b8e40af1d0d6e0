"""BwaMemIndex: owns an opened reference index.

Lifecycle parity with the reference's BwaMemIndex.java: create an image from
a FASTA or prebuilt bwa index files, open it (mmap-backed), hand out contig
names, guard concurrent use with a ref-count, refuse close while aligners
are in flight (BwaMemIndex.java:84, 363-397).  Unlike the reference, no
failure path can abort the process — everything raises typed exceptions
(the Java docs warn about JVM death at :105-108, 201-204).
"""
from __future__ import annotations

import os
import threading
from enum import Enum
from typing import List

from ..engine.pipeline import Engine
from ..index import bwtfile, image
from ..index.build import build_index
from ..utils.fasta import read_fasta, sniff_fasta
from .exceptions import (
    CouldNotCreateIndexImageException,
    CouldNotReadImageException,
    InvalidInputException,
)

VERSION = "bwamem_tpu-0.1 (bwa-mem 0.7.x compatible)"

INDEX_FILE_EXTENSIONS = [".amb", ".ann", ".bwt", ".pac", ".sa"]


class Algorithm(Enum):
    """Index construction algorithm selector (BwaMemIndex.Algorithm, :46-80).

    AUTO picks by reference size like bwa; IS forces the in-RAM linear-time
    SA-IS constructor; RB2 — the reference's bounded-memory >2 GB axis
    (ropebwt2, BwaMemIndex.java:66-71) — routes to the memory-frugal
     40-bit packed-SA constructor (index/native/sais40.cpp), byte-identical
    output at a fraction of the peak RSS.
    """

    AUTO = "auto"
    IS = "is"
    RB2 = "rb2"


class BwaMemIndex:
    """An opened, queryable index. Thread-safe; aligners are not."""

    # ------------------------------------------------------ image creation

    @staticmethod
    def create_index_image_from_fasta_file(
        fasta_path: str, image_path: str, algorithm: Algorithm = Algorithm.AUTO
    ) -> None:
        """FASTA -> image (BwaMemIndex.createIndexImageFromFastaFile, :218-230)."""
        sniff_fasta(fasta_path)
        BwaMemIndex._assert_can_write(image_path)
        idx = build_index(read_fasta(fasta_path), algo=algorithm.value)
        image.write_image(image_path, idx)

    @staticmethod
    def create_index_image_from_index_files(prefix: str, image_path: str) -> None:
        """Prebuilt bwa index files -> image
        (BwaMemIndex.createIndexImageFromIndexFiles, :195-216)."""
        BwaMemIndex._assert_can_write(image_path)
        idx = bwtfile.read_index_files(prefix)
        image.write_image(image_path, idx)

    @staticmethod
    def create_bwa_image_file(prefix_or_image: str, image_path: str) -> None:
        """Export a reference-compatible ``bwa_idx2mem`` blob
        (jnibwa_createIndexFile's output format, jnibwa.c:126-152) from a
        bwa index file set or one of our images — so images produced here
        open in the reference JNI stack too."""
        from ..index import bwa_img

        BwaMemIndex._assert_can_write(image_path)
        if os.path.isfile(prefix_or_image + ".bwt"):
            idx = bwtfile.read_index_files(prefix_or_image)
        else:
            idx = image.read_image(prefix_or_image)
        bwa_img.write_bwa_image(image_path, idx)

    @staticmethod
    def index_reference(fasta_path: str, prefix: str,
                        algorithm: Algorithm = Algorithm.AUTO) -> None:
        """FASTA -> bwa-format index file set (the createReferenceIndex native
        step, org_..._BwaMemIndex.c:42-63)."""
        sniff_fasta(fasta_path)
        idx = build_index(read_fasta(fasta_path), algo=algorithm.value)
        bwtfile.write_index_files(prefix, idx)

    @staticmethod
    def _assert_can_write(path: str) -> None:
        """BwaMemIndex.assertCanCreateOrOverwriteImageFile (:232-249)."""
        d = os.path.dirname(os.path.abspath(path))
        if os.path.isdir(path):
            raise CouldNotCreateIndexImageException(path, "is a directory")
        if os.path.exists(path) and not os.access(path, os.W_OK):
            raise CouldNotCreateIndexImageException(path, "not writable")
        if not os.path.exists(path) and not os.access(d, os.W_OK):
            raise CouldNotCreateIndexImageException(path, "directory not writable")

    # ------------------------------------------------------------ lifecycle

    def __init__(self, image_path: str):
        if not (os.path.isfile(image_path) and os.path.getsize(image_path) > 0):
            raise CouldNotReadImageException(image_path, "missing or empty")
        self._image_path = image_path
        try:
            idx = image.read_image(image_path)
        except Exception:
            # not our flat-array image: try the reference's bwa_idx2mem
            # blob (the .img format every GATK deployment has on disk;
            # jnibwa.c:126-165)
            from ..index import bwa_img

            if not bwa_img.looks_like_bwa_image(image_path):
                raise
            idx = bwa_img.read_bwa_image(image_path)
        self._engine: Engine | None = Engine(idx)
        self._ref_count = 0
        self._lock = threading.Lock()

    @property
    def image_path(self) -> str:
        return self._image_path

    def is_open(self) -> bool:
        return self._engine is not None

    def ref_index(self) -> None:
        """Pin the index while aligning (BwaMemIndex.refIndex, :363-369)."""
        with self._lock:
            if self._engine is None:
                raise InvalidInputException(
                    "Index image has been closed"
                )
            self._ref_count += 1

    def de_ref_index(self) -> None:
        with self._lock:
            self._ref_count -= 1

    def close(self) -> None:
        """Refuses while aligners are mid-flight (BwaMemIndex.close, :382-397)."""
        with self._lock:
            if self._engine is None:
                return
            if self._ref_count != 0:
                raise RuntimeError(
                    "Can't close index: it's in use by an aligner"
                )
            self._engine = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- queries

    def get_reference_contig_names(self) -> List[str]:
        """Contig names in index order (BwaMemIndex.getReferenceContigNames)."""
        return [a.name for a in self._require().idx.bns.anns]

    @property
    def contig_names(self) -> List[str]:
        return self.get_reference_contig_names()

    @staticmethod
    def get_bwa_version() -> str:
        """Engine version string (BwaMemIndex.getBWAVersion, :405-408)."""
        return VERSION

    def _require(self) -> Engine:
        eng = self._engine
        if eng is None:
            raise RuntimeError("Index image has been closed")
        return eng

    # Java-style aliases
    createIndexImageFromFastaFile = create_index_image_from_fasta_file
    createIndexImageFromIndexFiles = create_index_image_from_index_files
    getReferenceContigNames = get_reference_contig_names
    getBWAVersion = get_bwa_version
    isOpen = is_open
    refIndex = ref_index
    deRefIndex = de_ref_index
