"""Typed exception hierarchy.

Parity surface with the reference's seven exception classes
(src/main/java/.../utils/bwa/{CouldNotCreateIndexException,
CouldNotCreateIndexImageException, CouldNotReadImageException,
CouldNotReadIndexException, CouldNotReadReferenceException,
InvalidFileFormatException, InvalidInputException}.java).

Deliberate improvement over the reference: *every* failure surfaces as a
typed Python exception — there is no code path that can kill the process the
way the reference's native engine can (warned about in
BwaMemIndex.java:105-108, 201-204).
"""
from __future__ import annotations


class BwaMemException(RuntimeError):
    """Base class for all bwamem_tpu errors."""


class InvalidInputException(BwaMemException):
    """Bad input provided by the caller (InvalidInputException.java)."""


class InvalidFileFormatException(InvalidInputException):
    """A file exists but has the wrong format (InvalidFileFormatException.java)."""

    def __init__(self, path: str, why: str):
        super().__init__(f"{path}: {why}")
        self.path = path
        self.why = why


class CouldNotReadReferenceException(BwaMemException):
    """Reference FASTA unreadable (CouldNotReadReferenceException.java)."""

    def __init__(self, path: str, why: str = ""):
        super().__init__(f"could not read reference {path}: {why}")
        self.path = path


class CouldNotCreateIndexException(BwaMemException):
    """Index construction failed (CouldNotCreateIndexException.java)."""


class CouldNotCreateIndexImageException(BwaMemException):
    """Index image file could not be written (CouldNotCreateIndexImageException.java)."""

    def __init__(self, path: str, why: str = ""):
        super().__init__(f"could not create index image {path}: {why}")
        self.path = path


class CouldNotReadImageException(BwaMemException):
    """Index image file unreadable/corrupt (CouldNotReadImageException.java)."""

    def __init__(self, path: str, why: str = ""):
        super().__init__(f"could not read index image {path}: {why}")
        self.path = path


class CouldNotReadIndexException(BwaMemException):
    """Prebuilt index files unreadable (CouldNotReadIndexException.java)."""

    def __init__(self, path: str, why: str = ""):
        super().__init__(f"could not read index {path}: {why}")
        self.path = path
