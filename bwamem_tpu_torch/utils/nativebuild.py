"""Shared g++ invocation for the first-use native builds.

All native wrappers (engine/native_*.py, index/native_sais.py) compile their
C++ at first use into ``<package>/build/`` (``lib_path``) when no prebuilt
library is present (the BWAMEM_TPU_NATIVE_DIR path skips this).  Centralised
here so every hot kernel gets the same flag set: ``-march=native`` buys ~20% on the memory/SIMD-bound
kernels (measured on SA-IS induce loops) and falls back to the portable flag
set on toolchains/targets that reject it.

Because ``-march=native`` bakes the build host's ISA into the ``.so``, every
build records a host tag in a ``<lib>.hosttag`` sidecar; ``stale()`` treats a
tag mismatch (library copied from a different machine) as a rebuild trigger,
so a foreign-ISA cache never SIGILLs at runtime.
"""
from __future__ import annotations

import hashlib
import os
import platform
import subprocess

_BASE = ["g++", "-O3", "-std=c++20", "-shared", "-fPIC", "-fopenmp"]
_TUNED = ["-march=native", "-mtune=native"]

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")

_host_tag_cache: str | None = None


def lib_path(name: str) -> str:
    """Where the library ``name`` is loaded from: BWAMEM_TPU_NATIVE_DIR
    (prebuilt natives, never compiled; the LIBBWA_PATH analog,
    BwaMemIndex.java:438-441) or the package's build directory."""
    return os.path.join(os.environ.get("BWAMEM_TPU_NATIVE_DIR") or BUILD_DIR,
                        name)


def host_tag() -> str:
    """Stable fingerprint of this host's ISA feature set.

    Hash of the cpuinfo ``flags`` line (x86) / ``Features`` (arm) plus the
    machine arch — exactly what ``-march=native`` specialises on.
    """
    global _host_tag_cache
    if _host_tag_cache is not None:
        return _host_tag_cache
    feat = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feat = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    raw = f"{platform.machine()}|{feat}"
    _host_tag_cache = hashlib.sha256(raw.encode()).hexdigest()[:16]
    return _host_tag_cache


def stale(lib: str, sources: list[str]) -> bool:
    """True if `lib` must be (re)built from `sources`.

    Triggers: library missing, any source newer than the library, or the
    ``.hosttag`` sidecar absent/mismatched (library built on another ISA).
    """
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(s) for s in sources)
    if os.path.getmtime(lib) < newest:
        return True
    try:
        with open(lib + ".hosttag") as f:
            return f.read().strip() != host_tag()
    except OSError:
        return True


def compile_shared(sources: list[str], out: str) -> None:
    """g++-compile sources into the shared library at `out`.

    Tries the host-tuned flag set first; retries portable flags on failure.
    Raises CalledProcessError only if both fail.  The library is written
    beside `out` and renamed into place, so a process that builds at the
    same time never loads half a file.  Writes the host-tag sidecar on
    success (see `stale`).
    """
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            _BASE + _TUNED + ["-o", tmp, *sources],
            check=True,
            capture_output=True,
        )
    except (OSError, subprocess.CalledProcessError):
        subprocess.run(
            _BASE + ["-o", tmp, *sources],
            check=True,
            capture_output=True,
        )
    os.replace(tmp, out)
    try:
        with open(out + ".hosttag", "w") as f:
            f.write(host_tag())
    except OSError:
        pass  # sidecar is advisory; next import just rebuilds
