"""Builds the port's CUDA sources with ``nvcc`` into a plain-C shared library.

The kernels under ``csrc/`` expose ``extern "C"`` launchers that take device
pointers and a stream, so they need no PyTorch headers: one ``nvcc`` call per
source compiles in seconds, where an extension that includes
``torch/extension.h`` takes minutes.  The library is loaded with ``ctypes``.

Each library lands in ``<package>/build/`` under a name that carries a hash
of its source, the headers under ``csrc/``, the compiler flags and the
``nvcc`` version, so an edited
source is rebuilt and an unchanged one is loaded as it is.  Nothing here
runs at import time: ``import bwamem_tpu_torch`` works on a CPU-only PyTorch
without a CUDA toolkit, and the first launch of a kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
# per source: {"seconds": build time (0.0 when loaded from the cache),
# "log": nvcc's output (registers, shared memory, spills per kernel)}
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    """The CUDA toolkit's ``nvcc``, found the way torch.utils.cpp_extension
    finds it (``CUDA_HOME``/``CUDA_PATH``, ``PATH``, the default install)."""
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: str, nvcc: str) -> str:
    ver = subprocess.run([nvcc, "--version"], check=True, capture_output=True,
                         text=True).stdout
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS + FLAGS).encode())
    h.update(ver.encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists;
    returns the library's path.  Raises if ``nvcc`` fails."""
    src = os.path.join(CSRC, f"{name}.cu")
    nvcc = nvcc_path()
    lib = _lib_path(src, nvcc)
    if os.path.exists(lib):
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    res = subprocess.run(
        [nvcc, *ARCH_FLAGS, *FLAGS, "-o", tmp, src],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    BUILD_INFO[name] = {
        "seconds": time.perf_counter() - t0,
        "log": (res.stdout + res.stderr).strip(),
    }
    return lib


def load(name: str, bind) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``bind(lib)`` sets the
    ``argtypes``/``restype`` of its entry points.  Cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            bind(lib)
            _libs[name] = lib
        return lib
