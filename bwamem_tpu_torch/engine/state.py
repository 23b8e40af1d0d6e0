"""Carries the JAX package's host state over to the port's device.

Four pieces: the extension's scoring (``MemOptions`` holds the 5x5 matrix
as a flat list and the gap penalties as ints), the FM index tables
(``device_fm``), built once per device and kept on the host ``FMIndex``
object, as bwamem_tpu/engine/seed_device.py ``_get_dfm`` keeps the JAX
package's, the contig tables (``device_contigs``), kept on the host
``Bntseq`` object, and the 2-bit reference (``device_ref``), kept on the host
``BwaIndex`` object (the JAX package keys its caches of the last two by
``id()``, which a new index can inherit).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.chain import DeviceContigs
from ..ops.fmindex import DeviceFMIndex

_lock = threading.Lock()


@dataclass(frozen=True)
class DeviceScoring:
    """The extension's scoring on one device: ``mat`` [5, 5] int32 plus the
    statics the kernel takes as arguments."""

    mat: torch.Tensor
    o_del: int
    e_del: int
    o_ins: int
    e_ins: int
    zdrop: int
    max_sc: int


def device_scoring(opt, device) -> DeviceScoring:
    """``opt`` (a ``MemOptions``) -> its scoring on ``device``.  The matrix
    is read through numpy, so tests hand both packages the same values."""
    mat = np.asarray(opt.mat, dtype=np.int32).reshape(5, 5)
    return DeviceScoring(
        mat=torch.from_numpy(mat.copy()).to(device),
        o_del=int(opt.o_del), e_del=int(opt.e_del),
        o_ins=int(opt.o_ins), e_ins=int(opt.e_ins),
        zdrop=int(opt.zdrop), max_sc=int(mat.max()),
    )


@dataclass(frozen=True)
class DeviceRef:
    """The forward reference on one device as bwa packs it: ``pac`` uint8
    [ceil(l_pac / 4)], four bases a byte, the first in the high bits."""

    pac: torch.Tensor
    l_pac: int

    @classmethod
    def from_host(cls, idx, device) -> "DeviceRef":
        """``idx`` (an ``index.build.BwaIndex``) -> its pac on ``device``."""
        pac = np.ascontiguousarray(idx.pac, dtype=np.uint8)
        if not pac.flags.writeable:  # a memory-mapped image: torch wants its own
            pac = pac.copy()
        return cls(torch.from_numpy(pac).to(device), int(idx.bns.l_pac))


def _cached(host, attr: str, device, build):
    """``build(host, device)``, made once per device and kept on ``host``,
    so that it lives as long as the index object."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        cache = host.__dict__.setdefault(attr, {})
        val = cache.get(dev)
        if val is None:
            val = cache[dev] = build(host, dev)
    return val


def device_fm(fm, device) -> DeviceFMIndex:
    """``fm`` (an ``engine.fmindex.FMIndex``) -> its tables on ``device``."""
    return _cached(fm, "_torch_device_fms", device, DeviceFMIndex.from_host)


def device_contigs(bns, device) -> DeviceContigs:
    """``bns`` (an ``index.build.Bntseq``) -> its contig tables on
    ``device``."""
    return _cached(bns, "_torch_device_contigs", device, DeviceContigs.from_host)


def device_ref(idx, device) -> DeviceRef:
    """``idx`` (an ``index.build.BwaIndex``) -> its 2-bit pac on ``device``."""
    return _cached(idx, "_torch_device_refs", device, DeviceRef.from_host)
