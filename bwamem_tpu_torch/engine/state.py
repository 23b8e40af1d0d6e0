"""Carries the JAX package's host state over to the port's device.

For now that is the extension's scoring: ``MemOptions`` holds the 5x5
matrix as a flat list and the gap penalties as ints.  The FM index tables
join this module when seeding moves to the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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
