"""Device seeding for the port's pipeline: one entry point for the stage sets
("seed",) and ("seed", "sa_lookup").

The counterpart of bwamem_tpu/engine/seed_device.py
``collect_intv_batch_device`` and ``collect_intv_rbegs_batch_device``.  The
batch is padded once to [B, Lmax] uint8 codes (4 past each read's end; no
bucketing: nothing recompiles), uploaded, seeded by ``ops.seed.seed_sa``
(on the card: the collect_intv and sample_ks kernels).  The flat table and
the SA rows stay on the device, for the walks and the chaining; the table is
copied back when its ``rows`` are asked for.

A read that overflows the K- or M-slot budget is seeded on the host, as the
JAX package does: the host C++ ``native_fm.collect_intv_batch_raw`` on just
those reads when the natives are built, else the lockstep oracle
``engine.seed_batch.collect_intv_batch``; its rows are spliced in read order.  That is
the budget rule, not a device fallback: a failed build, launch or kernel
flag raises.  M is the JAX package's (48 intervals per read); K is raised
from its 24 slots per smem1a call to ``ops.seed.K_MAX`` (160), which no
read of up to 160 bases can overflow: on repeat-rich genomes 24 slots flag
several per cent of 150 bp reads.  ``SEED_STATS.ref_k_overflows`` counts
the reads that needed more than 24, the ones the JAX package seeds on the
host.  The flat table and the SA rows are sized exactly, so the JAX
package's whole-batch demotions (``R_cap``/``F_cap``) cannot happen.
``SEED_STATS`` counts the reads seeded on the device and on the host, the
kernel launches and, as the collect_intv kernel (or on the CPU its plain
version) counts them, the smem1a, strategy1 and bwt_extend calls, the
flagged reads by budget and the reads past the JAX package's K.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import List

import numpy as np
import torch

from ..ops import fmindex as fmops
from ..ops import seed as seedops
from ..utils import metrics as _metrics
from ..utils.cudabuild import tally
from . import native_fm
from .seed_batch import collect_intv_batch
from .state import device_fm


class SeedStats:
    """Reads seeded on the device, reads seeded on the host because they
    overflowed a budget, the seeding kernels launched, and the seeding
    calls the collect_intv kernel (or its plain version on the CPU) made,
    the reads it flagged by budget (K slots of an smem1a call, M
    accumulator slots) and the reads that needed more than the JAX
    package's K_SLOTS."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.device_reads = 0
        self.host_reads = 0
        self.launches = 0
        self.smem1a_calls = 0
        self.strategy1_calls = 0
        self.extend_calls = 0
        self.k_overflows = 0
        self.m_overflows = 0
        self.ref_k_overflows = 0


SEED_STATS = SeedStats()


@dataclass
class DeviceSeeds:
    """A batch's intervals: ``rows_dev`` [Nd, 5] int64 (x0, x1, s, qb, qe),
    the device-seeded reads' rows in read order, on the device with their SA
    rows ``ks``; ``n_intv`` [n] int64, every read's row count; ``on_host``
    [n] bool (seeded on the host) and ``host_rows`` [Nh, 5], those reads'
    rows in read order.  ``rows`` is the whole table on the host.  ``qseq``
    [n, Lmax] uint8 and ``qlen`` [n] int32 are the padded reads as seeding
    put them on the device."""

    rows_dev: torch.Tensor
    n_intv: np.ndarray
    on_host: np.ndarray
    host_rows: np.ndarray
    ks: torch.Tensor
    dfm: fmops.DeviceFMIndex
    qseq: torch.Tensor
    qlen: torch.Tensor

    @cached_property
    def rows(self) -> np.ndarray:
        """[N, 5] int64, every read's rows in read order (one copy back)."""
        flat = self.rows_dev.cpu().numpy()
        if not self.on_host.any():
            return flat
        from_host = np.repeat(self.on_host, self.n_intv)
        rows = np.empty((len(from_host), 5), dtype=np.int64)
        rows[~from_host] = flat
        rows[from_host] = self.host_rows
        return rows


def host_rows(opt, fm, reads: List[np.ndarray]):
    """Three-round seeding on the host, the C++ when it is built, else the
    lockstep oracle: (rows [N, 5] int64, n [len] int64)."""
    if native_fm.available():
        rows, n = native_fm.collect_intv_batch_raw(opt, fm, reads)
        return rows, np.asarray(n, dtype=np.int64)
    ivs = collect_intv_batch(opt, fm, reads)
    rows = np.asarray([tuple(p) for iv in ivs for p in iv],
                      dtype=np.int64).reshape(-1, 5)
    return rows, np.asarray([len(iv) for iv in ivs], dtype=np.int64)


def seed_batch(opt, fm, reads: List[np.ndarray], device,
               K: int = seedops.K_MAX) -> DeviceSeeds:
    """mem_collect_intv for every read of the batch on ``device`` with K
    slots per smem1a call; reads flagged by a budget are seeded on the
    host."""
    dfm = device_fm(fm, device)
    if not reads:
        none = np.zeros(0, dtype=np.int64)
        return DeviceSeeds(dfm.sa[:0].reshape(0, 5), none, none.astype(bool),
                           np.zeros((0, 5), dtype=np.int64), dfm.sa[:0], dfm,
                           *seedops.pad_reads([], dfm.device))
    qseq, qlen = seedops.pad_reads(reads, dfm.device)
    _metrics.count("device_seed_fused_batches")
    before = tally()["seed"]
    work = torch.zeros((len(reads), 5), dtype=torch.int32, device=dfm.device)
    out = seedops.seed_sa(dfm, qseq, qlen, seedops.SeedParams.from_opt(opt),
                          K=K, work=work)
    iv = out.intervals
    cause, peak = work[:, 3], work[:, 4]
    counts = torch.cat([work[:, :3].sum(dim=0, dtype=torch.int64), torch.stack(
        [(cause == 1).sum(), (cause == 2).sum(), (peak > seedops.K_SLOTS).sum()])])
    B = len(reads)
    meta = torch.cat([iv.n.long(), iv.ovf.long(), counts]).cpu().numpy()
    n_dev, on_host, calls = meta[:B], meta[B: 2 * B] != 0, meta[2 * B:].tolist()
    SEED_STATS.launches += tally()["seed"] - before
    SEED_STATS.smem1a_calls += calls[0]
    SEED_STATS.strategy1_calls += calls[1]
    SEED_STATS.extend_calls += calls[2]
    SEED_STATS.k_overflows += calls[3]
    SEED_STATS.m_overflows += calls[4]
    SEED_STATS.ref_k_overflows += calls[5]
    n_intv = np.where(on_host, 0, n_dev).astype(np.int64)
    rows_fb = np.zeros((0, 5), dtype=np.int64)
    fb = np.flatnonzero(on_host)
    if fb.size:
        _metrics.count("device_seed_fused_fallbacks", int(fb.size))
        rows_fb, n_intv[fb] = host_rows(opt, fm, [reads[i] for i in fb])
    SEED_STATS.device_reads += len(reads) - fb.size
    SEED_STATS.host_reads += fb.size
    return DeviceSeeds(out.flat, n_intv, on_host, rows_fb, out.ks, dfm, qseq,
                       qlen)
