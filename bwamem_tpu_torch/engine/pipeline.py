"""Batched mem_align1_core for the port: seeding on the host or the port's
device, sampled-SA walks on the host or the port's device, host chaining
from bwamem_tpu, extension waves on the port's device.

The counterpart of bwamem_tpu/engine/pipeline.py ``_align_regs_batch_native``
with the fused host chain+extend core always off, so every extension goes
through the cross-read waves of ``extend_batch.chain2aln_batch``.  Without
the native libraries the seeding and chaining fall back to the Python
oracles, as the reference's ``align_regs_batch`` does.  With
``exec_cfg.device_sa_lookup`` every SA walk of the batch runs in one call
of ``ops.fmindex.sa_lookup`` on ``exec_cfg.device`` (the JAX package's
``device_sa_lookup`` stage); there is no host fallback from it.  With
``exec_cfg.device_seed`` the three seeding rounds run in the port's device
stage (``engine.seed_device``); with both, the device-seeded reads' SA
rows go from the seeding kernels to the walk without leaving the device.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from bwamem_tpu.engine import native_chain, native_fm
from bwamem_tpu.engine.chain import (
    chain_flt, flt_chained_seeds, mem_chain, sample_ks,
)
from bwamem_tpu.engine.extend import AlnReg
from bwamem_tpu.engine.finalize import sort_dedup_patch
from bwamem_tpu.engine.pipeline import _flag_alt_regs
from bwamem_tpu.engine.seed import SmemIntv
from bwamem_tpu.engine.seed_batch import collect_intv_batch
from bwamem_tpu.utils.timers import TIMERS

from ..ops import fmindex as fmops
from .exec_ctx import ExecConfig
from .extend_batch import chain2aln_batch
from .seed_device import seed_batch
from .state import device_fm


class SaStats:
    """Sampled-SA rows resolved on the device and on the host, and the
    rows of the largest device call, a tensor on the device (so a
    benchmark can time the kernel on them)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.device_sa_rows = 0
        self.host_sa_rows = 0
        self.largest_rows = None


SA_STATS = SaStats()


def _device_walk(dfm, ks: torch.Tensor) -> np.ndarray:
    """Text positions of the SA rows ``ks`` on the index's device: one
    call of ``ops.fmindex.sa_lookup``."""
    out = fmops.sa_lookup(dfm, ks)
    SA_STATS.device_sa_rows += ks.numel()
    if (SA_STATS.largest_rows is None
            or ks.numel() > SA_STATS.largest_rows.numel()):
        SA_STATS.largest_rows = ks
    return out.cpu().numpy()


def _sa_rows(fm, ks: np.ndarray, exec_cfg: ExecConfig) -> np.ndarray:
    """Text positions of the SA rows ``ks`` (int64): one device call when
    the stage is on the device, else the host C++ walk (or the oracle)."""
    if exec_cfg.device_sa_lookup:
        dev = exec_cfg.device
        return _device_walk(device_fm(fm, dev), torch.from_numpy(ks).to(dev))
    SA_STATS.host_sa_rows += len(ks)
    if native_fm.available():
        return native_fm.sa_batch(fm, ks)
    return fm.sa_lookup(ks)


def _ks_counts(rows: np.ndarray, max_occ: int):
    """Per row of ``rows`` [N, 5], the count of bwa sample_ks's SA rows and
    the offset of its first."""
    cnt = np.minimum(rows[:, 2], max_occ).astype(np.int64)
    off = np.zeros(len(rows), dtype=np.int64)
    np.cumsum(cnt[:-1], out=off[1:])
    return cnt, off


def _sample_ks(rows: np.ndarray, max_occ: int) -> np.ndarray:
    """bwa sample_ks over every row of ``rows`` [N, 5], vectorized: the SA
    rows ks [R], row after row."""
    s, x0 = rows[:, 2], rows[:, 0]
    cnt, off = _ks_counts(rows, max_occ)
    step = np.where(s > max_occ, s // np.maximum(max_occ, 1), 1)
    within = np.arange(int(cnt.sum()), dtype=np.int64) - np.repeat(off, cnt)
    ks = np.repeat(x0, cnt) + np.repeat(step, cnt) * within
    return ks.astype(np.int64)


def _seed_sa(opt, eng, reads, exec_cfg: ExecConfig):
    """Three-round seeding, the vectorized ``sample_ks`` expansion and the
    SA walks; bwamem_tpu/engine/pipeline.py ``native_seed_sa`` and its
    device routing (:126-144).  Seeding is the host C++, or with
    ``exec_cfg.device_seed`` the port's device stage; with
    ``device_sa_lookup`` too, the device-seeded reads' SA rows are walked
    on the device straight from the seeding kernels' output, and those of
    reads seeded on the host (budget overflows) through ``_sa_rows``.
    Returns the arrays the native chainer takes: (intv rows [N, 5],
    intv_off, n_intv, rbegs, rbeg_off, cnt)."""
    seeds = None
    with TIMERS.stage("seed"):
        if exec_cfg.device_seed:
            seeds = seed_batch(opt, eng.fm, reads, exec_cfg.device)
            rows, n_intv = seeds.rows, seeds.n_intv
        else:
            rows, n_intv = native_fm.collect_intv_batch_raw(opt, eng.fm, reads)
    with TIMERS.stage("sa_lookup"):
        cnt, rbeg_off = _ks_counts(rows, opt.max_occ)
        if seeds is not None and exec_cfg.device_sa_lookup:
            # the card expanded the device-seeded reads' SA rows; the host
            # expands only those of the reads seeded on the host
            host_row = np.repeat(seeds.on_host, n_intv)
            on_card = np.repeat(~host_row, cnt)
            rbegs = np.empty(len(on_card), dtype=np.int64)
            rbegs[on_card] = _device_walk(seeds.dfm, seeds.ks)
            if not on_card.all():
                rbegs[~on_card] = _sa_rows(
                    eng.fm, _sample_ks(rows[host_row], opt.max_occ), exec_cfg)
        else:
            ks = _sample_ks(rows, opt.max_occ)
            rbegs = (_sa_rows(eng.fm, ks, exec_cfg) if len(ks)
                     else np.zeros(0, dtype=np.int64))
    intv_off = np.zeros(len(reads), dtype=np.int64)
    np.cumsum(n_intv[:-1], out=intv_off[1:])
    return rows, intv_off, n_intv, rbegs, rbeg_off, cnt


def _chains_native(opt, eng, reads, exec_cfg: ExecConfig):
    rows, intv_off, n_intv, rbegs, rbeg_off, cnt = _seed_sa(
        opt, eng, reads, exec_cfg
    )
    with TIMERS.stage("chain"):
        qlens = np.asarray([len(r) for r in reads], dtype=np.int32)
        chains_list = native_chain.chain_batch(
            opt, eng.idx.bns, qlens, rows, intv_off, n_intv, rbegs, rbeg_off,
            cnt,
        )
        for query, chains in zip(reads, chains_list):
            flt_chained_seeds(opt, eng.idx, len(query), query, chains)
    return chains_list


def _chains_python(opt, eng, reads, exec_cfg: ExecConfig):
    if exec_cfg.device_seed:
        rows, intv_off, n_intv, rbegs, rbeg_off, cnt = _seed_sa(
            opt, eng, reads, exec_cfg)
        rows_all = rows.tolist()
        intervals_list, rbegs_list = [], []
        for o, n in zip(intv_off.tolist(), n_intv.tolist()):
            intervals_list.append([SmemIntv(*r) for r in rows_all[o: o + n]])
            rbegs_list.append([rbegs[b: b + c] for b, c in zip(
                rbeg_off[o: o + n].tolist(), cnt[o: o + n].tolist())])
    else:
        with TIMERS.stage("seed"):
            intervals_list = collect_intv_batch(opt, eng.fm, reads)
        with TIMERS.stage("sa_lookup"):
            flat_ks, spans = [], []
            for intervals in intervals_list:
                read_spans = []
                for p in intervals:
                    ks = sample_ks(p, opt.max_occ)
                    read_spans.append((len(flat_ks), len(ks)))
                    flat_ks.extend(ks)
                spans.append(read_spans)
            flat_rbegs = (_sa_rows(eng.fm, np.asarray(flat_ks, dtype=np.int64),
                                   exec_cfg)
                          if flat_ks else np.zeros(0, dtype=np.int64))
        rbegs_list = [[flat_rbegs[off: off + ln] for off, ln in read_spans]
                      for read_spans in spans]
    with TIMERS.stage("chain"):
        chains_list = []
        for intervals, rbegs, query in zip(intervals_list, rbegs_list, reads):
            chains = mem_chain(opt, eng.fm, eng.idx.bns, len(query), intervals,
                               rbegs)
            chains = chain_flt(opt, chains)
            flt_chained_seeds(opt, eng.idx, len(query), query, chains)
            chains_list.append(chains)
    return chains_list


def align_regs_batch(opt, eng, reads: List[np.ndarray],
                     exec_cfg: ExecConfig) -> List[List[AlnReg]]:
    """Reads (codes 0-4) -> deduplicated alignment regions per read."""
    if native_fm.available() and native_chain.available():
        chains_list = _chains_native(opt, eng, reads, exec_cfg)
    else:
        chains_list = _chains_python(opt, eng, reads, exec_cfg)
    with TIMERS.stage("extend"):
        regs_list = chain2aln_batch(opt, eng.idx, reads, chains_list, exec_cfg)
    with TIMERS.stage("dedup"):
        return [
            _flag_alt_regs(eng.idx.bns, sort_dedup_patch(opt, eng.idx, q, regs))
            for q, regs in zip(reads, regs_list)
        ]
