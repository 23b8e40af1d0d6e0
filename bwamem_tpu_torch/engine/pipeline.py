"""Batched mem_align1_core for the port: host seeding, SA walks and chaining
from bwamem_tpu, extension waves on the port's device.

The counterpart of bwamem_tpu/engine/pipeline.py ``_align_regs_batch_native``
with the fused host chain+extend core always off, so every extension goes
through the cross-read waves of ``extend_batch.chain2aln_batch``.  Without
the native libraries the seeding and chaining fall back to the Python
oracles, as the reference's ``align_regs_batch`` does.
"""
from __future__ import annotations

from typing import List

import numpy as np

from bwamem_tpu.engine import native_chain, native_fm
from bwamem_tpu.engine.chain import (
    chain_flt, flt_chained_seeds, mem_chain, sample_ks,
)
from bwamem_tpu.engine.extend import AlnReg
from bwamem_tpu.engine.finalize import sort_dedup_patch
from bwamem_tpu.engine.pipeline import _flag_alt_regs, native_seed_sa
from bwamem_tpu.engine.seed_batch import collect_intv_batch
from bwamem_tpu.utils.timers import TIMERS

from .exec_ctx import ExecConfig
from .extend_batch import chain2aln_batch


def _chains_native(opt, eng, reads):
    rows, intv_off, n_intv, rbegs, rbeg_off, cnt = native_seed_sa(
        opt, eng, reads, TIMERS
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


def _chains_python(opt, eng, reads):
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
        flat_rbegs = eng.fm.sa_lookup(np.asarray(flat_ks, dtype=np.int64))
    with TIMERS.stage("chain"):
        chains_list = []
        for intervals, read_spans, query in zip(intervals_list, spans, reads):
            rbegs = [flat_rbegs[off: off + ln] for off, ln in read_spans]
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
        chains_list = _chains_native(opt, eng, reads)
    else:
        chains_list = _chains_python(opt, eng, reads)
    with TIMERS.stage("extend"):
        regs_list = chain2aln_batch(opt, eng.idx, reads, chains_list, exec_cfg)
    with TIMERS.stage("dedup"):
        return [
            _flag_alt_regs(eng.idx.bns, sort_dedup_patch(opt, eng.idx, q, regs))
            for q, regs in zip(reads, regs_list)
        ]
