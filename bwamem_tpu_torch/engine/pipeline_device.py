"""The fused device path: a batch goes from reads to alignment regions on
the port's device, and the host receives finished region rows.

The counterpart of bwamem_tpu/engine/pipeline_device.py ``regs_batch_fused``.
The JAX package runs one jitted program; here the same stages are the port's
kernels, launched one after another on tensors that never leave the device:
``engine.seed_device.seed_batch`` (seeding), ``ops.fmindex.sa_lookup`` (the
walks), ``ops.chain.chain`` (mem_chain + chain_flt) and
``ops.pipeline_fused.chain2aln`` (the mem_chain2aln loop, extension
included).  Then one copy back of the region rows, already in the host C++
core's column order (``engine.pipeline.regs_to_rows``), which the C++ tail
takes as they are.  No chain is rebuilt in Python, no ``AlnReg`` is built
and no extension wave passes through ``extend_batch`` for a read that stays
on this path.

Reads that leave it, by the reference's budget rule: reads seeded on the host
(flagged by the K or M budget), reads flagged by the C budget, and reads for
which mem_flt_chained_seeds would act (``fcs_noop`` false: about 700 bases
and longer at default options); and, by the port's own limit, reads longer
than the loop kernel runs (``ops.pipeline_fused.kernel_max_qlen``: about
3,200 bases on an H100, which only options such as a large
``min_chain_weight`` keep past the first rule).  They go, as one sub-batch,
through the
staged path (host chaining, ``flt_chained_seeds``, ``chain2aln_batch``) and
are spliced in read order.  That is not a device fallback: a failed build,
launch or kernel flag raises.  The JAX package's further budgets (S = 64
seeds, C = 64 chains, R = 16 regions a read, ``T_cap`` window bases) do not
exist here; ``FUSED_STATS.ref_*_overflows`` count the reads they would have
flagged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from ..api.options import MemOptions
from ..ops import chain as chainops
from ..ops import pipeline_fused as fusedops
from ..utils import metrics as _metrics
from ..utils.cudabuild import tally
from ..utils.timers import TIMERS
from . import exec_ctx
from .chain import (MEM_HSP_COEF, MEM_MINSC_COEF, MEM_SEEDSW_COEF,
                    flt_chained_seeds)
from .exec_ctx import ExecConfig
from .extend import AlnReg
from .extend_batch import chain2aln_batch
from .pipeline import (_device_table, _host_chains, by_reads, gather_reads,
                       regs_from_rows, regs_to_rows)
from .state import device_contigs, device_ref, device_scoring

# the JAX package's fused budgets (bwamem_tpu/engine/pipeline_device.py)
REF_S_SLOTS = 64
REF_C_SLOTS = 64
REF_R_SLOTS = 16
REF_L_BUCKETS = (64, 192, 512)


class FusedStats:
    """Reads that stayed on the fused path and reads that took the staged
    one, by cause (seeded on the host, flagged by C, ``fcs`` active, longer
    than the loop kernel runs; a read counts under its first cause in that
    order), the kernels launched, the
    tasks extended and pruned and the extension jobs run by the loop kernel,
    host-clock seconds by step (summed from the ``TIMERS`` spans:
    ``seed_sa`` is ``seed`` and ``sa_lookup``, then ``chain``,
    ``chain2aln``, ``decode``, ``staged``), the reads the JAX package's
    budgets would have flagged (S, then C, then R, then the window; each
    read once), the regions the extension returned (before dedup) and
    those of them on an ALT contig, on every route (fused and staged alike,
    and the host routes: counted by the C++ tail, ``engine.native_pipeline``,
    or by ``pipeline.align_regs_batch`` for the Python tail), the loop
    kernel's chains and its ``SPLIT_COUNTS`` (``ops.pipeline_fused``: the
    reads whose chains ran on many warps, those chains, the chains its
    commits decided otherwise than their own runs and the band cells of own
    extensions they discarded), and,
    only under ``exec_ctx.KEEP_LARGEST``, the largest batch's operands (so a
    benchmark can time the kernels on them)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.device_reads = 0
        self.host_reads = 0
        self.host_seeded = 0
        self.c_overflows = 0
        self.fcs_reads = 0
        self.long_reads = 0
        self.launches = 0
        self.tasks = 0
        self.pruned = 0
        self.jobs = 0
        self.ref_s_overflows = 0
        self.ref_c_overflows = 0
        self.ref_r_overflows = 0
        self.ref_t_overflows = 0
        self.regions = 0
        self.alt_regions = 0
        self.chains = 0
        self.split_reads = 0
        self.split_chains = 0
        self.split_reruns = 0
        self.split_wasted_cells = 0
        self.seconds = {"seed_sa": 0.0, "chain": 0.0, "chain2aln": 0.0,
                        "decode": 0.0, "staged": 0.0}
        self.largest_batch = None  # chain2aln's arguments


FUSED_STATS = FusedStats()


def fcs_noop(opt: MemOptions, qlen: int) -> bool:
    """True when mem_flt_chained_seeds does nothing for a read of ``qlen``
    bases (engine/chain.py ``flt_chained_seeds``'s early return)."""
    if opt.min_chain_weight:
        min_l = MEM_HSP_COEF * opt.min_chain_weight
    else:
        min_l = MEM_MINSC_COEF * math.log(qlen) if qlen > 0 else 1.0
    return min_l > MEM_SEEDSW_COEF * qlen


def ref_t_cap(opt: MemOptions, longest: int) -> int:
    """The JAX package's window budget for a batch whose longest read has
    ``longest`` bases (its ``_t_cap`` on the padded length)."""
    L = next((b for b in REF_L_BUCKETS if longest <= b),
             -(-longest // REF_L_BUCKETS[-1]) * REF_L_BUCKETS[-1])
    t = 2 * L + 2 * opt.max_gap(L) + 16
    return ((t + 127) // 128) * 128


# ``Regions.compact()``'s columns (rb, re, frac_rep bits, qb, qe, score,
# truesc, w, seedcov, seedlen0, rid) in ``regs_to_rows``'s order
ROW_ORDER = (0, 1, 3, 4, 10, 5, 6, 7, 8, 9, 2)


def _splice(rows, nregs, staged, staged_rows, staged_n):
    """The device's region rows with the reads ``staged`` replaced by their
    staged rows, read after read: (rows, n_reg)."""
    n = len(nregs)
    keep = np.ones(n, dtype=bool)
    keep[staged] = False
    dev_keep = np.repeat(keep, nregs)
    read_of = np.concatenate([np.repeat(np.arange(n), nregs)[dev_keep],
                              np.repeat(staged, staged_n)])
    order = np.argsort(read_of, kind="stable")
    n_reg = np.where(keep, nregs, 0)
    n_reg[staged] = staged_n
    return np.concatenate([rows[dev_keep], staged_rows])[order], n_reg


def _staged(opt, eng, reads, qlens, which, seeded_on_host, tab, host, host_tab,
            exec_cfg):
    """Regions of the reads ``which`` by the staged path: chained on the
    host from the device table's rows (gathered on the device first) or,
    for reads seeded on the host, from the host's table."""
    chains_of = {}
    card = which[~seeded_on_host[which]]
    with TIMERS.stage("chain"):
        if card.size:
            for i, chains in zip(card, _host_chains(
                    opt, eng, qlens[card], np.arange(card.size),
                    *gather_reads(tab, card))):
                chains_of[int(i)] = chains
        if host is not None and host.size:
            rows_h, off_h, n_h, *rest = host_tab
            for i, chains in zip(host, _host_chains(
                    opt, eng, qlens[host], np.arange(host.size), rows_h, off_h,
                    n_h, *rest)):
                chains_of[int(i)] = chains
    sub = [reads[i] for i in which]
    chains_list = [chains_of[int(i)] for i in which]
    with TIMERS.stage("flt"):
        for query, chains in zip(sub, chains_list):
            flt_chained_seeds(opt, eng.idx, len(query), query, chains)
    with TIMERS.stage("extend"):
        return chain2aln_batch(opt, eng.idx, sub, chains_list, exec_cfg)


def regs_batch_fused(opt: MemOptions, eng, reads: List[np.ndarray],
                     exec_cfg: ExecConfig) -> List[List[AlnReg]]:
    """Per read its regions before dedup, by the fused device path."""
    return regs_from_rows(*regs_rows_fused(opt, eng, reads, exec_cfg))


def regs_rows_fused(opt: MemOptions, eng, reads: List[np.ndarray],
                    exec_cfg: ExecConfig, longest: int = 0):
    """The regions before dedup of the batch by the fused device path, as
    (rows [Nr, 11] int64, n_reg [len] int64) in ``regs_to_rows``'s layout;
    the columns are put in that order on the device, before the one copy
    back.  With ``exec_cfg.mesh``, a sub-batch of reads a mesh device, each
    in its own thread (``pipeline.by_reads``), their rows concatenated;
    ``longest`` (the whole batch's longest read, when this is a shard of
    it) sets the JAX package's window budget that ``ref_t_overflows``
    counts against."""
    n = len(reads)
    if n == 0:
        return np.zeros((0, 11), dtype=np.int64), np.zeros(0, dtype=np.int64)
    if exec_cfg.mesh is not None:
        top = max(len(r) for r in reads)
        parts = by_reads(lambda sub, cfg: regs_rows_fused(opt, eng, sub, cfg,
                                                          top),
                         reads, exec_cfg)
        return (np.concatenate([r for r, _ in parts]),
                np.concatenate([k for _, k in parts]))
    st = FUSED_STATS
    dev = exec_cfg.device
    _metrics.count("device_fused_pipeline_batches")
    cfg = dataclasses.replace(exec_cfg, device_seed=True, device_sa_lookup=True,
                              device_chain=True)
    qlens = np.asarray([len(r) for r in reads], dtype=np.int32)
    tab, host, host_tab, seeds = _device_table(opt, eng, reads, qlens, cfg)
    st.seconds["seed_sa"] += TIMERS.take("seed") + TIMERS.take("sa_lookup")
    before = tally()["chain"] + tally()["chain2aln"]
    with TIMERS.stage("chain"):
        ctg = device_contigs(eng.idx.bns, dev)
        chains = chainops.chain(ctg, tab, chainops.ChainParams.from_opt(opt))
    st.seconds["chain"] += TIMERS.take("chain")
    with TIMERS.stage("chain2aln"):
        noop = {q: fcs_noop(opt, q) for q in set(qlens.tolist())}
        fcs_ok = np.asarray([noop[q] for q in qlens.tolist()], dtype=bool)
        fits = qlens <= fusedops.kernel_max_qlen(torch.tensor(opt.mat), dev)
        run = (torch.from_numpy(fcs_ok & fits & ~seeds.on_host).to(dev)
               & ~chains.ovf)
        args = (ctg, device_ref(eng.idx, dev), chains, seeds.qseq, seeds.qlen,
                run, fusedops.ExtendParams.from_opt(opt),
                device_scoring(opt, dev).mat,
                ref_t_cap(opt, max(int(qlens.max()), longest)))
        regs = fusedops.chain2aln(*args)
        rows = regs.compact()[:, list(ROW_ORDER)]
        flat = torch.cat([regs.split, regs.nregs.long(), chains.ovf.long(),
                          chains.seed_cnt, chains.nslots.long(),
                          regs.work[:, :4].t().reshape(-1), rows.reshape(-1)])
        with TIMERS.stage("copy_back"):
            flat = flat.cpu().numpy()
    st.seconds["chain2aln"] += TIMERS.take("chain2aln")
    with TIMERS.stage("decode"):
        st.launches += tally()["chain"] + tally()["chain2aln"] - before
        if exec_ctx.KEEP_LARGEST and (
                st.largest_batch is None
                or chains.seed_rows.shape[0]
                > st.largest_batch[2].seed_rows.shape[0]):
            st.largest_batch = args
        k = len(fusedops.SPLIT_COUNTS)
        split, flat = flat[:k], flat[k:]
        meta = flat[:8 * n].reshape(8, n)
        nregs, ovf, seed_cnt, nslots = meta[0], meta[1] != 0, meta[2], meta[3]
        tasks, pruned, jobs, ref_t = meta[4:8]
        rows = flat[8 * n:].reshape(-1, 11)
        n_reg = nregs
    st.seconds["decode"] += TIMERS.take("decode")
    staged = np.flatnonzero(seeds.on_host | ovf | ~fcs_ok | ~fits)
    if staged.size:
        _metrics.count("device_fused_pipeline_fallbacks", int(staged.size))
        with TIMERS.stage("staged"):
            rows, n_reg = _splice(rows, nregs, staged, *regs_to_rows(_staged(
                opt, eng, reads, qlens, staged, seeds.on_host, tab, host,
                host_tab, exec_cfg)))
        st.seconds["staged"] += TIMERS.take("staged")
    st.host_reads += staged.size
    st.device_reads += n - staged.size
    st.host_seeded += int(seeds.on_host.sum())
    st.c_overflows += int((ovf & ~seeds.on_host).sum())
    st.fcs_reads += int((~fcs_ok & ~ovf & ~seeds.on_host).sum())
    st.long_reads += int((~fits & fcs_ok & ~ovf & ~seeds.on_host).sum())
    st.tasks += int(tasks.sum())
    st.pruned += int(pruned.sum())
    st.jobs += int(jobs.sum())
    for name, v in zip(fusedops.SPLIT_COUNTS, split.tolist()):
        setattr(st, name, getattr(st, name) + v)
        if name != "chains":
            _metrics.count(name, v)
    # what the JAX package's budgets would have flagged, each read once
    ref_s = seed_cnt > REF_S_SLOTS
    ref_c = ~ref_s & (nslots > REF_C_SLOTS)
    on_path = ~(ref_s | ref_c)
    on_path[staged] = False
    ref_r = on_path & (nregs > REF_R_SLOTS)
    st.ref_s_overflows += int(ref_s.sum())
    st.ref_c_overflows += int(ref_c.sum())
    st.ref_r_overflows += int(ref_r.sum())
    st.ref_t_overflows += int((on_path & ~ref_r & (ref_t != 0)).sum())
    return rows, n_reg
