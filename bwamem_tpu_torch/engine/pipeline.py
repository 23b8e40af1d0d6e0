"""End-to-end alignment pipeline of the port ([EXT] bwamem.c:
mem_align1_core + mem_reg2sam + bwamem_extra.c: mem_gen_alt).

``align_regs_raw`` takes a batch of reads to its alignment regions before
dedup, as rows in the host C++ core's layout (``regs_to_rows``), and
``align_regs_batch`` adds the Python dedup step; together they are the
counterpart of bwamem_tpu/engine/pipeline.py
``align_regs_batch``/``_align_regs_batch_native``.  A host-only
configuration (``device="cpu"``, no device stage, no ``force_waves``) runs
the fused host chain+extend core (``engine.native_core``) as the reference
does; every other one extends through the cross-read waves of
``extend_batch.chain2aln_batch`` on the port's device.  Each earlier stage
runs on the host (the C++ natives, or the Python oracles without them) or,
by ``exec_cfg``, on the port's device:

* ``device_seed``: the three seeding rounds in ``engine.seed_device``;
* ``device_sa_lookup``: every SA walk of the batch in one call of
  ``ops.fmindex.sa_lookup``; with ``device_seed`` too, the device-seeded
  reads' SA rows go from the seeding kernels to the walk without leaving
  the device;
* ``device_chain``: mem_chain + chain_flt in ``ops.chain``; with the other
  two, the flat interval table and the walk's output stay on the device
  from seeding to chaining, and only chains come back;
* ``device_pipeline``: the fused device path of ``engine.pipeline_device``
  (seeding, walks, chaining and the whole mem_chain2aln loop on the device;
  region rows come back, no extension wave runs), whatever the three
  switches above say.

With ``exec_cfg.mesh`` (``exec_ctx.mesh_exec``) the batch's reads are split
in contiguous sub-batches, one a mesh device, and each runs the stages
above on its device in its own thread (``parallel.mesh.run_shards``):
seeding, the walks of its reads' SA rows and the chaining, or the whole
fused path; the extension waves are split over the mesh by jobs
(``extend_batch``).  Every stage's result for a read depends on that read
alone, so the merged chains and region rows are the single-device route's.

A read that overflows a stage's budget takes that stage on the host (the
reference's rule) and is spliced in read order; there is no other fallback
from the device: a failed build, launch or kernel flag raises.  The record
assembly is the host C++ tail's (``engine.native_pipeline``, called by the
aligner on ``align_regs_raw``'s rows), or the Python oracle's
(``reg2sam_records``, ``gen_alt_xa``) on ``align_regs_batch``'s regions.
``native_seed_sa`` and ``native_pipeline_ok`` feed and gate the aligner's
whole-batch host route, as in the reference.  ``align1_regs``
(mem_align1_core: one read to its deduplicated regions) and ``align_se``
(one read to its records) are the reference's per-read host oracle; they
take no device, and no route of the aligner calls them.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..api.options import MEM_F_ALL, MEM_F_NO_MULTI, MemOptions
from ..ops import chain as chainops
from ..ops import fmindex as fmops
from ..utils.cudabuild import tally
from ..utils.timers import TIMERS
from . import exec_ctx, native_chain, native_fm
from .chain import chain_flt, flt_chained_seeds, mem_chain
from .exec_ctx import ExecConfig
from .extend import AlnReg, chain2aln
from .extend_batch import chain2aln_batch
from .finalize import Aln, mark_primary_se, reg2aln, sort_dedup_patch
from .fmindex import FMIndex
from .seed import SmemIntv, collect_intv
from .seed_device import host_rows, seed_batch
from .state import device_contigs, device_fm


class Engine:
    """One opened index + its FM query structures (host oracle engine)."""

    def __init__(self, idx):
        self.idx = idx
        self.fm = FMIndex(idx)


def _flag_alt_regs(bns, regs: List[AlnReg]) -> List[AlnReg]:
    """[EXT] mem_align1_core tail: regs on ALT contigs get is_alt=1."""
    anns = bns.anns
    for r in regs:
        if r.rid >= 0 and anns[r.rid].is_alt:
            r.is_alt = 1
    return regs


def align1_regs(opt: MemOptions, eng: Engine, query: np.ndarray) -> List[AlnReg]:
    """[EXT] mem_align1_core: read codes -> deduped alignment regions."""
    intervals = collect_intv(opt, eng.fm, query)
    return _regs_from_intervals(opt, eng, query, intervals, None)


def _regs_from_intervals(opt, eng, query, intervals, rbegs_per_intv):
    from .chain import flt_chained_seeds

    qlen = len(query)
    chains = mem_chain(
        opt, eng.fm, eng.idx.bns, qlen, intervals, rbegs_per_intv
    )
    chains = chain_flt(opt, chains)
    flt_chained_seeds(opt, eng.idx, qlen, query, chains)
    regs: List[AlnReg] = []
    for c in chains:
        chain2aln(opt, eng.idx, qlen, query, c, regs)
    regs = sort_dedup_patch(opt, eng.idx, query, regs)
    return _flag_alt_regs(eng.idx.bns, regs)


class SaStats:
    """Sampled-SA rows resolved on the device and on the host, and, only
    under ``exec_ctx.KEEP_LARGEST``, the rows of the largest device call, a
    tensor on the device (so a benchmark can time the kernel on them)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.device_sa_rows = 0
        self.host_sa_rows = 0
        self.largest_rows = None


SA_STATS = SaStats()


class ChainStats:
    """Reads chained on the device and on the host (seeded on the host, or
    flagged by the C budget: ``c_overflows``), the chain kernels launched,
    under ``exec_ctx.KEEP_LARGEST`` the largest table chained on the device
    (so a benchmark can time the kernels on it), and the reads the JAX
    package's per-batch budgets would
    have sent to the host (more seeds than its S bucket, more chains than
    its C bucket)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.device_reads = 0
        self.host_reads = 0
        self.launches = 0
        self.c_overflows = 0
        self.ref_s_overflows = 0
        self.ref_c_overflows = 0
        self.largest_table = None


CHAIN_STATS = ChainStats()


def _device_walk(dfm, ks: torch.Tensor) -> torch.Tensor:
    """Text positions of the SA rows ``ks`` on the index's device: one
    call of ``ops.fmindex.sa_lookup``."""
    out = fmops.sa_lookup(dfm, ks)
    SA_STATS.device_sa_rows += ks.numel()
    if exec_ctx.KEEP_LARGEST and (
            SA_STATS.largest_rows is None
            or ks.numel() > SA_STATS.largest_rows.numel()):
        SA_STATS.largest_rows = ks
    return out


def _sa_rows(fm, ks: np.ndarray, exec_cfg: ExecConfig) -> np.ndarray:
    """Text positions of the SA rows ``ks`` (int64): one device call when
    the stage is on the device, else the host C++ walk (or the oracle)."""
    if not len(ks):
        return np.zeros(0, dtype=np.int64)
    if exec_cfg.device_sa_lookup:
        dev = exec_cfg.device
        return _device_walk(device_fm(fm, dev),
                            torch.from_numpy(ks).to(dev)).cpu().numpy()
    SA_STATS.host_sa_rows += len(ks)
    if native_fm.available():
        return native_fm.sa_batch(fm, ks)
    return fm.sa_lookup(ks)


def _excl_scan(x: np.ndarray) -> np.ndarray:
    off = np.zeros(len(x), dtype=np.int64)
    np.cumsum(x[:-1], out=off[1:])
    return off


def _ks_counts(rows: np.ndarray, max_occ: int):
    """Per row of ``rows`` [N, 5], the count of bwa sample_ks's SA rows and
    the offset of its first."""
    cnt = np.minimum(rows[:, 2], max_occ).astype(np.int64)
    return cnt, _excl_scan(cnt)


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
    device routing (:126-144).  Seeding is the host's (``host_rows``), or
    with ``exec_cfg.device_seed`` the port's device stage; with
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
            rows, n_intv = host_rows(opt, eng.fm, reads)
    with TIMERS.stage("sa_lookup"):
        cnt, rbeg_off = _ks_counts(rows, opt.max_occ)
        if seeds is not None and exec_cfg.device_sa_lookup:
            # the card expanded the device-seeded reads' SA rows; the host
            # expands only those of the reads seeded on the host
            host_row = np.repeat(seeds.on_host, n_intv)
            on_card = np.repeat(~host_row, cnt)
            rbegs = np.empty(len(on_card), dtype=np.int64)
            rbegs[on_card] = _device_walk(seeds.dfm, seeds.ks).cpu().numpy()
            if not on_card.all():
                rbegs[~on_card] = _sa_rows(
                    eng.fm, _sample_ks(rows[host_row], opt.max_occ), exec_cfg)
        else:
            rbegs = _sa_rows(eng.fm, _sample_ks(rows, opt.max_occ), exec_cfg)
    return rows, _excl_scan(n_intv), n_intv, rbegs, rbeg_off, cnt


def _host_chains(opt, eng, qlens, which, rows, intv_off, n_intv, rbegs,
                 rbeg_off, cnt):
    """mem_chain + chain_flt on the host for the reads ``which`` (indices
    into the per-read arrays ``qlens``, ``intv_off``, ``n_intv``) of a flat
    seed table: the host C++ when it is built, else the oracle."""
    bns = eng.idx.bns
    if native_chain.available():
        return native_chain.chain_batch(
            opt, bns, qlens[which], rows, intv_off[which], n_intv[which],
            rbegs, rbeg_off, cnt)
    out = []
    for i in which:
        lo, hi = int(intv_off[i]), int(intv_off[i] + n_intv[i])
        intervals = [SmemIntv(*r) for r in rows[lo:hi].tolist()]
        per_intv = [rbegs[b: b + c] for b, c in zip(rbeg_off[lo:hi].tolist(),
                                                   cnt[lo:hi].tolist())]
        out.append(chain_flt(opt, mem_chain(opt, eng.fm, bns, int(qlens[i]),
                                            intervals, per_intv)))
    return out


def _device_table(opt, eng, reads, qlens, exec_cfg: ExecConfig):
    """The batch's flat seed table on the device for the chain stage, the
    indices and the table on the host of the reads seeded there (None when
    there are none), and the seeding stage's ``DeviceSeeds`` (None when the
    host seeded).  With the seed and SA stages on the device too, the
    interval table and the walk's output go to the chain kernels as the
    seeding and SA kernels left them; else the host arrays of ``_seed_sa``
    are uploaded."""
    dev = exec_cfg.device
    qlen_d = torch.from_numpy(qlens).to(dev)
    if not (exec_cfg.device_seed and exec_cfg.device_sa_lookup):
        return chainops.SeedTable.from_numpy(
            dev, qlens, *_seed_sa(opt, eng, reads, exec_cfg)), None, None, None
    with TIMERS.stage("seed"):
        seeds = seed_batch(opt, eng.fm, reads, dev)
    with TIMERS.stage("sa_lookup"):
        rbegs = _device_walk(seeds.dfm, seeds.ks)
        n = torch.from_numpy(
            np.where(seeds.on_host, 0, seeds.n_intv)).to(dev)
        cnt = seeds.rows_dev[:, 2].clamp(max=opt.max_occ)
        tab = chainops.SeedTable(
            qlen_d, seeds.rows_dev, torch.cumsum(n, 0) - n, n, rbegs,
            torch.cumsum(cnt, 0) - cnt, cnt)
        host = np.flatnonzero(seeds.on_host)
        host_tab = None
        if host.size:
            rows_h, n_h = seeds.host_rows, seeds.n_intv[host]
            cnt_h, off_h = _ks_counts(rows_h, opt.max_occ)
            host_tab = (rows_h, _excl_scan(n_h), n_h, _sa_rows(
                eng.fm, _sample_ks(rows_h, opt.max_occ), exec_cfg), off_h, cnt_h)
    return tab, host, host_tab, seeds


def gather_reads(tab: chainops.SeedTable, which: np.ndarray):
    """The seeds of the reads ``which`` of a device table, gathered on the
    device and copied back in one piece: the arrays ``_host_chains`` takes
    (rows, intv_off, n_intv, rbegs, rbeg_off, cnt) for just those reads."""
    dev = tab.qlen.device
    idx = torch.from_numpy(np.asarray(which, dtype=np.int64)).to(dev)
    n = tab.n_intv.long()[idx]

    row_idx = chainops.expand_ranges(tab.intv_off.long()[idx], n)
    cnt = tab.cnt.long()[row_idx]
    rbegs = tab.rbegs.long()[
        chainops.expand_ranges(tab.rbeg_off.long()[row_idx], cnt)]
    flat = torch.cat([n, cnt, tab.rows[row_idx].reshape(-1), rbegs]).cpu().numpy()
    nr = row_idx.numel()
    n, cnt, flat = flat[:len(which)], flat[len(which): len(which) + nr], flat[
        len(which) + nr:]
    return (flat[:5 * nr].reshape(nr, 5), _excl_scan(n), n, flat[5 * nr:],
            _excl_scan(cnt), cnt)


def _chains_device(opt, eng, reads, exec_cfg: ExecConfig):
    """mem_chain + chain_flt of the batch in the chain kernels.  Reads
    seeded on the host and reads flagged by the C budget are chained on the
    host and spliced in read order."""
    qlens = np.asarray([len(r) for r in reads], dtype=np.int32)
    tab, host, host_tab, _ = _device_table(opt, eng, reads, qlens, exec_cfg)
    with TIMERS.stage("chain"):
        before = tally()["chain"]
        chains_list, (ovf, seed_cnt, nslots) = chainops.chains_device_batch(
            device_contigs(eng.idx.bns, exec_cfg.device), tab,
            chainops.ChainParams.from_opt(opt))
        CHAIN_STATS.launches += tally()["chain"] - before
        if exec_ctx.KEEP_LARGEST and (
                CHAIN_STATS.largest_table is None
                or tab.rbegs.numel() > CHAIN_STATS.largest_table.rbegs.numel()):
            CHAIN_STATS.largest_table = tab
        flagged = np.flatnonzero(ovf)
        if flagged.size:
            for i, chains in zip(flagged, _host_chains(
                    opt, eng, qlens[flagged], np.arange(flagged.size),
                    *gather_reads(tab, flagged))):
                chains_list[i] = chains
        if host_tab is not None:
            rows_h, off_h, n_h, *rest = host_tab
            for i, chains in zip(host, _host_chains(
                    opt, eng, qlens[host], np.arange(host.size), rows_h, off_h,
                    n_h, *rest)):
                chains_list[i] = chains
        n_host = flagged.size + (0 if host is None else host.size)
        CHAIN_STATS.c_overflows += flagged.size
        CHAIN_STATS.host_reads += n_host
        CHAIN_STATS.device_reads += len(reads) - n_host
        ref_s, ref_c = chainops.ref_overflows(seed_cnt, nslots)
        CHAIN_STATS.ref_s_overflows += ref_s
        CHAIN_STATS.ref_c_overflows += ref_c
    return chains_list


def by_reads(fn, reads, exec_cfg: ExecConfig):
    """``fn(sub_batch, shard_config)`` on the reads of each mesh device's
    contiguous shard, one thread a shard (``parallel.mesh.run_shards``):
    the per-shard results in read order."""
    from ..parallel.mesh import run_shards, shards

    work = [(d, reads[lo:hi]) for d, lo, hi in shards(exec_cfg.mesh, len(reads))]
    return run_shards(lambda d, sub: fn(sub, exec_cfg.on(d)), work)


def _chains(opt, eng, reads, exec_cfg: ExecConfig):
    """Seeding, SA walks, mem_chain + chain_flt and mem_flt_chained_seeds:
    per read its chains.  With a mesh and a device stage, each mesh
    device's sub-batch in its own thread (``by_reads``), inside the stage
    ``mesh_chains``; each shard thread's stages are top-level on it."""
    if exec_cfg.mesh is not None and (exec_cfg.device_seed
                                      or exec_cfg.device_sa_lookup
                                      or exec_cfg.device_chain):
        with TIMERS.stage("mesh_chains"):
            parts = by_reads(lambda sub, cfg: _chains(opt, eng, sub, cfg),
                             reads, exec_cfg)
        return [c for part in parts for c in part]
    if exec_cfg.device_chain:
        chains_list = _chains_device(opt, eng, reads, exec_cfg)
    else:
        table = _seed_sa(opt, eng, reads, exec_cfg)
        with TIMERS.stage("chain"):
            qlens = np.asarray([len(r) for r in reads], dtype=np.int32)
            chains_list = _host_chains(opt, eng, qlens, np.arange(len(reads)),
                                       *table)
    with TIMERS.stage("chain"):
        for query, chains in zip(reads, chains_list):
            flt_chained_seeds(opt, eng.idx, len(query), query, chains)
    return chains_list


_REG_FIELDS = ("rb", "re", "qb", "qe", "rid", "score", "truesc", "w",
               "seedcov", "seedlen0")


def regs_to_rows(regs_list: List[List[AlnReg]]):
    """Per read its regions -> (rows [Nr, 11] int64, n_reg [len] int64): the
    region rows of ``bwamem_align_regs_batch`` (native/align_core.cpp: rb,
    re, qb, qe, rid, score, truesc, w, seedcov, seedlen0, then the bits of
    frac_rep), read after read, and the count of each read's."""
    n_reg = np.fromiter(map(len, regs_list), dtype=np.int64,
                        count=len(regs_list))
    flat = [a for regs in regs_list for a in regs]
    rows = np.empty((len(flat), 11), dtype=np.int64)
    if flat:
        rows[:, :10] = [[getattr(a, f) for f in _REG_FIELDS] for a in flat]
        rows[:, 10] = np.asarray([a.frac_rep for a in flat],
                                 dtype=np.float64).view(np.int64)
    return rows, n_reg


def regs_from_rows(rows: np.ndarray, n_reg: np.ndarray) -> List[List[AlnReg]]:
    """``regs_to_rows``'s inverse: per read its ``AlnReg`` list."""
    frac = rows[:, 10].copy().view(np.float64).tolist()
    cols = [rows[:, j].tolist() for j in range(10)]
    flat = [AlnReg(rb=rb, re=re, qb=qb, qe=qe, rid=rid, score=sc, truesc=ts,
                   w=w, seedcov=cov, seedlen0=sl0, frac_rep=fr)
            for (rb, re, qb, qe, rid, sc, ts, w, cov, sl0), fr
            in zip(zip(*cols), frac)]
    out, k = [], 0
    for n in n_reg.tolist():
        out.append(flat[k: k + n])
        k += n
    return out


_HOST = ExecConfig(device="cpu")


def native_seed_sa(opt, eng, reads):
    """Native three-round seeding + vectorized SA resolution on the host
    (bwamem_tpu/engine/pipeline.py ``native_seed_sa``).

    Returns the raw arrays consumed by the native core/pipeline entries:
    (intv rows [N,5], intv_off, n_intv, rbegs, rbeg_off, cnt).
    """
    return _seed_sa(opt, eng, reads, _HOST)


def native_pipeline_ok(eng, reads, exec_cfg: ExecConfig) -> bool:
    """Full-native pipeline applicability: native libs present, no device
    stage (a configuration on a card never qualifies, nor one with
    ``force_waves``), and an unpacked reference cache."""
    from . import native_pipeline

    if not (native_fm.available() and native_pipeline.available()):
        return False
    if exec_cfg.any_device_stage():
        return False
    # all read lengths supported: the native tail carries the long-read
    # stages too (mem_flt_chained_seeds / mem_seed_sw in pipeline.cpp)
    return eng.idx.bns.l_pac <= eng.idx._UNPACK_CACHE_MAX


def _fused_core_ok(eng, reads, exec_cfg: ExecConfig) -> bool:
    """The reference's gate of its fused chain+extend core: the host-only
    route, every native built, no read long enough for
    mem_flt_chained_seeds to act, the reference in the unpacked cache."""
    from . import native_core

    return (not exec_cfg.any_device_stage()
            and native_fm.available() and native_chain.available()
            and native_core.available()
            and max((len(r) for r in reads), default=0) < 500
            and eng.idx.bns.l_pac <= eng.idx._UNPACK_CACHE_MAX)


def align_regs_raw(opt, eng, reads: List[np.ndarray], exec_cfg: ExecConfig):
    """Reads (codes 0-4) -> alignment regions before dedup, in the order
    chain2aln appends them: (rows [Nr, 11] int64, n_reg [len] int64), the
    layout of ``regs_to_rows``, which the C++ tail
    (``native_pipeline.tail_batch_arrays``) takes as it is."""
    if exec_cfg.device_pipeline:
        from .pipeline_device import regs_rows_fused

        with TIMERS.stage("device_pipeline"):
            return regs_rows_fused(opt, eng, reads, exec_cfg)
    if _fused_core_ok(eng, reads, exec_cfg):
        from . import native_core

        table = native_seed_sa(opt, eng, reads)
        with TIMERS.stage("chain+extend"):
            return regs_to_rows(native_core.align_regs_batch_core(
                opt, eng.idx, reads, *table))
    chains_list = _chains(opt, eng, reads, exec_cfg)
    with TIMERS.stage("extend"):
        return regs_to_rows(chain2aln_batch(opt, eng.idx, reads, chains_list,
                                            exec_cfg))


def align_regs_batch(opt, eng, reads: List[np.ndarray],
                     exec_cfg: ExecConfig) -> List[List[AlnReg]]:
    """Reads (codes 0-4) -> deduplicated alignment regions per read:
    ``align_regs_raw``, then the Python dedup (sort_dedup_patch and the ALT
    flags)."""
    rows, n_reg = align_regs_raw(opt, eng, reads, exec_cfg)
    with TIMERS.stage("dedup"):
        return [
            _flag_alt_regs(eng.idx.bns, sort_dedup_patch(opt, eng.idx, q, regs))
            for q, regs in zip(reads, regs_from_rows(rows, n_reg))
        ]


def gen_alt_xa(
    opt: MemOptions, eng: Engine, regs: List[AlnReg], qlen: int, query: np.ndarray
) -> List[Optional[str]]:
    """[EXT] mem_gen_alt: XA alternative-hit strings, indexed by primary reg.

    Returns a list parallel to regs; XA[k] is the alt-hit string for the
    primary region at index k (None when there are no alternates or the
    count exceeds max_XA_hits).
    """
    n = len(regs)
    xa: List[Optional[str]] = [None] * n

    def pri_idx(i: int) -> int:
        k = regs[i].secondary_all
        if k >= 0 and regs[i].score >= regs[k].score * opt.xa_drop_ratio:
            return k
        return -1

    cnt = [0] * n
    has_alt = [False] * n
    tot = 0
    for i in range(n):
        r = pri_idx(i)
        if r >= 0:
            cnt[r] += 1
            tot += 1
            if regs[i].is_alt:
                has_alt[r] = True
    if tot == 0:
        return xa
    parts: List[List[str]] = [[] for _ in range(n)]
    for i in range(n):
        r = pri_idx(i)
        if r < 0:
            continue
        if cnt[r] > opt.max_xa_hits_alt or (not has_alt[r] and cnt[r] > opt.max_xa_hits):
            continue
        t = reg2aln(opt, eng.idx, qlen, query, regs[i])
        cig = "".join(f"{ln}{'MIDSH'[op]}" for op, ln in t.cigar)
        parts[r].append(
            f"{eng.idx.bns.anns[t.rid].name},{'+-'[t.is_rev]}{t.pos + 1},{cig},{t.NM};"
        )
    for k in range(n):
        if parts[k]:
            xa[k] = "".join(parts[k])
    return xa


def reg2sam_records(
    opt: MemOptions,
    eng: Engine,
    query: np.ndarray,
    regs: List[AlnReg],
    extra_flag: int = 0,
    mate: Optional[Aln] = None,
) -> List[Aln]:
    """[EXT] mem_reg2sam: regions -> final per-read record list.

    mark_primary_se must already have run on regs.  Flag assembly mirrors
    mem_aln2sam's bit fixes, and the internal 0x10000 'secondary-style
    supplementary' bit maps to SAM 0x100 exactly as fmt_BAMish does
    (jnibwa.c:50-51).
    """
    qlen = len(query)
    xa = (
        gen_alt_xa(opt, eng, regs, qlen, query)
        if not (opt.flag & MEM_F_ALL)
        else [None] * len(regs)
    )
    out: List[Aln] = []
    for k, p in enumerate(regs):
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and (p.is_alt or not (opt.flag & MEM_F_ALL)):
            continue
        if (
            p.secondary >= 0
            and p.secondary < (1 << 30)
            and p.score < regs[p.secondary].score * opt.drop_ratio
        ):
            continue
        q = reg2aln(opt, eng.idx, qlen, query, p)
        q.XA = xa[k]
        q.flag |= extra_flag
        if p.secondary >= 0:
            q.sub = -1  # don't output subopt score for secondaries
        if out and p.secondary < 0:  # supplementary
            q.flag |= 0x10000 if (opt.flag & MEM_F_NO_MULTI) else 0x800
        if out and not p.is_alt and q.mapq > out[0].mapq:
            q.mapq = out[0].mapq
        out.append(q)
    if not out:
        t = reg2aln(opt, eng.idx, qlen, query, None)
        t.flag |= extra_flag
        out.append(t)
    # mem_aln2sam flag fixes for each record
    for q in out:
        _fix_flags(q, mate)
    return out


def _fix_flags(p: Aln, m: Optional[Aln]) -> None:
    """Flag assembly from mem_aln2sam ([EXT] bwamem.c)."""
    p.flag |= 0x1 if m is not None else 0
    p.flag |= 0x4 if p.rid < 0 else 0
    p.flag |= 0x8 if (m is not None and m.rid < 0) else 0
    if p.rid < 0 and m is not None and m.rid >= 0:  # copy mate pos to unmapped
        p.rid, p.pos, p.is_rev = m.rid, m.pos, m.is_rev
        p.cigar = []
    p.flag |= 0x10 if p.is_rev else 0
    p.flag |= 0x20 if (m is not None and m.is_rev) else 0


def align_se(opt: MemOptions, eng: Engine, query: np.ndarray, read_id: int = 0) -> List[Aln]:
    """Full single-end alignment of one read (codes in {0..4})."""
    from ..api.options import MEM_F_PRIMARY5
    from .finalize import reorder_primary5

    regs = align1_regs(opt, eng, query)
    mark_primary_se(opt, regs, read_id)
    if opt.flag & MEM_F_PRIMARY5:
        reorder_primary5(opt.T, regs)
    return reg2sam_records(opt, eng, query, regs)
