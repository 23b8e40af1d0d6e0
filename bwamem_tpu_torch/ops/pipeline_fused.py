"""Chains to alignment regions on the device (bwa mem_chain2aln), PyTorch.

The counterpart of the last stage of bwamem_tpu/ops/pipeline_fused.py
``pipeline_fused_body``: per chain the extension window ``[rmax0, rmax1]``,
per read the ``mem_chain2aln`` loop over its chains' seeds (contained-seed
pruning against the regions made so far, left and right banded extension
with one band doubling, region assembly).  The earlier stages of that
program are ``ops.seed.seed_sa``, ``ops.fmindex.sa_lookup`` and
``ops.chain.chain``; this module starts from ``ops.chain.Chains`` as they lie
on the device.

* ``chain2aln_torch`` is the plain PyTorch version: reads advance in
  lockstep, one task a read a wave, padded to the batch's largest counts;
  target windows are gathered base by base from the pac tensor; extensions
  run through ``ops.extend.ksw_extend_torch``.  It runs wherever its tensors
  lie.  ``chain2aln_split_torch`` mirrors the loop kernel's chain items
  (below) in the same waves; ``chain2aln_torch`` hands it a batch whose
  split set holds a read.
* ``chain2aln_cuda`` launches the hand-written Hopper kernels of
  ``csrc/chain2aln.cu`` (a prep kernel, one warp per chain, and the loop
  kernel, one warp per read, a target row's band across the lanes; warps
  take work items heaviest first, in the order ``work_items`` gives).  The
  reads of ``split_reads``, those that would outlast the card's fair share
  of the batch on one warp, run as chain items: each chain on a warp of its
  own against its own regions, then the read committed in bwa's order, each
  chain's decisions taken again against the read's regions with its own
  extensions reused (the kernel's note says why that is exact).
* ``chain2aln`` dispatches on the device of its inputs.

Semantics are the host oracle's, engine/extend.py ``chain2aln``.  The three
float comparisons (``cal_max_gap``'s truncated quotient, ``len - seedlen0 >
0.1 * qlen`` and ``t.len < s.len * 0.95``) are made in float64 as the oracle
makes them; the JAX program makes them in float32.

There is no budget on seeds, regions or window length: a read makes at most
one region per seed of its chains, so its regions live at its offset in a
table as long as ``seed_rows`` and ``nregs`` says how many are real.  ``run``
[B] bool names the reads to process (the caller leaves out reads flagged by
an earlier stage and reads for which mem_flt_chained_seeds would act).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..engine.state import DeviceRef
from ..utils.cudabuild import on_device, stream, tally
from .chain import Chains, DeviceContigs, _excl_scan, expand_ranges
from .extend import ksw_extend_torch

# launches of each CUDA kernel; bumped only where it is launched
LAUNCHES = {"chain2aln_prep": 0, "chain2aln": 0}
ERR_WINDOW = 1  # a seed outside its chain's window
ERR_ROWS = 2  # a region past the read's rows
ERR_CONTIG = 4  # a chain's first seed in no contig
NO_T_CAP = 1 << 62
# the loop kernel's limits (csrc/extend.cuh ksw_extend_warp): a column in 12
# bits and every H below 2^19, for the packed (h, j) of a row's max
MAX_QLEN = (1 << 12) - 1
MAX_H = 1 << 19
# columns of Regions.work
W_TASKS, W_PRUNED, W_JOBS, W_REF_T, W_CELLS, W_ROWS = range(6)
# Regions.split's entries: the chains of the reads run; the reads that split
# and their chains; the chains whose commit decided a seed otherwise than
# their own runs, and the band cells of own extensions it discarded
SPLIT_COUNTS = ("chains", "split_reads", "split_chains", "split_reruns",
                "split_wasted_cells")
# split_reads' line is the batch's estimate over this many times the resident
# warps.  The estimate counts every seed, and an average read's chains prune
# most of theirs (tasks were 31-49 % of seeds in batches of 66,666 GRCh38
# reads), while a heavy read of many short chains extends nearly all (98 %);
# at the resident warps alone the line missed the MHC reads' heaviest.  On
# twelve such batches of two read sets (chr20 and chr6 with its MHC ALT
# haplotypes; an H100), the loop's time at 4 was within 5 % of the best of
# 1, 2, 4, 8 and 16 on every batch, while 2 left MHC batches up to 1.8x
# slower, and a line from the batch's chains (which track its tasks within
# 3 %) over the resident warps alone left one 1.5x slower.
SPLIT_LINE = 4


@dataclass(frozen=True)
class ExtendParams:
    """The extension options of ``MemOptions`` that the kernels take."""

    a: int
    o_del: int
    e_del: int
    o_ins: int
    e_ins: int
    zdrop: int
    w: int
    pen_clip5: int
    pen_clip3: int
    max_sc: int

    @classmethod
    def from_opt(cls, opt) -> "ExtendParams":
        return cls(int(opt.a), int(opt.o_del), int(opt.e_del), int(opt.o_ins),
                   int(opt.e_ins), int(opt.zdrop), int(opt.w),
                   int(opt.pen_clip5), int(opt.pen_clip3), int(max(opt.mat)))


class Regions(NamedTuple):
    """``chain2aln``'s result.  Read i's regions are rows ``seed_off[i] ..
    seed_off[i] + nregs[i]`` of ``reg_c`` [Ns, 3] int64 (rb, re, frac_rep
    bits) and ``reg_i`` [Ns, 8] int32 (qb, qe, score, truesc, w, seedcov,
    seedlen0, rid), in the order the oracle appends them.  ``work`` [B, 6]
    int64 counts per read the tasks extended, the tasks pruned, the
    extension jobs, whether a task's window was longer than ``t_cap``, and
    the band cells and target rows its extensions walked: the decisions
    that stand, whichever way the read ran.  ``split`` [5] int64 holds the
    batch's ``SPLIT_COUNTS``."""

    reg_c: torch.Tensor
    reg_i: torch.Tensor
    nregs: torch.Tensor  # [B] int32
    seed_off: torch.Tensor  # [B] int64
    work: torch.Tensor
    split: torch.Tensor

    def compact(self) -> torch.Tensor:
        """The real rows in read order, [Nr, 11] int64: rb, re, frac_rep
        bits, then ``reg_i``'s columns."""
        rows = expand_ranges(self.seed_off, self.nregs.long())
        return torch.cat([self.reg_c[rows], self.reg_i[rows].long()], dim=1)


class _Layout(NamedTuple):
    """Where each read's chains and each chain's seeds lie in ``Chains``."""

    chain_off: torch.Tensor  # [B] first chain of the read
    seed_off: torch.Tensor  # [B] first seed row of the read
    ns: torch.Tensor  # [Nc] seeds per chain
    chain_seed_off: torch.Tensor  # [Nc] first seed row of the chain
    chain_read: torch.Tensor  # [Nc] int32


def _layout(chains: Chains) -> _Layout:
    B = chains.n_chain.shape[0]
    ns = chains.chain_rows[:, 2].contiguous()
    return _Layout(_excl_scan(chains.n_chain), _excl_scan(chains.n_seed), ns,
                   _excl_scan(ns), torch.repeat_interleave(
                       torch.arange(B, dtype=torch.int32, device=ns.device),
                       chains.n_chain))


def _check(ctg: DeviceContigs, ref: DeviceRef, chains: Chains, qseq, qlen, run):
    B = chains.n_chain.shape[0]
    dev = chains.chain_rows.device
    if chains.chain_rows.dim() != 2 or chains.chain_rows.shape[1] != 7:
        raise ValueError("chain_rows must be [Nc, 7]")
    if chains.seed_rows.dim() != 2 or chains.seed_rows.shape[1] != 4:
        raise ValueError("seed_rows must be [Ns, 4]")
    if qseq.dim() != 2 or qseq.shape[0] != B or qseq.dtype != torch.uint8:
        raise ValueError(f"qseq must be [{B}, L] uint8")
    if qlen.shape != (B,) or run.shape != (B,) or chains.n_seed.shape != (B,):
        raise ValueError(f"qlen, run and the read counts must be [{B}]")
    if ref.l_pac != ctg.l_pac or ref.pac.numel() * 4 < ref.l_pac:
        raise ValueError("the pac and the contig tables disagree on l_pac")
    for t in (chains.seed_rows, chains.n_chain, chains.n_seed, qseq, qlen, run,
              ref.pac, ctg.ctg_end, ctg.ctg_off):
        if t.device != dev:
            raise ValueError(f"expected tensors on {dev}, got one on {t.device}")
    if B and bool((qlen.long() > qseq.shape[1]).any()):
        raise ValueError("a read is longer than the padded reads")


# ------------------------------------------------------------- plain version

def max_gap(x: torch.Tensor, p: ExtendParams) -> torch.Tensor:
    """cal_max_gap per element of the int64 tensor ``x``: the oracle's
    truncated float64 quotient (``MemOptions.max_gap``)."""
    l_del = torch.trunc((x * p.a - p.o_del).double() / p.e_del + 1.0).long()
    l_ins = torch.trunc((x * p.a - p.o_ins).double() / p.e_ins + 1.0).long()
    return torch.maximum(l_del, l_ins).clamp(min=1).clamp(max=p.w << 1)


def ref_codes(ref: DeviceRef, pos: torch.Tensor) -> torch.Tensor:
    """The codes (0-3) at doubled-domain positions ``pos`` (bwa bns_get_seq:
    a reverse position is the complement of the mirrored forward one).
    Positions outside [0, 2 l_pac) are clamped; the caller masks them."""
    pos = pos.clamp(0, 2 * ref.l_pac - 1)
    rev = pos >= ref.l_pac
    f = torch.where(rev, 2 * ref.l_pac - 1 - pos, pos)
    c = (ref.pac[f >> 2].long() >> ((3 - (f & 3)) << 1)) & 3
    return torch.where(rev, 3 - c, c).to(torch.uint8)


def chain_windows(ctg: DeviceContigs, chains: Chains, lay: _Layout, qlen,
                  p: ExtendParams):
    """Per chain its extension window (rmax0, rmax1) and per srt position
    the seed row that stands there: each chain's seeds ascending by (score,
    index), chains in output order."""
    dev = chains.seed_rows.device
    Nc = chains.chain_rows.shape[0]
    l_pac = ctg.l_pac
    sr = chains.seed_rows
    rbeg, qb, ln, score = sr[:, 0], sr[:, 1], sr[:, 2], sr[:, 3]
    c_of = torch.repeat_interleave(torch.arange(Nc, device=dev), lay.ns)
    tail = qlen.long()[lay.chain_read.long()][c_of] - qb - ln
    lo = rbeg - (qb + max_gap(qb, p))
    hi = rbeg + ln + (tail + max_gap(tail, p))
    r0 = torch.full((Nc,), 2 * l_pac, dtype=torch.int64, device=dev)
    r0 = r0.scatter_reduce(0, c_of, lo, "amin").clamp(min=0)
    r1 = torch.zeros(Nc, dtype=torch.int64, device=dev)
    r1 = r1.scatter_reduce(0, c_of, hi, "amax").clamp(max=2 * l_pac)
    # crossing the strand boundary: the first seed picks the side
    first = rbeg[lay.chain_seed_off.clamp(max=max(rbeg.numel() - 1, 0))]
    cross, fwd = (r0 < l_pac) & (l_pac < r1), first < l_pac
    r1 = torch.where(cross & fwd, l_pac, r1)
    r0 = torch.where(cross & ~fwd, l_pac, r0)
    # clamp to the contig holding the first seed (bns_fetch_seq)
    mid = torch.where(fwd, first, 2 * l_pac - 1 - first)
    rid = torch.searchsorted(ctg.ctg_end, mid, right=True)
    if Nc and bool(((rid >= ctg.ctg_end.numel()) | (mid < 0)).any()):
        raise RuntimeError("chain2aln: a chain's first seed lies in no contig")
    far_beg, far_end = ctg.ctg_off[rid], ctg.ctg_end[rid]
    r0 = torch.maximum(r0, torch.where(fwd, far_beg, 2 * l_pac - far_end))
    r1 = torch.minimum(r1, torch.where(fwd, far_end, 2 * l_pac - far_beg))
    by_score = torch.sort(score, stable=True).indices
    perm = by_score[torch.sort(c_of[by_score], stable=True).indices]
    return r0, r1, perm, c_of


def _retry(ext, ql, tl, h0, prev, p: ExtendParams):
    """MAX_BAND_TRY = 2: every job at ``w``; those whose score moved off
    ``prev`` and whose max_off reached 3/4 of the band again at ``2w``.
    Returns the results (the rows and cells of both tries summed) and the
    band each job ended with."""
    w0 = torch.full_like(ql, p.w)
    res = ext(slice(None), ql, tl, h0, w0)
    retry = ((res["score"] != prev)
             & (res["max_off"] >= (p.w >> 1) + (p.w >> 2))).nonzero().squeeze(1)
    aw = w0.clone()
    if retry.numel():
        again = ext(retry, ql[retry], tl[retry], h0[retry], w0[retry] << 1)
        for k in res:
            if k in ("rows", "cells"):
                res[k][retry] += again[k]
            else:
                res[k][retry] = again[k]
        aw[retry] = p.w << 1
    return res, aw


def _split_counts(chains: Chains, run) -> torch.Tensor:
    """``Regions.split`` before any read splits: the chains of ``run``."""
    counts = torch.zeros(len(SPLIT_COUNTS), dtype=torch.int64,
                         device=chains.n_chain.device)
    counts[0] = torch.where(run.bool(), chains.n_chain, 0).sum()
    return counts


def chain2aln_torch(ctg: DeviceContigs, ref: DeviceRef, chains: Chains, qseq,
                    qlen, run, params: ExtendParams, mat,
                    t_cap: int = NO_T_CAP, split=None) -> Regions:
    """mem_chain2aln for every read of ``run``, in lockstep waves.  Where
    ``split`` ([B] bool) holds a read of ``run``, ``chain2aln_split_torch``
    runs the batch instead, as the loop kernel's chain items run it."""
    if split is not None and bool((split.bool() & run.bool()).any()):
        return chain2aln_split_torch(ctg, ref, chains, qseq, qlen, run, params,
                                     mat, t_cap, split)
    _check(ctg, ref, chains, qseq, qlen, run)
    p = params
    dev = chains.seed_rows.device
    i32, i64 = torch.int32, torch.int64
    B, Ns = qlen.shape[0], chains.seed_rows.shape[0]
    lay = _layout(chains)
    reg_c = torch.zeros((Ns, 3), dtype=i64, device=dev)
    reg_i = torch.zeros((Ns, 8), dtype=i32, device=dev)
    nreg = torch.zeros(B, dtype=i64, device=dev)
    work = torch.zeros((B, 6), dtype=i64, device=dev)
    counts = _split_counts(chains, run)
    if not Ns:
        return Regions(reg_c, reg_i, nreg.to(i32), lay.seed_off, work, counts)
    r0, r1, perm, c_of = chain_windows(ctg, chains, lay, qlen, p)
    sr = chains.seed_rows
    ql64 = qlen.long()
    n_seed = torch.where(run.bool(), chains.n_seed, 0)
    # task t of a read stands at row g = seed_off + t: its chain's seeds from
    # the end of srt down
    g_all = torch.arange(Ns, device=dev)
    cso = lay.chain_seed_off[c_of]
    task_pos = 2 * cso + lay.ns[c_of] - 1 - g_all
    chain_end = cso + lay.ns[c_of]  # by row; a chain's srt positions end here
    alive = torch.ones(Ns, dtype=torch.bool, device=dev)
    tc = torch.zeros(B, dtype=i64, device=dev)
    mat = mat.to(i32)
    L = qseq.shape[1]

    def pruned(idx):
        g = lay.seed_off[idx] + tc[idx]
        pos = task_pos[g]
        s = perm[pos]
        rb, qb, ln = sr[s, 0, None], sr[s, 1, None], sr[s, 2, None]
        R = int(nreg[idx].max())
        if R == 0:
            return torch.zeros(idx.numel(), dtype=torch.bool, device=dev)
        rr = torch.arange(R, device=dev)
        rows = (lay.seed_off[idx, None] + rr).clamp(max=Ns - 1)
        pc, pi = reg_c[rows], reg_i[rows].long()
        p_rb, p_re, p_qb, p_qe = pc[..., 0], pc[..., 1], pi[..., 0], pi[..., 1]
        p_w, p_sl0 = pi[..., 4], pi[..., 6]
        ok = ((rr < nreg[idx, None]) & (rb >= p_rb) & (rb + ln <= p_re)
              & (qb >= p_qb) & (qb + ln <= p_qe)
              & ~((ln - p_sl0).double() > 0.1 * ql64[idx, None].double()))
        hit = torch.zeros_like(ok)
        for qd, rd in ((qb - p_qb, rb - p_rb),
                       (p_qe - (qb + ln), p_re - (rb + ln))):
            w = torch.minimum(max_gap(torch.minimum(qd, rd), p), p_w)
            hit |= (qd - rd < w) & (rd - qd < w)
        contained = (ok & hit).any(dim=1)
        # a live later seed of the chain that argues for another alignment
        ci = contained.nonzero().squeeze(1)
        if not ci.numel():
            return contained
        pos, rb, qb, ln = pos[ci, None], rb[ci], qb[ci], ln[ci]
        end = chain_end[g[ci], None]
        M = int((end - pos - 1).max())
        if M <= 0:
            return contained
        p2 = pos + 1 + torch.arange(M, device=dev)
        m = p2 < end
        p2 = p2.clamp(max=Ns - 1)
        t = perm[p2]
        t_rb, t_qb, t_ln = sr[t, 0], sr[t, 1], sr[t, 2]
        big = ~(t_ln.double() < ln.double() * 0.95)
        c1 = ((qb <= t_qb) & (qb + ln - t_qb >= (ln >> 2))
              & (t_qb - qb != t_rb - rb))
        c2 = ((t_qb <= qb) & (t_qb + t_ln - qb >= (ln >> 2))
              & (qb - t_qb != rb - t_rb))
        diff = (m & alive[p2] & big & (c1 | c2)).any(dim=1)
        contained[ci[diff]] = False
        return contained

    def extend(idx, q_at, t_at, ql, tl, h0, prev, bonus):
        """One side's jobs of the reads ``idx``: query base j of a job is
        ``qseq[read, q_at(j)]``, target base i is position ``t_at(i)``."""
        jq = torch.arange(max(int(ql.max()), 1), device=dev)
        jt = torch.arange(max(int(tl.max()), 1), device=dev)
        qa = qseq[idx[:, None], q_at(jq).clamp(0, L - 1)]
        ta = ref_codes(ref, t_at(jt))

        def ext(sel, ql_, tl_, h0_, w_):
            return ksw_extend_torch(
                qa[sel], ta[sel], ql_.to(i32), tl_.to(i32), h0_.to(i32),
                w_.to(i32), torch.full_like(ql_, bonus, dtype=i32), mat,
                p.o_del, p.e_del, p.o_ins, p.e_ins, p.zdrop, p.max_sc,
                count=True)

        res, aw = _retry(ext, ql, tl, h0, prev, p)
        return {k: v.long() for k, v in res.items()}, aw

    while True:
        # each read's next task that is not pruned
        cand = (tc < n_seed).nonzero().squeeze(1)
        while cand.numel():
            dead = cand[pruned(cand)]
            alive[task_pos[lay.seed_off[dead] + tc[dead]]] = False
            tc[dead] += 1
            work[dead, W_PRUNED] += 1
            cand = dead[tc[dead] < n_seed[dead]]
        cur = (tc < n_seed).nonzero().squeeze(1)
        if not cur.numel():
            break
        g = lay.seed_off[cur] + tc[cur]
        s = perm[task_pos[g]]
        c = c_of[g]
        rb, qb, ln = sr[s, 0], sr[s, 1], sr[s, 2]
        ql = ql64[cur]
        if bool(((rb < r0[c]) | (rb + ln > r1[c])).any()):
            raise RuntimeError("chain2aln: a seed lies outside its chain's window")
        work[cur, W_TASKS] += 1
        work[cur, W_REF_T] |= (r1[c] - r0[c] > t_cap).long()
        n = cur.numel()
        aw0 = torch.full((n,), p.w, dtype=i64, device=dev)
        aw1 = aw0.clone()
        # left extension on the reversed prefix
        score = ln * p.a
        truesc, qb_f, rb_f = score.clone(), torch.zeros_like(qb), rb.clone()
        li = (qb > 0).nonzero().squeeze(1)
        if li.numel():
            res, aw0[li] = extend(
                cur[li], lambda j: qb[li, None] - 1 - j,
                lambda i: rb[li, None] - 1 - i, qb[li], rb[li] - r0[c[li]],
                score[li], torch.full_like(li, -1), p.pen_clip5)
            work[cur[li], W_JOBS] += 1
            work[cur[li[aw0[li] > p.w]], W_JOBS] += 1
            work[cur[li], W_CELLS] += res["cells"]
            work[cur[li], W_ROWS] += res["rows"]
            loc = (res["gscore"] <= 0) | (res["gscore"] <= res["score"] - p.pen_clip5)
            score[li] = res["score"]
            qb_f[li] = torch.where(loc, qb[li] - res["qle"], 0)
            rb_f[li] = rb[li] - torch.where(loc, res["tle"], res["gtle"])
            truesc[li] = torch.where(loc, res["score"], res["gscore"])
        # right extension
        qe, re0 = qb + ln, rb + ln
        qe_f, re_f = ql.clone(), re0.clone()
        ri = (qe != ql).nonzero().squeeze(1)
        if ri.numel():
            sc0 = score[ri]
            res, aw1[ri] = extend(
                cur[ri], lambda j: qe[ri, None] + j, lambda i: re0[ri, None] + i,
                ql[ri] - qe[ri], r1[c[ri]] - re0[ri], sc0, sc0, p.pen_clip3)
            work[cur[ri], W_JOBS] += 1
            work[cur[ri[aw1[ri] > p.w]], W_JOBS] += 1
            work[cur[ri], W_CELLS] += res["cells"]
            work[cur[ri], W_ROWS] += res["rows"]
            loc = (res["gscore"] <= 0) | (res["gscore"] <= res["score"] - p.pen_clip3)
            score[ri] = res["score"]
            qe_f[ri] = torch.where(loc, qe[ri] + res["qle"], ql[ri])
            re_f[ri] = re0[ri] + torch.where(loc, res["tle"], res["gtle"])
            truesc[ri] += torch.where(loc, res["score"], res["gscore"]) - sc0
        # seedcov over the chain's seeds, then the region
        cs = lay.chain_seed_off[c, None] + torch.arange(
            int(lay.ns[c].max()), device=dev)
        inside = cs < (lay.chain_seed_off[c] + lay.ns[c])[:, None]
        cs = cs.clamp(max=Ns - 1)
        t_rb, t_qb, t_ln = sr[cs, 0], sr[cs, 1], sr[cs, 2]
        inside &= ((t_qb >= qb_f[:, None]) & (t_qb + t_ln <= qe_f[:, None])
                   & (t_rb >= rb_f[:, None]) & (t_rb + t_ln <= re_f[:, None]))
        seedcov = torch.where(inside, t_ln, 0).sum(dim=1)
        row = lay.seed_off[cur] + nreg[cur]
        if bool((nreg[cur] >= chains.n_seed[cur]).any()):
            raise RuntimeError("chain2aln: a region past the read's rows")
        crow = chains.chain_rows[c]
        reg_c[row] = torch.stack([rb_f, re_f, crow[:, 3]], dim=1)
        reg_i[row] = torch.stack(
            [qb_f, qe_f, score, truesc, torch.maximum(aw0, aw1), seedcov, ln,
             crow[:, 0]], dim=1).to(i32)
        nreg[cur] += 1
        tc[cur] += 1
    return Regions(reg_c, reg_i, nreg.to(i32), lay.seed_off, work, counts)



class _Lockstep:
    """``chain2aln_split_torch``'s state over one batch: the chains'
    windows and seed order, the region table (a row for each seed row,
    where a read's regions go, then as many scratch rows, where a chain
    that runs alone writes its own from its first seed row on) with each
    region's extension counts (jobs, cells, rows), and the ``alive`` flag
    of each srt position."""

    def __init__(self, ctg, ref, chains, lay, qseq, qlen, p, mat, t_cap):
        dev = chains.seed_rows.device
        Ns = chains.seed_rows.shape[0]
        self.ref, self.chains, self.lay, self.qseq = ref, chains, lay, qseq
        self.p, self.mat, self.t_cap, self.Ns = p, mat.to(torch.int32), t_cap, Ns
        self.ql64 = qlen.long()
        self.r0, self.r1, self.perm, self.c_of = chain_windows(
            ctg, chains, lay, qlen, p)
        # task t of a unit stands at seed row g = its first row + t: its
        # chain's seeds from the end of srt down
        g_all = torch.arange(Ns, device=dev)
        cso = lay.chain_seed_off[self.c_of]
        self.task_pos = 2 * cso + lay.ns[self.c_of] - 1 - g_all
        self.chain_end = cso + lay.ns[self.c_of]  # by row: its chain's srt end
        self.reg_c = torch.zeros((2 * Ns, 3), dtype=torch.int64, device=dev)
        self.reg_i = torch.zeros((2 * Ns, 8), dtype=torch.int32, device=dev)
        self.reg_w = torch.zeros((2 * Ns, 3), dtype=torch.int64, device=dev)
        self.alive = torch.ones(Ns, dtype=torch.bool, device=dev)

    def held(self, rb, qb, ln, ql, rows, valid):
        """mem_chain2aln's containment test of each seed (rb, qb, ln [n, 1])
        against the regions at table rows ``rows`` [n, R] where ``valid``:
        [n] whether any holds it."""
        pc, pi = self.reg_c[rows], self.reg_i[rows].long()
        p_rb, p_re, p_qb, p_qe = pc[..., 0], pc[..., 1], pi[..., 0], pi[..., 1]
        p_w, p_sl0 = pi[..., 4], pi[..., 6]
        ok = (valid & (rb >= p_rb) & (rb + ln <= p_re) & (qb >= p_qb)
              & (qb + ln <= p_qe)
              & ~((ln - p_sl0).double() > 0.1 * ql.double()))
        hit = torch.zeros_like(ok)
        for qd, rd in ((qb - p_qb, rb - p_rb),
                       (p_qe - (qb + ln), p_re - (rb + ln))):
            w = torch.minimum(max_gap(torch.minimum(qd, rd), self.p), p_w)
            hit |= (qd - rd < w) & (rd - qd < w)
        return (ok & hit).any(dim=1)

    def differs(self, pos, end, rb, qb, ln):
        """Whether a live seed of the chain after srt position ``pos`` (up
        to ``end``) argues for another alignment than the seed (rb, qb, ln);
        all [n, 1]."""
        dev = pos.device
        M = int((end - pos - 1).max()) if pos.numel() else 0
        if M <= 0:
            return torch.zeros(pos.shape[0], dtype=torch.bool, device=dev)
        p2 = pos + 1 + torch.arange(M, device=dev)
        m = p2 < end
        p2 = p2.clamp(max=self.Ns - 1)
        t = self.perm[p2]
        sr = self.chains.seed_rows
        t_rb, t_qb, t_ln = sr[t, 0], sr[t, 1], sr[t, 2]
        big = ~(t_ln.double() < ln.double() * 0.95)
        c1 = ((qb <= t_qb) & (qb + ln - t_qb >= (ln >> 2))
              & (t_qb - qb != t_rb - rb))
        c2 = ((t_qb <= qb) & (t_qb + t_ln - qb >= (ln >> 2))
              & (qb - t_qb != rb - t_rb))
        return (m & self.alive[p2] & big & (c1 | c2)).any(dim=1)

    def run(self, row, n, reg, nreg, cap, read, soft, own=None, own_ext=None):
        """Units in lockstep, a task a unit a wave.  Unit u's tasks are the
        seed rows ``row[u] ..`` ``+ n[u]`` (a read's chains, or one chain);
        its regions and their counts go after the ``nreg[u]`` it has at table
        row ``reg[u]``, at most ``cap[u]`` in all; ``read[u]`` is its read.
        Where ``own[u]`` >= 0 the unit is one chain run again after its own
        run, whose regions start at table row ``own[u]`` and whose decisions
        ``own_ext`` holds by srt position: a seed both runs extend takes the
        own run's region and counts.  Returns the units' region counts, their
        work [U, 6], the units of ``soft`` that stopped on a seed outside
        the window or at ``cap`` (any other unit raises there), the units
        that decided a seed otherwise than their own runs, and the cells of
        own extensions they pruned."""
        p, sr, dev = self.p, self.chains.seed_rows, row.device
        i32, i64 = torch.int32, torch.int64
        U, L = row.shape[0], self.qseq.shape[1]
        n, nreg = n.clone(), nreg.clone()
        if own is None:
            own = torch.full((U,), -1, dtype=i64, device=dev)
        again = own >= 0
        work = torch.zeros((U, 6), dtype=i64, device=dev)
        failed = torch.zeros(U, dtype=torch.bool, device=dev)
        changed = torch.zeros(U, dtype=torch.bool, device=dev)
        wasted = torch.zeros(U, dtype=i64, device=dev)
        tc = torch.zeros(U, dtype=i64, device=dev)
        nxt = torch.zeros(U, dtype=i64, device=dev)  # the own run's next region

        def was_extended(idx, pos):
            if own_ext is None:
                return torch.zeros(idx.numel(), dtype=torch.bool, device=dev)
            return again[idx] & own_ext[pos]

        def pruned(idx):
            g = row[idx] + tc[idx]
            pos = self.task_pos[g]
            s = self.perm[pos]
            rb, qb, ln = sr[s, 0, None], sr[s, 1, None], sr[s, 2, None]
            R = int(nreg[idx].max())
            if R == 0:
                return torch.zeros(idx.numel(), dtype=torch.bool, device=dev)
            rr = torch.arange(R, device=dev)
            out = self.held(rb, qb, ln, self.ql64[read[idx], None],
                            (reg[idx, None] + rr).clamp(max=2 * self.Ns - 1),
                            rr < nreg[idx, None])
            ci = out.nonzero().squeeze(1)
            if ci.numel():
                out[ci[self.differs(pos[ci, None], self.chain_end[g[ci], None],
                                    rb[ci], qb[ci], ln[ci])]] = False
            return out

        def extend(idx, q_at, t_at, ql, tl, h0, prev, bonus):
            """One side's jobs of the units ``idx``: query base j of a job is
            ``qseq[read, q_at(j)]``, target base i is position ``t_at(i)``."""
            jq = torch.arange(max(int(ql.max()), 1), device=dev)
            jt = torch.arange(max(int(tl.max()), 1), device=dev)
            qa = self.qseq[read[idx][:, None], q_at(jq).clamp(0, L - 1)]
            ta = ref_codes(self.ref, t_at(jt))

            def ext(sel, ql_, tl_, h0_, w_):
                return ksw_extend_torch(
                    qa[sel], ta[sel], ql_.to(i32), tl_.to(i32), h0_.to(i32),
                    w_.to(i32), torch.full_like(ql_, bonus, dtype=i32),
                    self.mat, p.o_del, p.e_del, p.o_ins, p.e_ins, p.zdrop,
                    p.max_sc, count=True)

            res, aw = _retry(ext, ql, tl, h0, prev, p)
            return {k: v.long() for k, v in res.items()}, aw

        while True:
            # each unit's next task that is not pruned
            cand = (tc < n).nonzero().squeeze(1)
            while cand.numel():
                dead = cand[pruned(cand)]
                pos = self.task_pos[row[dead] + tc[dead]]
                self.alive[pos] = False
                lost = dead[was_extended(dead, pos)]
                changed[lost] = True
                wasted[lost] += self.reg_w[own[lost] + nxt[lost], 1]
                nxt[lost] += 1
                tc[dead] += 1
                work[dead, W_PRUNED] += 1
                cand = dead[tc[dead] < n[dead]]
            cur = (tc < n).nonzero().squeeze(1)
            if not cur.numel():
                break
            g = row[cur] + tc[cur]
            s = self.perm[self.task_pos[g]]
            c = self.c_of[g]
            rb, qb, ln = sr[s, 0], sr[s, 1], sr[s, 2]
            out = (rb < self.r0[c]) | (rb + ln > self.r1[c])
            full = nreg[cur] >= cap[cur]
            for bad, msg in ((out, "a seed lies outside its chain's window"),
                             (full, "a region past the read's rows")):
                if bool((bad & ~soft[cur]).any()):
                    raise RuntimeError(f"chain2aln: {msg}")
            stop = out | full
            if bool(stop.any()):
                failed[cur[stop]] = True
                n[cur[stop]] = tc[cur[stop]]
                keep = ~stop
                cur, g, c, rb, qb, ln = (cur[keep], g[keep], c[keep], rb[keep],
                                         qb[keep], ln[keep])
                if not cur.numel():
                    continue
            work[cur, W_TASKS] += 1
            work[cur, W_REF_T] |= (self.r1[c] - self.r0[c] > self.t_cap).long()
            at = reg[cur] + nreg[cur]
            # a seed both runs extend: the own run's region and counts
            use = was_extended(cur, self.task_pos[g])
            if bool(use.any()):
                src = own[cur[use]] + nxt[cur[use]]
                self.reg_c[at[use]] = self.reg_c[src]
                self.reg_i[at[use]] = self.reg_i[src]
                work[cur[use], W_JOBS] += self.reg_w[src, 0]
                work[cur[use], W_CELLS] += self.reg_w[src, 1]
                work[cur[use], W_ROWS] += self.reg_w[src, 2]
                nxt[cur[use]] += 1
            nreg[cur] += 1
            tc[cur] += 1
            changed[cur[again[cur] & ~use]] = True
            keep = ~use
            cur, c, at, rb, qb, ln = (cur[keep], c[keep], at[keep], rb[keep],
                                      qb[keep], ln[keep])
            if not cur.numel():
                continue
            ql = self.ql64[read[cur]]
            m = cur.numel()
            dw = torch.zeros((m, 3), dtype=i64, device=dev)  # jobs cells rows
            aw0 = torch.full((m,), p.w, dtype=i64, device=dev)
            aw1 = aw0.clone()
            # left extension on the reversed prefix
            score = ln * p.a
            truesc, qb_f, rb_f = score.clone(), torch.zeros_like(qb), rb.clone()
            li = (qb > 0).nonzero().squeeze(1)
            if li.numel():
                res, aw0[li] = extend(
                    cur[li], lambda j: qb[li, None] - 1 - j,
                    lambda i: rb[li, None] - 1 - i, qb[li],
                    rb[li] - self.r0[c[li]], score[li],
                    torch.full_like(li, -1), p.pen_clip5)
                dw[li] += torch.stack([1 + (aw0[li] > p.w).long(), res["cells"],
                                       res["rows"]], dim=1)
                loc = ((res["gscore"] <= 0)
                       | (res["gscore"] <= res["score"] - p.pen_clip5))
                score[li] = res["score"]
                qb_f[li] = torch.where(loc, qb[li] - res["qle"], 0)
                rb_f[li] = rb[li] - torch.where(loc, res["tle"], res["gtle"])
                truesc[li] = torch.where(loc, res["score"], res["gscore"])
            # right extension
            qe, re0 = qb + ln, rb + ln
            qe_f, re_f = ql.clone(), re0.clone()
            ri = (qe != ql).nonzero().squeeze(1)
            if ri.numel():
                sc0 = score[ri]
                res, aw1[ri] = extend(
                    cur[ri], lambda j: qe[ri, None] + j,
                    lambda i: re0[ri, None] + i, ql[ri] - qe[ri],
                    self.r1[c[ri]] - re0[ri], sc0, sc0, p.pen_clip3)
                dw[ri] += torch.stack([1 + (aw1[ri] > p.w).long(), res["cells"],
                                       res["rows"]], dim=1)
                loc = ((res["gscore"] <= 0)
                       | (res["gscore"] <= res["score"] - p.pen_clip3))
                score[ri] = res["score"]
                qe_f[ri] = torch.where(loc, qe[ri] + res["qle"], ql[ri])
                re_f[ri] = re0[ri] + torch.where(loc, res["tle"], res["gtle"])
                truesc[ri] += torch.where(loc, res["score"], res["gscore"]) - sc0
            work[cur, W_JOBS] += dw[:, 0]
            work[cur, W_CELLS] += dw[:, 1]
            work[cur, W_ROWS] += dw[:, 2]
            # seedcov over the chain's seeds, then the region
            lay = self.lay
            cs = lay.chain_seed_off[c, None] + torch.arange(
                int(lay.ns[c].max()), device=dev)
            inside = cs < (lay.chain_seed_off[c] + lay.ns[c])[:, None]
            cs = cs.clamp(max=self.Ns - 1)
            t_rb, t_qb, t_ln = sr[cs, 0], sr[cs, 1], sr[cs, 2]
            inside &= ((t_qb >= qb_f[:, None]) & (t_qb + t_ln <= qe_f[:, None])
                       & (t_rb >= rb_f[:, None]) & (t_rb + t_ln <= re_f[:, None]))
            seedcov = torch.where(inside, t_ln, 0).sum(dim=1)
            crow = self.chains.chain_rows[c]
            self.reg_c[at] = torch.stack([rb_f, re_f, crow[:, 3]], dim=1)
            self.reg_i[at] = torch.stack(
                [qb_f, qe_f, score, truesc, torch.maximum(aw0, aw1), seedcov,
                 ln, crow[:, 0]], dim=1).to(i32)
            self.reg_w[at] = dw
        return nreg, work, failed, changed, wasted


def _add_work(row, w):
    """A chain's work counts into its read's row: sums, but the window
    mark is an or."""
    ref_t = row[W_REF_T] | w[W_REF_T]
    row += w
    row[W_REF_T] = ref_t


def chain2aln_split_torch(ctg: DeviceContigs, ref: DeviceRef, chains: Chains,
                          qseq, qlen, run, params: ExtendParams, mat,
                          t_cap: int = NO_T_CAP, split=None) -> Regions:
    """``chain2aln_torch``'s results, with the reads of ``split`` ([B] bool,
    as ``split_reads`` gives it) run as the loop kernel runs them: each of
    their chains alone against its own regions, then the read committed
    chain by chain in bwa's order, each chain's decisions taken again
    against the read's earlier regions with its own run's extension of
    every seed both runs extend.  The CPU mirror of the kernel's chain
    items; the other reads run whole."""
    _check(ctg, ref, chains, qseq, qlen, run)
    dev = chains.seed_rows.device
    i32, i64 = torch.int32, torch.int64
    B, Ns = qlen.shape[0], chains.seed_rows.shape[0]
    lay = _layout(chains)
    ok = run.bool()
    split = (torch.zeros(B, dtype=torch.bool, device=dev) if split is None
             else split.bool() & ok)
    counts = _split_counts(chains, run)
    if not Ns:
        z = torch.zeros(B, dtype=i64, device=dev)
        return Regions(torch.zeros((0, 3), dtype=i64, device=dev),
                       torch.zeros((0, 8), dtype=i32, device=dev), z.to(i32),
                       lay.seed_off, torch.zeros((B, 6), dtype=i64, device=dev),
                       counts)
    st = _Lockstep(ctg, ref, chains, lay, qseq, qlen, params, mat, t_cap)
    # whole reads, and each chain of a split read alone into its scratch rows
    cs = split[lay.chain_read.long()].nonzero().squeeze(1)
    ns = lay.ns[cs]
    zB = torch.zeros(B, dtype=i64, device=dev)
    nreg, work, failed, _, _ = st.run(
        torch.cat([lay.seed_off, lay.chain_seed_off[cs]]),
        torch.cat([torch.where(ok & ~split, chains.n_seed, 0), ns]),
        torch.cat([lay.seed_off, Ns + lay.chain_seed_off[cs]]),
        torch.cat([zB, torch.zeros_like(ns)]),
        torch.cat([chains.n_seed, ns]),
        torch.cat([torch.arange(B, device=dev), lay.chain_read[cs].long()]),
        torch.cat([torch.zeros(B, dtype=torch.bool, device=dev),
                   torch.ones_like(ns, dtype=torch.bool)]))
    own_ok = torch.zeros(lay.ns.shape[0], dtype=torch.bool, device=dev)
    own_ok[cs] = ~failed[B:]
    own_ext = st.alive.clone()  # the own runs' decisions, by srt position
    nreg, work = nreg[:B].clone(), work[:B].clone()
    counts[1], counts[2] = split.sum(), cs.numel()
    # commit the split reads: each chain run again after the read's earlier
    # regions, taking its own run's extensions; a chain a read a round
    rb = split.nonzero().squeeze(1)
    nxt = lay.chain_off[rb].clone()
    end = nxt + chains.n_chain[rb]
    while rb.numel():
        for ci in nxt.tolist():
            so = int(lay.chain_seed_off[ci])
            st.alive[so: so + int(lay.ns[ci])] = True
        n2, w2, _, changed, wasted = st.run(
            lay.chain_seed_off[nxt], lay.ns[nxt], lay.seed_off[rb], nreg[rb],
            chains.n_seed[rb], rb, torch.zeros_like(rb, dtype=torch.bool),
            torch.where(own_ok[nxt], Ns + lay.chain_seed_off[nxt], -1), own_ext)
        nreg[rb] = n2
        for k, b in enumerate(rb.tolist()):
            _add_work(work[b], w2[k])
        counts[3] += (changed | ~own_ok[nxt]).sum()
        counts[4] += wasted.sum()
        nxt += 1
        more = nxt < end
        rb, nxt, end = rb[more], nxt[more], end[more]
    return Regions(st.reg_c[:Ns], st.reg_i[:Ns], nreg.to(i32), lay.seed_off,
                   work, counts)


# ------------------------------------------------------------------- kernels

def _bind(lib):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    opts = [i32] * 10  # ExtendParams, in field order
    lib.bwamem_chain2aln_prep_launch.restype = ctypes.c_int
    lib.bwamem_chain2aln_prep_launch.argtypes = (
        [p] * 5 + [i64] + [p, p, i32, i64] + opts + [p] * 4)
    lib.bwamem_chain2aln_launch.restype = ctypes.c_int
    lib.bwamem_chain2aln_launch.argtypes = (
        [p] * 13 + [i64, p, i32, i32, p, i64, p] + opts + [i64, p, i32]
        + [p] * 12 + [p])
    lib.bwamem_chain2aln_warps_per_sm.restype = ctypes.c_int
    lib.bwamem_chain2aln_warps_per_sm.argtypes = [i32]
    lib.bwamem_chain2aln_max_qlen.restype = ctypes.c_int
    lib.bwamem_chain2aln_max_qlen.argtypes = []
    lib.bwamem_band_width_launch.restype = ctypes.c_int
    lib.bwamem_band_width_launch.argtypes = [p, p, p, i32] + [i32] * 5 + [p, p]


def _lib():
    from ..utils import cudabuild

    return cudabuild.load("chain2aln", _bind)


def _launched(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    if name in LAUNCHES:
        LAUNCHES[name] += 1
        tally()["chain2aln"] += 1


def _opts(p: ExtendParams):
    return (p.a, p.o_del, p.e_del, p.o_ins, p.e_ins, p.zdrop, p.w, p.pen_clip5,
            p.pen_clip3, p.max_sc)


# The *_launch functions launch a kernel on prepared operands (as
# ``chain2aln_cuda`` prepares them: contiguous, typed, on the card; outputs,
# scratch and the int32 [1] flag word allocated by the caller) and leave the
# flags for the caller to read.

def chain2aln_prep_launch(ctg, chains: Chains, lay: _Layout, qlen, p, rmax, srt,
                          err):
    """Per chain ``rmax`` [Nc, 2] int64 and its seed order ``srt`` [Ns]
    int32 (indices within the chain, ascending by (score, index))."""
    with on_device(ctg.device):
        _launched("chain2aln_prep", _lib().bwamem_chain2aln_prep_launch(
            chains.chain_rows.data_ptr(), chains.seed_rows.data_ptr(),
            lay.chain_seed_off.data_ptr(), lay.chain_read.data_ptr(),
            qlen.data_ptr(), chains.chain_rows.shape[0], ctg.ctg_end.data_ptr(),
            ctg.ctg_off.data_ptr(), ctg.ctg_end.numel(), ctg.l_pac, *_opts(p),
            rmax.data_ptr(), srt.data_ptr(), err.data_ptr(),
            stream(ctg.device)))


def split_reads(n_seed, n_chain, qlen, run, warps: int) -> torch.Tensor:
    """The reads whose chains the loop kernel runs on many warps, [B] bool:
    those of ``run`` with two chains or more whose work estimate (``n_seed
    x qlen``, as ``work_items`` orders them) is above the batch's total over
    ``SPLIT_LINE`` times the kernel's resident ``warps``: such a read would
    outlast the card's fair share of the batch on one warp."""
    ok = run.bool()
    est = torch.where(ok, n_seed.long() * qlen.long(), 0)
    return ok & (n_chain >= 2) & (est * (SPLIT_LINE * warps) > est.sum())


def work_items(n_seed, qlen, run, chain_read, split) -> torch.Tensor:
    """The loop kernel's work items, heaviest first by ``n_seed x qlen``,
    int32: read b as b, chain ci of a read of ``split`` ([B] bool) as B + ci
    (a split read's chains in order, at its read's rank), and last a -1 for
    each split read; B + the split reads' chains items, so B where no read
    splits.  Reads left out of ``run`` come after the rest (the kernel
    still writes their counts).  Scheduling only: no result depends on it.
    One copy to the host (the split reads' chains)."""
    est = torch.where(run.bool(), n_seed.long() * qlen.long(), -1)
    split = split.bool()
    ci = split[chain_read.long()].nonzero().squeeze(1)
    if not ci.numel():
        return torch.sort(est, descending=True, stable=True).indices.to(torch.int32)
    B = est.shape[0]
    key = torch.cat([torch.where(split, -2, est), est[chain_read[ci].long()]])
    idx = torch.sort(key, descending=True, stable=True).indices
    item = torch.where(idx < B, idx, B + ci[(idx - B).clamp(min=0)])
    return torch.where(key[idx] == -2, -1, item).to(torch.int32)


def kernel_max_qlen(mat, device) -> int:
    """The longest read that the loop kernel runs on ``device`` with the
    scores ``mat``: ``MAX_QLEN`` bases, (qlen + 1) x the largest score below
    ``MAX_H`` (every H of a job lies below it), and on a card the warps'
    slices of shared memory within what the card allows a block.  Raises
    for scores outside [-128, 127] (int8, as the host ksw takes them).  The
    plain version has no such limit; ``regs_batch_fused`` sends longer reads
    to the staged path, whichever device runs it."""
    lo, hi = int(mat.min()), int(mat.max())
    if lo < -128 or hi > 127:
        raise ValueError("chain2aln: the loop kernel takes scores in [-128, 127]")
    Q = min(MAX_QLEN, (MAX_H - 1) // max(hi, 1) - 1)
    device = torch.device(device)
    if device.type == "cuda":
        with on_device(device):
            fit = int(_lib().bwamem_chain2aln_max_qlen())
        if fit < 0:
            raise RuntimeError("chain2aln: could not read the card's shared "
                               "memory a block")
        Q = min(Q, fit)
    return Q


def kernel_query_len(qlen, run, mat) -> int:
    """The longest read that the loop kernel runs (its shared memory is
    sized from it), after checking it against ``kernel_max_qlen`` on the
    reads' device.  One copy to the host."""
    Q = int(torch.where(run.bool(), qlen.long(), 0).max())
    limit = kernel_max_qlen(mat, qlen.device)
    if Q > limit:
        raise ValueError(f"chain2aln: a read of {Q} bases exceeds the loop "
                         f"kernel's limit of {limit} bases here")
    return Q


def chain2aln_launch(ref, chains: Chains, lay: _Layout, n_chain, n_seed,
                     chain_off, seed_off, rmax, srt, alive, run, qseq, qlen,
                     mat, p, t_cap, order, Q, reg_c, reg_i, nregs, work, err,
                     stats=None):
    """The loop kernel on the reads of the per-read operands (``n_chain``,
    ``n_seed``, ``chain_off``, ``seed_off``, ``run`` uint8, ``qseq``,
    ``qlen``, all of one length B), the warps taking the work items of
    ``order`` (``work_items``); ``Q`` (``kernel_query_len``) bounds the reads
    it runs.  Where ``order`` holds chain items (it is longer than B then
    only), the launcher allocates their scratch, and the kernel adds the
    chains its commits decided otherwise than their own runs and those runs'
    discarded band cells to ``stats`` (int64 [2], where given)."""
    B, dev = qseq.shape[0], qseq.device
    i32, i64 = torch.int32, torch.int64
    # the warps' item counter, which the launcher zeroes
    nxt = torch.empty(1, dtype=i32, device=dev)
    if stats is None:
        stats = torch.zeros(2, dtype=i64, device=dev)
    scratch = [0] * 5
    if order.numel() > B:
        Nc, Ns = chains.chain_rows.shape[0], chains.seed_rows.shape[0]
        scratch = [torch.empty((Ns, 3), dtype=i64, device=dev),
                   torch.empty((Ns, 8), dtype=i32, device=dev),
                   torch.empty((Ns, 3), dtype=i64, device=dev),
                   torch.empty(Nc, dtype=torch.uint8, device=dev),
                   torch.zeros(B, dtype=i32, device=dev)]
    with on_device(dev):
        _launched("chain2aln", _lib().bwamem_chain2aln_launch(
            chains.chain_rows.data_ptr(), chains.seed_rows.data_ptr(),
            chain_off.data_ptr(), n_chain.data_ptr(), seed_off.data_ptr(),
            n_seed.data_ptr(), lay.chain_seed_off.data_ptr(),
            lay.chain_read.data_ptr(), rmax.data_ptr(), srt.data_ptr(),
            alive.data_ptr(), run.data_ptr(), qseq.data_ptr(), qseq.stride(0),
            qlen.data_ptr(), B, Q, ref.pac.data_ptr(), ref.l_pac,
            mat.data_ptr(), *_opts(p), t_cap, order.data_ptr(), order.numel(),
            nxt.data_ptr(), reg_c.data_ptr(), reg_i.data_ptr(),
            nregs.data_ptr(), work.data_ptr(),
            *(s if isinstance(s, int) else s.data_ptr() for s in scratch),
            stats.data_ptr(), err.data_ptr(), stream(dev)))


def warps_per_sm(Q: int, device="cuda") -> int:
    """Warps of the loop kernel resident on one SM of ``device`` when it
    runs reads of up to ``Q`` bases (the CUDA occupancy calculator's
    figure); -1 when the card refuses the shared memory that takes."""
    with on_device(device):
        return int(_lib().bwamem_chain2aln_warps_per_sm(Q))


@functools.lru_cache(maxsize=None)
def _resident_warps(Q: int, index: int) -> int:
    dev = torch.device("cuda", index)
    return (warps_per_sm(Q, dev)
            * torch.cuda.get_device_properties(dev).multi_processor_count)


def resident_warps(Q: int, device) -> int:
    """The loop kernel's warps resident on the whole card ``device`` for
    reads of up to ``Q`` bases (``warps_per_sm`` x its SMs), the figure
    ``split_reads`` takes; asked of the card once a card and Q."""
    device = torch.device(device)
    index = device.index
    return _resident_warps(Q, torch.cuda.current_device() if index is None
                           else index)


def prepare(ctg: DeviceContigs, ref: DeviceRef, chains: Chains, qseq, qlen, run):
    """The operands as the kernels take them (contiguous, typed, on the
    contig tables' card) and the layout of ``chains``."""
    if ctg.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernels need tensors on the card, not {ctg.device}")
    _check(ctg, ref, chains, qseq, qlen, run)
    if qseq.device != ctg.device:
        raise ValueError(f"expected tensors on {ctg.device}, got {qseq.device}")
    chains = chains._replace(
        chain_rows=chains.chain_rows.to(torch.int64).contiguous(),
        seed_rows=chains.seed_rows.to(torch.int64).contiguous(),
        n_chain=chains.n_chain.to(torch.int64).contiguous(),
        n_seed=chains.n_seed.to(torch.int64).contiguous())
    return (chains, _layout(chains), qseq.contiguous(),
            qlen.to(torch.int32).contiguous(),
            run.to(torch.uint8).contiguous())


def raise_flags(err: int):
    if err & ERR_CONTIG:
        raise RuntimeError("chain2aln: a chain's first seed lies in no contig")
    if err & ERR_WINDOW:
        raise RuntimeError("chain2aln: a seed lies outside its chain's window")
    if err & ERR_ROWS:
        raise RuntimeError("chain2aln: a region past the read's rows")


def chain2aln_cuda(ctg: DeviceContigs, ref: DeviceRef, chains: Chains, qseq,
                   qlen, run, params: ExtendParams, mat,
                   t_cap: int = NO_T_CAP, split=None) -> Regions:
    """The chain2aln kernels; same contract as ``chain2aln_torch``.  The
    reads whose chains run on many warps are ``split`` where given, else
    ``split_reads`` of the batch at the loop kernel's resident warps on this
    card."""
    chains, lay, qseq, qlen, run = prepare(ctg, ref, chains, qseq, qlen, run)
    dev = ctg.device
    i32, i64 = torch.int32, torch.int64
    B = qseq.shape[0]
    Nc, Ns = chains.chain_rows.shape[0], chains.seed_rows.shape[0]
    reg_c = torch.zeros((Ns, 3), dtype=i64, device=dev)
    reg_i = torch.zeros((Ns, 8), dtype=i32, device=dev)
    nregs = torch.zeros(B, dtype=i32, device=dev)
    work = torch.zeros((B, 6), dtype=i64, device=dev)
    counts = torch.zeros(len(SPLIT_COUNTS), dtype=i64, device=dev)
    if not (B and Nc):
        return Regions(reg_c, reg_i, nregs, lay.seed_off, work, counts)
    rmax = torch.empty((Nc, 2), dtype=i64, device=dev)
    srt = torch.empty(Ns, dtype=i32, device=dev)
    alive = torch.empty(Ns, dtype=torch.uint8, device=dev)
    err = torch.zeros(1, dtype=i32, device=dev)
    mat = mat.to(i32).contiguous()
    if mat.numel() != 25 or mat.device != dev:
        raise ValueError("mat must be [5, 5] on the card")
    Q = kernel_query_len(qlen, run, mat)
    if split is None:
        split = split_reads(chains.n_seed, chains.n_chain, qlen, run,
                            resident_warps(Q, dev))
    split = split.to(dev).bool() & run.bool()
    counts[:3] = torch.stack([torch.where(run.bool(), chains.n_chain, 0).sum(),
                              split.sum(),
                              torch.where(split, chains.n_chain, 0).sum()])
    items = work_items(chains.n_seed, qlen, run, lay.chain_read, split)
    chain2aln_prep_launch(ctg, chains, lay, qlen, params, rmax, srt, err)
    chain2aln_launch(ref, chains, lay, chains.n_chain, chains.n_seed,
                     lay.chain_off, lay.seed_off, rmax, srt, alive, run, qseq,
                     qlen, mat, params, t_cap, items, Q, reg_c, reg_i, nregs,
                     work, err, counts[3:])
    raise_flags(int(err.item()))
    return Regions(reg_c, reg_i, nregs, lay.seed_off, work, counts)


def band_width_cuda(qlen, w, end_bonus, max_sc: int, o_del: int, e_del: int,
                    o_ins: int, e_ins: int) -> torch.Tensor:
    """``ksw_band_width`` of csrc/extend.cuh (the band preamble the loop
    kernel computes per job) on int32 CUDA tensors, to hold it against
    ``ops.extend.band_width``."""
    if qlen.device.type != "cuda":
        raise ValueError(f"band_width_cuda needs CUDA tensors, got {qlen.device}")
    args = [x.to(torch.int32).contiguous() for x in (qlen, w, end_bonus)]
    out = torch.empty_like(args[0])
    with on_device(qlen.device):
        _launched("band_width", _lib().bwamem_band_width_launch(
            *(x.data_ptr() for x in args), args[0].numel(), max_sc, o_del, e_del,
            o_ins, e_ins, out.data_ptr(), stream(qlen.device)))
    return out


# ---------------------------------------------------------------- dispatcher

def chain2aln(ctg: DeviceContigs, ref: DeviceRef, chains: Chains, qseq, qlen,
              run, params: ExtendParams, mat, t_cap: int = NO_T_CAP,
              split=None) -> Regions:
    """CPU tensors -> ``chain2aln_torch``; CUDA tensors -> the kernels."""
    fn = chain2aln_cuda if qseq.device.type == "cuda" else chain2aln_torch
    return fn(ctg, ref, chains, qseq, qlen, run, params, mat, t_cap, split)

