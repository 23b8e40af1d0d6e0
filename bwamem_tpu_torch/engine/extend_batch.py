"""Wave-batched chain extension on the port's device.

The counterpart of bwamem_tpu/engine/extend_batch.py: every read's (chain,
seed) tasks advance in lockstep, one task per read per wave, and each wave's
banded extensions run as one batch.  Per-read seed order, contained-seed
pruning (``_prune``) and band-doubling retries are the reference's; the
wave runner and the two functions that call it are the port's own.  A wave of at least
``exec_cfg.min_device_jobs`` jobs goes to the device kernel
(``ops.extend.ksw_extend_batch_np``; with ``exec_cfg.mesh``,
``ksw_extend_batch_mesh``, the jobs split over the mesh's devices), a
smaller one to the host C++ ``native_ksw`` (or the Python oracle without
it).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..api.options import MemOptions
from ..ops import extend as ext
from ..ops.extend import ksw_extend_batch_np
from ..utils import metrics as _metrics
from ..utils.cudabuild import tally
from . import exec_ctx, native_ksw
from .chain import Chain
from .exec_ctx import ExecConfig
from .extend import MAX_BAND_TRY, AlnReg, ksw_extend2
from ..parallel.mesh import replicate
from .state import device_scoring


class WaveStats:
    """Counts of extension jobs and waves by where they ran (and of the
    device jobs, those that the kernel ran on its scalar path), the host-clock
    seconds spent in each kind of wave (a device wave's include packing, the
    copies and the kernel), and, only under ``exec_ctx.KEEP_LARGEST``, the
    largest device wave's inputs (so a benchmark can time the kernel on
    it)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.device_extend_jobs = 0
        self.device_scalar_jobs = 0
        self.host_extend_jobs = 0
        self.device_extend_waves = 0
        self.host_extend_waves = 0
        self.device_wave_seconds = 0.0
        self.host_wave_seconds = 0.0
        self.largest_wave = None  # (jobs, h0s, ws, bonuses)

    def device_share(self) -> float:
        n = self.device_extend_jobs + self.host_extend_jobs
        return self.device_extend_jobs / n if n else 0.0


STATS = WaveStats()


@dataclass
class _Task:
    chain: Chain
    ci: int  # chain index within the read (identity, not value equality)
    seed_idx: int  # index into chain.seeds
    srt_pos: int  # position in the chain's srt order (for overlap checks)


@dataclass
class _ReadState:
    query: np.ndarray
    chains: List[Chain]
    tasks: List[_Task] = field(default_factory=list)
    task_i: int = 0
    regs: List[AlnReg] = field(default_factory=list)
    # per-chain prep
    rmax: dict = field(default_factory=dict)  # chain id -> (rmax0, rmax1)
    rseq: dict = field(default_factory=dict)
    srt: dict = field(default_factory=dict)
    srt_alive: dict = field(default_factory=dict)


def _prep_read(opt: MemOptions, idx, query: np.ndarray, chains: List[Chain]) -> _ReadState:
    st = _ReadState(query=query, chains=chains)
    qlen = len(query)
    bns = idx.bns
    l_pac = bns.l_pac
    for ci, c in enumerate(chains):
        if not c.seeds:
            continue
        rmax0, rmax1 = l_pac << 1, 0
        for t in c.seeds:
            b = t.rbeg - (t.qbeg + opt.max_gap(t.qbeg))
            e = t.rbeg + t.len + (
                (qlen - t.qbeg - t.len) + opt.max_gap(qlen - t.qbeg - t.len)
            )
            rmax0 = min(rmax0, b)
            rmax1 = max(rmax1, e)
        rmax0 = max(rmax0, 0)
        rmax1 = min(rmax1, l_pac << 1)
        if rmax0 < l_pac < rmax1:
            if c.seeds[0].rbeg < l_pac:
                rmax1 = l_pac
            else:
                rmax0 = l_pac
        fwd_mid, is_rev = bns.depos(c.seeds[0].rbeg)
        rid = bns.pos_to_rid(fwd_mid)
        far_beg = bns.anns[rid].offset
        far_end = far_beg + bns.anns[rid].length
        if is_rev:
            far_beg, far_end = (l_pac << 1) - far_end, (l_pac << 1) - far_beg
        rmax0 = max(rmax0, far_beg)
        rmax1 = min(rmax1, far_end)
        st.rmax[ci] = (rmax0, rmax1)
        st.rseq[ci] = idx.get_seq(rmax0, rmax1)
        srt = sorted(range(len(c.seeds)), key=lambda i: (c.seeds[i].score, i))
        st.srt[ci] = srt
        st.srt_alive[ci] = [True] * len(srt)
        for pos in range(len(srt) - 1, -1, -1):
            st.tasks.append(_Task(chain=c, ci=ci, seed_idx=srt[pos], srt_pos=pos))
    # annotate chain index on tasks (chains processed in order; seeds of a
    # chain are contiguous because we appended per chain)
    return st


def _prune(opt: MemOptions, st: _ReadState, ci: int, task: _Task, qlen: int) -> bool:
    """The contained-seed pruning from chain2aln; True = skip extension."""
    c = task.chain
    s = c.seeds[task.seed_idx]
    contained = False
    for p in st.regs:
        if (
            s.rbeg < p.rb
            or s.rbeg + s.len > p.re
            or s.qbeg < p.qb
            or s.qbeg + s.len > p.qe
        ):
            continue
        if s.len - p.seedlen0 > 0.1 * qlen:
            continue
        qd, rd = s.qbeg - p.qb, s.rbeg - p.rb
        w = min(opt.max_gap(min(qd, rd)), p.w)
        if qd - rd < w and rd - qd < w:
            contained = True
            break
        qd, rd = p.qe - (s.qbeg + s.len), p.re - (s.rbeg + s.len)
        w = min(opt.max_gap(min(qd, rd)), p.w)
        if qd - rd < w and rd - qd < w:
            contained = True
            break
    if not contained:
        return False
    srt = st.srt[ci]
    alive = st.srt_alive[ci]
    k = task.srt_pos
    diff = False
    for i2 in range(k + 1, len(srt)):
        if not alive[i2]:
            continue
        t = c.seeds[srt[i2]]
        if t.len < s.len * 0.95:
            continue
        if (
            s.qbeg <= t.qbeg
            and s.qbeg + s.len - t.qbeg >= s.len >> 2
            and t.qbeg - s.qbeg != t.rbeg - s.rbeg
        ):
            diff = True
            break
        if (
            t.qbeg <= s.qbeg
            and t.qbeg + t.len - s.qbeg >= s.len >> 2
            and s.qbeg - t.qbeg != s.rbeg - t.rbeg
        ):
            diff = True
            break
    if not diff:
        alive[k] = False
        return True
    return False


def _host_wave(opt, jobs, bonuses, ws, h0s):
    if native_ksw.available():
        return native_ksw.extend_batch(
            jobs, opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            opt.zdrop, h0s, ws, bonuses,
        )
    out = []
    for (q, t), b, w, h0 in zip(jobs, bonuses, ws, h0s):
        r = ksw_extend2(q, t, opt.mat, opt.o_del, opt.e_del, opt.o_ins,
                        opt.e_ins, w, b, opt.zdrop, h0)
        out.append(dict(score=r.score, qle=r.qle, tle=r.tle, gtle=r.gtle,
                        gscore=r.gscore, max_off=r.max_off))
    return out


def _run_kernel(opt, jobs, bonuses, ws, h0s, exec_cfg: ExecConfig, scoring):
    """One batched ksw_extend2 wave; jobs = list of (qseq, tseq)."""
    n = len(jobs)
    t0 = time.perf_counter()
    _metrics.count("extend_waves")
    _metrics.count("extend_jobs", n)
    if n < exec_cfg.min_device_jobs:
        out = _host_wave(opt, jobs, bonuses, ws, h0s)
        STATS.host_extend_waves += 1
        STATS.host_extend_jobs += n
        STATS.host_wave_seconds += time.perf_counter() - t0
        return out
    scalar = tally()["extend_scalar"]
    run = ext.ksw_extend_batch_mesh if exec_cfg.mesh is not None else \
        ksw_extend_batch_np
    out = run([q for q, _ in jobs], [t for _, t in jobs], scoring, list(h0s),
              list(ws), list(bonuses))
    STATS.device_scalar_jobs += tally()["extend_scalar"] - scalar
    _metrics.count("device_extend_waves")
    _metrics.count("device_extend_jobs", n)
    STATS.device_extend_waves += 1
    STATS.device_extend_jobs += n
    STATS.device_wave_seconds += time.perf_counter() - t0
    if exec_ctx.KEEP_LARGEST and (STATS.largest_wave is None
                                  or n > len(STATS.largest_wave[0])):
        STATS.largest_wave = (list(jobs), list(h0s), list(ws), list(bonuses))
    return out


def _extend_side(opt, pend, side: str, exec_cfg: ExecConfig, scoring):
    """One direction's extensions, with band-doubling retries, for the
    pending (state, task, reg, qseq, tseq, h0) list."""
    if not pend:
        return
    bonus = opt.pen_clip5 if side == "left" else opt.pen_clip3
    todo = list(range(len(pend)))
    results = [None] * len(pend)
    aw = [opt.w] * len(pend)
    prev_score = [None] * len(pend)
    for attempt in range(MAX_BAND_TRY):
        if not todo:
            break
        jobs = [(pend[i][3], pend[i][4]) for i in todo]
        h0s = [pend[i][5] for i in todo]
        ws = [opt.w << attempt] * len(todo)
        res = _run_kernel(opt, jobs, [bonus] * len(todo), ws, h0s, exec_cfg,
                          scoring)
        nxt = []
        for i, r in zip(todo, res):
            aw[i] = opt.w << attempt
            keep_going = (
                attempt + 1 < MAX_BAND_TRY
                and r["score"] != prev_score[i]
                and r["max_off"] >= (aw[i] >> 1) + (aw[i] >> 2)
            )
            results[i] = r
            prev_score[i] = r["score"]
            if keep_going:
                nxt.append(i)
        todo = nxt
    for i, (st, task, a, qs, ts, h0) in enumerate(pend):
        r = results[i]
        s = task.chain.seeds[task.seed_idx]
        if side == "left":
            a.score = r["score"]
            if r["gscore"] <= 0 or r["gscore"] <= a.score - opt.pen_clip5:
                a.qb = s.qbeg - r["qle"]
                a.rb = s.rbeg - r["tle"]
                a.truesc = a.score
            else:
                a.qb = 0
                a.rb = s.rbeg - r["gtle"]
                a.truesc = r["gscore"]
            a._aw0 = aw[i]
        else:
            sc0 = h0
            a.score = r["score"]
            rmax0 = st.rmax[task.ci][0]
            qe = s.qbeg + s.len
            re_off = s.rbeg + s.len - rmax0
            if r["gscore"] <= 0 or r["gscore"] <= a.score - opt.pen_clip3:
                a.qe = qe + r["qle"]
                a.re = rmax0 + re_off + r["tle"]
                a.truesc += a.score - sc0
            else:
                a.qe = len(st.query)
                a.re = rmax0 + re_off + r["gtle"]
                a.truesc += r["gscore"] - sc0
            a._aw1 = aw[i]


def chain2aln_batch(opt, idx, reads: List[np.ndarray], chains_list,
                    exec_cfg: ExecConfig) -> List[List[AlnReg]]:
    """Extend every read's chains; regions per read, identical to the
    reference's sequential chain2aln loop.  With ``exec_cfg.mesh`` each
    device wave is split over the mesh (one scoring a mesh device)."""
    if exec_cfg.mesh is not None:
        scoring = replicate(exec_cfg.mesh, device_scoring, opt)
    else:
        scoring = device_scoring(opt, exec_cfg.device)
    states = [
        _prep_read(opt, idx, q, chains) for q, chains in zip(reads, chains_list)
    ]
    while True:
        # phase 1: each read's next unpruned task, and its left job
        left_pend = []
        current = []  # (state, task, reg) of the reads active this wave
        for st in states:
            qlen = len(st.query)
            task = None
            while st.task_i < len(st.tasks):
                t = st.tasks[st.task_i]
                st.task_i += 1
                if not _prune(opt, st, t.ci, t, qlen):
                    task = t
                    break
            if task is None:
                continue
            s = task.chain.seeds[task.seed_idx]
            a = AlnReg()
            a.w = opt.w
            a._aw0 = a._aw1 = opt.w
            a.score = a.truesc = -1
            a.rid = task.chain.rid
            rmax0, _ = st.rmax[task.ci]
            if s.qbeg:
                qs = st.query[: s.qbeg][::-1].copy()
                ts = st.rseq[task.ci][: s.rbeg - rmax0][::-1].copy()
                left_pend.append((st, task, a, qs, ts, s.len * opt.a))
            else:
                a.score = a.truesc = s.len * opt.a
                a.qb = 0
                a.rb = s.rbeg
            current.append((st, task, a))
        if not current:
            break
        _extend_side(opt, left_pend, "left", exec_cfg, scoring)
        # phase 2: right extensions
        right_pend = []
        for st, task, a in current:
            qlen = len(st.query)
            s = task.chain.seeds[task.seed_idx]
            rmax0 = st.rmax[task.ci][0]
            if s.qbeg + s.len != qlen:
                qe = s.qbeg + s.len
                re_off = s.rbeg + s.len - rmax0
                right_pend.append((st, task, a, st.query[qe:],
                                   st.rseq[task.ci][re_off:], a.score))
            else:
                a.qe = qlen
                a.re = s.rbeg + s.len
        _extend_side(opt, right_pend, "right", exec_cfg, scoring)
        # phase 3: finalize the regions
        for st, task, a in current:
            c = task.chain
            a.seedcov = sum(
                t.len for t in c.seeds
                if t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                and t.rbeg >= a.rb and t.rbeg + t.len <= a.re
            )
            a.w = max(a._aw0, a._aw1)
            a.seedlen0 = c.seeds[task.seed_idx].len
            a.frac_rep = c.frac_rep
            st.regs.append(a)
    return [st.regs for st in states]
