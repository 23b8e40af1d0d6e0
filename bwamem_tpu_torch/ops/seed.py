"""Three-round SMEM seeding (bwa mem_collect_intv) and bwa's sample_ks
expansion, PyTorch.

The counterpart of bwamem_tpu/ops/smem_tpu.py ``smem1a_body``,
ops/seed_tpu.py ``strategy1_body`` and ops/seed_fused.py ``seed_sa_core``:

* ``smem1a_torch``, ``strategy1_torch``, ``collect_intv_torch`` and
  ``sample_ks_torch`` are the plain PyTorch versions: lockstep lanes with
  masks over ``fmindex.extend_torch``, each lane one call of the host oracle
  (bwamem_tpu/engine/seed.py ``smem1a``, ``seed_strategy1``,
  ``collect_intv``; bwamem_tpu/engine/chain.py ``sample_ks``).  They run
  wherever their tensors lie.
* ``smem1a_cuda``, ``strategy1_cuda``, ``collect_intv_cuda`` and
  ``sample_ks_cuda`` launch the hand-written Hopper kernels of
  ``csrc/seed.cu``: one thread per lane (per read in ``collect_intv``).
* ``smem1a``, ``strategy1``, ``collect_intv`` and ``sample_ks`` dispatch on
  the device of their inputs: CPU tensors go to the plain version, CUDA
  tensors to the kernel.
* ``seed_sa`` chains them as ``seed_sa_core`` does up to its walks:
  seeding, the flat table of the reads that kept within their budgets and
  their SA rows, left on the device for ``fmindex.sa_lookup``;
  ``seed_sa_torch`` is the same chain through the plain versions only.

Budgets follow the JAX package's rules: at most K forward snapshots and K
SMEMs per ``smem1a`` call, at most M intervals per read.  A read past either
is flagged (``ovf``) and stops there; its rows are unspecified and its
caller seeds it on the host.  K and M are run-time arguments, by default
``K_MAX`` and the JAX package's ``M_SLOTS``, the sizes of the kernels'
stacks.  K = ``K_MAX`` never overflows on reads of up to ``K_MAX`` bases
(one snapshot or SMEM per base at most); the JAX package's ``K_SLOTS``
(24) is passed where its flags are to be matched.  The JAX
package's TPU workarounds (the 8/16-slot split, the log-step candidate
scan, one-hot compactions, the round-1 lane ladder, ``qb<<16|qe`` packing,
``R_cap``/``F_cap``) are not carried over: the flat table and the SA rows
are sized exactly.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, NamedTuple

import numpy as np
import torch

from . import fmindex as fmops
from .fmindex import DeviceFMIndex, extend_torch

K_SLOTS = 24  # smem_tpu.K_SLOTS, the JAX package's budget
K_MAX = 160  # csrc/seed.cu kMaxK
M_SLOTS = 48  # seed_fused.M_SLOTS
# launches of each CUDA kernel; bumped only where it is launched
LAUNCHES = {"smem1a": 0, "strategy1": 0, "collect_intv": 0, "sample_ks": 0}


@dataclass(frozen=True)
class SeedParams:
    """The seeding options of ``MemOptions`` that the kernels take."""

    min_seed_len: int
    split_len: int
    split_width: int
    max_mem_intv: int
    max_occ: int

    @classmethod
    def from_opt(cls, opt) -> "SeedParams":
        return cls(int(opt.min_seed_len), int(opt.split_len),
                   int(opt.split_width), int(opt.max_mem_intv),
                   int(opt.max_occ))


class Smem1a(NamedTuple):
    """One bwt_smem1a call per lane: the next start, the SMEMs in emission
    order (descending qb) in ``[B, K]`` slots, their count, the overflow
    flag.  A flagged lane has no SMEMs (zeros) and a count of 0."""

    ret: torch.Tensor  # [B] int32
    x0: torch.Tensor  # [B, K] int64
    x1: torch.Tensor  # [B, K] int64
    s: torch.Tensor  # [B, K] int32
    qb: torch.Tensor  # [B, K] int32
    qe: torch.Tensor  # [B, K] int32
    m_cnt: torch.Tensor  # [B] int32
    ovf: torch.Tensor  # [B] bool


class Strategy1(NamedTuple):
    """One bwt_seed_strategy1 call per lane, as ``strategy1_body``
    returns it: zeros where nothing was found, qb the start."""

    found: torch.Tensor  # [B] bool
    x0: torch.Tensor  # [B] int64
    x1: torch.Tensor  # [B] int64
    s: torch.Tensor  # [B] int32
    qb: torch.Tensor  # [B] int32
    qe: torch.Tensor  # [B] int32
    nxt: torch.Tensor  # [B] int32


class Intervals(NamedTuple):
    """mem_collect_intv per read: ``rows`` [B, M, 5] int64 (x0, x1, s, qb,
    qe) sorted by (qb, qe), zero past ``n``; ``n`` [B] int32; ``ovf`` [B]
    bool; ``nks`` [B] int64, the read's SA rows (sum of min(s, max_occ);
    0 when flagged)."""

    rows: torch.Tensor
    n: torch.Tensor
    ovf: torch.Tensor
    nks: torch.Tensor


class SeedSA(NamedTuple):
    """``seed_sa``'s result: the intervals per read, the flat table [N, 5]
    of the unflagged reads' rows in read order and their SA rows ``ks`` [R]
    (bwa sample_ks, row after row)."""

    intervals: Intervals
    flat: torch.Tensor
    ks: torch.Tensor


def pad_reads(reads: List[np.ndarray], device):
    """Reads (codes 0-4) -> ``qseq`` [B, Lmax] uint8, 4 past each read's
    end, and ``qlen`` [B] int32, on ``device``."""
    L = max([len(r) for r in reads] + [1])
    qseq = np.full((len(reads), L), 4, dtype=np.uint8)
    for i, r in enumerate(reads):
        qseq[i, : len(r)] = r
    qlen = np.asarray([len(r) for r in reads], dtype=np.int32)
    return (torch.from_numpy(qseq).to(device),
            torch.from_numpy(qlen).to(device))


# ------------------------------------------------------------ plain versions

def _set_intv(dfm: DeviceFMIndex, c: torch.Tensor):
    """bwa bwt_set_intv per lane: (x0, x1, s) of the symbols ``c``."""
    L2 = dfm.L2
    return L2[c] + 1, L2[3 - c] + 1, L2[c + 1] - L2[c]


def _lanes(mask: torch.Tensor) -> torch.Tensor:
    return mask.nonzero().squeeze(1)


def smem1a_torch(dfm: DeviceFMIndex, qseq, qlen, x, min_intv,
                 K: int = K_MAX) -> Smem1a:
    """bwt_smem1a (max_intv == 0) from start ``x`` [B] with minimum
    interval ``min_intv`` [B] on each read of ``qseq`` [B, L], with the
    K budget; lanes with x >= qlen or an ambiguous base at x yield nothing
    and ret = x + 1."""
    _check_budget(K=K)
    dev = qseq.device
    q = qseq.long()
    B, L = q.shape
    qlen, x, min_intv = qlen.long(), x.long(), min_intv.long()
    lane = torch.arange(B, device=dev)
    c0 = q[lane, x.clamp(0, L - 1)]
    ok0 = (c0 <= 3) & (x < qlen)
    # ik per lane: x0, x1, s, info
    ik = torch.stack([*_set_intv(dfm, c0.clamp(0, 3)), x + 1], dim=1)
    snap = torch.zeros((B, K, 4), dtype=torch.long, device=dev)
    cnt = torch.zeros(B, dtype=torch.long, device=dev)
    ret = x + 1
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)

    def snapshot(lanes):
        ret[lanes] = ik[lanes, 3]
        room = cnt[lanes] < K
        ovf[lanes[~room]] = True
        w = lanes[room]
        snap[w, cnt[w]] = ik[w]
        cnt[w] += 1

    # forward: snapshot the interval each time its size changes
    alive = ok0.clone()
    t = 0
    while True:
        idx = _lanes(alive)
        if idx.numel() == 0:
            break
        p = x[idx] + 1 + t
        c = q[idx, p.clamp(max=L - 1)]
        stop = (p >= qlen[idx]) | (c > 3)
        gi = idx[~stop]
        ci = 3 - c[~stop]
        cur = ik[gi]
        ox0, ox1, sz = extend_torch(dfm, cur[:, 0], cur[:, 1], cur[:, 2], False)
        r = torch.arange(gi.numel(), device=dev)
        nxt = torch.stack([ox0[r, ci], ox1[r, ci], sz[r, ci].long(),
                           p[~stop] + 1], dim=1)
        changed = nxt[:, 2] != cur[:, 2]
        snapshot(torch.cat([idx[stop], gi[changed]]))
        cont = ~(changed & (nxt[:, 2] < min_intv[gi]))
        ik[gi[cont]] = nxt[cont]
        alive[idx] = False
        alive[gi[cont]] = True
        t += 1

    # backward: prev holds the snapshots longest match first
    j = torch.arange(K, device=dev)
    src = (cnt[:, None] - 1 - j).clamp(min=0)
    prev = snap.gather(1, src[:, :, None].expand(B, K, 4))
    n_prev = cnt.clone()
    mems = torch.zeros((B, K, 5), dtype=torch.long, device=dev)
    m_cnt = torch.zeros(B, dtype=torch.long, device=dev)
    last_qb = torch.zeros(B, dtype=torch.long, device=dev)
    live = ok0 & ~ovf
    t = 0
    while True:
        idx = _lanes(live)
        if idx.numel() == 0:
            break
        nl = idx.numel()
        ar = torch.arange(nl, device=dev)
        i = x[idx] - 1 - t
        c = q[idx, i.clamp(0, L - 1)]
        have = (i >= 0) & (c <= 3)
        W = int(n_prev[idx].max())
        P = prev[idx, :W]
        slot = j[:W] < n_prev[idx, None]
        li, sj = (slot & have[:, None]).nonzero(as_tuple=True)
        ext = torch.zeros((nl, W, 3), dtype=torch.long, device=dev)
        if li.numel():
            ox0, ox1, sz = extend_torch(dfm, P[li, sj, 0], P[li, sj, 1],
                                        P[li, sj, 2], True)
            r = torch.arange(li.numel(), device=dev)
            col = c[li]
            ext[li, sj] = torch.stack([ox0[r, col], ox1[r, col],
                                       sz[r, col].long()], dim=1)
        dead = slot & (~have[:, None] | (ext[:, :, 2] < min_intv[idx, None]))
        cand = slot & ~dead
        curr = torch.zeros((nl, K, 4), dtype=torch.long, device=dev)
        n_curr = torch.zeros(nl, dtype=torch.long, device=dev)
        for jj in range(W):
            # the first dying interval before any survivor emits an SMEM,
            # if it starts left of the last one emitted
            gate = (m_cnt[idx] == 0) | (i + 1 < last_qb[idx])
            e = _lanes(dead[:, jj] & (n_curr == 0) & gate)
            if e.numel():
                el = idx[e]
                full = m_cnt[el] >= K
                ovf[el[full]] = True
                e, el = e[~full], el[~full]
                pv = P[e, jj]
                mems[el, m_cnt[el]] = torch.stack(
                    [pv[:, 0], pv[:, 1], pv[:, 2], i[e] + 1, pv[:, 3]], dim=1)
                m_cnt[el] += 1
                last_qb[el] = i[e] + 1
            # a survivor is kept unless its size equals the last kept one's
            last_s = curr[ar, (n_curr - 1).clamp(min=0), 2]
            k = _lanes(cand[:, jj] & ((n_curr == 0) | (ext[:, jj, 2] != last_s)))
            curr[k, n_curr[k]] = torch.cat([ext[k, jj], P[k, jj, 3:]], dim=1)
            n_curr[k] += 1
        prev[idx] = curr
        n_prev[idx] = n_curr
        live[idx] = (n_curr > 0) & ~ovf[idx]
        t += 1
    mems[ovf] = 0
    m_cnt[ovf] = 0
    i32 = torch.int32
    return Smem1a(ret.to(i32), mems[..., 0], mems[..., 1], mems[..., 2].to(i32),
                  mems[..., 3].to(i32), mems[..., 4].to(i32), m_cnt.to(i32), ovf)


def strategy1_torch(dfm: DeviceFMIndex, qseq, qlen, x, min_len: int,
                    max_intv: int) -> Strategy1:
    """bwt_seed_strategy1 from start ``x`` [B] on each read of ``qseq``."""
    dev = qseq.device
    q = qseq.long()
    B, L = q.shape
    qlen, x = qlen.long(), x.long()
    lane = torch.arange(B, device=dev)
    c0 = q[lane, x.clamp(0, L - 1)]
    ik = torch.stack(_set_intv(dfm, c0.clamp(0, 3)), dim=1)
    hit = torch.zeros((B, 4), dtype=torch.long, device=dev)  # x0, x1, s, qe
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    nxt = x + 1
    alive = (c0 <= 3) & (x < qlen)
    t = 0
    while True:
        idx = _lanes(alive)
        if idx.numel() == 0:
            break
        p = x[idx] + 1 + t
        in_len = p < qlen[idx]
        c = q[idx, p.clamp(max=L - 1)]
        nxt[idx[in_len & (c > 3)]] = p[in_len & (c > 3)] + 1
        nxt[idx[~in_len]] = qlen[idx[~in_len]]
        go = in_len & (c <= 3)
        gi, pg = idx[go], p[go]
        ci = 3 - c[go]
        cur = ik[gi]
        ox0, ox1, sz = extend_torch(dfm, cur[:, 0], cur[:, 1], cur[:, 2], False)
        r = torch.arange(gi.numel(), device=dev)
        nx = torch.stack([ox0[r, ci], ox1[r, ci], sz[r, ci].long()], dim=1)
        h = (nx[:, 2] < max_intv) & (pg - x[gi] >= min_len)
        found[gi[h]] = True
        hit[gi[h]] = torch.cat([nx[h], (pg[h] + 1)[:, None]], dim=1)
        nxt[gi[h]] = pg[h] + 1
        ik[gi[~h]] = nx[~h]
        alive[idx] = False
        alive[gi[~h]] = True
        t += 1
    i32 = torch.int32
    return Strategy1(found, hit[:, 0], hit[:, 1], hit[:, 2].to(i32), x.to(i32),
                     hit[:, 3].to(i32), nxt.to(i32))


def collect_intv_torch(dfm: DeviceFMIndex, qseq, qlen, params: SeedParams,
                       M: int = M_SLOTS, K: int = K_MAX) -> Intervals:
    """mem_collect_intv on each read of ``qseq`` [B, L] (``qlen`` [B]):
    round 1 all SMEMs, round 2 re-seeding of round 1's long low-occurrence
    SMEMs, round 3 strategy-1 seeds, into M slots per read (K slots per
    smem1a call), then the stable (qb, qe) sort."""
    _check_budget(M, K)
    dev = qseq.device
    B, L = qseq.shape
    qlen = qlen.long()
    acc = torch.zeros((B, M, 5), dtype=torch.long, device=dev)
    n = torch.zeros(B, dtype=torch.long, device=dev)
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    marr = torch.arange(M, device=dev)

    def append(lanes, vals):  # distinct lanes, one row each
        room = n[lanes] < M
        ovf[lanes[~room]] = True
        w = lanes[room]
        acc[w, n[w]] = vals[room]
        n[w] += 1

    def append_wave(lanes, out: Smem1a):
        # the SMEMs in ascending qb, those of min_seed_len or longer
        ovf[lanes[out.ovf]] = True
        for k in range(int(out.m_cnt.max()) if lanes.numel() else 0):
            src = (out.m_cnt.long() - 1 - k).clamp(min=0)
            r = torch.arange(lanes.numel(), device=dev)
            row = torch.stack([out.x0[r, src], out.x1[r, src], out.s[r, src].long(),
                               out.qb[r, src].long(), out.qe[r, src].long()], dim=1)
            keep = (out.m_cnt > k) & (row[:, 4] - row[:, 3] >= params.min_seed_len)
            append(lanes[keep], row[keep])

    def busy(x):
        return _lanes((x < qlen) & ~ovf)

    # round 1: all SMEMs, one call per start and read
    x = torch.zeros(B, dtype=torch.long, device=dev)
    while (act := busy(x)).numel():
        out = smem1a_torch(dfm, qseq[act], qlen[act], x[act],
                           torch.ones_like(act), K)
        append_wave(act, out)
        x[act] = out.ret.long()
    # round 2: round 1's SMEMs in accumulator order, the qualifying ones
    # re-seeded from their middle
    qual = ((marr < n[:, None]) & (acc[:, :, 4] - acc[:, :, 3] >= params.split_len)
            & (acc[:, :, 2] <= params.split_width))
    jc = torch.zeros(B, dtype=torch.long, device=dev)
    while True:
        todo = qual & (marr >= jc[:, None]) & ~ovf[:, None]
        act = _lanes(todo.any(dim=1))
        if act.numel() == 0:
            break
        j = todo[act].to(torch.int8).argmax(dim=1)
        p = acc[act, j]
        out = smem1a_torch(dfm, qseq[act], qlen[act], (p[:, 3] + p[:, 4]) >> 1,
                           p[:, 2] + 1, K)
        append_wave(act, out)
        jc[act] = j + 1
    # round 3: LAST-like strategy-1 seeds, one call per start and read
    if params.max_mem_intv > 0:
        x = torch.zeros(B, dtype=torch.long, device=dev)
        while (act := busy(x)).numel():
            h = strategy1_torch(dfm, qseq[act], qlen[act], x[act],
                                params.min_seed_len, params.max_mem_intv)
            app = h.found & (h.s > 0)
            row = torch.stack([h.x0, h.x1, h.s.long(), x[act], h.qe.long()], dim=1)
            append(act[app], row[app])
            x[act] = h.nxt.long()
    # stable sort by (qb, qe), as the oracle's list.sort
    valid = marr < n[:, None]
    key = torch.where(valid, acc[:, :, 3] * (L + 1) + acc[:, :, 4],
                      torch.iinfo(torch.long).max)
    order = torch.sort(key, dim=1, stable=True).indices
    acc = acc.gather(1, order[:, :, None].expand(B, M, 5))
    nks = torch.where(valid, acc[:, :, 2].clamp(max=params.max_occ), 0).sum(dim=1)
    return Intervals(acc, n.to(torch.int32), ovf, torch.where(ovf, 0, nks))


def sample_ks_torch(rows, nrows, nks, max_occ: int):
    """bwa sample_ks over the first ``nrows`` [B] rows of each read of
    ``rows`` [B, M, 5]: the flat table [N, 5] of those rows in read order,
    and the SA rows [R] (R = sum of ``nks``) of every row, row after row:
    min(s, max_occ) rows x0 + step * t with step = s // max_occ when
    s > max_occ, else 1."""
    B, M, _ = rows.shape
    flat = rows[torch.arange(M, device=rows.device) < nrows[:, None].long()]
    s = flat[:, 2]
    cnt = s.clamp(0, max_occ)
    step = torch.where(s > max_occ, s // max(max_occ, 1), 1)
    rid = torch.repeat_interleave(torch.arange(flat.shape[0], device=rows.device),
                                  cnt, output_size=int(nks.sum()))
    start = torch.cumsum(cnt, 0) - cnt
    within = torch.arange(rid.numel(), device=rows.device) - start[rid]
    return flat, flat[rid, 0] + step[rid] * within


def _check_budget(M: int = M_SLOTS, K: int = K_MAX):
    if not 1 <= M <= M_SLOTS:
        raise ValueError(f"the interval budget M must lie in [1, {M_SLOTS}]")
    if not 1 <= K <= K_MAX:
        raise ValueError(f"the slot budget K must lie in [1, {K_MAX}]")


# ------------------------------------------------------------------ kernels

def _bind(lib):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fm = [p, i32, i32, p, i64, i64]  # lines, W, log2(span), L2, primary, seq_len
    q = [p, i32, p]  # qseq, L, qlen
    for name, args in (
        ("bwamem_seed_smem1a_launch",
         fm + q + [p, p, i32, i32, p, p, p, p, p, p]),
        ("bwamem_seed_strategy1_launch",
         fm + q + [p, i32, i32, i64, p, p, p, p, p]),
        ("bwamem_seed_collect_intv_launch",
         fm + q + [i32, i32, i32, i64, i64, i64, i32, i32, p, p, p, p, p, p, p]),
        ("bwamem_seed_sample_ks_launch", [p, i32, p, p, p, i32, i64, p, p, p]),
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args


def _lib():
    from ..utils import cudabuild

    return cudabuild.load("seed", _bind)


def _launched(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _reads_on_card(dfm: DeviceFMIndex, qseq, qlen, *lanes):
    """``qseq`` as contiguous uint8 [B, L], ``qlen`` and ``lanes`` as
    contiguous [B] tensors, all on the index's CUDA device."""
    dev = dfm.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need an index on the card, not {dev}")
    if qseq.dim() != 2:
        raise ValueError(f"qseq must be [B, L], got {tuple(qseq.shape)}")
    B = qseq.shape[0]
    for t in (qseq, qlen, *lanes):
        if t.device != dev:
            raise ValueError(f"expected tensors on {dev}, got one on {t.device}")
    for t in (qlen, *lanes):
        if t.dim() != 1 or t.shape[0] != B:
            raise ValueError(f"expected [{B}] lane tensors, got {tuple(t.shape)}")
    return (qseq.to(torch.uint8).contiguous(),
            qlen.to(torch.int32).contiguous())


def _seed_args(dfm, qseq, qlen):
    return (*fmops._fm_args(dfm), qseq.data_ptr(), qseq.shape[1],
            qlen.data_ptr())


# The *_launch functions launch a kernel on prepared operands (as the
# *_cuda wrappers prepare them; outputs and the int32 [1] flag word
# allocated by the caller) and leave the flags for the caller to read.

def smem1a_launch(dfm, qseq, qlen, x, min_intv, ret, mems, m_cnt, ovf, err):
    """``x`` int32, ``min_intv`` int64 [B] -> ``ret``, ``m_cnt``, ``ovf``
    int32 [B] and ``mems`` [B, K, 5] int64 (K, the budget, is its size)."""
    _launched("smem1a", _lib().bwamem_seed_smem1a_launch(
        *_seed_args(dfm, qseq, qlen), x.data_ptr(), min_intv.data_ptr(),
        qseq.shape[0], mems.shape[1], ret.data_ptr(), mems.data_ptr(),
        m_cnt.data_ptr(), ovf.data_ptr(), err.data_ptr(), fmops._stream(dfm)))


def strategy1_launch(dfm, qseq, qlen, x, min_len, max_intv, found, out, nxt,
                     err):
    """``x`` int32 [B] -> ``found``, ``nxt`` int32 [B], ``out`` [B, 5]
    int64 (x0, x1, s, qb, qe)."""
    _launched("strategy1", _lib().bwamem_seed_strategy1_launch(
        *_seed_args(dfm, qseq, qlen), x.data_ptr(), qseq.shape[0],
        int(min_len), int(max_intv), found.data_ptr(), out.data_ptr(),
        nxt.data_ptr(), err.data_ptr(), fmops._stream(dfm)))


def collect_intv_launch(dfm, qseq, qlen, params: SeedParams, M, K, rows, n,
                        ovf, nks, err, work=None):
    """-> ``rows`` [B, M, 5] int64, ``n``, ``ovf`` int32 [B], ``nks`` int64
    [B]; and, given ``work`` int32 [B, 5], each read's smem1a calls,
    strategy1 calls and bwt_extend calls, what flagged it (0 nothing, 1 the
    K budget, 2 the M-slot accumulator) and the most K slots one of its
    smem1a calls needed."""
    _launched("collect_intv", _lib().bwamem_seed_collect_intv_launch(
        *_seed_args(dfm, qseq, qlen), qseq.shape[0], params.min_seed_len,
        params.split_len, params.split_width, params.max_mem_intv,
        params.max_occ, M, K, rows.data_ptr(), n.data_ptr(), ovf.data_ptr(),
        nks.data_ptr(), None if work is None else work.data_ptr(),
        err.data_ptr(), fmops._stream(dfm)))


def sample_ks_launch(rows, nrows, row_off, ks_off, max_occ, flat, ks):
    """``rows`` [B, M, 5] int64, ``nrows`` int32 and the exclusive scans
    ``row_off``/``ks_off`` int64 [B] -> ``flat`` [N, 5], ``ks`` [R]."""
    B, M, _ = rows.shape
    _launched("sample_ks", _lib().bwamem_seed_sample_ks_launch(
        rows.data_ptr(), M, nrows.data_ptr(), row_off.data_ptr(),
        ks_off.data_ptr(), B, int(max_occ), flat.data_ptr(), ks.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream))


def smem1a_cuda(dfm: DeviceFMIndex, qseq, qlen, x, min_intv,
                K: int = K_MAX) -> Smem1a:
    """The smem1a kernel, one thread per lane; same contract as
    ``smem1a_torch``."""
    _check_budget(K=K)
    qseq, qlen = _reads_on_card(dfm, qseq, qlen, x, min_intv)
    B, dev = qseq.shape[0], dfm.device
    x = x.to(torch.int32).contiguous()
    min_intv = min_intv.to(torch.int64).contiguous()
    ret, m_cnt, ovf = (torch.zeros(B, dtype=torch.int32, device=dev)
                       for _ in range(3))
    mems = torch.zeros((B, K, 5), dtype=torch.int64, device=dev)
    if B:
        err = fmops._flag_word(dfm)
        smem1a_launch(dfm, qseq, qlen, x, min_intv, ret, mems, m_cnt, ovf, err)
        fmops._raise_flags("smem1a", err)
    i32 = torch.int32
    return Smem1a(ret, mems[..., 0], mems[..., 1], mems[..., 2].to(i32),
                  mems[..., 3].to(i32), mems[..., 4].to(i32), m_cnt, ovf.bool())


def strategy1_cuda(dfm: DeviceFMIndex, qseq, qlen, x, min_len: int,
                   max_intv: int) -> Strategy1:
    """The strategy-1 kernel, one thread per lane; same contract as
    ``strategy1_torch``."""
    qseq, qlen = _reads_on_card(dfm, qseq, qlen, x)
    B, dev = qseq.shape[0], dfm.device
    x = x.to(torch.int32).contiguous()
    found, nxt = (torch.zeros(B, dtype=torch.int32, device=dev) for _ in range(2))
    out = torch.zeros((B, 5), dtype=torch.int64, device=dev)
    if B:
        err = fmops._flag_word(dfm)
        strategy1_launch(dfm, qseq, qlen, x, min_len, max_intv, found, out, nxt,
                         err)
        fmops._raise_flags("strategy1", err)
    i32 = torch.int32
    return Strategy1(found.bool(), out[:, 0], out[:, 1], out[:, 2].to(i32),
                     out[:, 3].to(i32), out[:, 4].to(i32), nxt)


def collect_intv_cuda(dfm: DeviceFMIndex, qseq, qlen, params: SeedParams,
                      M: int = M_SLOTS, K: int = K_MAX,
                      work=None) -> Intervals:
    """The collect_intv kernel, one thread per read; same contract as
    ``collect_intv_torch``.  Given ``work`` (int32 [B, 5] on the card), the
    kernel writes there each read's seeding work (``collect_intv_launch``)."""
    _check_budget(M, K)
    qseq, qlen = _reads_on_card(dfm, qseq, qlen)
    B, dev = qseq.shape[0], dfm.device
    if work is not None and (work.shape != (B, 5) or work.dtype != torch.int32
                             or work.device != dev or not work.is_contiguous()):
        raise ValueError(f"work must be a contiguous int32 [{B}, 5] tensor on {dev}")
    rows = torch.zeros((B, M, 5), dtype=torch.int64, device=dev)
    n, ovf = (torch.zeros(B, dtype=torch.int32, device=dev) for _ in range(2))
    nks = torch.zeros(B, dtype=torch.int64, device=dev)
    if B:
        err = fmops._flag_word(dfm)
        collect_intv_launch(dfm, qseq, qlen, params, M, K, rows, n, ovf, nks,
                            err, work)
        fmops._raise_flags("collect_intv", err)
    return Intervals(rows, n, ovf.bool(), nks)


def _scan_offsets(nrows, nks):
    """Exclusive scans of the per-read row and SA-row counts, and their two
    totals (one small copy to the host)."""
    nrows = nrows.long()
    row_off = torch.cumsum(nrows, 0) - nrows
    ks_off = torch.cumsum(nks, 0) - nks
    n_total, ks_total = torch.stack([nrows.sum(), nks.sum()]).tolist()
    return row_off, ks_off, n_total, ks_total


def sample_ks_cuda(rows, nrows, nks, max_occ: int):
    """The sample_ks kernel, one thread per (read, slot); same contract as
    ``sample_ks_torch``."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need tensors on the card, not {dev}")
    B, M, _ = rows.shape
    rows = rows.to(torch.int64).contiguous()
    nks = nks.to(torch.int64).contiguous()
    row_off, ks_off, n_total, ks_total = _scan_offsets(nrows, nks)
    flat = torch.empty((n_total, 5), dtype=torch.int64, device=dev)
    ks = torch.empty(ks_total, dtype=torch.int64, device=dev)
    if n_total:
        sample_ks_launch(rows, nrows.to(torch.int32).contiguous(), row_off,
                         ks_off, max_occ, flat, ks)
    return flat, ks


# -------------------------------------------------------------- dispatchers

def smem1a(dfm: DeviceFMIndex, qseq, qlen, x, min_intv,
           K: int = K_MAX) -> Smem1a:
    """CPU tensors -> ``smem1a_torch``; CUDA tensors -> the kernel."""
    fn = smem1a_cuda if qseq.device.type == "cuda" else smem1a_torch
    return fn(dfm, qseq, qlen, x, min_intv, K)


def strategy1(dfm: DeviceFMIndex, qseq, qlen, x, min_len: int,
              max_intv: int) -> Strategy1:
    """CPU tensors -> ``strategy1_torch``; CUDA tensors -> the kernel."""
    fn = strategy1_cuda if qseq.device.type == "cuda" else strategy1_torch
    return fn(dfm, qseq, qlen, x, min_len, max_intv)


def collect_intv(dfm: DeviceFMIndex, qseq, qlen, params: SeedParams,
                 M: int = M_SLOTS, K: int = K_MAX, work=None) -> Intervals:
    """CPU tensors -> ``collect_intv_torch`` (which leaves ``work`` as it
    is); CUDA tensors -> the kernel."""
    if qseq.device.type == "cuda":
        return collect_intv_cuda(dfm, qseq, qlen, params, M, K, work)
    return collect_intv_torch(dfm, qseq, qlen, params, M, K)


def sample_ks(rows, nrows, nks, max_occ: int):
    """CPU tensors -> ``sample_ks_torch``; CUDA tensors -> the kernel."""
    fn = sample_ks_cuda if rows.device.type == "cuda" else sample_ks_torch
    return fn(rows, nrows, nks, max_occ)


def _seed_sa(iv: Intervals, sample, params) -> SeedSA:
    nrows = torch.where(iv.ovf, 0, iv.n)
    return SeedSA(iv, *sample(iv.rows, nrows, iv.nks, params.max_occ))


def seed_sa(dfm: DeviceFMIndex, qseq, qlen, params: SeedParams,
            M: int = M_SLOTS, K: int = K_MAX, work=None) -> SeedSA:
    """``seed_sa_core`` up to its walks, through the dispatchers: on the
    card, the collect_intv and sample_ks kernels, with no copy to the host
    between them but the two totals.  ``work`` goes to ``collect_intv``."""
    return _seed_sa(collect_intv(dfm, qseq, qlen, params, M, K, work),
                    sample_ks, params)


def seed_sa_torch(dfm: DeviceFMIndex, qseq, qlen, params: SeedParams,
                  M: int = M_SLOTS, K: int = K_MAX) -> SeedSA:
    """``seed_sa`` through the plain versions only."""
    return _seed_sa(collect_intv_torch(dfm, qseq, qlen, params, M, K),
                    sample_ks_torch, params)
