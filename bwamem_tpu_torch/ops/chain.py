"""Seed chaining and chain filtering (bwa mem_chain + mem_chain_flt), PyTorch.

The counterpart of bwamem_tpu/ops/chain_tpu.py:

* ``chain_torch`` is the plain PyTorch version: every read advances one
  seed per step in lockstep (a masked predecessor search over the chain
  slots, as ``chain_kernel`` writes it), then the filter runs one sorted
  chain per step.  It runs wherever its tensors lie.
* ``chain_cuda`` launches the hand-written Hopper kernels of
  ``csrc/chain.cu`` (a count pass and an emit pass around two scans, each
  a warp per read, the reads taken heaviest first in one ``read_order``).
* ``chain`` dispatches on the device of its inputs: CPU tensors go to the
  plain version, CUDA tensors to the kernels.
* ``chains_device_batch`` is the batch entry: the arrays the host C++
  ``engine.native_chain.chain_batch`` takes, as tensors, one copy back, and
  the ``Chain`` lists rebuilt with ``w``, ``kept`` and ``first`` set.

Input is the flat seed table (``SeedTable``): read i's intervals are rows
``intv_off[i] .. intv_off[i] + n_intv[i]`` of ``rows`` [N, 5] (x0, x1, s,
qb, qe), and interval r has ``cnt[r]`` seeds whose reference starts are
``rbegs[rbeg_off[r] ..]``.  Seeds are enumerated interval by interval,
sample by sample.  There is no budget on seeds.  Output (``Chains``) is
sized exactly: ``chain_rows`` [Nc, 7] int64 (rid, is_alt, n_seeds, frac_rep
bits, w, kept, first), chains of a read in the filter's output order (weight
descending, key order on ties; ``first`` indexes that sorted space), and
``seed_rows`` [Ns, 4] (rbeg, qbeg, len, score), each chain's seeds in
enumeration order.

Budget: C chain slots per read, a run-time argument (default and ceiling
``C_MAX``, the JAX package's largest bucket).  A read that needs more is
flagged (``ovf``), stops there and yields no chains; its caller chains it on
the host.  Coordinates are int64 throughout.  The comparisons against
``mask_level`` and ``drop_ratio`` are made in float64, as the host oracle
(engine/chain.py ``chain_flt``) makes them; the JAX program compares in
float32.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..engine.chain import Chain, Seed
from ..utils.cudabuild import on_device, stream, tally

C_MAX = 128  # csrc/chain.cu kMaxC; chain_tpu._C_BUCKETS[-1]
# the JAX package's per-batch buckets (chain_tpu._S_BUCKETS/_C_BUCKETS)
REF_S_BUCKETS = (64, 256, 1024)
REF_C_BUCKETS = (32, 128)
# launches of each CUDA kernel; bumped only where it is launched
LAUNCHES = {"chain": 0, "chain_emit": 0}
ERR_RANGE = 1
_W_CAP = (1 << 30) - 1
_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min


@dataclass(frozen=True)
class ChainParams:
    """The chaining options of ``MemOptions`` that the kernels take."""

    w: int
    max_chain_gap: int
    min_chain_weight: int
    min_seed_len: int
    max_chain_extend: int
    max_occ: int
    mask_level: float
    drop_ratio: float

    @classmethod
    def from_opt(cls, opt) -> "ChainParams":
        return cls(int(opt.w), int(opt.max_chain_gap),
                   int(opt.min_chain_weight), int(opt.min_seed_len),
                   int(opt.max_chain_extend), int(opt.max_occ),
                   float(opt.mask_level), float(opt.drop_ratio))


@dataclass(frozen=True)
class DeviceContigs:
    """The contig tables on one device: forward starts, cumulative forward
    ends and ALT flags, and the forward length."""

    ctg_end: torch.Tensor  # [Nc] int64
    ctg_alt: torch.Tensor  # [Nc] int32
    l_pac: int
    ctg_off: torch.Tensor  # [Nc] int64

    @property
    def device(self) -> torch.device:
        return self.ctg_end.device

    @classmethod
    def from_host(cls, bns, device) -> "DeviceContigs":
        """``bns`` (an ``index.build.Bntseq``) -> its tables on ``device``."""
        offs = np.asarray([a.offset for a in bns.anns], np.int64)
        ends = offs + np.asarray([a.length for a in bns.anns], np.int64)
        alts = np.asarray([a.is_alt for a in bns.anns], np.int32)
        return cls(torch.from_numpy(ends).to(device),
                   torch.from_numpy(alts).to(device), int(bns.l_pac),
                   torch.from_numpy(offs).to(device))


class SeedTable(NamedTuple):
    """A batch's seeds, flat (see the module docstring)."""

    qlen: torch.Tensor  # [B] int32
    rows: torch.Tensor  # [N, 5] int64
    intv_off: torch.Tensor  # [B] int64
    n_intv: torch.Tensor  # [B] int64
    rbegs: torch.Tensor  # [R] int64
    rbeg_off: torch.Tensor  # [N] int64
    cnt: torch.Tensor  # [N] int64

    @classmethod
    def from_numpy(cls, device, qlen, rows, intv_off, n_intv, rbegs, rbeg_off,
                   cnt) -> "SeedTable":
        def up(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)

        return cls(up(qlen, np.int32),
                   up(np.asarray(rows, np.int64).reshape(-1, 5), np.int64),
                   *(up(a, np.int64)
                     for a in (intv_off, n_intv, rbegs, rbeg_off, cnt)))


class Chains(NamedTuple):
    """``chain``'s result (see the module docstring), with per read its
    chains and seeds in the output, its seeds in the input, the overflow
    flag, and the chain slots it used (C + 1 when flagged)."""

    chain_rows: torch.Tensor  # [Nc, 7] int64
    seed_rows: torch.Tensor  # [Ns, 4] int64
    n_chain: torch.Tensor  # [B] int64
    n_seed: torch.Tensor  # [B] int64
    seed_cnt: torch.Tensor  # [B] int64
    ovf: torch.Tensor  # [B] bool
    nslots: torch.Tensor  # [B] int32


def _check_budget(C: int):
    if not 1 <= C <= C_MAX:
        raise ValueError(f"the chain budget C must lie in [1, {C_MAX}]")


def _check_table(tab: SeedTable):
    B, N = tab.qlen.shape[0], tab.rows.shape[0]
    dev = tab.qlen.device
    if tab.rows.dim() != 2 or tab.rows.shape[1] != 5:
        raise ValueError(f"rows must be [N, 5], got {tuple(tab.rows.shape)}")
    for name, t, n in (("intv_off", tab.intv_off, B), ("n_intv", tab.n_intv, B),
                       ("rbeg_off", tab.rbeg_off, N), ("cnt", tab.cnt, N)):
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
    if tab.rbegs.dim() != 1:
        raise ValueError("rbegs must be 1-D")
    for t in tab:
        if t.device != dev:
            raise ValueError(f"expected tensors on {dev}, got one on {t.device}")


def _excl_scan(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def expand_ranges(first: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """first[i], first[i] + 1, ... for count[i] places, for every i in
    turn."""
    ramp = torch.arange(int(count.sum()), device=count.device)
    return torch.repeat_interleave(first, count) + (
        ramp - torch.repeat_interleave(_excl_scan(count), count))


def _seed_counts(tab: SeedTable):
    """Per read, the count of its seeds and the offset of its first among
    all reads' seeds in read order; and the reads' interval rows in read
    order with the read of each."""
    B = tab.qlen.shape[0]
    dev = tab.qlen.device
    n_intv = tab.n_intv.long()
    read_of_row = torch.repeat_interleave(
        torch.arange(B, device=dev), n_intv)
    within = torch.arange(read_of_row.numel(), device=dev) - _excl_scan(
        n_intv)[read_of_row]
    row_idx = tab.intv_off.long()[read_of_row] + within
    seed_cnt = torch.zeros(B, dtype=torch.int64, device=dev).index_add_(
        0, read_of_row, tab.cnt.long()[row_idx])
    return seed_cnt, _excl_scan(seed_cnt), row_idx, read_of_row


# ------------------------------------------------------------- plain version

def _frac_rep(tab: SeedTable, params: ChainParams) -> torch.Tensor:
    """mem_chain's tail per read: the share of the query covered by
    intervals of more than max_occ occurrences, float64 [B]."""
    B = tab.qlen.shape[0]
    dev = tab.qlen.device
    b = torch.zeros(B, dtype=torch.int64, device=dev)
    e, l_rep = b.clone(), b.clone()
    n_intv, io = tab.n_intv.long(), tab.intv_off.long()
    for pi in range(int(n_intv.max()) if B else 0):
        act = (n_intv > pi).nonzero().squeeze(1)
        p = tab.rows[io[act] + pi]
        act, p = act[p[:, 2] > params.max_occ], p[p[:, 2] > params.max_occ]
        new = p[:, 3] > e[act]
        l_rep[act[new]] += (e - b)[act[new]]
        b[act[new]] = p[new, 3]
        e[act] = torch.where(new, p[:, 4], torch.maximum(e[act], p[:, 4]))
    l_rep += e - b
    ql = tab.qlen.double()
    return torch.where(ql > 0, l_rep.double() / ql.clamp(min=1), 0.0)


def _seed_rid(ctg: DeviceContigs, rbeg, slen):
    """bns_intv2rid per seed: the contig, or -1 where the seed bridges two
    contigs or the strand boundary."""
    l_pac = ctg.l_pac
    re_ = rbeg + slen
    fwd = rbeg < l_pac
    fb = torch.where(fwd, rbeg, 2 * l_pac - 1 - (re_ - 1))
    fe = torch.where(fwd, re_ - 1, 2 * l_pac - 1 - rbeg)
    rid_b = torch.searchsorted(ctg.ctg_end, fb, right=True)
    rid_e = torch.searchsorted(ctg.ctg_end, fe, right=True)
    bad = (fwd != (re_ <= l_pac)) | (rid_b != rid_e) | (fb < 0) | (fe >= l_pac)
    return torch.where(bad, -1, rid_b)


def chain_torch(ctg: DeviceContigs, tab: SeedTable, params: ChainParams,
                C: int = C_MAX) -> Chains:
    """mem_chain + mem_chain_flt on every read of ``tab`` with C chain
    slots per read."""
    _check_budget(C)
    _check_table(tab)
    dev = tab.qlen.device
    B = tab.qlen.shape[0]
    i64 = torch.int64
    seed_cnt, seed_off, row_idx, read_of_row = _seed_counts(tab)
    # every seed in enumeration order: its read, query start, length, rbeg
    cnt = tab.cnt.long()[row_idx]
    seed_row = torch.repeat_interleave(row_idx, cnt)
    within = torch.arange(seed_row.numel(), device=dev) - torch.repeat_interleave(
        _excl_scan(cnt), cnt)
    ridx = tab.rbeg_off.long()[seed_row] + within
    if ridx.numel() and bool(((ridx < 0) | (ridx >= tab.rbegs.numel())).any()):
        raise ValueError("chain: an interval's seeds lie outside rbegs")
    s_rbeg = tab.rbegs.long()[ridx]
    s_qb = tab.rows[seed_row, 3]
    s_len = tab.rows[seed_row, 4] - s_qb
    s_rid = _seed_rid(ctg, s_rbeg, s_len)
    s_read = torch.repeat_interleave(read_of_row, cnt)
    T = s_rbeg.numel()
    frac = _frac_rep(tab, params)

    # ---- mem_chain: slots in creation order; r0 is the chain's key
    def zeros():
        return torch.zeros((B, C), dtype=i64, device=dev)

    r0, rl, crid, q0, ql, ll = (zeros() for _ in range(6))
    endq, wq, endr, wr, ns = (zeros() for _ in range(5))
    nch = torch.zeros(B, dtype=i64, device=dev)
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    assign = torch.full((T,), -1, dtype=i64, device=dev)
    live = tab.qlen.long() >= params.min_seed_len
    l_pac = ctg.l_pac
    for t in range(int(seed_cnt.max()) if B else 0):
        idx = ((seed_cnt > t) & live & ~ovf).nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        g = seed_off[idx] + t
        ok = s_rid[g] >= 0
        idx, g = idx[ok], g[ok]
        if idx.numel() == 0:
            continue
        p_r, p_q, p_l, p_rid = s_rbeg[g], s_qb[g], s_len[g], s_rid[g]
        W = min(int(nch[idx].max()) + 1, C)
        slot = torch.arange(W, device=dev)
        key = r0[idx, :W]
        m = (slot < nch[idx, None]) & (key <= p_r[:, None])
        best = torch.where(m, key, _I64_MIN).max(dim=1).values
        # the rightmost chain of the predecessor key is the latest created
        ci = torch.where(m & (key == best[:, None]), slot, -1).max(dim=1).values
        has_pred = ci >= 0
        cis = ci.clamp(min=0)
        c_rid, c_q0, c_r0 = crid[idx, cis], q0[idx, cis], r0[idx, cis]
        c_ql, c_rl, c_ll = ql[idx, cis], rl[idx, cis], ll[idx, cis]
        same = has_pred & (p_rid == c_rid)
        contained = (same & (p_q >= c_q0) & (p_q + p_l <= c_ql + c_ll)
                     & (p_r >= c_r0) & (p_r + p_l <= c_rl + c_ll))
        strand_blk = ((c_rl < l_pac) | (c_r0 < l_pac)) & (p_r >= l_pac)
        x, y = p_q - c_ql, p_r - c_rl
        can = ((y >= 0) & (x - y <= params.w) & (y - x <= params.w)
               & (x - c_ll < params.max_chain_gap)
               & (y - c_ll < params.max_chain_gap))
        append = same & ~contained & ~strand_blk & can
        newc = ~contained & ~append
        full = newc & (nch[idx] >= C)
        ovf[idx[full]] = True
        newc = newc & ~full
        ni, nsl = idx[newc], nch[idx[newc]]
        crid[ni, nsl], q0[ni, nsl], r0[ni, nsl] = p_rid[newc], p_q[newc], p_r[newc]
        nch[ni] += 1
        join = append | newc
        ji = idx[join]
        js = torch.where(append, cis, nch[idx] - 1)[join]
        jq, jr, jl = p_q[join], p_r[join], p_l[join]
        ql[ji, js], rl[ji, js], ll[ji, js] = jq, jr, jl
        ns[ji, js] += 1
        # mem_chain_weight, one seed at a time
        eq, er = jq + jl, jr + jl
        wq[ji, js] += (eq - torch.maximum(endq[ji, js], jq)).clamp(min=0)
        wr[ji, js] += (er - torch.maximum(endr[ji, js], jr)).clamp(min=0)
        endq[ji, js] = torch.maximum(endq[ji, js], eq)
        endr[ji, js] = torch.maximum(endr[ji, js], er)
        assign[g[join]] = js
    nch = torch.where(ovf, 0, nch)
    nslots = torch.where(ovf, C + 1, nch).to(torch.int32)

    # ---- mem_chain_flt in sorted space: weight descending, key order on ties
    W = max(int(nch.max()) if B else 0, 1)
    slot = torch.arange(W, device=dev)
    used = slot < nch[:, None]
    weight = torch.minimum(wq, wr).clamp(max=_W_CAP)[:, :W]
    alive = used & (weight >= params.min_chain_weight)
    perm_pos = torch.sort(torch.where(used, r0[:, :W], _I64_MAX), dim=1,
                          stable=True).indices
    w_pos = torch.where(alive.gather(1, perm_pos), -weight.gather(1, perm_pos),
                        _I64_MAX)
    order = perm_pos.gather(1, torch.sort(w_pos, dim=1, stable=True).indices)
    n_alive = alive.sum(dim=1)
    sw = weight.gather(1, order)
    sqb = q0[:, :W].gather(1, order)
    sqe = (ql + ll)[:, :W].gather(1, order)
    srid = crid[:, :W].gather(1, order)
    salt = ctg.ctg_alt[srid] > 0
    sl = sqe - sqb
    kept = torch.zeros((B, W), dtype=i64, device=dev)
    kept[:, 0] = torch.where(n_alive > 0, 3, 0)
    first = torch.full((B, W), -1, dtype=i64, device=dev)
    for i in range(1, int(n_alive.max()) if B else 0):
        act = (n_alive > i).nonzero().squeeze(1)
        validj = (kept[act] >= 2) & (slot < i)
        b_max = torch.maximum(sqb[act], sqb[act, i, None])
        e_min = torch.minimum(sqe[act], sqe[act, i, None])
        min_l = torch.minimum(sl[act], sl[act, i, None])
        big_ov = ((e_min > b_max) & ~(salt[act] & ~salt[act, i, None])
                  & ((e_min - b_max).double()
                     >= min_l.double() * params.mask_level)
                  & (min_l < params.max_chain_gap))
        wi = sw[act, i, None]
        dropj = (validj & big_ov
                 & (wi.double() < sw[act].double() * params.drop_ratio)
                 & (sw[act] - wi >= (params.min_seed_len << 1)))
        fb = torch.where(dropj, slot, W).min(dim=1).values
        seen = validj & (slot <= fb[:, None]) & big_ov
        fa = first[act]
        first[act] = torch.where(seen & (fa < 0), i, fa)
        kept[act, i] = torch.where(fb < W, 0, torch.where(seen.any(dim=1), 2, 3))
    # the first shadowed chain of each kept chain is retained (kept = 1)
    tgt = torch.where((kept >= 2) & (first >= 0), first, W)
    bump = torch.zeros((B, W + 1), dtype=i64, device=dev).scatter_(
        1, tgt, torch.ones_like(tgt))
    kept = torch.maximum(kept, bump[:, :W])
    extc = torch.cumsum((kept >= 2).long(), dim=1)
    emit = (kept > 0) & ~((kept >= 2) & (extc > params.max_chain_extend))

    # ---- the flat output
    n_chain = emit.sum(dim=1)
    eb, ej = emit.nonzero(as_tuple=True)  # read order, then output order
    eslot = order[eb, ej]
    e_ns = ns[eb, eslot]
    chain_rows = torch.stack(
        [srid[eb, ej], ctg.ctg_alt.long()[srid[eb, ej]], e_ns,
         frac.view(i64)[eb], sw[eb, ej], kept[eb, ej], first[eb, ej]], dim=1)
    outpos = torch.cumsum(emit.long(), dim=1) - 1
    slot_out = torch.full((B, W), -1, dtype=i64, device=dev)
    slot_out[eb, eslot] = outpos[eb, ej]
    n_seed = torch.zeros(B, dtype=i64, device=dev).index_add_(0, eb, e_ns)
    sel = (assign >= 0).nonzero().squeeze(1)
    sel = sel[~ovf[s_read[sel]]]
    op = slot_out[s_read[sel], assign[sel]]
    sel, op = sel[op >= 0], op[op >= 0]
    sel = sel[torch.sort(s_read[sel] * W + op, stable=True).indices]
    seed_rows = torch.stack([s_rbeg[sel], s_qb[sel], s_len[sel], s_len[sel]], dim=1)
    return Chains(chain_rows, seed_rows, n_chain, n_seed, seed_cnt, ovf, nslots)


# ------------------------------------------------------------------- kernels

def _bind(lib):
    p, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_double)
    table = [p] * 8 + [i64, i32]  # the seed table, seed_off, n_rbegs, B
    ctg = [p, p, i32, i64]  # ctg_end, ctg_alt, n_ctg, l_pac
    for name, rest in (
        ("bwamem_chain_launch", [i64] * 6 + [f64, f64, i32] + [p] * 12),
        ("bwamem_chain_emit_launch", [p] * 12),
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = table + ctg + rest
    lib.bwamem_chain_warps_per_sm.restype = ctypes.c_int
    lib.bwamem_chain_warps_per_sm.argtypes = []


def _lib():
    from ..utils import cudabuild

    return cudabuild.load("chain", _bind)


def _launched(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    tally()["chain"] += 1


def _table_args(ctg: DeviceContigs, tab: SeedTable, seed_off):
    return (tab.qlen.data_ptr(), tab.rows.data_ptr(), tab.intv_off.data_ptr(),
            tab.n_intv.data_ptr(), tab.rbegs.data_ptr(), tab.rbeg_off.data_ptr(),
            tab.cnt.data_ptr(), seed_off.data_ptr(), tab.rbegs.numel(),
            tab.qlen.shape[0], ctg.ctg_end.data_ptr(), ctg.ctg_alt.data_ptr(),
            ctg.ctg_end.numel(), ctg.l_pac)


# The *_launch functions launch a kernel on prepared operands (as
# ``chain_cuda`` prepares them: contiguous, typed, on the card; outputs,
# scratch and the int32 [1] flag word allocated by the caller) and leave the
# flags for the caller to read.

def read_order(seed_cnt: torch.Tensor) -> torch.Tensor:
    """The order in which both chain kernels' warps take the reads: the
    most seeds first, ties in read order; int32 [B].  Scheduling only: a
    read writes only its own rows, so no result depends on it."""
    return torch.sort(seed_cnt, descending=True,
                      stable=True).indices.to(torch.int32)


def chain_launch(ctg, tab, seed_off, params: ChainParams, C, order, assign,
                 slot_dst, crec, n_chain, n_seed, frac, ovf, nslots, err):
    """The count pass, its warps taking the reads in ``order``
    (``read_order``): per read ``n_chain``, ``n_seed`` int64, ``frac``
    float64, ``ovf``, ``nslots`` int32 [B]; scratch ``assign``,
    ``slot_dst`` int32 [T] and ``crec`` int32 [T, 5] for the emit pass."""
    nxt = torch.empty(1, dtype=torch.int32, device=ctg.device)
    with on_device(ctg.device):
        _launched("chain", _lib().bwamem_chain_launch(
            *_table_args(ctg, tab, seed_off), params.w, params.max_chain_gap,
            params.min_chain_weight, params.min_seed_len, params.max_chain_extend,
            params.max_occ, params.mask_level, params.drop_ratio, C,
            order.data_ptr(), nxt.data_ptr(), assign.data_ptr(),
            slot_dst.data_ptr(), crec.data_ptr(), n_chain.data_ptr(),
            n_seed.data_ptr(), frac.data_ptr(), ovf.data_ptr(), nslots.data_ptr(),
            err.data_ptr(), stream(ctg.device)))


def warps_per_sm(device="cuda") -> int:
    """Warps of ``chain_kernel`` resident on one SM of ``device`` (the CUDA
    occupancy calculator's figure); -1 on error."""
    with on_device(device):
        return int(_lib().bwamem_chain_warps_per_sm())


def chain_emit_launch(ctg, tab, seed_off, order, assign, slot_dst, crec,
                      n_chain, frac, chain_off, seed_dst, chain_rows,
                      seed_rows):
    """The emit pass, its warps taking the reads in ``order``
    (``read_order``): ``chain_rows`` [Nc, 7] and ``seed_rows`` [Ns, 4] at
    the exclusive scans ``chain_off``/``seed_dst`` of the count pass's
    counts.  It reads the count pass's scratch and writes only the two
    outputs (16-byte aligned), so it may be launched again on the same
    operands."""
    for t in (chain_rows, seed_rows):
        if t.data_ptr() % 16:
            raise ValueError("the emit pass's outputs must be 16-byte aligned")
    nxt = torch.empty(1, dtype=torch.int32, device=ctg.device)
    with on_device(ctg.device):
        _launched("chain_emit", _lib().bwamem_chain_emit_launch(
            *_table_args(ctg, tab, seed_off), order.data_ptr(), nxt.data_ptr(),
            assign.data_ptr(), slot_dst.data_ptr(), crec.data_ptr(),
            n_chain.data_ptr(), frac.data_ptr(), chain_off.data_ptr(),
            seed_dst.data_ptr(), chain_rows.data_ptr(), seed_rows.data_ptr(),
            stream(ctg.device)))


def prepare(ctg: DeviceContigs, tab: SeedTable):
    """``tab`` as the kernels take it (contiguous, typed, on the contig
    tables' card) and the per-read seed counts and offsets."""
    dev = ctg.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need tensors on the card, not {dev}")
    _check_table(tab)
    if tab.qlen.device != dev:
        raise ValueError(f"expected tensors on {dev}, got {tab.qlen.device}")
    tab = SeedTable(tab.qlen.to(torch.int32).contiguous(),
                    *(t.to(torch.int64).contiguous() for t in tab[1:]))
    seed_cnt, seed_off, _, _ = _seed_counts(tab)
    return tab, seed_cnt, seed_off.contiguous()


def chain_cuda(ctg: DeviceContigs, tab: SeedTable, params: ChainParams,
               C: int = C_MAX) -> Chains:
    """The chain kernels (the count pass and the emit pass, each a warp
    per read, heaviest first); same contract as ``chain_torch``."""
    _check_budget(C)
    tab, seed_cnt, seed_off = prepare(ctg, tab)
    dev = ctg.device
    B = tab.qlen.shape[0]
    i32, i64 = torch.int32, torch.int64
    n_chain, n_seed = (torch.zeros(B, dtype=i64, device=dev) for _ in range(2))
    ovf, nslots = (torch.zeros(B, dtype=i32, device=dev) for _ in range(2))
    if not B:
        return Chains(torch.zeros((0, 7), dtype=i64, device=dev),
                      torch.zeros((0, 4), dtype=i64, device=dev), n_chain,
                      n_seed, seed_cnt, ovf.bool(), nslots)
    T = int(seed_cnt.sum())
    assign, slot_dst = (torch.empty(T, dtype=i32, device=dev) for _ in range(2))
    crec = torch.empty((T, 5), dtype=i32, device=dev)
    frac = torch.empty(B, dtype=torch.float64, device=dev)
    err = torch.zeros(1, dtype=i32, device=dev)
    order = read_order(seed_cnt)
    chain_launch(ctg, tab, seed_off, params, C, order, assign, slot_dst, crec,
                 n_chain, n_seed, frac, ovf, nslots, err)
    chain_off, seed_dst = _excl_scan(n_chain), _excl_scan(n_seed)
    nc, nsd, flags = torch.stack(
        [n_chain.sum(), n_seed.sum(), err[0].long()]).tolist()
    if flags & ERR_RANGE:
        raise ValueError("chain: an interval's seeds lie outside rbegs")
    chain_rows = torch.empty((nc, 7), dtype=i64, device=dev)
    seed_rows = torch.empty((nsd, 4), dtype=i64, device=dev)
    if nc:
        chain_emit_launch(ctg, tab, seed_off, order, assign, slot_dst, crec,
                          n_chain, frac, chain_off, seed_dst, chain_rows,
                          seed_rows)
    return Chains(chain_rows, seed_rows, n_chain, n_seed, seed_cnt, ovf.bool(),
                  nslots)


# ---------------------------------------------------------------- dispatcher

def chain(ctg: DeviceContigs, tab: SeedTable, params: ChainParams,
          C: int = C_MAX) -> Chains:
    """CPU tensors -> ``chain_torch``; CUDA tensors -> the kernels."""
    fn = chain_cuda if tab.qlen.device.type == "cuda" else chain_torch
    return fn(ctg, tab, params, C)


def ref_overflows(seed_cnt: np.ndarray, nslots: np.ndarray) -> Tuple[int, int]:
    """The reads of a batch that the JAX package's budgets would have sent
    to the host: those with more seeds than the batch's S bucket (64 when
    the largest read is past every bucket), and of the others those that
    use more chain slots than its C bucket."""
    if not len(seed_cnt):
        return 0, 0
    max_s = max(int(seed_cnt.max()), 1)
    S = next((b for b in REF_S_BUCKETS if max_s <= b), REF_S_BUCKETS[0])
    C = next(b for b in REF_C_BUCKETS if min(max_s, REF_C_BUCKETS[-1]) <= b)
    s_ovf = seed_cnt > S
    return int(s_ovf.sum()), int((~s_ovf & (nslots > C)).sum())


def chains_device_batch(ctg: DeviceContigs, tab: SeedTable, params: ChainParams,
                        C: int = C_MAX):
    """mem_chain + chain_flt for a batch on the tables' device: per read its
    ``Chain`` list in the host oracle's order with ``w``, ``kept`` and
    ``first`` set (None for a read flagged by the C budget, which its
    caller chains on the host), and the ``Chains`` counts on the host as
    ``(ovf, seed_cnt, nslots)`` numpy arrays.  One copy back."""
    return chain_lists(chain(ctg, tab, params, C))


def chain_lists(out: Chains):
    """``chains_device_batch``'s result from the ``Chains`` of a batch."""
    B = out.n_chain.shape[0]
    nc = out.chain_rows.shape[0]
    flat = torch.cat([out.n_chain, out.n_seed, out.seed_cnt, out.ovf.long(),
                      out.nslots.long(), out.chain_rows.reshape(-1),
                      out.seed_rows.reshape(-1)]).cpu().numpy()
    meta = flat[:5 * B].reshape(5, B)
    n_chain, ovf = meta[0].tolist(), meta[3] != 0
    chain_rows = flat[5 * B: 5 * B + 7 * nc].reshape(nc, 7)
    seed_rows = flat[5 * B + 7 * nc:].reshape(-1, 4).tolist()
    frac = chain_rows[:, 3].copy().view(np.float64).tolist()
    crow = chain_rows.tolist()
    chains_list: List[Optional[List[Chain]]] = []
    ci = si = 0
    for i in range(B):
        if ovf[i]:
            chains_list.append(None)
            continue
        chains = []
        for _ in range(n_chain[i]):
            rid, is_alt, ns, _, w, kept, first = crow[ci]
            seeds = [Seed(rbeg=sr[0], qbeg=sr[1], len=sr[2], score=sr[3])
                     for sr in seed_rows[si: si + ns]]
            si += ns
            chains.append(Chain(rid=rid, seeds=seeds, is_alt=is_alt,
                                frac_rep=frac[ci], w=w, kept=kept, first=first))
            ci += 1
        chains_list.append(chains)
    return chains_list, (ovf, meta[2], meta[4])
