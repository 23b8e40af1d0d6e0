"""Batched banded affine-gap SW extension (ksw_extend2 semantics), PyTorch.

The counterpart of bwamem_tpu/ops/extend_tpu.py and ops/extend_pallas.py:

* ``ksw_extend_torch`` is the plain PyTorch version of
  ``extend_tpu.ksw_extend_batch``: a row loop of ``[B, Q]`` tensor ops with
  the horizontal-gap recurrence F as a cummax, stopping once every job is
  done.  It runs wherever its tensors lie.
* ``ksw_extend_cuda`` launches the hand-written Hopper kernel
  (``csrc/extend.cu``), the port of the Pallas ``_extend_kernel``.
* ``ksw_extend`` dispatches on the device of its inputs: CPU tensors go to
  the plain version, CUDA tensors to the kernel.
* ``ksw_extend_batch_np`` is the entry of each extension wave: numpy
  jobs in, one dict of results per job out.

All take the JAX package's public layout: ``qseq [B, Q]`` and ``tseq [B, T]``
codes 0-4, per-job ``[B]`` int32 ``qlen, tlen, h0, w, end_bonus``, a ``[5, 5]``
int32 matrix, and return six ``[B]`` int32 results keyed like
``ksw_extend_batch``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List

import numpy as np
import torch

from ..engine.state import DeviceScoring

KEYS = ("score", "qle", "tle", "gtle", "gscore", "max_off")
# launches of the CUDA kernel; bumped only where it is launched
LAUNCHES = 0


def band_width(qlen, w, end_bonus, max_sc: int, o_del: int, e_del: int,
               o_ins: int, e_ins: int):
    """ksw_extend2's preamble: the band ``w`` clamped by the longest gap that
    could still score, per job.  One copy for the plain version and the
    kernel (which receives the result), with the JAX kernels' floor
    division (extend_pallas.py:293-296)."""
    max_ins = (qlen * max_sc + end_bonus - o_ins) // e_ins + 1
    max_del = (qlen * max_sc + end_bonus - o_del) // e_del + 1
    w = torch.minimum(w, max_ins.clamp(min=1))
    return torch.minimum(w, max_del.clamp(min=1))


def _last_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the last maximum along dim 1 (bwa's >= tie-break)."""
    n = x.shape[1]
    return (n - 1) - torch.argmax(x.flip(1), dim=1)


def _first_true(m: torch.Tensor) -> torch.Tensor:
    return torch.argmax(m.to(torch.int32), dim=1)


def ksw_extend_torch(qseq, tseq, qlen, tlen, h0, w, end_bonus, mat,
                     o_del: int, e_del: int, o_ins: int, e_ins: int,
                     zdrop: int, max_sc: int) -> Dict[str, torch.Tensor]:
    """Plain PyTorch ksw_extend2 over a batch; a line-for-line translation of
    ``extend_tpu.ksw_extend_batch`` (row scan with early exit)."""
    dev = qseq.device
    i32 = torch.int32
    B, Q = qseq.shape
    T = tseq.shape[1]
    qseq = qseq.to(torch.int64)
    tseq = tseq.to(torch.int64)
    qlen, tlen, h0 = qlen.to(i32), tlen.to(i32), h0.to(i32)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    cc = torch.arange(Q, dtype=i32, device=dev)[None, :]
    jj = torch.arange(Q + 1, dtype=i32, device=dev)[None, :]
    w_adj = band_width(qlen, w.to(i32), end_bonus.to(i32), max_sc, o_del,
                       e_del, o_ins, e_ins)
    qprof = mat.to(i32)[:, qseq].permute(1, 0, 2)  # [B, 5, Q]
    zero = torch.zeros((), dtype=i32, device=dev)

    eh_h = (h0[:, None] - oe_ins - (jj - 1) * e_ins).clamp(min=0)
    eh_h[:, 0] = h0
    eh_h = torch.where(jj <= qlen[:, None], eh_h, zero)
    eh_e = torch.zeros((B, Q + 1), dtype=i32, device=dev)
    qmask = (jj == qlen[:, None]).to(i32)
    beg = torch.zeros(B, dtype=i32, device=dev)
    end = qlen.clone()
    done = tlen <= 0
    maxv = h0.clone()
    max_i = torch.full((B,), -1, dtype=i32, device=dev)
    max_j = max_i.clone()
    max_ie = max_i.clone()
    gscore = max_i.clone()
    max_off = torch.zeros(B, dtype=i32, device=dev)
    brow = torch.arange(B, device=dev)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)

    for i in range(T):
        if bool(done.all()):
            break
        beg_w = torch.maximum(beg, i - w_adj)
        end_w = torch.minimum(torch.minimum(end, i + w_adj + 1), qlen)
        in_win = (cc >= beg_w[:, None]) & (cc < end_w[:, None])
        h1 = torch.where(beg_w == 0, (h0 - (o_del + e_del * (i + 1))).clamp(min=0),
                         zero)
        q = qprof[brow, tseq[:, i]]  # [B, Q]
        Hdiag = eh_h[:, :Q]
        M = torch.where(Hdiag != 0, Hdiag + q, zero)
        M = torch.where(in_win, M, zero)
        E = torch.where(in_win, eh_e[:, :Q], zero)
        Mc = (M - oe_ins).clamp(min=0)
        P = torch.cummax(Mc + cc * e_ins, dim=1).values
        F = torch.cat([zcol, P[:, :-1] - (cc[:, 1:] - 1) * e_ins], dim=1)
        F = torch.where(in_win, F.clamp(min=0), zero)
        Hrow = torch.where(in_win, torch.maximum(torch.maximum(M, E), F), zero)
        E_next = torch.maximum(E - e_del, (M - oe_del).clamp(min=0))
        E_next = torch.where(in_win, E_next, zero)
        mrow = Hrow.max(dim=1).values
        mj = _last_argmax(Hrow).to(i32)
        H_shift = torch.cat([zcol, Hrow], dim=1)
        write_h = (jj > beg_w[:, None]) & (jj <= end_w[:, None])
        eh_h2 = torch.where(write_h, H_shift, eh_h)
        eh_h2 = torch.where(jj == beg_w[:, None], h1[:, None], eh_h2)
        E_pad = torch.cat([E_next, zcol], dim=1)
        write_e = (jj >= beg_w[:, None]) & (jj < end_w[:, None])
        eh_e2 = torch.where(write_e, E_pad, eh_e)
        eh_e2 = torch.where(jj == end_w[:, None], zero, eh_e2)
        reaches = end_w == qlen
        h_last = (H_shift * qmask).sum(dim=1, dtype=i32)
        active = ~done & (i < tlen)
        upd_g = reaches & (gscore <= h_last) & active
        gscore = torch.where(upd_g, h_last, gscore)
        max_ie = torch.where(upd_g, i, max_ie)
        brk_zero = mrow == 0
        improved = mrow > maxv
        di = i - max_i
        dj = mj - max_j
        zcond = torch.where(di > dj, maxv - mrow - (di - dj) * e_del > zdrop,
                            maxv - mrow - (dj - di) * e_ins > zdrop)
        brk_z = ~improved & zcond if zdrop > 0 else torch.zeros_like(improved)
        upd = active & improved
        max_off = torch.where(upd, torch.maximum(max_off, (mj - i).abs()), max_off)
        maxv = torch.where(upd, mrow, maxv)
        max_i = torch.where(upd, i, max_i)
        max_j = torch.where(upd, mj, max_j)
        done = done | (i + 1 >= tlen) | (active & (brk_zero | brk_z))
        # window shrink over eh indices [beg, end]
        alive = ~((eh_h2 == 0) & (eh_e2 == 0))
        alive = alive & (jj >= beg_w[:, None]) & (jj <= end_w[:, None])
        any_alive = alive.any(dim=1)
        beg2 = torch.where(any_alive, _first_true(alive).to(i32), end_w)
        jmax = torch.where(any_alive, (Q - _first_true(alive.flip(1))).to(i32),
                           beg2 - 1)
        end2 = torch.minimum(jmax + 2, qlen)
        keep = active[:, None]
        eh_h = torch.where(keep, eh_h2, eh_h)
        eh_e = torch.where(keep, eh_e2, eh_e)
        beg = torch.where(active, beg2, beg)
        end = torch.where(active, end2, end)
    return dict(score=maxv, qle=max_j + 1, tle=max_i + 1, gtle=max_ie + 1,
                gscore=gscore, max_off=max_off)


# ------------------------------------------------------------------ kernel

def _bind(lib):
    fn = lib.bwamem_ksw_extend_launch
    fn.restype = ctypes.c_int
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [p, i64, p, i64, p, i64, p, p, p,
                   i32, i32, i32, i32, i32, i32, i32, p]


def ksw_extend_launch(q: torch.Tensor, t: torch.Tensor, scal: torch.Tensor,
                      mat: torch.Tensor, Q: int, o_del: int, e_del: int,
                      o_ins: int, e_ins: int, zdrop: int) -> torch.Tensor:
    """One launch of the kernel on prepared operands, the step that
    ``ksw_extend_cuda`` and ``ksw_extend_batch_np`` share.  ``q`` [B, >=Q]
    and ``t`` [B, >=T] uint8 codes with unit column stride; ``scal``
    [B, >=4] int32 = qlen, tlen, h0, w_adj (``band_width``); ``mat`` [5, 5]
    int32.  Returns [6, B] int32 in ``KEYS`` order."""
    global LAUNCHES
    from ..utils import cudabuild

    dev = q.device
    for x, dt in ((q, torch.uint8), (t, torch.uint8), (scal, torch.int32),
                  (mat, torch.int32)):
        if x.device != dev or x.dtype != dt:
            raise ValueError(f"expected {dt} on {dev}, got {x.dtype} on {x.device}")
        if x.dim() != 2 or x.stride(1) != 1:
            raise ValueError("kernel operands must be 2-D with unit column stride")
    B = q.shape[0]
    if t.shape[0] != B or scal.shape[0] != B or scal.shape[1] < 4:
        raise ValueError("q, t and scal must share the job dimension")
    if q.shape[1] < Q or not mat.is_contiguous() or mat.numel() != 25:
        raise ValueError("bad query width or scoring matrix")
    lib = cudabuild.load("extend", _bind)
    eh = torch.empty((2, Q + 1, B), dtype=torch.int32, device=dev)
    out = torch.empty((6, B), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    rc = lib.bwamem_ksw_extend_launch(
        q.data_ptr(), q.stride(0), t.data_ptr(), t.stride(0),
        scal.data_ptr(), scal.stride(0), mat.data_ptr(), eh.data_ptr(),
        out.data_ptr(), B, Q, o_del, e_del, o_ins, e_ins, zdrop,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ksw_extend kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def ksw_extend_cuda(qseq, tseq, qlen, tlen, h0, w, end_bonus, mat,
                    o_del: int, e_del: int, o_ins: int, e_ins: int,
                    zdrop: int, max_sc: int) -> Dict[str, torch.Tensor]:
    """The Hopper kernel on CUDA tensors, same contract as
    ``ksw_extend_torch``."""
    if qseq.device.type != "cuda":
        raise ValueError(f"ksw_extend_cuda needs CUDA tensors, got {qseq.device}")
    B, Q = qseq.shape
    T = tseq.shape[1]
    for x in (qlen, tlen, h0, w, end_bonus):
        if x.shape != (B,):
            raise ValueError(f"per-job arrays must be [{B}], got {tuple(x.shape)}")
    if tseq.shape[0] != B or mat.shape != (5, 5):
        raise ValueError("tseq must be [B, T] and mat [5, 5]")
    if bool((qlen > Q).any() | (tlen > T).any() | (qlen < 0).any()
            | (tlen < 0).any()):
        raise ValueError("qlen/tlen outside [0, sequence width]")
    if bool(((qseq < 0) | (qseq > 4)).any() | ((tseq < 0) | (tseq > 4)).any()):
        raise ValueError("sequence codes must be 0-4")
    i32 = torch.int32
    w_adj = band_width(qlen.to(i32), w.to(i32), end_bonus.to(i32), max_sc,
                       o_del, e_del, o_ins, e_ins)
    scal = torch.stack([qlen.to(i32), tlen.to(i32), h0.to(i32), w_adj], dim=1)
    out = ksw_extend_launch(qseq.to(torch.uint8).contiguous(),
                            tseq.to(torch.uint8).contiguous(), scal,
                            mat.to(i32).contiguous(), Q, o_del, e_del, o_ins,
                            e_ins, zdrop)
    return dict(zip(KEYS, out.unbind(0)))


def ksw_extend(qseq, tseq, qlen, tlen, h0, w, end_bonus, mat, o_del: int,
               e_del: int, o_ins: int, e_ins: int, zdrop: int,
               max_sc: int) -> Dict[str, torch.Tensor]:
    """CPU tensors -> ``ksw_extend_torch``; CUDA tensors -> the kernel."""
    fn = ksw_extend_cuda if qseq.device.type == "cuda" else ksw_extend_torch
    return fn(qseq, tseq, qlen, tlen, h0, w, end_bonus, mat, o_del, e_del,
              o_ins, e_ins, zdrop, max_sc)


def ksw_extend_batch_np(qseqs, tseqs, scoring: DeviceScoring, h0s, ws,
                        bonuses) -> List[dict]:
    """Host wrapper: lists of numpy (qseq, tseq) codes -> one result dict per
    job, on ``scoring``'s device.

    The wave moves as one packed ``[B, Q+T]`` uint8 host-to-device copy, one
    ``[B, 5]`` int32 copy (qlen, tlen, h0, w_adj, end_bonus), one launch and
    one ``[6, B]`` device-to-host copy.  Q and T are the wave's longest
    query and target: the kernel takes them at run time."""
    sc = scoring
    B = len(qseqs)
    qlens = np.fromiter((len(x) for x in qseqs), dtype=np.int64, count=B)
    tlens = np.fromiter((len(x) for x in tseqs), dtype=np.int64, count=B)
    Q = max(int(qlens.max(initial=0)), 1)
    T = max(int(tlens.max(initial=0)), 1)
    seqs = np.zeros((B, Q + T), dtype=np.uint8)
    for lens, parts, off in ((qlens, qseqs, 0), (tlens, tseqs, Q)):
        if lens.sum():
            rows = np.repeat(np.arange(B), lens)
            starts = np.cumsum(lens) - lens
            cols = np.arange(int(lens.sum())) - np.repeat(starts, lens) + off
            seqs[rows, cols] = np.concatenate([np.asarray(x) for x in parts])
    scal = torch.from_numpy(np.stack(
        [qlens, tlens, np.asarray(h0s, np.int64), np.asarray(ws, np.int64),
         np.asarray(bonuses, np.int64)], axis=1).astype(np.int32))
    dev = sc.mat.device
    seqs_t = torch.from_numpy(seqs)
    if dev.type == "cuda":
        scal[:, 3] = band_width(scal[:, 0], scal[:, 3], scal[:, 4], sc.max_sc,
                                sc.o_del, sc.e_del, sc.o_ins, sc.e_ins)
        seqs_d = seqs_t.to(dev)
        out = ksw_extend_launch(seqs_d[:, :Q], seqs_d[:, Q:], scal.to(dev),
                                sc.mat, Q, sc.o_del, sc.e_del, sc.o_ins,
                                sc.e_ins, sc.zdrop)
        stacked = out.cpu().numpy()
    else:
        res = ksw_extend(seqs_t[:, :Q], seqs_t[:, Q:], *scal.unbind(1), sc.mat,
                         sc.o_del, sc.e_del, sc.o_ins, sc.e_ins, sc.zdrop,
                         sc.max_sc)
        stacked = torch.stack([res[k] for k in KEYS]).numpy()
    cols = [stacked[j].tolist() for j in range(len(KEYS))]
    return [dict(zip(KEYS, vals)) for vals in zip(*cols)]
