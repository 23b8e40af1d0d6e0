"""Device-resident FM index: rank queries, bi-interval extension and
sampled-SA walks, PyTorch.

The counterpart of bwamem_tpu/ops/fmindex_tpu.py:

* ``DeviceFMIndex.from_host`` builds the same fused lines: one row per
  ``span`` BWT characters, ``[4 counts | span/16 packed words]``, held as
  int32 tensors of the u32 bit patterns.  ``L2`` and the sampled SA are
  int64 at every genome size, so there is one coordinate domain.
* ``occ4_torch``, ``extend_torch``, ``sa_lookup_torch`` and
  ``backward_search_torch`` are the plain PyTorch versions of
  ``occ4_device``, ``extend_device``, ``sa_lookup`` and (ops/seed_tpu.py)
  ``backward_search_batch``; they run wherever their tensors lie.  The SA walk is a
  loop over the rows still walking (boolean-mask compaction); the JAX
  compaction ladder is a TPU workaround and is not carried over.
* ``occ4_cuda``, ``extend_cuda``, ``sa_lookup_cuda`` and
  ``backward_search_cuda`` launch the hand-written Hopper kernels of
  ``csrc/fmindex.cu``.
* ``occ4``, ``extend``, ``sa_lookup`` and ``backward_search`` dispatch on the device of their
  inputs: CPU tensors go to the plain version, CUDA tensors to the kernel.

Conceptual rows follow bwa (engine/fmindex.py): row ``primary`` carries the
implicit sentinel, so the occ offset of row k is ``k - (k >= primary)`` and
its BWT character sits at ``k - (k > primary)``; ``occ4(-1)`` is 0 and
``occ4(seq_len)`` the full counts; an LF step from ``primary`` lands on row
0, and ``sa[0] == -1`` turns a walk through it into the right position.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

# launches of each CUDA kernel; bumped only where it is launched
LAUNCHES = {"occ4": 0, "bwt_extend": 0, "sa_lookup": 0, "backward_search": 0}
# error flags the kernels raise (OR-ed into one int32 on the device)
ERR_ROW_RANGE = 1
ERR_WALK_LENGTH = 2

_M55 = 0x55555555
_M33 = 0x33333333
_M0F = 0x0F0F0F0F
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class DeviceFMIndex:
    """FM index on one device: fused occ lines, sampled SA, statics."""

    lines: torch.Tensor  # [nb, 4 + span//16] int32: u32 counts, packed words
    L2: torch.Tensor  # [5] int64
    sa: torch.Tensor  # [n_sa] int64, sampled suffix array (sa[0] == -1)
    primary: int
    seq_len: int
    sa_intv: int
    span: int  # chars per line; power-of-two multiple of 128

    @property
    def device(self) -> torch.device:
        return self.lines.device

    @classmethod
    def from_host(cls, fm, device, span: int = 128) -> "DeviceFMIndex":
        """``fm`` (an ``engine.fmindex.FMIndex``) -> its tables on
        ``device``; the lines are those of ``fmindex_tpu.DeviceFMIndex``
        bit for bit."""
        if span % 128 or span & (span - 1):
            raise ValueError("span must be a power-of-two multiple of 128")
        per_sym = np.diff(np.asarray(fm.L2).astype(np.int64))
        if (per_sym >= (1 << 31)).any():
            raise ValueError("per-symbol occ counts exceed int32")
        m = span // 128
        nb = -(-fm.seq_len // span) or 1
        counts = fm.ckpt[: nb * m : m].astype(np.uint32)
        words = np.zeros((nb * m, 8), dtype=np.uint32)
        words[: fm.words.shape[0]] = fm.words
        lines = np.concatenate([counts, words.reshape(nb, 8 * m)], axis=1)
        return cls(
            lines=torch.from_numpy(lines.view(np.int32)).to(device),
            L2=torch.from_numpy(np.asarray(fm.L2, np.int64).copy()).to(device),
            sa=torch.from_numpy(np.asarray(fm.sa, np.int64).copy()).to(device),
            primary=int(fm.primary),
            seq_len=int(fm.seq_len),
            sa_intv=int(fm.sa_intv),
            span=span,
        )


# ------------------------------------------------------------ plain versions

def _check_rows(dfm: DeviceFMIndex, k: torch.Tensor, lo: int):
    if k.numel() and bool(((k < lo) | (k > dfm.seq_len)).any()):
        raise ValueError(f"rows must lie in [{lo}, seq_len={dfm.seq_len}]")


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int64 holding a u32 value."""
    x = x - ((x >> 1) & _M55)
    x = (x & _M33) + ((x >> 2) & _M33)
    x = (x + (x >> 4)) & _M0F
    return ((x * 0x01010101) & _U32) >> 24


def _rows_for(dfm: DeviceFMIndex, k: torch.Tensor):
    """Each row's fused line split into counts [N, 4] and u32 words
    [N, span/16] (int64), and the chars of the line counted through k."""
    kk = (k - (k >= dfm.primary).long()).clamp(min=0)
    row = dfm.lines[kk >> (dfm.span.bit_length() - 1)].long()
    within = (kk & (dfm.span - 1)) + 1
    return row[:, :4], row[:, 4:] & _U32, within


def _planes(words: torch.Tensor, nchars: torch.Tensor):
    """The high and low bit planes of each word, aligned to the low bit of
    each 2-bit char, and the mask of the first ``nchars`` chars."""
    base = 16 * torch.arange(words.shape[1], device=words.device)
    valid = (nchars[:, None] - base).clamp(0, 16)
    keep = (torch.full_like(valid, _U32) << (32 - 2 * valid)) & _U32 & _M55
    return (words >> 1) & _M55, words & _M55, keep


def occ4_torch(dfm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """bwa bwt_occ4 for rows k [N]: counts of each symbol among conceptual
    BWT chars [0..k]; k == -1 -> 0, k == seq_len -> full counts.  [N, 4]
    int32."""
    k = k.long()
    _check_rows(dfm, k, -1)
    base, words, within = _rows_for(dfm, k)
    hi, lo, keep = _planes(words, within)
    nhi, nlo = hi ^ _M55, lo ^ _M55
    cnt = torch.stack([
        _popcount32(a & b & keep).sum(dim=1)
        for a, b in ((nhi, nlo), (nhi, lo), (hi, nlo), (hi, lo))
    ], dim=1) + base
    cnt = torch.where((k == dfm.seq_len)[:, None], dfm.L2[1:] - dfm.L2[:4], cnt)
    cnt = torch.where((k == -1)[:, None], 0, cnt)
    return cnt.to(torch.int32)


def extend_torch(dfm: DeviceFMIndex, x0, x1, s, is_back: bool):
    """Batched bidirectional bwt_extend, as ``FMIndex.extend``: (ox0, ox1)
    int64 [N, 4] indexed by queried-space symbol, sz int32 [N, 4]."""
    x0, x1, s = x0.long(), x1.long(), s.long()
    xq, xo = (x0, x1) if is_back else (x1, x0)
    n = xq.shape[0]
    both = occ4_torch(dfm, torch.cat([xq - 1, xq - 1 + s])).long()
    tk, tl = both[:n], both[n:]
    new_q = dfm.L2[:4] + 1 + tk
    sz = tl - tk
    # the sentinel row precedes symbol 3's slice when it lies in [xq, xq+s)
    has_sent = ((xq <= dfm.primary) & (xq + s - 1 >= dfm.primary)).long()
    o3 = xo + has_sent
    o2 = o3 + sz[:, 3]
    o1 = o2 + sz[:, 2]
    o0 = o1 + sz[:, 1]
    new_o = torch.stack([o0, o1, o2, o3], dim=1)
    sz = sz.to(torch.int32)
    return (new_q, new_o, sz) if is_back else (new_o, new_q, sz)


def _lf(dfm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """One LF step (bwt_invPsi) per row: one line serves the BWT char at
    k and the inclusive count (the char's offset is the count's minus one
    for every k but ``primary``, whose step is row 0)."""
    base, words, within = _rows_for(dfm, k)
    ar = torch.arange(k.shape[0], device=k.device)
    wc = within - 1
    c = (words[ar, wc >> 4] >> (30 - 2 * (wc & 15))) & 3
    hi, lo, keep = _planes(words, within)
    hi = torch.where((c >> 1)[:, None] != 0, hi, hi ^ _M55)
    lo = torch.where((c & 1)[:, None] != 0, lo, lo ^ _M55)
    cnt = base[ar, c] + _popcount32(hi & lo & keep).sum(dim=1)
    return torch.where(k == dfm.primary, 0, dfm.L2[c] + cnt)


def sa_lookup_torch(dfm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """bwa bwt_sa for rows k [N] in [0, seq_len]: text positions, int64.
    Every row walking takes the same number of steps so far, so one
    counter serves them all; rows that reach a sample leave the batch."""
    k = k.long()
    _check_rows(dfm, k, 0)
    out = torch.empty_like(k)
    idx = torch.arange(k.shape[0], device=k.device)
    steps = 0
    while True:
        hit = k % dfm.sa_intv == 0
        out[idx[hit]] = dfm.sa[k[hit] // dfm.sa_intv] + steps
        idx, k = idx[~hit], k[~hit]
        if idx.numel() == 0:
            return out
        if steps == dfm.seq_len:
            raise RuntimeError("SA walk longer than seq_len steps: the "
                               "index is inconsistent")
        k = _lf(dfm, k)
        steps += 1


def right_align_reads(reads, device):
    """Reads (codes 0-4) -> ``qseq`` [B, Lmax] uint8 with each read's last
    base in the last column (4 before its first) and ``qlen`` [B] int32, on
    ``device``: the layout ``backward_search`` takes."""
    L = max([len(r) for r in reads] + [1])
    qseq = np.full((len(reads), L), 4, dtype=np.uint8)
    for i, r in enumerate(reads):
        qseq[i, L - len(r):] = r
    qlen = np.asarray([len(r) for r in reads], dtype=np.int32)
    return (torch.from_numpy(qseq).to(device),
            torch.from_numpy(qlen).to(device))


def backward_search_torch(dfm: DeviceFMIndex, qseq, qlen):
    """bwa bwt_match_exact per read of ``qseq`` [B, L] (codes, each read's
    last base in column L - 1): backward search from the last base
    leftwards until the interval empties, on a code above 3 or after
    ``qlen`` [B] bases.  Returns the last non-empty interval (k, l) int64
    [B] and the bases matched, int32 [B]."""
    dev = qseq.device
    B, L = qseq.shape
    q = qseq.long()
    k = torch.zeros(B, dtype=torch.long, device=dev)
    l = torch.full((B,), dfm.seq_len, dtype=torch.long, device=dev)
    matched = torch.zeros(B, dtype=torch.long, device=dev)
    idx = torch.arange(B, device=dev)
    for i in range(L):
        c = q[idx, L - 1 - i]
        ok = (c <= 3) & (i < qlen.long()[idx])
        idx, c = idx[ok], c[ok]
        if idx.numel() == 0:
            break
        n = idx.numel()
        both = occ4_torch(dfm, torch.cat([k[idx] - 1, l[idx]])).long()
        r = torch.arange(n, device=dev)
        k2 = dfm.L2[c] + both[:n][r, c] + 1
        l2 = dfm.L2[c] + both[n:][r, c]
        ok = k2 <= l2
        idx = idx[ok]
        k[idx], l[idx] = k2[ok], l2[ok]
        matched[idx] += 1
    return k, l, matched.to(torch.int32)


# ------------------------------------------------------------------ kernels

def _bind(lib):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fm = [p, i32, i32, p, i64, i64]  # lines, W, log2(span), L2, primary, seq_len
    for name, rest in (
        ("bwamem_fm_occ4_launch", [p, i64, p, p, p]),
        ("bwamem_fm_extend_launch", [p, p, p, i64, i32, p, p, p, p, p]),
        ("bwamem_fm_sa_lookup_launch", [p, i64, p, i64, p, p, p]),
        ("bwamem_fm_backward_search_launch", [p, i32, p, i32, p, p, p, p]),
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = fm + rest


def _lib():
    from ..utils import cudabuild

    return cudabuild.load("fmindex", _bind)


def _fm_args(dfm: DeviceFMIndex):
    if not dfm.lines.is_contiguous():
        raise ValueError("the line table must be contiguous")
    return (dfm.lines.data_ptr(), dfm.lines.shape[1],
            dfm.span.bit_length() - 1, dfm.L2.data_ptr(), dfm.primary,
            dfm.seq_len)


def _as_rows(dfm: DeviceFMIndex, *xs: torch.Tensor):
    """1-D int64 contiguous copies of ``xs`` on the index's CUDA device."""
    dev = dfm.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need an index on the card, not {dev}")
    n = xs[0].shape[0]
    for x in xs:
        if x.device != dev or x.dim() != 1 or x.shape[0] != n:
            raise ValueError(f"expected 1-D [{n}] tensors on {dev}, got "
                             f"{tuple(x.shape)} on {x.device}")
    return [x.to(torch.int64).contiguous() for x in xs]


def _stream(dfm: DeviceFMIndex) -> int:
    return torch.cuda.current_stream(dfm.device).cuda_stream


def _launched(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _raise_flags(name: str, err: torch.Tensor):
    flags = int(err.item())
    if flags & ERR_ROW_RANGE:
        raise ValueError(f"{name}: a row lies outside the index")
    if flags & ERR_WALK_LENGTH:
        raise RuntimeError(f"{name}: SA walk longer than seq_len steps: the "
                           "index is inconsistent")


# The *_launch functions launch a kernel on prepared operands (int64 rows,
# contiguous, on the index's card; outputs and the int32 [1] flag word
# allocated by the caller) and leave the flags for the caller to read: the
# step the *_cuda wrappers share with a benchmark that times the kernel.

def occ4_launch(dfm: DeviceFMIndex, k, out, err):
    """``out`` [N, 4] int32 <- occ4 of the rows ``k`` [N]."""
    _launched("occ4", _lib().bwamem_fm_occ4_launch(
        *_fm_args(dfm), k.data_ptr(), k.shape[0], out.data_ptr(),
        err.data_ptr(), _stream(dfm)))


def extend_launch(dfm: DeviceFMIndex, x0, x1, s, is_back: bool, ox0, ox1, sz,
                  err):
    """``ox0``, ``ox1`` [N, 4] int64 and ``sz`` [N, 4] int32 <- bwt_extend
    of the bi-intervals (``x0``, ``x1``, ``s``) [N]."""
    _launched("bwt_extend", _lib().bwamem_fm_extend_launch(
        *_fm_args(dfm), x0.data_ptr(), x1.data_ptr(), s.data_ptr(),
        x0.shape[0], int(bool(is_back)), ox0.data_ptr(), ox1.data_ptr(),
        sz.data_ptr(), err.data_ptr(), _stream(dfm)))


def sa_lookup_launch(dfm: DeviceFMIndex, k, out, err):
    """``out`` [N] int64 <- the text positions of the rows ``k`` [N]."""
    _launched("sa_lookup", _lib().bwamem_fm_sa_lookup_launch(
        *_fm_args(dfm), dfm.sa.data_ptr(), dfm.sa_intv, k.data_ptr(),
        k.shape[0], out.data_ptr(), err.data_ptr(), _stream(dfm)))


def backward_search_launch(dfm: DeviceFMIndex, qseq, qlen, k, l, matched):
    """``k``, ``l`` int64 [B] and ``matched`` int32 [B] <- the backward
    search of the reads ``qseq`` uint8 [B, L] with ``qlen`` int32 [B]."""
    _launched("backward_search", _lib().bwamem_fm_backward_search_launch(
        *_fm_args(dfm), qseq.data_ptr(), qseq.shape[1], qlen.data_ptr(),
        qseq.shape[0], k.data_ptr(), l.data_ptr(), matched.data_ptr(),
        _stream(dfm)))


def _flag_word(dfm: DeviceFMIndex) -> torch.Tensor:
    return torch.zeros(1, dtype=torch.int32, device=dfm.device)


def occ4_cuda(dfm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """The occ4 kernel, one thread per row; same contract as
    ``occ4_torch``."""
    (k,) = _as_rows(dfm, k)
    out = torch.empty((k.shape[0], 4), dtype=torch.int32, device=dfm.device)
    if k.shape[0]:
        err = _flag_word(dfm)
        occ4_launch(dfm, k, out, err)
        _raise_flags("occ4", err)
    return out


def extend_cuda(dfm: DeviceFMIndex, x0, x1, s, is_back: bool):
    """The bwt_extend kernel, one thread per bi-interval; same contract
    as ``extend_torch``."""
    x0, x1, s = _as_rows(dfm, x0, x1, s)
    n = x0.shape[0]
    dev = dfm.device
    ox0 = torch.empty((n, 4), dtype=torch.int64, device=dev)
    ox1 = torch.empty((n, 4), dtype=torch.int64, device=dev)
    sz = torch.empty((n, 4), dtype=torch.int32, device=dev)
    if n:
        err = _flag_word(dfm)
        extend_launch(dfm, x0, x1, s, is_back, ox0, ox1, sz, err)
        _raise_flags("bwt_extend", err)
    return ox0, ox1, sz


def sa_lookup_cuda(dfm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """The SA-walk kernel, one thread per row; same contract as
    ``sa_lookup_torch``."""
    (k,) = _as_rows(dfm, k)
    out = torch.empty_like(k)
    if k.shape[0]:
        err = _flag_word(dfm)
        sa_lookup_launch(dfm, k, out, err)
        _raise_flags("sa_lookup", err)
    return out


def backward_search_cuda(dfm: DeviceFMIndex, qseq, qlen):
    """The backward-search kernel, one thread per read; same contract as
    ``backward_search_torch``."""
    dev = dfm.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need an index on the card, not {dev}")
    if qseq.dim() != 2 or qlen.shape != qseq.shape[:1]:
        raise ValueError("expected qseq [B, L] and qlen [B], got "
                         f"{tuple(qseq.shape)} and {tuple(qlen.shape)}")
    if qseq.device != dev or qlen.device != dev:
        raise ValueError(f"expected tensors on {dev}")
    B = qseq.shape[0]
    qseq = qseq.to(torch.uint8).contiguous()
    qlen = qlen.to(torch.int32).contiguous()
    k, l = (torch.empty(B, dtype=torch.int64, device=dev) for _ in range(2))
    matched = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        backward_search_launch(dfm, qseq, qlen, k, l, matched)
    return k, l, matched


# -------------------------------------------------------------- dispatchers

def occ4(dfm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """CPU tensors -> ``occ4_torch``; CUDA tensors -> the kernel."""
    return (occ4_cuda if k.device.type == "cuda" else occ4_torch)(dfm, k)


def extend(dfm: DeviceFMIndex, x0, x1, s, is_back: bool
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CPU tensors -> ``extend_torch``; CUDA tensors -> the kernel."""
    fn = extend_cuda if x0.device.type == "cuda" else extend_torch
    return fn(dfm, x0, x1, s, is_back)


def sa_lookup(dfm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """CPU tensors -> ``sa_lookup_torch``; CUDA tensors -> the kernel."""
    return (sa_lookup_cuda if k.device.type == "cuda" else sa_lookup_torch)(
        dfm, k)


def backward_search(dfm: DeviceFMIndex, qseq, qlen):
    """CPU tensors -> ``backward_search_torch``; CUDA tensors -> the
    kernel."""
    fn = (backward_search_cuda if qseq.device.type == "cuda"
          else backward_search_torch)
    return fn(dfm, qseq, qlen)
