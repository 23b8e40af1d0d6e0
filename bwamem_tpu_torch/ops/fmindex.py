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
  ``csrc/fmindex.cu``.  The SA walk takes lines of span 128, 256 or 512 and
  picks its sampled test from ``sa_intv``: a mask and a shift for a power
  of two, a division otherwise.  ``line_chase_launch`` measures the latency
  of one dependent line fetch, the floor of a walk's step.
* ``occ4``, ``extend``, ``sa_lookup`` and ``backward_search`` dispatch on the device of their
  inputs: CPU tensors go to the plain version, CUDA tensors to the kernel.
* ``ShardedFMIndex`` holds the idx-sharded tables (D12; fmindex_tpu.py
  ``sharded_tables``, ``make_occ4_sharded``): the line table and the sampled
  SA in contiguous slices, one a device of the mesh's idx axis, padded as
  tests/test_sharded_tables.py pads them.  The plain versions take either
  form: every line and SA fetch goes through ``line_rows``/``sa_rows``, which
  on the sharded form gather each row from the shard that owns it (the
  JAX package's local gather and ``psum`` give the same rows, since one
  shard owns each).  ``occ4_sharded`` and ``sa_lookup_sharded`` (and
  ``ops.seed.seed_sa_walk``) launch the kernels' sharded instantiations
  (csrc/fmindex.cuh ``FmShards``), which read each row from its owner's
  memory, through peer access when it lies on another card.

Conceptual rows follow bwa (engine/fmindex.py): row ``primary`` carries the
implicit sentinel, so the occ offset of row k is ``k - (k >= primary)`` and
its BWT character sits at ``k - (k > primary)``; ``occ4(-1)`` is 0 and
``occ4(seq_len)`` the full counts; an LF step from ``primary`` lands on row
0, and ``sa[0] == -1`` turns a walk through it into the right position.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np
import torch

from ..utils.cudabuild import on_device, stream, tally

# launches of each CUDA kernel; bumped only where it is launched
LAUNCHES = {"occ4": 0, "bwt_extend": 0, "sa_lookup": 0, "backward_search": 0,
            "line_chase": 0, "occ4_sharded": 0, "sa_lookup_sharded": 0}
# u32 per line the SA-walk and line-chase kernels take (span 128, 256, 512)
WALK_LINE_WORDS = (12, 20, 36)
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
    sharded = False

    @property
    def device(self) -> torch.device:
        return self.lines.device

    @property
    def line_words(self) -> int:
        return self.lines.shape[1]

    def line_rows(self, block: torch.Tensor) -> torch.Tensor:
        """The lines ``block`` [N] int64, [N, W]."""
        return self.lines[block]

    def sa_rows(self, i: torch.Tensor) -> torch.Tensor:
        """The SA samples ``i`` [N] int64."""
        return self.sa[i]

    @cached_property
    def L2_values(self) -> Tuple[int, ...]:
        """``L2`` as host ints (one copy back, on first use): the SA walk
        takes L2[0..3] as kernel arguments."""
        return tuple(int(v) for v in self.L2.tolist())

    @property
    def sa_shift(self) -> int:
        """log2(sa_intv) when sa_intv is a power of two, else -1 (the SA
        walk's division path)."""
        v = self.sa_intv
        return v.bit_length() - 1 if v > 0 and v & (v - 1) == 0 else -1

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


def _gather_shards(shards, per: int, i: torch.Tensor, dev) -> torch.Tensor:
    """Rows ``i`` of a table split every ``per`` rows over ``shards``, each
    row read from the shard that owns it, on ``dev``."""
    out = torch.empty((i.shape[0], *shards[0].shape[1:]), dtype=shards[0].dtype,
                      device=dev)
    owner = i // per
    for s, t in enumerate(shards):
        sel = (owner == s).nonzero().flatten()
        if sel.numel():
            out[sel] = t[(i[sel] - s * per).to(t.device)].to(dev)
    return out


@dataclass(frozen=True)
class ShardedFMIndex:
    """The idx-sharded FM tables: shard ``s`` holds lines
    ``[s * blocks_per_shard, (s + 1) * blocks_per_shard)`` and SA samples
    ``[s * sa_per_shard, ...)`` on ``devices[s]``; ``L2`` and the statics
    are on the first shard's device, where the kernels launch."""

    line_shards: Tuple[torch.Tensor, ...]  # each [blocks_per_shard, W] int32
    sa_shards: Tuple[torch.Tensor, ...]  # each [sa_per_shard] int64
    L2: torch.Tensor
    primary: int
    seq_len: int
    sa_intv: int
    span: int
    blocks_per_shard: int
    sa_per_shard: int
    sharded = True

    @property
    def device(self) -> torch.device:
        return self.L2.device

    @property
    def n_shards(self) -> int:
        return len(self.line_shards)

    @property
    def line_words(self) -> int:
        return self.line_shards[0].shape[1]

    L2_values = DeviceFMIndex.L2_values
    sa_shift = DeviceFMIndex.sa_shift

    def line_rows(self, block: torch.Tensor) -> torch.Tensor:
        return _gather_shards(self.line_shards, self.blocks_per_shard, block,
                              self.device)

    def sa_rows(self, i: torch.Tensor) -> torch.Tensor:
        return _gather_shards(self.sa_shards, self.sa_per_shard, i,
                              self.device)

    @classmethod
    def from_host(cls, fm, devices, span: int = 128) -> "ShardedFMIndex":
        """``fm`` (an ``engine.fmindex.FMIndex``) split over ``devices`` (one
        shard each; a device may repeat, each shard is then its own
        allocation there): the lines of ``DeviceFMIndex.from_host`` and the
        sampled SA, each zero-padded to a multiple of the shard count
        (tests/test_sharded_tables.py).  Shards on another card than the
        first get peer access from it, or this raises."""
        devices = [torch.device(d) for d in devices]
        n = len(devices)
        if not 1 <= n <= MAX_SHARDS:
            raise ValueError(f"1 to {MAX_SHARDS} shards, not {n}")
        one = DeviceFMIndex.from_host(fm, "cpu", span)
        lines, sa = one.lines, one.sa
        bps, sps = -(-lines.shape[0] // n), -(-sa.shape[0] // n)
        pad_l = torch.zeros((bps * n, lines.shape[1]), dtype=lines.dtype)
        pad_l[: lines.shape[0]] = lines
        pad_s = torch.zeros(sps * n, dtype=sa.dtype)
        pad_s[: sa.shape[0]] = sa
        home = devices[0]
        for d in devices[1:]:
            if d.type == "cuda" and d != home:
                enable_peer(home, d)
        return cls(
            line_shards=tuple(pad_l[s * bps:(s + 1) * bps].clone().to(d)
                              for s, d in enumerate(devices)),
            sa_shards=tuple(pad_s[s * sps:(s + 1) * sps].clone().to(d)
                            for s, d in enumerate(devices)),
            L2=one.L2.to(home), primary=one.primary, seq_len=one.seq_len,
            sa_intv=one.sa_intv, span=span, blocks_per_shard=bps,
            sa_per_shard=sps)


# the most shards the kernels take (csrc/fmindex.cuh kMaxShards)
MAX_SHARDS = 8


def enable_peer(dev, peer):
    """Lets card ``dev`` load card ``peer``'s memory (a pair already
    enabled stays so); raises when the cards cannot: a shard is never
    copied through the host instead."""
    dev, peer = torch.device(dev), torch.device(peer)
    rc = _lib().bwamem_fm_enable_peer(dev.index or 0, peer.index or 0)
    if rc != 0:
        raise RuntimeError(f"peer access from {dev} to {peer} refused: "
                           f"cudaError {rc}")


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
    row = dfm.line_rows(kk >> (dfm.span.bit_length() - 1)).long()
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
        out[idx[hit]] = dfm.sa_rows(k[hit] // dfm.sa_intv) + steps
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
        ("bwamem_fm_sa_lookup_launch",
         [i64] * 4 + [p, i64, i32, p, i64, p, p, p]),
        ("bwamem_fm_backward_search_launch", [p, i32, p, i32, p, p, p, p]),
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = fm + rest
    lib.bwamem_fm_line_chase_launch.restype = ctypes.c_int
    lib.bwamem_fm_line_chase_launch.argtypes = [p, i32, i64, i64, i32, p, p]
    # line pointers, n_shards, blocks a shard, W, log2(span), L2, primary,
    # seq_len
    shards = [p, i32, i64, i32, i32, p, i64, i64]
    lib.bwamem_fm_occ4_sharded_launch.restype = ctypes.c_int
    lib.bwamem_fm_occ4_sharded_launch.argtypes = shards + [p, i64, p, p, p]
    lib.bwamem_fm_sa_lookup_sharded_launch.restype = ctypes.c_int
    lib.bwamem_fm_sa_lookup_sharded_launch.argtypes = (
        [p, p, i32, i64, i64, i32, i32, p, i64, i64] + [i64] * 4
        + [i64, i32, p, i64, p, p, p])
    lib.bwamem_fm_enable_peer.restype = ctypes.c_int
    lib.bwamem_fm_enable_peer.argtypes = [i32, i32]


def _lib():
    from ..utils import cudabuild

    return cudabuild.load("fmindex", _bind)


def _fm_args(dfm: DeviceFMIndex):
    if not dfm.lines.is_contiguous():
        raise ValueError("the line table must be contiguous")
    return (dfm.lines.data_ptr(), dfm.lines.shape[1],
            dfm.span.bit_length() - 1, dfm.L2.data_ptr(), dfm.primary,
            dfm.seq_len)


def _ptrs(shards) -> np.ndarray:
    """The shards' device pointers, a host uint64 array the launchers copy
    into the kernels' arguments."""
    return np.asarray([t.data_ptr() for t in shards], dtype=np.uint64)


def _shard_args(sfm: ShardedFMIndex, lines_ptrs: np.ndarray):
    """The sharded launchers' index arguments (``lines_ptrs`` kept alive by
    the caller for the call)."""
    for t in sfm.line_shards:
        if not t.is_contiguous():
            raise ValueError("every line shard must be contiguous")
    return (lines_ptrs.ctypes.data, sfm.n_shards, sfm.blocks_per_shard,
            sfm.line_words, sfm.span.bit_length() - 1, sfm.L2.data_ptr(),
            sfm.primary, sfm.seq_len)


def _walk_lines(dfm):
    """The line table(s) as the SA-walk and line-chase kernels take them:
    lines of span 128, 256 or 512, 16-byte aligned."""
    W = dfm.line_words
    if W not in WALK_LINE_WORDS:
        raise ValueError(f"the SA-walk kernel takes spans 128, 256 and 512, "
                         f"not {dfm.span}")
    tabs = dfm.line_shards if dfm.sharded else (dfm.lines,)
    if any(t.data_ptr() % 16 for t in tabs):
        raise ValueError("the line table must be 16-byte aligned")


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
    return stream(dfm.device)


def _launched(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    tally()["fmindex"] += 1


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

def occ4_launch(dfm, k, out, err):
    """``out`` [N, 4] int32 <- occ4 of the rows ``k`` [N]; on a
    ``ShardedFMIndex``, the sharded instantiation."""
    with on_device(dfm.device):
        if dfm.sharded:
            ptrs = _ptrs(dfm.line_shards)
            _launched("occ4_sharded", _lib().bwamem_fm_occ4_sharded_launch(
                *_shard_args(dfm, ptrs), k.data_ptr(), k.shape[0],
                out.data_ptr(), err.data_ptr(), _stream(dfm)))
            return
        _launched("occ4", _lib().bwamem_fm_occ4_launch(
            *_fm_args(dfm), k.data_ptr(), k.shape[0], out.data_ptr(),
            err.data_ptr(), _stream(dfm)))


def extend_launch(dfm: DeviceFMIndex, x0, x1, s, is_back: bool, ox0, ox1, sz,
                  err):
    """``ox0``, ``ox1`` [N, 4] int64 and ``sz`` [N, 4] int32 <- bwt_extend
    of the bi-intervals (``x0``, ``x1``, ``s``) [N]."""
    with on_device(dfm.device):
        _launched("bwt_extend", _lib().bwamem_fm_extend_launch(
            *_fm_args(dfm), x0.data_ptr(), x1.data_ptr(), s.data_ptr(),
            x0.shape[0], int(bool(is_back)), ox0.data_ptr(), ox1.data_ptr(),
            sz.data_ptr(), err.data_ptr(), _stream(dfm)))


def sa_lookup_launch(dfm, k, out, err):
    """``out`` [N] int64 <- the text positions of the rows ``k`` [N]; a
    power-of-two ``sa_intv`` takes the mask-and-shift kernel, any other the
    division one; on a ``ShardedFMIndex``, the sharded instantiation."""
    _walk_lines(dfm)
    if dfm.sharded:
        lp, sp = _ptrs(dfm.line_shards), _ptrs(dfm.sa_shards)
        with on_device(dfm.device):
            _launched("sa_lookup_sharded",
                      _lib().bwamem_fm_sa_lookup_sharded_launch(
                          lp.ctypes.data, sp.ctypes.data, dfm.n_shards,
                          dfm.blocks_per_shard, dfm.sa_per_shard,
                          dfm.line_words, dfm.span.bit_length() - 1,
                          dfm.L2.data_ptr(), dfm.primary, dfm.seq_len,
                          *dfm.L2_values[:4], dfm.sa_intv, dfm.sa_shift,
                          k.data_ptr(), k.shape[0], out.data_ptr(),
                          err.data_ptr(), _stream(dfm)))
        return
    with on_device(dfm.device):
        _launched("sa_lookup", _lib().bwamem_fm_sa_lookup_launch(
            *_fm_args(dfm), *dfm.L2_values[:4], dfm.sa.data_ptr(), dfm.sa_intv,
            dfm.sa_shift, k.data_ptr(), k.shape[0], out.data_ptr(),
            err.data_ptr(), _stream(dfm)))


def line_chase_launch(dfm: DeviceFMIndex, start: int, steps: int, out):
    """One thread's chain of ``steps`` dependent line fetches from line
    ``start``, each line chosen by a hash of the one before; ``out`` int64
    [1] <- the last line's index.  Its time over ``steps`` is the latency
    of one dependent line fetch: a measurement, on no aligner path."""
    _walk_lines(dfm)
    with on_device(dfm.device):
        _launched("line_chase", _lib().bwamem_fm_line_chase_launch(
            dfm.lines.data_ptr(), dfm.lines.shape[1], dfm.lines.shape[0], start,
            steps, out.data_ptr(), _stream(dfm)))


def backward_search_launch(dfm: DeviceFMIndex, qseq, qlen, k, l, matched):
    """``k``, ``l`` int64 [B] and ``matched`` int32 [B] <- the backward
    search of the reads ``qseq`` uint8 [B, L] with ``qlen`` int32 [B]."""
    with on_device(dfm.device):
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
    """The SA-walk kernel, one thread per row, one line fetch a step; same
    contract as ``sa_lookup_torch``."""
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


def occ4_sharded(sfm: ShardedFMIndex, k: torch.Tensor) -> torch.Tensor:
    """occ4 on the idx-sharded tables (fmindex_tpu.py
    ``make_occ4_sharded``): CPU tensors -> ``occ4_torch``, which gathers
    each line from its owner; CUDA tensors -> the sharded kernel."""
    if not sfm.sharded:
        raise ValueError("occ4_sharded takes a ShardedFMIndex")
    return occ4(sfm, k)


def sa_lookup_sharded(sfm: ShardedFMIndex, k: torch.Tensor) -> torch.Tensor:
    """The SA walk on the idx-sharded tables (fmindex_tpu.py
    ``sa_lookup_body`` under ``sharded_tables``): CPU tensors ->
    ``sa_lookup_torch``, CUDA tensors -> the sharded kernel."""
    if not sfm.sharded:
        raise ValueError("sa_lookup_sharded takes a ShardedFMIndex")
    return sa_lookup(sfm, k)
