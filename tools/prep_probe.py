#!/usr/bin/env python3
"""Times bwamem_tpu_torch's chain-to-region prep kernel (csrc/chain2aln.cu
chain2aln_prep_kernel) and its sample_ks kernel (csrc/seed.cu
sample_ks_kernel) alone, on one NVIDIA card.

    python3 tools/prep_probe.py [--genome ecoli|chr20|both] [--no-variant]

On chip_smoke.py's ecoli PE batch (12,000 reads of the 4.6 Mbp synthetic
genome) and its chr20 batch (4,000 reads of the 64 Mbp one), as the fused
path hands them to the two kernels: the prep kernel on the batch's chains
(``FUSED_STATS.largest_batch``) and sample_ks on the batch's seeding
intervals (``collect_intv_cuda`` at the aligner's K = 160), each over the
whole batch (warm, and from a cold L2: 256 MB written before each launch);
the prep kernel on the chain with the most seeds alone (a one-chain
``Chains``) and on a chain of one seed alone; sample_ks on the read with
the most SA rows alone and on a read with a row at s >= max_occ alone (if
the batch has one).  All as device time under torch.profiler, each
launch's output held equal to the plain version's (``chain_windows``'s
windows and order, ``sample_ks_torch``).  Beside them an empty kernel's
device time on the same stream, the launch floor, and the work: seeds per
chain, rows and SA rows per read, rows at and past max_occ.

Where the prep kernel is the warp-per-chain form (csrc/chain2aln.cu has
``prep_chain(``) and ``--no-variant`` is not given, variants are built
into build/prep_probe/ (one nvcc a source, all at once; each kernel's
registers printed), held equal to the shipped kernels (or, for a variant
that writes one output only, on that output) and timed the same way on the
whole batch: the prep kernel as a warp per read (the read's chains in turn,
PREP_BY_READ below) and, from text edits of a copy of csrc/chain2aln.cu,
with its registers uncapped or capped at 40 and 32 a thread (64 ship);
sample_ks writing one row's SA rows at a time and with its loads issued
after the row count arrives (SAMPLE_EXTRA), the former thread per (read,
slot) with both its stores, the flat table's only and the SA rows' only,
and, from text edits of a copy of csrc/seed.cu, the shipped kernel with a
cap of 40 registers and with the flat table's stores or the SA rows'
stores only.  Every time is the profiler's unless the key is listed under
``events`` (timed by CUDA events queued behind a busy-wait, where the
traces held too few launches).  The last line is one JSON object.  Nothing
of JAX is imported.  On an older tree (copy this file and chip_smoke.py
into a ``git archive`` of it) it times that tree's kernels.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the genomes, the card line, the timers)

OUT = os.path.join(ROOT, "build", "prep_probe")
CSRC = os.path.join(ROOT, "bwamem_tpu_torch", "csrc")
EMPTY = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
# The prep kernel as a warp per read, the read's chains in turn through the
# shipped prep_chain (the same translation unit, so its anonymous namespace).
PREP_BY_READ = r"""
#include "chain2aln.cu"
namespace {
__global__ void __launch_bounds__(kPrepThreads) prep_by_read_kernel(
    const int64_t* __restrict__ chain_rows, const int64_t* __restrict__ seed_rows,
    const int64_t* __restrict__ chain_seed_off,
    const int32_t* __restrict__ chain_read, const int32_t* __restrict__ qlen,
    const int64_t* __restrict__ chain_off, const int64_t* __restrict__ n_chain,
    int B, const int64_t* __restrict__ ctg_end,
    const int64_t* __restrict__ ctg_off, int n_ctg, int64_t l_pac, Opts o,
    int64_t* __restrict__ rmax, int32_t* __restrict__ srt,
    int32_t* __restrict__ err) {
  __shared__ int64_t tiles[kPrepWarps][kPrepTile];
  const int w = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kPrepWarps + w;
  if (b >= B) return;
  for (int64_t ci = chain_off[b]; ci < chain_off[b] + n_chain[b]; ++ci)
    prep_chain(ci, threadIdx.x & 31, tiles[w], chain_rows, seed_rows,
               chain_seed_off, chain_read, qlen, ctg_end, ctg_off, n_ctg,
               l_pac, o, rmax, srt, err);
}
}  // namespace
extern "C" int prep_by_read_launch(
    const int64_t* chain_rows, const int64_t* seed_rows,
    const int64_t* chain_seed_off, const int32_t* chain_read,
    const int32_t* qlen, const int64_t* chain_off, const int64_t* n_chain,
    int B, const int64_t* ctg_end, const int64_t* ctg_off, int n_ctg,
    int64_t l_pac, int a, int o_del, int e_del, int o_ins, int e_ins,
    int zdrop, int w, int pen_clip5, int pen_clip3, int max_sc, int64_t* rmax,
    int32_t* srt, int32_t* err, cudaStream_t stream) {
  const Opts o{a, o_del, e_del, o_ins, e_ins, zdrop, w, pen_clip5, pen_clip3,
               max_sc};
  prep_by_read_kernel<<<(B + kPrepWarps - 1) / kPrepWarps, kPrepThreads, 0,
                        stream>>>(chain_rows, seed_rows, chain_seed_off,
                                  chain_read, qlen, chain_off, n_chain, B,
                                  ctg_end, ctg_off, n_ctg, l_pac, o, rmax, srt,
                                  err);
  return static_cast<int>(cudaGetLastError());
}
"""
# The shipped prep kernel with other register caps: text edits of a copy of
# csrc/chain2aln.cu (4 blocks of 256 threads an SM, 64 registers a thread,
# ship; no cap, 6 and 8 blocks, 40 and 32 registers).
PREP_BOUNDS = "__launch_bounds__(kPrepThreads, 4) chain2aln_prep_kernel("
PREP_CAPS = {
    "nocap": [(PREP_BOUNDS, PREP_BOUNDS.replace(", 4)", ")"))],
    "cap40": [(PREP_BOUNDS, PREP_BOUNDS.replace(", 4)", ", 6)"))],
    "cap32": [(PREP_BOUNDS, PREP_BOUNDS.replace(", 4)", ", 8)"))],
}
PREP_VARIANTS = ("by_read", *PREP_CAPS)
# sample_ks a row at a time (after the warp scan, for each row in order the
# whole warp writes its SA rows, t = lane, lane + 32, ...); the shipped form
# with its loads issued after the row count arrives ("late"); and the
# former kernel, a thread per (read, slot), its stores of the flat table
# (bit 0 of ``stores``) and of the SA rows (bit 1) each switched on or off.
SAMPLE_EXTRA = r"""
#include "seed.cu"
namespace {
__global__ void __launch_bounds__(kSampleThreads) sample_ks_slot_kernel(
    const int64_t* __restrict__ rows, int M, const int32_t* __restrict__ nrows,
    const int64_t* __restrict__ row_off, const int64_t* __restrict__ ks_off,
    int B, int64_t max_occ, int64_t* __restrict__ flat,
    int64_t* __restrict__ ks) {
  const int lane = threadIdx.x & 31;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kSampleWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int n = nrows[b];
  const int64_t* read = rows + b * M * 5;
  int64_t* f = flat + row_off[b] * 5;
  for (int k = lane; k < 5 * n; k += 32) f[k] = read[k];
  int64_t off = ks_off[b];
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    int64_t x0 = 0, cnt = 0, step = 1;
    if (j < n) {
      const int64_t s = read[5 * j + 2];
      x0 = read[5 * j];
      cnt = occ_rows(s, max_occ);
      if (s > max_occ && max_occ > 0) step = s / max_occ;
    }
    int64_t incl = cnt;
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int64_t at = off + incl - cnt;
    const int rn = n - j0 < 32 ? n - j0 : 32;
    for (int r = 0; r < rn; ++r) {
      const int64_t c = __shfl_sync(kFull, cnt, r);
      const int64_t o = __shfl_sync(kFull, at, r);
      const int64_t x = __shfl_sync(kFull, x0, r);
      const int64_t st = __shfl_sync(kFull, step, r);
      for (int64_t t = lane; t < c; t += 32) ks[o + t] = x + st * t;
    }
    off += __shfl_sync(kFull, incl, 31);
  }
}
__global__ void __launch_bounds__(kSampleThreads) sample_ks_late_kernel(
    const int64_t* __restrict__ rows, int M, const int32_t* __restrict__ nrows,
    const int64_t* __restrict__ row_off, const int64_t* __restrict__ ks_off,
    int B, int64_t max_occ, int64_t* __restrict__ flat,
    int64_t* __restrict__ ks) {
  const int lane = threadIdx.x & 31;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kSampleWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int n = nrows[b];
  const int64_t* read = rows + b * M * 5;
  int64_t* f = flat + row_off[b] * 5;
  for (int k = lane; k < 5 * n; k += 32) f[k] = read[k];
  int64_t* out = ks + ks_off[b];
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    int64_t x0 = 0, cnt = 0, step = 1;
    if (j < n) {
      const int64_t s = read[5 * j + 2];
      x0 = read[5 * j];
      cnt = occ_rows(s, max_occ);
      if (s > max_occ && max_occ > 0) step = s / max_occ;
    }
    int64_t incl = cnt;
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int64_t excl = incl - cnt;
    const int64_t total = __shfl_sync(kFull, incl, 31);
    for (int64_t i0 = 0; i0 < total; i0 += 32) {
      const int64_t i = i0 + lane;
      int r = 0;
      for (int d = 16; d > 0; d >>= 1)
        if (__shfl_sync(kFull, incl, r + d - 1) <= i) r += d;
      const int64_t x = __shfl_sync(kFull, x0, r);
      const int64_t st = __shfl_sync(kFull, step, r);
      const int64_t at = __shfl_sync(kFull, excl, r);
      if (i < total) out[i] = x + st * (i - at);
    }
    out += total;
  }
}
__global__ void __launch_bounds__(256) sample_ks_thread_kernel(
    const int64_t* __restrict__ rows, int M, const int32_t* __restrict__ nrows,
    const int64_t* __restrict__ row_off, const int64_t* __restrict__ ks_off,
    int B, int64_t max_occ, int stores, int64_t* __restrict__ flat,
    int64_t* __restrict__ ks) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (t >= static_cast<int64_t>(B) * M) return;
  const int64_t b = t / M;
  const int j = static_cast<int>(t % M);
  if (j >= nrows[b]) return;
  const int64_t* read = rows + b * M * 5;
  const int64_t* r = read + 5 * j;
  if (stores & 1) {
    int64_t* f = flat + (row_off[b] + j) * 5;
    for (int c = 0; c < 5; ++c) f[c] = r[c];
  }
  if (stores & 2) {
    int64_t off = ks_off[b];
    for (int k = 0; k < j; ++k) off += occ_rows(read[5 * k + 2], max_occ);
    const int64_t s = r[2];
    const int64_t cnt = occ_rows(s, max_occ);
    const int64_t step = (s > max_occ && max_occ > 0) ? s / max_occ : 1;
    for (int64_t k = 0; k < cnt; ++k) ks[off + k] = r[0] + step * k;
  }
}
}  // namespace
extern "C" int sample_variant_launch(
    int which, int stores, const int64_t* rows, int M, const int32_t* nrows,
    const int64_t* row_off, const int64_t* ks_off, int B, int64_t max_occ,
    int64_t* flat, int64_t* ks, cudaStream_t stream) {
  if (B <= 0) return 0;
  const unsigned w = (B + kSampleWarps - 1) / kSampleWarps;  // a read a warp
  const int64_t n = static_cast<int64_t>(B) * M;
  switch (which) {
    case 0:
      sample_ks_slot_kernel<<<w, kSampleThreads, 0, stream>>>(
          rows, M, nrows, row_off, ks_off, B, max_occ, flat, ks);
      break;
    case 1:
      sample_ks_late_kernel<<<w, kSampleThreads, 0, stream>>>(
          rows, M, nrows, row_off, ks_off, B, max_occ, flat, ks);
      break;
    case 2:
      sample_ks_thread_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                                stream>>>(rows, M, nrows, row_off, ks_off, B,
                                          max_occ, stores, flat, ks);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""
# The shipped sample_ks kernel edited in a copy of csrc/seed.cu: with a
# cap of 40 registers a thread (6 blocks an SM), and with its stores of
# the SA rows or of the flat table made conditional on max_occ < 0 (never
# true), so that it writes one output only: the split of its time, warm and
# cold, between the two.
SAMPLE_BOUNDS = "__launch_bounds__(kSampleThreads) sample_ks_kernel("
SAMPLE_EDITS = {
    "cap40": [(SAMPLE_BOUNDS, SAMPLE_BOUNDS.replace(")", ", 6)", 1))],
    "flat_part": [("if (i < total) out[i]",
                   "if (i < total && max_occ < 0) out[i]")],
    "ks_part": [("if (lane < 5 * n) f[lane]",
                 "if (lane < 5 * n && max_occ < 0) f[lane]"),
                ("if (lane + 32 < 5 * n) f[lane + 32]",
                 "if (lane + 32 < 5 * n && max_occ < 0) f[lane + 32]"),
                ("k < 5 * n; k += 32) f[k] = read[k];",
                 "k < 5 * n && max_occ < 0; k += 32) f[k] = read[k];")],
}
# the former kernel with both stores, with the flat table's only, with the
# SA rows' only
THREAD_STORES = {"thread": 3, "thread_flat_part": 1, "thread_ks_part": 2}
SAMPLE_VARIANTS = ("by_row", "late", *SAMPLE_EDITS, *THREAD_STORES)


def _edited(name: str, edits) -> str:
    """csrc/``name`` with each (old, new) of ``edits`` made; each old text
    must occur in it exactly once."""
    with open(os.path.join(CSRC, name)) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def _build(name: str, text: str):
    """``text`` compiled by utils/cudabuild.py's nvcc and flags into
    build/prep_probe/lib<name>.so, loaded."""
    from bwamem_tpu_torch.utils import cudabuild

    os.makedirs(OUT, exist_ok=True)
    src, lib = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"lib{name}.so")
    with open(src, "w") as f:
        f.write(text)
    res = subprocess.run(
        [cudabuild.nvcc_path(), *cudabuild.ARCH_FLAGS, *cudabuild.FLAGS,
         "-I", CSRC, "-o", lib, src], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stderr}")
    lines = (res.stdout + res.stderr).splitlines()
    for k, line in enumerate(lines):  # registers of each variant's kernel
        if "Compiling entry function" in line and (
                "prep" in line or "sample_ks" in line):
            used = next((x for x in lines[k + 1: k + 4] if "Used" in x), "")
            print(f"[build] {name}: {line.split(chr(39))[1][:90]}: "
                  f"{used.split(':')[-1].strip()}")
    return ctypes.CDLL(lib)


def _sources() -> dict:
    """name -> (source text, the port module whose ``_bind`` types its
    entry points, or None) of every variant."""
    from bwamem_tpu_torch.ops import pipeline_fused as fo
    from bwamem_tpu_torch.ops import seed as so

    out = {"prep_by_read": (PREP_BY_READ, None),
           "sample_extra": (SAMPLE_EXTRA, None)}
    out.update({f"prep_{k}": (_edited("chain2aln.cu", e), fo)
                for k, e in PREP_CAPS.items()})
    out.update({f"sample_{k}": (_edited("seed.cu", e), so)
                for k, e in SAMPLE_EDITS.items()})
    return out


def _with_lib(mod, lib, fn):
    """``fn()`` with ``mod``'s kernels taken from ``lib``."""
    saved = mod._lib
    mod._lib = lambda: lib
    try:
        fn()
    finally:
        mod._lib = saved


def _has_warp_prep() -> bool:
    with open(os.path.join(CSRC, "chain2aln.cu")) as f:
        return "void prep_chain(" in f.read()


def _stats(x) -> dict:
    import numpy as np

    x = np.asarray(x, np.float64)
    return dict(mean=float(x.mean()), p99=float(np.percentile(x, 99)),
                max=int(x.max()))


def _batch(genome: str, dev):
    """(index image, reads) of chip_smoke's batch on ``genome``."""
    import numpy as np

    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch
    from bwamem_tpu_torch.utils.synth import simulate_pairs

    length, pairs = ((chip_smoke.ECOLI_LEN, chip_smoke.N_PAIRS)
                     if genome == "ecoli"
                     else (chip_smoke.CHR20_LEN, chip_smoke.CHR20_PAIRS))
    codes, img, _ = chip_smoke._synthetic_index(length)
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    simulate_pairs(codes, rng, 8)
    return img, seq_to_codes_batch(simulate_pairs(codes, rng, pairs))


def _prep(genome, eng, reads, dev, libs):
    import torch

    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.exec_ctx import ExecConfig
    from bwamem_tpu_torch.engine.pipeline_device import (FUSED_STATS,
                                                         regs_batch_fused)
    from bwamem_tpu_torch.ops import pipeline_fused as fo

    FUSED_STATS.reset()
    regs_batch_fused(MemOptions(), eng, reads,
                     ExecConfig(device=dev, device_pipeline=True))
    ctg, ref, chains, qseq, qlen, run, params, _, _ = FUSED_STATS.largest_batch
    chains_p, lay, q8, ql, run8 = fo.prepare(ctg, ref, chains, qseq, qlen, run)
    i32, i64 = torch.int32, torch.int64
    err = torch.zeros(1, dtype=i32, device=dev)

    def operands(ch, la, ql_):
        rmax = torch.empty((ch.chain_rows.shape[0], 2), dtype=i64, device=dev)
        srt = torch.empty(ch.seed_rows.shape[0], dtype=i32, device=dev)

        def launch():
            fo.chain2aln_prep_launch(ctg, ch, la, ql_, params, rmax, srt, err)

        def check():
            e = chip_smoke._prep_err(ctg, ch, la, ql_, params, rmax, srt)
            if e or int(err.item()):
                raise AssertionError(f"{genome}: the prep kernel disagrees with "
                                     f"chain_windows (max|diff| {e}, flags "
                                     f"{int(err.item())})")
        return launch, check, rmax, srt

    res = dict(events=[])

    def ms(key, fn, kernel="chain2aln_prep_kernel", cold=False):
        """res[key + "_ms"] = fn's time; ``key`` listed under "events" if
        it is not the profiler's."""
        t, by = chip_smoke._card_ms(fn, 10, dev, kernel, cold=cold)
        if by != "profiler":
            res["events"].append(key)
        res[f"{key}_ms"] = t

    whole, check, rmax, srt = operands(chains_p, lay, ql)
    res.update(chains=int(chains_p.chain_rows.shape[0]),
               seeds=int(chains_p.seed_rows.shape[0]),
               seeds_per_chain=_stats(lay.ns.cpu().numpy()))
    ms("batch", whole)
    ms("batch_cold", whole, cold=True)
    check()
    top = int(torch.argmax(lay.ns))
    sub, q1, l1, r1 = chip_smoke._one_chain(chains_p, lay, q8, ql, run8, top)
    sub, la1, _, l1, _ = fo.prepare(ctg, ref, sub, q1, l1, r1)
    one, check1, _, _ = operands(sub, la1, l1)
    res["heaviest_seeds"] = int(lay.ns[top])
    ms("heaviest", one)
    ms("heaviest_cold", one, cold=True)
    check1()
    low = int(torch.argmin(lay.ns))  # a chain of one seed: a warp's floor
    sub, q1, l1, r1 = chip_smoke._one_chain(chains_p, lay, q8, ql, run8, low)
    sub, la1, _, l1, _ = fo.prepare(ctg, ref, sub, q1, l1, r1)
    one, check1, _, _ = operands(sub, la1, l1)
    res["lightest_seeds"] = int(lay.ns[low])
    ms("lightest", one)
    check1()
    if libs:
        rv, sv = torch.empty_like(rmax), torch.empty_like(srt)
        stream = torch.cuda.current_stream(dev).cuda_stream
        by_read = libs["prep_by_read"]

        def read_launch():
            rc = by_read.prep_by_read_launch(
                *(ctypes.c_void_p(t.data_ptr()) for t in (
                    chains_p.chain_rows, chains_p.seed_rows,
                    lay.chain_seed_off, lay.chain_read, ql, lay.chain_off,
                    chains_p.n_chain)),
                ctypes.c_int(ql.shape[0]),
                ctypes.c_void_p(ctg.ctg_end.data_ptr()),
                ctypes.c_void_p(ctg.ctg_off.data_ptr()),
                ctypes.c_int(ctg.ctg_end.numel()), ctypes.c_int64(ctg.l_pac),
                *(ctypes.c_int(v) for v in fo._opts(params)),
                *(ctypes.c_void_p(t.data_ptr()) for t in (rv, sv, err)),
                ctypes.c_void_p(stream))
            if rc:
                raise RuntimeError(f"the by_read variant failed: cudaError {rc}")

        for name in PREP_VARIANTS:
            if name == "by_read":
                launch, kernel = read_launch, "prep_by_read_kernel"
            else:
                def launch(lib=libs[f"prep_{name}"]):
                    _with_lib(fo, lib, lambda: fo.chain2aln_prep_launch(
                        ctg, chains_p, lay, ql, params, rv, sv, err))
                kernel = "chain2aln_prep_kernel"
            rv.fill_(-1)
            sv.fill_(-1)
            ms(name, launch, kernel)
            ms(name + "_cold", launch, kernel, cold=True)
            if chip_smoke._diff(rv, rmax) or chip_smoke._diff(sv, srt):
                raise AssertionError(f"{genome}: the variant {name} differs")
        ms("whole_again", whole)  # the turn after the variants
    return res


def _sample_ks(genome, eng, reads, dev, libs):
    import numpy as np
    import torch

    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.state import device_fm
    from bwamem_tpu_torch.ops import seed as so

    params = so.SeedParams.from_opt(MemOptions())
    dfm = device_fm(eng.fm, dev)
    qseq, qlen = so.pad_reads(reads, dev)
    iv = so.collect_intv_cuda(dfm, qseq, qlen, params, K=so.K_MAX)
    rows = iv.rows.contiguous()
    nrows = torch.where(iv.ovf, 0, iv.n).to(torch.int32).contiguous()
    nks = iv.nks.contiguous()

    def operands(b0, b1):
        r, n, k = rows[b0:b1], nrows[b0:b1], nks[b0:b1]
        row_off, ks_off, n_tot, ks_tot = so._scan_offsets(n, k)
        flat = torch.empty((n_tot, 5), dtype=torch.int64, device=dev)
        ks = torch.empty(ks_tot, dtype=torch.int64, device=dev)

        def launch():
            so.sample_ks_launch(r, n, row_off, ks_off, params.max_occ, flat, ks)

        def check():
            pf, pk = so.sample_ks_torch(r, n, k, params.max_occ)
            e = max(chip_smoke._diff(flat, pf), chip_smoke._diff(ks, pk))
            if e:
                raise AssertionError(f"{genome}: sample_ks disagrees with "
                                     f"sample_ks_torch (max|diff| {e})")
        return launch, check

    res = dict(events=[])

    def ms(key, fn, kernel="sample_ks_kernel", cold=False):
        """As in ``_prep``."""
        t, by = chip_smoke._card_ms(fn, 10, dev, kernel, cold=cold)
        if by != "profiler":
            res["events"].append(key)
        res[f"{key}_ms"] = t

    whole, check = operands(0, len(reads))
    n_np, k_np = nrows.cpu().numpy(), nks.cpu().numpy()
    valid = np.arange(rows.shape[1])[None, :] < n_np[:, None]
    s = rows[:, :, 2].cpu().numpy()
    past = valid & (s > params.max_occ)
    res.update(reads=len(reads), rows=int(n_np.sum()), sa_rows=int(k_np.sum()),
               rows_per_read=_stats(n_np), sa_rows_per_read=_stats(k_np),
               rows_past_max_occ=int(past.sum()),
               rows_at_max_occ=int((valid & (s == params.max_occ)).sum()))
    ms("batch", whole)
    ms("batch_cold", whole, cold=True)
    check()
    if libs:  # the variants, on the same operands
        row_off, ks_off, n_tot, ks_tot = so._scan_offsets(nrows, nks)
        flat = torch.full((n_tot, 5), -1, dtype=torch.int64, device=dev)
        ks = torch.full((ks_tot,), -1, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        extra = libs["sample_extra"]
        pf, pk = so.sample_ks_torch(rows, nrows, nks, params.max_occ)

        def own(which, stores=3):
            def launch():
                rc = extra.sample_variant_launch(
                    ctypes.c_int(which), ctypes.c_int(stores),
                    ctypes.c_void_p(rows.data_ptr()), ctypes.c_int(rows.shape[1]),
                    *(ctypes.c_void_p(t.data_ptr())
                      for t in (nrows, row_off, ks_off)),
                    ctypes.c_int(len(reads)), ctypes.c_int64(params.max_occ),
                    ctypes.c_void_p(flat.data_ptr()),
                    ctypes.c_void_p(ks.data_ptr()), ctypes.c_void_p(stream))
                if rc:
                    raise RuntimeError(f"a sample_ks variant failed: {rc}")
            return launch

        def edited(lib):
            return lambda: _with_lib(so, lib, lambda: so.sample_ks_launch(
                rows, nrows, row_off, ks_off, params.max_occ, flat, ks))

        kernels = dict(by_row="sample_ks_slot_kernel",
                       late="sample_ks_late_kernel",
                       **{k: "sample_ks_thread_kernel" for k in THREAD_STORES})
        for name in SAMPLE_VARIANTS:
            if name in SAMPLE_EDITS:
                launch = edited(libs[f"sample_{name}"])
            elif name in THREAD_STORES:
                launch = own(2, THREAD_STORES[name])
            else:
                launch = own(("by_row", "late").index(name))
            flat.fill_(-1)
            ks.fill_(-1)
            kernel = kernels.get(name, "sample_ks_kernel")
            ms(name, launch, kernel)
            ms(name + "_cold", launch, kernel, cold=True)
            # a variant that writes one output only is held on that one
            e_f = 0 if name.endswith("ks_part") else chip_smoke._diff(flat, pf)
            e_k = 0 if name.endswith("flat_part") else chip_smoke._diff(ks, pk)
            if e_f or e_k:
                raise AssertionError(f"{genome}: the variant {name} differs")
        ms("whole_again", whole)
    top = int(np.argmax(k_np))
    one, check1 = operands(top, top + 1)
    res["heaviest_sa_rows"] = int(k_np[top])
    ms("heaviest", one)
    check1()
    at = np.flatnonzero((valid & (s >= params.max_occ)).any(1))
    if at.size:
        b = int(at[0])
        occ, check2 = operands(b, b + 1)
        res["max_occ_read_sa_rows"] = int(k_np[b])
        ms("max_occ_read", occ)
        check2()
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", choices=("ecoli", "chr20", "both"), default="both")
    ap.add_argument("--no-variant", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prep_probe: no CUDA card", file=sys.stderr)
        return 1
    from bwamem_tpu_torch import BwaMemIndex
    from bwamem_tpu_torch.engine import exec_ctx

    dev = torch.device("cuda", 0)
    card = chip_smoke._card_line()
    print(f"card: {card}")
    exec_ctx.KEEP_LARGEST = True
    todo = {"empty": (EMPTY, None)}
    if not args.no_variant and _has_warp_prep():
        todo.update(_sources())
    with ThreadPoolExecutor(len(todo)) as ex:  # one nvcc a source, all at once
        libs = dict(zip(todo, ex.map(lambda n: _build(n, todo[n][0]), todo)))
    for name, (_, mod) in todo.items():
        if mod is not None:
            mod._bind(libs[name])
    empty = libs.pop("empty")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty_launch():
        if empty.empty_launch(ctypes.c_void_p(stream)):
            raise RuntimeError("the empty kernel failed")

    empty_ms, empty_by = chip_smoke._card_ms(empty_launch, 10, dev,
                                             "empty_kernel")
    out = dict(card=card, warp_prep=_has_warp_prep(), empty_ms=empty_ms,
               empty_by=empty_by)
    print(f"empty kernel (the launch floor): {empty_ms:.5f} ms ({empty_by})",
          flush=True)
    genomes = ("ecoli", "chr20") if args.genome == "both" else (args.genome,)
    for g in genomes:
        img, reads = _batch(g, dev)
        with BwaMemIndex(img) as index:
            eng = index._require()
            s = _sample_ks(g, eng, reads, dev, libs)
            print(f"{g}: sample_ks on {s['reads']} reads ({s['rows']} rows, "
                  f"{s['sa_rows']} SA rows; rows per read mean "
                  f"{s['rows_per_read']['mean']:.2f} max "
                  f"{s['rows_per_read']['max']}, SA rows per read mean "
                  f"{s['sa_rows_per_read']['mean']:.2f} max "
                  f"{s['sa_rows_per_read']['max']}; {s['rows_past_max_occ']} "
                  f"rows past max_occ, {s['rows_at_max_occ']} at it): batch "
                  f"{s['batch_ms']:.5f} ms, {s['batch_cold_ms']:.5f} ms cold; "
                  f"the read with the most SA rows ({s['heaviest_sa_rows']}) "
                  f"alone {s['heaviest_ms']:.5f} ms"
                  + (f"; a read with a row at or past max_occ "
                     f"({s['max_occ_read_sa_rows']} SA rows) alone "
                     f"{s['max_occ_read_ms']:.5f} ms" if "max_occ_read_ms" in s
                     else "")
                  + "".join(f"; {v} {s[v + '_ms']:.5f} ms, "
                            f"{s[v + '_cold_ms']:.5f} ms cold"
                            for v in SAMPLE_VARIANTS if v + "_ms" in s)
                  + (f" (the shipped form again {s['whole_again_ms']:.5f} ms)"
                     if "whole_again_ms" in s else ""), flush=True)
            p = _prep(g, eng, reads, dev, libs)
            print(f"{g}: prep on {p['chains']} chains ({p['seeds']} seeds; per "
                  f"chain mean {p['seeds_per_chain']['mean']:.2f}, p99 "
                  f"{p['seeds_per_chain']['p99']:.0f}, max "
                  f"{p['seeds_per_chain']['max']}): batch {p['batch_ms']:.5f} "
                  f"ms, {p['batch_cold_ms']:.5f} ms cold; the chain with the "
                  f"most seeds ({p['heaviest_seeds']}) alone "
                  f"{p['heaviest_ms']:.5f} ms, {p['heaviest_cold_ms']:.5f} ms "
                  f"cold; a chain of {p['lightest_seeds']} seed alone "
                  f"{p['lightest_ms']:.5f} ms"
                  + "".join(f"; {v} {p[v + '_ms']:.5f} ms, "
                            f"{p[v + '_cold_ms']:.5f} ms cold"
                            for v in PREP_VARIANTS if v + "_ms" in p)
                  + (f" (the shipped form again {p['whole_again_ms']:.5f} ms)"
                     if "whole_again_ms" in p else ""), flush=True)
        out[g] = dict(prep=p, sample_ks=s)
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
