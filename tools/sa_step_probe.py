#!/usr/bin/env python3
"""Times bwamem_tpu_torch's SA-walk kernel (csrc/fmindex.cu
sa_lookup_kernel) by walk length, on one NVIDIA card.

    python3 tools/sa_step_probe.py [--walk-only]

On bench.py's two synthetic genomes (chip_smoke.py's "ecoli", 4.6 Mbp, its
lines in the 50 MB L2, and "chr20", 64 Mbp, past it; seed 1234, sa_intv 8):

* sets of up to 32 rows whose walks all take n LF steps (n = 0, 1, 2, 4, 8,
  16, 32, 64 and the longest found among 2^21 random rows; lengths from the
  plain walk), each launched alone and timed as device time under
  torch.profiler (CUDA events around a launch this small time the host's
  call), warm on ecoli and from a cold L2 (256 MB written before each
  launch) on chr20; the least-squares slope over the sets of a full warp
  (32 rows) is the device time of one step;
* the batch the aligner walks (the SA rows of chip_smoke.py's ecoli PE
  batch, 12,000 reads, and of its chr20 batch, 4,000 reads, seeded on the
  card), warm and cold, and its longest walk alone;
* unless ``--walk-only``: the latency of one dependent line fetch
  (ops/fmindex.py ``line_chase_launch``) and the latency floor of each
  batch, its longest walk times that latency; the batch's first 1/8, 1/4
  and 1/2 of rows; and two variants of the kernel built from VARIANT below
  (which includes csrc/fmindex.cuh) into build/sa_probe/, held equal to the
  shipped kernel on each batch and timed beside it in turns: two rows a
  thread, advanced together so that a thread has two line fetches in
  flight, and a step decoded with fewer dependent operations.

``--walk-only`` times the walks alone, for a tree whose package has no
line-chase kernel.  Every row's position is held equal to the plain
version's.  The last line is one JSON object.  Nothing of JAX is imported.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the genomes, the card line, the timers)

LENGTHS = (0, 1, 2, 4, 8, 16, 32, 64)
SET = 32
VARIANT = r'''
// Two variants of the SA walk on lines of span 128 with sa_intv 1 << shift
// (no flags: the rows are checked by the shipped kernel).
//
// sa_lookup2_kernel: two rows a thread (rows t and t + half of the batch),
// both stepped in each round so that their line fetches are in flight
// together; a finished row's step is computed and dropped.
//
// sa_lookup_tree_kernel: one row a thread, as shipped, with lf_tree: the
// char's word picked by a tree of three selects (not a chain of seven), c
// matched by one xor with its repeated pattern, the popcounts summed as a
// tree, L2[c] and line[c] by two levels of selects.
#include <cstdint>
#include <cuda_runtime.h>
#include "fmindex.cuh"

namespace {
constexpr int kThreads = 256;
using bwamem_fm::kM55;

__device__ __forceinline__ int64_t lf_tree(const bwamem_fm::Fm& fm,
                                           const bwamem_fm::L2Regs& l2,
                                           int64_t k) {
  int64_t kk = k - (k >= fm.primary);
  kk = kk < 0 ? 0 : kk;
  uint4 v[3];
  bwamem_fm::fetch_line<3>(fm.lines, kk >> 7, v);
  const int pos = static_cast<int>(kk) & 127;
  const int wi = pos >> 4;
  // the masks depend on pos alone: ready before the loads return
  const uint32_t last = (0xFFFFFFFFu << (30 - 2 * (pos & 15))) & kM55;
  uint32_t keep[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) keep[j] = j < wi ? kM55 : (j == wi ? last : 0u);
  const uint32_t w[8] = {v[1].x, v[1].y, v[1].z, v[1].w,
                         v[2].x, v[2].y, v[2].z, v[2].w};
  const uint4 h = (wi & 4) ? v[2] : v[1];
  const uint32_t a = (wi & 2) ? h.z : h.x, b = (wi & 2) ? h.w : h.y;
  const uint32_t x = (wi & 1) ? b : a;
  const int c = (x >> (30 - 2 * (pos & 15))) & 3;
  const uint32_t pat = static_cast<uint32_t>(c) * kM55;
  int p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t t = w[j] ^ pat;
    p[j] = __popc(~(t | (t >> 1)) & keep[j]);
  }
  const int n = ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
  const uint32_t cb = (c & 2) ? ((c & 1) ? v[0].w : v[0].z)
                              : ((c & 1) ? v[0].y : v[0].x);
  const int64_t lc = (c & 2) ? ((c & 1) ? l2.c3 : l2.c2)
                             : ((c & 1) ? l2.c1 : l2.c0);
  const int64_t nk = lc + (static_cast<int>(cb) + n);
  return k == fm.primary ? 0 : nk;
}

__global__ void __launch_bounds__(kThreads) sa_lookup2_kernel(
    bwamem_fm::Fm fm, bwamem_fm::L2Regs l2, const int64_t* __restrict__ sa,
    int64_t mask, int shift, const int64_t* __restrict__ ks, int64_t n,
    int64_t* __restrict__ out) {
  const int64_t half = (n + 1) / 2;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i0 >= half) return;
  const int64_t i1 = i0 + half;
  int64_t a = ks[i0], b = i1 < n ? ks[i1] : 0;
  int64_t sa_steps = 0, sb_steps = 0;
  bool da = (a & mask) == 0, db = (b & mask) == 0;
  while (!(da && db)) {
    const int64_t na = bwamem_fm::lf_line<3>(fm, l2, a);
    const int64_t nb = bwamem_fm::lf_line<3>(fm, l2, b);
    if (!da) {
      a = na;
      ++sa_steps;
      da = (a & mask) == 0;
    }
    if (!db) {
      b = nb;
      ++sb_steps;
      db = (b & mask) == 0;
    }
  }
  out[i0] = sa[a >> shift] + sa_steps;
  if (i1 < n) out[i1] = sa[b >> shift] + sb_steps;
}

__global__ void __launch_bounds__(kThreads) sa_lookup_tree_kernel(
    bwamem_fm::Fm fm, bwamem_fm::L2Regs l2, const int64_t* __restrict__ sa,
    int64_t mask, int shift, const int64_t* __restrict__ ks, int64_t n,
    int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  int64_t k = ks[i], steps = 0;
  while ((k & mask) != 0) {
    k = lf_tree(fm, l2, k);
    ++steps;
  }
  out[i] = sa[k >> shift] + steps;
}
}  // namespace

// which: 2 = two rows a thread, 1 = the tree step
extern "C" int sa_variant_launch(
    int which, const uint32_t* lines, int64_t primary, int64_t seq_len,
    int64_t L2_0, int64_t L2_1, int64_t L2_2, int64_t L2_3, const int64_t* sa,
    int64_t mask, int shift, const int64_t* ks, int64_t n, int64_t* out,
    cudaStream_t stream) {
  bwamem_fm::Fm fm;
  fm.lines = lines;
  fm.L2 = nullptr;
  fm.primary = primary;
  fm.seq_len = seq_len;
  fm.W = 12;
  fm.lg = 7;
  const bwamem_fm::L2Regs l2{L2_0, L2_1, L2_2, L2_3};
  const int64_t m = which == 2 ? (n + 1) / 2 : n;
  const unsigned grid = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  if (which == 2)
    sa_lookup2_kernel<<<grid, kThreads, 0, stream>>>(fm, l2, sa, mask, shift,
                                                     ks, n, out);
  else
    sa_lookup_tree_kernel<<<grid, kThreads, 0, stream>>>(fm, l2, sa, mask,
                                                         shift, ks, n, out);
  return static_cast<int>(cudaGetLastError());
}
'''


def _build_variant():
    """VARIANT compiled by utils/cudabuild.py's nvcc and flags, with
    csrc/ on the include path; returns the bound library."""
    from bwamem_tpu_torch.utils import cudabuild

    out = os.path.join(ROOT, "build", "sa_probe")
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, "sa_variants.cu"), os.path.join(out, "libsav.so")
    with open(src, "w") as f:
        f.write(VARIANT)
    res = subprocess.run(
        [cudabuild.nvcc_path(), *cudabuild.ARCH_FLAGS, *cudabuild.FLAGS,
         "-I", cudabuild.CSRC, "-o", lib, src], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on the variants:\n{res.stderr}")
    print("[build] the variants:\n" + "\n".join(
        "  " + ln for ln in (res.stdout + res.stderr).splitlines()
        if "registers" in ln or "spill" in ln))
    so = ctypes.CDLL(lib)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    so.sa_variant_launch.restype = ctypes.c_int
    so.sa_variant_launch.argtypes = [i32, p] + [i64] * 6 + [p, i64, i32, p, i64,
                                                           p, p]
    return so


def _batch_rows(dfm, codes, n_pairs, dev):
    """The SA rows of chip_smoke.py's PE batch of ``n_pairs`` pairs (seed
    1235 after 8 warm-up pairs), seeded on the card as the fused path
    seeds them."""
    import numpy as np

    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.ops import seed as so
    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch
    from bwamem_tpu_torch.utils.synth import simulate_pairs

    rng = np.random.default_rng(chip_smoke.SEED + 1)
    simulate_pairs(codes, rng, 8)
    batch = simulate_pairs(codes, rng, n_pairs)
    reads = [np.asarray(c, np.uint8) for c in seq_to_codes_batch(batch)]
    qseq, qlen = so.pad_reads(reads, dev)
    return so.seed_sa(dfm, qseq, qlen,
                      so.SeedParams.from_opt(MemOptions())).ks.contiguous()


def _genome(name, length, n_pairs, cold, dev, variant):
    import torch

    from bwamem_tpu_torch import BwaMemIndex
    from bwamem_tpu_torch.engine.state import device_fm
    from bwamem_tpu_torch.ops import fmindex as fmops

    codes, img, _ = chip_smoke._synthetic_index(length)
    index = BwaMemIndex(img)
    dfm = device_fm(index._require().fm, dev)
    flags = torch.zeros(1, dtype=torch.int32, device=dev)

    def walk(k, out):
        return lambda: fmops.sa_lookup_launch(dfm, k, out, flags)

    def dev_ms(fn, kernel="sa_lookup_kernel", c=cold):
        return chip_smoke._device_ms(fn, 10, dev, kernel, cold=c)

    # sets of rows by walk length
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    pool = torch.randint(0, dfm.seq_len + 1, (1 << 21,), device=dev,
                         generator=gen)
    steps = chip_smoke._walk_lengths(dfm, pool)
    longest = int(steps.max())
    sets = []
    for n in sorted(set(LENGTHS + (longest,))):
        rows = pool[steps == n][:SET].contiguous()
        if rows.numel() == 0:
            continue
        out = torch.empty_like(rows)
        ms = dev_ms(walk(rows, out))
        err = chip_smoke._diff(out, fmops.sa_lookup_torch(dfm, rows))
        sets.append(dict(steps=n, rows=rows.numel(), us=ms * 1e3, err=err))
    full = [s for s in sets if s["rows"] == SET]  # a warp of rows each
    xs = [s["steps"] for s in full]
    ys = [s["us"] for s in full]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    where = "from a cold L2" if cold else "warm"
    print(f"{name} ({where}): " + ", ".join(
        f"{s['steps']} steps {s['us']:.2f} us ({s['rows']} rows)" for s in sets)
        + f"; slope over the sets of {SET} rows {slope:.4f} us a step, "
        f"intercept {my - slope * mx:.2f} us")
    # the aligner's batch
    k = _batch_rows(dfm, codes, n_pairs, dev)
    out = torch.empty_like(k)
    bsteps = chip_smoke._walk_lengths(dfm, k)
    top = int(torch.argmax(bsteps))
    k1, out1 = k[top: top + 1].clone(), torch.empty(1, dtype=torch.int64,
                                                     device=dev)
    res = dict(genome=name, cold=cold, slope_us=slope, sets=sets,
               batch_rows=k.numel(), batch_longest=int(bsteps.max()),
               batch_mean_steps=float(bsteps.float().mean()),
               batch_ms=dev_ms(walk(k, out), c=False),
               batch_cold_ms=dev_ms(walk(k, out), c=True),
               longest_alone_ms=dev_ms(walk(k1, out1), c=False),
               longest_alone_cold_ms=dev_ms(walk(k1, out1), c=True))
    res["err"] = max([s["err"] for s in sets]
                     + [chip_smoke._diff(out, fmops.sa_lookup_torch(dfm, k)),
                        chip_smoke._diff(out1, out[top: top + 1])])
    if int(flags.item()):
        raise AssertionError(f"{name}: the SA kernel raised flags")
    print(f"{name} batch: {k.numel()} rows, mean {res['batch_mean_steps']:.3f} "
          f"steps, longest {res['batch_longest']}: {res['batch_ms']:.4f} ms "
          f"warm, {res['batch_cold_ms']:.4f} ms from a cold L2; its longest "
          f"walk alone {res['longest_alone_ms']:.4f} ms warm, "
          f"{res['longest_alone_cold_ms']:.4f} ms cold")
    if variant is not None:
        lat = {c: chip_smoke._chase_us(dfm, dev, c) for c in (False, True)}
        res.update(fetch_us=lat[False], fetch_cold_us=lat[True],
                   floor_ms=res["batch_longest"] * lat[False] / 1e3,
                   floor_cold_ms=res["batch_longest"] * lat[True] / 1e3)
        if dfm.lines.shape[1] != 12 or dfm.sa_shift < 0:
            raise AssertionError("the variant takes span 128, a power-of-two "
                                 "sa_intv")
        L2 = dfm.L2_values

        def var(which, rows, dst):
            def launch():
                rc = variant.sa_variant_launch(
                    which, dfm.lines.data_ptr(), dfm.primary, dfm.seq_len,
                    *L2[:4], dfm.sa.data_ptr(), dfm.sa_intv - 1, dfm.sa_shift,
                    rows.data_ptr(), rows.numel(), dst.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
                if rc:
                    raise RuntimeError(f"variant {which} failed: cudaError {rc}")
            return launch

        out2, out3 = (torch.empty_like(k) for _ in range(2))
        out4 = torch.empty_like(k1)
        two, tree = var(2, k, out2), var(1, k, out3)
        fns = {"one": (walk(k, out), "sa_lookup_kernel"),
               "two": (two, "sa_lookup2_kernel"),
               "tree": (tree, "sa_lookup_tree_kernel")}
        # in turns: shipped, two, tree, tree, two, shipped
        seq = ("one", "two", "tree", "tree", "two", "one")
        turns = {c: [(w, dev_ms(fns[w][0], fns[w][1], c)) for w in seq]
                 for c in (False, True)}
        tree1 = var(1, k1, out4)
        alone = [dev_ms(walk(k1, out1), c=False),
                 dev_ms(tree1, "sa_lookup_tree_kernel", False),
                 dev_ms(tree1, "sa_lookup_tree_kernel", False),
                 dev_ms(walk(k1, out1), c=False)]
        by_size = {f"1/{d}": dev_ms(walk(k[: k.numel() // d],
                                         out[: k.numel() // d]), c=False)
                   for d in (8, 4, 2)}
        res.update(turns=turns, tree_alone_turns_ms=alone, by_size_ms=by_size)
        res["err"] = max(res["err"], chip_smoke._diff(out2, out),
                         chip_smoke._diff(out3, out),
                         chip_smoke._diff(out4, out1))
        print(f"{name}: one dependent line fetch {lat[False]:.4f} us warm, "
              f"{lat[True]:.4f} us from a cold L2; latency floor of the batch "
              f"(longest walk x one fetch) {res['floor_ms']:.5f} ms warm, "
              f"{res['floor_cold_ms']:.5f} ms cold")
        for c, tt in turns.items():
            print(f"{name} batch {'cold' if c else 'warm'}, in turns: " + ", ".join(
                f"{w} {x:.4f}" for w, x in tt) + " ms")
        print(f"{name}: the longest walk alone, shipped / tree / tree / "
              f"shipped: " + ", ".join(f"{x:.4f}" for x in alone) + " ms; the "
              f"batch's first rows, warm: " + ", ".join(
                  f"{d} {x:.4f} ms" for d, x in by_size.items()))
    index.close()
    if res["err"]:
        raise AssertionError(f"{name}: a walk disagrees with the plain version")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sa_step_probe: no CUDA card", file=sys.stderr)
        return 1
    walk_only = "--walk-only" in sys.argv[1:]
    dev = torch.device("cuda", 0)
    card = chip_smoke._card_line()
    print(f"card: {card}")
    variant = None if walk_only else _build_variant()
    out = {"card": card, "genomes": [
        _genome("ecoli", chip_smoke.ECOLI_LEN, chip_smoke.N_PAIRS, False, dev,
                variant),
        _genome("chr20", chip_smoke.CHR20_LEN, chip_smoke.CHR20_PAIRS, True,
                dev, variant)]}
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
