// FM-index rank queries, bi-interval extension and sampled-SA walks for
// Hopper (sm_90a).
//
// Replaces the JAX device programs of bwamem_tpu/ops/fmindex_tpu.py:
// `occ4_device` (with `_rows_for` and `_block_counts4`), `_extend_core` /
// `extend_device`, and `_sa_tick` + `sa_lookup_body` / `sa_lookup`, and of
// bwamem_tpu/ops/seed_tpu.py `backward_search_batch`.  Their semantics are
// bwa's bwt_occ4, bwt_extend, bwt_sa and bwt_match_exact, as the host oracle
// bwamem_tpu/engine/fmindex.py writes them out.  The line decode they share,
// and the bwt_extend arithmetic (also called by the seeding kernels of
// seed.cu), are in fmindex.cuh.
//
// Design: one thread per query.  `occ4` reads one line per row;
// `bwt_extend` one line for each of its two rank queries; `sa_lookup` walks
// k <- LF(k), one line per step, until k is a multiple of sa_intv, then
// returns sa[k / sa_intv] + steps; `backward_search` narrows [k, l] by one
// base of its read per step, from the read's last column leftwards, two
// rank queries a step, until the interval empties, a base is ambiguous or
// qlen bases are matched.  The JAX walk's compaction ladder and
// argsort un-permute are TPU workarounds for lockstep lanes; here each
// thread stops when its own walk ends, and a warp runs as long as its
// longest walk.
//
// What bounds them: latency of dependent random reads.  Every step of a
// walk is a read of a 48-byte line at a random place in the table (48 MB of
// lines and 128 MB of sampled SA for a 64 Mbp genome, well past the 50 MB
// L2), and the next step's address depends on it.  Throughput comes only
// from the number of walks in flight: a batch holds hundreds of thousands
// of rows, so the card is filled with warps whose loads overlap.  Vector
// 16-byte line loads, a warp per line and explicit latency hiding are
// later work.
//
// Errors: a row outside [-1, seq_len] (occ4, bwt_extend) or [0, seq_len]
// (sa_lookup) sets bit 1 of *err and yields zeros; a walk that has taken
// seq_len steps without reaching a sample (an inconsistent index) sets
// bit 2.  The Python wrappers raise on either.

#include <cstdint>
#include <cuda_runtime.h>

#include "fmindex.cuh"

namespace {

using bwamem_fm::Fm;

constexpr int kThreads = 256;
constexpr int kErrRowRange = 1;
constexpr int kErrWalkLength = 2;

__global__ void __launch_bounds__(kThreads) occ4_kernel(
    Fm fm, const int64_t* __restrict__ ks, int64_t n,
    int32_t* __restrict__ out,  // [n, 4]
    int32_t* __restrict__ err) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t k = ks[i];
  int c[4] = {0, 0, 0, 0};
  if (k < -1 || k > fm.seq_len)
    atomicOr(err, kErrRowRange);
  else
    bwamem_fm::occ4(fm, k, c);
  reinterpret_cast<int4*>(out)[i] = make_int4(c[0], c[1], c[2], c[3]);
}

__global__ void __launch_bounds__(kThreads) extend_kernel(
    Fm fm, const int64_t* __restrict__ x0, const int64_t* __restrict__ x1,
    const int64_t* __restrict__ s, int64_t n, int is_back,
    int64_t* __restrict__ ox0,  // [n, 4]
    int64_t* __restrict__ ox1,  // [n, 4]
    int32_t* __restrict__ sz,   // [n, 4]
    int32_t* __restrict__ err) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  int64_t a[4], b[4];
  int d[4];
  if (!bwamem_fm::bwt_extend(fm, x0[i], x1[i], s[i], is_back, a, b, d))
    atomicOr(err, kErrRowRange);
  for (int c = 0; c < 4; ++c) {
    ox0[4 * i + c] = a[c];
    ox1[4 * i + c] = b[c];
  }
  reinterpret_cast<int4*>(sz)[i] = make_int4(d[0], d[1], d[2], d[3]);
}

__global__ void __launch_bounds__(kThreads) sa_lookup_kernel(
    Fm fm, const int64_t* __restrict__ sa, int64_t sa_intv,
    const int64_t* __restrict__ ks, int64_t n,
    int64_t* __restrict__ out, int32_t* __restrict__ err) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  int64_t k = ks[i];
  if (k < 0 || k > fm.seq_len) {
    atomicOr(err, kErrRowRange);
    out[i] = 0;
    return;
  }
  int64_t steps = 0;
  while (k % sa_intv != 0) {
    if (steps == fm.seq_len) {  // the cycle of LF steps has length seq_len+1
      atomicOr(err, kErrWalkLength);
      break;
    }
    k = bwamem_fm::lf(fm, k);
    ++steps;
  }
  // sa[0] == -1: a walk through the primary row wraps to row 0, and
  // steps - 1 is then the position (bwa bwt_sa's trick)
  out[i] = sa[k / sa_intv] + steps;
}

__global__ void __launch_bounds__(kThreads) backward_search_kernel(
    Fm fm, const uint8_t* __restrict__ qseq,  // [B, L], reads right-aligned
    int L, const int32_t* __restrict__ qlen, int B,
    int64_t* __restrict__ k_out, int64_t* __restrict__ l_out,
    int32_t* __restrict__ matched) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const uint8_t* q = qseq + static_cast<int64_t>(i) * L;
  const int n = qlen[i] < L ? qlen[i] : L;
  int64_t k = 0, l = fm.seq_len;
  int m = 0;
  for (; m < n; ++m) {
    const int c = q[L - 1 - m];
    if (c > 3) break;
    int ck[4], cl[4];
    bwamem_fm::occ4(fm, k - 1, ck);
    bwamem_fm::occ4(fm, l, cl);
    const int64_t k2 = fm.L2[c] + ck[c] + 1, l2 = fm.L2[c] + cl[c];
    if (k2 > l2) break;
    k = k2;
    l = l2;
  }
  k_out[i] = k;
  l_out[i] = l;
  matched[i] = m;
}

Fm make_fm(const uint32_t* lines, int W, int lg, const int64_t* L2,
           int64_t primary, int64_t seq_len) {
  Fm fm;
  fm.lines = lines;
  fm.L2 = L2;
  fm.primary = primary;
  fm.seq_len = seq_len;
  fm.W = W;
  fm.lg = lg;
  return fm;
}

unsigned blocks(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Launchers: device pointers and a stream in, cudaGetLastError() out.  The
// index is passed as lines [nb, W] (u32 bit patterns), log2(span), L2 [5]
// int64, primary and seq_len.

extern "C" int bwamem_fm_occ4_launch(
    const uint32_t* lines, int W, int lg, const int64_t* L2, int64_t primary,
    int64_t seq_len, const int64_t* ks, int64_t n, int32_t* out,
    int32_t* err, cudaStream_t stream) {
  occ4_kernel<<<blocks(n), kThreads, 0, stream>>>(
      make_fm(lines, W, lg, L2, primary, seq_len), ks, n, out, err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bwamem_fm_extend_launch(
    const uint32_t* lines, int W, int lg, const int64_t* L2, int64_t primary,
    int64_t seq_len, const int64_t* x0, const int64_t* x1, const int64_t* s,
    int64_t n, int is_back, int64_t* ox0, int64_t* ox1, int32_t* sz,
    int32_t* err, cudaStream_t stream) {
  extend_kernel<<<blocks(n), kThreads, 0, stream>>>(
      make_fm(lines, W, lg, L2, primary, seq_len), x0, x1, s, n, is_back,
      ox0, ox1, sz, err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bwamem_fm_sa_lookup_launch(
    const uint32_t* lines, int W, int lg, const int64_t* L2, int64_t primary,
    int64_t seq_len, const int64_t* sa, int64_t sa_intv, const int64_t* ks,
    int64_t n, int64_t* out, int32_t* err, cudaStream_t stream) {
  sa_lookup_kernel<<<blocks(n), kThreads, 0, stream>>>(
      make_fm(lines, W, lg, L2, primary, seq_len), sa, sa_intv, ks, n, out,
      err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bwamem_fm_backward_search_launch(
    const uint32_t* lines, int W, int lg, const int64_t* L2, int64_t primary,
    int64_t seq_len, const uint8_t* qseq, int L, const int32_t* qlen, int B,
    int64_t* k_out, int64_t* l_out, int32_t* matched, cudaStream_t stream) {
  backward_search_kernel<<<blocks(B), kThreads, 0, stream>>>(
      make_fm(lines, W, lg, L2, primary, seq_len), qseq, L, qlen, B, k_out,
      l_out, matched);
  return static_cast<int>(cudaGetLastError());
}
