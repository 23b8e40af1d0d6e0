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
// `bwt_extend` one line for each of its two rank queries; `backward_search`
// narrows [k, l] by one base of its read per step, from the read's last
// column leftwards, two rank queries a step, until the interval empties, a
// base is ambiguous or qlen bases are matched.  `sa_lookup` walks
// k <- LF(k) until k is a multiple of sa_intv, then returns
// sa[k / sa_intv] + steps.  The JAX walk's compaction ladder and argsort
// un-permute are TPU workarounds for lockstep lanes; here each thread stops
// when its own walk ends.
//
// What bounds them: latency of dependent random reads, not bytes.  Every
// step of a walk reads a 48-byte line at a random place in the table (48 MB
// of lines and 128 MB of sampled SA for a 64 Mbp genome, past the 50 MB
// L2), and the next step's address depends on it.  A batch of 10^5 rows
// fills the card at once, so `sa_lookup` lasts as long as its longest walk
// (80-90 steps at sa_intv 8) times the latency of one step.  So a step is
// made one memory round trip (fmindex.cuh `lf_line`): the whole line in NV
// 16-byte loads issued together, the char, its count and the popcounts
// decoded from registers by selects, L2[0..3] in kernel arguments, and
// when sa_intv is a power of two (the aligner's 8, bwa's 32) the sampled
// test a mask and the sample index a shift, not a 64-bit division.
// `line_chase_kernel` measures the floor this leaves: one thread's chain of
// dependent line fetches, with no decode.
//
// The idx-sharded tables (D12; bwamem_tpu/ops/fmindex_tpu.py
// `make_occ4_sharded`, `_shard_gather`): `occ4_kernel` and
// `sa_lookup_kernel` are templates of the index form (fmindex.cuh `Fm` or
// `FmShards`), and the *_sharded launchers run the same bodies with each
// line and SA fetch taken from the shard that owns it, on the launching
// card or, through peer access (`bwamem_fm_enable_peer`), another.
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
using bwamem_fm::FmShards;

constexpr int kThreads = 256;
constexpr int kErrRowRange = 1;
constexpr int kErrWalkLength = 2;

template <class F>
__global__ void __launch_bounds__(kThreads) occ4_kernel(
    F fm, const int64_t* __restrict__ ks, int64_t n,
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

// The sampled-SA walk, a thread a row, on lines of NV vectors.  kPow2: the
// interval is 1 << shift, so a row is sampled when (k & mask) == 0 and its
// sample is sa[k >> shift]; otherwise the test is k % sa_intv (a 64-bit
// division a step), which only an index built with another interval takes.
template <int NV, bool kPow2, class F>
__global__ void __launch_bounds__(kThreads) sa_lookup_kernel(
    F fm, bwamem_fm::L2Regs l2, const int64_t* __restrict__ sa,
    int64_t sa_intv, int shift, const int64_t* __restrict__ ks, int64_t n,
    int64_t* __restrict__ out, int32_t* __restrict__ err) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  int64_t k = ks[i];
  if (k < 0 || k > fm.seq_len) {
    atomicOr(err, kErrRowRange);
    out[i] = 0;
    return;
  }
  const int64_t mask = sa_intv - 1;
  int64_t steps = 0;
  while (kPow2 ? (k & mask) != 0 : k % sa_intv != 0) {
    if (steps == fm.seq_len) {  // the cycle of LF steps has length seq_len+1
      atomicOr(err, kErrWalkLength);
      break;
    }
    k = bwamem_fm::lf_line<NV>(fm, l2, k);
    ++steps;
  }
  // sa[0] == -1: a walk through the primary row wraps to row 0, and
  // steps - 1 is then the position (bwa bwt_sa's trick)
  out[i] = bwamem_fm::sa_sample(fm, sa, kPow2 ? k >> shift : k / sa_intv) +
           steps;
}

// Latency of one dependent line fetch: one thread fetches `steps` lines,
// each chosen by a hash of every word of the one before (the SA walk's
// dependence, without its decode), and leaves the last line's index.
template <int NV>
__global__ void line_chase_kernel(const uint32_t* __restrict__ lines,
                                  int64_t nb, int64_t li, int steps,
                                  int64_t* __restrict__ out) {
  for (int s = 0; s < steps; ++s) {
    uint4 v[NV];
    bwamem_fm::fetch_line<NV>(lines, li, v);
    uint32_t h = static_cast<uint32_t>(s);
#pragma unroll
    for (int j = 0; j < NV; ++j) h ^= v[j].x ^ v[j].y ^ v[j].z ^ v[j].w;
    h *= 0x9E3779B1u;
    li = static_cast<int64_t>((static_cast<uint64_t>(h) *
                               static_cast<uint64_t>(nb)) >> 32);
  }
  *out = li;
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
  occ4_kernel<Fm><<<blocks(n), kThreads, 0, stream>>>(
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

namespace {

template <int NV, class F>
void sa_launch(const F& fm, const bwamem_fm::L2Regs& l2, const int64_t* sa,
               int64_t sa_intv, int shift, const int64_t* ks, int64_t n,
               int64_t* out, int32_t* err, cudaStream_t stream) {
  if (shift >= 0)
    sa_lookup_kernel<NV, true, F><<<blocks(n), kThreads, 0, stream>>>(
        fm, l2, sa, sa_intv, shift, ks, n, out, err);
  else
    sa_lookup_kernel<NV, false, F><<<blocks(n), kThreads, 0, stream>>>(
        fm, l2, sa, sa_intv, shift, ks, n, out, err);
}

}  // namespace

// The SA walk on lines of W = 4 NV u32 (span 128, 256 or 512; another W is
// refused).  L2_0..3 are L2[0..3], passed by value; shift >= 0 when
// sa_intv == 1 << shift, -1 for the division path.
extern "C" int bwamem_fm_sa_lookup_launch(
    const uint32_t* lines, int W, int lg, const int64_t* L2, int64_t primary,
    int64_t seq_len, int64_t L2_0, int64_t L2_1, int64_t L2_2, int64_t L2_3,
    const int64_t* sa, int64_t sa_intv, int shift, const int64_t* ks,
    int64_t n, int64_t* out, int32_t* err, cudaStream_t stream) {
  const Fm fm = make_fm(lines, W, lg, L2, primary, seq_len);
  const bwamem_fm::L2Regs l2{L2_0, L2_1, L2_2, L2_3};
  switch (W) {
    case 12: sa_launch<3>(fm, l2, sa, sa_intv, shift, ks, n, out, err, stream); break;
    case 20: sa_launch<5>(fm, l2, sa, sa_intv, shift, ks, n, out, err, stream); break;
    case 36: sa_launch<9>(fm, l2, sa, sa_intv, shift, ks, n, out, err, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One thread's chain of `steps` dependent fetches of lines of W u32 (nb
// lines) from line li; out [1] gets the last line's index.
extern "C" int bwamem_fm_line_chase_launch(const uint32_t* lines, int W,
                                           int64_t nb, int64_t li, int steps,
                                           int64_t* out, cudaStream_t stream) {
  switch (W) {
    case 12: line_chase_kernel<3><<<1, 1, 0, stream>>>(lines, nb, li, steps, out); break;
    case 20: line_chase_kernel<5><<<1, 1, 0, stream>>>(lines, nb, li, steps, out); break;
    case 36: line_chase_kernel<9><<<1, 1, 0, stream>>>(lines, nb, li, steps, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// ---- the idx-sharded tables.  line_ptrs / sa_ptrs: host arrays of
// n_shards device pointers (shard s holds lines [s * bps, (s + 1) * bps)
// and samples [s * sps, (s + 1) * sps)); the rest as the launchers above.
// More than kMaxShards shards: cudaErrorInvalidValue, nothing launched.

extern "C" int bwamem_fm_occ4_sharded_launch(
    const uint64_t* line_ptrs, int n_shards, int64_t bps, int W, int lg,
    const int64_t* L2, int64_t primary, int64_t seq_len, const int64_t* ks,
    int64_t n, int32_t* out, int32_t* err, cudaStream_t stream) {
  FmShards fm;
  if (!bwamem_fm::make_fm_shards(line_ptrs, nullptr, n_shards, bps, 0, W, lg,
                                 L2, primary, seq_len, &fm))
    return static_cast<int>(cudaErrorInvalidValue);
  occ4_kernel<FmShards><<<blocks(n), kThreads, 0, stream>>>(fm, ks, n, out,
                                                           err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bwamem_fm_sa_lookup_sharded_launch(
    const uint64_t* line_ptrs, const uint64_t* sa_ptrs, int n_shards,
    int64_t bps, int64_t sps, int W, int lg, const int64_t* L2,
    int64_t primary, int64_t seq_len, int64_t L2_0, int64_t L2_1,
    int64_t L2_2, int64_t L2_3, int64_t sa_intv, int shift,
    const int64_t* ks, int64_t n, int64_t* out, int32_t* err,
    cudaStream_t stream) {
  FmShards fm;
  if (!bwamem_fm::make_fm_shards(line_ptrs, sa_ptrs, n_shards, bps, sps, W,
                                 lg, L2, primary, seq_len, &fm))
    return static_cast<int>(cudaErrorInvalidValue);
  const bwamem_fm::L2Regs l2{L2_0, L2_1, L2_2, L2_3};
  switch (W) {
    case 12: sa_launch<3>(fm, l2, nullptr, sa_intv, shift, ks, n, out, err, stream); break;
    case 20: sa_launch<5>(fm, l2, nullptr, sa_intv, shift, ks, n, out, err, stream); break;
    case 36: sa_launch<9>(fm, l2, nullptr, sa_intv, shift, ks, n, out, err, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Lets `dev` load `peer`'s memory (a shard on another card).  0 when it
// can (already enabled included), else the CUDA error; never copies.
extern "C" int bwamem_fm_enable_peer(int dev, int peer) {
  if (dev == peer) return 0;
  int ok = 0;
  cudaError_t rc = cudaDeviceCanAccessPeer(&ok, dev, peer);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (!ok) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int cur = 0;
  cudaGetDevice(&cur);
  cudaSetDevice(dev);
  rc = cudaDeviceEnablePeerAccess(peer, 0);
  cudaSetDevice(cur);
  if (rc == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the sticky-free error state
    return 0;
  }
  return static_cast<int>(rc);
}
