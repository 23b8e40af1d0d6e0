// Batched banded affine-gap Smith-Waterman extension for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bwamem_tpu/ops/extend_pallas.py
// `_extend_kernel` (launched by `ksw_extend_pallas`) and, with it, the XLA
// scan twin bwamem_tpu/ops/extend_tpu.py `ksw_extend_batch`.  Semantics are
// exactly [EXT] ksw.c ksw_extend2, as written out in the host oracle
// bwamem_tpu/engine/extend.py `ksw_extend2` and its C++ twin
// engine/native/ksw.cpp: z-drop, h0 seeding, the adaptive [beg, end) window
// that re-reads stale cells when it regrows, the eh[end] boundary writes, the
// last-attaining-column tie-break of the row max (>=), gscore updates on <=,
// maxv/max_off updates on strict >.
//
// Design: one thread per job, running the scalar recurrence row by row.  The
// eh[] row state (eh[j].h = H(i-1, j-1), eh[j].e = E(i, j)) lives in a
// scratch buffer laid out [2, Q+1, B] with the job index fastest, so threads
// of a warp that stand on the same column touch neighbouring words.  The
// kernel initialises that scratch itself: cells outside the window keep
// their stale values and are read again when the window regrows, so garbage
// from the allocator would change results.  Cells are int32 (the AVX2 host
// twin's int16 lanes are a host-SIMD width trick, not semantics).  The 5x5
// scoring matrix sits in shared memory.  The band preamble (w clamped by the
// largest possible gap, ksw_extend2's first lines) is computed by the Python
// wrapper and arrives as w_adj, so the plain PyTorch version and this kernel
// share one copy of it.
//
// What bounds it: latency and occupancy, not bytes or operations.  A wave
// holds a few thousand jobs, so one thread per job fills well under one warp
// per SM on 132 SMs, and every cell waits on dependent loads of the eh
// scratch through L1/L2.  Blocks are one warp each so that a wave spreads
// over as many SMs as it can.  A warp-per-job design (columns of a row across
// lanes, the F recurrence as a warp prefix-max, eh in shared memory) is the
// later work that trades this latency for parallelism.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads) ksw_extend_kernel(
    const uint8_t* __restrict__ qseq, int64_t ldq,  // [B, ldq] codes 0-4
    const uint8_t* __restrict__ tseq, int64_t ldt,  // [B, ldt] codes 0-4
    const int32_t* __restrict__ scal, int64_t lds,  // [B, lds]: qlen tlen h0 w_adj
    const int32_t* __restrict__ mat,                // [5, 5]
    int32_t* __restrict__ eh_h,                     // [Q+1, B] scratch
    int32_t* __restrict__ eh_e,                     // [Q+1, B] scratch
    int32_t* __restrict__ out,                      // [6, B]
    int B, int Q, int o_del, int e_del, int o_ins, int e_ins, int zdrop) {
  __shared__ int32_t smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;

  const int64_t st = B;  // distance between eh[j] and eh[j+1]
  int32_t* __restrict__ H = eh_h + b;
  int32_t* __restrict__ E = eh_e + b;
  const uint8_t* __restrict__ q = qseq + b * ldq;
  const uint8_t* __restrict__ t = tseq + b * ldt;
  const int32_t* s = scal + b * lds;
  const int qlen = s[0], tlen = s[1], h0 = s[2], w = s[3];
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;

  // eh[0].h = h0; eh[j].h = max(h0 - oe_ins - (j-1)*e_ins, 0) up to qlen,
  // 0 past it; eh[].e = 0 (ops/extend_tpu.py:91-95)
  H[0] = h0;
  E[0] = 0;
  int ramp = h0 > oe_ins ? h0 - oe_ins : 0;
  for (int j = 1; j <= Q; ++j) {
    H[j * st] = j <= qlen ? ramp : 0;
    E[j * st] = 0;
    ramp = ramp > e_ins ? ramp - e_ins : 0;
  }

  int maxv = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0;
  int beg = 0, end = qlen;
  for (int i = 0; i < tlen; ++i) {
    const int32_t* qp = smat + 5 * t[i];
    int f = 0, m = 0, mj = -1;
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    int h1 = 0;
    if (beg == 0) {
      h1 = h0 - (o_del + e_del * (i + 1));
      if (h1 < 0) h1 = 0;
    }
    for (int j = beg; j < end; ++j) {
      // eh[j] = {H(i-1, j-1), E(i, j)}, f = F(i, j), h1 = H(i, j-1)
      int M = H[j * st];
      int e = E[j * st];
      H[j * st] = h1;
      M = M ? M + qp[q[j]] : 0;  // no extension from a zeroed cell
      int h = M > e ? M : e;
      h = h > f ? h : f;
      h1 = h;
      mj = m > h ? mj : j;
      m = m > h ? m : h;
      int u = M - oe_del;
      u = u > 0 ? u : 0;
      e -= e_del;
      e = e > u ? e : u;
      E[j * st] = e;
      u = M - oe_ins;
      u = u > 0 ? u : 0;
      f -= e_ins;
      f = f > u ? f : u;
    }
    H[end * st] = h1;
    E[end * st] = 0;
    if (end == qlen && gscore <= h1) {  // reached the end of the query
      max_ie = i;
      gscore = h1;
    }
    if (m == 0) break;
    if (m > maxv) {
      maxv = m;
      max_i = i;
      max_j = mj;
      const int off = mj > i ? mj - i : i - mj;
      if (max_off < off) max_off = off;
    } else if (zdrop > 0) {
      const int di = i - max_i, dj = mj - max_j;
      if (di > dj) {
        if (maxv - m - (di - dj) * e_del > zdrop) break;
      } else {
        if (maxv - m - (dj - di) * e_ins > zdrop) break;
      }
    }
    // shrink the band over eh indices [beg, end]
    int j = beg;
    while (j < end && H[j * st] == 0 && E[j * st] == 0) ++j;
    beg = j;
    j = end;
    while (j >= beg && H[j * st] == 0 && E[j * st] == 0) --j;
    end = j + 2 < qlen ? j + 2 : qlen;
  }
  out[0 * st + b] = maxv;
  out[1 * st + b] = max_j + 1;
  out[2 * st + b] = max_i + 1;
  out[3 * st + b] = max_ie + 1;
  out[4 * st + b] = gscore;
  out[5 * st + b] = max_off;
}

}  // namespace

// Launches one wave on `stream`; returns cudaGetLastError() so the caller
// sees a refused launch (it never runs, and a later synchronize is silent).
// Output rows: score, qle, tle, gtle, gscore, max_off.
extern "C" int bwamem_ksw_extend_launch(
    const void* qseq, int64_t ldq, const void* tseq, int64_t ldt,
    const void* scal, int64_t lds, const void* mat, void* eh, void* out,
    int B, int Q, int o_del, int e_del, int o_ins, int e_ins, int zdrop,
    void* stream) {
  if (B <= 0) return 0;
  int32_t* eh_h = static_cast<int32_t*>(eh);
  int32_t* eh_e = eh_h + static_cast<int64_t>(Q + 1) * B;
  const int blocks = (B + kThreads - 1) / kThreads;
  ksw_extend_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qseq), ldq, static_cast<const uint8_t*>(tseq),
      ldt, static_cast<const int32_t*>(scal), lds,
      static_cast<const int32_t*>(mat), eh_h, eh_e,
      static_cast<int32_t*>(out), B, Q, o_del, e_del, o_ins, e_ins, zdrop);
  return static_cast<int>(cudaGetLastError());
}
