// Batched banded affine-gap Smith-Waterman extension for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bwamem_tpu/ops/extend_pallas.py
// `_extend_kernel` (launched by `ksw_extend_pallas`) and, with it, the XLA
// scan twin bwamem_tpu/ops/extend_tpu.py `ksw_extend_batch`.  Semantics are
// exactly [EXT] ksw.c ksw_extend2; the recurrence itself is the __device__
// function `ksw_extend_core` of extend.cuh, which the chain-to-region kernel
// (chain2aln.cu) shares.
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

#include "extend.cuh"

namespace {

constexpr int kThreads = 32;

// A job's row of codes in a job-major array.
struct Codes {
  const uint8_t* __restrict__ p;
  __device__ __forceinline__ int operator()(int i) const { return p[i]; }
};

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
  const int32_t* s = scal + b * lds;
  const bwamem::KswResult r = bwamem::ksw_extend_core(
      Codes{qseq + b * ldq}, Codes{tseq + b * ldt}, s[0], s[1], s[2], s[3],
      smat, eh_h + b, eh_e + b, st, Q, o_del, e_del, o_ins, e_ins, zdrop);
  out[0 * st + b] = r.score;
  out[1 * st + b] = r.qle;
  out[2 * st + b] = r.tle;
  out[3 * st + b] = r.gtle;
  out[4 * st + b] = r.gscore;
  out[5 * st + b] = r.max_off;
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
