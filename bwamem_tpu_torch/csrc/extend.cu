// Batched banded affine-gap Smith-Waterman extension for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bwamem_tpu/ops/extend_pallas.py
// `_extend_kernel` (launched by `ksw_extend_pallas`) and, with it, the XLA
// scan twin bwamem_tpu/ops/extend_tpu.py `ksw_extend_batch`.  Semantics are
// exactly [EXT] ksw.c ksw_extend2; the recurrence itself is extend.cuh's,
// which the chain-to-region kernel (chain2aln.cu) shares.
//
// Design: a job on a group of kGroup lanes (a whole warp), on a persistent
// grid.  Groups take jobs from a global counter in the order the wrapper
// gives, heaviest first (target rows x band cells a row), so the longest
// job starts at once and the light ones fill the card around it; results
// go back in job order, so the order changes no result.  A job runs on
// extend.cuh's `ksw_extend_group`: a target row's band across the lanes, F
// as a max-plus prefix scan by shuffles, the row max as one reduction of a
// packed (h, j), scores by `prmt` from the packed int8 profile.  The job's
// query codes and its H/E row state (2 x (qlen + 1) int32) sit in the
// group's slice of dynamic shared memory, sized from Qw, the longest query
// of the jobs it takes; the target is read from the job-major array, a row
// a lane, kGroup rows at a time.  The 5x5 matrix sits in shared memory.
// The band preamble (w clamped by the largest possible gap, ksw_extend2's
// first lines) is computed by the Python wrapper and arrives as w_adj, so
// the plain PyTorch version and this kernel share one copy of it.
//
// Jobs past the group DP's limits (qlen >= 2^12, an H that could reach
// 2^19, scores outside int8, or a row state past the block's shared memory;
// ops/extend.py `warp_jobs` draws the line and `bwamem_ksw_extend_max_qlen`
// gives the card's part of it) are run here too, on one lane of the group,
// by the scalar `ksw_extend_core` on a global scratch of 2 x (Qs + 1) int32
// a job, laid out for those jobs alone (`slot` numbers them).  The wrapper
// counts them.
//
// What bounds it: the latency of the heaviest job's chain of target rows
// (a row is a few shared-memory loads, a 5-step shuffle scan, four group
// reductions), and, on a wave of thousands of jobs, the SMs' issue rate; not
// bytes (a few MB) or operations (~10 a band cell).  kGroup is the width
// that ran the largest ecoli wave fastest of 32, 16 and 8 lanes (several
// jobs a warp, fewer scan steps, more cells a lane; PERF.md §6, PR 8).

#include <cstdint>
#include <cuda_runtime.h>

#include "extend.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kWarps = 4;  // a block
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 32;  // lanes a job
constexpr int kGroups = kThreads / kGroup;
constexpr int kMaxQlen = (1 << bwamem::kColBits) - 1;

// A job's row of codes in a job-major array.
struct Codes {
  const uint8_t* __restrict__ p;
  __device__ __forceinline__ int operator()(int i) const { return p[i]; }
};

using bwamem::slice_words;  // a group's slice of dynamic shared memory

__global__ void __launch_bounds__(kThreads) ksw_extend_kernel(
    const uint8_t* __restrict__ qseq, int64_t ldq,  // [B, ldq] codes 0-4
    const uint8_t* __restrict__ tseq, int64_t ldt,  // [B, ldt] codes 0-4
    const int32_t* __restrict__ scal, int64_t lds,  // [B, lds]: qlen tlen h0 w_adj
    const int32_t* __restrict__ mat,                // [5, 5]
    const int32_t* __restrict__ order,  // [B] jobs, heaviest first
    const int32_t* __restrict__ slot,   // [B] -1: the group DP; else scratch slot
    int32_t* __restrict__ next,         // [1] the next position of order
    int32_t* __restrict__ scratch,      // [n_scalar, 2, Qs + 1]
    int Qs, int Qw,
    int32_t* __restrict__ out,  // [6, B]
    int B, int o_del, int e_del, int o_ins, int e_ins, int zdrop) {
  extern __shared__ int32_t slices[];
  __shared__ int32_t smat[25];
  __shared__ uint32_t sprof[10];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  bwamem::pack_scores(mat, sprof);
  __syncthreads();
  const unsigned gmask = bwamem::group_mask<kGroup>();
  const int lane = threadIdx.x & (kGroup - 1);
  int32_t* H = slices + (threadIdx.x / kGroup) * slice_words(Qw);
  int32_t* E = H + Qw + 1;
  uint8_t* qs = reinterpret_cast<uint8_t*>(E + Qw + 1);
  for (;;) {
    int r = 0;
    if (lane == 0) r = atomicAdd(next, 1);
    r = __shfl_sync(gmask, r, 0, kGroup);
    if (r >= B) break;
    const int b = order[r];
    const int32_t* s = scal + b * lds;
    const uint8_t* q = qseq + b * ldq;
    const Codes t{tseq + b * ldt};
    const int qlen = s[0], tlen = s[1], h0 = s[2], w = s[3];
    const int sl = slot[b];
    bwamem::KswResult res;
    if (sl < 0) {
      // the last job's lanes are done with qs (ksw_extend_group ends in a
      // __syncwarp), and it publishes these writes before it reads them
      for (int j = lane; j < qlen; j += kGroup) qs[j] = q[j];
      res = bwamem::ksw_extend_group<kGroup>(qs, t, qlen, tlen, h0, w, sprof,
                                             H, E, o_del, e_del, o_ins, e_ins,
                                             zdrop);
    } else if (lane == 0) {
      int32_t* sh = scratch + static_cast<int64_t>(sl) * 2 * (Qs + 1);
      res = bwamem::ksw_extend_core(Codes{q}, t, qlen, tlen, h0, w, smat, sh,
                                    sh + Qs + 1, 1, qlen, o_del, e_del, o_ins,
                                    e_ins, zdrop);
    }
    if (lane == 0) {
      out[0 * B + b] = res.score;
      out[1 * B + b] = res.qle;
      out[2 * B + b] = res.tle;
      out[3 * B + b] = res.gtle;
      out[4 * B + b] = res.gscore;
      out[5 * B + b] = res.max_off;
    }
  }
}

// The kernel's dynamic shared memory a block for queries of up to Qw bases,
// allowed past the default 48 KB (the limit only rises: smem_limit.cuh).
cudaError_t allow_smem(int Qw, size_t* bytes) {
  *bytes = sizeof(int32_t) * kGroups * static_cast<size_t>(slice_words(Qw));
  return bwamem::raise_smem_limit(ksw_extend_kernel, *bytes);
}

}  // namespace

// Launches one wave on `stream`; returns cudaGetLastError() (or the error of
// a refused shared-memory size) so the caller sees a launch that never ran.
// Output rows: score, qle, tle, gtle, gscore, max_off.  `order`, `slot`,
// Qs and Qw come from ops/extend.py `plan_wave`; `next` is zeroed here.
extern "C" int bwamem_ksw_extend_launch(
    const void* qseq, int64_t ldq, const void* tseq, int64_t ldt,
    const void* scal, int64_t lds, const void* mat, const void* order,
    const void* slot, void* next, void* scratch, int Qs, int Qw, void* out,
    int B, int o_del, int e_del, int o_ins, int e_ins, int zdrop,
    void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t smem = 0;
  cudaError_t rc = allow_smem(Qw, &smem);
  if (rc != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(rc);
  }
  // a persistent grid: as many blocks as fit on the card at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ksw_extend_kernel,
                                                kThreads, smem);
  const int64_t need = (static_cast<int64_t>(B) + kGroups - 1) / kGroups;
  const int64_t fit = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  rc = cudaMemsetAsync(next, 0, sizeof(int32_t), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  ksw_extend_kernel<<<static_cast<unsigned>(need < fit ? need : fit), kThreads,
                      smem, st>>>(
      static_cast<const uint8_t*>(qseq), ldq, static_cast<const uint8_t*>(tseq),
      ldt, static_cast<const int32_t*>(scal), lds,
      static_cast<const int32_t*>(mat), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(slot), static_cast<int32_t*>(next),
      static_cast<int32_t*>(scratch), Qs, Qw, static_cast<int32_t*>(out), B,
      o_del, e_del, o_ins, e_ins, zdrop);
  return static_cast<int>(cudaGetLastError());
}

// The longest query the group DP takes on the current card: below 2^12
// (the column bits of the packed row max), with the block's slices of H, E
// and query within what the card allows a block; -1 on error.
extern "C" int bwamem_ksw_extend_max_qlen() {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, ksw_extend_kernel) != cudaSuccess)
    return -1;
  const int64_t words =
      (static_cast<int64_t>(optin) - static_cast<int64_t>(fa.sharedSizeBytes)) /
      static_cast<int64_t>(sizeof(int32_t) * kGroups);
  int Q = kMaxQlen;
  while (Q > 0 && slice_words(Q) > words) --Q;
  return Q;
}

// Warps of the kernel resident on one SM for queries of up to Qw bases (the
// occupancy calculator's figure); -1 when the card refuses that size.
extern "C" int bwamem_ksw_extend_warps_per_sm(int Qw) {
  size_t smem = 0;
  int per_sm = 0;
  if (allow_smem(Qw, &smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ksw_extend_kernel, kThreads, smem) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return per_sm * kWarps;
}
