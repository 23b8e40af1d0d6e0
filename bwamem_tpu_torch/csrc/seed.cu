// Three-round SMEM seeding (bwa mem_collect_intv) for Hopper (sm_90a).
//
// Replaces the JAX device programs bwamem_tpu/ops/smem_tpu.py `smem1a_body`
// (bwa bwt_smem1a, max_intv == 0), ops/seed_tpu.py `strategy1_body` (bwa
// bwt_seed_strategy1) and ops/seed_fused.py `seed_sa_core` with
// `_append_wave` (the three rounds, the per-read M-slot accumulator, the
// stable (qb, qe) sort and bwa's sample_ks expansion).  The SA walks that
// follow are fmindex.cu's sa_lookup kernel.  The device functions
// `smem1a_warp` and `strategy1_warp` compute what the host oracle
// bwamem_tpu/engine/seed.py `smem1a` and `seed_strategy1` compute, step for
// step, on the lanes of a warp.
//
// Design: one warp per read in `collect_intv_kernel`, the read's stacks in
// the warp's slice of shared memory: the forward snapshots and the backward
// prev/curr lists (K entries each), the SMEMs of one call (K) and the
// accumulator (M).  The serial steps (the forward passes of smem1a and
// strategy1, and the order of the calls) run on all lanes alike, each
// rank query through fmindex.cuh's warp-cooperative `bwt_extend_warp` (both
// lines of a query fetched in one round of loads, a word a lane).  A
// backward step extends every interval of prev by the same base, a lane an
// interval (the scalar `bwt_extend`), and rebuilds the list in list order
// with ballots: a survivor is kept when its size differs from the previous
// survivor's (a dropped survivor has the size of the last kept one), and
// the step emits at most one SMEM, prev[0], when it dies before any
// survivor.  Appends are a ballot and a popcount; the final stable (qb, qe)
// sort is a rank sort, a row a lane.  The TPU workarounds of the JAX
// programs (the 8/16-slot split under lax.cond, the log-step "last
// candidate" scan, one-hot slot writes and compactions, the round-1
// lane-compaction ladder, qb<<16|qe packing, the R_cap/F_cap caps) are not
// carried over.  `smem1a_kernel` and `strategy1_kernel` run one call per
// warp, with the same device functions, so that each can be held against
// its plain version and timed on its own.  `sample_ks_kernel` runs one warp
// per read: the read's rows go to the flat table as one contiguous copy,
// each row's place among the read's occurrence rows is a warp scan of the
// counts, and the read's occurrence rows are written as one contiguous run,
// a word a lane, each lane finding its row by a search over the scan; the
// reads' offsets are exclusive scans the wrapper takes.  It is bound by the
// bytes it writes.
//
// What bounds it: latency.  Every forward step is one rank query, and the
// next step's interval depends on it; a 150 bp read takes a few hundred
// such steps.  A step costs one memory latency and four warp reductions;
// a backward step of n intervals costs one lane's scalar query.  Latency
// is hidden by the warps in flight, which shared memory bounds (about
// 14 KB a warp at K = 160).
//
// Budgets, with the JAX package's rules: a forward pass that snapshots more
// than K intervals, or a backward pass that emits more than K SMEMs, flags
// the read (K-overflow); so does an append past the M-slot accumulator
// (M-overflow).  A flagged read stops there; the caller seeds it on the
// host.  K and M are run-time arguments, at most kMaxK and kMaxM; the
// warp's stacks are sized from them at launch (about 14 KB at K = 160,
// M = 48).  The JAX package's are K = 24 and M = 48.  With K = kMaxK
// no read of up to kMaxK bases overflows K: a call snapshots at most one
// interval per base forward and emits at most one SMEM per base backward.
// Errors: a rank query outside the index sets bit 1 of *err.
//
// The idx-sharded tables (D12): the device functions and
// `collect_intv_kernel` are templates of the index form (fmindex.cuh `Fm`
// or `FmShards`); `bwamem_seed_collect_intv_sharded_launch` runs the three
// rounds with every line fetch taken from the shard that owns it.

#include <cstdint>
#include <cuda_runtime.h>

#include "fmindex.cuh"
#include "smem_limit.cuh"

namespace {

using bwamem_fm::Fm;
using bwamem_fm::FmShards;

constexpr int kMaxK = 160;  // K_MAX: snapshots / SMEMs per smem1a call
constexpr int kMaxM = 48;   // M_SLOTS: the accumulator's size
constexpr int kErrRowRange = 1;
constexpr int kSeedWarps = 4;  // a read (or lane) a warp
constexpr int kSeedThreads = 32 * kSeedWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSampleWarps = 8;
constexpr int kSampleThreads = 32 * kSampleWarps;

struct Intv {  // bwtintv_t: bi-interval and info (the query end)
  int64_t x0, x1;
  int32_t s, info;
};

struct Mem {  // SmemIntv
  int64_t x0, x1;
  int32_t s, qb, qe;
};

struct Work {     // what a read's seeding cost
  int n_ext = 0;  // bwt_extend calls
  int peak = 0;   // the most K slots one smem1a call needed
};

// bwa bwt_set_intv: the bi-interval of one symbol.
template <class F>
__device__ __forceinline__ Intv set_intv(const F& fm, int c, int info) {
  return Intv{fm.L2[c] + 1, fm.L2[3 - c] + 1,
              static_cast<int32_t>(fm.L2[c + 1] - fm.L2[c]), info};
}

// One of four values by a run-time index, as selects (an array indexed at
// run time would go to local memory).
template <class T>
__device__ __forceinline__ T at4(const T a[4], int c) {
  return c == 0 ? a[0] : c == 1 ? a[1] : c == 2 ? a[2] : a[3];
}

// bwa bwt_smem1a with max_intv == 0 (engine/seed.py smem1a) on the 32 lanes
// of a warp, all calling it with the same arguments: the SMEMs covering x
// with interval size >= min_intv, in emission order (descending qb) in
// mems[0 .. *m_cnt).  Returns the next start (the end of the longest
// forward match).  x >= len or an ambiguous base at x yields nothing and
// x + 1.  More than K snapshots or SMEMs (K <= kMaxK) set *ovf and leave
// mems unspecified.  wk counts the bwt_extend calls (the intervals extended,
// whichever lane extended them, as the scalar walk counts them) and the
// slots needed.  buf_a, buf_b [K] and mems [K] are the warp's shared
// memory; every value returned is warp-uniform.
template <class F>
__device__ int smem1a_warp(const F& fm, const uint8_t* q, int len, int x,
                           int64_t min_intv, int K, Intv* buf_a, Intv* buf_b,
                           Mem* mems, int* m_cnt, bool* ovf, int* err,
                           Work* wk) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // the lanes under this one
  __syncwarp();  // the last call's readers are done with the stacks
  *m_cnt = 0;
  if (x >= len || q[x] > 3) return x + 1;
  Intv* curr = buf_a;
  Intv* prev = buf_b;
  int64_t ox0[4], ox1[4];
  int sz[4];
  // forward: snapshot the interval each time its size changes
  Intv ik = set_intv(fm, q[x], x + 1);
  int n = 0, n_snap = 0, ret = x + 1;
  auto snapshot = [&](const Intv& v) {
    ret = v.info;
    if (n_snap++ < K) {
      if (lane == 0) curr[n] = v;
      ++n;
    }
  };
  int i = x + 1;
  for (; i < len; ++i) {
    const int c = q[i];
    if (c > 3) {
      snapshot(ik);
      break;
    }
    if (!bwamem_fm::bwt_extend_warp(fm, ik.x0, ik.x1, ik.s, false, ox0, ox1,
                                    sz))
      *err |= kErrRowRange;
    ++wk->n_ext;
    const int ci = 3 - c;  // ok[] index for appending base c
    const int s_ci = at4(sz, ci);
    if (s_ci != ik.s) {
      snapshot(ik);
      if (s_ci < min_intv) break;
    }
    ik = Intv{at4(ox0, ci), at4(ox1, ci), s_ci, i + 1};
  }
  if (i == len) snapshot(ik);
  wk->peak = max(wk->peak, n_snap);
  if (n_snap > K) {
    *ovf = true;
    return ret;
  }
  // longest match first, like bwt_reverse_intvs
  __syncwarp();
  for (int j = lane; j < n; j += 32) prev[j] = curr[n - 1 - j];
  __syncwarp();
  int n_prev = n, m = 0;
  // backward: extend every interval by q[i], an interval a lane; an interval
  // that dies emits an SMEM when no survivor precedes it and it starts left
  // of the last one (so only prev[0] can), a survivor is kept when its size
  // differs from the previous survivor's
  for (i = x - 1; i >= -1; --i) {
    const int c = (i < 0 || q[i] > 3) ? -1 : q[i];
    const bool gate = m == 0 || i + 1 < mems[m - 1].qb;
    int n_curr = 0, last_s = 0;
    bool seen = false;  // a survivor in an earlier round of 32
    for (int j0 = 0; j0 < n_prev; j0 += 32) {
      const int j = j0 + lane;
      const bool valid = j < n_prev;
      Intv p{0, 0, 0, 0};
      if (valid) p = prev[j];
      bool dead = true, bad = false;
      int64_t nx0 = 0, nx1 = 0;
      int ns = 0;
      if (valid && c >= 0) {
        bad = !bwamem_fm::bwt_extend(fm, p.x0, p.x1, p.s, true, ox0, ox1, sz);
        nx0 = at4(ox0, c);
        nx1 = at4(ox1, c);
        ns = at4(sz, c);
        dead = ns < min_intv;
      }
      if (j0 == 0 && __shfl_sync(kFull, dead, 0) && gate) {
        if (m >= K) {
          // the scalar walk stops at prev[0]: one interval extended
          if (c >= 0) {
            ++wk->n_ext;
            if (__shfl_sync(kFull, bad, 0)) *err |= kErrRowRange;
          }
          wk->peak = max(wk->peak, m + 1);
          *ovf = true;
          *m_cnt = m;
          return ret;
        }
        if (lane == 0) mems[m] = Mem{p.x0, p.x1, p.s, i + 1, p.info};
        ++m;
      }
      if (c >= 0) {
        wk->n_ext += min(32, n_prev - j0);
        if (__any_sync(kFull, bad)) *err |= kErrRowRange;
      }
      const bool surv = valid && !dead;
      const unsigned sm = __ballot_sync(kFull, surv);
      const unsigned lower = sm & below;
      const int ps = __shfl_sync(kFull, ns, lower ? 31 - __clz(lower) : 0);
      const bool keep =
          surv && (lower ? ns != ps : (!seen || ns != last_s));
      const unsigned km = __ballot_sync(kFull, keep);
      if (keep) curr[n_curr + __popc(km & below)] = Intv{nx0, nx1, ns, p.info};
      n_curr += __popc(km);
      const int top = __shfl_sync(kFull, ns, sm ? 31 - __clz(sm) : 0);
      if (sm) {
        seen = true;
        last_s = top;
      }
    }
    if (n_curr == 0) break;
    __syncwarp();
    Intv* t = prev;
    prev = curr;
    curr = t;
    n_prev = n_curr;
  }
  wk->peak = max(wk->peak, m);
  *m_cnt = m;
  return ret;
}

// bwa bwt_seed_strategy1 (engine/seed.py seed_strategy1) on the lanes of a
// warp: the first forward extension from x whose interval drops below
// max_intv with length >= min_len.  Returns whether one was found (into
// *hit, qb = x); *nxt is the next start: i + 1 on a hit or an ambiguous
// base at i, len at the end.  wk counts the bwt_extend calls.
template <class F>
__device__ bool strategy1_warp(const F& fm, const uint8_t* q, int len, int x,
                               int min_len, int64_t max_intv, Mem* hit,
                               int* nxt, int* err, Work* wk) {
  *nxt = x + 1;
  if (x >= len || q[x] > 3) return false;
  Intv ik = set_intv(fm, q[x], 0);
  int64_t ox0[4], ox1[4];
  int sz[4];
  for (int i = x + 1; i < len; ++i) {
    const int c = q[i];
    if (c > 3) {
      *nxt = i + 1;
      return false;
    }
    if (!bwamem_fm::bwt_extend_warp(fm, ik.x0, ik.x1, ik.s, false, ox0, ox1,
                                    sz))
      *err |= kErrRowRange;
    ++wk->n_ext;
    const int ci = 3 - c;
    const int s_ci = at4(sz, ci);
    if (s_ci < max_intv && i - x >= min_len) {
      *hit = Mem{at4(ox0, ci), at4(ox1, ci), s_ci, x, i + 1};
      *nxt = i + 1;
      return true;
    }
    ik = Intv{at4(ox0, ci), at4(ox1, ci), s_ci, 0};
  }
  *nxt = len;
  return false;
}

// The rows bwa sample_ks takes from an interval of size s: min(s, max_occ).
__device__ __forceinline__ int64_t occ_rows(int64_t s, int64_t max_occ) {
  return s < max_occ ? s : max_occ;
}

__device__ __forceinline__ void put_mem(int64_t* out, const Mem& v) {
  out[0] = v.x0;
  out[1] = v.x1;
  out[2] = v.s;
  out[3] = v.qb;
  out[4] = v.qe;
}

// A warp's slice of dynamic shared memory: two interval lists and the SMEMs
// of a call (K entries each), then the M-slot accumulator.
struct Stacks {
  Intv* a;
  Intv* b;
  Mem* mems;
  Mem* acc;
};

__host__ __device__ __forceinline__ size_t warp_bytes(int K, int M) {
  return static_cast<size_t>(K) * (2 * sizeof(Intv) + sizeof(Mem)) +
         static_cast<size_t>(M) * sizeof(Mem);
}

__device__ __forceinline__ Stacks warp_stacks(unsigned char* smem, int K,
                                              int M) {
  unsigned char* p = smem + (threadIdx.x >> 5) * warp_bytes(K, M);
  Stacks st;
  st.a = reinterpret_cast<Intv*>(p);
  st.b = st.a + K;
  st.mems = reinterpret_cast<Mem*>(st.b + K);
  st.acc = st.mems + K;
  return st;
}

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// The read (or lane) of this warp; B when the block runs past the batch.
__device__ __forceinline__ int warp_item(int B) {
  const int b = blockIdx.x * kSeedWarps + (threadIdx.x >> 5);
  return b < B ? b : B;
}

__global__ void __launch_bounds__(kSeedThreads) smem1a_kernel(
    Fm fm, const uint8_t* __restrict__ qseq, int L,
    const int32_t* __restrict__ qlen, const int32_t* __restrict__ x,
    const int64_t* __restrict__ min_intv, int B, int K,
    int32_t* __restrict__ ret, int64_t* __restrict__ mems,  // [B, K, 5]
    int32_t* __restrict__ m_cnt, int32_t* __restrict__ ovf,
    int32_t* __restrict__ err) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = warp_item(B);
  if (b == B) return;
  const int lane = threadIdx.x & 31;
  const Stacks st = warp_stacks(smem, K, 0);
  int m = 0, e = 0;
  Work wk;
  bool o = false;
  const int r = smem1a_warp(fm, qseq + static_cast<int64_t>(b) * L, qlen[b],
                            x[b], min_intv[b], K, st.a, st.b, st.mems, &m, &o,
                            &e, &wk);
  __syncwarp();
  int64_t* out = mems + static_cast<int64_t>(b) * K * 5;
  for (int j = lane; j < K; j += 32)
    put_mem(out + 5 * j, j < m && !o ? st.mems[j] : Mem{0, 0, 0, 0, 0});
  if (lane == 0) {
    ret[b] = r;
    m_cnt[b] = o ? 0 : m;
    ovf[b] = o;
    if (e) atomicOr(err, e);
  }
}

__global__ void __launch_bounds__(kSeedThreads) strategy1_kernel(
    Fm fm, const uint8_t* __restrict__ qseq, int L,
    const int32_t* __restrict__ qlen, const int32_t* __restrict__ x, int B,
    int min_len, int64_t max_intv, int32_t* __restrict__ found,
    int64_t* __restrict__ out,  // [B, 5]
    int32_t* __restrict__ nxt, int32_t* __restrict__ err) {
  const int b = warp_item(B);
  if (b == B) return;
  Mem h{0, 0, 0, x[b], 0};
  int e = 0, n = 0;
  Work wk;
  const bool f = strategy1_warp(fm, qseq + static_cast<int64_t>(b) * L,
                                qlen[b], x[b], min_len, max_intv, &h, &n, &e,
                                &wk);
  if ((threadIdx.x & 31) == 0) {
    found[b] = f;
    nxt[b] = n;
    put_mem(out + 5 * static_cast<int64_t>(b), h);
    if (e) atomicOr(err, e);
  }
}

struct SeedOpts {
  int min_seed_len, split_len, M, K;
  int64_t split_width, max_mem_intv, max_occ;
};

// mem_collect_intv for one read per warp (engine/seed.py collect_intv):
// rows [B, M, 5] (x0, x1, s, qb, qe) sorted by (qb, qe), n [B], ovf [B],
// nks [B] = sum of min(s, max_occ) over the read's rows (0 when flagged).
// When work is not null, work [B, 5] receives the read's smem1a calls,
// strategy1 calls and bwt_extend calls (the intervals it extended), what
// flagged it (0 nothing, 1 the K budget of an smem1a call, 2 the M-slot
// accumulator) and the most K slots one of its smem1a calls needed (a lower
// bound when the K budget flagged it).
template <class F>
__global__ void __launch_bounds__(kSeedThreads) collect_intv_kernel(
    F fm, const uint8_t* __restrict__ qseq, int L,
    const int32_t* __restrict__ qlen, int B, SeedOpts opt,
    int64_t* __restrict__ rows, int32_t* __restrict__ n_out,
    int32_t* __restrict__ ovf_out, int64_t* __restrict__ nks_out,
    int32_t* __restrict__ work, int32_t* __restrict__ err) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = warp_item(B);
  if (b == B) return;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const Stacks st = warp_stacks(smem, opt.K, opt.M);
  Mem* acc = st.acc;
  Mem* w = st.mems;
  const uint8_t* q = qseq + static_cast<int64_t>(b) * L;
  const int len = qlen[b];
  int n = 0, wc = 0, e = 0, n_smem = 0, n_s1 = 0, cause = 0;
  Work wk;
  bool ovf = false;
  auto append = [&](const Mem& v) {
    if (n < opt.M) {
      if (lane == 0) acc[n] = v;
      ++n;
    } else {
      ovf = true;
      cause = 2;
    }
  };
  // an smem1a call's SMEMs in ascending qb, those of min_seed_len or
  // longer: an SMEM a lane, its slot by a ballot
  auto append_wave = [&]() {
    __syncwarp();
    for (int k0 = 0; k0 < wc; k0 += 32) {
      const int k = wc - 1 - (k0 + lane);
      const bool keep = k >= 0 && w[k].qe - w[k].qb >= opt.min_seed_len;
      const unsigned km = __ballot_sync(kFull, keep);
      const int at = n + __popc(km & below);
      if (keep && at < opt.M) acc[at] = w[k];
      n += __popc(km);
      if (n > opt.M) {
        n = opt.M;
        ovf = true;
        cause = 2;
      }
    }
  };
  // round 1: all SMEMs, one call per start
  for (int x = 0; x < len && !ovf;) {
    const int ret = smem1a_warp(fm, q, len, x, 1, opt.K, st.a, st.b, w, &wc,
                                &ovf, &e, &wk);
    ++n_smem;
    if (ovf)
      cause = 1;
    else
      append_wave();
    x = ret;
  }
  // round 2: re-seed round 1's long, low-occurrence SMEMs from the middle
  const int n1 = n;
  for (int j = 0; j < n1 && !ovf; ++j) {
    __syncwarp();
    const Mem p = acc[j];
    if (p.qe - p.qb < opt.split_len || p.s > opt.split_width) continue;
    smem1a_warp(fm, q, len, (p.qb + p.qe) >> 1, static_cast<int64_t>(p.s) + 1,
                opt.K, st.a, st.b, w, &wc, &ovf, &e, &wk);
    ++n_smem;
    if (ovf)
      cause = 1;
    else
      append_wave();
  }
  // round 3: LAST-like strategy-1 seeds
  if (opt.max_mem_intv > 0) {
    for (int x = 0; x < len && !ovf;) {
      Mem h;
      int nxt;
      if (strategy1_warp(fm, q, len, x, opt.min_seed_len, opt.max_mem_intv,
                         &h, &nxt, &e, &wk) &&
          h.s > 0)
        append(h);
      ++n_s1;
      x = nxt;
    }
  }
  // stable sort by (qb, qe), as the oracle's list.sort: a row a lane, its
  // rank the rows of a smaller key and those of an equal key before it
  __syncwarp();
  int64_t* out = rows + static_cast<int64_t>(b) * opt.M * 5;
  int64_t nks = 0;
  for (int a = lane; a < opt.M; a += 32) {
    if (a < n) {
      const Mem v = acc[a];
      int rank = 0;
      for (int c = 0; c < n; ++c) {
        const int qb = acc[c].qb, qe = acc[c].qe;
        rank += qb < v.qb || (qb == v.qb && (qe < v.qe || (qe == v.qe && c < a)));
      }
      put_mem(out + 5 * rank, v);
      nks += occ_rows(v.s, opt.max_occ);
    } else {
      put_mem(out + 5 * a, Mem{0, 0, 0, 0, 0});
    }
  }
  nks = warp_sum(nks);
  if (lane == 0) {
    n_out[b] = n;
    ovf_out[b] = ovf;
    nks_out[b] = ovf ? 0 : nks;
    if (work) {
      int32_t* wr = work + 5 * static_cast<int64_t>(b);
      wr[0] = n_smem;
      wr[1] = n_s1;
      wr[2] = wk.n_ext;
      wr[3] = cause;
      wr[4] = wk.peak;
    }
    if (e) atomicOr(err, e);
  }
}

// bwa sample_ks, a read a warp: the read's nrows[b] rows to the flat table
// at row_off[b] (one contiguous run of 5 nrows words, a word a lane; the
// first 64 words and the first round's sizes and starts are loaded before
// the row count arrives, so a read waits on one round trip to memory, not
// two), then each row's min(s, max_occ) rows x0 + step * t into ks, after
// those of the read's earlier rows.  Lanes take rows j = lane, lane + 32,
// ...; an inclusive warp scan of their counts gives each row's place among
// the round's SA rows, and the round's SA rows, one contiguous run from the
// read's offset (ks_off[b], advanced by each round's total), are written a
// word a lane: a lane takes SA row i = lane, lane + 32, ... of the run,
// finds its row as the first lane whose inclusive count exceeds i (a
// 5-step search by shuffles) and takes that row's x0, step and first place
// from it.  Consecutive lanes store consecutive words.
__global__ void __launch_bounds__(kSampleThreads) sample_ks_kernel(
    const int64_t* __restrict__ rows, int M, const int32_t* __restrict__ nrows,
    const int64_t* __restrict__ row_off, const int64_t* __restrict__ ks_off,
    int B, int64_t max_occ, int64_t* __restrict__ flat,
    int64_t* __restrict__ ks) {
  const int lane = threadIdx.x & 31;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kSampleWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int64_t* read = rows + b * M * 5;
  // the loads that need no row count go first, with nrows[b]: the read's
  // first 64 words and row lane's size and start
  const int words = 5 * M;
  const int64_t w0 = lane < words ? read[lane] : 0;
  const int64_t w1 = lane + 32 < words ? read[lane + 32] : 0;
  const int64_t s_l = lane < M ? read[5 * lane + 2] : 0;
  const int64_t x_l = lane < M ? read[5 * lane] : 0;
  const int n = nrows[b];
  int64_t* f = flat + row_off[b] * 5;
  if (lane < 5 * n) f[lane] = w0;
  if (lane + 32 < 5 * n) f[lane + 32] = w1;
  for (int k = lane + 64; k < 5 * n; k += 32) f[k] = read[k];
  int64_t* out = ks + ks_off[b];
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    int64_t x0 = 0, cnt = 0, step = 1;
    if (j < n) {
      const int64_t s = j0 == 0 ? s_l : read[5 * j + 2];
      x0 = j0 == 0 ? x_l : read[5 * j];
      cnt = occ_rows(s, max_occ);
      if (s > max_occ && max_occ > 0) step = s / max_occ;
    }
    int64_t incl = cnt;  // inclusive scan of the round's counts
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int64_t excl = incl - cnt;
    const int64_t total = __shfl_sync(kFull, incl, 31);
    for (int64_t i0 = 0; i0 < total; i0 += 32) {
      const int64_t i = i0 + lane;
      int r = 0;  // the lanes whose inclusive count is <= i
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

unsigned seed_blocks(int B) {
  return static_cast<unsigned>((B + kSeedWarps - 1) / kSeedWarps);
}

// Lets a kernel take `bytes` of dynamic shared memory a block, past the
// default 48 KB (the limit only rises: smem_limit.cuh), with the SM's
// carveout at its shared-memory maximum.
template <class Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  const cudaError_t rc = bwamem::raise_smem_limit(k, bytes);
  if (rc != cudaSuccess) return rc;
  return cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Launchers: device pointers and a stream in, cudaGetLastError() out.  The
// index is passed as fmindex.cu's launchers take it; qseq is [B, L] uint8
// codes (4 = ambiguous, and padding past each read's qlen).  The smem1a and
// collect_intv launchers return cudaErrorInvalidValue without launching when
// K is not in [1, kMaxK] or M not in [1, kMaxM].

extern "C" int bwamem_seed_smem1a_launch(
    const uint32_t* lines, int W, int lg, const int64_t* L2, int64_t primary,
    int64_t seq_len, const uint8_t* qseq, int L, const int32_t* qlen,
    const int32_t* x, const int64_t* min_intv, int B, int K, int32_t* ret,
    int64_t* mems, int32_t* m_cnt, int32_t* ovf, int32_t* err,
    cudaStream_t stream) {
  if (K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kSeedWarps * warp_bytes(K, 0);
  const cudaError_t rc = allow_smem(smem1a_kernel, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  smem1a_kernel<<<seed_blocks(B), kSeedThreads, smem, stream>>>(
      make_fm(lines, W, lg, L2, primary, seq_len), qseq, L, qlen, x, min_intv,
      B, K, ret, mems, m_cnt, ovf, err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bwamem_seed_strategy1_launch(
    const uint32_t* lines, int W, int lg, const int64_t* L2, int64_t primary,
    int64_t seq_len, const uint8_t* qseq, int L, const int32_t* qlen,
    const int32_t* x, int B, int min_len, int64_t max_intv, int32_t* found,
    int64_t* out, int32_t* nxt, int32_t* err, cudaStream_t stream) {
  strategy1_kernel<<<seed_blocks(B), kSeedThreads, 0, stream>>>(
      make_fm(lines, W, lg, L2, primary, seq_len), qseq, L, qlen, x, B,
      min_len, max_intv, found, out, nxt, err);
  return static_cast<int>(cudaGetLastError());
}

// work may be null (no per-read work counts).
extern "C" int bwamem_seed_collect_intv_launch(
    const uint32_t* lines, int W, int lg, const int64_t* L2, int64_t primary,
    int64_t seq_len, const uint8_t* qseq, int L, const int32_t* qlen, int B,
    int min_seed_len, int split_len, int64_t split_width,
    int64_t max_mem_intv, int64_t max_occ, int M, int K, int64_t* rows,
    int32_t* n, int32_t* ovf, int64_t* nks, int32_t* work, int32_t* err,
    cudaStream_t stream) {
  if (M < 1 || M > kMaxM || K < 1 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const SeedOpts opt{min_seed_len, split_len, M, K, split_width, max_mem_intv,
                     max_occ};
  const size_t smem = kSeedWarps * warp_bytes(K, M);
  const cudaError_t rc = allow_smem(collect_intv_kernel<Fm>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  collect_intv_kernel<Fm><<<seed_blocks(B), kSeedThreads, smem, stream>>>(
      make_fm(lines, W, lg, L2, primary, seq_len), qseq, L, qlen, B, opt,
      rows, n, ovf, nks, work, err);
  return static_cast<int>(cudaGetLastError());
}

// Warps of collect_intv_kernel resident on one SM with budgets K and M (the
// occupancy calculator's figure).
extern "C" int bwamem_seed_collect_intv_warps_per_sm(int K, int M) {
  const size_t smem = kSeedWarps * warp_bytes(K, M);
  int per_sm = 0;
  if (allow_smem(collect_intv_kernel<Fm>, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, collect_intv_kernel<Fm>, kSeedThreads, smem) != cudaSuccess)
    return -1;
  return per_sm * kSeedWarps;
}

extern "C" int bwamem_seed_sample_ks_launch(
    const int64_t* rows, int M, const int32_t* nrows, const int64_t* row_off,
    const int64_t* ks_off, int B, int64_t max_occ, int64_t* flat, int64_t* ks,
    cudaStream_t stream) {
  if (B <= 0) return 0;
  sample_ks_kernel<<<static_cast<unsigned>((B + kSampleWarps - 1) /
                                           kSampleWarps),
                     kSampleThreads, 0, stream>>>(rows, M, nrows, row_off,
                                                  ks_off, B, max_occ, flat, ks);
  return static_cast<int>(cudaGetLastError());
}

// collect_intv on the idx-sharded tables: line_ptrs is a host array of
// n_shards device pointers, shard s holding lines [s * bps, (s + 1) * bps);
// the rest as bwamem_seed_collect_intv_launch.
extern "C" int bwamem_seed_collect_intv_sharded_launch(
    const uint64_t* line_ptrs, int n_shards, int64_t bps, int W, int lg,
    const int64_t* L2, int64_t primary, int64_t seq_len, const uint8_t* qseq,
    int L, const int32_t* qlen, int B, int min_seed_len, int split_len,
    int64_t split_width, int64_t max_mem_intv, int64_t max_occ, int M, int K,
    int64_t* rows, int32_t* n, int32_t* ovf, int64_t* nks, int32_t* work,
    int32_t* err, cudaStream_t stream) {
  FmShards fm;
  if (M < 1 || M > kMaxM || K < 1 || K > kMaxK ||
      !bwamem_fm::make_fm_shards(line_ptrs, nullptr, n_shards, bps, 0, W, lg,
                                 L2, primary, seq_len, &fm))
    return static_cast<int>(cudaErrorInvalidValue);
  const SeedOpts opt{min_seed_len, split_len, M, K, split_width, max_mem_intv,
                     max_occ};
  const size_t smem = kSeedWarps * warp_bytes(K, M);
  const cudaError_t rc = allow_smem(collect_intv_kernel<FmShards>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  collect_intv_kernel<FmShards>
      <<<seed_blocks(B), kSeedThreads, smem, stream>>>(
          fm, qseq, L, qlen, B, opt, rows, n, ovf, nks, work, err);
  return static_cast<int>(cudaGetLastError());
}
