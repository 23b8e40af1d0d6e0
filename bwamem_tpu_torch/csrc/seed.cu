// Three-round SMEM seeding (bwa mem_collect_intv) for Hopper (sm_90a).
//
// Replaces the JAX device programs bwamem_tpu/ops/smem_tpu.py `smem1a_body`
// (bwa bwt_smem1a, max_intv == 0), ops/seed_tpu.py `strategy1_body` (bwa
// bwt_seed_strategy1) and ops/seed_fused.py `seed_sa_core` with
// `_append_wave` (the three rounds, the per-read M-slot accumulator, the
// stable (qb, qe) sort and bwa's sample_ks expansion).  The SA walks that
// follow are fmindex.cu's sa_lookup kernel.  The device functions `smem1a`
// and `strategy1` follow the host oracle bwamem_tpu/engine/seed.py line for
// line; `smem1a_kernel` and `strategy1_kernel` run one call per lane so
// that each can be held against its plain version and timed on its own.
//
// Design: one thread per read in `collect_intv_kernel`.  A thread keeps real
// stacks in local memory: the forward snapshots and the backward prev/curr
// lists (K entries), the SMEMs of one call (K) and the accumulator (M).
// The TPU workarounds of the JAX programs (the 8/16-slot split under
// lax.cond, the log-step "last candidate" scan, one-hot slot writes and
// compactions, the round-1 lane-compaction ladder, qb<<16|qe packing, the
// R_cap/F_cap caps) are not carried over.  `sample_ks_kernel` runs one
// thread per (read, slot), and writes its row of the flat table and its
// occurrence rows at offsets from exclusive scans the wrapper takes.
//
// What bounds it: latency of dependent line reads.  Every extension step is
// two rank queries (bwt_extend, fmindex.cuh), and the next step's interval
// depends on them; a 150 bp read takes several hundred such steps.  Latency
// is hidden only by the reads in flight, one chain per thread: small blocks
// (32 threads) spread a batch of ~10^4 reads over all SMs.  A warp per read,
// or round-2 jobs split over threads, is later work.
//
// Budgets, with the JAX package's rules: a forward pass that snapshots more
// than K intervals, or a backward pass that emits more than K SMEMs, flags
// the read (K-overflow); so does an append past the M-slot accumulator
// (M-overflow).  A flagged read stops there; the caller seeds it on the
// host.  K and M are run-time arguments, at most kMaxK and kMaxM (the
// stacks' sizes); the JAX package's are K = 24 and M = 48.  With K = kMaxK
// no read of up to kMaxK bases overflows K: a call snapshots at most one
// interval per base forward and emits at most one SMEM per base backward.
// Errors: a rank query outside the index sets bit 1 of *err.

#include <cstdint>
#include <cuda_runtime.h>

#include "fmindex.cuh"

namespace {

using bwamem_fm::Fm;

constexpr int kMaxK = 160;  // K_MAX: snapshots / SMEMs per smem1a call
constexpr int kMaxM = 48;   // M_SLOTS: the accumulator's size
constexpr int kErrRowRange = 1;
constexpr int kSeedThreads = 32;
constexpr int kThreads = 256;

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
__device__ __forceinline__ Intv set_intv(const Fm& fm, int c, int info) {
  return Intv{fm.L2[c] + 1, fm.L2[3 - c] + 1,
              static_cast<int32_t>(fm.L2[c + 1] - fm.L2[c]), info};
}

// bwa bwt_smem1a with max_intv == 0 (engine/seed.py smem1a): the SMEMs
// covering x with interval size >= min_intv, in emission order (descending
// qb) in mems[0 .. *m_cnt).  Returns the next start (the end of the longest
// forward match).  x >= len or an ambiguous base at x yields nothing and
// x + 1.  More than K snapshots or SMEMs (K <= kMaxK) set *ovf and leave
// mems unspecified.  wk counts the bwt_extend calls and the slots needed.
__device__ int smem1a(const Fm& fm, const uint8_t* q, int len, int x,
                      int64_t min_intv, int K, Mem* mems, int* m_cnt,
                      bool* ovf, int* err, Work* wk) {
  *m_cnt = 0;
  if (x >= len || q[x] > 3) return x + 1;
  Intv buf_a[kMaxK], buf_b[kMaxK];
  Intv* curr = buf_a;
  Intv* prev = buf_b;
  int64_t ox0[4], ox1[4];
  int sz[4];
  // forward: snapshot the interval each time its size changes
  Intv ik = set_intv(fm, q[x], x + 1);
  int n = 0, n_snap = 0, ret = x + 1;
  auto snapshot = [&](const Intv& v) {
    ret = v.info;
    if (n_snap++ < K) curr[n++] = v;
  };
  int i = x + 1;
  for (; i < len; ++i) {
    const int c = q[i];
    if (c > 3) {
      snapshot(ik);
      break;
    }
    if (!bwamem_fm::bwt_extend(fm, ik.x0, ik.x1, ik.s, false, ox0, ox1, sz))
      *err |= kErrRowRange;
    ++wk->n_ext;
    const int ci = 3 - c;  // ok[] index for appending base c
    if (sz[ci] != ik.s) {
      snapshot(ik);
      if (sz[ci] < min_intv) break;
    }
    ik = Intv{ox0[ci], ox1[ci], sz[ci], i + 1};
  }
  if (i == len) snapshot(ik);
  wk->peak = max(wk->peak, n_snap);
  if (n_snap > K) {
    *ovf = true;
    return ret;
  }
  // longest match first, like bwt_reverse_intvs
  for (int j = 0; j < n; ++j) prev[j] = curr[n - 1 - j];
  int n_prev = n, m = 0;
  // backward: extend every interval by q[i]; an interval that dies emits
  // an SMEM when no longer one survives and it starts left of the last
  for (i = x - 1; i >= -1; --i) {
    const int c = (i < 0 || q[i] > 3) ? -1 : q[i];
    int n_curr = 0;
    for (int j = 0; j < n_prev; ++j) {
      const Intv p = prev[j];
      bool dead = c < 0;
      if (!dead) {
        if (!bwamem_fm::bwt_extend(fm, p.x0, p.x1, p.s, true, ox0, ox1, sz))
          *err |= kErrRowRange;
        ++wk->n_ext;
        dead = sz[c] < min_intv;
      }
      if (dead) {
        if (n_curr == 0 && (m == 0 || i + 1 < mems[m - 1].qb)) {
          if (m >= K) {
            wk->peak = max(wk->peak, m + 1);
            *ovf = true;
            *m_cnt = m;
            return ret;
          }
          mems[m++] = Mem{p.x0, p.x1, p.s, i + 1, p.info};
        }
      } else if (n_curr == 0 || sz[c] != curr[n_curr - 1].s) {
        curr[n_curr++] = Intv{ox0[c], ox1[c], sz[c], p.info};
      }
    }
    if (n_curr == 0) break;
    Intv* t = prev;
    prev = curr;
    curr = t;
    n_prev = n_curr;
  }
  wk->peak = max(wk->peak, m);
  *m_cnt = m;
  return ret;
}

// bwa bwt_seed_strategy1 (engine/seed.py seed_strategy1): the first forward
// extension from x whose interval drops below max_intv with length >=
// min_len.  Returns whether one was found (into *hit, qb = x); *nxt is the
// next start: i + 1 on a hit or an ambiguous base at i, len at the end.
// wk counts the bwt_extend calls.
__device__ bool strategy1(const Fm& fm, const uint8_t* q, int len, int x,
                          int min_len, int64_t max_intv, Mem* hit, int* nxt,
                          int* err, Work* wk) {
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
    if (!bwamem_fm::bwt_extend(fm, ik.x0, ik.x1, ik.s, false, ox0, ox1, sz))
      *err |= kErrRowRange;
    ++wk->n_ext;
    const int ci = 3 - c;
    if (sz[ci] < max_intv && i - x >= min_len) {
      *hit = Mem{ox0[ci], ox1[ci], sz[ci], x, i + 1};
      *nxt = i + 1;
      return true;
    }
    ik = Intv{ox0[ci], ox1[ci], sz[ci], 0};
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

__global__ void __launch_bounds__(kSeedThreads) smem1a_kernel(
    Fm fm, const uint8_t* __restrict__ qseq, int L,
    const int32_t* __restrict__ qlen, const int32_t* __restrict__ x,
    const int64_t* __restrict__ min_intv, int B, int K,
    int32_t* __restrict__ ret, int64_t* __restrict__ mems,  // [B, K, 5]
    int32_t* __restrict__ m_cnt, int32_t* __restrict__ ovf,
    int32_t* __restrict__ err) {
  const int b = blockIdx.x * kSeedThreads + threadIdx.x;
  if (b >= B) return;
  Mem w[kMaxK];
  int m = 0, e = 0;
  Work wk;
  bool o = false;
  ret[b] = smem1a(fm, qseq + static_cast<int64_t>(b) * L, qlen[b], x[b],
                  min_intv[b], K, w, &m, &o, &e, &wk);
  int64_t* out = mems + static_cast<int64_t>(b) * K * 5;
  for (int j = 0; j < K; ++j)
    put_mem(out + 5 * j, j < m && !o ? w[j] : Mem{0, 0, 0, 0, 0});
  m_cnt[b] = o ? 0 : m;
  ovf[b] = o;
  if (e) atomicOr(err, e);
}

__global__ void __launch_bounds__(kSeedThreads) strategy1_kernel(
    Fm fm, const uint8_t* __restrict__ qseq, int L,
    const int32_t* __restrict__ qlen, const int32_t* __restrict__ x, int B,
    int min_len, int64_t max_intv, int32_t* __restrict__ found,
    int64_t* __restrict__ out,  // [B, 5]
    int32_t* __restrict__ nxt, int32_t* __restrict__ err) {
  const int b = blockIdx.x * kSeedThreads + threadIdx.x;
  if (b >= B) return;
  Mem h{0, 0, 0, x[b], 0};
  int e = 0;
  Work wk;
  found[b] = strategy1(fm, qseq + static_cast<int64_t>(b) * L, qlen[b], x[b],
                       min_len, max_intv, &h, &nxt[b], &e, &wk);
  put_mem(out + 5 * static_cast<int64_t>(b), h);
  if (e) atomicOr(err, e);
}

struct SeedOpts {
  int min_seed_len, split_len, M, K;
  int64_t split_width, max_mem_intv, max_occ;
};

// mem_collect_intv for one read per thread (engine/seed.py collect_intv):
// rows [B, M, 5] (x0, x1, s, qb, qe) sorted by (qb, qe), n [B], ovf [B],
// nks [B] = sum of min(s, max_occ) over the read's rows (0 when flagged).
// When work is not null, work [B, 5] receives the read's smem1a calls,
// strategy1 calls and bwt_extend calls (its dependent line-read pairs), what
// flagged it (0 nothing, 1 the K budget of an smem1a call, 2 the M-slot
// accumulator) and the most K slots one of its smem1a calls needed (a lower
// bound when the K budget flagged it).
__global__ void __launch_bounds__(kSeedThreads) collect_intv_kernel(
    Fm fm, const uint8_t* __restrict__ qseq, int L,
    const int32_t* __restrict__ qlen, int B, SeedOpts opt,
    int64_t* __restrict__ rows, int32_t* __restrict__ n_out,
    int32_t* __restrict__ ovf_out, int64_t* __restrict__ nks_out,
    int32_t* __restrict__ work, int32_t* __restrict__ err) {
  const int b = blockIdx.x * kSeedThreads + threadIdx.x;
  if (b >= B) return;
  const uint8_t* q = qseq + static_cast<int64_t>(b) * L;
  const int len = qlen[b];
  Mem acc[kMaxM], w[kMaxK];
  int n = 0, wc = 0, e = 0, n_smem = 0, n_s1 = 0, cause = 0;
  Work wk;
  bool ovf = false;
  auto append = [&](const Mem& v) {
    if (n < opt.M) {
      acc[n++] = v;
    } else {
      ovf = true;
      cause = 2;
    }
  };
  // an smem1a call's SMEMs in ascending qb, those of min_seed_len or longer
  auto append_wave = [&]() {
    for (int k = wc - 1; k >= 0; --k)
      if (w[k].qe - w[k].qb >= opt.min_seed_len) append(w[k]);
  };
  // round 1: all SMEMs, one call per start
  for (int x = 0; x < len && !ovf;) {
    const int ret = smem1a(fm, q, len, x, 1, opt.K, w, &wc, &ovf, &e, &wk);
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
    const Mem p = acc[j];
    if (p.qe - p.qb < opt.split_len || p.s > opt.split_width) continue;
    smem1a(fm, q, len, (p.qb + p.qe) >> 1, static_cast<int64_t>(p.s) + 1,
           opt.K, w, &wc, &ovf, &e, &wk);
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
      if (strategy1(fm, q, len, x, opt.min_seed_len, opt.max_mem_intv, &h,
                    &nxt, &e, &wk) &&
          h.s > 0)
        append(h);
      ++n_s1;
      x = nxt;
    }
  }
  // stable insertion sort by (qb, qe), as the oracle's list.sort
  for (int a = 1; a < n; ++a) {
    const Mem v = acc[a];
    int k = a - 1;
    while (k >= 0 && (acc[k].qb > v.qb || (acc[k].qb == v.qb && acc[k].qe > v.qe))) {
      acc[k + 1] = acc[k];
      --k;
    }
    acc[k + 1] = v;
  }
  int64_t* out = rows + static_cast<int64_t>(b) * opt.M * 5;
  int64_t nks = 0;
  for (int j = 0; j < opt.M; ++j) {
    put_mem(out + 5 * j, j < n ? acc[j] : Mem{0, 0, 0, 0, 0});
    if (j < n) nks += occ_rows(acc[j].s, opt.max_occ);
  }
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

// bwa sample_ks for each (read, slot) row kept: the row into the flat table
// at row_off[b] + j, and its min(s, max_occ) rows x0 + step * t into ks,
// after those of the read's earlier rows.
__global__ void __launch_bounds__(kThreads) sample_ks_kernel(
    const int64_t* __restrict__ rows, int M, const int32_t* __restrict__ nrows,
    const int64_t* __restrict__ row_off, const int64_t* __restrict__ ks_off,
    int B, int64_t max_occ, int64_t* __restrict__ flat,
    int64_t* __restrict__ ks) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(B) * M) return;
  const int64_t b = t / M;
  const int j = static_cast<int>(t % M);
  if (j >= nrows[b]) return;
  const int64_t* read = rows + b * M * 5;
  const int64_t* r = read + 5 * j;
  int64_t* f = flat + (row_off[b] + j) * 5;
  for (int c = 0; c < 5; ++c) f[c] = r[c];
  int64_t off = ks_off[b];
  for (int k = 0; k < j; ++k) off += occ_rows(read[5 * k + 2], max_occ);
  const int64_t s = r[2];
  const int64_t cnt = occ_rows(s, max_occ);
  const int64_t step = (s > max_occ && max_occ > 0) ? s / max_occ : 1;
  for (int64_t k = 0; k < cnt; ++k) ks[off + k] = r[0] + step * k;
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
  return static_cast<unsigned>((B + kSeedThreads - 1) / kSeedThreads);
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
  smem1a_kernel<<<seed_blocks(B), kSeedThreads, 0, stream>>>(
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
  collect_intv_kernel<<<seed_blocks(B), kSeedThreads, 0, stream>>>(
      make_fm(lines, W, lg, L2, primary, seq_len), qseq, L, qlen, B, opt,
      rows, n, ovf, nks, work, err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bwamem_seed_sample_ks_launch(
    const int64_t* rows, int M, const int32_t* nrows, const int64_t* row_off,
    const int64_t* ks_off, int B, int64_t max_occ, int64_t* flat, int64_t* ks,
    cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(B) * M;
  sample_ks_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                     kThreads, 0, stream>>>(rows, M, nrows, row_off, ks_off,
                                            B, max_occ, flat, ks);
  return static_cast<int>(cudaGetLastError());
}
