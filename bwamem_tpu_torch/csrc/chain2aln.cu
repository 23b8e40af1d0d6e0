// Chains to alignment regions (bwa mem_chain2aln) for Hopper (sm_90a).
//
// Replaces the last stage of the JAX device program
// bwamem_tpu/ops/pipeline_fused.py `pipeline_fused_body` (with `_win_codes`,
// `_max_gap`, `_ext_retry`, `prune_current` and `outer_body`): per chain the
// extension window, per read the mem_chain2aln loop.  The program's earlier
// stages are seed.cu, fmindex.cu and chain.cu; this file starts from
// chain.cu's output (chain_rows [Nc, 7], seed_rows [Ns, 4]) where it lies on
// the card.  Its semantics are the host oracle's, engine/extend.py
// `chain2aln`:
//
// * per chain, [rmax0, rmax1]: min/max over its seeds of the span a gapped
//   extension could reach (cal_max_gap), clamped to [0, 2 l_pac], cut at the
//   strand boundary on the side of the chain's first seed, then clamped to
//   that seed's contig (bns_fetch_seq);
// * per chain, its seeds in ascending (score, index) order, walked from the
//   end down;
// * per seed: skip it when it lies inside a region the read already has,
//   close to that region's diagonal, unless a live later seed of the chain
//   argues for another alignment; else extend left (reversed prefix,
//   h0 = len * a, pen_clip5) and right (pen_clip3, h0 = the left score), each
//   at band w and again at 2w when the score moved and max_off reached 3/4 of
//   the band; choose local or to-the-end by gscore; seedcov over the chain's
//   seeds; write the region.
//
// Design: `chain2aln_prep_kernel`, one warp per chain (a lane a seed: the
// spans in parallel and a warp min/max, the stable seed order as a rank
// sort over the chain's scores staged in shared memory, so no lane waits on
// a chain of dependent global loads).  Most chains have 1-5 seeds, so a
// warp's time is its few dependent loads, and the batch is ~18,500 such
// warps in rounds of what the card holds at once: registers are capped at
// 64 a thread (__launch_bounds__ with 4 blocks an SM) so that 32 warps
// fit an SM.  Then
// `chain2aln_kernel`, one warp per read, or per chain of a heavy read (below),
// a sequential state machine as the oracle writes it, so regions of a
// read's earlier chains prune seeds of its later ones.  The JAX program's barrel shifts, 128-base pac-row gathers,
// one-hot region writes and lane-compaction ladder are TPU shapes of a gather,
// an append and a loop that ends early; none is carried over.  The DP is
// extend.cuh's `ksw_extend_warp`: a target row's band across the 32 lanes,
// its row state (H, E) and the job's query in the warp's slice of shared
// memory for the whole job, sized from Q, the longest read it runs (the
// wrapper checks Q and the scores against the DP's limits, and
// `bwamem_chain2aln_max_qlen` gives the longest read whose slices fit a
// block; `regs_batch_fused` sends longer reads to the staged path).  Its
// target is read from the 2-bit pac as the DP walks, 32 rows at a time, a
// byte a lane (a position at or past l_pac is the complement of the
// mirrored forward base), so there is no window buffer, no T_cap and
// nothing uploaded per wave.  The per-task tests are "any" predicates over the read's
// regions and the chain's later seeds, a region or seed a lane; seedcov is
// a warp sum.  A read's regions go to its offset in a table as long as
// seed_rows (a read makes at most one region per seed), so there is no R
// budget.  cal_max_gap and the two ratio tests are computed in double as
// the oracle computes them, and the file is built without --use_fast_math.
//
// What bounds it: the latency of one warp's chain of target rows (a row is
// a few shared-memory loads, a 5-step shuffle scan, four warp reductions and
// a few shuffles), not bytes or operations (a few tens of MB and ~10
// operations a band cell would take well under a millisecond).  A warp per
// read leaves the card waiting on the read with the most cells: on an ecoli
// batch of 12,005 reads the loop took 10.08 ms, 9.77 of them that read's
// alone.  So the grid is persistent and warps take work items from a global
// counter in the order the wrapper gives, heaviest first (n_seed x qlen),
// and a read whose estimate is above the batch's total over four times the
// resident warps (one that would outlast the card's fair share on one warp;
// `split_reads` in ops/pipeline_fused.py says why four) and that has two
// chains or more runs as chain items: each chain on a warp of its
// own, at once, against its own regions only, into its rows of a scratch
// table (its regions and each one's extension counts).  The warp that
// finishes the read's last chain commits the read in bwa's order: it runs
// each chain's decisions again against the read's regions, as a warp per
// read does, but takes the chain's own extension of every seed that both
// runs extend, since an extension depends only on the seed, its chain and
// the read (the window, the query, seedcov over the chain's seeds), never
// on other regions.  So the commit is exact by construction, and its DP
// runs only for a seed that the chain's own run pruned and the read's run
// extends (a region that held it came from a seed now pruned); the cells
// of own extensions whose seeds the read's run prunes are counted as
// discarded.  Results do not depend on the order of the items: a read
// writes only its own rows, a chain its own scratch rows and flags.
//
// Errors: a seed outside its chain's window, a region past the read's rows
// or a first seed in no contig set a bit of *err; the wrapper raises.  A
// chain item that meets one stops and leaves the bit to its commit, which
// runs the chain again where the read's run reaches it.

#include <cstdint>
#include <cuda_runtime.h>

#include "extend.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kPrepWarps = 8;
constexpr int kPrepThreads = 32 * kPrepWarps;
constexpr int kPrepTile = 256;  // scores a warp stages at once
constexpr int kWarps = 8;  // a read a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kErrWindow = 1;
constexpr int kErrRows = 2;
constexpr int kErrContig = 4;
constexpr int kMaxBandTry = 2;

struct Opts {
  int a, o_del, e_del, o_ins, e_ins, zdrop, w, pen_clip5, pen_clip3, max_sc;
};

// cal_max_gap (`MemOptions.max_gap`): the quotient in double, truncated
// toward zero.
__device__ __forceinline__ int64_t cal_max_gap(const Opts& o, int64_t qlen) {
  const int l_del = static_cast<int>(
      static_cast<double>(qlen * o.a - o.o_del) / static_cast<double>(o.e_del) +
      1.0);
  const int l_ins = static_cast<int>(
      static_cast<double>(qlen * o.a - o.o_ins) / static_cast<double>(o.e_ins) +
      1.0);
  int l = l_del > l_ins ? l_del : l_ins;
  if (l < 1) l = 1;
  return l < (o.w << 1) ? l : (o.w << 1);
}

// One chain's window [rmax0, rmax1] and seed order, on one warp; `tile` is
// the warp's kPrepTile words of shared memory.  The warp takes the chain's
// seeds 32 at a time: each lane computes its seed's span (cal_max_gap in
// double) and its rank in the stable (score, index) order,
//   rank(t) = #{u : sc_u < sc_t} + #{u < t : sc_u = sc_t},
// against the chain's scores staged in `tile`, kPrepTile at a time (once
// for a chain of up to kPrepTile seeds).  srt[so + rank(t)] = t is the
// permutation a stable insertion sort gives, ties in index order.  The span
// is a min and max over the lanes; lane 0 then clamps it, cuts it at the
// strand boundary and clamps it to the first seed's contig.
__device__ __forceinline__ void prep_chain(
    int64_t ci, int lane, int64_t* tile,
    const int64_t* __restrict__ chain_rows,
    const int64_t* __restrict__ seed_rows,
    const int64_t* __restrict__ chain_seed_off,
    const int32_t* __restrict__ chain_read, const int32_t* __restrict__ qlen,
    const int64_t* __restrict__ ctg_end, const int64_t* __restrict__ ctg_off,
    int n_ctg, int64_t l_pac, const Opts& o, int64_t* __restrict__ rmax,
    int32_t* __restrict__ srt, int32_t* __restrict__ err) {
  const int64_t ns = chain_rows[ci * 7 + 2];
  if (ns <= 0) {
    if (lane == 0) {
      rmax[ci * 2] = 0;
      rmax[ci * 2 + 1] = 0;
    }
    return;
  }
  const int64_t so = chain_seed_off[ci];
  const int64_t ql = qlen[chain_read[ci]];
  const int64_t* sr = seed_rows + so * 4;
  const bool one_tile = ns <= kPrepTile;
  __syncwarp();  // every lane is done with the tile's last contents
  if (one_tile) {
    for (int64_t k = lane; k < ns; k += 32) tile[k] = sr[k * 4 + 3];
    __syncwarp();
  }
  int64_t r0 = l_pac << 1, r1 = 0;
  for (int64_t t0 = 0; t0 < ns; t0 += 32) {
    const int64_t t = t0 + lane;
    const bool live = t < ns;
    int64_t sc = 0;
    if (live) {
      const int64_t rbeg = sr[t * 4], qb = sr[t * 4 + 1], len = sr[t * 4 + 2];
      sc = sr[t * 4 + 3];
      const int64_t tail = ql - qb - len;
      const int64_t b = rbeg - (qb + cal_max_gap(o, qb));
      const int64_t e = rbeg + len + (tail + cal_max_gap(o, tail));
      r0 = b < r0 ? b : r0;
      r1 = e > r1 ? e : r1;
    }
    int64_t rank = 0;
    for (int64_t u0 = 0; u0 < ns; u0 += kPrepTile) {
      const int n = static_cast<int>(ns - u0 < kPrepTile ? ns - u0 : kPrepTile);
      if (!one_tile) {
        __syncwarp();
        for (int k = lane; k < n; k += 32) tile[k] = sr[(u0 + k) * 4 + 3];
        __syncwarp();
      }
      if (live) {
        const int64_t tu = t - u0;  // ties count below it
        for (int k = 0; k < n; ++k) {
          const int64_t v = tile[k];
          rank += v < sc || (v == sc && k < tu);
        }
      }
    }
    if (live) srt[so + rank] = static_cast<int32_t>(t);
  }
  for (int d = 16; d > 0; d >>= 1) {
    const int64_t a = __shfl_xor_sync(bwamem::kFullMask, r0, d);
    const int64_t c = __shfl_xor_sync(bwamem::kFullMask, r1, d);
    r0 = a < r0 ? a : r0;
    r1 = c > r1 ? c : r1;
  }
  if (lane != 0) return;
  if (r0 < 0) r0 = 0;
  if (r1 > (l_pac << 1)) r1 = l_pac << 1;
  const int64_t first = sr[0];
  const bool fwd = first < l_pac;
  if (r0 < l_pac && l_pac < r1) {  // crossing the strand boundary
    if (fwd)
      r1 = l_pac;
    else
      r0 = l_pac;
  }
  // the contig holding the first seed: the count of contig ends <= its
  // forward position
  const int64_t mid = fwd ? first : (l_pac << 1) - 1 - first;
  int lo = 0, hi = n_ctg;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (ctg_end[m] <= mid)
      lo = m + 1;
    else
      hi = m;
  }
  if (lo >= n_ctg || mid < 0) {
    atomicOr(err, kErrContig);
    rmax[ci * 2] = 0;
    rmax[ci * 2 + 1] = 0;
    return;
  }
  int64_t far_beg = ctg_off[lo], far_end = ctg_end[lo];
  if (!fwd) {
    const int64_t fb = (l_pac << 1) - far_end;
    far_end = (l_pac << 1) - far_beg;
    far_beg = fb;
  }
  rmax[ci * 2] = r0 > far_beg ? r0 : far_beg;
  rmax[ci * 2 + 1] = r1 < far_end ? r1 : far_end;
}

// A chain a warp, kPrepWarps warps a block; registers for 4 blocks an SM.
__global__ void __launch_bounds__(kPrepThreads, 4) chain2aln_prep_kernel(
    const int64_t* __restrict__ chain_rows,      // [Nc, 7]
    const int64_t* __restrict__ seed_rows,       // [Ns, 4] rbeg qbeg len score
    const int64_t* __restrict__ chain_seed_off,  // [Nc]
    const int32_t* __restrict__ chain_read,      // [Nc]
    const int32_t* __restrict__ qlen,            // [B]
    int64_t n_chains, const int64_t* __restrict__ ctg_end,
    const int64_t* __restrict__ ctg_off, int n_ctg, int64_t l_pac, Opts o,
    int64_t* __restrict__ rmax,  // [Nc, 2]
    int32_t* __restrict__ srt,   // [Ns] seed indices within the chain
    int32_t* __restrict__ err) {
  __shared__ int64_t tiles[kPrepWarps][kPrepTile];
  const int w = threadIdx.x >> 5;
  const int64_t ci = static_cast<int64_t>(blockIdx.x) * kPrepWarps + w;
  if (ci >= n_chains) return;
  prep_chain(ci, threadIdx.x & 31, tiles[w], chain_rows, seed_rows,
             chain_seed_off, chain_read, qlen, ctg_end, ctg_off, n_ctg, l_pac,
             o, rmax, srt, err);
}

// Reference bases from the 2-bit pac (four bases a byte, the first in the
// high bits) at doubled-domain positions pos, pos + dir, ...
struct PacView {
  const uint8_t* __restrict__ pac;
  int64_t l_pac, pos;
  int dir;
  __device__ __forceinline__ int operator()(int i) const {
    const int64_t p = pos + static_cast<int64_t>(dir) * i;
    const bool rev = p >= l_pac;
    const int64_t f = rev ? (l_pac << 1) - 1 - p : p;
    const int c = (pac[f >> 2] >> ((~f & 3) << 1)) & 3;
    return rev ? 3 - c : c;
  }
};

using bwamem::slice_words;  // the warp's slice of dynamic shared memory

// One side of a seed: the job at w, then at 2w under the oracle's break rule
// (`score` enters as the previous score and leaves as the job's).  `qs`
// already holds the side's query, `qlen` codes.
template <class TSeq>
__device__ __forceinline__ bwamem::KswResult extend_side(
    const uint8_t* qs, TSeq t, int qlen, int tlen, int h0, int end_bonus,
    const Opts& o, const uint32_t* sprof, int32_t* H, int32_t* E, int& score,
    int& aw, int64_t* work) {
  bwamem::KswResult res;
  for (int i2 = 0; i2 < kMaxBandTry; ++i2) {
    const int prev = score;
    aw = o.w << i2;
    const int w_adj = bwamem::ksw_band_width(qlen, aw, end_bonus, o.max_sc,
                                             o.o_del, o.e_del, o.o_ins, o.e_ins);
    res = bwamem::ksw_extend_warp(qs, t, qlen, tlen, h0, w_adj, sprof, H, E,
                                  o.o_del, o.e_del, o.o_ins, o.e_ins, o.zdrop);
    work[2] += 1;
    work[4] += res.cells;
    work[5] += res.rows;
    score = res.score;
    if (score == prev || res.max_off < (aw >> 1) + (aw >> 2)) break;
  }
  return res;
}

// The query of a side into the warp's shared memory: qlen codes from p,
// forward (dir 1) or backward (dir -1).
__device__ __forceinline__ void load_query(uint8_t* qs, const uint8_t* p,
                                           int dir, int qlen) {
  __syncwarp();  // the last job is done with qs
  for (int j = threadIdx.x & 31; j < qlen; j += 32) qs[j] = p[dir * j];
  __syncwarp();
}

// mem_chain2aln's containment test: does the region (pc, pi) hold the seed
// (rbeg, qb, len) close to its diagonal?
__device__ __forceinline__ bool region_holds(const int64_t* pc,
                                             const int32_t* pi, int64_t rbeg,
                                             int qb, int len, int ql,
                                             const Opts& o) {
  const int64_t p_rb = pc[0], p_re = pc[1];
  const int p_qb = pi[0], p_qe = pi[1], p_w = pi[4], p_sl0 = pi[6];
  if (!(rbeg >= p_rb && rbeg + len <= p_re && qb >= p_qb &&
        qb + len <= p_qe &&
        !(static_cast<double>(len - p_sl0) > 0.1 * static_cast<double>(ql))))
    return false;
  int64_t qd = qb - p_qb, rd = rbeg - p_rb;
  int64_t w = cal_max_gap(o, qd < rd ? qd : rd);
  if (w > p_w) w = p_w;
  if (qd - rd < w && rd - qd < w) return true;
  qd = p_qe - (qb + len);
  rd = p_re - (rbeg + len);
  w = cal_max_gap(o, qd < rd ? qd : rd);
  if (w > p_w) w = p_w;
  return qd - rd < w && rd - qd < w;
}

// Does any of the first n regions of the table (tc, ti) hold the seed?  A
// region a lane, then any; warp-uniform.
__device__ __forceinline__ bool any_holds(const int64_t* tc, const int32_t* ti,
                                          int n, int64_t rbeg, int qb, int len,
                                          int ql, const Opts& o) {
  const int lane = threadIdx.x & 31;
  bool held = false;
  for (int r0 = 0; r0 < n && !held; r0 += 32) {
    const int r = r0 + lane;
    held = __any_sync(bwamem::kFullMask,
                      r < n && region_holds(tc + r * 3, ti + r * 8, rbeg, qb,
                                            len, ql, o));
  }
  return held;
}

// Does a live seed of the chain after srt position k (the chain's seeds at
// so .. so + ns) argue for another alignment than the seed (rbeg, qb, len)?
// A seed a lane, then any; warp-uniform.  `alive` is read from L2: the
// chain's flags may have been written on another SM.
__device__ __forceinline__ bool later_differs(
    const int64_t* __restrict__ seed_rows, const int32_t* __restrict__ srt,
    const uint8_t* alive, int64_t so, int64_t ns, int64_t k, int64_t rbeg,
    int qb, int len) {
  const int lane = threadIdx.x & 31;
  bool diff = false;
  for (int64_t i0 = k + 1; i0 < ns && !diff; i0 += 32) {
    const int64_t i2 = i0 + lane;
    bool d = false;
    if (i2 < ns && __ldcg(alive + so + i2)) {
      const int64_t* t = seed_rows + (so + srt[so + i2]) * 4;
      const int64_t t_rbeg = t[0];
      const int t_qb = static_cast<int>(t[1]);
      const int t_len = static_cast<int>(t[2]);
      if (!(static_cast<double>(t_len) < static_cast<double>(len) * 0.95))
        d = (qb <= t_qb && qb + len - t_qb >= (len >> 2) &&
             t_qb - qb != t_rbeg - rbeg) ||
            (t_qb <= qb && t_qb + t_len - qb >= (len >> 2) &&
             qb - t_qb != rbeg - t_rbeg);
    }
    diff = __any_sync(bwamem::kFullMask, d);
  }
  return diff;
}

// A chain's own run, as its chain item leaves it from the chain's first seed
// row of the scratch table: its regions (c, i) and each one's extension
// counts (w: jobs, cells, rows), in the order it made them.
struct OwnRun {
  const int64_t* c;
  const int32_t* i;
  const int64_t* w;
};

// mem_chain2aln for chain ci on the 32 lanes of a warp: its seeds from the
// end of srt down, each tested against the first nreg regions of the table
// (tc, ti), its regions appended there (nreg grows) and, where tw is given,
// each region's extension counts.  Every visited seed leaves its flag in
// alive (0 pruned, 1 extended).  With `own`, the chain's own run: a seed it
// extended and this run extends again takes that run's region and counts
// (an extension depends only on the seed, its chain and the read), so only
// a seed it pruned and this run extends goes through the DP; `changed` is
// set where this run decides a seed otherwise, and `wasted` sums the cells
// of the own run's extensions this run prunes.  Returns false where it
// stopped on a seed outside the window or a region at max_regs, having set
// that bit of *err where err is given.  Every value that steers the loop is
// warp-uniform; lane 0 writes the shared rows (alive, regions), each
// followed by __syncwarp before other lanes read it.
__device__ bool chain2aln_chain(
    int64_t ci, int ql, const uint8_t* qrow,
    const int64_t* __restrict__ chain_rows,
    const int64_t* __restrict__ seed_rows,
    const int64_t* __restrict__ chain_seed_off, const int64_t* __restrict__ rmax,
    const int32_t* __restrict__ srt, uint8_t* __restrict__ alive,
    const uint8_t* __restrict__ pac, int64_t l_pac, const uint32_t* sprof,
    const Opts& o, int64_t t_cap, int32_t* H, int32_t* E, uint8_t* qs,
    int64_t* tc, int32_t* ti, int64_t* tw, int& nreg, int64_t max_regs,
    int32_t* err, int64_t* work, const OwnRun* own, bool& changed,
    int64_t& wasted) {
  const int lane = threadIdx.x & 31;
  const int64_t* cr = chain_rows + ci * 7;
  const int64_t ns = cr[2], so = chain_seed_off[ci];
  const int64_t r0 = rmax[ci * 2], r1 = rmax[ci * 2 + 1];
  int64_t j = 0;  // the own run's next region
  for (int64_t k = ns - 1; k >= 0; --k) {
    const int64_t* s = seed_rows + (so + srt[so + k]) * 4;
    const int64_t rbeg = s[0];
    const int qb = static_cast<int>(s[1]), len = static_cast<int>(s[2]);
    // the own run's decision, read by the lane that writes the flag later
    bool was_extended = false;
    if (own) {
      int v = 0;
      if (lane == 0) v = __ldcg(alive + so + k);
      was_extended = __shfl_sync(bwamem::kFullMask, v, 0) != 0;
    }
    // has this seed's neighbourhood been extended already?  unless a live
    // later seed of the chain argues for another alignment
    if (any_holds(tc, ti, nreg, rbeg, qb, len, ql, o) &&
        !later_differs(seed_rows, srt, alive, so, ns, k, rbeg, qb, len)) {
      if (lane == 0) alive[so + k] = 0;
      __syncwarp();
      work[1] += 1;
      if (was_extended) {
        changed = true;
        wasted += __ldcg(own->w + j * 3 + 1);
        ++j;
      }
      continue;
    }
    if (rbeg < r0 || rbeg + len > r1) {
      if (lane == 0 && err) atomicOr(err, kErrWindow);
      return false;
    }
    if (nreg >= max_regs) {
      if (lane == 0 && err) atomicOr(err, kErrRows);
      return false;
    }
    work[0] += 1;
    if (r1 - r0 > t_cap) work[3] = 1;
    if (was_extended) {  // the own run's region, a field a lane
      if (lane < 3)
        tc[nreg * 3 + lane] = __ldcg(own->c + j * 3 + lane);
      else if (lane < 11)
        ti[nreg * 8 + lane - 3] = __ldcg(own->i + j * 8 + lane - 3);
      if (lane == 0) alive[so + k] = 1;
      work[2] += __ldcg(own->w + j * 3);
      work[4] += __ldcg(own->w + j * 3 + 1);
      work[5] += __ldcg(own->w + j * 3 + 2);
      ++j;
      __syncwarp();
      ++nreg;
      continue;
    }
    if (own) changed = true;
    const int64_t jobs0 = work[2], cells0 = work[4], rows0 = work[5];
    int aw0 = o.w, aw1 = o.w;
    int score = -1, truesc, qb_f, qe_f;
    int64_t rb_f, re_f;
    if (qb > 0) {  // left extension on the reversed prefix
      load_query(qs, qrow + qb - 1, -1, qb);
      const bwamem::KswResult res = extend_side(
          qs, PacView{pac, l_pac, rbeg - 1, -1}, qb,
          static_cast<int>(rbeg - r0), len * o.a, o.pen_clip5, o, sprof, H, E,
          score, aw0, work);
      if (res.gscore <= 0 || res.gscore <= score - o.pen_clip5) {
        qb_f = qb - res.qle;
        rb_f = rbeg - res.tle;
        truesc = score;
      } else {
        qb_f = 0;
        rb_f = rbeg - res.gtle;
        truesc = res.gscore;
      }
    } else {
      score = truesc = len * o.a;
      qb_f = 0;
      rb_f = rbeg;
    }
    const int qe = qb + len;
    const int64_t re0 = rbeg + len;
    if (qe != ql) {  // right extension
      const int sc0 = score;
      load_query(qs, qrow + qe, 1, ql - qe);
      const bwamem::KswResult res = extend_side(
          qs, PacView{pac, l_pac, re0, 1}, ql - qe, static_cast<int>(r1 - re0),
          sc0, o.pen_clip3, o, sprof, H, E, score, aw1, work);
      if (res.gscore <= 0 || res.gscore <= score - o.pen_clip3) {
        qe_f = qe + res.qle;
        re_f = re0 + res.tle;
        truesc += score - sc0;
      } else {
        qe_f = ql;
        re_f = re0 + res.gtle;
        truesc += res.gscore - sc0;
      }
    } else {
      qe_f = ql;
      re_f = re0;
    }
    // seedcov: a warp sum over the chain's seeds
    int cov = 0;
    for (int64_t t2 = lane; t2 < ns; t2 += 32) {
      const int64_t* t = seed_rows + (so + t2) * 4;
      if (t[1] >= qb_f && t[1] + t[2] <= qe_f && t[0] >= rb_f &&
          t[0] + t[2] <= re_f)
        cov += static_cast<int>(t[2]);
    }
    const int seedcov = __reduce_add_sync(bwamem::kFullMask, cov);
    if (lane == 0) {
      int64_t* pc = tc + nreg * 3;
      int32_t* pi = ti + nreg * 8;
      pc[0] = rb_f;
      pc[1] = re_f;
      pc[2] = cr[3];
      pi[0] = qb_f;
      pi[1] = qe_f;
      pi[2] = score;
      pi[3] = truesc;
      pi[4] = aw0 > aw1 ? aw0 : aw1;
      pi[5] = seedcov;
      pi[6] = len;
      pi[7] = static_cast<int32_t>(cr[0]);
      if (tw) {
        tw[nreg * 3] = work[2] - jobs0;
        tw[nreg * 3 + 1] = work[4] - cells0;
        tw[nreg * 3 + 2] = work[5] - rows0;
      }
      alive[so + k] = 1;
    }
    __syncwarp();
    ++nreg;
  }
  return true;
}

// mem_chain2aln for read b on the 32 lanes of a warp, chain after chain into
// the read's rows.  With `commit`, every chain of the read has already run
// alone as a chain item (its own run in the scratch table at its first seed
// row, sreg_c/sreg_i/sreg_w; own_ok says whether it ran to its end): each
// chain runs again here against the read's regions, taking its own run's
// extensions, and a chain decided otherwise is counted in stats (the
// chains, and the band cells of their own runs' extensions pruned now).
__device__ void chain2aln_read(
    int b, bool commit, const int64_t* __restrict__ chain_rows,
    const int64_t* __restrict__ seed_rows, const int64_t* __restrict__ chain_off,
    const int64_t* __restrict__ n_chain, const int64_t* __restrict__ seed_off,
    const int64_t* __restrict__ n_seed,
    const int64_t* __restrict__ chain_seed_off, const int64_t* __restrict__ rmax,
    const int32_t* __restrict__ srt, uint8_t* __restrict__ alive,
    const uint8_t* __restrict__ run, const uint8_t* __restrict__ qseq,
    int64_t ldq, const int32_t* __restrict__ qlen, const uint8_t* __restrict__ pac,
    int64_t l_pac, const uint32_t* sprof, const Opts& o, int64_t t_cap,
    int32_t* H, int32_t* E, uint8_t* qs, int64_t* __restrict__ reg_c,
    int32_t* __restrict__ reg_i, int32_t* __restrict__ nregs,
    int64_t* __restrict__ work_out, const int64_t* sreg_c, const int32_t* sreg_i,
    const int64_t* sreg_w, const uint8_t* own_ok,
    unsigned long long* __restrict__ stats, int32_t* __restrict__ err) {
  const int lane = threadIdx.x & 31;
  int64_t work[6] = {0, 0, 0, 0, 0, 0};
  int nreg = 0;
  if (run[b]) {
    const int ql = qlen[b];
    const uint8_t* qrow = qseq + b * ldq;
    const int64_t base = seed_off[b], max_regs = n_seed[b];
    int64_t* tc = reg_c + base * 3;
    int32_t* ti = reg_i + base * 8;
    const int64_t c_end = chain_off[b] + n_chain[b];
    for (int64_t ci = chain_off[b]; ci < c_end; ++ci) {
      const int64_t so = chain_seed_off[ci];
      const OwnRun own{sreg_c + so * 3, sreg_i + so * 8, sreg_w + so * 3};
      const bool reuse = commit && __ldcg(own_ok + ci);
      bool changed = commit && !reuse;
      int64_t wasted = 0;
      const bool ok = chain2aln_chain(
          ci, ql, qrow, chain_rows, seed_rows, chain_seed_off, rmax, srt, alive,
          pac, l_pac, sprof, o, t_cap, H, E, qs, tc, ti, nullptr, nreg,
          max_regs, err, work, reuse ? &own : nullptr, changed, wasted);
      if (changed && lane == 0) {
        atomicAdd(stats, 1ull);
        atomicAdd(stats + 1, static_cast<unsigned long long>(wasted));
      }
      if (!ok) break;
    }
  }
  if (lane == 0) {
    nregs[b] = nreg;
    for (int k = 0; k < 6; ++k) work_out[b * 6 + k] = work[k];
  }
}

// A persistent grid: warps take work items in `items` order (heaviest
// first) from a global counter until none is left.  An item below B is a
// whole read; B + ci is chain ci of a read that splits; a negative item ends
// the list.  A chain item runs its chain alone, against its own regions, into
// the chain's rows of the scratch table; the warp that finishes a read's last
// chain commits the read (chain2aln_read with `commit`).
__global__ void __launch_bounds__(kThreads) chain2aln_kernel(
    const int64_t* __restrict__ chain_rows,      // [Nc, 7]
    const int64_t* __restrict__ seed_rows,       // [Ns, 4]
    const int64_t* __restrict__ chain_off,       // [B] first chain of the read
    const int64_t* __restrict__ n_chain,         // [B]
    const int64_t* __restrict__ seed_off,        // [B] first seed row of the read
    const int64_t* __restrict__ n_seed,          // [B]
    const int64_t* __restrict__ chain_seed_off,  // [Nc]
    const int32_t* __restrict__ chain_read,      // [Nc]
    const int64_t* __restrict__ rmax,            // [Nc, 2]
    const int32_t* __restrict__ srt,             // [Ns]
    uint8_t* __restrict__ alive,                 // [Ns] scratch, by srt position
    const uint8_t* __restrict__ run,             // [B]
    const uint8_t* __restrict__ qseq, int64_t ldq,  // [B, ldq] codes 0-4
    const int32_t* __restrict__ qlen, int B,
    int Q,  // the longest read of run, which sizes the warp's slice
    const uint8_t* __restrict__ pac, int64_t l_pac,
    const int32_t* __restrict__ mat, Opts o, int64_t t_cap,
    const int32_t* __restrict__ items,  // [n_items] heaviest first
    int n_items,
    int32_t* __restrict__ next,   // [1] the next position of items
    int64_t* __restrict__ reg_c,  // [Ns, 3] rb re frac_rep bits
    int32_t* __restrict__ reg_i,  // [Ns, 8] qb qe score truesc w seedcov seedlen0 rid
    int32_t* __restrict__ nregs,  // [B]
    int64_t* __restrict__ work_out,  // [B, 6]
    // chain items' scratch (unused where items holds reads only)
    int64_t* sreg_c,   // [Ns, 3] a chain's own regions from its first seed row
    int32_t* sreg_i,   // [Ns, 8]
    int64_t* sreg_w,   // [Ns, 3] their jobs, cells, rows
    uint8_t* own_ok,   // [Nc] the chain's own run reached its end
    int32_t* done,     // [B] chain items of the read finished, zeroed
    unsigned long long* __restrict__ stats,  // [2] chains decided again, cells
    int32_t* __restrict__ err) {
  extern __shared__ int32_t slices[];
  __shared__ uint32_t sprof[10];
  bwamem::pack_scores(mat, sprof);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int32_t* H = slices + (threadIdx.x >> 5) * slice_words(Q);
  int32_t* E = H + Q + 1;
  uint8_t* qs = reinterpret_cast<uint8_t*>(E + Q + 1);
  for (;;) {
    int r = 0;
    if (lane == 0) r = atomicAdd(next, 1);
    r = __shfl_sync(bwamem::kFullMask, r, 0);
    if (r >= n_items) break;
    const int item = items[r];
    if (item < 0) break;
    int b = item;
    if (item >= B) {  // a chain of a read that splits
      const int64_t ci = item - B;
      b = chain_read[ci];
      const int64_t so = chain_seed_off[ci];
      int64_t work[6] = {0, 0, 0, 0, 0, 0};
      int nreg = 0;
      bool changed = false;
      int64_t wasted = 0;
      const bool ok = chain2aln_chain(
          ci, qlen[b], qseq + b * ldq, chain_rows, seed_rows, chain_seed_off,
          rmax, srt, alive, pac, l_pac, sprof, o, t_cap, H, E, qs,
          sreg_c + so * 3, sreg_i + so * 8, sreg_w + so * 3, nreg,
          chain_rows[ci * 7 + 2], nullptr, work, nullptr, changed, wasted);
      if (lane == 0) own_ok[ci] = ok;
      // publish the chain's rows and flags before counting it done; the
      // read's last chain commits it
      __threadfence();
      __syncwarp();
      int last = 0;
      if (lane == 0) last = atomicAdd(done + b, 1) == n_chain[b] - 1;
      if (!__shfl_sync(bwamem::kFullMask, last, 0)) continue;
      __threadfence();
    }
    chain2aln_read(b, item >= B, chain_rows, seed_rows, chain_off, n_chain,
                   seed_off, n_seed, chain_seed_off, rmax, srt, alive, run,
                   qseq, ldq, qlen, pac, l_pac, sprof, o, t_cap, H, E, qs,
                   reg_c, reg_i, nregs, work_out, sreg_c, sreg_i, sreg_w,
                   own_ok, stats, err);
  }
}

__global__ void band_width_kernel(const int32_t* __restrict__ qlen,
                                  const int32_t* __restrict__ w,
                                  const int32_t* __restrict__ end_bonus, int n,
                                  int max_sc, int o_del, int e_del, int o_ins,
                                  int e_ins, int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = bwamem::ksw_band_width(qlen[i], w[i], end_bonus[i], max_sc, o_del,
                                    e_del, o_ins, e_ins);
}

// The loop kernel's dynamic shared memory a block for reads of up to Q
// bases, allowed past the default 48 KB.
cudaError_t allow_loop_smem(int Q, size_t* bytes) {
  *bytes = sizeof(int32_t) * kWarps * slice_words(Q);
  return bwamem::raise_smem_limit(chain2aln_kernel, *bytes);
}

}  // namespace

// Launchers: device pointers and a stream in, cudaGetLastError() out.

extern "C" int bwamem_chain2aln_prep_launch(
    const int64_t* chain_rows, const int64_t* seed_rows,
    const int64_t* chain_seed_off, const int32_t* chain_read,
    const int32_t* qlen, int64_t n_chains, const int64_t* ctg_end,
    const int64_t* ctg_off, int n_ctg, int64_t l_pac, int a, int o_del,
    int e_del, int o_ins, int e_ins, int zdrop, int w, int pen_clip5,
    int pen_clip3, int max_sc, int64_t* rmax, int32_t* srt, int32_t* err,
    cudaStream_t stream) {
  if (n_chains <= 0) return 0;
  const Opts o{a, o_del, e_del, o_ins, e_ins, zdrop, w, pen_clip5, pen_clip3,
               max_sc};
  const unsigned blocks =
      static_cast<unsigned>((n_chains + kPrepWarps - 1) / kPrepWarps);
  chain2aln_prep_kernel<<<blocks, kPrepThreads, 0, stream>>>(
      chain_rows, seed_rows, chain_seed_off, chain_read, qlen, n_chains,
      ctg_end, ctg_off, n_ctg, l_pac, o, rmax, srt, err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bwamem_chain2aln_launch(
    const int64_t* chain_rows, const int64_t* seed_rows,
    const int64_t* chain_off, const int64_t* n_chain, const int64_t* seed_off,
    const int64_t* n_seed, const int64_t* chain_seed_off,
    const int32_t* chain_read, const int64_t* rmax, const int32_t* srt,
    uint8_t* alive, const uint8_t* run, const uint8_t* qseq, int64_t ldq,
    const int32_t* qlen, int B, int Q, const uint8_t* pac, int64_t l_pac,
    const int32_t* mat, int a, int o_del, int e_del, int o_ins, int e_ins,
    int zdrop, int w, int pen_clip5, int pen_clip3, int max_sc, int64_t t_cap,
    const int32_t* items, int n_items, int32_t* next, int64_t* reg_c,
    int32_t* reg_i, int32_t* nregs, int64_t* work, int64_t* sreg_c,
    int32_t* sreg_i, int64_t* sreg_w, uint8_t* own_ok, int32_t* done,
    int64_t* stats, int32_t* err, cudaStream_t stream) {
  if (B <= 0 || n_items <= 0) return 0;
  const Opts o{a, o_del, e_del, o_ins, e_ins, zdrop, w, pen_clip5, pen_clip3,
               max_sc};
  size_t smem = 0;
  cudaError_t rc = allow_loop_smem(Q, &smem);
  if (rc != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(rc);
  }
  // a persistent grid: as many blocks as fit on the card at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain2aln_kernel,
                                                kThreads, smem);
  const int64_t need = (static_cast<int64_t>(n_items) + kWarps - 1) / kWarps;
  const int64_t fit = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  rc = cudaMemsetAsync(next, 0, sizeof(int32_t), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  chain2aln_kernel<<<static_cast<unsigned>(need < fit ? need : fit), kThreads,
                     smem, stream>>>(
      chain_rows, seed_rows, chain_off, n_chain, seed_off, n_seed,
      chain_seed_off, chain_read, rmax, srt, alive, run, qseq, ldq, qlen, B, Q,
      pac, l_pac, mat, o, t_cap, items, n_items, next, reg_c, reg_i, nregs,
      work, sreg_c, sreg_i, sreg_w, own_ok, done,
      reinterpret_cast<unsigned long long*>(stats), err);
  return static_cast<int>(cudaGetLastError());
}

// Warps of chain2aln_kernel resident on one SM for reads of up to Q bases
// (the occupancy calculator's figure).
extern "C" int bwamem_chain2aln_warps_per_sm(int Q) {
  size_t smem = 0;
  int per_sm = 0;
  if (allow_loop_smem(Q, &smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, chain2aln_kernel, kThreads, smem) != cudaSuccess) {
    cudaGetLastError();  // a refused size is no error of a later launch
    return -1;
  }
  return per_sm * kWarps;
}

// The longest read whose warp slices fit a block on the current card: the
// dynamic shared memory plus the kernel's static shared memory within what
// the card allows a block (cudaFuncSetAttribute refuses more); -1 on error.
extern "C" int bwamem_chain2aln_max_qlen() {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, chain2aln_kernel) != cudaSuccess)
    return -1;
  const int64_t words =
      (static_cast<int64_t>(optin) - static_cast<int64_t>(fa.sharedSizeBytes)) /
      static_cast<int64_t>(sizeof(int32_t) * kWarps);
  int Q = static_cast<int>(words / 2);  // slice_words(Q) > 2 Q
  while (Q > 0 && slice_words(Q) > words) --Q;
  return Q;
}

extern "C" int bwamem_band_width_launch(
    const int32_t* qlen, const int32_t* w, const int32_t* end_bonus, int n,
    int max_sc, int o_del, int e_del, int o_ins, int e_ins, int32_t* out,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  band_width_kernel<<<(n + 127) / 128, 128, 0, stream>>>(
      qlen, w, end_bonus, n, max_sc, o_del, e_del, o_ins, e_ins, out);
  return static_cast<int>(cudaGetLastError());
}
