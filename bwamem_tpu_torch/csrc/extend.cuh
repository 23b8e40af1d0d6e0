// The banded affine-gap extension DP (bwa ksw_extend2) as __device__
// functions: `ksw_extend_core`, one job on one thread, and
// `ksw_extend_group`, one job on a group of G lanes (`ksw_extend_warp`: a
// whole warp).  The wave kernel of extend.cu runs a job on a lane group and
// the rare job past the group's limits on `ksw_extend_core`, its sequences
// in job-major arrays; the chain-to-region kernel of chain2aln.cu runs its
// jobs on `ksw_extend_warp`, its query in the warp's shared memory, its
// target read from the 2-bit pac.
//
// Semantics are exactly [EXT] ksw.c ksw_extend2, as written out in the host
// oracle engine/extend.py `ksw_extend2` and its C++ twin
// engine/native/ksw.cpp: z-drop, h0 seeding, the adaptive [beg, end) window
// that re-reads stale cells when it regrows, the eh[end] boundary writes, the
// last-attaining-column tie-break of the row max (>=), gscore updates on <=,
// maxv/max_off updates on strict >.
//
// The query and the target come through accessors (`q(j)`, `t(i)` return a
// code 0-4), so a caller picks its own layout and direction.  For
// `ksw_extend_core` the eh[] row state (eh[j].h = H(i-1, j-1), eh[j].e =
// E(i, j)) lives in the caller's scratch: `H[j * st]`, `E[j * st]`, int32.
// The function initialises cells 0..ninit itself (ninit >= qlen): cells
// outside the window keep stale values and are read again when the window
// regrows, so what an earlier job or the allocator left there would change
// results.

#pragma once

#include <cstdint>

namespace bwamem {

struct KswResult {
  int score, qle, tle, gtle, gscore, max_off;
  int rows;       // target rows walked
  int64_t cells;  // band cells walked
};

// ksw_extend2's preamble: the band w clamped by the longest insertion and
// deletion that could still score, each at least 1.  Floor division, as
// ops/extend.py `band_width` (the Python copy that the plain version and the
// wave wrapper use); after the clamp to >= 1 it equals the oracle's truncated
// float quotient.
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int ksw_band_width(int qlen, int w, int end_bonus,
                                              int max_sc, int o_del, int e_del,
                                              int o_ins, int e_ins) {
  int max_ins = floor_div(qlen * max_sc + end_bonus - o_ins, e_ins) + 1;
  int max_del = floor_div(qlen * max_sc + end_bonus - o_del, e_del) + 1;
  if (max_ins < 1) max_ins = 1;
  if (max_del < 1) max_del = 1;
  if (w > max_ins) w = max_ins;
  if (w > max_del) w = max_del;
  return w;
}

// One job.  `smat` is the 5x5 matrix (row = target code), `w` the band after
// `ksw_band_width`.
template <class QSeq, class TSeq>
__device__ __forceinline__ KswResult ksw_extend_core(
    QSeq q, TSeq t, int qlen, int tlen, int h0, int w,
    const int32_t* __restrict__ smat, int32_t* __restrict__ H,
    int32_t* __restrict__ E, int64_t st, int ninit, int o_del, int e_del,
    int o_ins, int e_ins, int zdrop) {
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;

  // eh[0].h = h0; eh[j].h = max(h0 - oe_ins - (j-1)*e_ins, 0) up to qlen,
  // 0 past it; eh[].e = 0
  H[0] = h0;
  E[0] = 0;
  int ramp = h0 > oe_ins ? h0 - oe_ins : 0;
  for (int j = 1; j <= ninit; ++j) {
    H[j * st] = j <= qlen ? ramp : 0;
    E[j * st] = 0;
    ramp = ramp > e_ins ? ramp - e_ins : 0;
  }

  int maxv = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0;
  int beg = 0, end = qlen;
  int i = 0;
  int64_t cells = 0;
  for (; i < tlen; ++i) {
    const int32_t* qp = smat + 5 * t(i);
    int f = 0, m = 0, mj = -1;
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    int h1 = 0;
    if (beg == 0) {
      h1 = h0 - (o_del + e_del * (i + 1));
      if (h1 < 0) h1 = 0;
    }
    if (end > beg) cells += end - beg;
    for (int j = beg; j < end; ++j) {
      // eh[j] = {H(i-1, j-1), E(i, j)}, f = F(i, j), h1 = H(i, j-1)
      int M = H[j * st];
      int e = E[j * st];
      H[j * st] = h1;
      M = M ? M + qp[q(j)] : 0;  // no extension from a zeroed cell
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
  KswResult r;
  r.score = maxv;
  r.qle = max_j + 1;
  r.tle = max_i + 1;
  r.gtle = max_ie + 1;
  r.gscore = gscore;
  r.max_off = max_off;
  r.rows = i < tlen ? i + 1 : tlen;
  r.cells = cells;
  return r;
}

// ksw_extend_group: the same job, one target row at a time across the G
// lanes of a lane group (G = 32, a whole warp, or 16 or 8 lanes, several
// jobs a warp; `ksw_extend_warp` is G = 32).
//
// A row of n = end - beg cells goes over the lanes in C-cell chunks, lane l
// taking cells [base + l*C, base + (l+1)*C): C = 1, 2, 3 or 5 when n <= G C
// (one pass), else C = 160 / G (at least 5) and passes of 160 cells.  The
// smallest C keeps a lane's serial work, and so the row's latency, small.
// What makes the row parallel: F depends only on M of the earlier columns,
// never on H, so with u[k] = max(M[k] - oe_ins, 0), F[beg] = 0 and, for
// j > beg,
//   F[j] = max_{beg <= k < j} (u[k] + k e_ins) - (j - 1) e_ins,
// a max-plus prefix scan (a lane-local scan, then a shuffle scan of the lane
// totals, carried across passes), exact in int32.  (F[beg] may be taken as
// anything <= 0: E >= 0, so max(M, E, F) is the same.)  E and M are per
// cell; H(i, j-1), which the scalar writes to eh[j], comes from the lane
// below by a shuffle, so each lane reads and writes only its own cells.  The
// row max is one group reduction of (h << kColBits | j), which takes the
// last column that attains it (the scalar's >=); H(i, end-1) and the first
// and last live cells, for the band shrink, are three more.  Every value
// that steers the loop is uniform over the group.  `rows` and `cells` count
// as the scalar counts.
//
// All G lanes of the group call it with the same arguments; the groups of a
// warp may run different jobs (their shuffles and reductions name only the
// group's lanes).  `qs` [qlen] holds the job's query codes, H, E [qlen + 1]
// the row state, both in shared memory; the function initialises H, E over
// 0..qlen.  `sprof` [10] holds the scores of target code c against query
// codes 0-3 as the bytes of sprof[c] and against 4 as byte 0 of
// sprof[5 + c], int8 each (`pack_scores`).  The caller guarantees
// qlen < 2^kColBits and every H < 2^(31 - kColBits) (H <= max(h0, 0) +
// qlen * the largest score).  `t(r)` is called for rows r < tlen, G at a
// time, a row a lane, one batch ahead.
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kNoPrefix = -(1 << 30);
constexpr int kColBits = 12;  // a column, in the packed (h, j) of the row max

// The words of shared memory that `ksw_extend_group` takes for queries of
// up to Q bases: H and E [Q + 1] int32, then the query codes [Q] uint8.
__host__ __device__ __forceinline__ int slice_words(int Q) {
  return 2 * (Q + 1) + (Q + 3) / 4;
}

// The lanes of this thread's group of G in its warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return kFullMask;
  } else {
    return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  }
}

// The score of a query code qc (0-4) from a target code's packed scores:
// byte qc of {hi, lo}, sign-extended (PRMT with the sign-replicate bit).
__device__ __forceinline__ int score_of(uint32_t lo, uint32_t hi, int qc) {
  int r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi),
      "r"(qc * 0x1111 | 0x8880));
  return r;
}

// `sprof` from the 5x5 matrix (row = target code), on threads 0-4.
__device__ __forceinline__ void pack_scores(const int32_t* mat,
                                            uint32_t* sprof) {
  const int c = threadIdx.x;
  if (c < 5) {
    uint32_t lo = 0;
    for (int q = 0; q < 4; ++q)
      lo |= (static_cast<uint32_t>(mat[5 * c + q]) & 0xffu) << (8 * q);
    sprof[c] = lo;
    sprof[5 + c] = static_cast<uint32_t>(mat[5 * c + 4]) & 0xffu;
  }
}

// One pass of a row over cells [base, base + G C) of [.., end); `more`:
// another pass follows.  Carries pc (the prefix max of the earlier passes)
// and hc (H(i, base - 1)); keeps this lane's packed row max, H(i, end - 1)
// and live cells.
template <int G, int C>
__device__ __forceinline__ void row_pass(
    int base, int end, int lane, unsigned gmask, const uint8_t* __restrict__ qs,
    int32_t* __restrict__ H, int32_t* __restrict__ E, uint32_t slo,
    uint32_t shi, int oe_del, int oe_ins, int e_del, int e_ins, bool more,
    int& pc, int& hc, int& key, int& hl, int& live_lo, int& live_hi) {
  const int j0 = base + lane * C;
  int Mv[C], Ev[C], Vv[C], hv[C];
  int tot = kNoPrefix;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = j0 + k;
    Mv[k] = Ev[k] = hv[k] = 0;
    Vv[k] = kNoPrefix;
    if (j < end) {
      const int raw = H[j];
      Mv[k] = raw ? raw + score_of(slo, shi, qs[j]) : 0;  // none from a zero
      Ev[k] = E[j];
      Vv[k] = (Mv[k] > oe_ins ? Mv[k] - oe_ins : 0) + j * e_ins;
      tot = tot > Vv[k] ? tot : Vv[k];
    }
  }
  // exclusive max scan of the lane totals, after the earlier passes
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const int o = __shfl_up_sync(gmask, tot, d, G);
    if (lane >= d) tot = tot > o ? tot : o;
  }
  int run = __shfl_up_sync(gmask, tot, 1, G);
  if (lane == 0) run = kNoPrefix;
  run = run > pc ? run : pc;
  if (more) {
    const int all = __shfl_sync(gmask, tot, G - 1, G);
    pc = pc > all ? pc : all;
  }
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = j0 + k;
    if (j < end) {
      const int f = run - (j - 1) * e_ins;
      int h = Mv[k] > Ev[k] ? Mv[k] : Ev[k];
      h = h > f ? h : f;
      hv[k] = h;
      const int kj = h << kColBits | j;
      key = key > kj ? key : kj;
      if (j == end - 1) hl = h;
      run = run > Vv[k] ? run : Vv[k];
      const int ud = Mv[k] > oe_del ? Mv[k] - oe_del : 0;
      const int e = Ev[k] - e_del;
      Ev[k] = e > ud ? e : ud;
    }
  }
  // eh[j] = {H(i, j-1), E(i+1, j)}: H(i, j-1) from the lane below
  int hp = __shfl_up_sync(gmask, hv[C - 1], 1, G);
  if (lane == 0) hp = hc;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = j0 + k;
    if (j < end) {
      H[j] = hp;
      E[j] = Ev[k];
      if ((hp | Ev[k]) != 0) {  // both >= 0
        live_lo = live_lo < j ? live_lo : j;
        live_hi = j;
      }
      hp = hv[k];
    }
  }
  if (more) hc = __shfl_sync(gmask, hv[C - 1], G - 1, G);
}

template <int G, class TSeq>
__device__ KswResult ksw_extend_group(const uint8_t* __restrict__ qs, TSeq t,
                                      int qlen, int tlen, int h0, int w,
                                      const uint32_t* __restrict__ sprof,
                                      int32_t* __restrict__ H,
                                      int32_t* __restrict__ E, int o_del,
                                      int e_del, int o_ins, int e_ins,
                                      int zdrop) {
  constexpr int kBig = 160 / G > 5 ? 160 / G : 5;  // cells a lane, long rows
  const unsigned gmask = group_mask<G>();
  const int lane = threadIdx.x & (G - 1);
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  __syncwarp(gmask);
  for (int j = lane; j <= qlen; j += G) {
    const int ramp = h0 - oe_ins - (j - 1) * e_ins;
    H[j] = j == 0 ? h0 : (ramp > 0 ? ramp : 0);
    E[j] = 0;
  }
  int maxv = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0;
  int beg = 0, end = qlen;
  int i = 0;
  int64_t cells = 0;
  int tcur = 0, tnext = lane < tlen ? t(lane) : 0;
  for (; i < tlen; ++i) {
    __syncwarp(gmask);  // the last row's writes are visible to every lane
    if ((i & (G - 1)) == 0) {  // this batch of G target rows; fetch the next
      tcur = tnext;
      tnext = i + G + lane < tlen ? t(i + G + lane) : 0;
    }
    const int tb = __shfl_sync(gmask, tcur, i & (G - 1), G);
    const uint32_t slo = sprof[tb], shi = sprof[5 + tb];
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    int h1 = 0;
    if (beg == 0) {
      h1 = h0 - (o_del + e_del * (i + 1));
      if (h1 < 0) h1 = 0;
    }
    const int n = end - beg;
    int m = 0, mj = -1, h_last = h1, first = end, last = -1;
    if (n > 0) {
      cells += n;
      int pc = kNoPrefix, hc = h1, key = -1, hl = -1;
      int live_lo = 0x7fffffff, live_hi = -1;
      if (n <= G) {
        row_pass<G, 1>(beg, end, lane, gmask, qs, H, E, slo, shi, oe_del,
                       oe_ins, e_del, e_ins, false, pc, hc, key, hl, live_lo,
                       live_hi);
      } else if (n <= 2 * G) {
        row_pass<G, 2>(beg, end, lane, gmask, qs, H, E, slo, shi, oe_del,
                       oe_ins, e_del, e_ins, false, pc, hc, key, hl, live_lo,
                       live_hi);
      } else if (n <= 3 * G) {
        row_pass<G, 3>(beg, end, lane, gmask, qs, H, E, slo, shi, oe_del,
                       oe_ins, e_del, e_ins, false, pc, hc, key, hl, live_lo,
                       live_hi);
      } else if (n <= 5 * G) {
        row_pass<G, 5>(beg, end, lane, gmask, qs, H, E, slo, shi, oe_del,
                       oe_ins, e_del, e_ins, false, pc, hc, key, hl, live_lo,
                       live_hi);
      } else {
        for (int base = beg; base < end; base += G * kBig)
          row_pass<G, kBig>(base, end, lane, gmask, qs, H, E, slo, shi,
                            oe_del, oe_ins, e_del, e_ins,
                            base + G * kBig < end, pc, hc, key, hl, live_lo,
                            live_hi);
      }
      key = __reduce_max_sync(gmask, key);
      m = key >> kColBits;
      mj = key & ((1 << kColBits) - 1);
      h_last = __reduce_max_sync(gmask, hl);
      const int lo = __reduce_min_sync(gmask, live_lo);
      first = lo < end ? lo : end;
      last = __reduce_max_sync(gmask, live_hi);
    }
    if (lane == 0) {
      H[end] = h_last;
      E[end] = 0;
    }
    if (end == qlen && gscore <= h_last) {  // reached the end of the query
      max_ie = i;
      gscore = h_last;
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
    // shrink the band over eh indices [beg, end]: the first live cell of
    // [beg, end), the last of [beg, end] (eh[end] = {h_last, 0})
    beg = first;
    const int j = h_last != 0 ? end : (last >= 0 ? last : beg - 1);
    end = j + 2 < qlen ? j + 2 : qlen;
  }
  __syncwarp(gmask);
  KswResult r;
  r.score = maxv;
  r.qle = max_j + 1;
  r.tle = max_i + 1;
  r.gtle = max_ie + 1;
  r.gscore = gscore;
  r.max_off = max_off;
  r.rows = i < tlen ? i + 1 : tlen;
  r.cells = cells;
  return r;
}

template <class TSeq>
__device__ __forceinline__ KswResult ksw_extend_warp(
    const uint8_t* __restrict__ qs, TSeq t, int qlen, int tlen, int h0, int w,
    const uint32_t* __restrict__ sprof, int32_t* __restrict__ H,
    int32_t* __restrict__ E, int o_del, int e_del, int o_ins, int e_ins,
    int zdrop) {
  return ksw_extend_group<32>(qs, t, qlen, tlen, h0, w, sprof, H, E, o_del,
                              e_del, o_ins, e_ins, zdrop);
}

}  // namespace bwamem
