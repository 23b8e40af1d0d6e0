// The banded affine-gap extension DP (bwa ksw_extend2) as a __device__
// function, shared by the wave kernel of extend.cu (one job a thread, its
// sequences in job-major arrays) and the chain-to-region kernel of
// chain2aln.cu (one read a thread, its query on the padded reads and its
// target read base by base from the 2-bit pac).
//
// Semantics are exactly [EXT] ksw.c ksw_extend2, as written out in the host
// oracle engine/extend.py `ksw_extend2` and its C++ twin
// engine/native/ksw.cpp: z-drop, h0 seeding, the adaptive [beg, end) window
// that re-reads stale cells when it regrows, the eh[end] boundary writes, the
// last-attaining-column tie-break of the row max (>=), gscore updates on <=,
// maxv/max_off updates on strict >.
//
// The query and the target come through accessors (`q(j)`, `t(i)` return a
// code 0-4), so a caller picks its own layout and direction.  The eh[] row
// state (eh[j].h = H(i-1, j-1), eh[j].e = E(i, j)) lives in the caller's
// scratch: `H[j * st]`, `E[j * st]`, int32.  The function initialises cells
// 0..ninit itself (ninit >= qlen): cells outside the window keep stale values
// and are read again when the window regrows, so what an earlier job or the
// allocator left there would change results.

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

}  // namespace bwamem
