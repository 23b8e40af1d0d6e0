// Line decode of the fused FM-index lines, for Hopper (sm_90a).
//
// Device counterpart of bwamem_tpu/ops/fmindex_tpu.py `_rows_for`,
// `_block_counts4`, `_block_count1` and the char pick of `_sa_tick`, and of
// the host oracle bwamem_tpu/engine/fmindex.py.  A line holds `span`
// consecutive chars of the stored BWT (the sentinel elided): four u32
// counts of each symbol before the line, then span/16 u32 words of 16
// 2-bit chars each, char j of a word in bits {31-2j, 30-2j}.  The last
// line's words are zero-padded past seq_len.
//
// Conceptual rows follow bwa: row `primary` carries the sentinel, so the
// occ offset of row k is k - (k >= primary) and its BWT char sits at
// k - (k > primary); the two agree for every k but `primary`, whose LF
// step is row 0, so one line fetch serves the char and the count.

#pragma once

#include <cstdint>

namespace bwamem_fm {

constexpr uint32_t kM55 = 0x55555555u;

struct Fm {
  const uint32_t* __restrict__ lines;  // [nb, W]
  const int64_t* __restrict__ L2;      // [5]
  int64_t primary;
  int64_t seq_len;
  int W;   // u32 per line: 4 + span / 16
  int lg;  // log2(span)
};

// The line holding row k, and the chars of it counted through k
// (inclusive).  k = -1 reads line 0, which the callers mask.
__device__ __forceinline__ const uint32_t* fm_line(const Fm& fm, int64_t k,
                                                   int* within) {
  int64_t kk = k - (k >= fm.primary);
  if (kk < 0) kk = 0;
  *within = static_cast<int>(kk & ((int64_t{1} << fm.lg) - 1)) + 1;
  return fm.lines + (kk >> fm.lg) * fm.W;
}

// The low bit of each of word w's chars that fall among the first nchars
// chars of the line.
__device__ __forceinline__ uint32_t keep_mask(int nchars, int w) {
  const int valid = nchars - 16 * w;
  if (valid >= 16) return kM55;
  if (valid <= 0) return 0u;
  return (0xFFFFFFFFu << (32 - 2 * valid)) & kM55;
}

// Counts of all four symbols among the first nchars chars of a line's
// words: the two bit planes, aligned to the low bit, AND-ed per symbol.
__device__ __forceinline__ void count4(const uint32_t* words, int nchars,
                                       int cnt[4]) {
  cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
  const int nw = (nchars + 15) >> 4;
  for (int w = 0; w < nw; ++w) {
    const uint32_t x = words[w], keep = keep_mask(nchars, w);
    const uint32_t hi = (x >> 1) & kM55, lo = x & kM55;
    const uint32_t nhi = hi ^ kM55, nlo = lo ^ kM55;
    cnt[0] += __popc(nhi & nlo & keep);
    cnt[1] += __popc(nhi & lo & keep);
    cnt[2] += __popc(hi & nlo & keep);
    cnt[3] += __popc(hi & lo & keep);
  }
}

// Count of symbol c among the first nchars chars of a line's words.
__device__ __forceinline__ int count1(const uint32_t* words, int nchars,
                                      int c) {
  const uint32_t fh = (c & 2) ? 0u : kM55, fl = (c & 1) ? 0u : kM55;
  int n = 0;
  const int nw = (nchars + 15) >> 4;
  for (int w = 0; w < nw; ++w) {
    const uint32_t x = words[w];
    const uint32_t hi = ((x >> 1) & kM55) ^ fh, lo = (x & kM55) ^ fl;
    n += __popc(hi & lo & keep_mask(nchars, w));
  }
  return n;
}

// The BWT char at offset pos of a line's words.
__device__ __forceinline__ int bwt_char(const uint32_t* words, int pos) {
  return (words[pos >> 4] >> (30 - 2 * (pos & 15))) & 3;
}

// bwa bwt_occ4: counts of each symbol among conceptual chars [0..k];
// k == -1 -> 0, k == seq_len -> the full counts.
__device__ __forceinline__ void occ4(const Fm& fm, int64_t k, int cnt[4]) {
  if (k == fm.seq_len) {
    for (int c = 0; c < 4; ++c)
      cnt[c] = static_cast<int>(fm.L2[c + 1] - fm.L2[c]);
    return;
  }
  if (k == -1) {
    cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
    return;
  }
  int within;
  const uint32_t* line = fm_line(fm, k, &within);
  count4(line + 4, within, cnt);
  for (int c = 0; c < 4; ++c) cnt[c] += static_cast<int>(line[c]);
}

// One LF step (bwa bwt_invPsi).
__device__ __forceinline__ int64_t lf(const Fm& fm, int64_t k) {
  if (k == fm.primary) return 0;
  int within;
  const uint32_t* line = fm_line(fm, k, &within);
  const int c = bwt_char(line + 4, within - 1);
  return fm.L2[c] + static_cast<int>(line[c]) + count1(line + 4, within, c);
}

// bwa bwt_extend of the bi-interval (x0, x1, s), backward (is_back) or
// forward: ox0, ox1 and sz indexed by queried-space symbol, as the host
// oracle's FMIndex.extend.  Two rank queries, one line each.  Returns
// false (and counts of 0) when a queried row lies outside [-1, seq_len].
__device__ __forceinline__ bool bwt_extend(const Fm& fm, int64_t x0,
                                           int64_t x1, int64_t s,
                                           bool is_back, int64_t ox0[4],
                                           int64_t ox1[4], int sz[4]) {
  const int64_t xq = is_back ? x0 : x1;
  const int64_t xo = is_back ? x1 : x0;
  const int64_t ka = xq - 1, kb = xq - 1 + s;
  int tk[4] = {0, 0, 0, 0}, tl[4] = {0, 0, 0, 0};
  const bool ok = ka >= -1 && ka <= fm.seq_len && kb >= -1 && kb <= fm.seq_len;
  if (ok) {
    occ4(fm, ka, tk);
    occ4(fm, kb, tl);
  }
  int64_t* q = is_back ? ox0 : ox1;  // queried side
  int64_t* o = is_back ? ox1 : ox0;  // co-interval side
  for (int c = 0; c < 4; ++c) {
    q[c] = fm.L2[c] + 1 + tk[c];
    sz[c] = tl[c] - tk[c];
  }
  // the sentinel row precedes symbol 3's slice when it lies in [xq, xq+s)
  o[3] = xo + (xq <= fm.primary && xq + s - 1 >= fm.primary);
  o[2] = o[3] + sz[3];
  o[1] = o[2] + sz[2];
  o[0] = o[1] + sz[1];
  return ok;
}

}  // namespace bwamem_fm
