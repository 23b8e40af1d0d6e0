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
//
// Two forms of the index, a template parameter of every function and
// kernel that reads it (class F): `Fm`, one line table and one sampled SA,
// and `FmShards`, the idx-sharded tables of bwamem_tpu/ops/fmindex_tpu.py
// `sharded_tables` (D12): shard s holds the lines [s * blocks_per_shard,
// (s + 1) * blocks_per_shard) and the SA samples [s * sa_per_shard, ...)
// as separate allocations, on one card or several (peer access).  A fetch
// takes its row from the shard that owns it, so the result is the
// unsharded one bit for bit; the JAX package's gather-and-psum merge is a
// TPU workaround (a program cannot load another chip's memory) and is not
// carried over.  The shard's pointer is picked by selects from kernel
// arguments and its index by compares with each shard's first row, so
// `Fm`'s instantiation is the unsharded code as it was.

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

  __device__ __forceinline__ const uint32_t* line(int64_t li) const {
    return lines + li * W;
  }
};

constexpr int kMaxShards = 8;

struct FmShards {
  const uint32_t* lines[kMaxShards];  // shard s: lines [s * bps, (s+1) * bps)
  const int64_t* sa[kMaxShards];      // shard s: samples [s * sps, ...)
  const int64_t* __restrict__ L2;     // [5]
  int64_t primary;
  int64_t seq_len;
  int W;
  int lg;
  int n_shards;
  int64_t bps;  // blocks (lines) a shard
  int64_t sps;  // SA samples a shard
  // the first line and sample of each shard (INT64_MAX past n_shards)
  int64_t line0[kMaxShards];
  int64_t sa0[kMaxShards];

  // the shard that owns item i of a table whose shards start at `first`
  __device__ __forceinline__ int owner(int64_t i,
                                       const int64_t (&first)[kMaxShards]) const {
    int s = 0;
#pragma unroll
    for (int j = 1; j < kMaxShards; ++j) s += i >= first[j];
    return s;
  }
  template <class T>
  __device__ __forceinline__ const T* pick(const T* const (&p)[kMaxShards],
                                           int s) const {
    const T* x = p[0];
#pragma unroll
    for (int j = 1; j < kMaxShards; ++j) x = s == j ? p[j] : x;
    return x;
  }
  __device__ __forceinline__ const uint32_t* line(int64_t li) const {
    const int s = owner(li, line0);
    return pick(lines, s) + (li - s * bps) * W;
  }
  __device__ __forceinline__ int64_t sa_at(int64_t i) const {
    const int s = owner(i, sa0);
    return __ldg(pick(sa, s) + (i - s * sps));
  }
};

// The shard table of the launchers: n_shards (1..kMaxShards) pointers to
// each shard's lines and, when sa_ptrs is not null, its SA samples.
// Returns false for a shard count out of range.
inline bool make_fm_shards(const uint64_t* line_ptrs, const uint64_t* sa_ptrs,
                           int n_shards, int64_t bps, int64_t sps, int W,
                           int lg, const int64_t* L2, int64_t primary,
                           int64_t seq_len, FmShards* fm) {
  if (n_shards < 1 || n_shards > kMaxShards) return false;
  for (int s = 0; s < kMaxShards; ++s) {
    const int t = s < n_shards ? s : n_shards - 1;
    fm->lines[s] = reinterpret_cast<const uint32_t*>(line_ptrs[t]);
    fm->sa[s] = sa_ptrs ? reinterpret_cast<const int64_t*>(sa_ptrs[t])
                        : nullptr;
    fm->line0[s] = s < n_shards ? s * bps : INT64_MAX;
    fm->sa0[s] = s < n_shards ? s * sps : INT64_MAX;
  }
  fm->L2 = L2;
  fm->primary = primary;
  fm->seq_len = seq_len;
  fm->W = W;
  fm->lg = lg;
  fm->n_shards = n_shards;
  fm->bps = bps;
  fm->sps = sps;
  return true;
}

// SA sample i: sa[i] for the one table, the owning shard's otherwise.
__device__ __forceinline__ int64_t sa_sample(const Fm&, const int64_t* sa,
                                             int64_t i) {
  return sa[i];
}
__device__ __forceinline__ int64_t sa_sample(const FmShards& fm,
                                             const int64_t*, int64_t i) {
  return fm.sa_at(i);
}

// The line holding row k, and the chars of it counted through k
// (inclusive).  k = -1 reads line 0, which the callers mask.
template <class F>
__device__ __forceinline__ const uint32_t* fm_line(const F& fm, int64_t k,
                                                   int* within) {
  int64_t kk = k - (k >= fm.primary);
  if (kk < 0) kk = 0;
  *within = static_cast<int>(kk & ((int64_t{1} << fm.lg) - 1)) + 1;
  return fm.line(kk >> fm.lg);
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

// bwa bwt_occ4: counts of each symbol among conceptual chars [0..k];
// k == -1 -> 0, k == seq_len -> the full counts.
template <class F>
__device__ __forceinline__ void occ4(const F& fm, int64_t k, int cnt[4]) {
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

// ---- the SA walk's LF step: one fetch of the whole line a step.
//
// A line of span 64 (NV - 1) chars is NV 16-byte vectors: the four counts,
// then (NV - 1) * 4 char words.  The lines are 16-byte aligned (W = 4 NV
// u32, the table's base checked by the wrapper), so a step issues NV
// read-only vector loads together and decodes the char, its count and the
// popcounts from registers, with selects and masks: no second dependent
// load, no loop whose bound depends on the data.

__host__ __device__ constexpr int ilog2(int x) {
  return x > 1 ? 1 + ilog2(x / 2) : 0;
}

// The four cumulative counts L2[0..3] in registers (kernel arguments).
struct L2Regs {
  int64_t c0, c1, c2, c3;
};

template <class T>
__device__ __forceinline__ T pick4(T a0, T a1, T a2, T a3, int c) {
  T x = a0;
  x = c == 1 ? a1 : x;
  x = c == 2 ? a2 : x;
  x = c == 3 ? a3 : x;
  return x;
}

// The NV vectors of line li, loaded together (ld.global.nc.v4).
template <int NV>
__device__ __forceinline__ void fetch_line(const uint32_t* __restrict__ lines,
                                           int64_t li, uint4 (&v)[NV]) {
  const uint4* p = reinterpret_cast<const uint4*>(lines) + li * NV;
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = __ldg(p + j);
}

// Line li of the index as NV vectors: `fetch_line` on the one table, on
// the owning shard's otherwise.
template <int NV>
__device__ __forceinline__ void fetch_fm_line(const Fm& fm, int64_t li,
                                              uint4 (&v)[NV]) {
  fetch_line<NV>(fm.lines, li, v);
}
template <int NV>
__device__ __forceinline__ void fetch_fm_line(const FmShards& fm, int64_t li,
                                              uint4 (&v)[NV]) {
  const int s = fm.owner(li, fm.line0);
  fetch_line<NV>(fm.pick(fm.lines, s), li - s * fm.bps, v);
}

// One LF step (bwa bwt_invPsi) on lines of NV vectors.  Row k lies in
// [0, seq_len]; the primary row steps to row 0.  The within-line offsets
// are 32-bit; k and the line index stay 64-bit (genomes pass 2^31 rows).
template <int NV, class F>
__device__ __forceinline__ int64_t lf_line(const F& fm, const L2Regs& l2,
                                           int64_t k) {
  constexpr int kWords = 4 * (NV - 1);
  constexpr int kSpan = 16 * kWords;
  constexpr int kLg = ilog2(kSpan);
  static_assert((1 << kLg) == kSpan, "a line spans a power of two of chars");
  int64_t kk = k - (k >= fm.primary);
  kk = kk < 0 ? 0 : kk;
  uint4 v[NV];
  fetch_fm_line<NV>(fm, kk >> kLg, v);
  const int pos = static_cast<int>(kk) & (kSpan - 1);  // the char's offset
  uint32_t w[kWords];
#pragma unroll
  for (int j = 0; j < NV - 1; ++j) {
    w[4 * j] = v[j + 1].x;
    w[4 * j + 1] = v[j + 1].y;
    w[4 * j + 2] = v[j + 1].z;
    w[4 * j + 3] = v[j + 1].w;
  }
  // the char at pos: its word by selects, then its two bits
  const int wi = pos >> 4;
  uint32_t x = w[0];
#pragma unroll
  for (int j = 1; j < kWords; ++j) x = j == wi ? w[j] : x;
  const int c = (x >> (30 - 2 * (pos & 15))) & 3;
  // the count of c among chars [0, pos]: whole words before wi, the first
  // pos % 16 + 1 chars of word wi (a shift of 0..30), none after
  const uint32_t fh = (c & 2) ? 0u : kM55, fl = (c & 1) ? 0u : kM55;
  const uint32_t last = (0xFFFFFFFFu << (30 - 2 * (pos & 15))) & kM55;
  int n = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint32_t keep = j < wi ? kM55 : (j == wi ? last : 0u);
    const uint32_t hi = ((w[j] >> 1) & kM55) ^ fh, lo = (w[j] & kM55) ^ fl;
    n += __popc(hi & lo & keep);
  }
  const int base = static_cast<int>(pick4(v[0].x, v[0].y, v[0].z, v[0].w, c));
  const int64_t nk = pick4(l2.c0, l2.c1, l2.c2, l2.c3, c) + (base + n);
  return k == fm.primary ? 0 : nk;
}

// bwa bwt_extend of the bi-interval (x0, x1, s), backward (is_back) or
// forward: ox0, ox1 and sz indexed by queried-space symbol, as the host
// oracle's FMIndex.extend.  Two rank queries, one line each.  Returns
// false (and counts of 0) when a queried row lies outside [-1, seq_len].
template <class F>
__device__ __forceinline__ bool bwt_extend(const F& fm, int64_t x0,
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

// The four counts of one char word among a line's first nchars chars,
// packed two to a u32 (16-bit fields: a line's count of a symbol is at most
// its span, 512 at most here).
__device__ __forceinline__ void count4_packed(uint32_t x, uint32_t keep,
                                              uint32_t* c01, uint32_t* c23) {
  const uint32_t hi = (x >> 1) & kM55, lo = x & kM55;
  const uint32_t nhi = hi ^ kM55, nlo = lo ^ kM55;
  *c01 += __popc(nhi & nlo & keep) | (__popc(nhi & lo & keep) << 16);
  *c23 += __popc(hi & nlo & keep) | (__popc(hi & lo & keep) << 16);
}

// bwt_extend on the 32 lanes of a warp: the same contract as `bwt_extend`,
// every lane calling it with the same interval and getting the same result.
// The two rank queries (rows ka and kb) are one round of loads: lane l reads
// char word l of the words of both lines laid end to end (one line when ka
// and kb share it; lanes loop when there are more than 32 words) and every
// lane reads the two lines' four counts (broadcasts), so the query costs
// one memory latency instead of two chains of word loads.  The per-lane
// counts are packed two to a u32 and summed by four warp reductions.
template <class F>
__device__ __forceinline__ bool bwt_extend_warp(const F& fm, int64_t x0,
                                                int64_t x1, int64_t s,
                                                bool is_back, int64_t ox0[4],
                                                int64_t ox1[4], int sz[4]) {
  const int lane = threadIdx.x & 31;
  const int64_t xq = is_back ? x0 : x1;
  const int64_t xo = is_back ? x1 : x0;
  const int64_t ka = xq - 1, kb = xq - 1 + s;
  int tk[4] = {0, 0, 0, 0}, tl[4] = {0, 0, 0, 0};
  const bool ok = ka >= -1 && ka <= fm.seq_len && kb >= -1 && kb <= fm.seq_len;
  if (ok) {
    // rows -1 and seq_len need no line: no counts, and the full counts
    const bool need_a = ka != -1 && ka != fm.seq_len;
    const bool need_b = kb != -1 && kb != fm.seq_len;
    int wa = 0, wb = 0;
    const uint32_t* la = need_a ? fm_line(fm, ka, &wa) : nullptr;
    const uint32_t* lb = need_b ? fm_line(fm, kb, &wb) : nullptr;
    const bool two = need_a && need_b && la != lb;
    const uint32_t* l0 = need_a ? la : lb;
    const int nw = fm.W - 4;
    const int total = need_a || need_b ? (two ? 2 * nw : nw) : 0;
    uint32_t a01 = 0, a23 = 0, b01 = 0, b23 = 0;
    for (int w0 = 0; w0 < total; w0 += 32) {
      const int idx = w0 + lane;
      if (idx < total) {
        const bool second = two && idx >= nw;
        const int w = second ? idx - nw : idx;
        const uint32_t x = (second ? lb : l0)[4 + w];
        if (need_a && !second) count4_packed(x, keep_mask(wa, w), &a01, &a23);
        if (need_b && (second || !two))
          count4_packed(x, keep_mask(wb, w), &b01, &b23);
      }
    }
    a01 = __reduce_add_sync(0xffffffffu, a01);
    a23 = __reduce_add_sync(0xffffffffu, a23);
    b01 = __reduce_add_sync(0xffffffffu, b01);
    b23 = __reduce_add_sync(0xffffffffu, b23);
    const uint32_t pa[4] = {a01 & 0xffffu, a01 >> 16, a23 & 0xffffu, a23 >> 16};
    const uint32_t pb[4] = {b01 & 0xffffu, b01 >> 16, b23 & 0xffffu, b23 >> 16};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int full = static_cast<int>(fm.L2[c + 1] - fm.L2[c]);
      tk[c] = need_a ? static_cast<int>(la[c] + pa[c]) : (ka == -1 ? 0 : full);
      tl[c] = need_b ? static_cast<int>(lb[c] + pb[c]) : (kb == -1 ? 0 : full);
    }
  }
  int64_t* q = is_back ? ox0 : ox1;  // queried side
  int64_t* o = is_back ? ox1 : ox0;  // co-interval side
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    q[c] = fm.L2[c] + 1 + tk[c];
    sz[c] = tl[c] - tk[c];
  }
  o[3] = xo + (xq <= fm.primary && xq + s - 1 >= fm.primary);
  o[2] = o[3] + sz[3];
  o[1] = o[2] + sz[2];
  o[0] = o[1] + sz[1];
  return ok;
}

}  // namespace bwamem_fm
