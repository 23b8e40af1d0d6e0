// Seed chaining and chain filtering (bwa mem_chain + mem_chain_flt) for
// Hopper (sm_90a).
//
// Replaces the JAX device program of bwamem_tpu/ops/chain_tpu.py
// `chain_kernel` (with `_chain_entry` and the packing half of
// `chains_device_batch`).  Its semantics are the host oracle's,
// bwamem_tpu/engine/chain.py `mem_chain`, `_test_and_merge`, `chain_weight`
// and `chain_flt`: per read, each seed (interval by interval, sample by
// sample) gets its contig (bns_intv2rid; seeds that bridge contigs or the
// strand boundary are dropped), is merged into the chain whose key is the
// predecessor of its reference start (bisect_right - 1) or opens a new chain
// inserted after equal keys; chains are weighted by coverage, filtered by
// weight, sorted by weight (stable over key order), shadowed by overlap
// (kept 0-3, first), and trimmed to max_chain_extend.
//
// Design: `chain_kernel` runs a read on the 32 lanes of a warp, on a
// persistent grid; warps take reads from a global counter in the order the
// wrapper gives, the most seeds first, so the heaviest read starts at once
// and the light ones fill the card around it (a read writes only its own
// rows, so the order changes no result).  The JAX program's masked arg-max
// over C slots, one-hot slot writes, S-step weight scan and vectorised
// filter loop are TPU shapes of a bisect, an append, a per-chain walk and a
// `break`; none is carried over.  Per read:
//
// * frac_rep: the intervals 32 at a time, a lane each; every lane runs the
//   recurrence over the ballot of those past max_occ.
// * Seeds are read straight from the flat interval table and the SA walk's
//   output, 32 intervals a window (a lane each, counts scanned by
//   shuffles), 32 seeds a batch: each lane finds its seed's interval by a
//   5-step search of the window's scanned counts, loads its reference start
//   and computes its contig (bns_intv2rid) before the serial merge.  No
//   budget on seeds.
// * The merge walks the batch's seeds in turn.  The keys in key order sit
//   in registers, key position m = 32 c + lane (c < 4 chunks); bisect_right
//   is the popcount of a ballot of key <= rbeg a chunk, the new chain's
//   insertion a shift of the chunks by shuffles.  The chain table is
//   structure-of-arrays in the warp's shared memory, a slot a chain in
//   creation order (8,448 bytes a warp at kMaxC = 128); every lane runs
//   test_and_merge on the same words, lane 0 writes, and weights grow as
//   seeds join (the coverage walk visits a chain's seeds in the order they
//   were appended).
// * The filter: the weight sort as a rank sort (a chain's rank = the chains
//   of greater weight plus those of equal weight earlier in key order,
//   exact and stable); the shadowing walk over sorted chains a with the
//   earlier kept chains j tested by the lanes together, a break at the
//   lowest set bit of the drop ballot, `first` set for every large j up to
//   and including it; the kept = 1 marks; the output walk and the
//   max_chain_extend trim by ballot prefix counts, seed offsets by a
//   shuffle scan.
//
// Comparisons against mask_level and drop_ratio are made in double, as the
// oracle's, and the file is built without --use_fast_math.
//
// Output is sized exactly in two passes around two scans made by the
// caller: `chain_kernel` leaves per read its chain and seed counts, per
// seed its chain slot and per slot where its seeds start in the read's
// output (scratch as large as the seeds, since a read has at most as many
// chains as seeds); `chain_emit_kernel` writes chain_rows [Nc, 7] (rid,
// is_alt, n_seeds, frac_rep bits, w, kept, first) and seed_rows [Ns, 4]
// (rbeg, qbeg, len, score) at the scanned offsets, chains in output order
// and each chain's seeds in enumeration order.  It too runs a warp per
// read, in the same order: a lane a chain row (16-byte stores, the ALT flag
// loaded once a chain), then the seeds 32 at a time, a lane a seed found
// by the same window search; a seed's place is its slot's first place,
// plus the slot's seeds placed by earlier batches (a count per slot in the
// warp's shared memory, advanced once a batch by the slot's highest lane),
// plus its rank among the batch's lanes of that slot (__match_any_sync).
// It writes no scratch, so it can be launched (and timed) alone.
//
// What bounds them: the heaviest read's chain of dependent steps (a seed is
// a few shuffles, one to four ballots and a few shared-memory loads; the
// filter's shadowing walk a few ballots a chain), and on a batch of
// thousands of reads the warps resident a SM (registers and the chain
// table's shared memory); not bytes (a few tens of MB, microseconds at the
// card's memory rate) or operations.  The emit pass is a few dependent
// loads a batch of 32 seeds: its heaviest read is ~6 such batches.
//
// Budget: C chain slots per read (run-time, at most kMaxC).  A read that
// needs more sets its flag and stops; its caller chains it on the host.
// Errors: an interval of a chained read whose seeds lie outside the rbegs
// array, or a negative count, sets bit 1 of *err (caught when its window of
// 32 intervals is loaded); the wrapper raises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // both kernels: a read a warp, 4 warps a block
constexpr int kMaxC = 128;
constexpr int kChunks = kMaxC / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kErrRange = 1;

struct Opts {
  int64_t w, max_chain_gap, min_chain_weight, min_seed_len, max_chain_extend;
  int64_t max_occ;
  double mask_level, drop_ratio;
};

struct Ctg {
  const int64_t* __restrict__ end;  // [n] cumulative contig ends
  const int32_t* __restrict__ alt;  // [n]
  int n;
  int64_t l_pac;
};

// The flat seed table: read i's intervals are rows intv_off[i] ..
// intv_off[i] + n_intv[i] of `rows` [N, 5] (x0, x1, s, qb, qe); interval r
// has cnt[r] seeds, whose reference starts are rbegs[rbeg_off[r] ..].
struct Table {
  const int32_t* __restrict__ qlen;      // [B]
  const int64_t* __restrict__ rows;      // [N, 5]
  const int64_t* __restrict__ intv_off;  // [B]
  const int64_t* __restrict__ n_intv;    // [B]
  const int64_t* __restrict__ rbegs;     // [R]
  const int64_t* __restrict__ rbeg_off;  // [N]
  const int64_t* __restrict__ cnt;       // [N]
  const int64_t* __restrict__ seed_off;  // [B] first scratch entry per read
  int64_t n_rbegs;
  int B;
};

// Number of contig ends <= pos: the contig holding forward position pos.
__device__ __forceinline__ int ctg_of(const Ctg& c, int64_t pos) {
  int lo = 0, hi = c.n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c.end[mid] <= pos)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// bwa bns_intv2rid over the doubled domain: the contig of [rb, re), or -1
// when it bridges two contigs or the strand boundary.
__device__ __forceinline__ int intv2rid(const Ctg& c, int64_t rb, int64_t re) {
  const bool fwd = rb < c.l_pac;
  if (fwd != (re <= c.l_pac)) return -1;
  const int64_t fb = fwd ? rb : 2 * c.l_pac - 1 - (re - 1);
  const int64_t fe = fwd ? re - 1 : 2 * c.l_pac - 1 - rb;
  if (fb < 0 || fe >= c.l_pac) return -1;
  const int rid = ctg_of(c, fb);
  return rid == ctg_of(c, fe) ? rid : -1;
}

// A warp's chain table: a slot a chain, in creation order; r0 is the key.
// `kw` holds the weights in key order for the rank sort (-1: filtered
// out), `srt` the slots in sorted order, `mark` the kept = 1 marks.
struct Slots {
  int64_t r0[kMaxC], rl[kMaxC], endr[kMaxC], wr[kMaxC];
  int32_t crid[kMaxC], q0[kMaxC], qlast[kMaxC], ll[kMaxC], endq[kMaxC];
  int32_t wq[kMaxC], ns[kMaxC], kw[kMaxC];
  uint8_t srt[kMaxC], mark[kMaxC];
};

// v[c] for a warp-uniform c (registers cannot be indexed at run time).
template <class T>
__device__ __forceinline__ T pick(const T (&v)[kChunks], int c) {
  T x = v[0];
#pragma unroll
  for (int k = 1; k < kChunks; ++k)
    if (k == c) x = v[k];
  return x;
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// 32 intervals of a read, an interval a lane (intervals w0 + lane of the
// read's ni from row io): its query start and length, where its seeds
// start in rbegs and how many it has, the window's exclusive scan of those
// counts and their total; `bad` when the interval's seeds lie outside
// rbegs or its count is negative.
struct Window {
  int32_t qb, slen;
  int64_t off, n, excl, total;
  bool bad;
};

__device__ __forceinline__ Window load_window(const Table& tb, int64_t io,
                                              int64_t ni, int64_t w0,
                                              int lane) {
  Window w{0, 0, 0, 0, 0, 0, false};
  const int64_t pi = w0 + lane;
  if (pi < ni) {
    const int64_t* p = tb.rows + (io + pi) * 5;
    w.qb = static_cast<int32_t>(p[3]);
    w.slen = static_cast<int32_t>(p[4] - p[3]);
    w.off = tb.rbeg_off[io + pi];
    w.n = tb.cnt[io + pi];
    w.bad = w.n < 0 || w.off < 0 || w.off + w.n > tb.n_rbegs;
  }
  int64_t inc = w.n;  // inclusive scan of the window's seed counts
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t v = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += v;
  }
  w.excl = inc - w.n;
  w.total = __shfl_sync(kFull, inc, 31);
  return w;
}

// The lane of the window's interval that holds its seed rel: the last k
// with excl[k] <= rel, by a 5-step search over the lanes.
__device__ __forceinline__ int seed_interval(const Window& w, int64_t rel) {
  int k = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const int64_t ek = __shfl_sync(kFull, w.excl, k + step);
    if (ek <= rel) k += step;
  }
  return k;
}

// One read on the 32 lanes of a warp (all lanes call it with the same i).
__device__ void chain_read(const int i, const int lane, Slots& S,
                           const Table& tb, const Ctg& ctg, const Opts& o,
                           const int C, int32_t* __restrict__ assign,
                           int32_t* __restrict__ slot_dst,
                           int32_t* __restrict__ crec,
                           int64_t* __restrict__ n_chain,
                           int64_t* __restrict__ n_seed,
                           double* __restrict__ frac, int32_t* __restrict__ ovf,
                           int32_t* __restrict__ nslots,
                           int32_t* __restrict__ err) {
  const int64_t ql = tb.qlen[i];
  const int64_t io = tb.intv_off[i], ni = tb.n_intv[i];
  const int64_t base = tb.seed_off[i];
  if (lane == 0) {
    n_chain[i] = 0;
    n_seed[i] = 0;
    ovf[i] = 0;
    nslots[i] = 0;
  }

  // frac_rep: the share of the query covered by over-occurring intervals;
  // 32 intervals a round, every lane runs the recurrence on each one
  {
    int64_t b = 0, e = 0, l_rep = 0;
    for (int64_t w0 = 0; w0 < ni; w0 += 32) {
      const int64_t pi = w0 + lane;
      int64_t qb = 0, qe = 0;
      bool rep = false;
      if (pi < ni) {
        const int64_t* p = tb.rows + (io + pi) * 5;
        rep = p[2] > o.max_occ;
        qb = p[3];
        qe = p[4];
      }
      for (unsigned m = __ballot_sync(kFull, rep); m; m &= m - 1) {
        const int k = __ffs(m) - 1;
        const int64_t kb = __shfl_sync(kFull, qb, k);
        const int64_t ke = __shfl_sync(kFull, qe, k);
        if (kb > e) {
          l_rep += e - b;
          b = kb;
          e = ke;
        } else if (ke > e) {
          e = ke;
        }
      }
    }
    l_rep += e - b;
    if (lane == 0)
      frac[i] = ql > 0 ? static_cast<double>(l_rep) / static_cast<double>(ql)
                       : 0.0;
  }
  if (ql < o.min_seed_len) return;

  // ---- mem_chain: greedy merge in enumeration order.  Key position
  // m = 32 c + lane holds the chain's key okey[c] and slot oslot[c].
  int64_t okey[kChunks];
  int oslot[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    okey[c] = 0;
    oslot[c] = 0;
  }
  int nch = 0;
  int64_t tw = 0;  // the window's first seed, in enumeration order
  for (int64_t w0 = 0; w0 < ni; w0 += 32) {
    // 32 intervals a window, an interval a lane
    const Window win = load_window(tb, io, ni, w0, lane);
    if (__any_sync(kFull, win.bad)) {
      if (lane == 0) atomicOr(err, kErrRange);
      return;
    }
    const int64_t wtot = win.total;
    for (int64_t s0 = 0; s0 < wtot; s0 += 32) {
      // seed s0 + lane of the window, and its contig before the serial walk
      const int64_t rel = s0 + lane;
      const int k = seed_interval(win, rel);
      const int32_t sq = __shfl_sync(kFull, win.qb, k);
      const int32_t sl = __shfl_sync(kFull, win.slen, k);
      const int64_t so = __shfl_sync(kFull, win.off, k);
      const int64_t se = __shfl_sync(kFull, win.excl, k);
      int64_t rbeg = 0;
      int rid = -1;
      if (rel < wtot) {
        rbeg = tb.rbegs[so + rel - se];
        rid = intv2rid(ctg, rbeg, rbeg + sl);
      }
      const int nb = wtot - s0 < 32 ? static_cast<int>(wtot - s0) : 32;
      int mine = -1;  // the slot this lane's seed joins
      for (int u = 0; u < nb; ++u) {
        const int prid = __shfl_sync(kFull, rid, u);
        if (prid < 0) continue;
        const int64_t pr = __shfl_sync(kFull, rbeg, u);
        const int32_t pq = __shfl_sync(kFull, sq, u);
        const int32_t pl = __shfl_sync(kFull, sl, u);
        // bisect_right(keys, pr): the keys <= pr, by ballots
        int lo = 0;
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          if (32 * c < nch)
            lo += __popc(__ballot_sync(
                kFull, 32 * c + lane < nch && okey[c] <= pr));
        int s = -1;  // the slot the seed joins
        bool settled = false;
        if (lo > 0) {  // test_and_merge with the predecessor, on every lane
          const int pm = lo - 1;
          const int c = __shfl_sync(kFull, pick(oslot, pm >> 5), pm & 31);
          if (prid == S.crid[c]) {
            const int32_t cq0 = S.q0[c], cql = S.qlast[c], cll = S.ll[c];
            const int64_t cr0 = S.r0[c], crl = S.rl[c];
            if (pq >= cq0 && pq + pl <= cql + cll && pr >= cr0 &&
                pr + pl <= crl + cll) {
              settled = true;  // contained: dropped
            } else if (!((crl < ctg.l_pac || cr0 < ctg.l_pac) &&
                         pr >= ctg.l_pac)) {
              const int64_t x = pq - cql, y = pr - crl;
              if (y >= 0 && x - y <= o.w && y - x <= o.w &&
                  x - cll < o.max_chain_gap && y - cll < o.max_chain_gap) {
                settled = true;
                s = c;
              }
            }
          }
        }
        const bool fresh = !settled;
        if (fresh) {  // a new chain, inserted after equal keys
          if (nch >= C) {
            if (lane == 0) {
              ovf[i] = 1;
              nslots[i] = C + 1;
            }
            return;
          }
          s = nch++;
          // positions >= lo move up one: the old value of position m - 1
          int64_t upk[kChunks], topk[kChunks];
          int ups[kChunks], tops[kChunks];
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            upk[c] = __shfl_up_sync(kFull, okey[c], 1);
            ups[c] = __shfl_up_sync(kFull, oslot[c], 1);
            topk[c] = __shfl_sync(kFull, okey[c], 31);
            tops[c] = __shfl_sync(kFull, oslot[c], 31);
          }
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int m = 32 * c + lane;
            if (m == lo) {
              okey[c] = pr;
              oslot[c] = s;
            } else if (m > lo) {
              okey[c] = lane ? upk[c] : (c ? topk[c - 1] : 0);
              oslot[c] = lane ? ups[c] : (c ? tops[c - 1] : 0);
            }
          }
        }
        if (lane == u) mine = s;
        if (s >= 0) {
          // the seed joins s: mem_chain_weight, one seed at a time
          int32_t eq0 = 0, wq0 = 0, ns0 = 0;
          int64_t er0 = 0, wr0 = 0;
          if (!fresh) {
            eq0 = S.endq[s];
            wq0 = S.wq[s];
            ns0 = S.ns[s];
            er0 = S.endr[s];
            wr0 = S.wr[s];
          }
          const int32_t eq = pq + pl, bq = eq0 > pq ? eq0 : pq;
          const int64_t er = pr + pl, br = er0 > pr ? er0 : pr;
          if (lane == 0) {
            if (fresh) {
              S.crid[s] = prid;
              S.q0[s] = pq;
              S.r0[s] = pr;
            }
            S.qlast[s] = pq;
            S.rl[s] = pr;
            S.ll[s] = pl;
            S.ns[s] = ns0 + 1;
            S.wq[s] = eq > bq ? wq0 + (eq - bq) : wq0;
            S.endq[s] = eq > eq0 ? eq : eq0;
            S.wr[s] = er > br ? wr0 + (er - br) : wr0;
            S.endr[s] = er > er0 ? er : er0;
          }
        }
        __syncwarp();
      }
      if (rel < wtot) assign[base + tw + rel] = mine;
    }
    tw += wtot;
  }
  if (lane == 0) nslots[i] = nch;

  // ---- mem_chain_flt: weights in key order, then a rank sort (weight
  // descending, key order on ties) into `srt`
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int m = 32 * c + lane;
    if (m < nch) {
      const int s = oslot[c];
      int64_t wt = S.wq[s] < S.wr[s] ? S.wq[s] : S.wr[s];
      if (wt > (int64_t{1} << 30) - 1) wt = (int64_t{1} << 30) - 1;
      S.wq[s] = static_cast<int32_t>(wt);  // the chain's weight from here on
      S.kw[m] = wt >= o.min_chain_weight ? static_cast<int32_t>(wt) : -1;
      slot_dst[base + s] = -1;
    }
  }
  __syncwarp();
  int na = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int m = 32 * c + lane;
    const int wm = m < nch ? S.kw[m] : -1;
    int rank = 0;
    for (int m2 = 0; m2 < nch; ++m2) {
      const int w2 = S.kw[m2];
      rank += w2 > wm || (w2 == wm && m2 < m);
    }
    if (wm >= 0) S.srt[rank] = static_cast<uint8_t>(oslot[c]);
    na += __popc(__ballot_sync(kFull, wm >= 0));
  }
  __syncwarp();
  if (na == 0) return;

  // overlap shadowing, in sorted space: sorted position j = 32 c + lane
  int32_t jq0[kChunks], jqe[kChunks], jw[kChunks];
  int jslot[kChunks], kept[kChunks], first[kChunks];
  bool jalt[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = 32 * c + lane;
    jslot[c] = j < na ? S.srt[j] : 0;
    const int s = jslot[c];
    jq0[c] = S.q0[s];
    jqe[c] = S.qlast[s] + S.ll[s];
    jw[c] = S.wq[s];
    jalt[c] = j < na && ctg.alt[S.crid[s]] != 0;
    kept[c] = j == 0 ? 3 : 0;
    first[c] = -1;
  }
  for (int a = 1; a < na; ++a) {
    const int ca = a >> 5, la = a & 31;
    const int32_t qbi = __shfl_sync(kFull, pick(jq0, ca), la);
    const int32_t qei = __shfl_sync(kFull, pick(jqe, ca), la);
    const int32_t wi = __shfl_sync(kFull, pick(jw, ca), la);
    const bool alt_i = __shfl_sync(kFull, static_cast<int>(pick(jalt, ca)), la);
    const int32_t li = qei - qbi;
    unsigned big[kChunks];
    int jb = kMaxC;  // the first j that breaks, if any
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      big[c] = 0;
      if (32 * c < a) {
        const int j = 32 * c + lane;
        bool bg = false, drop = false;
        if (j < a && kept[c] != 0) {
          const int32_t b_max = jq0[c] > qbi ? jq0[c] : qbi;
          const int32_t e_min = jqe[c] < qei ? jqe[c] : qei;
          if (e_min > b_max && !(jalt[c] && !alt_i)) {
            const int32_t lj = jqe[c] - jq0[c], min_l = li < lj ? li : lj;
            bg = static_cast<double>(e_min - b_max) >=
                     static_cast<double>(min_l) * o.mask_level &&
                 min_l < o.max_chain_gap;
            drop = bg &&
                   static_cast<double>(wi) <
                       static_cast<double>(jw[c]) * o.drop_ratio &&
                   jw[c] - wi >= (o.min_seed_len << 1);
          }
        }
        big[c] = __ballot_sync(kFull, bg);
        const unsigned dm = __ballot_sync(kFull, drop);
        if (dm && jb == kMaxC) jb = 32 * c + __ffs(dm) - 1;
      }
    }
    // the serial walk sets first[j] for each large j up to the break,
    // that j included
    bool large = false;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = 32 * c + lane;
      if (j <= jb && (big[c] >> lane & 1u) && first[c] < 0) first[c] = a;
      large |= big[c] != 0;
    }
    if (jb == kMaxC && lane == la) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        if (c == ca) kept[c] = large ? 2 : 3;
    }
  }
  // the first shadowed chain of each kept chain is retained (kept = 1)
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (32 * c + lane < na) S.mark[32 * c + lane] = 0;
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (32 * c + lane < na && kept[c] >= 2 && first[c] >= 0)
      S.mark[first[c]] = 1;
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (32 * c + lane < na && kept[c] == 0 && S.mark[32 * c + lane])
      kept[c] = 1;

  // ---- the output walk with the max_chain_extend trim, by ballot scans
  int64_t n_ext = 0;
  int nout = 0;
  int32_t seedpos = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (32 * c >= na) break;
    const int j = 32 * c + lane;
    const bool ext = j < na && kept[c] >= 2;
    const unsigned em = __ballot_sync(kFull, ext);
    const int64_t ext_n = n_ext + __popc(em & lanes_below(lane)) + 1;
    const bool emit =
        j < na && kept[c] > 0 && !(ext && ext_n > o.max_chain_extend);
    const unsigned om = __ballot_sync(kFull, emit);
    const int32_t nsj = emit ? S.ns[jslot[c]] : 0;
    int32_t inc = nsj;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t v = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += v;
    }
    if (emit) {
      const int s = jslot[c];
      int32_t* r = crec + (base + nout + __popc(om & lanes_below(lane))) * 5;
      r[0] = S.crid[s];
      r[1] = nsj;
      r[2] = jw[c];
      r[3] = kept[c];
      r[4] = first[c];
      slot_dst[base + s] = seedpos + inc - nsj;
    }
    n_ext += __popc(em);
    nout += __popc(om);
    seedpos += __shfl_sync(kFull, inc, 31);
  }
  if (lane == 0) {
    n_chain[i] = nout;
    n_seed[i] = seedpos;
  }
}

// A warp per read, on a persistent grid: warps take reads in `order` (the
// most seeds first) from a global counter until none is left.
__global__ void __launch_bounds__(32 * kWarps) chain_kernel(
    Table tb, Ctg ctg, Opts o, int C,
    const int32_t* __restrict__ order,  // [B] reads, heaviest first
    int32_t* __restrict__ next,         // [1] the next position of order
    int32_t* __restrict__ assign,    // [T] seed -> slot, -1 dropped
    int32_t* __restrict__ slot_dst,  // [T] slot -> first seed in the output
    int32_t* __restrict__ crec,      // [T, 5] rid, n_seeds, w, kept, first
    int64_t* __restrict__ n_chain,   // [B]
    int64_t* __restrict__ n_seed,    // [B]
    double* __restrict__ frac,       // [B]
    int32_t* __restrict__ ovf,       // [B]
    int32_t* __restrict__ nslots,    // [B] slots used; C + 1 when flagged
    int32_t* __restrict__ err) {
  __shared__ Slots slots[kWarps];
  const int lane = threadIdx.x & 31;
  Slots& S = slots[threadIdx.x >> 5];
  for (;;) {
    int r = 0;
    if (lane == 0) r = atomicAdd(next, 1);
    r = __shfl_sync(kFull, r, 0);
    if (r >= tb.B) break;
    chain_read(order[r], lane, S, tb, ctg, o, C, assign, slot_dst, crec,
               n_chain, n_seed, frac, ovf, nslots, err);
    __syncwarp();
  }
}

// A chain row's 7 int64 at a (8-byte aligned) in 16-byte stores: three
// pairs and a single, the single first when a is not 16-byte aligned.
__device__ __forceinline__ void store_row7(int64_t* a, const int64_t (&v)[7]) {
  if ((reinterpret_cast<uintptr_t>(a) & 15u) == 0) {
    longlong2* p = reinterpret_cast<longlong2*>(a);
    p[0] = make_longlong2(v[0], v[1]);
    p[1] = make_longlong2(v[2], v[3]);
    p[2] = make_longlong2(v[4], v[5]);
    a[6] = v[6];
  } else {
    a[0] = v[0];
    longlong2* p = reinterpret_cast<longlong2*>(a + 1);
    p[0] = make_longlong2(v[1], v[2]);
    p[1] = make_longlong2(v[3], v[4]);
    p[2] = make_longlong2(v[5], v[6]);
  }
}

// One read's rows on the 32 lanes of a warp (all lanes call it with the
// same i).  `placed` is the warp's per-slot count of seeds written.
__device__ void emit_read(const int i, const int lane,
                          int32_t* __restrict__ placed, const Table& tb,
                          const Ctg& ctg, const int32_t* __restrict__ assign,
                          const int32_t* __restrict__ slot_dst,
                          const int32_t* __restrict__ crec,
                          const int64_t* __restrict__ n_chain,
                          const double* __restrict__ frac,
                          const int64_t* __restrict__ chain_off,
                          const int64_t* __restrict__ seed_dst,
                          int64_t* __restrict__ chain_rows,
                          int64_t* __restrict__ seed_rows) {
  const int64_t nout = n_chain[i];
  if (nout == 0) return;
  const int64_t base = tb.seed_off[i];
  const int64_t frac_bits = __double_as_longlong(frac[i]);
  // chain rows, a lane a chain
  const int64_t c0 = chain_off[i];
  for (int64_t j = lane; j < nout; j += 32) {
    const int32_t* r = crec + (base + j) * 5;
    const int32_t rid = r[0];
    const int64_t row[7] = {rid, ctg.alt[rid], r[1], frac_bits, r[2], r[3],
                            r[4]};
    store_row7(chain_rows + (c0 + j) * 7, row);
  }
  for (int s = lane; s < kMaxC; s += 32) placed[s] = 0;
  __syncwarp();
  // the seeds in enumeration order, 32 a batch, a lane a seed: its place is
  // its slot's first place, plus the slot's seeds placed by earlier
  // batches, plus its rank among this batch's lanes of the same slot
  const int64_t io = tb.intv_off[i], ni = tb.n_intv[i];
  int64_t* out = seed_rows + seed_dst[i] * 4;
  int64_t tw = 0;  // the window's first seed, in enumeration order
  for (int64_t w0 = 0; w0 < ni; w0 += 32) {
    const Window win = load_window(tb, io, ni, w0, lane);
    for (int64_t s0 = 0; s0 < win.total; s0 += 32) {
      const int64_t rel = s0 + lane;
      const int k = seed_interval(win, rel);
      const int32_t sq = __shfl_sync(kFull, win.qb, k);
      const int32_t sl = __shfl_sync(kFull, win.slen, k);
      const int64_t so = __shfl_sync(kFull, win.off, k);
      const int64_t se = __shfl_sync(kFull, win.excl, k);
      int32_t s = -1, d = -1;
      int64_t rbeg = 0;
      if (rel < win.total) {
        rbeg = tb.rbegs[so + rel - se];
        s = assign[base + tw + rel];
        if (s >= 0) d = slot_dst[base + s];  // -1: the chain was dropped
      }
      const bool live = s >= 0 && d >= 0;
      const unsigned same = __match_any_sync(kFull, live ? s : -1);
      const int32_t before = live ? placed[s] : 0;
      __syncwarp();
      if (live) {
        // the slot's highest lane advances its count, once a batch
        if (lane == 31 - __clz(same)) placed[s] = before + __popc(same);
        const int64_t at = d + before + __popc(same & lanes_below(lane));
        longlong2* sr = reinterpret_cast<longlong2*>(out + at * 4);
        sr[0] = make_longlong2(rbeg, sq);
        sr[1] = make_longlong2(sl, sl);
      }
      __syncwarp();
    }
    tw += win.total;
  }
}

// The emit pass: chain_rows [Nc, 7] and seed_rows [Ns, 4] at the scanned
// offsets, a warp per read on a persistent grid, warps taking reads in
// `order` from a global counter as chain_kernel does.  It reads
// chain_kernel's scratch and writes only its outputs, so two launches on
// the same operands give the same rows.
__global__ void __launch_bounds__(32 * kWarps) chain_emit_kernel(
    Table tb, Ctg ctg, const int32_t* __restrict__ order,
    int32_t* __restrict__ next, const int32_t* __restrict__ assign,
    const int32_t* __restrict__ slot_dst, const int32_t* __restrict__ crec,
    const int64_t* __restrict__ n_chain, const double* __restrict__ frac,
    const int64_t* __restrict__ chain_off,  // [B] exclusive scan of n_chain
    const int64_t* __restrict__ seed_dst,   // [B] exclusive scan of n_seed
    int64_t* __restrict__ chain_rows,       // [Nc, 7]
    int64_t* __restrict__ seed_rows) {      // [Ns, 4]
  __shared__ int32_t placed[kWarps][kMaxC];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  for (;;) {
    int r = 0;
    if (lane == 0) r = atomicAdd(next, 1);
    r = __shfl_sync(kFull, r, 0);
    if (r >= tb.B) break;
    emit_read(order[r], lane, placed[wid], tb, ctg, assign, slot_dst, crec,
              n_chain, frac, chain_off, seed_dst, chain_rows, seed_rows);
    __syncwarp();
  }
}

// A persistent grid of `kernel`: as many 4-warp blocks as fit on the card
// at once, or as the B reads need.
template <class K>
unsigned persistent_blocks(K kernel, int B) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kWarps,
                                                0);
  const int64_t need = (static_cast<int64_t>(B) + kWarps - 1) / kWarps;
  const int64_t fit = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  return static_cast<unsigned>(need < fit ? need : fit);
}

}  // namespace

// Launchers: device pointers and a stream in, cudaGetLastError() out.

extern "C" int bwamem_chain_launch(
    const int32_t* qlen, const int64_t* rows, const int64_t* intv_off,
    const int64_t* n_intv, const int64_t* rbegs, const int64_t* rbeg_off,
    const int64_t* cnt, const int64_t* seed_off, int64_t n_rbegs, int B,
    const int64_t* ctg_end, const int32_t* ctg_alt, int n_ctg, int64_t l_pac,
    int64_t w, int64_t max_chain_gap, int64_t min_chain_weight,
    int64_t min_seed_len, int64_t max_chain_extend, int64_t max_occ,
    double mask_level, double drop_ratio, int C, const int32_t* order,
    int32_t* next, int32_t* assign, int32_t* slot_dst, int32_t* crec,
    int64_t* n_chain, int64_t* n_seed, double* frac, int32_t* ovf,
    int32_t* nslots, int32_t* err, cudaStream_t stream) {
  if (C < 1 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  const Table tb{qlen, rows, intv_off, n_intv, rbegs, rbeg_off, cnt, seed_off,
                 n_rbegs, B};
  const Ctg ctg{ctg_end, ctg_alt, n_ctg, l_pac};
  const Opts o{w, max_chain_gap, min_chain_weight, min_seed_len,
               max_chain_extend, max_occ, mask_level, drop_ratio};
  const cudaError_t rc = cudaMemsetAsync(next, 0, sizeof(int32_t), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  chain_kernel<<<persistent_blocks(chain_kernel, B), 32 * kWarps, 0,
                 stream>>>(tb, ctg, o, C, order, next, assign, slot_dst, crec,
                           n_chain, n_seed, frac, ovf, nslots, err);
  return static_cast<int>(cudaGetLastError());
}

// Warps of chain_kernel resident on one SM (the occupancy calculator's
// figure); -1 on error.
extern "C" int bwamem_chain_warps_per_sm() {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_kernel,
                                                    32 * kWarps, 0) !=
      cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return per_sm * kWarps;
}

extern "C" int bwamem_chain_emit_launch(
    const int32_t* qlen, const int64_t* rows, const int64_t* intv_off,
    const int64_t* n_intv, const int64_t* rbegs, const int64_t* rbeg_off,
    const int64_t* cnt, const int64_t* seed_off, int64_t n_rbegs, int B,
    const int64_t* ctg_end, const int32_t* ctg_alt, int n_ctg, int64_t l_pac,
    const int32_t* order, int32_t* next, const int32_t* assign,
    const int32_t* slot_dst, const int32_t* crec, const int64_t* n_chain,
    const double* frac, const int64_t* chain_off, const int64_t* seed_dst,
    int64_t* chain_rows, int64_t* seed_rows, cudaStream_t stream) {
  if (B <= 0) return 0;
  const Table tb{qlen, rows, intv_off, n_intv, rbegs, rbeg_off, cnt, seed_off,
                 n_rbegs, B};
  const Ctg ctg{ctg_end, ctg_alt, n_ctg, l_pac};
  const cudaError_t rc = cudaMemsetAsync(next, 0, sizeof(int32_t), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  chain_emit_kernel<<<persistent_blocks(chain_emit_kernel, B), 32 * kWarps, 0,
                      stream>>>(tb, ctg, order, next, assign, slot_dst, crec,
                                n_chain, frac, chain_off, seed_dst, chain_rows,
                                seed_rows);
  return static_cast<int>(cudaGetLastError());
}
