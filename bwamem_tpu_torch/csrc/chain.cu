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
// Design: one thread per read, a sequential state machine as the oracle
// writes it.  The JAX program's masked arg-max over C slots, one-hot slot
// writes, S-step weight scan over all slots and vectorised filter loop are
// TPU shapes of a bisect, an append, a per-chain walk and a `break`; none is
// carried over.  A read's seeds are read straight from the flat interval
// table and the SA walk's output in global memory, so there is no budget on
// seeds.  The chain table is real arrays of up to kMaxC slots in local
// memory, in creation order, with a byte index kept sorted by key; chain
// weights are accumulated as seeds are appended (the coverage walk visits a
// chain's seeds in the order they were appended).  The filter's weight sort
// is a stable insertion sort over the key order.  Comparisons against
// mask_level and drop_ratio are made in double, as the oracle's, and the
// file is built without --use_fast_math.
//
// Output is sized exactly in two passes around two scans made by the
// caller: `chain_kernel` leaves per read its chain and seed counts, per
// seed its chain slot and per slot where its seeds start in the read's
// output (scratch as large as the seeds, since a read has at most as many
// chains as seeds); `chain_emit_kernel` writes chain_rows [Nc, 7] (rid,
// is_alt, n_seeds, frac_rep bits, w, kept, first) and seed_rows [Ns, 4]
// (rbeg, qbeg, len, score) at the scanned offsets, chains in output order
// and each chain's seeds in enumeration order.
//
// What bounds it: the longest read's sequential walk.  A thread reads about
// 16 bytes per seed and writes 36; a 12,000-read batch moves a few tens of
// megabytes, microseconds at the card's memory rate, while the read with the
// most seeds walks them one after another with a binary search each, and a
// warp runs as long as its slowest read.
//
// Budget: C chain slots per read (run-time, at most kMaxC).  A read that
// needs more sets its flag and stops; its caller chains it on the host.
// Errors: an interval whose seeds lie outside the rbegs array, or a negative
// count, sets bit 1 of *err; the wrapper raises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxC = 128;
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

__global__ void __launch_bounds__(kThreads) chain_kernel(
    Table tb, Ctg ctg, Opts o, int C,
    int32_t* __restrict__ assign,    // [T] seed -> slot, -1 dropped
    int32_t* __restrict__ slot_dst,  // [T] slot -> first seed in the output
    int32_t* __restrict__ crec,      // [T, 5] rid, n_seeds, w, kept, first
    int64_t* __restrict__ n_chain,   // [B]
    int64_t* __restrict__ n_seed,    // [B]
    double* __restrict__ frac,       // [B]
    int32_t* __restrict__ ovf,       // [B]
    int32_t* __restrict__ nslots,    // [B] slots used; C + 1 when flagged
    int32_t* __restrict__ err) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= tb.B) return;
  const int64_t ql = tb.qlen[i];
  const int64_t io = tb.intv_off[i], ni = tb.n_intv[i];
  const int64_t base = tb.seed_off[i];
  n_chain[i] = 0;
  n_seed[i] = 0;
  ovf[i] = 0;
  nslots[i] = 0;

  // frac_rep: the share of the query covered by over-occurring intervals
  {
    int64_t b = 0, e = 0, l_rep = 0;
    for (int64_t pi = 0; pi < ni; ++pi) {
      const int64_t* p = tb.rows + (io + pi) * 5;
      if (p[2] <= o.max_occ) continue;
      if (p[3] > e) {
        l_rep += e - b;
        b = p[3];
        e = p[4];
      } else if (p[4] > e) {
        e = p[4];
      }
    }
    l_rep += e - b;
    frac[i] = ql > 0 ? static_cast<double>(l_rep) / static_cast<double>(ql)
                     : 0.0;
  }
  if (ql < o.min_seed_len) return;

  // chain table, slots in creation order; r0 is the chain's key
  int64_t r0[kMaxC], rl[kMaxC], endr[kMaxC], wr[kMaxC];
  int32_t crid[kMaxC], q0[kMaxC], qlast[kMaxC], ll[kMaxC], endq[kMaxC];
  int32_t wq[kMaxC], ns[kMaxC];
  uint8_t ord[kMaxC];  // slots sorted by key, equal keys in creation order
  int nch = 0;

  // ---- mem_chain: greedy merge in enumeration order
  int64_t t = 0;
  for (int64_t pi = 0; pi < ni; ++pi) {
    const int64_t* p = tb.rows + (io + pi) * 5;
    const int32_t qb = static_cast<int32_t>(p[3]);
    const int32_t slen = static_cast<int32_t>(p[4] - p[3]);
    const int64_t off = tb.rbeg_off[io + pi], n = tb.cnt[io + pi];
    if (n < 0 || off < 0 || off + n > tb.n_rbegs) {
      atomicOr(err, kErrRange);
      return;
    }
    for (int64_t ri = 0; ri < n; ++ri, ++t) {
      const int64_t rbeg = tb.rbegs[off + ri];
      const int rid = intv2rid(ctg, rbeg, rbeg + slen);
      if (rid < 0) {
        assign[base + t] = -1;
        continue;
      }
      // bisect_right(keys, rbeg)
      int lo = 0, hi = nch;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (r0[ord[mid]] <= rbeg)
          lo = mid + 1;
        else
          hi = mid;
      }
      int s = -1;  // the slot the seed joins
      bool settled = false;
      if (lo > 0) {  // test_and_merge with the predecessor
        const int c = ord[lo - 1];
        if (rid == crid[c]) {
          if (qb >= q0[c] && qb + slen <= qlast[c] + ll[c] && rbeg >= r0[c] &&
              rbeg + slen <= rl[c] + ll[c]) {
            settled = true;  // contained: dropped
          } else if (!((rl[c] < ctg.l_pac || r0[c] < ctg.l_pac) &&
                       rbeg >= ctg.l_pac)) {
            const int64_t x = qb - qlast[c], y = rbeg - rl[c];
            if (y >= 0 && x - y <= o.w && y - x <= o.w &&
                x - ll[c] < o.max_chain_gap && y - ll[c] < o.max_chain_gap) {
              settled = true;
              s = c;
            }
          }
        }
      }
      if (!settled) {  // a new chain, inserted after equal keys
        if (nch >= C) {
          ovf[i] = 1;
          nslots[i] = C + 1;
          return;
        }
        s = nch++;
        for (int m = s; m > lo; --m) ord[m] = ord[m - 1];
        ord[lo] = static_cast<uint8_t>(s);
        crid[s] = rid;
        q0[s] = qb;
        r0[s] = rbeg;
        endq[s] = 0;
        wq[s] = 0;
        endr[s] = 0;
        wr[s] = 0;
        ns[s] = 0;
      }
      assign[base + t] = s;
      if (s >= 0) {
        qlast[s] = qb;
        rl[s] = rbeg;
        ll[s] = slen;
        ++ns[s];
        // mem_chain_weight, one seed at a time
        const int32_t eq = qb + slen;
        const int32_t bq = endq[s] > qb ? endq[s] : qb;
        if (eq > bq) wq[s] += eq - bq;
        if (eq > endq[s]) endq[s] = eq;
        const int64_t er = rbeg + slen;
        const int64_t br = endr[s] > rbeg ? endr[s] : rbeg;
        if (er > br) wr[s] += er - br;
        if (er > endr[s]) endr[s] = er;
      }
    }
  }
  nslots[i] = nch;

  // ---- mem_chain_flt: weights, the weight sort over key order
  uint8_t srt[kMaxC];
  int na = 0;
  for (int m = 0; m < nch; ++m) {
    const int s = ord[m];
    int64_t wt = wq[s] < wr[s] ? wq[s] : wr[s];
    if (wt > (int64_t{1} << 30) - 1) wt = (int64_t{1} << 30) - 1;
    wq[s] = static_cast<int32_t>(wt);  // the chain's weight from here on
    slot_dst[base + s] = -1;
    if (wt < o.min_chain_weight) continue;
    int k = na++;
    while (k > 0 && wq[srt[k - 1]] < wt) {
      srt[k] = srt[k - 1];
      --k;
    }
    srt[k] = static_cast<uint8_t>(s);
  }
  if (na == 0) return;

  // overlap shadowing, in sorted space
  int8_t kept[kMaxC];
  int16_t first[kMaxC];
  for (int j = 0; j < na; ++j) {
    kept[j] = 0;
    first[j] = -1;
  }
  kept[0] = 3;
  for (int a = 1; a < na; ++a) {
    const int si = srt[a];
    const int32_t qbi = q0[si], qei = qlast[si] + ll[si], li = qei - qbi;
    const bool alt_i = ctg.alt[crid[si]] != 0;
    const int32_t wi = wq[si];
    bool large = false, broke = false;
    for (int j = 0; j < a; ++j) {
      if (kept[j] == 0) continue;
      const int sj = srt[j];
      const int32_t qbj = q0[sj], qej = qlast[sj] + ll[sj];
      const int32_t b_max = qbj > qbi ? qbj : qbi;
      const int32_t e_min = qej < qei ? qej : qei;
      if (e_min <= b_max || (ctg.alt[crid[sj]] != 0 && !alt_i)) continue;
      const int32_t lj = qej - qbj, min_l = li < lj ? li : lj;
      if (static_cast<double>(e_min - b_max) >=
              static_cast<double>(min_l) * o.mask_level &&
          min_l < o.max_chain_gap) {
        large = true;
        if (first[j] < 0) first[j] = static_cast<int16_t>(a);
        const int32_t wj = wq[sj];
        if (static_cast<double>(wi) < static_cast<double>(wj) * o.drop_ratio &&
            wj - wi >= (o.min_seed_len << 1)) {
          broke = true;
          break;
        }
      }
    }
    if (!broke) kept[a] = large ? 2 : 3;
  }
  // the first shadowed chain of each kept chain is retained (kept = 1)
  for (int j = 0; j < na; ++j)
    if (kept[j] >= 2 && first[j] >= 0 && kept[first[j]] < 1)
      kept[first[j]] = 1;

  // ---- the output walk with the max_chain_extend trim
  int64_t n_ext = 0;
  int nout = 0;
  int32_t seedpos = 0;
  for (int j = 0; j < na; ++j) {
    if (kept[j] == 0) continue;
    if (kept[j] >= 2 && ++n_ext > o.max_chain_extend) continue;
    const int s = srt[j];
    int32_t* r = crec + (base + nout) * 5;
    r[0] = crid[s];
    r[1] = ns[s];
    r[2] = wq[s];
    r[3] = kept[j];
    r[4] = first[j];
    slot_dst[base + s] = seedpos;
    seedpos += ns[s];
    ++nout;
  }
  n_chain[i] = nout;
  n_seed[i] = seedpos;
}

__global__ void __launch_bounds__(kThreads) chain_emit_kernel(
    Table tb, Ctg ctg, const int32_t* __restrict__ assign,
    int32_t* __restrict__ slot_dst, const int32_t* __restrict__ crec,
    const int64_t* __restrict__ n_chain, const double* __restrict__ frac,
    const int64_t* __restrict__ chain_off,  // [B] exclusive scan of n_chain
    const int64_t* __restrict__ seed_dst,   // [B] exclusive scan of n_seed
    int64_t* __restrict__ chain_rows,       // [Nc, 7]
    int64_t* __restrict__ seed_rows) {      // [Ns, 4]
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= tb.B) return;
  const int64_t nout = n_chain[i];
  if (nout == 0) return;
  const int64_t base = tb.seed_off[i];
  const int64_t frac_bits = __double_as_longlong(frac[i]);
  for (int64_t j = 0; j < nout; ++j) {
    const int32_t* r = crec + (base + j) * 5;
    int64_t* c = chain_rows + (chain_off[i] + j) * 7;
    c[0] = r[0];
    c[1] = ctg.alt[r[0]];
    c[2] = r[1];
    c[3] = frac_bits;
    c[4] = r[2];
    c[5] = r[3];
    c[6] = r[4];
  }
  // the seeds again in enumeration order, each to its chain's next place
  const int64_t io = tb.intv_off[i], ni = tb.n_intv[i];
  int64_t* out = seed_rows + seed_dst[i] * 4;
  int64_t t = 0;
  for (int64_t pi = 0; pi < ni; ++pi) {
    const int64_t* p = tb.rows + (io + pi) * 5;
    const int64_t qb = p[3], slen = p[4] - p[3];
    const int64_t off = tb.rbeg_off[io + pi], n = tb.cnt[io + pi];
    for (int64_t ri = 0; ri < n; ++ri, ++t) {
      const int32_t s = assign[base + t];
      if (s < 0) continue;
      const int32_t d = slot_dst[base + s];
      if (d < 0) continue;
      slot_dst[base + s] = d + 1;
      int64_t* sr = out + static_cast<int64_t>(d) * 4;
      sr[0] = tb.rbegs[off + ri];
      sr[1] = qb;
      sr[2] = slen;
      sr[3] = slen;
    }
  }
}

unsigned blocks(int n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
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
    double mask_level, double drop_ratio, int C, int32_t* assign,
    int32_t* slot_dst, int32_t* crec, int64_t* n_chain, int64_t* n_seed,
    double* frac, int32_t* ovf, int32_t* nslots, int32_t* err,
    cudaStream_t stream) {
  if (C < 1 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const Table tb{qlen, rows, intv_off, n_intv, rbegs, rbeg_off, cnt, seed_off,
                 n_rbegs, B};
  const Ctg ctg{ctg_end, ctg_alt, n_ctg, l_pac};
  const Opts o{w, max_chain_gap, min_chain_weight, min_seed_len,
               max_chain_extend, max_occ, mask_level, drop_ratio};
  chain_kernel<<<blocks(B), kThreads, 0, stream>>>(
      tb, ctg, o, C, assign, slot_dst, crec, n_chain, n_seed, frac, ovf,
      nslots, err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bwamem_chain_emit_launch(
    const int32_t* qlen, const int64_t* rows, const int64_t* intv_off,
    const int64_t* n_intv, const int64_t* rbegs, const int64_t* rbeg_off,
    const int64_t* cnt, const int64_t* seed_off, int64_t n_rbegs, int B,
    const int64_t* ctg_end, const int32_t* ctg_alt, int n_ctg, int64_t l_pac,
    const int32_t* assign, int32_t* slot_dst, const int32_t* crec,
    const int64_t* n_chain, const double* frac, const int64_t* chain_off,
    const int64_t* seed_dst, int64_t* chain_rows, int64_t* seed_rows,
    cudaStream_t stream) {
  const Table tb{qlen, rows, intv_off, n_intv, rbegs, rbeg_off, cnt, seed_off,
                 n_rbegs, B};
  const Ctg ctg{ctg_end, ctg_alt, n_ctg, l_pac};
  chain_emit_kernel<<<blocks(B), kThreads, 0, stream>>>(
      tb, ctg, assign, slot_dst, crec, n_chain, frac, chain_off, seed_dst,
      chain_rows, seed_rows);
  return static_cast<int>(cudaGetLastError());
}
