// Full native per-read pipeline tail: dedup/patch -> ALT flagging ->
// primary marking -> (PE: pestat/pairing/mate rescue) -> final records.
//
// This is the mem_process_seqs-equivalent host runtime ([EXT] bwamem.c
// worker1/worker2, bwamem_pair.c mem_sam_pe; anchored in-tree at
// jnibwa.c:214).  Every routine is a line-faithful port of its validated
// python oracle in engine/{finalize,pair,pipeline}.py — those remain the
// semantic source of truth; tests/test_native_tail.py asserts record-level
// equality between this path and the oracle path.
//
// Build: compiled standalone into libbwamem_pipeline.so; includes the
// chain/extend core and the SW kernels by source so the hot routines stay
// single-source (see ksw.cpp / align_core.cpp).
//
// This copy (bwamem_tpu_torch) differs from bwamem_tpu's in two places.
// The body of bwamem_pipeline_batch is split at its phase boundary: all
// after phase 1's chain2aln (the Reg -> RegT copy, sort_dedup_patch,
// flag_alt_regs, pestat, phase 2 and the record rows) is one function,
// pipeline_tail, which bwamem_pipeline_batch calls after its own phase 1.
// A second entry, bwamem_tail_batch, is the port's own, composed of two
// entries of the reference: it takes regions in bwamem_align_regs_batch's
// 11-column row layout (align_core.cpp) and hands them to the same
// pipeline_tail, so that regions made on the card go through the
// reference's own dedup, pairing and record code.  And both entries
// hand back what the batch's ALT-aware mapping did (counts_out, the AC_*
// enum), tallied per thread; the records are the reference's either way.

#include "ksw.cpp"        // ksw_global_one, gen_cigar2_one + C ABI twins
#include "align_core.cpp" // Opts, Bns, Chain, build_chains, chain2aln

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <string_view>
#include <unordered_set>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace tail {

// ------------------------------------------------------------- option pack
enum {
  OI_W = 0, OI_MAX_CHAIN_GAP, OI_MIN_CHAIN_WEIGHT, OI_MIN_SEED_LEN,
  OI_MAX_CHAIN_EXTEND, OI_MAX_OCC, OI_O_DEL, OI_E_DEL, OI_O_INS, OI_E_INS,
  OI_ZDROP, OI_PEN_CLIP5, OI_PEN_CLIP3, OI_A, OI_B, OI_PEN_UNPAIRED, OI_T,
  OI_MAX_MATESW, OI_MAX_INS, OI_FLAG, OI_MAX_XA_HITS, OI_MAX_XA_HITS_ALT,
  OI_MAPQ_COEF_FAC, OI_N
};
enum {
  OF_MASK_LEVEL = 0, OF_DROP_RATIO, OF_XA_DROP_RATIO, OF_MASK_LEVEL_REDUN,
  OF_MAPQ_COEF_LEN, OF_N
};
// MEM_F_* bits (api/options.py / BwaMemAligner.java:76-84)
constexpr int64_t F_PE = 0x2, F_NOPAIRING = 0x4, F_ALL = 0x8,
                  F_NO_MULTI = 0x10, F_NO_RESCUE = 0x20, F_SOFTCLIP = 0x200,
                  F_PRIMARY5 = 0x800;

struct FullOpt {
  const int64_t* I;
  const double* F;
  const int8_t* mat;
  int64_t i(int k) const { return I[k]; }
  double f(int k) const { return F[k]; }
};

constexpr int64_t SECONDARY_INT_MAX = (1LL << 31) - 1;

// [EXT] hash_64 (engine/finalize.py::hash_64)
static inline uint64_t hash_64(uint64_t key) {
  key = key + ~(key << 32);
  key ^= key >> 22;
  key = key + ~(key << 13);
  key ^= key >> 8;
  key = key + (key << 3);
  key ^= key >> 15;
  key = key + ~(key << 27);
  key ^= key >> 31;
  return key;
}

// --------------------------------------------------------- region (full)
struct RegT {
  int64_t rb = 0, re = 0, qb = 0, qe = 0, rid = -1;
  int64_t score = 0, truesc = 0, w = 0, seedcov = 0, seedlen0 = 0;
  double frac_rep = 0.0;
  int64_t sub = 0, csub = 0, sub_n = 0, alt_sc = 0, n_comp = 1;
  int64_t secondary = -1, secondary_all = -1;
  int32_t is_alt = 0;
  uint64_t hash = 0;
};

// one output record (engine/finalize.py::Aln)
struct RecT {
  int64_t pos = -1, rid = -1, flag = 0;
  int32_t is_rev = 0, is_alt = 0;
  int64_t mapq = 0, NM = -1, score = 0, sub = -1, alt_sc = 0;
  std::vector<uint32_t> cigar;  // len<<4|op, MIDSH coding
  std::string md;
  std::string xa;
  bool has_xa = false;
};

// What one batch's ALT-aware mapping did, handed back by both entries in
// counts_out (AC_* order, native_pipeline.py mirrors it).  The regions, the
// pair ends and the XA time are kept per thread in its Scratch and summed by
// pipeline_tail; the two counts of records are read off the records.
enum {
  AC_REGIONS = 0,         // regions the extension returned (before dedup)
  AC_ALT_REGIONS,         // ... of them on an ALT contig
  AC_ALT_READS,           // reads with at least one of those
  AC_ALT_SC_PRIMARIES,    // primary records with alt_sc > 0
  AC_ALT_XA_ENTRIES,      // XA entries of the records that name an ALT contig
  AC_ALT_PAIR_PRIMARY_ENDS,  // ends of a proper pair whose best ALT hit
                             // stays primary (bwa's paired 0x800 branch)
  AC_ALT_XA_NS,           // thread-ns of gen_alt_xa for reads with an ALT hit
  AC_N
};

struct Scratch {
  std::vector<uint8_t> qtmp, rtmp, zbuf;
  std::vector<int64_t> ehbuf;
  std::vector<uint32_t> cig;
  std::vector<uint8_t> md;
  int64_t alt[AC_N] = {};
};

// gen_cigar2 via the shared core, into scratch buffers
static void gen_cigar2_s(const FullOpt& o, const Bns& bns, int64_t w_,
                         const uint8_t* q, int64_t lq, int64_t rb, int64_t re,
                         Scratch& s, int32_t* score, int32_t* n_cig,
                         int32_t* nm, int32_t* n_md) {
  int64_t cap = lq + std::max(re - rb, (int64_t)0) + 4;
  if ((int64_t)s.cig.size() < cap) s.cig.resize(cap);
  if ((int64_t)s.md.size() < 2 * cap + 32) s.md.resize(2 * cap + 32);
  gen_cigar2_one(q, lq, rb, re, bns.fwd, bns.l_pac, o.mat, (int32_t)o.i(OI_O_DEL),
                 (int32_t)o.i(OI_E_DEL), (int32_t)o.i(OI_O_INS),
                 (int32_t)o.i(OI_E_INS), w_, s.cig.data(), n_cig, s.md.data(),
                 n_md, score, nm, s.qtmp, s.rtmp, s.zbuf, s.ehbuf);
}

// ------------------------------------------------- sort_dedup_patch + alt

// [EXT] mem_patch_reg (engine/finalize.py::_patch_reg)
static int64_t patch_reg(const FullOpt& o, const Bns& bns, const uint8_t* query,
                         const RegT& a, const RegT& b, int64_t* w_out,
                         Scratch& s) {
  if (a.rb < bns.l_pac && bns.l_pac <= b.rb) return 0;
  if (a.qb >= b.qb || a.qe >= b.qe || a.re >= b.re) return 0;  // not colinear
  int64_t w = std::llabs((a.re - b.rb) - (a.qe - b.qb));
  double r = std::fabs((double)(a.re - b.rb) / (double)(b.re - a.rb) -
                       (double)(a.qe - b.qb) / (double)(b.qe - a.qb));
  if (a.re < b.rb || a.qe < b.qb) {  // no overlap
    if (w > o.i(OI_W) << 1 || r >= 0.05) return 0;
  } else if (w > o.i(OI_W) << 2 || r >= 0.05 * 2.0) {
    return 0;
  }
  w += std::max(a.w, b.w);
  w = std::min(w, o.i(OI_W) << 2);
  int32_t score = 0, n_cig = 0, nm = 0, n_md = 0;
  gen_cigar2_s(o, bns, w, query + a.qb, b.qe - a.qb, a.rb, b.re, s, &score,
               &n_cig, &nm, &n_md);
  int64_t q_s = (int64_t)((double)(b.qe - a.qb) /
                              (double)((b.qe - b.qb) + (a.qe - a.qb)) *
                              (double)(b.score + a.score) +
                          0.499);
  int64_t r_s = (int64_t)((double)(b.re - a.rb) /
                              (double)((b.re - b.rb) + (a.re - a.rb)) *
                              (double)(b.score + a.score) +
                          0.499);
  if ((double)score / (double)std::max(q_s, r_s) < 0.90) return 0;
  *w_out = w;
  return score;
}

// [EXT] mem_sort_dedup_patch (engine/finalize.py::sort_dedup_patch)
static void sort_dedup_patch(const FullOpt& o, const Bns& bns,
                             const uint8_t* query, std::vector<RegT>& regs,
                             Scratch& s) {
  if (regs.size() <= 1) {
    for (auto& r : regs) r.n_comp = 1;
    return;
  }
  std::stable_sort(regs.begin(), regs.end(),
                   [](const RegT& x, const RegT& y) { return x.re < y.re; });
  for (auto& r : regs) r.n_comp = 1;
  const double redun = o.f(OF_MASK_LEVEL_REDUN);
  for (int64_t i = 1; i < (int64_t)regs.size(); ++i) {
    RegT* p = &regs[i];
    if (p->rid != regs[i - 1].rid ||
        p->rb >= regs[i - 1].re + o.i(OI_MAX_CHAIN_GAP))
      continue;
    for (int64_t j = i - 1; j >= 0 && p->rid == regs[j].rid &&
                            p->rb < regs[j].re + o.i(OI_MAX_CHAIN_GAP);
         --j) {
      RegT* q = &regs[j];
      if (q->qe == q->qb) continue;  // excluded
      int64_t o_r = q->re - p->rb;
      int64_t o_q = q->qb < p->qb ? q->qe - p->qb : p->qe - q->qb;
      int64_t m_r = std::min(q->re - q->rb, p->re - p->rb);
      int64_t m_q = std::min(q->qe - q->qb, p->qe - p->qb);
      if ((double)o_r > (double)m_r * redun &&
          (double)o_q > (double)m_q * redun) {
        if (p->score < q->score) {
          p->qe = p->qb;
          break;
        } else {
          q->qe = q->qb;
        }
      } else if (q->rb < p->rb) {
        int64_t w = 0;
        int64_t score = patch_reg(o, bns, query, *q, *p, &w, s);
        if (score > 0) {
          p->n_comp += q->n_comp + 1;
          p->seedcov = std::max(p->seedcov, q->seedcov);
          p->sub = std::max(p->sub, q->sub);
          p->csub = std::max(p->csub, q->csub);
          p->qb = q->qb;
          p->rb = q->rb;
          p->truesc = p->score = score;
          p->w = w;
          q->qe = q->qb;
        }
      }
    }
  }
  std::vector<RegT> kept;
  kept.reserve(regs.size());
  for (auto& r : regs)
    if (r.qe > r.qb) kept.push_back(r);
  // mem_ars: score desc, then rb asc, then qb asc (stable python sort)
  std::stable_sort(kept.begin(), kept.end(), [](const RegT& x, const RegT& y) {
    if (x.score != y.score) return x.score > y.score;
    if (x.rb != y.rb) return x.rb < y.rb;
    return x.qb < y.qb;
  });
  for (size_t i = 1; i < kept.size(); ++i) {
    if (kept[i].score == kept[i - 1].score && kept[i].rb == kept[i - 1].rb &&
        kept[i].qb == kept[i - 1].qb)
      kept[i].qe = kept[i].qb;
  }
  regs.clear();
  for (size_t i = 0; i < kept.size(); ++i)
    if (i == 0 || kept[i].qe > kept[i].qb) regs.push_back(kept[i]);
}

// mem_align1_core tail (engine/pipeline.py::_flag_alt_regs)
static void flag_alt_regs(const Bns& bns, std::vector<RegT>& regs) {
  for (auto& r : regs)
    if (r.rid >= 0 && bns.is_alt && bns.is_alt[r.rid]) r.is_alt = 1;
}

// ------------------------------------------------------- primary marking

// [EXT] mem_mark_primary_se_core (engine/finalize.py::_mark_primary_core)
static void mark_primary_core(const FullOpt& o, RegT* regs, int64_t n) {
  int64_t tmp = std::max(o.i(OI_A) + o.i(OI_B),
                         std::max(o.i(OI_O_DEL) + o.i(OI_E_DEL),
                                  o.i(OI_O_INS) + o.i(OI_E_INS)));
  std::vector<int64_t> z{0};
  for (int64_t i = 1; i < n; ++i) {
    int64_t found = -1;
    for (int64_t k : z) {
      int64_t b_max = std::max(regs[k].qb, regs[i].qb);
      int64_t e_min = std::min(regs[k].qe, regs[i].qe);
      if (e_min > b_max) {
        int64_t min_l = std::min(regs[i].qe - regs[i].qb,
                                 regs[k].qe - regs[k].qb);
        if ((double)(e_min - b_max) >= (double)min_l * o.f(OF_MASK_LEVEL)) {
          if (regs[k].sub == 0) regs[k].sub = regs[i].score;
          if (regs[k].score - regs[i].score <= tmp &&
              (regs[k].is_alt || !regs[i].is_alt))
            ++regs[k].sub_n;
          found = k;
          break;
        }
      }
    }
    if (found < 0)
      z.push_back(i);
    else
      regs[i].secondary = found;
  }
}

// [EXT] mem_mark_primary_se (engine/finalize.py::mark_primary_se)
static int64_t mark_primary_se(const FullOpt& o, std::vector<RegT>& regs,
                               int64_t read_id) {
  if (regs.empty()) return 0;
  int64_t n = (int64_t)regs.size(), n_pri = 0;
  for (int64_t i = 0; i < n; ++i) {
    RegT& r = regs[i];
    r.sub = r.alt_sc = 0;
    r.sub_n = 0;
    r.secondary = r.secondary_all = -1;
    r.hash = hash_64((uint64_t)(read_id + i));
    if (!r.is_alt) ++n_pri;
  }
  std::sort(regs.begin(), regs.end(), [](const RegT& x, const RegT& y) {
    if (x.score != y.score) return x.score > y.score;      // mem_ars_hash
    if (x.is_alt != y.is_alt) return x.is_alt < y.is_alt;
    return x.hash < y.hash;
  });
  mark_primary_core(o, regs.data(), n);
  for (int64_t i = 0; i < n; ++i) {
    RegT& r = regs[i];
    r.secondary_all = i;  // keep the rank in the first round
    if (!r.is_alt && r.secondary >= 0 && regs[r.secondary].is_alt)
      r.alt_sc = regs[r.secondary].score;
  }
  if (n_pri < n) {  // ALT hits present
    if (n_pri > 0)
      std::sort(regs.begin(), regs.end(), [](const RegT& x, const RegT& y) {
        if (x.is_alt != y.is_alt) return x.is_alt < y.is_alt;  // mem_ars_hash2
        if (x.score != y.score) return x.score > y.score;
        return x.hash < y.hash;
      });
    std::vector<int64_t> z(n);
    for (int64_t i = 0; i < n; ++i) z[regs[i].secondary_all] = i;
    for (auto& r : regs) {
      if (r.secondary >= 0) {
        r.secondary_all = z[r.secondary];
        if (r.is_alt) r.secondary = SECONDARY_INT_MAX;
      } else {
        r.secondary_all = -1;
      }
    }
    if (n_pri > 0) {
      for (int64_t i = 0; i < n_pri; ++i) {
        regs[i].sub = 0;
        regs[i].secondary = -1;
      }
      mark_primary_core(o, regs.data(), n_pri);
    }
  } else {
    for (auto& r : regs) r.secondary_all = r.secondary;
  }
  return n_pri;
}

// [EXT] mem_reorder_primary5 (engine/finalize.py::reorder_primary5)
static void reorder_primary5(int64_t T, std::vector<RegT>& regs) {
  int64_t n_pri = 0;
  for (auto& r : regs)
    if (r.secondary < 0 && !r.is_alt && r.score >= T) ++n_pri;
  if (n_pri <= 1) return;
  int64_t left_st = (int64_t)1 << 62, left_k = -1;
  for (int64_t k = 0; k < (int64_t)regs.size(); ++k) {
    RegT& r = regs[k];
    if (r.secondary >= 0 || r.is_alt || r.score < T) continue;
    if (r.qb < left_st) {
      left_st = r.qb;
      left_k = k;
    }
  }
  if (left_k > 0) {
    std::swap(regs[0], regs[left_k]);
    for (auto& r : regs) {
      if (r.secondary == left_k)
        r.secondary = 0;
      else if (r.secondary == 0)
        r.secondary = left_k;
      if (r.secondary_all == left_k)
        r.secondary_all = 0;
      else if (r.secondary_all == 0)
        r.secondary_all = left_k;
    }
  }
}

// ----------------------------------------------------------- mapq / aln

// [EXT] mem_approx_mapq_se (engine/finalize.py::approx_mapq_se)
static int64_t approx_mapq_se(const FullOpt& o, const RegT& a) {
  int64_t sub = a.sub ? a.sub : o.i(OI_MIN_SEED_LEN) * o.i(OI_A);
  sub = std::max(a.csub, sub);
  if (sub >= a.score) return 0;
  int64_t length = std::max(a.qe - a.qb, a.re - a.rb);
  double identity =
      1.0 - (double)(length * o.i(OI_A) - a.score) /
                (double)(o.i(OI_A) + o.i(OI_B)) / (double)length;
  int64_t mapq;
  if (a.score == 0) {
    mapq = 0;
  } else if (o.f(OF_MAPQ_COEF_LEN) > 0) {
    double tmp = (double)length < o.f(OF_MAPQ_COEF_LEN)
                     ? 1.0
                     : (double)o.i(OI_MAPQ_COEF_FAC) / std::log((double)length);
    tmp *= identity * identity;
    mapq = (int64_t)(6.02 * (double)(a.score - sub) / (double)o.i(OI_A) * tmp *
                         tmp +
                     0.499);
  } else {
    mapq = (int64_t)(30.0 * (1.0 - (double)sub / (double)a.score) *
                         std::log((double)a.seedcov) +
                     0.499);
  }
  if (a.sub_n > 0)
    mapq -= (int64_t)(4.343 * std::log((double)a.sub_n + 1.0) + 0.499);
  mapq = std::min(mapq, (int64_t)60);
  mapq = std::max(mapq, (int64_t)0);
  return (int64_t)((double)mapq * (1.0 - a.frac_rep) + 0.499);
}

// [EXT] infer_bw (engine/finalize.py::infer_bw)
static int64_t infer_bw(int64_t l1, int64_t l2, int64_t score, int64_t a,
                        int64_t q, int64_t r) {
  if (l1 == l2 && l1 * a - score < (q + r - a) << 1) return 0;
  int64_t w = (int64_t)((double)(std::min(l1, l2) * a - score - q) / (double)r +
                        2.0);
  return std::max(w, (int64_t)std::llabs(l1 - l2));
}

// [EXT] mem_reg2aln (engine/finalize.py::reg2aln)
static RecT reg2aln(const FullOpt& o, const Bns& bns, int64_t qlen,
                    const uint8_t* query, const RegT* ar, Scratch& s) {
  RecT a;
  if (ar == nullptr || ar->rb < 0 || ar->re < 0) {
    a.rid = -1;
    a.pos = -1;
    a.flag |= 0x4;
    return a;
  }
  int64_t qb = ar->qb, qe = ar->qe, rb = ar->rb, re = ar->re;
  a.mapq = ar->secondary < 0 ? approx_mapq_se(o, *ar) : 0;
  if (ar->secondary >= 0) a.flag |= 0x100;
  int64_t w2 = std::max(
      infer_bw(qe - qb, re - rb, ar->truesc, o.i(OI_A), o.i(OI_O_DEL),
               o.i(OI_E_DEL)),
      infer_bw(qe - qb, re - rb, ar->truesc, o.i(OI_A), o.i(OI_O_INS),
               o.i(OI_E_INS)));
  if (w2 > o.i(OI_W)) w2 = std::min(w2, ar->w);
  int64_t last_sc = -(1LL << 30);
  int32_t score = 0, n_cig = 0, nm = -1, n_md = 0;
  for (int tries = 0;;) {
    w2 = std::min(w2, o.i(OI_W) << 2);
    gen_cigar2_s(o, bns, w2, query + qb, qe - qb, rb, re, s, &score, &n_cig,
                 &nm, &n_md);
    if (score == last_sc || w2 == o.i(OI_W) << 2) break;
    last_sc = score;
    w2 <<= 1;
    ++tries;
    if (!(tries < 3 && score < ar->truesc - o.i(OI_A))) break;
  }
  a.NM = nm;
  a.md.assign((const char*)s.md.data(), (size_t)n_md);
  int64_t dp = rb < bns.l_pac ? rb : re - 1;
  int32_t is_rev = dp >= bns.l_pac;
  int64_t pos = is_rev ? (bns.l_pac << 1) - 1 - dp : dp;
  a.is_rev = is_rev;
  std::vector<uint32_t> cigar(s.cig.begin(), s.cig.begin() + n_cig);
  if (!cigar.empty()) {  // squeeze leading/trailing deletions
    if ((cigar.front() & 0xf) == 2) {
      pos += cigar.front() >> 4;
      cigar.erase(cigar.begin());
    } else if ((cigar.back() & 0xf) == 2) {
      cigar.pop_back();
    }
  }
  if (qb != 0 || qe != qlen) {  // soft clips (op 3 in MIDSH coding)
    int64_t clip5 = is_rev ? qlen - qe : qb;
    int64_t clip3 = is_rev ? qb : qlen - qe;
    if (clip5) cigar.insert(cigar.begin(), ((uint32_t)clip5 << 4) | 3);
    if (clip3) cigar.push_back(((uint32_t)clip3 << 4) | 3);
  }
  a.cigar = std::move(cigar);
  a.rid = bns.pos_to_rid(pos);
  a.pos = pos - bns.off[a.rid];
  a.score = ar->score;
  a.sub = std::max(ar->sub, ar->csub);
  a.is_alt = ar->is_alt;
  a.alt_sc = ar->alt_sc;
  return a;
}

// ------------------------------------------------------------ XA strings

struct Names {
  const char* buf;
  const int64_t* off;  // n+1 offsets
};

static void append_i64(std::string& s, int64_t v) {
  char tmp[24];
  std::snprintf(tmp, sizeof tmp, "%lld", (long long)v);
  s += tmp;
}

// NATIVE_PROF sub-phase accumulators (ns); zeroed per batch, printed with
// the phase laps when BWAMEM_TPU_NATIVE_PROF=1
static std::atomic<long long> g_ns_matesw{0}, g_ns_xa{0}, g_ns_rec{0};
static std::atomic<long long> g_ns_chain{0}, g_ns_ext{0}, g_ns_dedup{0};
static bool g_prof_enabled = false;

struct SubTimer {
  std::atomic<long long>* acc;
  std::chrono::steady_clock::time_point t0;
  explicit SubTimer(std::atomic<long long>& a) : acc(nullptr) {
    if (g_prof_enabled) {
      acc = &a;
      t0 = std::chrono::steady_clock::now();
    }
  }
  ~SubTimer() {
    if (acc)
      *acc += std::chrono::duration_cast<std::chrono::nanoseconds>(
                  std::chrono::steady_clock::now() - t0)
                  .count();
  }
};

// Adds the steady clock's ns over its scope to *acc; reads no clock where
// acc is null.
struct NsTimer {
  int64_t* acc;
  std::chrono::steady_clock::time_point t0;
  explicit NsTimer(int64_t* a) : acc(a) {
    if (acc) t0 = std::chrono::steady_clock::now();
  }
  ~NsTimer() {
    if (acc)
      *acc += std::chrono::duration_cast<std::chrono::nanoseconds>(
                  std::chrono::steady_clock::now() - t0)
                  .count();
  }
};

// whether any of a read's regions lies on an ALT contig
static bool alt_hit(const std::vector<RegT>& regs) {
  return std::any_of(regs.begin(), regs.end(),
                     [](const RegT& r) { return r.is_alt != 0; });
}

// [EXT] mem_gen_alt (engine/pipeline.py::gen_alt_xa); xa[k] empty -> None
static void gen_alt_xa(const FullOpt& o, const Bns& bns, const Names& nm,
                       std::vector<RegT>& regs, int64_t qlen,
                       const uint8_t* query, std::vector<std::string>& xa,
                       Scratch& s) {
  int64_t n = (int64_t)regs.size();
  NsTimer timer(alt_hit(regs) ? &s.alt[AC_ALT_XA_NS] : nullptr);
  xa.assign(n, std::string());
  auto pri_idx = [&](int64_t i) -> int64_t {
    int64_t k = regs[i].secondary_all;
    if (k >= 0 &&
        (double)regs[i].score >= (double)regs[k].score * o.f(OF_XA_DROP_RATIO))
      return k;
    return -1;
  };
  std::vector<int64_t> cnt(n, 0);
  std::vector<uint8_t> has_alt(n, 0);
  int64_t tot = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = pri_idx(i);
    if (r >= 0) {
      ++cnt[r];
      ++tot;
      if (regs[i].is_alt) has_alt[r] = 1;
    }
  }
  if (tot == 0) return;
  static const char OPS[] = "MIDSH";
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = pri_idx(i);
    if (r < 0) continue;
    if (cnt[r] > o.i(OI_MAX_XA_HITS_ALT) ||
        (!has_alt[r] && cnt[r] > o.i(OI_MAX_XA_HITS)))
      continue;
    RecT t = reg2aln(o, bns, qlen, query, &regs[i], s);
    std::string& out = xa[r];
    out.append(nm.buf + nm.off[t.rid], nm.buf + nm.off[t.rid + 1]);
    out += ',';
    out += t.is_rev ? '-' : '+';
    append_i64(out, t.pos + 1);
    out += ',';
    for (uint32_t op : t.cigar) {
      append_i64(out, op >> 4);
      out += OPS[op & 0xf];
    }
    out += ',';
    append_i64(out, t.NM);
    out += ';';
  }
}

// mem_aln2sam flag fixes (engine/pipeline.py::_fix_flags)
static void fix_flags(RecT& p, const RecT* m) {
  if (m != nullptr) p.flag |= 0x1;
  if (p.rid < 0) p.flag |= 0x4;
  if (m != nullptr && m->rid < 0) p.flag |= 0x8;
  if (p.rid < 0 && m != nullptr && m->rid >= 0) {
    p.rid = m->rid;
    p.pos = m->pos;
    p.is_rev = m->is_rev;
    p.cigar.clear();
  }
  if (p.is_rev) p.flag |= 0x10;
  if (m != nullptr && m->is_rev) p.flag |= 0x20;
}

// [EXT] mem_reg2sam (engine/pipeline.py::reg2sam_records)
static void reg2sam_records(const FullOpt& o, const Bns& bns, const Names& nm,
                            int64_t qlen, const uint8_t* query,
                            std::vector<RegT>& regs, int64_t extra_flag,
                            const RecT* mate, std::vector<RecT>& out,
                            Scratch& s) {
  std::vector<std::string> xa;
  bool want_xa = !(o.i(OI_FLAG) & F_ALL);
  if (want_xa) gen_alt_xa(o, bns, nm, regs, qlen, query, xa, s);
  for (int64_t k = 0; k < (int64_t)regs.size(); ++k) {
    RegT& p = regs[k];
    if (p.score < o.i(OI_T)) continue;
    if (p.secondary >= 0 && (p.is_alt || !(o.i(OI_FLAG) & F_ALL))) continue;
    if (p.secondary >= 0 && p.secondary < (1LL << 30) &&
        (double)p.score < (double)regs[p.secondary].score * o.f(OF_DROP_RATIO))
      continue;
    RecT q = reg2aln(o, bns, qlen, query, &p, s);
    if (want_xa && !xa[k].empty()) {
      q.xa = xa[k];
      q.has_xa = true;
    }
    q.flag |= extra_flag;
    if (p.secondary >= 0) q.sub = -1;
    if (!out.empty() && p.secondary < 0)
      q.flag |= (o.i(OI_FLAG) & F_NO_MULTI) ? 0x10000 : 0x800;
    if (!out.empty() && !p.is_alt && q.mapq > out[0].mapq) q.mapq = out[0].mapq;
    out.push_back(std::move(q));
  }
  if (out.empty()) {
    RecT t = reg2aln(o, bns, qlen, query, nullptr, s);
    t.flag |= extra_flag;
    out.push_back(std::move(t));
  }
  for (auto& q : out) fix_flags(q, mate);
}

// ------------------------------------------------------------- paired end

struct PeStat {
  int64_t low = 0, high = 0, failed = 1;
  double avg = 0.0, std = 0.0;
};

// [EXT] mem_infer_dir (engine/pair.py::infer_dir)
static inline void infer_dir(int64_t l_pac, int64_t b1, int64_t b2, int64_t* d,
                             int64_t* dist) {
  bool r1 = b1 >= l_pac, r2 = b2 >= l_pac;
  int64_t p2 = r1 == r2 ? b2 : (l_pac << 1) - 1 - b2;
  *dist = p2 > b1 ? p2 - b1 : b1 - p2;
  *d = (r1 == r2 ? 0 : 1) ^ (p2 > b1 ? 0 : 3);
}

// engine/pair.py::_cal_sub
static int64_t cal_sub(const FullOpt& o, const std::vector<RegT>& regs) {
  for (size_t j = 1; j < regs.size(); ++j) {
    int64_t b_max = std::max(regs[j].qb, regs[0].qb);
    int64_t e_min = std::min(regs[j].qe, regs[0].qe);
    if (e_min > b_max) {
      int64_t min_l = std::min(regs[j].qe - regs[j].qb,
                               regs[0].qe - regs[0].qb);
      if ((double)(e_min - b_max) >= (double)min_l * o.f(OF_MASK_LEVEL))
        return regs[j].score;
    }
  }
  return o.i(OI_MIN_SEED_LEN) * o.i(OI_A);
}

// [EXT] mem_pestat (engine/pair.py::pestat)
static void pestat(const FullOpt& o, int64_t l_pac,
                   const std::vector<std::vector<RegT>>& regs_pairs,
                   PeStat pes[4]) {
  std::vector<int64_t> isize[4];
  int64_t n = (int64_t)regs_pairs.size();
  for (int64_t i = 0; i < (n >> 1); ++i) {
    const auto& r0 = regs_pairs[i << 1];
    const auto& r1 = regs_pairs[(i << 1) | 1];
    if (r0.empty() || r1.empty()) continue;
    if (cal_sub(o, r0) > 0.8 * (double)r0[0].score) continue;
    if (cal_sub(o, r1) > 0.8 * (double)r1[0].score) continue;
    if (r0[0].rid != r1[0].rid) continue;
    int64_t d, dist;
    infer_dir(l_pac, r0[0].rb, r1[0].rb, &d, &dist);
    if (dist && dist <= o.i(OI_MAX_INS)) isize[d].push_back(dist);
  }
  for (int d = 0; d < 4; ++d) {
    std::vector<int64_t> q = isize[d];
    std::sort(q.begin(), q.end());
    PeStat& r = pes[d];
    if ((int64_t)q.size() < 10) {
      r.failed = 1;
      continue;
    }
    r.failed = 0;
    int64_t p25 = q[(size_t)(0.25 * (double)q.size() + 0.499)];
    int64_t p75 = q[(size_t)(0.75 * (double)q.size() + 0.499)];
    r.low = std::max((int64_t)((double)p25 - 2.0 * (double)(p75 - p25) + 0.499),
                     (int64_t)1);
    r.high = (int64_t)((double)p75 + 2.0 * (double)(p75 - p25) + 0.499);
    double sum = 0;
    int64_t cnt = 0;
    for (int64_t x : q)
      if (r.low <= x && x <= r.high) {
        sum += (double)x;
        ++cnt;
      }
    r.avg = sum / (double)cnt;
    double var = 0;
    for (int64_t x : q)
      if (r.low <= x && x <= r.high)
        var += ((double)x - r.avg) * ((double)x - r.avg);
    r.std = std::sqrt(var / (double)cnt);
    r.low = (int64_t)((double)p25 - 3.0 * (double)(p75 - p25) + 0.499);
    r.high = (int64_t)((double)p75 + 3.0 * (double)(p75 - p25) + 0.499);
    if ((double)r.low > r.avg - 4.0 * r.std)
      r.low = (int64_t)(r.avg - 4.0 * r.std + 0.499);
    if ((double)r.high < r.avg + 4.0 * r.std)
      r.high = (int64_t)(r.avg + 4.0 * r.std + 0.499);
    r.low = std::max(r.low, (int64_t)1);
  }
  int64_t mx = 0;
  for (int d = 0; d < 4; ++d) mx = std::max(mx, (int64_t)isize[d].size());
  for (int d = 0; d < 4; ++d)
    if (pes[d].failed == 0 && (double)isize[d].size() < (double)mx * 0.05)
      pes[d].failed = 1;
}

// ------------------------------------------------------- local SW (mate)

struct SwHit {
  int64_t score = 0, qb = -1, qe = -1, tb = -1, te = -1, score2 = 0, te2 = -1;
};

// [EXT] ksw_align2 semantics (engine/pair.py::sw_local); scalar recurrence
// equals the oracle's prefix-max closed form for o>=0 affine gaps
// Local-SW core for mate rescue ([EXT] ksw_align2 semantics,
// engine/pair.py::sw_local).  The row recurrence uses the M-based gap
// opening of ksw.c: f depends on hbase (not h), so the same prefix-max
// reformulation as the extension kernels applies —
//   f[j] = max(0, max_{k<j}(hbase[k] + k*e_ins) - oe_ins - (j-1)*e_ins)
// — making every cell elementwise plus one log-step scan.  Rows run
// 8-wide AVX2 (int32 lanes; scores are query-length bounded) with a
// scalar tail/fallback carrying the identical recurrence; bit-exact vs
// the python oracle incl. the first-max argmax tie-break.
//
// H/E rows are 1-padded (index 0 = boundary 0) and H is double-buffered
// so the diagonal term is a plain unaligned load of the previous row.

struct SwScratch {
  std::vector<int32_t> Ha, Hb, E;
  std::vector<int8_t> prof;
  std::vector<int64_t> rowmax;
};

static inline int32_t sw_row_core(const int8_t* prow, int64_t qlen,
                                  const int32_t* Hold, int32_t* Hnew,
                                  int32_t* E, int32_t oe_del, int32_t e_del,
                                  int32_t oe_ins, int32_t e_ins) {
  int32_t rmax = 0;
  int64_t j = 1;
  int32_t f = 0;
#if defined(__AVX2__)
  if (qlen >= 16) {
    const __m256i vzero = _mm256_setzero_si256();
    const __m256i voedel = _mm256_set1_epi32(oe_del);
    const __m256i vedel = _mm256_set1_epi32(e_del);
    const __m256i voeins = _mm256_set1_epi32(oe_ins);
    const __m256i veins = _mm256_set1_epi32(e_ins);
    const __m256i viota = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
    __m256i vrmax = vzero;
    int32_t carry = vx::NEG;
    int64_t vec_end = 1 + ((qlen) & ~7);
    for (; j < vec_end; j += 8) {
      __m256i vHp = _mm256_loadu_si256((const __m256i*)&Hold[j]);
      __m256i vHd = _mm256_loadu_si256((const __m256i*)&Hold[j - 1]);
      __m256i vq = _mm256_cvtepi8_epi32(
          _mm_loadl_epi64((const __m128i*)&prow[j - 1]));
      __m256i vE = _mm256_loadu_si256((const __m256i*)&E[j]);
      __m256i vEn = _mm256_max_epi32(
          _mm256_max_epi32(_mm256_sub_epi32(vE, vedel),
                           _mm256_sub_epi32(vHp, voedel)),
          vzero);
      _mm256_storeu_si256((__m256i*)&E[j], vEn);
      __m256i vM = _mm256_add_epi32(vHd, vq);
      __m256i vhb = _mm256_max_epi32(_mm256_max_epi32(vM, vEn), vzero);
      __m256i vj = _mm256_add_epi32(_mm256_set1_epi32((int32_t)j), viota);
      __m256i vje = _mm256_mullo_epi32(vj, veins);
      __m256i vg = _mm256_add_epi32(vhb, vje);
      __m256i incl = _mm256_max_epi32(vg, vx::shiftl<1>(vg));
      incl = _mm256_max_epi32(incl, vx::shiftl<2>(incl));
      incl = _mm256_max_epi32(incl, vx::shiftl<4>(incl));
      __m256i excl = _mm256_max_epi32(vx::shiftl<1>(incl),
                                      _mm256_set1_epi32(carry));
      carry = std::max(carry, (int32_t)_mm256_extract_epi32(incl, 7));
      // f[j] = max(0, excl - oe_ins - (j-1)*e_ins)
      __m256i vf = _mm256_max_epi32(
          _mm256_sub_epi32(excl,
                           _mm256_add_epi32(_mm256_sub_epi32(vje, veins),
                                            voeins)),
          vzero);
      __m256i vh = _mm256_max_epi32(vhb, vf);
      _mm256_storeu_si256((__m256i*)&Hnew[j], vh);
      vrmax = _mm256_max_epi32(vrmax, vh);
    }
    alignas(32) int32_t tmp[8];
    _mm256_store_si256((__m256i*)tmp, vrmax);
    for (int k = 0; k < 8; ++k) rmax = std::max(rmax, tmp[k]);
    // reconstruct the serial f entering the scalar tail
    if (j > 1)
      f = std::max(carry - oe_ins - (int32_t)(j - 1) * e_ins, 0);
  }
#endif
  for (; j <= qlen; ++j) {
    int32_t e = std::max(std::max(E[j] - e_del, Hold[j] - oe_del), 0);
    int32_t M = Hold[j - 1] + prow[j - 1];
    int32_t hbase = std::max(std::max(M, e), 0);
    int32_t h = std::max(hbase, f);
    E[j] = e;
    Hnew[j] = h;
    rmax = std::max(rmax, h);
    f = std::max(std::max(f - e_ins, hbase - oe_ins), 0);
  }
  return rmax;
}

// first-maximum column of a completed row (H[1..qlen] -> query index),
// the exact tie-break of the old row-rerun formulation
static inline int64_t row_first_argmax(const int32_t* H, int64_t qlen) {
  int32_t best = H[1];
  int64_t arg = 0;
  for (int64_t j = 2; j <= qlen; ++j)
    if (H[j] > best) {
      best = H[j];
      arg = j - 1;
    }
  return arg;
}

static SwHit sw_local(const int8_t* mat, const uint8_t* qseq, int64_t qlen,
                      const uint8_t* tseq, int64_t tlen, int64_t o_del,
                      int64_t e_del, int64_t o_ins, int64_t e_ins,
                      int64_t minsc) {
  SwHit r;
  if (qlen == 0 || tlen == 0) return r;
  int32_t oe_del = (int32_t)(o_del + e_del), oe_ins = (int32_t)(o_ins + e_ins);
  static thread_local SwScratch s;
  // forward pass, tracking (gmax, te, qe) on the fly: a row that improves
  // the running max gets an O(qlen) argmax scan of its completed values —
  // this replaces the old from-scratch DP re-run of rows [0, te]
  s.prof.resize((size_t)5 * qlen);
  for (int k = 0; k < 5; ++k)
    for (int64_t j = 0; j < qlen; ++j)
      s.prof[(size_t)k * qlen + j] = mat[k * 5 + qseq[j]];
  size_t nbuf = (size_t)qlen + 9;
  s.Ha.assign(nbuf, 0);
  s.Hb.assign(nbuf, 0);
  s.E.assign(nbuf, 0);
  int32_t* Hold = s.Ha.data();
  int32_t* Hnew = s.Hb.data();
  std::vector<int64_t> rowmax((size_t)tlen);
  int64_t gmax = 0, te = -1, qe = -1;
  for (int64_t i = 0; i < tlen; ++i) {
    int32_t rmax = sw_row_core(&s.prof[(size_t)tseq[i] * qlen], qlen, Hold,
                               Hnew, s.E.data(), oe_del, (int32_t)e_del,
                               oe_ins, (int32_t)e_ins);
    rowmax[i] = rmax;
    if (rmax > gmax) {
      gmax = rmax;
      te = i;
      qe = row_first_argmax(Hnew, qlen);
    }
    std::swap(Hold, Hnew);
  }
  std::vector<int64_t> bscores, brows;
  for (int64_t i = 0; i < tlen; ++i) {
    int64_t imax = rowmax[i];
    if (imax >= minsc) {
      if (brows.empty() || brows.back() + 1 != i) {
        bscores.push_back(imax);
        brows.push_back(i);
      } else if (bscores.back() < imax) {
        bscores.back() = imax;
        brows.back() = i;
      }
    }
  }
  if (gmax == 0) return r;
  r.score = gmax;
  r.te = te;
  r.qe = qe;
  int64_t low = te - qlen, high = te + qlen;
  for (size_t k = 0; k < bscores.size(); ++k) {
    if ((brows[k] < low || brows[k] > high) && bscores[k] > r.score2) {
      r.score2 = bscores[k];
      r.te2 = brows[k];
    }
  }
  // start via reverse pass, stopping at the FIRST row reaching the known
  // score (the old code ran all te+1 rows, then re-ran rows for the argmax)
  std::vector<uint8_t> rq(qseq, qseq + r.qe + 1), rt(tseq, tseq + r.te + 1);
  std::reverse(rq.begin(), rq.end());
  std::reverse(rt.begin(), rt.end());
  int64_t rql = (int64_t)rq.size();
  s.prof.resize((size_t)5 * rql);
  for (int k = 0; k < 5; ++k)
    for (int64_t j = 0; j < rql; ++j)
      s.prof[(size_t)k * rql + j] = mat[k * 5 + rq[j]];
  nbuf = (size_t)rql + 9;
  s.Ha.assign(nbuf, 0);
  s.Hb.assign(nbuf, 0);
  s.E.assign(nbuf, 0);
  Hold = s.Ha.data();
  Hnew = s.Hb.data();
  for (int64_t i = 0; i < (int64_t)rt.size(); ++i) {
    int32_t rmax = sw_row_core(&s.prof[(size_t)rt[i] * rql], rql, Hold, Hnew,
                               s.E.data(), oe_del, (int32_t)e_del, oe_ins,
                               (int32_t)e_ins);
    if (rmax == gmax) {
      int64_t jrev = row_first_argmax(Hnew, rql);
      r.tb = r.te - i;
      r.qb = r.qe - jrev;
      break;
    }
    std::swap(Hold, Hnew);
  }
  return r;
}

// [EXT] bns_fetch_seq clamp (index/build.py::fetch_seq)
static void fetch_clamp(const Bns& bns, int64_t mid, int64_t* beg,
                        int64_t* end, int64_t* rid) {
  int64_t l_pac = bns.l_pac;
  bool is_rev = mid >= l_pac;
  int64_t fpos = is_rev ? (l_pac << 1) - 1 - mid : mid;
  int64_t r = bns.pos_to_rid(fpos);
  *rid = r;
  int64_t far_beg = bns.off[r], far_end = bns.off[r] + bns.len[r];
  if (is_rev) {
    int64_t nb = (l_pac << 1) - far_end, ne = (l_pac << 1) - far_beg;
    far_beg = nb;
    far_end = ne;
  }
  *beg = std::max(*beg, far_beg);
  *end = std::min(*end, far_end);
}

// [EXT] mem_seed_sw (engine/chain.py::_seed_sw): local SW around a short
// seed to judge whether it can support a decent alignment; -1 = trusted.
static int64_t seed_sw(const FullOpt& o, const Bns& bns, int64_t qlen,
                       const uint8_t* query, const Seed& s,
                       std::vector<uint8_t>& refbuf) {
  constexpr int64_t MEM_SHORT_EXT = 50, MEM_SHORT_LEN = 200;
  if (s.len >= MEM_SHORT_LEN) return -1;
  int64_t l_pac = bns.l_pac;
  int64_t qb = s.qbeg, qe = s.qbeg + s.len;
  int64_t rb = s.rbeg, re = s.rbeg + s.len;
  int64_t mid = (rb + re) >> 1;
  qb = std::max(qb - MEM_SHORT_EXT, (int64_t)0);
  qe = std::min(qe + MEM_SHORT_EXT, qlen);
  rb = std::max(rb - MEM_SHORT_EXT, (int64_t)0);
  re = std::min(re + MEM_SHORT_EXT, l_pac << 1);
  if (rb < l_pac && l_pac < re) {
    if (mid < l_pac)
      re = l_pac;
    else
      rb = l_pac;
  }
  // window guard is opt.w<<2 ([EXT] mem_seed_sw)
  if (qe - qb >= o.i(OI_W) << 2 || re - rb >= o.i(OI_W) << 2) return -1;
  int64_t rid;
  fetch_clamp(bns, mid, &rb, &re, &rid);
  refbuf.resize(re - rb);
  bns.get_seq(rb, re, refbuf.data());
  SwHit hit = sw_local(o.mat, query + qb, qe - qb, refbuf.data(), re - rb,
                       o.i(OI_O_DEL), o.i(OI_E_DEL), o.i(OI_O_INS),
                       o.i(OI_E_INS), (qe - qb) * o.i(OI_A));
  return hit.score;
}

// [EXT] mem_flt_chained_seeds (engine/chain.py::flt_chained_seeds):
// a no-op below ~700bp (the 0.05*qlen guard); SW-filters weak seeds on
// the long-read/chimeric path.
static void flt_chained_seeds(const FullOpt& o, const Bns& bns, int64_t qlen,
                              const uint8_t* query,
                              std::vector<Chain>& chains,
                              std::vector<uint8_t>& refbuf) {
  double min_l = o.i(OI_MIN_CHAIN_WEIGHT)
                     ? 1.1 * (double)o.i(OI_MIN_CHAIN_WEIGHT)
                     : 5.5 * std::log((double)qlen);
  int64_t min_hsp_score = (int64_t)((double)o.i(OI_A) * min_l + 0.499);
  if (min_l > 0.05 * (double)qlen) return;
  for (Chain& c : chains) {
    std::vector<Seed> kept;
    kept.reserve(c.seeds.size());
    for (Seed& s : c.seeds) {
      int64_t score = seed_sw(o, bns, qlen, query, s, refbuf);
      if (score < 0 || score >= min_hsp_score) {
        s.score = score < 0 ? s.len * o.i(OI_A) : score;
        kept.push_back(s);
      }
    }
    c.seeds = std::move(kept);
  }
}

// [EXT] mem_matesw (engine/pair.py::matesw)
static int64_t matesw(const FullOpt& o, const Bns& bns, const PeStat pes[4],
                      const RegT& a, const uint8_t* mseq, int64_t l_ms,
                      std::vector<RegT>& ma) {
  int64_t l_pac = bns.l_pac;
  int skip[4];
  for (int r = 0; r < 4; ++r) skip[r] = pes[r].failed ? 1 : 0;
  for (const RegT& reg : ma) {
    int64_t r, dist;
    infer_dir(l_pac, a.rb, reg.rb, &r, &dist);
    if (!pes[r].failed && pes[r].low <= dist && dist <= pes[r].high)
      skip[r] = 1;
  }
  if (skip[0] + skip[1] + skip[2] + skip[3] == 4) return 0;
  int64_t n = 0;
  std::vector<uint8_t> rev, refbuf;
  for (int r = 0; r < 4; ++r) {
    if (skip[r]) continue;
    bool is_rev = (r >> 1) != (r & 1);
    bool is_larger = !(r >> 1);
    const uint8_t* seq = mseq;
    if (is_rev) {
      rev.resize(l_ms);
      for (int64_t i = 0; i < l_ms; ++i) {
        uint8_t c = mseq[l_ms - 1 - i];
        rev[i] = c < 4 ? 3 - c : c;
      }
      seq = rev.data();
    }
    int64_t rb, re;
    if (!is_rev) {
      rb = is_larger ? a.rb + pes[r].low : a.rb - pes[r].high;
      re = (is_larger ? a.rb + pes[r].high : a.rb - pes[r].low) + l_ms;
    } else {
      rb = (is_larger ? a.rb + pes[r].low : a.rb - pes[r].high) - l_ms;
      re = is_larger ? a.rb + pes[r].high : a.rb - pes[r].low;
    }
    rb = std::max(rb, (int64_t)0);
    re = std::min(re, l_pac << 1);
    if (rb >= re) continue;
    int64_t rid;
    fetch_clamp(bns, (rb + re) >> 1, &rb, &re, &rid);
    if (rid != a.rid || re - rb < o.i(OI_MIN_SEED_LEN)) continue;
    refbuf.resize(re - rb);
    bns.get_seq(rb, re, refbuf.data());
    SwHit hit = sw_local(o.mat, seq, l_ms, refbuf.data(), re - rb,
                         o.i(OI_O_DEL), o.i(OI_E_DEL), o.i(OI_O_INS),
                         o.i(OI_E_INS),
                         o.i(OI_MIN_SEED_LEN) * o.i(OI_A));
    if (hit.score >= o.i(OI_MIN_SEED_LEN) && hit.qb >= 0) {
      RegT b;
      b.rid = a.rid;
      b.is_alt = a.is_alt;
      b.qb = is_rev ? l_ms - (hit.qe + 1) : hit.qb;
      b.qe = is_rev ? l_ms - hit.qb : hit.qe + 1;
      b.rb = is_rev ? (l_pac << 1) - (rb + hit.te + 1) : rb + hit.tb;
      b.re = is_rev ? (l_pac << 1) - (rb + hit.tb) : rb + hit.te + 1;
      b.score = hit.score;
      b.truesc = hit.score;
      b.csub = hit.score2;
      b.secondary = -1;
      b.seedcov = std::min(b.re - b.rb, b.qe - b.qb) >> 1;
      size_t pos = ma.size();
      for (size_t i = 0; i < ma.size(); ++i)
        if (ma[i].score < b.score) {
          pos = i;
          break;
        }
      ma.insert(ma.begin() + pos, b);
    }
    ++n;
  }
  return n;
}

// [EXT] raw_mapq (engine/pair.py::raw_mapq)
static inline int64_t raw_mapq(int64_t diff, int64_t a) {
  return (int64_t)(6.02 * (double)diff / (double)a + 0.499);
}

// [EXT] mem_pair (engine/pair.py::mem_pair)
static bool mem_pair(const FullOpt& o, int64_t l_pac, const PeStat pes[4],
                     const std::vector<RegT>* regs2, int64_t pair_id,
                     const int64_t* n_pri, int64_t* o_out, int64_t* sub_out,
                     int64_t* n_sub_out, int64_t z_out[2]) {
  std::vector<std::pair<int64_t, uint64_t>> v;
  for (int r = 0; r < 2; ++r) {
    for (int64_t i = 0; i < n_pri[r]; ++i) {
      const RegT& e = regs2[r][i];
      int64_t x = e.rb < l_pac ? e.rb : (l_pac << 1) - 1 - e.rb;
      uint64_t y = ((uint64_t)e.score << 32) | ((uint64_t)i << 2) |
                   ((uint64_t)(e.rb >= l_pac) << 1) | (uint64_t)r;
      v.push_back({x, y});
    }
  }
  std::sort(v.begin(), v.end());
  int64_t y_last[4] = {-1, -1, -1, -1};
  std::vector<std::pair<uint64_t, uint64_t>> u;
  for (int64_t i = 0; i < (int64_t)v.size(); ++i) {
    for (int r = 0; r < 2; ++r) {
      int64_t d = (r << 1) | ((v[i].second >> 1) & 1);
      if (pes[d].failed) continue;
      int64_t which = (r << 1) | ((v[i].second & 1) ^ 1);
      if (y_last[which] < 0) continue;
      for (int64_t k = y_last[which]; k >= 0; --k) {
        if ((int64_t)(v[k].second & 3) != which) continue;
        int64_t dist = v[i].first - v[k].first;
        if (dist > pes[d].high) break;
        if (dist < pes[d].low) continue;
        double ns = ((double)dist - pes[d].avg) / pes[d].std;
        int64_t q = (int64_t)((double)(v[i].second >> 32) +
                              (double)(v[k].second >> 32) +
                              0.721 *
                                  std::log(2.0 * std::erfc(std::fabs(ns) *
                                                           std::sqrt(0.5))) *
                                  (double)o.i(OI_A) +
                              0.499);
        q = std::max(q, (int64_t)0);
        uint64_t yy = ((uint64_t)k << 32) | (uint64_t)i;
        u.push_back({((uint64_t)q << 32) |
                         (hash_64(yy ^ ((uint64_t)pair_id << 8)) & 0xFFFFFFFFu),
                     yy});
      }
    }
    y_last[v[i].second & 3] = i;
  }
  if (u.empty()) return false;
  int64_t tmp = std::max(o.i(OI_A) + o.i(OI_B),
                         std::max(o.i(OI_O_DEL) + o.i(OI_E_DEL),
                                  o.i(OI_O_INS) + o.i(OI_E_INS)));
  std::sort(u.begin(), u.end());
  int64_t i = (int64_t)(u.back().second >> 32);
  int64_t k = (int64_t)(u.back().second & 0xFFFFFFFFu);
  z_out[v[i].second & 1] = (int64_t)((v[i].second & 0xFFFFFFFFu) >> 2);
  z_out[v[k].second & 1] = (int64_t)((v[k].second & 0xFFFFFFFFu) >> 2);
  *o_out = (int64_t)(u.back().first >> 32);
  *sub_out = u.size() > 1 ? (int64_t)(u[u.size() - 2].first >> 32) : 0;
  int64_t n_sub = 0;
  for (size_t j = 0; j + 1 < u.size(); ++j)
    if (*sub_out - (int64_t)(u[j].first >> 32) <= tmp) ++n_sub;
  *n_sub_out = n_sub;
  return true;
}

// [EXT] mem_sam_pe paired branch (engine/pair.py::_try_pair_output);
// returns false to fall through to the unpaired path
static bool try_pair_output(const FullOpt& o, const Bns& bns, const Names& nm,
                            const PeStat pes[4], int64_t pair_id,
                            const uint8_t* const seqs[2],
                            const int64_t qlens[2], std::vector<RegT>* regs2,
                            const int64_t* n_pri, std::vector<RecT>* out01,
                            Scratch& s) {
  int64_t l_pac = bns.l_pac;
  if (!(n_pri[0] && n_pri[1])) return false;
  int64_t o_sc = 0, subo = 0, n_sub = 0;
  int64_t z[2] = {0, 0};
  if (!mem_pair(o, l_pac, pes, regs2, pair_id, n_pri, &o_sc, &subo, &n_sub, z))
    return false;
  if (o_sc <= 0) return false;
  for (int i = 0; i < 2; ++i)
    for (int64_t j = 1; j < n_pri[i]; ++j)
      if (regs2[i][j].secondary < 0 && regs2[i][j].score >= o.i(OI_T))
        return false;
  int64_t score_un =
      regs2[0][0].score + regs2[1][0].score - o.i(OI_PEN_UNPAIRED);
  int64_t q_se[2];
  int64_t extra_flag;
  if (o_sc <= score_un) {  // unpaired alignment preferred
    z[0] = z[1] = 0;
    q_se[0] = approx_mapq_se(o, regs2[0][0]);
    q_se[1] = approx_mapq_se(o, regs2[1][0]);
    extra_flag = 1;
  } else {
    subo = std::max(subo, score_un);
    int64_t q_pe = raw_mapq(o_sc - subo, o.i(OI_A));
    if (n_sub > 0)
      q_pe -= (int64_t)(4.343 * std::log((double)n_sub + 1.0) + 0.499);
    q_pe = std::min(std::max(q_pe, (int64_t)0), (int64_t)60);
    q_pe = (int64_t)((double)q_pe *
                         (1.0 - 0.5 * (regs2[0][0].frac_rep +
                                       regs2[1][0].frac_rep)) +
                     0.499);
    RegT* c[2] = {&regs2[0][z[0]], &regs2[1][z[1]]};
    for (int i = 0; i < 2; ++i) {
      if (c[i]->secondary >= 0) {
        c[i]->secondary = -2;
        q_se[i] = 0;
      } else {
        q_se[i] = approx_mapq_se(o, *c[i]);
      }
    }
    q_se[0] = q_se[0] > q_pe ? q_se[0] : std::min(q_pe, q_se[0] + 40);
    q_se[1] = q_se[1] > q_pe ? q_se[1] : std::min(q_pe, q_se[1] + 40);
    q_se[0] = std::min(q_se[0], raw_mapq(c[0]->score - c[0]->csub, o.i(OI_A)));
    q_se[1] = std::min(q_se[1], raw_mapq(c[1]->score - c[1]->csub, o.i(OI_A)));
    extra_flag = 3;
  }
  RecT h[2];
  std::vector<std::string> xa[2];
  for (int i = 0; i < 2; ++i) {
    if (!(o.i(OI_FLAG) & F_ALL))
      {
        SubTimer st(g_ns_xa);
        gen_alt_xa(o, bns, nm, regs2[i], qlens[i], seqs[i], xa[i], s);
      }
    else
      xa[i].assign(regs2[i].size(), std::string());
  }
  for (int i = 0; i < 2; ++i) {
    RecT ai = reg2aln(o, bns, qlens[i], seqs[i], &regs2[i][z[i]], s);
    ai.mapq = q_se[i];
    ai.flag |= (0x40LL << i) | extra_flag;
    if (!xa[i][z[i]].empty()) {
      ai.xa = xa[i][z[i]];
      ai.has_xa = true;
    }
    h[i] = std::move(ai);
    // the end's best ALT hit stayed primary after the ALT round: bwa
    // 0.7.17's paired branch is recalled to write it as a 0x800 record,
    // which neither this tail nor its oracle does (counted, not written)
    if (n_pri[i] < (int64_t)regs2[i].size()) {
      const RegT& p = regs2[i][n_pri[i]];
      if (p.is_alt && p.secondary < 0 && p.score >= o.i(OI_T))
        ++s.alt[AC_ALT_PAIR_PRIMARY_ENDS];
    }
  }
  fix_flags(h[0], &h[1]);
  fix_flags(h[1], &h[0]);
  out01[0].push_back(std::move(h[0]));
  out01[1].push_back(std::move(h[1]));
  return true;
}

// [EXT] mem_sam_pe (engine/pair.py::sam_pe)
static void sam_pe(const FullOpt& o, const Bns& bns, const Names& nm,
                   const PeStat pes[4], int64_t pair_id,
                   const uint8_t* const seqs[2], const int64_t qlens[2],
                   std::vector<RegT>* regs2, std::vector<RecT>* out01,
                   Scratch& s) {
  int64_t l_pac = bns.l_pac;
  if (!(o.i(OI_FLAG) & F_NO_RESCUE)) {
    // snapshot near-best candidates of each end BEFORE any rescue runs
    std::vector<RegT> cand[2];
    for (int i = 0; i < 2; ++i)
      for (const RegT& r : regs2[i])
        if (r.score >= regs2[i][0].score - o.i(OI_PEN_UNPAIRED))
          cand[i].push_back(r);
    SubTimer st(g_ns_matesw);
    for (int i = 0; i < 2; ++i)
      for (int64_t j = 0;
           j < (int64_t)cand[i].size() && j < o.i(OI_MAX_MATESW); ++j)
        matesw(o, bns, pes, cand[i][j], seqs[1 - i], qlens[1 - i],
               regs2[1 - i]);
  }
  int64_t n_pri[2] = {mark_primary_se(o, regs2[0], (pair_id << 1) | 0),
                      mark_primary_se(o, regs2[1], (pair_id << 1) | 1)};
  int64_t extra_flag = 1;
  if (!(o.i(OI_FLAG) & F_NOPAIRING)) {
    if (try_pair_output(o, bns, nm, pes, pair_id, seqs, qlens, regs2, n_pri,
                        out01, s))
      return;
  }
  // no_pairing fallback
  RecT h[2];
  for (int i = 0; i < 2; ++i) {
    const RegT* which = nullptr;
    if (!regs2[i].empty() && regs2[i][0].score >= o.i(OI_T))
      which = &regs2[i][0];
    h[i] = reg2aln(o, bns, qlens[i], seqs[i], which, s);
  }
  if (h[0].rid == h[1].rid && h[0].rid >= 0 && !regs2[0].empty() &&
      !regs2[1].empty()) {
    int64_t d, dist;
    infer_dir(l_pac, regs2[0][0].rb, regs2[1][0].rb, &d, &dist);
    if (!pes[d].failed && pes[d].low <= dist && dist <= pes[d].high)
      extra_flag |= 2;
  }
  SubTimer st_rec(g_ns_rec);
  reg2sam_records(o, bns, nm, qlens[0], seqs[0], regs2[0], 0x40 | extra_flag,
                  &h[1], out01[0], s);
  reg2sam_records(o, bns, nm, qlens[1], seqs[1], regs2[1], 0x80 | extra_flag,
                  &h[0], out01[1], s);
}

}  // namespace tail

// ============================================================== C ABI

extern "C" {

// Record row field order (python native_pipeline.py mirrors this)
enum {
  RF_READ = 0, RF_FLAG, RF_RID, RF_POS, RF_IS_REV, RF_IS_ALT, RF_MAPQ, RF_NM,
  RF_SCORE, RF_SUB, RF_ALT_SC, RF_N_CIG, RF_CIG_OFF, RF_MD_OFF, RF_MD_LEN,
  RF_XA_OFF, RF_XA_LEN, RF_HAS_XA,
  // derived fields so the API layer never walks cigars in Python:
  // rendered BAM-coded cigar text (MIDNSH — correct N/H, unlike the
  // reference's '?' table, BwaMemAligner.java:256), reference span
  // (sum M/D), leading-softclip offset and query span (sum M/I)
  RF_CIGSTR_OFF, RF_CIGSTR_LEN, RF_REFLEN, RF_SEQSTART, RF_SEQLEN, RF_N
};

void bwamem_buf_free(void* p) { std::free(p); }

}  // extern "C"

namespace tail {

// Regions before dedup -> final alignment records: the part of
// bwamem_pipeline_batch after phase 1's chain2aln.  raws[i] is read i's
// regions in the order chain2aln appends them.
static void pipeline_tail(
    const FullOpt& o, const Bns& bns, const Names& nm, int64_t n_reads,
    const uint8_t* rbuf, const int64_t* roff, const int32_t* rlen,
    std::vector<std::vector<Reg>>& raws, int32_t is_pe, const double* pes_in,
    int64_t id_base, int64_t id_stride, double* pes_out, bool prof,
    int64_t** rec_rows_out, int64_t* n_rec_out, uint32_t** cig_out,
    int64_t* cig_len_out, char** str_out, int64_t* str_len_out,
    int64_t* counts_out) {
  const int64_t l_pac = bns.l_pac;
  int64_t counts[AC_N] = {};
  auto tally = [&](const Scratch& s) {
#pragma omp critical(alt_tally)
    for (int k = 0; k < AC_N; ++k) counts[k] += s.alt[k];
  };
  auto t0 = std::chrono::steady_clock::now();
  auto lap = [&](const char* name) {
    if (!prof) return;
    auto t1 = std::chrono::steady_clock::now();
    fprintf(stderr, "[native_prof] %s %.1fms\n", name,
            std::chrono::duration<double, std::milli>(t1 - t0).count());
    t0 = t1;
  };
  std::vector<std::vector<RegT>> regs(n_reads);
#pragma omp parallel
  {
    Scratch s;
#pragma omp for schedule(dynamic, 8)
    for (int64_t i = 0; i < n_reads; ++i) {
      SubTimer st(g_ns_dedup);
      std::vector<Reg>& raw = raws[(size_t)i];
      std::vector<RegT>& out = regs[i];
      out.reserve(raw.size());
      for (const Reg& r : raw) {
        RegT t;
        t.rb = r.rb; t.re = r.re; t.qb = r.qb; t.qe = r.qe; t.rid = r.rid;
        t.score = r.score; t.truesc = r.truesc; t.w = r.w;
        t.seedcov = r.seedcov; t.seedlen0 = r.seedlen0;
        t.frac_rep = r.frac_rep;
        out.push_back(t);
      }
      sort_dedup_patch(o, bns, rbuf + roff[i], out, s);
      flag_alt_regs(bns, out);
      int64_t n_alt = 0;
      for (const Reg& r : raw)
        n_alt += r.rid >= 0 && bns.is_alt && bns.is_alt[r.rid];
      s.alt[AC_REGIONS] += (int64_t)raw.size();
      s.alt[AC_ALT_REGIONS] += n_alt;
      s.alt[AC_ALT_READS] += n_alt > 0;
    }
    tally(s);
  }

  lap("dedup");
  // PE stats: caller-provided or inferred from the whole batch
  PeStat pes[4];
  if (is_pe) {
    if (pes_in != nullptr) {
      for (int d = 0; d < 4; ++d) {
        pes[d].low = (int64_t)pes_in[d * 5 + 0];
        pes[d].high = (int64_t)pes_in[d * 5 + 1];
        pes[d].failed = (int64_t)pes_in[d * 5 + 2];
        pes[d].avg = pes_in[d * 5 + 3];
        pes[d].std = pes_in[d * 5 + 4];
      }
    } else {
      pestat(o, l_pac, regs, pes);
    }
    if (pes_out != nullptr) {
      for (int d = 0; d < 4; ++d) {
        pes_out[d * 5 + 0] = (double)pes[d].low;
        pes_out[d * 5 + 1] = (double)pes[d].high;
        pes_out[d * 5 + 2] = (double)pes[d].failed;
        pes_out[d * 5 + 3] = pes[d].avg;
        pes_out[d * 5 + 4] = pes[d].std;
      }
    }
  }

  lap("pestat");
  // phase 2: finalize per read / per pair ([EXT] worker2)
  std::vector<std::vector<RecT>> recs(n_reads);
  if (is_pe) {
    int64_t n_pairs = n_reads >> 1;
#pragma omp parallel
    {
      Scratch s;
#pragma omp for schedule(dynamic, 4)
      for (int64_t p = 0; p < n_pairs; ++p) {
        const uint8_t* seqs[2] = {rbuf + roff[2 * p], rbuf + roff[2 * p + 1]};
        const int64_t qlens[2] = {rlen[2 * p], rlen[2 * p + 1]};
        std::vector<RegT>* r2 = &regs[2 * p];
        std::vector<RecT> out01[2];
        sam_pe(o, bns, nm, pes, id_base + p * id_stride, seqs, qlens, r2,
               out01, s);
        recs[2 * p] = std::move(out01[0]);
        recs[2 * p + 1] = std::move(out01[1]);
      }
      tally(s);
    }
  } else {
#pragma omp parallel
    {
      Scratch s;
#pragma omp for schedule(dynamic, 8)
      for (int64_t i = 0; i < n_reads; ++i) {
        mark_primary_se(o, regs[i], id_base + i * id_stride);
        if (o.i(OI_FLAG) & F_PRIMARY5) reorder_primary5(o.i(OI_T), regs[i]);
        reg2sam_records(o, bns, nm, rlen[i], rbuf + roff[i], regs[i], 0,
                        nullptr, recs[i], s);
      }
      tally(s);
    }
  }

  lap("pair+finalize");
  if (prof)
    fprintf(stderr,
            "[native_prof]   matesw %.1fms  xa %.1fms  reg2sam %.1fms  "
            "chain %.1fms  extend %.1fms  dedup %.1fms\n",
            g_ns_matesw.load() / 1e6, g_ns_xa.load() / 1e6,
            g_ns_rec.load() / 1e6, g_ns_chain.load() / 1e6,
            g_ns_ext.load() / 1e6, g_ns_dedup.load() / 1e6);
  // serialize into flat arenas (cigar text worst case: 11 chars per op)
  int64_t n_rec = 0, cig_len = 0, str_len = 0;
  for (const auto& rl : recs)
    for (const auto& r : rl) {
      ++n_rec;
      cig_len += (int64_t)r.cigar.size();
      str_len += (int64_t)r.md.size() + (int64_t)r.xa.size() +
                 (int64_t)r.cigar.size() * 11;
    }
  int64_t* rows =
      (int64_t*)std::malloc(sizeof(int64_t) * (size_t)std::max(n_rec, (int64_t)1) * RF_N);
  uint32_t* cig =
      (uint32_t*)std::malloc(sizeof(uint32_t) * (size_t)std::max(cig_len, (int64_t)1));
  char* str = (char*)std::malloc((size_t)std::max(str_len, (int64_t)1));
  int64_t ri = 0, cpos = 0, spos = 0;
  for (int64_t i = 0; i < n_reads; ++i) {
    for (const RecT& r : recs[i]) {
      int64_t* row = rows + ri * RF_N;
      row[RF_READ] = i;
      row[RF_FLAG] = r.flag;
      row[RF_RID] = r.rid;
      row[RF_POS] = r.pos;
      row[RF_IS_REV] = r.is_rev;
      row[RF_IS_ALT] = r.is_alt;
      row[RF_MAPQ] = r.mapq;
      row[RF_NM] = r.NM;
      row[RF_SCORE] = r.score;
      row[RF_SUB] = r.sub;
      row[RF_ALT_SC] = r.alt_sc;
      row[RF_N_CIG] = (int64_t)r.cigar.size();
      row[RF_CIG_OFF] = cpos;
      std::memcpy(cig + cpos, r.cigar.data(),
                  r.cigar.size() * sizeof(uint32_t));
      cpos += (int64_t)r.cigar.size();
      row[RF_MD_OFF] = spos;
      row[RF_MD_LEN] = (int64_t)r.md.size();
      std::memcpy(str + spos, r.md.data(), r.md.size());
      spos += (int64_t)r.md.size();
      row[RF_XA_OFF] = spos;
      row[RF_XA_LEN] = (int64_t)r.xa.size();
      std::memcpy(str + spos, r.xa.data(), r.xa.size());
      spos += (int64_t)r.xa.size();
      row[RF_HAS_XA] = r.has_xa ? 1 : 0;
      // derived: rendered cigar text + span sums (fmt_BAMish op shift:
      // internal MIDSH op>2 -> BAM MIDNSH op+1, jnibwa.c:65-67)
      static const char kCigChar[6] = {'M', 'I', 'D', 'N', 'S', 'H'};
      int64_t cs = spos, reflen = 0, seqlen = 0, seqstart = 0;
      for (size_t ci = 0; ci < r.cigar.size(); ++ci) {
        uint32_t v = r.cigar[ci];
        int op = (int)(v & 0xF);
        uint32_t ln = v >> 4;
        spos += (int64_t)snprintf(str + spos, 12, "%u%c", ln,
                                  kCigChar[op > 2 ? op + 1 : op]);
        if (op == 0 || op == 2) reflen += ln;
        if (op == 0 || op == 1) seqlen += ln;
        if (ci == 0 && op == 3) seqstart = ln;
      }
      row[RF_CIGSTR_OFF] = cs;
      row[RF_CIGSTR_LEN] = spos - cs;
      row[RF_REFLEN] = reflen;
      row[RF_SEQSTART] = seqstart;
      row[RF_SEQLEN] = seqlen;
      ++ri;
    }
  }
  *rec_rows_out = rows;
  *n_rec_out = n_rec;
  *cig_out = cig;
  *cig_len_out = cig_len;
  *str_out = str;
  *str_len_out = str_len;
  if (counts_out == nullptr) return;
  // what the records carry of the ALT path: primaries with an ALT shadow,
  // and XA entries ("name,pos,cigar,NM;") that name an ALT contig
  std::unordered_set<std::string_view> alt_names;
  for (int64_t k = 0; k < bns.n; ++k)
    if (bns.is_alt && bns.is_alt[k])
      alt_names.emplace(nm.buf + nm.off[k], nm.off[k + 1] - nm.off[k]);
  for (const auto& rl : recs)
    for (const RecT& r : rl) {
      counts[AC_ALT_SC_PRIMARIES] +=
          r.alt_sc > 0 && !(r.flag & (0x100 | 0x800 | 0x10000));
      std::string_view xa(r.xa);
      while (!xa.empty()) {
        std::string_view entry = xa.substr(0, xa.find(';'));
        counts[AC_ALT_XA_ENTRIES] +=
            alt_names.count(entry.substr(0, entry.find(',')));
        xa.remove_prefix(std::min(entry.size() + 1, xa.size()));
      }
    }
  std::memcpy(counts_out, counts, sizeof counts);
}

}  // namespace tail

// ============================================================== C ABI

extern "C" {

// Seed intervals -> final alignment records, the mem_process_seqs
// equivalent.  pes_in: NULL -> infer from the batch ([EXT] mem_pestat);
// else 4x5 doubles (low, high, failed, avg, std).  Output buffers are
// malloc'd here; caller frees via bwamem_buf_free.  counts_out (NULL or
// AC_N int64): the batch's ALT tallies (the AC_* enum).
void bwamem_pipeline_batch(
    const uint8_t* ref_fwd, int64_t l_pac, int64_t n_anns,
    const int64_t* ann_off, const int64_t* ann_len, const int32_t* ann_is_alt,
    const char* name_buf, const int64_t* name_off, int64_t n_reads,
    const uint8_t* rbuf, const int64_t* roff, const int32_t* rlen,
    const int64_t* intv, const int64_t* intv_off, const int64_t* n_intv,
    const int64_t* rbegs, const int64_t* rbeg_off, const int64_t* n_rbeg,
    const int64_t* opt_i, const double* opt_f, const int8_t* mat,
    int32_t is_pe, const double* pes_in, int64_t id_base, int64_t id_stride,
    double* pes_out,
    int64_t** rec_rows_out, int64_t* n_rec_out, uint32_t** cig_out,
    int64_t* cig_len_out, char** str_out, int64_t* str_len_out,
    int64_t* counts_out) {
  using namespace tail;
  FullOpt o{opt_i, opt_f, mat};
  Bns bns{l_pac, n_anns, ann_off, ann_len, ann_is_alt, ref_fwd};
  Names nm{name_buf, name_off};
  Opts core_o{o.i(OI_W), o.i(OI_MAX_CHAIN_GAP), o.i(OI_MIN_CHAIN_WEIGHT),
              o.i(OI_MIN_SEED_LEN), o.i(OI_MAX_CHAIN_EXTEND),
              o.f(OF_MASK_LEVEL), o.f(OF_DROP_RATIO), o.i(OI_MAX_OCC), mat,
              (int)o.i(OI_O_DEL), (int)o.i(OI_E_DEL), (int)o.i(OI_O_INS),
              (int)o.i(OI_E_INS), (int)o.i(OI_ZDROP), (int)o.i(OI_PEN_CLIP5),
              (int)o.i(OI_PEN_CLIP3), (int)o.i(OI_A)};

  // BWAMEM_TPU_NATIVE_PROF=1: print per-phase wall times to stderr
  const bool prof = []() {
    const char* e = getenv("BWAMEM_TPU_NATIVE_PROF");
    return e && e[0] == '1';
  }();
  g_prof_enabled = prof;
  g_ns_matesw = 0;
  g_ns_xa = 0;
  g_ns_rec = 0;
  g_ns_chain = 0;
  g_ns_ext = 0;
  g_ns_dedup = 0;
  auto t0 = std::chrono::steady_clock::now();
  auto lap = [&](const char* name) {
    if (!prof) return;
    auto t1 = std::chrono::steady_clock::now();
    fprintf(stderr, "[native_prof] %s %.1fms\n", name,
            std::chrono::duration<double, std::milli>(t1 - t0).count());
    t0 = t1;
  };
  // phase 1: align to deduped regions ([EXT] worker1), block-at-a-time.
  // BWAMEM_TPU_WAVE_TAIL=1 runs each block's reads as concurrent chain2aln
  // coroutines whose banded extensions flush through the 16-lane SoA batch
  // kernel between resume rounds (chains2aln_wave, align_core.cpp) —
  // bit-identical results, measured ~neutral on this host because the
  // scalar kernel's live-window shrink already beats lockstep lanes that
  // sweep the union band; the wave plumbing exists as the insertion point
  // for device-kernel flushes on fast-link hosts.  Default: sequential.
  std::vector<std::vector<Reg>> all_raws((size_t)n_reads);
  const bool wave_tail = []() {
    const char* e = getenv("BWAMEM_TPU_WAVE_TAIL");
    return e && e[0] == '1';
  }();
  int64_t BLK = 64;
#ifdef _OPENMP
  if (!wave_tail) {
    // small batches: shrink blocks so every thread stays busy and one slow
    // read cannot serialize a whole 64-read block (r03 advisor finding)
    const int64_t nt = omp_get_max_threads();
    if (n_reads < BLK * 4 * nt)
      BLK = std::max<int64_t>(1, n_reads / (4 * nt));
  }
#endif
  const int64_t n_blk = (n_reads + BLK - 1) / BLK;
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t blk = 0; blk < n_blk; ++blk) {
      const int64_t lo = blk * BLK, hi = std::min(n_reads, lo + BLK);
      const int64_t nb = hi - lo;
      std::vector<std::vector<Chain>> chv((size_t)nb);
      {
        SubTimer st(g_ns_chain);
        for (int64_t i = lo; i < hi; ++i) {
          build_chains(core_o, bns, rlen[i], intv + intv_off[i] * 5,
                       n_intv[i], rbegs, rbeg_off + intv_off[i],
                       n_rbeg + intv_off[i], chv[(size_t)(i - lo)]);
          std::vector<uint8_t> refbuf;
          flt_chained_seeds(o, bns, rlen[i], rbuf + roff[i],
                            chv[(size_t)(i - lo)], refbuf);
        }
      }
      std::vector<Reg>* raws = all_raws.data() + lo;
      {
        SubTimer st(g_ns_ext);
        if (wave_tail) {
          std::vector<int64_t> qls((size_t)nb);
          std::vector<const uint8_t*> qps((size_t)nb);
          for (int64_t i = lo; i < hi; ++i) {
            qls[(size_t)(i - lo)] = rlen[i];
            qps[(size_t)(i - lo)] = rbuf + roff[i];
          }
          chains2aln_wave(core_o, bns, nb, qls.data(), qps.data(),
                          chv.data(), raws);
        } else {
          for (int64_t i = lo; i < hi; ++i)
            chains2aln(core_o, bns, rlen[i], rbuf + roff[i],
                       chv[(size_t)(i - lo)], raws[(size_t)(i - lo)]);
        }
      }
    }

  lap("chain+extend");
  pipeline_tail(o, bns, nm, n_reads, rbuf, roff, rlen, all_raws, is_pe,
                pes_in, id_base, id_stride, pes_out, prof, rec_rows_out,
                n_rec_out, cig_out, cig_len_out, str_out, str_len_out,
                counts_out);
}

// The port's own entry, composed of two of the reference's: regions in
// bwamem_align_regs_batch's row layout (11 int64 a region: rb re qb qe rid
// score truesc w seedcov seedlen0 frac_rep_bits; n_reg[i] rows for read i,
// read after read) -> the records bwamem_pipeline_batch returns, through
// the same pipeline_tail.  The other arguments are bwamem_pipeline_batch's.
void bwamem_tail_batch(
    const uint8_t* ref_fwd, int64_t l_pac, int64_t n_anns,
    const int64_t* ann_off, const int64_t* ann_len, const int32_t* ann_is_alt,
    const char* name_buf, const int64_t* name_off, int64_t n_reads,
    const uint8_t* rbuf, const int64_t* roff, const int32_t* rlen,
    const int64_t* reg_rows, const int64_t* n_reg,
    const int64_t* opt_i, const double* opt_f, const int8_t* mat,
    int32_t is_pe, const double* pes_in, int64_t id_base, int64_t id_stride,
    double* pes_out,
    int64_t** rec_rows_out, int64_t* n_rec_out, uint32_t** cig_out,
    int64_t* cig_len_out, char** str_out, int64_t* str_len_out,
    int64_t* counts_out) {
  using namespace tail;
  FullOpt o{opt_i, opt_f, mat};
  Bns bns{l_pac, n_anns, ann_off, ann_len, ann_is_alt, ref_fwd};
  Names nm{name_buf, name_off};
  const bool prof = []() {
    const char* e = getenv("BWAMEM_TPU_NATIVE_PROF");
    return e && e[0] == '1';
  }();
  g_prof_enabled = prof;
  g_ns_matesw = 0;
  g_ns_xa = 0;
  g_ns_rec = 0;
  g_ns_chain = 0;
  g_ns_ext = 0;
  g_ns_dedup = 0;
  std::vector<std::vector<Reg>> raws((size_t)n_reads);
  const int64_t* rr = reg_rows;
  for (int64_t i = 0; i < n_reads; ++i) {
    raws[(size_t)i].resize((size_t)n_reg[i]);
    for (Reg& r : raws[(size_t)i]) {
      r.rb = rr[0];
      r.re = rr[1];
      r.qb = rr[2];
      r.qe = rr[3];
      r.rid = rr[4];
      r.score = rr[5];
      r.truesc = rr[6];
      r.w = rr[7];
      r.seedcov = rr[8];
      r.seedlen0 = rr[9];
      std::memcpy(&r.frac_rep, &rr[10], 8);
      rr += 11;
    }
  }
  pipeline_tail(o, bns, nm, n_reads, rbuf, roff, rlen, raws, is_pe, pes_in,
                id_base, id_stride, pes_out, prof, rec_rows_out, n_rec_out,
                cig_out, cig_len_out, str_out, str_len_out, counts_out);
}

}  // extern "C"
