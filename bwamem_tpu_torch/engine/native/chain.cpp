// Native seed chaining + chain filtering (host runtime hot path).
//
// C++ equivalent of [EXT] bwamem.c's mem_chain / test_and_merge /
// mem_chain_weight / mem_chain_flt, mirroring the validated Python
// implementation in engine/chain.py exactly (including the b-tree
// predecessor merge, weight sort with stable ties, overlap shadowing and
// the max_chain_extend trim).
//
// C ABI (see ../native_chain.py): per-read interval tables with
// pre-resolved suffix-array positions in, flat chain/seed arrays out
// (two-call probe/fill protocol like the seeding batch).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Seed {
  int64_t rbeg;
  int64_t qbeg, len, score;
};

struct Chain {
  int64_t rid;
  int32_t is_alt;
  int32_t kept;
  int64_t first;
  int64_t w;
  double frac_rep;
  std::vector<Seed> seeds;
  int64_t pos() const { return seeds[0].rbeg; }
  int64_t qbeg() const { return seeds[0].qbeg; }
  int64_t qend() const {
    const Seed& s = seeds.back();
    return s.qbeg + s.len;
  }
};

struct Opts {
  int64_t w, max_chain_gap, min_chain_weight, min_seed_len, max_chain_extend;
  double mask_level, drop_ratio;
  int64_t max_occ;
};

struct Bns {
  int64_t l_pac, n;
  const int64_t* off;
  const int64_t* len;
  const int32_t* is_alt;

  int64_t pos_to_rid(int64_t pos) const {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (pos < off[mid])
        hi = mid;
      else if (pos >= off[mid] + len[mid])
        lo = mid + 1;
      else
        return mid;
    }
    return -1;
  }
  int64_t intv_to_rid(int64_t rb, int64_t re) const {
    if ((rb < l_pac) != (re <= l_pac)) return -1;
    int64_t fb = rb < l_pac ? rb : (l_pac << 1) - 1 - (re - 1);
    int64_t fe = rb < l_pac ? (re - 1) : (l_pac << 1) - 1 - rb;
    int64_t rid = pos_to_rid(fb);
    if (rid < 0 || rid != pos_to_rid(fe)) return -1;
    return rid;
  }
};

bool test_and_merge(const Opts& o, int64_t l_pac, Chain& c, const Seed& p,
                    int64_t seed_rid) {
  const Seed& last = c.seeds.back();
  int64_t qend = last.qbeg + last.len;
  int64_t rend = last.rbeg + last.len;
  if (seed_rid != c.rid) return false;
  if (p.qbeg >= c.seeds[0].qbeg && p.qbeg + p.len <= qend &&
      p.rbeg >= c.seeds[0].rbeg && p.rbeg + p.len <= rend)
    return true;  // contained
  if ((last.rbeg < l_pac || c.seeds[0].rbeg < l_pac) && p.rbeg >= l_pac)
    return false;
  int64_t x = p.qbeg - last.qbeg;
  int64_t y = p.rbeg - last.rbeg;
  if (y >= 0 && x - y <= o.w && y - x <= o.w && x - last.len < o.max_chain_gap &&
      y - last.len < o.max_chain_gap) {
    c.seeds.push_back(p);
    return true;
  }
  return false;
}

int64_t chain_weight(const Chain& c) {
  int64_t wq = 0, end = 0;
  for (const Seed& s : c.seeds) {
    if (s.qbeg >= end)
      wq += s.len;
    else if (s.qbeg + s.len > end)
      wq += s.qbeg + s.len - end;
    end = std::max(end, s.qbeg + s.len);
  }
  int64_t wr = 0;
  end = 0;
  for (const Seed& s : c.seeds) {
    if (s.rbeg >= end)
      wr += s.len;
    else if (s.rbeg + s.len > end)
      wr += s.rbeg + s.len - end;
    end = std::max(end, s.rbeg + s.len);
  }
  return std::min(std::min(wq, wr), (int64_t)(1 << 30) - 1);
}

void chain_one(const Opts& o, const Bns& bns, int64_t qlen,
               const int64_t* intv,  // rows of 5
               int64_t n_intv, const int64_t* rbegs, const int64_t* rbeg_off,
               const int64_t* n_rbeg, std::vector<Chain>& out) {
  if (qlen < o.min_seed_len) return;
  std::vector<Chain> chains;  // sorted by pos
  std::vector<int64_t> keys;
  for (int64_t pi = 0; pi < n_intv; ++pi) {
    const int64_t* p = intv + pi * 5;
    int64_t slen = p[4] - p[3];
    const int64_t* rb = rbegs + rbeg_off[pi];
    for (int64_t ri = 0; ri < n_rbeg[pi]; ++ri) {
      int64_t rbeg = rb[ri];
      int64_t rid = bns.intv_to_rid(rbeg, rbeg + slen);
      if (rid < 0) continue;
      Seed s{rbeg, p[3], slen, slen};
      bool to_add = true;
      if (!chains.empty()) {
        // bisect_right(keys, rbeg) - 1
        int64_t i =
            std::upper_bound(keys.begin(), keys.end(), rbeg) - keys.begin() - 1;
        if (i >= 0 && test_and_merge(o, bns.l_pac, chains[i], s, rid))
          to_add = false;
      }
      if (to_add) {
        Chain c;
        c.rid = rid;
        c.is_alt = bns.is_alt ? bns.is_alt[rid] : 0;
        c.kept = 0;
        c.first = -1;
        c.frac_rep = 0.0;
        c.seeds.push_back(s);
        int64_t i =
            std::upper_bound(keys.begin(), keys.end(), rbeg) - keys.begin();
        chains.insert(chains.begin() + i, std::move(c));
        keys.insert(keys.begin() + i, rbeg);
      }
    }
  }
  // frac_rep from over-occurring intervals
  int64_t b = 0, e = 0, l_rep = 0;
  for (int64_t pi = 0; pi < n_intv; ++pi) {
    const int64_t* p = intv + pi * 5;
    if (p[2] <= o.max_occ) continue;
    if (p[3] > e) {
      l_rep += e - b;
      b = p[3];
      e = p[4];
    } else {
      e = std::max(e, p[4]);
    }
  }
  l_rep += e - b;
  for (Chain& c : chains) c.frac_rep = (double)l_rep / qlen;

  // ---- chain_flt ----
  for (Chain& c : chains) c.w = chain_weight(c);
  chains.erase(std::remove_if(chains.begin(), chains.end(),
                              [&](const Chain& c) {
                                return c.w < o.min_chain_weight;
                              }),
               chains.end());
  if (chains.empty()) return;
  for (Chain& c : chains) {
    c.kept = 0;
    c.first = -1;
  }
  std::stable_sort(chains.begin(), chains.end(),
                   [](const Chain& a, const Chain& b) { return a.w > b.w; });
  chains[0].kept = 3;
  std::vector<int64_t> kept_idx{0};
  for (size_t i = 1; i < chains.size(); ++i) {
    Chain& ci = chains[i];
    bool large_ovlp = false, broke = false;
    for (int64_t j : kept_idx) {
      Chain& cj = chains[j];
      int64_t b_max = std::max(cj.qbeg(), ci.qbeg());
      int64_t e_min = std::min(cj.qend(), ci.qend());
      if (e_min > b_max && !(cj.is_alt && !ci.is_alt)) {
        int64_t li = ci.qend() - ci.qbeg();
        int64_t lj = cj.qend() - cj.qbeg();
        int64_t min_l = std::min(li, lj);
        if (e_min - b_max >= min_l * o.mask_level && min_l < o.max_chain_gap) {
          large_ovlp = true;
          if (cj.first < 0) cj.first = (int64_t)i;
          if (ci.w < cj.w * o.drop_ratio &&
              cj.w - ci.w >= (o.min_seed_len << 1)) {
            broke = true;
            break;
          }
        }
      }
    }
    if (!broke) {
      kept_idx.push_back((int64_t)i);
      ci.kept = large_ovlp ? 2 : 3;
    }
  }
  for (int64_t j : kept_idx)
    if (chains[j].first >= 0)
      chains[chains[j].first].kept = std::max(chains[chains[j].first].kept, 1);
  int64_t n_ext = 0;
  for (Chain& c : chains) {
    if (c.kept == 0) continue;
    if (c.kept >= 2) {
      ++n_ext;
      if (n_ext > o.max_chain_extend) continue;
    }
    out.push_back(std::move(c));
  }
}

}  // namespace

extern "C" {

// probe/fill: out_* null on pass 1; n_chain/n_seed_total filled both passes.
// chain rows: (rid, is_alt, n_seeds, frac_rep_bits) int64 x4 per chain;
// seed rows: (rbeg, qbeg, len, score) int64 x4.
void bwamem_chain_batch(
    int64_t l_pac, int64_t n_anns, const int64_t* ann_off,
    const int64_t* ann_len, const int32_t* ann_is_alt, int64_t n_reads,
    const int32_t* qlen, const int64_t* intv, const int64_t* intv_off,
    const int64_t* n_intv, const int64_t* rbegs, const int64_t* rbeg_off,
    const int64_t* n_rbeg, int64_t w, int64_t max_chain_gap,
    int64_t min_chain_weight, int64_t min_seed_len, int64_t max_chain_extend,
    double mask_level, double drop_ratio, int64_t max_occ,
    int64_t* n_chain_out, int64_t* n_seed_out, int64_t* chain_rows_off,
    int64_t* seed_rows_off, int64_t* chain_rows, int64_t* seed_rows) {
  Opts o{w, max_chain_gap, min_chain_weight, min_seed_len, max_chain_extend,
         mask_level, drop_ratio, max_occ};
  Bns bns{l_pac, n_anns, ann_off, ann_len, ann_is_alt};
#pragma omp parallel for schedule(dynamic, 8)
  for (int64_t i = 0; i < n_reads; ++i) {
    std::vector<Chain> chains;
    chain_one(o, bns, qlen[i], intv + intv_off[i] * 5, n_intv[i], rbegs,
              rbeg_off + intv_off[i], n_rbeg + intv_off[i], chains);
    n_chain_out[i] = (int64_t)chains.size();
    int64_t ns = 0;
    for (const Chain& c : chains) ns += (int64_t)c.seeds.size();
    n_seed_out[i] = ns;
    if (chain_rows != nullptr) {
      int64_t* cr = chain_rows + chain_rows_off[i] * 4;
      int64_t* sr = seed_rows + seed_rows_off[i] * 4;
      for (const Chain& c : chains) {
        cr[0] = c.rid;
        cr[1] = c.is_alt;
        cr[2] = (int64_t)c.seeds.size();
        double fr = c.frac_rep;
        std::memcpy(&cr[3], &fr, 8);
        cr += 4;
        for (const Seed& s : c.seeds) {
          sr[0] = s.rbeg;
          sr[1] = s.qbeg;
          sr[2] = s.len;
          sr[3] = s.score;
          sr += 4;
        }
      }
    }
  }
}

}  // extern "C"
