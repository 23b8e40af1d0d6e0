// Fused native align core: chaining + chain extension in one call.
//
// Mirrors engine/chain.py (mem_chain/chain_flt) + engine/extend.py
// (chain2aln with ksw_extend2) exactly — the validated Python oracles.
// Short-read path only: callers route reads long enough to trigger
// mem_flt_chained_seeds (~700bp+) through the Python staged path.
//
// Built together with ksw.cpp and chain.cpp logic (this file includes its
// own copies of the chain structs to stay self-contained; the standalone
// stage entry points in chain.cpp remain for the unfused path).

#include <algorithm>
#include <cmath>
#include <coroutine>
#include <cstdint>
#include <cstring>
#include <exception>
#include <vector>

// from ksw.cpp
extern "C" void bwamem_ksw_extend_batch(
    int64_t n_jobs, const uint8_t* qbuf, const int64_t* qoff,
    const int32_t* qlen, const uint8_t* tbuf, const int64_t* toff,
    const int32_t* tlen, const int8_t* mat, int o_del, int e_del, int o_ins,
    int e_ins, int zdrop, const int32_t* h0, const int32_t* w,
    const int32_t* end_bonus, int32_t* out);
extern "C" void bwamem_ksw_extend_single(
    const uint8_t* q, int32_t qlen, const uint8_t* t, int32_t tlen,
    const int8_t* mat, int o_del, int e_del, int o_ins, int e_ins, int zdrop,
    int32_t h0, int32_t w, int32_t end_bonus, int32_t* out6);

namespace {

constexpr int MAX_BAND_TRY = 2;

struct Seed {
  int64_t rbeg, qbeg, len, score;
};

struct Chain {
  int64_t rid;
  int32_t is_alt;
  int64_t first;
  int32_t kept;
  int64_t w;
  double frac_rep;
  std::vector<Seed> seeds;
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
  const int8_t* mat;
  int o_del, e_del, o_ins, e_ins, zdrop, pen_clip5, pen_clip3, a;

  int64_t max_gap(int64_t qlen) const {
    int64_t l_del = (int64_t)((double)(qlen * a - o_del) / e_del + 1.0);
    int64_t l_ins = (int64_t)((double)(qlen * a - o_ins) / e_ins + 1.0);
    int64_t l = std::max(std::max(l_del, l_ins), (int64_t)1);
    return std::min(l, w << 1);
  }
};

struct Bns {
  int64_t l_pac, n;
  const int64_t* off;
  const int64_t* len;
  const int32_t* is_alt;
  const uint8_t* fwd;  // unpacked forward reference codes

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
  // doubled-domain fetch into dst ([beg, end), no strand straddle)
  void get_seq(int64_t beg, int64_t end, uint8_t* dst) const {
    if (beg >= l_pac) {
      int64_t fb = 2 * l_pac - end, fe = 2 * l_pac - beg;
      for (int64_t i = 0; i < fe - fb; ++i) {
        uint8_t c = fwd[fe - 1 - i];
        dst[i] = c < 4 ? 3 - c : c;
      }
    } else {
      std::memcpy(dst, fwd + beg, end - beg);
    }
  }
};

struct Reg {
  int64_t rb, re, qb, qe, rid;
  int64_t score, truesc, w, seedcov, seedlen0;
  double frac_rep;
};

bool test_and_merge(const Opts& o, int64_t l_pac, Chain& c, const Seed& p,
                    int64_t rid) {
  const Seed& last = c.seeds.back();
  int64_t qend = last.qbeg + last.len, rend = last.rbeg + last.len;
  if (rid != c.rid) return false;
  if (p.qbeg >= c.seeds[0].qbeg && p.qbeg + p.len <= qend &&
      p.rbeg >= c.seeds[0].rbeg && p.rbeg + p.len <= rend)
    return true;
  if ((last.rbeg < l_pac || c.seeds[0].rbeg < l_pac) && p.rbeg >= l_pac)
    return false;
  int64_t x = p.qbeg - last.qbeg, y = p.rbeg - last.rbeg;
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

void build_chains(const Opts& o, const Bns& bns, int64_t qlen,
                  const int64_t* intv, int64_t n_intv, const int64_t* rbegs,
                  const int64_t* rbeg_off, const int64_t* n_rbeg,
                  std::vector<Chain>& out) {
  if (qlen < o.min_seed_len) return;
  std::vector<Chain> chains;
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
  // chain_flt
  for (Chain& c : chains) c.w = chain_weight(c);
  chains.erase(std::remove_if(
                   chains.begin(), chains.end(),
                   [&](const Chain& c) { return c.w < o.min_chain_weight; }),
               chains.end());
  if (chains.empty()) return;
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

void ksw_one(const Opts& o, const uint8_t* q, int qlen, const uint8_t* t,
             int tlen, int wband, int bonus, int h0, int32_t out6[6]) {
  bwamem_ksw_extend_single(q, qlen, t, tlen, o.mat, o.o_del, o.e_del,
                           o.o_ins, o.e_ins, o.zdrop, h0, wband, bonus,
                           out6);
}

// ---- extension scheduling -------------------------------------------------
// chain2aln ([EXT] mem_chain2aln; python oracle engine/extend.py) runs as a
// COROUTINE that awaits every banded-extension call.  Two drivers share the
// one implementation:
//   * immediate mode — the await executes the scalar kernel inline and never
//     suspends: the classic sequential per-read path, bit-identical;
//   * wave mode — a block of reads runs concurrently; parked jobs flush
//     through the 16-lane SoA batch kernel (bwamem_ksw_extend_batch) between
//     resume rounds, so the per-read serial dependencies (seed pruning
//     against earlier regions, left->right h0 chaining, band retries) are
//     preserved while the DP itself runs 16 jobs per AVX2 pass.
struct ExtJob {
  const uint8_t* q;
  const uint8_t* t;
  int32_t qlen, tlen, w, h0, bonus;
  int32_t r6[6];
};

struct ExtSched {
  const Opts* o;
  bool immediate = true;
  std::vector<ExtJob*> jobs;
  std::vector<std::coroutine_handle<>> owners;
};

struct ExtTask {
  struct promise_type {
    ExtTask get_return_object() {
      return ExtTask{std::coroutine_handle<promise_type>::from_promise(*this)};
    }
    std::suspend_always initial_suspend() noexcept { return {}; }
    std::suspend_always final_suspend() noexcept { return {}; }
    void return_void() noexcept {}
    void unhandled_exception() { std::terminate(); }
  };
  std::coroutine_handle<promise_type> h;
};

struct ExtWaiter {
  ExtSched* s;
  ExtJob* j;
  bool await_ready() const noexcept {
    if (s->immediate) {
      ksw_one(*s->o, j->q, j->qlen, j->t, j->tlen, j->w, j->bonus, j->h0,
              j->r6);
      return true;
    }
    return false;
  }
  void await_suspend(std::coroutine_handle<> h) const noexcept {
    s->jobs.push_back(j);
    s->owners.push_back(h);
  }
  void await_resume() const noexcept {}
};

// mirror of engine/extend.py::chain2aln, one coroutine per READ (all its
// chains) so intra-read ordering/pruning semantics stay sequential
ExtTask chains2aln_co(const Opts& o, const Bns& bns, int64_t qlen,
                      const uint8_t* query, const std::vector<Chain>* chains,
                      std::vector<Reg>* regs_out, ExtSched* sched) {
  std::vector<Reg>& regs = *regs_out;
  std::vector<uint8_t> rseq_buf, rev_buf;
  std::vector<int8_t> srt_alive;
  for (const Chain& c : *chains) {
    if (c.seeds.empty()) continue;
    int64_t l_pac = bns.l_pac;
    int64_t rmax0 = l_pac << 1, rmax1 = 0;
    for (const Seed& t : c.seeds) {
      int64_t b = t.rbeg - (t.qbeg + o.max_gap(t.qbeg));
      int64_t e = t.rbeg + t.len +
                  ((qlen - t.qbeg - t.len) + o.max_gap(qlen - t.qbeg - t.len));
      rmax0 = std::min(rmax0, b);
      rmax1 = std::max(rmax1, e);
    }
    rmax0 = std::max(rmax0, (int64_t)0);
    rmax1 = std::min(rmax1, l_pac << 1);
    if (rmax0 < l_pac && l_pac < rmax1) {
      if (c.seeds[0].rbeg < l_pac)
        rmax1 = l_pac;
      else
        rmax0 = l_pac;
    }
    int64_t mid = c.seeds[0].rbeg;
    bool is_rev = mid >= l_pac;
    int64_t fwd_mid = is_rev ? (l_pac << 1) - 1 - mid : mid;
    int64_t rid = bns.pos_to_rid(fwd_mid);
    int64_t far_beg = bns.off[rid];
    int64_t far_end = far_beg + bns.len[rid];
    if (is_rev) {
      int64_t t = far_beg;
      far_beg = (l_pac << 1) - far_end;
      far_end = (l_pac << 1) - t;
    }
    rmax0 = std::max(rmax0, far_beg);
    rmax1 = std::min(rmax1, far_end);
    rseq_buf.resize(rmax1 - rmax0);
    bns.get_seq(rmax0, rmax1, rseq_buf.data());
    const uint8_t* rseq = rseq_buf.data();

    size_t n = c.seeds.size();
    std::vector<int64_t> srt(n);
    for (size_t i = 0; i < n; ++i) srt[i] = (int64_t)i;
    std::stable_sort(srt.begin(), srt.end(), [&](int64_t a, int64_t b) {
      return c.seeds[a].score < c.seeds[b].score ||
             (c.seeds[a].score == c.seeds[b].score && a < b);
    });
    srt_alive.assign(n, 1);
    for (int64_t k = (int64_t)n - 1; k >= 0; --k) {
      const Seed& s = c.seeds[srt[k]];
      // pruning against existing regs
      bool contained = false;
      for (const Reg& p : regs) {
        if (s.rbeg < p.rb || s.rbeg + s.len > p.re || s.qbeg < p.qb ||
            s.qbeg + s.len > p.qe)
          continue;
        if (s.len - p.seedlen0 > 0.1 * qlen) continue;
        int64_t qd = s.qbeg - p.qb, rd = s.rbeg - p.rb;
        int64_t w = std::min(o.max_gap(std::min(qd, rd)), p.w);
        if (qd - rd < w && rd - qd < w) {
          contained = true;
          break;
        }
        qd = p.qe - (s.qbeg + s.len);
        rd = p.re - (s.rbeg + s.len);
        w = std::min(o.max_gap(std::min(qd, rd)), p.w);
        if (qd - rd < w && rd - qd < w) {
          contained = true;
          break;
        }
      }
      if (contained) {
        bool diff = false;
        for (size_t i2 = k + 1; i2 < n; ++i2) {
          if (!srt_alive[i2]) continue;
          const Seed& t = c.seeds[srt[i2]];
          if (t.len < s.len * 0.95) continue;
          if (s.qbeg <= t.qbeg && s.qbeg + s.len - t.qbeg >= (s.len >> 2) &&
              t.qbeg - s.qbeg != t.rbeg - s.rbeg) {
            diff = true;
            break;
          }
          if (t.qbeg <= s.qbeg && t.qbeg + t.len - s.qbeg >= (s.len >> 2) &&
              s.qbeg - t.qbeg != s.rbeg - t.rbeg) {
            diff = true;
            break;
          }
        }
        if (!diff) {
          srt_alive[k] = 0;
          continue;
        }
      }
      Reg a;
      a.w = o.w;
      int64_t aw0 = o.w, aw1 = o.w;
      a.score = a.truesc = -1;
      a.rid = c.rid;
      ExtJob job;
      if (s.qbeg) {  // left extension
        rev_buf.resize(s.qbeg + (s.rbeg - rmax0));
        uint8_t* qs = rev_buf.data();
        for (int64_t i = 0; i < s.qbeg; ++i) qs[i] = query[s.qbeg - 1 - i];
        int64_t tmp = s.rbeg - rmax0;
        uint8_t* ts = qs + s.qbeg;
        for (int64_t i = 0; i < tmp; ++i) ts[i] = rseq[tmp - 1 - i];
        job.q = qs;
        job.t = ts;
        job.qlen = (int32_t)s.qbeg;
        job.tlen = (int32_t)tmp;
        job.bonus = o.pen_clip5;
        job.h0 = (int32_t)(s.len * o.a);
        for (int att = 0; att < MAX_BAND_TRY; ++att) {
          int64_t prev = a.score;
          aw0 = o.w << att;
          job.w = (int32_t)aw0;
          co_await ExtWaiter{sched, &job};
          a.score = job.r6[0];
          if (a.score == prev || job.r6[5] < (aw0 >> 1) + (aw0 >> 2)) break;
        }
        if (job.r6[4] <= 0 || job.r6[4] <= a.score - o.pen_clip5) {
          a.qb = s.qbeg - job.r6[1];
          a.rb = s.rbeg - job.r6[2];
          a.truesc = a.score;
        } else {
          a.qb = 0;
          a.rb = s.rbeg - job.r6[3];
          a.truesc = job.r6[4];
        }
      } else {
        a.score = a.truesc = s.len * o.a;
        a.qb = 0;
        a.rb = s.rbeg;
      }
      if (s.qbeg + s.len != qlen) {  // right extension
        int64_t sc0 = a.score;
        int64_t qe = s.qbeg + s.len;
        int64_t re_off = s.rbeg + s.len - rmax0;
        job.q = query + qe;
        job.t = rseq + re_off;
        job.qlen = (int32_t)(qlen - qe);
        job.tlen = (int32_t)(rmax1 - rmax0 - re_off);
        job.bonus = o.pen_clip3;
        job.h0 = (int32_t)sc0;
        for (int att = 0; att < MAX_BAND_TRY; ++att) {
          int64_t prev = a.score;
          aw1 = o.w << att;
          job.w = (int32_t)aw1;
          co_await ExtWaiter{sched, &job};
          a.score = job.r6[0];
          if (a.score == prev || job.r6[5] < (aw1 >> 1) + (aw1 >> 2)) break;
        }
        if (job.r6[4] <= 0 || job.r6[4] <= a.score - o.pen_clip3) {
          a.qe = qe + job.r6[1];
          a.re = rmax0 + re_off + job.r6[2];
          a.truesc += a.score - sc0;
        } else {
          a.qe = qlen;
          a.re = rmax0 + re_off + job.r6[3];
          a.truesc += job.r6[4] - sc0;
        }
      } else {
        a.qe = qlen;
        a.re = s.rbeg + s.len;
      }
      a.seedcov = 0;
      for (const Seed& t : c.seeds)
        if (t.qbeg >= a.qb && t.qbeg + t.len <= a.qe && t.rbeg >= a.rb &&
            t.rbeg + t.len <= a.re)
          a.seedcov += t.len;
      a.w = std::max(aw0, aw1);
      a.seedlen0 = s.len;
      a.frac_rep = c.frac_rep;
      regs.push_back(a);
    }
  }
  co_return;
}

// sequential driver: identical to the historical per-read chain2aln loop
void chains2aln(const Opts& o, const Bns& bns, int64_t qlen,
                const uint8_t* query, const std::vector<Chain>& chains,
                std::vector<Reg>& regs) {
  ExtSched sched{&o, true};
  ExtTask t = chains2aln_co(o, bns, qlen, query, &chains, &regs, &sched);
  t.h.resume();  // immediate mode: runs to completion without suspending
  t.h.destroy();
}

// flush parked jobs through the SoA batch kernel, then resume their owners
// (which may park the next band-retry attempt for the following round)
void flush_ext_wave(const Opts& o, ExtSched& sched) {
  size_t n = sched.jobs.size();
  if (!n) return;
  static thread_local std::vector<uint8_t> qb, tb;
  static thread_local std::vector<int64_t> qo, to;
  static thread_local std::vector<int32_t> ql, tl, h0v, wv, bv, out;
  qb.clear(); tb.clear(); qo.clear(); to.clear(); ql.clear(); tl.clear();
  h0v.clear(); wv.clear(); bv.clear();
  for (ExtJob* j : sched.jobs) {
    qo.push_back((int64_t)qb.size());
    qb.insert(qb.end(), j->q, j->q + j->qlen);
    to.push_back((int64_t)tb.size());
    tb.insert(tb.end(), j->t, j->t + j->tlen);
    ql.push_back(j->qlen);
    tl.push_back(j->tlen);
    h0v.push_back(j->h0);
    wv.push_back(j->w);
    bv.push_back(j->bonus);
  }
  out.assign(n * 6, 0);
  // nested-parallel note: called from inside the pipeline's parallel
  // region, the batch entry's own omp-for runs serially on this thread
  bwamem_ksw_extend_batch((int64_t)n, qb.data(), qo.data(), ql.data(),
                          tb.data(), to.data(), tl.data(), o.mat, o.o_del,
                          o.e_del, o.o_ins, o.e_ins, o.zdrop, h0v.data(),
                          wv.data(), bv.data(), out.data());
  for (size_t i = 0; i < n; ++i) std::memcpy(sched.jobs[i]->r6, &out[i * 6], 24);
  std::vector<std::coroutine_handle<>> owners = std::move(sched.owners);
  sched.jobs.clear();
  sched.owners.clear();
  for (auto h : owners) h.resume();
}

// wave driver: a block of reads concurrently, extensions batched 16-lane
void chains2aln_wave(const Opts& o, const Bns& bns, int64_t n,
                     const int64_t* qlens, const uint8_t* const* queries,
                     const std::vector<Chain>* chains_arr,
                     std::vector<Reg>* regs_arr) {
  ExtSched sched{&o, false};
  std::vector<std::coroutine_handle<ExtTask::promise_type>> hs;
  hs.reserve((size_t)n);
  for (int64_t i = 0; i < n; ++i)
    hs.push_back(chains2aln_co(o, bns, qlens[i], queries[i], &chains_arr[i],
                               &regs_arr[i], &sched)
                     .h);
  for (auto h : hs) h.resume();  // to the first parked job or completion
  while (!sched.jobs.empty()) flush_ext_wave(o, sched);
  for (auto h : hs) h.destroy();
}

}  // namespace

extern "C" {

// probe/fill protocol; reg rows of 11 int64: rb re qb qe rid score truesc
// w seedcov seedlen0 frac_rep_bits
void bwamem_align_regs_batch(
    const uint8_t* ref_fwd, int64_t l_pac, int64_t n_anns,
    const int64_t* ann_off, const int64_t* ann_len, const int32_t* ann_is_alt,
    int64_t n_reads, const uint8_t* rbuf, const int64_t* roff,
    const int32_t* rlen, const int64_t* intv, const int64_t* intv_off,
    const int64_t* n_intv, const int64_t* rbegs, const int64_t* rbeg_off,
    const int64_t* n_rbeg, int64_t w, int64_t max_chain_gap,
    int64_t min_chain_weight, int64_t min_seed_len, int64_t max_chain_extend,
    double mask_level, double drop_ratio, int64_t max_occ, const int8_t* mat,
    int o_del, int e_del, int o_ins, int e_ins, int zdrop, int pen_clip5,
    int pen_clip3, int match_a, int64_t* n_reg_out, const int64_t* reg_off,
    int64_t* reg_rows) {
  Opts o{w,    max_chain_gap, min_chain_weight, min_seed_len, max_chain_extend,
         mask_level, drop_ratio, max_occ, mat, o_del, e_del, o_ins, e_ins,
         zdrop, pen_clip5, pen_clip3, match_a};
  Bns bns{l_pac, n_anns, ann_off, ann_len, ann_is_alt, ref_fwd};
#pragma omp parallel for schedule(dynamic, 8)
  for (int64_t i = 0; i < n_reads; ++i) {
    std::vector<Chain> chains;
    build_chains(o, bns, rlen[i], intv + intv_off[i] * 5, n_intv[i], rbegs,
                 rbeg_off + intv_off[i], n_rbeg + intv_off[i], chains);
    std::vector<Reg> regs;
    chains2aln(o, bns, rlen[i], rbuf + roff[i], chains, regs);
    n_reg_out[i] = (int64_t)regs.size();
    if (reg_rows != nullptr) {
      int64_t* rr = reg_rows + reg_off[i] * 11;
      for (const Reg& r : regs) {
        rr[0] = r.rb;
        rr[1] = r.re;
        rr[2] = r.qb;
        rr[3] = r.qe;
        rr[4] = r.rid;
        rr[5] = r.score;
        rr[6] = r.truesc;
        rr[7] = r.w;
        rr[8] = r.seedcov;
        rr[9] = r.seedlen0;
        std::memcpy(&rr[10], &r.frac_rep, 8);
        rr += 11;
      }
    }
  }
}

}  // extern "C"
