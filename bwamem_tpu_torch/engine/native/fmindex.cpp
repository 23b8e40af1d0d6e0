// Native FM-index queries + SMEM seeding (host runtime hot path).
//
// C++ equivalent of the reference's [EXT] bwt.c role: Occ rank queries over
// the checkpointed BWT, bidirectional interval extension, SMEM generation
// (three-round mem_collect_intv seeding) and sampled-SA lookup.  Semantics
// mirror the validated Python oracle (engine/fmindex.py + engine/seed.py)
// exactly — same conventions (conceptual rows with the implicit sentinel at
// `primary`, ok[] indexed by queried-space symbol).
//
// C ABI consumed by ../native_fm.py.  Index arrays are borrowed pointers
// into the numpy arrays held by the Python FMIndex (int64 ckpt, uint32
// words, int64 L2/sa).

#include <algorithm>
#include <coroutine>
#include <cstdint>
#include <cstring>
#include <exception>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif
#if defined(__AVX512VPOPCNTDQ__) && defined(__AVX512VL__) && defined(__AVX2__)
#include <immintrin.h>
#define BWAMEM_OCC_AVX512 1
#endif

namespace {

struct FM {
  // fused block layout: per 128-base block one 64-byte (one cache line)
  // record [4 x int64 checkpoint | 8 x uint32 packed chars] — bwa's
  // interleaved-occ idea taken to exactly one line per rank query
  // (separate ckpt/words arrays cost two misses per query).
  const uint8_t* fused;  // [nb][64], 64-byte aligned
  const int64_t* L2;     // [5]
  const int64_t* sa;     // [n_sa]
  int64_t primary, seq_len, sa_intv;
};

inline const int64_t* blk_ckpt(const FM& fm, int64_t b) {
  return reinterpret_cast<const int64_t*>(fm.fused + (b << 6));
}
inline const uint32_t* blk_words(const FM& fm, int64_t b) {
  return reinterpret_cast<const uint32_t*>(fm.fused + (b << 6) + 32);
}

// keep-mask over a 64-bit word pair = 32 packed chars: tab[v] masks the
// low bit of each of the first v chars (branchless prefix selection).
// Char j of the pair lives in 32-bit half j>>4 at bits {31-2(j&15) hi,
// 30-2(j&15) lo}; little-endian pairing puts half 0 in the low 32 bits.
struct Keep64Tab {
  uint64_t t[33];
  constexpr Keep64Tab() : t{} {
    for (int v = 0; v <= 32; ++v) {
      auto k32 = [](int x) -> uint32_t {
        if (x <= 0) return 0u;
        if (x >= 16) return 0x55555555u;
        return (uint32_t)(0xFFFFFFFFu << (32 - 2 * x)) & 0x55555555u;
      };
      t[v] = (uint64_t)k32(v) | ((uint64_t)k32(v - 16) << 32);
    }
  }
};
constexpr Keep64Tab kKeep64;

inline uint64_t keep64(int v) {
  return kKeep64.t[v < 0 ? 0 : (v > 32 ? 32 : v)];
}

// AVX512-VPOPCNTDQ fast path: the whole 128-char block is one 256-bit
// register, the prefix mask comes from a 4-lane gather into kKeep64, and
// the count is branchless — no data-dependent early exit to mispredict
// (the scalar loop's `within > 0` break is ~random during seeding).
#if BWAMEM_OCC_AVX512
inline __m256i occ_keep_vec(int within) {
  __m256i v = _mm256_sub_epi64(_mm256_set1_epi64x(within),
                               _mm256_set_epi64x(96, 64, 32, 0));
  v = _mm256_max_epi64(v, _mm256_setzero_si256());
  v = _mm256_min_epi64(v, _mm256_set1_epi64x(32));
  return _mm256_i64gather_epi64(
      reinterpret_cast<const long long*>(kKeep64.t), v, 8);
}

inline int64_t occ_hsum4(__m256i x) {
  __m128i s = _mm_add_epi64(_mm256_castsi256_si128(x),
                            _mm256_extracti128_si256(x, 1));
  return _mm_cvtsi128_si64(s) + _mm_extract_epi64(s, 1);
}
#endif

// counts of all 4 symbols among conceptual BWT chars [0..k] inclusive.
// Inner loop runs on 64-bit word pairs (half the iterations of the
// 32-bit formulation; one popcountll per symbol per 32 chars).
inline void occ4(const FM& fm, int64_t k, int64_t cnt[4]) {
  if (k == fm.seq_len) {
    for (int c = 0; c < 4; ++c) cnt[c] = fm.L2[c + 1] - fm.L2[c];
    return;
  }
  if (k == -1) {
    cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
    return;
  }
  int64_t kk = k - (k >= fm.primary);
  int64_t block = kk >> 7;
  int within = (int)(kk & 127) + 1;  // inclusive char count
  const int64_t* base = blk_ckpt(fm, block);
#if BWAMEM_OCC_AVX512
  const __m256i M = _mm256_set1_epi64x(0x5555555555555555ll);
  __m256i w = _mm256_load_si256(
      reinterpret_cast<const __m256i*>(blk_words(fm, block)));
  __m256i hi = _mm256_and_si256(_mm256_srli_epi64(w, 1), M);
  __m256i lo = _mm256_and_si256(w, M);
  __m256i nhi = _mm256_xor_si256(hi, M), nlo = _mm256_xor_si256(lo, M);
  __m256i keep = occ_keep_vec(within);
  cnt[0] = base[0] + occ_hsum4(_mm256_popcnt_epi64(
      _mm256_and_si256(_mm256_and_si256(nhi, nlo), keep)));
  cnt[1] = base[1] + occ_hsum4(_mm256_popcnt_epi64(
      _mm256_and_si256(_mm256_and_si256(nhi, lo), keep)));
  cnt[2] = base[2] + occ_hsum4(_mm256_popcnt_epi64(
      _mm256_and_si256(_mm256_and_si256(hi, nlo), keep)));
  cnt[3] = base[3] + occ_hsum4(_mm256_popcnt_epi64(
      _mm256_and_si256(_mm256_and_si256(hi, lo), keep)));
#else
  const uint64_t* w = reinterpret_cast<const uint64_t*>(blk_words(fm, block));
  int64_t c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  constexpr uint64_t M = 0x5555555555555555ull;
  for (int wi = 0; wi < 4 && within > 0; ++wi, within -= 32) {
    uint64_t keep = keep64(within);
    uint64_t hi = (w[wi] >> 1) & M;
    uint64_t lo = w[wi] & M;
    uint64_t nhi = hi ^ M, nlo = lo ^ M;
    c0 += __builtin_popcountll(nhi & nlo & keep);
    c1 += __builtin_popcountll(nhi & lo & keep);
    c2 += __builtin_popcountll(hi & nlo & keep);
    c3 += __builtin_popcountll(hi & lo & keep);
  }
  cnt[0] = base[0] + c0;
  cnt[1] = base[1] + c1;
  cnt[2] = base[2] + c2;
  cnt[3] = base[3] + c3;
#endif
}

// count of ONE symbol c among conceptual chars [0..k] inclusive — the
// SA-walk primitive (inv_psi needs only the walked symbol's rank; doing
// one popcount per pair instead of four quarters the walk's ALU work).
inline int64_t occ1(const FM& fm, int64_t k, int c) {
  if (k == fm.seq_len) return fm.L2[c + 1] - fm.L2[c];
  if (k == -1) return 0;
  int64_t kk = k - (k >= fm.primary);
  int64_t block = kk >> 7;
  int within = (int)(kk & 127) + 1;
  const int64_t* base = blk_ckpt(fm, block);
#if BWAMEM_OCC_AVX512
  const __m256i M = _mm256_set1_epi64x(0x5555555555555555ll);
  __m256i w = _mm256_load_si256(
      reinterpret_cast<const __m256i*>(blk_words(fm, block)));
  __m256i hi = _mm256_and_si256(_mm256_srli_epi64(w, 1), M);
  __m256i lo = _mm256_and_si256(w, M);
  __m256i xh = (c & 2) ? _mm256_setzero_si256() : M;
  __m256i xl = (c & 1) ? _mm256_setzero_si256() : M;
  __m256i m = _mm256_and_si256(_mm256_xor_si256(hi, xh),
                               _mm256_xor_si256(lo, xl));
  return base[c] + occ_hsum4(_mm256_popcnt_epi64(
      _mm256_and_si256(m, occ_keep_vec(within))));
#else
  const uint64_t* w = reinterpret_cast<const uint64_t*>(blk_words(fm, block));
  constexpr uint64_t M = 0x5555555555555555ull;
  // symbol match via XOR: chars equal to c have both plane bits zero in t
  uint64_t xh = (c & 2) ? 0 : M, xl = (c & 1) ? 0 : M;
  int64_t n = 0;
  for (int wi = 0; wi < 4 && within > 0; ++wi, within -= 32) {
    uint64_t keep = keep64(within);
    uint64_t hi = (w[wi] >> 1) & M;
    uint64_t lo = w[wi] & M;
    n += __builtin_popcountll((hi ^ xh) & (lo ^ xl) & keep);
  }
  return base[c] + n;
#endif
}

// paired rank query ([EXT] bwt_2occ4): when both positions fall in the same
// 128-char block (the common case for small intervals during extension),
// share the checkpoint row + word gathers and count both prefixes in one
// pass — bwa's key memory-traffic optimization.
inline void occ4_pair(const FM& fm, int64_t k, int64_t l, int64_t ck[4],
                      int64_t cl[4]) {
  if (k == fm.seq_len || k == -1 || l == fm.seq_len || l == -1) {
    occ4(fm, k, ck);
    occ4(fm, l, cl);
    return;
  }
  int64_t kk = k - (k >= fm.primary);
  int64_t ll = l - (l >= fm.primary);
  if ((kk >> 7) != (ll >> 7)) {
    // distinct blocks: overlap the two misses instead of serializing them
    __builtin_prefetch(fm.fused + ((ll >> 7) << 6));
    occ4(fm, k, ck);
    occ4(fm, l, cl);
    return;
  }
  int64_t block = kk >> 7;
  int wk = (int)(kk & 127) + 1;  // k's inclusive char count (k <= l here)
  int wl = (int)(ll & 127) + 1;
  const int64_t* base = blk_ckpt(fm, block);
#if BWAMEM_OCC_AVX512
  const __m256i M = _mm256_set1_epi64x(0x5555555555555555ll);
  __m256i w = _mm256_load_si256(
      reinterpret_cast<const __m256i*>(blk_words(fm, block)));
  __m256i hi = _mm256_and_si256(_mm256_srli_epi64(w, 1), M);
  __m256i lo = _mm256_and_si256(w, M);
  __m256i nhi = _mm256_xor_si256(hi, M), nlo = _mm256_xor_si256(lo, M);
  __m256i m[4] = {_mm256_and_si256(nhi, nlo), _mm256_and_si256(nhi, lo),
                  _mm256_and_si256(hi, nlo), _mm256_and_si256(hi, lo)};
  __m256i keepk = occ_keep_vec(wk), keepl = occ_keep_vec(wl);
  for (int c = 0; c < 4; ++c) {
    ck[c] = base[c] +
            occ_hsum4(_mm256_popcnt_epi64(_mm256_and_si256(m[c], keepk)));
    cl[c] = base[c] +
            occ_hsum4(_mm256_popcnt_epi64(_mm256_and_si256(m[c], keepl)));
  }
#else
  const uint64_t* w = reinterpret_cast<const uint64_t*>(blk_words(fm, block));
  int64_t a[4] = {0, 0, 0, 0}, bcnt[4] = {0, 0, 0, 0};
  constexpr uint64_t M = 0x5555555555555555ull;
  int rk = wk, rl = wl;
  for (int wi = 0; wi < 4 && rl > 0; ++wi, rk -= 32, rl -= 32) {
    uint64_t hi = (w[wi] >> 1) & M;
    uint64_t lo = w[wi] & M;
    uint64_t nhi = hi ^ M, nlo = lo ^ M;
    uint64_t m0 = nhi & nlo, m1 = nhi & lo, m2 = hi & nlo, m3 = hi & lo;
    uint64_t keepl = keep64(rl);
    bcnt[0] += __builtin_popcountll(m0 & keepl);
    bcnt[1] += __builtin_popcountll(m1 & keepl);
    bcnt[2] += __builtin_popcountll(m2 & keepl);
    bcnt[3] += __builtin_popcountll(m3 & keepl);
    if (rk > 0) {
      uint64_t keepk = keep64(rk);
      a[0] += __builtin_popcountll(m0 & keepk);
      a[1] += __builtin_popcountll(m1 & keepk);
      a[2] += __builtin_popcountll(m2 & keepk);
      a[3] += __builtin_popcountll(m3 & keepk);
    }
  }
  for (int c = 0; c < 4; ++c) {
    ck[c] = base[c] + a[c];
    cl[c] = base[c] + bcnt[c];
  }
#endif
}

struct Intv {
  int64_t x0, x1, s;
  int64_t info;  // qb<<32 | qe
};

// bidirectional extension; ok[] indexed by queried-space symbol (bwa conv.)
inline void bwt_extend(const FM& fm, const Intv& ik, Intv ok[4], bool is_back) {
  int64_t tk[4], tl[4];
  int64_t xq = is_back ? ik.x0 : ik.x1;
  int64_t xo = is_back ? ik.x1 : ik.x0;
  occ4_pair(fm, xq - 1, xq - 1 + ik.s, tk, tl);
  int64_t sz[4], nq[4];
  for (int c = 0; c < 4; ++c) {
    nq[c] = fm.L2[c] + 1 + tk[c];
    sz[c] = tl[c] - tk[c];
  }
  int64_t has_sent = (xq <= fm.primary && xq + ik.s - 1 >= fm.primary) ? 1 : 0;
  int64_t oo[4];
  oo[3] = xo + has_sent;
  oo[2] = oo[3] + sz[3];
  oo[1] = oo[2] + sz[2];
  oo[0] = oo[1] + sz[1];
  for (int c = 0; c < 4; ++c) {
    if (is_back) {
      ok[c].x0 = nq[c];
      ok[c].x1 = oo[c];
    } else {
      ok[c].x0 = oo[c];
      ok[c].x1 = nq[c];
    }
    ok[c].s = sz[c];
  }
}

inline void set_intv(const FM& fm, int c, Intv& ik) {
  ik.x0 = fm.L2[c] + 1;
  ik.x1 = fm.L2[3 - c] + 1;
  ik.s = fm.L2[c + 1] - fm.L2[c];
  ik.info = 0;
}

// ---------------------------------------------------------------------------
// Interleaved seeding: SMEM generation is a serial pointer-chase through the
// occ table (every bwt_extend = one-two random 64-byte blocks), but chases
// for DIFFERENT reads are independent.  The three-round collect_intv runs as
// a C++20 coroutine that suspends immediately before every rank query after
// prefetching its block(s); a per-thread scheduler round-robins G reads, so
// each lane's block arrives while the other lanes compute — ~G misses in
// flight per core instead of one.  Control flow is the plain
// smem1a/seed_strategy1/collect_intv code with suspension points added
// (semantics pinned by the interval-exact oracle tests + fuzz).

struct SeedTask {
  struct promise_type {
    SeedTask get_return_object() {
      return SeedTask{
          std::coroutine_handle<promise_type>::from_promise(*this)};
    }
    std::suspend_always initial_suspend() noexcept { return {}; }
    std::suspend_always final_suspend() noexcept { return {}; }
    void return_void() noexcept {}
    void unhandled_exception() { std::terminate(); }
  };
  std::coroutine_handle<promise_type> h;
};

// Suspend-after-prefetch of the occ block(s) a bwt_extend is about to read.
struct PfExtend {
  const FM* fm;
  int64_t k, l;  // occ4_pair(k, l) positions (k = xq-1, l = xq-1+s)
  bool await_ready() const noexcept {
    if (k >= 0 && k < fm->seq_len) {
      int64_t kk = k - (k >= fm->primary);
      __builtin_prefetch(fm->fused + ((kk >> 7) << 6));
    }
    if (l >= 0 && l < fm->seq_len) {
      int64_t ll = l - (l >= fm->primary);
      __builtin_prefetch(fm->fused + ((ll >> 7) << 6));
    }
    return false;  // always yield to the lane scheduler
  }
  void await_suspend(std::coroutine_handle<>) const noexcept {}
  void await_resume() const noexcept {}
};

// Full three-round mem_collect_intv as one coroutine (the single source of
// truth for the native seeding control flow).
static SeedTask collect_intv_co(const FM& fm, const uint8_t* q, int len,
                                int min_seed_len, int split_len,
                                int split_width, int64_t max_mem_intv,
                                std::vector<Intv>& mems) {
  std::vector<Intv> tmp, curr, prev;
  // rounds 1 (all starts, min_intv=1) and 2 (re-seed long/low-occ mems)
  int x = 0;
  size_t k2 = 0, old_n = 0;
  for (int round = 1; round <= 2; ++round) {
    for (;;) {
      int start;
      int64_t min_intv;
      if (round == 1) {
        while (x < len && q[x] > 3) ++x;
        if (x >= len) break;
        start = x;
        min_intv = 1;
      } else {
        bool found = false;
        while (k2 < old_n) {
          Intv p = mems[k2];
          int qb = (int)(p.info >> 32), qe = (int)(p.info & 0xFFFFFFFFll);
          ++k2;
          if (qe - qb < split_len || p.s > split_width) continue;
          start = (qb + qe) >> 1;
          min_intv = p.s + 1;
          found = true;
          break;
        }
        if (!found) break;
      }
      // --- smem1a(start, min_intv, max_intv=0) with suspension points ---
      tmp.clear();
      int ret = start + 1;
      if (q[start] <= 3) {
        size_t mems0 = tmp.size();
        Intv ik, ok[4];
        set_intv(fm, q[start], ik);
        ik.info = start + 1;
        curr.clear();
        int i = start + 1;
        for (; i < len; ++i) {
          if (ik.s < 0) {  // max_intv == 0: never taken; kept for parity
            curr.push_back(ik);
            break;
          }
          if (q[i] < 4) {
            int c = 3 - q[i];
            co_await PfExtend{&fm, ik.x1 - 1, ik.x1 - 1 + ik.s};
            bwt_extend(fm, ik, ok, false);
            if (ok[c].s != ik.s) {
              curr.push_back(ik);
              if (ok[c].s < min_intv) break;
            }
            ok[c].info = i + 1;
            ik = ok[c];
          } else {
            curr.push_back(ik);
            break;
          }
        }
        if (i == len) curr.push_back(ik);
        ret = curr.empty() ? start + 1 : (int)curr.back().info;
        std::reverse(curr.begin(), curr.end());
        prev = curr;
        for (i = start - 1; i >= -1; --i) {
          int c = (i < 0 || q[i] > 3) ? -1 : q[i];
          curr.clear();
          for (size_t j = 0; j < prev.size(); ++j) {
            const Intv& p = prev[j];
            // max_intv == 0 here, so the plain code's `p.s >= max_intv`
            // gate is exactly `c >= 0`
            bool did_ext = (c >= 0);
            if (did_ext) {
              co_await PfExtend{&fm, p.x0 - 1, p.x0 - 1 + p.s};
              bwt_extend(fm, p, ok, true);
            }
            if (c < 0 || ok[c].s < min_intv) {
              if (curr.empty()) {
                bool keep = (tmp.size() == mems0) ||
                            (int64_t)(i + 1) < (tmp.back().info >> 32);
                if (keep) {
                  Intv m = p;
                  m.info =
                      ((int64_t)(i + 1) << 32) | (m.info & 0xFFFFFFFFll);
                  tmp.push_back(m);
                }
              }
            } else if (curr.empty() || ok[c].s != curr.back().s) {
              ok[c].info = p.info;
              curr.push_back(ok[c]);
            }
          }
          if (curr.empty()) break;
          std::swap(curr, prev);
        }
        std::reverse(tmp.begin() + mems0, tmp.end());
      }
      for (const Intv& m : tmp) {
        int qb = (int)(m.info >> 32), qe = (int)(m.info & 0xFFFFFFFFll);
        if (qe - qb >= min_seed_len) mems.push_back(m);
      }
      if (round == 1) x = ret;
    }
    if (round == 1) {
      old_n = mems.size();
      k2 = 0;
    }
  }
  // round 3: LAST-like re-seeding ([EXT] bwt_seed_strategy1)
  if (max_mem_intv > 0) {
    x = 0;
    while (x < len) {
      if (q[x] > 3) {
        ++x;
        continue;
      }
      // seed_strategy1(x) with suspension points
      int ret = len;
      bool found = false;
      Intv out, ik, ok[4];
      set_intv(fm, q[x], ik);
      for (int i = x + 1; i < len; ++i) {
        if (q[i] < 4) {
          int c = 3 - q[i];
          co_await PfExtend{&fm, ik.x1 - 1, ik.x1 - 1 + ik.s};
          bwt_extend(fm, ik, ok, false);
          if (ok[c].s < max_mem_intv && i - x >= min_seed_len) {
            out = ok[c];
            out.info = ((int64_t)x << 32) | (int64_t)(i + 1);
            found = true;
            ret = i + 1;
            break;
          }
          ik = ok[c];
        } else {
          ret = i + 1;
          break;
        }
      }
      if (found && out.s > 0) mems.push_back(out);
      x = ret;
    }
  }
  std::sort(mems.begin(), mems.end(),
            [](const Intv& a, const Intv& b) { return a.info < b.info; });
  co_return;
}

// Lanes interleaved per core: enough in-flight misses to cover DRAM latency
// without thrashing L1 with coroutine frames.  Re-tuned r04 on the chr20
// config after the fused-line/sa_intv work (16 -> 48: +20%+ seed rate;
// 64 regresses — frame footprint crosses L2).
constexpr int kSeedLanes = 48;

// Drive a group of reads' seeding coroutines round-robin.
static void collect_intv_group(const FM& fm, int n, const uint8_t* const* qs,
                               const int* lens, int min_seed_len,
                               int split_len, int split_width,
                               int64_t max_mem_intv,
                               std::vector<Intv>* mems_out) {
  constexpr int G = kSeedLanes;
  std::coroutine_handle<SeedTask::promise_type> hs[G] = {};
  int alive = 0;
  for (int i = 0; i < n && i < G; ++i) {
    hs[i] = collect_intv_co(fm, qs[i], lens[i], min_seed_len, split_len,
                            split_width, max_mem_intv, mems_out[i])
                .h;
    ++alive;
  }
  while (alive > 0) {
    for (int i = 0; i < G; ++i) {
      if (!hs[i]) continue;
      hs[i].resume();
      if (hs[i].done()) {
        hs[i].destroy();
        hs[i] = nullptr;
        --alive;
      }
    }
  }
}

// sampled-SA position of conceptual row k ([EXT] bwt_sa)
inline uint8_t bwt_char_at(const FM& fm, int64_t phys) {
  int64_t block = phys >> 7;
  int within = (int)(phys & 127);
  uint32_t word = blk_words(fm, block)[within >> 4];
  return (word >> (30 - 2 * (within & 15))) & 3;
}

inline int64_t inv_psi(const FM& fm, int64_t k) {
  if (k == fm.primary) return 0;
  int64_t kk = k - (k > fm.primary);
  int c = bwt_char_at(fm, kk);
  return fm.L2[c] + occ1(fm, k, c);
}

inline int64_t sa_one(const FM& fm, int64_t k) {
  int64_t steps = 0;
  while (k % fm.sa_intv != 0) {
    k = inv_psi(fm, k);
    ++steps;
  }
  return fm.sa[k / fm.sa_intv] + steps;
}

}  // namespace

extern "C" {

// Batched three-round seeding.  reads flattened via offsets; per-read
// output intervals appended to a caller-grown buffer protocol:
//   pass 1 (probe): out == nullptr -> fills n_out[i] with interval counts
//   pass 2: out != nullptr, out_off[i] gives each read's slot; rows are
//     (x0, x1, s, qb, qe) int64.
void bwamem_collect_intv_batch(
    const uint8_t* fused, const int64_t* L2,
    const int64_t* sa, int64_t primary, int64_t seq_len, int64_t sa_intv,
    int64_t n_reads, const uint8_t* rbuf, const int64_t* roff,
    const int32_t* rlen, int min_seed_len, int split_len, int split_width,
    int64_t max_mem_intv, int64_t* n_out, int64_t* out_off, int64_t* out) {
  FM fm{fused, L2, sa, primary, seq_len, sa_intv};
  std::vector<std::vector<Intv>> all(n_reads);
  int64_t n_groups = (n_reads + kSeedLanes - 1) / kSeedLanes;
#pragma omp parallel for schedule(dynamic, 2)
  for (int64_t g = 0; g < n_groups; ++g) {
    int64_t lo = g * kSeedLanes,
            hi = std::min(lo + kSeedLanes, n_reads);
    const uint8_t* qs[kSeedLanes];
    int lens[kSeedLanes];
    for (int64_t k = lo; k < hi; ++k) {
      qs[k - lo] = rbuf + roff[k];
      lens[k - lo] = rlen[k];
    }
    collect_intv_group(fm, (int)(hi - lo), qs, lens, min_seed_len, split_len,
                       split_width, max_mem_intv, &all[lo]);
  }
  for (int64_t i = 0; i < n_reads; ++i) {
    n_out[i] = (int64_t)all[i].size();
    if (out != nullptr) {
      int64_t* row = out + out_off[i] * 5;
      for (const Intv& m : all[i]) {
        row[0] = m.x0;
        row[1] = m.x1;
        row[2] = m.s;
        row[3] = m.info >> 32;
        row[4] = m.info & 0xFFFFFFFFll;
        row += 5;
      }
    }
  }
}

// Single-pass variant: collects per-read interval vectors in parallel,
// concatenates into one malloc'd block (rows of 5 int64), fills n_out and
// returns the block (caller frees with bwamem_free).
int64_t* bwamem_collect_intv_batch_alloc(
    const uint8_t* fused, const int64_t* L2,
    const int64_t* sa, int64_t primary, int64_t seq_len, int64_t sa_intv,
    int64_t n_reads, const uint8_t* rbuf, const int64_t* roff,
    const int32_t* rlen, int min_seed_len, int split_len, int split_width,
    int64_t max_mem_intv, int64_t* n_out) {
  FM fm{fused, L2, sa, primary, seq_len, sa_intv};
  std::vector<std::vector<Intv>> all(n_reads);
  int64_t n_groups = (n_reads + kSeedLanes - 1) / kSeedLanes;
#pragma omp parallel for schedule(dynamic, 2)
  for (int64_t g = 0; g < n_groups; ++g) {
    int64_t lo = g * kSeedLanes,
            hi = std::min(lo + kSeedLanes, n_reads);
    const uint8_t* qs[kSeedLanes];
    int lens[kSeedLanes];
    for (int64_t k = lo; k < hi; ++k) {
      qs[k - lo] = rbuf + roff[k];
      lens[k - lo] = rlen[k];
    }
    collect_intv_group(fm, (int)(hi - lo), qs, lens, min_seed_len, split_len,
                       split_width, max_mem_intv, &all[lo]);
  }
  for (int64_t i = 0; i < n_reads; ++i) n_out[i] = (int64_t)all[i].size();
  int64_t total = 0;
  for (int64_t i = 0; i < n_reads; ++i) total += n_out[i];
  int64_t* buf = (int64_t*)malloc(std::max<int64_t>(total, 1) * 5 * 8);
  if (!buf) return nullptr;
  int64_t* row = buf;
  for (int64_t i = 0; i < n_reads; ++i) {
    for (const Intv& m : all[i]) {
      row[0] = m.x0;
      row[1] = m.x1;
      row[2] = m.s;
      row[3] = m.info >> 32;
      row[4] = m.info & 0xFFFFFFFFll;
      row += 5;
    }
  }
  return buf;
}

void bwamem_free(void* p) { free(p); }

// Worker-thread control: the native analog of the reference's n_threads
// option (offset 92, BwaMemAligner.java:102-103 -> kt_for pool size).
// Applies to every OpenMP-parallel native stage in this process.
void bwamem_set_threads(int n) {
#ifdef _OPENMP
  if (n > 0) omp_set_num_threads(n);
#endif
}

// Sampled-SA resolution for a batch of rows.  Each walk is a serial
// pointer-chase (k -> inv_psi(k)) whose every step misses LLC at genome
// scale; walks are mutually independent, so each thread runs W of them
// round-robin and prefetches every lane's next fused block one sweep
// ahead — the lane count keeps ~W misses in flight instead of 1.
void bwamem_sa_batch(const uint8_t* fused,
                     const int64_t* L2, const int64_t* sa, int64_t primary,
                     int64_t seq_len, int64_t sa_intv, int64_t n,
                     const int64_t* ks, int64_t* out) {
  FM fm{fused, L2, sa, primary, seq_len, sa_intv};
#pragma omp parallel
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num(), nth = omp_get_num_threads();
#else
    int tid = 0, nth = 1;
#endif
    int64_t lo = n * tid / nth, hi = n * (tid + 1) / nth;
    constexpr int W = 32;
    int64_t lane_i[W];   // output index per lane (-1 = idle)
    int64_t lane_k[W], lane_steps[W];
    int64_t next = lo;
    int active = 0;
    for (int j = 0; j < W; ++j) {
      lane_i[j] = -1;
      if (next < hi) {
        lane_i[j] = next;
        lane_k[j] = ks[next];
        lane_steps[j] = 0;
        ++next;
        ++active;
      }
    }
    while (active > 0) {
      for (int j = 0; j < W; ++j) {  // prefetch sweep
        if (lane_i[j] < 0) continue;
        int64_t k = lane_k[j];
        if (k % fm.sa_intv != 0 && k != fm.primary) {
          int64_t kk = k - (k > fm.primary);
          __builtin_prefetch(fm.fused + ((kk >> 7) << 6));
        }
      }
      for (int j = 0; j < W; ++j) {  // advance sweep
        if (lane_i[j] < 0) continue;
        int64_t k = lane_k[j];
        if (k % fm.sa_intv == 0) {
          out[lane_i[j]] = fm.sa[k / fm.sa_intv] + lane_steps[j];
          if (next < hi) {
            lane_i[j] = next;
            lane_k[j] = ks[next];
            lane_steps[j] = 0;
            ++next;
          } else {
            lane_i[j] = -1;
            --active;
          }
        } else {
          lane_k[j] = inv_psi(fm, k);
          ++lane_steps[j];
        }
      }
    }
  }
}

}  // extern "C"
