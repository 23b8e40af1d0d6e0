// Memory-frugal genome-scale FM-index construction: BWT + sampled SA of the
// doubled (forward + reverse-complement) reference straight from the 2-bit
// pac, without ever materialising an int64 suffix array or an unpacked text.
//
// This is the package's equivalent of the reference's `Algorithm.RB2` axis
// (BwaMemIndex.java:66-71; Makefile:27 links rope.o/rle.o precisely so
// >2 GB references can be indexed in bounded memory).  Rather than porting
// ropebwt2's incremental B+-tree — whose single-string construction is
// inherently serial per symbol — this runs the same SA-IS induced sorting as
// sais.cpp (sais_core.h) with a storage-specialised top level:
//
//   * text: 2-bit packed, both strands (N/4 bytes; 1.55 GB for GRCh38 vs
//     6.2 GB of uint8 codes) — the random text reads in the induce loops
//     touch 4x fewer cache lines;
//   * suffix array: bit-packed signed entries at the minimal width for
//     the input (34 bits for GRCh38 scale: 26.4 GB vs 50 GB int64);
//   * suffix-type bits: 1 bit/position (0.8 GB vs 6.2 GB);
//   * recursion (level 1 down): the reduced problem is ~N/4 names and fits
//     the ordinary int32 in-RAM sais_core.
//
// Peak RSS for a 3.1 Gbp reference (N = 6.2e9 + 1): ~26 GB SA + 1.6 GB
// text + 0.8 GB types + ~11 GB level-1 buffers ≈ 41 GB — inside a 48 GB
// budget, where the int64 path needed 116 GB (BENCH_GRCH38_r02.json).  The
// output (.bwt codes, primary, sampled .sa) is byte-identical to the int64
// path; tests/test_index_frugal.py fuzzes the equality.
//
// Exposed C ABI (consumed via ctypes from ../native_sais.py):
//   int bwamem_build_bwt40(const uint8_t* pac, int64_t l_pac,
//                          uint8_t* bwt_out,        // 2*l_pac bytes
//                          int64_t* primary_out,
//                          int64_t* sa_samp_out,    // (2*l_pac+intv)/intv
//                          int64_t sa_intv,
//                          int64_t* n1_out);        // diagnostics (or null)
// Returns 0 ok, 1 allocation failure, 2 reduced problem exceeds int32
// (caller falls back to the in-RAM int64 constructor).

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <limits>
#include <memory>
#include <new>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif
#ifdef __linux__
#include <sys/mman.h>
#endif

#include "sais_core.h"

namespace {

// The induce passes are TLB-bound at genome scale (random 2-bit text reads
// + seven concurrent SA streams over ~33 GB); transparent hugepages on the
// two big buffers cut dTLB misses.  Advisory only — failure is harmless.
inline void advise_huge(void* p, size_t bytes) {
#ifdef __linux__
  static const bool off = []() {
    const char* e = getenv("BWAMEM_TPU_NO_HUGE");
    return e && e[0] == '1';
  }();
  if (off) return;
  uintptr_t a = (uintptr_t)p;
  uintptr_t lo = (a + 2097151) & ~(uintptr_t)2097151;
  uintptr_t hi = (a + bytes) & ~(uintptr_t)2097151;
  if (hi > lo) madvise((void*)lo, hi - lo, MADV_HUGEPAGE);
#else
  (void)p;
  (void)bytes;
#endif
}

// Bit-packed signed array with the minimal width for the input: a 3.1 Gbp
// reference (N = 6.2e9+1) needs 34-bit entries — 26.4 GB vs 50 GB int64.
// Entry i occupies bits [i*bits, (i+1)*bits); since bits <= 57, any field
// sits inside one unaligned 8-byte window (the buffer is over-allocated).
// set() is a masked read-modify-write of that window, so it is safe for the
// SEQUENTIAL passes SA-IS runs (seeding/induce/compact/naming/remap);
// parallel passes only read or memset.
struct SAPack {
  uint8_t* b = nullptr;
  int bits;
  int sh;  // 64 - bits, for sign extension
  uint64_t mask;
  SAPack(int64_t n_entries, int bits_) : bits(bits_) {
    sh = 64 - bits;
    mask = (~0ull) >> sh;
    size_t bytes = (size_t)((n_entries * (uint64_t)bits + 7) / 8) + 16;
    b = static_cast<uint8_t*>(std::malloc(bytes));
    if (!b) return;
    advise_huge(b, bytes);
    // parallel first-touch: on lazily-backed VMs serial faulting of fresh
    // multi-GB mappings runs at ~0.05 GB/s; threads triple it, and the
    // zeroing doubles as stage 1's empty-slot fill
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t c = 0; c < 64; ++c)
      std::memset(b + bytes * c / 64, 0, bytes * (c + 1) / 64 - bytes * c / 64);
  }
  ~SAPack() { std::free(b); }
  inline int64_t get(int64_t i) const {
    uint64_t bitoff = (uint64_t)i * bits;
    uint64_t raw;
    std::memcpy(&raw, b + (bitoff >> 3), 8);
    raw >>= (bitoff & 7);
    return ((int64_t)(raw << sh)) >> sh;
  }
  inline void set(int64_t i, int64_t v) {
    uint64_t bitoff = (uint64_t)i * bits;
    uint8_t* p = b + (bitoff >> 3);
    int s = (int)(bitoff & 7);
    uint64_t old;
    std::memcpy(&old, p, 8);
    old = (old & ~(mask << s)) | ((((uint64_t)v) & mask) << s);
    std::memcpy(p, &old, 8);
  }
  // bulk fill with 0 or -1 (the only patterns SA-IS needs): memset the
  // byte-aligned interior, set() the boundary entries that share bytes
  // with their neighbours
  inline void fill(int64_t lo, int64_t hi, int64_t val) {
    while (lo < hi && ((uint64_t)lo * bits) & 7) set(lo++, val);
    int64_t hi_al = hi;
    while (hi_al > lo && ((uint64_t)hi_al * bits) & 7) set(--hi_al, val);
    if (hi_al > lo)
      std::memset(b + ((uint64_t)lo * bits >> 3), val ? 0xFF : 0,
                  (size_t)(((uint64_t)hi_al * bits >> 3) -
                           ((uint64_t)lo * bits >> 3)));
  }
};

// minimal two's-complement width covering +/-(limit)
inline int bits_for(int64_t limit) {
  int b = 2;
  while (((int64_t)1 << (b - 1)) - 1 < limit) ++b;
  return b;
}

inline bool tget(const uint64_t* t, int64_t i) {
  return (t[i >> 6] >> (i & 63)) & 1;
}

// The doubled-text view: symbol i in [0, N) where N = 2*l_pac + 1; values
// are code+1 in 1..4 with the sentinel 0 at index N-1.  p2 is LSB-first
// 2-bit packed (internal layout, not bwa's MSB-first pac order).
struct Text2 {
  const uint8_t* p2;
  int64_t n;  // sentinel index == number of real symbols == 2*l_pac
  inline uint32_t raw(int64_t i) const {
    return (p2[i >> 2] >> ((i & 3) << 1)) & 3;
  }
  inline int64_t operator()(int64_t i) const {
    if (__builtin_expect(i == n, 0)) return 0;
    return (int64_t)raw(i) + 1;
  }
};

// Top-level induce passes, storage-specialised (packed SA + 2-bit text +
// sign-carried predecessor types); logic mirrors sais_core.h `induce`.
void induce40(const Text2& S, SAPack& SA, int64_t N, int64_t* cnt,
              int64_t* bkt) {
  constexpr int64_t K = 5, PF = 48;
  auto bucket_edges = [&](bool end) {
    int64_t sum = 0;
    for (int64_t i = 0; i < K; ++i) {
      sum += cnt[i];
      bkt[i] = end ? sum : sum - cnt[i];
    }
  };
  bucket_edges(false);  // L-pass: left-to-right, acts on positive entries
  for (int64_t i = 0; i < N; ++i) {
    if (i + PF < N) {
      int64_t v = SA.get(i + PF);
      if (v > 1) __builtin_prefetch(&S.p2[(v - 2) >> 2]);
    }
    int64_t v = SA.get(i);
    if (v > 1) {  // +(p+1) with p > 0 ⇒ predecessor j = p-1 is L-type
      int64_t j = v - 2;
      int64_t c = S(j);
      bool pred_l = j > 0 && S(j - 1) >= c;
      SA.set(bkt[c]++, pred_l ? (j + 1) : -(j + 1));
    }
  }
  bucket_edges(true);  // S-pass: right-to-left, acts on negative entries
  for (int64_t i = N; i-- > 0;) {
    if (i >= PF) {
      int64_t v = SA.get(i - PF);
      if (v < -1) __builtin_prefetch(&S.p2[(-v - 2) >> 2]);
    }
    int64_t v = SA.get(i);
    if (v < -1) {  // -(p+1) with p > 0 ⇒ predecessor j = p-1 is S-type
      int64_t j = -v - 2;
      int64_t c = S(j);
      bool pred_s = j > 0 && S(j - 1) <= c;
      SA.set(--bkt[c], pred_s ? -(j + 1) : (j + 1));
    }
  }
}

}  // namespace

extern "C" {

int bwamem_build_bwt40(const uint8_t* pac, int64_t l_pac, uint8_t* bwt_out,
                       int64_t* primary_out, int64_t* sa_samp_out,
                       int64_t sa_intv, int64_t* n1_out) {
  // BWAMEM_TPU_NATIVE_PROF=1: phase wall times to stderr
  const bool prof = []() {
    const char* e = getenv("BWAMEM_TPU_NATIVE_PROF");
    return e && e[0] == '1';
  }();
  auto t0 = std::chrono::steady_clock::now();
  auto lap = [&](const char* name) {
    if (!prof) return;
    auto t1 = std::chrono::steady_clock::now();
    long hwm_kb = 0;
    if (FILE* f = fopen("/proc/self/status", "r")) {
      char line[256];
      while (fgets(line, sizeof line, f))
        if (sscanf(line, "VmHWM: %ld", &hwm_kb) == 1) break;
      fclose(f);
    }
    fprintf(stderr, "[sais40] %-12s %8.1fs  hwm %.1f GB\n", name,
            std::chrono::duration<double>(t1 - t0).count(), hwm_kb / 1e6);
    t0 = t1;
  };
  try {
    const int64_t n = 2 * l_pac;  // real symbols (fwd + revcomp)
    const int64_t N = n + 1;      // + sentinel

    // --- repack both strands into the internal LSB-first 2-bit buffer ---
    std::vector<uint8_t> p2_v((size_t)(n + 3) / 4 + 8, 0);
    uint8_t* p2 = p2_v.data();
    advise_huge(p2, p2_v.size());
    auto fwd_code = [&](int64_t i) -> uint32_t {
      return (pac[i >> 2] >> ((3 - (i & 3)) << 1)) & 3;
    };
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t byte = 0; byte < (n + 3) / 4; ++byte) {
      uint32_t acc = 0;
      for (int64_t k = 0; k < 4; ++k) {
        int64_t i = byte * 4 + k;
        if (i >= n) break;
        uint32_t c = i < l_pac ? fwd_code(i) : 3 - fwd_code(2 * l_pac - 1 - i);
        acc |= c << (k << 1);
      }
      p2[byte] = (uint8_t)acc;
    }
    Text2 S{p2, n};
    lap("repack");

    // --- suffix-type bits (1 bit/position over N), blockwise parallel ---
    const size_t tb_words = (size_t)(N + 63) / 64;
    std::unique_ptr<uint64_t[]> tbits_v(new uint64_t[tb_words]);
    uint64_t* tb = tbits_v.get();
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t c = 0; c < 16; ++c)
      std::memset(tb + tb_words * c / 16, 0,
                  8 * (tb_words * (c + 1) / 16 - tb_words * c / 16));
    auto tset1 = [&](int64_t i) { tb[i >> 6] |= 1ull << (i & 63); };
    // sequential-equivalent recurrence, split at 64-aligned boundaries so
    // threads own whole words; each block's seed type is resolved by
    // scanning forward across the equal-symbol run at its right edge
    {
      int nb = 1;
#ifdef _OPENMP
      nb = std::max(1, omp_get_max_threads());
#endif
      std::vector<int64_t> edges(nb + 1);
      for (int b = 0; b <= nb; ++b)
        edges[b] = std::min<int64_t>(N, (((__int128)N * b / nb) + 63) & ~63ll);
      edges[nb] = N;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
      for (int b = 0; b < nb; ++b) {
        int64_t lo = edges[b], hi = edges[b + 1];
        if (lo >= hi) continue;
        int64_t i = hi - 1;
        bool ti;
        if (i == N - 1) {
          ti = true;  // sentinel suffix is S
        } else {
          int64_t j = i;
          while (j + 1 < N - 1 && S(j) == S(j + 1)) ++j;
          ti = S(j) <= S(j + 1);
        }
        if (ti) tset1(i);
        bool next = ti;
        for (int64_t k = i; k > lo; --k) {
          int64_t a = S(k - 1), c = S(k);
          bool cur = (a < c) || (a == c && next);
          if (cur) tset1(k - 1);
          next = cur;
        }
      }
    }
    auto is_lms = [&](int64_t i) {
      return i > 0 && tget(tb, i) && !tget(tb, i - 1);
    };
    lap("classify");

    // --- symbol histogram over the doubled text (+ sentinel) ---
    int64_t cnt[5] = {1, 0, 0, 0, 0}, bkt[5];
    {
      int64_t c64[4] = {0, 0, 0, 0};
#ifdef _OPENMP
#pragma omp parallel
      {
        int64_t local[4] = {0, 0, 0, 0};
#pragma omp for schedule(static)
        for (int64_t i = 0; i < n; ++i) ++local[S.raw(i)];
#pragma omp critical
        for (int k = 0; k < 4; ++k) c64[k] += local[k];
      }
#else
      for (int64_t i = 0; i < n; ++i) ++c64[S.raw(i)];
#endif
      for (int k = 0; k < 4; ++k) cnt[k + 1] = c64[k];
    }
    auto bucket_edges = [&](bool end) {
      int64_t sum = 0;
      for (int64_t i = 0; i < 5; ++i) {
        sum += cnt[i];
        bkt[i] = end ? sum : sum - cnt[i];
      }
    };

    lap("histogram");
    // +/-(N+1) entries: 34 bits for a whole-GRCh38-scale doubled text.
    // Floor of 16: stage 2 aliases the buffer as an int32 SA of the reduced
    // problem (n1 <= N/2 entries), which needs N*bits/8 >= 4*n1 bytes.
    const int sa_bits = std::max(bits_for(N + 1), 16);
    SAPack SA(N, sa_bits);
    if (!SA.b) return 1;

    // --- stage 1: sort LMS substrings by induced sorting ---
    SA.fill(0, N, 0);
    lap("s1-fill");
    bucket_edges(true);
    // word-scan LMS enumeration (lms = t & ~(t<<1|carry)), words backward
    // and bits high->low: same descending-i visit order as the plain loop,
    // but only LMS positions (~N/4) are touched and the branch per
    // non-LMS position disappears
    {
      int64_t nwords = (N + 63) >> 6;
      for (int64_t w = nwords; w-- > 0;) {
        uint64_t tw = tb[w];
        uint64_t carry = w ? (tb[w - 1] >> 63) : 0;
        uint64_t lmsm = tw & ~((tw << 1) | carry);
        if (w == 0) lmsm &= ~1ull;  // i == 0 is never LMS
        while (lmsm) {
          int b = 63 - __builtin_clzll(lmsm);
          int64_t i = ((int64_t)w << 6) | b;
          SA.set(--bkt[S(i)], i + 1);  // pred of an LMS is L
          lmsm &= ~(1ull << b);
        }
      }
    }
    lap("stage1-seed");
    induce40(S, SA, N, cnt, bkt);
    lap("stage1-ind");

    // compact sorted LMS positions into SA[0..n1)
    int64_t n1 = 0;
    for (int64_t i = 0; i < N; ++i) {
      if (i + 32 < N) {
        int64_t vf = SA.get(i + 32);
        int64_t pf = (vf < 0 ? -vf : vf) - 1;
        if (pf > 0) __builtin_prefetch(&tb[pf >> 6]);
      }
      int64_t v = SA.get(i);
      int64_t p = (v < 0 ? -v : v) - 1;
      if (p > 0 && is_lms(p)) SA.set(n1++, p);
    }
    if (n1_out) *n1_out = n1;
    if (n1 >= std::numeric_limits<int32_t>::max()) return 2;
    lap("compact");

    // name LMS substrings; names stored at SA[n1 + pos/2]
    SA.fill(n1, N, -1);
    int64_t name = 0, prev = -1;
    for (int64_t i = 0; i < n1; ++i) {
      if (i + 4 < n1) {
        int64_t pn = SA.get(i + 4);
        __builtin_prefetch(&S.p2[pn >> 2]);
        __builtin_prefetch(&tb[pn >> 6]);
      }
      int64_t pos = SA.get(i);
      bool diff = false;
      if (prev < 0) {
        diff = true;
      } else {
        for (int64_t d = 0;; ++d) {
          if (S(pos + d) != S(prev + d) ||
              tget(tb, pos + d) != tget(tb, prev + d)) {
            diff = true;
            break;
          }
          if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) break;
        }
      }
      if (diff) {
        ++name;
        prev = pos;
      }
      SA.set(n1 + pos / 2, name - 1);
    }
    lap("naming");
    std::unique_ptr<int32_t[]> s1(new int32_t[(size_t)n1]);
    for (int64_t i = n1, j = 0; i < N; ++i) {
      int64_t v = SA.get(i);
      if (v >= 0) s1[(size_t)j++] = (int32_t)v;
    }

    // --- stage 2: the reduced problem fits the in-RAM int32 core; its SA
    // aliases the head of the packed buffer (n1*4 <= N*5 bytes) ---
    int32_t* SA1 = reinterpret_cast<int32_t*>(SA.b);
    if (name < n1) {
      saisns::sais_core<int32_t, int32_t>(s1.get(), SA1, (int32_t)n1,
                                          (int32_t)name);
    } else {
      for (int64_t i = 0; i < n1; ++i) SA1[s1[(size_t)i]] = (int32_t)i;
    }
    s1.reset();
    lap("recursion");

    // --- stage 3: induce the full SA from sorted LMS suffixes ---
    SAPack lms(n1 > 0 ? n1 : 1, sa_bits);
    if (!lms.b) return 1;
    {
      int64_t nwords = (N + 63) >> 6, j = 0;
      for (int64_t w = 0; w < nwords; ++w) {
        uint64_t tw = tb[w];
        uint64_t carry = w ? (tb[w - 1] >> 63) : 0;
        uint64_t lmsm = tw & ~((tw << 1) | carry);
        if (w == 0) lmsm &= ~1ull;
        while (lmsm) {
          int b = __builtin_ctzll(lmsm);
          lms.set(j++, ((int64_t)w << 6) | b);
          lmsm &= lmsm - 1;
        }
      }
    }
    tbits_v.reset();
    tb = nullptr;
    // widen the int32 level-1 order back into packed entries.  Backward
    // iteration is clobber-safe iff the packed field starts at or past the
    // int32 entry (bits >= 32); below that (small inputs) copy the order out
    if (sa_bits >= 32) {
      for (int64_t i = n1; i-- > 0;) {
        if (i >= 32)
          __builtin_prefetch(
              lms.b + (((uint64_t)SA1[i - 32] * sa_bits) >> 3));
        SA.set(i, lms.get(SA1[i]));
      }
    } else {
      std::vector<int32_t> order(SA1, SA1 + n1);
      for (int64_t i = 0; i < n1; ++i) SA.set(i, lms.get(order[(size_t)i]));
    }
    std::free(lms.b);
    lms.b = nullptr;
    SA.fill(n1, N, 0);
    bucket_edges(true);
    for (int64_t i = n1; i-- > 0;) {
      if (i >= 32) {
        int64_t jf = SA.get(i - 32);
        __builtin_prefetch(&S.p2[jf >> 2]);
      }
      int64_t j = SA.get(i);
      SA.set(i, 0);
      SA.set(--bkt[S(j)], j + 1);  // pred of an LMS suffix is L
    }
    lap("stage3-place");
    induce40(S, SA, N, cnt, bkt);
    lap("stage3-ind");

    // --- extract primary, sampled SA, and the stored-form BWT ---
    // entries are ±(p+1); p == 0 marks the sentinel row (primary)
    int64_t primary = -1;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(max : primary)
#endif
    for (int64_t i = 0; i < N; ++i) {
      int64_t v = SA.get(i);
      if ((v < 0 ? -v : v) == 1) primary = i;  // unique row with p == 0
    }
    if (primary < 0) return 1;
    *primary_out = primary;
    const int64_t n_sa = (n + sa_intv) / sa_intv;
    for (int64_t k = 0; k < n_sa; ++k) {
      int64_t v = SA.get(k * sa_intv);
      sa_samp_out[k] = (v < 0 ? -v : v) - 1;
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < N; ++i) {
      if (i + 32 < N) {
        int64_t vf = SA.get(i + 32);
        int64_t pf = (vf < 0 ? -vf : vf) - 1;
        if (pf > 0) __builtin_prefetch(&S.p2[(pf - 1) >> 2]);
      }
      if (i == primary) continue;
      int64_t v = SA.get(i);
      int64_t p = (v < 0 ? -v : v) - 1;  // p >= 1 off the primary row
      bwt_out[i - (i > primary)] = (uint8_t)S.raw(p - 1);
    }
    lap("extract");
    return 0;
  } catch (const std::bad_alloc&) {
    return 1;
  }
}

}  // extern "C"

extern "C" {

// bwa .bwt body interleave ([EXT] bwt_dump layout as pinned by
// index/build.py interleave_bwt and the reference's ref.fa.bwt fixture):
// per 128-base block 8 u32 checkpoint words (4 int64 LE cumulative
// stored-char counts BEFORE the block) + packed data words (16 chars/word,
// MSB-first 2-bit pairs); the trailing block carries ceil(chars/16) data
// words; a final checkpoint row follows.  Chunked two-pass so it
// parallelises without a per-block temp: pass 1 per-chunk symbol totals +
// serial exclusive prefix, pass 2 writes blocks with running counts.
// `out` must hold 16*(n_blocks-1) + 8 + ceil(last_chars/16) + 8 words.
void bwamem_interleave_bwt(const uint8_t* bwt, int64_t n, uint32_t* out) {
  const int64_t OCC = 128;
  int64_t n_blocks = (n + OCC - 1) / OCC;
  if (n_blocks < 1) n_blocks = 1;
  const int64_t CB = 4096;  // blocks per chunk
  int64_t n_chunks = (n_blocks + CB - 1) / CB;
  std::vector<int64_t> chunk_tot((size_t)n_chunks * 4, 0);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t ch = 0; ch < n_chunks; ++ch) {
    int64_t lo = ch * CB * OCC;
    int64_t hi = std::min(n, (ch + 1) * CB * OCC);
    int64_t c[4] = {0, 0, 0, 0};
    for (int64_t i = lo; i < hi; ++i) ++c[bwt[i]];
    for (int k = 0; k < 4; ++k) chunk_tot[(size_t)ch * 4 + k] = c[k];
  }
  int64_t run[4] = {0, 0, 0, 0};
  for (int64_t ch = 0; ch < n_chunks; ++ch)
    for (int k = 0; k < 4; ++k) {
      int64_t t = chunk_tot[(size_t)ch * 4 + k];
      chunk_tot[(size_t)ch * 4 + k] = run[k];
      run[k] += t;
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t ch = 0; ch < n_chunks; ++ch) {
    int64_t cum[4];
    std::memcpy(cum, &chunk_tot[(size_t)ch * 4], 32);
    int64_t b1 = std::min(n_blocks, (ch + 1) * CB);
    for (int64_t b = ch * CB; b < b1; ++b) {
      uint32_t* dst = out + 16 * b;
      std::memcpy(dst, cum, 32);
      int64_t beg = b * OCC;
      int64_t end = std::min(n, beg + OCC);
      int nw = (int)((end - beg + 15) / 16);
      for (int wi = 0; wi < nw; ++wi) {
        uint32_t wv = 0;
        int64_t base = beg + (int64_t)wi * 16;
        int lim = (int)std::min<int64_t>(16, end - base);
        for (int k2 = 0; k2 < lim; ++k2) {
          uint8_t cch = bwt[base + k2];
          wv |= (uint32_t)cch << (30 - 2 * k2);
          ++cum[cch];
        }
        dst[8 + wi] = wv;
      }
    }
  }
  int64_t last_words = ((n - (n_blocks - 1) * OCC) + 15) / 16;
  if (last_words < 0) last_words = 0;
  std::memcpy(out + 16 * (n_blocks - 1) + 8 + last_words, run, 32);
}

}  // extern "C"
