// Shared SA-IS core templates (Nong/Zhang/Chan induced sorting with the
// sais-lite sign-carried-type trick), used by both constructors:
//   - sais.cpp    — in-RAM int32/int64 constructor (bwamem_sais)
//   - sais40.cpp  — memory-frugal genome-scale constructor (bwamem_build_bwt40);
//     its packed top level recurses into sais_core<int32_t, int32_t>.
//
// Native equivalent of the reference engine's suffix-array constructors
// ([EXT] is.c / QSufSort.c, linked per src/main/c/Makefile:27); written from
// the published algorithm, not ported from bwa.
//
// Performance notes (vs the naive textbook formulation):
//   - induced sorting carries the *predecessor's* suffix type in the sign of
//     each SA entry (the sais-lite trick, Mori 2008): the type is computed at
//     push time from s[j-1] vs s[j] — two adjacent bytes on one cache line —
//     so the inner loops never take the second random-access miss into a
//     type array;
//   - per-level symbol histogram is computed ONCE (parallel per-thread
//     histograms) and bucket edges are re-derived by an O(K) prefix sum,
//     instead of an O(n) recount per induce pass;
//   - data-dependent s[] loads are software-prefetched a fixed distance
//     ahead (the SA stream itself is sequential);
//   - suffix-type classification (still needed for LMS detection/naming)
//     runs blockwise in parallel over one byte per position.
#ifndef BWAMEM_SAIS_CORE_H_
#define BWAMEM_SAIS_CORE_H_

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace saisns {

// Blockwise-parallel suffix-type classification; t[i] = 1 iff suffix i is
// S-type.  The right boundary of each block is resolved by scanning forward
// across the (genomically short) run of equal symbols that straddles it.
template <typename Char, typename I>
void classify_types(const Char* s, uint8_t* t, I n) {
  t[n - 1] = 1;
  if (n == 1) return;
#ifdef _OPENMP
#pragma omp parallel
  {
    const int nb = omp_get_num_threads();
    const int b = omp_get_thread_num();
    const I lo = (I)((__int128)n * b / nb);
    const I hi = (I)((__int128)n * (b + 1) / nb);
    if (lo < hi) {
      I i = hi - 1;
      uint8_t ti;
      if (i == n - 1) {
        ti = 1;
      } else {
        // i..j is a run of one symbol; its type is decided at the run end:
        // s[j] < s[j+1] ⇒ S; s[j] == s[j+1] only when j+1 == n-1 (sentinel
        // suffix is S) ⇒ S; s[j] > s[j+1] ⇒ L.
        I j = i;
        while (j + 1 < n - 1 && s[j] == s[j + 1]) ++j;
        ti = (s[j] <= s[j + 1]) ? 1 : 0;
      }
      t[i] = ti;
      for (I k = i; k > lo; --k)
        t[k - 1] = (s[k - 1] < s[k]) || (s[k - 1] == s[k] && t[k]) ? 1 : 0;
    }
  }
#else
  for (I i = n - 1; i-- > 0;)
    t[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && t[i + 1]) ? 1 : 0;
#endif
}

// Parallel symbol histogram.
template <typename Char, typename I>
void count_symbols(const Char* s, I n, I K, I* cnt) {
  std::fill(cnt, cnt + K, (I)0);
#ifdef _OPENMP
  if ((int64_t)n > (1 << 20) && (int64_t)K <= (1 << 16)) {
#pragma omp parallel
    {
      std::vector<I> local(K, (I)0);
#pragma omp for schedule(static)
      for (int64_t i = 0; i < (int64_t)n; ++i) ++local[s[i]];
#pragma omp critical
      for (I k = 0; k < K; ++k) cnt[k] += local[k];
    }
    return;
  }
#endif
  for (I i = 0; i < n; ++i) ++cnt[s[i]];
}

// During the induce passes SA[] holds signed, 1-shifted entries:
//   0        empty slot (only before/during stage-1 and stage-3 fills)
//   +(p+1)   suffix p whose predecessor suffix p-1 is L-type
//   -(p+1)   suffix p whose predecessor is S-type (or p == 0: no action)
// The L-pass acts on positive entries, the S-pass on negative ones; the
// final cleanup strips signs/shifts.  This removes all t[] reads from the
// induce inner loops.
template <typename I, typename Char>
void sais_core(const Char* s, I* SA, I n, I K) {
  // uninitialized on purpose: classification assigns every byte, in
  // parallel — a value-initialized vector would pay a serial zeroing pass
  // over fresh pages first (first-touch faults are the dominant fixed cost
  // on lazily-backed VMs)
  std::unique_ptr<uint8_t[]> tv(new uint8_t[(size_t)n]);
  uint8_t* t = tv.get();
  classify_types<Char, I>(s, t, n);
  auto is_lms = [&](I i) { return i > 0 && t[i] && !t[i - 1]; };

  std::vector<I> cnt(K), bkt(K);
  count_symbols<Char, I>(s, n, K, cnt.data());
  auto bucket_edges = [&](bool end) {
    I sum = 0;
    for (I i = 0; i < K; ++i) {
      sum += cnt[i];
      bkt[i] = end ? sum : sum - cnt[i];
    }
  };

  constexpr I PF = 48;
  auto induce = [&]() {
    bucket_edges(false);  // L-pass: left-to-right, acts on positive entries
    for (I i = 0; i < n; ++i) {
      if (i + PF < n) {
        I v = SA[i + PF];
        if (v > 1) __builtin_prefetch(&s[v - 2]);
      }
      I v = SA[i];
      if (v > 1) {  // +(p+1) with p > 0 ⇒ predecessor j = p-1 is L-type
        I j = v - 2;
        Char c = s[j];
        bool pred_l = j > 0 && s[j - 1] >= c;
        SA[bkt[c]++] = pred_l ? (j + 1) : -(j + 1);
      }
    }
    bucket_edges(true);  // S-pass: right-to-left, acts on negative entries
    for (I i = n; i-- > 0;) {
      if (i >= PF) {
        I v = SA[i - PF];
        if (v < -1) __builtin_prefetch(&s[-v - 2]);
      }
      I v = SA[i];
      if (v < -1) {  // -(p+1) with p > 0 ⇒ predecessor j = p-1 is S-type
        I j = -v - 2;
        Char c = s[j];
        bool pred_s = j > 0 && s[j - 1] <= c;
        SA[--bkt[c]] = pred_s ? -(j + 1) : (j + 1);
      }
    }
  };

  // --- stage 1: sort LMS substrings by induced sorting ---
  std::fill(SA, SA + n, (I)0);
  bucket_edges(true);
  for (I i = n; i-- > 1;)
    if (is_lms(i)) SA[--bkt[s[i]]] = i + 1;  // pred of an LMS suffix is L
  induce();

  // compact sorted LMS positions into SA[0..n1)
  I n1 = 0;
  for (I i = 0; i < n; ++i) {
    if (i + 32 < n) {
      I vf = SA[i + 32];
      I pf = (vf < 0 ? -vf : vf) - 1;
      if (pf > 0) __builtin_prefetch(&t[pf]);
    }
    I p = (SA[i] < 0 ? -SA[i] : SA[i]) - 1;
    if (p > 0 && is_lms(p)) SA[n1++] = p;
  }

  // name LMS substrings; names stored at SA[n1 + pos/2]
  std::fill(SA + n1, SA + n, (I)-1);
  I name = 0, prev = -1;
  for (I i = 0; i < n1; ++i) {
    if (i + 4 < n1) {
      __builtin_prefetch(&s[SA[i + 4]]);
      __builtin_prefetch(&t[SA[i + 4]]);
    }
    I pos = SA[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (I d = 0;; ++d) {
        if (s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) {
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
    SA[n1 + pos / 2] = name - 1;
  }
  std::unique_ptr<I[]> s1(new I[(size_t)n1]);  // fully assigned below
  for (I i = n1, j = 0; i < n; ++i)
    if (SA[i] >= 0) s1[(size_t)j++] = SA[i];

  // --- stage 2: solve the reduced problem ---
  if (name < n1) {
    sais_core<I, I>(s1.get(), SA, n1, name);
  } else {
    for (I i = 0; i < n1; ++i) SA[s1[i]] = i;
  }
  // --- stage 3: induce the full SA from sorted LMS suffixes ---
  // genome-scale peak-RSS discipline: s1's *contents* are dead past stage 2,
  // so its n1-entry buffer is reused for the LMS position table (no second
  // allocation), and the type bits are released right after — the induce
  // passes never read t[] (sign-carried types)
  I* lms = s1.get();
  for (I i = 1, j = 0; i < n; ++i)
    if (is_lms(i)) lms[(size_t)j++] = i;
  tv.reset();
  t = nullptr;
  for (I i = 0; i < n1; ++i) {
    if (i + 32 < n1) __builtin_prefetch(&lms[SA[i + 32]]);
    SA[i] = lms[SA[i]];
  }
  s1.reset();
  std::fill(SA + n1, SA + n, (I)0);
  bucket_edges(true);
  for (I i = n1; i-- > 0;) {
    if (i >= 32) __builtin_prefetch(&s[SA[i - 32]]);
    I j = SA[i];
    SA[i] = 0;
    SA[--bkt[s[j]]] = j + 1;  // pred of an LMS suffix is L
  }
  induce();

  // strip the 1-shift/sign encoding
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < (int64_t)n; ++i) {
    I v = SA[i];
    SA[i] = (v < 0 ? -v : v) - 1;
  }
}

}  // namespace saisns

#endif  // BWAMEM_SAIS_CORE_H_
