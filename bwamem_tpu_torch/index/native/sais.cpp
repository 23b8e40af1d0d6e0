// SA-IS linear-time suffix array construction (Nong/Zhang/Chan algorithm),
// tuned for chromosome/genome-scale inputs.
//
// Native equivalent of the reference engine's suffix-array constructors
// ([EXT] is.c / QSufSort.c, linked per src/main/c/Makefile:27); written from
// the published algorithm, not ported from bwa.  Unlike bwa's is.c (int32,
// <2 GB inputs) this constructor is index-width adaptive: it runs the whole
// recursion in int32 when the input fits (half the memory traffic) and
// switches to int64 only above 2 Gbp, which is why the package aliases the
// reference's RB2 algorithm choice (BwaMemIndex.java:66-71) to this constructor.
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
//
// Exposed C ABI (consumed via ctypes from ../native_sais.py):
//   int bwamem_sais(const uint8_t* codes, int64_t n, int64_t* sa_out);
// Computes the suffix array of codes+sentinel (sentinel strictly smallest);
// sa_out must hold n+1 entries; sa_out[0] == n on return.  Returns 0 on
// success, nonzero on allocation failure.

#include <cstdint>
#include <limits>
#include <new>
#include <vector>

#include "sais_core.h"

using saisns::sais_core;

extern "C" {

int bwamem_sais(const uint8_t* codes, int64_t n, int64_t* sa_out) {
  try {
    std::vector<uint8_t> s((size_t)n + 1);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) s[i] = codes[i] + 1;
    s[n] = 0;  // sentinel, strictly smallest
    if (n + 1 <= (int64_t)std::numeric_limits<int32_t>::max()) {
      // int32 recursion: half the index-array memory traffic
      std::vector<int32_t> sa32((size_t)n + 1);
      sais_core<int32_t, uint8_t>(s.data(), sa32.data(), (int32_t)(n + 1), 7);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
      for (int64_t i = 0; i <= n; ++i) sa_out[i] = sa32[i];
    } else {
      sais_core<int64_t, uint8_t>(s.data(), sa_out, n + 1, 7);
    }
    return 0;
  } catch (const std::bad_alloc&) {
    return 1;
  }
}

// BWT from a ready suffix array, bwa stored-form conventions: the
// conceptual (n+1)-row BWT of codes+sentinel drops the sentinel row
// (`primary`, the row whose suffix starts at text position 0); Occ queries
// re-insert it by index adjustment (engine/fmindex.py).  Gather parallelized
// over rows; the numpy fancy-indexing equivalent in index/sais.py is the
// fallback.  sa has n+1 entries; bwt_out holds n bytes.
int bwamem_bwt_from_sa(const uint8_t* codes, const int64_t* sa, int64_t n,
                       uint8_t* bwt_out, int64_t* primary_out) {
  int64_t primary = -1;
  for (int64_t i = 0; i <= n; ++i) {
    if (sa[i] == 0) {
      primary = i;
      break;
    }
  }
  if (primary < 0) return 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i <= n; ++i) {
    if (i == primary) continue;
    bwt_out[i - (i > primary)] = codes[sa[i] - 1];
  }
  *primary_out = primary;
  return 0;
}

}  // extern "C"
