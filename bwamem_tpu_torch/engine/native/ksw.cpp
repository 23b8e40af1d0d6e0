// Native batched banded-SW extension (host runtime hot path).
//
// Provenance: the inner extension loop re-expresses the scalar definition
// of ksw_extend2 from Heng Li's bwa (ksw.c, MIT license, (c) 2011 by
// Attractive Chaos <attractor@live.co.uk>); bit-exact parity with that
// routine is a framework requirement (see LICENSES.md).  The batching,
// OpenMP scheduling, and ABI around it are original to this project.
//
// Same exact semantics as engine/extend.py::ksw_extend2 (the validated
// oracle for [EXT] ksw.c's ksw_extend2 behavior: adaptive window with
// stale-cell semantics, Z-drop, M==0 reset, gscore tie-breaks).  This is
// the C++ runtime component of the framework (SURVEY.md section 7: native
// where the reference's runtime is native); the TPU kernel
// (ops/extend_tpu.py) covers the device path.
//
// C ABI (ctypes; see ../native_ksw.py):
//   void bwamem_ksw_extend_batch(...)
// Jobs are flattened: sequences concatenated in qbuf/tbuf with per-job
// offsets.  Output: 6 int32 per job {score, qle, tle, gtle, gscore,
// max_off}.  OpenMP-parallel across jobs.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

struct EH {
  int32_t h, e;
};

void ksw_extend_one(const uint8_t* q, int qlen, const uint8_t* t, int tlen,
                    const int8_t* mat,  // 5x5
                    int o_del, int e_del, int o_ins, int e_ins, int w,
                    int end_bonus, int zdrop, int h0, int32_t* out6) {
  const int m = 5;
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  // thread-local scratch: tens of thousands of short jobs per batch make
  // per-call heap allocation a measurable fraction of the DP itself
  static thread_local std::vector<int8_t> qp;
  static thread_local std::vector<EH> eh;
  if ((int64_t)qp.size() < (int64_t)m * qlen) qp.resize((size_t)m * qlen);
  for (int k = 0; k < m; ++k) {
    const int8_t* p = &mat[k * m];
    for (int j = 0; j < qlen; ++j) qp[(size_t)k * qlen + j] = p[q[j]];
  }
  if ((int64_t)eh.size() < qlen + 1) eh.resize(qlen + 1);
  std::memset(eh.data(), 0, sizeof(EH) * (qlen + 1));
  // first row
  eh[0].h = h0;
  if (qlen > 0) {
    eh[1].h = h0 > oe_ins ? h0 - oe_ins : 0;
    int j = 2;
    for (; j <= qlen && eh[j - 1].h > e_ins; ++j) eh[j].h = eh[j - 1].h - e_ins;
  }
  // adjust the band width
  int max_sc = mat[0];
  for (int i = 1; i < m * m; ++i) max_sc = std::max(max_sc, (int)mat[i]);
  int max_ins = (int)((double)(qlen * max_sc + end_bonus - o_ins) / e_ins + 1.);
  w = std::min(w, std::max(max_ins, 1));
  int max_del = (int)((double)(qlen * max_sc + end_bonus - o_del) / e_del + 1.);
  w = std::min(w, std::max(max_del, 1));

  int maxv = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1, max_off = 0;
  int beg = 0, end = qlen;
  for (int i = 0; i < tlen; ++i) {
    int f = 0, mrow = 0, mj = -1;
    const int8_t* qrow = &qp[(size_t)t[i] * qlen];
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    int h1;
    if (beg == 0) {
      h1 = h0 - (o_del + e_del * (i + 1));
      if (h1 < 0) h1 = 0;
    } else {
      h1 = 0;
    }
    for (int j = beg; j < end; ++j) {
      EH* p = &eh[j];
      int M = p->h, e = p->e;
      p->h = h1;
      M = M ? M + qrow[j] : 0;
      int h = M > e ? M : e;
      h = h > f ? h : f;
      h1 = h;
      mj = mrow > h ? mj : j;
      mrow = mrow > h ? mrow : h;
      int tt = M - oe_del;
      tt = tt > 0 ? tt : 0;
      e -= e_del;
      e = e > tt ? e : tt;
      p->e = e;
      tt = M - oe_ins;
      tt = tt > 0 ? tt : 0;
      f -= e_ins;
      f = f > tt ? f : tt;
    }
    eh[end].h = h1;
    eh[end].e = 0;
    if (end == qlen) {
      if (gscore <= h1) {
        max_ie = i;
        gscore = h1;
      }
    }
    if (mrow == 0) break;
    if (mrow > maxv) {
      maxv = mrow;
      max_i = i;
      max_j = mj;
      if (max_off < std::abs(mj - i)) max_off = std::abs(mj - i);
    } else if (zdrop > 0) {
      if (i - max_i > mj - max_j) {
        if (maxv - mrow - ((i - max_i) - (mj - max_j)) * e_del > zdrop) break;
      } else {
        if (maxv - mrow - ((mj - max_j) - (i - max_i)) * e_ins > zdrop) break;
      }
    }
    // shrink the window
    int j = beg;
    while (j < end && eh[j].h == 0 && eh[j].e == 0) ++j;
    beg = j;
    j = end;
    while (j >= beg && eh[j].h == 0 && eh[j].e == 0) --j;
    end = j + 2 < qlen ? j + 2 : qlen;
  }
  out6[0] = maxv;
  out6[1] = max_j + 1;
  out6[2] = max_i + 1;
  out6[3] = max_ie + 1;
  out6[4] = gscore;
  out6[5] = max_off;
}

// -------------------------------------------------------------------------
// ksw_extend2, vectorized.  The scalar recurrence carries two serial
// dependencies along the row: the previous cell's h (fed to the next row)
// and the horizontal-gap tracker f.  h only SHIFTS (no feedback within the
// row), and f admits a prefix-max reformulation:
//     f[j] = max(0, max_{k<j}(tt[k] + k*e_ins) - (j-1)*e_ins),
//     tt[k] = max(M[k] - oe_ins, 0)
// — the same lane-prefix-max trick the Pallas device kernel uses
// (ops/extend_pallas.py), so every cell becomes elementwise plus one
// log-step scan.  Rows >= 16 cells run 8-wide AVX2; narrow rows and
// non-AVX2 builds use the scalar row.  Bit-exact vs the scalar code and
// the python oracle (adaptive window stale cells, zdrop ties, later-j
// row-max ties, M==0 reset) — pinned by the tier-equivalence tests and a
// 4000-job adversarial fuzz.  Measured: ~1.3x vs scalar at qlen 5k
// (band-width rows amortize the scan), below parity at short read
// lengths — so the batch entry dispatches here only for qlen >= 2048
// (the long-read/chimeric regime); short reads keep the scalar loop.

#if defined(__AVX2__)
namespace vx {

constexpr int32_t NEG = INT32_MIN / 2;

// lane i <- x[i-k] (k in {1,2,4}), lanes < k filled with NEG
template <int K>
static inline __m256i shiftl(__m256i x) {
  __m256i idx, fill = _mm256_set1_epi32(NEG);
  if (K == 1) idx = _mm256_setr_epi32(0, 0, 1, 2, 3, 4, 5, 6);
  if (K == 2) idx = _mm256_setr_epi32(0, 0, 0, 1, 2, 3, 4, 5);
  if (K == 4) idx = _mm256_setr_epi32(0, 0, 0, 0, 0, 1, 2, 3);
  __m256i perm = _mm256_permutevar8x32_epi32(x, idx);
  __m256i lane = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
  __m256i mask = _mm256_cmpgt_epi32(_mm256_set1_epi32(K), lane);  // lane < K
  return _mm256_blendv_epi8(perm, fill, mask);
}

}  // namespace vx
#endif  // __AVX2__

void ksw_extend_one_wide(const uint8_t* q, int qlen, const uint8_t* t,
                         int tlen,
                    const int8_t* mat,  // 5x5
                    int o_del, int e_del, int o_ins, int e_ins, int w,
                    int end_bonus, int zdrop, int h0, int32_t* out6) {
  const int m = 5;
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  // thread-local scratch: extension jobs are ~read-length sized and run in
  // tight OpenMP loops — per-call allocation would dominate short jobs
  static thread_local std::vector<int8_t> qp_s;
  static thread_local std::vector<int32_t> H_s, E_s, hrow_s;
  if ((int64_t)qp_s.size() < (int64_t)m * qlen) qp_s.resize((size_t)m * qlen);
  int8_t* qp = qp_s.data();
  for (int k = 0; k < m; ++k) {
    const int8_t* p = &mat[k * m];
    for (int j = 0; j < qlen; ++j) qp[(size_t)k * qlen + j] = p[q[j]];
  }
  // split h/e state (vector-friendly) + a scratch row for the new h values
  if ((int64_t)H_s.size() < qlen + 9) {
    H_s.resize(qlen + 9);
    E_s.resize(qlen + 9);
    hrow_s.resize(qlen + 9);
  }
  int32_t* H = H_s.data();
  int32_t* E = E_s.data();
  int32_t* hrow = hrow_s.data();
  std::memset(H, 0, sizeof(int32_t) * (qlen + 9));
  std::memset(E, 0, sizeof(int32_t) * (qlen + 9));
  // first row
  H[0] = h0;
  if (qlen > 0) {
    H[1] = h0 > oe_ins ? h0 - oe_ins : 0;
    int j = 2;
    for (; j <= qlen && H[j - 1] > e_ins; ++j) H[j] = H[j - 1] - e_ins;
  }
  // adjust the band width
  int max_sc = mat[0];
  for (int i = 1; i < m * m; ++i) max_sc = std::max(max_sc, (int)mat[i]);
  int max_ins = (int)((double)(qlen * max_sc + end_bonus - o_ins) / e_ins + 1.);
  w = std::min(w, std::max(max_ins, 1));
  int max_del = (int)((double)(qlen * max_sc + end_bonus - o_del) / e_del + 1.);
  w = std::min(w, std::max(max_del, 1));

  int maxv = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1, max_off = 0;
  int beg = 0, end = qlen;
  for (int i = 0; i < tlen; ++i) {
    int mrow = 0, mj = -1;
    const int8_t* qrow = &qp[(size_t)t[i] * qlen];
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    int h1b;  // boundary h entering this row at column beg
    if (beg == 0) {
      h1b = h0 - (o_del + e_del * (i + 1));
      if (h1b < 0) h1b = 0;
    } else {
      h1b = 0;
    }
    int j = beg;
#if defined(__AVX2__)
    if (end - beg >= 16) {
      const __m256i vzero = _mm256_setzero_si256();
      const __m256i voedel = _mm256_set1_epi32(oe_del);
      const __m256i vedel = _mm256_set1_epi32(e_del);
      const __m256i voeins = _mm256_set1_epi32(oe_ins);
      const __m256i veins = _mm256_set1_epi32(e_ins);
      const __m256i viota = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
      int32_t carry = vx::NEG;  // running max of g[k] = tt_ins[k] + k*e_ins
      int vec_end = beg + ((end - beg) & ~7);
      for (; j < vec_end; j += 8) {
        __m256i vMp = _mm256_loadu_si256((const __m256i*)&H[j]);
        __m256i vEo = _mm256_loadu_si256((const __m256i*)&E[j]);
        __m256i vq = _mm256_cvtepi8_epi32(
            _mm_loadl_epi64((const __m128i*)&qrow[j]));
        __m256i zmask = _mm256_cmpeq_epi32(vMp, vzero);  // Mprev == 0
        __m256i vM =
            _mm256_andnot_si256(zmask, _mm256_add_epi32(vMp, vq));
        // E update
        __m256i vtt = _mm256_max_epi32(_mm256_sub_epi32(vM, voedel), vzero);
        __m256i vE =
            _mm256_max_epi32(_mm256_sub_epi32(vEo, vedel), vtt);
        _mm256_storeu_si256((__m256i*)&E[j], vE);
        __m256i vhme = _mm256_max_epi32(vM, vEo);
        // f via prefix-max of g = tt_ins + j*e_ins
        __m256i vtti = _mm256_max_epi32(_mm256_sub_epi32(vM, voeins), vzero);
        __m256i vj =
            _mm256_add_epi32(_mm256_set1_epi32(j), viota);
        __m256i vje = _mm256_mullo_epi32(vj, veins);
        __m256i vg = _mm256_add_epi32(vtti, vje);
        __m256i incl = _mm256_max_epi32(vg, vx::shiftl<1>(vg));
        incl = _mm256_max_epi32(incl, vx::shiftl<2>(incl));
        incl = _mm256_max_epi32(incl, vx::shiftl<4>(incl));
        __m256i excl = _mm256_max_epi32(vx::shiftl<1>(incl),
                                        _mm256_set1_epi32(carry));
        carry = std::max(carry,
                         (int32_t)_mm256_extract_epi32(incl, 7));
        __m256i vf = _mm256_max_epi32(
            _mm256_sub_epi32(excl, _mm256_sub_epi32(vje, veins)), vzero);
        __m256i vh = _mm256_max_epi32(vhme, vf);
        _mm256_storeu_si256((__m256i*)&hrow[j], vh);
      }
      // continue the tail scalar with the reconstructed f chain
      int f = 0;
      if (j > beg)
        f = std::max(carry - (j - 1) * e_ins, 0);
      for (; j < end; ++j) {
        int32_t Mp = H[j], e = E[j];
        int32_t M = Mp ? Mp + qrow[j] : 0;
        int32_t h = M > e ? M : e;
        h = h > f ? h : f;
        hrow[j] = h;
        int tt = M - oe_del;
        tt = tt > 0 ? tt : 0;
        e -= e_del;
        E[j] = e > tt ? e : tt;
        tt = M - oe_ins;
        tt = tt > 0 ? tt : 0;
        f -= e_ins;
        f = f > tt ? f : tt;
      }
      // row max with later-j tie preference ([EXT] ksw_extend2 order)
      for (int k = beg; k < end; ++k) {
        if (!(mrow > hrow[k])) {
          mrow = hrow[k];
          mj = k;
        }
      }
      // commit the shifted h row: H[beg] = boundary, H[j] = h[j-1]
      if (end > beg)
        std::memmove(&H[beg + 1], &hrow[beg], sizeof(int32_t) * (end - beg));
      H[beg] = h1b;
      E[end] = 0;
      goto row_done;
    }
#endif  // __AVX2__
    {
      // original single-pass scalar row, h carried in place
      int f = 0, h1 = h1b;
      for (; j < end; ++j) {
        int32_t Mp = H[j], e = E[j];
        int32_t M = Mp ? Mp + qrow[j] : 0;
        H[j] = h1;
        int h = M > e ? M : e;
        h = h > f ? h : f;
        h1 = h;
        mj = mrow > h ? mj : j;
        mrow = mrow > h ? mrow : h;
        int tt = M - oe_del;
        tt = tt > 0 ? tt : 0;
        e -= e_del;
        E[j] = e > tt ? e : tt;
        tt = M - oe_ins;
        tt = tt > 0 ? tt : 0;
        f -= e_ins;
        f = f > tt ? f : tt;
      }
      H[end] = h1;
      E[end] = 0;
    }
  row_done:;
    int h1 = H[end];
    if (end == qlen) {
      if (gscore <= h1) {
        max_ie = i;
        gscore = h1;
      }
    }
    if (mrow == 0) break;
    if (mrow > maxv) {
      maxv = mrow;
      max_i = i;
      max_j = mj;
      if (max_off < std::abs(mj - i)) max_off = std::abs(mj - i);
    } else if (zdrop > 0) {
      if (i - max_i > mj - max_j) {
        if (maxv - mrow - ((i - max_i) - (mj - max_j)) * e_del > zdrop) break;
      } else {
        if (maxv - mrow - ((mj - max_j) - (i - max_i)) * e_ins > zdrop) break;
      }
    }
    // shrink the window
    j = beg;
    while (j < end && H[j] == 0 && E[j] == 0) ++j;
    beg = j;
    j = end;
    while (j >= beg && H[j] == 0 && E[j] == 0) --j;
    end = j + 2 < qlen ? j + 2 : qlen;
  }
  out6[0] = maxv;
  out6[1] = max_j + 1;
  out6[2] = max_i + 1;
  out6[3] = max_ie + 1;
  out6[4] = gscore;
  out6[5] = max_off;
}

// -------------------------------------------------------------------------
// ksw_extend2 across jobs: 16 lanes of int16, one lane per job (AVX2).
//
// The scalar row recurrence has two serial chains along j — the shifted h
// (h1) and the horizontal-gap tracker f — but BOTH are independent across
// jobs, so running 16 jobs in lockstep turns every chain into a plain
// vector register carried through the j loop: no prefix-max scan, no
// striping, the inner body IS the scalar code on vectors.  All the scalar
// path's semantics are preserved per lane:
//   * adaptive band [beg, end) with stale cells outside it (masked
//     blend-stores), per-row clip to [i-w, i+w+1) and qlen;
//   * the post-row shrink scan (first/last nonzero of the UPDATED h/e row,
//     including the boundary cell at `end`) — tracked as min/max-j vector
//     accumulators during the pass instead of a re-scan;
//   * row-max tie preference for later j, gscore `<=` tie, M==0 reset,
//     Z-drop with del/ins-slope cases, mrow==0 early out.
// Lanes retire independently (tlen end / mrow==0 / zdrop); the row loop
// runs until every lane is done.  int16 is safe for the dispatch domain
// (qlen*max_sc + h0 + end_bonus < 32000 checked per group; short-read
// extension scores are a few hundred).
#if defined(__AVX2__)
namespace soa {

constexpr int LANES = 16;

struct LaneJob {
  const uint8_t* q;
  const uint8_t* t;
  int qlen, tlen, w, h0, end_bonus;
  int32_t* out6;
};

inline __m256i vmax16(__m256i a, __m256i b) { return _mm256_max_epi16(a, b); }

// scores for 16 lanes at row-symbol trow5 (=t*5) and query bytes qb
inline __m256i score16(__m128i trow5, __m128i qb, __m128i tab0,
                       __m128i tab1) {
  __m128i idx = _mm_add_epi8(trow5, qb);
  __m128i lo = _mm_shuffle_epi8(tab0, idx);
  __m128i hi = _mm_shuffle_epi8(tab1, _mm_sub_epi8(idx, _mm_set1_epi8(16)));
  __m128i pick_hi = _mm_cmpgt_epi8(idx, _mm_set1_epi8(15));
  return _mm256_cvtepi8_epi16(_mm_blendv_epi8(lo, hi, pick_hi));
}

void extend_wave16(const LaneJob* jobs, int n, const int8_t* mat, int o_del,
                   int e_del, int o_ins, int e_ins, int zdrop) {
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  int max_q = 0, max_t = 0;
  for (int l = 0; l < n; ++l) {
    max_q = std::max(max_q, jobs[l].qlen);
    max_t = std::max(max_t, jobs[l].tlen);
  }
  // SoA state: H/E rows [max_q+2][16] int16; transposed query [max_q][16]
  static thread_local std::vector<int16_t> Hb, Eb;
  static thread_local std::vector<uint8_t> qTb, tTb;
  Hb.assign((size_t)(max_q + 2) * LANES, 0);
  Eb.assign((size_t)(max_q + 2) * LANES, 0);
  qTb.assign((size_t)std::max(max_q, 1) * LANES, 4);
  tTb.assign((size_t)std::max(max_t, 1) * LANES, 4);
  int16_t* H = Hb.data();
  int16_t* E = Eb.data();
  uint8_t* qT = qTb.data();
  uint8_t* tT = tTb.data();
  for (int l = 0; l < n; ++l) {
    for (int j = 0; j < jobs[l].qlen; ++j) qT[(size_t)j * LANES + l] = jobs[l].q[j];
    for (int i = 0; i < jobs[l].tlen; ++i) tT[(size_t)i * LANES + l] = jobs[l].t[i];
  }
  int max_sc = mat[0];
  for (int i = 1; i < 25; ++i) max_sc = std::max(max_sc, (int)mat[i]);
  // per-lane scalars
  int beg[LANES], end[LANES], w_[LANES], tlen_[LANES], qlen_[LANES];
  int maxv[LANES], max_i[LANES], max_j[LANES], max_ie[LANES],
      gscore[LANES], max_off[LANES];
  bool active[LANES];
  for (int l = 0; l < LANES; ++l) active[l] = false;
  for (int l = 0; l < n; ++l) {
    const LaneJob& jb = jobs[l];
    qlen_[l] = jb.qlen;
    tlen_[l] = jb.tlen;
    // first row
    H[0 * LANES + l] = (int16_t)jb.h0;
    if (jb.qlen > 0) {
      int h1 = jb.h0 > oe_ins ? jb.h0 - oe_ins : 0;
      H[1 * LANES + l] = (int16_t)h1;
      int j = 2;
      for (; j <= jb.qlen && H[(j - 1) * LANES + l] > e_ins; ++j)
        H[(size_t)j * LANES + l] = H[(j - 1) * LANES + l] - (int16_t)e_ins;
    }
    int w = jb.w;
    int max_ins =
        (int)((double)(jb.qlen * max_sc + jb.end_bonus - o_ins) / e_ins + 1.);
    w = std::min(w, std::max(max_ins, 1));
    int max_del =
        (int)((double)(jb.qlen * max_sc + jb.end_bonus - o_del) / e_del + 1.);
    w = std::min(w, std::max(max_del, 1));
    w_[l] = w;
    beg[l] = 0;
    end[l] = jb.qlen;
    maxv[l] = jb.h0;
    max_i[l] = max_j[l] = max_ie[l] = -1;
    gscore[l] = -1;
    max_off[l] = 0;
    active[l] = jb.tlen > 0 && jb.qlen > 0;
    if (!active[l] && jb.tlen == 0) {
      // no rows at all: results are the initial trackers
    }
  }
  __m128i tab0 = _mm_loadu_si128((const __m128i*)mat);
  alignas(16) int8_t t1buf[16] = {};
  std::memcpy(t1buf, mat + 16, 9);
  __m128i tab1 = _mm_load_si128((const __m128i*)t1buf);
  const __m256i vzero = _mm256_setzero_si256();
  const __m256i voedel = _mm256_set1_epi16((int16_t)oe_del);
  const __m256i vedel = _mm256_set1_epi16((int16_t)e_del);
  const __m256i voeins = _mm256_set1_epi16((int16_t)oe_ins);
  const __m256i veins = _mm256_set1_epi16((int16_t)e_ins);

  for (int i = 0;; ++i) {
    bool any = false;
    for (int l = 0; l < n; ++l) any |= active[l] && i < tlen_[l];
    if (!any) break;
    // per-lane row prologue
    alignas(32) int16_t begs[LANES], ends[LANES], h1b[LANES], rowact[LANES];
    alignas(32) int8_t trow5[LANES > 16 ? LANES : 16] = {};
    int jmin = 1 << 30, jmax = 0;
    for (int l = 0; l < LANES; ++l) {
      bool act = l < n && active[l] && i < tlen_[l];
      rowact[l] = act ? -1 : 0;
      if (!act) {
        begs[l] = 0;
        ends[l] = 0;
        h1b[l] = 0;
        continue;
      }
      if (beg[l] < i - w_[l]) beg[l] = i - w_[l];
      if (end[l] > i + w_[l] + 1) end[l] = i + w_[l] + 1;
      if (end[l] > qlen_[l]) end[l] = qlen_[l];
      int h1;
      if (beg[l] == 0) {
        h1 = jobs[l].h0 - (o_del + e_del * (i + 1));
        if (h1 < 0) h1 = 0;
      } else {
        h1 = 0;
      }
      begs[l] = (int16_t)beg[l];
      ends[l] = (int16_t)end[l];
      h1b[l] = (int16_t)h1;
      trow5[l] = (int8_t)(tT[(size_t)i * LANES + l] * 5);
      jmin = std::min(jmin, beg[l]);
      jmax = std::max(jmax, end[l]);
    }
    if (jmin >= jmax) {
      // every active lane has an empty row: commit boundaries + row epilogue
      for (int l = 0; l < n; ++l) {
        if (!rowact[l]) continue;
        // empty row: H[end] = h1b, E[end] = 0, mrow = 0 -> lane retires
        H[(size_t)end[l] * LANES + l] = h1b[l];
        E[(size_t)end[l] * LANES + l] = 0;
        if (end[l] == qlen_[l] && gscore[l] <= h1b[l]) {
          max_ie[l] = i;
          gscore[l] = h1b[l];
        }
        active[l] = false;  // mrow == 0
      }
      continue;
    }
    __m256i vbeg = _mm256_load_si256((const __m256i*)begs);
    __m256i vend = _mm256_load_si256((const __m256i*)ends);
    __m256i vract = _mm256_load_si256((const __m256i*)rowact);
    __m256i vh1 = _mm256_load_si256((const __m256i*)h1b);
    __m256i vf = vzero;
    __m256i vmrow = vzero;
    __m256i vmj = _mm256_set1_epi16(-1);
    __m256i vminnz = _mm256_set1_epi16(0x7FFF);
    __m256i vmaxnz = _mm256_set1_epi16(-1);
    __m128i vt5 = _mm_load_si128((const __m128i*)trow5);
    for (int j = jmin; j < jmax; ++j) {
      __m256i vj = _mm256_set1_epi16((int16_t)j);
      __m256i inr = _mm256_and_si256(
          _mm256_andnot_si256(_mm256_cmpgt_epi16(vbeg, vj),
                              _mm256_cmpgt_epi16(vend, vj)),
          vract);
      __m256i oldH = _mm256_loadu_si256((const __m256i*)&H[(size_t)j * LANES]);
      __m256i oldE = _mm256_loadu_si256((const __m256i*)&E[(size_t)j * LANES]);
      __m128i qb = _mm_loadu_si128((const __m128i*)&qT[(size_t)j * LANES]);
      __m256i sc = score16(vt5, qb, tab0, tab1);
      __m256i zmask = _mm256_cmpeq_epi16(oldH, vzero);
      __m256i vM = _mm256_andnot_si256(zmask, _mm256_add_epi16(oldH, sc));
      __m256i vh = vmax16(vM, oldE);
      vh = vmax16(vh, vf);
      // row max, later-j ties ([EXT] order: mj = mrow > h ? mj : j)
      __m256i keep = _mm256_cmpgt_epi16(vmrow, vh);
      __m256i upd = _mm256_andnot_si256(keep, inr);
      vmj = _mm256_blendv_epi8(vmj, vj, upd);
      vmrow = _mm256_blendv_epi8(vmrow, vmax16(vmrow, vh), inr);
      // E' and f'
      __m256i tt = vmax16(_mm256_sub_epi16(vM, voedel), vzero);
      __m256i vE2 = vmax16(_mm256_sub_epi16(oldE, vedel), tt);
      __m256i tti = vmax16(_mm256_sub_epi16(vM, voeins), vzero);
      __m256i vf2 = vmax16(_mm256_sub_epi16(vf, veins), tti);
      vf = _mm256_blendv_epi8(vf, vf2, inr);
      // stores: H[j] <- h1 (shifted), E[j] <- E'
      __m256i newH = _mm256_blendv_epi8(oldH, vh1, inr);
      __m256i newE = _mm256_blendv_epi8(oldE, vE2, inr);
      _mm256_storeu_si256((__m256i*)&H[(size_t)j * LANES], newH);
      _mm256_storeu_si256((__m256i*)&E[(size_t)j * LANES], newE);
      vh1 = _mm256_blendv_epi8(vh1, vh, inr);
      // shrink-scan accumulators over the UPDATED row
      __m256i nz = _mm256_and_si256(
          inr, _mm256_xor_si256(
                   _mm256_and_si256(_mm256_cmpeq_epi16(newH, vzero),
                                    _mm256_cmpeq_epi16(newE, vzero)),
                   _mm256_set1_epi16(-1)));
      vminnz = _mm256_blendv_epi8(vminnz, _mm256_min_epi16(vminnz, vj), nz);
      vmaxnz = _mm256_blendv_epi8(vmaxnz, vmax16(vmaxnz, vj), nz);
    }
    // row epilogue, per lane
    alignas(32) int16_t h1s[LANES], mrows[LANES], mjs[LANES], minnzs[LANES],
        maxnzs[LANES];
    _mm256_store_si256((__m256i*)h1s, vh1);
    _mm256_store_si256((__m256i*)mrows, vmrow);
    _mm256_store_si256((__m256i*)mjs, vmj);
    _mm256_store_si256((__m256i*)minnzs, vminnz);
    _mm256_store_si256((__m256i*)maxnzs, vmaxnz);
    for (int l = 0; l < n; ++l) {
      if (!rowact[l]) continue;
      int h1 = h1s[l], mrow = mrows[l], mj = mjs[l];
      H[(size_t)end[l] * LANES + l] = (int16_t)h1;
      E[(size_t)end[l] * LANES + l] = 0;
      if (end[l] == qlen_[l]) {
        if (gscore[l] <= h1) {
          max_ie[l] = i;
          gscore[l] = h1;
        }
      }
      if (mrow == 0) {
        active[l] = false;
        continue;
      }
      if (mrow > maxv[l]) {
        maxv[l] = mrow;
        max_i[l] = i;
        max_j[l] = mj;
        if (max_off[l] < std::abs(mj - i)) max_off[l] = std::abs(mj - i);
      } else if (zdrop > 0) {
        if (i - max_i[l] > mj - max_j[l]) {
          if (maxv[l] - mrow - ((i - max_i[l]) - (mj - max_j[l])) * e_del >
              zdrop) {
            active[l] = false;
            continue;
          }
        } else {
          if (maxv[l] - mrow - ((mj - max_j[l]) - (i - max_i[l])) * e_ins >
              zdrop) {
            active[l] = false;
            continue;
          }
        }
      }
      // shrink the window (scalar scan's result from the accumulators;
      // the scan also inspects the boundary cell at `end`)
      int mn = minnzs[l], mx = maxnzs[l];
      if (h1 != 0) mx = std::max(mx, end[l]);  // E[end] == 0 by definition
      int nbeg = (mn <= end[l] - 1 && mn >= beg[l]) ? mn : end[l];
      int nend;
      if (mx >= beg[l])
        nend = mx + 2 < qlen_[l] ? mx + 2 : qlen_[l];
      else
        nend = beg[l] + 1 < qlen_[l] ? beg[l] + 1 : qlen_[l];
      beg[l] = nbeg;
      end[l] = nend;
      if (i + 1 >= tlen_[l]) active[l] = false;
    }
  }
  for (int l = 0; l < n; ++l) {
    int32_t* o6 = jobs[l].out6;
    o6[0] = maxv[l];
    o6[1] = max_j[l] + 1;
    o6[2] = max_i[l] + 1;
    o6[3] = max_ie[l] + 1;
    o6[4] = gscore[l];
    o6[5] = max_off[l];
  }
}

// int16 domain check for a job
inline bool fits16(int qlen, int h0, int end_bonus, int max_sc) {
  return (int64_t)qlen * max_sc + h0 + end_bonus < 30000 && qlen < 2048;
}

}  // namespace soa
#endif  // __AVX2__

// Banded global (NW) alignment with traceback — exact twin of
// engine/extend.py::ksw_global2 (the validated oracle for [EXT] ksw.c's
// ksw_global2 incl. tie-breaks).  Scores in int64 like the oracle; the
// direction matrix z is 1 byte/cell over the band only.
static const int64_t KGLOBAL_MINUS_INF = -0x40000000LL;

static int32_t ksw_global_one(int32_t qlen, const uint8_t* query, int32_t tlen,
                              const uint8_t* target, const int8_t* mat,
                              int32_t o_del, int32_t e_del, int32_t o_ins,
                              int32_t e_ins, int32_t w, int want_cigar,
                              uint32_t* cigar_out, int32_t* n_cigar_out,
                              std::vector<uint8_t>& zbuf,
                              std::vector<int64_t>& ehbuf) {
  if (n_cigar_out) *n_cigar_out = 0;
  if (qlen <= 0 || tlen <= 0) return 0;
  const int64_t oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  const int64_t n_col = qlen < 2 * (int64_t)w + 1 ? qlen : 2 * (int64_t)w + 1;
  uint8_t* z = nullptr;
  if (want_cigar) {
    zbuf.assign((size_t)tlen * n_col, 0);
    z = zbuf.data();
  }
  ehbuf.assign(2 * (size_t)(qlen + 1), KGLOBAL_MINUS_INF);
  int64_t* eh_h = ehbuf.data();
  int64_t* eh_e = eh_h + (qlen + 1);
  eh_h[0] = 0;
  for (int64_t j = 1; j <= qlen && j <= w; ++j)
    eh_h[j] = -(o_ins + e_ins * j);
  // query profile per target symbol row is just mat lookup; loop directly
  for (int64_t i = 0; i < tlen; ++i) {
    int64_t f = KGLOBAL_MINUS_INF;
    const int8_t* q = mat + (int64_t)target[i] * 5;
    int64_t beg = i > w ? i - w : 0;
    int64_t end = i + w + 1 < qlen ? i + w + 1 : qlen;
    int64_t h1 = beg == 0 ? -(o_del + e_del * (i + 1)) : KGLOBAL_MINUS_INF;
    uint8_t* zrow = z ? z + i * n_col : nullptr;
    for (int64_t j = beg; j < end; ++j) {
      int64_t M = eh_h[j];
      int64_t e = eh_e[j];
      eh_h[j] = h1;
      M += q[query[j]];
      uint8_t d = M >= e ? 0 : 1;
      int64_t h = M >= e ? M : e;
      d = h >= f ? d : 2;
      h = h >= f ? h : f;
      h1 = h;
      int64_t t = M - oe_del;
      e -= e_del;
      d |= e > t ? (1 << 2) : 0;
      e = e > t ? e : t;
      eh_e[j] = e;
      t = M - oe_ins;
      f -= e_ins;
      d |= f > t ? (2 << 4) : 0;
      f = f > t ? f : t;
      if (zrow) zrow[j - beg] = d;
    }
    eh_h[end] = h1;
    eh_e[end] = KGLOBAL_MINUS_INF;
  }
  int32_t score = (int32_t)eh_h[qlen];
  if (!want_cigar) return score;
  // backtrack (same order/tie-breaks as the oracle); ops emitted reversed
  int32_t n_cig = 0;
  auto push = [&](uint32_t op, uint32_t ln) {
    if (n_cig && (cigar_out[n_cig - 1] & 0xf) == op)
      cigar_out[n_cig - 1] += ln << 4;
    else
      cigar_out[n_cig++] = (ln << 4) | op;
  };
  int which = 0;
  int64_t i = tlen - 1;
  int64_t k = (i + w + 1 < qlen ? i + w + 1 : qlen) - 1;
  while (i >= 0 && k >= 0) {
    int64_t beg = i > w ? i - w : 0;
    int64_t idx = k - beg;
    // a feasible band (w >= |tlen-qlen|, the gen_cigar2 contract) keeps the
    // traceback inside [0, n_col); for infeasible bands mirror the python
    // oracle's numpy negative-index wraparound instead of reading OOB
    if (idx < 0) idx += n_col;
    if (idx < 0) idx = 0;
    if (idx >= n_col) idx = n_col - 1;
    which = (z[i * n_col + idx] >> (which << 1)) & 3;
    if (which == 0) {
      push(0, 1);
      --i;
      --k;
    } else if (which == 1) {
      push(2, 1);
      --i;
    } else {
      push(1, 1);
      --k;
    }
  }
  if (i >= 0) push(2, (uint32_t)(i + 1));
  if (k >= 0) push(1, (uint32_t)(k + 1));
  // reverse op runs into caller order
  for (int32_t a = 0, b = n_cig - 1; a < b; ++a, --b) {
    uint32_t t = cigar_out[a];
    cigar_out[a] = cigar_out[b];
    cigar_out[b] = t;
  }
  *n_cigar_out = n_cig;
  return score;
}

// mem_reg2aln's CIGAR core: band-doubling retry loop around
// bwa_gen_cigar2 (global alignment + NM/MD), exact twin of
// engine/finalize.py::reg2aln's while-loop + gen_cigar2.  Reference
// anchored at [EXT] bwamem.c mem_reg2aln / bwa.c bwa_gen_cigar2.
struct Reg2AlnOut {
  int32_t score;
  int32_t nm;
  int32_t n_cig;
  int32_t n_md;
};

static void gen_cigar2_one(const uint8_t* query, int64_t l_query, int64_t rb,
                           int64_t re, const uint8_t* ref_fwd, int64_t l_pac,
                           const int8_t* mat, int32_t o_del, int32_t e_del,
                           int32_t o_ins, int32_t e_ins, int64_t w_,
                           uint32_t* cig, int32_t* n_cig, uint8_t* md,
                           int32_t* n_md, int32_t* score, int32_t* nm,
                           std::vector<uint8_t>& qtmp,
                           std::vector<uint8_t>& rtmp,
                           std::vector<uint8_t>& zbuf,
                           std::vector<int64_t>& ehbuf) {
  *n_cig = 0;
  *n_md = 0;
  *nm = -1;
  *score = 0;
  if (l_query <= 0 || rb >= re || (rb < l_pac && re > l_pac)) return;
  int64_t rlen = re - rb;
  // fetch rseq on the doubled domain (bns_get_seq semantics)
  rtmp.resize(rlen);
  if (rb >= l_pac) {
    int64_t fb = 2 * l_pac - re, fe = 2 * l_pac - rb;
    for (int64_t i = 0; i < fe - fb; ++i) {
      uint8_t c = ref_fwd[fe - 1 - i];
      rtmp[i] = c < 4 ? 3 - c : c;
    }
  } else {
    std::memcpy(rtmp.data(), ref_fwd + rb, rlen);
  }
  const uint8_t* q = query;
  uint8_t* rs = rtmp.data();
  if (rb >= l_pac) {  // flip both so indels left-align on the forward strand
    qtmp.assign(query, query + l_query);
    std::reverse(qtmp.begin(), qtmp.end());
    std::reverse(rtmp.begin(), rtmp.end());
    q = qtmp.data();
  }
  if (l_query == rlen && w_ == 0) {  // no gap possible: straight diagonal
    cig[0] = ((uint32_t)l_query << 4) | 0;
    *n_cig = 1;
    int64_t sc = 0;
    for (int64_t i = 0; i < l_query; ++i) sc += mat[(int64_t)rs[i] * 5 + q[i]];
    *score = (int32_t)sc;
  } else {
    int32_t max_sc = mat[0];
    int64_t max_ins =
        (int64_t)((double)(((l_query + 1) >> 1) * max_sc - o_ins) / e_ins + 1.0);
    int64_t max_del =
        (int64_t)((double)(((l_query + 1) >> 1) * max_sc - o_del) / e_del + 1.0);
    int64_t max_gap = std::max(std::max(max_ins, max_del), (int64_t)1);
    int64_t w = (max_gap + std::llabs(rlen - l_query) + 1) >> 1;
    w = std::min(w, w_);
    int64_t min_w = std::llabs(rlen - l_query) + 3;
    w = std::max(w, min_w);
    *score = ksw_global_one((int32_t)l_query, q, (int32_t)rlen, rs, mat, o_del,
                            e_del, o_ins, e_ins, (int32_t)w, 1, cig, n_cig,
                            zbuf, ehbuf);
  }
  // NM / MD over the (possibly flipped) sequences
  static const char FWD_BASE[] = "ACGTN";
  static const char REV_BASE[] = "TGCAN";
  const char* int2base = rb < l_pac ? FWD_BASE : REV_BASE;
  int64_t x = 0, y = 0, u = 0, n_mm = 0;
  int32_t mdl = 0;
  auto put_num = [&](int64_t v) {
    char tmp[20];
    int t = 0;
    if (v == 0) tmp[t++] = '0';
    while (v > 0) {
      tmp[t++] = (char)('0' + v % 10);
      v /= 10;
    }
    while (t > 0) md[mdl++] = tmp[--t];
  };
  int32_t nc = *n_cig;
  for (int32_t k = 0; k < nc; ++k) {
    uint32_t op = cig[k] & 0xf;
    int64_t ln = cig[k] >> 4;
    if (op == 0) {  // match run
      int64_t last = -1;
      for (int64_t i = 0; i < ln; ++i) {
        if (q[x + i] != rs[y + i]) {
          ++n_mm;
          put_num(u + i - last - 1);
          md[mdl++] = int2base[rs[y + i]];
          u = 0;
          last = i;
        }
      }
      u = last < 0 ? u + ln : ln - 1 - last;
      x += ln;
      y += ln;
    } else if (op == 2) {  // deletion
      if (k > 0 && k < nc - 1) {  // MD only for interior deletions
        put_num(u);
        md[mdl++] = '^';
        for (int64_t i = 0; i < ln; ++i) md[mdl++] = int2base[rs[y + i]];
        u = 0;
      }
      y += ln;
      n_mm += ln;
    } else if (op == 1) {  // insertion
      x += ln;
      n_mm += ln;
    }
  }
  put_num(u);
  *n_md = mdl;
  *nm = (int32_t)n_mm;
}

}  // namespace

extern "C" {

void bwamem_ksw_extend_batch(
    int64_t n_jobs, const uint8_t* qbuf, const int64_t* qoff,
    const int32_t* qlen, const uint8_t* tbuf, const int64_t* toff,
    const int32_t* tlen, const int8_t* mat, int o_del, int e_del, int o_ins,
    int e_ins, int zdrop, const int32_t* h0, const int32_t* w,
    const int32_t* end_bonus, int32_t* out) {
#if defined(__AVX2__)
  // route short jobs through the 16-lane SoA kernel in tlen-sorted groups
  // (similar row counts per group keep lane utilization high); long /
  // out-of-int16-domain jobs take the scalar or wide row kernels
  int max_sc = mat[0];
  for (int i = 1; i < 25; ++i) max_sc = std::max(max_sc, (int)mat[i]);
  if (n_jobs >= 16) {
    std::vector<int64_t> grp, rest;
    grp.reserve(n_jobs);
    for (int64_t i = 0; i < n_jobs; ++i) {
      if (soa::fits16(qlen[i], h0[i], end_bonus[i], max_sc) && qlen[i] > 0 &&
          tlen[i] > 0)
        grp.push_back(i);
      else
        rest.push_back(i);
    }
    std::sort(grp.begin(), grp.end(), [&](int64_t a, int64_t b) {
      return tlen[a] != tlen[b] ? tlen[a] < tlen[b] : qlen[a] < qlen[b];
    });
    int64_t n_groups = ((int64_t)grp.size() + soa::LANES - 1) / soa::LANES;
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t g = 0; g < n_groups; ++g) {
      soa::LaneJob jobs[soa::LANES];
      int64_t lo = g * soa::LANES;
      int nl = (int)std::min((int64_t)soa::LANES, (int64_t)grp.size() - lo);
      for (int l = 0; l < nl; ++l) {
        int64_t i = grp[lo + l];
        jobs[l] = soa::LaneJob{qbuf + qoff[i], tbuf + toff[i], qlen[i],
                               tlen[i], w[i], h0[i], end_bonus[i],
                               out + i * 6};
      }
      soa::extend_wave16(jobs, nl, mat, o_del, e_del, o_ins, e_ins, zdrop);
    }
#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t k = 0; k < (int64_t)rest.size(); ++k) {
      int64_t i = rest[k];
      (qlen[i] >= 2048 ? ksw_extend_one_wide : ksw_extend_one)(
          qbuf + qoff[i], qlen[i], tbuf + toff[i], tlen[i], mat, o_del,
          e_del, o_ins, e_ins, w[i], end_bonus[i], zdrop, h0[i],
          out + i * 6);
    }
    return;
  }
#endif  // __AVX2__
#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t i = 0; i < n_jobs; ++i) {
    (qlen[i] >= 2048 ? ksw_extend_one_wide : ksw_extend_one)(
        qbuf + qoff[i], qlen[i], tbuf + toff[i], tlen[i], mat,
                   o_del, e_del, o_ins, e_ins, w[i], end_bonus[i], zdrop,
                   h0[i], out + i * 6);
  }
}

// Single-job entry with NO OpenMP region: chain2aln's per-seed retry loop
// issues tens of thousands of tiny extensions per batch from inside an
// already-parallel region — a parallel-for entry per call costs more than
// the DP itself at short read lengths.
void bwamem_ksw_extend_single(
    const uint8_t* q, int32_t qlen, const uint8_t* t, int32_t tlen,
    const int8_t* mat, int o_del, int e_del, int o_ins, int e_ins, int zdrop,
    int32_t h0, int32_t w, int32_t end_bonus, int32_t* out6) {
  (qlen >= 2048 ? ksw_extend_one_wide : ksw_extend_one)(
      q, qlen, t, tlen, mat, o_del, e_del, o_ins, e_ins, w, end_bonus,
      zdrop, h0, out6);
}

int32_t bwamem_ksw_global(int32_t qlen, const uint8_t* query, int32_t tlen,
                          const uint8_t* target, const int8_t* mat,
                          int32_t o_del, int32_t e_del, int32_t o_ins,
                          int32_t e_ins, int32_t w, int32_t want_cigar,
                          uint32_t* cigar_out, int32_t* n_cigar_out) {
  std::vector<uint8_t> zbuf;
  std::vector<int64_t> ehbuf;
  return ksw_global_one(qlen, query, tlen, target, mat, o_del, e_del, o_ins,
                        e_ins, w, want_cigar, cigar_out, n_cigar_out, zbuf,
                        ehbuf);
}

// mem_reg2aln CIGAR core, batched: per job runs the band-doubling retry
// loop around gen_cigar2 (global SW + NM/MD).  Caller provides per-job
// cigar capacity (qlen+rlen+4 ops) and MD capacity (2*(qlen+rlen)+32 B)
// via the offset arrays.  OpenMP across jobs.
void bwamem_reg2aln_batch(
    int64_t n_jobs, const uint8_t* qbuf, const int64_t* qoff,
    const int32_t* qlen, const int64_t* rb, const int64_t* re,
    const int64_t* w0, const int64_t* truesc, const uint8_t* ref_fwd,
    int64_t l_pac, const int8_t* mat, int32_t o_del, int32_t e_del,
    int32_t o_ins, int32_t e_ins, int32_t opt_w, int32_t opt_a,
    uint32_t* cig_buf, const int64_t* cig_off, int32_t* n_cig_out,
    uint8_t* md_buf, const int64_t* md_off, int32_t* n_md_out,
    int32_t* score_out, int32_t* nm_out) {
#pragma omp parallel
  {
    std::vector<uint8_t> qtmp, rtmp, zbuf;
    std::vector<int64_t> ehbuf;
#pragma omp for schedule(dynamic, 8)
    for (int64_t j = 0; j < n_jobs; ++j) {
      const uint8_t* q = qbuf + qoff[j];
      uint32_t* cig = cig_buf + cig_off[j];
      uint8_t* md = md_buf + md_off[j];
      int64_t w2 = w0[j];
      int64_t last_sc = -(1LL << 30);
      int32_t score = 0, nm = -1, n_cig = 0, n_md = 0;
      for (int tries = 0;;) {
        w2 = std::min(w2, (int64_t)opt_w << 2);
        gen_cigar2_one(q, qlen[j], rb[j], re[j], ref_fwd, l_pac, mat, o_del,
                       e_del, o_ins, e_ins, w2, cig, &n_cig, md, &n_md,
                       &score, &nm, qtmp, rtmp, zbuf, ehbuf);
        if (score == last_sc || w2 == (int64_t)opt_w << 2) break;
        last_sc = score;
        w2 <<= 1;
        ++tries;
        if (!(tries < 3 && score < truesc[j] - opt_a)) break;
      }
      n_cig_out[j] = n_cig;
      n_md_out[j] = n_md;
      score_out[j] = score;
      nm_out[j] = nm;
    }
  }
}

// Single-job variant of bwamem_reg2aln_batch for call sites that cannot
// batch: scalar args, caller-preallocated outputs, no OpenMP.
void bwamem_reg2aln_one(const uint8_t* q, int32_t lq, int64_t rb, int64_t re,
                        int64_t w0, int64_t truesc, const uint8_t* ref_fwd,
                        int64_t l_pac, const int8_t* mat, int32_t o_del,
                        int32_t e_del, int32_t o_ins, int32_t e_ins,
                        int32_t opt_w, int32_t opt_a, uint32_t* cig,
                        int32_t* n_cig, uint8_t* md, int32_t* n_md,
                        int32_t* score_out, int32_t* nm_out) {
  static thread_local std::vector<uint8_t> qtmp, rtmp, zbuf;
  static thread_local std::vector<int64_t> ehbuf;
  int64_t w2 = w0;
  int64_t last_sc = -(1LL << 30);
  int32_t score = 0, nm = -1;
  *n_cig = 0;
  *n_md = 0;
  for (int tries = 0;;) {
    w2 = std::min(w2, (int64_t)opt_w << 2);
    gen_cigar2_one(q, lq, rb, re, ref_fwd, l_pac, mat, o_del, e_del, o_ins,
                   e_ins, w2, cig, n_cig, md, n_md, &score, &nm, qtmp, rtmp,
                   zbuf, ehbuf);
    if (score == last_sc || w2 == (int64_t)opt_w << 2) break;
    last_sc = score;
    w2 <<= 1;
    ++tries;
    if (!(tries < 3 && score < truesc - opt_a)) break;
  }
  *score_out = score;
  *nm_out = nm;
}

// Batched variant: jobs share flattened buffers; per-job cigar capacity is
// qlen+tlen ops written at cig_off[i]; OpenMP-parallel across jobs.
void bwamem_ksw_global_batch(int64_t n_jobs, const uint8_t* qbuf,
                             const int64_t* qoff, const int32_t* qlen,
                             const uint8_t* tbuf, const int64_t* toff,
                             const int32_t* tlen, const int8_t* mat,
                             int32_t o_del, int32_t e_del, int32_t o_ins,
                             int32_t e_ins, const int32_t* w,
                             uint32_t* cig_buf, const int64_t* cig_off,
                             int32_t* n_cig_out, int32_t* score_out) {
#pragma omp parallel
  {
    std::vector<uint8_t> zbuf;
    std::vector<int64_t> ehbuf;
#pragma omp for schedule(dynamic, 8)
    for (int64_t i = 0; i < n_jobs; ++i) {
      score_out[i] = ksw_global_one(
          qlen[i], qbuf + qoff[i], tlen[i], tbuf + toff[i], mat, o_del, e_del,
          o_ins, e_ins, w[i], 1, cig_buf + cig_off[i], n_cig_out + i, zbuf,
          ehbuf);
    }
  }
}

}  // extern "C"
