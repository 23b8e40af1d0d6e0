// Chains to alignment regions (bwa mem_chain2aln) for Hopper (sm_90a).
//
// Replaces the last stage of the JAX device program
// bwamem_tpu/ops/pipeline_fused.py `pipeline_fused_body` (with `_win_codes`,
// `_max_gap`, `_ext_retry`, `prune_current` and `outer_body`): per chain the
// extension window, per read the mem_chain2aln loop.  The program's earlier
// stages are seed.cu, fmindex.cu and chain.cu; this file starts from
// chain.cu's output (chain_rows [Nc, 7], seed_rows [Ns, 4]) where it lies on
// the card.  Its semantics are the host oracle's, engine/extend.py
// `chain2aln`:
//
// * per chain, [rmax0, rmax1]: min/max over its seeds of the span a gapped
//   extension could reach (cal_max_gap), clamped to [0, 2 l_pac], cut at the
//   strand boundary on the side of the chain's first seed, then clamped to
//   that seed's contig (bns_fetch_seq);
// * per chain, its seeds in ascending (score, index) order, walked from the
//   end down;
// * per seed: skip it when it lies inside a region the read already has,
//   close to that region's diagonal, unless a live later seed of the chain
//   argues for another alignment; else extend left (reversed prefix,
//   h0 = len * a, pen_clip5) and right (pen_clip3, h0 = the left score), each
//   at band w and again at 2w when the score moved and max_off reached 3/4 of
//   the band; choose local or to-the-end by gscore; seedcov over the chain's
//   seeds; write the region.
//
// Design: `chain2aln_prep_kernel`, one thread per chain, and
// `chain2aln_kernel`, one thread per read, a sequential state machine as the
// oracle writes it, so regions of a read's earlier chains prune seeds of its
// later ones.  The JAX program's barrel shifts, 128-base pac-row gathers,
// one-hot region writes and lane-compaction ladder are TPU shapes of a gather,
// an append and a loop that ends early; none is carried over.  The DP is the
// shared __device__ function of extend.cuh.  Its target is read from the
// 2-bit pac as the DP walks, base by base (a position at or past l_pac is the
// complement of the mirrored forward base), so there is no window buffer, no
// T_cap and nothing uploaded per wave; its query is read from the padded
// reads that seeding put on the card.  The eh scratch is [2, Q+1, B] with the
// read index fastest, re-initialised per job.  A read's regions go to its
// offset in a table as long as seed_rows (a read makes at most one region per
// seed), so there is no R budget.  cal_max_gap and the two ratio tests are
// computed in double as the oracle computes them, and the file is built
// without --use_fast_math.
//
// What bounds it: the read with the most extension work.  A thread runs its
// read's jobs one after another (a few per read on average, tens for a read
// in a repeat), each a DP of dependent loads of eh cells through L1/L2; a
// warp runs as long as its slowest read.  Bytes (a few tens of MB a batch)
// and operations (~10 per band cell) would take well under a millisecond.
//
// Errors: a seed outside its chain's window, a region past the read's rows
// or a first seed in no contig set a bit of *err; the wrapper raises.

#include <cstdint>
#include <cuda_runtime.h>

#include "extend.cuh"

namespace {

constexpr int kPrepThreads = 128;
constexpr int kThreads = 32;  // one warp a block: a batch spreads over the SMs
constexpr int kErrWindow = 1;
constexpr int kErrRows = 2;
constexpr int kErrContig = 4;
constexpr int kMaxBandTry = 2;

struct Opts {
  int a, o_del, e_del, o_ins, e_ins, zdrop, w, pen_clip5, pen_clip3, max_sc;
};

// cal_max_gap (`MemOptions.max_gap`): the quotient in double, truncated
// toward zero.
__device__ __forceinline__ int64_t cal_max_gap(const Opts& o, int64_t qlen) {
  const int l_del = static_cast<int>(
      static_cast<double>(qlen * o.a - o.o_del) / static_cast<double>(o.e_del) +
      1.0);
  const int l_ins = static_cast<int>(
      static_cast<double>(qlen * o.a - o.o_ins) / static_cast<double>(o.e_ins) +
      1.0);
  int l = l_del > l_ins ? l_del : l_ins;
  if (l < 1) l = 1;
  return l < (o.w << 1) ? l : (o.w << 1);
}

__global__ void __launch_bounds__(kPrepThreads) chain2aln_prep_kernel(
    const int64_t* __restrict__ chain_rows,      // [Nc, 7]
    const int64_t* __restrict__ seed_rows,       // [Ns, 4] rbeg qbeg len score
    const int64_t* __restrict__ chain_seed_off,  // [Nc]
    const int32_t* __restrict__ chain_read,      // [Nc]
    const int32_t* __restrict__ qlen,            // [B]
    int64_t n_chains, const int64_t* __restrict__ ctg_end,
    const int64_t* __restrict__ ctg_off, int n_ctg, int64_t l_pac, Opts o,
    int64_t* __restrict__ rmax,  // [Nc, 2]
    int32_t* __restrict__ srt,   // [Ns] seed indices within the chain
    int32_t* __restrict__ err) {
  const int64_t ci = static_cast<int64_t>(blockIdx.x) * kPrepThreads + threadIdx.x;
  if (ci >= n_chains) return;
  const int64_t ns = chain_rows[ci * 7 + 2];
  const int64_t so = chain_seed_off[ci];
  const int64_t ql = qlen[chain_read[ci]];
  int64_t r0 = l_pac << 1, r1 = 0;
  for (int64_t t = 0; t < ns; ++t) {
    const int64_t* s = seed_rows + (so + t) * 4;
    const int64_t rbeg = s[0], qb = s[1], len = s[2], sc = s[3];
    const int64_t tail = ql - qb - len;
    const int64_t b = rbeg - (qb + cal_max_gap(o, qb));
    const int64_t e = rbeg + len + (tail + cal_max_gap(o, tail));
    if (b < r0) r0 = b;
    if (e > r1) r1 = e;
    // stable insertion by score: ties keep index order
    int64_t k = t;
    while (k > 0 && seed_rows[(so + srt[so + k - 1]) * 4 + 3] > sc) {
      srt[so + k] = srt[so + k - 1];
      --k;
    }
    srt[so + k] = static_cast<int32_t>(t);
  }
  if (ns <= 0) {
    rmax[ci * 2] = 0;
    rmax[ci * 2 + 1] = 0;
    return;
  }
  if (r0 < 0) r0 = 0;
  if (r1 > (l_pac << 1)) r1 = l_pac << 1;
  const int64_t first = seed_rows[so * 4];
  const bool fwd = first < l_pac;
  if (r0 < l_pac && l_pac < r1) {  // crossing the strand boundary
    if (fwd)
      r1 = l_pac;
    else
      r0 = l_pac;
  }
  // the contig holding the first seed: the count of contig ends <= its
  // forward position
  const int64_t mid = fwd ? first : (l_pac << 1) - 1 - first;
  int lo = 0, hi = n_ctg;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (ctg_end[m] <= mid)
      lo = m + 1;
    else
      hi = m;
  }
  if (lo >= n_ctg || mid < 0) {
    atomicOr(err, kErrContig);
    rmax[ci * 2] = 0;
    rmax[ci * 2 + 1] = 0;
    return;
  }
  int64_t far_beg = ctg_off[lo], far_end = ctg_end[lo];
  if (!fwd) {
    const int64_t fb = (l_pac << 1) - far_end;
    far_end = (l_pac << 1) - far_beg;
    far_beg = fb;
  }
  rmax[ci * 2] = r0 > far_beg ? r0 : far_beg;
  rmax[ci * 2 + 1] = r1 < far_end ? r1 : far_end;
}

// Query bases of a read, forward from p or backward from it.
struct QueryView {
  const uint8_t* __restrict__ p;
  int dir;
  __device__ __forceinline__ int operator()(int j) const { return p[dir * j]; }
};

// Reference bases from the 2-bit pac (four bases a byte, the first in the
// high bits) at doubled-domain positions pos, pos + dir, ...
struct PacView {
  const uint8_t* __restrict__ pac;
  int64_t l_pac, pos;
  int dir;
  __device__ __forceinline__ int operator()(int i) const {
    const int64_t p = pos + static_cast<int64_t>(dir) * i;
    const bool rev = p >= l_pac;
    const int64_t f = rev ? (l_pac << 1) - 1 - p : p;
    const int c = (pac[f >> 2] >> ((~f & 3) << 1)) & 3;
    return rev ? 3 - c : c;
  }
};

// One extension job of a read: the band preamble, then the DP.
__device__ __noinline__ bwamem::KswResult extend_job(
    QueryView q, PacView t, int qlen, int tlen, int h0, int w, int end_bonus,
    const Opts& o, const int32_t* smat, int32_t* H, int32_t* E, int64_t st) {
  const int w_adj = bwamem::ksw_band_width(qlen, w, end_bonus, o.max_sc,
                                           o.o_del, o.e_del, o.o_ins, o.e_ins);
  return bwamem::ksw_extend_core(q, t, qlen, tlen, h0, w_adj, smat, H, E, st,
                                 qlen, o.o_del, o.e_del, o.o_ins, o.e_ins,
                                 o.zdrop);
}

// One side of a seed: the job at w, then at 2w under the oracle's break rule
// (`score` enters as the previous score and leaves as the job's).
__device__ __forceinline__ bwamem::KswResult extend_side(
    QueryView q, PacView t, int qlen, int tlen, int h0, int end_bonus,
    const Opts& o, const int32_t* smat, int32_t* H, int32_t* E, int64_t st,
    int& score, int& aw, int64_t* work) {
  bwamem::KswResult res;
  for (int i2 = 0; i2 < kMaxBandTry; ++i2) {
    const int prev = score;
    aw = o.w << i2;
    res = extend_job(q, t, qlen, tlen, h0, aw, end_bonus, o, smat, H, E, st);
    work[2] += 1;
    work[4] += res.cells;
    work[5] += res.rows;
    score = res.score;
    if (score == prev || res.max_off < (aw >> 1) + (aw >> 2)) break;
  }
  return res;
}

__global__ void __launch_bounds__(kThreads) chain2aln_kernel(
    const int64_t* __restrict__ chain_rows,      // [Nc, 7]
    const int64_t* __restrict__ seed_rows,       // [Ns, 4]
    const int64_t* __restrict__ chain_off,       // [B] first chain of the read
    const int64_t* __restrict__ n_chain,         // [B]
    const int64_t* __restrict__ seed_off,        // [B] first seed row of the read
    const int64_t* __restrict__ n_seed,          // [B]
    const int64_t* __restrict__ chain_seed_off,  // [Nc]
    const int64_t* __restrict__ rmax,            // [Nc, 2]
    const int32_t* __restrict__ srt,             // [Ns]
    uint8_t* __restrict__ alive,                 // [Ns] scratch, by srt position
    const uint8_t* __restrict__ run,             // [B]
    const uint8_t* __restrict__ qseq, int64_t ldq,  // [B, ldq] codes 0-4
    const int32_t* __restrict__ qlen, int B, int Q,
    const uint8_t* __restrict__ pac, int64_t l_pac,
    const int32_t* __restrict__ mat, Opts o, int64_t t_cap,
    int32_t* __restrict__ eh_h,   // [Q+1, B] scratch
    int32_t* __restrict__ eh_e,   // [Q+1, B] scratch
    int64_t* __restrict__ reg_c,  // [Ns, 3] rb re frac_rep bits
    int32_t* __restrict__ reg_i,  // [Ns, 8] qb qe score truesc w seedcov seedlen0 rid
    int32_t* __restrict__ nregs,  // [B]
    int64_t* __restrict__ work_out,  // [B, 6]
    int32_t* __restrict__ err) {
  __shared__ int32_t smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  int64_t work[6] = {0, 0, 0, 0, 0, 0};
  int nreg = 0;
  if (run[b]) {
    const int ql = qlen[b];
    const uint8_t* qrow = qseq + b * ldq;
    int32_t* H = eh_h + b;
    int32_t* E = eh_e + b;
    const int64_t st = B;
    const int64_t base = seed_off[b], max_regs = n_seed[b];
    const int64_t c_end = chain_off[b] + n_chain[b];
    bool failed = false;
    for (int64_t ci = chain_off[b]; ci < c_end && !failed; ++ci) {
      const int64_t* cr = chain_rows + ci * 7;
      const int64_t ns = cr[2], so = chain_seed_off[ci];
      const int64_t r0 = rmax[ci * 2], r1 = rmax[ci * 2 + 1];
      for (int64_t k = 0; k < ns; ++k) alive[so + k] = 1;
      for (int64_t k = ns - 1; k >= 0; --k) {
        const int64_t* s = seed_rows + (so + srt[so + k]) * 4;
        const int64_t rbeg = s[0];
        const int qb = static_cast<int>(s[1]), len = static_cast<int>(s[2]);
        // has this seed's neighbourhood been extended already?
        bool contained = false;
        for (int r = 0; r < nreg && !contained; ++r) {
          const int64_t* pc = reg_c + (base + r) * 3;
          const int32_t* pi = reg_i + (base + r) * 8;
          const int64_t p_rb = pc[0], p_re = pc[1];
          const int p_qb = pi[0], p_qe = pi[1], p_w = pi[4], p_sl0 = pi[6];
          if (rbeg < p_rb || rbeg + len > p_re || qb < p_qb || qb + len > p_qe)
            continue;
          if (static_cast<double>(len - p_sl0) > 0.1 * static_cast<double>(ql))
            continue;
          int64_t qd = qb - p_qb, rd = rbeg - p_rb;
          int64_t w = cal_max_gap(o, qd < rd ? qd : rd);
          if (w > p_w) w = p_w;
          if (qd - rd < w && rd - qd < w) {
            contained = true;
            break;
          }
          qd = p_qe - (qb + len);
          rd = p_re - (rbeg + len);
          w = cal_max_gap(o, qd < rd ? qd : rd);
          if (w > p_w) w = p_w;
          if (qd - rd < w && rd - qd < w) contained = true;
        }
        if (contained) {
          // unless a live later seed of the chain argues for another alignment
          bool diff = false;
          for (int64_t i2 = k + 1; i2 < ns && !diff; ++i2) {
            if (!alive[so + i2]) continue;
            const int64_t* t = seed_rows + (so + srt[so + i2]) * 4;
            const int64_t t_rbeg = t[0];
            const int t_qb = static_cast<int>(t[1]), t_len = static_cast<int>(t[2]);
            if (static_cast<double>(t_len) < static_cast<double>(len) * 0.95)
              continue;
            if (qb <= t_qb && qb + len - t_qb >= (len >> 2) &&
                t_qb - qb != t_rbeg - rbeg)
              diff = true;
            else if (t_qb <= qb && t_qb + t_len - qb >= (len >> 2) &&
                     qb - t_qb != rbeg - t_rbeg)
              diff = true;
          }
          if (!diff) {
            alive[so + k] = 0;
            work[1] += 1;
            continue;
          }
        }
        if (rbeg < r0 || rbeg + len > r1) {
          atomicOr(err, kErrWindow);
          failed = true;
          break;
        }
        if (nreg >= max_regs) {
          atomicOr(err, kErrRows);
          failed = true;
          break;
        }
        work[0] += 1;
        if (r1 - r0 > t_cap) work[3] = 1;
        int aw0 = o.w, aw1 = o.w;
        int score = -1, truesc, qb_f, qe_f;
        int64_t rb_f, re_f;
        if (qb > 0) {  // left extension on the reversed prefix
          const bwamem::KswResult res = extend_side(
              QueryView{qrow + qb - 1, -1}, PacView{pac, l_pac, rbeg - 1, -1},
              qb, static_cast<int>(rbeg - r0), len * o.a, o.pen_clip5, o, smat,
              H, E, st, score, aw0, work);
          if (res.gscore <= 0 || res.gscore <= score - o.pen_clip5) {
            qb_f = qb - res.qle;
            rb_f = rbeg - res.tle;
            truesc = score;
          } else {
            qb_f = 0;
            rb_f = rbeg - res.gtle;
            truesc = res.gscore;
          }
        } else {
          score = truesc = len * o.a;
          qb_f = 0;
          rb_f = rbeg;
        }
        const int qe = qb + len;
        const int64_t re0 = rbeg + len;
        if (qe != ql) {  // right extension
          const int sc0 = score;
          const bwamem::KswResult res = extend_side(
              QueryView{qrow + qe, 1}, PacView{pac, l_pac, re0, 1}, ql - qe,
              static_cast<int>(r1 - re0), sc0, o.pen_clip3, o, smat, H, E, st,
              score, aw1, work);
          if (res.gscore <= 0 || res.gscore <= score - o.pen_clip3) {
            qe_f = qe + res.qle;
            re_f = re0 + res.tle;
            truesc += score - sc0;
          } else {
            qe_f = ql;
            re_f = re0 + res.gtle;
            truesc += res.gscore - sc0;
          }
        } else {
          qe_f = ql;
          re_f = re0;
        }
        int seedcov = 0;
        for (int64_t t2 = 0; t2 < ns; ++t2) {
          const int64_t* t = seed_rows + (so + t2) * 4;
          if (t[1] >= qb_f && t[1] + t[2] <= qe_f && t[0] >= rb_f &&
              t[0] + t[2] <= re_f)
            seedcov += static_cast<int>(t[2]);
        }
        int64_t* pc = reg_c + (base + nreg) * 3;
        int32_t* pi = reg_i + (base + nreg) * 8;
        pc[0] = rb_f;
        pc[1] = re_f;
        pc[2] = cr[3];
        pi[0] = qb_f;
        pi[1] = qe_f;
        pi[2] = score;
        pi[3] = truesc;
        pi[4] = aw0 > aw1 ? aw0 : aw1;
        pi[5] = seedcov;
        pi[6] = len;
        pi[7] = static_cast<int32_t>(cr[0]);
        ++nreg;
      }
    }
  }
  nregs[b] = nreg;
  for (int k = 0; k < 6; ++k) work_out[b * 6 + k] = work[k];
}

__global__ void band_width_kernel(const int32_t* __restrict__ qlen,
                                  const int32_t* __restrict__ w,
                                  const int32_t* __restrict__ end_bonus, int n,
                                  int max_sc, int o_del, int e_del, int o_ins,
                                  int e_ins, int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = bwamem::ksw_band_width(qlen[i], w[i], end_bonus[i], max_sc, o_del,
                                    e_del, o_ins, e_ins);
}

}  // namespace

// Launchers: device pointers and a stream in, cudaGetLastError() out.

extern "C" int bwamem_chain2aln_prep_launch(
    const int64_t* chain_rows, const int64_t* seed_rows,
    const int64_t* chain_seed_off, const int32_t* chain_read,
    const int32_t* qlen, int64_t n_chains, const int64_t* ctg_end,
    const int64_t* ctg_off, int n_ctg, int64_t l_pac, int a, int o_del,
    int e_del, int o_ins, int e_ins, int zdrop, int w, int pen_clip5,
    int pen_clip3, int max_sc, int64_t* rmax, int32_t* srt, int32_t* err,
    cudaStream_t stream) {
  if (n_chains <= 0) return 0;
  const Opts o{a, o_del, e_del, o_ins, e_ins, zdrop, w, pen_clip5, pen_clip3,
               max_sc};
  const unsigned blocks =
      static_cast<unsigned>((n_chains + kPrepThreads - 1) / kPrepThreads);
  chain2aln_prep_kernel<<<blocks, kPrepThreads, 0, stream>>>(
      chain_rows, seed_rows, chain_seed_off, chain_read, qlen, n_chains,
      ctg_end, ctg_off, n_ctg, l_pac, o, rmax, srt, err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bwamem_chain2aln_launch(
    const int64_t* chain_rows, const int64_t* seed_rows,
    const int64_t* chain_off, const int64_t* n_chain, const int64_t* seed_off,
    const int64_t* n_seed, const int64_t* chain_seed_off, const int64_t* rmax,
    const int32_t* srt, uint8_t* alive, const uint8_t* run,
    const uint8_t* qseq, int64_t ldq, const int32_t* qlen, int B, int Q,
    const uint8_t* pac, int64_t l_pac, const int32_t* mat, int a, int o_del,
    int e_del, int o_ins, int e_ins, int zdrop, int w, int pen_clip5,
    int pen_clip3, int max_sc, int64_t t_cap, int32_t* eh, int64_t* reg_c,
    int32_t* reg_i, int32_t* nregs, int64_t* work, int32_t* err,
    cudaStream_t stream) {
  if (B <= 0) return 0;
  const Opts o{a, o_del, e_del, o_ins, e_ins, zdrop, w, pen_clip5, pen_clip3,
               max_sc};
  int32_t* eh_e = eh + static_cast<int64_t>(Q + 1) * B;
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  chain2aln_kernel<<<blocks, kThreads, 0, stream>>>(
      chain_rows, seed_rows, chain_off, n_chain, seed_off, n_seed,
      chain_seed_off, rmax, srt, alive, run, qseq, ldq, qlen, B, Q, pac, l_pac,
      mat, o, t_cap, eh, eh_e, reg_c, reg_i, nregs, work, err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bwamem_band_width_launch(
    const int32_t* qlen, const int32_t* w, const int32_t* end_bonus, int n,
    int max_sc, int o_del, int e_del, int o_ins, int e_ins, int32_t* out,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  band_width_kernel<<<(n + 127) / 128, 128, 0, stream>>>(
      qlen, w, end_bonus, n, max_sc, o_del, e_del, o_ins, e_ins, out);
  return static_cast<int>(cudaGetLastError());
}
