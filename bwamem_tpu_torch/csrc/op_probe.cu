// Per-op cost microprobes for Hopper (sm_90a).
//
// Replaces the Pallas kernel of benchmarks/mosaic_probe.py `probe`: K
// dependent iterations of one op-class body over an array held on chip,
// written back once, so that the slope of the kernel's time over K is the
// time of one iteration.  The nine bodies are mosaic_probe.py's, element
// for element (the Python side, bwamem_tpu_torch/benchmarks/op_probe.py,
// holds their plain PyTorch versions):
//
//   wide32, wide16, row32  [R, 128]  v = v + v, 32 times (int32 / int16)
//   scal32                 [512, 1]  v = v + v, 32 times
//   reduce                 [512, 128] v = v + max(v, axis=1)
//   roll-lane              [512, 128] v = roll(v, 1, axis=1) + 1, 8 times
//   roll-sub               [128, 512] v = roll(v, 1, axis=0) + 1, 8 times
//   reduce-sub             [128, 512] v = v + max(v, axis=0)
//   prefmax                [512, 128] inclusive prefix max along axis 1,
//                          log-step: P = max(P, col >= k ? roll(P, k) : -2^30)
//
// Mapping.  A [R, 128] array puts one row on each warp, four neighbouring
// columns on each lane: the lane roll, the lane max and the prefix max are
// warp shuffles (`__shfl_sync`, `__reduce_max_sync`).  A [128, C] array
// puts 32 columns on each block of four warps, lane = column, 32 rows of it
// in each thread's registers: the axis-0 roll and max cross warps through
// shared memory behind one barrier (double-buffered).  [512, 1] is one
// element per thread.
//
// What bounds them: nothing but the op chain itself; each iteration
// depends on the previous one and the array never leaves registers, so a
// probe measures the latency and issue rate of its op class.
//
// Keeping the ops: 32 doublings of x are x << 32, which is 0, and a
// compiler that sees that deletes the whole K loop.  Every add therefore
// goes through `asm volatile`, which the front end can neither fold nor
// merge, and the K loop is kept rolled (`#pragma unroll 1`), so that the
// SASS of each kernel's loop can be counted (op_probe.py does, with
// cuobjdump).  PTX `add` wraps modulo 2^n, the two's-complement semantics
// of the int32 / int16 arithmetic of the bodies.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPer = 4;    // columns of a 128-wide row on each lane
constexpr int kSubRows = 32;  // rows of a [128, C] column on each thread

__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  int32_t r;
  asm volatile("add.s32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ int16_t add(int16_t a, int16_t b) {
  int16_t r;
  asm volatile("add.s16 %0, %1, %2;" : "=h"(r) : "h"(a), "h"(b));
  return r;
}

enum Body { kAdds, kReduce, kRollLane, kPrefMax, kRollSub, kReduceSub };

// ---- [R, 128]: one row per warp, columns 4*lane .. 4*lane+3 on each lane

template <int B, typename T>
__device__ __forceinline__ void lane_step(T (&v)[kPer], int lane) {
  if constexpr (B == kAdds) {
#pragma unroll
    for (int r = 0; r < 32; ++r)
#pragma unroll
      for (int e = 0; e < kPer; ++e) v[e] = add(v[e], v[e]);
  } else if constexpr (B == kReduce) {
    int m = max(max(v[0], v[1]), max(v[2], v[3]));
    m = __reduce_max_sync(kFull, m);
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] = add(v[e], m);
  } else if constexpr (B == kRollLane) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      // roll by one column: column 4*lane comes from lane-1's last
      const T t = __shfl_sync(kFull, v[kPer - 1], (lane + 31) & 31);
#pragma unroll
      for (int e = kPer - 1; e > 0; --e) v[e] = v[e - 1];
      v[0] = t;
#pragma unroll
      for (int e = 0; e < kPer; ++e) v[e] = add(v[e], T(1));
    }
  } else if constexpr (B == kPrefMax) {
#pragma unroll
    for (int k = 1; k < 32 * kPer; k <<= 1) {
      T s[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        // column 4*lane+e reads column 4*lane+e-k: d lanes back, element se
        const int d = (k - e + kPer - 1) / kPer;
        const int se = ((e - k) % kPer + kPer) % kPer;
        s[e] = d == 0 ? v[se] : __shfl_sync(kFull, v[se], (lane - d) & 31);
      }
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const T m = kPer * lane + e >= k ? s[e] : T(-(1 << 30));
        v[e] = max(v[e], m);
      }
    }
  }
}

template <int B, typename T>
__device__ __forceinline__ void lane_probe(const T* __restrict__ x,
                                           T* __restrict__ out, int rows,
                                           int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int64_t base = int64_t{row} * (32 * kPer) + kPer * lane;
  T v[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) v[e] = x[base + e];
#pragma unroll 1
  for (int it = 0; it < K; ++it) lane_step<B>(v, lane);
#pragma unroll
  for (int e = 0; e < kPer; ++e) out[base + e] = v[e];
}

// ---- [128, C]: 32 columns per block of 4 warps; warp w holds rows
// 32w .. 32w+31 of its lane's column in registers

template <int B>
__device__ __forceinline__ void sub_probe(const int32_t* __restrict__ x,
                                          int32_t* __restrict__ out, int cols,
                                          int K) {
  __shared__ int32_t xchg[2][4][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  int32_t v[kSubRows];
#pragma unroll
  for (int r = 0; r < kSubRows; ++r)
    v[r] = x[int64_t{kSubRows * w + r} * cols + col];
  int buf = 0;
#pragma unroll 1
  for (int it = 0; it < K; ++it) {
    if constexpr (B == kRollSub) {
#pragma unroll
      for (int r8 = 0; r8 < 8; ++r8) {
        // row 32w comes from the previous warp's last row (row 127 for
        // warp 0); one barrier per roll, the buffers alternate
        xchg[buf][w][lane] = v[kSubRows - 1];
        __syncthreads();
        const int32_t t = xchg[buf][(w + 3) & 3][lane];
        buf ^= 1;
#pragma unroll
        for (int r = kSubRows - 1; r > 0; --r) v[r] = v[r - 1];
        v[0] = t;
#pragma unroll
        for (int r = 0; r < kSubRows; ++r) v[r] = add(v[r], 1);
      }
    } else {
      int32_t m = v[0];
#pragma unroll
      for (int r = 1; r < kSubRows; ++r) m = max(m, v[r]);
      xchg[buf][w][lane] = m;
      __syncthreads();
      m = max(max(xchg[buf][0][lane], xchg[buf][1][lane]),
              max(xchg[buf][2][lane], xchg[buf][3][lane]));
      buf ^= 1;
#pragma unroll
      for (int r = 0; r < kSubRows; ++r) v[r] = add(v[r], m);
    }
  }
#pragma unroll
  for (int r = 0; r < kSubRows; ++r)
    out[int64_t{kSubRows * w + r} * cols + col] = v[r];
}

}  // namespace

// One kernel per probe, named for it, so that its SASS can be found.
#define LANE_PROBE(name, body, T)                                          \
  extern "C" __global__ void __launch_bounds__(128)                        \
      probe_##name(const T* x, T* out, int rows, int K) {                  \
    lane_probe<body>(x, out, rows, K);                                     \
  }
LANE_PROBE(wide32, kAdds, int32_t)
LANE_PROBE(wide16, kAdds, int16_t)
LANE_PROBE(row32, kAdds, int32_t)
LANE_PROBE(reduce, kReduce, int32_t)
LANE_PROBE(roll_lane, kRollLane, int32_t)
LANE_PROBE(prefmax, kPrefMax, int32_t)
#undef LANE_PROBE

extern "C" __global__ void __launch_bounds__(128)
    probe_scal32(const int32_t* x, int32_t* out, int n, int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t v = x[i];
#pragma unroll 1
  for (int it = 0; it < K; ++it)
#pragma unroll
    for (int r = 0; r < 32; ++r) v = add(v, v);
  out[i] = v;
}

extern "C" __global__ void __launch_bounds__(128)
    probe_roll_sub(const int32_t* x, int32_t* out, int cols, int K) {
  sub_probe<kRollSub>(x, out, cols, K);
}

extern "C" __global__ void __launch_bounds__(128)
    probe_reduce_sub(const int32_t* x, int32_t* out, int cols, int K) {
  sub_probe<kReduceSub>(x, out, cols, K);
}

// The probes in op_probe.py's order.  rows x cols is the array's shape;
// returns cudaErrorInvalidValue for a shape the probe's mapping does not
// take, else cudaGetLastError().
extern "C" int bwamem_op_probe_launch(int probe, const void* x, void* out,
                                      int rows, int cols, int K,
                                      cudaStream_t stream) {
  const bool lane_shape = cols == 32 * kPer && rows > 0;
  const bool sub_shape = rows == 4 * kSubRows && cols > 0 && cols % 32 == 0;
  const unsigned lane_blocks = static_cast<unsigned>((rows + 3) / 4);
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto o32 = [](void* p) { return static_cast<int32_t*>(p); };
  switch (probe) {
    case 0:
      if (!lane_shape) return cudaErrorInvalidValue;
      probe_wide32<<<lane_blocks, 128, 0, stream>>>(i32(x), o32(out), rows, K);
      break;
    case 1:
      if (!lane_shape) return cudaErrorInvalidValue;
      probe_wide16<<<lane_blocks, 128, 0, stream>>>(
          static_cast<const int16_t*>(x), static_cast<int16_t*>(out), rows, K);
      break;
    case 2:
      if (cols != 1 || rows <= 0) return cudaErrorInvalidValue;
      probe_scal32<<<(rows + 127) / 128, 128, 0, stream>>>(i32(x), o32(out),
                                                           rows, K);
      break;
    case 3:
      if (!lane_shape) return cudaErrorInvalidValue;
      probe_row32<<<lane_blocks, 128, 0, stream>>>(i32(x), o32(out), rows, K);
      break;
    case 4:
      if (!lane_shape) return cudaErrorInvalidValue;
      probe_reduce<<<lane_blocks, 128, 0, stream>>>(i32(x), o32(out), rows, K);
      break;
    case 5:
      if (!lane_shape) return cudaErrorInvalidValue;
      probe_roll_lane<<<lane_blocks, 128, 0, stream>>>(i32(x), o32(out), rows,
                                                       K);
      break;
    case 6:
      if (!sub_shape) return cudaErrorInvalidValue;
      probe_roll_sub<<<cols / 32, 128, 0, stream>>>(i32(x), o32(out), cols, K);
      break;
    case 7:
      if (!sub_shape) return cudaErrorInvalidValue;
      probe_reduce_sub<<<cols / 32, 128, 0, stream>>>(i32(x), o32(out), cols,
                                                      K);
      break;
    case 8:
      if (!lane_shape) return cudaErrorInvalidValue;
      probe_prefmax<<<lane_blocks, 128, 0, stream>>>(i32(x), o32(out), rows,
                                                     K);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
