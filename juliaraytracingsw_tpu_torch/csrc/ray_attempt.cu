// Fused embedded Dormand-Prince 5(4) attempt (CUDA C++, sm_90a), in two
// forms over one piece of stage math.
//
// Replaces the Pallas TPU kernel `_attempt_kernel` that `make_fused_attempt`
// builds in juliaraytracingsw_tpu/ops/pallas_ray_step.py (pallas_call at
// :462, stage math `_attempt_math` at :336-385). Its plain PyTorch twin is
// `attempt_torch` in ops/ray_step.py; the two compute the same formulas in
// the same order, up to FMA contraction. (The error sum is a cancellation
// of stage slopes down to the truncation error, so its last digits are
// that round-off; the controller compares mean(esum)/4 with 1, and the two
// agree far below that scale.) It is the inner step of the
// adaptive ray path (rays/raytrace.raytrace_adaptive, pair 'dopri5',
// loop 'while', patch gather).
//
// The first cut keeps the reference's contract, 1:1 with the twin:
//   rows_T (2W, N) f32  gathered (old|new) patch rows, tap-major;
//   st     (7, N)  f32  [x y k l sign bx by], (bx, by) the patch base cell;
//   scal   (5,)    f32  [a0, dah, h, rtol, atol] in DEVICE memory: a0, dah
//                       and h come from the device clock, so no attempt
//                       waits on the host for them;
//   out    (5, N)  f32  [x5 y5 k5 l5 esum]: the 5th-order solution and the
//                       packet's sum of squared scaled component errors.
// The caller turns sum(esum) into the batch's Hairer norm.
//
// The table form, the one the adaptive path runs, reads the pair table
// T_pair (ny*nx, 2W) f32 or bf16 itself and takes st (5, N) = [x y k l
// sign]; each warp stages its packets' rows into shared memory, tap-major,
// as ray_step.cu's table form does (ray_sample.cuh: stage_rows). A rejected
// attempt reads its rows again (at the hero's size 84 MB of bf16 rows,
// 0.025 ms at 3.35 TB/s), where the first cut's caller reused gathered and
// transposed rows that cost 6.7 ms to make.
//
// The error is scaled by PATCH-LOCAL positions (x - shx, y - shy), as the
// reference kernel scales it; the shift is added back to the outputs only.
// (The reference's unfused attempt scales by global positions: a different
// formulation, kept apart in rays/raytrace.py.)
//
// What bounds it on the H100: memory, as for ray_step.cu. One thread
// integrates one packet through all 7 stages in registers. The 5th-order
// sum and the error sum accumulate stage by stage, in the twin's order, so
// only the stage slopes that later stage inputs need stay live.
//
// Every tableau constant is the float32 rounding of the Python double the
// twin uses (b - b4 is subtracted in double, then rounded once). Stage
// inputs add (h * a_ij) * k_j in stage order and skip a_ij == 0; the two
// sums skip zero weights, as the twin does.

#include <cuda_runtime.h>

#include <cstdint>

#include "ray_sample.cuh"

namespace {

using namespace jrsw;

// Dormand-Prince 5(4): nodes, stage matrix, 5th-order weights and the
// error weights b - b4 (juliaraytracingsw_tpu/rays/raytrace.py:302-315).
constexpr float kC2 = float(1.0 / 5.0), kC3 = float(3.0 / 10.0), kC4 = float(4.0 / 5.0),
                kC5 = float(8.0 / 9.0), kC6 = 1.0f, kC7 = 1.0f;
constexpr float kA21 = float(1.0 / 5.0);
constexpr float kA31 = float(3.0 / 40.0), kA32 = float(9.0 / 40.0);
constexpr float kA41 = float(44.0 / 45.0), kA42 = float(-56.0 / 15.0), kA43 = float(32.0 / 9.0);
constexpr float kA51 = float(19372.0 / 6561.0), kA52 = float(-25360.0 / 2187.0),
                kA53 = float(64448.0 / 6561.0), kA54 = float(-212.0 / 729.0);
constexpr float kA61 = float(9017.0 / 3168.0), kA62 = float(-355.0 / 33.0),
                kA63 = float(46732.0 / 5247.0), kA64 = float(49.0 / 176.0),
                kA65 = float(-5103.0 / 18656.0);
// the 7th stage is taken at the 5th-order solution's weights (a_72 = 0)
constexpr double kB1d = 35.0 / 384.0, kB3d = 500.0 / 1113.0, kB4d = 125.0 / 192.0,
                 kB5d = -2187.0 / 6784.0, kB6d = 11.0 / 84.0;
constexpr float kB1 = float(kB1d), kB3 = float(kB3d), kB4 = float(kB4d), kB5 = float(kB5d),
                kB6 = float(kB6d);
constexpr float kE1 = float(kB1d - 5179.0 / 57600.0), kE3 = float(kB3d - 7571.0 / 16695.0),
                kE4 = float(kB4d - 393.0 / 640.0), kE5 = float(kB5d - -92097.0 / 339200.0),
                kE6 = float(kB6d - 187.0 / 2100.0), kE7 = float(0.0 - 1.0 / 40.0);

// q += (h * a) * k, componentwise
__device__ __forceinline__ void add_slope(float q[4], float ha, const float k[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = q[j] + ha * k[j];
}

// s = k * w on the first weight, s += k * w after it
__device__ __forceinline__ void first_term(float s[4], const float k[4], float w) {
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = k[j] * w;
}
__device__ __forceinline__ void next_term(float s[4], const float k[4], float w) {
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = s[j] + k[j] * w;
}

// scaled squared error of one component (Hairer's mixed norm)
__device__ __forceinline__ float comp_err(float e, float y_new, float y_old, float rtol,
                                          float atol) {
  const float sc = atol + rtol * fmaxf(fabsf(y_old), fabsf(y_new));
  const float r = e / sc;
  return r * r;
}

// One DP5(4) attempt of packet i from its rows; writes out[:, i].
template <int I, class R>
__device__ __forceinline__ void dp5_packet(const R& rows, float x, float y, float kk, float ll,
                                           float sgn, float bx, float by,
                                           const float* __restrict__ scal, const RayConsts& c,
                                           float* __restrict__ out, int64_t n, int64_t i) {
  const float a0 = scal[0], dah = scal[1], h = scal[2], rtol = scal[3], atol = scal[4];
  // patch base in physical coordinates; stage math and the error scale run
  // patch-local
  const float shx = c.x0 + bx * c.dx;
  const float shy = c.y0 + by * c.dy;
  const float z0[4] = {x - shx, y - shy, kk, ll};

  float k1[4], k2[4], k3[4], k4[4], k5[4], k6[4], k7[4], q[4];
  float s5[4], se[4];  // running 5th-order and error sums
  auto stage = [&](const float qs[4], float ci, float kout[4]) {
    rhs<I>(rows, qs[0], qs[1], qs[2], qs[3], sgn, a0 + ci * dah, c, kout);
  };
  auto reset = [&](float qs[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) qs[j] = z0[j];
  };

  reset(q);
  stage(q, 0.0f, k1);
  first_term(s5, k1, kB1);
  first_term(se, k1, kE1);

  reset(q);
  add_slope(q, h * kA21, k1);
  stage(q, kC2, k2);

  reset(q);
  add_slope(q, h * kA31, k1);
  add_slope(q, h * kA32, k2);
  stage(q, kC3, k3);
  next_term(s5, k3, kB3);
  next_term(se, k3, kE3);

  reset(q);
  add_slope(q, h * kA41, k1);
  add_slope(q, h * kA42, k2);
  add_slope(q, h * kA43, k3);
  stage(q, kC4, k4);
  next_term(s5, k4, kB4);
  next_term(se, k4, kE4);

  reset(q);
  add_slope(q, h * kA51, k1);
  add_slope(q, h * kA52, k2);
  add_slope(q, h * kA53, k3);
  add_slope(q, h * kA54, k4);
  stage(q, kC5, k5);
  next_term(s5, k5, kB5);
  next_term(se, k5, kE5);

  reset(q);
  add_slope(q, h * kA61, k1);
  add_slope(q, h * kA62, k2);
  add_slope(q, h * kA63, k3);
  add_slope(q, h * kA64, k4);
  add_slope(q, h * kA65, k5);
  stage(q, kC6, k6);
  next_term(s5, k6, kB6);
  next_term(se, k6, kE6);

  reset(q);
  add_slope(q, h * kB1, k1);
  add_slope(q, h * kB3, k3);
  add_slope(q, h * kB4, k4);
  add_slope(q, h * kB5, k5);
  add_slope(q, h * kB6, k6);
  stage(q, kC7, k7);
  next_term(se, k7, kE7);

  float esum = 0.0f;
  float y5[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    y5[j] = z0[j] + h * s5[j];
    const float c_j = comp_err(h * se[j], y5[j], z0[j], rtol, atol);
    esum = (j == 0) ? c_j : esum + c_j;
  }
  out[i] = y5[0] + shx;
  out[n + i] = y5[1] + shy;
  out[2 * n + i] = y5[2];
  out[3 * n + i] = y5[3];
  out[4 * n + i] = esum;
}

constexpr int kThreads = 256;

// the first cut: rows_T (2W, N) in device memory
template <int I>
__global__ void __launch_bounds__(kThreads)
ray_attempt_kernel(const float* __restrict__ rows, const float* __restrict__ st,
                   const float* __restrict__ scal, float* __restrict__ out, int64_t n,
                   RayConsts c) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Rows<float, int64_t> src{rows + i, rows + int64_t(pair_width<I>() / 2) * n + i, n};
  dp5_packet<I>(src, st[i], st[n + i], st[2 * n + i], st[3 * n + i], st[4 * n + i],
                st[5 * n + i], st[6 * n + i], scal, c, out, n, i);
}

// the table form: each warp stages its packets' rows from T_pair
template <int I, typename T>
__global__ void __launch_bounds__(TableTile<I, T>::kThreads)
ray_attempt_table_kernel(const T* __restrict__ table, int ny, int nx,
                         const float* __restrict__ st, const float* __restrict__ scal,
                         float* __restrict__ out, int64_t n, RayConsts c) {
  extern __shared__ uint4 smem_raw[];
  const int lane = threadIdx.x & 31;
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i - lane >= n) return;                  // the whole warp is past the end
  T* tile = reinterpret_cast<T*>(smem_raw) +
            (threadIdx.x >> 5) * (TableTile<I, T>::kWidth * kTileStride);
  const bool live = i < n;
  float x = 0.0f, y = 0.0f, bx = 0.0f, by = 0.0f;
  int64_t row = -1;
  if (live) {
    x = st[i];
    y = st[n + i];
    row = table_row(x, y, c, ny, nx, &bx, &by);
  }
  stage_rows<I>(table, row, tile, lane);
  __syncwarp();
  if (!live) return;
  const Rows<T, int> src{tile + lane, tile + (pair_width<I>() / 2) * kTileStride + lane,
                          kTileStride};
  dp5_packet<I>(src, x, y, st[2 * n + i], st[3 * n + i], st[4 * n + i], bx, by, scal, c, out,
                n, i);
}

template <int I, typename T>
int launch_table(const void* table, int ny, int nx, const float* st, const float* scal,
                 float* out, long long n, const RayConsts& c, cudaStream_t s) {
  using G = TableTile<I, T>;
  auto kernel = ray_attempt_table_kernel<I, T>;
  // set on every call: the attributes belong to the current device
  const cudaError_t attr = set_table_attributes(kernel, G::kBlockBytes);
  if (attr != cudaSuccess) return int(attr);
  const unsigned blocks = unsigned((n + G::kThreads - 1) / G::kThreads);
  kernel<<<blocks, G::kThreads, G::kBlockBytes, s>>>(static_cast<const T*>(table), ny, nx, st,
                                                      scal, out, n, c);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_table(int interp, const void* table, int ny, int nx, const float* st,
                   const float* scal, float* out, long long n, const RayConsts& c,
                   cudaStream_t s) {
  switch (interp) {
    case kBilinear:
      return launch_table<kBilinear, T>(table, ny, nx, st, scal, out, n, c, s);
    case kBspline:
      return launch_table<kBspline, T>(table, ny, nx, st, scal, out, n, c, s);
    case kBicubic:
      return launch_table<kBicubic, T>(table, ny, nx, st, scal, out, n, c, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on
// success), or the error of setting the table kernel's shared memory.
extern "C" int jrsw_ray_attempt(int interp, const float* rows_T, const float* st,
                                const float* scal, float* out, long long n, float x0, float y0,
                                float dx, float dy, float f2, float Cg2, void* stream) {
  if (n <= 0) return 0;
  const RayConsts c{x0, y0, dx, dy, f2, Cg2};
  const unsigned blocks = unsigned((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (interp) {
    case kBilinear:
      ray_attempt_kernel<kBilinear><<<blocks, kThreads, 0, s>>>(rows_T, st, scal, out, n, c);
      break;
    case kBspline:
      ray_attempt_kernel<kBspline><<<blocks, kThreads, 0, s>>>(rows_T, st, scal, out, n, c);
      break;
    case kBicubic:
      ray_attempt_kernel<kBicubic><<<blocks, kThreads, 0, s>>>(rows_T, st, scal, out, n, c);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// T_pair (ny*nx, 2W) of dtype `table_dtype` (0 f32, 1 bf16); st (5, N).
extern "C" int jrsw_ray_attempt_table(int interp, int table_dtype, const void* table, int ny,
                                      int nx, const float* st, const float* scal, float* out,
                                      long long n, float x0, float y0, float dx, float dy,
                                      float f2, float Cg2, void* stream) {
  if (n <= 0) return 0;
  const RayConsts c{x0, y0, dx, dy, f2, Cg2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_dtype) {
    case kTableF32:
      return dispatch_table<float>(interp, table, ny, nx, st, scal, out, n, c, s);
    case kTableBf16:
      return dispatch_table<bf16_bits>(interp, table, ny, nx, st, scal, out, n, c, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
