// Fused RK4 ray substep (CUDA C++, sm_90a), in two forms over one piece of
// stage math.
//
// Replaces the Pallas TPU kernel `_kernel` that `make_fused_substep` builds
// in juliaraytracingsw_tpu/ops/pallas_ray_step.py (pallas_call at :284,
// stage math `_substep_math`/`_make_sample` at :124-233). Its plain PyTorch
// twin is `substep_torch` in ops/ray_step.py; the two compute the same
// formulas in the same order, up to FMA contraction.
//
// The first cut keeps the reference's contract, 1:1 with the twin:
//   rows_T (2W, N) f32  gathered (old|new) patch rows, tap-major;
//   st     (7, N)  f32  [x y k l sign bx by], (bx, by) the patch base cell;
//   scal   (2,)    f32  [a0, h] in DEVICE memory: h comes from the device
//                       clock, so reading it here keeps the host from
//                       waiting on the stream every substep;
//   out    (4, N)  f32  [x' y' k' l'].
// W = channels * PH * PW: 5 * 4 * 4 = 80 bilinear, 5 * 6 * 6 = 180 bspline,
// 20 * 4 * 4 = 320 bicubic ([f|fx|fy|fxy] Hermite corner data).
//
// The table form, the one the ray path runs, reads the pair table itself:
//   T_pair (ny*nx, 2W) f32 or bf16, row-major, as make_pair_table builds it;
//   st     (5, N)      f32  [x y k l sign]; the kernel finds each packet's
//                           base cell (bx, by) and table row, as
//                           rays/raytrace._gather_patch_rows does;
//   scal, out as above.
// The first cut's contract cost the ray path two full passes over N x 2W
// values in device memory before every launch (row gather and upcast, then
// the transpose: 6.7 ms of an 8.2 ms hero step on the H100). Here each warp
// loads its 32 packets' rows with 16-byte loads, once, and transposes them
// in shared memory (ray_sample.cuh: stage_rows); then each thread
// integrates its own packet, exactly as the first cut does, reading its
// taps from the tile.
//
// What bounds it on the H100: memory. At the hero size (N = 2^20,
// bilinear, bf16) the table rows that hold a packet (262,144 of them at 4
// packets a cell) are 84 MB, the state and output 38 MB, against ~230
// flops per packet and stage. The first cut reads only the taps that
// carry weight (40 of 160 bilinear values) from rows_T in device memory;
// the table form reads the whole row once into shared memory, and every
// stage's taps from there.
//
// Offsets into device memory are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "ray_sample.cuh"

namespace {

using namespace jrsw;

struct Consts {
  RayConsts r;        // grid and dispersion constants
  float c_half, c1;   // stage time offsets 0.5*da and 1.0*da
  float b16, b13;     // RK4 weights 1/6 and 1/3
};

// One RK4 substep of packet i from its rows; writes out[:, i].
template <int I, class R>
__device__ __forceinline__ void rk4_packet(const R& rows, float x, float y, float kk, float ll,
                                           float sgn, float bx, float by, float a0, float h,
                                           const Consts& c, float* __restrict__ out,
                                           int64_t n, int64_t i) {
  // patch base in physical coordinates; stage math runs patch-local
  const float shx = c.r.x0 + bx * c.r.dx;
  const float shy = c.r.y0 + by * c.r.dy;
  const float lx = x - shx, ly = y - shy;

  float k1[4], k2[4], k3[4], k4[4];
  const float hh = h * 0.5f;
  rhs<I>(rows, lx, ly, kk, ll, sgn, a0 + 0.0f, c.r, k1);
  rhs<I>(rows, lx + hh * k1[0], ly + hh * k1[1], kk + hh * k1[2], ll + hh * k1[3], sgn,
         a0 + c.c_half, c.r, k2);
  rhs<I>(rows, lx + hh * k2[0], ly + hh * k2[1], kk + hh * k2[2], ll + hh * k2[3], sgn,
         a0 + c.c_half, c.r, k3);
  rhs<I>(rows, lx + h * k3[0], ly + h * k3[1], kk + h * k3[2], ll + h * k3[3], sgn,
         a0 + c.c1, c.r, k4);

  float d[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float s = k1[j] * c.b16;
    s = s + k2[j] * c.b13;
    s = s + k3[j] * c.b13;
    s = s + k4[j] * c.b16;
    d[j] = s;
  }
  out[i] = (lx + h * d[0]) + shx;
  out[n + i] = (ly + h * d[1]) + shy;
  out[2 * n + i] = kk + h * d[2];
  out[3 * n + i] = ll + h * d[3];
}

constexpr int kThreads = 256;

// the first cut: rows_T (2W, N) in device memory
template <int I>
__global__ void __launch_bounds__(kThreads)
ray_step_kernel(const float* __restrict__ rows, const float* __restrict__ st,
                const float* __restrict__ scal, float* __restrict__ out, int64_t n, Consts c) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Rows<float, int64_t> src{rows + i, rows + int64_t(pair_width<I>() / 2) * n + i, n};
  rk4_packet<I>(src, st[i], st[n + i], st[2 * n + i], st[3 * n + i], st[4 * n + i],
                st[5 * n + i], st[6 * n + i], scal[0], scal[1], c, out, n, i);
}

// the table form: each warp stages its packets' rows from T_pair
template <int I, typename T>
__global__ void __launch_bounds__(TableTile<I, T>::kThreads)
ray_step_table_kernel(const T* __restrict__ table, int ny, int nx,
                      const float* __restrict__ st, const float* __restrict__ scal,
                      float* __restrict__ out, int64_t n, Consts c) {
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
    row = table_row(x, y, c.r, ny, nx, &bx, &by);
  }
  stage_rows<I>(table, row, tile, lane);
  __syncwarp();
  if (!live) return;
  const Rows<T, int> src{tile + lane, tile + (pair_width<I>() / 2) * kTileStride + lane,
                          kTileStride};
  rk4_packet<I>(src, x, y, st[2 * n + i], st[3 * n + i], st[4 * n + i], bx, by, scal[0],
                scal[1], c, out, n, i);
}

template <int I, typename T>
int launch_table(const void* table, int ny, int nx, const float* st, const float* scal,
                 float* out, long long n, const Consts& c, cudaStream_t s) {
  using G = TableTile<I, T>;
  auto kernel = ray_step_table_kernel<I, T>;
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
                   const float* scal, float* out, long long n, const Consts& c,
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
extern "C" int jrsw_ray_step(int interp, const float* rows_T, const float* st, const float* scal,
                             float* out, long long n, float x0, float y0, float dx, float dy,
                             float f2, float Cg2, float c_half, float c1, float b16, float b13,
                             void* stream) {
  if (n <= 0) return 0;
  const Consts c{{x0, y0, dx, dy, f2, Cg2}, c_half, c1, b16, b13};
  const unsigned blocks = unsigned((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (interp) {
    case kBilinear:
      ray_step_kernel<kBilinear><<<blocks, kThreads, 0, s>>>(rows_T, st, scal, out, n, c);
      break;
    case kBspline:
      ray_step_kernel<kBspline><<<blocks, kThreads, 0, s>>>(rows_T, st, scal, out, n, c);
      break;
    case kBicubic:
      ray_step_kernel<kBicubic><<<blocks, kThreads, 0, s>>>(rows_T, st, scal, out, n, c);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// T_pair (ny*nx, 2W) of dtype `table_dtype` (0 f32, 1 bf16); st (5, N).
extern "C" int jrsw_ray_step_table(int interp, int table_dtype, const void* table, int ny,
                                   int nx, const float* st, const float* scal, float* out,
                                   long long n, float x0, float y0, float dx, float dy,
                                   float f2, float Cg2, float c_half, float c1, float b16,
                                   float b13, void* stream) {
  if (n <= 0) return 0;
  const Consts c{{x0, y0, dx, dy, f2, Cg2}, c_half, c1, b16, b13};
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
