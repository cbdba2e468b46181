// Fused RK4 ray substep over gathered patch rows (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` that `make_fused_substep` builds
// in juliaraytracingsw_tpu/ops/pallas_ray_step.py (pallas_call at :284,
// stage math `_substep_math`/`_make_sample` at :124-233). Its plain PyTorch
// twin is `substep_torch` in ops/ray_step.py; the two compute the same
// formulas in the same order, up to FMA contraction.
//
// Contract (the reference's, kept 1:1 with the twin):
//   rows_T (2W, N) f32  gathered (old|new) patch rows, tap-major, so tap t
//                       of neighbouring packets sits at neighbouring
//                       addresses and every tap load is coalesced;
//   st     (7, N)  f32  [x y k l sign bx by], (bx, by) the patch base cell;
//   scal   (2,)    f32  [a0, h] in DEVICE memory: h comes from the device
//                       clock, so reading it here keeps the host from
//                       waiting on the stream every substep;
//   out    (4, N)  f32  [x' y' k' l'].
// W = channels * PH * PW: 5 * 4 * 4 = 80 bilinear, 5 * 6 * 6 = 180 bspline,
// 20 * 4 * 4 = 320 bicubic ([f|fx|fy|fxy] Hermite corner data).
//
// What bounds it on the H100: memory. At the hero size (N = 2^20,
// bilinear) rows_T alone is 160 f32 x 1M packets = 671 MB per substep,
// against ~230 flops per packet and stage, far below the card's
// flop-per-byte balance. The design's answer is to read each tap that
// carries weight exactly once per stage: the separable weights are zero
// outside a 2x2 window per axis pair (4x4 for the cubic B-spline), so a
// stage reads 40 of the 160 bilinear values (160 of 360 bspline, 160 of 640
// bicubic), and the four stages of one packet mostly reuse the same taps
// from L1. One thread integrates one packet through all four stages in
// registers; only the 4 updated components are written back.
//
// The sampler and the right-hand side are shared with ray_attempt.cu
// (ray_sample.cuh); offsets are 64-bit there.

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

template <int I>
__global__ void __launch_bounds__(256)
ray_step_kernel(const float* __restrict__ rows, const float* __restrict__ st,
                const float* __restrict__ scal, float* __restrict__ out, int64_t n, Consts c) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a0 = scal[0];
  const float h = scal[1];
  const float x = st[i], y = st[n + i], kk = st[2 * n + i], ll = st[3 * n + i];
  const float sgn = st[4 * n + i], bx = st[5 * n + i], by = st[6 * n + i];
  // patch base in physical coordinates; stage math runs patch-local
  const float shx = c.r.x0 + bx * c.r.dx;
  const float shy = c.r.y0 + by * c.r.dy;
  const float lx = x - shx, ly = y - shy;

  float k1[4], k2[4], k3[4], k4[4];
  const float hh = h * 0.5f;
  rhs<I>(rows, n, i, lx, ly, kk, ll, sgn, a0 + 0.0f, c.r, k1);
  rhs<I>(rows, n, i, lx + hh * k1[0], ly + hh * k1[1], kk + hh * k1[2], ll + hh * k1[3], sgn,
         a0 + c.c_half, c.r, k2);
  rhs<I>(rows, n, i, lx + hh * k2[0], ly + hh * k2[1], kk + hh * k2[2], ll + hh * k2[3], sgn,
         a0 + c.c_half, c.r, k3);
  rhs<I>(rows, n, i, lx + h * k3[0], ly + h * k3[1], kk + h * k3[2], ll + h * k3[3], sgn,
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

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success).
extern "C" int jrsw_ray_step(int interp, const float* rows_T, const float* st, const float* scal,
                             float* out, long long n, float x0, float y0, float dx, float dy,
                             float f2, float Cg2, float c_half, float c1, float b16, float b13,
                             void* stream) {
  if (n <= 0) return 0;
  const Consts c{{x0, y0, dx, dy, f2, Cg2}, c_half, c1, b16, b13};
  constexpr int kThreads = 256;
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
