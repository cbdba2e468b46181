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
// Offsets are 64-bit: bicubic at 4M packets has 640 * 4M > 2^31 elements.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Interp { kBilinear = 0, kBspline = 1, kBicubic = 2 };

template <int I> struct Shape;
template <> struct Shape<kBilinear> { static constexpr int PH = 4, PW = 4, LO = 1, NCH = 5; };
template <> struct Shape<kBspline> { static constexpr int PH = 6, PW = 6, LO = 2, NCH = 5; };
template <> struct Shape<kBicubic> { static constexpr int PH = 4, PW = 4, LO = 1, NCH = 20; };

struct Consts {
  float x0, y0;       // grid origin
  float dx, dy;       // cell size
  float f2, Cg2;      // f*f and Cg*Cg, each rounded once from double
  float c_half, c1;   // stage time offsets 0.5*da and 1.0*da
  float b16, b13;     // RK4 weights 1/6 and 1/3
};

// Non-zero bilinear weights along one axis: taps t, t+1 carry 1-a, a.
template <int SIZE, int LO>
__device__ __forceinline__ int axis_bilinear(float local, float w[2]) {
  const float j0 = fminf(fmaxf(floorf(local), float(-LO)), float(SIZE - LO - 2));
  const float a = local - j0;
  w[0] = 1.0f - a;
  w[1] = a;
  return int(j0) + LO;
}

// Non-zero cubic B-spline weights along one axis: taps base..base+3.
template <int SIZE, int LO>
__device__ __forceinline__ int axis_bspline(float local, float w[4]) {
  const float j0 = fminf(fmaxf(floorf(local), float(-(LO - 1))), float(SIZE - LO - 3));
  const float a = local - j0;
  const float a2 = a * a, a3 = a * a * a;
  w[0] = (1.0f - 3.0f * a + 3.0f * a2 - a3) / 6.0f;
  w[1] = (4.0f - 6.0f * a2 + 3.0f * a3) / 6.0f;
  w[2] = (1.0f + 3.0f * a + 3.0f * a2 - 3.0f * a3) / 6.0f;
  w[3] = a3 / 6.0f;
  return int(j0) + (LO - 1);
}

// Non-zero Hermite weights along one axis: value basis (h00, h01) and
// derivative basis (h10, h11) scaled by the cell size, on taps t, t+1.
template <int SIZE, int LO>
__device__ __forceinline__ int axis_hermite(float local, float scale, float wv[2], float wd[2]) {
  const float j0 = fminf(fmaxf(floorf(local), float(-LO)), float(SIZE - LO - 2));
  const float a = local - j0;
  const float a2 = a * a, a3 = a * a * a;
  wv[0] = 1.0f - 3.0f * a2 + 2.0f * a3;
  wv[1] = 3.0f * a2 - 2.0f * a3;
  wd[0] = (a - 2.0f * a2 + a3) * scale;
  wd[1] = (a3 - a2) * scale;
  return int(j0) + LO;
}

// Interpolate [u, v, ux, uy, vx] at local offset (qx, qy) from the packet's
// rows at both time levels and blend them at relative time a. Taps are
// visited jy-major, jx-minor, as the twin sums them.
template <int I>
__device__ __forceinline__ void sample(const float* __restrict__ rows, int64_t n, int64_t i,
                                       float qx, float qy, float a, const Consts& c,
                                       float val[5]) {
  using S = Shape<I>;
  constexpr int NPP = S::PH * S::PW;
  constexpr int W = S::NCH * NPP;
  const float* old_lvl = rows + i;
  const float* new_lvl = rows + int64_t(W) * n + i;
  if constexpr (I == kBicubic) {
    float wxv[2], wxd[2], wyv[2], wyd[2];
    const int tx = axis_hermite<S::PW, S::LO>(qx / c.dx, c.dx, wxv, wxd);
    const int ty = axis_hermite<S::PH, S::LO>(qy / c.dy, c.dy, wyv, wyd);
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) {
      float vo = 0.0f, vn = 0.0f;
      // channel blocks [f | fx | fy | fxy] take weights (wyv wxv),
      // (wyv wxd), (wyd wxv), (wyd wxd)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int jy = 0; jy < 2; ++jy) {
#pragma unroll
          for (int jx = 0; jx < 2; ++jx) {
            const float w = (b < 2 ? wyv[jy] : wyd[jy]) * (b % 2 == 0 ? wxv[jx] : wxd[jx]);
            const int64_t t = int64_t((b * 5 + ch) * NPP + (ty + jy) * S::PW + tx + jx) * n;
            vo += old_lvl[t] * w;
            vn += new_lvl[t] * w;
          }
        }
      }
      val[ch] = (1.0f - a) * vo + a * vn;
    }
  } else {
    constexpr int K = (I == kBspline) ? 4 : 2;
    float wx[K], wy[K];
    int tx, ty;
    if constexpr (I == kBspline) {
      tx = axis_bspline<S::PW, S::LO>(qx / c.dx, wx);
      ty = axis_bspline<S::PH, S::LO>(qy / c.dy, wy);
    } else {
      tx = axis_bilinear<S::PW, S::LO>(qx / c.dx, wx);
      ty = axis_bilinear<S::PH, S::LO>(qy / c.dy, wy);
    }
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) {
      float vo = 0.0f, vn = 0.0f;
#pragma unroll
      for (int jy = 0; jy < K; ++jy) {
#pragma unroll
        for (int jx = 0; jx < K; ++jx) {
          const float w = wy[jy] * wx[jx];
          const int64_t t = int64_t(ch * NPP + (ty + jy) * S::PW + tx + jx) * n;
          vo += old_lvl[t] * w;
          vn += new_lvl[t] * w;
        }
      }
      val[ch] = (1.0f - a) * vo + a * vn;
    }
  }
}

// WKB right-hand side at one stage: d(x, y, k, l)/dt.
template <int I>
__device__ __forceinline__ void rhs(const float* __restrict__ rows, int64_t n, int64_t i,
                                    float qx, float qy, float qk, float ql, float sgn, float a,
                                    const Consts& c, float d[4]) {
  float v[5];
  sample<I>(rows, n, i, qx, qy, a, c, v);
  const float om = sgn * sqrtf(c.f2 + c.Cg2 * (qk * qk + ql * ql));
  const float cg = c.Cg2 / om;
  d[0] = v[0] + cg * qk;
  d[1] = v[1] + cg * ql;
  d[2] = -(v[2] * qk + v[4] * ql);
  d[3] = -(v[3] * qk - v[2] * ql);
}

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
  const float shx = c.x0 + bx * c.dx;
  const float shy = c.y0 + by * c.dy;
  const float lx = x - shx, ly = y - shy;

  float k1[4], k2[4], k3[4], k4[4];
  const float hh = h * 0.5f;
  rhs<I>(rows, n, i, lx, ly, kk, ll, sgn, a0 + 0.0f, c, k1);
  rhs<I>(rows, n, i, lx + hh * k1[0], ly + hh * k1[1], kk + hh * k1[2], ll + hh * k1[3], sgn,
         a0 + c.c_half, c, k2);
  rhs<I>(rows, n, i, lx + hh * k2[0], ly + hh * k2[1], kk + hh * k2[2], ll + hh * k2[3], sgn,
         a0 + c.c_half, c, k3);
  rhs<I>(rows, n, i, lx + h * k3[0], ly + h * k3[1], kk + h * k3[2], ll + h * k3[3], sgn,
         a0 + c.c1, c, k4);

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
  const Consts c{x0, y0, dx, dy, f2, Cg2, c_half, c1, b16, b13};
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
