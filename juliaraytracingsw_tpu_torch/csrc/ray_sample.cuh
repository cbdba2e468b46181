// Per-packet patch sampler and WKB right-hand side shared by the ray
// kernels (ray_step.cu, ray_attempt.cu).
//
// The counterpart of `_make_sample` and the `rhs` closures in
// juliaraytracingsw_tpu/ops/pallas_ray_step.py:124-189, and of their plain
// twins in ops/ray_step.py. One thread samples one packet: rows_T is the
// gathered (old|new) patch rows, tap-major (2W, N), so tap t of
// neighbouring packets sits at neighbouring addresses and every tap load is
// coalesced. Only the taps whose weights are not zero are read: a 2x2
// window per axis pair (4x4 for the cubic B-spline, 2x2 per Hermite block).
//
// Offsets are 64-bit: bicubic at 4M packets has 640 * 4M > 2^31 elements.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace jrsw {

enum Interp { kBilinear = 0, kBspline = 1, kBicubic = 2 };

template <int I> struct Shape;
template <> struct Shape<kBilinear> { static constexpr int PH = 4, PW = 4, LO = 1, NCH = 5; };
template <> struct Shape<kBspline> { static constexpr int PH = 6, PW = 6, LO = 2, NCH = 5; };
template <> struct Shape<kBicubic> { static constexpr int PH = 4, PW = 4, LO = 1, NCH = 20; };

struct RayConsts {
  float x0, y0;   // grid origin
  float dx, dy;   // cell size
  float f2, Cg2;  // f*f and Cg*Cg, each rounded once from double
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
                                       float qx, float qy, float a, const RayConsts& c,
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
                                    const RayConsts& c, float d[4]) {
  float v[5];
  sample<I>(rows, n, i, qx, qy, a, c, v);
  const float om = sgn * sqrtf(c.f2 + c.Cg2 * (qk * qk + ql * ql));
  const float cg = c.Cg2 / om;
  d[0] = v[0] + cg * qk;
  d[1] = v[1] + cg * ql;
  d[2] = -(v[2] * qk + v[4] * ql);
  d[3] = -(v[3] * qk - v[2] * ql);
}

}  // namespace jrsw
