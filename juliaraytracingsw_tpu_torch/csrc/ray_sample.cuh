// Per-packet patch sampler and WKB right-hand side shared by the ray
// kernels (ray_step.cu, ray_attempt.cu), and the staging of a warp's pair
// rows into shared memory for their table forms.
//
// The counterpart of `_make_sample` and the `rhs` closures in
// juliaraytracingsw_tpu/ops/pallas_ray_step.py:124-189, and of their plain
// twins in ops/ray_step.py. One thread samples one packet from a row
// source `Rows<T, Index>`: tap t of the packet's old row sits at
// old_lvl[t * stride], of its new row at new_lvl[t * stride]. Two sources
// instantiate the same stage math:
//
// - the first cut, rows_T (2W, N) f32 in device memory, tap-major: old_lvl
//   is rows_T + i, new_lvl rows_T + W N + i, the stride N, so tap t of
//   neighbouring packets sits at neighbouring addresses and every tap load
//   is coalesced;
// - the table form, a warp's 32 rows staged tap-major in shared memory in
//   the table's own dtype (f32 or bf16): old_lvl is tile + lane, new_lvl
//   W taps further, the stride kTileStride. A bf16 tap is widened when it
//   is read (a shift, exact).
//
// Only the taps whose weights are not zero are read: a 2x2 window per axis
// pair (4x4 for the cubic B-spline, 2x2 per Hermite block).
//
// Offsets into device memory are 64-bit: bicubic at 4M packets has
// 640 * 4M > 2^31 elements.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace jrsw {

enum Interp { kBilinear = 0, kBspline = 1, kBicubic = 2 };
enum TableDtype { kTableF32 = 0, kTableBf16 = 1 };

template <int I> struct Shape;
template <> struct Shape<kBilinear> { static constexpr int PH = 4, PW = 4, LO = 1, NCH = 5; };
template <> struct Shape<kBspline> { static constexpr int PH = 6, PW = 6, LO = 2, NCH = 5; };
template <> struct Shape<kBicubic> { static constexpr int PH = 4, PW = 4, LO = 1, NCH = 20; };

// values in one (old|new) pair row: 2W, W = channels * PH * PW
template <int I>
__host__ __device__ constexpr int pair_width() {
  return 2 * Shape<I>::NCH * Shape<I>::PH * Shape<I>::PW;
}

struct RayConsts {
  float x0, y0;   // grid origin
  float dx, dy;   // cell size
  float f2, Cg2;  // f*f and Cg*Cg, each rounded once from double
};

// A bf16 value is stored as its 16 bits; widening to f32 is exact.
struct bf16_bits {
  uint16_t bits;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16_bits v) {
  return __uint_as_float(uint32_t(v.bits) << 16);
}

// The row source: tap t of one packet's old and new rows, at one offset
// t * stride from each level's tap 0.
template <typename T, typename Index>
struct Rows {
  const T* old_lvl;
  const T* new_lvl;
  Index stride;
  __device__ __forceinline__ Index offset(int t) const { return Index(t) * stride; }
  __device__ __forceinline__ float old_at(Index off) const { return to_f32(old_lvl[off]); }
  __device__ __forceinline__ float new_at(Index off) const { return to_f32(new_lvl[off]); }
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
template <int I, class R>
__device__ __forceinline__ void sample(const R& rows, float qx, float qy, float a,
                                       const RayConsts& c, float val[5]) {
  using S = Shape<I>;
  constexpr int NPP = S::PH * S::PW;
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
            const auto t = rows.offset((b * 5 + ch) * NPP + (ty + jy) * S::PW + tx + jx);
            vo += rows.old_at(t) * w;
            vn += rows.new_at(t) * w;
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
          const auto t = rows.offset(ch * NPP + (ty + jy) * S::PW + tx + jx);
          vo += rows.old_at(t) * w;
          vn += rows.new_at(t) * w;
        }
      }
      val[ch] = (1.0f - a) * vo + a * vn;
    }
  }
}

// WKB right-hand side at one stage: d(x, y, k, l)/dt.
template <int I, class R>
__device__ __forceinline__ void rhs(const R& rows, float qx, float qy, float qk, float ql,
                                    float sgn, float a, const RayConsts& c, float d[4]) {
  float v[5];
  sample<I>(rows, qx, qy, a, c, v);
  const float om = sgn * sqrtf(c.f2 + c.Cg2 * (qk * qk + ql * ql));
  const float cg = c.Cg2 / om;
  d[0] = v[0] + cg * qk;
  d[1] = v[1] + cg * ql;
  d[2] = -(v[2] * qk + v[4] * ql);
  d[3] = -(v[3] * qk - v[2] * ql);
}

// --- the table form: a warp stages its packets' rows ------------------------
//
// The pair table T_pair (ny*nx, 2W) is row-major: packet j's row is 2W
// contiguous values at its base cell. A warp owns a tile of 32 packets,
// tap-major in shared memory: tap t of packet j at t * kTileStride + j.
// Reading one tap, the warp's 32 threads hit consecutive elements, free of
// bank conflicts.
//
// Staging: the warp's lanes take 4 rows x 8 consecutive 16-byte chunks at
// a time (lane = 8 r + c), so each quarter-warp reads one 128-byte run of a
// row. Each chunk holds E = 16 / sizeof(T) consecutive taps, scattered into
// E tap rows of the tile. The stride is padded to 33 (odd) so these
// scattered stores are free of bank conflicts too: for f32 lane (r, c)
// writes word 33 (4 c + e) + r = 4 c + r + const (mod 32), 32 distinct
// banks; for bf16 its word is 132 c + (33 e + r) / 2 = 4 c + [0, 2] + const,
// disjoint windows per c (lanes sharing a word do not conflict).
constexpr int kTileStride = 33;

template <int I, typename T>
struct TableTile {
  static constexpr int kWidth = pair_width<I>();                         // taps in a row
  static constexpr int kChunks = kWidth * int(sizeof(T)) / 16;           // uint4 per row
  static constexpr int kPerChunk = 16 / int(sizeof(T));                  // taps per uint4
  static constexpr int kWarpBytes = kWidth * kTileStride * int(sizeof(T));
  // warps per block: as many tiles as fit in 48 KB (at least one), so two
  // blocks or more fit on an SM's 227 KB
  static constexpr int kWarps = kWarpBytes * 4 <= 49152 ? 4
                                : kWarpBytes * 2 <= 49152 ? 2 : 1;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlockBytes = kWarps * kWarpBytes;
  static_assert(kWidth * int(sizeof(T)) % 16 == 0, "pair rows must be whole 16-byte chunks");
};

// The packet's pair-table row, as rays/raytrace._gather_patch_rows finds
// it: bx = floor((x - x0) / dx) in IEEE f32 (x0 and dx each rounded once
// to f32), likewise by; the cell index wraps with the sign of the divisor
// (Python's remainder). Positions are never wrapped.
__device__ __forceinline__ int wrap_cell(int b, int size) {
  const int r = b % size;
  return r < 0 ? r + size : r;
}

__device__ __forceinline__ int64_t table_row(float x, float y, const RayConsts& c, int ny,
                                             int nx, float* bx, float* by) {
  *bx = floorf(__fdiv_rn(__fsub_rn(x, c.x0), c.dx));
  *by = floorf(__fdiv_rn(__fsub_rn(y, c.y0), c.dy));
  return int64_t(wrap_cell(int(*by), ny)) * nx + wrap_cell(int(*bx), nx);
}

// Stage the rows of the warp's 32 packets into its tile. `row` is this
// lane's packet row, or -1 past the end of the batch (not read). Every lane
// of the warp calls this; the caller then syncs the warp.
template <int I, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ table, int64_t row, T* tile,
                                           int lane) {
  using G = TableTile<I, T>;
  const uint4* src4 = reinterpret_cast<const uint4*>(table);
  const int r = lane >> 3, cc = lane & 7;
#pragma unroll 1
  for (int q = 0; q < 8; ++q) {
    const int j = 4 * q + r;                     // the packet whose row this lane reads
    const int64_t rj = __shfl_sync(0xffffffffu, row, j);
    if (rj < 0) continue;
    const uint4* src = src4 + rj * G::kChunks;
    T* dst = tile + j;
#pragma unroll
    for (int c0 = 0; c0 < G::kChunks; c0 += 8) {
      const int c = c0 + cc;
      if (c < G::kChunks) {
        const uint4 v = __ldg(src + c);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        T* d = dst + c * G::kPerChunk * kTileStride;
        if constexpr (sizeof(T) == 4) {
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e * kTileStride] = __uint_as_float(w[e]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // low half: tap 2e, high half: tap 2e + 1
            d[(2 * e) * kTileStride] = T{uint16_t(w[e] & 0xffffu)};
            d[(2 * e + 1) * kTileStride] = T{uint16_t(w[e] >> 16)};
          }
        }
      }
    }
  }
}

// One-time kernel attributes of a table kernel: its dynamic shared memory
// and a carveout that gives shared memory the whole unified L1 (the rows
// are read once; nothing else is reused from L1). Returns the first error.
template <typename Kernel>
inline cudaError_t set_table_attributes(Kernel kernel, int bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

}  // namespace jrsw
