// The (old|new) pair table of two field stacks (CUDA C++, sm_90a).
//
// Replaces the reference's `build_pair_table_direct`
// (juliaraytracingsw_tpu/rays/patch.py:91, one patch-extraction
// convolution) and `build_pair`'s roll path (juliaraytracingsw_tpu/rays/
// raytrace.py:198: `build_patch_table` of each stack, then
// `make_pair_table`). Its plain PyTorch twin is that roll path,
// `ops/pair_table.pair_table_torch`; the kernel is bit-equal to it: a table
// value is a copy of a field value, rounded once to the table's dtype, and
// rounding before the copy equals rounding after it.
//
// Contract:
//   fields_old, fields_new (NCH, ny, nx) f32, contiguous;
//   out (ny*nx, 2W) f32 or bf16 (round to nearest even), W = NCH*PH*PW:
//   row c = iy*nx + ix holds [old | new], each half
//   fields[f, (iy+dy-LO) mod ny, (ix+dx-LO) mod nx] in (f, dy, dx) order,
//   for the three shapes of ray_sample.cuh (4x4 of 5 fields bilinear, 6x6
//   of 5 bspline, 4x4 of 20 bicubic).
//
// What bounds it on the H100: the store. It reads both stacks once
// (2 x 5 x 512^2 x 4 B = 10.5 MB at the hero's size, in L2 right after the
// inverse transforms that made them) and writes the table once (512^2 x
// 160 x 2 B = 83.9 MB bf16): 94.4 MB, 28.2 us at 3.35 TB/s. Every field
// value lands in PH*PW rows of each level, so the roll path moved each
// through device memory many times (16 rolls, a stack, a permute, a
// concat and a cast: 0.668 ms a hero step). Here a block takes a tile of
// kTY x kTX cells, stages the tile's periodic halo of both stacks in
// shared memory once, already in the table's dtype, with coalesced loads,
// and then writes the tile's rows, which lie contiguous along ix: thread
// (cc, j) stores the 16-byte chunk cc of the rows of cells j, j + kCells,
// ..., so neighbouring threads store neighbouring chunks and a warp's 32
// stores cover 512 contiguous bytes. Each thread's chunk has the same offsets
// into the halo for every cell it writes, computed once. Bicubic's 40
// planes fit the 48 KB of static shared memory at kTY = 4.
//
// Offsets into device memory are 64-bit: at 2048^2 a bicubic float32
// table is 10.7 GB.

#include <cuda_runtime.h>

#include <cstdint>

#include "ray_sample.cuh"

namespace {

using namespace jrsw;

// One f32 value in the table's storage: f32 as is, bf16 as its 16 bits,
// rounded to nearest even (the instruction PyTorch's CUDA cast runs).
template <typename T>
__device__ __forceinline__ T to_table(float v);
template <>
__device__ __forceinline__ float to_table<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ uint16_t to_table<uint16_t>(float v) {
  uint16_t r;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(r) : "f"(v));
  return r;
}

__host__ __device__ constexpr int floor_pow2(int v) {
  int p = 1;
  while (2 * p <= v) p *= 2;
  return p;
}

template <int I, typename T>
struct PairTile {
  using S = Shape<I>;
  static constexpr int kTX = 32, kTY = 4;                     // cells of a tile
  static constexpr int kPlanes = 2 * S::NCH;                  // (level, field)
  static constexpr int kRows = kTY + S::PH - 1;               // halo rows
  static constexpr int kCols = kTX + S::PW - 1;               // halo columns
  static constexpr int kPlane = kRows * kCols;
  static constexpr int kHalo = kPlanes * kPlane;              // staged values
  static constexpr int kPerChunk = 16 / int(sizeof(T));       // values in 16 bytes
  static constexpr int kChunks = pair_width<I>() / kPerChunk; // 16-byte chunks in a row
  static constexpr int kCells = floor_pow2(512 / kChunks);    // cells a pass
  static constexpr int kThreads = kChunks * kCells;
  static_assert(pair_width<I>() % kPerChunk == 0, "rows must be whole 16-byte chunks");
  static_assert(kTX % kCells == 0, "a pass stays in one row of the tile");
  static_assert(kHalo * int(sizeof(T)) <= 48 * 1024, "the halo fits static shared memory");
};

template <int I, typename T>
__global__ void __launch_bounds__(PairTile<I, T>::kThreads)
pair_table_kernel(const float* __restrict__ fields_old, const float* __restrict__ fields_new,
                  T* __restrict__ out, int ny, int nx) {
  using S = Shape<I>;
  using G = PairTile<I, T>;
  __shared__ T halo[G::kHalo];
  const int ix0 = blockIdx.x * G::kTX, iy0 = blockIdx.y * G::kTY;
  const int64_t field = int64_t(ny) * nx;

  // the halo of both stacks, plane by plane, row by row: neighbouring
  // threads load neighbouring columns
  for (int idx = threadIdx.y * G::kChunks + threadIdx.x; idx < G::kHalo; idx += G::kThreads) {
    const int p = idx / G::kPlane;
    const int rc = idx - p * G::kPlane;
    const int r = rc / G::kCols, c = rc - r * G::kCols;
    const float* src = p < S::NCH ? fields_old + p * field : fields_new + (p - S::NCH) * field;
    const int gy = wrap_cell(iy0 - S::LO + r, ny), gx = wrap_cell(ix0 - S::LO + c, nx);
    halo[idx] = to_table<T>(__ldg(src + int64_t(gy) * nx + gx));
  }
  __syncthreads();

  // this thread's chunk: value e of a row is plane e / (PH PW), tap
  // (dy, dx) of it, at the same halo offset from every cell's corner
  const int cc = threadIdx.x;
  int off[G::kPerChunk];
#pragma unroll
  for (int k = 0; k < G::kPerChunk; ++k) {
    const int e = cc * G::kPerChunk + k;
    const int p = e / (S::PH * S::PW);
    const int t = e - p * (S::PH * S::PW);
    const int dy = t / S::PW, dx = t - dy * S::PW;
    off[k] = p * G::kPlane + dy * G::kCols + dx;
  }
  uint4* out4 = reinterpret_cast<uint4*>(out);
#pragma unroll 1
  for (int cell = threadIdx.y; cell < G::kTY * G::kTX; cell += G::kCells) {
    const int ty = cell / G::kTX, tx = cell - ty * G::kTX;
    const int iy = iy0 + ty, ix = ix0 + tx;
    if (iy >= ny || ix >= nx) continue;
    const T* h = halo + ty * G::kCols + tx;
    uint32_t w[4];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = __float_as_uint(h[off[k]]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = uint32_t(h[off[2 * k]]) | (uint32_t(h[off[2 * k + 1]]) << 16);
      }
    }
    out4[(int64_t(iy) * nx + ix) * G::kChunks + cc] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int I, typename T>
int launch(const float* fo, const float* fn, void* out, int ny, int nx, cudaStream_t s) {
  using G = PairTile<I, T>;
  const dim3 grid((nx + G::kTX - 1) / G::kTX, (ny + G::kTY - 1) / G::kTY);
  pair_table_kernel<I, T><<<grid, dim3(G::kChunks, G::kCells), 0, s>>>(
      fo, fn, static_cast<T*>(out), ny, nx);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(int interp, const float* fo, const float* fn, void* out, int ny, int nx,
             cudaStream_t s) {
  switch (interp) {
    case kBilinear:
      return launch<kBilinear, T>(fo, fn, out, ny, nx, s);
    case kBspline:
      return launch<kBspline, T>(fo, fn, out, ny, nx, s);
    case kBicubic:
      return launch<kBicubic, T>(fo, fn, out, ny, nx, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success).
// fields_old, fields_new (NCH, ny, nx) f32; out (ny*nx, 2W) of dtype
// `table_dtype` (0 f32, 1 bf16), 16-byte aligned.
extern "C" int jrsw_pair_table(int interp, int table_dtype, const float* fields_old,
                               const float* fields_new, void* out, int ny, int nx,
                               void* stream) {
  if (ny <= 0 || nx <= 0) return 0;
  if (ny > 65535 * PairTile<kBilinear, float>::kTY) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_dtype) {
    case kTableF32:
      return dispatch<float>(interp, fields_old, fields_new, out, ny, nx, s);
    case kTableBf16:
      return dispatch<uint16_t>(interp, fields_old, fields_new, out, ny, nx, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
