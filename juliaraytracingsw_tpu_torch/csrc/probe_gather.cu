// Gather probes (CUDA C++, sm_90a): element gathers and row gathers.
//
// Replaces the Pallas TPU gather probes (juliaraytracingsw_tpu's
// benchmarks/profiling/); their plain PyTorch versions are
// `gather_elems_torch` and `gather_rows_torch` in ops/probes.py.
//
// gather_elems, one thread per output element, three address modes:
//   flat   out[i] = table[idx[i]]        prof_pallas_gather.py `k1` (:51),
//                                        `k2` (:86: row take + lane select)
//   axis 0 out[r, c] = table[idx[r, c], c]  prof_pallas2.py `kA` (:41),
//                                        prof_pallas3.py `kA` (:40)
//   axis 1 out[r, c] = table[r, idx[r, c]]  prof_pallas3.py `kA2` (:71)
// An index outside the table traps the kernel (the launch's stream then
// reports an error), as PyTorch's own gathers assert on the device.
//
// What bounds it: the tables are 1 MB and stay in the 50 MB L2, so device
// memory sees the indices and the output once (8 MB for 1M elements, 2.5 us
// at 3.35 TB/s). In practice the L2's sector rate bounds it: each 4-byte
// element costs a 32-byte sector read. Neighbouring threads read
// neighbouring indices and write neighbouring outputs, so those two streams
// are coalesced; only the table reads scatter.
//
// gather_rows, one warp per row, 16-byte loads and stores:
//   out[i, :] = table[rows[i], :]        prof_pallas2.py `kB` (:71), `kE` (:140)
//   the same rounded through bf16        prof_pallas2.py `kC` (:103, a one-hot
//                                        bf16 matmul, which rounds so)
//   bf16 rows, copied or upcast to f32   the row gather of the ray path
//                                        (prof_r5_dma_probe.py:61-79 times it
//                                        with XLA at 1M rows of 160)
// What bounds it: device memory. At 1M random rows of 160 f32 out of a
// 262,144-row table, the output (671 MB) and the table's rows (168 MB, each
// read about four times, mostly from L2) dominate. A warp moves a row as one
// run of 16-byte accesses, so each row costs whole 32-byte sectors and no
// lane waits on another's index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

enum ElemMode { kFlat = 0, kAxis0 = 1, kAxis1 = 2 };

__device__ __forceinline__ void check_index(long long j, long long bound) {
  if (j < 0 || j >= bound) __trap();
}

// idx_bound: table elements (flat), rows (axis 0) or columns (axis 1)
template <int M>
__global__ void __launch_bounds__(kThreads)
gather_elems_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                    float* __restrict__ out, long long n, long long cols, long long tab_cols,
                    long long idx_bound) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long j = idx[i];
  check_index(j, idx_bound);
  long long src;
  if (M == kFlat) {
    src = j;
  } else if (M == kAxis0) {
    src = j * tab_cols + i % cols;
  } else {
    src = (i / cols) * tab_cols + j;
  }
  out[i] = __ldg(table + src);
}

enum RowKind { kF32 = 0, kF32RoundBf16 = 1, kBf16 = 2, kBf16ToF32 = 3 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one warp per row; `chunks` 16-byte input chunks per row
template <int KIND>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ table, const int* __restrict__ rows,
                   uint4* __restrict__ out, long long n, int chunks, long long n_rows) {
  const int lane = threadIdx.x & 31;
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (r >= n) return;
  const long long row = rows[r];
  check_index(row, n_rows);
  const uint4* src = table + row * chunks;
  if (KIND == kBf16ToF32) {
    uint4* dst = out + r * chunks * 2;  // 8 bf16 in -> 8 f32 out
    for (int c = lane; c < chunks; c += 32) {
      const uint4 v = __ldg(src + c);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      float f[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f[2 * k] = __uint_as_float(w[k] << 16);            // low half: element 2k
        f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);  // high half: element 2k+1
      }
      dst[2 * c] = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                              __float_as_uint(f[2]), __float_as_uint(f[3]));
      dst[2 * c + 1] = make_uint4(__float_as_uint(f[4]), __float_as_uint(f[5]),
                                  __float_as_uint(f[6]), __float_as_uint(f[7]));
    }
    return;
  }
  uint4* dst = out + r * chunks;
  for (int c = lane; c < chunks; c += 32) {
    uint4 v = __ldg(src + c);
    if (KIND == kF32RoundBf16) {
      v = make_uint4(__float_as_uint(round_bf16(__uint_as_float(v.x))),
                     __float_as_uint(round_bf16(__uint_as_float(v.y))),
                     __float_as_uint(round_bf16(__uint_as_float(v.z))),
                     __float_as_uint(round_bf16(__uint_as_float(v.w))));
    }
    dst[c] = v;
  }
}

unsigned blocks_for(long long threads) {
  return unsigned((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on success).

// n output elements; cols = idx's last dimension; tab_cols = table's;
// tab_numel = table's elements
extern "C" int jrsw_gather_elems(int mode, const float* table, const int* idx, float* out,
                                 long long n, long long cols, long long tab_cols,
                                 long long tab_numel, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bound = mode == kFlat ? tab_numel : mode == kAxis0 ? tab_numel / tab_cols
                                                                     : tab_cols;
  switch (mode) {
    case kFlat:
      gather_elems_kernel<kFlat><<<blocks_for(n), kThreads, 0, s>>>(table, idx, out, n, cols,
                                                                    tab_cols, bound);
      break;
    case kAxis0:
      gather_elems_kernel<kAxis0><<<blocks_for(n), kThreads, 0, s>>>(table, idx, out, n, cols,
                                                                     tab_cols, bound);
      break;
    case kAxis1:
      gather_elems_kernel<kAxis1><<<blocks_for(n), kThreads, 0, s>>>(table, idx, out, n, cols,
                                                                     tab_cols, bound);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// n rows of `row_bytes` input bytes each (a multiple of 16) from a table of
// n_rows rows; table and out 16-byte aligned
extern "C" int jrsw_gather_rows(int kind, const void* table, const int* rows, void* out,
                                long long n, int row_bytes, long long n_rows, void* stream) {
  if (n <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 16 != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const uint4*>(table);
  auto* o = static_cast<uint4*>(out);
  const int chunks = row_bytes / 16;
  const unsigned blocks = blocks_for(n * 32);
  switch (kind) {
    case kF32:
    case kBf16:  // a copy of 16-byte chunks either way
      gather_rows_kernel<kF32><<<blocks, kThreads, 0, s>>>(t, rows, o, n, chunks, n_rows);
      break;
    case kF32RoundBf16:
      gather_rows_kernel<kF32RoundBf16><<<blocks, kThreads, 0, s>>>(t, rows, o, n, chunks,
                                                                    n_rows);
      break;
    case kBf16ToF32:
      gather_rows_kernel<kBf16ToF32><<<blocks, kThreads, 0, s>>>(t, rows, o, n, chunks,
                                                                 n_rows);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
