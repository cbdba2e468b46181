// Gather probes (CUDA C++, sm_90a): element gathers and row gathers.
//
// Replaces the Pallas TPU gather probes (juliaraytracingsw_tpu's
// benchmarks/profiling/); their plain PyTorch versions are
// `gather_elems_torch` and `gather_rows_torch` in ops/probes.py.
//
// gather_elems, three address modes:
//   flat   out[i] = table[idx[i]]        prof_pallas_gather.py `k1` (:51),
//                                        `k2` (:86: row take + lane select)
//   axis 0 out[r, c] = table[idx[r, c], c]  prof_pallas2.py `kA` (:41),
//                                        prof_pallas3.py `kA` (:40)
//   axis 1 out[r, c] = table[r, idx[r, c]]  prof_pallas3.py `kA2` (:71)
// What bounds it: the probes' tables are 1 MB (4 MB for axis 1, read row by
// row) and stay in the 50 MB L2, so device memory sees the indices and the
// output once (8 MB for 1M elements, 2.5 us at 3.35 TB/s). The L2 bounds it
// first: each random 4-byte read is a request for a whole 32-byte sector,
// 33.5 MB for 1M elements, and 1M such reads from the 1 MB table take
// 0.0093-0.0099 ms on an H100 with no index or output stream at all (a
// launch of the same grid alone 0.0039-0.0043; PERF.md §6), whatever the
// reads a thread. Design: four neighbouring elements a
// thread, their indices in one 16-byte load, four independent table reads
// in flight, one 16-byte streaming store; element by element where idx is
// not 16-byte aligned and for the ragged tail. A table spread over the
// shared memory of a cluster of 8 blocks, read through distributed shared
// memory, took 0.023 ms against this form's 0.010 (the sweeps' `cluster`).
//
// gather_rows, 16-byte chunks of rows:
//   out[i, :] = table[rows[i], :]        prof_pallas2.py `kB` (:71), `kE` (:140)
//   the same rounded through bf16        prof_pallas2.py `kC` (:103, a one-hot
//                                        bf16 matmul, which rounds so)
//   bf16 rows, copied or upcast to f32   the row gather of the ray path
//                                        (prof_r5_dma_probe.py:61-79 times it
//                                        with XLA at 1M rows of 160)
// What bounds it: device memory. At 1M random rows of 160 f32 out of a
// 262,144-row table, the output (671 MB) and the table's rows (168 MB, each
// drawn about four times) dominate; the table is over three times the 50 MB
// L2 (the bf16 one 1.7 times), so a row's later draws hit the L2 only while
// the output stream has not evicted it. At rows of 16-32 bytes (the probes'
// permutes) the whole work fits the L2, and the L2's random-sector rate
// bounds it as it bounds gather_elems. Design:
//   - threads map onto the flat output, one 16-byte chunk each: thread t
//     moves chunk t mod chunks of rows t / chunks + k (active / chunks),
//     k = 0 .. U - 1, so every lane works at every width and neighbouring
//     threads load and store neighbouring chunks (a warp covers 32 rows of
//     16 bytes or 1.6 rows of 320);
//   - one pass: a thread a chunk for every U rows, U of them in flight
//     (their indices, then their chunks, then the stores), U by the row
//     width alone: 32 bytes of output a thread (two chunks of a copy, one
//     chunk upcast into two), one chunk for rows under 256 bytes. On the
//     H100 a grid the card holds at once, striding over the rows, and 4-8
//     rows in flight were 3-20% slower (the sweeps' `rows`, `geometry`);
//   - where one warp a row fits one wave of the card (32 n threads), the
//     warp a row this mapping replaced runs instead: every thread starts at
//     once, so a thread's instructions are the time, and a warp's row is a
//     shift where the chunk mapping divides. At kB's 8192 rows of 512 bytes
//     it was ~0.0003 ms of a 0.004 ms launch faster (`small`);
//   - the output goes out by streaming (evict-first) stores, so it does
//     not push out table rows still to be drawn again. Table loads keep the
//     default priority: an evict-last policy bought 0-3% more, but nothing
//     resets a line's priority after the kernel, so the table would crowd
//     the L2 for whatever runs next. No access-policy window is set on the
//     stream either (it too outlives the kernel). Hopper's TMA has no
//     gather, and one thread starts a bulk copy only every ~0.2 us (the row
//     ring's sweeps), so rows are not bulk-copied.
// An index outside the table traps the kernel (the launch's stream then
// reports an error), as PyTorch's own gathers assert on the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// a grid of at most 2^31 threads keeps the row gather's thread numbers in
// 32 bits (beyond it the threads stride over the rows)
constexpr long long kMaxRowBlocks = (1LL << 31) / kThreads;

enum ElemMode { kFlat = 0, kAxis0 = 1, kAxis1 = 2 };

__device__ __forceinline__ void check_index(long long j, long long bound) {
  if (j < 0 || j >= bound) __trap();
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// idx_bound: table elements (flat), rows (axis 0) or columns (axis 1).
// Thread t gathers elements [4 t, 4 t + 4): idx element i lies in row r,
// column c of idx's (.., cols) layout. `vec`: idx and out are 16-byte
// aligned, so a thread's four indices and outputs move as one 16-byte load
// and store; otherwise, and in the ragged tail, element by element.
template <int M>
__global__ void __launch_bounds__(kThreads)
gather_elems_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                    float* __restrict__ out, long long n, long long cols, long long tab_cols,
                    long long idx_bound, bool vec) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i0 >= n) return;
  const bool whole = vec && i0 + 4 <= n;
  int j[4];
  if (whole) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(idx + i0));
    j[0] = q.x, j[1] = q.y, j[2] = q.z, j[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) j[k] = i0 + k < n ? __ldcs(idx + i0 + k) : 0;
  }
  long long r = 0, c = 0;
  if (M != kFlat) {
    r = i0 / cols;
    c = i0 - r * cols;
  }
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = 0.0f;
    if (i0 + k < n) {
      check_index(j[k], idx_bound);
      const long long src = M == kFlat ? j[k] : M == kAxis0 ? j[k] * tab_cols + c
                                                            : r * tab_cols + j[k];
      v[k] = __ldg(table + src);
    }
    if (M != kFlat && ++c == cols) {
      c = 0;
      ++r;
    }
  }
  if (whole) {
    __stcs(reinterpret_cast<float4*>(out + i0), make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i0 + k < n) __stcs(out + i0 + k, v[k]);
}

template <int M>
int launch_elems(bool vec, const float* table, const int* idx, float* out, long long n,
                 long long cols, long long tab_cols, long long bound, cudaStream_t s) {
  gather_elems_kernel<M><<<unsigned(cdiv(n, 4 * kThreads)), kThreads, 0, s>>>(
      table, idx, out, n, cols, tab_cols, bound, vec);
  return int(cudaGetLastError());
}

enum RowKind { kF32 = 0, kF32RoundBf16 = 1, kBf16 = 2, kBf16ToF32 = 3 };

__device__ __forceinline__ uint32_t round_bf16(uint32_t bits) {
  return __float_as_uint(__bfloat162float(__float2bfloat16_rn(__uint_as_float(bits))));
}

template <bool kStream>
__device__ __forceinline__ void put(uint4* p, uint4 v) {
  if (kStream) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// input chunk g (8 bf16 or 4 f32) to its place in the output: as it is,
// its 4 f32 rounded through bf16, or its 8 bf16 upcast into two f32 chunks
// (bf16 element 2k is the low half of word k, 2k + 1 the high half); by
// streaming (evict-first) stores where kStream
template <int KIND, bool kStream>
__device__ __forceinline__ void store_chunk(uint4* out, long long g, uint4 v) {
  if (KIND == kBf16ToF32) {
    put<kStream>(out + 2 * g,
                 make_uint4(v.x << 16, v.x & 0xffff0000u, v.y << 16, v.y & 0xffff0000u));
    put<kStream>(out + 2 * g + 1,
                 make_uint4(v.z << 16, v.z & 0xffff0000u, v.w << 16, v.w & 0xffff0000u));
  } else if (KIND == kF32RoundBf16) {
    put<kStream>(out + g, make_uint4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                                     round_bf16(v.w)));
  } else {
    put<kStream>(out + g, v);
  }
}

// `chunks` 16-byte input chunks a row; `active` threads work, a multiple of
// chunks, so thread t keeps chunk c = t mod chunks and moves rows t / chunks
// + k step, k = 0 .. U - 1, step = active / chunks, U at a time
template <int KIND, int U>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ table, const int* __restrict__ rows,
                   uint4* __restrict__ out, long long n, int chunks, long long n_rows,
                   unsigned active) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= active) return;
  const unsigned r0 = t / unsigned(chunks), c = t - r0 * unsigned(chunks);
  const long long step = active / unsigned(chunks);
  for (long long r = r0; r < n; r += U * step) {
    long long src[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      src[k] = 0;
      if (r + k * step < n) {
        const long long j = __ldg(rows + r + k * step);
        check_index(j, n_rows);
        src[k] = j * chunks + c;
      }
    }
    uint4 v[U];
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (r + k * step < n) v[k] = __ldg(table + src[k]);
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (r + k * step < n) store_chunk<KIND, true>(out, (r + k * step) * chunks + c, v[k]);
  }
}

// one warp a row, its lanes over the row's chunks
template <int KIND>
__global__ void __launch_bounds__(kThreads)
gather_rows_warp_kernel(const uint4* __restrict__ table, const int* __restrict__ rows,
                        uint4* __restrict__ out, long long n, int chunks, long long n_rows) {
  const long long r = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (r >= n) return;
  const long long j = rows[r];
  check_index(j, n_rows);
  for (int c = threadIdx.x & 31; c < chunks; c += 32)
    store_chunk<KIND, false>(out, r * chunks + c, __ldg(table + j * chunks + c));
}

// threads the card holds at once (0 where the device cannot be asked)
long long wave_threads() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev) !=
          cudaSuccess)
    return 0;
  return (long long)sms * per_sm;
}

// One warp a row where that grid fits one wave of the card (every thread
// starts at once, and the warp's row number is a shift, no divide);
// otherwise one pass of the chunk mapping, a thread a chunk for every U rows
// (at least one a chunk of a row): 32 bytes of output a thread (two chunks
// of a copy, one upcast chunk), one chunk where a row is under 256 bytes.
template <int KIND>
int launch_rows(const uint4* table, const int* rows, uint4* out, long long n, int chunks,
                long long n_rows, cudaStream_t s) {
  if (32 * n <= wave_threads()) {
    gather_rows_warp_kernel<KIND><<<unsigned(cdiv(32 * n, kThreads)), kThreads, 0, s>>>(
        table, rows, out, n, chunks, n_rows);
    return int(cudaGetLastError());
  }
  constexpr int kU = KIND == kBf16ToF32 ? 1 : 2;
  const int U = chunks < 16 ? 1 : kU;
  const long long blocks = std::max(std::min(cdiv(cdiv(n, U) * chunks, kThreads), kMaxRowBlocks),
                                    cdiv(chunks, kThreads));
  const long long threads = blocks * kThreads;
  const unsigned active = unsigned(threads - threads % chunks);
  if (U == 1) {
    gather_rows_kernel<KIND, 1><<<unsigned(blocks), kThreads, 0, s>>>(table, rows, out, n, chunks,
                                                                    n_rows, active);
  } else {
    gather_rows_kernel<KIND, kU><<<unsigned(blocks), kThreads, 0, s>>>(table, rows, out, n,
                                                                     chunks, n_rows, active);
  }
  return int(cudaGetLastError());
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
  const bool vec = reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  switch (mode) {
    case kFlat:
      return launch_elems<kFlat>(vec, table, idx, out, n, cols, tab_cols, tab_numel, s);
    case kAxis0:
      return launch_elems<kAxis0>(vec, table, idx, out, n, cols, tab_cols, tab_numel / tab_cols,
                                  s);
    case kAxis1:
      return launch_elems<kAxis1>(vec, table, idx, out, n, cols, tab_cols, tab_cols, s);
    default:
      return int(cudaErrorInvalidValue);
  }
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
  switch (kind) {
    case kF32:
    case kBf16:  // a copy of 16-byte chunks either way
      return launch_rows<kF32>(t, rows, o, n, chunks, n_rows, s);
    case kF32RoundBf16:
      return launch_rows<kF32RoundBf16>(t, rows, o, n, chunks, n_rows, s);
    case kBf16ToF32:
      return launch_rows<kBf16ToF32>(t, rows, o, n, chunks, n_rows, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
