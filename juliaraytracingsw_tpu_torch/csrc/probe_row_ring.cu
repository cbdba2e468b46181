// Per-row asynchronous copy ring (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU per-row DMA probes (juliaraytracingsw_tpu's
// benchmarks/profiling/):
//   prof_r5_dma_probe.py `row_dma_kernel` / `make_row_dma` (pallas_call :133)
//   prof_r5_dma2.py `kern_a` / `make_a` (:78)     Q consecutive rows a copy
//   prof_r5_dma2.py `kern_b` / `make_b` (:146)    indices staged per block
//   prof_r5_dma_bisect2.py `make_case` / `kern` (:67)
// Its plain PyTorch version is `row_ring_torch` in ops/probes.py.
//
// The function: block b starts n_dma = rows_per_blk / Q copies; copy i moves
// the Q rows of the table starting at row r(b, i), and the block writes every
// copy's rows in issue order, out[b] of (rows_per_blk, W): a row gather.
// r(b, i) is either
//   idx[b * rows_per_blk + i]                   (kern_b, Q = 1), or
//   ((b * rows_per_blk + i) * stride + offset) mod m
// in int32 arithmetic that wraps (two's complement, as XLA's int32 product
// does from b * rows_per_blk + i = 53,021 on at stride 40503), then a floor
// modulo (jnp.remainder); m = R or R - Q, which need not be a power of two.
// The Pallas probe keeps only a ring of 2K slots, slot s ending with the
// last copy i with i mod 2K = s, and its grid runs in order, so its output
// is the last block's ring; that ring is a selection of out[b]. Writing
// every copy makes the whole timed work observable: a copy of a wrong row
// shows in the comparison with the plain version.
//
// Design: as the TPU's scalar core starts one DMA descriptor per row, one
// elected lane starts one 1-D bulk copy (TMA) per copy, device memory ->
// shared memory, on K mbarriers used round-robin, so K copies are in flight.
// The block is one warp: it waits for copy j, reads its slot out with 16-byte
// loads and stores the rows to out[b], and only then does the elected lane
// start copy j + K into that slot. Shared memory holds the K in-flight slots
// (a 2K ring of (K, Q) = (8, 32) rows of 640 B would be 320 KB, above the
// 227 KB a block may have). With indices from an array, the block first
// stages its rows_per_blk indices into shared memory with one bulk copy, as
// kern_b stages them into SMEM.
//
// What bounds it: the rate at which one lane per block starts copies, and
// the latency of each copy (K / latency copies per block and second), far
// below device memory's 3.35 TB/s. At the scripts' split (16 blocks on 132
// SMs) it gives a per-SM start rate; a split of 256 blocks fills the card
// with the same function.

#include <cuda_runtime.h>

#include <cstdint>

#include "probe_async.cuh"

namespace {

using namespace jrsw_probe;

struct RingArgs {
  int rows_per_blk;    // table rows per block (n_dma * Q)
  int K;               // copies in flight
  int Q;               // rows per copy
  int row_bytes;       // bytes per table row (a multiple of 16)
  uint32_t stride;     // synthetic index stride ...
  uint32_t offset;     // ... and offset, in wrapping int32 arithmetic
  int32_t modulus;     // ... floor modulo (below 2^31)
  long long n_rows;    // table rows (an index outside traps the kernel)
};

constexpr int kMaxK = 64;
constexpr int kBarrierBytes = 8 * (kMaxK + 1);          // K slot barriers + the index barrier
constexpr int kHeaderBytes = (kBarrierBytes + 127) / 128 * 128;

// in 32-bit arithmetic: one lane starts every copy of its block, so this
// chain is on the critical path, and the card emulates 64-bit division
__device__ __forceinline__ int32_t synthetic_row(const RingArgs& c, long long g) {
  const uint32_t u = uint32_t(g) * c.stride + c.offset;  // wraps mod 2^32
  const int32_t r = int32_t(u) % c.modulus;               // truncates toward 0 ...
  return r < 0 ? r + c.modulus : r;                       // ... so floor it
}

__global__ void __launch_bounds__(32)
row_ring_kernel(const unsigned char* __restrict__ table, const int* __restrict__ idx,
                unsigned char* __restrict__ out, RingArgs c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* idx_bar = bars + kMaxK;
  int* idx_s = reinterpret_cast<int*>(smem + kHeaderBytes);
  const int idx_bytes = idx ? (c.rows_per_blk * 4 + 127) / 128 * 128 : 0;
  unsigned char* slots = smem + kHeaderBytes + idx_bytes;

  const int K = c.K;
  const uint32_t copy_bytes = uint32_t(c.Q) * c.row_bytes;
  const int n_dma = c.rows_per_blk / c.Q;
  const long long base = (long long)blockIdx.x * c.rows_per_blk;
  unsigned char* dst = out + base * c.row_bytes;  // copy j lands at dst + j * copy_bytes

  if (lane == 0) {
    for (int k = 0; k < K; ++k) mbar_init(&bars[k]);
    mbar_init(idx_bar);
    mbar_init_fence();
    if (idx) {
      mbar_expect_tx(idx_bar, uint32_t(c.rows_per_blk) * 4);
      bulk_load(idx_s, idx + base, uint32_t(c.rows_per_blk) * 4, idx_bar);
      mbar_wait(idx_bar, 0);
    }
  }
  __syncwarp();

  // lane 0 starts copy i into slot i mod K
  auto start = [&](int i) {
    const long long r = idx ? idx_s[i] : synthetic_row(c, base + i);
    if (r < 0 || r + c.Q > c.n_rows) __trap();
    uint64_t* bar = &bars[i % K];
    fence_proxy_async();  // the warp's reads of this slot come before the copy's writes
    mbar_expect_tx(bar, copy_bytes);
    bulk_load(slots + (i % K) * copy_bytes, table + r * c.row_bytes, copy_bytes, bar);
  };

  if (lane == 0)
    for (int i = 0; i < K && i < n_dma; ++i) start(i);
  const int chunks = int(copy_bytes / 16);
  for (int j = 0; j < n_dma; ++j) {
    mbar_wait(&bars[j % K], uint32_t((j / K) & 1));
    const int4* src = reinterpret_cast<const int4*>(slots + (j % K) * copy_bytes);
    int4* d = reinterpret_cast<int4*>(dst + (long long)j * copy_bytes);
    for (int k = lane; k < chunks; k += 32) d[k] = src[k];
    __syncwarp();
    if (lane == 0 && j + K < n_dma) start(j + K);
  }
}

}  // namespace

extern "C" int jrsw_row_ring_smem_bytes(int rows_per_blk, int K, int Q, int row_bytes,
                                        int staged_idx) {
  const int idx_bytes = staged_idx ? (rows_per_blk * 4 + 127) / 128 * 128 : 0;
  return kHeaderBytes + idx_bytes + K * Q * row_bytes;
}

// Plain C entry point (loaded with ctypes). Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success). `idx`
// is NULL for synthetic indices.
extern "C" int jrsw_row_ring(const void* table, long long n_rows, const int* idx, void* out,
                             int n_blocks, int rows_per_blk, int K, int Q, int row_bytes,
                             int stride, int offset, long long modulus, void* stream) {
  if (n_blocks <= 0) return 0;
  if (K < 1 || K > kMaxK || Q < 1 || rows_per_blk % Q != 0 || rows_per_blk / Q < 2 * K ||
      row_bytes % 16 != 0 || modulus <= 0 || modulus > INT32_MAX ||
      (idx && (Q != 1 || rows_per_blk % 4 != 0)))
    return int(cudaErrorInvalidValue);
  const RingArgs c{rows_per_blk,     K, Q, row_bytes, uint32_t(stride),
                   uint32_t(offset), int32_t(modulus), n_rows};
  const int smem = jrsw_row_ring_smem_bytes(rows_per_blk, K, Q, row_bytes, idx != nullptr);
  cudaError_t err =
      cudaFuncSetAttribute(row_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_ring_kernel<<<n_blocks, 32, smem, s>>>(static_cast<const unsigned char*>(table), idx,
                                             static_cast<unsigned char*>(out), c);
  return int(cudaGetLastError());
}
