// Per-row asynchronous copy rings spread over the whole card (CUDA C++,
// sm_90a).
//
// Replaces the Pallas TPU per-row DMA probes (juliaraytracingsw_tpu's
// benchmarks/profiling/):
//   prof_r5_dma_probe.py `row_dma_kernel` / `make_row_dma` (pallas_call :133)
//   prof_r5_dma2.py `kern_a` / `make_a` (:78)     Q consecutive rows a copy
//   prof_r5_dma2.py `kern_b` / `make_b` (:146)    indices staged per block
//   prof_r5_dma_bisect2.py `make_case` / `kern` (:67)
// Its plain PyTorch version is `row_ring_torch` in ops/probes.py.
//
// The function: probe block b (b < n_blocks) starts n_dma = rows_per_blk / Q
// copies; copy (b, i) moves the Q rows of the table starting at row r(b, i)
// to out[b, i Q .. i Q + Q - 1], a row gather in issue order. r(b, i) is
// either
//   idx[b * rows_per_blk + i]                   (kern_b, Q = 1), or
//   ((b * rows_per_blk + i) * stride + offset) mod m
// in int32 arithmetic that wraps (two's complement, as XLA's int32 product
// does from b * rows_per_blk + i = 53,021 on at stride 40503), then a floor
// modulo (jnp.remainder); m = R or R - Q, which need not be a power of two.
// The Pallas probe keeps only a ring of 2K slots, slot s ending with the
// last copy i with i mod 2K = s, and its grid runs in order, so its output
// is the last block's ring; that ring is a selection of out[b].
//
// Design. No copy depends on another, and the TPU ran the probe's blocks one
// after another on one core, so the split into n_blocks shapes the output
// and the row walk, not who issues the copies. The copies c = b n_dma + i
// are cut into contiguous chunks, one per ring, on the host
// (ops/probes.ring_plan: `chunk` copies a ring, the last ring takes the
// rest); a ring is one issuing thread (lane 0 of a warp) with K + 1 slots
// in shared memory and K copies in flight, and a block holds several rings,
// one per warp, one block per SM. Each ring's thread:
//   - stages its chunk of idx with one bulk copy (the chunk starts at a
//     multiple of 4 indices, so at a 16-byte boundary), as kern_b stages a
//     block's indices into SMEM;
//   - starts copy t, device memory -> slot t mod (K + 1), by one 1-D bulk
//     copy (TMA) on that slot's mbarrier;
//   - waits for copy j, writes the slot back to out by one bulk store
//     (shared -> device memory, in its own bulk group), and refills the slot
//     the store before it read (wait_group.read 1) with copy j + K.
// The rows never pass through registers, and nothing waits for a store's
// writes to land, only for its reads of the slot, before the slot is
// reused.
//
// No proxy fence: a slot is written by the bulk load and read by the bulk
// store, both in the async proxy, and no generic load or store ever touches
// it. The load's writes are ordered before the store by the mbarrier's
// complete_tx, which the issuing thread observes before it starts the store;
// the store's reads are ordered before the refill by wait_group.read. A
// fence.proxy.async orders generic-proxy accesses against async-proxy ones,
// and there are none on a slot. (The staged indices are written by the
// async proxy and read by generic loads after the mbarrier wait, the
// ordinary TMA-load pattern, which needs none either.)
//
// Measured on an H100 80GB HBM3 at 700 W (scripts/torch_probe_sweeps.py,
// which builds its variants of this ring itself): one ring starts a copy
// every ~0.20 us whatever K >= 4 (the copies alone; ~0.24 us with the bulk
// store), so an SM's rings add up until device memory binds; 16 rings an
// SM, one per warp, run 131,072 rows of 160 f32 in ~0.065 ms.
//
// What bounds it: the rate at which one thread starts bulk copies and
// stores, so the rings an SM holds; with 16 an SM, device memory (each row
// read once and written once at 3.35 TB/s).

#include <cuda_runtime.h>

#include <cstdint>

#include "probe_async.cuh"

namespace {

using namespace jrsw_probe;

struct RingArgs {
  int rows_per_blk;     // table rows per probe block (n_dma * Q)
  int n_dma;            // copies per probe block
  int n_copies;         // n_blocks * n_dma
  int K;                // copies in flight per ring
  int Q;                // rows per copy
  int row_bytes;        // bytes per table row (a multiple of 16)
  uint32_t stride;      // synthetic index stride ...
  uint32_t offset;      // ... and offset, in wrapping int32 arithmetic
  int32_t modulus;      // ... floor modulo (below 2^31)
  long long n_rows;     // table rows (an index outside traps the kernel)
  int n_rings;          // rings launched
  int chunk;            // copies per ring (the last ring: what is left)
  int ring_bytes;       // shared memory per ring, as the host sizes it
};

constexpr int kMaxK = 64;
constexpr int kSmemLimit = 232448;   // bytes of shared memory a block may have

// a ring's shared memory, in this order from its start: K + 1 slots of
// copy_bytes, K + 1 slot mbarriers and the index mbarrier, then its chunk
// of indices at a 16-byte boundary. The host sizes a ring
// (ops/probes.ring_bytes), a multiple of 128 bytes, so every ring of a
// block starts 128-byte aligned; the entry point checks that it covers this
__host__ __device__ __forceinline__ int idx_offset(int K, int copy_bytes) {
  return ((K + 1) * copy_bytes + 8 * (K + 2) + 15) / 16 * 16;
}

__global__ void __launch_bounds__(1024)
row_ring_kernel(const unsigned char* __restrict__ table, const int* __restrict__ idx,
                unsigned char* __restrict__ out, RingArgs c) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x % 32 != 0) return;
  const int local = threadIdx.x / 32;                          // ring in this block
  const int ring = blockIdx.x * (blockDim.x / 32) + local;
  if (ring >= c.n_rings) return;

  const int K = c.K, S = K + 1;
  const uint32_t copy_bytes = uint32_t(c.Q) * c.row_bytes;
  unsigned char* slots = smem + local * c.ring_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + S * copy_bytes);
  uint64_t* idx_bar = bars + S;
  int* idx_s = reinterpret_cast<int*>(slots + idx_offset(K, copy_bytes));
  const int c0 = ring * c.chunk;
  const int n = min(c.chunk, c.n_copies - c0);

  for (int k = 0; k <= S; ++k) mbar_init(&bars[k]);
  mbar_init_fence();
  if (idx) {
    mbar_expect_tx(idx_bar, uint32_t(n) * 4);
    bulk_load(idx_s, idx + c0, uint32_t(n) * 4, idx_bar);
    mbar_wait(idx_bar, 0);
  }

  // the row walk of the copies to start, in 32-bit arithmetic: the first
  // (b, i) by one division, then i + 1 and a jump over the block's unused
  // walk (rows_per_blk - n_dma, for Q > 1) where i reaches n_dma
  int i = c0 % c.n_dma;
  uint32_t u = (uint32_t(c0 / c.n_dma) * uint32_t(c.rows_per_blk) + uint32_t(i)) * c.stride +
               c.offset;                                          // wraps mod 2^32
  const uint32_t jump = uint32_t(c.rows_per_blk - c.n_dma) * c.stride;
  int t = 0;                                                       // next copy to start
  auto start = [&](int slot) {
    int row;
    if (idx) {
      row = idx_s[t];
    } else {
      const int32_t m = int32_t(u) % c.modulus;                   // truncates toward 0 ...
      row = m < 0 ? m + c.modulus : m;                            // ... so floor it
      u += c.stride;
      if (++i == c.n_dma) {
        i = 0;
        u += jump;
      }
    }
    if (row < 0 || row + (long long)c.Q > c.n_rows) __trap();
    ++t;
    mbar_expect_tx(&bars[slot], copy_bytes);
    bulk_load(slots + slot * copy_bytes, table + (long long)row * c.row_bytes, copy_bytes,
              &bars[slot]);
  };

  for (int s = 0; s < K && s < n; ++s) start(s);
  int slot = 0, fill = K;   // the slots of copies j and j + K (= that of j - 1)
  uint32_t phase = 0;       // the parity of copy j's use of its slot
  for (int j = 0; j < n; ++j) {
    mbar_wait(&bars[slot], phase);
    bulk_store(out + (long long)(c0 + j) * copy_bytes, slots + slot * copy_bytes, copy_bytes);
    bulk_commit();
    if (j + K < n) {
      bulk_wait_read<1>();   // the store of copy j - 1 has read `fill`
      start(fill);
    }
    if (++slot == S) {
      slot = 0;
      phase ^= 1;
    }
    if (++fill == S) fill = 0;
  }
  bulk_wait_all();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success). `idx`
// is NULL for synthetic indices (`modulus` is read only then). The rings
// (ops/probes.ring_plan): n_rings of `chunk` copies, `rings_per_block` a
// block (one a warp), each in `ring_bytes` of shared memory.
extern "C" int jrsw_row_ring(const void* table, long long n_rows, const int* idx, void* out,
                             int n_blocks, int rows_per_blk, int K, int Q, int row_bytes,
                             int stride, int offset, long long modulus, int n_rings, int chunk,
                             int rings_per_block, int ring_bytes, void* stream) {
  if (n_blocks < 1 || K < 1 || K > kMaxK || Q < 1 || rows_per_blk < Q || rows_per_blk % Q != 0 ||
      row_bytes % 16 != 0 || (!idx && (modulus <= 0 || modulus > INT32_MAX)) ||
      rings_per_block < 1 || rings_per_block > 32 || chunk < 1)
    return int(cudaErrorInvalidValue);
  const int n_dma = rows_per_blk / Q;
  const long long n_copies = (long long)n_blocks * n_dma;
  const long long copy_bytes = (long long)Q * row_bytes;
  // every copy in exactly one ring; staged index chunks on 16-byte boundaries
  if (n_copies > INT32_MAX || copy_bytes > kSmemLimit || n_rings < 1 ||
      (long long)(n_rings - 1) * chunk >= n_copies || (long long)n_rings * chunk < n_copies ||
      (idx && (Q != 1 || chunk % 4 != 0 || n_copies % 4 != 0)))
    return int(cudaErrorInvalidValue);
  // the host's ring covers the slots, the barriers and the indices
  const long long need = idx_offset(K, int(copy_bytes)) + (idx ? 4LL * chunk : 0);
  const long long smem = (long long)rings_per_block * ring_bytes;
  if (ring_bytes % 128 != 0 || ring_bytes < need || smem > kSmemLimit)
    return int(cudaErrorInvalidValue);
  const RingArgs c{rows_per_blk, n_dma,      int(n_copies), K,      Q,         row_bytes,
                   uint32_t(stride), uint32_t(offset), int32_t(modulus), n_rows, n_rings,
                   chunk,        ring_bytes};
  cudaError_t err = cudaFuncSetAttribute(row_ring_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  row_ring_kernel<<<(n_rings + rings_per_block - 1) / rings_per_block, rings_per_block * 32,
                    int(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(table), idx, static_cast<unsigned char*>(out), c);
  return int(cudaGetLastError());
}
