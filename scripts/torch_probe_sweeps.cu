// Variants of the per-row copy ring of juliaraytracingsw_tpu_torch/csrc/
// probe_row_ring.cu, and a chain of dependent bulk copies, for the sweeps of
// scripts/torch_probe_sweeps.py, which compiles this file on its own
// (sm_90a). Nothing of the package uses it.
//
// sweep_ring<kChain>: the ring over the probes' synthetic row walk with one
// row a copy: copy c moves row ((c stride + offset) mod m), in wrapping
// int32 arithmetic with a floor modulo, to out row c (rows out of range trap,
// as in the package's kernel). The copies are cut into `chunk` a ring, one
// issuing thread a ring with K copies in flight on K + 1 slots, `lanes`
// rings a warp (lanes 0 .. lanes - 1). kChain is what a ring does with a
// landed copy:
//   0  writes it back by a bulk store, as the package's kernel does;
//   1  nothing (the copies alone; out is not written);
//   2  nothing, with a proxy fence before each copy, as a ring whose warp
//      reads its slots out through registers needs.
//
// copy_chain: one thread starts n bulk copies of `bytes` from src, each
// waited before the next starts, stepping through `span` bytes: at n = 0 a
// launch alone, and from there one copy's latency from where src lies (L2,
// for a buffer the size of the staged copy probes' x).

#include <cuda_runtime.h>

#include <cstdint>

#include "probe_async.cuh"

namespace {

using namespace jrsw_probe;

struct SweepRing {
  int n_copies, K, row_bytes;
  uint32_t stride, offset;
  int32_t modulus;
  long long n_rows;
  int n_rings, chunk, lanes, ring_bytes;
};

constexpr int kSmemLimit = 232448;
constexpr int kChainBytes = 4096;

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int kChain>
__global__ void __launch_bounds__(1024)
sweep_ring_kernel(const unsigned char* __restrict__ table, unsigned char* __restrict__ out,
                  SweepRing c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  if (lane >= c.lanes) return;
  const int local = (threadIdx.x / 32) * c.lanes + lane;
  const int ring = blockIdx.x * (blockDim.x / 32) * c.lanes + local;
  if (ring >= c.n_rings) return;

  const int K = c.K, S = K + 1;
  const uint32_t bytes = uint32_t(c.row_bytes);
  unsigned char* slots = smem + local * c.ring_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + S * bytes);
  const int c0 = ring * c.chunk;
  const int n = min(c.chunk, c.n_copies - c0);
  for (int k = 0; k < S; ++k) mbar_init(&bars[k]);
  mbar_init_fence();

  uint32_t u = uint32_t(c0) * c.stride + c.offset;   // wraps mod 2^32
  auto start = [&](int slot) {
    const int32_t m = int32_t(u) % c.modulus;
    const int row = m < 0 ? m + c.modulus : m;
    u += c.stride;
    if (row < 0 || row + 1LL > c.n_rows) __trap();
    if (kChain == 2) fence_proxy_async();
    mbar_expect_tx(&bars[slot], bytes);
    bulk_load(slots + slot * bytes, table + (long long)row * c.row_bytes, bytes, &bars[slot]);
  };

  for (int s = 0; s < K && s < n; ++s) start(s);
  int slot = 0, fill = K;
  uint32_t phase = 0;
  for (int j = 0; j < n; ++j) {
    mbar_wait(&bars[slot], phase);
    if (kChain == 0) {
      bulk_store(out + (long long)(c0 + j) * bytes, slots + slot * bytes, bytes);
      bulk_commit();
    }
    if (j + K < n) {
      if (kChain == 0) bulk_wait_read<1>();
      start(fill);
    }
    if (++slot == S) {
      slot = 0;
      phase ^= 1;
    }
    if (++fill == S) fill = 0;
  }
  if (kChain == 0) bulk_wait_all();
}

__global__ void copy_chain_kernel(const unsigned char* __restrict__ src, int bytes, int n,
                                  long long span) {
  __shared__ __align__(128) unsigned char buf[kChainBytes];
  __shared__ uint64_t bar;
  if (threadIdx.x != 0) return;
  mbar_init(&bar);
  mbar_init_fence();
  for (int i = 0; i < n; ++i) {
    mbar_expect_tx(&bar, uint32_t(bytes));
    bulk_load(buf, src + (long long)i * bytes % span, uint32_t(bytes), &bar);
    mbar_wait(&bar, uint32_t(i & 1));
  }
}

template <int kChain>
cudaError_t launch_ring(const void* table, void* out, const SweepRing& c, int warps, int smem,
                        cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(sweep_ring_kernel<kChain>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int per_block = warps * c.lanes;
  sweep_ring_kernel<kChain><<<(c.n_rings + per_block - 1) / per_block, warps * 32, smem, s>>>(
      static_cast<const unsigned char*>(table), static_cast<unsigned char*>(out), c);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t. `ring_bytes`
// holds a ring's K + 1 slots of row_bytes and its K + 1 mbarriers.
extern "C" int sweep_ring(const void* table, long long n_rows, void* out, int n_copies, int K,
                          int row_bytes, int stride, int offset, int modulus, int n_rings,
                          int chunk, int warps, int lanes, int ring_bytes, int chain,
                          void* stream) {
  const long long smem = (long long)warps * lanes * ring_bytes;
  if (n_copies < 1 || K < 1 || row_bytes % 16 != 0 || modulus < 1 || n_rings < 1 ||
      chunk < 1 || (long long)(n_rings - 1) * chunk >= n_copies ||
      (long long)n_rings * chunk < n_copies || warps < 1 || warps > 32 || lanes < 1 ||
      lanes > 32 || ring_bytes % 128 != 0 || ring_bytes < (K + 1) * (row_bytes + 8) ||
      smem > kSmemLimit || chain < 0 || chain > 2)
    return int(cudaErrorInvalidValue);
  const SweepRing c{n_copies, K,       row_bytes, uint32_t(stride), uint32_t(offset),
                    modulus,  n_rows,  n_rings,   chunk,            lanes,
                    ring_bytes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chain) {
    case 0: return int(launch_ring<0>(table, out, c, warps, int(smem), s));
    case 1: return int(launch_ring<1>(table, out, c, warps, int(smem), s));
    default: return int(launch_ring<2>(table, out, c, warps, int(smem), s));
  }
}

extern "C" int sweep_copy_chain(const void* src, int bytes, int n, long long span,
                                void* stream) {
  if (bytes < 16 || bytes % 16 != 0 || bytes > kChainBytes || n < 0 || span < bytes ||
      span % bytes != 0)
    return int(cudaErrorInvalidValue);
  copy_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), bytes, n, span);
  return int(cudaGetLastError());
}
