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
//
// The gathers of juliaraytracingsw_tpu_torch/csrc/probe_gather.cu:
//   l2_reads<U>: n random 4-byte reads from a table of 2^b floats (the read's
//     number hashed), U independent reads a thread and no index or output
//     stream: what the L2's sector rate alone allows an element gather from a
//     resident table (U = 0: the launch of the same grid, reading nothing);
//   cluster_gather: the flat element gather with the table spread over the
//     shared memory of a cluster of 8 blocks (1 MB: 128 KB a block), read
//     through distributed shared memory;
//   sweep_rows<U, kHint, kUpcast>: the package's row gather (16-byte chunks
//     over the flat output) with U rows in flight a thread, cache hints
//     kHint: 0 none, 1 streaming stores (the package's), 2 streaming index
//     loads, evict-last table loads and streaming stores, copying or upcasting
//     bf16 to f32, on a grid the card holds or on one thread a chunk for
//     every U rows (one pass, no loop);
//   warp_rows: the row gather one warp a row, its lanes over the row's
//     16-byte chunks (the package's form where that grid fits one wave).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "probe_async.cuh"

namespace {

namespace cg = cooperative_groups;
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

constexpr int kThreads = 256;

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

__device__ __forceinline__ void check_index(long long j, long long bound) {
  if (j < 0 || j >= bound) __trap();
}

// read i (of n) takes element (i 2654435761 mod 2^32) >> shift: the high
// bits of Knuth's multiplicative hash, so neighbouring lanes read unrelated
// sectors. A thread stores its sum only where it equals `never`, which no
// sum of the probes' tables does, so no read is optimised away.
template <int U>
__global__ void __launch_bounds__(kThreads)
l2_reads_kernel(const float* __restrict__ table, int shift, long long n, float never,
                float* sink) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * U;
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < U; ++k)
    if (i0 + k < n) sum += __ldg(table + ((unsigned(i0 + k) * 2654435761u) >> shift));
  if (sum == never) *sink = sum;
}

constexpr int kClusterBlocks = 8;
constexpr int kClusterThreads = 1024;

// out[i] = table[idx[i]], block b of each cluster holding table elements
// [b 2^s, (b + 1) 2^s) in shared memory; the cluster's threads take four
// neighbouring elements at a time, striding over the clusters
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kClusterThreads)
cluster_gather_kernel(const float* __restrict__ table, int s, const int* __restrict__ idx,
                      float* __restrict__ out, long long n) {
  extern __shared__ __align__(16) float slice[];
  cg::cluster_group cluster = cg::this_cluster();
  const int per = 1 << s;
  const unsigned rank = cluster.block_rank();
  const float4* src = reinterpret_cast<const float4*>(table + (long long)rank * per);
  for (int q = threadIdx.x; q < per / 4; q += kClusterThreads)
    reinterpret_cast<float4*>(slice)[q] = src[q];
  cluster.sync();
  const long long per_cluster = (long long)kClusterBlocks * kClusterThreads;
  const long long stride = (long long)(gridDim.x / kClusterBlocks) * per_cluster;
  const long long bound = (long long)kClusterBlocks * per;
  for (long long v = (blockIdx.x / kClusterBlocks) * per_cluster + rank * kClusterThreads +
                     threadIdx.x;
       4 * v < n; v += stride) {
    const long long i0 = 4 * v;
    int j[4];
    if (i0 + 4 <= n) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(idx + i0));
      j[0] = q.x, j[1] = q.y, j[2] = q.z, j[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) j[k] = i0 + k < n ? idx[i0 + k] : 0;
    }
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      check_index(j[k], bound);
      o[k] = *cluster.map_shared_rank(slice + (j[k] & (per - 1)), unsigned(j[k]) >> s);
    }
    if (i0 + 4 <= n) {
      __stcs(reinterpret_cast<float4*>(out + i0), make_float4(o[0], o[1], o[2], o[3]));
    } else {
      for (int k = 0; i0 + k < n; ++k) out[i0 + k] = o[k];
    }
  }
  cluster.sync();   // no block leaves while another still reads its slice
}

__device__ __forceinline__ uint4 load_row_chunk(const uint4* p, int hint) {
  if (hint < 2) return __ldg(p);
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

template <int U, int kHint, bool kUpcast>
__global__ void __launch_bounds__(kThreads)
sweep_rows_kernel(const uint4* __restrict__ table, const int* __restrict__ rows,
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
        const int* at = rows + r + k * step;
        const long long j = kHint == 2 ? __ldcs(at) : __ldg(at);
        check_index(j, n_rows);
        src[k] = j * chunks + c;
      }
    }
    uint4 v[U];
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (r + k * step < n) v[k] = load_row_chunk(table + src[k], kHint);
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (r + k * step >= n) continue;
      const long long g = (r + k * step) * chunks + c;
      if (kUpcast) {
        const uint4 w = v[k];
        const uint4 lo = make_uint4(w.x << 16, w.x & 0xffff0000u, w.y << 16, w.y & 0xffff0000u);
        const uint4 hi = make_uint4(w.z << 16, w.z & 0xffff0000u, w.w << 16, w.w & 0xffff0000u);
        if (kHint == 0) {
          out[2 * g] = lo, out[2 * g + 1] = hi;
        } else {
          __stcs(out + 2 * g, lo), __stcs(out + 2 * g + 1, hi);
        }
      } else if (kHint == 0) {
        out[g] = v[k];
      } else {
        __stcs(out + g, v[k]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
warp_rows_kernel(const uint4* __restrict__ table, const int* __restrict__ rows,
                 uint4* __restrict__ out, long long n, int chunks, long long n_rows) {
  const long long r = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (r >= n) return;
  const long long row = rows[r];
  check_index(row, n_rows);
  for (int c = threadIdx.x & 31; c < chunks; c += 32)
    out[r * chunks + c] = __ldg(table + row * chunks + c);
}

// `card`: as many blocks as the card holds (fewer where there is less
// work), striding over the rows; otherwise one chunk a thread for every U
// rows, one pass
template <int U, int kHint, bool kUpcast>
int launch_sweep_rows(bool card, const uint4* table, const int* rows, uint4* out, long long n,
                      int chunks, long long n_rows, cudaStream_t s) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep_rows_kernel<U, kHint, kUpcast>,
                                                kThreads, 0);
  const long long need = card ? cdiv(n * chunks, kThreads) : cdiv(cdiv(n, U) * chunks, kThreads);
  const long long blocks = std::max(card ? std::min((long long)sms * per_sm, need) : need,
                                    cdiv(chunks, kThreads));
  const long long threads = std::min(blocks * kThreads, 1LL << 31);
  sweep_rows_kernel<U, kHint, kUpcast><<<unsigned(blocks), kThreads, 0, s>>>(
      table, rows, out, n, chunks, n_rows, unsigned(threads - threads % chunks));
  return int(cudaGetLastError());
}

template <int U, bool kUpcast>
int sweep_rows_hint(int hint, bool card, const uint4* table, const int* rows, uint4* out,
                    long long n, int chunks, long long n_rows, cudaStream_t s) {
  switch (hint) {
    case 0: return launch_sweep_rows<U, 0, kUpcast>(card, table, rows, out, n, chunks, n_rows, s);
    case 1: return launch_sweep_rows<U, 1, kUpcast>(card, table, rows, out, n, chunks, n_rows, s);
    default:
      return launch_sweep_rows<U, 2, kUpcast>(card, table, rows, out, n, chunks, n_rows, s);
  }
}

template <int U>
int sweep_rows_u(bool upcast, int hint, bool card, const uint4* table, const int* rows,
                 uint4* out, long long n, int chunks, long long n_rows, cudaStream_t s) {
  return upcast ? sweep_rows_hint<U, true>(hint, card, table, rows, out, n, chunks, n_rows, s)
                : sweep_rows_hint<U, false>(hint, card, table, rows, out, n, chunks, n_rows, s);
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

// n reads, U = per_thread (0, 1, 4, 8 or 16) a thread, from a table of
// 2^log2 floats; `sink` one float the kernel writes only in the never case
extern "C" int sweep_l2_reads(const float* table, int log2, long long n, int per_thread,
                              float* sink, void* stream) {
  if (log2 < 1 || log2 > 31 || n < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = unsigned(cdiv(n, (long long)kThreads * std::max(per_thread, 1)));
  const int shift = 32 - log2;
  const float never = -1.2345e30f;
  switch (per_thread) {
    case 0: l2_reads_kernel<0><<<blocks, kThreads, 0, s>>>(table, shift, n, never, sink); break;
    case 1: l2_reads_kernel<1><<<blocks, kThreads, 0, s>>>(table, shift, n, never, sink); break;
    case 4: l2_reads_kernel<4><<<blocks, kThreads, 0, s>>>(table, shift, n, never, sink); break;
    case 8: l2_reads_kernel<8><<<blocks, kThreads, 0, s>>>(table, shift, n, never, sink); break;
    case 16: l2_reads_kernel<16><<<blocks, kThreads, 0, s>>>(table, shift, n, never, sink); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// clusters of 8 blocks the card runs at once with a table of 8 2^s floats
// in their shared memory (0 where none fits), or a negative cudaError_t
extern "C" int sweep_cluster_max(int s) {
  const int smem = 4 << s;
  cudaError_t err = cudaFuncSetAttribute(cluster_gather_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterBlocks);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, cluster_gather_kernel, &cfg);
  return err == cudaSuccess ? clusters : -int(err);
}

// the flat gather of n elements from a table of 8 2^s floats, on `clusters`
// clusters of 8 blocks; idx and out 16-byte aligned
extern "C" int sweep_cluster_gather(const float* table, int s, const int* idx, float* out,
                                    long long n, int clusters, void* stream) {
  if (s < 2 || (4 << s) > kSmemLimit || clusters < 1 || n < 1) return int(cudaErrorInvalidValue);
  const int smem = 4 << s;
  cudaError_t err = cudaFuncSetAttribute(cluster_gather_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  cluster_gather_kernel<<<clusters * kClusterBlocks, kClusterThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(table, s, idx, out, n);
  return int(cudaGetLastError());
}

// the row gather's variant: n rows of row_bytes input bytes (a multiple of
// 16), U = in_flight (1, 2, 4 or 8) rows a thread, L2 hints `hint` (0, 1,
// 2), bf16 upcast to f32 (`upcast`) or a copy, on a card-sized grid (`card`)
// or in one pass
extern "C" int sweep_rows(const void* table, const int* rows, void* out, long long n,
                          int row_bytes, long long n_rows, int in_flight, int hint, int upcast,
                          int card, void* stream) {
  if (n < 1 || row_bytes < 16 || row_bytes % 16 != 0 || hint < 0 || hint > 2)
    return int(cudaErrorInvalidValue);
  const auto* t = static_cast<const uint4*>(table);
  auto* o = static_cast<uint4*>(out);
  const int chunks = row_bytes / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_flight) {
    case 1: return sweep_rows_u<1>(upcast, hint, card, t, rows, o, n, chunks, n_rows, s);
    case 2: return sweep_rows_u<2>(upcast, hint, card, t, rows, o, n, chunks, n_rows, s);
    case 4: return sweep_rows_u<4>(upcast, hint, card, t, rows, o, n, chunks, n_rows, s);
    case 8: return sweep_rows_u<8>(upcast, hint, card, t, rows, o, n, chunks, n_rows, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// the row gather one warp a row: n rows of row_bytes (a multiple of 16)
extern "C" int sweep_warp_rows(const void* table, const int* rows, void* out, long long n,
                               int row_bytes, long long n_rows, void* stream) {
  if (n < 1 || row_bytes < 16 || row_bytes % 16 != 0) return int(cudaErrorInvalidValue);
  warp_rows_kernel<<<unsigned(cdiv(n * 32, kThreads)), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), rows, static_cast<uint4*>(out), n, row_bytes / 16,
      n_rows);
  return int(cudaGetLastError());
}
