// Staged affine copy probe (CUDA C++, sm_90a): out = a * x[rows] + b.
//
// Replaces the Pallas TPU feature probes (juliaraytracingsw_tpu's
// benchmarks/profiling/):
//   prof_pallas_probe.py `trivial` (pallas_call at :48)     plain loads
//   prof_r5_dma_bisect.py `k0` (:51)                        plain loads
//   prof_r5_dma_bisect.py `k1` (:65)  one whole-buffer async copy
//   prof_r5_dma_bisect.py `k2` (:81)  the same on a barrier array
//   prof_r5_dma_bisect.py `k3` (:99)  copies at a runtime offset, serial
//   prof_r5_dma_bisect.py `k4` (:122) a loop of serial copies, each waited
//   prof_r5_dma_bisect.py `k5` (:158) a ring of 4 copies in flight
// Its plain PyTorch version is `staged_copy_torch` in ops/probes.py.
//
// The function: copy i (i = 0 .. n_copies-1) moves the q rows of x starting
// at (i * q) mod src_mod, an offset computed at run time, into ring slot
// i mod n_slots; the ring holds n_slots * q rows of W floats, each slot
// ending with the last copy into it, and out = a * ring + b, rounded after
// the product and after the sum (no FMA contraction), as PyTorch's
// x * a + b rounds.
//
// Each Mosaic feature has its Hopper counterpart: an async copy into VMEM
// becomes a 1-D bulk copy (TMA) into shared memory, a DMA semaphore an
// mbarrier, up to `in_flight` copies outstanding with the wait for copy i-K
// delayed until copy i starts. One elected thread starts them, as the TPU's
// scalar core does; the block then applies a * . + b from shared memory.
// The plain mode reads the surviving rows straight from device memory.
//
// What bounds it: nothing on this card at these sizes. A (256, 128) f32
// buffer is 128 KB each way, 0.08 us at 3.35 TB/s; the launch and the copy's
// latency (a few us) are the whole time. The staged mode needs the ring in
// shared memory (128 KB for k1, above the default 48 KB: the launch raises
// the limit; the (256, 256) of `trivial` does not fit, so it takes plain
// loads).

#include <cuda_runtime.h>

#include <cstdint>

#include "probe_async.cuh"

namespace {

using namespace jrsw_probe;

struct CopyArgs {
  int W;               // floats per row
  int q;               // rows per copy
  long long n_copies;  // copies started
  long long src_mod;   // copy i starts at row (i * q) mod src_mod
  int n_slots;         // ring slots of q rows
  int in_flight;       // copies outstanding (= mbarriers)
  float a, b;
};

constexpr int kThreads = 256;
constexpr int kMaxInFlight = 32;
constexpr int kBarrierBytes = 8 * kMaxInFlight;  // ring starts 128-byte aligned after them

__device__ __forceinline__ long long src_row(const CopyArgs& c, long long i) {
  return (i * c.q) % c.src_mod;
}

// the copy whose rows stay in ring slot s: the last i < n_copies with i mod n_slots = s
__device__ __forceinline__ long long last_copy(const CopyArgs& c, long long s) {
  return s + c.n_slots * ((c.n_copies - 1 - s) / c.n_slots);
}

__device__ __forceinline__ float affine(float v, float a, float b) {
  return __fadd_rn(__fmul_rn(a, v), b);
}

__global__ void __launch_bounds__(kThreads)
copy_plain_kernel(const float* __restrict__ x, float* __restrict__ out, CopyArgs c) {
  const long long n = (long long)c.n_slots * c.q * c.W;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long o = e / c.W, col = e % c.W;
    const long long row = src_row(c, last_copy(c, o / c.q)) + o % c.q;
    out[e] = affine(x[row * c.W + col], c.a, c.b);
  }
}

__global__ void __launch_bounds__(kThreads)
copy_staged_kernel(const float* __restrict__ x, float* __restrict__ out, CopyArgs c) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kBarrierBytes);
  const uint32_t copy_bytes = uint32_t(c.q) * c.W * sizeof(float);
  const int K = c.in_flight;

  if (threadIdx.x == 0) {
    for (int k = 0; k < K; ++k) mbar_init(&bars[k]);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (long long i = 0; i < c.n_copies; ++i) {
      if (i >= K) mbar_wait(&bars[(i - K) % K], uint32_t(((i - K) / K) & 1));
      uint64_t* bar = &bars[i % K];
      mbar_expect_tx(bar, copy_bytes);
      bulk_load(ring + (i % c.n_slots) * c.q * c.W, x + src_row(c, i) * c.W, copy_bytes, bar);
    }
    const long long first = c.n_copies > K ? c.n_copies - K : 0;
    for (long long j = first; j < c.n_copies; ++j) mbar_wait(&bars[j % K], uint32_t((j / K) & 1));
  }
  __syncthreads();
  // every thread observes each barrier's last phase (already complete), so
  // the bytes the async proxy wrote are visible to it
  for (int k = 0; k < K && k < c.n_copies; ++k) {
    const long long last = k + (long long)K * ((c.n_copies - 1 - k) / K);
    mbar_wait(&bars[k], uint32_t((last / K) & 1));
  }
  const long long n = (long long)c.n_slots * c.q * c.W;
  for (long long e = threadIdx.x; e < n; e += blockDim.x) out[e] = affine(ring[e], c.a, c.b);
}

}  // namespace

extern "C" int jrsw_probe_copy_smem_bytes(int W, int q, int n_slots) {
  return kBarrierBytes + n_slots * q * W * int(sizeof(float));
}

// Plain C entry point (loaded with ctypes). Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success).
extern "C" int jrsw_probe_copy(int staged, const float* x, float* out, int W, int q,
                               long long n_copies, long long src_mod,
                               int n_slots, int in_flight, float a, float b, void* stream) {
  const CopyArgs c{W, q, n_copies, src_mod, n_slots, in_flight, a, b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_copies <= 0 || in_flight < 1 || in_flight > kMaxInFlight)
    return int(cudaErrorInvalidValue);
  if (!staged) {
    const long long want = ((long long)n_slots * q * W + kThreads - 1) / kThreads;
    const unsigned blocks = unsigned(want < 1024 ? want : 1024);
    copy_plain_kernel<<<blocks, kThreads, 0, s>>>(x, out, c);
    return int(cudaGetLastError());
  }
  const int smem = jrsw_probe_copy_smem_bytes(W, q, n_slots);
  cudaError_t err =
      cudaFuncSetAttribute(copy_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  // one block: the TPU kernel runs on one core
  copy_staged_kernel<<<1, kThreads, smem, s>>>(x, out, c);
  return int(cudaGetLastError());
}
