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
// delayed until copy i starts. The TPU ran the probe on one core; here every
// copy is cut into n_slices contiguous slices of slice_bytes (a multiple of
// 16, the last one longer; ops/probes.copy_slices), and block s starts
// slice s of every copy, in the schedule's order, on its own mbarriers and
// into its own slices of the ring slots. A thread's chain of starting bulk
// copies costs ~0.20 us a copy on this card (scripts/torch_probe_sweeps.py),
// so where slot reuse allows it each mbarrier has its own starting thread
// (thread k starts copies k, k + in_flight, ...; else one thread starts
// all, as the TPU's scalar core). Every copy is still started, waited and
// overwritten as the schedule says, only in S pieces on S SMs at once and
// by up to in_flight threads of each. The block then writes
// a * . + b of its slices with 16-byte loads and stores. The plain mode
// reads the surviving rows straight from device memory, one block row per
// output row (its source row computed once, in 32-bit arithmetic) and
// 16-byte accesses where a row allows them.
//
// What bounds it: not the bytes (a (256, 128) f32 buffer is 128 KB each
// way, 0.08 us at 3.35 TB/s) but the launch and, in the staged mode, the
// chain of dependent copies: a copy waited before the next one starts adds
// its whole latency (k3, k4: 4 and 8 copies one at a time; k5: 16 copies 4
// in flight).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "probe_async.cuh"

namespace {

using namespace jrsw_probe;

struct CopyArgs {
  int W;            // floats per row
  int q;            // rows per copy
  int n_copies;     // copies started
  int src_mod;      // copy i starts at row (i * q) mod src_mod
  int n_slots;      // ring slots of q rows
  int in_flight;    // copies outstanding (= mbarriers)
  int issuers;      // threads starting copies: in_flight, or 1 (see the launch)
  int copy_bytes;   // q * W * 4
  int slice_bytes;  // bytes of a copy each block starts (the last block: the rest)
  int slot_bytes;   // a ring slot's slice in shared memory: the last, longest slice
  float a, b;
};

constexpr int kThreads = 128;      // staged mode: a 2 KB slice is 128 16-byte chunks
constexpr int kPlainThreads = 64;  // plain mode: (256, 128) f32 in 128 blocks
constexpr int kMaxInFlight = 32;
constexpr int kBarrierBytes = 8 * kMaxInFlight;  // the slices start 128-byte aligned after them

__device__ __forceinline__ float affine(float v, float a, float b) {
  return __fadd_rn(__fmul_rn(a, v), b);
}
__device__ __forceinline__ float4 affine(float4 v, float a, float b) {
  return make_float4(affine(v.x, a, b), affine(v.y, a, b), affine(v.z, a, b), affine(v.w, a, b));
}

// V floats an access (4: 16-byte loads and stores); threadIdx.y picks the
// output row, threadIdx.x its V-float chunks
template <int V>
__global__ void __launch_bounds__(kThreads)
copy_plain_kernel(const float* __restrict__ x, float* __restrict__ out, CopyArgs c) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int o = blockIdx.x * blockDim.y + threadIdx.y;
  if (o >= c.n_slots * c.q) return;
  // the copy whose rows stay in o's slot: the last i < n_copies with
  // i mod n_slots = slot; the host keeps n_copies * q below 2^31
  const int slot = o / c.q;
  const int last = slot + c.n_slots * ((c.n_copies - 1 - slot) / c.n_slots);
  const int row = (last * c.q) % c.src_mod + (o - slot * c.q);
  const Vec* src = reinterpret_cast<const Vec*>(x + (long long)row * c.W);
  Vec* dst = reinterpret_cast<Vec*>(out + (long long)o * c.W);
  for (int k = threadIdx.x; k < c.W / V; k += blockDim.x) dst[k] = affine(src[k], c.a, c.b);
}

__global__ void __launch_bounds__(kThreads)
copy_staged_kernel(const float* __restrict__ x, float* __restrict__ out, CopyArgs c) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarrierBytes;   // slot t's slice at t * slot_bytes
  const int K = c.in_flight;
  const int off = blockIdx.x * c.slice_bytes;
  const uint32_t bytes =
      uint32_t(blockIdx.x + 1 == gridDim.x ? c.copy_bytes - off : c.slice_bytes);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(x) + off;

  if (threadIdx.x == 0) {
    for (int k = 0; k < K; ++k) mbar_init(&bars[k]);
    mbar_init_fence();
  }
  __syncthreads();
  // thread t starts copies t, t + issuers, ...; with issuers = K copy i - K,
  // which copy i waits for, is the thread's own, on its own mbarrier
  if (threadIdx.x < c.issuers) {
    for (int i = threadIdx.x; i < c.n_copies; i += c.issuers) {
      if (i >= K) mbar_wait(&bars[(i - K) % K], uint32_t(((i - K) / K) & 1));
      uint64_t* bar = &bars[i % K];
      mbar_expect_tx(bar, bytes);
      bulk_load(ring + (i % c.n_slots) * c.slot_bytes,
                src + (long long)((i * c.q) % c.src_mod) * c.W * 4, bytes, bar);
    }
    // the thread's own copies among the last K, each a barrier's last phase
    for (int j = c.n_copies > K ? c.n_copies - K : 0; j < c.n_copies; ++j)
      if (j % c.issuers == int(threadIdx.x)) mbar_wait(&bars[j % K], uint32_t((j / K) & 1));
  }
  __syncthreads();
  // every thread observes each barrier's last phase (complete by now), so
  // the bytes the async proxy wrote are visible to it
  for (int k = 0; k < K && k < c.n_copies; ++k) {
    const int last = k + K * ((c.n_copies - 1 - k) / K);
    mbar_wait(&bars[k], uint32_t((last / K) & 1));
  }
  const int chunks = int(bytes / 16);
  unsigned char* dst = reinterpret_cast<unsigned char*>(out) + off;
  for (int t = 0; t < c.n_slots; ++t) {
    const float4* s = reinterpret_cast<const float4*>(ring + t * c.slot_bytes);
    float4* d = reinterpret_cast<float4*>(dst + (long long)t * c.copy_bytes);
    for (int k = threadIdx.x; k < chunks; k += blockDim.x) d[k] = affine(s[k], c.a, c.b);
  }
}

}  // namespace

// bytes of shared memory a block of the staged mode takes: n_slots slices
// as long as the last one
extern "C" int jrsw_probe_copy_smem_bytes(int copy_bytes, int slice_bytes, int n_slices,
                                          int n_slots) {
  return kBarrierBytes + n_slots * (copy_bytes - (n_slices - 1) * slice_bytes);
}

// Plain C entry point (loaded with ctypes). Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success). The
// staged mode runs n_slices blocks, block s starting bytes [s slice_bytes,
// (s + 1) slice_bytes) of every copy, the last block the rest (the longest
// slice; ops/probes.copy_slices); the plain mode takes 16-byte accesses
// when `vec4` (W a multiple of 4, x and out 16-byte aligned).
extern "C" int jrsw_probe_copy(int staged, const float* x, float* out, int W, int q,
                               int n_copies, int src_mod, int n_slots, int in_flight,
                               int slice_bytes, int n_slices, int vec4, float a, float b,
                               void* stream) {
  if (W < 1 || q < 1 || n_copies < 1 || src_mod < 1 || n_slots < 1 || in_flight < 1 ||
      in_flight > kMaxInFlight || (long long)n_copies * q > INT32_MAX ||
      (long long)q * W * 4 > INT32_MAX || (vec4 && W % 4 != 0))
    return int(cudaErrorInvalidValue);
  const int copy_bytes = q * W * 4;
  const long long slot_bytes = copy_bytes - (long long)(n_slices - 1) * slice_bytes;
  // one thread a copy in flight, where the copies into a slot are all one
  // thread's (n_slots a multiple of in_flight) or no slot is used twice:
  // then every copy still lands before the next one into its slot starts
  const int issuers = n_slots % in_flight == 0 || n_copies <= n_slots ? in_flight : 1;
  const CopyArgs c{W,       q,          n_copies,    src_mod,         n_slots, in_flight,
                   issuers, copy_bytes, slice_bytes, int(slot_bytes), a,       b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!staged) {
    const int chunks = vec4 ? W / 4 : W;
    const dim3 block(chunks < kPlainThreads ? chunks : kPlainThreads,
                     chunks < kPlainThreads ? kPlainThreads / chunks : 1);
    const unsigned blocks = unsigned((n_slots * q + block.y - 1) / block.y);
    if (vec4)
      copy_plain_kernel<4><<<blocks, block, 0, s>>>(x, out, c);
    else
      copy_plain_kernel<1><<<blocks, block, 0, s>>>(x, out, c);
    return int(cudaGetLastError());
  }
  // the slices tile every copy: 16-byte multiples, the last one the longest
  if (copy_bytes % 16 != 0 || slice_bytes < 16 || slice_bytes % 16 != 0 || n_slices < 1 ||
      slot_bytes < slice_bytes)
    return int(cudaErrorInvalidValue);
  const long long smem = kBarrierBytes + (long long)n_slots * slot_bytes;
  if (smem > 232448) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(copy_staged_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  copy_staged_kernel<<<n_slices, kThreads, int(smem), s>>>(x, out, c);
  return int(cudaGetLastError());
}
