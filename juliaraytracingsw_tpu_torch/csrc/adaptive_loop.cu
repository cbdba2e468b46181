// The adaptive DP5(4) 'while' loop's control on the card (CUDA C++,
// sm_90a): the clock, the step size, the counters and the loop test of
// rays/raytrace.raytrace_adaptive's fused path ('dopri5', 'while', patch
// gather) kept in device memory, so that no slot waits on the host and a
// CUDA graph can hold the whole loop as one conditional WHILE node.
//
// Replaces no TPU kernel: the reference runs this loop as a lax.while_loop,
// which XLA keeps on the TPU; the port's loop tested the clock on the host
// before the first attempt and after each one. Its plain twin is `body` in
// rays/raytrace.py (the controller `_adapt`), on the CPU.
//
// A slot is three launches, each on the loop's state only:
//   1. jrsw_ray_attempt_table (csrc/ray_attempt.cu), unchanged: out5 (5, N)
//      = [x5 y5 k5 l5 esum] from st (5, N) and scal (5,);
//   2. loop_decide_kernel: each block sums its stretch of the error column
//      esum; the last block to finish sums the blocks' sums in block order
//      (the same sum every run), takes Hairer's norm and decides as `body`
//      does: it updates the clock, the step size, the counters, the next
//      attempt's scal and the loop test t < t1 - eps && slots < max_steps,
//      which it also sets on the WHILE node's handle where there is one;
//   3. loop_apply_kernel: st[0:4] <- out5[0:4] where the slot was accepted.
// loop_init_kernel sets the state and the first test before the loop.
// Eager, the host reads the test after each slot; under a stream capture
// jrsw_while_begin adds the WHILE node after the capture's current nodes
// and captures the slot's launches into its body from a stream of its own,
// and jrsw_while_end closes that body.
//
// What bounds it on the H100: launches. Kernel 2 reads the error column
// (4 MB at 1M packets), kernel 3 reads and writes 4 rows (32 MB) on an
// accepted slot and nothing on a rejected one; the attempt itself reads
// the table rows. The decision is one thread's arithmetic in float32, in
// the order of the twin's tensor operations (IEEE division and sqrt, no
// contraction across them), maxima and minima that pass NaN on as
// torch.maximum/minimum/clip do.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ctl_f (float32): the clock and the step size, then the call's constants
enum : int { kT = 0, kH = 1, kT0 = 2, kT1 = 3, kSpan = 4, kEps = 5, kCtlF = 8 };
// ctl_i (int32): the counters, the loop test, the last slot's decision and
// the blocks of the running reduction that have finished
enum : int { kAcc = 0, kRej = 1, kSlots = 2, kGo = 3, kAccepted = 4, kBlocksDone = 5, kCtlI = 8 };

constexpr int kThreads = 256;
// blocks of the error column's reduction: partial sums kept in device memory
constexpr int kMaxBlocks = 1024;

// torch.maximum / torch.minimum: NaN in either operand gives NaN
__device__ __forceinline__ float tmax(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float tmin(float a, float b) { return (a != a || a < b) ? a : b; }
// torch.clip(x, lo, hi)
__device__ __forceinline__ float tclip(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}

// The next attempt's scal = [a0, dah, h_att] from the clock t and step h:
// h_eff = min(h, t1 - t), no attempt (h kept) once t >= t1 - eps.
__device__ __forceinline__ void next_scal(float t, float h, const float* ctl_f, float* scal) {
  const float t1 = ctl_f[kT1], span = ctl_f[kSpan];
  const bool done = t >= t1 - ctl_f[kEps];
  const float h_att = done ? h : tmin(h, t1 - t);
  scal[0] = (t - ctl_f[kT0]) / span;
  scal[1] = h_att / span;
  scal[2] = h_att;
}

__device__ __forceinline__ void set_test(int go, unsigned long long handle, int graph) {
  if (graph) cudaGraphSetConditional(handle, go ? 1u : 0u);
}

// one thread: the state before the first slot
__global__ void loop_init_kernel(const float* __restrict__ t0p, const float* __restrict__ t1p,
                                 float rtol, float atol, int init_substeps, int max_steps,
                                 float* __restrict__ ctl_f, int* __restrict__ ctl_i,
                                 float* __restrict__ scal, unsigned long long handle,
                                 int graph) {
  const float t0 = *t0p, t1 = *t1p;
  const float span = t1 - t0;
  const float eps = __fmul_rn(1e-9f, fabsf(span));
  const float h = span / float(init_substeps);
  ctl_f[kT] = t0;
  ctl_f[kH] = h;
  ctl_f[kT0] = t0;
  ctl_f[kT1] = t1;
  ctl_f[kSpan] = span;
  ctl_f[kEps] = eps;
  const int go = (t0 < t1 - eps) && (0 < max_steps);
  ctl_i[kAcc] = 0;
  ctl_i[kRej] = 0;
  ctl_i[kSlots] = 0;
  ctl_i[kGo] = go;
  ctl_i[kAccepted] = 0;
  ctl_i[kBlocksDone] = 0;
  next_scal(t0, h, ctl_f, scal);
  scal[3] = rtol;
  scal[4] = atol;
  set_test(go, handle, graph);
}

// the block's sum of v in a fixed tree order, in thread 0
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

__global__ void __launch_bounds__(kThreads)
loop_decide_kernel(const float* __restrict__ esum, int64_t n, float* __restrict__ partials,
                   float* __restrict__ ctl_f, int* __restrict__ ctl_i, float* __restrict__ scal,
                   float exponent, int max_steps, unsigned long long handle, int graph) {
  __shared__ float red[kThreads];
  __shared__ bool last;
  const int tid = threadIdx.x;
  float s = 0.0f;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + tid; i < n; i += int64_t(gridDim.x) * kThreads)
    s += esum[i];
  s = block_sum(s, red);
  if (tid == 0) {
    partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(&ctl_i[kBlocksDone], 1) == int(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: the blocks' sums in block order, read from L2
  float p = 0.0f;
  for (int j = tid; j < int(gridDim.x); j += kThreads) p += __ldcg(&partials[j]);
  p = block_sum(p, red);
  if (tid != 0) return;
  ctl_i[kBlocksDone] = 0;

  // `body`: err = sqrt(sum(esum) / (4 N)), accept / reject unless the clock
  // has reached t1 - eps, the factor 0.9 err^(-exponent) clipped to [0.2, 5]
  const float t = ctl_f[kT], h = ctl_f[kH], t1 = ctl_f[kT1], eps = ctl_f[kEps];
  const bool done = t >= t1 - eps;
  const float h_eff = tmin(h, t1 - t);
  const float err = sqrtf(p / float(4.0 * double(n)));
  const bool accept = err <= 1.0f && !done;
  const bool reject = err > 1.0f && !done;
  const float t_next = accept ? t + h_eff : t;
  const float fac = tclip(0.9f * powf(tmax(err, 1e-10f), -exponent), 0.2f, 5.0f);
  const float h_next = done ? h : tmax(h_eff * fac, eps);
  const int slots = ctl_i[kSlots] + 1;
  const int go = (t_next < t1 - eps) && (slots < max_steps);
  ctl_f[kT] = t_next;
  ctl_f[kH] = h_next;
  ctl_i[kAcc] += accept;
  ctl_i[kRej] += reject;
  ctl_i[kSlots] = slots;
  ctl_i[kGo] = go;
  ctl_i[kAccepted] = accept;
  next_scal(t_next, h_next, ctl_f, scal);
  set_test(go, handle, graph);
}

// st[0:4] <- out5[0:4] on an accepted slot: 4N contiguous floats each, N
// float4s (both start on 16-byte boundaries)
__global__ void __launch_bounds__(kThreads)
loop_apply_kernel(const float4* __restrict__ out5, float4* __restrict__ st, int64_t n,
                  const int* __restrict__ ctl_i) {
  if (!ctl_i[kAccepted]) return;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * kThreads)
    st[i] = out5[i];
}

// at least one block: no packets sum to 0, and err = sqrt(0 / 0) is NaN,
// which neither accepts nor rejects, as in the twin
unsigned blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return unsigned(b < 1 ? 1 : b < kMaxBlocks ? b : kMaxBlocks);
}

// a stream made or destroyed while this thread captures another: neither
// call enqueues work, so the capture's interaction mode is relaxed around it
cudaError_t relaxed(cudaError_t (*call)(cudaStream_t*), cudaStream_t* s) {
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  cudaError_t err = cudaThreadExchangeStreamCaptureMode(&mode);
  if (err != cudaSuccess) return err;
  const cudaError_t out = call(s);
  err = cudaThreadExchangeStreamCaptureMode(&mode);
  return out != cudaSuccess ? out : err;
}

cudaError_t make_stream(cudaStream_t* s) {
  return cudaStreamCreateWithFlags(s, cudaStreamNonBlocking);
}

cudaError_t drop_stream(cudaStream_t* s) { return cudaStreamDestroy(*s); }

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`
// without synchronising and returns a cudaError_t (0 on success).

extern "C" int jrsw_adaptive_max_blocks() { return kMaxBlocks; }

// ctl_f (8,) f32, ctl_i (8,) i32, scal (5,) f32; t0, t1 0-d f32. With
// `graph` the stream must be capturing: the WHILE node's handle is made in
// the capture's graph, written to *handle, and set to the first test.
extern "C" int jrsw_adaptive_init(const float* t0, const float* t1, float rtol, float atol,
                                  int init_substeps, int max_steps, float* ctl_f, int* ctl_i,
                                  float* scal, int graph, unsigned long long* handle,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraphConditionalHandle h = 0;
  if (graph) {
    cudaStreamCaptureStatus status;
    cudaGraph_t g;
    cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &g, nullptr, nullptr);
    if (err != cudaSuccess) return int(err);
    if (status != cudaStreamCaptureStatusActive) return int(cudaErrorStreamCaptureImplicit);
    err = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
    if (err != cudaSuccess) return int(err);
  }
  *handle = h;
  loop_init_kernel<<<1, 1, 0, s>>>(t0, t1, rtol, atol, init_substeps, max_steps, ctl_f, ctl_i,
                                   scal, h, graph);
  return int(cudaGetLastError());
}

// out5 (5, N) f32 (its row 4 the error column), partials (max blocks,) f32
extern "C" int jrsw_adaptive_decide(const float* out5, long long n, float* partials, float* ctl_f,
                                    int* ctl_i, float* scal, float exponent, int max_steps,
                                    int graph, unsigned long long handle, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  loop_decide_kernel<<<blocks_for(n), kThreads, 0, s>>>(out5 + 4 * n, n, partials, ctl_f, ctl_i,
                                                        scal, exponent, max_steps, handle, graph);
  return int(cudaGetLastError());
}

// out5 (5, N), st (5, N) f32, each on a 16-byte boundary
extern "C" int jrsw_adaptive_apply(const float* out5, float* st, long long n, const int* ctl_i,
                                   void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  loop_apply_kernel<<<blocks_for(n), kThreads, 0, s>>>(reinterpret_cast<const float4*>(out5),
                                                       reinterpret_cast<float4*>(st), n, ctl_i);
  return int(cudaGetLastError());
}

// Adds a WHILE node on `handle` after the capture's current nodes on
// `stream`, makes it the capture's only dependency, and starts capturing
// its body from a new stream, written to *body.
extern "C" int jrsw_while_begin(void* stream, unsigned long long handle, void** body) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t g;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &g, &deps, &ndeps);
  if (err != cudaSuccess) return int(err);
  if (status != cudaStreamCaptureStatusActive) return int(cudaErrorStreamCaptureImplicit);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, g, deps, ndeps, &params);
  if (err != cudaSuccess) return int(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return int(err);
  cudaStream_t b;
  err = relaxed(make_stream, &b);
  if (err != cudaSuccess) return int(err);
  err = cudaStreamBeginCaptureToGraph(b, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                      cudaStreamCaptureModeRelaxed);
  if (err != cudaSuccess) {
    relaxed(drop_stream, &b);
    return int(err);
  }
  *body = b;
  return 0;
}

// Ends the body's capture begun by jrsw_while_begin and frees its stream
// (the body graph belongs to the WHILE node).
extern "C" int jrsw_while_end(void* body) {
  cudaStream_t b = static_cast<cudaStream_t>(body);
  cudaGraph_t g;
  const cudaError_t err = cudaStreamEndCapture(b, &g);
  const cudaError_t dropped = relaxed(drop_stream, &b);
  return int(err != cudaSuccess ? err : dropped);
}
