// Weibull birth/death resampling of the packet ensemble, one flow step in
// one launch.
//
// Replaces no Pallas kernel: the reference's
// juliaraytracingsw_tpu/rays/resample.py:weibull_birth_death (:66) is left
// to XLA, which fuses it. Eagerly in PyTorch the same function is about 700
// small launches a flow step (some 160 for each of its Threefry draws), on a
// path the host's dispatch already bounds; here it is one.
//
// Each thread takes one packet: it derives the four subkeys the reference
// splits off the parent key (the Threefry-2x32 hash of the counters (0, 1)
// ... (0, 4)), ages the packet by dt and, if it died (age + dt >= lifetime),
// draws its new position, lifetime and branch at its own counter (0, i) as
// jax.random.uniform does; the new key (counter (0, 0)) is written by
// thread 0 and the deaths of a block are added to `births` by one integer
// atomic. Inputs are read and new tensors written: the caller (remat, a
// driver holding the last frame) may still hold the old packets.
//
// Bound: bytes. A live packet reads 7 words of T, a dead one 2 (its age and
// lifetime: the rest are drawn); each writes 7 and a byte of dead mask. The
// hash, ~80 integer operations a Threefry and 8 a dead packet, is far below
// the card's rate.
//
// Rounding, held bit-equal to the plain twin (ops/birth_death.py):
// positions x0 + u Lx as one fused multiply-add in float32 (the reference's
// XLA contracts them), separately rounded in float64; the Weibull core
// (-log u)^(1/k_shape) in float64, rounded once to T, then times lam in T.
// nvcc compiles without --use_fast_math (ops/_build.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;

// Threefry-2x32, 20 rounds: jax's threefry2x32 of the counters (x0, x1).
__device__ __forceinline__ uint2 threefry(uint32_t k1, uint32_t k2, uint32_t x0, uint32_t x1) {
  const uint32_t ks0 = k1, ks1 = k2, ks2 = k1 ^ k2 ^ 0x1BD11BDAu;
  x0 += ks0;
  x1 += ks1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += ks1;
  x1 += ks2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += ks2;
  x1 += ks0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += ks0;
  x1 += ks1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += ks1;
  x1 += ks2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += ks2;
  x1 += ks0 + 5u;
  return make_uint2(x0, x1);
}
#undef TF_ROUND

// jax.random.uniform's float in [0, 1) from the hash's two words
template <typename T>
__device__ __forceinline__ T unit(uint2 b);

template <>
__device__ __forceinline__ float unit<float>(uint2 b) {
  return __uint_as_float(((b.x ^ b.y) >> 9) | 0x3F800000u) - 1.0f;
}

template <>
__device__ __forceinline__ double unit<double>(uint2 b) {
  const unsigned long long w = (static_cast<unsigned long long>(b.x) << 20) |
                               (b.y >> 12) | 0x3FF0000000000000ull;
  return __longlong_as_double(static_cast<long long>(w)) - 1.0;
}

// u * scale + lo: one rounding in float32 (fused), two in float64
__device__ __forceinline__ float affine(float u, float scale, float lo) {
  return fmaf(u, scale, lo);
}
__device__ __forceinline__ double affine(double u, double scale, double lo) {
  return __dadd_rn(__dmul_rn(u, scale), lo);
}
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

// (-log u)^(1/k_shape) in float64, with the exponents PyTorch's pow takes
// apart (its twin computes the same expression with torch.pow)
__device__ __forceinline__ double weibull_core(double u, double inv_k) {
  const double w = -log(u);
  if (inv_k == 0.5) return sqrt(w);
  if (inv_k == 1.0) return w;
  if (inv_k == 2.0) return w * w;
  if (inv_k == 3.0) return w * w * w;
  return pow(w, inv_k);
}

template <typename T>
struct Params {
  T Lx, Ly, x0, y0, k0, lam;
  T life_scale, life_lo;  // the lifetime draw's maxval - minval and minval
  double inv_k;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
birth_death_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ k,
                   const T* __restrict__ l, const T* __restrict__ sign,
                   const T* __restrict__ age, const T* __restrict__ lifetime,
                   const T* __restrict__ dt, const uint32_t* __restrict__ key,
                   T* __restrict__ ox, T* __restrict__ oy, T* __restrict__ ok,
                   T* __restrict__ ol, T* __restrict__ osign, T* __restrict__ oage,
                   T* __restrict__ olife, bool* __restrict__ dead_out,
                   uint32_t* __restrict__ key_out, int* __restrict__ births, long long n,
                   Params<T> p) {
  const uint32_t k1 = key[0], k2 = key[1];
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i == 0) {
    const uint2 nk = threefry(k1, k2, 0u, 0u);
    key_out[0] = nk.x;
    key_out[1] = nk.y;
  }
  int dead = 0;
  if (i < n) {
    const T a = age[i] + *dt;
    const T life = lifetime[i];
    dead = a >= life;
    if (dead) {
      const uint32_t c = static_cast<uint32_t>(i);
      const uint2 kx = threefry(k1, k2, 0u, 1u), ky = threefry(k1, k2, 0u, 2u);
      const uint2 kl = threefry(k1, k2, 0u, 3u), ks = threefry(k1, k2, 0u, 4u);
      ox[i] = affine(unit<T>(threefry(kx.x, kx.y, 0u, c)), p.Lx, p.x0);
      oy[i] = affine(unit<T>(threefry(ky.x, ky.y, 0u, c)), p.Ly, p.y0);
      const T u = max(p.life_lo, affine(unit<T>(threefry(kl.x, kl.y, 0u, c)), p.life_scale,
                                        p.life_lo));
      olife[i] = mul(static_cast<T>(weibull_core(static_cast<double>(u), p.inv_k)), p.lam);
      osign[i] = unit<T>(threefry(ks.x, ks.y, 0u, c)) < T(0.5) ? T(1) : T(-1);
      ok[i] = p.k0;
      ol[i] = T(0);
      oage[i] = T(0);
    } else {
      ox[i] = x[i];
      oy[i] = y[i];
      ok[i] = k[i];
      ol[i] = l[i];
      osign[i] = sign[i];
      oage[i] = a;
      olife[i] = life;
    }
    dead_out[i] = dead;
  }
  const int block_deaths = __syncthreads_count(dead);
  if (threadIdx.x == 0 && block_deaths) atomicAdd(births, block_deaths);
}

template <typename T>
int launch(const void* const* in, const void* dt, const uint32_t* key, void* const* out,
           bool* dead, uint32_t* key_out, int* births, long long n, const double* s,
           cudaStream_t stream) {
  Params<T> p{T(s[0]), T(s[1]), T(s[2]), T(s[3]), T(s[4]), T(s[5]), T(s[6]), T(s[7]), s[8]};
  const unsigned blocks = unsigned(n > 0 ? (n + kThreads - 1) / kThreads : 1);
  birth_death_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]), static_cast<const T*>(in[2]),
      static_cast<const T*>(in[3]), static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const T*>(dt), key, static_cast<T*>(out[0]),
      static_cast<T*>(out[1]), static_cast<T*>(out[2]), static_cast<T*>(out[3]),
      static_cast<T*>(out[4]), static_cast<T*>(out[5]), static_cast<T*>(out[6]), dead, key_out,
      births, n, p);
  return int(cudaGetLastError());
}

}  // namespace

// dtype 0 float32, 1 float64. in = (x, y, k, l, sign, age, lifetime), out the
// same seven; dt a 0-d tensor of the dtype; scalars = (Lx, Ly, x0, y0, k0,
// lam, life_scale, life_lo, 1/k_shape); births holds the running count,
// to which the deaths are added.
extern "C" int jrsw_birth_death(int dtype, const void* const* in, const void* dt,
                                const uint32_t* key, void* const* out, bool* dead,
                                uint32_t* key_out, int* births, long long n,
                                const double* scalars, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(in, dt, key, out, dead, key_out, births, n, scalars, s);
    case 1:
      return launch<double>(in, dt, key, out, dead, key_out, births, n, scalars, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
