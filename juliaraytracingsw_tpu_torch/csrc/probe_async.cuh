// Hopper's asynchronous copy engine (TMA, 1-D bulk form) and shared-memory
// mbarriers, as the probe kernels use them (sm_90a).
//
// A bulk copy moves a contiguous run of bytes from device memory into
// shared memory without using the starting thread's registers. It
// completes on an mbarrier: the starting thread announces the bytes it
// expects (arrive.expect_tx) and waits for the barrier's phase to complete.
// Every address must be 16-byte aligned and every size a multiple of 16
// bytes.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace jrsw_probe {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: an mbarrier that completes a phase on one arrival plus the
// bytes that arrival announces
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// make the initialised barriers visible to the async proxy and the block
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed: the n-th use of a
// barrier (n = 0, 1, ...) completes the phase of parity n & 1
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// device memory -> shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst_smem, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst_smem)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared memory -> device memory, in this thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src_smem, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src_smem)), "r"(bytes)
               : "memory");
}

// close this thread's current bulk group (the bulk stores started since the
// last commit)
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed bulk groups still read
// their shared-memory source: after it, the older groups' slots may be
// overwritten (their writes to device memory may still be in flight)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// wait until every committed bulk group of this thread has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace jrsw_probe
