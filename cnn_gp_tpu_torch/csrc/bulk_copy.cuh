// Bulk asynchronous copies from global into shared memory (cp.async.bulk,
// the 1-D form of the Tensor Memory Accelerator) with their completion on
// an mbarrier, as PTX for sm_90: the staging of the box filter
// (csrc/boxfilter.cu) and of its adjoint (csrc/boxfilter_vjp.cu).
//
// The pattern: thread 0 initialises one mbarrier per stage (count 1),
// then per run arms its stage's barrier with the bytes to come
// (mbar_arrive_expect_tx) and issues the copies; every thread waits on
// the barrier's phase parity before it reads the stage.  Threads that
// wrote or read a stage through ordinary loads and stores order those
// accesses before a later copy into it with fence_proxy_async and a block
// barrier.

#pragma once

#include <cstdint>

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier shared-memory accesses (generic proxy)
// before later bulk copies into the same memory (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Bytes of a run of n floats at src that one bulk copy takes: all but a
// tail under 16 bytes, or none when src is not 16-byte aligned.
__device__ __forceinline__ unsigned bulk_bytes(const float* src,
                                               unsigned n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15u) != 0) return 0;
  return (n * 4u) & ~15u;
}

