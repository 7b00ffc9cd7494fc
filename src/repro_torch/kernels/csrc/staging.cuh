// Helpers of the persistent kernels that stage their tiles in shared memory
// (encode_fused.cu, bitpack.cu, decode_reduce.cu): asynchronous copies into
// shared memory (per thread, and 1-D bulk copies with an mbarrier), 16-byte
// stores of a staged tile, and the dynamic shared memory a launch may take.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace staging {

// 16 (or 4) bytes from global to shared memory, without registers; both
// addresses aligned to the size
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait for every copy group of this thread but the newest
__device__ __forceinline__ void wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// 1-D bulk copies (the Tensor Memory Accelerator): one thread asks for a
// whole range to be copied into shared memory, and the copy's completion
// is counted in bytes on an mbarrier in shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// one thread, before any use of `bar`; the block then synchronises
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// `src` to shared `dst`, completing the current phase of `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
// wait until the phase of `bar` with parity `phase` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
                 "selp.u32 %0, 1, 0, p; }\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(phase) : "memory");
}

// `words` 32-bit words from shared `src` to 16-byte aligned global `dst`,
// by the whole thread block: 16-byte stores, the <16-byte tail word by word.
__device__ __forceinline__ void store_words(uint32_t* __restrict__ dst,
                                            const uint32_t* src, int words) {
  const int n4 = words >> 2;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  for (int i = (n4 << 2) + threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
}

// Lets `kernel` take `smem` dynamic shared bytes a thread block, which
// above 48 KB it may only when asked.  The wrappers size grid and shared
// bytes (kernels/__init__.py::resident_blocks); this is no second opinion.
// Returns a cudaError_t.
template <typename K>
int allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace staging
