// Asynchronous global -> shared copies (cp.async, sm_80+), shared by
// tap_gemm.cu and matmul.cu.
//
// A copy with ok false reads nothing and zero-fills its destination
// (src-size 0), so a masked element costs no load.  Copies land in the
// order of their commit groups; cp_async_wait_all waits for every group
// this thread committed.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes: src and dst 16-byte aligned.  L2 only (.cg): the operands are
// streamed once per block.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
// 4 bytes: src and dst 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
