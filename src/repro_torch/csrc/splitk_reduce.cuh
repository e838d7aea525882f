// Fixed-order split-K reduction, shared by tap_gemm.cu and matmul.cu.
//
// A kernel that splits its contraction over blocks writes float32 partials
// part[s, i] (s < splits, i < total); this pass sums them over s in
// increasing order and converts to the output type.  No atomics, so the
// result is identical run to run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace splitk {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

// out[i] = sum_s part[s * total + i], s in increasing order.
template <typename TOut>
__global__ void reduce_kernel(const float* __restrict__ part,
                              TOut* __restrict__ out, size_t total,
                              int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    // Unrolled so that eight loads are in flight; the sum keeps its order.
#pragma unroll 8
    for (int k = 0; k < splits; ++k) v += part[(size_t)k * total + i];
    store(out + i, v);
  }
}

// Launch the reduction (a grid-stride loop over at most 4096 blocks).
template <typename TOut>
inline cudaError_t reduce(const float* part, TOut* out, size_t total,
                          int splits, cudaStream_t stream) {
  const size_t want = (total + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  reduce_kernel<TOut><<<blocks, 256, 0, stream>>>(part, out, total, splits);
  return cudaGetLastError();
}

}  // namespace splitk
