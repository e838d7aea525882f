// Fixed-order split-K reduction, shared by tap_gemm.cu and matmul.cu.
//
// A kernel that splits its contraction over blocks writes float32 partials
// part[s, i] (s < splits, i < total); this pass sums them over s in
// increasing order and converts to the output type.  The input grad sums
// each phase plane over that phase's own splits (reduce_planes).  No atomics, so the
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

// The input grad's form, per phase plane: for each row r of `table`
// (phase p, first slot f, count n) and group g,
//   out[g, p, i] = sum_{s < n} part[f + s, g, i], s in increasing order,
// over planes of `plane` floats (part: (slots, G, plane), out: (G, PH,
// plane)).  grid.y = rows * G.
__global__ void reduce_planes_kernel(const float* __restrict__ part,
                                     float* __restrict__ out,
                                     const int* __restrict__ table,
                                     size_t plane, int G, int PH) {
  const int r = blockIdx.y / G, g = blockIdx.y % G;
  const int p = table[3 * r], first = table[3 * r + 1], n = table[3 * r + 2];
  const float* src = part + ((size_t)first * G + g) * plane;
  float* dst = out + ((size_t)g * PH + p) * plane;
  const size_t stride = (size_t)G * plane;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < plane;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
#pragma unroll 8
    for (int k = 0; k < n; ++k) v += src[(size_t)k * stride + i];
    dst[i] = v;
  }
}

// Launch it for `rows` table rows (a grid-stride loop over at most 4096
// blocks in all).
inline cudaError_t reduce_planes(const float* part, float* out,
                                 const int* table, int rows, size_t plane,
                                 int G, int PH, cudaStream_t stream) {
  const size_t want = (plane + 255) / 256;
  const size_t cap = 4096 / ((size_t)rows * G) + 1;
  const dim3 grid((unsigned)(want < cap ? want : cap), rows * G);
  reduce_planes_kernel<<<grid, 256, 0, stream>>>(part, out, table, plane, G,
                                                 PH);
  return cudaGetLastError();
}

}  // namespace splitk
