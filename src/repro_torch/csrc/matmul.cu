// Batched GEMM for Hopper (sm_90a): out[g] = a[g] @ b[g], float32 sums.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul.py (_matmul_kernel
// / matmul): (M, K) @ (K, N) with float32 accumulation and an output of
// `out_dtype or a.dtype`.  Inputs are float32 or bfloat16 (bfloat16 converts
// to float32 with the intrinsics only); the output is float32 or bfloat16.
// The TPU kernel padded every dimension to 128 and took its tile sizes as
// arguments; here the tiles are fixed and ragged edges are masked, so no
// operand is padded or copied.  A leading batch dimension G (the groups of
// a grouped conv) is a grid dimension: one launch serves every group.
//
// It is the GEMM under the explicit-im2col baseline ("traditional") and the
// implicit-gather engine ("bp_im2col"): every lowered product of those
// engines runs here.  Their shapes run to both extremes (paper Table II,
// batch 2): (24,642 x 27) @ (27 x 64) for the forward of layer 1,
// (100,352 x 576) @ (576 x 3) for its traditional input grad,
// (3 x 576) @ (576 x 100,352) for its bp_im2col input grad, and
// (27 x 97,682) @ (97,682 x 64) for its weight grad: one output tile over
// a 97,682-deep contraction.
//
// What bounds it on an H100: most of these products do 0.1-3 GFLOP against
// 1-60 MB, above the card's float32 ridge (67 TFLOP/s / 3.35 TB/s = 20
// FLOP/byte), so they are bound by float32 operations; the products with
// an edge of 3 (C = 3 at layer 1) are bound by bytes.
// Design: one 256-thread block owns a 64x64 output tile and walks its
// contraction in steps of 16, staging both operands through 8.5 KB of
// shared memory and accumulating a 4x4 register tile per thread with FMA
// (the same inner loop as tap_gemm.cu).  No tensor cores and no TF32: the
// sums are full float32, like the paper's FP32 setup.  When the output has
// fewer tiles than the card has SMs, the contraction is split over blocks
// (split-K): each split writes float32 partials and a second kernel sums
// them in a fixed order and converts to the output type.  No atomics, so
// results are identical run to run.
//
// The entry returns cudaGetLastError() right after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "splitk_reduce.cuh"

namespace {

constexpr int BM = 64;        // output tile rows
constexpr int BN = 64;        // output tile columns
constexpr int BK = 16;        // contraction step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int AS_LD = BM + 4; // padded row: fewer bank conflicts on stores

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// grid = (cdiv(M, BM), cdiv(N, BN), G * splits); blockIdx.z = g*splits + s.
// Split s sums contraction rows [s*chunk, min(K, (s+1)*chunk)).  With one
// split the block writes `out` in its type; otherwise it writes float32
// partials part[s, g, m, n].
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
              float* __restrict__ part, TOut* __restrict__ out, int G, int M,
              int K, int N, int splits, int chunk) {
  __shared__ __align__(16) float As[BK][AS_LD];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int g = blockIdx.z / splits, s = blockIdx.z % splits;
  const int k_begin = s * chunk;
  const int k_end = min(K, k_begin + chunk);
  const TIn* ag = a + (size_t)g * M * K;
  const TIn* bg = b + (size_t)g * K * N;
  // A loads: contraction column tid % BK, rows tid / BK + 16*r.
  // B loads: output column tid % BN, contraction rows tid / BN + 4*r.
  const int a_k = tid % BK, a_m = tid / BK;
  const int b_n = tid % BN, b_k = tid / BN;
  float acc[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m0 + a_m + 16 * r, k = k0 + a_k;
      As[a_k][a_m + 16 * r] =
          (m < M && k < k_end) ? to_f32(ag[(size_t)m * K + k]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + b_k + 4 * r, n = n0 + b_n;
      Bs[b_k + 4 * r][b_n] =
          (k < k_end && n < N) ? to_f32(bg[(size_t)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
    __syncthreads();
  }
  const size_t plane = (size_t)M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      if (splits == 1)
        splitk::store(out + (size_t)g * plane + o, acc[i][j]);
      else
        part[((size_t)s * G + g) * plane + o] = acc[i][j];
    }
  }
}

template <typename TIn, typename TOut>
int launch(const void* a, const void* b, float* part, void* out, int G,
           int M, int K, int N, int splits, cudaStream_t stream) {
  const int chunk = cdiv(cdiv(K, splits), BK) * BK;
  const dim3 grid(cdiv(M, BM), cdiv(N, BN), G * splits);
  matmul_kernel<TIn, TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b), part,
      static_cast<TOut*>(out), G, M, K, N, splits, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)splitk::reduce(part, static_cast<TOut*>(out),
                             (size_t)G * M * N, splits, stream);
}

}  // namespace

extern "C" {

// a: (G, M, K), b: (G, K, N), out: (G, M, N), all contiguous row-major.
// in_bf16 / out_bf16 select bfloat16 (1) or float32 (0) for the inputs
// (both the same type) and the output.  `part` holds splits*G*M*N floats
// and is not read when splits == 1.
int matmul(const void* a, const void* b, float* part, void* out, int in_bf16,
           int out_bf16, int G, int M, int K, int N, int splits,
           cudaStream_t stream) {
  if (in_bf16) {
    if (out_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16>(a, b, part, out, G, M, K,
                                                  N, splits, stream);
    return launch<__nv_bfloat16, float>(a, b, part, out, G, M, K, N, splits,
                                        stream);
  }
  if (out_bf16)
    return launch<float, __nv_bfloat16>(a, b, part, out, G, M, K, N, splits,
                                        stream);
  return launch<float, float>(a, b, part, out, G, M, K, N, splits, stream);
}

}  // extern "C"
