// Tap-GEMM kernels of BP-im2col for Hopper (sm_90a), float32.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/tap_gemm.py:
//   tap_gemm_f32         <- tap_gemm        (_tap_gemm_kernel)         forward conv
//   tap_gemm_phased_f32  <- tap_gemm_phased (_tap_gemm_phased_kernel)  input grad,
//                           transposed mode (Algorithm 1), all stride phases
//   tap_wgrad_f32        <- tap_wgrad       (_tap_wgrad_kernel)        weight grad,
//                           dilated mode (Algorithm 2)
//
// All three compute a multi-tap GEMM over COMPACT, channels-last tensors:
// tap t reads the source at a static (plane, du, dv) offset, so the
// zero-space of backprop is never built.  The tap tables come from the
// planner in repro_torch/kernels/ops.py as small int32 device tensors.
//
// What bounds them on an H100: at the paper's layers (batch 2, FP32) most
// passes need 0.4 GFLOP against ~10 MB, i.e. ~40 FLOP/byte, above the
// card's float32 ridge (67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte), so they are
// bound by float32 operations; the first layer (C = 3) is bound by bytes.
// Design: one 256-thread block owns a 64x64 output tile and walks the
// contraction (taps x channel chunks, or batch x space for the weight
// grad) in steps of 16, staging both operands through 8 KB of shared
// memory and accumulating a 4x4 register tile per thread with FMA.  The
// tap halo is a pointer offset; reads past the source plane or the
// ragged channel edge are masked to zero, so no operand is padded.  The
// shared-memory footprint does not depend on the geometry, so every
// layer launches.  No tensor cores and no TF32 in this version: results
// are full float32, like the paper's FP32 setup.
//
// Groups are a grid dimension with per-group operand offsets, so a
// grouped or depthwise conv is one launch per pass.  The weight grad
// splits its contraction over blocks (split-K); each split writes float32
// partials and a second kernel sums them in a fixed order.  No atomics, so
// results are identical run to run.
//
// Every entry returns cudaGetLastError() right after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "splitk_reduce.cuh"

namespace {

constexpr int BM = 64;        // output tile rows (pixels, or cin for wgrad)
constexpr int BN = 64;        // output tile columns (cout)
constexpr int BK = 16;        // contraction step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int AS_LD = BM + 4; // padded row: fewer bank conflicts on stores

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// acc[i][j] += sum_k As[k][ty*4+i] * Bs[k][tx*4+j]
__device__ __forceinline__ void mma_tile(float (*As)[AS_LD],
                                         float (*Bs)[BN],
                                         float acc[4][4], int ty, int tx) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Store the 4x4 register tile of an (M x COUT) row-major output.
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           float acc[4][4], int m0,
                                           int n0, int M, int COUT, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < COUT) out[(size_t)m * COUT + n] = acc[i][j];
    }
  }
}

// Pixel-major contraction over one list of taps: shared by the forward and
// the phased input grad.  src_g: (P, B, Hs, Ws, CIN) of one group (P == 1
// for the phased kernel); w_g: (T, CIN, COUT); rows of `taps` are
// (sel, du, dv): with plane_from_tap, sel is the source plane and tap t
// reads w[t] (forward); otherwise sel indexes w and the source has one plane.
__device__ __forceinline__ void tap_loop(
    const float* __restrict__ src_g, const float* __restrict__ w_g,
    const int* __restrict__ taps, int ntaps, bool plane_from_tap,
    int B, int Hs, int Ws, int CIN, int COUT, int OH, int OW, int m0, int n0,
    float (*As)[AS_LD], float (*Bs)[BN], float acc[4][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int M = B * OH * OW;
  // A loads: element e = tid + THREADS*r -> channel k = tid % BK (fixed),
  // pixel row tid / BK + 16*r of the tile (fixed across the whole loop).
  const int a_k = tid % BK;
  int a_b[4], a_oh[4], a_ow[4];
  bool a_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + tid / BK + 16 * r;
    a_ok[r] = m < M;
    const int mm = a_ok[r] ? m : 0;
    a_ow[r] = mm % OW;
    const int t = mm / OW;
    a_oh[r] = t % OH;
    a_b[r] = t / OH;
  }
  // B loads: column tid % BN, rows tid / BN + 4*r.
  const int b_n = tid % BN, b_k = tid / BN;
  const size_t plane = (size_t)B * Hs * Ws * CIN;
  for (int t = 0; t < ntaps; ++t) {
    const int sel = taps[3 * t], du = taps[3 * t + 1], dv = taps[3 * t + 2];
    const float* sp = src_g + (plane_from_tap ? (size_t)sel * plane : 0);
    const float* wt = w_g + (size_t)(plane_from_tap ? t : sel) * CIN * COUT;
    for (int c0 = 0; c0 < CIN; c0 += BK) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = a_oh[r] + du, col = a_ow[r] + dv, c = c0 + a_k;
        float v = 0.f;
        if (a_ok[r] && row < Hs && col < Ws && c < CIN)
          v = sp[(((size_t)a_b[r] * Hs + row) * Ws + col) * CIN + c];
        As[a_k][tid / BK + 16 * r] = v;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = c0 + b_k + 4 * r, n = n0 + b_n;
        Bs[b_k + 4 * r][b_n] =
            (k < CIN && n < COUT) ? wt[(size_t)k * COUT + n] : 0.f;
      }
      __syncthreads();
      mma_tile(As, Bs, acc, ty, tx);
      __syncthreads();
    }
  }
}

// Forward: out[g, b, oh, ow, :] = sum_t src[g, p_t, b, oh+du_t, ow+dv_t, :] @ w[g, t].
// grid = (cdiv(B*OH*OW, BM), cdiv(COUT, BN), G)
__global__ void __launch_bounds__(THREADS)
tap_gemm_kernel(const float* __restrict__ src, const float* __restrict__ w,
                const int* __restrict__ taps, float* __restrict__ out, int P,
                int B, int Hs, int Ws, int CIN, int T, int COUT, int OH,
                int OW) {
  __shared__ __align__(16) float As[BK][AS_LD];
  __shared__ __align__(16) float Bs[BK][BN];
  const int g = blockIdx.z, m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = B * OH * OW;
  float acc[4][4] = {};
  tap_loop(src + (size_t)g * P * B * Hs * Ws * CIN,
           w + (size_t)g * T * CIN * COUT, taps, T, true, B, Hs, Ws, CIN,
           COUT, OH, OW, m0, n0, As, Bs, acc);
  store_tile(out + (size_t)g * M * COUT, acc, m0, n0, M, COUT,
             threadIdx.x / 16, threadIdx.x % 16);
}

// Input grad, all stride phases in one launch: blockIdx.z = g*PH + phase.
// Phase p runs counts[p] taps (j, du, dv) from taps[p, :, :]; a phase with
// no taps writes zeros (its rows of dI receive no contribution).
// src: (G, B, Hs, Ws, CIN) padded compact dY; w: (G, PH, T, CIN, COUT);
// out: (G, PH, B, QH, QW, COUT).
__global__ void __launch_bounds__(THREADS)
tap_gemm_phased_kernel(const float* __restrict__ src,
                       const float* __restrict__ w,
                       const int* __restrict__ counts,
                       const int* __restrict__ taps, float* __restrict__ out,
                       int PH, int B, int Hs, int Ws, int CIN, int T,
                       int COUT, int QH, int QW) {
  __shared__ __align__(16) float As[BK][AS_LD];
  __shared__ __align__(16) float Bs[BK][BN];
  const int g = blockIdx.z / PH, ph = blockIdx.z % PH;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = B * QH * QW;
  float acc[4][4] = {};
  tap_loop(src + (size_t)g * B * Hs * Ws * CIN,
           w + ((size_t)g * PH + ph) * T * CIN * COUT, taps + ph * T * 3,
           counts[ph], false, B, Hs, Ws, CIN, COUT, QH, QW, m0, n0, As, Bs,
           acc);
  store_tile(out + ((size_t)g * PH + ph) * M * COUT, acc, m0, n0, M, COUT,
             threadIdx.x / 16, threadIdx.x % 16);
}

// Weight grad: part[s, g, t, c, n] = sum over contraction rows l of split s
// (l = (b*OH + oh)*OW + ow) of src[g, p_t, b, oh+du, ow+dv, c] * dy[g, l, n].
// grid = (cdiv(CIN, BM) * cdiv(COUT, BN), splits, G*T)
__global__ void __launch_bounds__(THREADS)
tap_wgrad_kernel(const float* __restrict__ src, const float* __restrict__ dy,
                 const int* __restrict__ taps, float* __restrict__ part,
                 int G, int P, int B, int Hs, int Ws, int CIN, int T,
                 int COUT, int OH, int OW, int chunk) {
  __shared__ __align__(16) float As[BK][AS_LD];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_tiles = cdiv(COUT, BN);
  const int m0 = (blockIdx.x / n_tiles) * BM, n0 = (blockIdx.x % n_tiles) * BN;
  const int g = blockIdx.z / T, t = blockIdx.z % T;
  const int L = B * OH * OW;
  const int l_begin = blockIdx.y * chunk;
  const int l_end = min(L, l_begin + chunk);
  const int p = taps[3 * t], du = taps[3 * t + 1], dv = taps[3 * t + 2];
  const float* sp = src + ((size_t)g * P + p) * B * Hs * Ws * CIN;
  const float* dyg = dy + (size_t)g * L * COUT;
  // Loads: column tid % 64 (cin for A, cout for B), rows tid / 64 + 4*r.
  const int col = tid % 64, k_lo = tid / 64;
  float acc[4][4] = {};
  for (int l0 = l_begin; l0 < l_end; l0 += BK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k_lo + 4 * r, l = l0 + k;
      const bool ok = l < l_end;
      const int ll = ok ? l : 0;
      const int ow = ll % OW, q = ll / OW, oh = q % OH, b = q / OH;
      const int row = oh + du, cl = ow + dv, c = m0 + col, n = n0 + col;
      As[k][col] = (ok && row < Hs && cl < Ws && c < CIN)
          ? sp[(((size_t)b * Hs + row) * Ws + cl) * CIN + c] : 0.f;
      Bs[k][col] = (ok && n < COUT) ? dyg[(size_t)ll * COUT + n] : 0.f;
    }
    __syncthreads();
    mma_tile(As, Bs, acc, ty, tx);
    __syncthreads();
  }
  float* out = part + (((size_t)blockIdx.y * G + g) * T + t) * CIN * COUT;
  store_tile(out, acc, m0, n0, CIN, COUT, ty, tx);
}

}  // namespace

extern "C" {

int tap_gemm_f32(const float* src, const float* w, const int* taps,
                 float* out, int G, int P, int B, int Hs, int Ws, int CIN,
                 int T, int COUT, int OH, int OW, cudaStream_t stream) {
  const dim3 grid(cdiv(B * OH * OW, BM), cdiv(COUT, BN), G);
  tap_gemm_kernel<<<grid, THREADS, 0, stream>>>(src, w, taps, out, P, B, Hs,
                                                Ws, CIN, T, COUT, OH, OW);
  return (int)cudaGetLastError();
}

int tap_gemm_phased_f32(const float* src, const float* w, const int* counts,
                        const int* taps, float* out, int G, int PH, int B,
                        int Hs, int Ws, int CIN, int T, int COUT, int QH,
                        int QW, cudaStream_t stream) {
  const dim3 grid(cdiv(B * QH * QW, BM), cdiv(COUT, BN), G * PH);
  tap_gemm_phased_kernel<<<grid, THREADS, 0, stream>>>(
      src, w, counts, taps, out, PH, B, Hs, Ws, CIN, T, COUT, QH, QW);
  return (int)cudaGetLastError();
}

// `part` holds splits * G*T*CIN*COUT floats; with splits == 1 it may alias
// `out` and the reduction is skipped.
int tap_wgrad_f32(const float* src, const float* dy, const int* taps,
                  float* part, float* out, int G, int P, int B, int Hs,
                  int Ws, int CIN, int T, int COUT, int OH, int OW,
                  int splits, cudaStream_t stream) {
  const int L = B * OH * OW;
  const int chunk = cdiv(cdiv(L, splits), BK) * BK;
  const dim3 grid(cdiv(CIN, BM) * cdiv(COUT, BN), splits, G * T);
  tap_wgrad_kernel<<<grid, THREADS, 0, stream>>>(
      src, dy, taps, part, G, P, B, Hs, Ws, CIN, T, COUT, OH, OW, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)splitk::reduce(part, out, (size_t)G * T * CIN * COUT, splits,
                             stream);
}

}  // extern "C"
