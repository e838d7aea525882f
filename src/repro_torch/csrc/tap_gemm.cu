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
// No tensor cores and no TF32: results are full float32, like the paper's
// FP32 setup.  Every tile is 64 x 64 outputs; the tap halo is a pointer
// offset and reads past the source plane or the contraction are masked to
// zero, so no operand is padded and shared memory does not depend on the
// geometry.
//
// Forward (fwd::kernel).  At the paper's deep layers its 64 x 64 tiles are
// too few to fill 132 SMs (layer 4: 28 tiles), and chunking each tap's
// channels by 16 wastes lanes on a ragged edge (C = 3: 13 of 16).  So:
//   * the contraction runs over the flattened (tap, channel) index
//     kk = t * CIN + c, whose weight operand is one (T*CIN) x COUT matrix:
//     no lane is empty but the last step's;
//   * split-K refills the card where the tiles cannot (splits chosen by
//     the wrapper), each split writing float32 partials;
//   * 64 threads, each with an 8 x 8 register tile: 4 FMA per float read
//     from shared memory;
//   * a 2-stage shared-memory ring filled by cp.async (16-byte copies
//     of 4 channels of one pixel where CIN % 4 == 0, 4-byte otherwise),
//     so step k+1 loads while step k computes, with one barrier a step.
//     18,432 B of shared memory.
// Input grad and weight grad (tap_loop, mma_tile): one 256-thread block
// walks taps x channel chunks (or batch x space for the weight grad) in
// steps of 16, staging both operands through 8,448 B of shared memory, a
// 4 x 4 register tile per thread, no overlap of loads with compute.
//
// Groups are a grid dimension with per-group operand offsets, so a
// grouped or depthwise conv is one launch per pass.  The forward and the
// weight grad split their contraction over blocks (split-K); each split
// writes float32 partials and a second kernel sums them in a fixed order.
// No atomics, so results are identical run to run.
//
// Every entry returns cudaGetLastError() right after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "splitk_reduce.cuh"

namespace {

// Tiles of the input-grad and weight-grad kernels.
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

// Pixel-major contraction over one list of taps, for the phased input grad.
// src_g: (B, Hs, Ws, CIN) of one group and phase; w_g: (T, CIN, COUT);
// rows of `taps` are (j, du, dv): tap j reads w[j] at offset (du, dv).
__device__ __forceinline__ void tap_loop(
    const float* __restrict__ src_g, const float* __restrict__ w_g,
    const int* __restrict__ taps, int ntaps,
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
  for (int t = 0; t < ntaps; ++t) {
    const int sel = taps[3 * t], du = taps[3 * t + 1], dv = taps[3 * t + 2];
    const float* wt = w_g + (size_t)sel * CIN * COUT;
    for (int c0 = 0; c0 < CIN; c0 += BK) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = a_oh[r] + du, col = a_ow[r] + dv, c = c0 + a_k;
        float v = 0.f;
        if (a_ok[r] && row < Hs && col < Ws && c < CIN)
          v = src_g[(((size_t)a_b[r] * Hs + row) * Ws + col) * CIN + c];
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

// ---------------------------------------------------------------------------
// Forward: packed taps, split-K, 8 x 8 register micro-tile, cp.async ring
// ---------------------------------------------------------------------------

namespace fwd {

constexpr int BM = 64, BN = 64, BK = 16;  // output tile, contraction step
constexpr int THREADS = 64;  // 8 x 8 threads, 8 x 8 outputs each
constexpr int LDA = BK + 4;  // A row pitch: conflict-free float4 reads

struct Tiles {
  float a[2][BM][LDA];  // [stage][pixel][kk]
  float b[2][BK][BN];   // [stage][kk][cout]
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// Async copies; with ok false nothing is read and the destination is
// zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const float* src,
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

// out[z, m, n] = sum over kk in split s of A[m, kk] * w_g[kk, n], where
// z = s * G + g, m = (b * OH + oh) * OW + ow, kk = t * CIN + c and
// A[m, kk] = src[g, sel_t, b, oh + du_t, ow + dv_t, c] (zero past the
// plane).  out holds (splits, G, M, COUT) partials, or the output when
// there is one split.  VEC_A: CIN % 4 == 0 and src 16-byte aligned, so a
// channel quad never straddles a tap; VEC_B: COUT % 4 == 0 and w, out
// 16-byte aligned.  grid = (cdiv(M, BM), cdiv(COUT, BN), splits * G).
template <bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(THREADS)
kernel(const float* __restrict__ src, const float* __restrict__ w,
       const int* __restrict__ taps, float* __restrict__ out, int G, int P,
       int B, int Hs, int Ws, int CIN, int T, int COUT, int OH, int OW,
       int chunk) {
  __shared__ __align__(16) Tiles sm;
  const int tid = threadIdx.x;
  const int g = blockIdx.z % G, split = blockIdx.z / G;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = B * OH * OW, K = T * CIN;
  const int k_begin = split * chunk, k_end = min(K, k_begin + chunk);
  const size_t plane = (size_t)B * Hs * Ws * CIN;
  const float* src_g = src + (size_t)g * P * plane;
  const float* w_g = w + (size_t)g * K * COUT;

  // The A rows this thread fills, fixed for the whole walk: with VEC_A
  // pixels tid / 4 + 16 j and channel quad tid % 4 of every step (16-byte
  // copies); otherwise pixel tid and all BK columns (4-byte copies).
  constexpr int AR = VEC_A ? 4 : 1;
  int a_oh[AR], a_ow[AR];
  size_t a_off[AR];
  bool a_ok[AR];
#pragma unroll
  for (int j = 0; j < AR; ++j) {
    const int m = m0 + (VEC_A ? tid / 4 + 16 * j : tid);
    a_ok[j] = m < M;
    const int mm = a_ok[j] ? m : 0;
    a_ow[j] = mm % OW;
    const int q = mm / OW;
    a_oh[j] = q % OH;
    a_off[j] = (((size_t)(q / OH) * Hs + a_oh[j]) * Ws + a_ow[j]) * CIN;
  }

  auto load = [&](int st, int k0) {
    if constexpr (VEC_A) {
      const int kk = k0 + (tid % 4) * 4;
      const bool k_ok = kk < k_end;
      int du = 0, dv = 0;
      size_t off = 0;
      if (k_ok) {
        const int t = kk / CIN;
        du = taps[3 * t + 1];
        dv = taps[3 * t + 2];
        off = taps[3 * t] * plane + ((size_t)du * Ws + dv) * CIN +
              (kk - t * CIN);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = k_ok && a_ok[j] && a_oh[j] + du < Hs &&
                        a_ow[j] + dv < Ws;
        cp_async16(&sm.a[st][tid / 4 + 16 * j][(tid % 4) * 4],
                   ok ? src_g + off + a_off[j] : src_g, ok);
      }
    } else {
      // Step (t, c) along the flattened contraction, one tap per CIN.
      int t = k0 / CIN, c = k0 - t * CIN;
      int du = 0, dv = 0;
      size_t off = 0;
      auto tap = [&] {
        if (t < T) {
          du = taps[3 * t + 1];
          dv = taps[3 * t + 2];
          off = taps[3 * t] * plane + ((size_t)du * Ws + dv) * CIN;
        }
      };
      tap();
#pragma unroll
      for (int e = 0; e < BK; ++e) {
        const bool ok = k0 + e < k_end && a_ok[0] && a_oh[0] + du < Hs &&
                        a_ow[0] + dv < Ws;
        cp_async4(&sm.a[st][tid][e], ok ? src_g + off + a_off[0] + c : src_g,
                  ok);
        if (++c == CIN) {
          c = 0;
          ++t;
          tap();
        }
      }
    }
    if constexpr (VEC_B) {
      const int n = n0 + (tid % 16) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = tid / 16 + 4 * j, k = k0 + kr;
        const bool ok = k < k_end && n < COUT;
        cp_async16(&sm.b[st][kr][(tid % 16) * 4],
                   ok ? w_g + (size_t)k * COUT + n : w_g, ok);
      }
    } else {
      const int n = n0 + tid;
#pragma unroll
      for (int kr = 0; kr < BK; ++kr) {
        const int k = k0 + kr;
        const bool ok = k < k_end && n < COUT;
        cp_async4(&sm.b[st][kr][tid], ok ? w_g + (size_t)k * COUT + n : w_g,
                  ok);
      }
    }
  };

  // Thread (ty, tx) owns rows ty + 8 i and columns tx * 4 + j, 32 + tx * 4
  // + j (i, j < 8 and 4): 16 floats read per 64 FMA of each kk.
  const int ty = tid / 8, tx = tid % 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int steps = k_end > k_begin ? cdiv(k_end - k_begin, BK) : 0;
  if (steps > 0) {
    load(0, k_begin);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    // Step `step` has landed, and every thread is done with step - 1,
    // whose stage the next load overwrites.
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < steps) {
      load((step + 1) % 2, k_begin + (step + 1) * BK);
      cp_async_commit();
    }
    const int st = step % 2;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sm.a[st][ty + 8 * i][kq]);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(&sm.b[st][kq + kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&sm.b[st][kq + kk][32 + tx * 4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i][kk], bv[j], acc[i][j]);
      }
    }
  }

  float* out_z = out + (size_t)blockIdx.z * M * COUT;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= M) continue;
    float* row = out_z + (size_t)m * COUT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 32 + tx * 4;
      if (VEC_B) {
        if (n < COUT)
          *reinterpret_cast<float4*>(row + n) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < COUT) row[n + j] = acc[i][4 * h + j];
      }
    }
  }
}

template <bool VEC_A, bool VEC_B>
cudaError_t launch(const float* src, const float* w, const int* taps,
                   float* out, int G, int P, int B, int Hs, int Ws, int CIN,
                   int T, int COUT, int OH, int OW, int splits, int chunk,
                   cudaStream_t stream) {
  const dim3 grid(cdiv(B * OH * OW, BM), cdiv(COUT, BN), splits * G);
  kernel<VEC_A, VEC_B><<<grid, THREADS, 0, stream>>>(
      src, w, taps, out, G, P, B, Hs, Ws, CIN, T, COUT, OH, OW, chunk);
  return cudaGetLastError();
}

}  // namespace fwd

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
           counts[ph], B, Hs, Ws, CIN, COUT, QH, QW, m0, n0, As, Bs,
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

// `part` holds splits * G*M*COUT floats (M = B*OH*OW); with splits == 1 it
// may alias `out` and the reduction is skipped.
int tap_gemm_f32(const float* src, const float* w, const int* taps,
                 float* part, float* out, int G, int P, int B, int Hs,
                 int Ws, int CIN, int T, int COUT, int OH, int OW,
                 int splits, cudaStream_t stream) {
  const int chunk = cdiv(cdiv(T * CIN, splits), fwd::BK) * fwd::BK;
  const bool vec_a = CIN % 4 == 0 && (uintptr_t)src % 16 == 0;
  const bool vec_b =
      COUT % 4 == 0 && ((uintptr_t)w | (uintptr_t)part) % 16 == 0;
  auto run = vec_a ? (vec_b ? &fwd::launch<true, true>
                            : &fwd::launch<true, false>)
                   : (vec_b ? &fwd::launch<false, true>
                            : &fwd::launch<false, false>);
  cudaError_t err = run(src, w, taps, part, G, P, B, Hs, Ws, CIN, T, COUT,
                        OH, OW, splits, chunk, stream);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)splitk::reduce(part, out, (size_t)G * B * OH * OW * COUT,
                             splits, stream);
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
