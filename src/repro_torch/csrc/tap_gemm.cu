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
// bound by float32 operations; the first layer (C = 3) and the example
// CNN's and autoencoder's convs are bound by bytes (and, at their sizes,
// by latency: a few microseconds of work).  No tensor cores and no TF32:
// results are full float32, like the paper's FP32 setup.  The tap halo is
// a pointer offset and reads past the source plane or the contraction are
// masked to zero (cp.async with src-size 0), so no operand is padded and
// shared memory does not depend on the geometry.
//
// Forward (fwd::kernel) and weight grad (wgrad::kernel) share one design:
//   * (tap, channel) packed into one index, so a narrow layer (C = 3) or a
//     depthwise conv (C = 1 per group) fills its tile rows instead of
//     padding each tap to a tile: the forward contracts over
//     kk = t * CIN + c against a (T*CIN) x COUT weight matrix; the weight
//     grad's output rows are r = t * CIN + c of one (T*CIN) x COUT matrix
//     per group, contracted over the pixels l = (b*OH + oh)*OW + ow;
//   * split-K over the contraction, summed by a second kernel in a fixed
//     order (splits chosen by the wrappers' plans);
//   * 64 threads, each with an 8 x 8 register tile (4 FMA per float read
//     from shared memory) over a 64 x 64 output tile; the weight grad has
//     a 64 x 16 variant (4 x 4 per thread) for COUT <= 16;
//   * a 2-stage shared-memory ring filled by cp.async (16-byte copies of
//     4 channels where CIN % 4 == 0, so a copy never straddles a tap, and
//     of 4 output channels where COUT % 4 == 0; 4-byte copies otherwise),
//     so step k+1 loads while step k computes, with one barrier a step.
//     Forward 18,432 B of shared memory; weight grad 16,384 B (64 x 64) or
//     10,240 B (64 x 16).  A weight-grad thread fills 4 rows of 4 pixels
//     a step: it decodes the taps of its rows once per kernel and walks
//     its pixels incrementally.
// Input grad (tap_gemm_phased_kernel: tap_loop, mma_tile): one 256-thread
// block walks taps x channel chunks in steps of 16, staging both operands
// through 8,448 B of shared memory, a 4 x 4 register tile per thread, no
// overlap of loads with compute.
//
// Groups are a grid dimension with per-group operand offsets, so a
// grouped or depthwise conv is one launch per pass.  No atomics: results
// are identical run to run.
//
// Every entry returns cudaGetLastError() right after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "splitk_reduce.cuh"

namespace {

// Tiles of the input-grad kernel.
constexpr int BM = 64;        // output tile rows (pixels)
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

// ---------------------------------------------------------------------------
// Weight grad: rows packed over (tap, channel), split-K, cp.async ring
// ---------------------------------------------------------------------------

namespace wgrad {

constexpr int BM = 64;  // output rows r = t * CIN + c of a block
constexpr int BK = 16;  // pixels per step
constexpr int THREADS = 64;

// A pixel l = (b * OH + oh) * OW + ow of the contraction.
struct Pix {
  int l, b, oh, ow;
};
__device__ __forceinline__ Pix pixel(int l, int OH, int OW) {
  const int q = l / OW;
  return {l, q / OH, q % OH, l - q * OW};
}
__device__ __forceinline__ void advance(Pix& p, int d, int OH, int OW) {
  p.l += d;
  p.ow += d;
  while (p.ow >= OW) {
    p.ow -= OW;
    if (++p.oh == OH) {
      p.oh = 0;
      ++p.b;
    }
  }
}

template <int BN>
struct Tiles {
  float a[2][BK][BM];  // [stage][pixel][row]
  float b[2][BK][BN];  // [stage][pixel][cout]
};

// part[z, r, n] = sum over the pixels l of split s of
//   src[g, p_t, b, oh + du_t, ow + dv_t, c] * dy[g, l, n],
// r = t * CIN + c, z = s * G + g (zero past the plane).  part holds
// (splits, G, T*CIN, COUT) partials, or the output when there is one
// split.  A BM x BN tile, TM x TN outputs per thread.  VEC_A: CIN % 4 == 0
// and src 16-byte aligned, so a channel quad never straddles a tap; VEC_B:
// COUT % 4 == 0 and dy, part 16-byte aligned.
// grid = (cdiv(T*CIN, BM) * cdiv(COUT, BN), 1, splits * G).
template <int BN, int TM, int TN, bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(THREADS)
kernel(const float* __restrict__ src, const float* __restrict__ dy,
       const int* __restrict__ taps, float* __restrict__ part, int G, int P,
       int B, int Hs, int Ws, int CIN, int T, int COUT, int OH, int OW,
       int chunk) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "TM x TN per thread");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 fragments");
  __shared__ __align__(16) Tiles<BN> sm;
  const int tid = threadIdx.x;
  const int col_tiles = cdiv(COUT, BN);
  const int r0 = (blockIdx.x / col_tiles) * BM;
  const int n0 = (blockIdx.x % col_tiles) * BN;
  const int g = blockIdx.z % G, split = blockIdx.z / G;
  const int R = T * CIN, L = B * OH * OW;
  const int l_begin = split * chunk, l_end = min(L, l_begin + chunk);
  const size_t plane = (size_t)B * Hs * Ws * CIN;
  const float* src_g = src + (size_t)g * P * plane;
  const float* dy_g = dy + (size_t)g * L * COUT;

  // The A rows this thread fills, fixed for the whole walk: the quad
  // r0 + 4 (tid % 16) + [0, 4) of pixels 4 (tid / 16) + [0, 4) of each
  // step.  Their taps are decoded once: with VEC_A the quad lies in one
  // tap (one 16-byte copy a pixel); otherwise each row has its own (four
  // 4-byte copies a pixel).
  constexpr int AQ = VEC_A ? 1 : 4;
  int du[AQ], dv[AQ];
  size_t a_tap[AQ];
  bool a_ok[AQ];
#pragma unroll
  for (int q = 0; q < AQ; ++q) {
    const int r = r0 + (tid % 16) * 4 + q;
    a_ok[q] = r < R;
    du[q] = dv[q] = 0;
    a_tap[q] = 0;
    if (a_ok[q]) {
      const int t = r / CIN;
      du[q] = taps[3 * t + 1];
      dv[q] = taps[3 * t + 2];
      a_tap[q] = taps[3 * t] * plane + ((size_t)du[q] * Ws + dv[q]) * CIN +
                 (r - t * CIN);
    }
  }
  // The first of this thread's pixels in the next step to load.
  Pix a_pix = pixel(l_begin + (tid / 16) * 4, OH, OW);

  auto load = [&](int st, int l0) {
    Pix p = a_pix;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t pix = (((size_t)p.b * Hs + p.oh) * Ws + p.ow) * CIN;
      float* d = &sm.a[st][(tid / 16) * 4 + j][(tid % 16) * 4];
#pragma unroll
      for (int q = 0; q < AQ; ++q) {
        const bool ok = a_ok[q] && p.l < l_end && p.oh + du[q] < Hs &&
                        p.ow + dv[q] < Ws;
        const float* s = ok ? src_g + a_tap[q] + pix : src_g;
        if constexpr (VEC_A)
          cp_async16(d, s, ok);
        else
          cp_async4(d + q, s, ok);
      }
      if (j < 3) advance(p, 1, OH, OW);
    }
    advance(a_pix, BK, OH, OW);
    if constexpr (VEC_B) {
      // Column quad tid % QB of pixels tid / QB + (THREADS / QB) j.
      constexpr int QB = BN / 4;
      const int n = n0 + (tid % QB) * 4;
#pragma unroll
      for (int j = 0; j < BK * QB / THREADS; ++j) {
        const int e = tid / QB + (THREADS / QB) * j, l = l0 + e;
        const bool ok = l < l_end && n < COUT;
        cp_async16(&sm.b[st][e][(tid % QB) * 4],
                   ok ? dy_g + (size_t)l * COUT + n : dy_g, ok);
      }
    } else {
      const int n = n0 + tid % BN;
#pragma unroll
      for (int j = 0; j < BK * BN / THREADS; ++j) {
        const int e = tid / BN + (THREADS / BN) * j, l = l0 + e;
        const bool ok = l < l_end && n < COUT;
        cp_async4(&sm.b[st][e][tid % BN],
                  ok ? dy_g + (size_t)l * COUT + n : dy_g, ok);
      }
    }
  };

  // Thread (ty, tx) owns rows h * (4 BM / TM) + 4 ty + [0, 4) and columns
  // h * (4 BN / TN) + 4 tx + [0, 4): float4 reads of both operands.
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  constexpr int RS = 4 * BM / TM, CS = 4 * BN / TN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int steps = l_end > l_begin ? cdiv(l_end - l_begin, BK) : 0;
  if (steps > 0) {
    load(0, l_begin);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    // Step `step` has landed, and every thread is done with step - 1,
    // whose stage the next load overwrites.
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < steps) {
      load((step + 1) % 2, l_begin + (step + 1) * BK);
      cp_async_commit();
    }
    const int st = step % 2;
#pragma unroll
    for (int e = 0; e < BK; ++e) {
      float a[TM], b[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sm.a[st][e][h * RS + ty * 4]);
        a[4 * h] = v.x;
        a[4 * h + 1] = v.y;
        a[4 * h + 2] = v.z;
        a[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sm.b[st][e][h * CS + tx * 4]);
        b[4 * h] = v.x;
        b[4 * h + 1] = v.y;
        b[4 * h + 2] = v.z;
        b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  float* out_z = part + (size_t)blockIdx.z * R * COUT;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + (i / 4) * RS + ty * 4 + i % 4;
    if (r >= R) continue;
    float* row = out_z + (size_t)r * COUT;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = n0 + h * CS + tx * 4;
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

using KernelFn = void (*)(const float*, const float*, const int*, float*, int,
                          int, int, int, int, int, int, int, int, int, int);

// The two tiles: 64 x 64 with 8 x 8 per thread and, for COUT <= 16,
// 64 x 16 with 4 x 4 per thread.
constexpr int BN_WIDE = 64, BN_NARROW = 16;

template <bool VEC_A, bool VEC_B>
KernelFn pick(bool narrow) {
  return narrow ? &kernel<BN_NARROW, 4, 4, VEC_A, VEC_B>
                : &kernel<BN_WIDE, 8, 8, VEC_A, VEC_B>;
}
inline KernelFn pick(bool narrow, bool vec_a, bool vec_b) {
  return vec_a ? (vec_b ? pick<true, true>(narrow) : pick<true, false>(narrow))
               : (vec_b ? pick<false, true>(narrow)
                        : pick<false, false>(narrow));
}

}  // namespace wgrad

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
// `out` and the reduction is skipped.  narrow != 0 takes the 64 x 16 tile
// (COUT <= 16), else the 64 x 64 tile.
int tap_wgrad_f32(const float* src, const float* dy, const int* taps,
                  float* part, float* out, int G, int P, int B, int Hs,
                  int Ws, int CIN, int T, int COUT, int OH, int OW,
                  int narrow, int splits, cudaStream_t stream) {
  const int L = B * OH * OW;
  const int chunk = cdiv(cdiv(L, splits), wgrad::BK) * wgrad::BK;
  const bool vec_a = CIN % 4 == 0 && (uintptr_t)src % 16 == 0;
  const bool vec_b =
      COUT % 4 == 0 && ((uintptr_t)dy | (uintptr_t)part) % 16 == 0;
  const int cols = narrow ? wgrad::BN_NARROW : wgrad::BN_WIDE;
  const dim3 grid(cdiv(T * CIN, wgrad::BM) * cdiv(COUT, cols), 1,
                  splits * G);
  const wgrad::KernelFn kernel = wgrad::pick(narrow, vec_a, vec_b);
  kernel<<<grid, wgrad::THREADS, 0, stream>>>(src, dy, taps, part, G, P, B,
                                              Hs, Ws, CIN, T, COUT, OH, OW,
                                              chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)splitk::reduce(part, out, (size_t)G * T * CIN * COUT, splits,
                             stream);
}

// Blocks of one weight-grad instance an SM holds (registers and shared
// memory), which the plan in kernels/tap_gemm.py assumes.
int tap_wgrad_blocks_per_sm(int narrow, int vec_a, int vec_b, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, wgrad::pick(narrow, vec_a, vec_b), wgrad::THREADS, 0);
}

}  // extern "C"
