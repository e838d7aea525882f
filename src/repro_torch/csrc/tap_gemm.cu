// Tap-GEMM kernels of BP-im2col for Hopper (sm_90a), float32 or bfloat16
// operands, float32 products, sums and outputs.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/tap_gemm.py:
//   tap_gemm_{f32,bf16}         <- tap_gemm        (_tap_gemm_kernel)         forward conv
//   tap_gemm_phased_{f32,bf16}  <- tap_gemm_phased (_tap_gemm_phased_kernel)  input grad,
//                                  transposed mode (Algorithm 1), all stride phases
//   tap_wgrad_{f32,bf16}        <- tap_wgrad       (_tap_wgrad_kernel)        weight grad,
//                                  dilated mode (Algorithm 2)
//   tap_gemm_dw_{f32,bf16},        <- tap_gemm, tap_gemm_phased, tap_wgrad
//   tap_gemm_phased_dw_{f32,bf16},    at one channel a group (depthwise:
//   tap_wgrad_dw_{f32,bf16}           the dw namespace below)
// As the TPU kernels do, a bfloat16 entry reads its operands as bfloat16
// and sums their products in float32 (the TPU kernels'
// preferred_element_type); every tiled entry writes float32 (the wrappers
// cast the forward's and the input grad's output back to the operands'
// type), the depthwise forward and input grad the operands' type.
// A bfloat16 operand stays bfloat16 in global and shared memory and is
// converted to float32 as a register fragment loads (elem::load4), so the
// tile walks, their thread maps and the float32 instances are unchanged.
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
// All three kernels share one design:
//   * (tap, channel) packed into one index, so a narrow layer (C = 3) or a
//     depthwise conv (C = 1 per group) fills its tile rows instead of
//     padding each tap to a tile: the forward contracts over
//     kk = t * CIN + c against a (T*CIN) x COUT weight matrix; input-grad
//     phase p over kk = t * CIN + c for its own counts[p] taps, weight row
//     j_t * CIN + c of its stack (j_t from the tap table); the weight
//     grad's output rows are r = t * CIN + c of one (T*CIN) x COUT matrix
//     per group, contracted over the pixels l = (b*OH + oh)*OW + ow;
//   * split-K over the contraction, summed by a second kernel in a fixed
//     order (splits chosen by the wrappers' plans);
//   * 64 threads, each with an 8 x 8 register tile (4 FMA per float read
//     from shared memory) over a 64 x 64 output tile; for narrow outputs a
//     64 x 16 tile (4 x 4 per thread, COUT <= 16) and, for the input grad,
//     a 128 x 8 tile (2 x 8 per thread, COUT <= 8) that streams the source
//     once at full width and reads the few weight columns as broadcasts;
//   * a 2-stage shared-memory ring filled by cp.async (copies of 4
//     channels where CIN % 4 == 0, so a copy never straddles a tap, and of
//     4 output channels where COUT % 4 == 0: 16 bytes of float32, 8 of
//     bfloat16; one element a copy otherwise: a 4-byte cp.async of
//     float32, a plain load and store of bfloat16, which has no 2-byte
//     cp.async), so step k+1 loads while step k computes, with one barrier
//     a step.  Shared memory of a bfloat16 instance is half the float32
//     one's.
// The forward and the input grad run one tile walk (tile::run): the
// forward's 64 x 64 instance, 18,432 B of shared memory; the input grad's
// 64 x 64, 64 x 16 (12,288 B) and 128 x 8 (21,504 B) instances.  The
// weight grad's A rows are packed taps rather than pixels, so it has its
// own walk (wgrad::kernel, 16,384 B or 10,240 B): a thread fills 4 rows
// of 4 pixels a step, decodes the taps of its rows once per kernel and
// walks its pixels incrementally.
// Input grad: one launch for every (group, phase, split).  A small int32
// work table lists the blocks' (phase, contraction range, destination):
// the active phases' splits, cut to one chunk length so blocks carry equal
// work, and one empty entry per phase without taps, which stores its zeros
// straight into the output.  Only the phases that split write partials
// (one plane a split), summed per phase by splitk::reduce_planes.
//
// Groups are a grid dimension with per-group operand offsets, so a
// grouped or depthwise conv is one launch per pass.  No atomics: results
// are identical run to run.
//
// Every entry returns cudaGetLastError() right after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "splitk_reduce.cuh"

namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// Operand elements: float32, or bfloat16 kept as bfloat16 in global and
// shared memory and converted to float32 as a register fragment loads
// ---------------------------------------------------------------------------

namespace elem {

// Four consecutive elements global -> shared: 16 bytes of float32 (src and
// dst 16-byte aligned), 8 of bfloat16 (8-byte aligned); zero when !ok.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  cp_async16(dst, src, ok);
}
__device__ __forceinline__ void copy4(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, bool ok) {
  cp_async8(dst, src, ok);
}
// One element: a 4-byte cp.async for float32; bfloat16 has no 2-byte
// cp.async, so a plain load and store (ordered by the ring's barrier).
__device__ __forceinline__ void copy1(float* dst, const float* src, bool ok) {
  cp_async4(dst, src, ok);
}
__device__ __forceinline__ void copy1(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16(0.f);
}
// Four consecutive shared elements as float32 (p 16-byte aligned for
// float32, 8-byte for bfloat16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

}  // namespace elem

// ---------------------------------------------------------------------------
// The tile walk of the forward and the input grad: packed taps, 8 x 8 (or
// narrower) register tiles, cp.async ring
// ---------------------------------------------------------------------------

namespace tile {

constexpr int BK = 16;       // contraction rows per step
constexpr int THREADS = 64;
constexpr int LDA = BK + 4;  // A row pitch: conflict-free float4 reads

template <int BM, int BN, typename E>
struct Tiles {
  E a[2][BM][LDA];  // [stage][pixel][kk]
  E b[2][BK][BN];   // [stage][kk][cout]
};

// Contraction row k = t * CIN + c as (t, c), moved forward without a
// division.
struct Row {
  int t, c;
};
__device__ __forceinline__ void advance(Row& r, int d, int CIN) {
  r.c += d;
  while (r.c >= CIN) {
    r.c -= CIN;
    ++r.t;
  }
}

// out_z[m, n] = sum over kk in [k_begin, k_end) of A[m, kk] * W[kk, n] for
// the BM x BN output tile at (m0, n0), with m = (b * OH + oh) * OW + ow,
// kk = t * CIN + c and A[m, kk] = src_g[taps[3t] * plane + pixel
// (b, oh + du_t, ow + dv_t), c] (zero past the Hs x Ws plane).  W's row kk
// is w_g's row kk, or with TAP_ROWS its row taps[3t] * CIN + c (the input
// grad's weight slot j of tap t).  Rows of the tap table below T may be
// read.  TM x TN outputs a thread.  E is the operands' element (float or
// __nv_bfloat16); products and sums are float32 and out_z is float32.
// VEC_A: CIN % 4 == 0 and src aligned to four elements, so a channel quad
// never straddles a tap; VEC_B: COUT % 4 == 0, w aligned to four elements
// and out 16-byte aligned.
template <int BM, int BN, int TM, int TN, bool VEC_A, bool VEC_B,
          bool TAP_ROWS, typename E>
__device__ __forceinline__ void run(
    Tiles<BM, BN, E>& sm, const E* __restrict__ src_g, size_t plane,
    const E* __restrict__ w_g, const int* __restrict__ taps, int T,
    int B, int Hs, int Ws, int CIN, int COUT, int OH, int OW, int m0, int n0,
    int k_begin, int k_end, float* __restrict__ out_z) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "TM x TN per thread");
  static_assert(TN % 4 == 0 && BM % 16 == 0 && BM % THREADS == 0,
                "float4 fragments, whole copy passes");
  const int tid = threadIdx.x;
  const int M = B * OH * OW;

  // The A rows this thread fills, fixed for the whole walk: with VEC_A
  // pixels tid / 4 + 16 j and channel quad tid % 4 of every step (copies
  // of four elements); otherwise pixels tid + 64 j and all BK columns (one
  // element a copy).
  constexpr int AR = VEC_A ? BM / 16 : BM / THREADS;
  int a_oh[AR], a_ow[AR];
  size_t a_off[AR];
  bool a_ok[AR];
#pragma unroll
  for (int j = 0; j < AR; ++j) {
    const int m = m0 + (VEC_A ? tid / 4 + 16 * j : tid + THREADS * j);
    a_ok[j] = m < M;
    const int mm = a_ok[j] ? m : 0;
    a_ow[j] = mm % OW;
    const int q = mm / OW;
    a_oh[j] = q % OH;
    a_off[j] = (((size_t)(q / OH) * Hs + a_oh[j]) * Ws + a_ow[j]) * CIN;
  }

  // The B rows this thread fills: with VEC_B column quad tid % QB of rows
  // tid / QB + (THREADS / QB) j; otherwise column tid % BN of rows
  // tid / BN + (THREADS / BN) j.  With TAP_ROWS, step_row is the (t, c) of
  // the first row of the next step to load: a step within one tap reads
  // its rows shifted by (j_t - t) * CIN, one offset for the whole step.
  constexpr int QB = BN / 4;
  constexpr int B_PER_ROW = VEC_B ? QB : BN;  // threads on one row
  constexpr int B_STRIDE = THREADS / B_PER_ROW;
  constexpr int NB = VEC_B ? cdiv(BK * QB, THREADS) : BK * BN / THREADS;
  constexpr bool B_COL = !VEC_B && BN == THREADS;  // one column a thread
  const int b_r0 = B_COL ? 0 : tid / B_PER_ROW;
  const int b_n = n0 + (VEC_B ? (tid % QB) * 4 : B_COL ? tid : tid % BN);
  Row step_row = {0, 0};
  if constexpr (TAP_ROWS) {
    if (k_end > k_begin) {
      step_row.t = k_begin / CIN;
      step_row.c = k_begin - step_row.t * CIN;
    }
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
      for (int j = 0; j < AR; ++j) {
        const bool ok = k_ok && a_ok[j] && a_oh[j] + du < Hs &&
                        a_ow[j] + dv < Ws;
        elem::copy4(&sm.a[st][tid / 4 + 16 * j][(tid % 4) * 4],
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
#pragma unroll
        for (int j = 0; j < AR; ++j) {
          const bool ok = k0 + e < k_end && a_ok[j] && a_oh[j] + du < Hs &&
                          a_ow[j] + dv < Ws;
          elem::copy1(&sm.a[st][tid + THREADS * j][e],
                      ok ? src_g + off + a_off[j] + c : src_g, ok);
        }
        if (++c == CIN) {
          c = 0;
          ++t;
          tap();
        }
      }
    }
    // With TAP_ROWS: the step's rows lie in one tap (shift) or not (each
    // row decoded).
    const bool one_tap = !TAP_ROWS || step_row.c + BK <= CIN;
    int shift = 0;
    if constexpr (TAP_ROWS) {
      if (one_tap) shift = (taps[3 * step_row.t] - step_row.t) * CIN;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int kr = b_r0 + B_STRIDE * j, k = k0 + kr;
      if constexpr (VEC_B && BK * QB % THREADS != 0) {
        if (kr >= BK) break;  // more threads than quads a step
      }
      const bool ok = k < k_end && b_n < COUT;
      size_t row = k + shift;
      if (TAP_ROWS && !one_tap && ok) {
        Row r = step_row;
        advance(r, kr, CIN);
        row = (size_t)taps[3 * r.t] * CIN + r.c;
      }
      const E* s = ok ? w_g + row * COUT + b_n : w_g;
      if constexpr (VEC_B)
        elem::copy4(&sm.b[st][kr][b_n - n0], s, ok);
      else
        elem::copy1(&sm.b[st][kr][b_n - n0], s, ok);
    }
    if constexpr (TAP_ROWS) advance(step_row, BK, CIN);
  };

  // Thread (ty, tx) owns rows ty + RS i and columns h * CS + tx * 4 + j
  // (i < TM, h < TN / 4, j < 4): float4 reads of both operands; with
  // 8 x 8, 16 floats read per 64 FMA of each kk.
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);
  constexpr int RS = BM / TM, CS = 4 * BN / TN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
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
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = elem::load4(&sm.a[st][ty + RS * i][kq]);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[TN];
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 v = elem::load4(&sm.b[st][kq + kk][h * CS + tx * 4]);
          bv[4 * h] = v.x;
          bv[4 * h + 1] = v.y;
          bv[4 * h + 2] = v.z;
          bv[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][kk], bv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + RS * i;
    if (m >= M) continue;
    float* row = out_z + (size_t)m * COUT;
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

}  // namespace tile

// ---------------------------------------------------------------------------
// Forward: packed taps, split-K, 8 x 8 register micro-tile, cp.async ring
// ---------------------------------------------------------------------------

namespace fwd {

constexpr int BM = 64, BN = 64;  // output tile

// out[z, m, n] = sum over kk in split s of A[m, kk] * w_g[kk, n], where
// z = s * G + g, m = (b * OH + oh) * OW + ow, kk = t * CIN + c and
// A[m, kk] = src[g, sel_t, b, oh + du_t, ow + dv_t, c] (zero past the
// plane).  out holds (splits, G, M, COUT) partials, or the output when
// there is one split.  grid = (cdiv(M, BM), cdiv(COUT, BN), splits * G).
template <typename E, bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(tile::THREADS)
kernel(const E* __restrict__ src, const E* __restrict__ w,
       const int* __restrict__ taps, float* __restrict__ out, int G, int P,
       int B, int Hs, int Ws, int CIN, int T, int COUT, int OH, int OW,
       int chunk) {
  __shared__ __align__(16) tile::Tiles<BM, BN, E> sm;
  const int g = blockIdx.z % G, split = blockIdx.z / G;
  const int M = B * OH * OW, K = T * CIN;
  const int k_begin = split * chunk;
  const size_t plane = (size_t)B * Hs * Ws * CIN;
  tile::run<BM, BN, 8, 8, VEC_A, VEC_B, false>(
      sm, src + (size_t)g * P * plane, plane, w + (size_t)g * K * COUT, taps,
      T, B, Hs, Ws, CIN, COUT, OH, OW, blockIdx.x * BM, blockIdx.y * BN,
      k_begin, min(K, k_begin + chunk),
      out + (size_t)blockIdx.z * M * COUT);
}

template <typename E, bool VEC_A, bool VEC_B>
cudaError_t launch(const E* src, const E* w, const int* taps, float* out,
                   int G, int P, int B, int Hs, int Ws, int CIN, int T,
                   int COUT, int OH, int OW, int splits, int chunk,
                   cudaStream_t stream) {
  const dim3 grid(cdiv(B * OH * OW, BM), cdiv(COUT, BN), splits * G);
  kernel<E, VEC_A, VEC_B><<<grid, tile::THREADS, 0, stream>>>(
      src, w, taps, out, G, P, B, Hs, Ws, CIN, T, COUT, OH, OW, chunk);
  return cudaGetLastError();
}

}  // namespace fwd

// ---------------------------------------------------------------------------
// Input grad: every phase in one launch, packed per-phase taps, narrow
// tiles, phase-aware split-K
// ---------------------------------------------------------------------------

namespace phased {

// Work entry z / G of the table: (phase, k_begin, k_end, slot).  Phase p
// contracts over kk = t * CIN + c, t < counts[p], against weight rows
// j_t * CIN + c of w[g, p] (rows (j, du, dv) of taps[p]); an entry with
// k_begin == k_end stores zeros (a phase without taps).  slot < 0 writes
// out[g, p] (G, PH, M, COUT); else part[slot, g] (slots, G, M, COUT).
// src: (G, B, Hs, Ws, CIN) padded compact dY; w: (G, PH, T, CIN, COUT).
// grid = (cdiv(M, BM), cdiv(COUT, BN), entries * G).
template <typename E, int BM, int BN, int TM, int TN, bool VEC_A,
          bool VEC_B>
__global__ void __launch_bounds__(tile::THREADS)
kernel(const E* __restrict__ src, const E* __restrict__ w,
       const int* __restrict__ taps, const int* __restrict__ work,
       float* __restrict__ part, float* __restrict__ out, int G, int PH,
       int B, int Hs, int Ws, int CIN, int T, int COUT, int QH, int QW) {
  __shared__ __align__(16) tile::Tiles<BM, BN, E> sm;
  const int g = blockIdx.z % G;
  const int* e = work + 4 * (blockIdx.z / G);
  const int p = e[0], slot = e[3];
  const size_t plane_out = (size_t)B * QH * QW * COUT;
  float* dst = slot < 0 ? out + ((size_t)g * PH + p) * plane_out
                        : part + ((size_t)slot * G + g) * plane_out;
  tile::run<BM, BN, TM, TN, VEC_A, VEC_B, true>(
      sm, src + (size_t)g * B * Hs * Ws * CIN, 0,
      w + ((size_t)g * PH + p) * T * CIN * COUT, taps + 3 * p * T, T, B, Hs,
      Ws, CIN, COUT, QH, QW, blockIdx.x * BM, blockIdx.y * BN, e[1], e[2],
      dst);
}

template <typename E>
using KernelFn = void (*)(const E*, const E*, const int*, const int*, float*,
                          float*, int, int, int, int, int, int, int, int, int,
                          int);

// The plan's variants (kernels/tap_gemm.py: PHASED_TILES): 64 x 64 with
// 8 x 8 a thread; 64 x 16 with 4 x 4 (COUT <= 16); 128 x 8 with 2 x 8
// (COUT <= 8).
enum Variant { WIDE = 0, NARROW = 1, TALL = 2 };
constexpr int rows(int v) { return v == TALL ? 128 : 64; }
constexpr int cols(int v) { return v == WIDE ? 64 : v == NARROW ? 16 : 8; }

template <typename E, bool VEC_A, bool VEC_B>
KernelFn<E> pick(int variant) {
  switch (variant) {
    case WIDE:
      return &kernel<E, 64, 64, 8, 8, VEC_A, VEC_B>;
    case NARROW:
      return &kernel<E, 64, 16, 4, 4, VEC_A, VEC_B>;
    case TALL:
      return &kernel<E, 128, 8, 2, 8, VEC_A, VEC_B>;
  }
  return nullptr;
}
// nullptr for an unknown variant.
template <typename E>
KernelFn<E> pick(int variant, bool vec_a, bool vec_b) {
  return vec_a ? (vec_b ? pick<E, true, true>(variant)
                        : pick<E, true, false>(variant))
               : (vec_b ? pick<E, false, true>(variant)
                        : pick<E, false, false>(variant));
}

}  // namespace phased

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

template <int BN, typename E>
struct Tiles {
  E a[2][BK][BM];  // [stage][pixel][row]
  E b[2][BK][BN];  // [stage][pixel][cout]
};

// part[z, r, n] = sum over the pixels l of split s of
//   src[g, p_t, b, oh + du_t, ow + dv_t, c] * dy[g, l, n],
// r = t * CIN + c, z = s * G + g (zero past the plane).  part holds
// (splits, G, T*CIN, COUT) partials, or the output when there is one
// split.  A BM x BN tile, TM x TN outputs per thread.  E is the operands'
// element (float or __nv_bfloat16); products and sums are float32.  VEC_A:
// CIN % 4 == 0 and src aligned to four elements, so a channel quad never
// straddles a tap; VEC_B: COUT % 4 == 0, dy aligned to four elements and
// part 16-byte aligned.
// grid = (cdiv(T*CIN, BM) * cdiv(COUT, BN), 1, splits * G).
template <typename E, int BN, int TM, int TN, bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(THREADS)
kernel(const E* __restrict__ src, const E* __restrict__ dy,
       const int* __restrict__ taps, float* __restrict__ part, int G, int P,
       int B, int Hs, int Ws, int CIN, int T, int COUT, int OH, int OW,
       int chunk) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "TM x TN per thread");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 fragments");
  __shared__ __align__(16) Tiles<BN, E> sm;
  const int tid = threadIdx.x;
  const int col_tiles = cdiv(COUT, BN);
  const int r0 = (blockIdx.x / col_tiles) * BM;
  const int n0 = (blockIdx.x % col_tiles) * BN;
  const int g = blockIdx.z % G, split = blockIdx.z / G;
  const int R = T * CIN, L = B * OH * OW;
  const int l_begin = split * chunk, l_end = min(L, l_begin + chunk);
  const size_t plane = (size_t)B * Hs * Ws * CIN;
  const E* src_g = src + (size_t)g * P * plane;
  const E* dy_g = dy + (size_t)g * L * COUT;

  // The A rows this thread fills, fixed for the whole walk: the quad
  // r0 + 4 (tid % 16) + [0, 4) of pixels 4 (tid / 16) + [0, 4) of each
  // step.  Their taps are decoded once: with VEC_A the quad lies in one
  // tap (one copy of four elements a pixel); otherwise each row has its own
  // (four one-element copies a pixel).
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
      E* d = &sm.a[st][(tid / 16) * 4 + j][(tid % 16) * 4];
#pragma unroll
      for (int q = 0; q < AQ; ++q) {
        const bool ok = a_ok[q] && p.l < l_end && p.oh + du[q] < Hs &&
                        p.ow + dv[q] < Ws;
        const E* s = ok ? src_g + a_tap[q] + pix : src_g;
        if constexpr (VEC_A)
          elem::copy4(d, s, ok);
        else
          elem::copy1(d + q, s, ok);
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
        elem::copy4(&sm.b[st][e][(tid % QB) * 4],
                    ok ? dy_g + (size_t)l * COUT + n : dy_g, ok);
      }
    } else {
      const int n = n0 + tid % BN;
#pragma unroll
      for (int j = 0; j < BK * BN / THREADS; ++j) {
        const int e = tid / BN + (THREADS / BN) * j, l = l0 + e;
        const bool ok = l < l_end && n < COUT;
        elem::copy1(&sm.b[st][e][tid % BN],
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
        const float4 v = elem::load4(&sm.a[st][e][h * RS + ty * 4]);
        a[4 * h] = v.x;
        a[4 * h + 1] = v.y;
        a[4 * h + 2] = v.z;
        a[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v = elem::load4(&sm.b[st][e][h * CS + tx * 4]);
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

template <typename E>
using KernelFn = void (*)(const E*, const E*, const int*, float*, int, int,
                          int, int, int, int, int, int, int, int, int);

// The two tiles: 64 x 64 with 8 x 8 per thread and, for COUT <= 16,
// 64 x 16 with 4 x 4 per thread.
constexpr int BN_WIDE = 64, BN_NARROW = 16;

template <typename E, bool VEC_A, bool VEC_B>
KernelFn<E> pick(bool narrow) {
  return narrow ? &kernel<E, BN_NARROW, 4, 4, VEC_A, VEC_B>
                : &kernel<E, BN_WIDE, 8, 8, VEC_A, VEC_B>;
}
template <typename E>
KernelFn<E> pick(bool narrow, bool vec_a, bool vec_b) {
  return vec_a ? (vec_b ? pick<E, true, true>(narrow)
                        : pick<E, true, false>(narrow))
               : (vec_b ? pick<E, false, true>(narrow)
                        : pick<E, false, false>(narrow));
}

}  // namespace wgrad

// ---------------------------------------------------------------------------
// Depthwise (one channel a group): the forward, the input grad and the
// weight grad without tiles, one thread a 16-byte vector of outputs or
// pixels
// ---------------------------------------------------------------------------
//
// At CIN = COUT = 1 the packed tiles above keep one column of 64 (the
// forward), 8 (the input grad) or 16 (the weight grad) and run a
// contraction of T rows (the forward, the input grad) or walk every pixel
// for a 4 x 1 corner (the weight grad), and the bfloat16 rows move by
// plain 2-byte loads.  The passes are bound by bytes there (Mamba2's
// conv: ~1 FLOP a byte), so these kernels read each operand in 16-byte
// vectors and do the T taps' arithmetic in registers:
//   * dw::fwd_kernel: thread n computes V = 16 bytes of outputs (4 float32,
//     8 bfloat16) along ow of one (group, b, oh) row; grid x is the flat
//     (group, b, oh, vector) index, so no grid limit binds the group count.
//     The group's T tap weights sit in registers, loaded once; taps are
//     summed in tap order in float32 (fmaf) and the sum is rounded once to
//     the operands' type and stored: no float32 plane, no cast pass.
//   * dw::phased_kernel: the input grad, still the transposed mode
//     (Algorithm 1): stride phase p of dX is a depthwise conv over the
//     padded compact dY with phase p's rotated taps, so each thread is the
//     forward's, over the flat (group, phase, b, oh, vector) index, and
//     sums the taps of its own phase (every phase's rows, concatenated,
//     are one table; a phase without taps stores zeros).  All phases run
//     in one launch and no phase splits.
//   * dw::wgrad_kernel: block (split, group); its threads stride over the
//     split's vectors of pixels, read dY's V values and each tap's source
//     window, and keep T float32 sums in registers; a fixed-order block
//     reduction (warp shuffles in a fixed tree, then the warps in index
//     order) writes one partial a split, summed by splitk::reduce.
// A window of V source elements at any column is read as the one or two
// aligned 16-byte vectors that hold it, shifted into place in registers
// (funnel shifts), so rows of any width and sources at any offset take
// vector loads; a window that runs past either end of its row is read
// element by element, masked.  The tap table is a kernel parameter (the
// constant bank), so no tap costs a dependent load.  Taps are general (plane, du, dv) rows, so
// strided and 2-D depthwise convs run too.  TCAP is the instance's tap
// capacity (SMALL_TAPS or MAX_TAPS registers of weights or sums).

namespace dw {

constexpr int THREADS = 128;
constexpr int SMALL_TAPS = 16;  // 1-D convs up to 16 taps, 3 x 3, 4 x 4
constexpr int MAX_TAPS = 49;    // 7 x 7 (kernels/tap_gemm.py: DW_MAX_TAPS)
// The input grad's phases (strides up to 8 x 8; kernels/tap_gemm.py:
// DW_MAX_PHASES): with the table's rows, an 848-byte kernel parameter.
constexpr int MAX_PHASES = 64;

// Elements of E in a 16-byte vector.
template <typename E>
__host__ __device__ constexpr int vec() {
  return 16 / (int)sizeof(E);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The tap table, (p, du, dv) rows, passed by value: the kernels read it
// from the constant bank, with no load on their critical path.
struct Taps {
  int v[3 * MAX_TAPS];
};

// The input grad's table: every phase's (j, du, dv) rows, phase after
// phase; phase p's are rows [start[p], start[p + 1]).
struct PhasedTaps {
  Taps rows;
  int start[MAX_PHASES + 1];
};

// The four words of V elements of E that start OFF elements into the two
// 16-byte vectors w[0..3], w[4..7].
template <int OFF, typename E>
__device__ __forceinline__ void extract(const uint32_t (&w)[8],
                                        uint32_t (&v)[4]) {
  constexpr int EPW = 4 / (int)sizeof(E);  // elements a 32-bit word
  constexpr int K = OFF / EPW, SH = (OFF % EPW) * 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = SH ? __funnelshift_r(w[K + i], w[K + i + 1], SH) : w[K + i];
}

// extract<off> for a runtime off in [0, V): the threads of a warp that read
// one row share it, so the branch does not diverge there.
template <typename E>
__device__ __forceinline__ void shift(const uint32_t (&w)[8], int off,
                                      uint32_t (&v)[4]) {
  switch (off) {
    case 0: extract<0, E>(w, v); break;
    case 1: extract<1, E>(w, v); break;
    case 2: extract<2, E>(w, v); break;
    case 3: extract<3, E>(w, v); break;
    default:
      if constexpr (vec<E>() == 8) {
        switch (off) {
          case 4: extract<4, E>(w, v); break;
          case 5: extract<5, E>(w, v); break;
          case 6: extract<6, E>(w, v); break;
          default: extract<7, E>(w, v); break;
        }
      }
  }
}

// Four words of packed elements as float32 (a bfloat16 is the high half of
// its float32).
__device__ __forceinline__ void unpack(const uint32_t (&v)[4],
                                       float (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(v[i]);
}
__device__ __forceinline__ void unpack(const uint32_t (&v)[4],
                                       float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(v[i] << 16);
    x[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}

// x[j] = row[col + j] as float32 for j < V, zero at and past column ws (the
// row's end).  A window inside the row is read as the one or two aligned
// 16-byte vectors that hold it (aligned on the address, not on the row),
// shifted into place in registers; one that runs past either end of the
// row is read element by element, masked.
template <typename E>
__device__ __forceinline__ void window(const E* __restrict__ row, int ws,
                                       int col, float (&x)[vec<E>()]) {
  constexpr int V = vec<E>();
  const uintptr_t a = (uintptr_t)row + (uintptr_t)col * sizeof(E);
  const uintptr_t lo = a & ~(uintptr_t)15;
  const int off = (int)(a - lo) / (int)sizeof(E);
  const uintptr_t end = (uintptr_t)row + (uintptr_t)ws * sizeof(E);
  if (col < ws && lo >= (uintptr_t)row && lo + (off ? 32 : 16) <= end) {
    uint32_t w[8];
    const uint4 c0 = __ldg(reinterpret_cast<const uint4*>(lo));
    const uint4 c1 = off ? __ldg(reinterpret_cast<const uint4*>(lo + 16))
                         : make_uint4(0, 0, 0, 0);
    w[0] = c0.x, w[1] = c0.y, w[2] = c0.z, w[3] = c0.w;
    w[4] = c1.x, w[5] = c1.y, w[6] = c1.z, w[7] = c1.w;
    uint32_t v[4];
    shift<E>(w, off, v);
    unpack(v, x);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      x[j] = col + j < ws ? to_float(row[col + j]) : 0.f;
  }
}

// V float32 values as the 16 bytes of their E (bfloat16: rounded to
// nearest even, the lower address's element in the low half).
__device__ __forceinline__ uint4 pack(const float (&y)[4]) {
  return make_uint4(__float_as_uint(y[0]), __float_as_uint(y[1]),
                    __float_as_uint(y[2]), __float_as_uint(y[3]));
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint4 pack(const float (&y)[8]) {
  return make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]), pack2(y[4], y[5]),
                    pack2(y[6], y[7]));
}

// row[col + j] = y[j] rounded to E for col + j < ow: one 16-byte store when
// the vector is aligned and inside the row, else element by element.
template <typename E>
__device__ __forceinline__ void store(E* __restrict__ row, int ow, int col,
                                      const float (&y)[vec<E>()]) {
  constexpr int V = vec<E>();
  E* a = row + col;
  if ((uintptr_t)a % 16 == 0 && col + V <= ow) {
    *reinterpret_cast<uint4*>(a) = pack(y);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (col + j < ow) from_float(a + j, y[j]);
  }
}

// acc[j] += wt[t] * src_b[p_t * plane + (oh + du_t) * Ws + col + dv_t + j]
// for the rows t in [t0, t1) of `taps`, (p, du, dv), in row order, with
// fmaf; a source row at or past Hs, or a column at or past Ws, reads zero.
// src_b is one (group, b) image of Hs x Ws; the forward's planes lie
// `plane` elements apart, the input grad reads its one source (plane 0,
// so the rows' first column, there a weight slot, moves nothing).
template <typename E, int TCAP>
__device__ __forceinline__ void sum_taps(const E* __restrict__ src_b,
                                         size_t plane, const Taps& taps,
                                         int t0, int t1,
                                         const float (&wt)[TCAP], int oh,
                                         int Hs, int Ws, int col,
                                         float (&acc)[vec<E>()]) {
  constexpr int V = vec<E>();
#pragma unroll
  for (int t = 0; t < TCAP; ++t) {
    if (t >= t1) break;
    if (t < t0) continue;
    const int p = taps.v[3 * t], du = taps.v[3 * t + 1],
              dv = taps.v[3 * t + 2];
    if (oh + du >= Hs) continue;
    float x[V];
    window(src_b + p * plane + (size_t)(oh + du) * Ws, Ws, col + dv, x);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = fmaf(x[j], wt[t], acc[j]);
  }
}

// out[g, b, oh, ow] = sum over t < T of w[g, t] *
//   src[g, p_t, b, oh + du_t, ow + dv_t] (zero past the Hs x Ws plane), in
// the operands' type.  src (G, P, B, Hs, Ws), w (G, T), out (G, B, OH, OW),
// taps T rows (p, du, dv).  Thread n of `total` = G * B * OH * NV (NV =
// cdiv(OW, V)) computes outputs [V v, V v + V) of its row (32-bit index
// arithmetic where `total` fits it).
template <typename E, int TCAP>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const E* __restrict__ src, const E* __restrict__ w,
           const __grid_constant__ Taps taps, E* __restrict__ out, int P,
           int B, int Hs, int Ws, int T, int OH, int OW, long long total) {
  constexpr int V = vec<E>();
  const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (n >= total) return;
  const int NV = cdiv(OW, V);
  int v, oh, b;
  long long gb;  // g * B + b
  if (total <= 0xffffffffLL) {
    const unsigned n32 = (unsigned)n, q = n32 / NV, gb32 = q / OH;
    v = (int)(n32 - q * NV);
    oh = (int)(q - gb32 * OH);
    b = (int)(gb32 % B);
    gb = gb32;
  } else {
    const long long q = n / NV;
    v = (int)(n - q * NV);
    oh = (int)(q % OH);
    gb = q / OH;
    b = (int)(gb % B);
  }
  const long long g = gb / B;
  float wt[TCAP];
#pragma unroll
  for (int t = 0; t < TCAP; ++t)
    wt[t] = t < T ? to_float(w[g * T + t]) : 0.f;
  const size_t plane = (size_t)B * Hs * Ws;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  sum_taps(src + (size_t)g * P * plane + (size_t)b * Hs * Ws, plane, taps,
           0, T, wt, oh, Hs, Ws, v * V, acc);
  store(out + ((size_t)gb * OH + oh) * OW, OW, v * V, acc);
}

// out[g, p, b, oh, ow] = sum over the rows t of phase p, [start[p],
// start[p + 1]) of taps.rows, (j, du, dv), of w[g, p, j] *
//   src[g, b, oh + du, ow + dv] (zero past the Hs x Ws plane), in the
// operands' type; a phase without rows stores zeros.  src (G, B, Hs, Ws)
// is the padded compact dY, w (G, PH, T) the per-phase tap weights, out
// (G, PH, B, OH, OW).  Thread n of `total` = G * PH * B * OH * NV (NV =
// cdiv(OW, V)) computes outputs [V v, V v + V) of its row, walking the
// whole table (TCAP rows, unrolled, so each row is a constant-bank read)
// and summing its phase's rows; the threads of a warp share a phase but
// at a phase's end.
template <typename E, int TCAP>
__global__ void __launch_bounds__(THREADS)
phased_kernel(const E* __restrict__ src, const E* __restrict__ w,
              const __grid_constant__ PhasedTaps taps, E* __restrict__ out,
              int PH, int B, int Hs, int Ws, int T, int OH, int OW,
              long long total) {
  constexpr int V = vec<E>();
  const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (n >= total) return;
  const int NV = cdiv(OW, V);
  int v, oh, b, p;
  long long gpb;  // (g * PH + p) * B + b
  if (total <= 0xffffffffLL) {
    const unsigned n32 = (unsigned)n, q = n32 / NV, gpb32 = q / OH;
    v = (int)(n32 - q * NV);
    oh = (int)(q - gpb32 * OH);
    b = (int)(gpb32 % B);
    p = (int)(gpb32 / B % PH);
    gpb = gpb32;
  } else {
    const long long q = n / NV;
    v = (int)(n - q * NV);
    oh = (int)(q % OH);
    gpb = q / OH;
    b = (int)(gpb % B);
    p = (int)(gpb / B % PH);
  }
  const long long gp = gpb / B, g = gp / PH;
  const int t0 = taps.start[p], t1 = taps.start[p + 1];
  const E* w_gp = w + gp * T;
  float wt[TCAP];
#pragma unroll
  for (int t = 0; t < TCAP; ++t)
    wt[t] = t >= t0 && t < t1 ? to_float(w_gp[taps.rows.v[3 * t]]) : 0.f;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  sum_taps(src + ((size_t)g * B + b) * Hs * Ws, 0, taps.rows, t0, t1, wt,
           oh, Hs, Ws, v * V, acc);
  store(out + ((size_t)gpb * OH + oh) * OW, OW, v * V, acc);
}

// part[s, g, t] = sum over the vectors u of split s (u in [s chunk,
// min(U, s chunk + chunk)), U = B * OH * NV) of
//   sum over j < V of src[g, p_t, b, oh + du_t, ow + dv_t] * dy[g, b, oh, ow]
// with ow = V v + j < OW (zero past the plane).  src (G, P, B, Hs, Ws), dy
// (G, B, OH, OW); part (splits, G, T) float32, the output when there is one
// split.  grid = splits * G blocks, block z = s * G + g.
template <typename E, int TCAP>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const E* __restrict__ src, const E* __restrict__ dy,
             const Taps taps, float* __restrict__ part, int G, int P, int B,
             int Hs, int Ws, int T, int OH, int OW, int chunk) {
  constexpr int V = vec<E>();
  constexpr int WARPS = THREADS / 32;
  __shared__ float red[TCAP][WARPS];
  const int g = (int)(blockIdx.x % G), split = (int)(blockIdx.x / G);
  const int NV = cdiv(OW, V);
  const long long U = (long long)B * OH * NV;
  const long long u0 = (long long)split * chunk;
  const long long u1 = min(U, u0 + chunk);
  const size_t plane = (size_t)B * Hs * Ws;
  const E* src_g = src + (size_t)g * P * plane;
  const E* dy_g = dy + (size_t)g * B * OH * OW;
  float acc[TCAP];
#pragma unroll
  for (int t = 0; t < TCAP; ++t) acc[t] = 0.f;
  for (long long u = u0 + threadIdx.x; u < u1; u += THREADS) {
    const int v = (int)(u % NV), q = (int)(u / NV);
    const int oh = q % OH, b = q / OH;
    float y[V];
    window(dy_g + (size_t)q * OW, OW, v * V, y);
#pragma unroll
    for (int t = 0; t < TCAP; ++t) {
      if (t >= T) break;
      const int p = taps.v[3 * t], du = taps.v[3 * t + 1],
                dv = taps.v[3 * t + 2];
      if (oh + du >= Hs) continue;
      float x[V];
      window(src_g + p * plane + ((size_t)b * Hs + oh + du) * Ws, Ws,
             v * V + dv, x);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[t] = fmaf(x[j], y[j], acc[t]);
    }
  }
  // Fixed order: a shuffle tree in each warp, then the warps in order.
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int t = 0; t < TCAP; ++t) {
    if (t >= T) break;
    float s = acc[t];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) red[t][warp] = s;
  }
  __syncthreads();
  if ((int)threadIdx.x < T) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += red[threadIdx.x][k];
    part[(size_t)blockIdx.x * T + threadIdx.x] = s;
  }
}

template <typename E>
using FwdFn = void (*)(const E*, const E*, const Taps, E*, int, int, int,
                       int, int, int, int, long long);
template <typename E>
using PhasedFn = void (*)(const E*, const E*, const PhasedTaps, E*, int, int,
                          int, int, int, int, int, long long);
template <typename E>
using WgradFn = void (*)(const E*, const E*, const Taps, float*, int, int,
                         int, int, int, int, int, int, int);

// The host's T rows (p, du, dv) as a kernel parameter.
inline Taps taps_of(const int* rows, int T) {
  Taps t = {};
  for (int i = 0; i < 3 * T; ++i) t.v[i] = rows[i];
  return t;
}

// The host's table of PH phases, phase p's rows [start[p], start[p + 1])
// of `rows`, as a kernel parameter.
inline PhasedTaps phased_taps_of(const int* rows, const int* start, int PH) {
  PhasedTaps t = {};
  t.rows = taps_of(rows, start[PH]);
  for (int p = 0; p <= PH; ++p) t.start[p] = start[p];
  return t;
}

// The instance for T taps: SMALL_TAPS or MAX_TAPS registers.
template <typename E>
FwdFn<E> fwd(bool wide) {
  return wide ? &fwd_kernel<E, MAX_TAPS> : &fwd_kernel<E, SMALL_TAPS>;
}
template <typename E>
PhasedFn<E> phased(bool wide) {
  return wide ? &phased_kernel<E, MAX_TAPS> : &phased_kernel<E, SMALL_TAPS>;
}
template <typename E>
WgradFn<E> wgrad(bool wide) {
  return wide ? &wgrad_kernel<E, MAX_TAPS> : &wgrad_kernel<E, SMALL_TAPS>;
}

}  // namespace dw

// ---------------------------------------------------------------------------
// The entries' bodies, for either operand element
// ---------------------------------------------------------------------------

// True when p is aligned to four elements of E (a copy4 source).
template <typename E>
bool quad_aligned(const void* p) {
  return (uintptr_t)p % (4 * sizeof(E)) == 0;
}

template <typename E>
cudaError_t forward(const E* src, const E* w, const int* taps, float* part,
                    float* out, int G, int P, int B, int Hs, int Ws, int CIN,
                    int T, int COUT, int OH, int OW, int splits,
                    cudaStream_t stream) {
  const int chunk = cdiv(cdiv(T * CIN, splits), tile::BK) * tile::BK;
  const bool vec_a = CIN % 4 == 0 && quad_aligned<E>(src);
  const bool vec_b =
      COUT % 4 == 0 && quad_aligned<E>(w) && (uintptr_t)part % 16 == 0;
  auto run = vec_a ? (vec_b ? &fwd::launch<E, true, true>
                            : &fwd::launch<E, true, false>)
                   : (vec_b ? &fwd::launch<E, false, true>
                            : &fwd::launch<E, false, false>);
  cudaError_t err = run(src, w, taps, part, G, P, B, Hs, Ws, CIN, T, COUT,
                        OH, OW, splits, chunk, stream);
  if (err != cudaSuccess || splits == 1) return err;
  return splitk::reduce(part, out, (size_t)G * B * OH * OW * COUT, splits,
                        stream);
}

template <typename E>
cudaError_t input_grad(const E* src, const E* w, const int* taps,
                       const int* work, int n_work, const int* sums,
                       int n_sums, float* part, float* out, int G, int PH,
                       int B, int Hs, int Ws, int CIN, int T, int COUT,
                       int QH, int QW, int variant, cudaStream_t stream) {
  const bool vec_a = CIN % 4 == 0 && quad_aligned<E>(src);
  const bool vec_b = COUT % 4 == 0 && quad_aligned<E>(w) &&
                     ((uintptr_t)part | (uintptr_t)out) % 16 == 0;
  const phased::KernelFn<E> kernel = phased::pick<E>(variant, vec_a, vec_b);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const int M = B * QH * QW;
  const dim3 grid(cdiv(M, phased::rows(variant)),
                  cdiv(COUT, phased::cols(variant)), n_work * G);
  kernel<<<grid, tile::THREADS, 0, stream>>>(src, w, taps, work, part, out, G,
                                             PH, B, Hs, Ws, CIN, T, COUT, QH,
                                             QW);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_sums == 0) return err;
  return splitk::reduce_planes(part, out, sums, n_sums, (size_t)M * COUT, G,
                               PH, stream);
}

template <typename E>
cudaError_t weight_grad(const E* src, const E* dy, const int* taps,
                        float* part, float* out, int G, int P, int B, int Hs,
                        int Ws, int CIN, int T, int COUT, int OH, int OW,
                        int narrow, int splits, cudaStream_t stream) {
  const int L = B * OH * OW;
  const int chunk = cdiv(cdiv(L, splits), wgrad::BK) * wgrad::BK;
  const bool vec_a = CIN % 4 == 0 && quad_aligned<E>(src);
  const bool vec_b =
      COUT % 4 == 0 && quad_aligned<E>(dy) && (uintptr_t)part % 16 == 0;
  const int cols = narrow ? wgrad::BN_NARROW : wgrad::BN_WIDE;
  const dim3 grid(cdiv(T * CIN, wgrad::BM) * cdiv(COUT, cols), 1,
                  splits * G);
  const wgrad::KernelFn<E> kernel = wgrad::pick<E>(narrow, vec_a, vec_b);
  kernel<<<grid, wgrad::THREADS, 0, stream>>>(src, dy, taps, part, G, P, B,
                                              Hs, Ws, CIN, T, COUT, OH, OW,
                                              chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return splitk::reduce(part, out, (size_t)G * T * CIN * COUT, splits,
                        stream);
}

template <typename E>
cudaError_t dw_forward(const E* src, const E* w, const int* taps, E* out,
                       int G, int P, int B, int Hs, int Ws, int T, int OH,
                       int OW, cudaStream_t stream) {
  if (T < 1 || T > dw::MAX_TAPS) return cudaErrorInvalidValue;
  const long long total = (long long)G * B * OH * cdiv(OW, dw::vec<E>());
  const long long blocks = (total + dw::THREADS - 1) / dw::THREADS;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const dw::FwdFn<E> kernel = dw::fwd<E>(T > dw::SMALL_TAPS);
  kernel<<<(unsigned)blocks, dw::THREADS, 0, stream>>>(
      src, w, dw::taps_of(taps, T), out, P, B, Hs, Ws, T, OH, OW, total);
  return cudaGetLastError();
}

// `rows` and `start` are host memory: the table the wrapper built, checked
// here (phase starts from 0, not decreasing, at most MAX_TAPS rows in all,
// weight slots j in [0, T)) before it becomes the kernel's parameter.
template <typename E>
cudaError_t dw_input_grad(const E* src, const E* w, const int* rows,
                          const int* start, E* out, int G, int PH, int B,
                          int Hs, int Ws, int T, int OH, int OW,
                          cudaStream_t stream) {
  if (PH < 1 || PH > dw::MAX_PHASES || start[0] != 0 ||
      start[PH] > dw::MAX_TAPS)
    return cudaErrorInvalidValue;
  for (int p = 0; p < PH; ++p)
    if (start[p + 1] < start[p]) return cudaErrorInvalidValue;
  for (int t = 0; t < start[PH]; ++t)
    if (rows[3 * t] < 0 || rows[3 * t] >= T || rows[3 * t + 1] < 0 ||
        rows[3 * t + 2] < 0)
      return cudaErrorInvalidValue;
  const long long total =
      (long long)G * PH * B * OH * cdiv(OW, dw::vec<E>());
  const long long blocks = (total + dw::THREADS - 1) / dw::THREADS;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const dw::PhasedFn<E> kernel = dw::phased<E>(start[PH] > dw::SMALL_TAPS);
  kernel<<<(unsigned)blocks, dw::THREADS, 0, stream>>>(
      src, w, dw::phased_taps_of(rows, start, PH), out, PH, B, Hs, Ws, T, OH,
      OW, total);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dw_weight_grad(const E* src, const E* dy, const int* taps,
                           float* part, float* out, int G, int P, int B,
                           int Hs, int Ws, int T, int OH, int OW, int splits,
                           cudaStream_t stream) {
  if (T < 1 || T > dw::MAX_TAPS || splits < 1) return cudaErrorInvalidValue;
  const long long units = (long long)B * OH * cdiv(OW, dw::vec<E>());
  const long long chunk = (units + splits - 1) / splits;
  const long long blocks = (long long)G * splits;
  if (blocks > INT32_MAX || chunk > INT32_MAX) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const dw::WgradFn<E> kernel = dw::wgrad<E>(T > dw::SMALL_TAPS);
  kernel<<<(unsigned)blocks, dw::THREADS, 0, stream>>>(
      src, dy, dw::taps_of(taps, T), part, G, P, B, Hs, Ws, T, OH, OW,
      (int)chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return splitk::reduce(part, out, (size_t)G * T, splits, stream);
}

}  // namespace

// Each kernel has a float32 entry and a bfloat16 one (`_bf16`: src, w and
// dy read as bfloat16); both write float32, but for the depthwise forward
// and input grad.
extern "C" {

// `part` holds splits * G*M*COUT floats (M = B*OH*OW); with splits == 1 it
// may alias `out` and the reduction is skipped.
int tap_gemm_f32(const float* src, const float* w, const int* taps,
                 float* part, float* out, int G, int P, int B, int Hs,
                 int Ws, int CIN, int T, int COUT, int OH, int OW,
                 int splits, cudaStream_t stream) {
  return (int)forward(src, w, taps, part, out, G, P, B, Hs, Ws, CIN, T, COUT,
                      OH, OW, splits, stream);
}
int tap_gemm_bf16(const __nv_bfloat16* src, const __nv_bfloat16* w,
                  const int* taps, float* part, float* out, int G, int P,
                  int B, int Hs, int Ws, int CIN, int T, int COUT, int OH,
                  int OW, int splits, cudaStream_t stream) {
  return (int)forward(src, w, taps, part, out, G, P, B, Hs, Ws, CIN, T, COUT,
                      OH, OW, splits, stream);
}

// taps: (PH, T, 3) rows (j, du, dv); work: n_work rows (phase, k_begin,
// k_end, slot) from the wrapper's plan; sums: n_sums rows (phase, first
// slot, count) of the phases that split, whose partials `part` holds
// (slots, G, M, COUT) (M = B*QH*QW; not read when n_sums == 0).  variant:
// 0 the 64 x 64 tile, 1 the 64 x 16 tile (COUT <= 16), 2 the 128 x 8 tile
// (COUT <= 8).
int tap_gemm_phased_f32(const float* src, const float* w, const int* taps,
                        const int* work, int n_work, const int* sums,
                        int n_sums, float* part, float* out, int G, int PH,
                        int B, int Hs, int Ws, int CIN, int T, int COUT,
                        int QH, int QW, int variant, cudaStream_t stream) {
  return (int)input_grad(src, w, taps, work, n_work, sums, n_sums, part, out,
                         G, PH, B, Hs, Ws, CIN, T, COUT, QH, QW, variant,
                         stream);
}
int tap_gemm_phased_bf16(const __nv_bfloat16* src, const __nv_bfloat16* w,
                         const int* taps, const int* work, int n_work,
                         const int* sums, int n_sums, float* part, float* out,
                         int G, int PH, int B, int Hs, int Ws, int CIN, int T,
                         int COUT, int QH, int QW, int variant,
                         cudaStream_t stream) {
  return (int)input_grad(src, w, taps, work, n_work, sums, n_sums, part, out,
                         G, PH, B, Hs, Ws, CIN, T, COUT, QH, QW, variant,
                         stream);
}

// Blocks of one input-grad instance an SM holds (registers and shared
// memory), which the plan in kernels/tap_gemm.py assumes; bf16 != 0 for
// the bfloat16 instance.
int tap_gemm_phased_blocks_per_sm(int variant, int bf16, int vec_a, int vec_b,
                                  int* blocks) {
  if (bf16) {
    const auto kernel = phased::pick<__nv_bfloat16>(variant, vec_a, vec_b);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, tile::THREADS, 0);
  }
  const auto kernel = phased::pick<float>(variant, vec_a, vec_b);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, tile::THREADS, 0);
}

// `part` holds splits * G*T*CIN*COUT floats; with splits == 1 it may alias
// `out` and the reduction is skipped.  narrow != 0 takes the 64 x 16 tile
// (COUT <= 16), else the 64 x 64 tile.
int tap_wgrad_f32(const float* src, const float* dy, const int* taps,
                  float* part, float* out, int G, int P, int B, int Hs,
                  int Ws, int CIN, int T, int COUT, int OH, int OW,
                  int narrow, int splits, cudaStream_t stream) {
  return (int)weight_grad(src, dy, taps, part, out, G, P, B, Hs, Ws, CIN, T,
                          COUT, OH, OW, narrow, splits, stream);
}
int tap_wgrad_bf16(const __nv_bfloat16* src, const __nv_bfloat16* dy,
                   const int* taps, float* part, float* out, int G, int P,
                   int B, int Hs, int Ws, int CIN, int T, int COUT, int OH,
                   int OW, int narrow, int splits, cudaStream_t stream) {
  return (int)weight_grad(src, dy, taps, part, out, G, P, B, Hs, Ws, CIN, T,
                          COUT, OH, OW, narrow, splits, stream);
}

// Blocks of one weight-grad instance an SM holds (registers and shared
// memory), which the plan in kernels/tap_gemm.py assumes; bf16 != 0 for
// the bfloat16 instance.
int tap_wgrad_blocks_per_sm(int narrow, int bf16, int vec_a, int vec_b,
                            int* blocks) {
  if (bf16)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, wgrad::pick<__nv_bfloat16>(narrow, vec_a, vec_b),
        wgrad::THREADS, 0);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, wgrad::pick<float>(narrow, vec_a, vec_b), wgrad::THREADS, 0);
}

// The depthwise variant (CIN = COUT = 1 a group, 1 <= T <= 49 taps):
// src (G, P, B, Hs, Ws), w (G, T); out (G, B, OH, OW) in the operands'
// type (bfloat16 rounded once from the float32 sum).  `taps` is HOST
// memory here: T rows (p, du, dv), passed to the kernel by value.
int tap_gemm_dw_f32(const float* src, const float* w, const int* taps,
                    float* out, int G, int P, int B, int Hs, int Ws, int T,
                    int OH, int OW, cudaStream_t stream) {
  return (int)dw_forward(src, w, taps, out, G, P, B, Hs, Ws, T, OH, OW,
                         stream);
}
int tap_gemm_dw_bf16(const __nv_bfloat16* src, const __nv_bfloat16* w,
                     const int* taps, __nv_bfloat16* out, int G, int P,
                     int B, int Hs, int Ws, int T, int OH, int OW,
                     cudaStream_t stream) {
  return (int)dw_forward(src, w, taps, out, G, P, B, Hs, Ws, T, OH, OW,
                         stream);
}

// The depthwise input grad (CIN = COUT = 1 a group): src (G, B, Hs, Ws)
// padded compact dY, w (G, PH, T) per-phase tap weights; out (G, PH, B, OH,
// OW) in the operands' type, every phase written (zeros for a phase
// without taps).  `taps` and `start` are HOST memory: rows (j, du, dv) of
// every phase, concatenated (at most 49), and PH + 1 (PH <= 64) offsets,
// phase p's rows [start[p], start[p + 1]); passed to the kernel by value.
int tap_gemm_phased_dw_f32(const float* src, const float* w, const int* taps,
                           const int* start, float* out, int G, int PH,
                           int B, int Hs, int Ws, int T, int OH, int OW,
                           cudaStream_t stream) {
  return (int)dw_input_grad(src, w, taps, start, out, G, PH, B, Hs, Ws, T,
                            OH, OW, stream);
}
int tap_gemm_phased_dw_bf16(const __nv_bfloat16* src, const __nv_bfloat16* w,
                            const int* taps, const int* start,
                            __nv_bfloat16* out, int G, int PH, int B, int Hs,
                            int Ws, int T, int OH, int OW,
                            cudaStream_t stream) {
  return (int)dw_input_grad(src, w, taps, start, out, G, PH, B, Hs, Ws, T,
                            OH, OW, stream);
}

// dy (G, B, OH, OW); out (G, T) float32.  `part` holds splits * G*T
// floats (splits of the B*OH*cdiv(OW, V) pixel vectors, V = 4 float32 or
// 8 bfloat16); with splits == 1 it may alias `out`.
int tap_wgrad_dw_f32(const float* src, const float* dy, const int* taps,
                     float* part, float* out, int G, int P, int B, int Hs,
                     int Ws, int T, int OH, int OW, int splits,
                     cudaStream_t stream) {
  return (int)dw_weight_grad(src, dy, taps, part, out, G, P, B, Hs, Ws, T,
                             OH, OW, splits, stream);
}
int tap_wgrad_dw_bf16(const __nv_bfloat16* src, const __nv_bfloat16* dy,
                      const int* taps, float* part, float* out, int G, int P,
                      int B, int Hs, int Ws, int T, int OH, int OW,
                      int splits, cudaStream_t stream) {
  return (int)dw_weight_grad(src, dy, taps, part, out, G, P, B, Hs, Ws, T,
                             OH, OW, splits, stream);
}

// Blocks of one depthwise instance an SM holds: the forward (role 0), the
// weight grad (1) or the input grad (2), float32 or bfloat16, for up to 16
// taps or (wide) 49.
int tap_dw_blocks_per_sm(int role, int bf16, int wide, int* blocks) {
  const void* kernel;
  switch (role) {
    case 0:
      kernel = bf16 ? (const void*)dw::fwd<__nv_bfloat16>(wide)
                    : (const void*)dw::fwd<float>(wide);
      break;
    case 1:
      kernel = bf16 ? (const void*)dw::wgrad<__nv_bfloat16>(wide)
                    : (const void*)dw::wgrad<float>(wide);
      break;
    case 2:
      kernel = bf16 ? (const void*)dw::phased<__nv_bfloat16>(wide)
                    : (const void*)dw::phased<float>(wide);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, dw::THREADS, 0);
}

}  // extern "C"
