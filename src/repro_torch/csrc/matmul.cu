// Batched GEMM for Hopper (sm_90a): out[g] = a[g] @ b[g], float32 sums.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul.py (_matmul_kernel
// / matmul): (M, K) @ (K, N) with float32 accumulation and an output of
// `out_dtype or a.dtype`.  Inputs are float32 or bfloat16; the output is
// float32 or bfloat16.  The TPU kernel padded every dimension to 128 and
// took its tile sizes as arguments; here the tiles are fixed per variant
// and ragged edges are masked (cp.async with src-size 0 zero-fills), so no
// operand is padded or copied.  A leading batch dimension G (the groups of
// a grouped conv) is a grid dimension: one launch serves every group.
//
// It is the GEMM under the explicit-im2col baseline ("traditional") and the
// implicit-gather engine ("bp_im2col"): every lowered product of those
// engines runs here.  Their shapes run to both extremes (paper Table II,
// batch 2): (24,642 x 27) @ (27 x 64) for the forward of layer 1,
// (100,352 x 576) @ (576 x 3) for its traditional input grad,
// (3 x 576) @ (576 x 100,352) for its bp_im2col input grad, and
// (27 x 97,682) @ (97,682 x 64) for its weight grad.
//
// What bounds it on an H100: most of these products do 0.1-3 GFLOP against
// 1-60 MB, above the card's float32 ridge (67 TFLOP/s / 3.35 TB/s = 20
// FLOP/byte), so they are bound by float32 operations; the products with
// an edge of 3 (C = 3 at layer 1) or 1 (a depthwise conv) are bound by
// bytes.  So there are four tiles, chosen by the wrapper's plan:
//   * 64 x 64 (gemm::kernel), the forward tap GEMM's design: 64 threads,
//     each with an 8 x 8 register tile (4 FMA per float read from shared
//     memory), a 2-stage shared-memory ring filled by cp.async (16-byte
//     copies along K where K % 4 == 0 and along N where N % 4 == 0, 4-byte
//     copies otherwise), one barrier a step of 16; 18,432 B of shared
//     memory;
//   * 64 x 16, the same with 4 x 4 sums a thread, for 8 < N <= 16: a
//     quarter of the 64 x 64 tile's FMA chain a step, which is what the
//     small GEMMs of the training shapes wait on; 12,288 B;
//   * 128 x 8 (tall::kernel) for N <= 8 and 8 x 128 (mirror::kernel) for
//     M <= 8: 128 threads, one row (column) and 8 sums each, that stream
//     the large operand once through a 2-stage ring in steps of 32
//     (16-byte copies, 128 B of a row per 8 threads) and read the few
//     columns (rows) of the small one as broadcasts; 38,912 B / 34,816 B.
// bfloat16 inputs are converted to float32 as they are staged (plain loads
// and the intrinsics, no cp.async; the 64-row tiles fetch the next step
// into registers, 8 bytes at a time where K or N % 4 == 0, while this one
// computes), so every tile computes in float32.
// No tensor cores and no TF32: the sums are full float32, like the paper's
// FP32 setup.  When the output has too few tiles to fill the card, the
// contraction is split over blocks (split-K): each split writes float32
// partials and a second kernel (splitk_reduce.cuh) sums them in a fixed
// order and converts to the output type.  No atomics, so results are
// identical run to run.
//
// The entry returns cudaGetLastError() right after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "splitk_reduce.cuh"

namespace {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four bfloat16 as float32, by one 8-byte load (p 8-byte aligned).
__device__ __forceinline__ void bf16x4(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  out[0] = lo.x;
  out[1] = lo.y;
  out[2] = hi.x;
  out[3] = hi.y;
}

// One input element into shared memory as float32: float32 by a 4-byte
// cp.async, bfloat16 by a plain load and the intrinsic; zero when !ok.
__device__ __forceinline__ void stage(float* dst, const float* src, bool ok) {
  cp_async4(dst, src, ok);
}
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.f;
}

// Block z = s * G + g sums contraction rows [k_begin, k_end) of group g,
// in `steps` steps of BK.
struct Split {
  int g, k_begin, k_end, steps;
};
__device__ __forceinline__ Split split_of(int G, int K, int chunk, int BK) {
  const int g = blockIdx.z % G, s = blockIdx.z / G;
  const int k_begin = s * chunk, k_end = min(K, k_begin + chunk);
  return {g, k_begin, k_end, k_end > k_begin ? cdiv(k_end - k_begin, BK) : 0};
}

// Each kernel writes dst[z, m, n] (z = s * G + g): float32 partials, or the
// float32 output itself when there is one split.

// ---------------------------------------------------------------------------
// 64 x 64 tiles, 8 x 8 per thread, and 64 x 16 tiles, 4 x 4 per thread
// ---------------------------------------------------------------------------

namespace gemm {

constexpr int BM = 64, BK = 16, THREADS = 64;
constexpr int LDA = BK + 4;  // A row pitch: conflict-free float4 reads

template <int BN>
struct Tiles {
  float a[2][BM][LDA];  // [stage][m][k]
  float b[2][BK][BN];   // [stage][k][n]
};

// BN = 64 (8 x 8 sums a thread) or 16 (4 x 4, for N <= 16).  float32:
// cp.async straight into the ring; VEC_A: K % 4 == 0 and a 16-byte
// aligned (16-byte copies); VEC_B: N % 4 == 0 and b, dst 16-byte aligned.
// bfloat16: each thread fetches its 16 + BN / 4 elements of the next step
// into registers before this step computes, converts them and stores them
// to shared memory after it; VEC_A: K % 4 == 0 and a 8-byte aligned
// (8-byte loads of 4 elements); VEC_B: N % 4 == 0, b 8-byte and dst
// 16-byte aligned.
// grid = (cdiv(M, BM), cdiv(N, BN), splits * G).
template <typename TIn, int BN, bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(THREADS)
kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
       float* __restrict__ dst, int G, int M, int K, int N, int chunk) {
  constexpr bool F32 = sizeof(TIn) == 4;
  constexpr int QB = BN / 4;            // column quads of a B row
  constexpr int EB = BK * BN / THREADS; // B elements a thread stages
  __shared__ __align__(16) Tiles<BN> sm;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const Split sp = split_of(G, K, chunk, BK);
  const TIn* a_g = a + (size_t)sp.g * M * K;
  const TIn* b_g = b + (size_t)sp.g * K * N;

  // Element e of this thread's share of a step, in quads: A row
  // tid / 4 + 16 (e / 4), column (tid % 4) * 4 + e % 4 (e < 16); B row
  // tid / QB + (THREADS / QB) (e / 4), column (tid % QB) * 4 + e % 4.
  auto a_rc = [&](int e, int& r, int& k) {
    r = tid / 4 + 16 * (e / 4);
    k = (tid % 4) * 4 + e % 4;
  };
  auto b_rc = [&](int e, int& kr, int& c) {
    kr = tid / QB + (THREADS / QB) * (e / 4);
    c = (tid % QB) * 4 + e % 4;
  };

  auto load = [&](int st, int k0) {  // float32
    if constexpr (VEC_A) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int r, k;
        a_rc(4 * j, r, k);
        const int m = m0 + r;
        k += k0;
        const bool ok = m < M && k < sp.k_end;
        cp_async16(&sm.a[st][r][(tid % 4) * 4],
                   ok ? a_g + (size_t)m * K + k : a_g, ok);
      }
    } else {
      // Row tid, every column: contiguous in a row of A.
      const int m = m0 + tid;
#pragma unroll
      for (int e = 0; e < BK; ++e) {
        const int k = k0 + e;
        const bool ok = m < M && k < sp.k_end;
        stage(&sm.a[st][tid][e], ok ? a_g + (size_t)m * K + k : a_g, ok);
      }
    }
    if constexpr (VEC_B) {
#pragma unroll
      for (int j = 0; j < EB / 4; ++j) {
        int kr, c;
        b_rc(4 * j, kr, c);
        const int k = k0 + kr, n = n0 + c;
        const bool ok = k < sp.k_end && n < N;
        cp_async16(&sm.b[st][kr][c], ok ? b_g + (size_t)k * N + n : b_g, ok);
      }
    } else {
      // Column tid % BN of rows tid / BN + (THREADS / BN) j.
#pragma unroll
      for (int j = 0; j < EB; ++j) {
        const int kr = tid / BN + (THREADS / BN) * j, c = tid % BN;
        const int k = k0 + kr, n = n0 + c;
        const bool ok = k < sp.k_end && n < N;
        stage(&sm.b[st][kr][c], ok ? b_g + (size_t)k * N + n : b_g, ok);
      }
    }
  };
  float ra[16], rb[EB];  // bfloat16 staging registers
  auto fetch = [&](int k0) {  // bfloat16
    if constexpr (!F32) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int r, k;
        a_rc(4 * j, r, k);
        const int m = m0 + r;
        k += k0;
        const TIn* p = a_g + (size_t)m * K + k;
        if (VEC_A && m < M && k < sp.k_end) {
          bf16x4(p, &ra[4 * j]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            ra[4 * j + c] = m < M && k + c < sp.k_end ? to_f32(p[c]) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < EB / 4; ++j) {
        int kr, c;
        b_rc(4 * j, kr, c);
        const int k = k0 + kr, n = n0 + c;
        const TIn* p = b_g + (size_t)k * N + n;
        if (VEC_B && k < sp.k_end && n < N) {
          bf16x4(p, &rb[4 * j]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rb[4 * j + e] = k < sp.k_end && n + e < N ? to_f32(p[e]) : 0.f;
        }
      }
    }
  };
  auto put = [&](int st) {  // bfloat16
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      int r, k;
      a_rc(e, r, k);
      sm.a[st][r][k] = ra[e];
    }
#pragma unroll
    for (int e = 0; e < EB; ++e) {
      int kr, c;
      b_rc(e, kr, c);
      sm.b[st][kr][c] = rb[e];
    }
  };

  // Thread (ty, tx) owns rows ty + TY i (i < TM) and columns
  // h * (BN / H) + tx * 4 + j (h < H, j < 4).
  constexpr int H = BN / 32 > 0 ? BN / 32 : 1;  // column quads a thread
  constexpr int TX = BN / (4 * H), TY = THREADS / TX, TM = BM / TY;
  const int ty = tid / TX, tx = tid % TX;
  float acc[TM][4 * H];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * H; ++j) acc[i][j] = 0.f;
  if (sp.steps > 0) {
    if constexpr (F32) {
      load(0, sp.k_begin);
      cp_async_commit();
    } else {
      fetch(sp.k_begin);
      put(0);
    }
  }
  for (int step = 0; step < sp.steps; ++step) {
    // Step `step` has landed, and every thread is done with step - 1,
    // whose stage the next load overwrites.
    if constexpr (F32) cp_async_wait_all();
    __syncthreads();
    const bool next = step + 1 < sp.steps;
    if (next) {
      if constexpr (F32) {
        load((step + 1) % 2, sp.k_begin + (step + 1) * BK);
        cp_async_commit();
      } else {
        fetch(sp.k_begin + (step + 1) * BK);
      }
    }
    const int st = step % 2;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float av[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sm.a[st][ty + TY * i][kq]);
        av[i][0] = v.x;
        av[i][1] = v.y;
        av[i][2] = v.z;
        av[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[4 * H];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              &sm.b[st][kq + kk][h * (BN / H) + tx * 4]);
          bv[4 * h] = v.x;
          bv[4 * h + 1] = v.y;
          bv[4 * h + 2] = v.z;
          bv[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4 * H; ++j)
            acc[i][j] = fmaf(av[i][kk], bv[j], acc[i][j]);
      }
    }
    if constexpr (!F32) {
      if (next) put((step + 1) % 2);
    }
  }

  float* out_z = dst + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + TY * i;
    if (m >= M) continue;
    float* row = out_z + (size_t)m * N;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int n = n0 + h * (BN / H) + tx * 4;
      if (VEC_B) {
        if (n < N)
          *reinterpret_cast<float4*>(row + n) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) row[n + j] = acc[i][4 * h + j];
      }
    }
  }
}

}  // namespace gemm

// ---------------------------------------------------------------------------
// N <= 8: 128 x 8 tiles, one row per thread
// ---------------------------------------------------------------------------

namespace tall {

constexpr int BM = 128, BN = 8, BK = 32, THREADS = 128;
constexpr int LDA = BK + 4;  // A row pitch: conflict-free float4 reads

struct Tiles {
  float a[2][BM][LDA];  // [stage][m][k]
  float b[2][BK][BN];   // [stage][k][n]
};

// VEC_A: K % 4 == 0 and a 16-byte aligned (float32 only).
// grid = (cdiv(M, BM), 1, splits * G).
template <typename TIn, bool VEC_A>
__global__ void __launch_bounds__(THREADS)
kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
       float* __restrict__ dst, int G, int M, int K, int N, int chunk) {
  __shared__ __align__(16) Tiles sm;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const Split sp = split_of(G, K, chunk, BK);
  const TIn* a_g = a + (size_t)sp.g * M * K;
  const TIn* b_g = b + (size_t)sp.g * K * N;

  auto load = [&](int st, int k0) {
    if constexpr (VEC_A) {
      // Rows tid / 8 + 16 j, quad tid % 8 of the step's 32 columns: eight
      // threads copy 128 contiguous bytes of a row.
      const int k = k0 + (tid % 8) * 4;
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) {
        const int r = tid / 8 + 16 * j, m = m0 + r;
        const bool ok = m < M && k < sp.k_end;
        cp_async16(&sm.a[st][r][(tid % 8) * 4],
                   ok ? a_g + (size_t)m * K + k : a_g, ok);
      }
    } else {
      // Rows tid / 32 + 4 j, column tid % 32: a warp copies one row.
      const int k = k0 + tid % 32;
#pragma unroll 8
      for (int j = 0; j < BM / 4; ++j) {
        const int r = tid / 32 + 4 * j, m = m0 + r;
        const bool ok = m < M && k < sp.k_end;
        stage(&sm.a[st][r][tid % 32], ok ? a_g + (size_t)m * K + k : a_g,
              ok);
      }
    }
#pragma unroll
    for (int j = 0; j < BK * BN / THREADS; ++j) {
      const int kr = tid / BN + (THREADS / BN) * j, n = tid % BN;
      const int k = k0 + kr;
      const bool ok = k < sp.k_end && n < N;
      stage(&sm.b[st][kr][n], ok ? b_g + (size_t)k * N + n : b_g, ok);
    }
  };

  float acc[BN];
#pragma unroll
  for (int j = 0; j < BN; ++j) acc[j] = 0.f;
  if (sp.steps > 0) {
    load(0, sp.k_begin);
    cp_async_commit();
  }
  for (int step = 0; step < sp.steps; ++step) {
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < sp.steps) {
      load((step + 1) % 2, sp.k_begin + (step + 1) * BK);
      cp_async_commit();
    }
    const int st = step % 2;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&sm.a[st][tid][kq]);
      const float av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(&sm.b[st][kq + kk][0]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&sm.b[st][kq + kk][4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < BN; ++j) acc[j] = fmaf(av[kk], bv[j], acc[j]);
      }
    }
  }

  const int m = m0 + tid;
  if (m >= M) return;
  float* row = dst + (size_t)blockIdx.z * M * N + (size_t)m * N;
#pragma unroll
  for (int j = 0; j < BN; ++j)
    if (j < N) row[j] = acc[j];
}

}  // namespace tall

// ---------------------------------------------------------------------------
// M <= 8: 8 x 128 tiles, one column per thread
// ---------------------------------------------------------------------------

namespace mirror {

constexpr int BM = 8, BN = 128, BK = 32, THREADS = 128;

struct Tiles {
  float a[2][BK][BM];  // [stage][k][m]: A transposed as it is staged
  float b[2][BK][BN];  // [stage][k][n]
};

// VEC_B: N % 4 == 0 and b 16-byte aligned (float32 only).
// grid = (cdiv(N, BN), 1, splits * G).
template <typename TIn, bool VEC_B>
__global__ void __launch_bounds__(THREADS)
kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
       float* __restrict__ dst, int G, int M, int K, int N, int chunk) {
  __shared__ __align__(16) Tiles sm;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const Split sp = split_of(G, K, chunk, BK);
  const TIn* a_g = a + (size_t)sp.g * M * K;
  const TIn* b_g = b + (size_t)sp.g * K * N;

  auto load = [&](int st, int k0) {
    // A: column tid % 32 of rows tid / 32 + 4 j.
#pragma unroll
    for (int j = 0; j < BK * BM / THREADS; ++j) {
      const int mr = tid / BK + (THREADS / BK) * j, kr = tid % BK;
      const int k = k0 + kr;
      const bool ok = mr < M && k < sp.k_end;
      stage(&sm.a[st][kr][mr], ok ? a_g + (size_t)mr * K + k : a_g, ok);
    }
    if constexpr (VEC_B) {
      // Rows tid / 32 + 4 j, quad tid % 32: a warp copies 512 contiguous
      // bytes of a row.
      const int n = n0 + (tid % 32) * 4;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const int kr = tid / 32 + 4 * j, k = k0 + kr;
        const bool ok = k < sp.k_end && n < N;
        cp_async16(&sm.b[st][kr][(tid % 32) * 4],
                   ok ? b_g + (size_t)k * N + n : b_g, ok);
      }
    } else {
      const int n = n0 + tid;
#pragma unroll 8
      for (int kr = 0; kr < BK; ++kr) {
        const int k = k0 + kr;
        const bool ok = k < sp.k_end && n < N;
        stage(&sm.b[st][kr][tid], ok ? b_g + (size_t)k * N + n : b_g, ok);
      }
    }
  };

  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;
  if (sp.steps > 0) {
    load(0, sp.k_begin);
    cp_async_commit();
  }
  for (int step = 0; step < sp.steps; ++step) {
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < sp.steps) {
      load((step + 1) % 2, sp.k_begin + (step + 1) * BK);
      cp_async_commit();
    }
    const int st = step % 2;
#pragma unroll
    for (int e = 0; e < BK; ++e) {
      const float bv = sm.b[st][e][tid];
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[st][e][0]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[st][e][4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < BM; ++i) acc[i] = fmaf(av[i], bv, acc[i]);
    }
  }

  const int n = n0 + tid;
  if (n >= N) return;
  float* out_z = dst + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < BM; ++i)
    if (i < M) out_z[(size_t)i * N + n] = acc[i];
}

}  // namespace mirror

// The plan's variants (kernels/matmul.py: VARIANTS).
enum Variant { GENERAL = 0, TALL = 1, MIRROR = 2, NARROW = 3 };

template <typename TIn>
using KernelFn = void (*)(const TIn*, const TIn*, float*, int, int, int, int,
                          int);

// The instance for `variant`; vec_a / vec_b pick the copies of four
// elements (the 128 x 8 and 8 x 128 tiles take them for float32 only).
// nullptr for an unknown variant.
template <typename TIn, int BN>
KernelFn<TIn> pick_gemm(bool vec_a, bool vec_b) {
  return vec_a ? (vec_b ? &gemm::kernel<TIn, BN, true, true>
                        : &gemm::kernel<TIn, BN, true, false>)
               : (vec_b ? &gemm::kernel<TIn, BN, false, true>
                        : &gemm::kernel<TIn, BN, false, false>);
}
KernelFn<float> pick(float*, int variant, bool vec_a, bool vec_b) {
  switch (variant) {
    case GENERAL:
      return pick_gemm<float, 64>(vec_a, vec_b);
    case NARROW:
      return pick_gemm<float, 16>(vec_a, vec_b);
    case TALL:
      return vec_a ? &tall::kernel<float, true> : &tall::kernel<float, false>;
    case MIRROR:
      return vec_b ? &mirror::kernel<float, true>
                   : &mirror::kernel<float, false>;
  }
  return nullptr;
}
KernelFn<__nv_bfloat16> pick(__nv_bfloat16*, int variant, bool vec_a,
                             bool vec_b) {
  switch (variant) {
    case GENERAL:
      return pick_gemm<__nv_bfloat16, 64>(vec_a, vec_b);
    case NARROW:
      return pick_gemm<__nv_bfloat16, 16>(vec_a, vec_b);
    case TALL:
      return &tall::kernel<__nv_bfloat16, false>;
    case MIRROR:
      return &mirror::kernel<__nv_bfloat16, false>;
  }
  return nullptr;
}

int threads(int variant) {
  return variant == TALL ? tall::THREADS
         : variant == MIRROR ? mirror::THREADS
                             : gemm::THREADS;
}

template <typename TIn>
cudaError_t launch(const void* a, const void* b, float* dst, int G, int M,
                   int K, int N, int variant, int splits,
                   cudaStream_t stream) {
  // Four elements at a time: 16 bytes of float32, 8 of bfloat16.
  const uintptr_t quad = 4 * sizeof(TIn);
  const bool vec_a = K % 4 == 0 && (uintptr_t)a % quad == 0;
  const bool vec_b = N % 4 == 0 && (uintptr_t)b % quad == 0 &&
                     (uintptr_t)dst % 16 == 0;
  const KernelFn<TIn> kernel =
      pick(static_cast<TIn*>(nullptr), variant, vec_a, vec_b);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const bool tiled = variant == GENERAL || variant == NARROW;
  const int bk = tiled ? gemm::BK : tall::BK;
  const int chunk = cdiv(cdiv(K, splits), bk) * bk;
  const dim3 grid =
      tiled ? dim3(cdiv(M, gemm::BM), cdiv(N, variant == GENERAL ? 64 : 16),
                   splits * G)
      : variant == TALL ? dim3(cdiv(M, tall::BM), 1, splits * G)
                        : dim3(cdiv(N, mirror::BN), 1, splits * G);
  kernel<<<grid, threads(variant), 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b), dst, G, M, K,
      N, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a: (G, M, K), b: (G, K, N), out: (G, M, N), all contiguous row-major.
// in_bf16 / out_bf16 select bfloat16 (1) or float32 (0) for the inputs
// (both the same type) and the output.  variant: 0 the 64 x 64 tile, 1 the
// 128 x 8 tile (N <= 8), 2 the 8 x 128 tile (M <= 8), 3 the 64 x 16 tile
// (N <= 16).  `part` holds
// splits*G*M*N floats; it is not read when splits == 1 and the output is
// float32 (the kernel writes `out` directly).
int matmul(const void* a, const void* b, float* part, void* out, int in_bf16,
           int out_bf16, int G, int M, int K, int N, int variant, int splits,
           cudaStream_t stream) {
  const bool direct = splits == 1 && !out_bf16;
  float* dst = direct ? static_cast<float*>(out) : part;
  cudaError_t err =
      in_bf16 ? launch<__nv_bfloat16>(a, b, dst, G, M, K, N, variant, splits,
                                      stream)
              : launch<float>(a, b, dst, G, M, K, N, variant, splits, stream);
  if (err != cudaSuccess || direct) return (int)err;
  const size_t total = (size_t)G * M * N;
  if (out_bf16)
    return (int)splitk::reduce(part, static_cast<__nv_bfloat16*>(out), total,
                               splits, stream);
  return (int)splitk::reduce(part, static_cast<float*>(out), total, splits,
                             stream);
}

// Blocks of one instance an SM holds (registers and shared memory), which
// the plan in kernels/matmul.py assumes.
int matmul_blocks_per_sm(int variant, int in_bf16, int vec_a, int vec_b,
                         int* blocks) {
  const void* kernel =
      in_bf16 ? (const void*)pick(static_cast<__nv_bfloat16*>(nullptr),
                                  variant, vec_a, vec_b)
              : (const void*)pick(static_cast<float*>(nullptr), variant,
                                  vec_a, vec_b);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads(variant), 0);
}

}  // extern "C"
