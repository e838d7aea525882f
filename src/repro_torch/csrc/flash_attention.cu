// Flash attention forward for Hopper (sm_90a): online-softmax attention on
// (B, H, L, D), causal or full, with grouped key/value heads.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel / flash_attention): o = softmax(q k^T * scale + mask) v
// with float32 scores, running max, normaliser and accumulator, and the
// output in the inputs' type.  Keys at or past Lk are masked; under
// `causal` query row i sees key j when q_offset + i >= j, with
// q_offset = Lk - Lq, and key tiles past the diagonal are never loaded
// (the TPU kernel's `hi`).  Query head h reads key/value head
// h / (H / Hk), the grouping of the JAX package's dense attention, so GQA
// needs no repeated copy of K and V.  The TPU wrapper padded L to its
// 128-row blocks; here ragged edges are masked, so nothing is padded.
//
// It runs the attention of every prefill of the LM server: one causal
// pass over the prompt per layer, at SmolLM-360M's (1, 15, P, 64) queries
// against (1, 5, P, 64) keys and values in bf16.  What bounds it on an
// H100: at P = 1,024 a launch does 2.0 GFLOP (causal half of 4 P^2 D H)
// against 4.5 MB, far above the bf16 ridge (989 TFLOP/s / 3.35 TB/s
// = 295 FLOP/byte), so it is bound by operations.  This first version does
// them as SIMT float32 FMA (67 TFLOP/s peak), not on the tensor cores.
//
// Design: one 256-thread block owns 64 query rows of one (batch, head) and
// walks the key tiles of 64 rows.  Q (scaled), K and V of the tile are
// converted to float32 (bf16 with the intrinsics only) and staged in
// dynamic shared memory, Q and K transposed so both operands of S = Q K^T
// are float4 reads.  Thread (ty, tx) of the 16 x 16 grid holds a 4 x 4
// block of scores (rows 4ty.., keys 4tx..); a row's max and sum are
// reduced over the 16 threads of its half-warp with shuffles.  P goes back
// to shared memory (transposed) for O += P V, where the thread owns rows
// 4ty.. and columns 4tx.. (+64 for D > 64) of the output.  Blocks run the
// heaviest causal tiles first.  No atomics: results are identical run to
// run.  D <= 128 (tiles sized for 64 or 128 columns: 68.6 or 119.8 KB of
// shared memory).
//
// The entry returns cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BKV = 64;        // key rows per tile
constexpr int THREADS = 256;   // 16 x 16 threads
constexpr int LD = 64 + 4;     // padded row of the transposed tiles
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Reduce over the 16 lanes of a half-warp (xor offsets below 16 stay in it).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int DM>
struct Tiles {
  float qt[DM][LD];   // (Q * scale)^T: [d][query row]
  float kt[DM][LD];   // K^T: [d][key]
  float v[BKV][DM];   // V: [key][d]
  float pt[BKV][LD];  // P^T: [key][query row]
};

// grid = (cdiv(Lq, BQ), B * H).  q (B, H, Lq, D), k/v (B, Hk, Lk, D),
// o (B, H, Lq, D), all contiguous; DM = 64 or 128 >= D.
template <typename T, int DM>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int Hk,
             int Lq, int Lk, int D, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tiles<DM>& s = *reinterpret_cast<Tiles<DM>*>(smem);
  constexpr int NC = DM / 64;  // 64-column groups of the output
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = b * Hk + h / (H / Hk);
  const T* qg = q + (size_t)bh * Lq * D;
  const T* kg = k + (size_t)kvh * Lk * D;
  const T* vg = v + (size_t)kvh * Lk * D;
  const int q_offset = Lk - Lq;

  for (int idx = tid; idx < BQ * DM; idx += THREADS) {
    const int r = idx / DM, d = idx % DM, row = q0 + r;
    s.qt[d][r] = (row < Lq && d < D) ? to_f32(qg[(size_t)row * D + d]) * scale
                                     : 0.f;
  }
  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }
  int n_tiles = cdiv(Lk, BKV);
  if (causal) {
    const int last_row = min(q0 + BQ, Lq) - 1;
    n_tiles = min(n_tiles, (q_offset + last_row) / BKV + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BKV * DM; idx += THREADS) {
      const int r = idx / DM, d = idx % DM, key = k0 + r;
      const bool ok = key < Lk && d < D;
      s.kt[d][r] = ok ? to_f32(kg[(size_t)key * D + d]) : 0.f;
      s.v[r][d] = ok ? to_f32(vg[(size_t)key * D + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < DM; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&s.qt[d][ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&s.kt[d][tx * 4]);
      const float ai[4] = {a.x, a.y, a.z, a.w};
      const float bj[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(ai[i], bj[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        ok[j] = key < Lk && (!causal || qpos >= key);
        if (ok[j]) mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += p;
        s.pt[tx * 4 + j][ty * 4 + i] = p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(&s.pt[kk][ty * 4]);
      const float pi[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&s.v[kk][c * 64 + tx * 4]);
        const float vj[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][c * 4 + j] = fmaf(pi[i], vj[j], acc[i][c * 4 + j]);
      }
    }
  }

  T* og = o + (size_t)bh * Lq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Lq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = c * 64 + tx * 4 + j;
        if (d < D) store(og + (size_t)row * D + d, acc[i][c * 4 + j] * inv);
      }
  }
}

template <typename T, int DM>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hk, int Lq, int Lk, int D, int causal, float scale,
           cudaStream_t stream) {
  constexpr int bytes = (int)sizeof(Tiles<DM>);
  // Above 48 KB a block's shared memory must be dynamic, and allowed once
  // per device before the first launch (not while a graph is captured).
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(flash_kernel<T, DM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  const dim3 grid(cdiv(Lq, BQ), B * H);
  flash_kernel<T, DM><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hk, Lq, Lk, D, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hk, int Lq, int Lk, int D, int causal, float scale,
             cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal, scale,
                         stream);
  return launch<T, 128>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal, scale,
                        stream);
}

}  // namespace

extern "C" {

// q, o: (B, H, Lq, D); k, v: (B, Hk, Lk, D); contiguous row-major, all
// bfloat16 (bf16 = 1) or all float32 (bf16 = 0).  H % Hk == 0, 1 <= D <= 128,
// Lq >= 1, Lk >= 1, and Lq <= Lk when causal (the wrapper checks).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int bf16, int B, int H, int Hk, int Lq, int Lk, int D,
                    int causal, float scale, cudaStream_t stream) {
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal,
                                   scale, stream);
  return dispatch<float>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal, scale,
                         stream);
}

}  // extern "C"
