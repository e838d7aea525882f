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
// Blocks own 64 query rows of one (batch, head), walk key tiles of 64
// rows, and run the heaviest causal blocks first.  No atomics: results are
// identical run to run.  D <= 256, in instances for D <= 64, 128, 192 and
// 256.
//
// It runs the attention of every prefill of the LM server: one causal
// pass over the prompt per layer, at SmolLM-360M's (1, 15, P, 64) queries
// against (1, 5, P, 64) keys and values, moonshot-v1-16b-a3b's (1, 16, P,
// 128), DeepSeek-V3 MLA's (1, 128, P, 192) (qk_nope 128 + qk_rope 64,
// v zero-padded from 128 to 192 by the caller) and recurrentgemma-9b's
// (1, 16, P, 256) against one key/value head (MQA; only prompts that fit
// its 2,048-key window reach the kernel), in bf16.  What bounds it on an
// H100: at P = 1,024 a launch does 2.0 GFLOP (causal half of 4 P^2 D H)
// against 4.5 MB, far above the bf16 ridge (989 TFLOP/s / 3.35 TB/s
// = 295 FLOP/byte), so it is bound by operations, and those only run at
// speed on the tensor cores.  Two kernels:
//
// bf16 (flash_bf16_kernel): FA2 on mma.sync.m16n8k16 (bf16 in, float32
// sums).  4 warps of 16 query rows each.  Q is loaded once and held in
// registers as A fragments (ldmatrix).  K and V tiles stream through a
// 2-stage shared-memory ring filled by 16-byte cp.async (zero-filled past
// Lk and past D), so tile t+1 loads while tile t computes, with one
// barrier per tile; rows are padded by 16 bytes so ldmatrix (plain for K,
// .trans for V) is free of bank conflicts.  S = Q K^T stays in the mma
// accumulators; the online softmax runs on them in registers (each row's
// max over the 4 lanes of a quad, exp2 with scale * log2(e) folded into
// the float32 scores).  P is rounded to bf16 in registers and is directly
// the A operand of O += P V (the m16n8 accumulator pairs are the m16n8k16
// A fragment): it never touches shared memory.  The normaliser sums the
// float32 p; P V sums bf16 p, the one rounding the TPU kernel (float32 P)
// does not make.  Only tiles on the causal diagonal or the ragged key
// edge compute masks; a masked score becomes p = 0 exactly.  Rows that
// are not 16-byte aligned (D % 8 != 0, or an unaligned base) take plain
// loads into the same ring.  Shared memory: 45 KB for D <= 64, 85 KB for
// D <= 128, 128 KB for D <= 192, 165 KB for D <= 256 (one block an SM).
// At D = 192 the output accumulator alone takes 96 registers a thread, so
// that instance does not hold Q's 48 fragment registers for the walk: it
// re-reads them from shared memory (where Q stays) with ldmatrix in every
// tile.  At D = 256 the accumulator would take 128, so that instance runs
// 8 warps, two to each 16-row strip: both compute the strip's S (and so
// the same softmax statistics, with no exchange), and each holds and
// updates half of O's columns (64 registers), reading its half of V.  The
// second S costs a third more tensor-core work than one warp a strip.
//
// float32 (flash_kernel): SIMT float32 FMA (67 TFLOP/s peak).  256
// threads; Q (scaled), K and V of the tile are staged in dynamic shared
// memory, Q and K transposed so both operands of S = Q K^T are float4
// reads.  Thread (ty, tx) of the 16 x 16 grid holds a 4 x 4 block of
// scores (rows 4ty.., keys 4tx..); a row's max and sum are reduced over
// the 16 threads of its half-warp with shuffles.  P goes back to shared
// memory (transposed) for O += P V, where the thread owns rows 4ty.. and
// columns 4tx.. (+64, +128, +192 for wider D) of the output.  68.6, 119.8,
// 171.0 or 222.2 KB of shared memory (the last under the 227 KB a block
// may take; one block an SM).  Its products stay full float32: TF32 or bf16
// products would break the float32 serving path's 1e-5 tolerance.
//
// The entry returns cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BKV = 64;        // key rows per tile
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Above 48 KB a block's shared memory must be dynamic, and allowed once
// per device before the first launch (not while a graph is captured).
// One flag array per kernel instantiation.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync), cp.async ring, softmax in registers
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;

// Warps to each 16-row strip of the 64 query rows: each holds 1 / CS of
// O's columns.
template <int DM>
__host__ __device__ constexpr int col_split() { return DM > 192 ? 2 : 1; }
template <int DM>
__host__ __device__ constexpr int threads() { return 128 * col_split<DM>(); }

// Row pitch of every shared tile (bf16): 16 bytes of padding put the 8
// rows an ldmatrix phase reads on 8 distinct groups of 4 banks.
template <int DM>
__host__ __device__ constexpr int pitch() { return DM + 8; }

// Q (BQ rows) + 2 stages x (K + V) (BKV rows each).
template <int DM>
__host__ __device__ constexpr int smem_bytes() {
  return (BQ + 4 * BKV) * pitch<DM>() * (int)sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; with src_bytes = 0 nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), float32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, the lower column in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a (rows, D) matrix into a (64, pitch) tile,
// zero past `rows` and past D.  VEC: D % 8 == 0 and a 16-byte aligned
// base, so each 16-byte chunk is all in or all out (async); otherwise
// plain element loads.
template <int DM, bool VEC>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int rows, int D) {
  constexpr int P = pitch<DM>();
  constexpr int NT = threads<DM>();
  if constexpr (VEC) {
    constexpr int CPR = DM / 8;  // 16-byte chunks per row
#pragma unroll
    for (int i = 0; i < 64 * CPR / NT; ++i) {
      const int c = threadIdx.x + i * NT;
      const int r = c / CPR, col = (c % CPR) * 8, row = row0 + r;
      const bool ok = row < rows && col < D;
      cp_async16(smem_addr(dst + r * P + col),
                 ok ? src + (size_t)row * D + col : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < 64 * DM; e += NT) {
      const int r = e / DM, col = e % DM, row = row0 + r;
      dst[r * P + col] = (row < rows && col < D)
                             ? src[(size_t)row * D + col]
                             : __float2bfloat16(0.f);
    }
  }
}

// grid = (cdiv(Lq, BQ), B * H).  q (B, H, Lq, D), k/v (B, Hk, Lk, D),
// o (B, H, Lq, D), all contiguous bf16; DM = 64, 128, 192 or 256 >= D.
// scale_log2 = scale * log2(e).
template <int DM, bool VEC>
__global__ void __launch_bounds__(threads<DM>())
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                  int Hk, int Lq, int Lk, int D, int causal,
                  float scale_log2) {
  constexpr int P = pitch<DM>();
  constexpr int CS = col_split<DM>();
  constexpr int KD = DM / 16;  // k-steps of S = Q K^T; column pairs of O
  constexpr int KO = KD / CS;  // column pairs of O this warp holds
  constexpr int NO = DM / 8 / CS;  // 8-column tiles of O this warp holds
  // Q held in registers for the whole walk, or (DM = 192) re-read from
  // shared memory in every tile.
  constexpr bool QREG = DM <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + BQ * P;       // [2][BKV][P]
  bf16* sv = sk + 2 * BKV * P;  // [2][BKV][P]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strip = warp % 4;  // 16 query rows
  const int col0 = (warp / 4) * KO;  // first column pair of O held here
  const int grp = lane / 4, tig = lane % 4;  // accumulator row, column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = b * Hk + h / (H / Hk);
  const bf16* qg = q + (size_t)bh * Lq * D;
  const bf16* kg = k + (size_t)kvh * Lk * D;
  const bf16* vg = v + (size_t)kvh * Lk * D;
  const int q_offset = Lk - Lq;
  int n_tiles = cdiv(Lk, BKV);
  if (causal) {
    const int last_row = min(q0 + BQ, Lq) - 1;
    n_tiles = min(n_tiles, (q_offset + last_row) / BKV + 1);
  }

  load_tile<DM, VEC>(sq, qg, q0, Lq, D);
  load_tile<DM, VEC>(sk, kg, 0, Lk, D);
  load_tile<DM, VEC>(sv, vg, 0, Lk, D);
  cp_async_commit();

  // ldmatrix lane addressing: lane l serves row (l % 8) of 8x8 matrix l / 8.
  const int lm_row = lane % 8, lm_mat = lane / 8;
  uint32_t qf[QREG ? KD : 1][4];  // Q as A fragments, for the whole walk
  float acc[NO][4];             // O, rows grp and grp + 8
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    // Tile t has landed, and every warp is done with tile t - 1, whose
    // stage the next load overwrites.
    cp_async_wait_all();
    __syncthreads();
    const bf16* q_frag = sq + (strip * 16 + (lm_mat % 2) * 8 + lm_row) * P
                         + (lm_mat / 2) * 8;
    if constexpr (QREG) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldsm_x4(smem_addr(q_frag + kk * 16), qf[kk]);
      }
    }
    if (t + 1 < n_tiles) {
      const int st = (t + 1) % 2;
      load_tile<DM, VEC>(sk + st * BKV * P, kg, (t + 1) * BKV, Lk, D);
      load_tile<DM, VEC>(sv + st * BKV * P, vg, (t + 1) * BKV, Lk, D);
      cp_async_commit();
    }
    const bf16* kt = sk + (t % 2) * BKV * P;
    const bf16* vt = sv + (t % 2) * BKV * P;

    // S = Q K^T: 8 tiles of 8 keys; K rows are the col-major B operand.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldsm_x4(smem_addr(q_frag + kk * 16), qa);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(smem_addr(kt + (np * 16 + (lm_mat / 2) * 8 + lm_row) * P
                          + kk * 16 + (lm_mat % 2) * 8),
                bf);
        mma(s[2 * np], qa, bf[0], bf[1]);
        mma(s[2 * np + 1], qa, bf[2], bf[3]);
      }
    }

    // Element e of s[n] is row grp + 8 * (e / 2), key 8n + 2 tig + e % 2.
    const int k0 = t * BKV;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
    if (k0 + BKV > Lk || (causal && k0 + BKV - 1 > q_offset + q0)) {
      const int qpos = q_offset + q0 + strip * 16 + grp;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + tig * 2 + e % 2;
          if (key >= Lk || (causal && key > qpos + 8 * (e / 2)))
            s[n][e] = -CUDART_INF_F;  // exp2 gives exactly 0
        }
    }

    // Online softmax on the two rows this lane holds; a row's 64 scores
    // lie on the 4 lanes of a quad.
    float alpha[2], m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // A row with every key so far masked keeps NEG_INF (finite), so
      // alpha is 1 and its masked p stay 0.
      m_new[i] = fmaxf(m_run[i], mx);
      alpha[i] = exp2f(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
    }
    // P as the A fragments of P V: k-step kk covers score tiles 2kk and
    // 2kk + 1, {a0, a1} from the first, {a2, a3} from the second.
    uint32_t pf[4][4];
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2f(s[n][0] - m_new[0]);
      const float p1 = exp2f(s[n][1] - m_new[0]);
      const float p2 = exp2f(s[n][2] - m_new[1]);
      const float p3 = exp2f(s[n][3] - m_new[1]);
      rsum[0] += p0 + p1;
      rsum[1] += p2 + p3;
      pf[n / 2][(n % 2) * 2] = pack(p0, p1);
      pf[n / 2][(n % 2) * 2 + 1] = pack(p2, p3);
    }
    // The lane's partial normaliser; the quad sums it once, at the end.
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rsum[i];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: V rows (keys) are the k dim, so .trans gives the B operand.
    // This warp's columns: pairs col0 .. col0 + KO - 1.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dp = 0; dp < KO; ++dp) {
        uint32_t bf[4];
        ldsm_x4_trans(smem_addr(vt + (kk * 16 + (lm_mat % 2) * 8 + lm_row) * P
                                + (col0 + dp) * 16 + (lm_mat / 2) * 8),
                      bf);
        mma(acc[2 * dp], pf[kk], bf[0], bf[1]);
        mma(acc[2 * dp + 1], pf[kk], bf[2], bf[3]);
      }
  }

  bf16* og = o + (size_t)bh * Lq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = q0 + strip * 16 + grp + 8 * i;
    if (row >= Lq) continue;
    bf16* orow = og + (size_t)row * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = col0 * 16 + n * 8 + tig * 2;
      const float x = acc[n][2 * i] * inv, y = acc[n][2 * i + 1] * inv;
      if (VEC) {
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(x, y);
      } else {
        if (col < D) orow[col] = __float2bfloat16(x);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16(y);
      }
    }
  }
}

template <int DM, bool VEC>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hk, int Lq, int Lk, int D, int causal, float scale,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DM>();
  static bool allowed[MAX_DEVICES] = {};
  const int err = allow_smem(flash_bf16_kernel<DM, VEC>, bytes, allowed);
  if (err) return err;
  const dim3 grid(cdiv(Lq, BQ), B * H);
  flash_bf16_kernel<DM, VEC><<<grid, threads<DM>(), bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, Hk, Lq, Lk, D,
      causal, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hk, int Lq, int Lk, int D, int causal, float scale,
             cudaStream_t stream) {
  const bool vec = D % 8 == 0 && ((uintptr_t)q | (uintptr_t)k |
                                  (uintptr_t)v | (uintptr_t)o) % 16 == 0;
  if (D <= 64)
    return vec ? launch<64, true>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal,
                                  scale, stream)
               : launch<64, false>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal,
                                   scale, stream);
  if (D <= 128)
    return vec ? launch<128, true>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal,
                                   scale, stream)
               : launch<128, false>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal,
                                    scale, stream);
  if (D <= 192)
    return vec ? launch<192, true>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal,
                                   scale, stream)
               : launch<192, false>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal,
                                    scale, stream);
  return vec ? launch<256, true>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal,
                                 scale, stream)
             : launch<256, false>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal,
                                  scale, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: SIMT FMA
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;   // 16 x 16 threads
constexpr int LD = 64 + 4;     // padded row of the transposed tiles

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
// o (B, H, Lq, D), all contiguous float32; DM = 64, 128, 192 or 256 >= D.
template <int DM>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int H,
             int Hk, int Lq, int Lk, int D, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tiles<DM>& s = *reinterpret_cast<Tiles<DM>*>(smem);
  constexpr int NC = DM / 64;  // 64-column groups of the output
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = b * Hk + h / (H / Hk);
  const float* qg = q + (size_t)bh * Lq * D;
  const float* kg = k + (size_t)kvh * Lk * D;
  const float* vg = v + (size_t)kvh * Lk * D;
  const int q_offset = Lk - Lq;

  for (int idx = tid; idx < BQ * DM; idx += THREADS) {
    const int r = idx / DM, d = idx % DM, row = q0 + r;
    s.qt[d][r] = (row < Lq && d < D) ? qg[(size_t)row * D + d] * scale : 0.f;
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
      s.kt[d][r] = ok ? kg[(size_t)key * D + d] : 0.f;
      s.v[r][d] = ok ? vg[(size_t)key * D + d] : 0.f;
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

  float* og = o + (size_t)bh * Lq * D;
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
        if (d < D) og[(size_t)row * D + d] = acc[i][c * 4 + j] * inv;
      }
  }
}

template <int DM>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Hk, int Lq, int Lk, int D, int causal, float scale,
               cudaStream_t stream) {
  constexpr int bytes = (int)sizeof(Tiles<DM>);
  static bool allowed[MAX_DEVICES] = {};
  const int err = allow_smem(flash_kernel<DM>, bytes, allowed);
  if (err) return err;
  const dim3 grid(cdiv(Lq, BQ), B * H);
  flash_kernel<DM><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hk, Lq, Lk, D,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, H, Lq, D); k, v: (B, Hk, Lk, D); contiguous row-major, all
// bfloat16 (bf16 = 1) or all float32 (bf16 = 0).  H % Hk == 0, 1 <= D <= 256,
// Lq >= 1, Lk >= 1, and Lq <= Lk when causal (the wrapper checks).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int bf16, int B, int H, int Hk, int Lq, int Lk, int D,
                    int causal, float scale, cudaStream_t stream) {
  if (bf16)
    return tc::dispatch(q, k, v, o, B, H, Hk, Lq, Lk, D, causal, scale,
                        stream);
  if (D <= 64)
    return launch_f32<64>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal, scale,
                          stream);
  if (D <= 128)
    return launch_f32<128>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal, scale,
                           stream);
  if (D <= 192)
    return launch_f32<192>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal, scale,
                           stream);
  return launch_f32<256>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal, scale,
                         stream);
}

}  // extern "C"
