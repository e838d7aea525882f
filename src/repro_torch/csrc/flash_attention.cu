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
// Blocks own 64 query rows of one (batch, head), walk key tiles, and run
// the heaviest causal blocks first.  No atomics: results are identical run
// to run.  D <= 256, in instances for D <= 64, 128, 192 and 256 (float32
// also 80).
//
// It runs the attention of every prefill of the LM server: one causal
// pass over the prompt per layer, at SmolLM-360M's (1, 15, P, 64) queries
// against (1, 5, P, 64) keys and values, moonshot-v1-16b-a3b's (1, 16, P,
// 128), DeepSeek-V3 MLA's (1, 128, P, 192) (qk_nope 128 + qk_rope 64,
// v zero-padded from 128 to 192 by the caller) and recurrentgemma-9b's
// (1, 16, P, 256) against one key/value head (MQA; only prompts that fit
// its 2,048-key window reach the kernel), in bf16 and, under the configs'
// float32 variants (the JAX package's default dtype), in float32; and the
// full attention of hubert-xlarge's encoder, (4, 16, 1,000, 80).  What
// bounds it on an
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
// float32 (flash_f32_kernel): FA2 on mma.sync.m16n8k8 TF32, three
// products a pair, which keep float32's accuracy.  Each operand x splits
// into hi = tf32(x) and lo = tf32(x - hi) (to nearest, 10 mantissa bits,
// as cvt.rna; x - hi is exact), and a b sums a_hi b_lo + a_lo b_hi +
// a_hi b_hi in float32, the small products first: the dropped a_lo b_lo
// and lo's rounding leave about 2^-21 of |a b|, the scale of float32's own
// rounding, where one TF32 product (2^-11) misses the float32 path's 1e-5.
// TF32 runs at 495 TFLOP/s dense, so three products bound the kernel at
// 165 TFLOP/s of float32 work, 2.5x the 67 of SIMT FMA.  The tensor cores
// round each mma's sum toward zero, so no accumulator takes a long chain:
// the small products and the big one go to two accumulators (two chains
// the tensor cores overlap), and each key tile's P V is summed apart and
// added to O with float32 arithmetic that rounds to nearest.
//
// 4 warps of 16 query rows; from DM 128 two warps to a strip, each walking
// half of every key tile with its own max, normaliser and O, merged at the
// end.  Q, scaled by scale * log2(e), is split once into hi and lo tiles
// in shared memory, or, at DM 256, where those would pass 227 KB, stays
// raw there and is split at each read; either is stored in fragment
// order, one 16-byte read a lane a k-step.  K and V stream through a
// 2-stage ring of 16-byte cp.async (zero-filled past Lk and past D; rows
// that are not 16-byte aligned, D % 4 != 0 or an unaligned base, take
// plain loads into the same ring), tile t+1 loading while tile t
// computes, one barrier a tile; their fragments are split as they are
// read.  Within a k-step of 8 the mma's k index tig (tig + 4) stands for
// column or key 2 tig (2 tig + 1) on both sides of a product, so K's
// pairs are one float2 read and the m16n8 accumulator of S is, as it
// lies, the A fragment of O += P V: P never leaves its lane's registers.
// Online softmax as in bf16 (exp2, scale * log2(e) folded into Q, masks
// only on the diagonal and ragged-edge tiles); P is split like any
// operand, so P V keeps the TPU kernel's float32 P.  Row pitches: 8 mod
// 32 floats for K (float2 reads: a half-warp on 32 banks), 4 mod 32 for V
// (scalar reads of rows 2 tig and 2 tig + 1: the warp on 32 banks).  Key
// tiles of 64 rows at DM 64 and 128, of 32 at 80 and past 128.  Shared
// memory: 102 KB at DM 64 and 91 KB at 80 (two blocks an SM), 199 KB at
// 128, 196 KB at 192 and 256 (one).  The D-80 instance takes hubert's
// D 80 in 10 k-steps, where the D-128 one worked on 48 zero columns.
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
// float32: tensor cores (mma.sync TF32), three products a pair
// ---------------------------------------------------------------------------

namespace f32 {

// Warps to each 16-row strip of the 64 query rows: at DM >= 128 two, each
// taking half of every key tile with its own running max, normaliser and
// O, merged once at the end (one block an SM there: shared memory).
template <int DM>
__host__ __device__ constexpr int key_split() { return DM >= 128 ? 2 : 1; }
template <int DM>
__host__ __device__ constexpr int threads() { return 128 * key_split<DM>(); }
// Blocks an SM for __launch_bounds__: stated (1) only at DM 256, where the
// assembler then fits the walk in 255 registers without spilling; 0
// leaves it unstated, which the other instances need to avoid spills.
template <int DM>
__host__ __device__ constexpr int min_blocks() { return DM == 256 ? 1 : 0; }
// Key rows per tile: 64 at DM 64 and 128; 32 at 80 (two blocks an SM)
// and past 128 (shared memory).
template <int DM>
__host__ __device__ constexpr int bkv() {
  return DM == 80 || DM > 128 ? 32 : 64;
}
// Q kept split in shared memory (hi and lo tiles), or, at DM = 256, where
// the two would pass 227 KB, kept raw and split at each read.  Either is
// stored in fragment order, [strip][k-step][lane][4], so a lane reads its
// A fragment as one 16-byte load (consecutive lanes, no bank conflict).
template <int DM>
__host__ __device__ constexpr bool qsplit() { return DM < 256; }
// Row pitches in floats.  K and Q are read as float2 (columns 2 tig and
// 2 tig + 1): a pitch of 8 mod 32 puts a half-warp's 16 reads on 32
// distinct banks.  V is read as scalars from rows 2 tig and 2 tig + 1: a
// pitch of 4 mod 32 puts the warp's 32 reads on 32 distinct banks.
template <int DM>
__host__ __device__ constexpr int pk() { return DM + (40 - DM % 32) % 32; }
template <int DM>
__host__ __device__ constexpr int pv() { return DM + (36 - DM % 32) % 32; }

// 2 stages x (K + V) (bkv rows each), then Q (BQ x DM; two tiles when
// split), then, with two warps a strip, a float a thread (see `fence`).
template <int DM>
__host__ __device__ constexpr int smem_bytes() {
  return (2 * bkv<DM>() * (pk<DM>() + pv<DM>())
          + (qsplit<DM>() ? 2 : 1) * BQ * DM
          + (key_split<DM>() == 2 ? threads<DM>() : 0)) * (int)sizeof(float);
}

// tf32(x): x rounded to nearest, ties away from zero, to 10 mantissa bits
// (the value cvt.rna.tf32.f32 gives for finite x, in two integer
// operations; cvt.rna also guards inf and NaN, which no operand here
// holds, and was slower on an H100: scripts/ab_kernel_times.py).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo + e with |e| <= 2^-22 |x|: hi = tf32(x), lo = tf32(x - hi);
// x - hi is exact in float32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8, row-major) * b (8 x 8, column-major): TF32 products,
// float32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b in three TF32 products: the small ones (a_hi b_lo, then a_lo b_hi)
// into `small`, a_hi b_hi into `big` (a_lo b_lo, 2^-22 of |a b|, is
// dropped).  Two accumulators are two chains the tensor cores overlap.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(small, ah, bl0, bl1);
  mma(small, al, bh0, bh1);
  mma(big, ah, bh0, bh1);
}

// Rows [row0, row0 + ROWS) of a (rows, D) matrix into a (ROWS, PITCH)
// tile, zero past `rows` and past D.  VEC: D % 4 == 0 and a 16-byte
// aligned base, so each 16-byte chunk is all in or all out (async): TPR
// threads to a row, CPT chunks each, so a thread's addresses step by
// constants; otherwise plain element loads.
template <int DM, int NT, int ROWS, int PITCH, bool VEC>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows, int D) {
  if constexpr (VEC) {
    constexpr int CPR = DM / 4;  // 16-byte chunks per row
    constexpr int TPR = CPR % 32 == 0   ? 32
                        : CPR % 16 == 0 ? 16
                        : CPR % 8 == 0  ? 8
                                        : 4;
    constexpr int CPT = CPR / TPR;
    constexpr int RPP = NT / TPR;  // rows a pass
    static_assert(CPR % TPR == 0 && ROWS % RPP == 0, "tile cover");
    const int r = threadIdx.x / TPR, c = threadIdx.x % TPR * 4;
    const float* base = src + (size_t)row0 * D;
#pragma unroll
    for (int p = 0; p < ROWS / RPP; ++p) {
      const int rr = r + p * RPP;
      // Opaque to the compiler, so it recomputes this row's offset each
      // tile instead of carrying a 64-bit pointer a chunk across the walk.
      int off = rr * D + c;
      asm volatile("" : "+r"(off));
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c + j * TPR * 4;
        const bool ok = row0 + rr < rows && col < D;
        tc::cp_async16(tc::smem_addr(dst + rr * PITCH + col),
                       ok ? base + off + j * TPR * 4 : src, ok ? 16 : 0);
      }
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DM; e += NT) {
      const int r = e / DM, col = e % DM, row = row0 + r;
      dst[r * PITCH + col] =
          (row < rows && col < D) ? src[(size_t)row * D + col] : 0.f;
    }
  }
}

// grid = (cdiv(Lq, BQ), B * H).  q (B, H, Lq, D), k/v (B, Hk, Lk, D),
// o (B, H, Lq, D), all contiguous float32; DM = 64, 80, 128, 192 or
// 256 >= D.  scale_log2 = scale * log2(e).
//
// Within each k-step of 8, the mma's k index tig (tig + 4) stands for
// column or key 2 tig (2 tig + 1) on both sides of every product.  So
// lane (grp, tig) reads K's pairs as one float2, and the m16n8
// accumulator of S, which holds keys 2 tig and 2 tig + 1 of rows grp and
// grp + 8, is the A fragment of P V as it lies: P stays in registers.
//
// The tensor cores round each mma's float32 sum toward zero, so a long
// chain of mma into one accumulator drifts by up to an ulp a link (past
// 1e-5 relative over a 1,000-key walk; tests/test_torch_flash.py emulates
// it).  So no chain is long: S's big products
// chain over the DM / 8 k-steps and its small ones apart; P V sums each
// key tile apart, big and small, and O takes it as o * alpha + part, with
// float32 arithmetic that rounds to nearest.
template <int DM, bool VEC>
__global__ void __launch_bounds__(threads<DM>(), min_blocks<DM>())
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int Hk, int Lq, int Lk, int D, int causal,
                 float scale_log2) {
  constexpr int NT = threads<DM>(), KS = key_split<DM>();
  constexpr int BK = bkv<DM>(), PK = pk<DM>(), PV = pv<DM>();
  constexpr int KD = DM / 8;        // k-steps of S = Q K^T; O's column tiles
  constexpr int NS = BK / 8 / KS;   // this warp's 8-key tiles of a key tile
  // O's column tiles summed side by side: two where O's DM / 2 registers
  // leave no room for more (DM >= 192), or DM / 8 is not a multiple of 4.
  constexpr int JG = KD % 4 == 0 && DM < 192 ? 4 : 2;
  constexpr bool QSPLIT = qsplit<DM>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);  // [2][BK][PK]
  float* sv = sk + 2 * BK * PK;                // [2][BK][PV]
  float* sq = sv + 2 * BK * PV;  // [4][KD][32][4] (hi or raw), then lo
  float* fence = sq + (QSPLIT ? 2 : 1) * BQ * DM;  // [NT], KS == 2

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;  // accumulator row, column pair
  const int strip = warp % 4, half = warp / 4;
  const int r0 = strip * 16 + grp;  // this lane's rows: r0 and r0 + 8
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = b * Hk + h / (H / Hk);
  const float* qg = q + (size_t)bh * Lq * D;
  const float* kg = k + (size_t)kvh * Lk * D;
  const float* vg = v + (size_t)kvh * Lk * D;
  const int q_offset = Lk - Lq;
  int n_tiles = cdiv(Lk, BK);
  if (causal) {
    const int last_row = min(q0 + BQ, Lq) - 1;
    n_tiles = min(n_tiles, (q_offset + last_row) / BK + 1);
  }

  load_rows<DM, NT, BK, PK, VEC>(sk, kg, 0, Lk, D);
  load_rows<DM, NT, BK, PV, VEC>(sv, vg, 0, Lk, D);
  tc::cp_async_commit();

  // Q * scale * log2(e), split once (or, at DM 256, staged raw) into
  // shared memory while tile 0 lands.
  for (int e = threadIdx.x; e < BQ * DM; e += NT) {
    const int r = e / DM, col = e % DM, row = q0 + r;
    const float x = (row < Lq && col < D)
                        ? qg[(size_t)row * D + col] * scale_log2
                        : 0.f;
    // Row r is strip r / 16, fragment row r % 8 (+ 8); column col is
    // k-step col / 8, lane column col % 8 / 2 (pair col % 2).
    const int at = (((r / 16) * KD + col / 8) * 32 + r % 8 * 4
                    + col % 8 / 2) * 4 + r % 16 / 8 + 2 * (col % 2);
    if constexpr (QSPLIT) {
      uint32_t hi, lo;
      split(x, hi, lo);
      sq[at] = __uint_as_float(hi);
      sq[BQ * DM + at] = __uint_as_float(lo);
    } else {
      sq[at] = x;
    }
  }

  float acc[KD][4];  // O: rows r0, r0 + 8; columns 8 j + 2 tig, + 1
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    // Tile t (and Q's shared copy) has landed, and every warp is done
    // with tile t - 1, whose stage the next load overwrites.
    tc::cp_async_wait_all();
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int st = (t + 1) % 2;
      load_rows<DM, NT, BK, PK, VEC>(sk + st * BK * PK, kg, (t + 1) * BK,
                                     Lk, D);
      load_rows<DM, NT, BK, PV, VEC>(sv + st * BK * PV, vg, (t + 1) * BK,
                                     Lk, D);
      tc::cp_async_commit();
    }
    // This warp's keys of the tile: rows half * NS * 8 .. of the stage.
    const float* kt = sk + (t % 2) * BK * PK + half * NS * 8 * PK;
    const float* vt = sv + (t % 2) * BK * PV + half * NS * 8 * PV;

    // S = Q K^T: NS tiles of 8 keys; K rows are the col-major B operand.
    float s[NS][4], ss[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = ss[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ah[4], al[4];
      {  // this lane's A fragment of k-step kk
        const float* qa = sq + ((strip * KD + kk) * 32 + lane) * 4;
        const float4 x = *reinterpret_cast<const float4*>(qa);
        if constexpr (QSPLIT) {
          const float4 y = *reinterpret_cast<const float4*>(qa + BQ * DM);
          ah[0] = __float_as_uint(x.x);
          ah[1] = __float_as_uint(x.y);
          ah[2] = __float_as_uint(x.z);
          ah[3] = __float_as_uint(x.w);
          al[0] = __float_as_uint(y.x);
          al[1] = __float_as_uint(y.y);
          al[2] = __float_as_uint(y.z);
          al[3] = __float_as_uint(y.w);
        } else {
          split(x.x, ah[0], al[0]);
          split(x.y, ah[1], al[1]);
          split(x.z, ah[2], al[2]);
          split(x.w, ah[3], al[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float2 kx = *reinterpret_cast<const float2*>(
            kt + (n * 8 + grp) * PK + kk * 8 + 2 * tig);
        uint32_t bh0, bl0, bh1, bl1;
        split(kx.x, bh0, bl0);
        split(kx.y, bh1, bl1);
        mma3(s[n], ss[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }

    // Element e of s[n] is row r0 + 8 (e / 2), key 8 n + 2 tig + e % 2 of
    // this warp's keys; the scores are in log2 units already (Q carries
    // scale * log2(e)).
    const int key0 = t * BK + half * NS * 8;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += ss[n][e];
    if (t * BK + BK > Lk || (causal && t * BK + BK - 1 > q_offset + q0)) {
      const int qpos = q_offset + q0 + r0;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + n * 8 + tig * 2 + e % 2;
          if (key >= Lk || (causal && key > qpos + 8 * (e / 2)))
            s[n][e] = -CUDART_INF_F;  // exp2 gives exactly 0
        }
    }

    // Online softmax on the two rows this lane holds; a row's scores lie
    // on the 4 lanes of a quad.
    float alpha[2], m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // A row with every key so far masked keeps NEG_INF (finite), so
      // alpha is 1 and its masked p stay 0.
      m_new[i] = fmaxf(m_run[i], mx);
      alpha[i] = exp2f(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
    }
    // P as the A fragments of P V, split: k-step n's a0..a3 are p of
    // (row, key) (r0, 2 tig), (r0 + 8, 2 tig), (r0, 2 tig + 1),
    // (r0 + 8, 2 tig + 1) of score tile n.
    uint32_t ph[NS][4], pl[NS][4];
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float p0 = exp2f(s[n][0] - m_new[0]);
      const float p1 = exp2f(s[n][1] - m_new[0]);
      const float p2 = exp2f(s[n][2] - m_new[1]);
      const float p3 = exp2f(s[n][3] - m_new[1]);
      rsum[0] += p0 + p1;
      rsum[1] += p2 + p3;
      split(p0, ph[n][0], pl[n][0]);
      split(p2, ph[n][1], pl[n][1]);
      split(p1, ph[n][2], pl[n][2]);
      split(p3, ph[n][3], pl[n][3]);
    }
    // The lane's partial normaliser; the quad sums it once, at the end.
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rsum[i];

    // O = O * alpha + P V, JG column tiles at a time, each summed over
    // this warp's keys of the tile apart; V rows 8 n + 2 tig and
    // 8 n + 2 tig + 1 are the B operand's k indices tig and tig + 4.
    if constexpr (KS == 2) {
      // A store of the softmax's result that V's reads may not pass: the
      // assembler, free to, hoists them above the softmax, where they hold
      // registers that O needs, and spills O (DM 192, 256).
      fence[threadIdx.x] = l_run[0];
    }
#pragma unroll
    for (int j0 = 0; j0 < KD; j0 += JG) {
      float pb[JG][4], ps[JG][4];
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) pb[jj][e] = ps[jj][e] = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float* vb = vt + (n * 8 + 2 * tig) * PV + j0 * 8 + grp;
#pragma unroll
        for (int jj = 0; jj < JG; ++jj) {
          uint32_t bh0, bl0, bh1, bl1;
          split(vb[jj * 8], bh0, bl0);
          split(vb[PV + jj * 8], bh1, bl1);
          mma3(pb[jj], ps[jj], ph[n], pl[n], bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j0 + jj][e] = fmaf(acc[j0 + jj][e], alpha[e / 2],
                                 pb[jj][e] + ps[jj][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  if constexpr (KS == 2) {
    // The strip's second warp hands its max, normaliser and O to the
    // first through the ring's memory (every warp is done with it), which
    // merges the two walks.
    float* xs = reinterpret_cast<float*>(smem) + (strip * 32 + lane)
                                                     * (4 * KD + 4);
    __syncthreads();
    if (half == 1) {
      xs[0] = m_run[0];
      xs[1] = m_run[1];
      xs[2] = l_run[0];
      xs[3] = l_run[1];
#pragma unroll
      for (int j = 0; j < KD; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[4 + 4 * j + e] = acc[j][e];
    }
    __syncthreads();
    if (half == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = xs[i], m = fmaxf(m_run[i], m1);
      a0[i] = exp2f(m_run[i] - m);
      a1[i] = exp2f(m1 - m);
      l_run[i] = l_run[i] * a0[i] + xs[2 + i] * a1[i];
    }
#pragma unroll
    for (int j = 0; j < KD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = acc[j][e] * a0[e / 2] + xs[4 + 4 * j + e] * a1[e / 2];
  }

  float* og = o + (size_t)bh * Lq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
    const int row = q0 + r0 + 8 * i;
    if (row >= Lq) continue;
    float* orow = og + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      const int col = j * 8 + tig * 2;
      const float x = acc[j][2 * i] * inv, y = acc[j][2 * i + 1] * inv;
      if (VEC) {
        if (col < D)
          *reinterpret_cast<float2*>(orow + col) = make_float2(x, y);
      } else {
        if (col < D) orow[col] = x;
        if (col + 1 < D) orow[col + 1] = y;
      }
    }
  }
}

template <int DM, bool VEC>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hk, int Lq, int Lk, int D, int causal, float scale,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DM>();
  static_assert(bytes <= 232448, "227 KB a block");
  static bool allowed[MAX_DEVICES] = {};
  const int err = allow_smem(flash_f32_kernel<DM, VEC>, bytes, allowed);
  if (err) return err;
  const dim3 grid(cdiv(Lq, BQ), B * H);
  flash_f32_kernel<DM, VEC><<<grid, threads<DM>(), bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hk, Lq, Lk, D,
      causal, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int DM>
int launch_dm(bool vec, const void* q, const void* k, const void* v, void* o,
              int B, int H, int Hk, int Lq, int Lk, int D, int causal,
              float scale, cudaStream_t stream) {
  return vec ? launch<DM, true>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal,
                                scale, stream)
             : launch<DM, false>(q, k, v, o, B, H, Hk, Lq, Lk, D, causal,
                                 scale, stream);
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hk, int Lq, int Lk, int D, int causal, float scale,
             cudaStream_t stream) {
  const bool vec = D % 4 == 0 && ((uintptr_t)q | (uintptr_t)k |
                                  (uintptr_t)v | (uintptr_t)o) % 16 == 0;
  if (D <= 64)
    return launch_dm<64>(vec, q, k, v, o, B, H, Hk, Lq, Lk, D, causal, scale,
                         stream);
  if (D <= 80)
    return launch_dm<80>(vec, q, k, v, o, B, H, Hk, Lq, Lk, D, causal, scale,
                         stream);
  if (D <= 128)
    return launch_dm<128>(vec, q, k, v, o, B, H, Hk, Lq, Lk, D, causal,
                          scale, stream);
  if (D <= 192)
    return launch_dm<192>(vec, q, k, v, o, B, H, Hk, Lq, Lk, D, causal,
                          scale, stream);
  return launch_dm<256>(vec, q, k, v, o, B, H, Hk, Lq, Lk, D, causal, scale,
                        stream);
}

}  // namespace f32

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
  return f32::dispatch(q, k, v, o, B, H, Hk, Lq, Lk, D, causal, scale,
                       stream);
}

}  // extern "C"
