// Fused FFN block: LayerNorm -> fc1 -> SiLU -> fc2 -> dropout -> residual,
// forward and backward. The forward writes no (R, F) intermediate; the
// backward at D 256 writes bf16 a and gh1 (R, F) once, for its weight
// gradients.
//
// Replaces: pytorch_end2end_speech_recognition_tpu/ops/ffn_pallas.py
//   _ffn_fwd (pallas_call at :172, kernel body _fwd_kernel :77) and
//   _ffn_bwd (pallas_call at :209, kernel body _bwd_kernel :94).
//
// Per row r of x (R, D), with W1 = fc1.weight (F, D) and W2 = fc2.weight
// (D, F) as nn.Linear holds them (the JAX kernel's w1 and w2 are their
// transposes), all bf16:
//   y  = LN(x) = (x - mean) rstd gamma + beta      float32, eps 1e-6
//   h1 = bf16(y) W1^T + b1                          float32 accumulation
//   a  = h1 sigmoid(h1)                             float32
//   h2 = rd(bf16(a) W2^T + b2)                      rd: rounded to x's dtype
//   out = x + scale keep(r, c) h2                   rounded once to x's dtype
// keep(r, c) is 0 or 1/(1-rate): a counter-based hash of (seed, global row,
// column), murmur3's fmix32 three times, drops iff (low 24 bits) / 2^24 <
// rate. It depends on nothing but those three, so no tile size changes it,
// and the backward regenerates it bit for bit (the TPU kernel draws the
// same role from its hardware PRNG). The seed is read from device memory.
// The backward recomputes y, h1 and a from x and returns, as the TPU kernel:
//   g2 = scale g keep,  dW2 = bf16(g2)^T bf16(a),  db2 = sum_r g2,
//   gh1 = (bf16(g2) W2) sigmoid'(h1 ...) (silu'),  dW1 = bf16(gh1)^T bf16(y),
//   db1 = sum_r gh1,  gy = bf16(gh1) W1,  dgamma = sum_r gy xn,
//   dbeta = sum_r gy,  dx = g + rstd (gy gamma - mean(gy gamma)
//   - xn mean(gy gamma xn)), the weight gradients summed in float32.
//
// Bound on the H100 at the flagship shape (R = 24,000, D 256, F 1,024):
// the forward does 4 R D F = 25 GFLOP (25 us at 989 TFLOP/s bf16) against
// ~25 MB of x and out (7.5 us at 3.35 TB/s); the backward's function needs
// five products (h1, dW2, ga, dW1, gy; h2 enters no gradient), 10 R D F =
// 63 GFLOP (64 us) against ~40 MB: the tensor cores bound both. Unfused,
// the two (R, F) activations alone would move ~200 MB each way.
//
// Design. The TPU kernel keeps W1, W2 and their float32 gradient sums
// (6 MB) in VMEM and walks row tiles in order. One SM holds 227 KB, so
// here the weights stream through shared memory and the weight gradients
// come from a second pass:
// - at D 256 (the flagship's and rung 3's width), wgmma and TMA: the
//   forward `hop::ffn_fwd_wgmma_kernel` and the backward's three launches
//   (`hop::ffn_bwd_rows_wgmma_kernel`, `hop::ffn_bwd_weights_wgmma_kernel`,
//   `ffn_bwd_sum_kernel`), each described where it is defined; the
//   backward does the function's 10 R D F, and writes bf16 a and gh1 (R, F)
//   once for its weight-gradient products.
// - at D 512 (rung 4's width, which `fits_vmem` sends to no model path),
//   mma.sync: the forward's block (D threads: 4 row warps x D/128 column
//   warps) owns 64 rows, keeps bf16 LN(x) in shared memory, and walks F in
//   chunks of 32 through a cp.async double buffer; per chunk h1 = y W1c^T
//   on the tensor cores (mma.sync m16n8k16, bf16 in, float32 out), SiLU,
//   bf16 a into shared memory, then out_acc += a W2c^T into a (64, D)
//   float32 accumulator in registers; the epilogue adds b2, applies the
//   mask and the residual. Its backward: launch A (row tiles) recomputes h1
//   and ga = bf16(g2) W2c, forms gh1, accumulates gy += gh1 W1c, writes dx,
//   the tile's column sums of gy xn, gy and g2, and bf16 y and g2 (R, D);
//   launch B (a block per F chunk and row split) recomputes h1 and ga from
//   them and accumulates dW2c += g2^T a and dW1c += gh1^T y (operands
//   transposed by ldmatrix.trans): 14 R D F in all.
// - `ffn_bwd_sum_kernel` adds the partials of either in a fixed order:
//   the weight gradients are deterministic.
// No library product is called.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BR = 64;  // rows per tile: 4 warps x 16
constexpr float LN_EPS = 1e-6f;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// mma fragments (g = lane / 4, t = lane % 4). A is 16 x 16 at (m0, k0), B
// is 16 x 8 at (k0, n0).
// A from a row-major [M][K] tile.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s, int ld,
                                       int m0, int k0, int g, int t) {
  const bf16* p0 = s + (m0 + g) * ld + k0 + 2 * t;
  const bf16* p1 = p0 + 8 * ld;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// A from a [K][M] tile (A^T stored row-major), transposed by ldmatrix.
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const bf16* s,
                                         int ld, int m0, int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  const bf16* p = s + (k0 + (q >> 1) * 8 + r) * ld + m0 + (q & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// B from an [N][K] tile (B column-major: nn.Linear's weight rows).
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* s, int ld, int n0, int k0,
                                       int g, int t) {
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B from a [K][N] tile (B row-major), transposed by ldmatrix.
__device__ __forceinline__ void frag_b_t(uint32_t& b0, uint32_t& b1,
                                         const bf16* s, int ld, int n0, int k0,
                                         int lane) {
  const int l = lane & 15;
  const bf16* p = s + (k0 + (l >> 3) * 8 + (l & 7)) * ld + n0;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- the dropout mask: keep(r, c) from (seed, global row, column)
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t row_key(uint32_t seed, uint32_t row) {
  return fmix32(fmix32(seed + 0x9E3779B9u) ^ row);
}

// 0 (dropped) or keep_scale = 1 / (1 - rate)
__device__ __forceinline__ float keep_mult(uint32_t rk, uint32_t col,
                                           float rate, float keep_scale) {
  const uint32_t u24 = fmix32(rk ^ col) & 0xFFFFFFu;
  return (float)u24 * (1.0f / 16777216.0f) < rate ? 0.f : keep_scale;
}

// ---- the residual dtype (float or bf16)
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16(v));
  return v;
}

template <typename T>
__device__ __forceinline__ void load2(const T* p, float& a, float& b) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    a = __low2float(v);
    b = __high2float(v);
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a = v.x;
    b = v.y;
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (sizeof(T) == 2)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// v sigmoid(v) with the fast exponential and division (a few ulp of
// float32, far below the bf16 rounding of a that follows); 0 where
// exp(-v) overflows
__device__ __forceinline__ float silu_fast(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

// LayerNorm of the tile's 64 rows, a warp per row: bf16 y into sY (and
// into y_out when given), the rows' mean and rstd into s_mean / s_rstd.
// Rows past R read as zeros (y = beta; finite, and never stored).
template <int D, typename XT>
__device__ void layer_norm_tile(const XT* __restrict__ x,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta, int R, int r0,
                                bf16* sY, float* s_mean, float* s_rstd,
                                bf16* __restrict__ y_out, int warp, int lane,
                                int nwarps) {
  constexpr int PER = D / 32, LDD = D + 8;
  for (int r = warp; r < BR; r += nwarps) {
    const int row = r0 + r;
    float v[PER];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      v[j] = row < R ? to_f(x[(size_t)row * D + lane + 32 * j]) : 0.f;
      sum += v[j];
    }
    const float mean = warp_sum(sum) * (1.f / D);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const float d = v[j] - mean;
      sq += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(sq) * (1.f / D) + LN_EPS);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      const bf16 y = __float2bfloat16((v[j] - mean) * rstd * gamma[c] + beta[c]);
      sY[r * LDD + c] = y;
      if (y_out != nullptr && row < R) y_out[(size_t)row * D + c] = y;
    }
    if (lane == 0) {
      s_mean[r] = mean;
      s_rstd[r] = rstd;
    }
  }
}

// F-chunk of the weights into shared memory: W1 rows f0.. as [FC][D+8],
// W2 columns f0.. as [D][FC+8].
template <int D, int FC>
__device__ __forceinline__ void load_weight_chunk(
    const bf16* __restrict__ w1, const bf16* __restrict__ w2, int F, int f0,
    bf16* d1, bf16* d2, int tid, int nthreads) {
  constexpr int LDD = D + 8, LDF = FC + 8;
  for (int i = tid; i < FC * (D / 8); i += nthreads) {
    const int r = i / (D / 8), cc = (i % (D / 8)) * 8;
    cp_async16(d1 + r * LDD + cc, w1 + (size_t)(f0 + r) * D + cc, true);
  }
  for (int i = tid; i < D * (FC / 8); i += nthreads) {
    const int r = i / (FC / 8), cc = (i % (FC / 8)) * 8;
    cp_async16(d2 + r * LDF + cc, w2 + (size_t)r * F + f0 + cc, true);
  }
}

template <int D, int FC, int STAGES>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return 2 * BR * sizeof(float) +
         (size_t)(BR * (D + 8) + STAGES * (FC * (D + 8) + D * (FC + 8)) +
                  BR * (FC + 8)) * sizeof(bf16);
}

// ------------------------------------------------------------------ forward
// grid: one block per 64-row tile; D threads (4 row warps x D/128 column
// warps). Each warp owns 16 rows x 128 columns of the output accumulator.
template <int D, int FC, typename XT>
__global__ void __launch_bounds__(D)
ffn_fwd_kernel(const XT* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const bf16* __restrict__ w1,
               const bf16* __restrict__ b1, const bf16* __restrict__ w2,
               const bf16* __restrict__ b2, const int* __restrict__ seed,
               XT* __restrict__ out, int R, int F, float scale, float rate,
               float keep_scale) {
  constexpr int C = D / 128;         // column warps
  constexpr int LDD = D + 8, LDF = FC + 8;
  constexpr int CW = FC / C;         // h1 columns per warp
  constexpr int NT1 = CW / 8;
  constexpr int STAGE = FC * LDD + D * LDF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_mean = reinterpret_cast<float*>(smem_raw);
  float* s_rstd = s_mean + BR;
  bf16* sY = reinterpret_cast<bf16*>(s_rstd + BR);
  bf16* sStage = sY + BR * LDD;
  bf16* sA = sStage + 2 * STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp & 3, cw = warp >> 2;
  const int r0 = blockIdx.x * BR;
  const int nC = F / FC;

  load_weight_chunk<D, FC>(w1, w2, F, 0, sStage, sStage + FC * LDD, tid, D);
  cp_async_commit();
  layer_norm_tile<D, XT>(x, gamma, beta, R, r0, sY, s_mean, s_rstd, nullptr,
                         warp, lane, D / 32);

  float acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int c = 0; c < nC; ++c) {
    const int s = c & 1;
    if (c + 1 < nC) {
      bf16* nxt = sStage + (s ^ 1) * STAGE;
      load_weight_chunk<D, FC>(w1, w2, F, (c + 1) * FC, nxt, nxt + FC * LDD,
                               tid, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* W1 = sStage + s * STAGE;
    const bf16* W2 = W1 + FC * LDD;

    // h1 = y W1c^T: this warp's 16 rows x CW columns of the chunk
    float h[NT1][4];
#pragma unroll
    for (int nt = 0; nt < NT1; ++nt) h[nt][0] = h[nt][1] = h[nt][2] = h[nt][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, sY, LDD, rw * 16, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt) {
        uint32_t b0, b1v;
        frag_b(b0, b1v, W1, LDD, cw * CW + nt * 8, kk * 16, g, t);
        mma_bf16(h[nt], a, b0, b1v);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT1; ++nt) {
      const int col = cw * CW + nt * 8 + 2 * t;
      const float c0 = __bfloat162float(b1[c * FC + col]);
      const float c1 = __bfloat162float(b1[c * FC + col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v0 = h[nt][2 * half] + c0, v1 = h[nt][2 * half + 1] + c1;
        *reinterpret_cast<uint32_t*>(sA + (rw * 16 + g + 8 * half) * LDF + col) =
            pack_bf16(v0 * sigmoid(v0), v1 * sigmoid(v1));
      }
    }
    __syncthreads();

    // out_acc += a W2c^T: 16 rows x this warp's 128 output columns
#pragma unroll
    for (int kk = 0; kk < FC / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, sA, LDF, rw * 16, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        uint32_t b0, b1v;
        frag_b(b0, b1v, W2, LDF, cw * 128 + nt * 8, kk * 16, g, t);
        mma_bf16(acc[nt], a, b0, b1v);
      }
    }
    __syncthreads();  // stage s and sA are free for the next chunk
  }

  const uint32_t sd = rate > 0.f ? static_cast<uint32_t>(seed[0]) : 0u;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + rw * 16 + g + 8 * half;
    if (row >= R) continue;
    const uint32_t rk = row_key(sd, row);
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int col = cw * 128 + nt * 8 + 2 * t;
      float v0 = round_to<XT>(acc[nt][2 * half] + __bfloat162float(b2[col]));
      float v1 = round_to<XT>(acc[nt][2 * half + 1] + __bfloat162float(b2[col + 1]));
      if (rate > 0.f) {
        v0 *= keep_mult(rk, col, rate, keep_scale);
        v1 *= keep_mult(rk, col + 1, rate, keep_scale);
      }
      float x0, x1;
      load2(x + (size_t)row * D + col, x0, x1);
      store2(out + (size_t)row * D + col, x0 + scale * v0, x1 + scale * v1);
    }
  }
}

// ------------------------------------------------- forward for Hopper (D 256)
// The forward has the shape of flash attention's: y plays Q, W1's chunk K,
// W2's chunk V, and b1 + SiLU takes the softmax's place. So it is built as
// FlashAttention-3 builds that loop:
// - a block of two consumer warpgroups (64 rows each, a 128-row tile) and
//   one producer warp; blocks are persistent, each walking the row tiles
//   blockIdx.x, blockIdx.x + gridDim.x, ...;
// - the producer's one thread streams each F chunk of 64 (W1's rows as four
//   64 x 64 boxes, W2's columns as one 256 x 64 box, 64 KB) by TMA into a
//   two-stage ring guarded by mbarriers; the two warpgroups share every
//   stage, so the weights cross L2 once per 128 rows;
// - each warpgroup writes the LayerNorm of its rows once per tile, as bf16
//   y in the swizzled layout wgmma reads; h1 = y W1c^T is 16 wgmma
//   m64n64k16 with both operands in shared memory;
// - b1 and SiLU in registers, a rounded to bf16 there and fed as the
//   register A operand of out_acc += a W2c^T (4 wgmma m64n256k16): a never
//   touches shared memory, and the two products are separated only by the
//   wgmma wait;
// - the (64, 256) float32 accumulator (128 registers a thread) stays in
//   registers across the chunks; the epilogue is the mma.sync kernel's.
// The producer is a whole warpgroup (one thread of it issues the loads):
// setmaxnreg hands its registers to the consumers, 232 a thread against the
// 168 that 384 threads would each get, enough for the accumulator, h1 and
// a without spills.
// At the flagship's R = 24,000: 188 tiles on 132 SMs, 1.42 waves (56 SMs
// take two tiles).
namespace hop {

using namespace hopper;
constexpr int D = 256, FC = 64, ROWS = 128, STAGES = 2;
constexpr int THREADS = 384;                    // 2 consumer + 1 producer WG
constexpr uint32_t Y_BYTES = 64 * D * 2;        // a warpgroup's y: 32 KB
constexpr uint32_t W1_BYTES = FC * D * 2;       // W1's chunk: 32 KB
constexpr uint32_t W2_BYTES = D * FC * 2;       // W2's chunk: 32 KB
constexpr uint32_t STAGE_BYTES = W1_BYTES + W2_BYTES;
constexpr size_t SMEM = 1024 /* alignment */ + 2 * Y_BYTES +
                        STAGES * STAGE_BYTES + 64 /* barriers */;

template <typename XT>
__global__ void __launch_bounds__(THREADS, 1)
ffn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_w1,
                     const __grid_constant__ CUtensorMap tm_w2,
                     const XT* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                     const int* __restrict__ seed, XT* __restrict__ out, int R,
                     int F, float scale, float rate, float keep_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sY = base;                                  // [2][Y_BYTES]
  unsigned char* sW = base + 2 * Y_BYTES;                    // [STAGES][W1|W2]
  uint64_t* full = reinterpret_cast<uint64_t*>(sW + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int n_tiles = (R + ROWS - 1) / ROWS;
  const int nC = F / FC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // ------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int c = 0; c < nC; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* w1s = sW + stage * STAGE_BYTES;
          mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
#pragma unroll
          for (int kb = 0; kb < D / 64; ++kb)
            tma_load_2d(w1s + kb * (FC * 128), &tm_w1, &full[stage], kb * 64,
                        c * FC);
          tma_load_2d(w1s + W1_BYTES, &tm_w2, &full[stage], c * FC, 0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
  setmaxnreg_inc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* myY = sY + wg * Y_BYTES;
  const uint32_t sd = rate > 0.f ? static_cast<uint32_t>(seed[0]) : 0u;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * ROWS + wg * 64;  // this warpgroup's first row
    // LayerNorm, a warp per row, 8 columns a lane: bf16 y into the
    // swizzled column blocks (lane's 16-byte chunk: block lane / 8, chunk
    // lane % 8). Rows past R read as zeros (y = beta, never stored).
    for (int r = warp; r < 64; r += 4) {
      const int row = r0 + r;
      float v[8];
      if (row < R) {
        const XT* px = x + (size_t)row * D + lane * 8;
#pragma unroll
        for (int j = 0; j < 8; j += 2) load2(px + j, v[j], v[j + 1]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += v[j];
      const float mean = warp_sum(sum) * (1.f / D);
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sq += (v[j] - mean) * (v[j] - mean);
      const float rstd = 1.f / sqrtf(warp_sum(sq) * (1.f / D) + LN_EPS);
      __align__(16) bf16 y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = lane * 8 + j;
        y[j] = __float2bfloat16((v[j] - mean) * rstd * gamma[c] + beta[c]);
      }
      *reinterpret_cast<uint4*>(myY + (lane >> 3) * (64 * 128) +
                                sw128_offset(r, (lane & 7) * 8)) =
          *reinterpret_cast<uint4*>(y);
    }
    fence_proxy_async();
    warpgroup_sync(1 + wg);

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float h[32];
    uint32_t a[FC / 16][4], a_next[FC / 16][4];
    // h1 = y W1c^T for the chunk in `st`: K = D in 16 steps (4 column
    // blocks of 4 steps); issued, not awaited
    auto issue_h1 = [&](int st) {
      const unsigned char* w1s = sW + st * STAGE_BYTES;
#pragma unroll
      for (int i = 0; i < 32; ++i) h[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
        wgmma_m64n64k16_ss<0>(h, desc_sw128(myY + off),
                              desc_sw128(w1s + off), kk > 0 ? 1 : 0);
      }
      wgmma_commit();
    };
    // a = silu(h1 + b1) of chunk c, bf16: the A fragments of the second
    // product, k step kk from h1's 8-column blocks 2kk and 2kk + 1
    auto silu_a = [&](int c, uint32_t (&dst)[FC / 16][4]) {
#pragma unroll
      for (int j = 0; j < FC / 8; ++j) {
        const int col = c * FC + j * 8 + 2 * t;
        const float c0 = __bfloat162float(b1[col]);
        const float c1 = __bfloat162float(b1[col + 1]);
        const float v0 = h[4 * j] + c0, v1 = h[4 * j + 1] + c1;
        const float v2 = h[4 * j + 2] + c0, v3 = h[4 * j + 3] + c1;
        dst[j >> 1][(j & 1) * 2 + 0] =
            pack_bf16(silu_fast(v0), silu_fast(v1));
        dst[j >> 1][(j & 1) * 2 + 1] =
            pack_bf16(silu_fast(v2), silu_fast(v3));
      }
    };
    mbar_wait(&full[stage], phase);
    issue_h1(stage);
    wgmma_wait<0>();
    fence_operand(h);
    silu_a(0, a);
    // out_acc += a W2c^T for the chunk in stage st (K = FC in 4 steps of
    // 32 bytes along W2's rows), with a fence of its own, so that an h1
    // issued before it is a pipeline stage of its own
    auto issue_out = [&](int st) {
      fence_operand(acc);
      wgmma_fence();
      const unsigned char* w2s = sW + st * STAGE_BYTES + W1_BYTES;
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk)
        wgmma_m64n256k16_rs<0>(acc, a[kk], desc_sw128(w2s + kk * 32));
      wgmma_commit();
    };
    auto next_stage = [&]() {
      const int cur = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
      return cur;
    };
    // every chunk but the last: the next chunk's h1 goes to the tensor
    // cores first, then this chunk's second product, and the next SiLU
    // runs while the latter computes; no branch between issue and wait
    for (int c = 0; c + 1 < nC; ++c) {
      const int cur = next_stage();
      mbar_wait(&full[stage], phase);
      issue_h1(stage);
      issue_out(cur);
      wgmma_wait<1>();
      fence_operand(h);
      silu_a(c + 1, a_next);
      wgmma_wait<0>();
      fence_operand(acc);
      fence_operand(a);
      mbar_arrive(&empty[cur]);
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) a[kk][r] = a_next[kk][r];
    }
    {  // the last chunk's second product
      const int cur = next_stage();
      issue_out(cur);
      wgmma_wait<0>();
      fence_operand(acc);
      fence_operand(a);
      mbar_arrive(&empty[cur]);
    }

    // + b2, rounded to x's dtype, the mask, the residual
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + warp * 16 + g + 8 * half;
      if (row >= R) continue;
      const uint32_t rk = row_key(sd, row);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = j * 8 + 2 * t;
        float v0 = round_to<XT>(acc[4 * j + 2 * half] +
                                __bfloat162float(b2[col]));
        float v1 = round_to<XT>(acc[4 * j + 2 * half + 1] +
                                __bfloat162float(b2[col + 1]));
        if (rate > 0.f) {
          v0 *= keep_mult(rk, col, rate, keep_scale);
          v1 *= keep_mult(rk, col + 1, rate, keep_scale);
        }
        float x0, x1;
        load2(x + (size_t)row * D + col, x0, x1);
        store2(out + (size_t)row * D + col, x0 + scale * v0, x1 + scale * v1);
      }
    }
    // the next tile's LayerNorm rewrites y: every warp of this warpgroup
    // is past its products (their waits) before any warp writes
    warpgroup_sync(1 + wg);
  }
  }  // consumers
}

// the tensor maps of W1 (F, D) and W2 (D, F), bf16 row-major
inline cudaError_t weight_maps(CUtensorMap* m1, CUtensorMap* m2,
                               const void* w1, const void* w2, int F) {
  const uint64_t d1[2] = {(uint64_t)D, (uint64_t)F}, s1[1] = {D * 2ull};
  const uint32_t b1[2] = {64, FC};
  cudaError_t e = encode_bf16_sw128(m1, w1, 2, d1, s1, b1);
  if (e != cudaSuccess) return e;
  const uint64_t d2[2] = {(uint64_t)F, (uint64_t)D}, s2[1] = {F * 2ull};
  const uint32_t b2[2] = {FC, D};
  return encode_bf16_sw128(m2, w2, 2, d2, s2, b2);
}


// ------------------------------------------------ backward for Hopper (D 256)
// Three launches, the function's five products and no more (10 R D F):
// - launch A (`ffn_bwd_rows_wgmma_kernel`) is the forward's structure with
//   two more products: persistent blocks of two consumer warpgroups (64 rows
//   each, a 128-row tile) and a producer warpgroup whose one thread streams
//   each F chunk of 64 by TMA: W1's rows (four 64 x 64 boxes) into a
//   two-stage ring, W2's columns (one 256 x 64 box) into a buffer of their
//   own, which frees as soon as ga has read it. Per tile each warpgroup
//   writes bf16 y = LN(x) and bf16 g2 = scale g keep in the swizzled layout
//   (and to yw, g2w for launch B). Per chunk:
//     h1 = y W1c^T (W1's boxes K-major) and ga = g2 W2c (W2's box read
//     MN-major), m64n64k16 with both operands in shared memory;
//     in registers a = silu(h1 + b1) and gh1 = ga silu'(h1 + b1); their
//     bf16 values, the operands of dW2 and dW1, stored to aw and hw (R, F);
//     gh1's float32 column sums (db1) per warp into db1p;
//     gy += bf16(gh1) W1c: gh1 is the register A operand, W1's four boxes
//     the MN-major B operand (LBO one box), m64n256k16 into a (64, 256)
//     float32 gy held in registers across the chunks.
//   The next chunk's ga and h1 go to the tensor cores right behind this
//   chunk's gy, three wgmma groups awaited in order: gy's end frees W1's
//   stage, ga's W2's buffer; the two warpgroups take turns at issuing, so
//   that one's register work overlaps the other's products. The epilogue
//   is the LayerNorm backward, with gy moved through the freed y and g2
//   buffers to a warp-per-row layout: dx, and the column sums of gy xn, gy
//   and g2 (dgamma, dbeta, db2) over each warp's 16 rows into part. Shared
//   memory: y and g2 of both warpgroups (128 KB), W1's two stages (64 KB),
//   W2's chunk (32 KB).
// - launch B (`ffn_bwd_weights_wgmma_kernel`): dW2 = bf16(g2)^T bf16(a) and
//   dW1 = bf16(gh1)^T bf16(y), plain TMA-fed products over the rows: a block
//   owns one 128 x 256 output tile of one of them and one of S row splits,
//   so that (tiles x S) blocks fill the card once. The rows are the
//   products' K, so every operand arrives as it lies in memory and is read
//   MN-major. Partial sums per split, float32.
// - launch C (`ffn_bwd_sum_kernel`) adds the partials in a fixed order.
// Scratch: a and gh1 (R, F) bf16 each, written once and read once (98 MB
// at R = 24,000), against the four products launch B would recompute.
// Cycles per phase of launch A's row tiles (consumer thread 0 of block 0),
// for csrc/probe/ffn_logmel_phases.py, which builds this file with
// -DFFN_PHASES; the kernel library compiles the markers to nothing.
#ifdef FFN_PHASES
__device__ long long ffn_phase_cycles[16];
#define PHASES_BEGIN long long ph_last_ = clock64(), ph_acc_[16] = {};
#define PHASE(i)                    \
  do {                              \
    const long long c_ = clock64(); \
    ph_acc_[i] += c_ - ph_last_;    \
    ph_last_ = c_;                  \
  } while (0)
#define PHASES_END                                 \
  if (threadIdx.x == 0 && blockIdx.x == 0)         \
    for (int i_ = 0; i_ < 16; ++i_) ffn_phase_cycles[i_] = ph_acc_[i_];
#else
#define PHASES_BEGIN
#define PHASE(i)
#define PHASES_END
#endif

constexpr uint32_t BWD_W_BYTES = 2 * W1_BYTES + W2_BYTES;  // 96 KB
constexpr size_t BWD_SMEM = 1024 + 4 * Y_BYTES + BWD_W_BYTES + 64;

// float32 sigmoid with the fast exponential and division (a few ulp, far
// below the bf16 rounding of a and gh1 that follows; no branch, so the
// compiler interleaves many of them): 0 where exp(-v) overflows
__device__ __forceinline__ float sigmoid_fast(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}

// 2 x 2 transpose across a lane pair (lanes 2p, 2p + 1; e = lane % 2): on
// return x[k] holds what pair lane k held in x[e]
__device__ __forceinline__ void pair_transpose(uint32_t (&x)[2], int e) {
  const uint32_t r = __shfl_xor_sync(0xffffffffu, e ? x[0] : x[1], 1);
  x[0] = e ? r : x[0];
  x[1] = e ? x[1] : r;
}

template <typename XT>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_rows_wgmma_kernel(const __grid_constant__ CUtensorMap tm_w1,
                          const __grid_constant__ CUtensorMap tm_w2,
                          const XT* __restrict__ x, const XT* __restrict__ gin,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          const bf16* __restrict__ b1,
                          const int* __restrict__ seed, XT* __restrict__ dx,
                          bf16* __restrict__ yw, bf16* __restrict__ g2w,
                          bf16* __restrict__ aw, bf16* __restrict__ hw,
                          float* __restrict__ part, float* __restrict__ db1p,
                          int R, int F, float scale, float rate,
                          float keep_scale) {
  // aligned by pointer arithmetic on smem_raw, not through an integer, so
  // that the compiler keeps every access below in the shared state space
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sY = base;                  // [2][Y_BYTES]
  unsigned char* sG = base + 2 * Y_BYTES;    // [2][Y_BYTES]
  unsigned char* sW1 = base + 4 * Y_BYTES;   // [2][W1_BYTES]
  unsigned char* sW2 = sW1 + 2 * W1_BYTES;   // [W2_BYTES]
  uint64_t* w1full = reinterpret_cast<uint64_t*>(sW2 + W2_BYTES);
  uint64_t* w1empty = w1full + 2;
  uint64_t* w2full = w1empty + 2;
  uint64_t* w2empty = w2full + 1;

  const int n_tiles = (R + ROWS - 1) / ROWS;
  const int nC = F / FC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&w1full[s], 1);
      mbar_init(&w1empty[s], 256);
    }
    mbar_init(w2full, 1);
    mbar_init(w2empty, 256);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // ------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int st = 0;
      uint32_t ph = 0, ph2 = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int c = 0; c < nC; ++c) {
          mbar_wait(&w1empty[st], ph ^ 1);
          unsigned char* w1s = sW1 + st * W1_BYTES;
          mbar_arrive_expect_tx(&w1full[st], W1_BYTES);
#pragma unroll
          for (int kb = 0; kb < D / 64; ++kb)
            tma_load_2d(w1s + kb * (FC * 128), &tm_w1, &w1full[st], kb * 64,
                        c * FC);
          if (++st == 2) {
            st = 0;
            ph ^= 1;
          }
          mbar_wait(w2empty, ph2 ^ 1);
          mbar_arrive_expect_tx(w2full, W2_BYTES);
          tma_load_2d(sW2, &tm_w2, w2full, c * FC, 0);
          ph2 ^= 1;
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* myY = sY + wg * Y_BYTES;
  unsigned char* myG = sG + wg * Y_BYTES;
  const uint32_t sd = rate > 0.f ? static_cast<uint32_t>(seed[0]) : 0u;
  int st = 0;
  uint32_t ph = 0, ph2 = 0;
  // the two warpgroups take turns at issuing their products (named
  // barriers 3 and 4), so that one's a, gh1 and LayerNorm work runs while
  // the other's products occupy the tensor cores; warpgroup 0 goes first
  auto my_turn = [&]() { named_sync(3 + wg, 256); };
  auto your_turn = [&]() { named_arrive(4 - wg, 256); };
  if (wg == 1) named_arrive(3, 256);
  PHASES_BEGIN
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * ROWS + wg * 64;  // this warpgroup's first row
    const int pidx = tile * 2 + wg;  // rows 4 pidx + warp of part and db1p
    const int ra = r0 + warp * 16 + g, rb = ra + 8;  // this thread's rows
    // LayerNorm and g2, a warp per row over the warp's own 16 rows (those
    // its threads hold in the products), 8 columns a lane: bf16 y and g2
    // into the swizzled column blocks (block lane / 8, chunk lane % 8) and
    // to yw, g2w. Rows past R read as zeros: y = beta, g2 = 0, never stored.
    for (int i0 = 0; i0 < 16; i0 += 4) {  // 4 rows' loads in flight at once
      float vv[4][8], gg[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = r0 + warp * 16 + i0 + u;
        if (row < R) {
          const XT* px = x + (size_t)row * D + lane * 8;
          const XT* pg = gin + (size_t)row * D + lane * 8;
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            load2(px + j, vv[u][j], vv[u][j + 1]);
            load2(pg + j, gg[u][j], gg[u][j + 1]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) vv[u][j] = gg[u][j] = 0.f;
        }
      }
      // the four rows' means and variances, their butterflies interleaved
      float mean[4], rstd[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mean[u] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) mean[u] += vv[u][j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          mean[u] += __shfl_xor_sync(0xffffffffu, mean[u], o);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mean[u] *= 1.f / D;
        rstd[u] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          rstd[u] += (vv[u][j] - mean[u]) * (vv[u][j] - mean[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          rstd[u] += __shfl_xor_sync(0xffffffffu, rstd[u], o);
#pragma unroll
      for (int u = 0; u < 4; ++u) rstd[u] = rsqrtf(rstd[u] * (1.f / D) + LN_EPS);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u;
      const int r = warp * 16 + i, row = r0 + r;
      const float* v = vv[u];
      const float* gv = gg[u];
      const uint32_t rk = row_key(sd, row);
      __align__(16) bf16 y[8], q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = lane * 8 + j;
        y[j] = __float2bfloat16((v[j] - mean[u]) * rstd[u] * gamma[c] +
                                beta[c]);
        float g2v = scale * gv[j];
        if (rate > 0.f) g2v *= keep_mult(rk, c, rate, keep_scale);
        q[j] = __float2bfloat16(g2v);
      }
      const uint32_t off =
          (lane >> 3) * (64 * 128) + sw128_offset(r, (lane & 7) * 8);
      *reinterpret_cast<uint4*>(myY + off) = *reinterpret_cast<uint4*>(y);
      *reinterpret_cast<uint4*>(myG + off) = *reinterpret_cast<uint4*>(q);
      if (row < R) {
        *reinterpret_cast<uint4*>(yw + (size_t)row * D + lane * 8) =
            *reinterpret_cast<uint4*>(y);
        *reinterpret_cast<uint4*>(g2w + (size_t)row * D + lane * 8) =
            *reinterpret_cast<uint4*>(q);
      }
    }
    }
    fence_proxy_async();
    warpgroup_sync(1 + wg);
    PHASE(0);

    float gy[128], h[32], ga[32];
#pragma unroll
    for (int i = 0; i < 128; ++i) gy[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) h[i] = ga[i] = 0.f;
    uint32_t fr[FC / 16][4];
    // ga = g2 W2c: K = D in 16 steps; W2's box (rows d, 64 columns f) is
    // B read MN-major, 16 rows (2 KB) a step
    // (descriptors are formed from one opaque base each, so that the
    // compiler keeps no loop-invariant set of them in registers)
    auto issue_ga = [&]() {
      const uint64_t da = opaque(desc_sw128(myG)), db = opaque(desc_sw128(sW2));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss<1>(
            ga, desc_add(da, (kk >> 2) * (64 * 128) + (kk & 3) * 32),
            desc_add(db, kk * 2048), kk > 0 ? 1 : 0);
      wgmma_commit();
    };
    // h1 = y W1c^T for the chunk in stage s, as the forward's issue_h1
    auto issue_h1 = [&](int s) {
      const uint64_t da = opaque(desc_sw128(myY));
      const uint64_t db = opaque(desc_sw128(sW1 + s * W1_BYTES));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
        wgmma_m64n64k16_ss<0>(h, desc_add(da, off), desc_add(db, off),
                              kk > 0 ? 1 : 0);
      }
      wgmma_commit();
    };
    // gy += gh1 W1c for the chunk in stage s: K = FC in 4 steps of 16 rows
    // of W1's boxes, N = D across the four boxes (LBO = one box)
    auto issue_gy = [&](int s) {
      const uint64_t db = opaque(desc_sw128(sW1 + s * W1_BYTES, FC * 128));
      fence_operand(gy);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk)
        wgmma_m64n256k16_rs<1>(gy, fr[kk], desc_add(db, kk * 2048));
      wgmma_commit();
    };
    // chunk c's a and gh1 from h1 and ga: bf16 a and gh1 to aw and hw, gh1's
    // column sums over the warp's 16 rows to db1p, gh1's A fragments into
    // fr (k step kk from h1's 8-column blocks 2kk and 2kk + 1). The stores
    // go out 8 bytes a thread: each lane pair's two 8-column blocks (2kk,
    // 2kk + 1) are transposed across the pair first.
    auto act = [&](int c) {
      float* dbp = db1p + (size_t)(pidx * 4 + warp) * F + c * FC;
#pragma unroll
      for (int jg = 0; jg < FC / 16; ++jg) {
      uint32_t xa[2], xb[2], ya[2], yb[2];  // a and gh1, rows ra and rb
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = jg * 2 + jj;
        const int col = j * 8 + 2 * t, f = c * FC + col;
        const __nv_bfloat162 bb =
            *reinterpret_cast<const __nv_bfloat162*>(b1 + f);
        const float c0 = __low2float(bb), c1 = __high2float(bb);
        const float v0 = h[4 * j] + c0, v1 = h[4 * j + 1] + c1;
        const float v2 = h[4 * j + 2] + c0, v3 = h[4 * j + 3] + c1;
        const float s0 = sigmoid_fast(v0), s1 = sigmoid_fast(v1);
        const float s2 = sigmoid_fast(v2), s3 = sigmoid_fast(v3);
        const float q0 = ga[4 * j] * (s0 * (1.f + v0 * (1.f - s0)));
        const float q1 = ga[4 * j + 1] * (s1 * (1.f + v1 * (1.f - s1)));
        const float q2 = ga[4 * j + 2] * (s2 * (1.f + v2 * (1.f - s2)));
        const float q3 = ga[4 * j + 3] * (s3 * (1.f + v3 * (1.f - s3)));
        const uint32_t qa = pack_bf16(q0, q1), qb = pack_bf16(q2, q3);
        fr[j >> 1][(j & 1) * 2 + 0] = qa;
        fr[j >> 1][(j & 1) * 2 + 1] = qb;
        xa[jj] = pack_bf16(v0 * s0, v1 * s1);
        xb[jj] = pack_bf16(v2 * s2, v3 * s3);
        ya[jj] = qa;
        yb[jj] = qb;
        // rows past R have g2 = 0, so ga = gh1 = 0 there
        float cs0 = q0 + q2, cs1 = q1 + q3;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
          cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
        }
        if (g == 0) *reinterpret_cast<float2*>(dbp + col) = make_float2(cs0, cs1);
      }
      // lane t now stores columns 8 (2 jg + t % 2) + 2 (t & 2) .. + 3 of
      // its two rows
      pair_transpose(xa, t & 1);
      pair_transpose(xb, t & 1);
      pair_transpose(ya, t & 1);
      pair_transpose(yb, t & 1);
      const int cc = c * FC + 8 * (2 * jg + (t & 1)) + 2 * (t & 2);
      if (ra < R) {
        *reinterpret_cast<uint2*>(aw + (size_t)ra * F + cc) =
            make_uint2(xa[0], xa[1]);
        *reinterpret_cast<uint2*>(hw + (size_t)ra * F + cc) =
            make_uint2(ya[0], ya[1]);
      }
      if (rb < R) {
        *reinterpret_cast<uint2*>(aw + (size_t)rb * F + cc) =
            make_uint2(xb[0], xb[1]);
        *reinterpret_cast<uint2*>(hw + (size_t)rb * F + cc) =
            make_uint2(yb[0], yb[1]);
      }
      }
    };

    // chunk 0: ga and h1 alone
    mbar_wait(&w1full[st], ph);
    mbar_wait(w2full, ph2);
    PHASE(1);
    my_turn();
    issue_ga();
    issue_h1(st);
    your_turn();
    PHASE(2);
    wgmma_wait<1>();
    fence_operand(ga);
    mbar_arrive(w2empty);
    ph2 ^= 1;
    wgmma_wait<0>();
    fence_operand(h);
    PHASE(3);
    act(0);
    PHASE(4);
    // every further chunk: the previous chunk's gy, then this one's ga and
    // h1, each awaited in turn; no branch between issue and wait
    for (int c = 1; c < nC; ++c) {
      const int prev = st;
      if (++st == 2) {
        st = 0;
        ph ^= 1;
      }
      mbar_wait(&w1full[st], ph);
      mbar_wait(w2full, ph2);
      PHASE(1);
      my_turn();
      issue_gy(prev);
      issue_ga();
      issue_h1(st);
      your_turn();
      PHASE(2);
      wgmma_wait<2>();
      fence_operand(gy);
      fence_operand(fr);
      mbar_arrive(&w1empty[prev]);
      wgmma_wait<1>();
      fence_operand(ga);
      mbar_arrive(w2empty);
      ph2 ^= 1;
      wgmma_wait<0>();
      fence_operand(h);
      PHASE(3);
      act(c);
      PHASE(4);
    }
    {  // the last chunk's gy
      const int prev = st;
      if (++st == 2) {
        st = 0;
        ph ^= 1;
      }
      my_turn();
      issue_gy(prev);
      your_turn();
      PHASE(2);
      wgmma_wait<0>();
      fence_operand(gy);
      fence_operand(fr);
      mbar_arrive(&w1empty[prev]);
      PHASE(3);
    }

    // the LayerNorm backward. Every warp of this warpgroup is past its
    // products, so y's and g2's buffers (64 KB) take gy as float32 rows
    // (16-byte groups XOR-swizzled by row, conflict-free both ways); then a
    // warp per row of its own 16, 8 columns a lane, as the LayerNorm ran:
    // x's mean and rstd again (the same arithmetic), m1 = mean(gy gamma),
    // m2 = mean(gy gamma xn), dx, and the lane's column sums of gy xn, gy
    // and g2 over the warp's rows into part (one row of part per warp)
    warpgroup_sync(1 + wg);
    static_assert(Y_BYTES == 32 * D * 4, "gy's rows fill y's and g2's buffers");
    auto gy_row = [&](int r) {  // rows 0..31 in y's buffer, 32..63 in g2's
      return reinterpret_cast<float*>(r < 32 ? myY : myG) + (r & 31) * D;
    };
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + g + 8 * half;
        const int col = (j * 8 + 2 * t) ^ ((r & 7) << 3);
        *reinterpret_cast<float2*>(gy_row(r) + col) =
            make_float2(gy[4 * j + 2 * half], gy[4 * j + 2 * half + 1]);
      }
    warpgroup_sync(1 + wg);
    float cg[8] = {}, cb[8] = {}, c2[8] = {};  // dgamma, dbeta, db2 partials
    float gm[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) gm[j] = gamma[lane * 8 + j];
    for (int i0 = 0; i0 < 16; i0 += 4) {  // 4 rows' loads in flight at once
      float vv[4][8], gg[4][8], yy[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = warp * 16 + i0 + u, row = r0 + r;
        if (row < R) {
          const XT* px = x + (size_t)row * D + lane * 8;
          const XT* pg = gin + (size_t)row * D + lane * 8;
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            load2(px + j, vv[u][j], vv[u][j + 1]);
            load2(pg + j, gg[u][j], gg[u][j + 1]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) vv[u][j] = gg[u][j] = 0.f;
        }
        const float* py = gy_row(r) + ((lane * 8) ^ ((r & 7) << 3));
        const float4 y0 = *reinterpret_cast<const float4*>(py);
        const float4 y1 = *reinterpret_cast<const float4*>(py + 4);
        yy[u][0] = y0.x, yy[u][1] = y0.y, yy[u][2] = y0.z, yy[u][3] = y0.w;
        yy[u][4] = y1.x, yy[u][5] = y1.y, yy[u][6] = y1.z, yy[u][7] = y1.w;
      }
      float mean[4], rstd[4], m1[4], m2[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mean[u] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) mean[u] += vv[u][j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          mean[u] += __shfl_xor_sync(0xffffffffu, mean[u], o);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mean[u] *= 1.f / D;
        rstd[u] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          rstd[u] += (vv[u][j] - mean[u]) * (vv[u][j] - mean[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          rstd[u] += __shfl_xor_sync(0xffffffffu, rstd[u], o);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        rstd[u] = rsqrtf(rstd[u] * (1.f / D) + LN_EPS);
        m1[u] = m2[u] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xn = (vv[u][j] - mean[u]) * rstd[u];
          vv[u][j] = xn;
          m1[u] += yy[u][j] * gm[j];
          m2[u] += yy[u][j] * gm[j] * xn;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          m1[u] += __shfl_xor_sync(0xffffffffu, m1[u], o);
          m2[u] += __shfl_xor_sync(0xffffffffu, m2[u], o);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = r0 + warp * 16 + i0 + u;
        if (row >= R) continue;  // gy = g2 = 0 there: no sums to add
        const float a1 = m1[u] * (1.f / D), a2 = m2[u] * (1.f / D);
        const uint32_t rk = row_key(sd, row);
        float d8[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xn = vv[u][j], gyv = yy[u][j];
          d8[j] = gg[u][j] + rstd[u] * (gyv * gm[j] - a1 - xn * a2);
          cg[j] += gyv * xn;
          cb[j] += gyv;
          float g2v = scale * gg[u][j];
          if (rate > 0.f) g2v *= keep_mult(rk, lane * 8 + j, rate, keep_scale);
          c2[j] += g2v;  // db2: float32 g2
        }
        XT* pd = dx + (size_t)row * D + lane * 8;
#pragma unroll
        for (int j = 0; j < 8; j += 2) store2(pd + j, d8[j], d8[j + 1]);
      }
    }
    float* pp = part + (size_t)(pidx * 4 + warp) * 3 * D + lane * 8;
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      *reinterpret_cast<float4*>(pp + j) =
          make_float4(cg[j], cg[j + 1], cg[j + 2], cg[j + 3]);
      *reinterpret_cast<float4*>(pp + D + j) =
          make_float4(cb[j], cb[j + 1], cb[j + 2], cb[j + 3]);
      *reinterpret_cast<float4*>(pp + 2 * D + j) =
          make_float4(c2[j], c2[j + 1], c2[j + 2], c2[j + 3]);
    }
    // the next tile's LayerNorm rewrites y and g2: every warp is past this
    warpgroup_sync(1 + wg);
    PHASE(5);
  }
  if (wg == 0) named_sync(3, 256);  // warpgroup 1's last turn
  PHASES_END
  }  // consumers
}

// Launch B. Block (tile, split): tiles [0, n_t2) are dW2's (D x F) 128 x
// 256 tiles, the rest dW1's (F x D); split s sums the 64-row blocks [s kps,
// (s + 1) kps) of launch A's scratch. The producer's thread loads, per row
// block, each warpgroup's 64 columns of A (g2w or hw) and the 256 columns
// of B (aw or yw) as four 64 x 64 boxes; rows past R read as zeros.
constexpr int WB_BK = 64, WB_STAGES = 4;
constexpr uint32_t WB_BOX = 64 * WB_BK * 2;               // 8 KB
constexpr uint32_t WB_STAGE = 6 * WB_BOX;                 // A x 2, B x 4
constexpr size_t WB_SMEM = 1024 + WB_STAGES * WB_STAGE + 64;

__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_weights_wgmma_kernel(const __grid_constant__ CUtensorMap tm_g2,
                             const __grid_constant__ CUtensorMap tm_a,
                             const __grid_constant__ CUtensorMap tm_h,
                             const __grid_constant__ CUtensorMap tm_y,
                             float* __restrict__ dw2p,
                             float* __restrict__ dw1p, int R, int F,
                             int n_t2, int kps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + WB_STAGES * WB_STAGE);
  uint64_t* empty = full + WB_STAGES;

  const int tile = blockIdx.x, split = blockIdx.y;
  const bool w2t = tile < n_t2;  // a dW2 tile: A = g2 (M = d), B = a
  const int m0 = w2t ? (tile % (D / 128)) * 128 : (tile - n_t2) * 128;
  const int n0 = w2t ? (tile / (D / 128)) * 256 : 0;
  const int n_k = (R + WB_BK - 1) / WB_BK;
  const int k0 = split * kps, k1 = min(n_k, k0 + kps);
  if (threadIdx.x == 0) {
    for (int s = 0; s < WB_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // ------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      const CUtensorMap* ma = w2t ? &tm_g2 : &tm_h;
      const CUtensorMap* mb = w2t ? &tm_a : &tm_y;
      int st = 0;
      uint32_t ph = 0;
      for (int kb = k0; kb < k1; ++kb) {
        mbar_wait(&empty[st], ph ^ 1);
        unsigned char* s = base + st * WB_STAGE;
        mbar_arrive_expect_tx(&full[st], WB_STAGE);
        tma_load_2d(s, ma, &full[st], m0, kb * WB_BK);
        tma_load_2d(s + WB_BOX, ma, &full[st], m0 + 64, kb * WB_BK);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tma_load_2d(s + (2 + i) * WB_BOX, mb, &full[st], n0 + 64 * i,
                      kb * WB_BK);
        if (++st == WB_STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int st = 0;
  uint32_t ph = 0;
  for (int kb = k0; kb < k1; ++kb) {
    mbar_wait(&full[st], ph);
    const unsigned char* s = base + st * WB_STAGE;
    const uint64_t da = opaque(desc_sw128(s + wg * WB_BOX));
    const uint64_t db = opaque(desc_sw128(s + 2 * WB_BOX, WB_BOX));
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WB_BK / 16; ++kk)
      wgmma_m64n256k16_ss<1, 1>(acc, desc_add(da, kk * 2048),
                                desc_add(db, kk * 2048), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    mbar_arrive(&empty[st]);
    if (++st == WB_STAGES) {
      st = 0;
      ph ^= 1;
    }
  }
  // rows m (d of dW2, f of dW1), columns n (f of dW2, d of dW1)
  float* out = w2t ? dw2p + (size_t)split * D * F : dw1p + (size_t)split * F * D;
  const int M = w2t ? D : F, N = w2t ? F : D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + wg * 64 + warp * 16 + g + 8 * half;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      if (n < N)
        *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
  }  // consumers
}

// a tensor map over bf16 (rows, cols) row-major scratch, 64 x WB_BK boxes
inline cudaError_t rows_map(CUtensorMap* m, const void* p, int cols,
                            int rows) {
  const uint64_t d[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t s[1] = {cols * 2ull};
  const uint32_t b[2] = {64, WB_BK};
  return encode_bf16_sw128(m, p, 2, d, s, b);
}

}  // namespace hop

// ---------------------------------------- backward at D 512: row tiles
template <int D, int FC>
__host__ __device__ constexpr size_t rows_smem_bytes() {
  return (2 * BR + 2 * (D / 128) * BR) * sizeof(float) +
         (size_t)(2 * BR * (D + 8) + (FC * (D + 8) + D * (FC + 8)) +
                  BR * (FC + 8)) * sizeof(bf16);
}

// grid: one block per 64-row tile; D threads as in the forward; one weight
// chunk in shared memory at a time. Writes dx, bf16 y and g2 (R, D) for
// launch B, and part[tile] = (column sums over the tile's rows of gy xn, gy,
// g2), (3, D) float32.
template <int D, int FC, typename XT>
__global__ void __launch_bounds__(D)
ffn_bwd_rows_kernel(const XT* __restrict__ x, const XT* __restrict__ gin,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const int* __restrict__ seed, XT* __restrict__ dx,
                    bf16* __restrict__ y_out, bf16* __restrict__ g2_out,
                    float* __restrict__ part, int R, int F, float scale,
                    float rate, float keep_scale) {
  constexpr int C = D / 128;
  constexpr int LDD = D + 8, LDF = FC + 8;
  constexpr int CW = FC / C;
  constexpr int NT1 = CW / 8;
  constexpr int STAGE = FC * LDD + D * LDF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_mean = reinterpret_cast<float*>(smem_raw);
  float* s_rstd = s_mean + BR;
  float* s_row = s_rstd + BR;                       // [C][BR][2]
  bf16* sY = reinterpret_cast<bf16*>(s_row + 2 * C * BR);
  bf16* sG = sY + BR * LDD;
  bf16* sStage = sG + BR * LDD;
  bf16* sH = sStage + STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp & 3, cw = warp >> 2;
  const int r0 = blockIdx.x * BR;
  const int nC = F / FC;
  const uint32_t sd = rate > 0.f ? static_cast<uint32_t>(seed[0]) : 0u;

  load_weight_chunk<D, FC>(w1, w2, F, 0, sStage, sStage + FC * LDD, tid, D);
  cp_async_commit();
  layer_norm_tile<D, XT>(x, gamma, beta, R, r0, sY, s_mean, s_rstd, y_out,
                         warp, lane, D / 32);
  {
    // g2 = scale g keep, a thread per column: bf16 into sG and g2_out, its
    // float32 column sum (db2's partial) into part
    const int col = tid;
    float colsum = 0.f;
    for (int r = 0; r < BR; ++r) {
      const int row = r0 + r;
      float v = 0.f;
      if (row < R) {
        v = scale * to_f(gin[(size_t)row * D + col]);
        if (rate > 0.f) v *= keep_mult(row_key(sd, row), col, rate, keep_scale);
      }
      colsum += v;
      const bf16 vb = __float2bfloat16(v);
      sG[r * LDD + col] = vb;
      if (row < R) g2_out[(size_t)row * D + col] = vb;
    }
    part[((size_t)blockIdx.x * 3 + 2) * D + col] = colsum;
  }

  float gy[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) gy[nt][0] = gy[nt][1] = gy[nt][2] = gy[nt][3] = 0.f;

  for (int c = 0; c < nC; ++c) {
    if (c > 0) {
      load_weight_chunk<D, FC>(w1, w2, F, c * FC, sStage, sStage + FC * LDD,
                               tid, D);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    const bf16* W1 = sStage;
    const bf16* W2 = W1 + FC * LDD;

    // h1 = y W1c^T and ga = g2 W2c, the same 16 rows x CW columns
    float h[NT1][4], ga[NT1][4];
#pragma unroll
    for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[nt][e] = ga[nt][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ay[4], ag[4];
      frag_a(ay, sY, LDD, rw * 16, kk * 16, g, t);
      frag_a(ag, sG, LDD, rw * 16, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt) {
        const int n0 = cw * CW + nt * 8;
        uint32_t b0, b1v;
        frag_b(b0, b1v, W1, LDD, n0, kk * 16, g, t);
        mma_bf16(h[nt], ay, b0, b1v);
        frag_b_t(b0, b1v, W2, LDF, n0, kk * 16, lane);
        mma_bf16(ga[nt], ag, b0, b1v);
      }
    }
    // gh1 = ga silu'(h1), bf16 into sH
#pragma unroll
    for (int nt = 0; nt < NT1; ++nt) {
      const int col = cw * CW + nt * 8 + 2 * t;
      const float c0 = __bfloat162float(b1[c * FC + col]);
      const float c1 = __bfloat162float(b1[c * FC + col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v0 = h[nt][2 * half] + c0, v1 = h[nt][2 * half + 1] + c1;
        const float s0 = sigmoid(v0), s1 = sigmoid(v1);
        const float q0 = ga[nt][2 * half] * (s0 * (1.f + v0 * (1.f - s0)));
        const float q1 = ga[nt][2 * half + 1] * (s1 * (1.f + v1 * (1.f - s1)));
        *reinterpret_cast<uint32_t*>(sH + (rw * 16 + g + 8 * half) * LDF + col) =
            pack_bf16(q0, q1);
      }
    }
    __syncthreads();

    // gy += gh1 W1c: W1c is [K = FC][N = D]
#pragma unroll
    for (int kk = 0; kk < FC / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, sH, LDF, rw * 16, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        uint32_t b0, b1v;
        frag_b_t(b0, b1v, W1, LDD, cw * 128 + nt * 8, kk * 16, lane);
        mma_bf16(gy[nt], a, b0, b1v);
      }
    }
    __syncthreads();
  }

  // epilogue: the stages are free; colred [4 row warps][2][D] lives there
  float* colred = reinterpret_cast<float*>(sStage);
  const int ra = r0 + rw * 16 + g, rb = ra + 8;  // this thread's two rows
  const bool oka = ra < R, okb = rb < R;
  const float mean_a = s_mean[rw * 16 + g], rstd_a = s_rstd[rw * 16 + g];
  const float mean_b = s_mean[rw * 16 + g + 8], rstd_b = s_rstd[rw * 16 + g + 8];
  float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col = cw * 128 + nt * 8 + 2 * t;
    float xa0 = 0.f, xa1 = 0.f, xb0 = 0.f, xb1 = 0.f;
    if (oka) load2(x + (size_t)ra * D + col, xa0, xa1);
    if (okb) load2(x + (size_t)rb * D + col, xb0, xb1);
    // xn of rows past R: 0
    const float na0 = oka ? (xa0 - mean_a) * rstd_a : 0.f;
    const float na1 = oka ? (xa1 - mean_a) * rstd_a : 0.f;
    const float nb0 = okb ? (xb0 - mean_b) * rstd_b : 0.f;
    const float nb1 = okb ? (xb1 - mean_b) * rstd_b : 0.f;
    const float ga0 = gamma[col], ga1 = gamma[col + 1];
    const float ya0 = oka ? gy[nt][0] : 0.f, ya1 = oka ? gy[nt][1] : 0.f;
    const float yb0 = okb ? gy[nt][2] : 0.f, yb1 = okb ? gy[nt][3] : 0.f;
    s1a += ya0 * ga0 + ya1 * ga1;
    s2a += ya0 * ga0 * na0 + ya1 * ga1 * na1;
    s1b += yb0 * ga0 + yb1 * ga1;
    s2b += yb0 * ga0 * nb0 + yb1 * ga1 * nb1;
    // column sums over the warp's 16 rows (dgamma, dbeta partials)
    float dg0 = ya0 * na0 + yb0 * nb0, dg1 = ya1 * na1 + yb1 * nb1;
    float db0 = ya0 + yb0, db1 = ya1 + yb1;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      dg0 += __shfl_xor_sync(0xffffffffu, dg0, o);
      dg1 += __shfl_xor_sync(0xffffffffu, dg1, o);
      db0 += __shfl_xor_sync(0xffffffffu, db0, o);
      db1 += __shfl_xor_sync(0xffffffffu, db1, o);
    }
    if (g == 0) {
      colred[(rw * 2 + 0) * D + col] = dg0;
      colred[(rw * 2 + 0) * D + col + 1] = dg1;
      colred[(rw * 2 + 1) * D + col] = db0;
      colred[(rw * 2 + 1) * D + col + 1] = db1;
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s1a += __shfl_xor_sync(0xffffffffu, s1a, o);
    s2a += __shfl_xor_sync(0xffffffffu, s2a, o);
    s1b += __shfl_xor_sync(0xffffffffu, s1b, o);
    s2b += __shfl_xor_sync(0xffffffffu, s2b, o);
  }
  if (t == 0) {
    s_row[(cw * BR + rw * 16 + g) * 2 + 0] = s1a;
    s_row[(cw * BR + rw * 16 + g) * 2 + 1] = s2a;
    s_row[(cw * BR + rw * 16 + g + 8) * 2 + 0] = s1b;
    s_row[(cw * BR + rw * 16 + g + 8) * 2 + 1] = s2b;
  }
  __syncthreads();
  {
    const int col = tid;  // dgamma and dbeta partials, summed in fixed order
    float dg = 0.f, db = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dg += colred[(q * 2 + 0) * D + col];
      db += colred[(q * 2 + 1) * D + col];
    }
    part[((size_t)blockIdx.x * 3 + 0) * D + col] = dg;
    part[((size_t)blockIdx.x * 3 + 1) * D + col] = db;
  }
  float m1a = 0.f, m2a = 0.f, m1b = 0.f, m2b = 0.f;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    m1a += s_row[(q * BR + rw * 16 + g) * 2 + 0];
    m2a += s_row[(q * BR + rw * 16 + g) * 2 + 1];
    m1b += s_row[(q * BR + rw * 16 + g + 8) * 2 + 0];
    m2b += s_row[(q * BR + rw * 16 + g + 8) * 2 + 1];
  }
  m1a *= 1.f / D;
  m2a *= 1.f / D;
  m1b *= 1.f / D;
  m2b *= 1.f / D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= R) continue;
    const float mean = half ? mean_b : mean_a, rstd = half ? rstd_b : rstd_a;
    const float m1 = half ? m1b : m1a, m2 = half ? m2b : m2a;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int col = cw * 128 + nt * 8 + 2 * t;
      float x0, x1, g0, g1;
      load2(x + (size_t)row * D + col, x0, x1);
      load2(gin + (size_t)row * D + col, g0, g1);
      const float n0 = (x0 - mean) * rstd, n1 = (x1 - mean) * rstd;
      const float q0 = gy[nt][2 * half] * gamma[col];
      const float q1 = gy[nt][2 * half + 1] * gamma[col + 1];
      store2(dx + (size_t)row * D + col, g0 + rstd * (q0 - m1 - n0 * m2),
             g1 + rstd * (q1 - m1 - n1 * m2));
    }
  }
}

// ------------------------------------- backward at D 512: weight chunks
template <int D, int FCB>
__host__ __device__ constexpr size_t weights_smem_bytes() {
  return 4 * FCB * sizeof(float) +
         (size_t)(FCB * (D + 8) + D * (FCB + 8) + 2 * BR * (D + 8) +
                  2 * BR * (FCB + 8)) * sizeof(bf16);
}

// grid (F / FCB, S), 256 threads. Block (c, s) sums over the 64-row tiles
// [s * tps, (s + 1) * tps): dW2p[s][:, chunk] = g2^T a, dW1p[s][chunk, :] =
// gh1^T y and db1p[s][chunk] = sum gh1, from bf16 y and g2 of launch A.
template <int D, int FCB>
__global__ void __launch_bounds__(256, 1)
ffn_bwd_weights_kernel(const bf16* __restrict__ yw, const bf16* __restrict__ g2w,
                       const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                       const bf16* __restrict__ w2, float* __restrict__ dw1p,
                       float* __restrict__ dw2p, float* __restrict__ db1p,
                       int R, int F, int tps) {
  constexpr int LDD = D + 8, LDF = FCB + 8;
  constexpr int CW = FCB / 2;                 // h1 / ga columns per warp
  constexpr int NTP = CW / 8;
  constexpr int MT3 = D / 128, NT3 = FCB / 8;  // dW2c: warp rows D / 8
  constexpr int MT4 = FCB / 16, NT4 = D / 64;  // dW1c: warp columns D / 8
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* db1red = reinterpret_cast<float*>(smem_raw);   // [4][FCB]
  bf16* sW1 = reinterpret_cast<bf16*>(db1red + 4 * FCB);
  bf16* sW2 = sW1 + FCB * LDD;
  bf16* sY = sW2 + D * LDF;
  bf16* sG = sY + BR * LDD;
  bf16* sA = sG + BR * LDD;
  bf16* sH = sA + BR * LDF;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp & 3, cw = warp >> 2;
  const int f0 = blockIdx.x * FCB, split = blockIdx.y;

  load_weight_chunk<D, FCB>(w1, w2, F, f0, sW1, sW2, tid, 256);
  cp_async_commit();

  float acc2[MT3][NT3][4], acc1[MT4][NT4][4], db1acc[NTP][2];
#pragma unroll
  for (int i = 0; i < MT3; ++i)
#pragma unroll
    for (int j = 0; j < NT3; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[i][j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < MT4; ++i)
#pragma unroll
    for (int j = 0; j < NT4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[i][j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < NTP; ++i) db1acc[i][0] = db1acc[i][1] = 0.f;

  for (int it = 0; it < tps; ++it) {
    const int r0 = (split * tps + it) * BR;
    if (r0 >= R) break;
    for (int i = tid; i < BR * (D / 8); i += 256) {
      const int r = i / (D / 8), cc = (i % (D / 8)) * 8;
      const bool ok = r0 + r < R;
      const size_t off = (size_t)(ok ? r0 + r : 0) * D + cc;
      cp_async16(sY + r * LDD + cc, yw + off, ok);
      cp_async16(sG + r * LDD + cc, g2w + off, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // h1 = y W1c^T, ga = g2 W2c; a and gh1 into sA and sH as bf16
    float h[NTP][4], ga[NTP][4];
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[nt][e] = ga[nt][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ay[4], ag[4];
      frag_a(ay, sY, LDD, rw * 16, kk * 16, g, t);
      frag_a(ag, sG, LDD, rw * 16, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt) {
        const int n0 = cw * CW + nt * 8;
        uint32_t b0, b1v;
        frag_b(b0, b1v, sW1, LDD, n0, kk * 16, g, t);
        mma_bf16(h[nt], ay, b0, b1v);
        frag_b_t(b0, b1v, sW2, LDF, n0, kk * 16, lane);
        mma_bf16(ga[nt], ag, b0, b1v);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt) {
      const int col = cw * CW + nt * 8 + 2 * t;
      const float c0 = __bfloat162float(b1[f0 + col]);
      const float c1 = __bfloat162float(b1[f0 + col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v0 = h[nt][2 * half] + c0, v1 = h[nt][2 * half + 1] + c1;
        const float s0 = sigmoid(v0), s1 = sigmoid(v1);
        const float q0 = ga[nt][2 * half] * (s0 * (1.f + v0 * (1.f - s0)));
        const float q1 = ga[nt][2 * half + 1] * (s1 * (1.f + v1 * (1.f - s1)));
        const int r = rw * 16 + g + 8 * half;
        *reinterpret_cast<uint32_t*>(sA + r * LDF + col) =
            pack_bf16(v0 * s0, v1 * s1);
        *reinterpret_cast<uint32_t*>(sH + r * LDF + col) = pack_bf16(q0, q1);
        db1acc[nt][0] += q0;  // rows past R have g2 = 0, so gh1 = 0
        db1acc[nt][1] += q1;
      }
    }
    __syncthreads();

    // dW2c (D x FCB) += g2^T a; this warp's D / 8 rows
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      uint32_t a[MT3][4];
#pragma unroll
      for (int mt = 0; mt < MT3; ++mt)
        frag_a_t(a[mt], sG, LDD, warp * (D / 8) + mt * 16, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < NT3; ++nt) {
        uint32_t b0, b1v;
        frag_b_t(b0, b1v, sA, LDF, nt * 8, kk * 16, lane);
#pragma unroll
        for (int mt = 0; mt < MT3; ++mt) mma_bf16(acc2[mt][nt], a[mt], b0, b1v);
      }
    }
    // dW1c (FCB x D) += gh1^T y; this warp's D / 8 columns
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      uint32_t a[MT4][4];
#pragma unroll
      for (int mt = 0; mt < MT4; ++mt)
        frag_a_t(a[mt], sH, LDF, mt * 16, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < NT4; ++nt) {
        uint32_t b0, b1v;
        frag_b_t(b0, b1v, sY, LDD, warp * (D / 8) + nt * 8, kk * 16, lane);
#pragma unroll
        for (int mt = 0; mt < MT4; ++mt) mma_bf16(acc1[mt][nt], a[mt], b0, b1v);
      }
    }
    __syncthreads();  // the tile's buffers are free for the next one
  }

  float* p2 = dw2p + (size_t)split * D * F;
#pragma unroll
  for (int mt = 0; mt < MT3; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT3; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = warp * (D / 8) + mt * 16 + g + 8 * half;
        *reinterpret_cast<float2*>(p2 + (size_t)d * F + f0 + nt * 8 + 2 * t) =
            make_float2(acc2[mt][nt][2 * half], acc2[mt][nt][2 * half + 1]);
      }
  float* p1 = dw1p + (size_t)split * F * D;
#pragma unroll
  for (int mt = 0; mt < MT4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int f = f0 + mt * 16 + g + 8 * half;
        *reinterpret_cast<float2*>(p1 + (size_t)f * D + warp * (D / 8) + nt * 8 + 2 * t) =
            make_float2(acc1[mt][nt][2 * half], acc1[mt][nt][2 * half + 1]);
      }
#pragma unroll
  for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = db1acc[nt][j];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (g == 0) db1red[rw * FCB + cw * CW + nt * 8 + 2 * t + j] = v;
    }
  __syncthreads();
  if (tid < FCB) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) v += db1red[q * FCB + tid];
    db1p[(size_t)split * F + f0 + tid] = v;
  }
}


// ------------------------------------------------- backward C: the sums
// Blocks [0, dense_blocks): dW1 and dW2, each element the sum of the S row
// splits' partials in split order. The rest take 32 columns each of the db1
// partials (n_db rows) or of the (dgamma, dbeta, db2) partials (n_part rows
// of 3 D): 32 threads a column walk the rows 32 apart, and their 32 sums are
// added in thread order. Every sum has one fixed order: no atomics.
constexpr int SUM_THREADS = 1024;

__global__ void __launch_bounds__(SUM_THREADS) ffn_bwd_sum_kernel(
    const float* __restrict__ dw1p, const float* __restrict__ dw2p,
    const float* __restrict__ db1p, const float* __restrict__ part,
    bf16* __restrict__ dw1, bf16* __restrict__ dw2, bf16* __restrict__ db1,
    float* __restrict__ dgamma, float* __restrict__ dbeta,
    bf16* __restrict__ db2, int S, int F, int D, int n_db, int n_part,
    int dense_blocks) {
  __shared__ float red[32][33];
  if ((int)blockIdx.x < dense_blocks) {
    const size_t FD = (size_t)F * D;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * FD;
         i += (size_t)dense_blocks * blockDim.x) {
      const bool w2 = i >= FD;
      const size_t j = w2 ? i - FD : i;
      const float* src = w2 ? dw2p : dw1p;
      float v = 0.f;
      for (int s = 0; s < S; ++s) v += src[s * FD + j];
      (w2 ? dw2 : dw1)[j] = __float2bfloat16(v);
    }
    return;
  }
  const int cb = (int)blockIdx.x - dense_blocks, db_blocks = (F + 31) / 32;
  const bool is_db = cb < db_blocks;
  const int C = is_db ? F : 3 * D, n = is_db ? n_db : n_part;
  const float* src = is_db ? db1p : part;
  const int lane = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const int col = (is_db ? cb : cb - db_blocks) * 32 + lane;
  float v = 0.f;
  if (col < C) {
#pragma unroll 4
    for (int i = rg; i < n; i += 32) v += src[(size_t)i * C + col];
  }
  red[rg][lane] = v;
  __syncthreads();
  if (rg == 0 && col < C) {
    float s = 0.f;
    for (int q = 0; q < 32; ++q) s += red[q][lane];
    if (is_db) {
      db1[col] = __float2bfloat16(s);
    } else {
      const int k = col / D, c = col % D;
      if (k == 0) dgamma[c] = s;
      else if (k == 1) dbeta[c] = s;
      else db2[c] = __float2bfloat16(s);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The F-chunk widths: 64, or 32 at D 512, where a 64-wide chunk of both
// weights (and the backward's two (64, D) tiles) would not fit beside the
// rest of a block's 227 KB.
constexpr int chunk_of(int D) { return D <= 256 ? 64 : 32; }

template <int D, typename XT>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* seed, void* out, int R,
                       int F, float scale, float rate, float keep_scale,
                       cudaStream_t s) {
  if constexpr (D == hop::D) {  // the wgmma/TMA kernel
    CUtensorMap m1, m2;
    cudaError_t e = hop::weight_maps(&m1, &m2, w1, w2, F);
    if (e == cudaSuccess)
      e = allow_smem(hop::ffn_fwd_wgmma_kernel<XT>, hop::SMEM);
    if (e != cudaSuccess) return e;
    const int tiles = (R + hop::ROWS - 1) / hop::ROWS;
    const int grid = tiles < hopper::sm_count() ? tiles : hopper::sm_count();
    hop::ffn_fwd_wgmma_kernel<XT><<<grid, hop::THREADS, hop::SMEM, s>>>(
        m1, m2, static_cast<const XT*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const bf16*>(b1),
        static_cast<const bf16*>(b2), static_cast<const int*>(seed),
        static_cast<XT*>(out), R, F, scale, rate, keep_scale);
    return cudaGetLastError();
  } else {  // D 512: the mma.sync kernel
    constexpr int FC = chunk_of(D);
    constexpr size_t bytes = fwd_smem_bytes<D, FC, 2>();
    cudaError_t e = allow_smem(ffn_fwd_kernel<D, FC, XT>, bytes);
    if (e != cudaSuccess) return e;
    ffn_fwd_kernel<D, FC, XT><<<(R + BR - 1) / BR, D, bytes, s>>>(
        static_cast<const XT*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const bf16*>(w1),
        static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
        static_cast<const bf16*>(b2), static_cast<const int*>(seed),
        static_cast<XT*>(out), R, F, scale, rate, keep_scale);
    return cudaGetLastError();
  }
}

// The backward's plan: S row splits of the weight-gradient pass (its
// partials are S x the weights' size, float32), the rows of its partial
// column sums (part: (n_part, 3, D); db1p: (n_db, F)), and whether it takes
// the (R, F) a and gh1 scratch (the wgmma path at D 256).
struct BwdPlan {
  int S, n_part, n_db, af;
};

BwdPlan plan_of(int R, int D, int F) {
  const int sms = hopper::sm_count();
  BwdPlan p;
  if (D == hop::D) {
    // launch B: (D / 128) x ceil(F / 256) dW2 tiles and ceil(F / 128) dW1
    // tiles, times S splits of the 64-row blocks, about one wave
    const int tiles = (R + hop::ROWS - 1) / hop::ROWS;
    const int wtiles = (D / 128) * ((F + 255) / 256) + (F + 127) / 128;
    const int n_k = (R + hop::WB_BK - 1) / hop::WB_BK;
    p.S = sms / wtiles;
    if (p.S > n_k) p.S = n_k;
    if (p.S < 1) p.S = 1;
    p.n_part = 8 * tiles;  // one per warp (16 rows)
    p.n_db = 8 * tiles;
    p.af = 1;
  } else {  // one block per F chunk and split, one part row per 64-row tile
    const int chunks = F / chunk_of(D), tiles = (R + BR - 1) / BR;
    p.S = sms / chunks;
    if (p.S < 1) p.S = 1;
    if (p.S > tiles) p.S = tiles;
    p.n_part = tiles;
    p.n_db = p.S;
    p.af = 0;
  }
  return p;
}

template <int D, typename XT>
cudaError_t launch_bwd(const void* x, const void* g, const void* gamma,
                       const void* beta, const void* w1, const void* b1,
                       const void* w2, const void* seed, void* dx, void* yw,
                       void* g2w, void* aw, void* hw, void* part, void* dw1p,
                       void* dw2p, void* db1p, void* dgamma, void* dbeta,
                       void* dw1, void* db1, void* dw2, void* db2, int R,
                       int F, const BwdPlan& p, float scale, float rate,
                       float keep_scale, cudaStream_t s) {
  cudaError_t e;
  if constexpr (D == hop::D) {  // wgmma/TMA: launches A and B
    CUtensorMap m1, m2, mg, ma, mh, my;
    e = hop::weight_maps(&m1, &m2, w1, w2, F);
    if (e == cudaSuccess) e = hop::rows_map(&mg, g2w, D, R);
    if (e == cudaSuccess) e = hop::rows_map(&ma, aw, F, R);
    if (e == cudaSuccess) e = hop::rows_map(&mh, hw, F, R);
    if (e == cudaSuccess) e = hop::rows_map(&my, yw, D, R);
    if (e == cudaSuccess)
      e = allow_smem(hop::ffn_bwd_rows_wgmma_kernel<XT>, hop::BWD_SMEM);
    if (e == cudaSuccess)
      e = allow_smem(hop::ffn_bwd_weights_wgmma_kernel, hop::WB_SMEM);
    if (e != cudaSuccess) return e;
    const int tiles = (R + hop::ROWS - 1) / hop::ROWS;
    const int grid = tiles < hopper::sm_count() ? tiles : hopper::sm_count();
    hop::ffn_bwd_rows_wgmma_kernel<XT><<<grid, hop::THREADS, hop::BWD_SMEM,
                                         s>>>(
        m1, m2, static_cast<const XT*>(x), static_cast<const XT*>(g),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const bf16*>(b1), static_cast<const int*>(seed),
        static_cast<XT*>(dx), static_cast<bf16*>(yw), static_cast<bf16*>(g2w),
        static_cast<bf16*>(aw), static_cast<bf16*>(hw),
        static_cast<float*>(part), static_cast<float*>(db1p), R, F, scale,
        rate, keep_scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int n_t2 = (D / 128) * ((F + 255) / 256), n_t1 = (F + 127) / 128;
    const int n_k = (R + hop::WB_BK - 1) / hop::WB_BK;
    const int kps = (n_k + p.S - 1) / p.S;
    hop::ffn_bwd_weights_wgmma_kernel<<<dim3(n_t2 + n_t1, p.S), hop::THREADS,
                                        hop::WB_SMEM, s>>>(
        mg, ma, mh, my, static_cast<float*>(dw2p), static_cast<float*>(dw1p),
        R, F, n_t2, kps);
  } else {  // D 512: the mma.sync kernels
    constexpr int FC = chunk_of(D);
    constexpr size_t a_bytes = rows_smem_bytes<D, FC>();
    constexpr size_t b_bytes = weights_smem_bytes<D, FC>();
    const int n_tiles = (R + BR - 1) / BR;
    const int tps = (n_tiles + p.S - 1) / p.S;
    e = allow_smem(ffn_bwd_rows_kernel<D, FC, XT>, a_bytes);
    if (e == cudaSuccess) e = allow_smem(ffn_bwd_weights_kernel<D, FC>, b_bytes);
    if (e != cudaSuccess) return e;
    ffn_bwd_rows_kernel<D, FC, XT><<<n_tiles, D, a_bytes, s>>>(
        static_cast<const XT*>(x), static_cast<const XT*>(g),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
        static_cast<const bf16*>(w2), static_cast<const int*>(seed),
        static_cast<XT*>(dx), static_cast<bf16*>(yw), static_cast<bf16*>(g2w),
        static_cast<float*>(part), R, F, scale, rate, keep_scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ffn_bwd_weights_kernel<D, FC><<<dim3(F / FC, p.S), 256, b_bytes, s>>>(
        static_cast<const bf16*>(yw), static_cast<const bf16*>(g2w),
        static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
        static_cast<const bf16*>(w2), static_cast<float*>(dw1p),
        static_cast<float*>(dw2p), static_cast<float*>(db1p), R, F, tps);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int dense_blocks = 256;
  const int col_blocks = (F + 31) / 32 + (3 * D + 31) / 32;
  ffn_bwd_sum_kernel<<<dense_blocks + col_blocks, SUM_THREADS, 0, s>>>(
      static_cast<const float*>(dw1p), static_cast<const float*>(dw2p),
      static_cast<const float*>(db1p), static_cast<const float*>(part),
      static_cast<bf16*>(dw1), static_cast<bf16*>(dw2), static_cast<bf16*>(db1),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta),
      static_cast<bf16*>(db2), p.S, F, D, p.n_db, p.n_part, dense_blocks);
  return cudaGetLastError();
}

bool shape_ok(int R, int D, int F) {
  return R > 0 && (D == 256 || D == 512) && F >= 64 && F % 64 == 0;
}

}  // namespace

extern "C" {

// x, out: (R, D), bf16 (x_is_bf16) or float32; gamma, beta: (D,) float32;
// w1 (F, D), b1 (F,), w2 (D, F), b2 (D,): bf16; seed: (1,) int32 in
// device memory (read only when rate > 0). D 256 (the flagship's and rung
// 3's width) or 512 (rung 4's); F a multiple of 64. keep_scale = 1 / (1 - rate) as float32.
int ffn_fwd_launch(const void* x, const void* gamma, const void* beta,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* seed, void* out, int x_is_bf16,
                   int R, int D, int F, float scale, float rate,
                   float keep_scale, void* stream) {
  if (!shape_ok(R, D, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FFN_FWD(DD, XT)                                                       \
  return (int)launch_fwd<DD, XT>(x, gamma, beta, w1, b1, w2, b2, seed, out, R, \
                                 F, scale, rate, keep_scale, s)
  if (x_is_bf16) {
    if (D == 256) FFN_FWD(256, bf16);
    FFN_FWD(512, bf16);
  }
  if (D == 256) FFN_FWD(256, float);
  FFN_FWD(512, float);
#undef FFN_FWD
}

// The dynamic shared memory of the D-256 wgmma kernels, for reports: 0 the
// forward, 1 the backward's launch A, 2 its launch B.
int ffn_smem_bytes(int which) {
  return (int)(which == 0 ? hop::SMEM : which == 1 ? hop::BWD_SMEM
                                                    : hop::WB_SMEM);
}

// The backward's plan for (R, D, F) into out[4]: S, n_part, n_db and 1 when
// the (R, F) a and gh1 scratch is taken (see BwdPlan). Returns 0, or
// cudaErrorInvalidValue for a shape the kernels do not take.
int ffn_bwd_plan(int R, int D, int F, int* out) {
  if (!shape_ok(R, D, F)) return (int)cudaErrorInvalidValue;
  const BwdPlan p = plan_of(R, D, F);
  out[0] = p.S;
  out[1] = p.n_part;
  out[2] = p.n_db;
  out[3] = p.af;
  return 0;
}

// The backward. x, g (the cotangent of out), dx: (R, D) of x's dtype;
// gamma, beta, w1, b1, w2 as in the forward; scratch as `ffn_bwd_plan`
// gives it: yw, g2w (R, D) bf16, aw, hw (R, F) bf16 (D 256; else unused),
// part (n_part, 3, D), dw1p (S, F, D), dw2p (S, D, F), db1p (n_db, F)
// float32; outputs dgamma, dbeta (D,) float32 and dw1 (F, D), db1 (F,), dw2
// (D, F), db2 (D,) bf16.
int ffn_bwd_launch(const void* x, const void* g, const void* gamma,
                   const void* beta, const void* w1, const void* b1,
                   const void* w2, const void* seed, void* dx, void* yw,
                   void* g2w, void* aw, void* hw, void* part, void* dw1p,
                   void* dw2p, void* db1p, void* dgamma, void* dbeta,
                   void* dw1, void* db1, void* dw2, void* db2, int x_is_bf16,
                   int R, int D, int F, int S, float scale, float rate,
                   float keep_scale, void* stream) {
  if (!shape_ok(R, D, F)) return (int)cudaErrorInvalidValue;
  const BwdPlan p = plan_of(R, D, F);
  if (S != p.S || (p.af && (aw == nullptr || hw == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FFN_BWD(DD, XT)                                                      \
  return (int)launch_bwd<DD, XT>(x, g, gamma, beta, w1, b1, w2, seed, dx, yw, \
                                 g2w, aw, hw, part, dw1p, dw2p, db1p, dgamma, \
                                 dbeta, dw1, db1, dw2, db2, R, F, p, scale,  \
                                 rate, keep_scale, s)
  if (x_is_bf16) {
    if (D == 256) FFN_BWD(256, bf16);
    FFN_BWD(512, bf16);
  }
  if (D == 256) FFN_BWD(256, float);
  FFN_BWD(512, float);
#undef FFN_BWD
}

#ifdef FFN_PHASES
// launch A's phase cycles of the last backward (block 0, consumer thread 0)
int ffn_phase_read(long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, hop::ffn_phase_cycles, 16 * sizeof(long long));
  return (int)e;
}
#endif

}  // extern "C"
