// Fused encoder self-attention forward: bias + key-length mask + softmax + PV.
//
// Replaces: pytorch_end2end_speech_recognition_tpu/ops/attention_pallas.py
//   _attention_fwd_pallas (pallas_call at :101, kernel body _kernel :48).
//
// For every batch row b, head h and query i:
//   s[j]   = (q[i] * sm_scale) . k[j] + bias[h, i, j]    (j < lens[b])
//   s[j]   = -1e30                                        (j >= lens[b])
//   out[i] = sum_j e[j] v[j] / sum_j e[j],   e[j] = exp(s[j] - max s)
// q, k, v, out: (B, T, H*Dh) bf16 in the model's layout (heads are column
// slices, no transposes); bias: (H, P, P) bf16 with P >= T (the Toeplitz
// expansion is padded to a lane multiple); lens: (B,) int32. As in the TPU
// kernel, q is scaled in float32 and rounded back to bf16, e is rounded to
// bf16 before the PV product, its row sum is taken of the rounded values
// in float32, and 1/sum scales the float32 output before the bf16 store.
//
// Bound on the H100 at the flagship shape (B=32, T=750, H=4, Dh=64): 18.4
// GFLOP per launch in bf16 (~19 us at 989 TFLOP/s) against ~54 MB moved
// (~16 us at 3.35 TB/s), so the tensor cores bound it.
//
// Design. The TPU kernel keeps a whole (Tp, Tp) float32 score block in VMEM
// (2.4 MB at Tp=768), ten times what one block's shared memory holds. Here
// the forward is FlashAttention-3's loop (`hop::attention_fwd_kernel` below):
// a block of three consumer warpgroups and a producer warpgroup takes a
// 192-query tile of one (b, h) and walks 64-key tiles up to lens[b] only; K,
// V and the tile's bias arrive by TMA into an mbarrier ring; Q K^T and P V
// are wgmma (bf16 in, float32 accumulate), P from registers; the softmax is
// online, in float32 registers, and scores never leave them. The work items
// take b slowest, so the blocks in flight share one layer's 4.7 MB bias,
// which stays in the 50 MB L2 across the batch.
//
// Long-audio flash attention (the same kernels, bias mode kDiag).
//
// Replaces: pytorch_end2end_speech_recognition_tpu/ops/attention_pallas.py
//   _flash_fwd_pallas (pallas_call at :545, kernel body _flash_kernel :482)
//   and _flash_bwd_pallas (pallas_call at :696, body _flash_bwd_kernel
//   :574): attention past 768 frames, where the relative bias travels as
//   its diagonals diag (H, 2T-1) float32, bias[h, i, j] = diag[h, (T-1) +
//   j - i], never as an (H, T, T) tensor. The backward also returns ddiag
//   (H, 2T-1) float32, summed over the batch and all query rows.
//
// The TPU kernels keep whole K/V rows in VMEM, take a single-pass softmax
// over all keys, and expand the bias with a strided roll. Here the tiles
// above run unchanged; only the bias source differs: a tile reads the
// consecutive diagonals it spans, staged as float32, so the bias is not
// rounded to bf16 (the one numerical difference from the dense path). Any
// T, no padding.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 64;  // keys per tile (forward, pre-pass and dbias)
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Where the additive bias comes from: none; a dense (H, ld, ld) bf16 block
// (T <= 768, the Toeplitz expansion); or the diagonals (H, 2T-1) float32.
enum BiasMode { kNoBias = 0, kDense = 1, kDiag = 2 };

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------- forward for Hopper
// FlashAttention-3's structure at head width 64: a block takes a 192-query
// tile of one (b, h) with three consumer warpgroups (64 queries each) and
// one producer warpgroup, which hands its registers to them (setmaxnreg:
// 160 a consumer thread).
// - Blocks are persistent: one per SM walks the work items (query tile, head,
//   batch row). One producer thread loads each item's Q tile into one of two
//   buffers, so the next item's Q arrives while this one computes, and per
//   64-key tile K, V and (kDense) the 192 x 64 bias tile by TMA into a three-
//   stage mbarrier ring; the tensor maps are 3-D, (B, T, H*Dh) for q, k, v
//   and (H, ld, ld) for the bias, so a box that runs past T reads zeros and
//   never the next utterance's rows. kDiag: the tile's 255 diagonals
//   (float32, not rounded) are stored by the producer's first warp, whose 32
//   lanes arrive on the same barrier. Key tiles past lens[b] are never
//   loaded.
// - S = Q K^T is wgmma m64n64k16 with Q and K in 128-byte-swizzled shared
//   memory (Q scaled in float32 and rounded to bf16 in place first). The
//   online softmax runs in registers as in the mma.sync kernels (the
//   accumulator layout per warp is the same): e rounded to bf16 before PV,
//   lse from the sum of the unrounded e.
// - [O | l] += P [V | 1] is wgmma m64n72k16 with P as the register A
//   operand and V the B operand read from its row-major [key][d] tile
//   through the descriptor's transpose (MN-major); columns 64-71 come from
//   a block of ones, so the tensor cores also sum the rounded e of each
//   row, rescaled with O.
// - Within a warpgroup the next tile's S goes to the tensor cores before
//   this tile's P V, so the softmax of tile j + 1 runs while P_j V_j
//   computes; O is rescaled once that product is done.
// The output and lse leave registers with the row < T test.
namespace hop {

using namespace hopper;

// 2^x by the hardware's approximation (2 ulp; results below 2^-126 flush
// to 0, far below what a bf16 e or the row sums can hold beside the row
// maximum's 1)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int CONSUMERS = 3;
constexpr int QROWS = CONSUMERS * 64;         // 192 queries a block
constexpr int THREADS = (CONSUMERS + 1) * 128;
// three stages let the producer stay a tile ahead of the two that each
// consumer holds (S of tile j + 1 in flight beside P_j V_j)
constexpr int STAGES = 3;
constexpr uint32_t Q_BYTES = QROWS * 128;     // (192, 64) bf16
constexpr uint32_t KV_BYTES = BK * 128;       // (64, 64) bf16
constexpr uint32_t BIAS_BYTES = QROWS * 128;  // (192, 64) bf16, kDense
constexpr int DIAG_N = QROWS + BK;            // 255 diagonals (+1)
static_assert(DIAG_N % 32 == 0, "the producer warp stores DIAG_N / 32 each");

template <int BM>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return 2 * KV_BYTES + (BM == kDense ? BIAS_BYTES : 0) +
         (BM == kDiag ? 1024 : 0);  // 256 floats
}

constexpr uint32_t ONES_BYTES = BK * 128;     // (64, 64) bf16 ones

template <int BM>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + 2 * Q_BYTES + STAGES * stage_bytes<BM>() + ONES_BYTES + 128;
}

template <int BM>
__global__ void __launch_bounds__(THREADS, 1)
attention_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_bias,
                     const float* __restrict__ diag,
                     const int* __restrict__ lens,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int B, int T, int H, float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  auto sQ = [&](int i) { return base + i * Q_BYTES; };  // 2 Q buffers
  auto sK = [&](int s) { return base + 2 * Q_BYTES + s * stage_bytes<BM>(); };
  auto sV = [&](int s) { return sK(s) + KV_BYTES; };
  auto sB = [&](int s) { return sK(s) + 2 * KV_BYTES; };
  // a block of ones: V's 8 extra columns in P [V | 1], whose product
  // column is the row sum of the bf16 e
  unsigned char* sOnes = base + 2 * Q_BYTES + STAGES * stage_bytes<BM>();
  uint64_t* bars = reinterpret_cast<uint64_t*>(sOnes + ONES_BYTES);
  uint64_t* qfull = bars;
  uint64_t* qempty = bars + 2;
  uint64_t* full = bars + 4;
  uint64_t* empty = bars + 4 + STAGES;

  // the work items (query tile, head, batch row), query tile fastest; the
  // block takes blockIdx.x, + gridDim.x, ...
  const int n_qt = (T + QROWS - 1) / QROWS;
  const int n_work = n_qt * H * B;
  const int D = H * 64;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], CONSUMERS * 128);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], BM == kDiag ? 33 : 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // ------------------------------------ producer
    setmaxnreg_dec<24>();
    const int lane = threadIdx.x - CONSUMERS * 128;
    if (lane < 32) {
      int stage = 0;
      uint32_t phase = 0;
      for (int w = blockIdx.x, it = 0; w < n_work; w += gridDim.x, ++it) {
        const int qt = w % n_qt, h = (w / n_qt) % H, b = w / (n_qt * H);
        const int len = min(max(lens[b], 0), T);
        const int n_kt = (len + BK - 1) / BK;
        const int q0 = qt * QROWS;
        // Q into the buffer the work before last has released
        mbar_wait(&qempty[it & 1], ((it >> 1) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&qfull[it & 1], Q_BYTES);
          tma_load_3d(sQ(it & 1), &tm_q, &qfull[it & 1], h * 64, q0, b);
        }
        for (int kt = 0; kt < n_kt; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(
                &full[stage], 2 * KV_BYTES + (BM == kDense ? BIAS_BYTES : 0));
            tma_load_3d(sK(stage), &tm_k, &full[stage], h * 64, kt * BK, b);
            tma_load_3d(sV(stage), &tm_v, &full[stage], h * 64, kt * BK, b);
            if constexpr (BM == kDense)
              tma_load_3d(sB(stage), &tm_bias, &full[stage], kt * BK, q0, h);
          }
          if constexpr (BM == kDiag) {
            // w[c] = diag_h[(T-1) + k0 - q0 - (QROWS-1) + c]; diagonals
            // outside [0, 2T-1) belong to rows or keys past T and read as 0
            float* w = reinterpret_cast<float*>(sB(stage));
            const float* dh = diag + (size_t)h * (2 * T - 1);
            const int ws = (T - 1) + kt * BK - q0 - (QROWS - 1);
            float vals[DIAG_N / 32];  // all loads in flight, then the stores
#pragma unroll
            for (int u = 0; u < DIAG_N / 32; ++u) {
              const int d = ws + lane + 32 * u;
              vals[u] = d >= 0 && d < 2 * T - 1 ? __ldg(dh + d) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < DIAG_N / 32; ++u) w[lane + 32 * u] = vals[u];
            mbar_arrive(&full[stage]);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
  setmaxnreg_inc<160>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int c = threadIdx.x; c < int(ONES_BYTES / 16); c += CONSUMERS * 128)
    reinterpret_cast<uint4*>(sOnes)[c] =
        make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
  fence_proxy_async();
  // named barrier 4: the consumers (1-3 are the warpgroups' own)
  asm volatile("bar.sync 4, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
  int stage = 0;
  uint32_t phase = 0;
  for (int w = blockIdx.x, it = 0; w < n_work; w += gridDim.x, ++it) {
  const int qt = w % n_qt, h = (w / n_qt) % H, b = w / (n_qt * H);
  const int len = min(max(lens[b], 0), T);
  const int n_kt = (len + BK - 1) / BK;
  const int q0 = qt * QROWS;
  unsigned char* myQ = sQ(it & 1) + wg * (64 * 128);
  mbar_wait(&qfull[it & 1], (it >> 1) & 1);
  // q * sm_scale in float32, rounded back to bf16, in place (elementwise:
  // the swizzle does not matter)
  for (int c = tid; c < 64 * 8; c += 128) {
    uint4 raw = *reinterpret_cast<uint4*>(myQ + c * 16);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      e[u] = __float2bfloat16(__bfloat162float(e[u]) * sm_scale);
    *reinterpret_cast<uint4*>(myQ + c * 16) = raw;
  }
  fence_proxy_async();
  warpgroup_sync(1 + wg);

  // O (64 x 64) and, in columns 64-71, the running sum of the bf16 e
  float o[36];
#pragma unroll
  for (int i = 0; i < 36; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max of s + bias
  float l_ex[2] = {0.f, 0.f};  // sum of the unrounded e, for the row's lse
  float alpha[2] = {1.f, 1.f};  // O's rescale before the next P V
  const int rb = wg * 64 + warp * 16 + g;  // block-local row of half 0
  const int i0 = q0 + rb, i1 = i0 + 8;
  float sc[32];
  uint32_t pa[BK / 16][4], pa_next[BK / 16][4];

  // S = (q sm_scale) K^T of the tile in stage st; issued, not awaited
  auto issue_s = [&](int st) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss<0>(sc, desc_sw128(myQ + kk * 32),
                            desc_sw128(sK(st) + kk * 32), kk > 0 ? 1 : 0);
    wgmma_commit();
  };
  // the online softmax of key tile kt (its S in sc, its bias in stage st):
  // bf16 e into dst, the running max and sums updated, O's rescale in alpha
  auto softmax = [&](int kt, int st, uint32_t (&dst)[BK / 16][4]) {
    const unsigned char* tB = sB(st);
    const bool ragged = kt * BK + BK > len;  // keys past len in this tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = rb + half * 8;
        const int cl = nt * 8 + 2 * t;
        const int col = kt * BK + cl;
        float b0 = 0.f, b1 = 0.f;
        if constexpr (BM == kDense) {
          const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(
              tB + sw128_offset(rl, cl));
          b0 = __low2float(bb);
          b1 = __high2float(bb);
        }
        if constexpr (BM == kDiag) {
          const float* w =
              reinterpret_cast<const float*>(tB) + (cl - rl + QROWS - 1);
          b0 = w[0];
          b1 = w[1];
        }
        float v0 = sc[4 * nt + 2 * half] + b0;
        float v1 = sc[4 * nt + 2 * half + 1] + b1;
        if (ragged) {
          if (col >= len) v0 = MASKED;
          if (col + 1 >= len) v1 = MASKED;
        }
        sc[4 * nt + 2 * half] = v0;
        sc[4 * nt + 2 * half + 1] = v1;
        mx[half] = fmaxf(mx[half], fmaxf(v0, v1));
      }
    }
    // e = 2^((s + bias - max) log2 e), one FFMA and one ex2 each
    float ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2_fast((m_run[r] - m_new) * LOG2E);
      m_run[r] = m_new;
      ml[r] = m_new * LOG2E;
    }
    float rx[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float e0 = exp2_fast(fmaf(sc[4 * nt + 0], LOG2E, -ml[0]));
      const float e1 = exp2_fast(fmaf(sc[4 * nt + 1], LOG2E, -ml[0]));
      const float e2 = exp2_fast(fmaf(sc[4 * nt + 2], LOG2E, -ml[1]));
      const float e3 = exp2_fast(fmaf(sc[4 * nt + 3], LOG2E, -ml[1]));
      rx[0] += e0 + e1;
      rx[1] += e2 + e3;
      dst[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(e0, e1);
      dst[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(e2, e3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_ex[r] = l_ex[r] * alpha[r] + rx[r];
  };

  if (n_kt > 0) {
    mbar_wait(&full[stage], phase);
    issue_s(stage);
    wgmma_wait<0>();
    fence_operand(sc);
    softmax(0, stage, pa);  // O is 0: its rescale is moot
  }
  // [O | l] += P [V | 1] for the tile in stage st: V's [key][d] tile is
  // the MN-major B operand, 16 keys (2 KB) per k step, and the ones block
  // its second 64-column block, LBO bytes on; issued with a fence of its
  // own, so that an S issued before it is a pipeline stage of its own
  auto issue_pv = [&](int st) {
    fence_operand(o);
    wgmma_fence();
    const uint32_t lbo = static_cast<uint32_t>(sOnes - sV(st));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n72k16_rs<1>(o, pa[kk], desc_sw128(sV(st) + kk * 2048, lbo));
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
  // every tile but the last: the next tile's S, then this tile's P V, and
  // the next softmax while P V computes; no branch between issue and wait
  for (int kt = 0; kt + 1 < n_kt; ++kt) {
    const int cur = next_stage();
    mbar_wait(&full[stage], phase);
    issue_s(stage);
    issue_pv(cur);
    wgmma_wait<1>();
    fence_operand(sc);
    softmax(kt + 1, stage, pa_next);
    wgmma_wait<0>();
    fence_operand(o);
    fence_operand(pa);
    mbar_arrive(&empty[cur]);
#pragma unroll
    for (int nt = 0; nt < 9; ++nt) {
      o[4 * nt + 0] *= alpha[0];
      o[4 * nt + 1] *= alpha[0];
      o[4 * nt + 2] *= alpha[1];
      o[4 * nt + 3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pa_next[kk][r];
  }
  if (n_kt > 0) {  // the last tile's P V
    const int cur = next_stage();
    issue_pv(cur);
    wgmma_wait<0>();
    fence_operand(o);
    fence_operand(pa);
    mbar_arrive(&empty[cur]);
  }

  mbar_arrive(&qempty[it & 1]);  // every wgmma reading Q is done

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = 1.f / fmaxf(o[32 + 2 * r], 1e-30f);  // the bf16 e's row sum
    l_ex[r] += __shfl_xor_sync(0xffffffffu, l_ex[r], 1);
    l_ex[r] += __shfl_xor_sync(0xffffffffu, l_ex[r], 2);
  }
  const size_t row0 = (size_t)b * T;
  if (lse != nullptr && t == 0) {
    // log2-domain log-sum-exp of the float32 scores (JAX's backward
    // recomputes p = e / sum(e) from unrounded e); +inf for a row with no
    // key (len 0), so the backward's p is 0 there as this output is
    float* lrow = lse + ((size_t)b * H + h) * T;
    if (i0 < T)
      lrow[i0] = len > 0 ? m_run[0] * LOG2E + log2f(l_ex[0]) : INFINITY;
    if (i1 < T)
      lrow[i1] = len > 0 ? m_run[1] * LOG2E + log2f(l_ex[1]) : INFINITY;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = h * 64 + nt * 8 + 2 * t;
    if (i0 < T)
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + i0) * D + col) =
          __floats2bfloat162_rn(o[4 * nt] * inv[0], o[4 * nt + 1] * inv[0]);
    if (i1 < T)
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + i1) * D + col) =
          __floats2bfloat162_rn(o[4 * nt + 2] * inv[1],
                                o[4 * nt + 3] * inv[1]);
  }
  }  // work items
  }  // consumers
}

// q, k or v (B, T, H*64) bf16: boxes of `rows` x 64 (one head's columns)
inline cudaError_t qkv_map(CUtensorMap* m, const void* p, int B, int T,
                           int H, int rows) {
  const uint64_t dims[3] = {(uint64_t)H * 64, (uint64_t)T, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)H * 64 * 2, (uint64_t)T * H * 64 * 2};
  const uint32_t box[3] = {64, (uint32_t)rows, 1};
  return encode_bf16_sw128(m, p, 3, dims, strides, box);
}

}  // namespace hop

// ---------------------------------------------------------------- backward
//
// Replaces: pytorch_end2end_speech_recognition_tpu/ops/attention_pallas.py
//   _attention_bwd_pallas (pallas_call at :311, kernel body _bwd_kernel
//   :122) and _attention_bwd_headsplit (pallas_call at :250), which compute
//   the same function in two layouts, and _flash_bwd_pallas (:696) with the
//   bias as diagonals. With p recomputed from the forward's row lse and g
//   the output cotangent:
//   dv = p^T g,  dp = g v^T,  ds = p * (dp - rowsum(dp * p)),
//   dq = (ds k) * sm_scale,  dk = ds^T (q * sm_scale),  dbias_h = sum_b ds,
//   ddiag_h[d] = sum over b and the (i, j) with (T-1) + j - i = d of ds.
// Rounding as in the TPU kernel: q * sm_scale rounded to bf16 (also the dk
// operand), p float32 from the forward's lse and rounded to bf16 only for
// dv, ds rounded to bf16 for dq and dk, float32 accumulation everywhere,
// dbias summed over the batch in float32 and stored as bf16, ddiag float32.
// delta = rowsum(dp * p) is taken as the TPU kernel takes it, from float32
// p, not through FlashAttention's identity rowsum(g * o), which the bf16
// rounding of o would break. sm_scale is 1/8 (Dh 64), a power of two: the
// kernels multiply float32 sums by it, which gives the same bits as
// products of the rounded q * sm_scale.
//
// Bound on the H100 at the flagship shape (B=32, T=750, H=4, Dh=64): five
// 64-wide products per (query, key) pair, S, dP, dV, dK and dQ, ~46 GFLOP
// per launch in bf16 (~47 us at 989 TFLOP/s).
//
// Design, on FlashAttention-3's backward; every kernel is warp-specialised
// (one producer warpgroup, two consumer warpgroups of 64 rows; the producer
// keeps 24 registers a thread, the consumers 240), its operands arrive by
// TMA into mbarrier rings, and every product is wgmma:
// - attn_bwd_delta_kernel: delta = rowsum(dp * p) per query row. A block
//   takes 128 queries of one (b, h) and walks 64-key tiles up to lens[b]:
//   S = Q K^T and dP = G V^T, p from the lse, the sum in registers (2
//   products).
// - attn_bwd_main_kernel: a block owns 128 keys of one (b, h) (64 per
//   consumer) and walks all 64-query tiles: S^T = K Q^T and dP^T = V G^T,
//   P^T and dS^T in registers, dV += P^T G and dK += dS^T Q with the
//   register A operand, dS^T through 128-byte-swizzled shared memory into
//   dQ = dS K, each consumer 32 of dQ's 64 columns (5 products). The next
//   diagonal sums run while dQ computes. Each block stores its float32 dQ
//   partial per query tile, with no fence and no wait on another block;
//   attn_bwd_dq_sum_kernel adds the partials of a (b, h) in key-block
//   order, scales and stores bf16 dq. (An ordered hand-over per tile
//   between the key blocks, FlashAttention-3's deterministic mode, put a
//   release fence and a wait on the previous block into every tile and
//   chained the blocks' pace; summing in the last block to finish left one
//   SM per (b, h) walking every partial.) Key blocks past lens[b] load
//   nothing and store zeros.
// - Dense bias: attn_bwd_dbias_kernel, one block per (64-key tile,
//   128-query tile, head), walks the batch rows in order, recomputes S and
//   dP (2 products) and sums ds in float32 registers, the bias tile held in
//   registers across the rows.
// - Diagonals: the main kernel stores each tile's float32 dS skewed (row i,
//   column j - i + 63) and sums the columns in row order: one partial per
//   (block, query tile, diagonal); attn_bwd_ddiag_sum_kernel adds them per
//   diagonal in a fixed order.
// No float atomics anywhere: every sum has one order, the same bits on
// every run.
// Cycles per phase of the main backward kernel's query tiles (consumer
// thread 0 of the first and of the last key block of (b, h) = (0, 0)), for
// csrc/probe/attn_bwd_phases.py, which builds this file with -DATTN_PHASES;
// the kernel library compiles the markers to nothing.
#ifdef ATTN_PHASES
__device__ long long attn_phase_cycles[32];
#define PHASES_BEGIN long long ph_last_ = clock64(), ph_acc_[16] = {};
#define PHASE(i)                    \
  do {                              \
    const long long c_ = clock64(); \
    ph_acc_[i] += c_ - ph_last_;    \
    ph_last_ = c_;                  \
  } while (0)
#define PHASES_END                                                        \
  if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&           \
      (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1))                   \
    for (int i_ = 0; i_ < 16; ++i_)                                       \
      attn_phase_cycles[(blockIdx.x ? 16 : 0) + i_] = ph_acc_[i_];
#else
#define PHASES_BEGIN
#define PHASE(i)
#define PHASES_END
#endif

namespace hop {

constexpr int BWD_THREADS = 384;  // 2 consumer warpgroups + 1 producer
constexpr int BWD_CONSUMERS = 256;
constexpr int KEYS = 128;         // main kernel: keys a block
constexpr int QT = 64;            // main kernel: queries a tile
constexpr int ROWS2 = 128;        // pre-pass and dbias: queries an item
constexpr int MAIN_STAGES = 3;
constexpr int PRE_STAGES = 3;
constexpr int SKEW_LD = 197;      // 197 - 1 = 4 mod 16: conflict-free stores
constexpr int DIAG_COLS = 192;    // diagonals a main tile spans (191) + 1
constexpr uint32_t TILE64 = 64 * 128;  // a (64, 64) bf16 tile: 8 KB

// main kernel, one stage: Q, G (64, 64), the bias (kDense: two (64 queries,
// 64 keys) blocks), lse and delta of the 64 queries, the 192 diagonals
template <int BM>
__host__ __device__ constexpr uint32_t main_stage_bytes() {
  return 2 * TILE64 + (BM == kDense ? 2 * TILE64 : 0) + 2048;
}

template <int BM>
__host__ __device__ constexpr size_t main_smem_bytes() {
  return 1024 + 4 * TILE64 /* K, V */ + MAIN_STAGES * main_stage_bytes<BM>() +
         4 * TILE64 /* dS^T, two buffers */ +
         (BM == kDiag ? 2 * 64 * SKEW_LD * 4 : 0) + 64;
}

// pre-pass, one stage: K, V (64, 64), the bias (kDense: (128, 64); kDiag:
// 192 diagonals)
template <int BM>
__host__ __device__ constexpr uint32_t pre_stage_bytes() {
  return 2 * TILE64 + (BM == kDense ? 2 * TILE64 : 0) +
         (BM == kDiag ? 1024 : 0);
}

template <int BM>
__host__ __device__ constexpr size_t pre_smem_bytes() {
  return 1024 + 4 * TILE64 /* Q, G (128, 64) */ +
         PRE_STAGES * pre_stage_bytes<BM>() + 64;
}

// dbias, one stage: Q, G (128, 64), K, V (64, 64), lse and delta of 128 rows
constexpr uint32_t DB_STAGE = 6 * TILE64 + 1024;
constexpr size_t DB_SMEM = 1024 + PRE_STAGES * DB_STAGE + 64;

// bias of (block-local query row r, key column c) from a stage: kDense, a
// TMA tile (rows queries, 64 key columns, swizzled); kDiag, the window w[c
// - r + off]
template <int BM>
__device__ __forceinline__ float bias_at(const unsigned char* tB, int r,
                                         int c, int off) {
  if constexpr (BM == kDense)
    return __bfloat162float(
        *reinterpret_cast<const __nv_bfloat16*>(tB + sw128_offset(r, c)));
  if constexpr (BM == kDiag)
    return reinterpret_cast<const float*>(tB)[c - r + off];
  return 0.f;
}

// S = A B^T over Dh 64 (4 k steps) for two K-major (64, 64) tiles
__device__ __forceinline__ void issue_qk(float (&acc)[32],
                                         const unsigned char* a,
                                         const unsigned char* b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_ss<0>(acc, desc_sw128(a + kk * 32),
                          desc_sw128(b + kk * 32), kk > 0 ? 1 : 0);
  wgmma_commit();
}

// ------------------------------------------------- delta pre-pass
template <int BM>
__global__ void __launch_bounds__(BWD_THREADS, 1)
attn_bwd_delta_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_g,
                      const __grid_constant__ CUtensorMap tm_bias,
                      const float* __restrict__ diag,
                      const int* __restrict__ lens,
                      const float* __restrict__ lse,
                      float* __restrict__ delta, int T, int H,
                      float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = base;
  unsigned char* sG = base + 2 * TILE64;
  auto sK = [&](int s) { return base + 4 * TILE64 + s * pre_stage_bytes<BM>(); };
  auto sV = [&](int s) { return sK(s) + TILE64; };
  auto sB = [&](int s) { return sK(s) + 2 * TILE64; };
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(sK(0) + PRE_STAGES * pre_stage_bytes<BM>());
  uint64_t* qfull = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + PRE_STAGES;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * ROWS2;
  const int len = min(max(lens[b], 0), T);
  const int n_kt = (len + BK - 1) / BK;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < PRE_STAGES; ++s) {
      mbar_init(&full[s], BM == kDiag ? 33 : 1);
      mbar_init(&empty[s], BWD_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // ------------------------------------------ producer
    setmaxnreg_dec<24>();
    const int lane = threadIdx.x - BWD_CONSUMERS;
    if (lane < 32 && n_kt > 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(qfull, 4 * TILE64);
        tma_load_3d(sQ, &tm_q, qfull, h * 64, q0, b);
        tma_load_3d(sG, &tm_g, qfull, h * 64, q0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage],
                                2 * TILE64 + (BM == kDense ? 2 * TILE64 : 0));
          tma_load_3d(sK(stage), &tm_k, &full[stage], h * 64, kt * BK, b);
          tma_load_3d(sV(stage), &tm_v, &full[stage], h * 64, kt * BK, b);
          if constexpr (BM == kDense)
            tma_load_3d(sB(stage), &tm_bias, &full[stage], kt * BK, q0, h);
        }
        if constexpr (BM == kDiag) {
          // w[c] = diag_h[(T-1) + k0 - q0 - 127 + c], bias(r, c) = w[c - r
          // + 127]; diagonals outside [0, 2T-1) read as 0 (masked)
          float* w = reinterpret_cast<float*>(sB(stage));
          const float* dh = diag + (size_t)h * (2 * T - 1);
          const int ws = (T - 1) + kt * BK - q0 - (ROWS2 - 1);
          float vals[6];
#pragma unroll
          for (int u = 0; u < 6; ++u) {
            const int d = ws + lane + 32 * u;
            vals[u] = d >= 0 && d < 2 * T - 1 ? __ldg(dh + d) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 6; ++u) w[lane + 32 * u] = vals[u];
          mbar_arrive(&full[stage]);
        }
        if (++stage == PRE_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const float scale2 = sm_scale * LOG2E;  // exact: a power of two times LOG2E
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rb = wg * 64 + warp * 16 + g;  // block-local row of half 0
    const int i0 = q0 + rb, i1 = i0 + 8;
    const float* lse_bh = lse + ((size_t)b * H + h) * T;
    const float l2[2] = {i0 < T ? lse_bh[i0] : INFINITY,
                         i1 < T ? lse_bh[i1] : INFINITY};
    float dsum[2] = {0.f, 0.f};
    const unsigned char* myQ = sQ + wg * TILE64;
    const unsigned char* myG = sG + wg * TILE64;
    if (n_kt > 0) mbar_wait(qfull, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      mbar_wait(&full[stage], phase);
      float sc[32], dp[32];
      issue_qk(sc, myQ, sK(stage));
      issue_qk(dp, myG, sV(stage));
      wgmma_wait<0>();
      fence_operand(sc);
      fence_operand(dp);
      const unsigned char* tB = sB(stage);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * nt + 2 * half + e;
            const int cl = nt * 8 + 2 * t + e;
            const float bb = bias_at<BM>(tB, rb + 8 * half, cl, ROWS2 - 1);
            const float s2 = fmaf(sc[idx], scale2, fmaf(bb, LOG2E, -l2[half]));
            const float p = kt * BK + cl < len ? exp2_fast(s2) : 0.f;
            dsum[half] += p * dp[idx];
          }
        }
      }
      mbar_arrive(&empty[stage]);
      if (++stage == PRE_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
      dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
    }
    if (t == 0) {
      float* drow = delta + ((size_t)b * H + h) * T;
      if (i0 < T) drow[i0] = dsum[0];
      if (i1 < T) drow[i1] = dsum[1];
    }
  }
}

// ------------------------------------------------------- main kernel
template <int BM>
__global__ void __launch_bounds__(BWD_THREADS, 1)
attn_bwd_main_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_g,
                     const __grid_constant__ CUtensorMap tm_bias,
                     const float* __restrict__ diag,
                     const int* __restrict__ lens,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_part,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
                     int T, int H, float sm_scale) {
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * KEYS;
  const int len = min(max(lens[b], 0), T);
  const int D = H * 64;
  const size_t row0 = (size_t)b * T;
  if (k0 >= len) {  // every key of the block is masked: dk = dv = 0
    const uint4 z = make_uint4(0, 0, 0, 0);
    const int kend = min(k0 + KEYS, T);
    for (int c = threadIdx.x; c < (kend - k0) * 8; c += blockDim.x) {
      const size_t off = (row0 + k0 + c / 8) * D + h * 64 + (c % 8) * 8;
      *reinterpret_cast<uint4*>(dk + off) = z;
      *reinterpret_cast<uint4*>(dv + off) = z;
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sK = base;               // (128 keys, 64) swizzled
  unsigned char* sV = base + 2 * TILE64;
  auto sQ = [&](int s) {
    return base + 4 * TILE64 + s * main_stage_bytes<BM>();
  };
  auto sG = [&](int s) { return sQ(s) + TILE64; };
  auto sB = [&](int s) { return sQ(s) + 2 * TILE64; };
  // lse[64], delta[64], then (kDiag) the 192 diagonals
  auto sL = [&](int s) {
    return reinterpret_cast<float*>(sQ(s) + main_stage_bytes<BM>() - 2048);
  };
  unsigned char* sDS = sQ(MAIN_STAGES);  // [2][128 keys][64 queries] bf16
  float* skew = reinterpret_cast<float*>(sDS + 4 * TILE64);  // kDiag
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      sDS + 4 * TILE64 + (BM == kDiag ? 2 * 64 * SKEW_LD * 4 : 0));
  uint64_t* kvfull = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + MAIN_STAGES;

  const int n_qt = (T + QT - 1) / QT;
  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < MAIN_STAGES; ++s) {
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], BWD_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // ------------------------------------------ producer
    setmaxnreg_dec<24>();
    const int lane = threadIdx.x - BWD_CONSUMERS;
    if (lane < 32) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kvfull, 4 * TILE64);
        tma_load_3d(sK, &tm_k, kvfull, h * 64, k0, b);
        tma_load_3d(sV, &tm_v, kvfull, h * 64, k0, b);
      }
      const float* lse_bh = lse + ((size_t)b * H + h) * T;
      const float* del_bh = delta + ((size_t)b * H + h) * T;
      int stage = 0;
      uint32_t phase = 0;
      for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * QT;
        mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage],
                                2 * TILE64 + (BM == kDense ? 2 * TILE64 : 0));
          tma_load_3d(sQ(stage), &tm_q, &full[stage], h * 64, q0, b);
          tma_load_3d(sG(stage), &tm_g, &full[stage], h * 64, q0, b);
          if constexpr (BM == kDense) {
            tma_load_3d(sB(stage), &tm_bias, &full[stage], k0, q0, h);
            tma_load_3d(sB(stage) + TILE64, &tm_bias, &full[stage], k0 + 64,
                        q0, h);
          }
        }
        float* L = sL(stage);
        float vals[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = q0 + lane + 32 * u;
          vals[u] = i < T ? lse_bh[i] : INFINITY;  // p = 0 past T
          vals[2 + u] = i < T ? del_bh[i] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          L[lane + 32 * u] = vals[u];
          L[64 + lane + 32 * u] = vals[2 + u];
        }
        if constexpr (BM == kDiag) {
          // w[c] = diag_h[(T-1) + k0 - q0 - 63 + c]: bias(query r, block
          // key c) = w[c - r + 63]
          float* w = L + 128;
          const float* dh = diag + (size_t)h * (2 * T - 1);
          const int ws = (T - 1) + k0 - q0 - (QT - 1);
          float dv_[6];
#pragma unroll
          for (int u = 0; u < 6; ++u) {
            const int d = ws + lane + 32 * u;
            dv_[u] = d >= 0 && d < 2 * T - 1 ? __ldg(dh + d) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 6; ++u) w[lane + 32 * u] = dv_[u];
        }
        mbar_arrive(&full[stage]);
        if (++stage == MAIN_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const float scale2 = sm_scale * LOG2E;  // exact: a power of two times LOG2E
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kl0 = warp * 16 + g;  // warpgroup-local key row of half 0
    const bool kok[2] = {k0 + wg * 64 + kl0 < len,
                         k0 + wg * 64 + kl0 + 8 < len};
    const unsigned char* myK = sK + wg * TILE64;
    const unsigned char* myV = sV + wg * TILE64;
    float dva[32], dka[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dva[i] = dka[i] = 0.f;
    PHASES_BEGIN
    float st[32], dpt[32], dqa[16];
    uint32_t pa[4][4], da[4][4];
    // S^T = K Q^T and dP^T = V G^T (rows keys, columns queries) of stage stg
    auto issue_sdp = [&](int stg) {
      issue_qk(st, myK, sQ(stg));
      issue_qk(dpt, myV, sG(stg));
    };
    // tile qt in stage stg, its S^T and dP^T issued: P^T and dV, dS^T and
    // dK, then (both consumers' dS^T stored) dQ; returns with dV, dK and dQ
    // in flight, in that order
    auto front = [&](int qt, int stg) {
      const int par = qt & 1;
      const unsigned char* tQ = sQ(stg);
      const unsigned char* tG = sG(stg);
      const unsigned char* tB = sB(stg) + wg * TILE64;
      const float* L = sL(stg);
      wgmma_wait<1>();
      fence_operand(st);
      PHASE(1);
      // P^T, float32; its bf16 copy is the A operand of dV += P^T G
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * nt + 2 * half + e;
            const int ql = nt * 8 + 2 * t + e;
            const int kl = kl0 + 8 * half;
            float bb;
            if constexpr (BM == kDense) bb = bias_at<BM>(tB, ql, kl, 0);
            else bb = bias_at<BM>(reinterpret_cast<const unsigned char*>(L + 128),
                                  ql, wg * 64 + kl, QT - 1);
            const float s2 = fmaf(st[idx], scale2, fmaf(bb, LOG2E, -L[ql]));
            st[idx] = kok[half] ? exp2_fast(s2) : 0.f;
          }
        }
        pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(st[4 * nt], st[4 * nt + 1]);
        pa[nt >> 1][(nt & 1) * 2 + 1] =
            pack_bf16(st[4 * nt + 2], st[4 * nt + 3]);
      }
      fence_operand(dva);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs<1>(dva, pa[kk], desc_sw128(tG + kk * 2048));
      wgmma_commit();
      PHASE(2);
      wgmma_wait<1>();
      fence_operand(dpt);
      PHASE(3);
      // dS^T = P^T (dP^T - delta), float32 in dpt
      unsigned char* myDS = sDS + par * 2 * TILE64 + wg * TILE64;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * nt + 2 * half + e;
            dpt[idx] = st[idx] * (dpt[idx] - L[64 + nt * 8 + 2 * t + e]);
          }
          const uint32_t pk =
              pack_bf16(dpt[4 * nt + 2 * half], dpt[4 * nt + 2 * half + 1]);
          da[nt >> 1][(nt & 1) * 2 + half] = pk;
          // bf16 dS^T: rows keys, 64 queries a row, swizzled (dQ's A)
          *reinterpret_cast<uint32_t*>(
              myDS + sw128_offset(kl0 + 8 * half, nt * 8 + 2 * t)) = pk;
        }
      }
      if constexpr (BM == kDiag) {
        // float32 dS skewed: query row ql, column (block key) - ql + 63
        float* sk = skew + par * 64 * SKEW_LD;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ql = nt * 8 + 2 * t + e;
              sk[ql * (SKEW_LD - 1) + wg * 64 + kl0 + 8 * half + QT - 1] =
                  dpt[4 * nt + 2 * half + e];
            }
      }
      PHASE(4);
      fence_proxy_async();
      fence_operand(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs<1>(dka, da[kk], desc_sw128(tQ + kk * 2048));
      wgmma_commit();
      PHASE(5);
      // named barrier 3: both consumers' dS^T (and skewed dS) are stored
      asm volatile("bar.sync 3, %0;\n" ::"n"(BWD_CONSUMERS) : "memory");
      PHASE(6);
      // this consumer's 32 columns of dQ = dS K over the block's 128 keys:
      // A is dS^T read MN-major, B the K tile read MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n32k16_ss<1, 1>(
            dqa, desc_sw128(sDS + par * 2 * TILE64 + kk * 2048),
            desc_sw128(sK + kk * 2048 + wg * 64), kk > 0 ? 1 : 0);
      wgmma_commit();
    };
    float* my_part =
        dq_part + ((((size_t)b * H + h) * gridDim.x + kt) * n_qt * 2 + wg) *
                      2048 + tid * 16;
    mbar_wait(kvfull, 0);
    PHASE(12);
    int stage = 0;
    uint32_t phase = 0;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int stg = stage;
      mbar_wait(&full[stg], phase);
      PHASE(0);
      if (++stage == MAIN_STAGES) {
        stage = 0;
        phase ^= 1;
      }
      issue_sdp(stg);
      front(qt, stg);
      PHASE(7);
      wgmma_wait<1>();  // dV and dK done: the stage is free
      PHASE(8);
      fence_operand(dva);
      fence_operand(dka);
      fence_operand(pa);
      fence_operand(da);
      mbar_arrive(&empty[stg]);
      if constexpr (BM == kDiag) {
        // while dQ runs: column c holds diagonal j - i = k0 - q0 + c - 63 in
        // rows max(0, 63 - c) .. min(63, 190 - c); all 64 rows are read at
        // once (the others masked), into eight sums added in a fixed order
        const int c = threadIdx.x;
        if (c < DIAG_COLS) {
          const float* sk = skew + (qt & 1) * 64 * SKEW_LD + c;
          const int lo = QT - 1 - c, hi = KEYS + QT - 2 - c;
          float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int r = 0; r < QT; ++r) {
            const float x = sk[r * SKEW_LD];
            a[r & 7] += r >= lo && r <= hi ? x : 0.f;
          }
          part[((((size_t)b * gridDim.x + kt) * H + h) * n_qt + qt) *
                   DIAG_COLS + c] =
              ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
        }
      }
      PHASE(9);
      wgmma_wait<0>();
      fence_operand(dqa);
      PHASE(10);
      // this key block's dQ partial of the tile, in the accumulator's order
      float4* dst = reinterpret_cast<float4*>(my_part + (size_t)qt * 4096);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        __stcg(dst + u, make_float4(dqa[4 * u], dqa[4 * u + 1],
                                    dqa[4 * u + 2], dqa[4 * u + 3]));
      PHASE(11);
    }
    PHASES_END
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = h * 64 + nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = k0 + wg * 64 + kl0 + 8 * half;
        if (j >= T) continue;
        const int i = 4 * nt + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(dk + (row0 + j) * D + col) =
            __floats2bfloat162_rn(dka[i] * sm_scale, dka[i + 1] * sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + (row0 + j) * D + col) =
            __floats2bfloat162_rn(dva[i], dva[i + 1]);
      }
    }
  }
}

// ------------------------------------------------- dense bias gradient
// dbias[h, i, j] = sum_b ds_b[i, j] for i, j < T (0 in the pad band), in
// batch order: a block per (64-key tile, 128-query tile, head) walks the
// batch rows whose keys reach its tile, recomputes S and dP on wgmma from
// Q, G, K and V tiles that arrive by TMA (a three-stage ring, the next rows'
// tiles in flight while this one computes), and adds ds into float32
// registers; the bias tile, the same for every row, stays in registers.
__global__ void __launch_bounds__(BWD_THREADS, 1)
attn_bwd_dbias_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_g,
                      const __nv_bfloat16* __restrict__ bias, int ld,
                      const int* __restrict__ lens,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dbias, int B, int T, int H,
                      float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  auto sQ = [&](int s) { return base + s * DB_STAGE; };
  auto sG = [&](int s) { return sQ(s) + 2 * TILE64; };
  auto sK = [&](int s) { return sQ(s) + 4 * TILE64; };
  auto sV = [&](int s) { return sQ(s) + 5 * TILE64; };
  auto sL = [&](int s) {  // lse[128], delta[128]
    return reinterpret_cast<float*>(sQ(s) + 6 * TILE64);
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(base + PRE_STAGES * DB_STAGE);
  uint64_t* empty = full + PRE_STAGES;

  const int k0 = blockIdx.x * BK, q0 = blockIdx.y * ROWS2, h = blockIdx.z;
  const bool active = q0 < T && k0 < T;
  auto len_of = [&](int bb) { return min(max(lens[bb], 0), T); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < PRE_STAGES; ++s) {
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], BWD_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // ------------------------------------------ producer
    setmaxnreg_dec<24>();
    const int lane = threadIdx.x - BWD_CONSUMERS;
    if (lane < 32 && active) {
      int stage = 0;
      uint32_t phase = 0;
      for (int bb = 0; bb < B; ++bb) {
        if (len_of(bb) <= k0) continue;  // no key of this row in the tile
        mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage], 6 * TILE64);
          tma_load_3d(sQ(stage), &tm_q, &full[stage], h * 64, q0, bb);
          tma_load_3d(sG(stage), &tm_g, &full[stage], h * 64, q0, bb);
          tma_load_3d(sK(stage), &tm_k, &full[stage], h * 64, k0, bb);
          tma_load_3d(sV(stage), &tm_v, &full[stage], h * 64, k0, bb);
        }
        const float* lse_bh = lse + ((size_t)bb * H + h) * T;
        const float* del_bh = delta + ((size_t)bb * H + h) * T;
        float* L = sL(stage);
        float vals[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = q0 + lane + 32 * u;
          vals[u] = i < T ? lse_bh[i] : INFINITY;
          vals[4 + u] = i < T ? del_bh[i] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          L[lane + 32 * u] = vals[u];
          L[ROWS2 + lane + 32 * u] = vals[4 + u];
        }
        mbar_arrive(&full[stage]);
        if (++stage == PRE_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const float scale2 = sm_scale * LOG2E;  // exact: a power of two times LOG2E
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rb = wg * 64 + warp * 16 + g;
    const int i0 = q0 + rb, i1 = i0 + 8;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if (active) {
      float bv[32];  // this thread's bias values (0 past T)
      const __nv_bfloat16* bias_h = bias + (size_t)h * ld * ld;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = half ? i1 : i0, j = k0 + nt * 8 + 2 * t;
          float2 f = make_float2(0.f, 0.f);
          if (i < T && j < T)
            f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                bias_h + (size_t)i * ld + j));
          bv[4 * nt + 2 * half] = f.x;
          bv[4 * nt + 2 * half + 1] = f.y;
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int bb = 0; bb < B; ++bb) {
        const int len = len_of(bb);
        if (len <= k0) continue;
        mbar_wait(&full[stage], phase);
        float sc[32], dp[32];
        issue_qk(sc, sQ(stage) + wg * TILE64, sK(stage));
        issue_qk(dp, sG(stage) + wg * TILE64, sV(stage));
        wgmma_wait<0>();
        fence_operand(sc);
        fence_operand(dp);
        const float* L = sL(stage);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float lq = L[rb + 8 * half];
            const float dl = L[ROWS2 + rb + 8 * half];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * nt + 2 * half + e;
              const float s2 = fmaf(sc[idx], scale2, fmaf(bv[idx], LOG2E, -lq));
              const float p =
                  k0 + nt * 8 + 2 * t + e < len ? exp2_fast(s2) : 0.f;
              acc[idx] += p * (dp[idx] - dl);
            }
          }
        }
        mbar_arrive(&empty[stage]);
        if (++stage == PRE_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // the whole (ld, ld) plane: the T x T core, zeros around it
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = k0 + nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? i1 : i0;
        if (i >= ld || j >= ld) continue;
        const bool in = i < T;
        const float v0 = in && j < T ? acc[4 * nt + 2 * half] : 0.f;
        const float v1 = in && j + 1 < T ? acc[4 * nt + 2 * half + 1] : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(
            dbias + ((size_t)h * ld + i) * ld + j) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace hop

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// ddiag[h, d] = the sum of the main kernel's per-tile column sums: tile (b,
// kt, qt) holds diagonal j - i = d - (T-1) in column c = d - (T-1) - 128 kt
// + 64 qt + 63, c < 191; key blocks past lens[b] wrote nothing and are
// skipped. A block takes 32 diagonals of one head: lane l its diagonal,
// warp w the (batch row, key block) pairs w, w + 8, ... in order, and the
// eight warps' sums are added in warp order: one fixed order.
constexpr int SUM_WARPS = 8;
__global__ void __launch_bounds__(SUM_WARPS * 32)
attn_bwd_ddiag_sum_kernel(const float* __restrict__ part,
                          const int* __restrict__ lens,
                          float* __restrict__ ddiag, int B, int T, int H) {
  using namespace hop;
  __shared__ float sums[SUM_WARPS][32];
  const int W = 2 * T - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane, h = blockIdx.y;
  const int n_kb = (T + KEYS - 1) / KEYS;
  const int n_qt = (T + QT - 1) / QT;
  float acc = 0.f;
  if (d < W) {
    for (int r = warp; r < B * n_kb; r += SUM_WARPS) {
      const int b = r / n_kb, kt = r % n_kb;
      if (kt * KEYS >= min(max(lens[b], 0), T)) continue;
      const int X = d - (T - 1) - kt * KEYS + QT - 1;  // c = X + 64 qt
      const int lo = max(0, -floor_div(X, QT));
      const int hi = min(n_qt - 1, floor_div(KEYS + QT - 2 - X, QT));
      const float* row =
          part + (((size_t)b * n_kb + kt) * H + h) * n_qt * DIAG_COLS;
      for (int qt = lo; qt <= hi; ++qt)
        acc += row[(size_t)qt * DIAG_COLS + X + QT * qt];
    }
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && d < W) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < SUM_WARPS; ++w) total += sums[w][lane];
    ddiag[(size_t)h * W + d] = total;
  }
}

// dq = sm_scale * the sum of the main kernel's dQ partials over the key
// blocks of (b, h) that reach lens[b], in key-block order, rounded to bf16;
// 0 where the row has no key. A block per (64-query tile, head, batch row),
// a thread per consumer thread's 16 values of the tile. (BM only names the
// instance, so that a profile tells the two paths apart.)
template <int BM>
__global__ void __launch_bounds__(256)
attn_bwd_dq_sum_kernel(const float* __restrict__ dq_part,
                       const int* __restrict__ lens,
                       __nv_bfloat16* __restrict__ dq, int T, int H,
                       float sm_scale) {
  using namespace hop;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_qt = gridDim.x, n_kb = (T + KEYS - 1) / KEYS;
  const int nk = (min(max(lens[b], 0), T) + KEYS - 1) / KEYS;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const float4* src = reinterpret_cast<const float4*>(
      dq_part + ((((size_t)b * H + h) * n_kb * n_qt + qt) * 2 + wg) * 2048 +
      tid * 16);
  const size_t kstride = (size_t)n_qt * 1024;  // float4s between key blocks
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int kt = 0; kt < nk; ++kt) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 x = __ldcs(src + kt * kstride + u);
      acc[4 * u] += x.x;
      acc[4 * u + 1] += x.y;
      acc[4 * u + 2] += x.z;
      acc[4 * u + 3] += x.w;
    }
  }
  // consumer thread tid of warpgroup wg held rows warp*16 + g (+8), columns
  // wg*32 + nt*8 + 2t (+1)
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int D = H * 64;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = h * 64 + wg * 32 + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = qt * QT + warp * 16 + g + 8 * half;
      if (i < T)
        *reinterpret_cast<__nv_bfloat162*>(dq + ((size_t)b * T + i) * D +
                                           col) =
            __floats2bfloat162_rn(acc[4 * nt + 2 * half] * sm_scale,
                                  acc[4 * nt + 2 * half + 1] * sm_scale);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the dense bias (H, ld, ld) bf16: boxes of `rows` queries x 64 keys
inline cudaError_t bias_map(CUtensorMap* m, const void* bias, int ld, int H,
                            int rows) {
  const uint64_t dims[3] = {(uint64_t)ld, (uint64_t)ld, (uint64_t)H};
  const uint64_t strides[2] = {(uint64_t)ld * 2, (uint64_t)ld * ld * 2};
  const uint32_t box[3] = {BK, (uint32_t)rows, 1};
  return hopper::encode_bf16_sw128(m, bias, 3, dims, strides, box);
}

template <int BM>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* bias, int bias_ld, const void* lens,
                       void* out, void* lse, int B, int T, int H,
                       float sm_scale, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mb{};
  cudaError_t e = hop::qkv_map(&mq, q, B, T, H, hop::QROWS);
  if (e == cudaSuccess) e = hop::qkv_map(&mk, k, B, T, H, BK);
  if (e == cudaSuccess) e = hop::qkv_map(&mv, v, B, T, H, BK);
  if (e == cudaSuccess && BM == kDense)
    e = bias_map(&mb, bias, bias_ld, H, hop::QROWS);
  constexpr size_t bytes = hop::smem_bytes<BM>();
  if (e == cudaSuccess) e = allow_smem(hop::attention_fwd_kernel<BM>, bytes);
  if (e != cudaSuccess) return e;
  const int n_work = (T + hop::QROWS - 1) / hop::QROWS * H * B;
  const int grid = n_work < hopper::sm_count() ? n_work : hopper::sm_count();
  hop::attention_fwd_kernel<BM><<<grid, hop::THREADS, bytes, s>>>(
      mq, mk, mv, mb,
      BM == kDiag ? static_cast<const float*>(bias) : nullptr,
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), B, T, H, sm_scale);
  return cudaGetLastError();
}

// The backward's largest T: the kernels index with 32-bit ints per (batch
// row, head), and the dQ partials take 2 B H T^2 bytes.
constexpr int MAX_BWD_T = 65536;

template <int BM>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* g, const void* bias, int bias_ld,
                       const void* lens, const void* lse, void* delta,
                       void* work, void* dq, void* dk, void* dv, void* part,
                       void* dbias, int B, int T, int H, float sm_scale,
                       cudaStream_t s) {
  using bf = __nv_bfloat16;
  using namespace hop;
  if (T > MAX_BWD_T) return cudaErrorInvalidValue;
  int expo = 0;  // sm_scale must be a power of two (see the note above)
  if (!(sm_scale > 0.f) || frexpf(sm_scale, &expo) != 0.5f)
    return cudaErrorInvalidValue;
  CUtensorMap mq64, mq128, mg64, mg128, mk64, mk128, mv64, mv128, mb64{},
      mb128{};
  cudaError_t e = qkv_map(&mq64, q, B, T, H, QT);
  if (e == cudaSuccess) e = qkv_map(&mq128, q, B, T, H, ROWS2);
  if (e == cudaSuccess) e = qkv_map(&mg64, g, B, T, H, QT);
  if (e == cudaSuccess) e = qkv_map(&mg128, g, B, T, H, ROWS2);
  if (e == cudaSuccess) e = qkv_map(&mk64, k, B, T, H, BK);
  if (e == cudaSuccess) e = qkv_map(&mk128, k, B, T, H, KEYS);
  if (e == cudaSuccess) e = qkv_map(&mv64, v, B, T, H, BK);
  if (e == cudaSuccess) e = qkv_map(&mv128, v, B, T, H, KEYS);
  if (e == cudaSuccess && BM == kDense) {
    e = bias_map(&mb64, bias, bias_ld, H, QT);
    if (e == cudaSuccess) e = bias_map(&mb128, bias, bias_ld, H, ROWS2);
  }
  constexpr size_t pre_bytes = pre_smem_bytes<BM>();
  constexpr size_t main_bytes = main_smem_bytes<BM>();
  if (e == cudaSuccess) e = allow_smem(attn_bwd_delta_kernel<BM>, pre_bytes);
  if (e == cudaSuccess) e = allow_smem(attn_bwd_main_kernel<BM>, main_bytes);
  if (e != cudaSuccess) return e;
  const float* diag = BM == kDiag ? static_cast<const float*>(bias) : nullptr;
  const int n_qt = (T + QT - 1) / QT;
  attn_bwd_delta_kernel<BM>
      <<<dim3((T + ROWS2 - 1) / ROWS2, H, B), BWD_THREADS, pre_bytes, s>>>(
          mq128, mk64, mv64, mg128, mb128, diag,
          static_cast<const int*>(lens), static_cast<const float*>(lse),
          static_cast<float*>(delta), T, H, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_main_kernel<BM>
      <<<dim3((T + KEYS - 1) / KEYS, H, B), BWD_THREADS, main_bytes, s>>>(
          mq64, mk128, mv128, mg64, mb64, diag,
          static_cast<const int*>(lens), static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<float*>(work),
          static_cast<bf*>(dk), static_cast<bf*>(dv),
          static_cast<float*>(part), T, H, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dq_sum_kernel<BM><<<dim3(n_qt, H, B), 256, 0, s>>>(
      static_cast<const float*>(work), static_cast<const int*>(lens),
      static_cast<bf*>(dq), T, H, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (BM == kDense) {
    e = allow_smem(attn_bwd_dbias_kernel, DB_SMEM);
    if (e != cudaSuccess) return e;
    attn_bwd_dbias_kernel<<<dim3((bias_ld + BK - 1) / BK,
                                 (bias_ld + ROWS2 - 1) / ROWS2, H),
                            BWD_THREADS, DB_SMEM, s>>>(
        mq128, mk64, mv64, mg128, static_cast<const bf*>(bias), bias_ld,
        static_cast<const int*>(lens), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf*>(dbias), B, T, H,
        sm_scale);
    e = cudaGetLastError();
  }
  if constexpr (BM == kDiag) {
    attn_bwd_ddiag_sum_kernel<<<dim3((2 * T - 1 + 31) / 32, H),
                                SUM_WARPS * 32, 0, s>>>(static_cast<const float*>(part),
                                     static_cast<const int*>(lens),
                                     static_cast<float*>(dbias), B, T, H);
    e = cudaGetLastError();
  }
  return e;
}

}  // namespace

// q, k, v, out: (B, T, H*Dh) bf16; bias: (H, bias_ld, bias_ld) bf16 with
// bias_ld a multiple of 8, or null; lens: (B,) int32; lse: (B, H, T)
// float32 or null (written when given, for the backward). Dh must be 64,
// the head width of every attention preset (else cudaErrorInvalidValue).
extern "C" int attention_launch(const void* q, const void* k, const void* v,
                                const void* bias, int bias_ld,
                                const void* lens, void* out, void* lse, int B,
                                int T, int H, int Dh, float sm_scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias != nullptr && bias_ld % 8) return (int)cudaErrorInvalidValue;
  if (Dh != 64) return (int)cudaErrorInvalidValue;
  return (int)(bias != nullptr
                   ? launch_fwd<kDense>(q, k, v, bias, bias_ld, lens, out, lse,
                                        B, T, H, sm_scale, s)
                   : launch_fwd<kNoBias>(q, k, v, nullptr, 0, lens, out, lse,
                                         B, T, H, sm_scale, s));
}

// The backward. q, k, v, g (the output cotangent), dq, dk, dv: (B, T, H*Dh)
// bf16; bias as above or null; lse: the forward's (B, H, T) float32; delta:
// (B, H, T) float32 scratch; work: B * H * ceil(T / 128) * ceil(T / 64) *
// 4,096 float32 scratch (the dQ partials, 2 B H T^2 bytes); dbias: (H,
// bias_ld, bias_ld) bf16, all of it written, or null (then bias must be
// null too). Dh must be 64 and sm_scale a power of two; T at most 65,536
// (else cudaErrorInvalidValue).
extern "C" int attention_bwd_launch(const void* q, const void* k,
                                    const void* v, const void* g,
                                    const void* bias, int bias_ld,
                                    const void* lens, const void* lse,
                                    void* delta, void* work, void* dq,
                                    void* dk, void* dv, void* dbias, int B,
                                    int T, int H, int Dh, float sm_scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias != nullptr && bias_ld % 8) return (int)cudaErrorInvalidValue;
  if ((bias == nullptr) != (dbias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (Dh != 64 || work == nullptr) return (int)cudaErrorInvalidValue;
  return (int)(bias != nullptr
                   ? launch_bwd<kDense>(q, k, v, g, bias, bias_ld, lens, lse,
                                        delta, work, dq, dk, dv, nullptr,
                                        dbias, B, T, H, sm_scale, s)
                   : launch_bwd<kNoBias>(q, k, v, g, nullptr, 0, lens, lse,
                                         delta, work, dq, dk, dv, nullptr,
                                         nullptr, B, T, H, sm_scale, s));
}

// The dynamic shared memory of the wgmma kernels for bias mode `bias_mode`
// (0 none, 1 dense, 2 diagonals), for reports: `which` 0 the forward, 1 the
// backward's delta pre-pass, 2 its main kernel, 3 the dbias kernel.
extern "C" int attention_smem_bytes(int which, int bias_mode) {
  switch (which) {
    case 0:
      return bias_mode == kDense  ? (int)hop::smem_bytes<kDense>()
             : bias_mode == kDiag ? (int)hop::smem_bytes<kDiag>()
                                  : (int)hop::smem_bytes<kNoBias>();
    case 1:
      return bias_mode == kDense  ? (int)hop::pre_smem_bytes<kDense>()
             : bias_mode == kDiag ? (int)hop::pre_smem_bytes<kDiag>()
                                  : (int)hop::pre_smem_bytes<kNoBias>();
    case 2:
      return bias_mode == kDense  ? (int)hop::main_smem_bytes<kDense>()
             : bias_mode == kDiag ? (int)hop::main_smem_bytes<kDiag>()
                                  : (int)hop::main_smem_bytes<kNoBias>();
    default:
      return (int)hop::DB_SMEM;
  }
}

#ifdef ATTN_PHASES
// the phase cycles of the last main backward launch: the first key block's
// (0..15) and the last's (16..31)
extern "C" int attn_phase_read(long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, attn_phase_cycles, 32 * sizeof(long long));
  return (int)e;
}
#endif

// Long-audio flash attention (TPU kernel 7): as attention_launch, with the
// relative bias as diagonals diag (H, 2T-1) float32 (attention without a
// bias is attention_launch's).
extern "C" int flash_launch(const void* q, const void* k, const void* v,
                            const void* diag, const void* lens, void* out,
                            void* lse, int B, int T, int H, int Dh,
                            float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (diag == nullptr || Dh != 64) return (int)cudaErrorInvalidValue;
  return (int)launch_fwd<kDiag>(q, k, v, diag, 0, lens, out, lse, B, T, H,
                                sm_scale, s);
}

// Its backward (TPU kernel 8): as attention_bwd_launch, with diag (H, 2T-1)
// float32, part (B * ceil(T / 128) * H * ceil(T / 64), 192) float32
// scratch (the per-tile diagonal sums) and ddiag (H, 2T-1) float32, all
// written. T at most 65,536 (else cudaErrorInvalidValue).
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* g, const void* diag,
                                const void* lens, const void* lse, void* delta,
                                void* work, void* dq, void* dk, void* dv,
                                void* part, void* ddiag, int B, int T, int H,
                                int Dh, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (diag == nullptr || ddiag == nullptr || part == nullptr ||
      work == nullptr || Dh != 64)
    return (int)cudaErrorInvalidValue;
  return (int)launch_bwd<kDiag>(q, k, v, g, diag, 0, lens, lse, delta, work,
                                dq, dk, dv, part, ddiag, B, T, H, sm_scale,
                                s);
}
