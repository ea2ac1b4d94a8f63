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
// above run unchanged; only the bias source differs. A forward tile (q0, k0)
// of 192 queries reads the 255 consecutive diagonals diag[h, (T-1) + k0 - q0
// - 191 ...], a backward tile of 64 the 127 from (T-1) + k0 - q0 - 63, staged
// as float32 and indexed w[j - i + rows - 1], so the bias is not rounded to
// bf16 (the one numerical difference from the dense path). In the backward's
// dq kernel each block sums its ds along diagonals in shared memory over its
// whole key sweep (one float per diagonal it touches, T + 63 of them; each
// warp first gathers a tile's diagonals in a window of its own, one row per
// lane column, and the windows are added in warp order), writes them to its
// own row of a partial buffer, and a second launch adds the rows per diagonal
// in a fixed order.
// Any T, no padding. Bound (H100 SXM, 989 TFLOP/s bf16): the products, as
// for the dense kernels; the diagonals add 16 KB per head.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block (16 per warp)
constexpr int BK = 64;  // keys per tile
constexpr int LDB = BK + 8;  // padded row of the bias tile (bank spread)
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Where the additive bias comes from: none; a dense (H, ld, ld) bf16 block
// (T <= 768, the Toeplitz expansion); or the diagonals (H, 2T-1) float32.
enum BiasMode { kNoBias = 0, kDense = 1, kDiag = 2 };
template <int BM> struct BiasOf { using T = __nv_bfloat16; };
template <> struct BiasOf<kDiag> { using T = float; };

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed on the way: lanes 8q..8q+7 give the
// row addresses of matrix q; register q receives matrix q's fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16-byte async copy global -> shared; zero-fills when `valid` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

// 4-byte async copy global -> shared (one float); zero-fills when invalid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

// Stage the 127 diagonals that the tile (q0, k0) reads, float32, into w:
// w[c] = diag_h[(T-1) + k0 - q0 - (BQ-1) + c], so bias(i, j) of the tile is
// w[j - i + BQ - 1]. Diagonals outside [0, 2T-1) belong to rows past T or
// keys past T, which are masked; they are zero-filled.
__device__ __forceinline__ void load_diag_window(float* w,
                                                 const float* diag_h, int T,
                                                 int q0, int k0, int tid,
                                                 int nthreads) {
  const int ws = (T - 1) + k0 - q0 - (BQ - 1);
  for (int c = tid; c < BQ + BK; c += nthreads) {
    const int d = ws + c;
    const bool ok = d >= 0 && d < 2 * T - 1;
    cp_async4(w + c, diag_h + (ok ? d : 0), ok);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DH>
__host__ __device__ constexpr int stage_elems() {  // bf16 elements per stage
  return 2 * BK * (DH + 8) + BQ * LDB;
}

// This head's bias: (ld, ld) bf16 (kDense) or (2T-1) float32 (kDiag).
template <int BM>
__device__ __forceinline__ const typename BiasOf<BM>::T* head_bias(
    const typename BiasOf<BM>::T* bias, int h, int bias_ld, int T) {
  if constexpr (BM == kDense) return bias + (size_t)h * bias_ld * bias_ld;
  if constexpr (BM == kDiag) return bias + (size_t)h * (2 * T - 1);
  return nullptr;
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
//   the same function in two layouts. With p recomputed from the forward's
//   row lse and g the output cotangent:
//   dv = p^T g,  dp = g v^T,  ds = p * (dp - rowsum(dp * p)),
//   dq = (ds k) * sm_scale,  dk = ds^T (q * sm_scale),  dbias_h = sum_b ds.
// Rounding as in the TPU kernel: q * sm_scale rounded to bf16 (also the dk
// operand), p rounded to bf16 for dv, ds rounded to bf16 for dq and dk,
// float32 accumulation everywhere, dbias summed in float32. rowsum(dp * p)
// is computed as the TPU kernel computes it, from float32 p, not through
// the FlashAttention-2 identity rowsum(g * o), which the bf16 rounding of o
// would break.
//
// Design. The TPU kernel holds a whole (Tp, Tp) score block per head; here
// the work is tiled 64 x 64 as in the forward, in two kernels:
// - attn_bwd_dq: one block per (64-query tile, head, batch row). Pass 1
//   walks the key tiles (up to lens[b]) and accumulates delta =
//   rowsum(dp * p), written out for the second kernel; pass 2 walks them
//   again for ds and accumulates dq in registers. With the diagonals it
//   also sums ds along them into a partial row of its own, and a second
//   launch adds the rows in a fixed order.
// - attn_bwd_dbias (dense bias): one block per (key tile, query tile,
//   head) recomputes ds on its tile for each batch row in order and sums
//   it in registers. No atomics anywhere: the same bits on every run.
// - attn_bwd_dkdv: one block per (64-key tile, head, batch row); each warp
//   owns 16 keys and computes the transposed scores s^T = k q^T directly,
//   so dk and dv accumulate in registers with no atomics. Key tiles past
//   lens[b] are written as zeros without loading anything.
// Tiles arrive by cp.async into a double buffer. The products are
// mma.sync.m16n8k16 (bf16 in, float32 out); operands that are not
// row-major for the product come through ldmatrix.trans.
//
// Bound on the H100 at the flagship shape (B=32, T=750, H=4, Dh=64):
// 2.5x the forward's operations, ~46 GFLOP per launch in bf16 (~47 us at
// 989 TFLOP/s); the recomputation (pass 1 and the dk/dv kernel's s and dp)
// adds 4 more products of the same size, the price of keeping every score
// tile on chip.

// kDiag: the dynamic shared memory holds, after the two stages, the
// four warps' windows of one key tile's diagonals and the block's
// per-diagonal ds sums sAcc[u] for the diagonal (T-1) - q0 - (BQ-1) + u, u
// < roundup(T, BK) + BQ; the block writes sAcc to its own row of the
// (B n_qt H, roundup(T, BK) + BQ) float32 partial buffer, which
// attn_bwd_ddiag_sum_kernel adds per diagonal in (batch row, query tile)
// order. kDense: dbias comes from attn_bwd_dbias_kernel. Every sum has one
// fixed order: the same bits on every run.
constexpr int DIAG_WIN = 80;  // a warp's 16 x 64 tile spans 79 diagonals

template <int DH, int BM>
__global__ void __launch_bounds__(128)
attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ g,
                   const typename BiasOf<BM>::T* __restrict__ bias,
                   int bias_ld, const int* __restrict__ lens,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, float* __restrict__ part,
                   int T, int H, float sm_scale) {
  constexpr int LDS = DH + 8;
  constexpr int CH = DH / 8;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  auto sK = [&](int s) { return smem + s * stage_elems<DH>(); };
  auto sV = [&](int s) { return sK(s) + BK * LDS; };
  auto sBias = [&](int s) { return sV(s) + BK * LDS; };
  // kDiag: the warps' windows [4 warps][4 lanes t][DIAG_WIN], then sAcc
  float* sWin = reinterpret_cast<float*>(smem + 2 * stage_elems<DH>());
  float* sAcc = sWin + 16 * DIAG_WIN;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const auto* bias_h = head_bias<BM>(bias, h, bias_ld, T);
  const int wr = warp * 16;
  const int i0 = qt * BQ + wr + gq;  // this thread's two query rows
  const int i1 = i0 + 8;
  const int q4 = lane >> 3;
  const int KW = (T + BK - 1) / BK * BK + BQ;  // diagonals a block can touch
  const int len = min(max(lens[b], 0), T);
  const size_t row0 = (size_t)b * T;
  const int n_kt = (len + BK - 1) / BK;
  if constexpr (BM == kDiag) {
    for (int u = tid; u < KW; u += blockDim.x) sAcc[u] = 0.f;
  }

  // Q (scaled in f32, rounded to bf16) and G tiles -> A fragments
  {
    __nv_bfloat16* sQ = sK(1);
    __nv_bfloat16* sG = sV(1);
    for (int c = tid; c < BQ * CH; c += blockDim.x) {
      const int r = c / CH, cc = (c % CH) * 8;
      const int row = qt * BQ + r;
      __align__(16) uint4 rq = make_uint4(0, 0, 0, 0), rg = rq;
      if (row < T) {
        const size_t off = (row0 + row) * D + h * DH + cc;
        rq = *reinterpret_cast<const uint4*>(q + off);
        rg = *reinterpret_cast<const uint4*>(g + off);
      }
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&rq);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        e[u] = __float2bfloat16(__bfloat162float(e[u]) * sm_scale);
      *reinterpret_cast<uint4*>(sQ + r * LDS + cc) = rq;
      *reinterpret_cast<uint4*>(sG + r * LDS + cc) = rg;
    }
  }
  __syncthreads();
  uint32_t qa[DH / 16][4], ga[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int o0 = (wr + gq) * LDS + kk * 16 + 2 * t, o1 = o0 + 8 * LDS;
    qa[kk][0] = ld32(sK(1) + o0);
    qa[kk][1] = ld32(sK(1) + o1);
    qa[kk][2] = ld32(sK(1) + o0 + 8);
    qa[kk][3] = ld32(sK(1) + o1 + 8);
    ga[kk][0] = ld32(sV(1) + o0);
    ga[kk][1] = ld32(sV(1) + o1);
    ga[kk][2] = ld32(sV(1) + o0 + 8);
    ga[kk][3] = ld32(sV(1) + o1 + 8);
  }
  __syncthreads();

  auto load_tile = [&](int kt, int s) {
    __nv_bfloat16* dk_ = sK(s);
    __nv_bfloat16* dv_ = sV(s);
    for (int c = tid; c < BK * CH; c += blockDim.x) {
      const int r = c / CH, cc = (c % CH) * 8;
      const int row = kt * BK + r;
      const size_t off = (row0 + min(row, T - 1)) * D + h * DH + cc;
      cp_async16(dk_ + r * LDS + cc, k + off, row < T);
      cp_async16(dv_ + r * LDS + cc, v + off, row < T);
    }
    if constexpr (BM == kDense) {
      __nv_bfloat16* db = sBias(s);
      for (int c = tid; c < BQ * (BK / 8); c += blockDim.x) {
        const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
        const int row = qt * BQ + r, col = kt * BK + cc;
        const bool ok = row < T && col < T;
        const __nv_bfloat16* src =
            bias_h + (size_t)(ok ? row : 0) * bias_ld + (ok ? col : 0);
        cp_async16(db + r * LDB + cc, src, ok);
      }
    }
    if constexpr (BM == kDiag)
      load_diag_window(reinterpret_cast<float*>(sBias(s)), bias_h, T,
                       qt * BQ, kt * BK, tid, blockDim.x);
    cp_async_commit();
  };

  const float* lse_bh = lse + ((size_t)b * H + h) * T;
  const float l2[2] = {i0 < T ? lse_bh[i0] : INFINITY,
                       i1 < T ? lse_bh[i1] : INFINITY};
  float dsum[2] = {0.f, 0.f};  // delta = rowsum(dp * p), after pass 0
  float o[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    if (n_kt > 0) load_tile(0, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt & 1;
      if (kt + 1 < n_kt) {
        load_tile(kt + 1, s ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* tK = sK(s);
      const __nv_bfloat16* tV = sV(s);
      const __nv_bfloat16* tB = sBias(s);

      float p[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const int off = (nt * 8 + gq) * LDS + kk * 16 + 2 * t;
          mma_bf16(p[nt], qa[kk], ld32(tK + off), ld32(tK + off + 8));
          mma_bf16(dp[nt], ga[kk], ld32(tV + off), ld32(tV + off + 8));
        }
      }
      // p = exp2((s + bias) * log2e - lse); 0 on masked keys
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rl = wr + gq + half * 8;
          const int col = kt * BK + nt * 8 + 2 * t;
          float b0 = 0.f, b1 = 0.f;
          if constexpr (BM == kDense) {
            const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(
                tB + rl * LDB + nt * 8 + 2 * t);
            b0 = __low2float(bb);
            b1 = __high2float(bb);
          }
          if constexpr (BM == kDiag) {
            const float* w = reinterpret_cast<const float*>(tB) +
                             (nt * 8 + 2 * t - rl + BQ - 1);
            b0 = w[0];
            b1 = w[1];
          }
          const float s0 = (p[nt][2 * half] + b0) * LOG2E;
          const float s1 = (p[nt][2 * half + 1] + b1) * LOG2E;
          p[nt][2 * half] = col < len ? exp2f(s0 - l2[half]) : 0.f;
          p[nt][2 * half + 1] = col + 1 < len ? exp2f(s1 - l2[half]) : 0.f;
        }
      }
      if (pass == 0) {
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
          dsum[0] += p[nt][0] * dp[nt][0] + p[nt][1] * dp[nt][1];
          dsum[1] += p[nt][2] * dp[nt][2] + p[nt][3] * dp[nt][3];
        }
      } else {
        // ds = p * (dp - delta), kept in p; 0 on masked keys and on rows
        // past T (p = 0 there)
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            p[nt][2 * half] *= dp[nt][2 * half] - dsum[half];
            p[nt][2 * half + 1] *= dp[nt][2 * half + 1] - dsum[half];
          }
        }
        if constexpr (BM == kDiag) {
          // ds onto this warp's window of the tile's diagonals: element
          // (row wr+gq+8*half, key kt*BK + nt*8 + 2t + e) lies on window
          // slot 8*(nt-half) + e + 2t - gq + 15, so (nt = m, half 0) and
          // (nt = m+1, half 1) share one; each lane t has its own row of
          // the window, so the lanes of one step hit distinct slots
          float* win = sWin + (warp * 4 + t) * DIAG_WIN + 2 * t - gq + 15;
          for (int u = lane; u < 4 * DIAG_WIN; u += 32)
            sWin[warp * 4 * DIAG_WIN + u] = 0.f;
          __syncwarp();
#pragma unroll
          for (int m = -1; m < BK / 8; ++m) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float val = 0.f;
              if (m >= 0) val += p[m][e];
              if (m + 1 < BK / 8) val += p[m + 1][2 + e];
              win[m * 8 + e] += val;
              __syncwarp();
            }
          }
        }
        // dq += bf16(ds) . K  (K tile is [key][d]: B fragments transposed)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t a[4];
          a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
          a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
          a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
          a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
          for (int nt = 0; nt < DH / 8; nt += 2) {
            uint32_t bk[4];
            ldmatrix_x4_trans(
                bk, tK + (kk * 16 + (q4 & 1) * 8 + (lane & 7)) * LDS +
                        (nt + (q4 >> 1)) * 8);
            mma_bf16(o[nt], a, bk[0], bk[1]);
            mma_bf16(o[nt + 1], a, bk[2], bk[3]);
          }
        }
        if constexpr (BM == kDiag) {
          // the four warps' windows into the block's sums, in warp and
          // lane order: block slot kt*BK + u is warp w's window slot u -
          // 48 + 16 w
          __syncthreads();
          if (tid < BQ + BK - 1) {
            float acc = 0.f;
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const int ul = tid - 48 + 16 * w;
              if (ul >= 0 && ul < DIAG_WIN) {
#pragma unroll
                for (int tt = 0; tt < 4; ++tt)
                  acc += sWin[(w * 4 + tt) * DIAG_WIN + ul];
              }
            }
            sAcc[kt * BK + tid] += acc;
          }
        }
      }
      __syncthreads();  // stage s is consumed before it is refilled
    }
    if (pass == 0) {
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
  if constexpr (BM == kDiag) {  // this block's row of the partial buffer
    __syncthreads();
    const int n_qt = gridDim.x;
    float* row = part + (((size_t)b * n_qt + qt) * H + h) * KW;
    const int n_acc = n_kt * BK + BQ;
    for (int u = tid; u < KW; u += blockDim.x)
      row[u] = u < n_acc ? sAcc[u] : 0.f;
  }

#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int col = h * DH + nt * 8 + 2 * t;
    if (i0 < T)
      *reinterpret_cast<__nv_bfloat162*>(dq + (row0 + i0) * D + col) =
          __floats2bfloat162_rn(o[nt][0] * sm_scale, o[nt][1] * sm_scale);
    if (i1 < T)
      *reinterpret_cast<__nv_bfloat162*>(dq + (row0 + i1) * D + col) =
          __floats2bfloat162_rn(o[nt][2] * sm_scale, o[nt][3] * sm_scale);
  }
}

// Dense dbias[h, i, j] = sum_b ds_b[i, j] for i, j < T (0 in the pad band),
// in batch order: one block per (64-key tile, 64-query tile, head) walks
// the batch rows whose keys reach its tile, recomputes that row's p and dp
// on its tile from q, k, v, g and the forward's lse and the dq kernel's
// delta (two 64 x 64 x 64 products, mma.sync), and adds ds into float32
// registers; the sum is rounded to bf16 once and stored. No atomics and no
// partial buffer: one fixed order, the same bits on every run. The tiles
// of the next batch row arrive by cp.async while this one computes; the
// bias tile, the same for every row, is held in registers.
template <int DH>
__global__ void __launch_bounds__(128, 3)
attn_bwd_dbias_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ g,
                      const __nv_bfloat16* __restrict__ bias, int bias_ld,
                      const int* __restrict__ lens,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dbias, int B, int T, int H,
                      float sm_scale) {
  constexpr int LDS = DH + 8;
  constexpr int CH = DH / 8;
  constexpr int TILE = BK * LDS;  // one staged (64, DH) tile
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  // stage s: Q, G, K, V tiles (72 KB in all: three blocks an SM)
  auto sT = [&](int s, int i) { return smem + (s * 4 + i) * TILE; };

  const int kt = blockIdx.x, qt = blockIdx.y, h = blockIdx.z;
  const int q0 = qt * BQ, k0 = kt * BK;
  const int D = H * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int i0 = q0 + wr + gq, i1 = i0 + 8;  // this thread's two query rows
  auto len_of = [&](int b) { return min(max(lens[b], 0), T); };
  auto next_b = [&](int b) {  // the next batch row whose keys reach k0
    while (b < B && len_of(b) <= k0) ++b;
    return b;
  };

  float acc[BK / 8][4];
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  if (q0 < T && k0 < T) {
    // the tile's bias is the same for every batch row: this thread's 32
    // values stay in registers (0 past T, where p is 0 anyway)
    const __nv_bfloat16* bias_h = bias + (size_t)h * bias_ld * bias_ld;
    float bv[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? i1 : i0, col = k0 + nt * 8 + 2 * t;
        float2 f = make_float2(0.f, 0.f);
        if (row < T && col < T)
          f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              bias_h + (size_t)row * bias_ld + col));
        bv[nt][2 * half] = f.x;
        bv[nt][2 * half + 1] = f.y;
      }
    }
    auto load_tiles = [&](int b, int s) {
      const size_t row0 = (size_t)b * T;
      for (int c = tid; c < BQ * CH; c += blockDim.x) {
        const int r = c / CH, cc = (c % CH) * 8;
        const int qrow = q0 + r, krow = k0 + r;
        const size_t qoff = (row0 + min(qrow, T - 1)) * D + h * DH + cc;
        const size_t koff = (row0 + min(krow, T - 1)) * D + h * DH + cc;
        cp_async16(sT(s, 0) + r * LDS + cc, q + qoff, qrow < T);
        cp_async16(sT(s, 1) + r * LDS + cc, g + qoff, qrow < T);
        cp_async16(sT(s, 2) + r * LDS + cc, k + koff, krow < T);
        cp_async16(sT(s, 3) + r * LDS + cc, v + koff, krow < T);
      }
      cp_async_commit();
    };
    int b = next_b(0), s = 0;
    if (b < B) load_tiles(b, 0);
    while (b < B) {
      const int bn = next_b(b + 1);
      if (bn < B) {
        load_tiles(bn, s ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int len = len_of(b);
      const __nv_bfloat16 *tQ = sT(s, 0), *tG = sT(s, 1), *tK = sT(s, 2),
                          *tV = sT(s, 3);
      // q * sm_scale rounded to bf16 and g: A fragments of this warp's rows
      uint32_t qa[DH / 16][4], ga[DH / 16][4];
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int o0 = (wr + gq) * LDS + kk * 16 + 2 * t, o1 = o0 + 8 * LDS;
        const int offs[4] = {o0, o1, o0 + 8, o1 + 8};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(tQ + offs[r]));
          qa[kk][r] = pack_bf16(f.x * sm_scale, f.y * sm_scale);
          ga[kk][r] = ld32(tG + offs[r]);
        }
      }
      float p[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const int off = (nt * 8 + gq) * LDS + kk * 16 + 2 * t;
          mma_bf16(p[nt], qa[kk], ld32(tK + off), ld32(tK + off + 8));
          mma_bf16(dp[nt], ga[kk], ld32(tV + off), ld32(tV + off + 8));
        }
      }
      const float* lse_bh = lse + ((size_t)b * H + h) * T;
      const float* del_bh = delta + ((size_t)b * H + h) * T;
      const float l2[2] = {i0 < T ? lse_bh[i0] : INFINITY,
                           i1 < T ? lse_bh[i1] : INFINITY};
      const float dl[2] = {i0 < T ? del_bh[i0] : 0.f,
                           i1 < T ? del_bh[i1] : 0.f};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = k0 + nt * 8 + 2 * t;
          const float s0 = (p[nt][2 * half] + bv[nt][2 * half]) * LOG2E;
          const float s1 =
              (p[nt][2 * half + 1] + bv[nt][2 * half + 1]) * LOG2E;
          const float p0 = col < len ? exp2f(s0 - l2[half]) : 0.f;
          const float p1 = col + 1 < len ? exp2f(s1 - l2[half]) : 0.f;
          acc[nt][2 * half] += p0 * (dp[nt][2 * half] - dl[half]);
          acc[nt][2 * half + 1] += p1 * (dp[nt][2 * half + 1] - dl[half]);
        }
      }
      __syncthreads();  // stage s is consumed before it is refilled
      b = bn;
      s ^= 1;
    }
  }

  // the whole (bias_ld, bias_ld) plane: the T x T core, zeros around it
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    const int col = k0 + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = half ? i1 : i0;
      if (i >= bias_ld || col >= bias_ld) continue;
      const bool in = i < T;
      const float v0 = in && col < T ? acc[nt][2 * half] : 0.f;
      const float v1 = in && col + 1 < T ? acc[nt][2 * half + 1] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(
          dbias + ((size_t)h * bias_ld + i) * bias_ld + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// ddiag[h, d] = the sum over (batch row, query tile), in that order, of the
// dq blocks' partial rows: block (b, qt) holds diagonal d at slot d - (T-1)
// + qt*BQ + BQ-1. One thread per (h, d).
__global__ void attn_bwd_ddiag_sum_kernel(const float* __restrict__ part,
                                          float* __restrict__ ddiag, int B,
                                          int T, int H) {
  const int W = 2 * T - 1;
  const int d = blockIdx.x * blockDim.x + threadIdx.x, h = blockIdx.y;
  if (d >= W) return;
  const int n_qt = (T + BQ - 1) / BQ;
  const int KW = (T + BK - 1) / BK * BK + BQ;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) {
    for (int qt = 0; qt < n_qt; ++qt) {
      const int u = d - (T - 1) + qt * BQ + (BQ - 1);
      if (u >= 0 && u < KW)
        acc += part[(((size_t)b * n_qt + qt) * H + h) * KW + u];
    }
  }
  ddiag[(size_t)h * W + d] = acc;
}

template <int DH, int BM>
__global__ void __launch_bounds__(128)
attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ g,
                     const typename BiasOf<BM>::T* __restrict__ bias,
                     int bias_ld, const int* __restrict__ lens,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int T, int H,
                     float sm_scale) {
  constexpr int LDS = DH + 8;
  constexpr int CH = DH / 8;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  // stage s: Q tile [BQ][LDS], G tile [BQ][LDS], bias tile [BQ][LDB]
  // (rows are queries, columns this block's keys)
  auto sQ = [&](int s) { return smem + s * stage_elems<DH>(); };
  auto sG = [&](int s) { return sQ(s) + BQ * LDS; };
  auto sBias = [&](int s) { return sG(s) + BQ * LDS; };

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int len = min(max(lens[b], 0), T);
  const size_t row0 = (size_t)b * T;
  const auto* bias_h = head_bias<BM>(bias, h, bias_ld, T);
  const int wr = warp * 16;
  const int j0 = kt * BK + wr + gq;  // this thread's two keys
  const int j1 = j0 + 8;

  if (kt * BK >= len) {  // every key of the tile is masked: p = 0
    for (int c = tid; c < BK * CH; c += blockDim.x) {
      const int r = c / CH, cc = (c % CH) * 8;
      const int row = kt * BK + r;
      if (row < T) {
        const size_t off = (row0 + row) * D + h * DH + cc;
        *reinterpret_cast<uint4*>(dk + off) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv + off) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  // K and V tiles -> A fragments (rows are keys)
  {
    for (int c = tid; c < BK * CH; c += blockDim.x) {
      const int r = c / CH, cc = (c % CH) * 8;
      const int row = kt * BK + r;
      __align__(16) uint4 rk = make_uint4(0, 0, 0, 0), rv = rk;
      if (row < T) {
        const size_t off = (row0 + row) * D + h * DH + cc;
        rk = *reinterpret_cast<const uint4*>(k + off);
        rv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sQ(1) + r * LDS + cc) = rk;
      *reinterpret_cast<uint4*>(sG(1) + r * LDS + cc) = rv;
    }
  }
  __syncthreads();
  uint32_t ka[DH / 16][4], va[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int o0 = (wr + gq) * LDS + kk * 16 + 2 * t, o1 = o0 + 8 * LDS;
    ka[kk][0] = ld32(sQ(1) + o0);
    ka[kk][1] = ld32(sQ(1) + o1);
    ka[kk][2] = ld32(sQ(1) + o0 + 8);
    ka[kk][3] = ld32(sQ(1) + o1 + 8);
    va[kk][0] = ld32(sG(1) + o0);
    va[kk][1] = ld32(sG(1) + o1);
    va[kk][2] = ld32(sG(1) + o0 + 8);
    va[kk][3] = ld32(sG(1) + o1 + 8);
  }
  __syncthreads();

  auto load_tile = [&](int qt, int s) {
    __nv_bfloat16* dq_ = sQ(s);
    __nv_bfloat16* dg_ = sG(s);
    for (int c = tid; c < BQ * CH; c += blockDim.x) {
      const int r = c / CH, cc = (c % CH) * 8;
      const int row = qt * BQ + r;
      const size_t off = (row0 + min(row, T - 1)) * D + h * DH + cc;
      cp_async16(dq_ + r * LDS + cc, q + off, row < T);
      cp_async16(dg_ + r * LDS + cc, g + off, row < T);
    }
    if constexpr (BM == kDiag)
      load_diag_window(reinterpret_cast<float*>(sBias(s)), bias_h, T,
                       qt * BQ, kt * BK, tid, blockDim.x);
    if constexpr (BM == kDense) {
      __nv_bfloat16* db = sBias(s);
      for (int c = tid; c < BQ * (BK / 8); c += blockDim.x) {
        const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
        const int row = qt * BQ + r, col = kt * BK + cc;
        const bool ok = row < T && col < T;
        const __nv_bfloat16* src =
            bias_h + (size_t)(ok ? row : 0) * bias_ld + (ok ? col : 0);
        cp_async16(db + r * LDB + cc, src, ok);
      }
    }
    cp_async_commit();
  };

  float dka[DH / 8][4], dva[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    dka[nt][0] = dka[nt][1] = dka[nt][2] = dka[nt][3] = 0.f;
    dva[nt][0] = dva[nt][1] = dva[nt][2] = dva[nt][3] = 0.f;
  }
  const float* lse_bh = lse + ((size_t)b * H + h) * T;
  const float* del_bh = delta + ((size_t)b * H + h) * T;
  const int n_qt = (T + BQ - 1) / BQ;
  const int q4 = lane >> 3;

  load_tile(0, 0);
  for (int qt = 0; qt < n_qt; ++qt) {
    const int s = qt & 1;
    if (qt + 1 < n_qt) {
      load_tile(qt + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    __nv_bfloat16* tQ = sQ(s);
    const __nv_bfloat16* tG = sG(s);
    const __nv_bfloat16* tB = sBias(s);
    // q * sm_scale rounded to bf16, in place (the s and dk operand)
    for (int c = tid; c < BQ * DH / 2; c += blockDim.x) {
      const int r = c / (DH / 2), cc = (c % (DH / 2)) * 2;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(tQ + r * LDS + cc);
      const float2 f = __bfloat1622float2(*e);
      *e = __floats2bfloat162_rn(f.x * sm_scale, f.y * sm_scale);
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v g^T: rows keys, columns queries
    float p[BQ / 8][4], ds[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
      ds[nt][0] = ds[nt][1] = ds[nt][2] = ds[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int off = (nt * 8 + gq) * LDS + kk * 16 + 2 * t;
        mma_bf16(p[nt], ka[kk], ld32(tQ + off), ld32(tQ + off + 8));
        mma_bf16(ds[nt], va[kk], ld32(tG + off), ld32(tG + off + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = nt * 8 + 2 * t + e;  // block-local query
        const int i = qt * BQ + ql;
        const bool qok = i < T;
        const float li = qok ? __ldg(lse_bh + i) : INFINITY;
        const float di = qok ? __ldg(del_bh + i) : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int kl = wr + gq + half * 8;  // block-local key
          float bb = 0.f;
          if constexpr (BM == kDense) bb = __bfloat162float(tB[ql * LDB + kl]);
          if constexpr (BM == kDiag)
            bb = reinterpret_cast<const float*>(tB)[kl - ql + BQ - 1];
          const float s2 = (p[nt][2 * half + e] + bb) * LOG2E;
          const bool kok = (half ? j1 : j0) < len;
          const float pv = (kok && qok) ? exp2f(s2 - li) : 0.f;
          p[nt][2 * half + e] = pv;
          ds[nt][2 * half + e] = pv * (ds[nt][2 * half + e] - di);
        }
      }
    }
    // dv += bf16(p^T) g and dk += bf16(ds^T) (q * sm_scale)
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], ad[4];
      ap[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      ap[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      ap[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      ap[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
      ad[0] = pack_bf16(ds[2 * kk][0], ds[2 * kk][1]);
      ad[1] = pack_bf16(ds[2 * kk][2], ds[2 * kk][3]);
      ad[2] = pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]);
      ad[3] = pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3]);
      const int roff = (kk * 16 + (q4 & 1) * 8 + (lane & 7)) * LDS;
#pragma unroll
      for (int nt = 0; nt < DH / 8; nt += 2) {
        const int off = roff + (nt + (q4 >> 1)) * 8;
        uint32_t bg[4], bq[4];
        ldmatrix_x4_trans(bg, tG + off);
        mma_bf16(dva[nt], ap, bg[0], bg[1]);
        mma_bf16(dva[nt + 1], ap, bg[2], bg[3]);
        ldmatrix_x4_trans(bq, tQ + off);
        mma_bf16(dka[nt], ad, bq[0], bq[1]);
        mma_bf16(dka[nt + 1], ad, bq[2], bq[3]);
      }
    }
    __syncthreads();  // stage s is consumed before it is refilled
  }

#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int col = h * DH + nt * 8 + 2 * t;
    if (j0 < T) {
      *reinterpret_cast<__nv_bfloat162*>(dk + (row0 + j0) * D + col) =
          __floats2bfloat162_rn(dka[nt][0], dka[nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + (row0 + j0) * D + col) =
          __floats2bfloat162_rn(dva[nt][0], dva[nt][1]);
    }
    if (j1 < T) {
      *reinterpret_cast<__nv_bfloat162*>(dk + (row0 + j1) * D + col) =
          __floats2bfloat162_rn(dka[nt][2], dka[nt][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv + (row0 + j1) * D + col) =
          __floats2bfloat162_rn(dva[nt][2], dva[nt][3]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

constexpr size_t kStageBytes = 2 * stage_elems<64>() * sizeof(__nv_bfloat16);
// The dq kernel's per-diagonal sums and warp windows in kDiag mode.
size_t diag_acc_bytes(int T) {
  return ((size_t)(T + BK - 1) / BK * BK + BQ + 16 * DIAG_WIN) * sizeof(float);
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
  if (e == cudaSuccess && BM == kDense) {
    const uint64_t dims[3] = {(uint64_t)bias_ld, (uint64_t)bias_ld,
                              (uint64_t)H};
    const uint64_t strides[2] = {(uint64_t)bias_ld * 2,
                                 (uint64_t)bias_ld * bias_ld * 2};
    const uint32_t box[3] = {BK, hop::QROWS, 1};
    e = hopper::encode_bf16_sw128(&mb, bias, 3, dims, strides, box);
  }
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

template <int BM>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* g, const void* bias, int bias_ld,
                       const void* lens, const void* lse, void* delta,
                       void* dq, void* dk, void* dv, void* part, void* dbias,
                       int B, int T, int H, float sm_scale, cudaStream_t s) {
  using bf = __nv_bfloat16;
  using Bias = typename BiasOf<BM>::T;
  const size_t dq_bytes =
      kStageBytes + (BM == kDiag ? diag_acc_bytes(T) : 0);
  cudaError_t e = allow_smem(attn_bwd_dq_kernel<64, BM>, dq_bytes);
  if (e == cudaSuccess)
    e = allow_smem(attn_bwd_dkdv_kernel<64, BM>, kStageBytes);
  if (e != cudaSuccess) return e;
  const int n_qt = (T + BQ - 1) / BQ;
  attn_bwd_dq_kernel<64, BM><<<dim3(n_qt, H, B), 128, dq_bytes, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(g),
      static_cast<const Bias*>(bias), bias_ld, static_cast<const int*>(lens),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<bf*>(dq), static_cast<float*>(part), T, H, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkdv_kernel<64, BM><<<dim3(n_qt, H, B), 128, kStageBytes, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(g),
      static_cast<const Bias*>(bias), bias_ld, static_cast<const int*>(lens),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf*>(dk), static_cast<bf*>(dv), T, H, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (BM == kDense) {
    constexpr size_t bytes = 8 * BK * (64 + 8) * sizeof(bf);
    e = allow_smem(attn_bwd_dbias_kernel<64>, bytes);
    if (e != cudaSuccess) return e;
    const int n_p = (bias_ld + BK - 1) / BK;
    attn_bwd_dbias_kernel<64><<<dim3(n_p, n_p, H), 128, bytes, s>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(g),
        static_cast<const bf*>(bias), bias_ld, static_cast<const int*>(lens),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf*>(dbias), B, T, H, sm_scale);
    e = cudaGetLastError();
  }
  if constexpr (BM == kDiag) {
    attn_bwd_ddiag_sum_kernel<<<dim3((2 * T - 1 + 127) / 128, H), 128, 0,
                                s>>>(static_cast<const float*>(part),
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
// (B, H, T) float32 scratch; dbias: (H, bias_ld, bias_ld) bf16, all of it
// written, or null (then bias must be null too). Dh must be 64.
extern "C" int attention_bwd_launch(const void* q, const void* k,
                                    const void* v, const void* g,
                                    const void* bias, int bias_ld,
                                    const void* lens, const void* lse,
                                    void* delta, void* dq, void* dk, void* dv,
                                    void* dbias, int B, int T, int H, int Dh,
                                    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias != nullptr && bias_ld % 8) return (int)cudaErrorInvalidValue;
  if ((bias == nullptr) != (dbias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (Dh != 64) return (int)cudaErrorInvalidValue;
  return (int)(bias != nullptr
                   ? launch_bwd<kDense>(q, k, v, g, bias, bias_ld, lens, lse,
                                        delta, dq, dk, dv, nullptr, dbias, B,
                                        T, H, sm_scale, s)
                   : launch_bwd<kNoBias>(q, k, v, g, nullptr, 0, lens, lse,
                                         delta, dq, dk, dv, nullptr, nullptr,
                                         B, T, H, sm_scale, s));
}

// The dynamic shared memory the forward kernel takes for bias mode
// `bias_mode` (0 none, 1 dense, 2 diagonals), for reports.
extern "C" int attention_fwd_smem_bytes(int bias_mode) {
  return bias_mode == kDense  ? (int)hop::smem_bytes<kDense>()
         : bias_mode == kDiag ? (int)hop::smem_bytes<kDiag>()
                              : (int)hop::smem_bytes<kNoBias>();
}

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
// float32, part (B * ceil(T / 64) * H, roundup(T, 64) + 64) float32
// scratch and ddiag (H, 2T-1) float32, all written.
// The dq kernel's shared memory grows with T (4 bytes per diagonal): T up to
// ~42,000 frames (else cudaErrorInvalidValue from the launch).
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* g, const void* diag,
                                const void* lens, const void* lse, void* delta,
                                void* dq, void* dk, void* dv, void* part,
                                void* ddiag, int B, int T, int H, int Dh,
                                float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (diag == nullptr || ddiag == nullptr || part == nullptr || Dh != 64)
    return (int)cudaErrorInvalidValue;
  return (int)launch_bwd<kDiag>(q, k, v, g, diag, 0, lens, lse, delta, dq, dk,
                                dv, part, ddiag, B, T, H, sm_scale, s);
}
