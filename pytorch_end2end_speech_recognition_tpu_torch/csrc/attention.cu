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
// one block of 4 warps takes a 64-query tile of one (b, h); each warp owns
// 16 query rows. The block walks 64-key tiles up to lens[b] only (keys past
// the row's length are never loaded). K, V and the tile's bias arrive by
// cp.async into a double buffer, so the next tile streams in while this one
// computes. Q . K^T and P . V run on the tensor cores as mma.sync.m16n8k16
// (bf16 in, float32 accumulate); V's fragments come from its row-major tile
// through ldmatrix.trans. The softmax is online: running row max and row
// sum in float32 registers, the output accumulator rescaled when the max
// grows. Scores never leave registers. blockIdx.z = b is the slowest grid
// index, so the blocks in flight share one layer's 4.7 MB bias, which stays
// in the 50 MB L2 across the batch. wgmma/TMA is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block (16 per warp)
constexpr int BK = 64;  // keys per tile
constexpr int LDB = BK + 8;  // padded row of the bias tile (bank spread)
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ float pair_sum(uint32_t packed) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&packed);
  return __low2float(v) + __high2float(v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DH>
__host__ __device__ constexpr int stage_elems() {  // bf16 elements per stage
  return 2 * BK * (DH + 8) + BQ * LDB;
}

template <int DH>
__global__ void __launch_bounds__(128)
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ bias, int bias_ld,
                 const int* __restrict__ lens, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int T, int H, float sm_scale) {
  constexpr int LDS = DH + 8;  // padded row of the Q/K/V tiles (bank spread)
  constexpr int CH = DH / 8;   // 16-byte chunks per head row
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  // stage s: K tile [BK][LDS], V tile [BK][LDS], bias tile [BQ][LDB]
  auto sK = [&](int s) { return smem + s * stage_elems<DH>(); };
  auto sV = [&](int s) { return sK(s) + BK * LDS; };
  auto sBias = [&](int s) { return sV(s) + BK * LDS; };

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column
  const int len = min(max(lens[b], 0), T);
  const size_t row0 = (size_t)b * T;
  const bool has_bias = bias != nullptr;
  const __nv_bfloat16* bias_h =
      has_bias ? bias + (size_t)h * bias_ld * bias_ld : nullptr;

  // Q tile, scaled in f32 and rounded back to bf16 (as the TPU kernel
  // does), staged in stage 1's K buffer and moved to registers.
  {
    __nv_bfloat16* sQ = sK(1);
    for (int c = tid; c < BQ * CH; c += blockDim.x) {
      const int r = c / CH, cc = (c % CH) * 8;
      const int row = qt * BQ + r;
      __align__(16) uint4 raw = make_uint4(0, 0, 0, 0);
      if (row < T)
        raw = *reinterpret_cast<const uint4*>(q + (row0 + row) * D + h * DH + cc);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        e[u] = __float2bfloat16(__bfloat162float(e[u]) * sm_scale);
      *reinterpret_cast<uint4*>(sQ + r * LDS + cc) = raw;
    }
  }
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const __nv_bfloat16* p0 = sK(1) + (wr + g) * LDS + kk * 16 + 2 * t;
    const __nv_bfloat16* p1 = p0 + 8 * LDS;
    qa[kk][0] = ld32(p0);
    qa[kk][1] = ld32(p1);
    qa[kk][2] = ld32(p0 + 8);
    qa[kk][3] = ld32(p1 + 8);
  }
  __syncthreads();  // stage 1 is free for the pipeline

  // start the async copies of key tile kt into stage s
  auto load_tile = [&](int kt, int s) {
    __nv_bfloat16* dk = sK(s);
    __nv_bfloat16* dv = sV(s);
    for (int c = tid; c < BK * CH; c += blockDim.x) {
      const int r = c / CH, cc = (c % CH) * 8;
      const int row = kt * BK + r;
      const size_t off = (row0 + min(row, T - 1)) * D + h * DH + cc;
      cp_async16(dk + r * LDS + cc, k + off, row < T);
      cp_async16(dv + r * LDS + cc, v + off, row < T);
    }
    if (has_bias) {
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

  float o[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l_run[2] = {0.f, 0.f};
  float l_ex[2] = {0.f, 0.f};  // sum of the unrounded e, for the row's lse
  const int i0 = qt * BQ + wr + g;  // this thread's two query rows
  const int i1 = i0 + 8;
  const int n_kt = (len + BK - 1) / BK;

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

    float sc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const __nv_bfloat16* kp = tK + (nt * 8 + g) * LDS + kk * 16 + 2 * t;
        mma_bf16(sc[nt], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }

    // bias, key mask, row max (scores kept in log2 units from here on)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wr + g + half * 8;  // block-local query row
        const int col = kt * BK + nt * 8 + 2 * t;
        float b0 = 0.f, b1 = 0.f;
        if (has_bias) {
          const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(
              tB + rl * LDB + nt * 8 + 2 * t);
          b0 = __low2float(bb);
          b1 = __high2float(bb);
        }
        float v0 = (sc[nt][2 * half] + b0) * LOG2E;
        float v1 = (sc[nt][2 * half + 1] + b1) * LOG2E;
        if (col >= len) v0 = MASKED;
        if (col + 1 >= len) v1 = MASKED;
        sc[nt][2 * half] = v0;
        sc[nt][2 * half + 1] = v1;
        mx[half] = fmaxf(mx[half], fmaxf(v0, v1));
      }
    }
    float m_new[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
    }

    uint32_t pa[BK / 16][4];
    float rs[2] = {0.f, 0.f}, rx[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float e0 = exp2f(sc[nt][0] - m_new[0]);
      const float e1 = exp2f(sc[nt][1] - m_new[0]);
      const float e2 = exp2f(sc[nt][2] - m_new[1]);
      const float e3 = exp2f(sc[nt][3] - m_new[1]);
      const uint32_t lo = pack_bf16(e0, e1);
      const uint32_t hi = pack_bf16(e2, e3);
      rs[0] += pair_sum(lo);
      rs[1] += pair_sum(hi);
      rx[0] += e0 + e1;
      rx[1] += e2 + e3;
      pa[nt >> 1][(nt & 1) * 2 + 0] = lo;
      pa[nt >> 1][(nt & 1) * 2 + 1] = hi;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * alpha[r] + rs[r];
      l_ex[r] = l_ex[r] * alpha[r] + rx[r];
    }
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
    // P . V: lanes 8q..8q+7 address keys kk*16 + (q&1)*8 + (lane&7) at head
    // columns (nt + (q>>1))*8, giving b0/b1 of n-tiles nt and nt+1
    const int q4 = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < DH / 8; nt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(
            bv, tV + (kk * 16 + (q4 & 1) * 8 + (lane & 7)) * LDS +
                    (nt + (q4 >> 1)) * 8);
        mma_bf16(o[nt], pa[kk], bv[0], bv[1]);
        mma_bf16(o[nt + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();  // stage s is consumed before it is refilled
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / fmaxf(l_run[r], 1e-30f);
    l_ex[r] += __shfl_xor_sync(0xffffffffu, l_ex[r], 1);
    l_ex[r] += __shfl_xor_sync(0xffffffffu, l_ex[r], 2);
  }
  if (lse != nullptr && t == 0) {
    // log2-domain log-sum-exp of the float32 scores (JAX's backward
    // recomputes p = e / sum(e) from unrounded e); +inf for a row with no
    // key (len 0), so the backward's p is 0 there as this output is
    float* lrow = lse + ((size_t)b * H + h) * T;
    if (i0 < T) lrow[i0] = len > 0 ? m_run[0] + log2f(l_ex[0]) : INFINITY;
    if (i1 < T) lrow[i1] = len > 0 ? m_run[1] + log2f(l_ex[1]) : INFINITY;
  }
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int col = h * DH + nt * 8 + 2 * t;
    if (i0 < T)
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + i0) * D + col) =
          __floats2bfloat162_rn(o[nt][0] * inv[0], o[nt][1] * inv[0]);
    if (i1 < T)
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + i1) * D + col) =
          __floats2bfloat162_rn(o[nt][2] * inv[1], o[nt][3] * inv[1]);
  }
}

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
//   again for ds, accumulates dq in registers and adds ds into the float32
//   dbias with 8-byte float2 atomics (one per element pair, across the
//   batch rows: the order of that sum varies from run to run).
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

template <int DH>
__global__ void __launch_bounds__(128)
attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ g,
                   const __nv_bfloat16* __restrict__ bias, int bias_ld,
                   const int* __restrict__ lens, const float* __restrict__ lse,
                   float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                   float* __restrict__ dbias, int T, int H, float sm_scale) {
  constexpr int LDS = DH + 8;
  constexpr int CH = DH / 8;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  auto sK = [&](int s) { return smem + s * stage_elems<DH>(); };
  auto sV = [&](int s) { return sK(s) + BK * LDS; };
  auto sBias = [&](int s) { return sV(s) + BK * LDS; };

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int len = min(max(lens[b], 0), T);
  const size_t row0 = (size_t)b * T;
  const bool has_bias = bias != nullptr;
  const __nv_bfloat16* bias_h =
      has_bias ? bias + (size_t)h * bias_ld * bias_ld : nullptr;

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
  const int wr = warp * 16;
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
    if (has_bias) {
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

  const int i0 = qt * BQ + wr + gq;  // this thread's two query rows
  const int i1 = i0 + 8;
  const float* lse_bh = lse + ((size_t)b * H + h) * T;
  const float l2[2] = {i0 < T ? lse_bh[i0] : INFINITY,
                       i1 < T ? lse_bh[i1] : INFINITY};
  float dsum[2] = {0.f, 0.f};  // delta = rowsum(dp * p), after pass 0
  float o[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  const int n_kt = (len + BK - 1) / BK;
  const int q4 = lane >> 3;

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
          if (has_bias) {
            const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(
                tB + rl * LDB + nt * 8 + 2 * t);
            b0 = __low2float(bb);
            b1 = __high2float(bb);
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
        // ds = p * (dp - delta), kept in p
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            p[nt][2 * half] *= dp[nt][2 * half] - dsum[half];
            p[nt][2 * half + 1] *= dp[nt][2 * half + 1] - dsum[half];
            const int i = half ? i1 : i0;
            const int col = kt * BK + nt * 8 + 2 * t;
            if (dbias != nullptr && i < T && col < len)
              atomicAdd(reinterpret_cast<float2*>(
                            dbias + ((size_t)h * bias_ld + i) * bias_ld + col),
                        make_float2(p[nt][2 * half], p[nt][2 * half + 1]));
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

template <int DH>
__global__ void __launch_bounds__(128)
attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ g,
                     const __nv_bfloat16* __restrict__ bias, int bias_ld,
                     const int* __restrict__ lens,
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
  const bool has_bias = bias != nullptr;
  const __nv_bfloat16* bias_h =
      has_bias ? bias + (size_t)h * bias_ld * bias_ld : nullptr;
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
    if (has_bias) {
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
          const float bb = has_bias ? __bfloat162float(tB[ql * LDB + kl]) : 0.f;
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
  const size_t bytes = 2 * stage_elems<64>() * sizeof(__nv_bfloat16);
  cudaError_t e = allow_smem(attention_kernel<64>, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  attention_kernel<64><<<grid, 128, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(bias), bias_ld,
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), T, H, sm_scale);
  return (int)cudaGetLastError();
}

// The backward. q, k, v, g (the output cotangent), dq, dk, dv: (B, T, H*Dh)
// bf16; bias as above or null; lse: the forward's (B, H, T) float32; delta:
// (B, H, T) float32 scratch; dbias: (H, bias_ld, bias_ld) float32, zeroed
// by the caller, or null (then bias must be null too). Dh must be 64.
extern "C" int attention_bwd_launch(const void* q, const void* k,
                                    const void* v, const void* g,
                                    const void* bias, int bias_ld,
                                    const void* lens, const void* lse,
                                    void* delta, void* dq, void* dk, void* dv,
                                    void* dbias, int B, int T, int H, int Dh,
                                    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias != nullptr && bias_ld % 8) return (int)cudaErrorInvalidValue;
  if ((bias == nullptr) != (dbias == nullptr)) return (int)cudaErrorInvalidValue;
  if (Dh != 64) return (int)cudaErrorInvalidValue;
  const size_t bytes = 2 * stage_elems<64>() * sizeof(__nv_bfloat16);
  cudaError_t e = allow_smem(attn_bwd_dq_kernel<64>, bytes);
  if (e == cudaSuccess) e = allow_smem(attn_bwd_dkdv_kernel<64>, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  using bf = __nv_bfloat16;
  attn_bwd_dq_kernel<64><<<grid, 128, bytes, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(g),
      static_cast<const bf*>(bias), bias_ld, static_cast<const int*>(lens),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<bf*>(dq), static_cast<float*>(dbias), T, H, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dkdv_kernel<64><<<grid, 128, bytes, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(g),
      static_cast<const bf*>(bias), bias_ld, static_cast<const int*>(lens),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf*>(dk), static_cast<bf*>(dv), T, H, sm_scale);
  return (int)cudaGetLastError();
}
