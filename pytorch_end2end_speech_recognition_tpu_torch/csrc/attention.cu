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
                 int T, int H, float sm_scale) {
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
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const uint32_t lo = pack_bf16(exp2f(sc[nt][0] - m_new[0]),
                                    exp2f(sc[nt][1] - m_new[0]));
      const uint32_t hi = pack_bf16(exp2f(sc[nt][2] - m_new[1]),
                                    exp2f(sc[nt][3] - m_new[1]));
      rs[0] += pair_sum(lo);
      rs[1] += pair_sum(hi);
      pa[nt >> 1][(nt & 1) * 2 + 0] = lo;
      pa[nt >> 1][(nt & 1) * 2 + 1] = hi;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
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

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* bias,
           int bias_ld, const void* lens, void* out, int B, int T, int H,
           float sm_scale, cudaStream_t s) {
  const size_t bytes = 2 * stage_elems<DH>() * sizeof(__nv_bfloat16);
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  attention_kernel<DH><<<grid, 128, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(bias), bias_ld,
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out), T, H,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, T, H*Dh) bf16; bias: (H, bias_ld, bias_ld) bf16 with
// bias_ld a multiple of 8, or null; lens: (B,) int32. Dh must be 64, the
// head width of every attention preset (else cudaErrorInvalidValue).
extern "C" int attention_launch(const void* q, const void* k, const void* v,
                                const void* bias, int bias_ld,
                                const void* lens, void* out, int B, int T,
                                int H, int Dh, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias != nullptr && bias_ld % 8) return (int)cudaErrorInvalidValue;
  if (Dh != 64) return (int)cudaErrorInvalidValue;
  return launch<64>(q, k, v, bias, bias_ld, lens, out, B, T, H, sm_scale, s);
}
