// LSTM recurrence over precomputed input gates: the forward sequence and its
// reverse-time backward, each one persistent launch for all T steps.
//
// Replaces: pytorch_end2end_speech_recognition_tpu/ops/rnn_pallas.py
//   _fwd_call (pallas_call at :144, kernel body _fwd_kernel :57) and
//   _vjp_bwd (pallas_call at :213, kernel body _bwd_kernel :81).
//
// Inputs: xg (B, T, 4H) float32 = x @ W_ih + b (the input product stays a
// large matrix product outside, as it stays in XLA in the JAX package),
// whh (H, 4H) float32, lens (B,) int32. Gate order i, f, g, o.
// Forward, per step t (the TPU kernel's semantics):
//   gates = xg[:, t] + h @ W_hh (float32 throughout, no TF32)
//   c' = sig(f) c + sig(i) tanh(g);  h' = sig(o) tanh(c')
//   valid = t < lens[b]: h_all = valid ? h' : 0, c_all = valid ? c' : c
//   (c_all holds the frozen c past the length); the carry freezes too.
// Backward, t = T-1..0, from (xg, h_prev, c_prev) with h_prev = h_all[t-1]
// and c_prev = c_all[t-1] (zeros at t = 0): the gates are recomputed,
//   dh = dh_carry + g[t], dc = dc_carry + dh o (1 - tanh(c')^2), the four
//   pre-activation gradients masked to 0 past lens, written as dxg[t];
//   dh_carry = dgates @ W_hh^T, dc_carry = dc f (only on valid steps);
//   dW_hh = sum_t h_prev^T dgates.
//
// Bound on the H100. Operations: 2 B H 4H per step forward (4 per step
// backward: the recomputed gates, dW_hh and dh), float32 on the CUDA cores
// at 67 TFLOP/s: ~0.4 us per step at B=32, H=320. Bytes: xg, h_all, c_all
// once each, ~40 MB per direction at B=32, T=400. Neither bounds it: each
// step depends on the previous one's full h, which every SM needs, so the
// floor is T x (one step's latency: a grid-wide exchange of h).
//
// Design. W_hh (1-1.6 MiB float32) does not fit one SM's shared memory, so
// the time loop runs in one cooperative launch over H/4 blocks. A block owns
// four hidden units j and keeps their four gate columns {j, H+j, 2H+j, 3H+j}
// of W_hh in shared memory (16 H bytes) for the whole loop. A thread owns
// one (row, unit) pair and all four of its gates, so the cell update is a
// thread's own; the cell state stays in shared memory. Each step a block
// stages the full previous h (B, H) into shared memory (rows padded by four
// floats so the float4 reads of eight rows hit distinct banks), computes its
// gates, writes its units' new h into a global double buffer (in L2), and
// all blocks meet at cooperative_groups' grid barrier. The launch checks
// that the grid is co-resident (occupancy x SM count) and fails otherwise;
// there is no fallback. The backward's dh_prev = dgates @ W_hh^T sums over
// columns that other blocks own: each block writes its dgates slice to a
// global double buffer, all meet at the grid barrier, and each block then
// computes dh_prev of its own units from the full (B, 4H) dgates (staged H
// columns at a time) and the rows of W_hh of those units (another 16 H
// bytes). dW_hh's columns belong to the block that owns them, so each block
// accumulates sum_t h_prev^T dgates for them in shared memory and writes
// them once: no atomics, deterministic. grid.sync() is header-only in CUDA
// 12 (an acquire/release counter on the launch's grid workspace), so it
// builds under the plain `nvcc -c` / `-shared` flow without -rdc.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int J = 4;            // hidden units per block
constexpr int THREADS = 128;
constexpr int RSTEP = THREADS / J;  // rows handled in one pass

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void fma4(float4& acc, float h, const float4& w) {
  acc.x = fmaf(h, w.x, acc.x);
  acc.y = fmaf(h, w.y, acc.y);
  acc.z = fmaf(h, w.z, acc.z);
  acc.w = fmaf(h, w.w, acc.w);
}

// sum_k hrow[k] * ws[k][j] over the four gates of unit j (ws gate-packed)
__device__ __forceinline__ float4 gate_dot(const float* hrow,
                                           const float4* ws, int j, int H) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < H; k += 4) {
    const float4 hv = *reinterpret_cast<const float4*>(hrow + k);
    fma4(acc, hv.x, ws[(k + 0) * J + j]);
    fma4(acc, hv.y, ws[(k + 1) * J + j]);
    fma4(acc, hv.z, ws[(k + 2) * J + j]);
    fma4(acc, hv.w, ws[(k + 3) * J + j]);
  }
  return acc;
}

// the block's gate columns of W_hh, gate-packed: ws[k * J + j]
__device__ void load_cols(const float* whh, float4* ws, int H, int u0) {
  for (int i = threadIdx.x; i < H * J; i += THREADS) {
    const int k = i / J, j = i % J;
    const float* w = whh + (size_t)k * 4 * H + u0 + j;
    ws[i] = make_float4(w[0], w[H], w[2 * H], w[3 * H]);
  }
}

// rows[b][0..n) (global, row stride ld floats, n % 4 == 0) into dst[b][..]
// (row stride n + 4); zeros when src is null. cg: read through L2 (rows
// written by other blocks of this launch).
__device__ void stage_rows(const float* src, size_t ld, float* dst, int B,
                           int n, bool cg_load) {
  const int nq = n / 4;
  for (int i = threadIdx.x; i < B * nq; i += THREADS) {
    const int b = i / nq, q = i % nq;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src != nullptr) {
      const float4* p = reinterpret_cast<const float4*>(src + b * ld) + q;
      v = cg_load ? __ldcg(p) : __ldg(p);
    }
    *reinterpret_cast<float4*>(dst + b * (n + 4) + 4 * q) = v;
  }
}

__global__ void __launch_bounds__(THREADS)
    lstm_fwd_kernel(const float* __restrict__ xg,
                    const float* __restrict__ whh,
                    const int* __restrict__ lens, float* __restrict__ h_all,
                    float* __restrict__ c_all, float* hbuf, int B, int T,
                    int H) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  const int HP = H + 4;
  float4* ws = smem4;                                 // (H, J) gate-packed
  float* hs = reinterpret_cast<float*>(ws + H * J);   // (B, HP) h_{t-1}
  float* cs = hs + (size_t)B * HP;                    // (B, J) cell carry
  const int u0 = blockIdx.x * J, j = threadIdx.x % J, u = u0 + j;
  load_cols(whh, ws, H, u0);
  for (int i = threadIdx.x; i < B * J; i += THREADS) cs[i] = 0.f;

  for (int t = 0; t < T; ++t) {
    const float* hsrc = hbuf + (size_t)(t & 1) * B * H;
    float* hdst = hbuf + (size_t)((t + 1) & 1) * B * H;
    stage_rows(t == 0 ? nullptr : hsrc, H, hs, B, H, true);
    __syncthreads();
    for (int b = threadIdx.x / J; b < B; b += RSTEP) {
      const float* x = xg + ((size_t)b * T + t) * 4 * H + u;
      const float4 acc = gate_dot(hs + (size_t)b * HP, ws, j, H);
      const float ig = sigm(x[0] + acc.x), fg = sigm(x[H] + acc.y);
      const float gg = tanhf(x[2 * H] + acc.z), og = sigm(x[3 * H] + acc.w);
      const float c_prev = cs[b * J + j];
      const float c_new = fg * c_prev + ig * gg;
      const float h_new = og * tanhf(c_new);
      const bool valid = t < __ldg(lens + b);
      const size_t o = ((size_t)b * T + t) * H + u;
      h_all[o] = valid ? h_new : 0.f;
      c_all[o] = valid ? c_new : c_prev;
      cs[b * J + j] = valid ? c_new : c_prev;
      hdst[(size_t)b * H + u] = valid ? h_new : hs[(size_t)b * HP + u];
    }
    grid.sync();  // all of h_t written; hs free for the next stage
  }
}

__global__ void __launch_bounds__(THREADS)
    lstm_bwd_kernel(const float* __restrict__ xg,
                    const float* __restrict__ whh,
                    const int* __restrict__ lens,
                    const float* __restrict__ h_all,
                    const float* __restrict__ c_all,
                    const float* __restrict__ g, float* __restrict__ dxg,
                    float* __restrict__ dwhh, float* dgbuf, int B, int T,
                    int H) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  const int HP = H + 4, H4 = 4 * H, WP = 4 * H + 4;
  float4* ws = smem4;                     // (H, J) gate columns, packed
  float4* dws = ws + H * J;               // (H, J) dW_hh columns, packed
  float4* dgs = dws + H * J;              // (B, J) this step's dgates
  float* wt = reinterpret_cast<float*>(dgs + B * J);  // (J, WP) W_hh rows
  float* hs = wt + J * WP;                // (B, HP) h_prev, then dgates
  float* dhs = hs + (size_t)B * HP;       // (B, J) dh carry
  float* dcs = dhs + B * J;               // (B, J) dc carry
  float* dtmp = dcs + B * J;              // (B, J) dh_prev being summed
  const int u0 = blockIdx.x * J, j = threadIdx.x % J, u = u0 + j;
  load_cols(whh, ws, H, u0);
  for (int i = threadIdx.x; i < J * H4; i += THREADS) {
    const int jj = i / H4, col = i % H4;
    wt[jj * WP + col] = whh[(size_t)(u0 + jj) * H4 + col];
  }
  for (int i = threadIdx.x; i < H * J; i += THREADS)
    dws[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < B * J; i += THREADS) dhs[i] = dcs[i] = 0.f;

  for (int k = 0; k < T; ++k) {
    const int t = T - 1 - k;
    float* dgo = dgbuf + (size_t)(k & 1) * B * H4;
    stage_rows(t == 0 ? nullptr : h_all + (size_t)(t - 1) * H, (size_t)T * H,
               hs, B, H, false);
    __syncthreads();
    for (int b = threadIdx.x / J; b < B; b += RSTEP) {
      const size_t row = (size_t)b * T + t;
      const float* x = xg + row * H4 + u;
      const float4 acc = gate_dot(hs + (size_t)b * HP, ws, j, H);
      const float ig = sigm(x[0] + acc.x), fg = sigm(x[H] + acc.y);
      const float gg = tanhf(x[2 * H] + acc.z), og = sigm(x[3 * H] + acc.w);
      const float c_prev = t > 0 ? c_all[(row - 1) * H + u] : 0.f;
      const float tc = tanhf(fg * c_prev + ig * gg);
      const float dh = dhs[b * J + j] + g[row * H + u];
      const float dc = dcs[b * J + j] + dh * og * (1.f - tc * tc);
      const bool valid = t < __ldg(lens + b);
      float4 dg = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) {
        dg.x = dc * gg * ig * (1.f - ig);
        dg.y = dc * c_prev * fg * (1.f - fg);
        dg.z = dc * ig * (1.f - gg * gg);
        dg.w = dh * tc * og * (1.f - og);
        dcs[b * J + j] = dc * fg;
      }
      dgs[b * J + j] = dg;
      float* dx = dxg + row * H4 + u;
      float* dgb = dgo + (size_t)b * H4 + u;
      dx[0] = dgb[0] = dg.x;
      dx[H] = dgb[H] = dg.y;
      dx[2 * H] = dgb[2 * H] = dg.z;
      dx[3 * H] = dgb[3 * H] = dg.w;
    }
    __syncthreads();
    // dW_hh[:, own columns] += h_prev^T dgates
    for (int kk = threadIdx.x; kk < H; kk += THREADS) {
      float4 a[J];
#pragma unroll
      for (int jj = 0; jj < J; ++jj) a[jj] = dws[kk * J + jj];
      for (int b = 0; b < B; ++b) {
        const float h = hs[(size_t)b * HP + kk];
#pragma unroll
        for (int jj = 0; jj < J; ++jj) fma4(a[jj], h, dgs[b * J + jj]);
      }
#pragma unroll
      for (int jj = 0; jj < J; ++jj) dws[kk * J + jj] = a[jj];
    }
    grid.sync();  // every block's dgates in dgo; hs free
    // dh_prev of the own units = dgates (B, 4H) @ W_hh[own units]^T, H
    // columns at a time through hs
    for (int q = 0; q < 4; ++q) {
      stage_rows(dgo + (size_t)q * H, H4, hs, B, H, true);
      __syncthreads();
      for (int b = threadIdx.x / J; b < B; b += RSTEP) {
        const float* drow = hs + (size_t)b * HP;
        const float* wrow = wt + j * WP + q * H;
        float s = q == 0 ? 0.f : dtmp[b * J + j];
        for (int c = 0; c < H; c += 4) {
          const float4 d = *reinterpret_cast<const float4*>(drow + c);
          const float4 w = *reinterpret_cast<const float4*>(wrow + c);
          s = fmaf(d.x, w.x, s);
          s = fmaf(d.y, w.y, s);
          s = fmaf(d.z, w.z, s);
          s = fmaf(d.w, w.w, s);
        }
        dtmp[b * J + j] = s;
      }
      __syncthreads();
    }
    for (int b = threadIdx.x / J; b < B; b += RSTEP)
      if (t < __ldg(lens + b)) dhs[b * J + j] = dtmp[b * J + j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < H * J; i += THREADS) {
    const int kk = i / J, jj = i % J;
    const float4 a = dws[i];
    float* d = dwhh + (size_t)kk * H4 + u0 + jj;
    d[0] = a.x;
    d[H] = a.y;
    d[2 * H] = a.z;
    d[3 * H] = a.w;
  }
}

size_t fwd_smem(int B, int H) {
  return (size_t)H * J * sizeof(float4) + (size_t)B * (H + 4) * sizeof(float) +
         (size_t)B * J * sizeof(float);
}

size_t bwd_smem(int B, int H) {
  return 2 * (size_t)H * J * sizeof(float4) + (size_t)B * J * sizeof(float4) +
         (size_t)J * (4 * H + 4) * sizeof(float) +
         (size_t)B * (H + 4) * sizeof(float) + 3 * (size_t)B * J * sizeof(float);
}

// A cooperative launch of H/J blocks after checking that they are all
// co-resident; cudaErrorCooperativeLaunchTooLarge when they are not.
template <typename Kernel>
cudaError_t coop_launch(Kernel kernel, int blocks, size_t smem, void** args,
                        cudaStream_t s) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                  dim3(THREADS), args, smem, s);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" {

// xg: (B, T, 4H) float32; whh: (H, 4H) float32; lens: (B,) int32; h_all,
// c_all: (B, T, H) float32; hbuf: (2, B, H) float32 scratch. H % 4 == 0.
int lstm_fwd_launch(const void* xg, const void* whh, const void* lens,
                    void* h_all, void* c_all, void* hbuf, int B, int T, int H,
                    void* stream) {
  if (B < 1 || T < 1 || H < J || H % J) return (int)cudaErrorInvalidValue;
  const float* xg_ = static_cast<const float*>(xg);
  const float* whh_ = static_cast<const float*>(whh);
  const int* lens_ = static_cast<const int*>(lens);
  float* h_ = static_cast<float*>(h_all);
  float* c_ = static_cast<float*>(c_all);
  float* hb_ = static_cast<float*>(hbuf);
  void* args[] = {&xg_, &whh_, &lens_, &h_, &c_, &hb_, &B, &T, &H};
  return (int)coop_launch(lstm_fwd_kernel, H / J, fwd_smem(B, H), args,
                          static_cast<cudaStream_t>(stream));
}

// as above, plus h_all, c_all from the forward, g: (B, T, H) float32, the
// cotangent of h_all; dxg: (B, T, 4H); dwhh: (H, 4H); dgbuf: (2, B, 4H)
// float32 scratch.
int lstm_bwd_launch(const void* xg, const void* whh, const void* lens,
                    const void* h_all, const void* c_all, const void* g,
                    void* dxg, void* dwhh, void* dgbuf, int B, int T, int H,
                    void* stream) {
  if (B < 1 || T < 1 || H < J || H % J) return (int)cudaErrorInvalidValue;
  const float* xg_ = static_cast<const float*>(xg);
  const float* whh_ = static_cast<const float*>(whh);
  const int* lens_ = static_cast<const int*>(lens);
  const float* h_ = static_cast<const float*>(h_all);
  const float* c_ = static_cast<const float*>(c_all);
  const float* g_ = static_cast<const float*>(g);
  float* dx_ = static_cast<float*>(dxg);
  float* dw_ = static_cast<float*>(dwhh);
  float* db_ = static_cast<float*>(dgbuf);
  void* args[] = {&xg_, &whh_, &lens_, &h_, &c_, &g_, &dx_, &dw_, &db_,
                  &B, &T, &H};
  return (int)coop_launch(lstm_bwd_kernel, H / J, bwd_smem(B, H), args,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
