// LSTM recurrence over precomputed input gates, both directions of a
// bidirectional layer in one launch: the forward sequence, and its backward
// as a gate pre-pass, a reverse-time recurrence and a dW_hh product.
//
// Replaces: pytorch_end2end_speech_recognition_tpu/ops/rnn_pallas.py
//   _fwd_call (pallas_call at :144, kernel body _fwd_kernel :57) and
//   _vjp_bwd (pallas_call at :213, kernel body _bwd_kernel :81).
//
// Inputs, D directions stacked (D = 2 for a layer, 1 for one direction):
// xg (D, B, T, 4H) float32 = x @ W_ih + b (the reverse direction's already
// flipped; the input product stays a large matrix product outside, as it
// stays in XLA in the JAX package), whh (D, H, 4H) float32, lens (B,)
// int32. Gate order i, f, g, o. Forward, per direction and step t (the TPU
// kernel's semantics):
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
// Bound on the H100. Operations: 2 B H 4H per step and direction forward
// (3x that backward: the recomputed gates, dh and dW_hh), float32 on the
// CUDA cores at 67 TFLOP/s: ~0.8 us per step of two directions at B=32,
// H=320. Bytes: xg, h_all, c_all once each. Neither bounds it: each step
// needs the previous step's full h, so the floor is T x (one step's
// latency: the step's share of the product on the SMs that hold W_hh, and
// one exchange of h).
//
// Design (forward). The rows of the batch never interact, so the grid is
// (direction x row group) thread-block clusters that never wait for one
// another: no grid-wide barrier, no cooperative launch. A cluster of C
// blocks holds its direction's whole W_hh in float32 shared memory, split
// by hidden units: a block owns NU = H / C units and keeps their four gate
// columns, gate-packed as float4 (200 KiB at H 320, C 8). It runs all T
// steps for its cluster's R rows. Each step a block computes its units'
// gates from h_{t-1} in its own shared memory and sends its units' new h to
// every block of the cluster through distributed shared memory with
// st.async, each store completing transaction bytes on the receiver's
// mbarrier. A block waits on its own mbarrier for the R x H x 4 bytes of
// the next h, so the exchange costs one point-to-point signal per step, not
// a cluster barrier (0.27 against 0.70 us per step at C 8, measured by
// csrc/probe/dsmem_sync.cu). h is double-buffered; each buffer has its own
// mbarrier, and a block can only send step t+2's h into a buffer after
// every block of the cluster has sent it step t+1's, which each sends only
// after reading step t's: the data dependence orders the reuse. The gate
// dot: a warp is 8 units x 4 k-slices (a quarter-warp reads one k row of
// W: 128 bytes, one wavefront), each lane 4 gates x R rows over its k (a
// float4 of W and R floats of h per k), KW warps more k-slices; the 4
// slices' sums meet by shuffles, reduce-scattered so that slice s keeps
// the rows s + 4q with their four gates, the warps' through shared memory
// in a fixed order. That lane applies the nonlinearities and the cell
// update and keeps the row's c and h carry in registers. The xg of step
// t+1 is loaded into registers while step t computes, off the chain (a
// cp.async or TMA ring would need shared memory, which W_hh fills). The plan (C, rows per cluster R, k-warps) comes from
// cudaOccupancyMaxActiveClusters so that every cluster is resident in one
// wave where one wave can hold them (15 clusters of 8 on an H100 SXM: at
// B=32 with two directions, 14 clusters of 5 rows); past that, clusters
// run in waves, correct all the same since none waits for another.
//
// Design (backward), three launches per call:
//   (a) lstm_gemm_kernel<false>: the gate activations of every step at
//       once, act(xg + h_prev @ W_hh), one (B T, H) x (H, 4H) product in
//       float32 accuracy (3xTF32 on the tensor cores) written into dxg's
//       buffer;
//   (b) lstm_bwd_kernel: the recurrence, clusters as in the forward with
//       the same W_hh slices. Per step a block forms its units' dgates from
//       the stored activations and the carries, overwrites them in dxg, and
//       multiplies them by its columns of W_hh^T: a partial dh_prev of all
//       H units, which it sends to each unit's owner block (reduce-scatter
//       through st.async, R x H x 4 bytes per block per step, a quarter of
//       gathering the dgates, and no second copy of W_hh). An owner sums
//       the C partials in rank order: deterministic;
//   (c) lstm_gemm_kernel<true> + lstm_dw_reduce_kernel: dW_hh = sum over B
//       T of h_prev^T dgates (3xTF32 as (a)), per-split partials summed in
//       order by a second launch (no atomics, the same bits every launch).
// Only (b) is on the dependent chain; (a) and (c) run at the card's width.
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <tuple>
#include <type_traits>

#include "hopper.cuh"

// Cycles per phase of the recurrences' steps (thread 0 of block 0), for
// csrc/probe/lstm_phases.py, which builds this file with -DLSTM_PHASES; the
// kernel library compiles the markers to nothing.
#ifdef LSTM_PHASES
__device__ long long lstm_phase_cycles[16];
#define PHASES_BEGIN \
  long long ph_last_ = clock64(), ph_acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define PHASE(i)                        \
  do {                                  \
    const long long c_ = clock64();     \
    ph_acc_[i] += c_ - ph_last_;        \
    ph_last_ = c_;                      \
  } while (0)
#define PHASES_END(off)                                    \
  if (threadIdx.x == 0 && blockIdx.x == 0)                 \
    for (int i_ = 0; i_ < 8; ++i_) lstm_phase_cycles[(off) + i_] = ph_acc_[i_];
#else
#define PHASES_BEGIN
#define PHASE(i)
#define PHASES_END(off)
#endif

namespace {

using hopper::smem_u32;
namespace wmma = nvcuda::wmma;

constexpr int MAX_R = 8;           // rows per cluster
// threads per block (__launch_bounds__): 96 registers a thread forward, 128
// backward, whose dh product holds more
constexpr int FWD_THREADS = 640, BWD_THREADS = 512;
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may take
constexpr int CLUSTER_SIZES[] = {8, 16, 4, 2, 1};

// the gate nonlinearities from the hardware exponential and reciprocal
// (relative error ~1e-7 at |x| < 8, far inside the kernels' 2^-16 check; the
// IEEE division and expf/tanhf branch to slow paths on the step's chain)
__device__ __forceinline__ float sigm(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_(float x) {
  return 2.f * sigm(2.f * x) - 1.f;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of the same offset in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// a float into (possibly remote) shared memory; its 4 bytes complete on the
// receiver's mbarrier
__device__ __forceinline__ void send(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// wait for the phase of parity `parity`, acquiring the cluster's st.async
// stores; traps after ~2^34 cycles (~10 s) instead of hanging the card
__device__ __forceinline__ void wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// the block's gate columns of W_hh, gate-packed: (W[k][u], W[k][H+u],
// W[k][2H+u], W[k][3H+u]), u = u0 + j, at ws[k * NU + j] (the forward: a
// warp reads consecutive units) or, by_unit, at ws[j * H + k] (the
// backward: consecutive k)
__device__ void load_cols(const float* whh, float4* ws, int H, int NU, int u0,
                          bool by_unit) {
  for (int i = threadIdx.x; i < H * NU; i += blockDim.x) {
    const int k = i / NU, j = i % NU;
    const float* w = whh + (size_t)k * 4 * H + u0 + j;
    ws[by_unit ? j * H + k : i] = make_float4(w[0], w[H], w[2 * H], w[3 * H]);
  }
}

// the step's mbarriers: one arrival (the block's own thread 0, which also
// announces the bytes) and R x H x 4 transaction bytes from the cluster
__device__ void init_bars(uint64_t* bars, int T, uint32_t bytes) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bars[0], 1);
    hopper::mbar_init(&bars[1], 1);
    hopper::fence_barrier_init();
  }
  cluster_sync();  // every block running and its barriers initialised
  if (threadIdx.x == 0) {
    // buffer 1 receives what step 0 sends, buffer 0 what step 1 sends
    if (T > 1) hopper::mbar_arrive_expect_tx(&bars[1], bytes);
    if (T > 2) hopper::mbar_arrive_expect_tx(&bars[0], bytes);
  }
}

// step k > 0 of T: wait for what step k-1 sent into buffer k & 1, then
// announce that buffer's next phase (what step k+1 sends) if there is one
__device__ __forceinline__ void step_wait(uint64_t* bars, int k, int T,
                                          uint32_t bytes) {
  wait_cluster(&bars[k & 1], ((k - 1) >> 1) & 1);
  if (threadIdx.x == 0 && k + 2 < T)
    hopper::mbar_arrive_expect_tx(&bars[k & 1], bytes);
}

size_t fwd_smem(int H, int C, int R, int KW) {
  const int NU = H / C, RP = (R + 3) & ~3;
  return 16 * (size_t)H * NU + 4 * (size_t)2 * H * RP +
         4 * (size_t)(KW - 1) * 4 * NU * R + 16;
}

// Forward. Shared memory: ws float4 (H, NU); hs (2, H, RP) h_{t-1} of the
// cluster's rows (RP = R rounded up to 4, so a lane's rows are float4
// loads); part (KW-1, R, 4 NU) the k-warps' partial gate sums; 2 mbarriers.
// Block threads: 32 x (NU / 8) x KW.
template <int R>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    lstm_fwd_kernel(const float* __restrict__ xg,
                    const float* __restrict__ whh,
                    const int* __restrict__ lens, float* __restrict__ h_all,
                    float* __restrict__ c_all, int B, int T, int H, int KW,
                    int groups) {
  constexpr int RP = (R + 3) & ~3, RQ = (R + 3) / 4;
  extern __shared__ float4 smem4[];
  const int C = cluster_size(), rank = cluster_rank();
  const int NU = H / C, u0 = rank * NU, NG = NU / 8;
  const int cid = blockIdx.x / C, d = cid / groups, b0 = (cid % groups) * R;
  xg += (size_t)d * B * T * 4 * H;
  whh += (size_t)d * H * 4 * H;
  h_all += (size_t)d * B * T * H;
  c_all += (size_t)d * B * T * H;
  float4* ws = smem4;
  float* hs = reinterpret_cast<float*>(ws + (size_t)H * NU);
  float* part = hs + 2 * H * RP;
  uint64_t* bars = reinterpret_cast<uint64_t*>(part + (KW - 1) * 4 * NU * R);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ug = warp % NG, kw = warp / NG, s = lane >> 3;
  const int j = ug * 8 + (lane & 7), u = u0 + j;
  const int KS = 4 * KW, ks = kw * 4 + s;
  const uint32_t bytes = (uint32_t)R * H * 4;
  load_cols(whh, ws, H, NU, u0, false);
  for (int i = threadIdx.x; i < 2 * H * RP; i += blockDim.x) hs[i] = 0.f;
  init_bars(bars, T, bytes);

  // lane slice s of a k-warp-0 warp owns the rows r = s + 4q of unit u:
  // their four gates (xg, the nonlinearities), the cell and the carries
  int len[RQ];
  float cc[RQ], hc[RQ];
#pragma unroll
  for (int q = 0; q < RQ; ++q) {
    const int r = s + 4 * q, b = b0 + r;
    len[q] = (kw == 0 && r < R && b < B) ? __ldg(lens + b) : -1;  // no row
    cc[q] = hc[q] = 0.f;
  }
  // xg of this lane's rows at step t, gate g
  const float* xl = xg + ((size_t)(b0 + s) * T) * 4 * H + u;
  float xc[RQ][4], xn[RQ][4];
  auto load_x = [&](float (&x)[RQ][4], int t) {
#pragma unroll
    for (int q = 0; q < RQ; ++q)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        x[q][g] = len[q] >= 0
                      ? __ldg(xl + ((size_t)4 * q * T + t) * 4 * H + g * H)
                      : 0.f;
  };
  load_x(xc, 0);

  PHASES_BEGIN
  for (int t = 0; t < T; ++t) {
    const int ib = t & 1;
    PHASE(7);
    if (t > 0) step_wait(bars, t, T, bytes);
    PHASE(0);
    if (t + 1 < T) load_x(xn, t + 1);
    // partial gates over this lane's k: acc[g][r]
    float acc[4][R];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[g][r] = 0.f;
    const float* hb = hs + ib * H * RP;
#pragma unroll 4
    for (int k = ks; k < H; k += KS) {
      const float4 w = ws[k * NU + j];
      float hv[RP];
#pragma unroll
      for (int q = 0; q < RP / 4; ++q)
        *reinterpret_cast<float4*>(hv + 4 * q) =
            *reinterpret_cast<const float4*>(hb + k * RP + 4 * q);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[0][r] = fmaf(hv[r], w.x, acc[0][r]);
        acc[1][r] = fmaf(hv[r], w.y, acc[1][r]);
        acc[2][r] = fmaf(hv[r], w.z, acc[2][r]);
        acc[3][r] = fmaf(hv[r], w.w, acc[3][r]);
      }
    }
    PHASE(1);
    // the 4 k-slice lanes' sums, reduce-scattered over rows: slice s keeps
    // the rows r = s + 4q, all four gates. Level 1 (lanes xor 8) keeps the
    // rows of parity s & 1, as a1[g][p] = row 2p + (s & 1); level 2
    // (xor 16) the rows of a1 index parity s >> 1, as a2[g][q] = row 4q + s
    constexpr int P1 = (R + 1) / 2;
    const int b0s = s & 1, b1s = s >> 1;
    float a1[4][P1], a2[4][RQ];
#pragma unroll
    for (int p = 0; p < P1; ++p)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (2 * p + 1 < R) {
          const float keep = b0s ? acc[g][2 * p + 1] : acc[g][2 * p];
          const float give = b0s ? acc[g][2 * p] : acc[g][2 * p + 1];
          a1[g][p] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
        } else {  // the last row has no pair: parity 0 keeps it
          a1[g][p] = acc[g][2 * p] +
                     __shfl_xor_sync(0xffffffffu, acc[g][2 * p], 8);
        }
      }
#pragma unroll
    for (int q = 0; q < RQ; ++q)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (2 * q + 1 < P1) {
          const float keep = b1s ? a1[g][2 * q + 1] : a1[g][2 * q];
          const float give = b1s ? a1[g][2 * q] : a1[g][2 * q + 1];
          a2[g][q] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
        } else {
          a2[g][q] = a1[g][2 * q] +
                     __shfl_xor_sync(0xffffffffu, a1[g][2 * q], 16);
        }
      }
    PHASE(2);
    // the k-warps' sums, added in order by k-warp 0
    if (KW > 1) {
      if (kw > 0) {
#pragma unroll
        for (int q = 0; q < RQ; ++q)
          if (s + 4 * q < R)
#pragma unroll
            for (int g = 0; g < 4; ++g)
              part[((kw - 1) * R + s + 4 * q) * 4 * NU + g * NU + j] =
                  a2[g][q];
      }
      __syncthreads();
      if (kw == 0) {
        for (int w2 = 1; w2 < KW; ++w2)
#pragma unroll
          for (int q = 0; q < RQ; ++q)
            if (s + 4 * q < R)
#pragma unroll
              for (int g = 0; g < 4; ++g)
                a2[g][q] +=
                    part[((w2 - 1) * R + s + 4 * q) * 4 * NU + g * NU + j];
      }
    }
    PHASE(3);
    if (kw == 0) {
      const int ob = ib ^ 1;
      const uint32_t hdst = smem_u32(hs + ob * H * RP + u * RP);
      const uint32_t bar = smem_u32(&bars[ob]);
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const int r = s + 4 * q;
        if (r >= R) continue;
        float hv = 0.f;
        if (len[q] >= 0) {
          const float ig = sigm(a2[0][q] + xc[q][0]);
          const float fg = sigm(a2[1][q] + xc[q][1]);
          const float gg = tanh_(a2[2][q] + xc[q][2]);
          const float og = sigm(a2[3][q] + xc[q][3]);
          const float c_new = fg * cc[q] + ig * gg;
          const float h_new = og * tanh_(c_new);
          const bool valid = t < len[q];
          const size_t o = ((size_t)(b0 + r) * T + t) * H + u;
          if (valid) cc[q] = c_new, hc[q] = h_new;
          h_all[o] = valid ? h_new : 0.f;
          c_all[o] = cc[q];
          hv = hc[q];
        }
        if (t + 1 < T)
          for (int c = 0; c < C; ++c)
            send(map_rank(hdst + 4 * r, c), hv, map_rank(bar, c));
      }
#pragma unroll
      for (int q = 0; q < RQ; ++q)
#pragma unroll
        for (int g = 0; g < 4; ++g) xc[q][g] = xn[q][g];
    }
    PHASE(4);
  }
  PHASES_END(0)
  cluster_sync();  // no block leaves while another may still write to it
}

size_t bwd_smem(int H, int C, int R, int CW) {
  const int NU = H / C;
  return 16 * (size_t)H * NU + 16 * (size_t)NU * (R + 1) +
         4 * (size_t)(CW - 1) * R * H + 4 * (size_t)2 * R * H + 16;
}

constexpr int KPL = 8;  // k per lane in the backward's dh product

// Backward recurrence (b). dxg holds the activations (i, f, g, o) of every
// step on entry (from (a)) and the dgates on exit. Shared memory: ws float4
// (NU, H), the forward's columns by unit; dgs float4 (NU, R + 1) this
// step's dgates of the block's units (row stride R + 1 spreads the banks);
// part (CW-1, R, H) the unit-warps' partial dh; rs (2, C, R, NU) the
// partial dh_prev that each block of the cluster sent for this block's
// units; 2 mbarriers. Threads: 32 x ceil(H / 8 KPL) x CW (a warp: 8 x KPL
// consecutive k, 4 unit slices); thread i < R NU owns (row i / NU, unit
// i % NU): its carries and next step's inputs in registers.
template <int R>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    lstm_bwd_kernel(const float* __restrict__ whh,
                    const int* __restrict__ lens,
                    const float* __restrict__ c_all,
                    const float* __restrict__ g, float* __restrict__ dxg,
                    int B, int T, int H, int CW, int groups) {
  extern __shared__ float4 smem4[];
  const int C = cluster_size(), rank = cluster_rank();
  const int NU = H / C, u0 = rank * NU;
  const int cid = blockIdx.x / C, d = cid / groups, b0 = (cid % groups) * R;
  whh += (size_t)d * H * 4 * H;
  c_all += (size_t)d * B * T * H;
  g += (size_t)d * B * T * H;
  dxg += (size_t)d * B * T * 4 * H;
  float4* ws = smem4;
  float4* dgs = ws + (size_t)H * NU;
  float* part = reinterpret_cast<float*>(dgs + NU * (R + 1));
  float* rs = part + (CW - 1) * R * H;
  uint64_t* bars = reinterpret_cast<uint64_t*>(rs + 2 * R * H);
  const uint32_t bytes = (uint32_t)R * H * 4;
  load_cols(whh, ws, H, NU, u0, true);
  init_bars(bars, T, bytes);

  // the owner's (row, unit): carries and next step's inputs in registers
  const bool owner = threadIdx.x < R * NU;
  const int orow = threadIdx.x / NU, oj = threadIdx.x % NU, ou = u0 + oj;
  const int ob_ = b0 + orow;
  const int olen = (owner && ob_ < B) ? __ldg(lens + ob_) : -1;
  float dh = 0.f, dc = 0.f;
  bool was_valid = false;
  float4 an = make_float4(0.f, 0.f, 0.f, 0.f);
  float cpn = 0.f, gn = 0.f;
  auto load_in = [&](int t) {
    if (olen < 0) return;
    const size_t row = (size_t)ob_ * T + t;
    const float* a = dxg + row * 4 * H + ou;
    an = make_float4(a[0], a[H], a[2 * H], a[3 * H]);
    cpn = t > 0 ? __ldg(c_all + (row - 1) * H + ou) : 0.f;
    gn = __ldg(g + row * H + ou);
  };
  load_in(T - 1);

  // the dh product's lanes: 8 x KPL consecutive k per warp chunk, 4 unit
  // slices per warp (lanes xor 8, 16), CW warps over the units
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NKC = (H + 8 * KPL - 1) / (8 * KPL);
  const int kc = warp % NKC, cw = warp / NKC;
  const int kl = lane & 7, cs = lane >> 3;
  const int kbase = kc * 8 * KPL + kl;
  const int per = (NU + 4 * CW - 1) / (4 * CW);  // units per lane
  const int jlo = cw * per * 4;

  PHASES_BEGIN
  for (int k = 0; k < T; ++k) {
    const int t = T - 1 - k, ib = k & 1;
    PHASE(6);
    if (k > 0) step_wait(bars, k, T, bytes);
    PHASE(0);
    if (owner) {
      if (k > 0 && was_valid) {  // dh_carry = (dgates of t + 1) @ W_hh^T
        float sum = 0.f;
#pragma unroll 4
        for (int q = 0; q < C; ++q)
          sum += rs[((ib * C + q) * R + orow) * NU + oj];
        dh = sum;
      }
      const float4 a = an;
      const float cp = cpn, gc = gn;
      if (t > 0) load_in(t - 1);
      float4 dg = make_float4(0.f, 0.f, 0.f, 0.f);
      const bool valid = t < olen;
      if (valid) {
        const float tc = tanh_(a.y * cp + a.x * a.z);
        const float dht = dh + gc;
        const float dct = dc + dht * a.w * (1.f - tc * tc);
        dg.x = dct * a.z * a.x * (1.f - a.x);
        dg.y = dct * cp * a.y * (1.f - a.y);
        dg.z = dct * a.x * (1.f - a.z * a.z);
        dg.w = dht * tc * a.w * (1.f - a.w);
        dc = dct * a.y;
      }
      was_valid = valid;
      if (olen >= 0) {
        float* dx = dxg + ((size_t)ob_ * T + t) * 4 * H + ou;
        dx[0] = dg.x;
        dx[H] = dg.y;
        dx[2 * H] = dg.z;
        dx[3 * H] = dg.w;
      }
      dgs[oj * (R + 1) + orow] = dg;
    }
    PHASE(1);
    __syncthreads();
    PHASE(2);
    if (t == 0) break;  // dh_prev of step 0 is not needed
    // partial dh_prev[r][k] = sum over this warp's units j and gates of
    // dgates[r][j] W[k][gate, u0 + j]
    float acc[KPL][R];
#pragma unroll
    for (int m = 0; m < KPL; ++m)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[m][r] = 0.f;
    const int jhi = min(NU, jlo + per * 4);
    for (int jj = jlo + cs; jj < jhi; jj += 4) {
      float4 e[R], w[KPL];
#pragma unroll
      for (int r = 0; r < R; ++r) e[r] = dgs[jj * (R + 1) + r];
#pragma unroll
      for (int m = 0; m < KPL; ++m) {
        const int kk = kbase + 8 * m;
        w[m] = kk < H ? ws[jj * H + kk] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      // gate by gate (o, g, f, i), so that KPL x R independent sums lie
      // between two steps of one sum
#pragma unroll
      for (int m = 0; m < KPL; ++m)
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[m][r] = fmaf(e[r].w, w[m].w, acc[m][r]);
#pragma unroll
      for (int m = 0; m < KPL; ++m)
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[m][r] = fmaf(e[r].z, w[m].z, acc[m][r]);
#pragma unroll
      for (int m = 0; m < KPL; ++m)
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[m][r] = fmaf(e[r].y, w[m].y, acc[m][r]);
#pragma unroll
      for (int m = 0; m < KPL; ++m)
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[m][r] = fmaf(e[r].x, w[m].x, acc[m][r]);
    }
    PHASE(3);
    // the 4 unit slices' sums, reduce-scattered over k (lanes xor 8, 16):
    // lane slice cs keeps k = kbase + 8m for m = 4 (cs & 1) + 2 (cs >> 1)
    // + {0, 1}, every row
    const int b0s = cs & 1, b1s = cs >> 1;
    float v1[KPL / 2][R], v2[KPL / 4][R];
#pragma unroll
    for (int m = 0; m < KPL / 2; ++m)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float keep = b0s ? acc[KPL / 2 + m][r] : acc[m][r];
        const float give = b0s ? acc[m][r] : acc[KPL / 2 + m][r];
        v1[m][r] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
      }
#pragma unroll
    for (int m = 0; m < KPL / 4; ++m)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float keep = b1s ? v1[KPL / 4 + m][r] : v1[m][r];
        const float give = b1s ? v1[m][r] : v1[KPL / 4 + m][r];
        v2[m][r] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
      }
    const int mbase = (KPL / 2) * b0s + (KPL / 4) * b1s;
    // the unit-warps' sums, added in order by unit-warp 0
    if (CW > 1) {
      if (cw > 0) {
#pragma unroll
        for (int m = 0; m < KPL / 4; ++m) {
          const int kk = kbase + 8 * (mbase + m);
          if (kk < H)
#pragma unroll
            for (int r = 0; r < R; ++r)
              part[((cw - 1) * R + r) * H + kk] = v2[m][r];
        }
      }
      __syncthreads();
    }
    PHASE(4);
    if (cw == 0) {  // to each k's owner block
      // the unit-warps' partials first: a send is a compiler memory
      // barrier, so loads after one would wait for it
      for (int w2 = 1; w2 < CW; ++w2)
#pragma unroll
        for (int m = 0; m < KPL / 4; ++m) {
          const int kk = kbase + 8 * (mbase + m);
          if (kk < H)
#pragma unroll
            for (int r = 0; r < R; ++r)
              v2[m][r] += part[((w2 - 1) * R + r) * H + kk];
        }
      const int ob = ib ^ 1;
      const uint32_t bar0 = smem_u32(&bars[ob]);
      const uint32_t base = smem_u32(rs + (ob * C + rank) * R * NU);
#pragma unroll
      for (int m = 0; m < KPL / 4; ++m) {
        const int kk = kbase + 8 * (mbase + m);
        if (kk >= H) continue;
        const int dst = kk / NU;
        const uint32_t bar = map_rank(bar0, dst);
        const uint32_t addr = map_rank(base + 4 * (kk - dst * NU), dst);
#pragma unroll
        for (int r = 0; r < R; ++r) send(addr + 4 * r * NU, v2[m][r], bar);
      }
    }
    PHASE(5);
  }
  PHASES_END(8)
  cluster_sync();
}

// ------------------------------------------------------- (a) and (c): GEMM
// out(i, n) = sum_p X(i, p) Y(p, n) in float32 from tensor-core products
// split three ways (3xTF32: x = hi + lo, both TF32, and x y ~ hi_x hi_y +
// hi_x lo_y + lo_x hi_y summed in float32, ~2^-21 of |x y| per product;
// only the gate pre-pass and dW_hh, never the recurrence). 128 x 128 tiles
// of 8 warps (64 x 32 each, wmma 16 x 16 x 8), p in steps of 16 through a
// ring of GS stages filled by cp.async (zeros where a row or column is out
// of range). X reads h_prev(m, k) = h_all[m - 1][k] (0 where t(m) = 0).
//   DW false, (a): i = m < M = B T, p = k < H, Y = W_hh (H, 4H); X tiles
//     [i][p]; the epilogue writes act(xg + out) (tanh for gate g, else
//     sigmoid) to dxg.
//   DW true, (c): i = k < H, p = m in this split's rows, Y = dgates (M,
//     4H) in dxg; X tiles [p][i]; out goes to part (S, H, 4H).
constexpr int GT = 128, GK = 16, GS = 4;
constexpr int XLD_A = GK + 4, XLD_C = GT + 4, YLD = GT + 4;  // row strides
constexpr int X_STAGE = GT * XLD_A > GK * XLD_C ? GT * XLD_A : GK * XLD_C;
constexpr int Y_STAGE = GK * YLD;
constexpr int GTHREADS = 256;  // 8 warps of 64 x 32, two blocks an SM
constexpr size_t GEMM_SMEM =
    4 * ((size_t)GS * (X_STAGE + Y_STAGE) + (GTHREADS / 32) * 16 * 16);

using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
template <bool DW>
using FragA = wmma::fragment<
    wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
    typename std::conditional<DW, wmma::col_major, wmma::row_major>::type>;

// x into its TF32 high part (in x) and the TF32 rest (in lo)
template <typename Frag>
__device__ __forceinline__ void split_tf32(Frag& x, Frag& lo) {
#pragma unroll
  for (int e = 0; e < x.num_elements; ++e) {
    const float v = x.x[e], hi = wmma::__float_to_tf32(v);
    x.x[e] = hi;
    lo.x[e] = wmma::__float_to_tf32(v - hi);
  }
}

// 16 bytes global -> shared, asynchronously; zeros when !ok
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

template <bool DW>
__global__ void __launch_bounds__(GTHREADS, 2)
    lstm_gemm_kernel(const float* __restrict__ h_all,
                     const float* __restrict__ y,
                     const float* __restrict__ xg, float* __restrict__ out,
                     int B, int T, int H, int rows_per_split) {
  extern __shared__ __align__(128) float gsm[];
  float* xs = gsm;                          // GS x X_STAGE
  float* ys = xs + GS * X_STAGE;            // GS x Y_STAGE
  float* scr = ys + GS * Y_STAGE;           // a 16 x 16 tile a warp
  const int d = blockIdx.z, M = B * T, N = 4 * H, tid = threadIdx.x;
  h_all += (size_t)d * M * H;
  const int I = DW ? H : M;
  const int tiles_n = (N + GT - 1) / GT;
  const int i0 = (blockIdx.x / tiles_n) * GT, n0 = (blockIdx.x % tiles_n) * GT;
  int p0 = 0, p1 = H;
  if (DW) {
    y += (size_t)d * M * N;
    out += ((size_t)d * gridDim.y + blockIdx.y) * H * N;
    p0 = blockIdx.y * rows_per_split;
    p1 = min(M, p0 + rows_per_split);
  } else {
    y += (size_t)d * H * N;
    xg += (size_t)d * M * N;
    out += (size_t)d * M * N;
  }
  // stage `slot` <- the tiles at p (two 16-byte chunks of X and of Y a
  // thread); h_prev(m, k) reads row m - 1, zeros at t(m) = 0
  auto load = [&](int slot, int p) {
    float* xd = xs + slot * X_STAGE;
    float* yd = ys + slot * Y_STAGE;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int f = tid + GTHREADS * e;
      int m, k;
      float* dst;
      if (DW) {  // X(i, p) = h_prev(p, i): [p][i], along i
        m = p + f / 32;
        k = i0 + (f % 32) * 4;
        dst = xd + (f / 32) * XLD_C + (f % 32) * 4;
      } else {   // X(i, p) = h_prev(i, p): [i][p], along p
        m = i0 + f / 4;
        k = p + (f % 4) * 4;
        dst = xd + (f / 4) * XLD_A + (f % 4) * 4;
      }
      const bool ok = m < (DW ? p1 : M) && k < H && m % T != 0;
      cp16(dst, ok ? h_all + (size_t)(m - 1) * H + k : h_all, ok);
      const int pp = p + f / 32, n = n0 + (f % 32) * 4;
      const bool oky = pp < p1 && n < N;
      cp16(yd + (f / 32) * YLD + (f % 32) * 4,
           oky ? y + (size_t)pp * N + n : y, oky);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const int warp = tid >> 5, lane = tid & 31;
  const int wi = (warp / 4) * 64, wn = (warp % 4) * 32;
  FragC acc[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.f);
  const int nk = (p1 - p0 + GK - 1) / GK;
#pragma unroll
  for (int st = 0; st < GS - 1; ++st) {
    if (st < nk) load(st, p0 + st * GK);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(GS - 2) : "memory");
    __syncthreads();  // stage kt landed; stage kt - 1 free for refilling
    if (kt + GS - 1 < nk) load((kt + GS - 1) % GS, p0 + (kt + GS - 1) * GK);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* xd = xs + (kt % GS) * X_STAGE;
    const float* yd = ys + (kt % GS) * Y_STAGE;
#pragma unroll
    for (int kk = 0; kk < GK; kk += 8) {
      FragB bh[2], bl[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        wmma::load_matrix_sync(bh[b], yd + kk * YLD + wn + 16 * b, YLD);
        split_tf32(bh[b], bl[b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        FragA<DW> ah, al;
        if (DW)
          wmma::load_matrix_sync(ah, xd + kk * XLD_C + wi + 16 * a, XLD_C);
        else
          wmma::load_matrix_sync(ah, xd + (wi + 16 * a) * XLD_A + kk, XLD_A);
        split_tf32(ah, al);
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          wmma::mma_sync(acc[a][b], al, bh[b], acc[a][b]);
          wmma::mma_sync(acc[a][b], ah, bl[b], acc[a][b]);
          wmma::mma_sync(acc[a][b], ah, bh[b], acc[a][b]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // epilogue: each 16 x 16 tile through the warp's scratch, a lane taking
  // half a row (8 columns) of it
  float* ws_ = scr + warp * 256;
  const int er = lane / 2, ec = (lane % 2) * 8;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      wmma::store_matrix_sync(ws_, acc[a][b], 16, wmma::mem_row_major);
      __syncwarp();
      const int i = i0 + wi + 16 * a + er;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + wn + 16 * b + ec + 4 * h;
        if (i < I && n < N) {
          float4 v = *reinterpret_cast<const float4*>(ws_ + er * 16 + ec +
                                                      4 * h);
          if (!DW) {  // the four columns share a gate (H % 4 == 0)
            const float4 x =
                __ldg(reinterpret_cast<const float4*>(xg + (size_t)i * N + n));
            const bool tg = n / H == 2;
            v.x = tg ? tanh_(v.x + x.x) : sigm(v.x + x.x);
            v.y = tg ? tanh_(v.y + x.y) : sigm(v.y + x.y);
            v.z = tg ? tanh_(v.z + x.z) : sigm(v.z + x.z);
            v.w = tg ? tanh_(v.w + x.w) : sigm(v.w + x.w);
          }
          *reinterpret_cast<float4*>(out + (size_t)i * N + n) = v;
        }
      }
      __syncwarp();
    }
}

// dwhh[d][e] = sum over s = 0..S-1 in order of part[d][s][e], e < n4 x 4
__global__ void lstm_dw_reduce_kernel(const float4* __restrict__ part,
                                      float4* __restrict__ dwhh, int S,
                                      int n4) {
  const int d = blockIdx.y;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n4;
       e += gridDim.x * blockDim.x) {
    float4 a = part[(size_t)d * S * n4 + e];
    for (int s = 1; s < S; ++s) {
      const float4 b = part[((size_t)d * S + s) * n4 + e];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    dwhh[(size_t)d * n4 + e] = a;
  }
}

// ------------------------------------------------------------- the plans
using Kernel = void*;

template <int R>
Kernel fwd_of() { return reinterpret_cast<Kernel>(lstm_fwd_kernel<R>); }
template <int R>
Kernel bwd_of() { return reinterpret_cast<Kernel>(lstm_bwd_kernel<R>); }

Kernel kernel_of(bool bwd, int R) {
  static const Kernel f[MAX_R] = {fwd_of<1>(), fwd_of<2>(), fwd_of<3>(),
                                  fwd_of<4>(), fwd_of<5>(), fwd_of<6>(),
                                  fwd_of<7>(), fwd_of<8>()};
  static const Kernel b[MAX_R] = {bwd_of<1>(), bwd_of<2>(), bwd_of<3>(),
                                  bwd_of<4>(), bwd_of<5>(), bwd_of<6>(),
                                  bwd_of<7>(), bwd_of<8>()};
  return (bwd ? b : f)[R - 1];
}

// a launch of `blocks` blocks in clusters of C (attr: the caller's storage)
cudaLaunchConfig_t cluster_config(int C, int blocks, int threads,
                                  size_t smem, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of C blocks of `threads` threads and `smem` bytes that the card
// holds at once (0: none fits); cached per configuration
int max_clusters(Kernel k, int C, int threads, size_t smem) {
  static std::map<std::tuple<Kernel, int, int, size_t>, int> cache;
  const auto key = std::make_tuple(k, C, threads, smem);
  const auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  int n = 0;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_MAX) == cudaSuccess &&
      cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(C, C, threads, smem, attr);
    if (cudaOccupancyMaxActiveClusters(&n, k, &cfg) != cudaSuccess) n = 0;
  }
  cudaGetLastError();
  cache[key] = n;
  return n;
}

struct Plan {
  int C = 0, R = 0, W = 0, groups = 0, threads = 0, active = 0;
  size_t smem = 0;
};

// The launch configuration of the forward (bwd false) or the backward
// recurrence: cluster size C, rows per cluster R, k-warps (forward) or
// unit-warps (backward) W. Among the configurations whose shared memory
// fits, the one of least estimated time per step: waves x (the block's
// share of the step's product + one exchange), with waves the clusters
// over those the card holds at once. C = 0 when none fits.
Plan plan_of(bool bwd, int D, int B, int H) {
  Plan best;
  double best_cost = 0.0;
  for (int C : CLUSTER_SIZES) {
    if (H % C) continue;
    const int NU = H / C;
    if (!bwd && NU % 8) continue;  // a forward warp is 8 units
    for (int R = 1; R <= MAX_R; ++R) {
      Plan p;
      p.C = C;
      p.R = R;
      for (int W : {4, 3, 2, 1}) {
        const int threads =
            bwd ? 32 * ((H + 8 * KPL - 1) / (8 * KPL)) * W : 4 * NU * W;
        const size_t smem = bwd ? bwd_smem(H, C, R, W) : fwd_smem(H, C, R, W);
        if (threads > (bwd ? BWD_THREADS : FWD_THREADS) ||
            smem > (size_t)SMEM_MAX)
          continue;
        if (!bwd && 4 * W > H) continue;
        if (bwd && R * NU > threads) continue;  // one owner per (row, unit)
        p.W = W;
        p.threads = threads;
        p.smem = smem;
        break;
      }
      if (p.W == 0) continue;
      p.active = max_clusters(kernel_of(bwd, R), C, p.threads, p.smem);
      if (p.active == 0) continue;
      p.groups = (B + R - 1) / R;
      const int waves = (D * p.groups + p.active - 1) / p.active;
      // cycles per step: the product on 128 lanes at ~1.3x, and the
      // exchange, ~500 (0.27 us) and more for each block it reaches
      const double cost =
          waves * (1.3 * R * 4.0 * NU * H / 128.0 + 500.0 + 150.0 * C);
      if (best.C == 0 || cost < best_cost) {
        best = p;
        best_cost = cost;
      }
    }
  }
  return best;
}

cudaError_t launch_cluster(bool bwd, const Plan& p, int D, void** args,
                           cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config(p.C, p.C * p.groups * D, p.threads, p.smem, attr);
  cfg.stream = s;
  const cudaError_t e = cudaLaunchKernelExC(&cfg, kernel_of(bwd, p.R), args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// row splits of the dW_hh product: about one wave of two blocks an SM
// (132 SMs), at least 512 rows a split
int dw_splits(int D, int B, int T, int H) {
  const int tiles = ((H + GT - 1) / GT) * ((4 * H + GT - 1) / GT) * D;
  const int most = (B * T + 4 * GT - 1) / (4 * GT);
  return std::max(1, std::min(most, 264 / tiles));
}

}  // namespace

extern "C" {

#ifdef LSTM_PHASES
// the phase cycles of the last forward (0..7) and backward (8..15) launch
int lstm_phase_read(long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, lstm_phase_cycles, 16 * sizeof(long long));
  return (int)e;
}
#endif

// The plan a launch of D directions at (B, H) takes: out = {C, R, W,
// clusters, clusters the card holds at once, threads, shared bytes}.
// Returns 0, or cudaErrorInvalidConfiguration when no configuration fits.
int lstm_plan(int bwd, int D, int B, int H, int* out) {
  const Plan p = plan_of(bwd != 0, D, B, H);
  if (p.C == 0) return (int)cudaErrorInvalidConfiguration;
  const int v[7] = {p.C, p.R, p.W, p.groups * D, p.active, p.threads,
                    (int)p.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// xg: (D, B, T, 4H) float32; whh: (D, H, 4H) float32; lens: (B,) int32;
// h_all, c_all: (D, B, T, H) float32. H % 4 == 0.
int lstm_fwd_launch(const void* xg, const void* whh, const void* lens,
                    void* h_all, void* c_all, int D, int B, int T, int H,
                    void* stream) {
  if (D < 1 || B < 1 || T < 1 || H < 4 || H % 4)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(false, D, B, H);
  if (p.C == 0) return (int)cudaErrorInvalidConfiguration;
  const float* xg_ = static_cast<const float*>(xg);
  const float* whh_ = static_cast<const float*>(whh);
  const int* lens_ = static_cast<const int*>(lens);
  float* h_ = static_cast<float*>(h_all);
  float* c_ = static_cast<float*>(c_all);
  int KW = p.W, groups = p.groups;
  void* args[] = {&xg_, &whh_, &lens_, &h_, &c_, &B, &T, &H, &KW, &groups};
  return (int)launch_cluster(false, p, D, args,
                             static_cast<cudaStream_t>(stream));
}

// The dW_hh product's row splits S: part holds (D, S, H, 4H) float32.
int lstm_bwd_splits(int D, int B, int T, int H) {
  return dw_splits(D, B, T, H);
}

// as above, plus h_all, c_all from the forward and g (D, B, T, H) float32,
// the cotangent of h_all; dxg: (D, B, T, 4H); dwhh: (D, H, 4H); part: (D,
// S, H, 4H) float32 scratch, S = lstm_bwd_splits(D, B, T, H).
int lstm_bwd_launch(const void* xg, const void* whh, const void* lens,
                    const void* h_all, const void* c_all, const void* g,
                    void* dxg, void* dwhh, void* part, int D, int B, int T,
                    int H, void* stream) {
  if (D < 1 || B < 1 || T < 1 || H < 4 || H % 4)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(true, D, B, H);
  if (p.C == 0) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xg_ = static_cast<const float*>(xg);
  const float* whh_ = static_cast<const float*>(whh);
  const int* lens_ = static_cast<const int*>(lens);
  const float* h_ = static_cast<const float*>(h_all);
  const float* c_ = static_cast<const float*>(c_all);
  const float* g_ = static_cast<const float*>(g);
  float* dx_ = static_cast<float*>(dxg);
  float* part_ = static_cast<float*>(part);
  const int M = B * T, N = 4 * H, tn = (N + GT - 1) / GT;
  // (a) the activations of every step into dxg
  cudaError_t e = cudaFuncSetAttribute(
      lstm_gemm_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GEMM_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(lstm_gemm_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)GEMM_SMEM);
  if (e != cudaSuccess) return (int)e;
  lstm_gemm_kernel<false>
      <<<dim3(((M + GT - 1) / GT) * tn, 1, D), GTHREADS, GEMM_SMEM, s>>>(
          h_, whh_, xg_, dx_, B, T, H, 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // (b) the recurrence: dgates into dxg
  int CW = p.W, groups = p.groups;
  void* args[] = {&whh_, &lens_, &c_, &g_, &dx_, &B, &T, &H, &CW, &groups};
  e = launch_cluster(true, p, D, args, s);
  if (e != cudaSuccess) return (int)e;
  // (c) dW_hh: per-split partials, summed in order
  const int S = dw_splits(D, B, T, H);
  const int rows = (((M + S - 1) / S) + GK - 1) / GK * GK;
  lstm_gemm_kernel<true>
      <<<dim3(((H + GT - 1) / GT) * tn, S, D), GTHREADS, GEMM_SMEM, s>>>(
          h_, dx_, nullptr, part_, B, T, H, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n4 = H * N / 4;
  lstm_dw_reduce_kernel<<<dim3((n4 + 255) / 256, D), 256, 0, s>>>(
      reinterpret_cast<const float4*>(part_), static_cast<float4*>(dwhh), S,
      n4);
  return (int)cudaGetLastError();
}

}  // extern "C"
