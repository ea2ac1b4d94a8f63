// CTC loss: the alpha recursion (forward) and the beta recursion with the
// gradient (backward) over batched label lattices.
//
// Replaces: pytorch_end2end_speech_recognition_tpu/ops/ctc_pallas.py
//   _ctc_fwd_call (pallas_call at :170, kernel body _fwd_kernel :70) and
//   _ctc_nll_bwd (pallas_call at :222, kernel body _bwd_kernel :117).
//
// Inputs, per batch row b: lp (B, T, S) float32, the log-probabilities of
// the lattice states (NEG_INF where a state lies past the row's labels),
// with S padded to a multiple of 64 (`lattice_inputs(..., pad_to=64)`; the
// padded states are NEG_INF with both flags 0), skip (B, S) uint8 (the s-2
// -> s transition is allowed), sok (B, S) uint8 (state within
// 2*label_len+1), tlen (B,) int32 frames, last (B,) int32 = 2*label_len.
// The log_softmax, the lattice gather and the flags stay in PyTorch, as
// they stay in XLA in the JAX package.
//
// Forward (the TPU kernel's semantics, edge rules included):
//   alpha_0[s] = lp[0, s] for s < 2 (and sok), NEG_INF elsewhere
//   alpha_t[s] = lse(alpha[s], alpha[s-1], skip ? alpha[s-2]) + lp[t, s]
//   frames t >= tlen keep the carry (t == 0 is always computed)
//   ll = lse(alpha_T[last], alpha_T[last-1]); NEG_INF when impossible
// alpha (B, T, S) is written for the backward.
// Backward: beta_t[s] = lp at the final states where t == tlen-1, the
// mirrored recursion (s+1, s+2) where t < tlen-1; grad[t, s] = g * exp(min(
// alpha + beta - lp - ll, 0)), zero where the state is past the labels, t
// >= tlen, tlen > T or ll <= NEG_INF/2 (no path explains the row).
//
// What bounds it on the H100. Bytes: at the flagship train step (B=32,
// T=750, S=129) each kernel moves ~25 MB (~7.4 us at 3.35 TB/s); the
// operations (~10 a lattice cell) take under a microsecond. Neither is the
// floor: each row is a chain of tlen dependent steps, so the floor is
// tlen x (one step's latency). The one-thread-a-state kernels these
// replace spent ~600 (alpha) and ~900 (beta) cycles a step, three quarters
// of it in expf/logf sequences (csrc/probe/ctc_phases.py).
//
// Design: one warp carries a row's whole chain, and nothing else.
// - One block per row: a chain warp and a producer warp (and, for the
//   backward, a gradient warp). Each lane of the chain warp owns K = S/32
//   consecutive states (K even: S is a multiple of 64), so a step's
//   neighbours s-1, s-2 (alpha) or s+1, s+2 (beta) are the lane's own
//   registers except at its run's edge: one shuffle (alpha: the previous
//   lane's top state) or two (beta: the next lane's bottom two). Nothing
//   crosses a warp, so a step has no barrier and no shared-memory
//   exchange. K even puts every run's first state on a blank, so state j's
//   parity is j's: the blanks (even j) never take the skip term and sum
//   two terms, not three. (Runs of 4 states over S/128 warps that handed
//   their edge states on through a shared-memory ring measured ~630 cycles
//   a step at S 160, against ~240 for one warp; PERF.md.)
// - The inputs come ahead of the chain: the producer warp streams C-frame
//   chunks of lp (and alpha, for the backward) into a ring of NST stages
//   with 1-D bulk copies completing on mbarriers; the chain reads them from
//   shared memory and waits only where the ring has fallen behind, at a
//   chunk's start, where it also frees the last chunk's stage. Within a
//   chunk the steps are unrolled, so one step's top (alpha) or bottom
//   (beta) states can start before the last step's other states finish.
// - Base 2 on the chain: lp is scaled by log2 e as it is read and the
//   carry is kept in log2 units, so lse is max + lg2(1 + ex2 + ex2) on the
//   special-function unit (ex2.approx, lg2.approx: three operations a
//   state, two for a blank). A dead state holds NEG2, which ln 2 maps to
//   NEG_INF exactly, so the natural value stored is one multiply.
// - The gradient is off the chain: the backward's chain writes each step's
//   betas into the stage beside its lp and alpha, and the gradient warp
//   turns a finished chunk into g exp(gamma) (one ex2 a state) and its
//   stores, while the chain goes on.
// - Only the row's own frames: the chain runs t < tlen (the backward from
//   tlen-1 down); frames past it get the carry (alpha) or zeros (the
//   gradient) by plain stores after the chain, and a row no path explains
//   gets zeros without a chain.
// No atomics: two launches give the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// Cycles per phase (lane 0 of each warp of block 0: the chain, then the
// producer), for csrc/probe/ctc_phases.py, which builds this file with
// -DCTC_PHASES; the kernel library compiles the markers to nothing.
#ifdef CTC_PHASES
__device__ long long ctc_phase_cycles[2 * 16 * 8];
#define PHASES_BEGIN \
  long long ph_last_ = clock64(), ph_acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define PHASE(i)                    \
  do {                              \
    const long long c_ = clock64(); \
    ph_acc_[i] += c_ - ph_last_;    \
    ph_last_ = c_;                  \
  } while (0)
#define PHASES_END(off)                                          \
  if ((threadIdx.x & 31) == 0 && blockIdx.x == 0)                \
    for (int i_ = 0; i_ < 8; ++i_)                               \
      ctc_phase_cycles[(off) + (threadIdx.x >> 5) * 8 + i_] = ph_acc_[i_];
#else
#define PHASES_BEGIN
#define PHASE(i)
#define PHASES_END(off)
#endif

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// a dead state in log2 units: fl(NEG2 * LN2) == NEG_INF exactly
constexpr float NEG2 = -1.4426950497748728e30f;
constexpr int MAX_K = 32;            // states a lane: S <= 1,024
constexpr int RING_BYTES = 160 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_C = 8;             // frames a chunk of the ring

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log2(2^a + 2^b) + lp log2 e in log2 units. No term is below NEG2, and a
// sum whose terms are all NEG2 stays NEG2 exactly (an ulp of NEG2 is 2^77,
// far above any log-probability added to it), as does one whose lp is
// NEG_INF (fl(NEG_INF log2 e) == NEG2).
__device__ __forceinline__ float lse2(float a, float b, float lp) {
  const float m = fmaxf(a, b);
  return fmaf(lp, LOG2E, m) + lg2(1.f + ex2(fminf(a, b) - m));
}

// log2(2^a + 2^b + 2^c) + lp log2 e, the same way
__device__ __forceinline__ float lse3(float a, float b, float c, float lp) {
  const float hi = fmaxf(a, b);
  const float m = fmaxf(hi, c);
  return fmaf(lp, LOG2E, m) +
         lg2(1.f + ex2(fminf(a, b) - m) + ex2(fminf(hi, c) - m));
}

// The lane's flags as bounds, so that a step applies them with a min and
// no select (the compiler branches around a select whose arm holds the
// special-function operations, state by state, and the branches serialise
// the states' chains): ub[j] is +inf where state j is within the labels
// and NEG2 past them (the state's new value is min'd with it); for odd j,
// sb[j] is +inf where the skip transition into (alpha) or out of (beta)
// the state is allowed and NEG2 where not (its term is min'd with it).
template <int K>
__device__ __forceinline__ void bounds(float (&ub)[K], float (&sb)[K],
                                       uint32_t ok, uint32_t skip_bits) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ub[j] = (ok >> j & 1) ? INFINITY : NEG2;
    sb[j] = (skip_bits >> j & 1) ? INFINITY : NEG2;
  }
}

// bit j: byte j of the K at p is nonzero
template <int K>
__device__ __forceinline__ uint32_t mask_of(const uint8_t* p) {
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) m |= (p[j] != 0 ? 1u : 0u) << j;
  return m;
}

template <int K>
__device__ __forceinline__ void load_frame(float (&l)[K], const float* p) {
#pragma unroll
  for (int j = 0; j < K; j += 2) {
    const float2 v = *reinterpret_cast<const float2*>(p + j);
    l[j] = v.x;
    l[j + 1] = v.y;
  }
}

template <int K>
__device__ __forceinline__ void store_frame(float* p, const float (&v)[K]) {
#pragma unroll
  for (int j = 0; j < K; j += 2)
    *reinterpret_cast<float2*>(p + j) = make_float2(v[j], v[j + 1]);
}

// natural units: one multiply, NEG2 -> NEG_INF
template <int K>
__device__ __forceinline__ void store_nat(float* p, const float (&a)[K]) {
#pragma unroll
  for (int j = 0; j < K; j += 2)
    *reinterpret_cast<float2*>(p + j) = make_float2(a[j] * LN2, a[j + 1] * LN2);
}

// alpha_t of the lane's states from alpha_{t-1} in a and lp in l, n1 =
// alpha_{t-1} of the state below the run
template <int K>
__device__ __forceinline__ void alpha_step(float (&a)[K], float n1,
                                           const float (&l)[K],
                                           const float (&ub)[K],
                                           const float (&sb)[K]) {
  float v[K];
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const float p1 = j > 0 ? a[j - 1] : n1;
    if (j & 1) {
      const float p2 = fminf(j > 1 ? a[j - 2] : n1, sb[j]);
      v[j] = fminf(lse3(a[j], p1, p2, l[j]), ub[j]);
    } else {
      v[j] = fminf(lse2(a[j], p1, l[j]), ub[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) a[j] = v[j];
}

// beta_t of the lane's states from beta_{t+1} in b and lp in l, n1, n2 =
// beta_{t+1} of the two states above the run
template <int K>
__device__ __forceinline__ void beta_step(float (&b)[K], float n1, float n2,
                                          const float (&l)[K],
                                          const float (&ub)[K],
                                          const float (&sb)[K]) {
  float v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float p1 = j < K - 1 ? b[j + 1] : n1;
    if (j & 1) {
      const float p2 = fminf(j < K - 1 ? b[j + 2] : n2, sb[j]);
      v[j] = fminf(lse3(b[j], p1, p2, l[j]), ub[j]);
    } else {
      v[j] = fminf(lse2(b[j], p1, l[j]), ub[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) b[j] = v[j];
}

// g * exp(min(alpha + beta - lp - ll, 0)) with beta in log2 units, +0
// where keep is 0 (keep: all ones or 0)
__device__ __forceinline__ float occupancy(float a, float b2, float lp,
                                           float llb, float gb,
                                           uint32_t keep) {
  const float v =
      gb * ex2(fminf(fmaf(a - llb, LOG2E, fmaf(-lp, LOG2E, b2)), 0.f));
  return __uint_as_float(__float_as_uint(v) & keep);
}

// Shared memory of a launch, in bytes from a 128-byte-aligned base: the
// ring (NST stages of `slabs` slabs of C frames: lp, and for the backward
// alpha and beta), the final states (S floats), then the mbarriers (full,
// empty, and for the backward bfull: a stage's betas are in).
struct Layout {
  int C, NST, slabs, fin, bars, total;
};

inline Layout layout_of(int S, int slabs) {
  Layout L;
  L.slabs = slabs;
  L.C = MAX_C;
  while (L.C > 1 && RING_BYTES / (L.C * S * 4 * slabs) < 4) L.C /= 2;
  const int n = RING_BYTES / (L.C * S * 4 * slabs);
  L.NST = n < 8 ? n : 8;
  L.fin = L.NST * L.C * S * 4 * slabs;
  L.bars = L.fin + S * 4;
  L.total = L.bars + 3 * L.NST * 8;
  return L;
}

struct Smem {
  float* ring;
  float* fin;
  uint64_t *full, *empty, *bfull;
};

// the layout's pointers, aligned by pointer arithmetic on smem_raw (not
// through an integer, so every access stays in the shared state space);
// thread 0 initialises the mbarriers: `freers` lanes free a stage, `bfill`
// lanes fill a stage's betas
__device__ __forceinline__ Smem carve(unsigned char* smem_raw,
                                      const Layout& L, int freers,
                                      int bfill) {
  unsigned char* base =
      smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  Smem m;
  m.ring = reinterpret_cast<float*>(base);
  m.fin = reinterpret_cast<float*>(base + L.fin);
  m.full = reinterpret_cast<uint64_t*>(base + L.bars);
  m.empty = m.full + L.NST;
  m.bfull = m.empty + L.NST;
  if (threadIdx.x == 0) {
    for (int i = 0; i < L.NST; ++i) {
      mbar_init(m.full + i, 1);
      mbar_init(m.empty + i, freers);
      if (bfill) mbar_init(m.bfull + i, bfill);
    }
    fence_barrier_init();
  }
  __syncthreads();
  return m;
}

// the producer (lane 0 of warp 1): chunk c of the ring holds frames
// [j C, j C + nf) of each of the nsrc sources, j = first + dir c, in stage
// c % NST (whose first nsrc slabs of C S floats it fills)
__device__ __forceinline__ void produce(const Smem& m, const Layout& L,
                                        const float* const* src, int nsrc,
                                        int S, int nch, int first, int dir,
                                        int tl) {
  PHASES_BEGIN
  for (int c = 0; c < nch; ++c) {
    const int st = c % L.NST, j = first + dir * c;
    if (c >= L.NST) mbar_wait(m.empty + st, (c / L.NST - 1) & 1);
    PHASE(0);
    const uint32_t bytes = (uint32_t)(min(L.C, tl - j * L.C) * S * 4);
    float* dst = m.ring + (size_t)st * L.slabs * L.C * S;
    mbar_arrive_expect_tx(m.full + st, nsrc * bytes);
    for (int i = 0; i < nsrc; ++i)
      bulk_load(dst + (size_t)i * L.C * S, src[i] + (size_t)j * L.C * S,
                bytes, m.full + st);
    PHASE(1);
  }
  PHASES_END(dir > 0 ? 0 : 128)
}

template <int K>
__global__ void __launch_bounds__(64, 1)
    ctc_alpha_kernel(const float* __restrict__ lp,
                     const uint8_t* __restrict__ skip,
                     const uint8_t* __restrict__ sok,
                     const int* __restrict__ tlen,
                     const int* __restrict__ last, float* __restrict__ alpha,
                     float* __restrict__ ll, int T, Layout L) {
  constexpr int S = 32 * K;
  extern __shared__ unsigned char smem_raw[];
  const Smem m = carve(smem_raw, L, 32, 0);
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  const int C = L.C, NST = L.NST;
  const int tl = max(min(tlen[b], T), 1);  // the chain's frames
  const int nch = (tl + C - 1) / C;
  if (threadIdx.x >= 32) {  // the producer: lp's frames [0, tl)
    const float* src[1] = {lp + (size_t)b * T * S};
    if (lane == 0) produce(m, L, src, 1, S, nch, 0, 1, tl);
    return;
  }
  const int s0 = lane * K;
  const uint32_t ok = mask_of<K>(sok + (size_t)b * S + s0);
  float ub[K], sb[K];
  bounds(ub, sb, ok, mask_of<K>(skip + (size_t)b * S + s0));
  float* out = alpha + (size_t)b * T * S + s0;

  PHASES_BEGIN
  float a[K], l[K];
  mbar_wait(m.full, 0);
  load_frame(l, m.ring + s0);  // t = 0
#pragma unroll
  for (int j = 0; j < K; ++j)
    a[j] = (lane == 0 && j < 2 && (ok >> j & 1)) ? l[j] * LOG2E : NEG2;
  store_nat(out, a);
  int st = 0;
  uint32_t ph = 0;
  for (int c = 0; c < nch; ++c) {  // one chunk of the ring
    if (c > 0) {                   // free the last chunk's stage
      mbar_arrive(m.empty + st);
      if (++st == NST) st = 0, ph ^= 1;
      mbar_wait(m.full + st, ph);
    }
    PHASE(0);
    const float* lpf = m.ring + (size_t)st * C * S + s0;
    float* o = out + (size_t)c * C * S;
    const int nf = min(C, tl - c * C);
#pragma unroll 4
    for (int f = c == 0 ? 1 : 0; f < nf; ++f) {
      load_frame(l, lpf + f * S);
      float n1 = __shfl_up_sync(FULL, a[K - 1], 1);
      n1 = lane == 0 ? NEG2 : n1;
      alpha_step(a, n1, l, ub, sb);
      store_nat(o + (size_t)f * S, a);
    }
    PHASE(1);
  }

  // frames past tlen keep the carry; ll from the final states
  for (int t = tl; t < T; ++t) store_nat(out + (size_t)t * S, a);
  PHASE(2);
  PHASES_END(0)
  store_nat(m.fin + s0, a);
  __syncwarp();
  if (lane == 0) {
    const int Lb = last[b];
    const float a1 = (Lb >= 0 && Lb < S) ? m.fin[Lb] : NEG_INF;
    const float a2 = (Lb >= 1 && Lb <= S) ? m.fin[Lb - 1] : NEG_INF;
    const float mx = fmaxf(a1, a2);
    ll[b] = mx > NEG_INF * 0.5f ? mx + logf(expf(a1 - mx) + expf(a2 - mx))
                                : NEG_INF;
  }
}

// The backward's block: warp 0 the chain (beta into the stage's third slab),
// warp 1 the producer (lp and alpha into the first two), warp 2 the
// gradient (each chunk once its betas are in: lp, alpha, beta -> grad). A
// stage is freed by both the chain's and the gradient warp's 32 lanes.
template <int K>
__global__ void __launch_bounds__(96, 1)
    ctc_beta_kernel(const float* __restrict__ lp,
                    const uint8_t* __restrict__ skip,
                    const uint8_t* __restrict__ sok,
                    const int* __restrict__ tlen,
                    const int* __restrict__ last,
                    const float* __restrict__ alpha,
                    const float* __restrict__ ll, const float* __restrict__ g,
                    float* __restrict__ grad, int T, Layout L) {
  constexpr int S = 32 * K;
  extern __shared__ unsigned char smem_raw[];
  const Smem m = carve(smem_raw, L, 64, 32);
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = L.C, NST = L.NST;
  const int tl = tlen[b];
  const float llb = ll[b];
  const bool live = llb > NEG_INF * 0.5f && tl >= 1 && tl <= T;
  // chunk c holds frame block nch - 1 - c: the last frames first
  const int nch = live ? (tl - 1) / C + 1 : 0;
  const int s0 = lane * K;
  const uint32_t ok = mask_of<K>(sok + (size_t)b * S + s0);
  if (warp == 1) {  // the producer
    const float* src[2] = {lp + (size_t)b * T * S, alpha + (size_t)b * T * S};
    if (lane == 0) produce(m, L, src, 2, S, nch, nch - 1, -1, tl);
    return;
  }
  if (warp == 2) {  // the gradient
    const float gb = g[b];
    uint32_t keep[K];
#pragma unroll
    for (int j = 0; j < K; ++j) keep[j] = (ok >> j & 1) ? ~0u : 0u;
    float* out = grad + (size_t)b * T * S + s0;
    float l[K], a[K], v[K], o[K];
    PHASES_BEGIN
    int st = 0;
    uint32_t ph = 0;
    for (int c = 0; c < nch; ++c) {
      mbar_wait(m.bfull + st, ph);
      PHASE(0);
      const int j = nch - 1 - c, nf = min(C, tl - j * C);
      const float* base = m.ring + (size_t)st * 3 * C * S + s0;
      float* dst = out + (size_t)j * C * S;
      for (int f = 0; f < nf; ++f) {
        load_frame(l, base + f * S);
        load_frame(a, base + (C + f) * S);
        load_frame(v, base + (2 * C + f) * S);
#pragma unroll
        for (int i = 0; i < K; ++i)
          o[i] = occupancy(a[i], v[i], l[i], llb, gb, keep[i]);
        store_frame(dst + (size_t)f * S, o);
      }
      mbar_arrive(m.empty + st);
      if (++st == NST) st = 0, ph ^= 1;
      PHASE(1);
    }
    // frames past tlen, and every frame of a row no path explains: zeros
#pragma unroll
    for (int i = 0; i < K; ++i) o[i] = 0.f;
    for (int t = live ? tl : 0; t < T; ++t)
      store_frame(out + (size_t)t * S, o);
    PHASE(2);
    PHASES_END(128)
    return;
  }
  uint32_t sf = 0, fin = 0;
  const int Lb = last[b];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = s0 + j;
    if (s + 2 < S && skip[(size_t)b * S + s + 2]) sf |= 1u << j;
    if (s == Lb || s == Lb - 1) fin |= 1u << j;
  }
  float ub[K], sb[K], v[K], l[K];
  bounds(ub, sb, ok, sf);
  PHASES_BEGIN
  int st = 0;
  uint32_t ph = 0;
  for (int c = 0; c < nch; ++c) {  // frames [j C, j C + nf), last first
    if (c > 0) {                   // free the last chunk's stage
      mbar_arrive(m.empty + st);
      if (++st == NST) st = 0, ph ^= 1;
    }
    mbar_wait(m.full + st, ph);
    PHASE(0);
    const int j = nch - 1 - c, nf = min(C, tl - j * C);
    const float* lpf = m.ring + (size_t)st * 3 * C * S + s0;
    float* bf = const_cast<float*>(lpf) + 2 * C * S;
    int f = nf - 1;
    if (c == 0) {  // t = tlen - 1: the final states
      load_frame(l, lpf + f * S);
#pragma unroll
      for (int i = 0; i < K; ++i)
        v[i] = ((ok & fin) >> i & 1) ? l[i] * LOG2E : NEG2;
      store_frame(bf + f * S, v);
      --f;
    }
#pragma unroll 4
    for (; f >= 0; --f) {
      load_frame(l, lpf + f * S);
      float n1 = __shfl_down_sync(FULL, v[0], 1);
      float n2 = __shfl_down_sync(FULL, v[1], 1);
      n1 = lane == 31 ? NEG2 : n1;
      n2 = lane == 31 ? NEG2 : n2;
      beta_step(v, n1, n2, l, ub, sb);
      store_frame(bf + f * S, v);
    }
    mbar_arrive(m.bfull + st);  // this chunk's betas, to the gradient warp
    PHASE(1);
  }
  PHASES_END(128)
}

template <int K>
cudaError_t launch_alpha(const void* lp, const void* skip, const void* sok,
                         const void* tlen, const void* last, void* alpha,
                         void* ll, int B, int T, cudaStream_t st) {
  const Layout L = layout_of(32 * K, 1);
  const int bytes = L.total + 128;
  cudaError_t e = cudaFuncSetAttribute(
      ctc_alpha_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  ctc_alpha_kernel<K><<<B, 64, bytes, st>>>(
      static_cast<const float*>(lp), static_cast<const uint8_t*>(skip),
      static_cast<const uint8_t*>(sok), static_cast<const int*>(tlen),
      static_cast<const int*>(last), static_cast<float*>(alpha),
      static_cast<float*>(ll), T, L);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_beta(const void* lp, const void* skip, const void* sok,
                        const void* tlen, const void* last, const void* alpha,
                        const void* ll, const void* g, void* grad, int B,
                        int T, cudaStream_t st) {
  const Layout L = layout_of(32 * K, 3);
  const int bytes = L.total + 128;
  cudaError_t e = cudaFuncSetAttribute(
      ctc_beta_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  ctc_beta_kernel<K><<<B, 96, bytes, st>>>(
      static_cast<const float*>(lp), static_cast<const uint8_t*>(skip),
      static_cast<const uint8_t*>(sok), static_cast<const int*>(tlen),
      static_cast<const int*>(last), static_cast<const float*>(alpha),
      static_cast<const float*>(ll), static_cast<const float*>(g),
      static_cast<float*>(grad), T, L);
  return cudaGetLastError();
}

bool bad_shape(int S, int T) {
  return S < 64 || S > 32 * MAX_K || S % 64 != 0 || T < 1;
}

}  // namespace

// one case a K (states a lane): 2..32, even
#define CTC_EACH_K(X)                                                    \
  X(2) X(4) X(6) X(8) X(10) X(12) X(14) X(16) X(18) X(20) X(22) X(24) \
      X(26) X(28) X(30) X(32)

extern "C" {

#ifdef CTC_PHASES
// the phase cycles of the last alpha ([0, 128): 8 a warp) and beta ([128,
// 256)) launch
int ctc_phase_read(long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, ctc_phase_cycles, 256 * sizeof(long long));
  return (int)e;
}
#endif

// lp, alpha: (B, T, S) float32, 16-byte aligned; skip, sok: (B, S) uint8;
// tlen, last: (B,) int32; ll: (B,) float32. S a multiple of 64 in [64,
// 1024], T >= 1.
int ctc_alpha_launch(const void* lp, const void* skip, const void* sok,
                     const void* tlen, const void* last, void* alpha,
                     void* ll, int B, int T, int S, void* stream) {
  if (bad_shape(S, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S / 32) {
#define CTC_ALPHA(K) \
  case K:            \
    return (int)launch_alpha<K>(lp, skip, sok, tlen, last, alpha, ll, B, T, st);
    CTC_EACH_K(CTC_ALPHA)
#undef CTC_ALPHA
  }
  return (int)cudaErrorInvalidValue;
}

// as above, plus g: (B,) float32, the cotangent of ll; grad: (B, T, S),
// 16-byte aligned.
int ctc_beta_launch(const void* lp, const void* skip, const void* sok,
                    const void* tlen, const void* last, const void* alpha,
                    const void* ll, const void* g, void* grad, int B, int T,
                    int S, void* stream) {
  if (bad_shape(S, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S / 32) {
#define CTC_BETA(K)                                                    \
  case K:                                                              \
    return (int)launch_beta<K>(lp, skip, sok, tlen, last, alpha, ll, g, \
                               grad, B, T, st);
    CTC_EACH_K(CTC_BETA)
#undef CTC_BETA
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
