// The CTC prefix scorer of joint CTC/attention beam search.
//
// Replaces: pytorch_end2end_speech_recognition_tpu/decode/beam.py
//   ctc_prefix_scores (:162), the lax.scan over the encoder frames at :204;
//   with r_init, decode/chunk_beam.py ctc_prefix_scores (:277), the scan at
//   :293-315.
//   It is no pl.pallas_call: on the TPU the scan compiles into the decode
//   program, where PyTorch would run a Python loop of ~12 launches a frame.
//
// For each chain (row b, hypothesis k, candidate c), over t < T:
//   phi   = same ? r_b[t-1] : log_add(r_b[t-1], r_n[t-1])
//   n'    = log_add(n', phi) + lp[b, t, c]
//   b'    = log_add(b', n') + lp[b, t, blank]      (n' of step t-1)
//   psi   = log_add(psi, phi + lp[b, t, c])
// with r[-1] = (NEG_INF, empty ? 0 : NEG_INF) and log_add(a, b) = m +
// log1pf(expf(-|a - b|)) for m = max(a, b) > NEG_INF / 2, else m: the
// reference's arithmetic, with the accurate expf/log1pf (no fast-math).
// With r_init (B, K, 2), r[-1] is the hypothesis's pre-window column
// instead: the streaming beam (decode/chunk_beam.py:277-319 of the JAX
// package) runs the same recursion over a sliding window of frames, chained
// through the column carried from before the window.
//
// Bound on the H100: latency. Each chain is T dependent steps of three
// log_adds (two expf + two log1pf on its critical path); at the widest
// beam (B 32, K 10, 40 candidates, T' 750) the bytes are lp once (~3 MB)
// and r once, ~1 us at 3.35 TB/s, and the 12,800 chains fill ~3 warps an
// SM. Design: one thread a chain, the whole recursion in registers, each
// step's three loads issued one step ahead. ctc_prefix_score_kernel stores
// only psi (B, K, C): the reference stores every candidate's (T, 2)
// columns, 77 MB a token at that width. ctc_prefix_select_kernel then
// recomputes the columns of the K kept (parent, token) pairs with the
// same code, so they carry the same bits, or copies the parent's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BLANK = 0;

__device__ __forceinline__ float log_add(float a, float b) {
  const float m = fmaxf(a, b);
  const float s = m + log1pf(expf(-fabsf(a - b)));
  return m > NEG_INF * 0.5f ? s : m;
}

// r[-1] of hypothesis bk: its pre-window column where r_init is given, else
// (NEG_INF, 0) for the empty prefix and (NEG_INF, NEG_INF) otherwise.
__device__ __forceinline__ float2 col_before(const float* __restrict__ r_init,
                                             int bk, bool empty) {
  if (r_init) return make_float2(r_init[2 * bk], r_init[2 * bk + 1]);
  return make_float2(NEG_INF, empty ? 0.f : NEG_INF);
}

// One chain: prefix columns rp (T, 2) of a hypothesis whose last token is
// `last`, with r[-1] = r0, extended by `tok`. With STORE, the extended
// prefix's columns go to out (T, 2). Returns psi.
template <bool STORE>
__device__ __forceinline__ float chain(const float* __restrict__ lpb,
                                       const float* __restrict__ rp,
                                       int tok, bool same, float2 r0, int T,
                                       int V, float2* __restrict__ out) {
  float pn = r0.x, pb = r0.y;  // r at t = -1
  float n = NEG_INF, b = NEG_INF, psi = NEG_INF;
  float lc = __ldg(lpb + tok), lbl = __ldg(lpb + BLANK);
  for (int t = 0; t < T; ++t) {
    // the next step's inputs, ahead of this step's chain
    float lc_n = 0.f, lbl_n = 0.f, pn_n = 0.f, pb_n = 0.f;
    if (t + 1 < T) {
      const float* row = lpb + (size_t)(t + 1) * V;
      lc_n = __ldg(row + tok);
      lbl_n = __ldg(row + BLANK);
      pn_n = __ldg(rp + 2 * t);
      pb_n = __ldg(rp + 2 * t + 1);
    }
    const float lse = log_add(pb, pn);
    const float phi = same ? pb : lse;
    const float n_new = log_add(n, phi) + lc;
    const float b_new = log_add(b, n) + lbl;
    psi = log_add(psi, phi + lc);
    n = n_new;
    b = b_new;
    if (STORE) out[t] = make_float2(n, b);
    lc = lc_n;
    lbl = lbl_n;
    pn = pn_n;
    pb = pb_n;
  }
  return psi;
}

// grid (B * K), block >= C threads: thread c scores candidate c of (b, k)
__global__ void ctc_prefix_score_kernel(const float* __restrict__ lp,
                                        const float* __restrict__ r_state,
                                        const int* __restrict__ last,
                                        const int* __restrict__ lengths,
                                        const int* __restrict__ cand,
                                        const float* __restrict__ r_init,
                                        float* __restrict__ psi, int K, int C,
                                        int T, int V) {
  const int bk = blockIdx.x;
  const int c = threadIdx.x;
  if (c >= C) return;
  const int b = bk / K;
  const int tok = cand[(size_t)bk * C + c];
  psi[(size_t)bk * C + c] = chain<false>(
      lp + (size_t)b * T * V, r_state + (size_t)bk * T * 2, tok,
      tok == last[bk], col_before(r_init, bk, lengths[bk] == 0), T, V,
      nullptr);
}

// one thread per kept hypothesis (b, k): the recursion for (parent, tok)
// where is_ext, else the parent's columns copied
__global__ void ctc_prefix_select_kernel(const float* __restrict__ lp,
                                         const float* __restrict__ r_state,
                                         const int* __restrict__ last,
                                         const int* __restrict__ lengths,
                                         const int* __restrict__ parent,
                                         const int* __restrict__ tok,
                                         const uint8_t* __restrict__ is_ext,
                                         const float* __restrict__ r_init,
                                         float* __restrict__ out, int B, int K,
                                         int T, int V) {
  const int bk = blockIdx.x * blockDim.x + threadIdx.x;
  if (bk >= B * K) return;
  const int b = bk / K;
  const int src = b * K + parent[bk];
  const float* rp = r_state + (size_t)src * T * 2;
  float2* dst = reinterpret_cast<float2*>(out + (size_t)bk * T * 2);
  if (is_ext[bk]) {
    const int c = tok[bk];
    chain<true>(lp + (size_t)b * T * V, rp, c, c == last[src],
                col_before(r_init, src, lengths[src] == 0), T, V, dst);
  } else {
    const float2* s = reinterpret_cast<const float2*>(rp);
    for (int t = 0; t < T; ++t) dst[t] = s[t];
  }
}

}  // namespace

extern "C" {

// lp (B, T, V) float32; r_state (B, K, T, 2) float32; last, lengths (B, K)
// int32; cand (B, K, C) int32; r_init (B, K, 2) float32 or null -> psi (B,
// K, C) float32. C <= 1024.
int ctc_prefix_score_launch(const void* lp, const void* r_state,
                            const void* last, const void* lengths,
                            const void* cand, const void* r_init, void* psi,
                            int B, int K, int C, int T, int V, void* stream) {
  if (B < 1 || K < 1 || C < 1 || C > 1024 || T < 1 || V < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = (C + 31) / 32 * 32;
  ctc_prefix_score_kernel<<<B * K, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const float*>(r_state),
      static_cast<const int*>(last), static_cast<const int*>(lengths),
      static_cast<const int*>(cand), static_cast<const float*>(r_init),
      static_cast<float*>(psi), K, C, T, V);
  return static_cast<int>(cudaGetLastError());
}

// as above; parent, tok (B, K) int32, is_ext (B, K) bytes, r_init (B, K, 2)
// float32 or null (read at the parent) -> out (B, K, T, 2) float32, the kept
// hypotheses' columns
int ctc_prefix_select_launch(const void* lp, const void* r_state,
                             const void* last, const void* lengths,
                             const void* parent, const void* tok,
                             const void* is_ext, const void* r_init,
                             void* out, int B, int K, int T, int V,
                             void* stream) {
  if (B < 1 || K < 1 || T < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const int threads = 64;
  ctc_prefix_select_kernel<<<(B * K + threads - 1) / threads, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const float*>(r_state),
      static_cast<const int*>(last), static_cast<const int*>(lengths),
      static_cast<const int*>(parent), static_cast<const int*>(tok),
      static_cast<const uint8_t*>(is_ext), static_cast<const float*>(r_init),
      static_cast<float*>(out), B, K, T, V);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
