// CTC loss: the alpha recursion (forward) and the beta recursion with the
// gradient (backward) over batched label lattices.
//
// Replaces: pytorch_end2end_speech_recognition_tpu/ops/ctc_pallas.py
//   _ctc_fwd_call (pallas_call at :170, kernel body _fwd_kernel :70) and
//   _ctc_nll_bwd (pallas_call at :222, kernel body _bwd_kernel :117).
//
// Inputs, per batch row b: lp (B, T, S) float32, the log-probabilities of
// the S = 2U+1 lattice states (NEG_INF where a state lies past the row's
// labels), skip (B, S) uint8 (the s-2 -> s transition is allowed), sok
// (B, S) uint8 (state within 2*label_len+1), tlen (B,) int32 frames, last
// (B,) int32 = 2*label_len. The log_softmax, the lattice gather and the flags
// stay in PyTorch, as they stay in XLA in the JAX package.
//
// Forward, for t = 0..T-1 (the TPU kernel's semantics, edge rules included):
//   alpha_0[s] = lp[0, s] for s < 2 (and sok), NEG_INF elsewhere
//   alpha_t[s] = lse(alpha[s], alpha[s-1], skip ? alpha[s-2]) + lp[t, s]
//   frames t >= tlen keep the carry (t == 0 is always computed)
//   ll = lse(alpha_T[last], alpha_T[last-1]); NEG_INF when impossible
// alpha (B, T, S) is written for the backward.
// Backward, t = T-1..0: beta_t[s] = lp at the final states where
// t == tlen-1, the mirrored recursion where t < tlen-1, the carry
// elsewhere; grad[t, s] = g * exp(min(alpha + beta - lp - ll, 0)), zero
// where the state is past the labels, t >= tlen or ll <= NEG_INF/2.
//
// Bound on the H100. Bytes: at the flagship train step (B=32, T=750,
// S=129) each kernel moves ~25 MB (~7.4 us at 3.35 TB/s) and does ~10
// float32 operations per lattice cell (well under a microsecond at 67
// TFLOP/s). Neither bounds it in practice: the recursion is a chain of T
// dependent steps per row, so the floor is T x (one step's latency).
//
// Design. One thread block per batch row, one thread per lattice state (S
// taken as it is: the TPU's padding of S to 128 lanes and of T to a time
// tile is a layout artefact). The carry lives in a register; the
// neighbours' values come through a double buffer in shared memory with
// two NEG_INF guard cells, so each frame costs one __syncthreads(). The
// next frame's lp (and alpha, in the backward) is loaded before the
// barrier, which hides its latency behind the step. 32 blocks leave most
// SMs idle; the chain's latency, not throughput, sets the time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, NEG_INF);
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return m > NEG_INF * 0.5f ? out : NEG_INF;
}

__global__ void ctc_alpha_kernel(const float* __restrict__ lp,
                                 const uint8_t* __restrict__ skip,
                                 const uint8_t* __restrict__ sok,
                                 const int* __restrict__ tlen,
                                 const int* __restrict__ last,
                                 float* __restrict__ alpha,
                                 float* __restrict__ ll, int T, int S) {
  // buf[x][0..1] are NEG_INF guards; buf[x][s + 2] is state s
  extern __shared__ float smem[];
  float* buf[2] = {smem, smem + S + 2};
  const int b = blockIdx.x, s = threadIdx.x;
  const bool in = s < S;
  const bool ok = in && sok[(size_t)b * S + s];
  const bool sk = in && skip[(size_t)b * S + s];
  const int tl = tlen[b];
  const float* lpb = lp + (size_t)b * T * S;
  float* ab = alpha + (size_t)b * T * S;
  if (s < 2) buf[0][s] = buf[1][s] = NEG_INF;

  float cur = NEG_INF;  // this state's alpha, the carry
  float lpt = in ? lpb[s] : NEG_INF;
  for (int t = 0; t < T; ++t) {
    const float* prev = buf[t & 1];
    float* next = buf[(t + 1) & 1];
    const float lp_next = (in && t + 1 < T) ? lpb[(size_t)(t + 1) * S + s]
                                            : NEG_INF;
    float nw;
    if (t == 0) {
      nw = (s < 2 && ok) ? lpt : NEG_INF;
    } else if (t < tl) {
      const float diag = prev[s + 1];                // state s-1
      const float skp = sk ? prev[s] : NEG_INF;      // state s-2
      nw = ok ? lse3(cur, diag, skp) + lpt : NEG_INF;
    } else {
      nw = cur;                                      // frozen past tlen
    }
    cur = nw;
    if (in) {
      next[s + 2] = cur;
      ab[(size_t)t * S + s] = cur;
    }
    __syncthreads();
    lpt = lp_next;
  }
  if (s == 0) {
    const float* fin = buf[T & 1];
    const int L = last[b];
    const float a1 = (L >= 0 && L < S) ? fin[L + 2] : NEG_INF;
    const float a2 = (L >= 1 && L <= S) ? fin[L + 1] : NEG_INF;
    const float m = fmaxf(a1, a2);
    ll[b] = m > NEG_INF * 0.5f ? m + logf(expf(a1 - m) + expf(a2 - m))
                               : NEG_INF;
  }
}

__global__ void ctc_beta_kernel(const float* __restrict__ lp,
                                const uint8_t* __restrict__ skip,
                                const uint8_t* __restrict__ sok,
                                const int* __restrict__ tlen,
                                const int* __restrict__ last,
                                const float* __restrict__ alpha,
                                const float* __restrict__ ll,
                                const float* __restrict__ g,
                                float* __restrict__ grad, int T, int S) {
  // buf[x][s] is state s; buf[x][S], buf[x][S + 1] are NEG_INF guards
  extern __shared__ float smem[];
  float* buf[2] = {smem, smem + S + 2};
  const int b = blockIdx.x, s = threadIdx.x;
  const bool in = s < S;
  const bool ok = in && sok[(size_t)b * S + s];
  const bool skip_from = s + 2 < S && skip[(size_t)b * S + s + 2];
  const int L = last[b];
  const bool is_final = s == L || s == L - 1;
  const int tl = tlen[b];
  const float llb = ll[b];
  const float gb = g[b];
  const bool live = llb > NEG_INF * 0.5f;
  const float* lpb = lp + (size_t)b * T * S;
  const float* ab = alpha + (size_t)b * T * S;
  float* gr = grad + (size_t)b * T * S;
  for (int c = s; c < 2 * (S + 2); c += blockDim.x) smem[c] = NEG_INF;
  __syncthreads();

  float cur = NEG_INF;  // this state's beta, the carry
  float lpt = in ? lpb[(size_t)(T - 1) * S + s] : NEG_INF;
  float at = in ? ab[(size_t)(T - 1) * S + s] : NEG_INF;
  for (int k = 0; k < T; ++k) {
    const int t = T - 1 - k;
    const float* prev = buf[k & 1];
    float* next = buf[(k + 1) & 1];
    float lp_next = NEG_INF, a_next = NEG_INF;
    if (in && t > 0) {
      lp_next = lpb[(size_t)(t - 1) * S + s];
      a_next = ab[(size_t)(t - 1) * S + s];
    }
    float nb;
    if (t == tl - 1) {
      nb = (is_final && ok) ? lpt : NEG_INF;
    } else if (t < tl - 1) {
      const float diag = prev[s + 1];                  // state s+1
      const float skp = skip_from ? prev[s + 2] : NEG_INF;  // state s+2
      nb = ok ? lse3(cur, diag, skp) + lpt : NEG_INF;
    } else {
      nb = cur;
    }
    cur = nb;
    if (in) {
      const float gamma = at + nb - lpt - llb;
      const float v = gb * expf(fminf(gamma, 0.f));
      gr[(size_t)t * S + s] = (ok && t < tl && live) ? v : 0.f;
      next[s] = cur;
    }
    __syncthreads();
    lpt = lp_next;
    at = a_next;
  }
}

int threads_for(int S) { return (S + 31) / 32 * 32; }

}  // namespace

extern "C" {

// lp, alpha: (B, T, S) float32; skip, sok: (B, S) uint8; tlen, last: (B,)
// int32; ll: (B,) float32. S <= 1024, T >= 1.
int ctc_alpha_launch(const void* lp, const void* skip, const void* sok,
                     const void* tlen, const void* last, void* alpha,
                     void* ll, int B, int T, int S, void* stream) {
  if (S < 1 || S > 1024 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = 2 * (S + 2) * sizeof(float);
  ctc_alpha_kernel<<<B, threads_for(S), bytes, st>>>(
      static_cast<const float*>(lp), static_cast<const uint8_t*>(skip),
      static_cast<const uint8_t*>(sok), static_cast<const int*>(tlen),
      static_cast<const int*>(last), static_cast<float*>(alpha),
      static_cast<float*>(ll), T, S);
  return (int)cudaGetLastError();
}

// as above, plus g: (B,) float32, the cotangent of ll; grad: (B, T, S).
int ctc_beta_launch(const void* lp, const void* skip, const void* sok,
                    const void* tlen, const void* last, const void* alpha,
                    const void* ll, const void* g, void* grad, int B, int T,
                    int S, void* stream) {
  if (S < 1 || S > 1024 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = 2 * (S + 2) * sizeof(float);
  ctc_beta_kernel<<<B, threads_for(S), bytes, st>>>(
      static_cast<const float*>(lp), static_cast<const uint8_t*>(skip),
      static_cast<const uint8_t*>(sok), static_cast<const int*>(tlen),
      static_cast<const int*>(last), static_cast<const float*>(alpha),
      static_cast<const float*>(ll), static_cast<const float*>(g),
      static_cast<float*>(grad), T, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
