// Toeplitz expansion of relative-position diagonals into dense bias blocks.
//
// Replaces: pytorch_end2end_speech_recognition_tpu/ops/attention_pallas.py
//   toeplitz_dense (pallas_call at :437, kernel body _toep_expand_kernel :367).
//
// Computes out[n, i, j] = diag[n, clamp((T-1) + j - i, 0, 2T-2)] for
// i, j < P (P >= T, the padded length). Inside the T x T core this is the
// Toeplitz bias; in the pad band the clamp repeats the edge diagonals, as the
// TPU kernel's edge-padded (N, 2P) diagonal vector does.
//
// Bound on the H100: bytes. It reads N(2T-1) floats and writes N*P*P
// elements (at the flagship shape 48 x 768 x 768 bf16 = 56.6 MB, ~17 us at
// 3.35 TB/s) and does no arithmetic. The design is a pure streaming write:
// one block per output row (n, i), threads along j so every warp stores
// contiguous, coalesced bytes (8 elements = 16 bytes of bf16 per thread per
// step). The reads of the diagonal row are a contiguous window that L1/L2
// serve, so device memory sees the write stream and little else.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename OutT>
__device__ __forceinline__ OutT cvt(float x);
template <>
__device__ __forceinline__ float cvt<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename OutT>
__global__ void toeplitz_kernel(const float* __restrict__ diag,
                                OutT* __restrict__ out, int T, int P) {
  const int i = blockIdx.x;            // output row
  const int n = blockIdx.y;            // (layer, head)
  const int W = 2 * T - 1;
  const float* d = diag + (size_t)n * W;
  OutT* row = out + ((size_t)n * P + i) * P;
  const int base = (T - 1) - i;        // diagonal index of column 0
  for (int j0 = threadIdx.x * 8; j0 < P; j0 += blockDim.x * 8) {
    __align__(16) OutT v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      int idx = min(max(base + j0 + u, 0), W - 1);
      v[u] = cvt<OutT>(__ldg(d + idx));
    }
    if (j0 + 8 <= P && (P % 8) == 0) {
      // 16-byte (bf16) or 2 x 16-byte (f32) aligned vector store
      if (sizeof(OutT) == 2) {
        *reinterpret_cast<uint4*>(row + j0) = *reinterpret_cast<uint4*>(v);
      } else {
        reinterpret_cast<uint4*>(row + j0)[0] = reinterpret_cast<uint4*>(v)[0];
        reinterpret_cast<uint4*>(row + j0)[1] = reinterpret_cast<uint4*>(v)[1];
      }
    } else {
      for (int u = 0; u < 8 && j0 + u < P; ++u) row[j0 + u] = v[u];
    }
  }
}

// Toeplitz reduce, the transpose of the expansion: per-diagonal sums of the
// cotangent's T x T core, out[n, (T-1) + j - i] += g[n, i, j].
//
// Replaces: pytorch_end2end_speech_recognition_tpu/ops/attention_pallas.py
//   _toeplitz_dense_bwd (pallas_call at :464, kernel body
//   _toep_reduce_kernel :380).
//
// The TPU kernel sums the whole padded block after pre-reversing the rows
// and rolling each one (a TPU layout trick); its CPU path sums only
// g[:, :T, :T]. On the training path the pad band (i or j >= T) is zero, so
// the two agree; this kernel sums the T x T core.
//
// Bound on the H100: bytes. It reads the T x T core once (48 x 750 x 750
// bf16 = 54 MB at the flagship train step, ~16 us at 3.35 TB/s) and writes
// N(2T-1) floats. Design: one thread per diagonal, so the 32 threads of a
// warp walk 32 neighbouring diagonals down the rows together and every load
// instruction reads 32 neighbouring elements of one row (coalesced). The
// rows are cut into chunks of ROWS (blockIdx.y) to put enough loads in
// flight; each thread keeps four partial sums and adds its chunk's total to
// the output with one float atomic, so the order of the T/ROWS chunk sums
// varies between runs (float32 summation order only).
constexpr int REDUCE_ROWS = 64;
constexpr int REDUCE_THREADS = 256;

template <typename InT>
__device__ __forceinline__ float to_f32(InT x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename InT>
__global__ void toeplitz_reduce_kernel(const InT* __restrict__ g,
                                       float* __restrict__ out, int T, int P) {
  const int W = 2 * T - 1;
  const int d = blockIdx.x * blockDim.x + threadIdx.x;  // output diagonal
  const int n = blockIdx.z;
  if (d >= W) return;
  const int r = d - (T - 1);                            // j - i
  const int i0 = blockIdx.y * REDUCE_ROWS;
  const int lo = max(i0, max(0, -r));
  const int hi = min(min(i0 + REDUCE_ROWS, T), T - r);
  if (lo >= hi) return;
  const InT* p = g + (size_t)n * P * P + (size_t)lo * (P + 1) + r;
  const size_t step = (size_t)P + 1;                    // one row down, one right
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int i = lo;
  for (; i + 4 <= hi; i += 4, p += 4 * step) {
    a0 += to_f32<InT>(p[0]);
    a1 += to_f32<InT>(p[step]);
    a2 += to_f32<InT>(p[2 * step]);
    a3 += to_f32<InT>(p[3 * step]);
  }
  for (; i < hi; ++i, p += step) a0 += to_f32<InT>(p[0]);
  atomicAdd(out + (size_t)n * W + d, (a0 + a1) + (a2 + a3));
}

}  // namespace

extern "C" {

// g: (N, P, P) bf16 (in_is_bf16) or float32; out: (N, 2T-1) float32, zeroed
// by the caller. Sums the T x T core of each block.
int toeplitz_reduce_launch(const void* g, void* out, int in_is_bf16, int N,
                           int T, int P, void* stream) {
  if (T < 1 || P < T) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = 2 * T - 1;
  dim3 grid((W + REDUCE_THREADS - 1) / REDUCE_THREADS,
            (T + REDUCE_ROWS - 1) / REDUCE_ROWS, N);
  if (in_is_bf16) {
    toeplitz_reduce_kernel<__nv_bfloat16><<<grid, REDUCE_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<float*>(out), T, P);
  } else {
    toeplitz_reduce_kernel<float><<<grid, REDUCE_THREADS, 0, s>>>(
        static_cast<const float*>(g), static_cast<float*>(out), T, P);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// diag: (N, 2T-1) float32; out: (N, P, P) bf16 (out_is_bf16) or float32.
int toeplitz_launch(const void* diag, void* out, int out_is_bf16, int N,
                    int T, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(P, N);
  const int want = ((P + 7) / 8 + 31) / 32 * 32;  // one 8-wide chunk each
  const int threads = want < 256 ? want : 256;
  if (out_is_bf16) {
    toeplitz_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const float*>(diag), static_cast<__nv_bfloat16*>(out), T,
        P);
  } else {
    toeplitz_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(diag), static_cast<float*>(out), T, P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
