// Fused log-mel front-end: raw audio -> masked log-mel features.
//
// Replaces: pytorch_end2end_speech_recognition_tpu/ops/frontend_pallas.py
//   logmel_pallas (pallas_call at :179, kernel body _kernel :108).
//
// Per frame f of a row: reim[k] = sum_s x[f*hop + s] * basis[s, k]
//                                 + x[f*hop - 1] * basis_prev[k],
// power = re^2 + im^2, mel = power @ mel_fb, out = log(mel + 1e-10), and
// frames at or past frame_lens[b] are written as exact zeros. Preemphasis is
// folded into `basis` (win rows, [cos | sin] columns) and `basis_prev` (the
// coefficient of the sample before each frame), so the kernel reads RAW
// audio. When the basis is bf16, the audio samples are rounded to bf16 too,
// as logmel_pallas casts its frame views to the basis dtype; products and
// sums are float32 either way.
//
// Bound on the H100 at B=32 x 30 s (2998 frames, win 400, 257 bins, 80 mels):
// ~39 GFLOP of DFT and ~4 GFLOP of mel product over ~92 MB of audio and
// features. With bf16 DFT operands on the tensor cores the floor is ~0.1 ms
// (the float32 mel product on the CUDA cores is most of it); the memory
// floor is ~28 us. So it is bound by operations, and the design keeps the
// (frames x bins) spectra out of device memory entirely.
//
// Design. The TPU kernel pre-stacks shifted hop views in XLA and adds the
// predecessor sample as a rank-1 update only because Mosaic cannot
// concatenate or roll at those offsets; neither limit exists here. A block
// loads ONE contiguous span of (frames-1)*hop + win samples into shared
// memory and indexes every frame in place (frame f starts at f*hop; its
// predecessor is the sample before). Two kernels share that plan:
// - bf16 basis (the main path): logmel_mma_kernel runs the DFT on the
//   tensor cores and streams the power spectrum chunk by chunk into the mel
//   product (see its comment below). It takes the basis transposed,
//   (2F, win) bin-major, which the wrapper makes with one 0.4 MB copy;
// - float32 basis: logmel_kernel runs every product on the float32 CUDA
//   cores. Thread k owns DFT bin k and keeps the re/im sums of TF frames in
//   registers, so each basis element it reads (coalesced, served by L2)
//   feeds 2*TF FMAs and each frame sample is a broadcast shared-memory
//   read; the power spectrum then overwrites the span, and the mel product,
//   log and frame mask run as the epilogue before one coalesced store.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// --------------------------------------------------------------------------
// float32 basis: every product on the CUDA cores.
constexpr int TF = 32;         // frames per block
constexpr int MAX_BINS = 512;  // threads per block at most (one per bin)

__global__ void __launch_bounds__(MAX_BINS)
logmel_f32_kernel(const float* __restrict__ audio,
                  const float* __restrict__ basis,
                  const float* __restrict__ basis_prev,
                  const float* __restrict__ mel, const int* __restrict__ flens,
                  float* __restrict__ out, int Ts, int n_frames, int hop,
                  int win, int F, int M) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float pred0;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * TF;
  const int nf = min(TF, n_frames - f0);
  const int span = (TF - 1) * hop + win;  // whole tile, zero past real frames
  const int have = (nf - 1) * hop + win;  // samples the real frames read
  const float* x = audio + (size_t)b * Ts + (size_t)f0 * hop;
  for (int i = threadIdx.x; i < span; i += blockDim.x)
    smem[i] = i < have ? x[i] : 0.f;
  if (threadIdx.x == 0) pred0 = f0 > 0 ? x[-1] : 0.f;
  __syncthreads();

  const int k = threadIdx.x;  // DFT bin
  float re[TF], im[TF];
#pragma unroll
  for (int f = 0; f < TF; ++f) re[f] = im[f] = 0.f;
  if (k < F) {
    const size_t ld = 2 * (size_t)F;
    const float* bc = basis + k;
    const float* bs = basis + F + k;
    for (int s = 0; s < win; s += 4) {
      float c[4], sn[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        c[u] = __ldg(bc + (s + u) * ld);
        sn[u] = __ldg(bs + (s + u) * ld);
      }
#pragma unroll
      for (int f = 0; f < TF; ++f) {
        const float4 xv = *reinterpret_cast<const float4*>(smem + f * hop + s);
        re[f] = fmaf(xv.x, c[0], re[f]);
        im[f] = fmaf(xv.x, sn[0], im[f]);
        re[f] = fmaf(xv.y, c[1], re[f]);
        im[f] = fmaf(xv.y, sn[1], im[f]);
        re[f] = fmaf(xv.z, c[2], re[f]);
        im[f] = fmaf(xv.z, sn[2], im[f]);
        re[f] = fmaf(xv.w, c[3], re[f]);
        im[f] = fmaf(xv.w, sn[3], im[f]);
      }
    }
    const float pc = basis_prev[k], ps = basis_prev[F + k];
#pragma unroll
    for (int f = 0; f < TF; ++f) {
      const float p = f == 0 ? pred0 : smem[f * hop - 1];
      re[f] = fmaf(p, pc, re[f]);
      im[f] = fmaf(p, ps, im[f]);
    }
  }
  __syncthreads();  // every thread is done with the span
  if (k < F) {
#pragma unroll
    for (int f = 0; f < TF; ++f) smem[f * F + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  const int valid = flens[b];
  for (int idx = threadIdx.x; idx < nf * M; idx += blockDim.x) {
    const int f = idx / M;
    const int m = idx - f * M;
    const float* pw = smem + f * F;
    float acc = 0.f;
    for (int kk = 0; kk < F; ++kk)
      acc = fmaf(pw[kk], __ldg(mel + (size_t)kk * M + m), acc);
    out[((size_t)b * n_frames + f0 + f) * M + m] =
        f0 + f < valid ? logf(acc + 1e-10f) : 0.f;
  }
}

// --------------------------------------------------------------------------
// bf16 basis: the DFT on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate). One block of 4 warps takes MT = 64 frames (16 per warp) and
// walks the bins in chunks of NB: it copies the chunk's cos and sin rows of
// the bin-major basis into shared memory (16-byte copies; a B fragment is
// then one 32-bit load), multiplies the frames (A fragments read in place
// from the bf16 span: frame f, sample k at span[f*hop + k]), adds the
// predecessor term and writes the chunk's power spectrum to shared memory.
// The mel product accumulates each chunk into float32 registers: thread
// (fg, mg) owns frames 4fg..4fg+3 and mels mg, mg+8, ..., so each shared
// load feeds several FMAs and the whole power spectrum is never held.
constexpr int MT = 64;                 // frames per block (4 warps x 16)
constexpr int NB = 16;                 // bins per chunk (2 cos + 2 sin tiles)
constexpr int FPT = MT / 16;           // frames per thread in the mel product
constexpr int MAX_M = 128;             // mel bands at most
constexpr int MPT = MAX_M / 8;         // mels per thread at most

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

size_t mma_smem_bytes(int hop, int win, int M) {
  return (size_t)2 * NB * (win + 8) * 2 + (size_t)MT * (NB + 1) * 4 +
         (size_t)NB * M * 4 + (size_t)((MT - 1) * hop + win) * 2;
}

__global__ void __launch_bounds__(128)
logmel_mma_kernel(const float* __restrict__ audio,
                  const __nv_bfloat16* __restrict__ basis_t,
                  const float* __restrict__ basis_prev,
                  const float* __restrict__ mel, const int* __restrict__ flens,
                  float* __restrict__ out, int Ts, int n_frames, int hop,
                  int win, int F, int M) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldb = win + 8;  // padded row of the basis chunk (bank spread)
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* pw = reinterpret_cast<float*>(sB + 2 * NB * ldb);  // [MT][NB+1]
  float* melc = pw + MT * (NB + 1);                         // [NB][M]
  __nv_bfloat16* span = reinterpret_cast<__nv_bfloat16*>(melc + NB * M);
  __shared__ float pred0;

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * MT;
  const int nf = min(MT, n_frames - f0);
  const int span_len = (MT - 1) * hop + win;
  const int have = (nf - 1) * hop + win;
  const float* x = audio + (size_t)b * Ts + (size_t)f0 * hop;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < span_len; i += blockDim.x)
    span[i] = __float2bfloat16(i < have ? x[i] : 0.f);
  if (tid == 0)
    pred0 = f0 > 0 ? __bfloat162float(__float2bfloat16(x[-1])) : 0.f;

  const int r0 = warp * 16 + g;   // this thread's DFT frames: r0 and r0 + 8
  const int fg = tid >> 3;        // mel product: frames 4fg .. 4fg+3
  const int mg = tid & 7;         //              mels mg, mg+8, ...
  float acc[FPT][MPT];
#pragma unroll
  for (int i = 0; i < FPT; ++i)
#pragma unroll
    for (int j = 0; j < MPT; ++j) acc[i][j] = 0.f;
  const int chunks16 = win / 8;  // 16-byte pieces per basis row

  for (int c0 = 0; c0 < F; c0 += NB) {
    __syncthreads();  // the span is written; the last chunk is consumed
    for (int idx = tid; idx < 2 * NB * chunks16; idx += blockDim.x) {
      const int n = idx / chunks16, piece = idx - n * chunks16;
      const int bin = c0 + (n < NB ? n : n - NB);
      const int row = (n < NB ? 0 : F) + bin;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (bin < F)
        v = __ldg(reinterpret_cast<const uint4*>(basis_t + (size_t)row * win) +
                  piece);
      *reinterpret_cast<uint4*>(sB + n * ldb + piece * 8) = v;
    }
    for (int idx = tid; idx < NB * M; idx += blockDim.x) {
      const int bb = idx / M;
      melc[idx] = c0 + bb < F ? mel[(size_t)(c0 + bb) * M + idx - bb * M] : 0.f;
    }
    __syncthreads();

    const int n_tiles = min(NB / 8, (F - c0 + 7) / 8);  // tiles with a bin < F
    float c[NB / 4][4];
#pragma unroll
    for (int j = 0; j < NB / 4; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
    for (int kk = 0; kk < win / 16; ++kk) {
      const __nv_bfloat16* ap = span + r0 * hop + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * hop), ld32(ap + 8),
                             ld32(ap + 8 * hop + 8)};
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
        if (j < n_tiles) {
          const __nv_bfloat16* bc = sB + (j * 8 + g) * ldb + kk * 16 + 2 * t;
          const __nv_bfloat16* bs = bc + NB * ldb;
          mma_bf16(c[j], a, ld32(bc), ld32(bc + 8));
          mma_bf16(c[j + NB / 8], a, ld32(bs), ld32(bs + 8));
        }
      }
    }
    const float p_lo = r0 == 0 ? pred0 : __bfloat162float(span[r0 * hop - 1]);
    const float p_hi = __bfloat162float(span[(r0 + 8) * hop - 1]);
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int bin = c0 + col;
        const float p = e < 2 ? p_lo : p_hi;
        const float re = c[j][e] + p * (bin < F ? basis_prev[bin] : 0.f);
        const float im =
            c[j + NB / 8][e] + p * (bin < F ? basis_prev[F + bin] : 0.f);
        pw[(r0 + (e >> 1) * 8) * (NB + 1) + col] = re * re + im * im;
      }
    }
    __syncthreads();
    for (int bb = 0; bb < NB; ++bb) {
      float p[FPT];
#pragma unroll
      for (int i = 0; i < FPT; ++i) p[i] = pw[(fg * FPT + i) * (NB + 1) + bb];
#pragma unroll
      for (int j = 0; j < MPT; ++j) {
        const int m = mg + 8 * j;
        if (m < M) {
          const float w = melc[bb * M + m];
#pragma unroll
          for (int i = 0; i < FPT; ++i) acc[i][j] = fmaf(p[i], w, acc[i][j]);
        }
      }
    }
  }

  const int valid = flens[b];
#pragma unroll
  for (int i = 0; i < FPT; ++i) {
    const int f = fg * FPT + i;
#pragma unroll
    for (int j = 0; j < MPT; ++j) {
      const int m = mg + 8 * j;
      if (f < nf && m < M)
        out[((size_t)b * n_frames + f0 + f) * M + m] =
            f0 + f < valid ? logf(acc[i][j] + 1e-10f) : 0.f;
    }
  }
}

}  // namespace

extern "C" {

// float32 basis (win, 2F) = [cos | sin] with preemphasis folded in.
int logmel_f32_launch(const void* audio, const void* basis,
                      const void* basis_prev, const void* mel,
                      const void* flens, void* out, int B, int Ts,
                      int n_frames, int hop, int win, int F, int M,
                      void* stream) {
  if (F > MAX_BINS || win % 4 || hop % 4) return (int)cudaErrorInvalidValue;
  const int span = (TF - 1) * hop + win;
  const int n_smem = span > TF * F ? span : TF * F;
  const size_t bytes = (size_t)n_smem * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        logmel_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n_frames + TF - 1) / TF, B);
  logmel_f32_kernel<<<grid, (F + 31) / 32 * 32, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(basis),
      static_cast<const float*>(basis_prev), static_cast<const float*>(mel),
      static_cast<const int*>(flens), static_cast<float*>(out), Ts, n_frames,
      hop, win, F, M);
  return (int)cudaGetLastError();
}

// bf16 basis TRANSPOSED, (2F, win) bin-major: rows 0..F-1 cos, F..2F-1 sin.
int logmel_bf16_launch(const void* audio, const void* basis_t,
                       const void* basis_prev, const void* mel,
                       const void* flens, void* out, int B, int Ts,
                       int n_frames, int hop, int win, int F, int M,
                       void* stream) {
  if (M > MAX_M || win % 16 || hop % 2) return (int)cudaErrorInvalidValue;
  const size_t bytes = mma_smem_bytes(hop, win, M);
  cudaError_t e = cudaFuncSetAttribute(
      logmel_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n_frames + MT - 1) / MT, B);
  logmel_mma_kernel<<<grid, 128, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio),
      static_cast<const __nv_bfloat16*>(basis_t),
      static_cast<const float*>(basis_prev), static_cast<const float*>(mel),
      static_cast<const int*>(flens), static_cast<float*>(out), Ts, n_frames,
      hop, win, F, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
