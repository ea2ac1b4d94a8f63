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
// the DFT is ~39 GFLOP on the tensor cores with bf16 operands (~40 us), the
// filterbank's ~0.1 GFLOP of nonzeros, against ~92 MB of audio and features
// (~28 us): operations bound it, and the design keeps the (frames x bins)
// spectra out of device memory entirely.
//
// Design. The TPU kernel pre-stacks shifted hop views in XLA and adds the
// predecessor sample as a rank-1 update only because Mosaic cannot
// concatenate or roll at those offsets; neither limit exists here: frame f
// starts at sample f*hop of the row and its predecessor is the sample
// before. Two kernels:
// - bf16 basis (the main path): `hop::logmel_wgmma_kernel` below, wgmma and
//   TMA over the bin-major (2F, win) basis that `Frontend` keeps;
// - float32 basis: logmel_f32_kernel runs every product on the float32 CUDA
//   cores. A block loads one contiguous span of its frames' samples into
//   shared memory; thread k owns DFT bin k and keeps the re/im sums of TF
//   frames in registers, so each basis element it reads (coalesced, served
//   by L2) feeds 2*TF FMAs and each frame sample is a broadcast
//   shared-memory read; the power spectrum then overwrites the span, and
//   the mel product, log and frame mask run as the epilogue before one
//   coalesced store.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
// bf16 basis (the main path): `hop::logmel_wgmma_kernel`, the DFT on wgmma.
// Persistent blocks of two consumer warpgroups (64 frames each, a 128-frame
// tile of one batch row) and one producer warpgroup:
// - the consumers read their frames' float32 samples, round them to bf16 (as
//   logmel_pallas casts its frame views) and write each frame as one row of
//   a K-major operand: K = win zero-padded to KB blocks of 64, in the
//   128-byte-swizzled layout, once per tile (overlapping frames have no
//   wgmma descriptor);
// - the producer's thread streams the bin-major (2F, win) basis by TMA in
//   chunks of NB = 32 bins: per 64-sample K block a box of the chunk's 32 cos
//   rows and one of its 32 sin rows (a 3-D map (win, F, 2), so bins past F
//   and samples past win read as zeros), 8 KB, into a ring of NSTAGE stages
//   that both warpgroups read. Only the bins [k_lo, k_lo + 32 n_chunks) are
//   streamed: the filterbank's nonzero rows, from `bands` (the wrapper's);
// - per chunk, 4 KB wgmma m64n64k16 give a (64 frames, 64) float32 tile in
//   which columns j and j + 32 (the re and im of one bin) sit in the same
//   thread; it adds the predecessor term x[f hop - 1] basis_prev[k] in
//   float32 and writes the power re^2 + im^2 to shared memory;
// - the mel product: thread m of a warpgroup owns band m's float32 sums
//   over the warpgroup's 64 frames for the whole tile, and adds the band's
//   bins in ascending order over its nonzero range [lo_m, hi_m] (`bands`),
//   each weight read once (from the transposed filterbank) for 64 FMAs,
//   while the tensor cores compute the next chunk. A zero weight inside a
//   range adds an exact +0, and bins outside every range have no weight, so
//   this is the float32 function power @ mel summed in one fixed order;
// - log(mel + 1e-10), zeros at frames >= frame_lens[b], stored band-major
//   (a warp writes a contiguous run of a frame's row). Tiles with no frame
//   below frame_lens[b] only store zeros (the producer skips them too).
// Bound on the H100 at B=32 x 30 s: the DFT of the 256 bins the filterbank
// reads, 2 x 95,936 x 400 x 512 = 39 GFLOP (40 us at 989 TFLOP/s), against
// ~92 MB of audio and features (28 us): operations bound it.
namespace hop {

using namespace hopper;
constexpr int FT = 64;                           // frames per warpgroup
constexpr int KB = 7;                            // K blocks: win <= 448
constexpr int NB = 32;                           // bins per chunk (N = 64)
constexpr int NSTAGE = 11;                       // basis ring stages
constexpr int MAX_SPAN = 512;                    // bins from k_lo at most
constexpr int THREADS = 384;                     // 2 consumer + 1 producer WG
constexpr uint32_t FRAME_BYTES = KB * FT * 128;  // a warpgroup's frames: 56 KB
constexpr uint32_t STAGE_BYTES = 64 * 128;       // a K block of a chunk: 8 KB
constexpr int PW_LD = FT + 4;                    // a bin's power row, floats
constexpr uint32_t PW_BYTES = NB * PW_LD * 4;
constexpr size_t SMEM = 1024 + 2 * FRAME_BYTES + NSTAGE * STAGE_BYTES +
                        2 * PW_BYTES + 2 * MAX_SPAN * 4 + 2 * NSTAGE * 8;

// Cycles per phase of the tiles of block 0 (consumer thread 0), for
// csrc/probe/ffn_logmel_phases.py, which builds this file with
// -DLOGMEL_PHASES; the kernel library compiles the markers to nothing.
#ifdef LOGMEL_PHASES
__device__ long long logmel_phase_cycles[16];
#define PHASES_BEGIN long long ph_last_ = clock64(), ph_acc_[16] = {};
#define PHASE(i)                    \
  do {                              \
    const long long c_ = clock64(); \
    ph_acc_[i] += c_ - ph_last_;    \
    ph_last_ = c_;                  \
  } while (0)
#define PHASES_END                                 \
  if (threadIdx.x == 0 && blockIdx.x == 0)         \
    for (int i_ = 0; i_ < 16; ++i_) logmel_phase_cycles[i_] = ph_acc_[i_];
#else
#define PHASES_BEGIN
#define PHASE(i)
#define PHASES_END
#endif

__global__ void __launch_bounds__(THREADS, 1)
logmel_wgmma_kernel(const __grid_constant__ CUtensorMap tm_basis,
                    const float* __restrict__ audio,
                    const float* __restrict__ basis_prev,
                    const float* __restrict__ mel_t,
                    const int* __restrict__ bands,
                    const int* __restrict__ flens, float* __restrict__ out,
                    int Ts, int n_frames, int hop, int win, int F, int M,
                    int tiles_per_row, int n_tiles, int vec4) {
  // aligned by pointer arithmetic on smem_raw, not through an integer, so
  // that the compiler keeps every access below in the shared state space
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sF = base;                              // [2][FRAME_BYTES]
  unsigned char* ring = base + 2 * FRAME_BYTES;          // [NSTAGE][8 KB]
  float* sP = reinterpret_cast<float*>(ring + NSTAGE * STAGE_BYTES);
  float* sBP = sP + 2 * NB * PW_LD;  // basis_prev of the streamed bins
  uint64_t* full = reinterpret_cast<uint64_t*>(sBP + 2 * MAX_SPAN);
  uint64_t* empty = full + NSTAGE;

  const int k_lo = bands[0], n_ch = bands[1];
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // ------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int st = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / tiles_per_row;
        if ((tile % tiles_per_row) * 2 * FT >= flens[b]) continue;
        for (int c = 0; c < n_ch; ++c) {
          for (int kb = 0; kb < KB; ++kb) {
            mbar_wait(&empty[st], ph ^ 1);
            unsigned char* s = ring + st * STAGE_BYTES;
            mbar_arrive_expect_tx(&full[st], STAGE_BYTES);
            tma_load_3d(s, &tm_basis, &full[st], kb * 64, k_lo + c * NB, 0);
            tma_load_3d(s + STAGE_BYTES / 2, &tm_basis, &full[st], kb * 64,
                        k_lo + c * NB, 1);
            if (++st == NSTAGE) {
              st = 0;
              ph ^= 1;
            }
          }
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // basis_prev's cos and sin terms of bins k_lo + i, for the power
  for (int i = threadIdx.x; i < n_ch * NB; i += 256) {
    const int k = k_lo + i;
    sBP[i] = k < F ? basis_prev[k] : 0.f;
    sBP[MAX_SPAN + i] = k < F ? basis_prev[F + k] : 0.f;
  }
  named_sync(3, 256);
  unsigned char* myF = sF + wg * FRAME_BYTES;
  float* pw = sP + wg * NB * PW_LD;
  // the mel product: thread tid owns band tid (if tid < M) over the
  // warpgroup's 64 frames, its nonzero bins [blo, bend) in registers
  const bool has_band = tid < M;
  const int blo = has_band ? bands[2 + tid] : F;
  const int bend = has_band ? bands[2 + M + tid] + 1 : 0;
  const float* wrow = mel_t + (size_t)(has_band ? tid : 0) * F;
  int st = 0;
  uint32_t ph = 0;
  PHASES_BEGIN
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_row;
    const int t0 = (tile % tiles_per_row) * 2 * FT;  // the tile's first frame
    const int f0 = t0 + wg * FT;                     // this warpgroup's
    const int nf = min(FT, n_frames - f0);           // its frames (may be <= 0)
    const int valid = flens[b];
    float* orow = out + ((size_t)b * n_frames + f0) * M;
    if (t0 >= valid) {  // no frame of the tile is valid: zeros
      for (int i = tid; i < nf * M; i += 128) orow[i] = 0.f;
      continue;
    }
    // the frames, bf16: row r = frame f0 + r, K block kb, 8 samples c8
    // (win is a multiple of 8: a piece is all inside or all past it); zeros
    // past win and for frames past n_frames (never read past Ts). vec4: the
    // rows and frames start on 16 bytes, so a piece is two float4 loads.
    const float* xr = audio + (size_t)b * Ts;
#pragma unroll 7
    for (int p = tid; p < FT * KB * 8; p += 128) {
      const int r = p / (KB * 8), q = p - r * (KB * 8);
      const int kb = q >> 3, c8 = q & 7, k = kb * 64 + c8 * 8;
      const int fr = f0 + r;
      float a[8] = {};
      if (fr < n_frames && k < win) {
        const float* px = xr + (size_t)fr * hop + k;
        if (vec4) {
          const float4 u = __ldg(reinterpret_cast<const float4*>(px));
          const float4 w = __ldg(reinterpret_cast<const float4*>(px) + 1);
          a[0] = u.x, a[1] = u.y, a[2] = u.z, a[3] = u.w;
          a[4] = w.x, a[5] = w.y, a[6] = w.z, a[7] = w.w;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) a[j] = __ldg(px + j);
        }
      }
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(a[j]);
      *reinterpret_cast<uint4*>(myF + kb * (FT * 128) + sw128_offset(r, c8 * 8)) =
          *reinterpret_cast<uint4*>(v);
    }
    // the predecessor samples of this thread's DFT rows (frames f0 + 16 warp
    // + g and + 8), bf16 as the frames; 0 before the row's first frame
    const int fa = f0 + warp * 16 + g, fb = fa + 8;
    const float pa = fa > 0 && fa < n_frames
                         ? __bfloat162float(__float2bfloat16(xr[(size_t)fa * hop - 1]))
                         : 0.f;
    const float pb = fb < n_frames
                         ? __bfloat162float(__float2bfloat16(xr[(size_t)fb * hop - 1]))
                         : 0.f;
    // the span of this warpgroup's frames in the block's next tile, to L2
    {
      const int nt = tile + gridDim.x;
      if (nt < n_tiles) {
        const int nb = nt / tiles_per_row;
        const int nf0 = (nt % tiles_per_row) * 2 * FT + wg * FT;
        const int nlast = min(nf0 + FT, n_frames) - 1;
        if (nlast >= nf0) {
          const char* p0 = reinterpret_cast<const char*>(
              audio + (size_t)nb * Ts + (size_t)nf0 * hop);
          const int bytes = ((nlast - nf0) * hop + win) * 4;
          for (int off = tid * 128; off < bytes; off += 128 * 128)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(p0 + off));
        }
      }
    }
    fence_proxy_async();
    warpgroup_sync(1 + wg);
    PHASE(0);

    float acc[32], msum[FT];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < FT; ++i) msum[i] = 0.f;
    // the chunk in the next KB stages: awaited, then KB x 4 wgmma, issued
    auto issue_dft = [&]() {
      int sk[KB];
      uint32_t pk[KB];
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const int s = st + kb;
        sk[kb] = s < NSTAGE ? s : s - NSTAGE;
        pk[kb] = s < NSTAGE ? ph : ph ^ 1;
      }
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) mbar_wait(&full[sk[kb]], pk[kb]);
      PHASE(1);
      // descriptors from opaque bases: no loop-invariant set in registers
      const uint64_t da = opaque(desc_sw128(myF));
      const uint64_t db = opaque(desc_sw128(ring));
      fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss<0>(
              acc, desc_add(da, kb * (FT * 128) + kk * 32),
              desc_add(db, sk[kb] * STAGE_BYTES + kk * 32), (kb | kk) ? 1 : 0);
      wgmma_commit();
      PHASE(2);
    };
    // after the chunk's wait: its stages are free
    auto release = [&]() {
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const int s = st + kb;
        mbar_arrive(&empty[s < NSTAGE ? s : s - NSTAGE]);
      }
      st += KB;
      if (st >= NSTAGE) {
        st -= NSTAGE;
        ph ^= 1;
      }
    };
    // chunk c's power spectrum into pw, [bin][frame]: columns 8j + 2t + e
    // (j < 4) of the product are the re of bin 8j + 2t + e, columns + 32 its
    // im
    auto power = [&](int c) {
      // basis_prev's terms first: loads the compiler cannot move past the
      // stores to pw, which it cannot prove apart from them
      float pc[8], ps[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int bin = (i >> 1) * 8 + 2 * t + (i & 1);
        pc[i] = sBP[c * NB + bin];
        ps[i] = sBP[MAX_SPAN + c * NB + bin];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bin = j * 8 + 2 * t + e;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float p = half ? pb : pa;
            const float re = acc[4 * j + 2 * half + e] + p * pc[2 * j + e];
            const float im = acc[4 * (j + 4) + 2 * half + e] + p * ps[2 * j + e];
            pw[bin * PW_LD + warp * 16 + g + 8 * half] = re * re + im * im;
          }
        }
    };
    // chunk c's bins of this thread's band, in ascending order, into the
    // mel sums of the 64 frames: one weight (the transposed filterbank's
    // row) feeds 64 FMAs
    auto mel_add = [&](int c) {
      const int k0 = k_lo + c * NB;
      const int lo = max(blo, k0), end = min(bend, k0 + NB);
      for (int k = lo; k < end; ++k) {
        const float w = __ldg(wrow + k);
        const float4* row = reinterpret_cast<const float4*>(pw + (k - k0) * PW_LD);
#pragma unroll
        for (int q = 0; q < FT / 4; ++q) {
          const float4 p = row[q];
          msum[4 * q] = fmaf(p.x, w, msum[4 * q]);
          msum[4 * q + 1] = fmaf(p.y, w, msum[4 * q + 1]);
          msum[4 * q + 2] = fmaf(p.z, w, msum[4 * q + 2]);
          msum[4 * q + 3] = fmaf(p.w, w, msum[4 * q + 3]);
        }
      }
    };

    if (n_ch > 0) {
      issue_dft();
      wgmma_wait<0>();
      fence_operand(acc);
      release();
      PHASE(5);
      // every chunk but the last: its power, then the next chunk's DFT on
      // the tensor cores while its mel sums run
      for (int c = 0; c + 1 < n_ch; ++c) {
        power(c);
        PHASE(3);
        warpgroup_sync(1 + wg);
        PHASE(7);
        issue_dft();
        mel_add(c);
        PHASE(4);
        wgmma_wait<0>();
        fence_operand(acc);
        release();
        warpgroup_sync(1 + wg);  // pw is read before the next power
        PHASE(5);
      }
      power(n_ch - 1);
      PHASE(3);
      warpgroup_sync(1 + wg);
      PHASE(7);
      mel_add(n_ch - 1);
      PHASE(4);
    }

    // log (the fast log2 times ln 2: a few ulp, in a tolerance of 1e-3) and
    // the frame mask; band tid of each frame, so that a warp's stores are
    // one contiguous run of a frame's row
    if (has_band) {
#pragma unroll
      for (int f = 0; f < FT; ++f)
        if (f < nf)
          orow[(size_t)f * M + tid] =
              f0 + f < valid ? __logf(msum[f] + 1e-10f) : 0.f;
    }
    // every warp is past its products before the next tile's frames
    // rewrite the buffer
    warpgroup_sync(1 + wg);
    PHASE(6);
  }
  PHASES_END
  }  // consumers
}

}  // namespace hop

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

// bf16 basis TRANSPOSED, (2F, win) bin-major: rows 0..F-1 cos, F..2F-1 sin;
// mel_t the filterbank transposed, (M, F) float32; bands (int32, 2 + 2M):
// k_lo, the number of 32-bin chunks from it, then each band's first and last
// nonzero bin (`mel_plan` in ops/frontend_kernel.py). win a multiple of 8
// and at most 448, M <= 128. vec4: audio's rows and frames start on 16
// bytes (the data pointer on 16, Ts and hop multiples of 4).
int logmel_bf16_launch(const void* audio, const void* basis_t,
                       const void* basis_prev, const void* mel_t,
                       const void* bands, const void* flens, void* out, int B,
                       int Ts, int n_frames, int hop, int win, int F, int M,
                       int vec4, void* stream) {
  using namespace hop;
  if (M > 128 || F > MAX_SPAN || win % 8 || win > KB * 64 || hop < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm;
  const uint64_t dims[3] = {(uint64_t)win, (uint64_t)F, 2};
  const uint64_t strides[2] = {win * 2ull, (uint64_t)F * win * 2ull};
  const uint32_t box[3] = {64, NB, 1};
  cudaError_t e = encode_bf16_sw128(&tm, basis_t, 3, dims, strides, box);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(logmel_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tpr = (n_frames + 2 * FT - 1) / (2 * FT);
  const int n_tiles = B * tpr;
  const int grid = n_tiles < sm_count() ? n_tiles : sm_count();
  logmel_wgmma_kernel<<<grid, THREADS, SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      tm, static_cast<const float*>(audio),
      static_cast<const float*>(basis_prev), static_cast<const float*>(mel_t),
      static_cast<const int*>(bands), static_cast<const int*>(flens),
      static_cast<float*>(out), Ts, n_frames, hop, win, F, M, tpr, n_tiles,
      vec4);
  return (int)cudaGetLastError();
}

#ifdef LOGMEL_PHASES
// the phase cycles of the last bf16 launch (block 0, consumer thread 0)
int logmel_phase_read(long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, hop::logmel_phase_cycles,
                             16 * sizeof(long long));
  return (int)e;
}
#endif

// The dynamic shared memory of the bf16 kernel, for reports.
int logmel_smem_bytes() { return (int)hop::SMEM; }

}  // extern "C"
