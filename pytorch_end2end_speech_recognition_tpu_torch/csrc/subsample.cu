// The x4 convolution subsampling's two convolutions in one kernel, forward:
// masked log-mel -> conv1 (1 -> C, 3 x 3, stride 2) -> ReLU -> mask ->
// conv2 (C -> C, 3 x 3, stride 2) -> ReLU -> mask, written in the (B, T2,
// F2 * C) layout the projection reads.
//
// Replaces no TPU kernel: the JAX package's `ConvSubsample` is two
// `nnx.Conv`s that XLA compiles. Added because the port's plain sequence
// (`ops/subsample_kernel.py:subsample_plain`, cuDNN convolutions, pads,
// casts, masks and a layout copy) wrote and reread the conv1 activation,
// (B, C, T/2, F/2) bf16 (7.9 GB a request at B 256 x 30 s, C 256), in ~60
// launches, and ran conv1's single input channel off the tensor cores.
//
// Arithmetic, as the plain version's: x is float32 (B, T, F); frames at or
// past lens are zeros, the rest rounded to bf16; Flax SAME padding at
// stride 2 ((0, 1) for an even extent, (1, 1) for an odd one) on both axes
// of both convolutions;
//   h1 = bf16(relu(sum_9 x w1 + b1)),   zero at t1 >= (lens + 1) // 2
//   h2 = bf16(relu(sum_9C h1 w2 + b2)), zero at t2 >= (lens1 + 1) // 2
// bf16 operands, float32 sums (w1, b1, w2 bf16; b2 enters as float32).
//
// Bound on the H100, at the serving cells' shapes (30 s: T 2,998, F 80, so
// T2 750, F2 20): conv2 is the work, 2 x 9C x C x B T2 F2 = 4.53 TFLOP at
// B 256, C 256 (4.6 ms at 989 TFLOP/s bf16) and 9.06 TFLOP at B 128, C 512;
// conv1 is 71 GFLOP, the bytes ~0.12 GB in and ~2 GB out (0.6 ms at 3.35
// TB/s). The conv2 GEMM on the tensor cores bounds the kernel.
//
// Design: one implicit GEMM per 128-row tile of one utterance's (T2 F2)
// output positions (M 128, N = C in pieces of NW <= 256, K = 9 taps x C).
// - conv1 never reaches device memory. The producer warpgroup's three
//   builder warps compute it for the tile's receptive field, 64 channels
//   at a time, as mma.sync m16n8k16 products (9 taps + the bias as a tenth
//   tap of constant 1, padded to K 16; masked and padding positions get an
//   all-zero A row, so they come out exactly 0), ReLU and bf16 rounding in
//   one cvt, into shared memory, 128 bytes a position, channels innermost,
//   the 16-byte chunks swizzled by the position. Two buffers: the builders
//   fill the next one while the consumers multiply out of the other.
// - conv2's stride-2 gather costs nothing: a buffer holds one set of conv1
//   rows (even t1 + pad for taps kt 0 and 2, odd for kt 1), each row split
//   by f1's parity and laid out as a window over the tile's positions, so
//   that tap (kt, kf) of output position j is entry j + row(j) + a per-tap
//   constant. The consumers load their A fragments with ldmatrix at those
//   per-lane row addresses and run wgmma with A in registers (RS form).
// - the (9, N, C) bf16 weights, rearranged by the wrapper, stream tap by
//   tap (64 input channels x NW output channels a stage) through a
//   two-stage TMA ring, fed by one thread of the producer warpgroup. Every
//   128-row tile reads all 9 C x C weights from L2 again (1.2 MB at C 256):
//   alone, that stream takes ~60% of the kernel's time at 6 TB/s, so the
//   ring is kept short (3 stages measured 3-15% slower in turns).
// - two consumer warpgroups of 64 rows each keep the (64, NW) float32 sums
//   in registers across the 9 C / 16 k-steps; the epilogue adds b2, applies
//   ReLU, the length mask and bf16 rounding, and stores straight into (B,
//   T2, F2 * C). Blocks are persistent over the tiles.
// Per tile the builders redo ~25% of conv1 (the window's halo; each N piece
// of a C > 256 layer builds it again): a few percent of the tensor work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 128;      // output positions a tile (2 warpgroups x 64)
constexpr int THREADS = 384;   // 2 consumer warpgroups + 1 producer
constexpr int KC = 64;         // input channels a stage (one 128-byte row)
constexpr int BUILDERS = 96;   // producer warps 1-3 build conv1
constexpr int STAGES = 2;      // the weights' TMA ring
constexpr int SMEM_LIMIT = 232448;
// the taps in the order the ring carries them: the even conv1 rows' taps
// (kt 0 and 2) share one buffer, the odd rows' (kt 1) the next
__device__ __forceinline__ int ring_tap(int i) {
  return i < 3 ? i : i < 6 ? i + 3 : i - 3;
}

struct Geo {
  int B, T, F, C;          // x (B, T, F); C channels
  int T1, F1, T2, F2;      // conv1's and conv2's output extents
  int pt1, pf1, pt2, pf2;  // SAME padding before each axis of conv1, conv2
  int S16;                 // conv1 window entries a parity (multiple of 16)
  int tpu;                 // tiles an utterance
  int pieces;              // N pieces of NW channels
  int n_tiles;             // B * tpu * pieces
  int chunks;              // 64-channel chunks of conv2's input
};

struct Plan {
  int nw, pieces, smem, s16, chunks;
};

int nw_of(int C) {
  return C <= 32 ? 32 : C <= 64 ? 64 : C <= 128 ? 128 : 256;
}

// the window of conv1 entries a tile reads, per parity: positions j + r(j)
// plus the taps' offsets (1, F2 + 1, F2 + 2), r(j) < the rows a tile spans
int s16_of(int F2) {
  const int rows = (ROWS + F2 - 2) / F2 + 1;
  return (ROWS + 1 + rows + F2 + 15) / 16 * 16;
}

Plan plan_of(int F, int C) {
  Plan p;
  const int F2 = ((F + 1) / 2 + 1) / 2;
  p.nw = nw_of(C);
  p.pieces = (C + p.nw - 1) / p.nw;
  p.s16 = s16_of(F2);
  p.chunks = (C + KC - 1) / KC;
  p.smem = 1024 + STAGES * p.nw * 128 + 2 * 2 * p.s16 * 128 +
           4 * p.s16 * 32 + 128;
  return p;
}

bool shape_ok(int F, int C) {
  return F >= 1 && C >= 16 && C <= 1024 && C % 16 == 0 &&
         plan_of(F, C).smem <= SMEM_LIMIT;
}

__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p))
      : "memory");
}

// byte offset of the 16-byte chunk q (channels 8q..8q+7) of conv1 entry e
__device__ __forceinline__ uint32_t entry_chunk(int e, int q) {
  return (uint32_t)e * 128u + ((uint32_t)(q ^ (e & 7)) << 4);
}

}  // namespace

namespace hop {

using namespace hopper;

// D += A B^T: conv2's product for one k-step, NW output channels
template <int NW>
__device__ __forceinline__ void conv2_mma(float (&d)[NW / 2],
                                          const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NW == 256) wgmma_m64n256k16_rs<0>(d, a, db);
  else if constexpr (NW == 128) wgmma_m64n128k16_rs<0>(d, a, db);
  else if constexpr (NW == 64) wgmma_m64n64k16_rs<0>(d, a, db);
  else wgmma_m64n32k16_rs<0>(d, a, db);
}

// the A fragments of one tap: 4 k-steps of 16 channels from conv1 entry e
// (this lane's ldmatrix row), kc the lane's 8-channel half of a k-step
__device__ __forceinline__ void load_tap(uint32_t (&a)[4][4],
                                         const unsigned char* buf, int e,
                                         int kc) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk], buf + entry_chunk(e, 2 * kk + kc));
}

// the taps of one conv1 buffer: tap i reads entry e0 + off[i]; each tap's
// 4 wgmma are issued and awaited in one unrolled step, and the next tap's
// A fragments load while they run
template <int NW, int NT>
__device__ __forceinline__ void run_taps(float (&acc)[NW / 2],
                                         const unsigned char* buf,
                                         const int (&off)[NT], int e0, int kc,
                                         const unsigned char* sB,
                                         uint64_t* full, uint64_t* empty,
                                         int& slot, uint32_t& ph) {
  uint32_t a[2][4][4];
  load_tap(a[0], buf, e0 + off[0], kc);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    mbar_wait(&full[slot], ph);
    const uint64_t db = opaque(desc_sw128(sB + slot * (NW * 128)));
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      conv2_mma<NW>(acc, a[i & 1][kk], desc_add(db, kk * 32));
    wgmma_commit();
    if (i + 1 < NT) load_tap(a[(i + 1) & 1], buf, e0 + off[i + 1], kc);
    wgmma_wait<0>();
    fence_operand(acc);
    fence_operand(a[i & 1]);
    mbar_arrive(&empty[slot]);
    if (++slot == STAGES) {
      slot = 0;
      ph ^= 1;
    }
  }
}

// byte offset of 16-byte chunk q (taps 8q..8q+7) of im2col row r: 32-byte
// rows, the chunk swapped in every other group of 4 rows, so that the 8
// rows of an ldmatrix read hit 8 distinct bank groups
__device__ __forceinline__ uint32_t im2col_chunk(int r, int q) {
  return (uint32_t)r * 32u + ((uint32_t)(q ^ ((r >> 2) & 1)) << 4);
}

template <int NW>
__global__ void __launch_bounds__(THREADS, 1)
subsample_conv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_w2,
                            const float* __restrict__ x,
                            const int* __restrict__ lens,
                            const bf16* __restrict__ w1p,
                            const float* __restrict__ b2p,
                            bf16* __restrict__ out, const Geo G) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stage_bytes = NW * 128;
  const int cbuf_bytes = 2 * G.S16 * 128;
  unsigned char* sB = base;                                 // [STAGES][NW][128]
  unsigned char* sC = base + STAGES * stage_bytes;          // [2][2 S16][128]
  unsigned char* sI = sC + 2 * cbuf_bytes;                  // [4 S16][32]
  uint64_t* full = reinterpret_cast<uint64_t*>(sI + 4 * G.S16 * 32);
  uint64_t* empty = full + STAGES;
  uint64_t* cfull = empty + STAGES;
  uint64_t* cempty = cfull + 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&cfull[s], BUILDERS);
      mbar_init(&cempty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int per_piece = G.B * G.tpu;
  if (wg == 2) {  // --------------------------------------------- producer
    setmaxnreg_dec<88>();
    if (threadIdx.x == 256) {  // the weights' TMA ring
      int slot = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < G.n_tiles; tile += gridDim.x) {
        const int piece = tile / per_piece;
        for (int ch = 0; ch < G.chunks; ++ch) {
          for (int i = 0; i < 9; ++i) {
            mbar_wait(&empty[slot], ph ^ 1);
            mbar_arrive_expect_tx(&full[slot], stage_bytes);
            tma_load_3d(sB + slot * stage_bytes, &tm_w2, &full[slot], ch * KC,
                        piece * NW, ring_tap(i));
            if (++slot == STAGES) {
              slot = 0;
              ph ^= 1;
            }
          }
        }
      }
    } else if (threadIdx.x >= 288) {  // conv1 builders
      const int bt = threadIdx.x - 288, bw = bt >> 5, lane = bt & 31;
      const int g = lane >> 2, t = lane & 3;
      const int n_mt = G.S16 / 8;  // 16-entry m-tiles a buffer
      int cb = 0;
      uint32_t cph = 0;
      for (int tile = blockIdx.x; tile < G.n_tiles; tile += gridDim.x) {
        const int rem = tile % per_piece, b = rem / G.tpu;
        const int m0 = (rem - b * G.tpu) * ROWS;
        const int t2a = m0 / G.F2, f2a = m0 - t2a * G.F2;
        const int L = lens[b];
        const int len0 = min(L, G.T), len1 = min((L + 1) >> 1, G.T1);
        const int t1_base = 2 * t2a - G.pt2;
        const float* xb = x + (size_t)b * G.T * G.F;
        // im2col of the tile's conv1 entries, once for every chunk: row r =
        // (set, parity, s) holds the 9 taps' bf16 x, the bias's 1 and 6
        // zeros; an entry outside conv1's valid positions is all zeros
        named_sync(1, BUILDERS);  // the last tile's reads are done
        for (int r = bt; r < 4 * G.S16; r += BUILDERS) {
          const int set = r >= 2 * G.S16 ? 1 : 0, e = r - set * 2 * G.S16;
          const int par = e >= G.S16 ? 1 : 0;
          const int q = e - par * G.S16 + f2a;
          const int er = q / (G.F2 + 1), c = q - er * (G.F2 + 1);
          const int t1 = t1_base + 2 * er + set, f1 = 2 * c + par - G.pf2;
          const bool valid = t1 >= 0 && t1 < len1 && f1 >= 0 && f1 < G.F1;
          const int t0 = 2 * t1 - G.pt1, f0 = 2 * f1 - G.pf1;
          float v[16];
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            const int tt = t0 + k / 3, ff = f0 + k % 3;
            v[k] = valid && tt >= 0 && tt < len0 && ff >= 0 && ff < G.F
                       ? __ldg(xb + (size_t)tt * G.F + ff)
                       : 0.f;
          }
          v[9] = valid ? 1.f : 0.f;
#pragma unroll
          for (int k = 10; k < 16; ++k) v[k] = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint4 u;
            u.x = pack_bf16(v[8 * h + 0], v[8 * h + 1]);
            u.y = pack_bf16(v[8 * h + 2], v[8 * h + 3]);
            u.z = pack_bf16(v[8 * h + 4], v[8 * h + 5]);
            u.w = pack_bf16(v[8 * h + 6], v[8 * h + 7]);
            *reinterpret_cast<uint4*>(sI + im2col_chunk(r, h)) = u;
          }
        }
        named_sync(1, BUILDERS);
        for (int ch = 0; ch < G.chunks; ++ch) {
          // conv1's B fragments for this chunk's 8 groups of 8 channels:
          // row n of w1p is (9 taps, bias, 6 zeros)
          uint32_t wb[8][2];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const uint32_t* wr = reinterpret_cast<const uint32_t*>(
                w1p + (size_t)(ch * KC + nt * 8 + g) * 16);
            wb[nt][0] = __ldg(wr + t);
            wb[nt][1] = __ldg(wr + 4 + t);
          }
          for (int set = 0; set < 2; ++set) {
            mbar_wait(&cempty[cb], cph ^ 1);
            unsigned char* buf = sC + cb * cbuf_bytes;
            for (int mt = bw; mt < n_mt; mt += 3) {
              uint32_t a[4];
              const int r = set * 2 * G.S16 + mt * 16 + (lane & 15);
              ldmatrix_x4(a, sI + im2col_chunk(r, lane >> 4));
              const int e = mt * 16 + g;  // this lane's entries e, e + 8
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) {
                float d[4] = {0.f, 0.f, 0.f, 0.f};
                mma_bf16(d, a, wb[nt][0], wb[nt][1]);
                const uint32_t o = entry_chunk(e, nt) + 4 * t;
                *reinterpret_cast<uint32_t*>(buf + o) = relu_bf16x2(d[0], d[1]);
                *reinterpret_cast<uint32_t*>(buf + o + 8 * 128) =
                    relu_bf16x2(d[2], d[3]);
              }
            }
            mbar_arrive(&cfull[cb]);
            if (++cb == 2) {
              cb = 0;
              cph ^= 1;
            }
          }
        }
      }
    }
  } else {  // ------------------------------------------------- consumers
    setmaxnreg_inc<208>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int arow = wg * 64 + warp * 16 + (lane & 15);  // ldmatrix row
    const int kc = lane >> 4;
    const int T2F2 = G.T2 * G.F2;
    // entry offsets of the taps: parity 1 is S16 entries on, the next
    // conv1 row F2 + 1
    const int even[6] = {0, G.S16, 1, G.F2 + 1, G.S16 + G.F2 + 1, G.F2 + 2};
    const int odd[3] = {0, G.S16, 1};
    int slot = 0, cb = 0;
    uint32_t ph = 0, cph = 0;
    for (int tile = blockIdx.x; tile < G.n_tiles; tile += gridDim.x) {
      const int piece = tile / per_piece, rem = tile - piece * per_piece;
      const int b = rem / G.tpu;
      const int m0 = (rem - b * G.tpu) * ROWS;
      const int f2a = m0 % G.F2;
      // this lane's row j: window entry j + (the tile rows it is past)
      const int e0 = m0 + arow < T2F2 ? arow + (f2a + arow) / G.F2 : 0;
      float acc[NW / 2];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
      for (int ch = 0; ch < G.chunks; ++ch) {
        mbar_wait(&cfull[cb], cph);
        run_taps<NW, 6>(acc, sC + cb * cbuf_bytes, even, e0, kc, sB, full,
                        empty, slot, ph);
        mbar_arrive(&cempty[cb]);
        cb ^= 1;
        cph ^= cb == 0 ? 1u : 0u;
        mbar_wait(&cfull[cb], cph);
        run_taps<NW, 3>(acc, sC + cb * cbuf_bytes, odd, e0, kc, sB, full,
                        empty, slot, ph);
        mbar_arrive(&cempty[cb]);
        cb ^= 1;
        cph ^= cb == 0 ? 1u : 0u;
      }
      // + b2, ReLU, the mask at t2 >= lens2, bf16, into (B, T2, F2 C)
      const int L = lens[b];
      const int len2 = (((L + 1) >> 1) + 1) >> 1;
      const int n0 = piece * NW;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int mp = m0 + wg * 64 + warp * 16 + g + 8 * half;
        if (mp < T2F2) {
          const bool keep = mp / G.F2 < len2;
          bf16* orow = out + ((size_t)b * T2F2 + mp) * G.C + n0;
#pragma unroll
          for (int i = 0; i < NW / 8; ++i) {
            const int n = i * 8 + 2 * t;
            if (n0 + n < G.C) {
              const float2 bb = *reinterpret_cast<const float2*>(b2p + n0 + n);
              const uint32_t v =
                  keep ? relu_bf16x2(acc[4 * i + 2 * half] + bb.x,
                                     acc[4 * i + 2 * half + 1] + bb.y)
                       : 0u;
              *reinterpret_cast<uint32_t*>(orow + n) = v;
            }
          }
        }
      }
    }
  }
}

}  // namespace hop

namespace {

template <int NW>
cudaError_t launch(const void* x, const void* lens, const void* w1p,
                   const void* w2r, const void* b2p, void* out, const Geo& g,
                   const Plan& p, cudaStream_t s) {
  // w2r: (9, pieces NW, chunks 64) bf16, zero past C in both channel axes
  CUtensorMap tm;
  const uint64_t cin = (uint64_t)g.chunks * KC, nout = (uint64_t)g.pieces * NW;
  const uint64_t dims[3] = {cin, nout, 9};
  const uint64_t strides[2] = {cin * 2, cin * nout * 2};
  const uint32_t box[3] = {KC, NW, 1};
  cudaError_t e = hopper::encode_bf16_sw128(&tm, w2r, 3, dims, strides, box);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(hop::subsample_conv_wgmma_kernel<NW>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           p.smem);
  if (e != cudaSuccess) return e;
  const int sms = hopper::sm_count();
  const int grid = g.n_tiles < sms ? g.n_tiles : sms;
  hop::subsample_conv_wgmma_kernel<NW><<<grid, THREADS, p.smem, s>>>(
      tm, static_cast<const float*>(x), static_cast<const int*>(lens),
      static_cast<const bf16*>(w1p), static_cast<const float*>(b2p),
      static_cast<bf16*>(out), g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel's plan for n_mels F and C channels into out[5]: NW (output
// channels a block), pieces (N pieces of NW), dynamic shared memory in
// bytes, conv1 window entries a parity, 64-channel chunks.
// Returns 0, or cudaErrorInvalidValue for widths the kernel does not take
// (C not a multiple of 16 in [16, 1024], or a conv1 window too wide for
// shared memory).
int subsample_plan(int F, int C, int* out) {
  if (!shape_ok(F, C)) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(F, C);
  out[0] = p.nw;
  out[1] = p.pieces;
  out[2] = p.smem;
  out[3] = p.s16;
  out[4] = p.chunks;
  return 0;
}

// x (B, T, F) float32, lens (B,) int32, w1p (chunks 64, 16) bf16 (conv1's
// 9 taps and bias a row, zero rows past C), w2r (9, pieces NW, chunks 64)
// bf16 (conv2's weight as [tap][out][in], zero past C), b2p (pieces NW,)
// float32 -> out (B, T2, F2 C) bf16, T2 = ceil(ceil(T / 2) / 2), likewise
// F2.
int subsample_launch(const void* x, const void* lens, const void* w1p,
                     const void* w2r, const void* b2p, void* out, int B, int T,
                     int F, int C, void* stream) {
  if (B < 1 || T < 1 || !shape_ok(F, C)) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(F, C);
  Geo g;
  g.B = B;
  g.T = T;
  g.F = F;
  g.C = C;
  g.T1 = (T + 1) / 2;
  g.F1 = (F + 1) / 2;
  g.T2 = (g.T1 + 1) / 2;
  g.F2 = (g.F1 + 1) / 2;
  g.pt1 = T & 1;
  g.pf1 = F & 1;
  g.pt2 = g.T1 & 1;
  g.pf2 = g.F1 & 1;
  g.S16 = p.s16;
  g.tpu = (g.T2 * g.F2 + ROWS - 1) / ROWS;
  g.pieces = p.pieces;
  g.n_tiles = B * g.tpu * p.pieces;
  g.chunks = p.chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.nw) {
    case 32: return (int)launch<32>(x, lens, w1p, w2r, b2p, out, g, p, s);
    case 64: return (int)launch<64>(x, lens, w1p, w2r, b2p, out, g, p, s);
    case 128: return (int)launch<128>(x, lens, w1p, w2r, b2p, out, g, p, s);
    default: return (int)launch<256>(x, lens, w1p, w2r, b2p, out, g, p, s);
  }
}

}  // extern "C"
