// Toeplitz expansion of relative-position diagonals into dense bias blocks,
// and its transpose, the per-diagonal reduce of the bias cotangent.
//
// Expand. Replaces: pytorch_end2end_speech_recognition_tpu/ops/
//   attention_pallas.py toeplitz_dense (pallas_call at :437, kernel body
//   _toep_expand_kernel :367).
//
// Computes out[n, i, j] = diag[n, clamp((T-1) + j - i, 0, 2T-2)] for
// i, j < P (P >= T, the padded length). Inside the T x T core this is the
// Toeplitz bias; in the pad band the clamp repeats the edge diagonals, as the
// TPU kernel's edge-padded (N, 2P) diagonal vector does. Row i is the window
// ext[(P-1) - i : (P-1) - i + P] of one vector, ext[m] = diag[clamp(m - (P -
// T))] of length 2P - 1: the expand is a copy of shifted windows.
//
// Bound on the H100: bytes. It reads N(2T-1) floats and writes N P^2
// elements (48 x 768 x 768 bf16 = 56.6 MB at the flagship, ~17 us at 3.35
// TB/s; rung 4's 128 blocks 151 MB) and does no arithmetic. Design: a
// persistent grid over work items of 64 rows x up to 1,024 columns of one
// block n. An item stages the part of ext its rows read in shared memory,
// converted once, in 16/sizeof(out) copies each shifted by one element, so
// that every row's window starts on a 16-byte boundary of one copy. A warp
// then writes a row as plain 16-byte loads from shared memory and 16-byte
// coalesced stores, with no clamp or conversion in the store loop. The
// output is the same rounding of the same gather, bit for bit.
//
// Reduce. Replaces: pytorch_end2end_speech_recognition_tpu/ops/
//   attention_pallas.py _toeplitz_dense_bwd (pallas_call at :464, kernel
//   body _toep_reduce_kernel :380).
//
// out[n, (T-1) + j - i] = the sum over the T x T core of g[n, i, j]. The TPU
// kernel sums the whole padded block after pre-reversing the rows and
// rolling each one (a TPU layout trick); its CPU path sums only g[:, :T,
// :T]. On the training path the pad band (i or j >= T) is zero, so the two
// agree; this kernel sums the T x T core.
//
// Bound on the H100: bytes. It reads the T x T core once (48 x 750 x 750
// bf16 = 54 MB at the flagship train step, ~16 us at 3.35 TB/s) and writes
// N(2T-1) floats. Design: a cluster of two blocks owns 128 neighbouring
// diagonals of one block n, each block one half of their rows (whole
// tiles), so the longest chain of tiles a block walks is halved and no
// partial leaves the chip: the second block's sums reach the first through
// distributed shared memory, which adds them after its own, in that
// order, and writes them. One launch, no partial buffer, no atomics. A
// block streams 32-row tiles of the parallelogram the band covers (each
// row's 166 or 162 columns from the band's first, rounded to 16-byte
// chunks) into a three-stage ring of shared memory by cp.async, chunks
// outside the T x T core left unread. Each thread owns one diagonal and
// adds its 32 elements of a tile from shared memory in row order, the
// elements outside the core (the pad band and the rounding) as zeros
// (neighbour threads read neighbour elements: no bank conflicts): every
// diagonal is the same sums in the same order, the same bits on every run.
// Tiles come by cp.async: a TMA ring whose boxes start left of the tensor
// for a band's first rows hung in its first wait on the card. Two segments:
// one block over all of a band's rows is bound by its own chain of tiles. A
// P that leaves rows unaligned (P % 8 for bf16, % 4 for float32) takes a
// plain kernel that sums each diagonal's rows in order.
#include "hopper.cuh"

namespace {

using namespace hopper;

template <typename OutT>
__device__ __forceinline__ OutT cvt(float x);
template <>
__device__ __forceinline__ float cvt<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename InT>
__device__ __forceinline__ float to_f32(InT x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ------------------------------------------------------------------ expand
constexpr int EXP_ROWS = 64;      // rows of one work item
constexpr int EXP_COLS = 1024;    // columns of one work item
constexpr int EXP_THREADS = 256;
constexpr int EXP_WIN = EXP_COLS + EXP_ROWS;  // staged window, elements
constexpr int EXP_BLOCKS_PER_SM = 8;

// one copy of the window per element of a 16-byte vector
template <typename OutT>
constexpr int exp_smem_bytes() {
  return (16 / (int)sizeof(OutT)) * EXP_WIN * (int)sizeof(OutT);
}

template <typename OutT>
__global__ void __launch_bounds__(EXP_THREADS)
    toeplitz_expand_kernel(const float* __restrict__ diag,
                           OutT* __restrict__ out, int T, int P, int n_rb,
                           int n_cb, int items) {
  constexpr int VEC = 16 / sizeof(OutT);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  OutT* copies = reinterpret_cast<OutT*>(smem_raw);  // copy s at s * EXP_WIN
  const int W = 2 * T - 1;
  const bool vec = P % VEC == 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int cb = item % n_cb;
    const int rb = (item / n_cb) % n_rb;
    const int n = item / (n_cb * n_rb);
    const int i0 = rb * EXP_ROWS, j0 = cb * EXP_COLS;
    const int cw = min(EXP_COLS, P - j0);
    // window element x is ext[(P-1) - (i0 + EXP_ROWS - 1) + j0 + x], the
    // diagonal at `base + x` before the clamp
    const int base = (T - 1) - (i0 + EXP_ROWS - 1) + j0;
    const float* d = diag + (size_t)n * W;
    __syncthreads();  // the previous item's rows are written
    for (int x = threadIdx.x; x < EXP_WIN + VEC - 1; x += EXP_THREADS) {
      const OutT v = cvt<OutT>(__ldg(d + min(max(base + x, 0), W - 1)));
#pragma unroll
      for (int s = 0; s < VEC; ++s) {
        const int y = x - s;
        if (y >= 0 && y < EXP_WIN) copies[s * EXP_WIN + y] = v;
      }
    }
    __syncthreads();
    for (int r = warp; r < EXP_ROWS; r += EXP_THREADS / 32) {
      const int i = i0 + r;
      if (i >= P) break;
      const int a = EXP_ROWS - 1 - r;  // the row's window starts at x = a
      OutT* dst = out + ((size_t)n * P + i) * P + j0;
      if (vec) {
        const int s = a % VEC;
        const uint4* src =
            reinterpret_cast<const uint4*>(copies + s * EXP_WIN + (a - s));
        uint4* dv = reinterpret_cast<uint4*>(dst);
        for (int l = lane; l < cw / VEC; l += 32) dv[l] = src[l];
      } else {
        for (int j = lane; j < cw; j += 32) dst[j] = copies[a + j];
      }
    }
  }
}

template <typename OutT>
cudaError_t expand_launch(const float* diag, OutT* out, int N, int T, int P,
                          cudaStream_t s) {
  const int n_rb = (P + EXP_ROWS - 1) / EXP_ROWS;
  const int n_cb = (P + EXP_COLS - 1) / EXP_COLS;
  const long long items = (long long)N * n_rb * n_cb;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const long long slots = (long long)sm_count() * EXP_BLOCKS_PER_SM;
  const int grid = (int)(items < slots ? items : slots);
  toeplitz_expand_kernel<OutT>
      <<<grid, EXP_THREADS, exp_smem_bytes<OutT>(), s>>>(
          diag, out, T, P, n_rb, n_cb, (int)items);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ reduce
constexpr int RED_DIAGS = 128;  // diagonals of a block: one thread each
constexpr int RED_ROWS = 32;    // rows of a tile
constexpr int RED_STAGES = 3;   // tiles in flight
constexpr int RED_SEGS = 2;     // row segments of a band: a cluster's blocks

// A tile: RED_ROWS rows of the parallelogram a band of diagonals covers,
// each row's columns from the band's first column in that row (row r of
// tile k starts one column right of row r - 1), rounded down to a 16-byte
// chunk: W elements a row, >= RED_DIAGS + RED_ROWS - 1 + (VEC - 1).
template <typename InT>
struct RedTile {
  static constexpr int VEC = 16 / (int)sizeof(InT);
  static constexpr int W =
      (RED_DIAGS + RED_ROWS - 1 + 2 * (VEC - 1)) / VEC * VEC;
  static constexpr int CHUNKS = W / VEC;  // 16-byte chunks a row
  static constexpr int ELEMS = RED_ROWS * W;
  static constexpr int SMEM_BYTES = RED_STAGES * ELEMS * (int)sizeof(InT);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the float at the same shared-memory address in cluster block `rank`
__device__ __forceinline__ float load_rank(const float* p, uint32_t rank) {
  uint32_t a;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a)
               : "memory");
  return v;
}

// The rows of the band [d0, d1) of diagonals: diagonal d has rows i with
// 0 <= i + d - (T-1) < T.
__device__ __forceinline__ void band_rows(int T, int d0, int d1, int& lo,
                                          int& hi) {
  lo = max(0, T - d1);
  hi = min(T, 2 * T - 1 - d0);
}

// grid (ceil(W / RED_DIAGS), RED_SEGS, N) in clusters of the RED_SEGS
// blocks of one band, each block a segment of the band's tiles; P a
// multiple of 16 / sizeof(InT)
template <typename InT>
__global__ void __cluster_dims__(1, RED_SEGS, 1) __launch_bounds__(RED_DIAGS)
    toeplitz_reduce_kernel(const InT* __restrict__ g, float* __restrict__ out,
                           int T, int P) {
  using Tile = RedTile<InT>;
  constexpr int VEC = Tile::VEC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float part[RED_DIAGS];
  InT* tiles = reinterpret_cast<InT*>(smem_raw);
  const int W = 2 * T - 1;
  const int n = blockIdx.z;
  const int d0 = blockIdx.x * RED_DIAGS;
  const int dl = threadIdx.x;
  const uint32_t seg = cluster_rank();
  int lo, hi, my_lo, my_hi;
  band_rows(T, d0, min(d0 + RED_DIAGS, W), lo, hi);
  band_rows(T, d0 + dl, d0 + dl + 1, my_lo, my_hi);  // this diagonal's rows
  const int all_tiles = hi > lo ? (hi - lo + RED_ROWS - 1) / RED_ROWS : 0;
  const int per_seg = (all_tiles + RED_SEGS - 1) / RED_SEGS;
  lo += seg * per_seg * RED_ROWS;  // this segment's first row
  const int n_tiles = max(0, min(per_seg, all_tiles - (int)seg * per_seg));
  const InT* gn = g + (size_t)n * P * P;
  // tile k: rows lo + k R .., columns from c0 = its first row's column of
  // diagonal d0, aligned down to a chunk by the shift sh
  auto shift = [&](int k) {
    const int c0 = lo + k * RED_ROWS + d0 - (T - 1);
    return ((c0 % VEC) + VEC) % VEC;
  };
  auto issue = [&](int k) {
    if (k < n_tiles) {
      const int i0 = lo + k * RED_ROWS;
      const int ca = i0 + d0 - (T - 1) - shift(k);
      InT* dst = tiles + (k % RED_STAGES) * Tile::ELEMS;
      for (int q = dl; q < RED_ROWS * Tile::CHUNKS; q += RED_DIAGS) {
        const int r = q / Tile::CHUNKS, j = ca + (q % Tile::CHUNKS) * VEC;
        // chunks outside the core's rows or columns stay unread: the sums
        // below take only the core's elements (the row's pad band past T
        // inside a chunk is read, not added)
        if (i0 + r < T && j >= 0 && j < T)
          cp_async16(dst + r * Tile::W + (j - ca),
                     gn + (size_t)(i0 + r) * P + j);
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < RED_STAGES - 1; ++k) issue(k);
  float acc = 0.f;
  for (int k = 0; k < n_tiles; ++k) {
    issue(k + RED_STAGES - 1);
    cp_async_wait<RED_STAGES - 1>();
    __syncthreads();
    // diagonal d0 + dl at row r sits at column r + dl of the shifted tile
    const InT* t = tiles + (k % RED_STAGES) * Tile::ELEMS + shift(k) + dl;
    const int i0 = lo + k * RED_ROWS;
#pragma unroll
    for (int r = 0; r < RED_ROWS; ++r) {
      const float v = to_f32<InT>(t[r * (Tile::W + 1)]);
      acc += (i0 + r >= my_lo && i0 + r < my_hi) ? v : 0.f;
    }
    __syncthreads();  // the stage is free for the tile issued next
  }
  // the segments' sums, added in segment order by the first block
  part[dl] = acc;
  cluster_sync();
  if (seg == 0) {
    for (uint32_t r = 1; r < RED_SEGS; ++r) acc += load_rank(&part[dl], r);
    if (d0 + dl < W) out[(size_t)n * W + d0 + dl] = acc;
  }
  cluster_sync();  // every block's part stays until it has been read
}

// the same sums for a P that leaves rows unaligned: thread per diagonal,
// rows in increasing order
template <typename InT>
__global__ void __launch_bounds__(RED_DIAGS)
    toeplitz_reduce_rows_kernel(const InT* __restrict__ g,
                                float* __restrict__ out, int T, int P) {
  const int W = 2 * T - 1;
  const int n = blockIdx.y;
  const int d = blockIdx.x * RED_DIAGS + threadIdx.x;
  if (d >= W) return;
  int lo, hi;
  band_rows(T, d, d + 1, lo, hi);
  const InT* p = g + (size_t)n * P * P + (size_t)lo * (P + 1) + (d - (T - 1));
  float acc = 0.f;
  for (int i = lo; i < hi; ++i, p += P + 1) acc += to_f32<InT>(*p);
  out[(size_t)n * W + d] = acc;
}

template <typename InT>
cudaError_t reduce_launch(const InT* g, float* out, int N, int T, int P,
                          cudaStream_t s) {
  const int W = 2 * T - 1;
  dim3 grid((W + RED_DIAGS - 1) / RED_DIAGS, N);
  const bool aligned = P % RedTile<InT>::VEC == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (!aligned) {
    toeplitz_reduce_rows_kernel<InT><<<grid, RED_DIAGS, 0, s>>>(g, out, T, P);
    return cudaGetLastError();
  }
  const int bytes = RedTile<InT>::SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      toeplitz_reduce_kernel<InT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  toeplitz_reduce_kernel<InT><<<dim3(grid.x, RED_SEGS, N), RED_DIAGS, bytes,
                                s>>>(g, out, T, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// g: (N, P, P) bf16 (in_is_bf16) or float32; out: (N, 2T-1) float32. Sums
// the T x T core of each block, every diagonal in increasing row order.
int toeplitz_reduce_launch(const void* g, void* out, int in_is_bf16, int N,
                           int T, int P, void* stream) {
  if (T < 1 || P < T || N < 1 || N > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_is_bf16)
    return (int)reduce_launch(static_cast<const __nv_bfloat16*>(g),
                              static_cast<float*>(out), N, T, P, s);
  return (int)reduce_launch(static_cast<const float*>(g),
                            static_cast<float*>(out), N, T, P, s);
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// diag: (N, 2T-1) float32; out: (N, P, P) bf16 (out_is_bf16) or float32.
int toeplitz_launch(const void* diag, void* out, int out_is_bf16, int N,
                    int T, int P, void* stream) {
  if (T < 1 || P < T || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_is_bf16)
    return (int)expand_launch(static_cast<const float*>(diag),
                              static_cast<__nv_bfloat16*>(out), N, T, P, s);
  return (int)expand_launch(static_cast<const float*>(diag),
                            static_cast<float*>(out), N, T, P, s);
}

}  // extern "C"
