// Shared-memory load cost by access pattern: SM cycles per warp
// instruction, 16 warps an SM issuing nothing but loads. The measurement
// behind the LSTM kernels' operand layouts (csrc/lstm.cu): a quarter-warp
// should read one 128-byte row of W, and a float4 that every lane of a
// quarter-warp shares (h, dgates) costs half of one whose lanes differ.
// Build and run on the card (not part of the kernel library):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/lds_cost \
//     pytorch_end2end_speech_recognition_tpu_torch/csrc/probe/lds_cost.cu
//   build/lds_cost
#include <cuda_runtime.h>
#include <stdio.h>

namespace {

constexpr int kWords = 8192;

// MODE: the word each lane reads (its float4's first word for 128-bit)
__device__ int lane_word(int mode, int lane) {
  switch (mode) {
    case 0: return 0;                       // 128-bit, one address a warp
    case 1: return (lane >> 3) * 8;         // 128-bit, one a quarter-warp
    case 2: return lane * 4;                // 128-bit, 32 contiguous
    case 3: return (lane & 7) * 4 + (lane >> 3) * 640;  // 4 rows x 128 B
    case 4: return lane >> 3;               // 32-bit, 4 distinct
    default: return lane;                   // 32-bit, 32 contiguous
  }
}

template <int MODE>
__global__ void loads(float* out, int iters) {
  __shared__ __align__(16) float sm[kWords];
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) sm[i] = i;
  __syncthreads();
  const int base = lane_word(MODE, threadIdx.x & 31);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const int off = (it & 7) * 512;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int w = (base + off + u * 128) & (kWords - 4);
      if (MODE >= 4) {
        acc.x += sm[(base + off + u * 128) & (kWords - 1)];
      } else {
        const float4 v = *reinterpret_cast<const float4*>(&sm[w]);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0)
    out[blockIdx.x] = (float)(t1 - t0) / (iters * 8.f) +
                      1e-30f * (acc.x + acc.y + acc.z + acc.w);
}

}  // namespace

int main() {
  const char* names[6] = {
      "LDS.128, one address a warp", "LDS.128, one address a quarter-warp",
      "LDS.128, 32 distinct contiguous", "LDS.128, 4 rows of 128 bytes",
      "LDS.32, 4 distinct", "LDS.32, 32 distinct contiguous"};
  void (*kernels[6])(float*, int) = {loads<0>, loads<1>, loads<2>,
                                     loads<3>, loads<4>, loads<5>};
  float* out;
  cudaMalloc(&out, 132 * sizeof(float));
  for (int m = 0; m < 6; ++m) {
    float h = 0.f;
    kernels[m]<<<132, 512>>>(out, 1000);
    kernels[m]<<<132, 512>>>(out, 20000);
    cudaMemcpy(&h, out, sizeof(float), cudaMemcpyDeviceToHost);
    printf("%-38s %6.3f SM cycles per warp instruction (%s)\n", names[m],
           h / 16.f, cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
