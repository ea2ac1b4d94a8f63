// Cost of one step's exchange between the blocks of a thread-block cluster,
// three ways, the measurement behind csrc/lstm.cu's choice of st.async with
// mbarrier transaction counts. Every block of a cluster writes 64 floats
// into each block's shared memory (double-buffered), then all meet:
//   cluster barrier: st.shared::cluster, barrier.cluster.arrive.release +
//     wait.acquire;
//   st.async: each store completes 4 transaction bytes on the receiver's
//     mbarrier, which the receiver waits on (acquire.cluster);
//   remote arrive: st.shared::cluster, then mbarrier.arrive.release.cluster
//     on the receiver's mbarrier, one arrival per store.
// Prints the cluster sizes the card holds at once, and us per step for
// clusters of 2, 8 and 16 blocks, one cluster and 14 at once.
// Build and run on the card (not part of the kernel library):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//     -o build/dsmem_sync \
//     pytorch_end2end_speech_recognition_tpu_torch/csrc/probe/dsmem_sync.cu
//   build/dsmem_sync
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

__device__ __forceinline__ uint32_t su32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t rank_of() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t size_of() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void wait_cluster(uint64_t* bar, uint32_t par) {
  asm volatile(
      "{\n .reg .pred p;\n W: mbarrier.try_wait.parity.acquire.cluster"
      ".shared::cta.b64 p, [%0], %1;\n @!p bra W;\n}\n" ::"r"(su32(bar)),
      "r"(par)
      : "memory");
}

enum Mode { kBarrier = 0, kStAsync = 1, kRemoteArrive = 2 };

template <int MODE>
__global__ void exchange_kernel(float* out, int iters) {
  __shared__ float buf[2][1024];
  __shared__ __align__(8) uint64_t full[2];
  const uint32_t C = size_of(), me = rank_of();
  const uint32_t bytes = C * 64 * 4;
  if (threadIdx.x == 0 && MODE != kBarrier) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       su32(&full[b])),
                   "r"(MODE == kStAsync ? 1u : C * 64));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) (&buf[0][0])[i] = 0.f;
  cluster_sync();
  if (MODE == kStAsync && threadIdx.x == 0)
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                       "r"(su32(&full[b])),
                   "r"(bytes)
                   : "memory");
  uint32_t ph[2] = {0, 0};
  float acc = 0.f;
  for (int t = 0; t < iters; ++t) {
    const int ib = t & 1, ob = ib ^ 1;
    if (MODE != kBarrier && t > 0) {
      wait_cluster(&full[ib], ph[ib]);
      ph[ib] ^= 1;
      if (MODE == kStAsync && threadIdx.x == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                su32(&full[ib])),
            "r"(bytes)
            : "memory");
    }
    acc += buf[ib][(threadIdx.x * 7) % (C * 64)];
    __syncthreads();
    if (threadIdx.x < 64 && (MODE == kBarrier || t + 1 < iters)) {
      const float v = acc + me;
      for (uint32_t q = 0; q < C; ++q) {
        const uint32_t a = mapa(su32(&buf[ob][me * 64 + threadIdx.x]), q);
        const uint32_t b = mapa(su32(&full[ob]), q);
        if (MODE == kStAsync) {
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
              "[%0], %1, [%2];" ::"r"(a),
              "r"(__float_as_uint(v)), "r"(b)
              : "memory");
        } else {
          asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(v)
                       : "memory");
          if (MODE == kRemoteArrive)
            asm volatile(
                "mbarrier.arrive.release.cluster.shared::cluster.b64 _, "
                "[%0];" ::"r"(b)
                : "memory");
        }
      }
    }
    if (MODE == kBarrier) cluster_sync();
  }
  cluster_sync();
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

template <typename K>
cudaLaunchConfig_t config(int C, int clusters, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * clusters);
  cfg.blockDim = dim3(512);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

int main() {
  void (*kernels[3])(float*, int) = {exchange_kernel<kBarrier>,
                                     exchange_kernel<kStAsync>,
                                     exchange_kernel<kRemoteArrive>};
  const char* names[3] = {"cluster barrier", "st.async + complete_tx",
                          "st + remote arrive"};
  float* out;
  cudaMalloc(&out, 4096 * sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  printf("clusters the card holds at once (512 threads, 200 KiB shared):");
  for (int C : {1, 2, 4, 8, 16}) {
    cudaFuncSetAttribute(kernels[0],
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaFuncSetAttribute(kernels[0],
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         200 * 1024);
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config<void>(C, 1, attr);
    cfg.dynamicSmemBytes = 200 * 1024;
    int n = 0;
    cudaOccupancyMaxActiveClusters(&n, kernels[0], &cfg);
    printf(" C%d %d", C, n);
  }
  printf("\n");
  const int iters = 20000;
  for (int mode = 0; mode < 3; ++mode)
    for (int C : {2, 8, 16})
      for (int clusters : {1, 14}) {
        if (C * clusters > 120) continue;
        cudaFuncSetAttribute(kernels[mode],
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
        cudaLaunchAttribute attr[1];
        cudaLaunchConfig_t cfg = config<void>(C, clusters, attr);
        cudaLaunchKernelEx(&cfg, kernels[mode], out, 100);
        cudaEventRecord(e0);
        cudaError_t e = cudaLaunchKernelEx(&cfg, kernels[mode], out, iters);
        cudaEventRecord(e1);
        const cudaError_t e2 = cudaEventSynchronize(e1);
        float ms = 0.f;
        cudaEventElapsedTime(&ms, e0, e1);
        printf("%-24s cluster %2d x %2d: %s, %.3f us per step\n",
               names[mode], C, clusters,
               cudaGetErrorString(e != cudaSuccess ? e : e2),
               1e3f * ms / iters);
      }
  return 0;
}
