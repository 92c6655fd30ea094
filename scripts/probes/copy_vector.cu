// K4's copy variant by 16-byte vector loads and stores, sm_90a: the form
// that csrc/onehot_adam.cu's COPY mode (TMA bulk copies) was chosen over,
// kept as the probe that scripts/probe_study_kernels.py times beside it.
//
// Three tables of `bytes` bytes each are streamed to fresh outputs, p, then
// m, then v, by a persistent grid (the SMs times the 256-thread CTAs
// resident on one), each thread VECS 16-byte loads (streaming hint) a
// grid's width apart in flight before it stores them (streaming hint).

#include <cuda_runtime.h>

#define THREADS 256
#define VECS 4

__global__ void __launch_bounds__(THREADS) copy_vector_kernel(const float4* s0,
                                                              const float4* s1,
                                                              const float4* s2, float4* d0,
                                                              float4* d1, float4* d2,
                                                              long long n4) {
  const long long nth = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (int k = 0; k < 3; ++k) {
    const float4* s = k == 0 ? s0 : k == 1 ? s1 : s2;
    float4* d = k == 0 ? d0 : k == 1 ? d1 : d2;
    for (long long e = tid; e < n4; e += VECS * nth) {
      float4 x[VECS];
#pragma unroll
      for (int c = 0; c < VECS; ++c)
        if (e + c * nth < n4) x[c] = __ldcs(s + e + c * nth);
#pragma unroll
      for (int c = 0; c < VECS; ++c)
        if (e + c * nth < n4) __stcs(d + e + c * nth, x[c]);
    }
  }
}

extern "C" {

// Copies s0, s1, s2 (16-byte aligned, `bytes` each, a multiple of 16) to
// d0, d1, d2 on `stream`; returns cudaGetLastError() (0 = launched).
int copy_vector(const void* s0, const void* s1, const void* s2, void* d0, void* d1, void* d2,
                long long bytes, void* stream) {
  if (bytes < 0 || bytes % 16) return (int)cudaErrorInvalidValue;
  if (bytes == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, copy_vector_kernel, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  copy_vector_kernel<<<sms * per_sm, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float4*>(s0), static_cast<const float4*>(s1),
      static_cast<const float4*>(s2), static_cast<float4*>(d0), static_cast<float4*>(d1),
      static_cast<float4*>(d2), bytes / 16);
  return (int)cudaGetLastError();
}

}  // extern "C"
