// Top-k error-feedback threshold kernel for Hopper (sm_90a), plain C
// interface loaded with ctypes by repro_torch/kernels/topk_ef/kernel.py.
//
// Replaces the Pallas TPU kernel topk_ef_kernel (_topk_ef_kernel) of
// src/repro/kernels/topk_ef/kernel.py.  Given the threshold tau (the k-th
// largest |x|, selected by the caller with torch.topk):
//   keep = |x| >= tau   (ties are all kept)
//   kept = keep ? x : 0,   res = keep ? 0 : x
// Every element lands unmodified in exactly one output, so kept + res == x
// bitwise.
//
// Bound: device-memory bytes (read 4n, write 8n, one compare per element).
// Design: elementwise, one thread per 4 elements with 16-byte float4 loads
// and stores on the aligned body and masked scalar accesses on the ragged
// tail.  tau is read from device memory (a 0-d tensor), so the caller never
// synchronises the host with .item() between selection and filtering.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
topk_ef_kernel(const float* __restrict__ x, const float* __restrict__ tau,
               float* __restrict__ kept, float* __restrict__ res,
               long long n) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i >= n) return;
  const float t = __ldg(tau);
  if (i + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    const bool k0 = fabsf(v.x) >= t, k1 = fabsf(v.y) >= t;
    const bool k2 = fabsf(v.z) >= t, k3 = fabsf(v.w) >= t;
    *reinterpret_cast<float4*>(kept + i) =
        make_float4(k0 ? v.x : 0.0f, k1 ? v.y : 0.0f,
                    k2 ? v.z : 0.0f, k3 ? v.w : 0.0f);
    *reinterpret_cast<float4*>(res + i) =
        make_float4(k0 ? 0.0f : v.x, k1 ? 0.0f : v.y,
                    k2 ? 0.0f : v.z, k3 ? 0.0f : v.w);
  } else {
    for (long long j = i; j < n; ++j) {
      const float v = x[j];
      const bool keep = fabsf(v) >= t;
      kept[j] = keep ? v : 0.0f;
      res[j] = keep ? 0.0f : v;
    }
  }
}

}  // namespace

extern "C" int topk_ef_launch(const float* x, const float* tau, float* kept,
                              float* res, long long n, cudaStream_t stream) {
  const long long quads = (n + 3) / 4;
  if (quads > 0) {
    const unsigned grid =
        static_cast<unsigned>((quads + kThreads - 1) / kThreads);
    topk_ef_kernel<<<grid, kThreads, 0, stream>>>(x, tau, kept, res, n);
  }
  return static_cast<int>(cudaGetLastError());
}
