// Flash decoding for Hopper (sm_90a), plain C interface loaded with ctypes
// by repro_torch/kernels/decode_attention/kernel.py.
//
// Replaces the Pallas TPU kernel decode_attention_kernel (body _kernel) of
// src/repro/kernels/decode_attention/kernel.py, and computes the
// score/mask/softmax/PV block of the JAX model's gqa_decode
// (src/repro/models/attention.py): for each batch row b and query head
// h = kvh * g + i,
//   o[b, h] = softmax_{t < length}(q[b, h] . k[b, t, kvh] * d^-1/2) v[b, t, kvh]
// with an fp32 online softmax and cache positions >= length masked to
// -1e30 as the Pallas kernel does (the model masks t <= pos, so
// length = pos + 1).
//
// Layout: q (b, h, d) and the cache k/v (b, S, m, d) read in place through
// their strides (head_dim contiguous, cache row stride m*d).  The Pallas
// wrapper's transpose(0, 2, 1, 3).reshape of the cache would copy the whole
// cache per layer per token; here the block walks its kv head's rows where
// they lie.  Types: float32 or bfloat16 in and out, fp32 inside; any
// head_dim <= 128.  length is a plain int argument: no host sync.
//
// Bound: device-memory bytes -- the cache prefix (2 * length * d per
// (b, kv head)) is read once, and each element feeds 2g flops.  Design,
// simple first: one block of 256 threads per (b, kv head), so the g query
// heads of the group share every K/V tile load (64 positions through
// shared memory); positions past length are neither loaded nor counted,
// and the tail of the last tile is masked.  Scores are one (head,
// position) dot product per thread; the online softmax is one warp per
// head; the fp32 accumulator lives in shared memory.  Split-KV across
// blocks (more blocks than b*m at small batch), TMA and wider loads are
// for a later kernel.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;           // cache positions per tile (2 per lane)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_floats(int group, int d) {
  // q, acc: group x d; K: kBK x (d+1); V: kBK x d; P: group x kBK; m, l, corr
  return size_t(2) * group * d + size_t(kBK) * (d + 1) + size_t(kBK) * d +
         size_t(group) * kBK + size_t(3) * group;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        int kv_heads, int group, int length, int d,
                        long long qsb, long long qsh,
                        long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh,
                        long long osb, long long osh, float sm_scale) {
  const int ld = d + 1;           // padded K row: conflict-free dot products
  extern __shared__ float smem[];
  float* sQ = smem;                       // group x d
  float* sAcc = sQ + group * d;           // group x d
  float* sK = sAcc + group * d;           // kBK x ld
  float* sV = sK + kBK * ld;              // kBK x d
  float* sP = sV + kBK * d;               // group x kBK
  float* sM = sP + group * kBK;           // group
  float* sL = sM + group;                 // group
  float* sCorr = sL + group;              // group

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / kv_heads, kvh = blockIdx.x % kv_heads;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < group * d; i += kThreads) {
    const int g = i / d, c = i % d;
    sQ[i] = to_f32(q[b * qsb + (kvh * group + g) * qsh + c]);
    sAcc[i] = 0.0f;
  }
  for (int g = tid; g < group; g += kThreads) {
    sM[g] = kNegInf;
    sL[g] = 0.0f;
  }

  const int n_tiles = (length + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    const int kn = min(kBK, length - k0);
    __syncthreads();              // q loaded / last tile's reads finished
#pragma unroll 4
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const bool ok = r < kn;
      sK[r * ld + c] = ok ? to_f32(kb[(k0 + r) * kss + c]) : 0.0f;
      sV[r * d + c] = ok ? to_f32(vb[(k0 + r) * vss + c]) : 0.0f;
    }
    __syncthreads();

    for (int i = tid; i < group * kBK; i += kThreads) {
      const int g = i / kBK, j = i % kBK;
      const float* qr = sQ + g * d;
      const float* kr = sK + j * ld;
      float s = 0.0f;
      for (int c = 0; c < d; ++c) s = fmaf(qr[c], kr[c], s);
      sP[i] = j < kn ? s * sm_scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < group; g += kWarps) {
      float* pr = sP + g * kBK;
      float a = pr[lane], c2 = pr[lane + 32];
      float mx = fmaxf(a, c2);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);
      a = expf(a - m_new);
      c2 = expf(c2 - m_new);
      pr[lane] = a;
      pr[lane + 32] = c2;
      float sum = a + c2;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sCorr[g] = corr;
        sL[g] = sL[g] * corr + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < group * d; i += kThreads) {
      const int g = i / d, c = i % d;
      const float* pr = sP + g * kBK;
      float a = sAcc[i] * sCorr[g];
      for (int j = 0; j < kn; ++j) a = fmaf(pr[j], sV[j * d + c], a);
      sAcc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < group * d; i += kThreads) {
    const int g = i / d, c = i % d;
    store(o + b * osb + (kvh * group + g) * osh + c,
          sAcc[i] / fmaxf(sL[g], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int kv_heads, int group, int length, int d,
                   const long long* st, float sm_scale, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T>;
  const size_t smem = sizeof(float) * smem_floats(group, d);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<unsigned(batch) * unsigned(kv_heads), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kv_heads, group, length,
      d, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 10 host integers in
// elements -- q (batch, head), k (batch, position, head), v (batch,
// position, head), o (batch, head).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* o, int dtype,
                                       int batch, int heads, int kv_heads,
                                       int length, int d,
                                       const long long* strides,
                                       float sm_scale, cudaStream_t stream) {
  if (d < 1 || d > 128 || kv_heads < 1 || heads % kv_heads != 0 ||
      length < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * kv_heads == 0) return static_cast<int>(cudaGetLastError());
  const int group = heads / kv_heads;
  const cudaError_t err =
      dtype == 0
          ? launch<float>(q, k, v, o, batch, kv_heads, group, length, d,
                          strides, sm_scale, stream)
      : dtype == 1
          ? launch<__nv_bfloat16>(q, k, v, o, batch, kv_heads, group, length,
                                  d, strides, sm_scale, stream)
          : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
