// Flash attention forward for Hopper (sm_90a), plain C interface loaded
// with ctypes by repro_torch/kernels/flash_attention/kernel.py.
//
// Replaces the Pallas TPU kernel flash_attention_kernel (body _kernel) of
// src/repro/kernels/flash_attention/kernel.py, and computes the function
// of the JAX model's _sdpa (src/repro/models/attention.py):
//   o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/g] * d^-1/2) v[b, j, h/g]
// with an fp32 online softmax (running max m, sum l, accumulator acc),
// masked scores set to -1e30 as the Pallas kernel does, and, when causal,
// the top-left aligned mask qpos >= kpos with key tiles strictly above the
// diagonal skipped.  Any sq and sk: the ragged tails are masked here (the
// Pallas kernel asserts divisibility instead).
//
// Layout: q (b, sq, h, d) and k/v (b, sk, m, d) read in place through
// their batch/position/head strides (head_dim contiguous); query head h
// reads kv head h / g with g = h_total / m, the mapping of _sdpa's
// reshape(b, s, m, g, d) and of the Pallas wrapper's jnp.repeat -- but
// with no repeat copy and no transpose copy.  o is (b, sq, h, d).
// Types: float32 or bfloat16 in and out, fp32 arithmetic inside; any
// head_dim <= 128 (padded to a multiple of 16 in shared memory).
//
// Bound: at the model's lengths (s >= 512, d = 64) the QK^T and PV
// products (4 b h sq sk d flops, halved when causal) bound it, far above
// the bytes of q, k, v and o.  Design, simple first: one block of 256
// threads per (b*h, 64-row query tile); K/V stream through shared memory
// in 64-key tiles; each thread owns a 4x4 patch of the score tile and a
// 4-row x (d/16)-column patch of the fp32 accumulator, with fp32 FMAs on
// the CUDA cores (no tensor cores, no TMA: those are for a later kernel).
// Row max and row sum of the online softmax reduce over the 16 threads
// sharing the rows with warp shuffles.  Shared rows are padded by one
// word so the column-wise reads of K are free of bank conflicts.
// Heavier causal tiles (the later query rows) are scheduled first.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;     // 16 x 16
constexpr int kTM = 4;            // query rows per thread
constexpr int kTN = 4;            // keys per thread in the score tile
constexpr int kLP = kBK + 1;      // padded row stride of the P tile
constexpr float kNegInf = -1e30f;

struct Strides {                  // in elements; head_dim is contiguous
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int NJ>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBQ + 2 * kBK) * (NJ * 16 + 1) + size_t(kBQ) * kLP);
}

// NJ = padded head_dim / 16: the accumulator columns each thread owns
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int heads, int group, int sq, int sk, int d,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float sm_scale, int causal) {
  constexpr int kDP = NJ * 16;    // padded head_dim
  constexpr int kLD = kDP + 1;    // padded row stride of Q, K, V tiles
  extern __shared__ float smem[];
  float* sQ = smem;               // kBQ x kLD
  float* sK = sQ + kBQ * kLD;     // kBK x kLD
  float* sV = sK + kBK * kLD;     // kBK x kLD
  float* sP = sV + kBK * kLD;     // kBQ x kLP

  const int tid = threadIdx.x;
  const int tx = tid & 15;        // key / head_dim column group
  const int ty = tid >> 4;        // query row group
  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < kBQ * kDP; i += kThreads) {
    const int r = i / kDP, c = i % kDP;
    const int row = q0 + r;
    sQ[r * kLD + c] = (row < sq && c < d) ? to_f32(qb[row * qs.s + c]) : 0.0f;
  }

  float acc[kTM][NJ];
  float m[kTM], l[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.0f;
  }

  // keys past the block's last valid query row are masked for every row
  // when causal: those tiles are skipped, the rest of the tail masked
  const int last_row = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, last_row + 1) : sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();              // Q loaded / last tile's reads finished
    for (int i = tid; i < kBK * kDP; i += kThreads) {
      const int r = i / kDP, c = i % kDP;
      const int key = k0 + r;
      const bool ok = key < k_end && c < d;
      sK[r * kLD + c] = ok ? to_f32(kb[key * ks.s + c]) : 0.0f;
      sV[r * kLD + c] = ok ? to_f32(vb[key * vs.s + c]) : 0.0f;
    }
    __syncthreads();

    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[kTM], kv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) qv[i] = sQ[(ty * kTM + i) * kLD + c];
#pragma unroll
      for (int j = 0; j < kTN; ++j) kv[j] = sK[(tx + 16 * j) * kLD + c];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = q0 + ty * kTM + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int key = k0 + tx + 16 * j;
        float val = s[i][j] * sm_scale;
        if (key >= sk || (causal && key > row)) val = kNegInf;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(ty * kTM + i) * kLP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();              // P tile complete

    const int kn = min(kBK, k_end - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float vv[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) vv[jj] = sV[kk * kLD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float p = sP[(ty * kTM + i) * kLP + kk];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + ty * kTM + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + b * os.b + row * os.s + h * os.h;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < d) store(orow + c, acc[i][jj] / denom);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int heads, int group, int sq, int sk, int d,
                   const Strides* st, float sm_scale, int causal,
                   cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, NJ>;
  constexpr size_t smem = smem_bytes<NJ>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned(batch) * unsigned(heads),
                  unsigned((sq + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), heads, group, sq, sk, d,
      st[0], st[1], st[2], st[3], sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int batch, int heads, int group, int sq, int sk, int d,
                     const Strides* st, float sm_scale, int causal,
                     cudaStream_t stream) {
  switch ((d + 15) / 16) {
#define REPRO_FA_CASE(NJ)                                                  \
  case NJ:                                                                 \
    return launch<T, NJ>(q, k, v, o, batch, heads, group, sq, sk, d, st,   \
                         sm_scale, causal, stream);
    REPRO_FA_CASE(1)
    REPRO_FA_CASE(2)
    REPRO_FA_CASE(3)
    REPRO_FA_CASE(4)
    REPRO_FA_CASE(5)
    REPRO_FA_CASE(6)
    REPRO_FA_CASE(7)
    REPRO_FA_CASE(8)
#undef REPRO_FA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 host integers, the
// (batch, position, head) strides in elements of q, k, v and o.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int batch, int heads, int kv_heads,
                                      int sq, int sk, int d,
                                      const long long* strides,
                                      float sm_scale, int causal,
                                      cudaStream_t stream) {
  if (d < 1 || d > 128 || kv_heads < 1 || heads % kv_heads != 0 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * heads == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int group = heads / kv_heads;
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(q, k, v, o, batch, heads, group, sq, sk, d, st,
                            sm_scale, causal, stream)
      : dtype == 1
          ? dispatch<__nv_bfloat16>(q, k, v, o, batch, heads, group, sq, sk,
                                    d, st, sm_scale, causal, stream)
          : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
