// Tile helpers shared by the flash-attention kernels (flash_attention.cu and
// its gradient, flash_attention_bwd.cu): strided inputs, element types,
// copies of rows into shared memory, and the wide shared loads their mma
// fragments are read with.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

struct Strides {                  // in elements; head_dim is contiguous
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// one element of a row into shared memory, zero when !valid: a 4-byte
// cp.async for fp32, a plain load for bfloat16
__device__ __forceinline__ void copy_elem(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          bool valid) {
  *dst = valid ? *src : zero<__nv_bfloat16>();
}

// rows [r0, r0 + n) of two (position, head_dim) operands (row strides st0,
// st1) into shared tiles (row strides ld0, ld1); rows at or past `limit`
// are zeros.  vec: 16-byte cp.async copies (d, the strides and the
// pointers allow them), else element copies.  Commits nothing.
template <typename T>
__device__ __forceinline__ void copy_rows2(T* d0, int ld0, const T* s0,
                                          long long st0, T* d1, int ld1,
                                          const T* s1, long long st1, int r0,
                                          int n, int limit, int d, int vec,
                                          int tid, int threads) {
  if (vec) {
    constexpr int kE = 16 / sizeof(T);
    const int pieces = d / kE;
    for (int i = tid; i < n * pieces; i += threads) {
      const int r = i / pieces, c = (i % pieces) * kE;
      const bool ok = r0 + r < limit;
      const long long row = ok ? r0 + r : 0;
      cp_async16(d0 + r * ld0 + c, s0 + row * st0 + c, ok);
      cp_async16(d1 + r * ld1 + c, s1 + row * st1 + c, ok);
    }
  } else {
    for (int i = tid; i < n * d; i += threads) {
      const int r = i / d, c = i % d;
      const bool ok = r0 + r < limit;
      const long long row = ok ? r0 + r : 0;
      copy_elem(d0 + r * ld0 + c, s0 + row * st0 + c, ok);
      copy_elem(d1 + r * ld1 + c, s1 + row * st1 + c, ok);
    }
  }
}

// rows [r0, r0 + n) of one (position, head_dim) operand (row stride st)
// into a shared tile (row stride ld); rows at or past `limit` are zeros.
// vec: 16-byte cp.async copies, else element copies.  Commits nothing.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          long long st, int r0, int n,
                                          int limit, int d, int vec, int tid,
                                          int threads) {
  if (vec) {
    constexpr int kE = 16 / sizeof(T);
    const int pieces = d / kE;
    for (int i = tid; i < n * pieces; i += threads) {
      const int r = i / pieces, c = (i % pieces) * kE;
      const bool ok = r0 + r < limit;
      cp_async16(dst + r * ld + c, src + (ok ? r0 + r : 0) * st + c, ok);
    }
  } else {
    for (int i = tid; i < n * d; i += threads) {
      const int r = i / d, c = i % d;
      const bool ok = r0 + r < limit;
      copy_elem(dst + r * ld + c, src + (ok ? r0 + r : 0) * st + c, ok);
    }
  }
}

// 4 consecutive elements of a shared row (16-byte aligned in fp32, 8 in
// bfloat16), widened to fp32 exactly
__device__ __forceinline__ void load4(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&out)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(v.x << 16);
  out[1] = __uint_as_float(v.x & 0xffff0000u);
  out[2] = __uint_as_float(v.y << 16);
  out[3] = __uint_as_float(v.y & 0xffff0000u);
}
// 2 consecutive elements (8-byte aligned in fp32, 4 in bfloat16)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// shared row strides in elements: the first keeps the two rows that one
// quarter-warp's 16-byte loads read 16 banks apart, the second the four
// rows of an 8-byte load 8 banks apart (fp32)
template <typename T, int DP>
__host__ __device__ constexpr int k_stride() {
  return DP + 16 / int(sizeof(T));
}
template <typename T, int DP>
__host__ __device__ constexpr int v_stride() {
  return DP + 32 / int(sizeof(T));
}

// a warp's 16 rows r .. r + 15 of a (position, head_dim) operand as fp32
// A fragments, straight from global memory: x[j][hr][e] = row r + g + 8 hr,
// dim 16 j + 4 t + e (zero past `limit` rows or d dims); k-step 2j takes
// e = 0, 1 and k-step 2j + 1 e = 2, 3 (see mma_tf32.cuh's fragments)
template <typename T, int NC>
__device__ __forceinline__ void load_frag_rows(float (&x)[NC][2][4],
                                               const T* base,
                                               long long row_stride, int r,
                                               int limit, int d, int g,
                                               int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r + g + 8 * hr;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * j + 4 * t + e;
        x[j][hr][e] = row < limit && c < d
                          ? to_f32(base[row * row_stride + c])
                          : 0.0f;
      }
  }
}

}  // namespace
