// Tensor-core and copy helpers shared by the port's Hopper kernels
// (ssd_scan.cu, flash_attention.cu): fp32-accurate matrix products as
// 3xTF32 on mma.sync m16n8k8, and 16-byte cp.async copies into shared
// memory.

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}
__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_wait_group<0>();
}

// ---- 3xTF32 on mma.sync m16n8k8 ----
// Fragments (lane = 4 g + t): A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B b0 (k t, n g), b1 (k t + 4, n g); C/D c0 (g, 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// hi: v rounded to TF32's 10 mantissa bits (to nearest, by integer ops);
// lo = v - hi, exact in fp32 and below 2^-11 |v|, of which the tensor
// cores read the top 10 mantissa bits: a_lo b_lo and the bits dropped from
// lo are each under 2^-22 |a b|.
template <int N>
__device__ __forceinline__ void split(const float (&v)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = (__float_as_uint(v[i]) + 0x1000u) & 0xffffe000u;
    lo[i] = __float_as_uint(v[i] - __uint_as_float(hi[i]));
  }
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// 3xTF32 over a warp's MI x NJ accumulator tiles for one k-step: d[i][j]
// += a[i] b[j] to fp32-level accuracy, the small products first.  Each
// pass walks every tile before the next pass, so consecutive mma.sync
// feed independent accumulators.
template <int MI, int NJ>
__device__ __forceinline__ void mma3(float (&d)[MI][NJ][4],
                                     const uint32_t (&ah)[MI][4],
                                     const uint32_t (&al)[MI][4],
                                     const uint32_t (&bh)[NJ][2],
                                     const uint32_t (&bl)[NJ][2], int mi_lo,
                                     int mi_hi, int nj) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (i >= mi_lo && i < mi_hi && j < nj)
          mma_tf32(d[i][j], pass == 0 ? al[i] : ah[i],
                   pass == 1 ? bl[j] : bh[j]);
}

}  // namespace
