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
// head_dim <= 128 (padded with zeros to a multiple of 16 on chip).
//
// Bound: at the model's lengths (s >= 512, d = 64) the QK^T and PV
// products (4 b h sq sk d flops, about halved when causal) bound it, far
// above the bytes of q, k, v and o.  Design:
// - One block of 4 warps per (b*h, 64-row query tile); each warp owns 16
//   query rows.  Heavier causal tiles (the later query rows) go first.
// - Both products run on the tensor cores (mma.sync m16n8k8 TF32) as
//   3xTF32 (mma_tf32.cuh): a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, never
//   one-pass TF32.  bfloat16 values are exact in TF32: no lo parts.
// - The tensor cores sum with truncation, so long sums into one large
//   accumulator lose bits: the score tile keeps the hi x hi products and
//   the two small ones in separate accumulators, and P V is summed from
//   zero over each 32 keys and added to the fp32 accumulator with an FMA
//   (acc = acc * corr + P V).  That keeps the error against float64
//   within twice that of the CUDA-core kernel this one replaced.
// - The scores, the running max and sum and the fp32 accumulator stay in
//   registers in the mma fragment layout; the row max reduces over the 4
//   lanes of a quad by shuffles, the row sum once at the end.  The
//   softmax runs in base 2 (scores scaled by d^-1/2 log2 e, exp2f).
// - P never leaves the registers: lane g of a score tile's B fragment
//   reads key g / 2 + 4 (g % 2) of each 8-key group, so the score tile's
//   C fragment (columns 2t, 2t + 1) holds keys t and t + 4 -- exactly the
//   A fragment of P V, with V read in its natural key order.
// - head_dim is permuted consistently on both sides of each product so
//   that fragments load as wide words: QK^T's k-slots t and t + 4 of
//   k-steps 2j, 2j + 1 read dims 16j + 4t .. 16j + 4t + 3 (one 16-byte
//   shared load of K per lane; Q stays in registers as loaded), and P V's
//   n-tiles 2i, 2i + 1 read V columns 16i + 2g, 16i + 2g + 1 (one 8-byte
//   load), which puts output columns 16i + 4t .. + 3 in one lane.
// - K/V tiles of 64 keys stream through a two-stage cp.async ring (16-byte
//   copies where d, the strides and the pointers allow, else element
//   copies); the next tile is in flight while the current one computes,
//   one barrier per tile.  A warp takes each tile 32 keys at a time.  Row
//   strides are padded so that the fragment loads of K and V are free of
//   bank conflicts in fp32.
// - Masks cost only on the tiles that need them (the diagonal tile and
//   the ragged last tile); a warp skips the 8-key groups above its own
//   rows on the diagonal, and rows past sq are never stored.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kNT = kBK / 8;      // 8-key groups (score n-tiles) per tile
constexpr int kNH = 4;            // 8-key groups per compute step
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {                  // in elements; head_dim is contiguous
  long long b, s, h;
};

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  int heads, group, sq, sk, d;
  Strides qs, ks, vs, os;
  float sm_scale;
  int causal, vec;                // vec: K/V rows copied 16 bytes at a time
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

// one element of a K/V row into shared memory, zero when !valid: a 4-byte
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

// shared row strides in elements: K's keeps the two keys that one
// quarter-warp's 16-byte loads read 16 banks apart, V's the four key rows
// of an 8-byte load 8 banks apart (fp32)
template <typename T, int DP>
__host__ __device__ constexpr int k_stride() {
  return DP + 16 / int(sizeof(T));
}
template <typename T, int DP>
__host__ __device__ constexpr int v_stride() {
  return DP + 32 / int(sizeof(T));
}
template <typename T, int DP>
__host__ __device__ constexpr size_t stage_elems() {
  return size_t(kBK) * (k_stride<T, DP>() + v_stride<T, DP>());
}
template <typename T, int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * kStages * stage_elems<T, DP>();
}

// NC = padded head_dim / 16
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params<T> P) {
  constexpr int kDP = 16 * NC;
  constexpr int kLK = k_stride<T, kDP>();
  constexpr int kLV = v_stride<T, kDP>();
  constexpr int kND = 2 * NC;     // 8-column n-tiles of the accumulator
  constexpr bool kExact = sizeof(T) == 2;  // bfloat16: no lo parts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / P.heads, h = bh % P.heads, kvh = h / P.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int r0 = q0 + 16 * warp;  // this warp's first query row
  const T* kb = P.k + b * P.ks.b + kvh * P.ks.h;
  const T* vb = P.v + b * P.vs.b + kvh * P.vs.h;

  // keys past the block's last valid query row are masked for every row
  // when causal: those tiles are skipped, the rest of the tail masked
  const int last_row = min(q0 + kBQ, P.sq) - 1;
  const int k_end = P.causal ? min(P.sk, last_row + 1) : P.sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  // the same for this warp's rows (none when they all lie past sq)
  const int w_end = r0 >= P.sq ? 0
                    : P.causal ? min(P.sk, min(r0 + 16, P.sq))
                               : P.sk;

  auto issue = [&](int tile) {    // K/V tile into its ring stage
    T* sk = smem + (tile % kStages) * stage_elems<T, kDP>();
    T* sv = sk + kBK * kLK;
    const int k0 = tile * kBK;
    if (P.vec) {
      constexpr int kE = 16 / sizeof(T);
      const int pieces = P.d / kE;
      for (int i = tid; i < kBK * pieces; i += kThreads) {
        const int r = i / pieces, c = (i % pieces) * kE;
        const bool ok = k0 + r < k_end;
        const long long row = ok ? k0 + r : 0;
        cp_async16(sk + r * kLK + c, kb + row * P.ks.s + c, ok);
        cp_async16(sv + r * kLV + c, vb + row * P.vs.s + c, ok);
      }
    } else {
      for (int i = tid; i < kBK * P.d; i += kThreads) {
        const int r = i / P.d, c = i % P.d;
        const bool ok = k0 + r < k_end;
        const long long row = ok ? k0 + r : 0;
        copy_elem(sk + r * kLK + c, kb + row * P.ks.s + c, ok);
        copy_elem(sv + r * kLV + c, vb + row * P.vs.s + c, ok);
      }
    }
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);

  // head_dim padding of both stages: zero once, never copied over
  if (kDP > P.d) {
    const int pad = kDP - P.d;
    for (int i = tid; i < kStages * kBK * pad; i += kThreads) {
      const int r = i / pad, c = P.d + i % pad;  // r over both stages
      T* sk = smem + (r / kBK) * stage_elems<T, kDP>();
      sk[(r % kBK) * kLK + c] = zero<T>();
      sk[kBK * kLK + (r % kBK) * kLV + c] = zero<T>();
    }
  }

  // Q's A fragments, straight from global memory: row r0 + g (+ 8), dims
  // 16j + 4t .. + 3 (k-step 2j takes the first two, 2j + 1 the last two)
  float qv[NC][2][4];
  {
    const T* qb = P.q + b * P.qs.b + h * P.qs.h;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + g + 8 * hr;
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 16 * j + 4 * t + e;
          qv[j][hr][e] = row < P.sq && c < P.d ? to_f32(qb[row * P.qs.s + c])
                                               : 0.0f;
        }
    }
  }

  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // running max, in base 2
  float l[2] = {0.0f, 0.0f};      // this lane's share of the row sums
  const float scale = P.sm_scale * kLog2e;

  // one K/V tile for this warp's rows, kNH 8-key groups at a time; kEdge:
  // mask the scores and take only the first ntc 8-key groups
  auto attend = [&](const T* sk, const T* sv, int k0, int ntc, auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
    const T* krow = sk + ((g >> 1) + 4 * (g & 1)) * kLK + 4 * t;
    const T* vrow = sv + t * kLV + 2 * g;
#pragma unroll
    for (int n0 = 0; n0 < kNT; n0 += kNH) {
      if (kEdge && n0 >= ntc) break;
      // S = Q K^T: the hi x hi products in s, the two small ones in s_lo
      float s[kNH][4], s_lo[kNH][4];
#pragma unroll
      for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = s_lo[nt][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        // a0..a3 of k-step 2j + ks: rows g, g + 8 at k-slot t, then t + 4
        uint32_t ah[2][4];
        [[maybe_unused]] uint32_t al[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          float av[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) av[e] = qv[j][e & 1][2 * ks + (e >> 1)];
          if constexpr (kExact) {
#pragma unroll
            for (int e = 0; e < 4; ++e) ah[ks][e] = __float_as_uint(av[e]);
          } else {
            split(av, ah[ks], al[ks]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt) {
          if (kEdge && n0 + nt >= ntc) continue;
          float kv[4];
          load4(krow + 8 * (n0 + nt) * kLK + 16 * j, kv);
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const float bv[2] = {kv[2 * ks], kv[2 * ks + 1]};
            if constexpr (kExact) {
              const uint32_t bh[2] = {__float_as_uint(bv[0]),
                                      __float_as_uint(bv[1])};
              mma_tf32(s[nt], ah[ks], bh);
            } else {
              uint32_t bh[2], bl[2];
              split(bv, bh, bl);
              mma_tf32(s_lo[nt], al[ks], bh);
              mma_tf32(s_lo[nt], ah[ks], bl);
              mma_tf32(s[nt], ah[ks], bh);
            }
          }
        }
      }

      // online softmax: c0, c1 are row g's keys t and t + 4 of each group,
      // c2, c3 row g + 8's
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < kNH; ++nt) {
        if (kEdge && n0 + nt >= ntc) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float val = (s[nt][e] + s_lo[nt][e]) * scale;
          if constexpr (kEdge) {
            const int row = r0 + g + 8 * (e >> 1);
            const int key = k0 + 8 * (n0 + nt) + t + 4 * (e & 1);
            if (key >= P.sk || (P.causal && key > row)) val = kNegInf;
          }
          s[nt][e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
        }
      }
      float corr[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        corr[hr] = exp2f(m[hr] - mx[hr]);
        m[hr] = mx[hr];
        l[hr] *= corr[hr];
      }

      // P V of this step from zero, one 8-key group (k-step) at a time;
      // P's A fragment is the score tile's C fragment reordered in the lane
      float pv[kND][4];
#pragma unroll
      for (int n = 0; n < kND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kNH; ++ks) {
        if (kEdge && n0 + ks >= ntc) continue;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(s[ks][e] - m[e >> 1]);
          l[e >> 1] += p[e];
        }
        const float av[4] = {p[0], p[2], p[1], p[3]};
        uint32_t ph[4], pl[4];
        split(av, ph, pl);
        const T* vk = vrow + 8 * (n0 + ks) * kLV;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const float2 v0 = load2(vk + 16 * i);
          const float2 v1 = load2(vk + 4 * kLV + 16 * i);
          const float bv[2][2] = {{v0.x, v1.x}, {v0.y, v1.y}};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float (&d)[4] = pv[2 * i + u];
            if constexpr (kExact) {
              const uint32_t bh[2] = {__float_as_uint(bv[u][0]),
                                      __float_as_uint(bv[u][1])};
              mma_tf32(d, pl, bh);
              mma_tf32(d, ph, bh);
            } else {
              uint32_t bh[2], bl[2];
              split(bv[u], bh, bl);
              mma_tf32(d, pl, bh);
              mma_tf32(d, ph, bl);
              mma_tf32(d, ph, bh);
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = fmaf(acc[n][e], corr[e >> 1], pv[n][e]);
    }
  };

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait_all();
    __syncthreads();              // tile landed; the other stage is free
    if (tile + 1 < n_tiles) issue(tile + 1);
    const int k0 = tile * kBK;
    const int keys = min(kBK, w_end - k0);
    if (keys <= 0) continue;      // every key of the tile masked here
    const int ntc = (keys + 7) / 8;
    const T* sk = smem + (tile % kStages) * stage_elems<T, kDP>();
    const T* sv = sk + kBK * kLK;
    const bool edge = ntc < kNT || k0 + kBK > P.sk ||
                      (P.causal && k0 + kBK - 1 > r0);
    if (edge)
      attend(sk, sv, k0, ntc, std::true_type{});
    else
      attend(sk, sv, k0, kNT, std::false_type{});
  }

  // lanes (g, t) hold output columns 16i + 4t .. + 3 of rows g and g + 8
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int row = r0 + g + 8 * hr;
    if (row >= P.sq) continue;
    const float denom = fmaxf(l[hr], 1e-30f);
    T* orow = P.o + b * P.os.b + row * P.os.s + h * P.os.h;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float val[4] = {acc[2 * i][2 * hr], acc[2 * i + 1][2 * hr],
                            acc[2 * i][2 * hr + 1],
                            acc[2 * i + 1][2 * hr + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * i + 4 * t + e;
        if (c < P.d) store(orow + c, val[e] / denom);
      }
    }
  }
}

bool aligned16(long long x) { return x % 16 == 0; }

template <typename T, int NC>
cudaError_t launch(const Params<T>& P, int batch, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, NC>;
  constexpr size_t smem = smem_bytes<T, 16 * NC>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess)         // as many blocks per SM as fit
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned(batch) * unsigned(P.heads),
                  unsigned((P.sq + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, stream>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int batch, int heads, int group, int sq, int sk, int d,
                     const Strides* st, float sm_scale, int causal,
                     cudaStream_t stream) {
  const long long es = sizeof(T);
  bool vec = aligned16(d * es) &&
             aligned16(reinterpret_cast<uintptr_t>(k)) &&
             aligned16(reinterpret_cast<uintptr_t>(v));
  for (int i = 1; i < 3; ++i)     // k and v: batch, position, head strides
    vec = vec && aligned16(st[i].b * es) && aligned16(st[i].s * es) &&
          aligned16(st[i].h * es);
  const Params<T> P{static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<T*>(o), heads,
                    group, sq, sk, d, st[0], st[1], st[2], st[3], sm_scale,
                    causal, int(vec)};
  switch ((d + 15) / 16) {
#define REPRO_FA_CASE(NC) \
  case NC:                \
    return launch<T, NC>(P, batch, stream);
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
