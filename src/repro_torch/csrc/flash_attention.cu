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
// Layout: q (b, sq, h, dk), k (b, sk, m, dk) and v (b, sk, m, dv) read in
// place through their batch/position/head strides (head_dim contiguous);
// query head h reads kv head h / g with g = h_total / m, the mapping of
// _sdpa's reshape(b, s, m, g, d) and of the Pallas wrapper's jnp.repeat --
// but with no repeat copy and no transpose copy.  o is (b, sq, h, dv).
// Types: float32 or bfloat16 in and out, fp32 arithmetic inside.
//
// Head widths: the score side (dk, Q and K) and the value side (dv, V and
// the accumulator) are separate template widths, each padded with zeros to
// a multiple of 16 on chip (zeros add nothing to a product: the padding is
// exact).  dk and dv up to 128 run one width for both sides, the larger;
// dk up to 192 (MLA's 128 + 64) runs at 192 beside dv padded to 128 (MLA's
// 128) or 192.  Q's fragments stay in registers (96 floats a lane at dk
// 192), so at those widths P V is walked in strips of kStrip 16-column
// pieces of the accumulator, each strip summed from zero over the step's
// keys (32 floats of partial sums a lane instead of 2 dv / 16 x 4); up to
// 128 one strip is the whole row.  Every accumulator sees the same
// products in the same order whatever the strips.
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
// With a non-null lse pointer the kernel also writes each row's natural
// log-sum-exp of the scaled scores, (m + log2 l) ln 2, as fp32 (b, h, sq):
// the offset the backward kernel (flash_attention_bwd.cu) recomputes P
// from.  A null pointer (the serving path) skips that store.
//
// bfloat16 rounds where the JAX model's _sdpa rounds (kRounds): the scores
// S = bf16(bf16(q.k) / bf16(sqrt d)) (the divisor comes from the wrapper,
// the division is fp32 and rounded to nearest), masked to -1e30 after the
// rounding, P = exp(S - max) / sum in fp32, P_b = bf16(P), o = bf16(P_b V)
// summed in fp32.  A one-pass online softmax cannot round normalised
// probabilities, so the bf16 instance (rounded_kernel) walks the key tiles
// twice through the same ring: pass 1 keeps each row's max m and sum l of
// exp(S - m) (online, in natural base), pass 2 recomputes S bit for bit,
// rounds P = exp(S - m) / l to bf16 and adds P_b V to the fp32 accumulator
// with no rescaling.  q, k and P_b are bf16 values, exact in TF32: every
// product is one mma.sync pass.  Its lse is m + ln l of the rounded
// scores.  The float32 instance is the kernel above, unchanged.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kNT = kBK / 8;      // 8-key groups (score n-tiles) per tile
constexpr int kNH = 4;            // 8-key groups per compute step
constexpr int kStages = 2;
// 16-column pieces of P V summed per strip: the whole row up to a head
// width of 128, four pieces (8 accumulators in flight) above it
template <int NC, int NV>
constexpr int kStrip = NC <= 8 && NV <= 8 ? NV : 4;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the types whose instance rounds where the JAX model rounds (bfloat16)
template <typename T> constexpr bool kRounds = sizeof(T) == 2;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  float* lse;                     // (b, h, sq) or null
  int heads, group, sq, sk, d;    // d: q's and k's head_dim (dk)
  int dv;                         // v's and o's
  Strides qs, ks, vs, os;
  float sm_scale;
  float div;                      // bf16(sqrt d): the rounding instance's
  int causal, vec;                // vec: K/V rows copied 16 bytes at a time
};

template <typename T, int DK, int DV>
__host__ __device__ constexpr size_t stage_elems() {
  return size_t(kBK) * (k_stride<T, DK>() + v_stride<T, DV>());
}
template <typename T, int DK, int DV>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * kStages * stage_elems<T, DK, DV>();
}

// K's and V's rows [r0, r0 + kBK) of one ring stage (zeros from `limit`
// on); commits nothing
template <typename T, int DK, int DV>
__device__ __forceinline__ void copy_kv(T* sk, const T* kb, const T* vb,
                                        const Params<T>& P, int r0, int limit,
                                        int tid) {
  constexpr int kLK = k_stride<T, DK>(), kLV = v_stride<T, DV>();
  if (P.d == P.dv) {              // one loop over both operands' rows
    copy_rows2(sk, kLK, kb, P.ks.s, sk + kBK * kLK, kLV, vb, P.vs.s, r0, kBK,
               limit, P.d, P.vec, tid, kThreads);
  } else {
    copy_rows(sk, kLK, kb, P.ks.s, r0, kBK, limit, P.d, P.vec, tid, kThreads);
    copy_rows(sk + kBK * kLK, kLV, vb, P.vs.s, r0, kBK, limit, P.dv, P.vec,
              tid, kThreads);
  }
}

// the head_dim padding of both stages' K and V rows: zeroed once, never
// copied over
template <typename T, int DK, int DV>
__device__ __forceinline__ void zero_padding(T* smem, const Params<T>& P,
                                             int tid) {
  constexpr int kLK = k_stride<T, DK>(), kLV = v_stride<T, DV>();
  for (int i = tid; i < kStages * kBK * (DK - P.d); i += kThreads) {
    const int r = i / (DK - P.d), c = P.d + i % (DK - P.d);
    smem[(r / kBK) * stage_elems<T, DK, DV>() + (r % kBK) * kLK + c] =
        zero<T>();
  }
  for (int i = tid; i < kStages * kBK * (DV - P.dv); i += kThreads) {
    const int r = i / (DV - P.dv), c = P.dv + i % (DV - P.dv);
    smem[(r / kBK) * stage_elems<T, DK, DV>() + kBK * kLK + (r % kBK) * kLV +
         c] = zero<T>();
  }
}

// NC = padded dk / 16, NV = padded dv / 16
template <typename T, int NC, int NV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params<T> P) {
  constexpr int kDK = 16 * NC, kDV = 16 * NV;
  constexpr int kLK = k_stride<T, kDK>();
  constexpr int kLV = v_stride<T, kDV>();
  constexpr int kND = 2 * NV;     // 8-column n-tiles of the accumulator
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
    copy_kv<T, kDK, kDV>(smem + (tile % kStages) * stage_elems<T, kDK, kDV>(),
                         kb, vb, P, tile * kBK, k_end, tid);
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);
  zero_padding<T, kDK, kDV>(smem, P, tid);

  // Q's A fragments, straight from global memory: row r0 + g (+ 8), dims
  // 16j + 4t .. + 3 (k-step 2j takes the first two, 2j + 1 the last two)
  float qv[NC][2][4];
  load_frag_rows<T, NC>(qv, P.q + b * P.qs.b + h * P.qs.h, P.qs.s, r0, P.sq,
                        P.d, g, t);

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

      // P V of this step from zero, one 8-key group (k-step) at a time,
      // kStrip 16-column pieces of the accumulator per strip; P's A
      // fragments (the score tile's C fragments reordered in the lane) are
      // made in the first strip and kept for the others
      uint32_t ph[kNH][4], pl[kNH][4];
#pragma unroll
      for (int i0 = 0; i0 < NV; i0 += kStrip<NC, NV>) {
        float pv[2 * kStrip<NC, NV>][4];
#pragma unroll
        for (int n = 0; n < 2 * kStrip<NC, NV>; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kNH; ++ks) {
          if (kEdge && n0 + ks >= ntc) continue;
          if (i0 == 0) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              p[e] = exp2f(s[ks][e] - m[e >> 1]);
              l[e >> 1] += p[e];
            }
            const float av[4] = {p[0], p[2], p[1], p[3]};
            split(av, ph[ks], pl[ks]);
          }
          const T* vk = vrow + 8 * (n0 + ks) * kLV;
#pragma unroll
          for (int i = 0; i < kStrip<NC, NV>; ++i) {
            if (i0 + i >= NV) break;
            const float2 v0 = load2(vk + 16 * (i0 + i));
            const float2 v1 = load2(vk + 4 * kLV + 16 * (i0 + i));
            const float bv[2][2] = {{v0.x, v1.x}, {v0.y, v1.y}};
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float (&d)[4] = pv[2 * i + u];
              if constexpr (kExact) {
                const uint32_t bh[2] = {__float_as_uint(bv[u][0]),
                                        __float_as_uint(bv[u][1])};
                mma_tf32(d, pl[ks], bh);
                mma_tf32(d, ph[ks], bh);
              } else {
                uint32_t bh[2], bl[2];
                split(bv[u], bh, bl);
                mma_tf32(d, pl[ks], bh);
                mma_tf32(d, ph[ks], bl);
                mma_tf32(d, ph[ks], bh);
              }
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 2 * kStrip<NC, NV>; ++n) {
          if (2 * i0 + n >= kND) break;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[2 * i0 + n][e] = fmaf(acc[2 * i0 + n][e], corr[e >> 1],
                                      pv[n][e]);
        }
      }
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
    const T* sk = smem + (tile % kStages) * stage_elems<T, kDK, kDV>();
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
    if (P.lse != nullptr && t == 0)
      P.lse[static_cast<long long>(bh) * P.sq + row] =
          (m[hr] + log2f(denom)) * kLn2;
    T* orow = P.o + b * P.os.b + row * P.os.s + h * P.os.h;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float val[4] = {acc[2 * i][2 * hr], acc[2 * i + 1][2 * hr],
                            acc[2 * i][2 * hr + 1],
                            acc[2 * i + 1][2 * hr + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * i + 4 * t + e;
        if (c < P.dv) store(orow + c, val[e] / denom);
      }
    }
  }
}

// the bfloat16 instance: two passes over the key tiles (see the head of
// this file); NC = padded dk / 16, NV = padded dv / 16
template <typename T, int NC, int NV>
__global__ void __launch_bounds__(kThreads)
rounded_kernel(const Params<T> P) {
  constexpr int kDK = 16 * NC, kDV = 16 * NV;
  constexpr int kLK = k_stride<T, kDK>();
  constexpr int kLV = v_stride<T, kDV>();
  constexpr int kND = 2 * NV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / P.heads, h = bh % P.heads, kvh = h / P.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int r0 = q0 + 16 * warp;
  const T* kb = P.k + b * P.ks.b + kvh * P.ks.h;
  const T* vb = P.v + b * P.vs.b + kvh * P.vs.h;
  const int last_row = min(q0 + kBQ, P.sq) - 1;
  const int k_end = P.causal ? min(P.sk, last_row + 1) : P.sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  const int w_end = r0 >= P.sq ? 0
                    : P.causal ? min(P.sk, min(r0 + 16, P.sq))
                               : P.sk;

  auto issue = [&](int it) {      // K/V tile it % n_tiles into its stage
    copy_kv<T, kDK, kDV>(smem + (it % kStages) * stage_elems<T, kDK, kDV>(),
                         kb, vb, P, (it % n_tiles) * kBK, k_end, tid);
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);
  zero_padding<T, kDK, kDV>(smem, P, tid);
  float qv[NC][2][4];
  load_frag_rows<T, NC>(qv, P.q + b * P.qs.b + h * P.qs.h, P.qs.s, r0, P.sq,
                        P.d, g, t);
  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // each row's max, natural base
  float l[2] = {0.0f, 0.0f};      // this lane's share of the row sums

  // the rounded, masked scores of kNH 8-key groups from n0 (the forward's
  // permuted key order: c0, c1 are row g's keys t and t + 4 of a group,
  // c2, c3 row g + 8's); groups from ntc on are masked (kEdge)
  auto scores = [&](const T* sk, int k0, int n0, int ntc,
                    float (&s)[kNH][4], auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
    const T* krow = sk + ((g >> 1) + 4 * (g & 1)) * kLK + 4 * t;
#pragma unroll
    for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      uint32_t ah[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ah[ks][e] = __float_as_uint(qv[j][e & 1][2 * ks + (e >> 1)]);
#pragma unroll
      for (int nt = 0; nt < kNH; ++nt) {
        if (kEdge && n0 + nt >= ntc) continue;
        float kv[4];
        load4(krow + 8 * (n0 + nt) * kLK + 16 * j, kv);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const uint32_t bh[2] = {__float_as_uint(kv[2 * ks]),
                                  __float_as_uint(kv[2 * ks + 1])};
          mma_tf32(s[nt], ah[ks], bh);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = round_bf16(__fdiv_rn(round_bf16(s[nt][e]), P.div));
        if constexpr (kEdge) {
          const int row = r0 + g + 8 * (e >> 1);
          const int key = k0 + 8 * (n0 + nt) + t + 4 * (e & 1);
          if (n0 + nt >= ntc || key >= P.sk || (P.causal && key > row))
            val = kNegInf;
        }
        s[nt][e] = val;
      }
  };

  // pass 1 (kSecond false): the online max and sum; pass 2: P_b V
  auto attend = [&](const T* sk, const T* sv, int k0, int ntc, auto edge,
                    auto second) {
    constexpr bool kEdge = decltype(edge)::value;
    constexpr bool kSecond = decltype(second)::value;
    const T* vrow = sv + t * kLV + 2 * g;
#pragma unroll
    for (int n0 = 0; n0 < kNT; n0 += kNH) {
      if (kEdge && n0 >= ntc) break;
      float s[kNH][4];
      scores(sk, k0, n0, ntc, s, edge);
      if constexpr (!kSecond) {
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
          mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
          l[hr] *= expf(m[hr] - mx[hr]);
          m[hr] = mx[hr];
        }
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (s[nt][e] != kNegInf) l[e >> 1] += expf(s[nt][e] - m[e >> 1]);
      } else {
        // P_b V from zero, kStrip 16-column pieces per strip, P_b's A
        // fragments made in the first strip
        uint32_t pa[kNH][4];
#pragma unroll
        for (int i0 = 0; i0 < NV; i0 += kStrip<NC, NV>) {
          float pv[2 * kStrip<NC, NV>][4];
#pragma unroll
          for (int n = 0; n < 2 * kStrip<NC, NV>; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pv[n][e] = 0.0f;
#pragma unroll
          for (int ks = 0; ks < kNH; ++ks) {
            if (kEdge && n0 + ks >= ntc) continue;
            if (i0 == 0) {
              float p[4];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                p[e] = s[ks][e] == kNegInf
                           ? 0.0f
                           : round_bf16(__fdiv_rn(expf(s[ks][e] - m[e >> 1]),
                                                  l[e >> 1]));
              pa[ks][0] = __float_as_uint(p[0]);
              pa[ks][1] = __float_as_uint(p[2]);
              pa[ks][2] = __float_as_uint(p[1]);
              pa[ks][3] = __float_as_uint(p[3]);
            }
            const T* vk = vrow + 8 * (n0 + ks) * kLV;
#pragma unroll
            for (int i = 0; i < kStrip<NC, NV>; ++i) {
              if (i0 + i >= NV) break;
              const float2 v0 = load2(vk + 16 * (i0 + i));
              const float2 v1 = load2(vk + 4 * kLV + 16 * (i0 + i));
              const uint32_t b0[2] = {__float_as_uint(v0.x),
                                      __float_as_uint(v1.x)};
              const uint32_t b1[2] = {__float_as_uint(v0.y),
                                      __float_as_uint(v1.y)};
              mma_tf32(pv[2 * i], pa[ks], b0);
              mma_tf32(pv[2 * i + 1], pa[ks], b1);
            }
          }
#pragma unroll
          for (int n = 0; n < 2 * kStrip<NC, NV>; ++n) {
            if (2 * i0 + n >= kND) break;
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[2 * i0 + n][e] += pv[n][e];
          }
        }
      }
    }
  };

  for (int it = 0; it < 2 * n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();              // tile landed; the other stage is free
    if (it + 1 < 2 * n_tiles) issue(it + 1);
    if (it == n_tiles) {          // pass 1 done: the quad's sums
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
        l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
        l[hr] = fmaxf(l[hr], 1e-30f);
      }
    }
    const int k0 = (it % n_tiles) * kBK;
    const int keys = min(kBK, w_end - k0);
    if (keys <= 0) continue;      // every key of the tile masked here
    const int ntc = (keys + 7) / 8;
    const T* sk = smem + (it % kStages) * stage_elems<T, kDK, kDV>();
    const T* sv = sk + kBK * kLK;
    const bool edge = ntc < kNT || k0 + kBK > P.sk ||
                      (P.causal && k0 + kBK - 1 > r0);
    if (it >= n_tiles) {
      if (edge)
        attend(sk, sv, k0, ntc, std::true_type{}, std::true_type{});
      else
        attend(sk, sv, k0, kNT, std::false_type{}, std::true_type{});
    } else {
      if (edge)
        attend(sk, sv, k0, ntc, std::true_type{}, std::false_type{});
      else
        attend(sk, sv, k0, kNT, std::false_type{}, std::false_type{});
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    if (row >= P.sq) continue;
    if (P.lse != nullptr && t == 0)
      P.lse[static_cast<long long>(bh) * P.sq + row] = m[hr] + logf(l[hr]);
    T* orow = P.o + b * P.os.b + row * P.os.s + h * P.os.h;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float val[4] = {acc[2 * i][2 * hr], acc[2 * i + 1][2 * hr],
                            acc[2 * i][2 * hr + 1],
                            acc[2 * i + 1][2 * hr + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * i + 4 * t + e;
        if (c < P.dv) store(orow + c, val[e]);
      }
    }
  }
}

bool aligned16(long long x) { return x % 16 == 0; }

template <typename T, int NC, int NV>
cudaError_t launch(const Params<T>& P, int batch, cudaStream_t stream) {
  auto kern = [] {
    if constexpr (kRounds<T>) return rounded_kernel<T, NC, NV>;
    else return flash_attention_kernel<T, NC, NV>;
  }();
  constexpr size_t smem = smem_bytes<T, 16 * NC, 16 * NV>();
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
                     float* lse, int batch, int heads, int group, int sq,
                     int sk, int d, int dv,
                     const Strides* st, float sm_scale, float div,
                     int causal, cudaStream_t stream) {
  const long long es = sizeof(T);
  bool vec = aligned16(d * es) && aligned16(dv * es) &&
             aligned16(reinterpret_cast<uintptr_t>(k)) &&
             aligned16(reinterpret_cast<uintptr_t>(v));
  for (int i = 1; i < 3; ++i)     // k and v: batch, position, head strides
    vec = vec && aligned16(st[i].b * es) && aligned16(st[i].s * es) &&
          aligned16(st[i].h * es);
  const Params<T> P{static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<T*>(o), lse,
                    heads, group, sq, sk, d, dv, st[0], st[1], st[2], st[3],
                    sm_scale, div, causal, int(vec)};
  const int nc = (d + 15) / 16, nv = (dv + 15) / 16;
  switch (nc > 8 || nv > 8 ? 0 : nc > nv ? nc : nv) {
#define REPRO_FA_CASE(N) \
  case N:                \
    return launch<T, N, N>(P, batch, stream);
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
      break;
  }
  // a head_dim above 128: dk at 192, dv at 128 (MLA) or 192
  if (nc <= 12 && nv <= 8) return launch<T, 12, 8>(P, batch, stream);
  if (nc <= 12 && nv <= 12) return launch<T, 12, 12>(P, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  d: q's and k's head_dim (dk), dv:
// v's and o's, each in [1, 192].  strides: 12 host integers, the (batch,
// position, head) strides in elements of q, k, v and o.  lse: fp32 (b, h,
// sq) contiguous, or null.  sm_scale: dk^-1/2, the float32 instance's;
// div: bf16(sqrt dk), the rounding (bfloat16) instance's.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int dtype,
                                      int batch, int heads, int kv_heads,
                                      int sq, int sk, int d, int dv,
                                      const long long* strides,
                                      float sm_scale, float div, int causal,
                                      cudaStream_t stream) {
  if (d < 1 || d > 192 || dv < 1 || dv > 192 || kv_heads < 1 ||
      heads % kv_heads != 0 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * heads == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int group = heads / kv_heads;
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(q, k, v, o, lse, batch, heads, group, sq, sk, d,
                            dv, st, sm_scale, div, causal, stream)
      : dtype == 1
          ? dispatch<__nv_bfloat16>(q, k, v, o, lse, batch, heads, group,
                                    sq, sk, d, dv, st, sm_scale, div, causal,
                                    stream)
          : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
