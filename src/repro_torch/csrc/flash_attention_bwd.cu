// Flash attention backward for Hopper (sm_90a), plain C interface loaded
// with ctypes by repro_torch/kernels/flash_attention/kernel.py.
//
// The JAX package has no backward Pallas kernel: its models differentiate
// the jnp attention of src/repro/models/attention.py (_sdpa).  This kernel
// is the gradient of the port's forward kernel (flash_attention.cu, which
// replaces flash_attention_kernel of src/repro/kernels/flash_attention/
// kernel.py), so that training on the card never differentiates the plain
// version.  With P = softmax(S), S = q k^T d^-1/2 (causal: qpos >= kpos,
// top-left aligned) and o = P v, for an upstream gradient dO:
//   dP = dO v^T,   D = rowsum(P dP) = rowsum(dO o),   dS = P (dP - D)
//   dv = P^T dO,   dk = dS^T q d^-1/2,   dq = dS k d^-1/2
// P is recomputed from the forward's per-row log-sum-exp (fp32 (b, h, sq),
// natural log of the scaled scores) and renormalised here:
//   P~ = exp2(S d^-1/2 log2 e - lse log2 e),   l = rowsum(P~),   P = P~ / l,
// and D is summed from the same P~ and dP: D = rowsum(P~ dP) / l.  l is 1
// up to rounding, but dividing by it cancels any error common to a row
// (the fp32 lse carries ~5e-7 of rounding), and a D consistent with P
// makes each row of dS sum to zero, so the part of k or q common to a row
// cancels from dq and dk.  FlashAttention-2's D = rowsum(dO o) reads the
// forward's o, whose rounding is not P's: with it dq erred 2.2x as much
// against float64 as the kernel this one replaces (PERF.md section 6).
// GQA: query head h reads kv head h / g; dk and dv sum over the g query
// heads of the group.
//
// Layout and types: q, dO (b, sq, h, dk / dv) and k, v (b, sk, m, dk /
// dv) read in place through their batch/position/head strides (head_dim
// contiguous), float32 or bfloat16; dq (b, sq, h, dk) and dk, dv (b, sk,
// m, dk / dv) are written contiguous in the input type; every sum is
// fp32.  Any sq and sk (ragged tiles masked).
//
// Head widths, as the forward's: the score side (dk: Q, K, dq, dk) and
// the value side (dv: V, dO, dv) are separate template widths, each padded
// with zeros to a multiple of 16 on chip (the padding is exact).  dk and
// dv up to 128 run one width for both, the larger (the instances and bits
// of the kernel before the widening); dk up to 192 (MLA's 128 + 64) runs
// at 192 beside dv padded to 128 (MLA's 128) or 192.  Q, dO (launch 1)
// and K, V (launch 2) stay in registers as A fragments at every width; at
// the wide instances the dq, dk and dv products are summed in strips of
// four 16-column pieces of the accumulator (add_az), which keeps the
// step's partial sums to 32 floats a lane, with the same products in the
// same order as one whole-row strip, a tile's steps run as a loop, not
// unrolled, and every tile takes the masked (edge) path,
// whose unmasked elements compute what the unmasked path does: the wide
// instances' code, and their build, a fraction of the size.  Registers
// spill there (ptxas -v:
// chip_smoke.py reports every instance's).
//
// Bound: five s x s x d products (S, dP, dv, dk, dq), about halved when
// causal, far above the bytes of the tensors.  This design does nine (S
// and dP three times: for l and D, for dq, for dk and dv), on the
// forward's machinery (flash_tiles.cuh, mma_tf32.cuh):
// - Every product runs on the tensor cores (mma.sync m16n8k8) as 3xTF32,
//   never one-pass TF32; bfloat16 inputs are exact in TF32 and need no lo
//   parts (P and dS always do).  The tensor cores truncate where they
//   add, so no long sum runs inside them: every hi x hi product is taken
//   from zero and added in fp32 with rounding to nearest, the small
//   products go to accumulators of their own, and each step's dq (8 keys),
//   dk and dv (32 query rows; 16 above head_dim 64) contribution is summed
//   from zero and then added to the fp32 accumulator.  With the tensor
//   cores' own sums, as the forward keeps them, dk missed the gate of
//   twice the plain version's float64 error (PERF.md section 6).
// - Launch 1, l, D and dq (one block of 4 warps per (b, query head,
//   64-row tile), heavy causal tiles first): each warp keeps its 16 query
//   rows of Q and dO in registers as A fragments.  K/V tiles of 64 keys
//   stream through a two-stage cp.async ring, twice: pass 1 sums l and D
//   (written out for launch 2), pass 2 forms dS and dq.  A warp takes 32
//   keys a step (16 above head_dim 64): S = Q K^T and dP = dO V^T with
//   the keys read in the forward's permuted order, so that dS, in the C
//   fragment, is the A fragment of dq += dS K.
// - Launch 2, dk and dv (one block of 4 warps per (b, kv head, 64-key
//   tile), or per (b, query head, 64-key tile) when that many blocks are
//   too few for the card): each warp keeps its 16 keys of K and V in
//   registers and streams 64-row tiles of Q and dO (with their rows' lse,
//   l and D) through the ring, over the g query heads of the group and the
//   query tiles that can see its keys; per 32 query rows (16 above
//   head_dim 64) it forms S^T = K Q^T and dP^T = V dO^T, the query rows
//   read in the permuted order, so that P^T and dS^T in the C fragment
//   are the A fragments of dv += P^T dO and dk += dS^T Q.  dk and dv
//   stay in registers to the block's end.  S^T takes the same products in
//   the same order as launch 1's S, so both launches form the same P bit
//   for bit.
// - Launch 3, only when launch 2 was split over query heads: the g fp32
//   partials of each dk and dv row summed in head order (no atomics: two
//   calls give the same bits).
// - Shared row strides keep the 16-byte fragment loads (the permuted
//   order) free of bank conflicts; the 8-byte loads of the second product
//   of each operand have 2-way conflicts in fp32.
//
// bfloat16 (kRounds) is the gradient of the forward's bfloat16 instance,
// the JAX model's _sdpa, rounded where jax.vjp rounds: S = bf16(bf16(q.k)
// / div) with div = bf16(sqrt dk), P~ = exp(S - lse) in natural base (the
// forward's lse of the rounded scores), P = P~ / l, dP_b = bf16(dO v^T),
// D = rowsum(P~ dP_b) / l, dS = P (dP_b - D), dS_1 = bf16(bf16(dS) /
// div), dv = P_b^T dO with P_b = bf16(P), dq = dS_1 k, dk = dS_1^T q -- no
// final multiply by the scale.  dS_1, P_b, q, k, v and dO are bf16 values,
// exact in TF32: no product needs lo parts.  dk and dv stay summed over
// the group in fp32 (registers, or the fp32 partials) and are rounded
// once.  The float32 instance does not change.
//
// Allocates nothing (l, D and the partials live in scratch the wrapper
// allocates), and returns cudaGetLastError() so the wrapper can raise on a
// refused launch.  The launches run on one stream, in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // resident rows a block: query rows or keys
constexpr int kBN = 64;           // streamed rows a tile: keys or query rows
constexpr int kNT = kBN / 8;      // 8-row groups a tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// the types whose instance rounds where the JAX model rounds (bfloat16)
template <typename T> constexpr bool kRounds = sizeof(T) == 2;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// d += a b with the tensor cores' sum taken from zero and added in fp32
// with rounding to nearest: the tensor cores truncate where they add, and
// a long chain of truncations into one accumulator drifts (see the head
// of this file)
__device__ __forceinline__ void mma_rn(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(t, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;               // (b, h, sq) from the forward
  float* rows;                    // (b, h, sq, 2): l and D, by launch 1
  float* part;                    // (b, h, sk, dk + dv) or null: launch 3
  T* dq;
  T* dk;
  T* dv;
  int heads, kv_heads, group, sq, sk, d, dv_d;   // d: dk, dv_d: dv
  Strides qs, ks, vs, dos;
  float sm_scale;
  float div;                      // bf16(sqrt dk): the rounding instance's
  int causal, vec_kv, vec_qdo;    // 16-byte copies of K/V and of Q/dO rows
};

// the rounding instance's S and dS_1 from their fp32 sums
template <typename T>
__device__ __forceinline__ float rounded_div(float v, const Params<T>& P) {
  return round_bf16(__fdiv_rn(round_bf16(v), P.div));
}

// C (+)= X Y^T for a warp's 16 resident rows and kNH 8-row groups n0 ..
// of a shared tile: X as fp32 A fragments (load_frag_rows), Y read in the
// permuted order -- lane group g reads row g / 2 + 4 (g % 2) of each
// group, dims 16 j + 4 t .. + 3 (yrow points at row (g / 2 + 4 (g % 2)),
// dim 4 t of the tile) -- so that C's columns 2t, 2t + 1 hold the group's
// rows t and t + 4.  The hi x hi products go to c (each from zero, added
// with rounding), the small ones to c_lo, in the forward's order: for Q
// K^T with X = Q (kSwap false) X_lo Y_hi then X_hi Y_lo; for K Q^T with X
// = K (kSwap) X_hi Y_lo then X_lo Y_hi -- the same products in the same
// order, so S^T is bitwise S and both launches form the same P.  kEdge:
// groups from ntc on are skipped.
template <typename T, int NC, int kNH, bool kSwap, bool kEdge>
__device__ __forceinline__ void xyt(const float (&x)[NC][2][4],
                                    const T* yrow, int ld, int n0, int ntc,
                                    float (&c)[kNH][4],
                                    float (&c_lo)[kNH][4]) {
  constexpr bool kExact = sizeof(T) == 2;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    uint32_t ah[2][4];
    [[maybe_unused]] uint32_t al[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      float av[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) av[e] = x[j][e & 1][2 * ks + (e >> 1)];
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
      float yv[4];
      load4(yrow + 8 * (n0 + nt) * ld + 16 * j, yv);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float bv[2] = {yv[2 * ks], yv[2 * ks + 1]};
        if constexpr (kExact) {
          const uint32_t bh[2] = {__float_as_uint(bv[0]),
                                  __float_as_uint(bv[1])};
          mma_rn(c[nt], ah[ks], bh);
        } else {
          uint32_t bh[2], bl[2];
          split(bv, bh, bl);
          if constexpr (kSwap) {
            mma_tf32(c_lo[nt], ah[ks], bl);
            mma_tf32(c_lo[nt], al[ks], bh);
          } else {
            mma_tf32(c_lo[nt], al[ks], bh);
            mma_tf32(c_lo[nt], ah[ks], bl);
          }
          mma_rn(c[nt], ah[ks], bh);
        }
      }
    }
  }
}

// acc[2i + u] += A Z over kNH k-steps, for the strip of kS 16-column
// pieces from piece I0: k-step ks's A is the C fragment a[ks] of a
// product above (columns 2t, 2t + 1: the group's rows t, t + 4)
// reordered {c0, c2, c1, c3}; Z is rows t, t + 4 of group n0 + ks of a
// shared tile in natural order, columns 16 i + 2 g, + 1 (zrow points at
// row t, dim 2 g), so the lane ends up with output dims 16 i + 4 t .. + 3
// of its two rows (n-tiles 2i, 2i + 1).  The sum is taken from zero --
// the hi x hi products (each from zero, added with rounding) apart from
// the small ones -- and added to acc after every k-step (kPerKStep) or
// after all kNH.  kEdge: k-steps from ntc on are skipped.  kAExact: A
// holds bf16 values (the rounding instance's P_b and dS_1), no lo part.
template <typename T, int NW, int I0, int kS, int kNH, bool kEdge,
          bool kPerKStep, bool kAExact>
__device__ __forceinline__ void add_az_strip(const float (&a)[kNH][4],
                                             const T* zrow, int ld, int n0,
                                             int ntc,
                                             float (&acc)[2 * NW][4]) {
  constexpr bool kExact = sizeof(T) == 2;
  float st[2 * kS][4], sl[2 * kS][4];
  auto clear = [&]() {
#pragma unroll
    for (int n = 0; n < 2 * kS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = sl[n][e] = 0.0f;
  };
  auto flush = [&]() {
#pragma unroll
    for (int n = 0; n < 2 * kS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[2 * I0 + n][e] += st[n][e] + sl[n][e];
  };
  clear();
#pragma unroll
  for (int ks = 0; ks < kNH; ++ks) {
    if (kEdge && n0 + ks >= ntc) continue;
    const float av[4] = {a[ks][0], a[ks][2], a[ks][1], a[ks][3]};
    uint32_t ph[4], pl[4];
    split(av, ph, pl);
    const T* zk = zrow + 8 * (n0 + ks) * ld;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const float2 z0 = load2(zk + 16 * (I0 + i));
      const float2 z1 = load2(zk + 4 * ld + 16 * (I0 + i));
      const float bv[2][2] = {{z0.x, z1.x}, {z0.y, z1.y}};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float (&d)[4] = st[2 * i + u];
        float (&dl)[4] = sl[2 * i + u];
        if constexpr (kExact) {
          const uint32_t bh[2] = {__float_as_uint(bv[u][0]),
                                  __float_as_uint(bv[u][1])};
          if constexpr (!kAExact) mma_tf32(dl, pl, bh);
          if constexpr (kPerKStep) mma_tf32(d, ph, bh);
          else mma_rn(d, ph, bh);
        } else {
          uint32_t bh[2], bl[2];
          split(bv[u], bh, bl);
          mma_tf32(dl, pl, bh);
          mma_tf32(dl, ph, bl);
          if constexpr (kPerKStep) mma_tf32(d, ph, bh);
          else mma_rn(d, ph, bh);
        }
      }
    }
    if constexpr (kPerKStep) {
      flush();
      clear();
    }
  }
  if constexpr (!kPerKStep) flush();
}

// add_az_strip over the NW pieces of acc in strips of kS from piece I0
// (one strip, the whole row, up to head_dim 128): each accumulator sees
// the same products in the same order whatever the strips
template <typename T, int NW, int kS, int kNH, bool kEdge, bool kPerKStep,
          bool kAExact = false, int I0 = 0>
__device__ __forceinline__ void add_az(const float (&a)[kNH][4],
                                       const T* zrow, int ld, int n0,
                                       int ntc, float (&acc)[2 * NW][4]) {
  static_assert(NW % kS == 0, "strips of kS pieces tile the row");
  add_az_strip<T, NW, I0, kS, kNH, kEdge, kPerKStep, kAExact>(a, zrow, ld,
                                                              n0, ntc, acc);
  if constexpr (I0 + kS < NW)
    add_az<T, NW, kS, kNH, kEdge, kPerKStep, kAExact, I0 + kS>(a, zrow, ld,
                                                              n0, ntc, acc);
}

// 16-column pieces of an accumulator a strip of add_az walks: the whole
// row up to head_dim 128 (the kernel before the widening), four above;
// above 128 (kWide) a tile's steps also run as a loop, not unrolled, and
// every tile takes the masked (edge) path
template <int NC, int NV, int NW>
constexpr int kStrip = NC <= 8 && NV <= 8 ? NW : 4;


// a warp's accumulator (rows r + g, r + 8 + g; dims 16 i + 4 t .. + 3)
// times `scale` into a contiguous (row, d) output with row stride `ld`,
// rows below `limit`
template <typename T, int NC>
__device__ __forceinline__ void store_acc(const float (&acc)[2 * NC][4],
                                          float scale, T* base, long long ld,
                                          int r, int limit, int d, int g,
                                          int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r + g + 8 * hr;
    if (row >= limit) continue;
    T* out = base + row * ld;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float val[4] = {acc[2 * i][2 * hr], acc[2 * i + 1][2 * hr],
                            acc[2 * i][2 * hr + 1],
                            acc[2 * i + 1][2 * hr + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * i + 4 * t + e;
        if (c < d) store(out + c, val[e] * scale);
      }
    }
  }
}

// a ring stage: a 64-row tile at dk (K, or Q) and one at dv (V, or dO),
// then (launch 2) lse, l and D of 64 rows
template <typename T, int DK, int DV>
__host__ __device__ constexpr size_t stage_bytes(bool rows) {
  return sizeof(T) * kBN * (k_stride<T, DK>() + k_stride<T, DV>()) +
         (rows ? sizeof(float) * 3 * kBN : 0);
}

// head_dim padding of both tiles of every stage: zero once, never copied
// over (the tiles' rows are DK and DV wide, d and dv of them copied); one
// loop over both tiles where the widths are alike, as before the widening
template <typename T, int DK, int DV>
__device__ __forceinline__ void zero_pad(unsigned char* smem, size_t stage,
                                         int d, int dv, int tid) {
  constexpr int kLK = k_stride<T, DK>(), kLV = k_stride<T, DV>();
  if constexpr (DK == DV) {
    if (d == dv) {
      if (DK == d) return;
      const int pad = DK - d;
      for (int i = tid; i < kStages * 2 * kBN * pad; i += kThreads) {
        const int r = i / pad, c = d + i % pad;   // r over both tiles, stages
        T* tile = reinterpret_cast<T*>(smem + (r / (2 * kBN)) * stage);
        tile[(r % (2 * kBN)) * kLK + c] = zero<T>();
      }
      return;
    }
  }
  const int pk = DK - d, pv = DV - dv;
  for (int i = tid; i < kStages * kBN * pk; i += kThreads) {
    const int r = i / pk, c = d + i % pk;     // r over the stages' tiles
    T* tile = reinterpret_cast<T*>(smem + (r / kBN) * stage);
    tile[(r % kBN) * kLK + c] = zero<T>();
  }
  for (int i = tid; i < kStages * kBN * pv; i += kThreads) {
    const int r = i / pv, c = dv + i % pv;
    T* tile = reinterpret_cast<T*>(smem + (r / kBN) * stage) + kBN * kLK;
    tile[(r % kBN) * kLV + c] = zero<T>();
  }
}

// rows [r0, r0 + kBN) of the dk-wide operand (a) and the dv-wide one (b)
// into a stage's two tiles: one loop where the widths are alike
template <typename T>
__device__ __forceinline__ void copy_pair(T* ta, int lda, const T* a,
                                          long long sa, T* tb, int ldb,
                                          const T* b, long long sb, int r0,
                                          int limit, int d, int dv, int vec,
                                          int tid) {
  if (d == dv) {
    copy_rows2(ta, lda, a, sa, tb, ldb, b, sb, r0, kBN, limit, d, vec, tid,
               kThreads);
  } else {
    copy_rows(ta, lda, a, sa, r0, kBN, limit, d, vec, tid, kThreads);
    copy_rows(tb, ldb, b, sb, r0, kBN, limit, dv, vec, tid, kThreads);
  }
}

// l, D and dq of one (b, query head, 64-row tile); NC = padded dk / 16,
// NV = padded dv / 16
template <typename T, int NC, int NV>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params<T> P) {
  constexpr int kDK = 16 * NC, kDV = 16 * NV;
  constexpr int kLK = k_stride<T, kDK>(), kLV = k_stride<T, kDV>();
  constexpr int kNH = NC <= 4 && NV <= 4 ? 4 : 2;   // 8-key groups a step
  constexpr bool kWide = !(NC <= 8 && NV <= 8);   // see kStrip
  constexpr size_t kStage = stage_bytes<T, kDK, kDV>(false);
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / P.heads, h = bh % P.heads, kvh = h / P.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heavy tiles first
  const int r0 = q0 + 16 * warp;
  const T* kb = P.k + b * P.ks.b + kvh * P.ks.h;
  const T* vb = P.v + b * P.vs.b + kvh * P.vs.h;
  const int last_row = min(q0 + kBM, P.sq) - 1;
  const int k_end = P.causal ? min(P.sk, last_row + 1) : P.sk;
  const int n_tiles = (k_end + kBN - 1) / kBN;
  const int w_end = r0 >= P.sq ? 0
                    : P.causal ? min(P.sk, min(r0 + 16, P.sq))
                               : P.sk;

  // the ring walks the key tiles twice: pass 1 (l and D), pass 2 (dq)
  auto issue = [&](int it) {      // K/V tile it % n_tiles into its stage
    T* sk = reinterpret_cast<T*>(smem + (it % kStages) * kStage);
    copy_pair(sk, kLK, kb, P.ks.s, sk + kBN * kLK, kLV, vb, P.vs.s,
              (it % n_tiles) * kBN, k_end, P.d, P.dv_d, P.vec_kv, tid);
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);
  zero_pad<T, kDK, kDV>(smem, kStage, P.d, P.dv_d, tid);

  float qv[NC][2][4], dov[NV][2][4];
  load_frag_rows<T, NC>(qv, P.q + b * P.qs.b + h * P.qs.h, P.qs.s, r0, P.sq,
                        P.d, g, t);
  load_frag_rows<T, NV>(dov, P.dout + b * P.dos.b + h * P.dos.h, P.dos.s,
                        r0, P.sq, P.dv_d, g, t);
  const long long row0 = static_cast<long long>(bh) * P.sq;
  float m2[2], l[2] = {0.0f, 0.0f}, D[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {  // the offset, lse in base 2 (unfused
                                    // multiplies: launch 2 forms the same)
    const int row = r0 + g + 8 * hr;
    const float lse = row < P.sq ? P.lse[row0 + row] : 0.0f;
    m2[hr] = kRounds<T> ? lse : __fmul_rn(lse, kLog2e);  // bf16: natural
  }

  float acc[2 * NC][4];
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const float scale = P.sm_scale * kLog2e;
  const int prow = (g >> 1) + 4 * (g & 1);   // the permuted row of a group

  // one K/V tile for this warp's rows, kNH 8-key groups a step.  Pass 1
  // (kGrad false) adds this lane's P~ and P~ dP to tl and td; pass 2 forms
  // dS = P (dP - D) and adds the step's dS K to acc
  float tl[2], td[2];
  auto attend = [&](const T* sk, const T* sv, int k0, int ntc, auto edge,
                    auto grad) {
    constexpr bool kEdge = decltype(edge)::value;
    constexpr bool kGrad = decltype(grad)::value;
    auto step = [&](int n0) {       // the keys of 8-key groups n0 ..
      float s[kNH][4], s_lo[kNH][4], dp[kNH][4], dp_lo[kNH][4];
#pragma unroll
      for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = s_lo[nt][e] = dp[nt][e] = dp_lo[nt][e] = 0.0f;
      xyt<T, NC, kNH, false, kEdge>(qv, sk + prow * kLK + 4 * t, kLK, n0,
                                    ntc, s, s_lo);
      xyt<T, NV, kNH, false, kEdge>(dov, sv + prow * kLV + 4 * t, kLV, n0,
                                    ntc, dp, dp_lo);
      // c0, c1 are row g's keys t and t + 4 of each group, c2, c3 row
      // g + 8's
#pragma unroll
      for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          bool keep = true;
          if constexpr (kEdge) {
            const int row = r0 + g + 8 * hr;
            const int key = k0 + 8 * (n0 + nt) + t + 4 * (e & 1);
            keep = key < P.sk && !(P.causal && key > row);
          }
          float pt, dpv;
          if constexpr (kRounds<T>) {
            pt = keep ? expf(rounded_div(s[nt][e], P) - m2[hr]) : 0.0f;
            dpv = round_bf16(dp[nt][e]);
          } else {
            pt = keep ? exp2f(__fmul_rn(s[nt][e] + s_lo[nt][e], scale) -
                              m2[hr])
                      : 0.0f;
            dpv = dp[nt][e] + dp_lo[nt][e];
          }
          if constexpr (kGrad) {
            dp[nt][e] = pt / l[hr] * (dpv - D[hr]);
            if constexpr (kRounds<T>) dp[nt][e] = rounded_div(dp[nt][e], P);
          } else {
            tl[hr] += pt;
            td[hr] = fmaf(pt, dpv, td[hr]);
          }
        }
      if constexpr (kGrad)
        add_az<T, NC, kStrip<NC, NV, NC>, kNH, kEdge, true, kRounds<T>>(
            dp, sk + t * kLK + 2 * g, kLK, n0, ntc, acc);
    };
    if constexpr (kWide) {
#pragma unroll 1
      for (int n0 = 0; n0 < kNT; n0 += kNH) {
        if (kEdge && n0 >= ntc) break;
        step(n0);
      }
    } else {
#pragma unroll
      for (int n0 = 0; n0 < kNT; n0 += kNH) {
        if (kEdge && n0 >= ntc) break;
        step(n0);
      }
    }
  };

  for (int it = 0; it < 2 * n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();              // tile landed; the other stage is free
    if (it + 1 < 2 * n_tiles) issue(it + 1);
    const bool grad = it >= n_tiles;
    if (it == n_tiles) {          // pass 1 done: the quad's sums
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
        l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
        D[hr] += __shfl_xor_sync(0xffffffffu, D[hr], 1);
        D[hr] += __shfl_xor_sync(0xffffffffu, D[hr], 2);
        l[hr] = fmaxf(l[hr], 1e-30f);
        D[hr] /= l[hr];
        const int row = r0 + g + 8 * hr;
        if (row < P.sq && t == 0) {
          P.rows[2 * (row0 + row)] = l[hr];
          P.rows[2 * (row0 + row) + 1] = D[hr];
        }
      }
    }
    const int k0 = (it % n_tiles) * kBN;
    const int keys = min(kBN, w_end - k0);
    if (keys <= 0) continue;      // every key of the tile masked here
    const int ntc = (keys + 7) / 8;
    const T* sk = reinterpret_cast<const T*>(smem + (it % kStages) * kStage);
    const T* sv = sk + kBN * kLK;
    const bool edge = ntc < kNT || k0 + kBN > P.sk ||
                      (P.causal && k0 + kBN - 1 > r0);
    if (grad) {
      if (edge || kWide)
        attend(sk, sv, k0, ntc, std::true_type{}, std::true_type{});
      else if constexpr (!kWide)
        attend(sk, sv, k0, kNT, std::false_type{}, std::true_type{});
    } else {                      // each tile's sums from zero, then added
      tl[0] = tl[1] = td[0] = td[1] = 0.0f;
      if (edge || kWide)
        attend(sk, sv, k0, ntc, std::true_type{}, std::false_type{});
      else if constexpr (!kWide)
        attend(sk, sv, k0, kNT, std::false_type{}, std::false_type{});
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        l[hr] += tl[hr];
        D[hr] += td[hr];
      }
    }
  }
  store_acc<T, NC>(acc, kRounds<T> ? 1.0f : P.sm_scale,
                   P.dq + (static_cast<long long>(b) * P.sq * P.heads + h) *
                              P.d,
                   static_cast<long long>(P.heads) * P.d, r0, P.sq, P.d, g,
                   t);
}

// dk and dv of one (b, kv head, 64-key tile) -- or, with P.part, one
// query head's share of them, (b, query head, 64-key tile), as fp32
template <typename T, int NC, int NV>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Params<T> P) {
  constexpr int kDK = 16 * NC, kDV = 16 * NV;
  constexpr int kLK = k_stride<T, kDK>(), kLV = k_stride<T, kDV>();
  constexpr int kNH = NC <= 4 && NV <= 4 ? 4 : 2;   // 8-row groups a step
  constexpr bool kWide = !(NC <= 8 && NV <= 8);   // see kStrip
  constexpr size_t kStage = stage_bytes<T, kDK, kDV>(true);
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool split = P.part != nullptr;
  const int units = split ? P.heads : P.kv_heads;
  const int b = blockIdx.x / units, u = blockIdx.x % units;
  const int kvh = split ? u / P.group : u;
  const int h_first = split ? u : kvh * P.group;
  const int n_heads = split ? 1 : P.group;
  const int k0 = blockIdx.y * kBM;        // heavy causal tiles first
  const int kw = k0 + 16 * warp;          // this warp's first key
  // query rows before k0 see none of these keys when causal (k0 is a
  // multiple of the 64-row tile)
  const int q_first = P.causal ? k0 : 0;
  const int n_qt = q_first < P.sq ? (P.sq - q_first + kBN - 1) / kBN : 0;
  const int n_steps = n_heads * n_qt;

  auto issue = [&](int step) {    // Q/dO tile, with lse, l, D of its rows
    unsigned char* st = smem + (step % kStages) * kStage;
    T* sq_ = reinterpret_cast<T*>(st);
    const int h = h_first + step / n_qt;
    const int q0 = q_first + (step % n_qt) * kBN;
    copy_pair(sq_, kLK, P.q + b * P.qs.b + h * P.qs.h, P.qs.s,
              sq_ + kBN * kLK, kLV, P.dout + b * P.dos.b + h * P.dos.h,
              P.dos.s, q0, P.sq, P.d, P.dv_d, P.vec_qdo, tid);
    float* rows =
        reinterpret_cast<float*>(st + stage_bytes<T, kDK, kDV>(false));
    const long long row0 = (static_cast<long long>(b) * P.heads + h) * P.sq;
    for (int i = tid; i < 3 * kBN; i += kThreads) {
      const int r = i % kBN, what = i / kBN;     // 0: lse, 1: l, 2: D
      const bool ok = q0 + r < P.sq;
      const long long at = row0 + (ok ? q0 + r : 0);
      copy_elem(rows + i, what == 0 ? P.lse + at : P.rows + 2 * at + what - 1,
                ok);
    }
    cp_async_commit();
  };
  if (n_steps > 0) issue(0);
  zero_pad<T, kDK, kDV>(smem, kStage, P.d, P.dv_d, tid);

  float kf[NC][2][4], vf[NV][2][4];
  load_frag_rows<T, NC>(kf, P.k + b * P.ks.b + kvh * P.ks.h, P.ks.s, kw,
                        P.sk, P.d, g, t);
  load_frag_rows<T, NV>(vf, P.v + b * P.vs.b + kvh * P.vs.h, P.vs.s, kw,
                        P.sk, P.dv_d, g, t);
  float dk[2 * NC][4], dv[2 * NV][4];
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < 2 * NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.0f;
  const float scale = P.sm_scale * kLog2e;
  const int prow = (g >> 1) + 4 * (g & 1);

  // one Q/dO tile (query rows q0 ..) for this warp's keys, kNH 8-row
  // groups a step
  auto attend = [&](const T* sq_, const T* sdo, const float* rows, int q0,
                    int n0, auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
    float s[kNH][4], s_lo[kNH][4], dp[kNH][4], dp_lo[kNH][4];
#pragma unroll
    for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = s_lo[nt][e] = dp[nt][e] = dp_lo[nt][e] = 0.0f;
    xyt<T, NC, kNH, true, false>(kf, sq_ + prow * kLK + 4 * t, kLK, n0,
                                 kNT, s, s_lo);
    xyt<T, NV, kNH, false, false>(vf, sdo + prow * kLV + 4 * t, kLV, n0,
                                  kNT, dp, dp_lo);
    // P^T and dS^T in place of s and dp: c0, c1 are key g's query rows t
    // and t + 4 of each group, c2, c3 key g + 8's
#pragma unroll
    for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * (n0 + nt) + t + 4 * (e & 1);   // in the tile
        bool keep = true;
        if constexpr (kEdge) {
          const int key = kw + g + 8 * (e >> 1), row = q0 + qi;
          keep = row < P.sq && !(P.causal && key > row);
        }
        if constexpr (kRounds<T>) {
          const float p =
              keep ? expf(rounded_div(s[nt][e], P) - rows[qi]) /
                         rows[kBN + qi]
                   : 0.0f;
          s[nt][e] = round_bf16(p);
          dp[nt][e] = rounded_div(
              p * (round_bf16(dp[nt][e]) - rows[2 * kBN + qi]), P);
        } else {
          const float p =
              keep ? exp2f(__fmul_rn(s[nt][e] + s_lo[nt][e], scale) -
                           __fmul_rn(rows[qi], kLog2e)) /
                         rows[kBN + qi]
                   : 0.0f;
          s[nt][e] = p;
          dp[nt][e] = p * ((dp[nt][e] + dp_lo[nt][e]) - rows[2 * kBN + qi]);
        }
      }
    add_az<T, NV, kStrip<NC, NV, NV>, kNH, false, false, kRounds<T>>(
        s, sdo + t * kLV + 2 * g, kLV, n0, kNT, dv);
    add_az<T, NC, kStrip<NC, NV, NC>, kNH, false, false, kRounds<T>>(
        dp, sq_ + t * kLK + 2 * g, kLK, n0, kNT, dk);
  };

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait_all();
    __syncthreads();              // tile landed; the other stage is free
    if (step + 1 < n_steps) issue(step + 1);
    const unsigned char* st = smem + (step % kStages) * kStage;
    const T* sq_ = reinterpret_cast<const T*>(st);
    const T* sdo = sq_ + kBN * kLK;
    const float* rows =
        reinterpret_cast<const float*>(st + stage_bytes<T, kDK, kDV>(false));
    const int q0 = q_first + (step % n_qt) * kBN;
    auto group = [&](int n0) {      // the query rows of groups n0 ..
      const int first = q0 + 8 * n0, last = first + 8 * kNH - 1;
      if (P.causal && last < kw) return;      // every row before the keys
      if (kWide || (P.causal && first < kw + 15) || last >= P.sq)
        attend(sq_, sdo, rows, q0, n0, std::true_type{});
      else if constexpr (!kWide)
        attend(sq_, sdo, rows, q0, n0, std::false_type{});
    };
    if constexpr (kWide) {
#pragma unroll 1
      for (int n0 = 0; n0 < kNT; n0 += kNH) group(n0);
    } else {
#pragma unroll
      for (int n0 = 0; n0 < kNT; n0 += kNH) group(n0);
    }
  }

  if (split) {
    // (b, h, sk, dk + dv): this head's dk (unscaled) and dv rows, fp32
    const long long w = P.d + P.dv_d;
    float* base = P.part + static_cast<long long>(blockIdx.x) * P.sk * w;
    store_acc<float, NC>(dk, 1.0f, base, w, kw, P.sk, P.d, g, t);
    store_acc<float, NV>(dv, 1.0f, base + P.d, w, kw, P.sk, P.dv_d, g, t);
  } else {
    const long long row = static_cast<long long>(b) * P.sk * P.kv_heads + kvh;
    store_acc<T, NC>(dk, kRounds<T> ? 1.0f : P.sm_scale, P.dk + row * P.d,
                     static_cast<long long>(P.kv_heads) * P.d, kw, P.sk,
                     P.d, g, t);
    store_acc<T, NV>(dv, 1.0f, P.dv + row * P.dv_d,
                     static_cast<long long>(P.kv_heads) * P.dv_d, kw, P.sk,
                     P.dv_d, g, t);
  }
}

// dk and dv from the g query heads' fp32 partials, summed in head order,
// where dk and dv are alike (the kernel before the widening); one thread
// per output element of (b, sk, m, d)
template <typename T>
__global__ void __launch_bounds__(256) gqa_sum_same_kernel(const Params<T> P,
                                                           long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  const int c = static_cast<int>(i % P.d);
  long long r = i / P.d;
  const int kvh = static_cast<int>(r % P.kv_heads);
  r /= P.kv_heads;
  const int key = static_cast<int>(r % P.sk);
  const long long b = r / P.sk;
  const float* src =
      P.part + (((b * P.heads + kvh * P.group) * P.sk + key) * 2) * P.d + c;
  const long long head = static_cast<long long>(P.sk) * 2 * P.d;
  float dk = 0.0f, dv = 0.0f;
  for (int gi = 0; gi < P.group; ++gi) {
    dk += src[gi * head];
    dv += src[gi * head + P.d];
  }
  store(P.dk + i, kRounds<T> ? dk : dk * P.sm_scale);
  store(P.dv + i, dv);
}

// the same where dk and dv differ: one thread per (b, key, kv head) and
// column up to the wider of dk and dv
template <typename T>
__global__ void __launch_bounds__(256) gqa_sum_kernel(const Params<T> P,
                                                      long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  const int w = max(P.d, P.dv_d);
  const int c = static_cast<int>(i % w);
  const long long row = i / w;      // (b, key, kv head)
  const int kvh = static_cast<int>(row % P.kv_heads);
  const int key = static_cast<int>((row / P.kv_heads) % P.sk);
  const long long b = row / P.kv_heads / P.sk;
  const float* src = P.part + ((b * P.heads + kvh * P.group) * P.sk + key) *
                                  (P.d + P.dv_d);
  const long long head = static_cast<long long>(P.sk) * (P.d + P.dv_d);
  float dk = 0.0f, dv = 0.0f;
  for (int gi = 0; gi < P.group; ++gi) {
    if (c < P.d) dk += src[gi * head + c];
    if (c < P.dv_d) dv += src[gi * head + P.d + c];
  }
  if (c < P.d)
    store(P.dk + row * P.d + c, kRounds<T> ? dk : dk * P.sm_scale);
  if (c < P.dv_d) store(P.dv + row * P.dv_d + c, dv);
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess)         // as many blocks per SM as fit
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  return err;
}

template <typename T, int NC, int NV>
cudaError_t launch(const Params<T>& P, int batch, cudaStream_t stream) {
  constexpr int kDK = 16 * NC, kDV = 16 * NV;
  const size_t dq_bytes = kStages * stage_bytes<T, kDK, kDV>(false);
  cudaError_t err = allow_smem(dq_kernel<T, NC, NV>, dq_bytes);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(unsigned(batch) * unsigned(P.heads),
                     unsigned((P.sq + kBM - 1) / kBM));
  dq_kernel<T, NC, NV><<<dq_grid, kThreads, dq_bytes, stream>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkdv_bytes = kStages * stage_bytes<T, kDK, kDV>(true);
  err = allow_smem(dkdv_kernel<T, NC, NV>, dkdv_bytes);
  if (err != cudaSuccess) return err;
  const unsigned units = P.part != nullptr ? P.heads : P.kv_heads;
  const dim3 dkdv_grid(unsigned(batch) * units,
                       unsigned((P.sk + kBM - 1) / kBM));
  dkdv_kernel<T, NC, NV><<<dkdv_grid, kThreads, dkdv_bytes, stream>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess || P.part == nullptr) return err;

  const long long n = static_cast<long long>(batch) * P.sk * P.kv_heads *
                      (P.d > P.dv_d ? P.d : P.dv_d);
  if (P.d == P.dv_d)
    gqa_sum_same_kernel<T><<<unsigned((n + 255) / 256), 256, 0, stream>>>(P,
                                                                          n);
  else
    gqa_sum_kernel<T><<<unsigned((n + 255) / 256), 256, 0, stream>>>(P, n);
  return cudaGetLastError();
}

bool aligned16(long long x) { return x % 16 == 0; }

// 16-byte copies of two operands' rows: both widths (da, db), both
// pointers and their batch, position and head strides all multiples of 16
// bytes
template <typename T>
bool vec_rows(int da, const void* a, const Strides& sa, int db,
              const void* b, const Strides& sb) {
  const long long es = sizeof(T);
  return aligned16(da * es) && aligned16(db * es) &&
         aligned16(reinterpret_cast<uintptr_t>(a)) &&
         aligned16(reinterpret_cast<uintptr_t>(b)) && aligned16(sa.b * es) &&
         aligned16(sa.s * es) && aligned16(sa.h * es) &&
         aligned16(sb.b * es) && aligned16(sb.s * es) && aligned16(sb.h * es);
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, float* rows, float* part,
                void* dq, void* dk, void* dv, int batch, int heads,
                int kv_heads, int sq, int sk, int d, int dv_d,
                const Strides* st, float sm_scale, float div, int causal,
                cudaStream_t stream) {
  const Params<T> P{static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<const T*>(dout),
                    lse, rows, part, static_cast<T*>(dq),
                    static_cast<T*>(dk), static_cast<T*>(dv), heads,
                    kv_heads, heads / kv_heads, sq, sk, d, dv_d, st[0],
                    st[1], st[2], st[3], sm_scale, div, causal,
                    int(vec_rows<T>(d, k, st[1], dv_d, v, st[2])),
                    int(vec_rows<T>(d, q, st[0], dv_d, dout, st[3]))};
  const int nc = (d + 15) / 16, nv = (dv_d + 15) / 16;
  switch (nc > 8 || nv > 8 ? 0 : nc > nv ? nc : nv) {
#define REPRO_FAB_CASE(N) \
  case N:                 \
    return launch<T, N, N>(P, batch, stream);
    REPRO_FAB_CASE(1)
    REPRO_FAB_CASE(2)
    REPRO_FAB_CASE(3)
    REPRO_FAB_CASE(4)
    REPRO_FAB_CASE(5)
    REPRO_FAB_CASE(6)
    REPRO_FAB_CASE(7)
    REPRO_FAB_CASE(8)
#undef REPRO_FAB_CASE
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
// v's and dout's, each in [1, 192].  strides: 12 host integers, the
// (batch, position, head) strides in elements of q, k, v and dout.  lse:
// fp32 (b, h, sq) from the forward; rows: fp32 (b, h, sq, 2) scratch;
// part: fp32 (b, h, sk, dk + dv) scratch, or null -- with it the dk/dv
// launch runs one block per query head and a third launch sums the
// group's partials; dq (b, sq, h, dk), dk (b, sk, m, dk) and dv (b, sk, m,
// dv) contiguous.  sm_scale: dk^-1/2, the float32 instance's; div:
// bf16(sqrt dk), the rounding (bfloat16) instance's.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* rows, float* part, void* dq, void* dk,
    void* dv, int dtype, int batch, int heads, int kv_heads, int sq, int sk,
    int d, int dv_d, const long long* strides, float sm_scale, float div,
    int causal, cudaStream_t stream) {
  if (d < 1 || d > 192 || dv_d < 1 || dv_d > 192 || kv_heads < 1 ||
      heads % kv_heads != 0 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * heads == 0 || sq == 0)
    return static_cast<int>(cudaGetLastError());
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaError_t err =
      dtype == 0
          ? run<float>(q, k, v, dout, lse, rows, part, dq, dk, dv, batch,
                       heads, kv_heads, sq, sk, d, dv_d, st, sm_scale, div,
                       causal, stream)
      : dtype == 1
          ? run<__nv_bfloat16>(q, k, v, dout, lse, rows, part, dq, dk, dv,
                               batch, heads, kv_heads, sq, sk, d, dv_d, st,
                               sm_scale, div, causal, stream)
          : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
