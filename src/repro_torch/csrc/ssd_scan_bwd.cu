// Gradient of the Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C
// interface loaded with ctypes by repro_torch/kernels/ssd_scan/kernel.py.
//
// The JAX package has no backward kernel: its models differentiate the jnp
// scan (src/repro/models/ssm.py ssd_scan) with autograd.  This kernel
// computes that gradient for the forward of ssd_scan.cu, as the closed form
// repro_torch/kernels/ssd_scan/ref.py ssd_scan_chunked_bwd states it.  From
// the cotangents dy (b, s, h, p) of y and dS (b, h, p, n) of the final
// state it gives dx, ddt, dA (per position: dA = sum dda dt is taken in
// torch), dB, dC and the initial state's gradient.  Per chunk of kL = 64
// positions (cum = inclusive cumsum of dt A, l the chunk's last position,
// W = exp(cum_l - cum), e = exp(cum), L[t,m] = exp(cum_t - cum_m), m <= t):
//   G_c  = dS for the last chunk, G_{c-1} = exp(cum_l) G_c + sum_t e_t dy_t
//          C_t^T (the gradient of each chunk's final state, backwards);
//   dxc  = M^T dy + W (B G^T),  M = C B^T o L;   dM = dy xc^T (m <= t);
//   dB   = W xc G + (dM o L)^T C;   dC = e (dy S_prev) + (dM o L) B;
//   dda_t = sum_{t' >= t > m} dM C B^T o L + sum_{t' < t} dW W
//           + sum_{t' >= t} de e + d exp(cum_l) exp(cum_l)
// with dW = sum_p xc (B G^T), de = sum_n C (dy S_prev), d exp(cum_l) =
// sum G o S_prev; then dx = dxc dt, ddt = dda A + sum_p dxc x.  B and C
// are shared by the heads, so (dM o L)^T C and (dM o L) B are taken once
// per (b, chunk) from their sum over the heads.
//
// Precision.  cum, L, W, e and exp(cum_l) are float64 (64 values and one
// 64 x 64 triangle per (b, chunk, head)) and rounded once to fp32: the
// fp32 cumsum's rounding, which the plain backward inherits, is what
// decides its float64 error in ddt (exp of differences of fp32 sums near
// -100).  Every product runs on the tensor cores (mma.sync m16n8k8) on
// a hi + lo split of each fp32 operand, both parts rounded to TF32 to
// nearest (split_rn), with the four products hi hi, hi lo, lo hi, lo lo
// -- an operand rounded to bf16 takes no lo part; each k-step's hi x hi
// product is summed from zero and added in fp32 with rounding to nearest
// (the tensor cores truncate where they add), the small products in
// accumulators of their own.  mma_tf32.cuh's 3xTF32 (lo truncated by the
// tensor cores, lo lo dropped) erred up to 2.7x as much as the CUDA-core
// kernel this one replaced against float64 gradients.  The exception is
// launch 6's two products per (b, chunk) (see there), on the CUDA cores.  The sums of dW, de, dda
// and ddt are float64 from fp32 products; the segment sums of dda run as
// a scan over the chunk's row and column sums of the strictly lower
// triangle of dM C B^T o L, in float64.
// bfloat16 inputs: autograd of the forward's rounding points rounds the
// cotangents flowing back through them, and so does this kernel: dxc,
// dB, dC, dM and dW are rounded to bfloat16 (nearest even) where the plain
// version rounds them; M and W are recomputed rounded, as the forward
// rounds them.  Those points are the model's only where it takes one chunk
// (s <= 64; see ssd_scan.cu).
//
// Bound: about 36 p n + 6 kL (p + n) flops per (batch, head, position)
// (the products above) -- operations at the model's widths.  Design, for
// the training path's one chunk first: launches on the caller's stream,
// every one of 4 warps, each warp 16 rows of a 64-row tile in the mma
// fragments' layout, operands read from fp32 tiles in shared memory:
//   1. state  -- per (b, chunk, head), with several chunks or an initial
//                state: sum_t e_t dy_t C_t^T and exp(cum_l);
//   2. pass   -- per (b, head) and element of the state: G_c backwards
//                over the chunks, the initial state's gradient;
//   3. terms  -- per (b, chunk, head), where the chunk has an entering
//                state or a state gradient: the terms of S_prev and G (Z =
//                dy S_prev^T, de, e Z; B G^T, dW, W B G^T; W xc G; d
//                exp(cum_l)) into scratch;
//   4. gram   -- per (b, chunk, 16-column strip): C B^T, once for all
//                heads (scratch);
//   5. local  -- per (b, chunk, head): dM = dy xc^T, M, dM o L (out to
//                scratch), the segment sums, dxc = M^T dy (+ launch 3's),
//                dx, ddt, dda;
//   6. dbc    -- per (b, chunk, dB or dC, 16-row strip): the heads' dM o
//                L added in head order, times C or B, plus launch 3's
//                per-head shares, rounded once.
// B and C enter only launches 3, 4 and 6: each product with them is taken
// once per (b, chunk), not per head.  Shared memory stays under half an
// SM at the zoo's widths (two blocks an SM) and takes every (p, n) up to
// 128.  No atomics: the same inputs give the same bits.
//
// Allocates nothing, and returns cudaGetLastError() so the wrapper can
// raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kL = 64;            // positions per chunk (ssd_scan.cu's)
constexpr int kWarps = 4;         // 16 rows of a 64-row tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr int kLdL = kL + 8;      // row stride of the kL x kL tiles
constexpr size_t kMaxSmem = 232448;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* dy;                // (b, s, h, p) contiguous
  const float* dstate;            // (b, h, p, n) or null (zeros)
  const float* prev;              // entering states (b, h, nc, p, n) or null
  const float* gs_in;             // G of each chunk: gs, dstate or null
  float* dsl;                     // (b, h, nc, p, n): sum_t e_t dy_t C_t^T
  float* gs;                      // (b, h, nc, p, n): G_c
  float* decay;                   // (b, h, nc): exp(cum_l)
  float* dinit;                   // (b, h, p, n) or null
  float* gram;                    // (b, nc, kL, kL): C B^T
  float* dxw;                     // (b, s, h, p): W (B G^T)      (terms)
  float* seg;                     // (b, s, h, 2): dW W, de e     (terms)
  double* dcd;                    // (b, h, nc): d exp(cum_l) exp(cum_l)
  float* dBh;                     // (b, s, h, n): W xc G          (terms)
  float* dCh;                     // (b, s, h, n): e Z             (terms)
  float* dsc;                     // (b, nc, h, kL, kL): dM o L
  void* dx;                       // (b, s, h, p), x's dtype
  float* ddt;                     // (b, s, h)
  float* dda;                     // (b, s, h)
  void* dB;                       // (b, s, n), B's dtype
  void* dC;
  int heads, s, p, n, nc, pp, nn; // pp, nn: p and n padded to 8
  int terms;                      // launch 3 ran
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, B_b, B_s, C_b, C_s;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// v rounded to T and widened again: the identity for float
template <typename T> __device__ __forceinline__ float round_as(float v) {
  return sizeof(T) == 2 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void widen(const uint4& w, float (&v)[4]) {
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z);
  v[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void widen(const uint4& w, float (&v)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // little endian: element 2i is the low half
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// rows x cols elements from global (row r at src + r * gs) into fp32
// shared memory (row stride ld), times scale[r] when given and then, with
// round_t, rounded as T (x dt); rows >= valid and columns in [cols,
// cols_pad) are zero.  16-byte loads where the
// columns, the row stride and the pointer allow (else single elements),
// several in flight a thread: the tiles are small and the blocks few, so
// the copy is bound by latency, not by bytes.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, long long gs,
                          int rows, int valid, int cols, int cols_pad,
                          const float* scale = nullptr,
                          bool round_t = false) {
  auto put = [&](float* d, float v, int r) {
    if (scale != nullptr) v *= scale[r];
    *d = round_t ? round_as<T>(v) : v;
  };
  constexpr int kE = 16 / sizeof(T);       // elements of a 16-byte load
  constexpr int kB = 8;                    // 16-byte loads in flight
  if (cols % kE == 0 && cols_pad % kE == 0 && gs % kE == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int per_row = cols_pad / kE, total = rows * per_row;
    for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kB) {
      uint4 w[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int i = i0 + u * kThreads, r = i / per_row;
        const int c = (i % per_row) * kE;
        w[u] = i < total && r < valid && c < cols
                   ? *reinterpret_cast<const uint4*>(src + r * gs + c)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int i = i0 + u * kThreads, r = i / per_row;
        const int c = (i % per_row) * kE;
        if (i >= total) break;
        float v[kE];
        widen(w[u], v);
#pragma unroll
        for (int e = 0; e < kE; ++e) put(dst + r * ld + c + e, v[e], r);
      }
    }
    return;
  }
  constexpr int kS = 8;                    // element loads in flight
  const int total = rows * cols_pad;
  for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kS) {
    float v[kS];
#pragma unroll
    for (int u = 0; u < kS; ++u) {
      const int i = i0 + u * kThreads, r = i / cols_pad, c = i % cols_pad;
      v[u] = i < total && r < valid && c < cols ? to_f32(src[r * gs + c])
                                                : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kS; ++u) {
      const int i = i0 + u * kThreads, r = i / cols_pad, c = i % cols_pad;
      if (i >= total) break;
      put(dst + r * ld + c, v[u], r);
    }
  }
}

// sDt[t], dt of the chunk's position t (0 past its valid positions), by
// the block's first kL threads
__device__ __forceinline__ void load_dt(const Params& P, int b, int h,
                                        int pos0, int valid, float* sDt) {
  const int t = threadIdx.x;
  if (t < kL)
    sDt[t] = t < valid ? P.dt[b * P.dt_b + (pos0 + t) * P.dt_s + h * P.dt_h]
                       : 0.0f;
}

// warp 0: sCum[t], the inclusive cumsum of dt A in float64, from sDt
// (load_dt, after a barrier); the caller synchronises
__device__ void decay_scan(const Params& P, int h, const float* sDt,
                           double* sCum) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const double a = P.A[h];
  double carry = 0.0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = lane + 32 * half;
    double v = double(sDt[t]) * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    sCum[t] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// v = hi + lo with both rounded to TF32 to nearest by integer ops (hi
// the value's, lo the remainder's): mma_tf32.cuh's split leaves lo for
// the tensor cores to truncate, a one-sided error of up to 2^-21 |v|;
// rounded, it is at most 2^-22 |v| and of either sign
template <int N>
__device__ __forceinline__ void split_rn(const float (&v)[N],
                                         uint32_t (&hi)[N],
                                         uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = (__float_as_uint(v[i]) + 0x1000u) & 0xffffe000u;
    lo[i] = (__float_as_uint(v[i] - __uint_as_float(hi[i])) + 0x1000u) &
            0xffffe000u;
  }
}

// acc[j] += sum_k a(r, k) b(k, c) for the warp's 16 rows r0 .. r0 + 15 and
// 8-column tiles j < nt_hi (columns c0 + 8 j ..), k over [k0, k1) in steps
// of 8: a(r, k) = A[r ar + k ak], b(k, c) = Bm[k bk + c bc], fp32 values in
// shared memory.  The C fragment: acc[j][e] is row r0 + g + 8 (e / 2),
// column c0 + 8 j + 2 t + e % 2 (lane 4 g + t).  kAX / kBX: the operand
// holds bf16 values, exact in TF32 (no lo part).  Each k-step's hi x hi
// product is summed from zero and added with rounding; the small products
// (a_lo b_hi, a_hi b_lo, and a_lo b_lo where neither operand is exact) go
// to lo, which the caller adds.
template <int NT, bool kAX, bool kBX>
__device__ __forceinline__ void warp_mm(float (&acc)[NT][4],
                                        float (&lo)[NT][4], const float* A,
                                        int ar, int ak, const float* Bm,
                                        int bk, int bc, int r0, int c0,
                                        int k0, int k1, int nt_hi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = k0; k < k1; k += 8) {
    const float av[4] = {A[(r0 + g) * ar + (k + t) * ak],
                         A[(r0 + g + 8) * ar + (k + t) * ak],
                         A[(r0 + g) * ar + (k + t + 4) * ak],
                         A[(r0 + g + 8) * ar + (k + t + 4) * ak]};
    uint32_t ah[4], al[4];
    if constexpr (kAX) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ah[e] = __float_as_uint(av[e]);
    } else {
      split_rn(av, ah, al);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt_hi) break;
      const int c = c0 + 8 * j + g;
      const float bv[2] = {Bm[(k + t) * bk + c * bc],
                           Bm[(k + t + 4) * bk + c * bc]};
      uint32_t bh[2], bl[2];
      if constexpr (kBX) {
        bh[0] = __float_as_uint(bv[0]);
        bh[1] = __float_as_uint(bv[1]);
      } else {
        split_rn(bv, bh, bl);
      }
      if constexpr (!kAX && !kBX) mma_tf32(lo[j], al, bl);
      if constexpr (!kAX) mma_tf32(lo[j], al, bh);
      if constexpr (!kBX) mma_tf32(lo[j], ah, bl);
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_tf32(d, ah, bh);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += d[e];
    }
  }
}

template <int NT>
__device__ __forceinline__ void clear(float (&a)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.0f;
}
template <int NT>
__device__ __forceinline__ void add_lo(float (&a)[NT][4],
                                       const float (&lo)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] += lo[j][e];
}

// the sum over the quad's 4 lanes (a fragment row), in a fixed order
__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// the block's sum of v in float64, in a fixed order; red holds kWarps
__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

// a (b, chunk, head) block's chunk and first position
struct Chunk {
  int b, c, pos0, valid;
};
__device__ __forceinline__ Chunk chunk_of(const Params& P, int bc) {
  const int b = bc / P.nc, c = bc % P.nc;
  return {b, c, c * kL, min(kL, P.s - c * kL)};
}

// ---- 1. state: sum_t e_t dy_t C_t^T and exp(cum_l) per (b, chunk, head) --
__host__ __device__ inline size_t state_smem(int pp, int nn) {
  return sizeof(double) * kL +
         sizeof(float) * (size_t(kL) * (pp + 8 + nn + 8) + 2 * kL);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_kernel(
    const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldp = P.pp + 8, ldn = P.nn + 8;
  double* sCum = reinterpret_cast<double*>(smem);
  float* sDY = reinterpret_cast<float*>(sCum + kL);   // kL x ldp: dy e
  float* sC = sDY + kL * ldp;                          // kL x ldn
  float* sDt = sC + kL * ldn;
  float* sE = sDt + kL;

  const int h = blockIdx.x % P.heads;
  const Chunk ch = chunk_of(P, blockIdx.x / P.heads);
  load_dt(P, ch.b, h, ch.pos0, ch.valid, sDt);
  __syncthreads();
  decay_scan(P, h, sDt, sCum);
  __syncthreads();
  if (threadIdx.x < kL) sE[threadIdx.x] = float(exp(sCum[threadIdx.x]));
  if (threadIdx.x == 0)
    P.decay[(size_t(ch.b) * P.heads + h) * P.nc + ch.c] =
        float(exp(sCum[kL - 1]));
  __syncthreads();
  load_tile(sDY, ldp, P.dy + (size_t(ch.b) * P.s + ch.pos0) * P.heads * P.p +
                          size_t(h) * P.p,
            P.heads * P.p, kL, ch.valid, P.p, P.pp, sE);
  load_tile(sC, ldn,
            static_cast<const T*>(P.C) + ch.b * P.C_b + ch.pos0 * P.C_s,
            P.C_s, kL, ch.valid, P.n, P.nn);
  __syncthreads();
  // out[p][n] = sum_t (e dy)[t][p] C[t][n]: 64 rows of p at a time
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* out =
      P.dsl + ((size_t(ch.b) * P.heads + h) * P.nc + ch.c) * P.p * P.n;
  for (int rb = 0; rb < P.pp; rb += kL) {
    const int r0 = rb + 16 * warp;
    if (r0 >= P.pp) break;
    for (int c0 = 0; c0 < P.nn; c0 += 64) {
      float acc[8][4], lo[8][4];
      clear(acc);
      clear(lo);
      const int nt = min(8, (P.nn - c0) / 8);
      warp_mm<8, false, sizeof(T) == 2>(acc, lo, sDY, 1, ldp, sC, ldn, 1,
                                        r0, c0, 0, kL, nt);
      add_lo(acc, lo);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + 8 * (e >> 1), c = c0 + 8 * j + 2 * t + (e & 1);
          if (j < nt && r < P.p && c < P.n) out[r * P.n + c] = acc[j][e];
        }
    }
  }
}

// ---- 2. pass: G_c backwards over the chunks, per (b, head), elementwise --
__global__ void __launch_bounds__(kThreads) ssd_bwd_pass_kernel(
    const Params P) {
  const int per = P.p * P.n;
  const int per_bh = (per + kThreads - 1) / kThreads;
  const int bh = blockIdx.x / per_bh;
  const int i = (blockIdx.x % per_bh) * kThreads + threadIdx.x;
  if (i >= per) return;
  float G = P.dstate != nullptr ? P.dstate[size_t(bh) * per + i] : 0.0f;
  for (int c = P.nc - 1; c >= 0; --c) {
    const size_t at = (size_t(bh) * P.nc + c) * per + i;
    P.gs[at] = G;
    G = fmaf(G, P.decay[size_t(bh) * P.nc + c], P.dsl[at]);
  }
  if (P.dinit != nullptr) P.dinit[size_t(bh) * per + i] = G;
}

// ---- 3. terms: the terms of S_prev and G per (b, chunk, head) ----
__host__ __device__ inline size_t terms_smem(int pp, int nn) {
  const size_t tiles = size_t(kL) * (pp + 8) + size_t(kL) * (nn + 8) +
                       size_t(pp) * (nn + 8);
  return sizeof(double) * (kL + kWarps) +
         sizeof(float) * (tiles + 4 * kL);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_terms_kernel(
    const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldp = P.pp + 8, ldn = P.nn + 8;
  double* sCum = reinterpret_cast<double*>(smem);     // kL
  double* sRed = sCum + kL;                            // kWarps
  float* sR = reinterpret_cast<float*>(sRed + kWarps); // kL x ldp: dy or xc
  float* sN = sR + kL * ldp;                           // kL x ldn: C or B
  float* sS = sN + kL * ldn;                           // pp x ldn: S_prev, G
  float* sDt = sS + P.pp * ldn;
  float* sE = sDt + kL;                                // exp(cum)
  float* sW = sE + kL;                                 // exp(cum_l - cum)
  float* sWr = sW + kL;                                // W rounded as T

  const int h = blockIdx.x % P.heads;
  const Chunk ch = chunk_of(P, blockIdx.x / P.heads);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  const size_t state_at =
      ((size_t(ch.b) * P.heads + h) * P.nc + ch.c) * P.p * P.n;
  const float* prev = P.prev != nullptr ? P.prev + state_at : nullptr;
  const float* G = P.gs_in != nullptr ? P.gs_in + state_at : nullptr;
  auto row_of = [&](int r) {      // (b, pos0 + r, h)
    return (size_t(ch.b) * P.s + ch.pos0 + r) * P.heads + h;
  };
  load_dt(P, ch.b, h, ch.pos0, ch.valid, sDt);
  __syncthreads();
  decay_scan(P, h, sDt, sCum);
  __syncthreads();
  const double cum_l = sCum[kL - 1];
  if (tid < kL) {
    sE[tid] = float(exp(sCum[tid]));
    sW[tid] = float(exp(cum_l - sCum[tid]));
    sWr[tid] = round_as<T>(sW[tid]);
  }
  constexpr bool kX = sizeof(T) == 2;  // B, C and xc exact in TF32

  // a. y_off = e (C S_prev^T): Z = dy S_prev, de = sum_n C Z, dC = e Z,
  //    and d exp(cum_l) = sum G o S_prev
  double dcd = 0.0;
  float de[2] = {0.0f, 0.0f};
  if (prev != nullptr) {
    load_tile(sR, ldp, P.dy + (size_t(ch.b) * P.s + ch.pos0) * P.heads * P.p +
                           size_t(h) * P.p,
              P.heads * P.p, kL, ch.valid, P.p, P.pp);
    load_tile(sN, ldn,
              static_cast<const T*>(P.C) + ch.b * P.C_b + ch.pos0 * P.C_s,
              P.C_s, kL, ch.valid, P.n, P.nn);
    load_tile(sS, ldn, prev, P.n, P.pp, P.p, P.n, P.nn);
    __syncthreads();
    double part = 0.0;
    if (G != nullptr)
      for (int i = tid; i < P.p * P.n; i += kThreads)
        part += double(sS[(i / P.n) * ldn + i % P.n] * G[i]);
    dcd = block_sum(part, sRed);
    double ds[2] = {0.0, 0.0};
    for (int c0 = 0; c0 < P.nn; c0 += 64) {
      float acc[8][4], lo[8][4];
      clear(acc);
      clear(lo);
      const int nt = min(8, (P.nn - c0) / 8);
      warp_mm<8, false, false>(acc, lo, sR, ldp, 1, sS, ldn, 1, r0, c0, 0,
                               P.pp, nt);
      add_lo(acc, lo);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + 8 * (e >> 1), c = c0 + 8 * j + 2 * t + (e & 1);
          if (j >= nt) continue;
          ds[e >> 1] += double(sN[r * ldn + c] * acc[j][e]);
          if (r < ch.valid && c < P.n)
            P.dCh[row_of(r) * P.n + c] = sE[r] * acc[j][e];
        }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) de[hr] = float(quad_sum(ds[hr]));
  } else {
    for (int i = tid; i < ch.valid * P.n; i += kThreads)
      P.dCh[row_of(i / P.n) * P.n + i % P.n] = 0.0f;
  }
  __syncthreads();

  // b. S_c = (W xc)^T B: BG = B G^T, dW = sum_p xc BG, dxc = W BG,
  //    dB = W xc G
  float dw[2] = {0.0f, 0.0f};
  if (G != nullptr) {
    load_tile(sR, ldp,
              static_cast<const T*>(P.x) + ch.b * P.x_b + h * P.x_h +
                  ch.pos0 * P.x_s,
              P.x_s, kL, ch.valid, P.p, P.pp, sDt, true);
    load_tile(sN, ldn,
              static_cast<const T*>(P.B) + ch.b * P.B_b + ch.pos0 * P.B_s,
              P.B_s, kL, ch.valid, P.n, P.nn);
    load_tile(sS, ldn, G, P.n, P.pp, P.p, P.n, P.nn);
    __syncthreads();
    double dws[2] = {0.0, 0.0};
    for (int c0 = 0; c0 < P.pp; c0 += 64) {
      float acc[8][4], lo[8][4];
      clear(acc);
      clear(lo);
      const int nt = min(8, (P.pp - c0) / 8);
      warp_mm<8, kX, false>(acc, lo, sN, ldn, 1, sS, 1, ldn, r0, c0, 0,
                            P.nn, nt);
      add_lo(acc, lo);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + 8 * (e >> 1), c = c0 + 8 * j + 2 * t + (e & 1);
          if (j >= nt) continue;
          dws[e >> 1] += double(sR[r * ldp + c] * acc[j][e]);
          if (r < ch.valid && c < P.p)
            P.dxw[row_of(r) * P.p + c] = sWr[r] * acc[j][e];
        }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) dw[hr] = round_as<T>(float(quad_sum(dws[hr])));
    for (int c0 = 0; c0 < P.nn; c0 += 64) {
      float acc[8][4], lo[8][4];
      clear(acc);
      clear(lo);
      const int nt = min(8, (P.nn - c0) / 8);
      warp_mm<8, kX, false>(acc, lo, sR, ldp, 1, sS, ldn, 1, r0, c0, 0,
                            P.pp, nt);
      add_lo(acc, lo);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + 8 * (e >> 1), c = c0 + 8 * j + 2 * t + (e & 1);
          if (j < nt && r < ch.valid && c < P.n)
            P.dBh[row_of(r) * P.n + c] = sWr[r] * acc[j][e];
        }
    }
  } else {
    for (int i = tid; i < ch.valid * P.p; i += kThreads)
      P.dxw[row_of(i / P.p) * P.p + i % P.p] = 0.0f;
    for (int i = tid; i < ch.valid * P.n; i += kThreads)
      P.dBh[row_of(i / P.n) * P.n + i % P.n] = 0.0f;
  }
  // the segment terms of dda per position, and d exp(cum_l) exp(cum_l)
  if (t == 0)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + g + 8 * hr;
      if (r < ch.valid) {
        P.seg[2 * row_of(r)] = dw[hr] * sW[r];
        P.seg[2 * row_of(r) + 1] = de[hr] * sE[r];
      }
    }
  if (tid == 0)
    P.dcd[(size_t(ch.b) * P.heads + h) * P.nc + ch.c] = dcd * exp(cum_l);
}

// ---- 4. gram: C B^T per (b, chunk), a 16-column strip a block ----
constexpr int kStrips = kL / 16;

__host__ __device__ inline size_t gram_smem(int nn) {
  return sizeof(float) * (kL + 16) * size_t(nn + 8);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_gram_kernel(
    const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldn = P.nn + 8;
  float* sC = reinterpret_cast<float*>(smem);       // kL rows
  float* sB = sC + kL * ldn;                          // the strip's 16 rows
  const int bc = blockIdx.x / kStrips, m0 = 16 * (blockIdx.x % kStrips);
  const Chunk ch = chunk_of(P, bc);
  load_tile(sC, ldn,
            static_cast<const T*>(P.C) + ch.b * P.C_b + ch.pos0 * P.C_s,
            P.C_s, kL, ch.valid, P.n, P.nn);
  load_tile(sB, ldn,
            static_cast<const T*>(P.B) + ch.b * P.B_b +
                (ch.pos0 + m0) * P.B_s,
            P.B_s, 16, ch.valid - m0, P.n, P.nn);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  constexpr bool kX = sizeof(T) == 2;
  float acc[2][4], lo[2][4];
  clear(acc);
  clear(lo);
  // rows t of the warp, columns m0 .. m0 + 15: none below the diagonal
  // where m0 > the warp's last row
  if (m0 <= r0 + 15) {
    warp_mm<2, kX, kX>(acc, lo, sC, ldn, 1, sB, 1, ldn, r0, 0, 0, P.nn, 2);
    add_lo(acc, lo);
  }
  float* out = P.gram + size_t(bc) * kL * kL;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      out[r * kL + m0 + c] = acc[j][e];
    }
}

// ---- 5. local: the rest per (b, chunk, head) ----
__host__ __device__ inline size_t local_smem(int pp) {
  return sizeof(double) * (kL + kL + kWarps * kL) +
         sizeof(float) * (3 * size_t(kL) * kLdL + 2 * size_t(kL) * (pp + 4) +
                          2 * kL);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_local_kernel(
    const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldp = P.pp + 4;
  double* sCum = reinterpret_cast<double*>(smem);     // kL
  double* sRow = sCum + kL;                            // kL: row sums of Q
  double* sCol = sRow + kL;                            // kWarps x kL
  float* sCB = reinterpret_cast<float*>(sCol + kWarps * kL);  // C B^T
  float* sDsc = sCB + kL * kLdL;                       // kL x kLdL
  float* sM = sDsc + kL * kLdL;                        // kL x kLdL
  float* sX = sM + kL * kLdL;                          // kL x ldp: xc
  float* sDY = sX + kL * ldp;                          // kL x ldp: dy
  float* sDt = sDY + kL * ldp;
  float* sDA = sDt + kL;                               // dda

  const int h = blockIdx.x % P.heads;
  const Chunk ch = chunk_of(P, blockIdx.x / P.heads);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  constexpr bool kX = sizeof(T) == 2;  // xc, M, B and C exact in TF32

  for (int i = tid; i < kL * kL; i += kThreads)
    sDsc[(i / kL) * kLdL + i % kL] = 0.0f;

  auto row_of = [&](int r) {    // (b, pos0 + r, h)
    return (size_t(ch.b) * P.s + ch.pos0 + r) * P.heads + h;
  };
  const T* xg = static_cast<const T*>(P.x) + ch.b * P.x_b + h * P.x_h +
                ch.pos0 * P.x_s;
  // every load at once (C B^T too): dt, dy, x; then x dt rounded and the
  // decays
  load_dt(P, ch.b, h, ch.pos0, ch.valid, sDt);
  load_tile(sCB, kLdL, P.gram + size_t(blockIdx.x / P.heads) * kL * kL, kL,
            kL, kL, kL, kL);
  load_tile(sDY, ldp, P.dy + (size_t(ch.b) * P.s + ch.pos0) * P.heads * P.p +
                          size_t(h) * P.p,
            P.heads * P.p, kL, ch.valid, P.p, P.pp);
  load_tile(sX, ldp, xg, P.x_s, kL, ch.valid, P.p, P.pp);
  __syncthreads();
  decay_scan(P, h, sDt, sCum);
  for (int i = tid; i < kL * P.pp; i += kThreads) {
    float* v = sX + (i / P.pp) * ldp + i % P.pp;
    *v = round_as<T>(*v * sDt[i / P.pp]);
  }
  __syncthreads();

  // dM = dy xc^T on the warp's rows t, columns m <= t; then M, dM o L,
  // and the row and column sums of the strictly lower triangle of Q = dM
  // C B^T o L
  const int nt = 2 * warp + 2;
  float acc[8][4], lo[8][4];
  clear(acc);
  clear(lo);
  warp_mm<8, false, kX>(acc, lo, sDY, ldp, 1, sX, 1, ldp, r0, 0, 0, P.pp,
                        nt);
  add_lo(acc, lo);
  double rq[2] = {0.0, 0.0}, cq[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cq[j][0] = cq[j][1] = 0.0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), m = 8 * j + 2 * t + (e & 1);
      float mval = 0.0f;
      if (j < nt && m <= r) {
        const float Lf = float(exp(sCum[r] - sCum[m]));
        const float cb = sCB[r * kLdL + m];
        const float gd = round_as<T>(acc[j][e]);
        mval = round_as<T>(cb * Lf);
        sDsc[r * kLdL + m] += gd * Lf;
        if (m < r) {
          const double q = double(gd * cb * Lf);
          rq[e >> 1] += q;
          cq[j][e & 1] += q;
        }
      }
      sM[r * kLdL + m] = mval;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const double v = quad_sum(rq[hr]);
    if (t == 0) sRow[r0 + g + 8 * hr] = v;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      double v = cq[j][u];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) sCol[warp * kL + 8 * j + 2 * t + u] = v;
    }
  __syncthreads();

  // dda_t = the rectangle sum R_t = sum_{r >= t} sum_{m < t} Q[r][m]
  // (R_{t+1} = R_t - row_t + col_t), + sum_{r < t} dW W + sum_{r >= t}
  // de e + d exp(cum_l) exp(cum_l): an exclusive scan in float64 by the
  // last warp, whose rows m take the fewest k-steps of M^T dy below,
  // while the others start that product (dda is read after it)
  if (warp == kWarps - 1) {
    const double dcd = P.terms
        ? P.dcd[(size_t(ch.b) * P.heads + h) * P.nc + ch.c] : 0.0;
    double carry = 0.0, carry_e = 0.0, rect[2], pre_e[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = lane + 32 * half;
      double col = 0.0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) col += sCol[w * kL + r];
      double d = col - sRow[r], de_e = 0.0;
      if (P.terms && r < ch.valid) {
        d += double(P.seg[2 * row_of(r)]);
        de_e = double(P.seg[2 * row_of(r) + 1]);
      }
      double v = d, ve = de_e;  // inclusive scans over the 32 lanes
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        const double ue = __shfl_up_sync(0xffffffffu, ve, off);
        if (lane >= off) {
          v += u;
          ve += ue;
        }
      }
      rect[half] = carry + v - d;      // the rectangle and dW W: r' < r
      pre_e[half] = carry_e + ve - de_e;
      carry += __shfl_sync(0xffffffffu, v, 31);
      carry_e += __shfl_sync(0xffffffffu, ve, 31);
    }
    // de e over r' >= r: the total less the sum over r' < r
#pragma unroll
    for (int half = 0; half < 2; ++half)
      sDA[lane + 32 * half] =
          float(rect[half] + (carry_e - pre_e[half]) + dcd);
  }

  // dxc = M^T dy (+ W B G^T): the warp's rows m, columns p; then dx =
  // round(dxc) dt, ddt = dda A + sum_p round(dxc) x, dda
  double dd[2] = {0.0, 0.0};
  for (int c0 = 0; c0 < P.pp; c0 += 64) {
    float d[8][4], dl[8][4];
    clear(d);
    clear(dl);
    const int ntp = min(8, (P.pp - c0) / 8);
    warp_mm<8, kX, false>(d, dl, sM, 1, kLdL, sDY, ldp, 1, r0, c0, r0, kL,
                          ntp);
    add_lo(d, dl);
    // x (and launch 3's share) at the fragment's positions, all loaded
    // before the first store: dx might alias them, so a load after a
    // store would wait for it
    float xv[8][4], xw[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = r0 + g + 8 * (e >> 1), c = c0 + 8 * j + 2 * t + (e & 1);
        const bool in = j < ntp && m < ch.valid && c < P.p;
        xv[j][e] = in ? to_f32(xg[m * P.x_s + c]) : 0.0f;
        xw[j][e] = in && P.terms ? P.dxw[row_of(m) * P.p + c] : 0.0f;
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = r0 + g + 8 * (e >> 1), c = c0 + 8 * j + 2 * t + (e & 1);
        if (j >= ntp || m >= ch.valid || c >= P.p) continue;
        const float gx = round_as<T>(d[j][e] + xw[j][e]);
        dd[e >> 1] += double(gx * xv[j][e]);
        static_cast<T*>(P.dx)[row_of(m) * P.p + c] = from_f32<T>(gx * sDt[m]);
      }
  }
  __syncthreads();              // dda is in sDA
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const double acc_x = quad_sum(dd[hr]);
    const int m = r0 + g + 8 * hr;
    if (t == 0 && m < ch.valid) {
      P.ddt[row_of(m)] = sDA[m] * P.A[h] + float(acc_x);
      P.dda[row_of(m)] = sDA[m];
    }
  }
  __syncthreads();                // dM o L is in sDsc

  // the head's dM o L, for launch 6
  float* out = P.dsc + size_t(blockIdx.x) * kL * kL;
  for (int i = tid; i < kL * kL / 4; i += kThreads) {
    const int r = i / (kL / 4), c = 4 * (i % (kL / 4));
    *reinterpret_cast<float4*>(out + r * kL + c) =
        *reinterpret_cast<const float4*>(sDsc + r * kLdL + c);
  }
}

// ---- 6. dbc: dB = (dM o L)^T C and dC = (dM o L) B per (b, chunk), the
// heads' dM o L summed first (in head order, in float64), 16
// rows of one of the two a block; with launch 3's per-head shares;
// rounded once.  These two products, 4 n kL^2 / 2 flops per (b, chunk),
// run on the CUDA cores in fp32: on the tensor cores (the split of
// warp_mm) dC erred 2.1x-2.3x the replaced kernel's float64 error ----
__host__ __device__ inline size_t dbc_smem(int nn) {
  return sizeof(float) * size_t(kL) * (kLdL + nn + 8);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dbc_kernel(
    const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldn = P.nn + 8;
  float* sD = reinterpret_cast<float*>(smem);         // kL x kLdL
  float* sN = sD + kL * kLdL;                          // kL x ldn: C or B
  const int strip = blockIdx.x % kStrips;
  const bool dB = (blockIdx.x / kStrips) % 2 == 0;
  const int bc = blockIdx.x / (2 * kStrips);
  const Chunk ch = chunk_of(P, bc);
  const int tid = threadIdx.x, r0 = 16 * strip;

  // the part of the summed dM o L this strip reads: for dB rows m (its
  // columns) over t >= m, for dC rows t over m <= t
  const int t_lo = r0, t_hi = dB ? kL : r0 + 16;
  const int m_lo = dB ? r0 : 0, m_hi = r0 + 16;
  const int wq = (m_hi - m_lo) / 4, total = (t_hi - t_lo) * wq;
  const float* src = P.dsc + size_t(bc) * P.heads * kL * kL;
  // the region is at most 1024 floats: two float4 a thread, both summed
  // in one pass over the heads (in float64: the heads' terms cancel;
  // then one rounding)
  constexpr int kPer = kL * 16 / 4 / kThreads;
  int off[kPer];
  bool ok[kPer];
  double tot[kPer][4];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kThreads;
    ok[u] = i < total;
    off[u] = ok[u] ? (t_lo + i / wq) * kL + m_lo + 4 * (i % wq) : 0;
    tot[u][0] = tot[u][1] = tot[u][2] = tot[u][3] = 0.0;
  }
#pragma unroll 16
  for (int q = 0; q < P.heads; ++q) {
    const float* tile = src + size_t(q) * kL * kL;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (!ok[u]) continue;
      const float4 v = *reinterpret_cast<const float4*>(tile + off[u]);
      tot[u][0] += v.x;
      tot[u][1] += v.y;
      tot[u][2] += v.z;
      tot[u][3] += v.w;
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (ok[u]) {
      const int r = off[u] / kL, c = off[u] % kL;
      *reinterpret_cast<float4*>(sD + r * kLdL + c) =
          make_float4(float(tot[u][0]), float(tot[u][1]), float(tot[u][2]),
                      float(tot[u][3]));
    }
  if (dB)                         // C rows t >= r0
    load_tile(sN + r0 * ldn, ldn,
              static_cast<const T*>(P.C) + ch.b * P.C_b +
                  (ch.pos0 + r0) * P.C_s,
              P.C_s, kL - r0, ch.valid - r0, P.n, P.nn);
  else                            // B rows m < r0 + 16
    load_tile(sN, ldn,
              static_cast<const T*>(P.B) + ch.b * P.B_b + ch.pos0 * P.B_s,
              P.B_s, r0 + 16, ch.valid, P.n, P.nn);
  __syncthreads();

  // each thread a 4 x 4 tile: rows ra .. ra + 3 of the strip (one group
  // of 4 a warp), columns 4 lane ..; fp32 FMAs summed by blocks of 16
  // terms from k0 (dB: t >= m, dC: m <= t; the summed dM o L is zero
  // above its diagonal, so the tile's rows share one range of k)
  const int ra = r0 + 4 * (tid >> 5), cb = 4 * (tid & 31);
  if (ra >= ch.valid || cb >= P.nn) return;
  const int k0 = dB ? ra : 0, k1 = dB ? kL : ra + 4;
  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.0f;
  for (int kb = k0; kb < k1; kb += 16) {
    const int ke = min(k1, kb + 16);
    for (int k = kb; k < ke; ++k) {
      float av[4];
      if (dB) {
        const float4 v = *reinterpret_cast<const float4*>(sD + k * kLdL + ra);
        av[0] = v.x; av[1] = v.y; av[2] = v.z; av[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = sD[(ra + i) * kLdL + k];
      }
      const float4 bv = *reinterpret_cast<const float4*>(sN + k * ldn + cb);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bb[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] += part[i][j];
        part[i][j] = 0.0f;
      }
  }
  const float* th = dB ? P.dBh : P.dCh;
  T* outp = static_cast<T*>(dB ? P.dB : P.dC);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ra + i;
    if (r >= ch.valid) break;
    const size_t row = size_t(ch.b) * P.s + ch.pos0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cb + j;
      if (c >= P.n) break;
      float v = acc[i][j];
      if (P.terms) {              // the terms' per-head shares, in order
        double sum = v;
        for (int h = 0; h < P.heads; ++h)
          sum += double(th[(row * P.heads + h) * P.n + c]);
        v = float(sum);
      }
      outp[row * P.n + c] = from_f32<T>(v);
    }
  }
}

template <typename K>
cudaError_t run(K kern, unsigned blocks, size_t smem, const Params& P,
                cudaStream_t stream) {
  if (blocks == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess)         // as many blocks per SM as fit
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  kern<<<blocks, kThreads, smem, stream>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& P, int batch, bool states,
                   cudaStream_t stream) {
  const unsigned chunks = unsigned(batch) * P.nc;
  cudaError_t err = cudaSuccess;
  if (states) {
    err = run(ssd_bwd_state_kernel<T>, chunks * P.heads,
              state_smem(P.pp, P.nn), P, stream);
    if (err == cudaSuccess)
      err = run(ssd_bwd_pass_kernel,
                unsigned(batch) * P.heads *
                    ((P.p * P.n + kThreads - 1) / kThreads),
                0, P, stream);
  }
  if (err == cudaSuccess && P.terms)
    err = run(ssd_bwd_terms_kernel<T>, chunks * P.heads,
              terms_smem(P.pp, P.nn), P, stream);
  if (err == cudaSuccess)
    err = run(ssd_bwd_gram_kernel<T>, chunks * kStrips, gram_smem(P.nn), P,
              stream);
  if (err == cudaSuccess)
    err = run(ssd_bwd_local_kernel<T>, chunks * P.heads, local_smem(P.pp),
              P, stream);
  if (err == cudaSuccess)
    err = run(ssd_bwd_dbc_kernel<T>, chunks * 2 * kStrips, dbc_smem(P.nn), P,
              stream);
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, and dx, dB, dC).  strides: 10
// host integers as ssd_scan_launch's.  dy: (b, s, h, p) fp32 contiguous;
// dstate (b, h, p, n) fp32 or null (zeros); prev: the entering states (b,
// h, nc, p, n) fp32, or null (one chunk, no initial state); dinit: null
// unless the initial state's gradient is wanted.  scratch: kernel.py's
// bwd_scratch_floats, laid out as in this function.  Outputs: dx (b, s, h,
// p), ddt and dda (b, s, h) fp32, dB and dC (b, s, n), dinit (b, h, p, n)
// fp32.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* dy, const void* dstate, const void* prev,
    void* scratch, void* dinit, void* dx, void* ddt, void* dda, void* dB,
    void* dC, int dtype, int batch, int heads, int s, int p, int n,
    const long long* strides, cudaStream_t stream) {
  if (p < 1 || p > kMaxP || n < 1 || n > kMaxN || heads < 1 || s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pp = (p + 7) / 8 * 8, nn = (n + 7) / 8 * 8;
  if (local_smem(pp) > kMaxSmem || terms_smem(pp, nn) > kMaxSmem ||
      dbc_smem(nn) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || s == 0) return static_cast<int>(cudaGetLastError());
  const int nc = (s + kL - 1) / kL;
  const bool states = nc > 1 || dinit != nullptr;
  const bool terms = nc > 1 || prev != nullptr || dstate != nullptr;
  const size_t bsh = size_t(batch) * s * heads;
  const size_t bhc = size_t(batch) * heads * nc;
  // scratch, in floats: dcd (doubles) first, then gram, the heads' dM o
  // L, the terms' outputs and the states'
  double* dcd = static_cast<double*>(scratch);
  float* gram = reinterpret_cast<float*>(dcd + (terms ? (bhc + 1) / 2 * 2
                                                     : 0));  // 16 bytes
  float* dsc = gram + size_t(batch) * nc * kL * kL;
  float* dBh = dsc + size_t(batch) * nc * heads * kL * kL;
  float* dCh = dBh + (terms ? bsh * n : 0);
  float* dxw = dCh + (terms ? bsh * n : 0);
  float* seg = dxw + (terms ? bsh * p : 0);
  float* dsl = seg + (terms ? 2 * bsh : 0);
  float* gs = dsl + (states ? bhc * p * n : 0);
  float* decay = gs + (states ? bhc * p * n : 0);
  const float* ds = static_cast<const float*>(dstate);
  const Params P{x, static_cast<const float*>(dt),
                 static_cast<const float*>(A), B, C,
                 static_cast<const float*>(dy), ds,
                 static_cast<const float*>(prev), states ? gs : ds,
                 dsl, gs, decay, static_cast<float*>(dinit), gram, dxw, seg,
                 dcd, dBh, dCh, dsc, dx,
                 static_cast<float*>(ddt), static_cast<float*>(dda), dB, dC,
                 heads, s, p, n, nc, pp, nn, int(terms),
                 strides[0], strides[1], strides[2], strides[3], strides[4],
                 strides[5], strides[6], strides[7], strides[8], strides[9]};
  const cudaError_t err =
      dtype == 0   ? launch<float>(P, batch, states, stream)
      : dtype == 1 ? launch<__nv_bfloat16>(P, batch, states, stream)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
