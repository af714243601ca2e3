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
// sum G o S_prev.  dda is summed segment by segment (no reverse cumsum
// whose terms cancel); then dx = dxc dt, ddt = dda A + sum_p dxc x.
//
// Precision.  cum, L, W, e and exp(cum_l) are float64 (64 values and one
// 64 x 64 triangle per (b, chunk, head)) and rounded once to fp32: the
// fp32 cumsum's rounding, which the plain backward inherits, is what
// decides its float64 error in ddt (exp of differences of fp32 sums near
// -100).  The products are fp32 on the CUDA cores, summed by blocks of 16
// terms; the sums of dW, de, dda and ddt are float64 from fp32 products.
// bfloat16 inputs: autograd of the forward's rounding points rounds the
// cotangents flowing back through them, and so does this kernel: dxc,
// dB, dC, dM and dW are rounded to bfloat16 (nearest even) where the plain
// version rounds them; M and W are recomputed rounded, as the forward
// rounds them.  Those points are the model's only where it takes one chunk
// (s <= 64; see ssd_scan.cu).
//
// Bound: about 36 p n + 6 kL (p + n) flops per (batch, head, position)
// (the nine products below) -- operations at the model's widths.  Design,
// simple first: four launches on the caller's stream, the first two only
// when there are several chunks or an initial state wants its gradient:
//   1. state  -- per (b, chunk, head): sum_t e_t dy_t C_t^T and exp(cum_l);
//   2. pass   -- per (b, head) and element of the state: G_c backwards
//                over the chunks, the initial state's gradient;
//   3. local  -- per (b, chunk, head), everything else: dx, ddt, dda, and
//                each head's share of dB and dC (fp32, scratch);
//   4. heads  -- dB and dC summed over the heads in order.
// Launch 3 holds x dt, dy, dxc (kL x p), B, C (kL x n) and either S_prev
// or G (p x n) with one kL x n product, or three kL x kL tiles, in shared
// memory as fp32: every (p, n) up to 128 except p and n both above 96.
// Each thread sums a 4 x 4 tile of a product over k.  No atomics: the same
// inputs give the same bits.
//
// Allocates nothing, and returns cudaGetLastError() so the wrapper can
// raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;            // positions per chunk (ssd_scan.cu's)
constexpr int kThreads = 256;     // 8 warps; 4 threads per chunk row
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr int kLdL = kL + 1;      // row stride of the kL x kL tiles
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
  const float* gs_in;             // G read by launch 3: gs, dstate or null
  float* dsl;                     // (b, h, nc, p, n): sum_t e_t dy_t C_t^T
  float* gs;                      // (b, h, nc, p, n): G_c
  float* decay;                   // (b, h, nc): exp(cum_l)
  float* dinit;                   // (b, h, p, n) or null
  void* dx;                       // (b, s, h, p), x's dtype
  float* ddt;                     // (b, s, h)
  float* dda;                     // (b, s, h)
  float* dBh;                     // (b, s, h, n): each head's dB
  float* dCh;                     // (b, s, h, n): each head's dC
  void* dB;                       // (b, s, n), B's dtype
  void* dC;
  int heads, s, p, n, nc, pp, nn;
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

// rows x cols elements from global (row r at src + r * gs) into fp32
// shared memory (row stride ld); rows >= valid and columns in [cols,
// cols_pad) are zero
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, long long gs,
                          int rows, int valid, int cols, int cols_pad) {
  for (int i = threadIdx.x; i < rows * cols_pad; i += kThreads) {
    const int r = i / cols_pad, c = i % cols_pad;
    dst[r * ld + c] = (r < valid && c < cols) ? to_f32(src[r * gs + c]) : 0.0f;
  }
}

// warp 0: sDt[t] (0 past the chunk's valid positions) and sCum[t], the
// inclusive cumsum of dt A in float64; the caller synchronises
__device__ void decay_math(const Params& P, int b, int h, int pos0,
                           int valid, float* sDt, double* sCum) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const double a = P.A[h];
  double carry = 0.0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = lane + 32 * half;
    const float d =
        t < valid ? P.dt[b * P.dt_b + (pos0 + t) * P.dt_s + h * P.dt_h] : 0.0f;
    double v = double(d) * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    sDt[t] = d;
    sCum[t] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// out(r, c) = sum_k a(r, k) b(c, k) for r < R, c < Cn (multiples of 4):
// a(r, k) = A[r ar + k ak], b(c, k) = Bm[c bc + k bk].  Each thread takes
// a 4 x 4 tile (rows r, r + R/4, ..., columns likewise, so that
// neighbouring threads read neighbouring columns), sums k in fp32 by
// blocks of 16 terms, and hands each sum to epi(r, c, v)
template <typename F>
__device__ __forceinline__ void mm(int R, int Cn, int K, const float* A,
                                   int ar, int ak, const float* Bm, int bc,
                                   int bk, F epi) {
  const int tr = R / 4, tc = Cn / 4;
  for (int tile = threadIdx.x; tile < tr * tc; tile += kThreads) {
    const int rl = tile / tc, cl = tile % tc;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int k1 = min(K, k0 + 16);
      float part[4][4] = {};
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = A[(rl + i * tr) * ar + k * ak];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bm[(cl + j * tc) * bc + k * bk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[i][j] = fmaf(av[i], bv[j], part[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(rl + i * tr, cl + j * tc, acc[i][j]);
  }
}

// sum over c < cols of f(t, c) for every chunk row t, in float64 from the
// fp32 values f returns: 4 threads a row, each a strided quarter, then
// summed across the four in a fixed order.  Every thread gets its row's
// sum; the caller reads it where threadIdx.x % 4 == 0
template <typename F>
__device__ __forceinline__ double row_sum(int cols, F f) {
  const int t = threadIdx.x >> 2, q = threadIdx.x & 3;
  double acc = 0.0;
  for (int c = q; c < cols; c += 4) acc += double(f(t, c));
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// the block's sum of v in float64, in a fixed order; red holds 8 doubles
__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  __syncthreads();
  return t;
}

__host__ __device__ inline size_t state_smem(int pp, int nn) {
  return sizeof(double) * kL +
         sizeof(float) * (size_t(kL) * (pp + 1 + nn + 1) + 2 * kL);
}

// ---- 1. state: sum_t e_t dy_t C_t^T and exp(cum_l) per (b, chunk, head) --
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_kernel(
    const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldp = P.pp + 1, ldn = P.nn + 1;
  double* sCum = reinterpret_cast<double*>(smem);
  float* sDY = reinterpret_cast<float*>(sCum + kL);   // kL x ldp: dy e
  float* sC = sDY + kL * ldp;                          // kL x ldn
  float* sDt = sC + kL * ldn;
  float* sE = sDt + kL;

  const int h = blockIdx.x % P.heads, bc = blockIdx.x / P.heads;
  const int b = bc / P.nc, c = bc % P.nc;
  const int pos0 = c * kL, valid = min(kL, P.s - pos0);
  load_tile(sDY, ldp, P.dy + (size_t(b) * P.s + pos0) * P.heads * P.p +
                          size_t(h) * P.p,
            P.heads * P.p, kL, valid, P.p, P.pp);
  load_tile(sC, ldn, static_cast<const T*>(P.C) + b * P.C_b + pos0 * P.C_s,
            P.C_s, kL, valid, P.n, P.nn);
  decay_math(P, b, h, pos0, valid, sDt, sCum);
  __syncthreads();
  if (threadIdx.x < kL) sE[threadIdx.x] = float(exp(sCum[threadIdx.x]));
  if (threadIdx.x == 0)
    P.decay[(size_t(b) * P.heads + h) * P.nc + c] = float(exp(sCum[kL - 1]));
  __syncthreads();
  for (int i = threadIdx.x; i < kL * P.pp; i += kThreads)
    sDY[(i / P.pp) * ldp + i % P.pp] *= sE[i / P.pp];
  __syncthreads();
  float* out = P.dsl + ((size_t(b) * P.heads + h) * P.nc + c) * P.p * P.n;
  mm(P.pp, P.nn, kL, sDY, 1, ldp, sC, 1, ldn, [&](int r, int j, float v) {
    if (r < P.p && j < P.n) out[r * P.n + j] = v;
  });
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

// ---- 3. local: the rest per (b, chunk, head) ----
__host__ __device__ inline size_t local_union_floats(int pp, int nn) {
  const size_t a = size_t(pp) * (nn + 1) + size_t(kL) * (nn + 1);
  const size_t c = 3 * size_t(kL) * kLdL;
  return a > c ? a : c;
}
__host__ __device__ inline size_t local_smem(int pp, int nn) {
  return sizeof(double) * (kL + 8) +
         sizeof(float) * (3 * size_t(kL) * (pp + 1) + 2 * size_t(kL) * (nn + 1) +
                          local_union_floats(pp, nn) + 8 * kL);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_local_kernel(
    const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldp = P.pp + 1, ldn = P.nn + 1;
  double* sCum = reinterpret_cast<double*>(smem);     // kL
  double* sRed = sCum + kL;                            // 8
  float* sX = reinterpret_cast<float*>(sRed + 8);      // kL x ldp: x dt
  float* sDY = sX + kL * ldp;                          // kL x ldp: dy
  float* sDX = sDY + kL * ldp;                         // kL x ldp: dxc
  float* sB = sDX + kL * ldp;                          // kL x ldn
  float* sC = sB + kL * ldn;                           // kL x ldn
  float* sU = sC + kL * ldn;                           // the union below
  float* sDt = sU + local_union_floats(P.pp, P.nn);
  float* sE = sDt + kL;                                // exp(cum)
  float* sW = sE + kL;                                 // exp(cum_l - cum)
  float* sWr = sW + kL;                                // W rounded as T
  float* sDE = sWr + kL;                               // de
  float* sDW = sDE + kL;                               // dW, rounded as T
  float* sDA = sDW + kL;                               // dda
  // the union: phases a and b hold S_prev or G (pp x ldn) and a kL x ldn
  // product; phase c three kL x kL tiles (scores, M, dM)
  float* sP = sU;
  float* sT = sU + P.pp * ldn;
  float* sS = sU;
  float* sM = sU + kL * kLdL;
  float* sD = sM + kL * kLdL;

  const int h = blockIdx.x % P.heads, bc = blockIdx.x / P.heads;
  const int b = bc / P.nc, c = bc % P.nc;
  const int pos0 = c * kL, valid = min(kL, P.s - pos0);
  const int tid = threadIdx.x;
  const T* xg = static_cast<const T*>(P.x) + b * P.x_b + h * P.x_h +
                pos0 * P.x_s;
  // each head's dB and dC rows of this chunk: row t at hrow(t)
  auto hrow = [&](int t) {
    return ((size_t(b) * P.s + pos0 + t) * P.heads + h) * P.n;
  };

  load_tile(sX, ldp, xg, P.x_s, kL, valid, P.p, P.pp);
  load_tile(sDY, ldp, P.dy + (size_t(b) * P.s + pos0) * P.heads * P.p +
                          size_t(h) * P.p,
            P.heads * P.p, kL, valid, P.p, P.pp);
  load_tile(sB, ldn, static_cast<const T*>(P.B) + b * P.B_b + pos0 * P.B_s,
            P.B_s, kL, valid, P.n, P.nn);
  load_tile(sC, ldn, static_cast<const T*>(P.C) + b * P.C_b + pos0 * P.C_s,
            P.C_s, kL, valid, P.n, P.nn);
  decay_math(P, b, h, pos0, valid, sDt, sCum);
  __syncthreads();
  const double cum_l = sCum[kL - 1];
  if (tid < kL) {
    sE[tid] = float(exp(sCum[tid]));
    sW[tid] = float(exp(cum_l - sCum[tid]));
    sWr[tid] = round_as<T>(sW[tid]);
  }
  for (int i = tid; i < kL * P.pp; i += kThreads) {
    float* v = sX + (i / P.pp) * ldp + i % P.pp;
    *v = round_as<T>(*v * sDt[i / P.pp]);
  }
  const size_t state_at = ((size_t(b) * P.heads + h) * P.nc + c) * P.p * P.n;

  // a. y_off = e (C S_prev^T): Z = dy S_prev, de = sum_n C Z, dC = e Z,
  //    and d exp(cum_l) = sum G o S_prev
  double dcd = 0.0;
  if (P.prev != nullptr) {
    load_tile(sP, ldn, P.prev + state_at, P.n, P.pp, P.p, P.n, P.nn);
    __syncthreads();
    double part = 0.0;
    if (P.gs_in != nullptr)
      for (int i = tid; i < P.p * P.n; i += kThreads)
        part += double(sP[(i / P.n) * ldn + i % P.n] * P.gs_in[state_at + i]);
    dcd = block_sum(part, sRed);
    mm(kL, P.nn, P.pp, sDY, ldp, 1, sP, 1, ldn,
       [&](int t, int j, float v) { sT[t * ldn + j] = v; });
    __syncthreads();
    const double de = row_sum(P.nn, [&](int t, int j) {
      return sC[t * ldn + j] * sT[t * ldn + j];
    });
    if ((tid & 3) == 0) sDE[tid >> 2] = float(de);
    for (int i = tid; i < valid * P.n; i += kThreads) {
      const int t = i / P.n, j = i % P.n;
      P.dCh[hrow(t) + j] = sE[t] * sT[t * ldn + j];
    }
  } else {
    if (tid < kL) sDE[tid] = 0.0f;
    for (int i = tid; i < valid * P.n; i += kThreads)
      P.dCh[hrow(i / P.n) + i % P.n] = 0.0f;
  }
  __syncthreads();

  // b. S_c = (W xc)^T B: BG = B G^T, dW = sum_p xc BG, dxc = W BG,
  //    dB = W xc G
  if (P.gs_in != nullptr) {
    load_tile(sP, ldn, P.gs_in + state_at, P.n, P.pp, P.p, P.n, P.nn);
    __syncthreads();
    mm(kL, P.pp, P.nn, sB, ldn, 1, sP, ldn, 1,
       [&](int t, int j, float v) { sDX[t * ldp + j] = v; });
    __syncthreads();
    const double dw = row_sum(P.pp, [&](int t, int j) {
      return sX[t * ldp + j] * sDX[t * ldp + j];
    });
    if ((tid & 3) == 0) sDW[tid >> 2] = round_as<T>(float(dw));
    __syncthreads();
    for (int i = tid; i < kL * P.pp; i += kThreads)
      sDX[(i / P.pp) * ldp + i % P.pp] *= sWr[i / P.pp];
    mm(kL, P.nn, P.pp, sX, ldp, 1, sP, 1, ldn, [&](int t, int j, float v) {
      if (t < valid && j < P.n) P.dBh[hrow(t) + j] = sWr[t] * v;
    });
  } else {
    if (tid < kL) sDW[tid] = 0.0f;
    for (int i = tid; i < kL * P.pp; i += kThreads)
      sDX[(i / P.pp) * ldp + i % P.pp] = 0.0f;
    for (int i = tid; i < valid * P.n; i += kThreads)
      P.dBh[hrow(i / P.n) + i % P.n] = 0.0f;
  }
  __syncthreads();

  // c. y_diag = M xc, M = round(C B^T o L): dM = round(dy xc^T), then
  //    dxc += M^T dy, dB += (dM o L)^T C, dC += (dM o L) B, and the
  //    segments' terms dM (C B^T) o L kept in sS
  mm(kL, kL, P.nn, sC, ldn, 1, sB, ldn, 1,
     [&](int t, int m, float v) { sS[t * kLdL + m] = v; });
  mm(kL, kL, P.pp, sDY, ldp, 1, sX, ldp, 1,
     [&](int t, int m, float v) { sD[t * kLdL + m] = v; });
  __syncthreads();
  for (int i = tid; i < kL * kL; i += kThreads) {
    const int t = i / kL, m = i % kL;
    float* sc = sS + t * kLdL + m;
    float* dm = sD + t * kLdL + m;
    if (m <= t) {
      const float Lf = float(exp(sCum[t] - sCum[m]));
      const float g = round_as<T>(*dm);
      sM[t * kLdL + m] = round_as<T>(*sc * Lf);
      *sc = g * *sc * Lf;
      *dm = g * Lf;
    } else {
      sM[t * kLdL + m] = 0.0f;
      *sc = 0.0f;
      *dm = 0.0f;
    }
  }
  __syncthreads();
  mm(kL, P.pp, kL, sM, 1, kLdL, sDY, 1, ldp,
     [&](int m, int j, float v) { sDX[m * ldp + j] += v; });
  mm(kL, P.nn, kL, sD, 1, kLdL, sC, 1, ldn, [&](int m, int j, float v) {
    if (m < valid && j < P.n) P.dBh[hrow(m) + j] += v;
  });
  mm(kL, P.nn, kL, sD, kLdL, 1, sB, 1, ldn, [&](int t, int j, float v) {
    if (t < valid && j < P.n) P.dCh[hrow(t) + j] += v;
  });
  // dda_t: 4 threads a position share the rows t' >= t of the segment
  // sums, one adds the other terms
  {
    const int t = tid >> 2, q = tid & 3;
    double acc = 0.0;
    for (int r = t + q; r < kL; r += 4)
      for (int m = 0; m < t; ++m) acc += double(sS[r * kLdL + m]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (q == 0) {
      for (int r = 0; r < t; ++r) acc += double(sDW[r] * sW[r]);
      for (int r = t; r < kL; ++r) acc += double(sDE[r] * sE[r]);
      acc += dcd * exp(cum_l);
      sDA[t] = float(acc);
    }
  }
  __syncthreads();

  // dx = round(dxc) dt, ddt = dda A + sum_p round(dxc) x, dda
  {
    const int t = tid >> 2, q = tid & 3;
    const size_t row = (size_t(b) * P.s + pos0 + t) * P.heads + h;
    T* dxg = static_cast<T*>(P.dx) + row * P.p;
    double acc = 0.0;
    if (t < valid) {
      for (int j = q; j < P.p; j += 4) {
        const float g = round_as<T>(sDX[t * ldp + j]);
        acc += double(g * to_f32(xg[t * P.x_s + j]));
        dxg[j] = from_f32<T>(g * sDt[t]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (q == 0 && t < valid) {
      P.ddt[row] = sDA[t] * P.A[h] + float(acc);
      P.dda[row] = sDA[t];
    }
  }
}

// ---- 4. heads: dB and dC summed over the heads in order ----
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_heads_kernel(
    const Params P, int rows) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= 2 * rows * P.n) return;
  const int which = i / (rows * P.n), k = i % (rows * P.n);
  const int row = k / P.n, j = k % P.n;
  const float* src = (which == 0 ? P.dBh : P.dCh) + size_t(row) * P.heads * P.n + j;
  double acc = 0.0;
  for (int h = 0; h < P.heads; ++h) acc += double(src[size_t(h) * P.n]);
  static_cast<T*>(which == 0 ? P.dB : P.dC)[k] = from_f32<T>(float(acc));
}

template <typename K>
cudaError_t run(K kern, unsigned blocks, size_t smem, const Params& P,
                cudaStream_t stream) {
  if (blocks == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<blocks, kThreads, smem, stream>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& P, int batch, bool states,
                   cudaStream_t stream) {
  const unsigned chunks = unsigned(batch) * P.nc * P.heads;
  cudaError_t err = cudaSuccess;
  if (states) {
    err = run(ssd_bwd_state_kernel<T>, chunks, state_smem(P.pp, P.nn), P,
              stream);
    if (err == cudaSuccess)
      err = run(ssd_bwd_pass_kernel,
                unsigned(batch) * P.heads *
                    ((P.p * P.n + kThreads - 1) / kThreads),
                0, P, stream);
  }
  if (err == cudaSuccess)
    err = run(ssd_bwd_local_kernel<T>, chunks, local_smem(P.pp, P.nn), P,
              stream);
  if (err == cudaSuccess) {
    const int rows = batch * P.s;
    const unsigned blocks = unsigned((2 * rows * P.n + kThreads - 1) / kThreads);
    if (blocks > 0) {
      ssd_bwd_heads_kernel<T><<<blocks, kThreads, 0, stream>>>(P, rows);
      err = cudaGetLastError();
    }
  }
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, and dx, dB, dC).  strides: 10
// host integers as ssd_scan_launch's.  dy: (b, s, h, p) fp32 contiguous;
// dstate (b, h, p, n) fp32 or null (zeros); prev: the entering states (b,
// h, nc, p, n) fp32, or null (one chunk, no initial state); dinit: null
// unless the initial state's gradient is wanted.  scratch: 2 b s h n
// floats, and when nc > 1 or dinit is wanted 2 b h nc p n + b h nc more.
// Outputs: dx (b, s, h, p), ddt and dda (b, s, h) fp32, dB and dC (b, s,
// n), dinit (b, h, p, n) fp32.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* dy, const void* dstate, const void* prev,
    void* scratch, void* dinit, void* dx, void* ddt, void* dda, void* dB,
    void* dC, int dtype, int batch, int heads, int s, int p, int n,
    const long long* strides, cudaStream_t stream) {
  if (p < 1 || p > kMaxP || n < 1 || n > kMaxN || heads < 1 || s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pp = (p + 31) / 32 * 32, nn = (n + 31) / 32 * 32;
  if (local_smem(pp, nn) > kMaxSmem)    // kernel.bwd_smem_bytes refuses it
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || s == 0) return static_cast<int>(cudaGetLastError());
  const int nc = (s + kL - 1) / kL;
  const bool states = nc > 1 || dinit != nullptr;
  float* dBh = static_cast<float*>(scratch);
  float* dCh = dBh + size_t(batch) * s * heads * n;
  float* dsl = dCh + size_t(batch) * s * heads * n;
  float* gs = dsl + size_t(batch) * heads * nc * p * n;
  float* decay = gs + size_t(batch) * heads * nc * p * n;
  const float* ds = static_cast<const float*>(dstate);
  const Params P{x, static_cast<const float*>(dt),
                 static_cast<const float*>(A), B, C,
                 static_cast<const float*>(dy), ds,
                 static_cast<const float*>(prev), states ? gs : ds,
                 dsl, gs, decay, static_cast<float*>(dinit), dx,
                 static_cast<float*>(ddt), static_cast<float*>(dda), dBh, dCh,
                 dB, dC, heads, s, p, n, nc, pp, nn, strides[0], strides[1],
                 strides[2], strides[3], strides[4], strides[5], strides[6],
                 strides[7], strides[8], strides[9]};
  const cudaError_t err =
      dtype == 0   ? launch<float>(P, batch, states, stream)
      : dtype == 1 ? launch<__nv_bfloat16>(P, batch, states, stream)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
