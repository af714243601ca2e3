// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface loaded
// with ctypes by repro_torch/kernels/ssd_scan/kernel.py.
//
// Replaces the Pallas TPU kernel ssd_scan_kernel (body _kernel) of
// src/repro/kernels/ssd_scan/kernel.py, and computes the function of the
// JAX model's ssd_scan (src/repro/models/ssm.py) and of the recurrence
// ssd_scan_ref:
//   S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t
// per (batch, head), with the fp32 (p, n) state S.  In the SSD's chunked
// form (Dao & Gu, arXiv:2405.21060 sec. 6-7), per chunk of kL positions
// (cum = inclusive cumsum of dt A in the chunk):
//   y   = (C B^T o L)(x dt) + exp(cum) (C S_prev^T),  L[i,j] = exp(cum_i -
//         cum_j) for j <= i and 0 above the diagonal (selected, never
//         multiplied: exp overflows there, and inf * 0 is NaN);
//   S_c = (x dt exp(cum_end - cum))^T B,   S_next = exp(cum_end) S_prev + S_c.
// Any length s: positions past s in the last chunk take dt = 0 and x = 0,
// so their decay is 1 and their update 0, and no y is written there (the
// Pallas wrapper asserts s % chunk == 0 instead).  The chunk is the
// kernel's own (kL = 64), independent of the model's ssm_chunk: in fp32
// it changes the rounding, not the function.
//
// Layout: x (b, s, h, p), dt (b, s, h) and B/C (b, s, n) are read in the
// model's layout through their strides (p and n contiguous); B and C are
// shared by the h heads of a batch row, with no broadcast copy.  y is
// written as (b, s, h, p) fp32 and the final state as (b, h, p, n) fp32;
// an optional initial state (b, h, p, n) fp32 (null means zeros).  x, B
// and C are float32 or bfloat16 (widened to fp32 exactly); dt, A and
// every sum fp32.
//
// bfloat16: the JAX model's precision policy (src/repro/models/ssm.py
// ssd_scan) keeps the decay math, the states and y_off in fp32 but rounds
// four things to the input dtype, and so does this kernel (round to
// nearest even, then widened again): x dt, B and C (already bf16), the
// masked scores (C_l . B_m) L[l,m] before they multiply x dt, and
// exp(cum_end - cum_l) before the state product.  The rounding points
// are the model's only where both take one chunk: s <= 64 here (the
// model's chunk is 256, or s where 256 does not divide s), which holds
// every training shape of the port (sequence length 64).  For bf16 at s >
// 64 the kernel rounds per 64-position chunk and the model per its own: a
// latent gap that no ported path reaches.  fp32 inputs round nowhere.
//
// Bound: 4 p n flops per (batch, head, position) -- operations at the
// model's widths.  Design: three launches on the caller's stream, every
// one parallel over chunks, so that the card fills at small batch:
//   1. chunk  -- per (b, chunk, head): the chunk's own state S_c (into
//                scratch, p and n padded to 32, in the mma accumulators'
//                order: one float4 per lane) and its decay exp(cum_end);
//                the head-0 block also computes G = C B^T, once per
//                (b, chunk) for all heads;
//   2. pass   -- per (b, head) and float4 of the state: the chunks in
//                order, S_prev <- exp(cum_end) S_prev + S_c from
//                init_state, each chunk's entering state written over its
//                S_c, the final state out (p n elementwise work a chunk);
//   3. output -- per (b, chunk, head): y = exp(cum) (C S_prev^T) +
//                (G o L)(x dt), written once.
// Every product runs on the tensor cores (mma.sync m16n8k8 TF32) with the
// 3xTF32 split a = a_hi + a_lo, a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi
// and fp32 accumulators: fp32-level accuracy, never one-pass TF32.  Tiles
// arrive by 16-byte cp.async where the layout allows it (else plain
// loads).  No atomics: the same inputs give the same bits.
//
// Allocates nothing, and returns cudaGetLastError() so the wrapper can
// raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kL = 64;            // positions per chunk
constexpr int kThreads = 256;     // 8 warps: 2 row halves x 4 column groups
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr int kLdG = kL + 4;      // the score tile's row stride (A operand)

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* init;              // (b, h, p, n) or null
  float* y;                       // (b, s, h, p)
  float* state;                   // (b, h, p, n)
  float* chunk_states;            // (b, h, nc, pp, nn), accumulator order
  float* gram;                    // (b, nc, kL, kL)
  float* decay;                   // (b, h, nc): exp(cum_end)
  int heads, s, p, n, nc;
  int pp, nn;                     // p and n padded to multiples of 32
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, B_b, B_s, C_b, C_s;
  int vec_x, vec_b, vec_c;        // 16-byte copies allowed
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// v rounded to T and widened again: the identity for float
template <typename T> __device__ __forceinline__ float round_as(float v) {
  return sizeof(T) == 2 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// rows x cols elements from global (row r at src + r * gs) into shared
// (row stride ld); rows >= valid and columns in [cols, cols_pad) are zero.
// 16-byte cp.async when vec (the caller commits), else plain loads.
template <typename T>
__device__ void load_rows(T* dst, int ld, const T* src, long long gs,
                          int rows, int valid, int cols, int cols_pad,
                          bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kE = 16 / sizeof(T);
    const int pieces = cols / kE;
    for (int i = tid; i < rows * pieces; i += kThreads) {
      const int r = i / pieces, c = (i % pieces) * kE;
      const bool ok = r < valid;
      cp_async16(dst + r * ld + c, ok ? src + r * gs + c : src, ok);
    }
    const int pad = cols_pad - cols;
    if (pad > 0)
      for (int i = tid; i < rows * pad; i += kThreads)
        dst[(i / pad) * ld + cols + i % pad] = zero<T>();
  } else {
    for (int i = tid; i < rows * cols_pad; i += kThreads) {
      const int r = i / cols_pad, c = i % cols_pad;
      dst[r * ld + c] = (r < valid && c < cols) ? src[r * gs + c] : zero<T>();
    }
  }
}

// v0, v1 into row[col], row[col + 1] where they lie below p: one 8-byte
// store when p is even (col always is)
__device__ __forceinline__ void store_pair(float* row, int col, int p,
                                           float v0, float v1) {
  if ((p & 1) == 0 && col < p) {
    *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
  } else {
    if (col < p) row[col] = v0;
    if (col + 1 < p) row[col + 1] = v1;
  }
}

// inclusive cumsum of dt A over one chunk, one warp: lane holds positions
// lane and lane + 32 (da[0], da[1]) -> cum at both; returns cum_end
__device__ __forceinline__ float chunk_cumsum(float (&da)[2],
                                              float (&cum)[2], int lane) {
  float carry = 0.0f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v = da[half];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    cum[half] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  return carry;
}


// x dt over one chunk into sX (fp32, row stride ldx, columns pp): from
// sX itself (float32 x, loaded there) or from sXr (bfloat16 x, pp stride,
// and x dt rounded to bfloat16 as the model rounds it)
template <typename T>
__device__ __forceinline__ void scale_x(float* sX, int ldx, const T* sXr,
                                        const float* sDt, int pp) {
  for (int i = threadIdx.x; i < kL * pp; i += kThreads) {
    const int l = i / pp, cc = i % pp;
    const float v =
        sizeof(T) == 2 ? to_f32(sXr[l * pp + cc]) : sX[l * ldx + cc];
    sX[l * ldx + cc] = round_as<T>(v * sDt[l]);
  }
}

// x (rows of p at head h) into sX (float32) or sXr (bfloat16, widened by
// scale_x); the caller commits
template <typename T>
__device__ __forceinline__ void load_x(const Params& P, float* sX, int ldx,
                                       T* sXr, int b, int h, int pos0,
                                       int valid) {
  const T* xb = static_cast<const T*>(P.x) + b * P.x_b + h * P.x_h +
                pos0 * P.x_s;
  if (sizeof(T) == 2)
    load_rows(sXr, P.pp, xb, P.x_s, kL, valid, P.p, P.pp, P.vec_x);
  else
    load_rows(reinterpret_cast<T*>(sX), ldx, xb, P.x_s, kL, valid, P.p,
              P.pp, P.vec_x);
}

// ---- 1. chunk: S_c and its decay per (b, chunk, head); G per (b, chunk) --
__host__ __device__ inline size_t chunk_union_bytes(int pp, int nn,
                                                    int esize) {
  // x dt (fp32) and bfloat16 x, or C for G (head 0 only, before x)
  const size_t x = sizeof(float) * size_t(kL) * (pp + 8) +
                   (esize == 2 ? size_t(kL) * pp * esize : 0);
  const size_t c = size_t(kL) * (nn + 16 / esize) * esize;
  return x > c ? x : c;
}
__host__ __device__ inline size_t chunk_smem(int pp, int nn, int esize) {
  return chunk_union_bytes(pp, nn, esize) +
         size_t(kL) * (nn + 32 / esize) * esize + sizeof(float) * 2 * kL;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = P.pp + 8;       // x dt, row stride (B-operand layout)
  const int ldb = P.nn + 32 / int(sizeof(T));
  const int lda = P.nn + 16 / int(sizeof(T));
  const size_t ub = chunk_union_bytes(P.pp, P.nn, sizeof(T));
  float* sX = reinterpret_cast<float*>(smem);     // kL x ldx: x dt
  T* sXr = reinterpret_cast<T*>(sX + kL * ldx);   // kL x pp (bfloat16 x)
  T* sCg = reinterpret_cast<T*>(smem);            // kL x lda: C, head 0
  T* sB = reinterpret_cast<T*>(smem + ub);        // kL x ldb
  float* sDt = reinterpret_cast<float*>(sB + kL * ldb);  // kL
  float* sW = sDt + kL;           // kL: exp(cum_end - cum), rounded as T

  const int h = blockIdx.x % P.heads, bc = blockIdx.x / P.heads;
  const int b = bc / P.nc, c = bc % P.nc;
  const int pos0 = c * kL, valid = min(kL, P.s - pos0);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  load_rows(sB, ldb, static_cast<const T*>(P.B) + b * P.B_b + pos0 * P.B_s,
            P.B_s, kL, valid, P.n, P.nn, P.vec_b);
  if (h == 0)
    load_rows(sCg, lda, static_cast<const T*>(P.C) + b * P.C_b + pos0 * P.C_s,
              P.C_s, kL, valid, P.n, P.nn, P.vec_c);
  else
    load_x(P, sX, ldx, sXr, b, h, pos0, valid);
  cp_async_commit();
  if (w == 0) {
    const float a = P.A[h];
    float dtv[2], da[2], cum[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int l = lane + 32 * half;
      dtv[half] = l < valid ? P.dt[b * P.dt_b + (pos0 + l) * P.dt_s +
                                   h * P.dt_h]
                            : 0.0f;
      da[half] = dtv[half] * a;
    }
    const float cum_end = chunk_cumsum(da, cum, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int l = lane + 32 * half;
      sDt[l] = dtv[half];
      sW[l] = round_as<T>(expf(cum_end - cum[half]));
    }
    if (lane == 0)
      P.decay[(size_t(b) * P.heads + h) * P.nc + c] = expf(cum_end);
  }
  cp_async_wait_all();
  __syncthreads();

  if (h == 0) {
    // G = C B^T, once for every head of (b, chunk): warp w < 4 takes rows
    // [16 w, 16 w + 16) and the column tiles at or below the diagonal
    const int r0 = 16 * (w & 3), ntiles = w < 4 ? 2 * w + 2 : 0;
    float acc[1][8][4] = {};
#pragma unroll 4
    for (int k0 = 0; k0 < P.nn; k0 += 8) {
      const T* ar = sCg + (r0 + g) * lda + k0 + t;
      float av[4] = {to_f32(ar[0]), to_f32(ar[8 * lda]), to_f32(ar[4]),
                     to_f32(ar[8 * lda + 4])};
      uint32_t ah[1][4], al[1][4], bh[8][2], bl[8][2];
      split(av, ah[0], al[0]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < ntiles) {
          const T* br = sB + (8 * nt + g) * ldb + k0 + t;
          float bv[2] = {to_f32(br[0]), to_f32(br[4])};
          split(bv, bh[nt], bl[nt]);
        }
      }
      mma3(acc, ah, al, bh, bl, 0, 1, ntiles);
    }
    float* G = P.gram + size_t(bc) * kL * kL;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < ntiles) {
        const int col = 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(G + (r0 + g) * kL + col) =
            make_float2(acc[0][nt][0], acc[0][nt][1]);
        *reinterpret_cast<float2*>(G + (r0 + g + 8) * kL + col) =
            make_float2(acc[0][nt][2], acc[0][nt][3]);
      }
    }
    __syncthreads();              // C's space takes x
    load_x(P, sX, ldx, sXr, b, h, pos0, valid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }
  scale_x(sX, ldx, sXr, sDt, P.pp);
  __syncthreads();

  // S_c = (x dt exp(cum_end - cum))^T B: warp w takes n-columns
  // [8 ng nq, 8 (ng + 1) nq), ng = w % 4, and half w / 4 of the p rows,
  // two 16-row tiles at a time
  const int nq = P.nn / 32, ng = w & 3;
  const int mhalf = P.pp / 32, m_lo = (w >> 2) * mhalf;
  float4* Sc = reinterpret_cast<float4*>(
      P.chunk_states + ((size_t(b) * P.heads + h) * P.nc + c) * P.pp * P.nn);
  for (int mg = m_lo; mg < m_lo + mhalf; mg += 2) {
    const int mcount = min(2, m_lo + mhalf - mg);
    float acc[2][4][4] = {};
#pragma unroll
    for (int ks = 0; ks < kL / 8; ++ks) {
      const int k0 = 8 * ks;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj < nq) {
          const T* br = sB + (k0 + t) * ldb + 8 * (ng * nq + jj) + g;
          float bv[2] = {to_f32(br[0]), to_f32(br[4 * ldb])};
          split(bv, bh[jj], bl[jj]);
        }
      }
      const float w0 = sW[k0 + t], w1 = sW[k0 + t + 4];
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (mi >= mcount) continue;
        const int r = 16 * (mg + mi) + g;
        const float* x0 = sX + (k0 + t) * ldx + r;
        const float* x1 = sX + (k0 + t + 4) * ldx + r;
        float av[4] = {x0[0] * w0, x0[8] * w0, x1[0] * w1, x1[8] * w1};
        split(av, ah[mi], al[mi]);
      }
      mma3(acc, ah, al, bh, bl, 0, mcount, nq);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (mi >= mcount) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj >= nq) continue;
        const int tile = (mg + mi) * (P.nn / 8) + ng * nq + jj;
        Sc[tile * 32 + lane] = make_float4(acc[mi][jj][0], acc[mi][jj][1],
                                           acc[mi][jj][2], acc[mi][jj][3]);
      }
    }
  }
}

// row, column of value q of accumulator-order float4 u in a (pp, nn)
// state: tile u / 32 of 16 x 8, lane u % 32 = 4 g + t holds (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
__device__ __forceinline__ void frag_rc(int u, int nn, int& r, int& j) {
  const int n8 = nn / 8, tile = u >> 5, ln = u & 31;
  r = 16 * (tile / n8) + (ln >> 2);
  j = 8 * (tile % n8) + 2 * (ln & 3);
}

// ---- 2. pass: the chunks in order per (b, head), elementwise ----
__global__ void __launch_bounds__(kThreads) ssd_pass_kernel(const Params P) {
  const int units = P.pp * P.nn / 4;              // float4s per state
  const int per_bh = (units + kThreads - 1) / kThreads;
  const int bh = blockIdx.x / per_bh;
  const int u = (blockIdx.x % per_bh) * kThreads + threadIdx.x;
  if (u >= units) return;
  int r, j;
  frag_rc(u, P.nn, r, j);
  const size_t base = size_t(bh) * P.p * P.n;
  auto in = [&](int rr, int jj) { return rr < P.p && jj < P.n; };
  float4 S = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (P.init != nullptr) {
    const float* ib = P.init + base;
    if (in(r, j)) S.x = ib[r * P.n + j];
    if (in(r, j + 1)) S.y = ib[r * P.n + j + 1];
    if (in(r + 8, j)) S.z = ib[(r + 8) * P.n + j];
    if (in(r + 8, j + 1)) S.w = ib[(r + 8) * P.n + j + 1];
  }
  float4* st = reinterpret_cast<float4*>(P.chunk_states) +
               size_t(bh) * P.nc * units + u;
  const float* dec = P.decay + size_t(bh) * P.nc;
  constexpr int kAhead = 8;       // chunks whose loads are in flight at once
  for (int c0 = 0; c0 < P.nc; c0 += kAhead) {
    float4 sc[kAhead];
    float d[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < P.nc) {
        sc[i] = __ldcs(st + size_t(c0 + i) * units);
        d[i] = dec[c0 + i];
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < P.nc) {
        __stcs(st + size_t(c0 + i) * units, S);  // the state entering it
        S = make_float4(d[i] * S.x + sc[i].x, d[i] * S.y + sc[i].y,
                        d[i] * S.z + sc[i].z, d[i] * S.w + sc[i].w);
      }
    }
  }
  float* so = P.state + base;
  if (in(r, j)) so[r * P.n + j] = S.x;
  if (in(r, j + 1)) so[r * P.n + j + 1] = S.y;
  if (in(r + 8, j)) so[(r + 8) * P.n + j] = S.z;
  if (in(r + 8, j + 1)) so[(r + 8) * P.n + j + 1] = S.w;
}

// ---- 3. output: y per (b, chunk, head) ----
__host__ __device__ inline size_t output_smem(int pp, int nn, int esize) {
  return sizeof(float) * (size_t(kL) * kLdG + size_t(kL) * (pp + 8) +
                          size_t(pp) * nn + 8 * kL) +
         size_t(kL) * (nn + 16 / esize) * esize +
         (esize == 2 ? size_t(kL) * pp * esize : 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_output_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = P.pp + 8;
  const int lda = P.nn + 16 / int(sizeof(T));
  float* sM = reinterpret_cast<float*>(smem);     // kL x kLdG: G, G o L
  float* sX = sM + kL * kLdG;                     // kL x ldx: x dt
  float* sS = sX + kL * ldx;                      // pp x nn: S_prev, acc order
  float* sDt = sS + P.pp * P.nn;                  // kL
  float* sCum = sDt + kL;                         // kL
  float* sE = sCum + kL;                          // kL: exp(cum)
  float* sER = sE + kL;           // kL: exp(cum_i - cum_{16 floor(i / 16)})
  float* sEC = sER + kL;          // 4 x kL: exp(cum_{16 q} - cum_j), j < 16 q
  T* sC = reinterpret_cast<T*>(sEC + 4 * kL);     // kL x lda
  T* sXr = sC + kL * lda;                         // kL x pp (bfloat16 x)

  const int h = blockIdx.x % P.heads, bc = blockIdx.x / P.heads;
  const int b = bc / P.nc, c = bc % P.nc;
  const int pos0 = c * kL, valid = min(kL, P.s - pos0);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // two groups: what the readout takes, then what y_diag takes
  load_rows(sC, lda, static_cast<const T*>(P.C) + b * P.C_b + pos0 * P.C_s,
            P.C_s, kL, valid, P.n, P.nn, P.vec_c);
  load_rows(sS, P.nn,
            P.chunk_states + ((size_t(b) * P.heads + h) * P.nc + c) * P.pp *
                                 P.nn,
            P.nn, P.pp, P.pp, P.nn, P.nn, true);
  cp_async_commit();
  load_rows(sM, kLdG, P.gram + size_t(bc) * kL * kL, kL, kL, kL, kL, kL,
            true);
  load_x(P, sX, ldx, sXr, b, h, pos0, valid);
  cp_async_commit();
  if (w == 0) {
    const float a = P.A[h];
    float dtv[2], da[2], cum[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int l = lane + 32 * half;
      dtv[half] = l < valid ? P.dt[b * P.dt_b + (pos0 + l) * P.dt_s +
                                   h * P.dt_h]
                            : 0.0f;
      da[half] = dtv[half] * a;
    }
    chunk_cumsum(da, cum, lane);
    // the factors of L off the diagonal 16 x 16 blocks: for i in row tile
    // q and j < 16 q, cum_i - cum_j = (cum_i - cum_{16 q}) + (cum_{16 q} -
    // cum_j), both <= 0, so neither factor overflows
    float head[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      head[q] = __shfl_sync(0xffffffffu, cum[q >> 1], 16 * (q & 1));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int l = lane + 32 * half;
      sDt[l] = dtv[half];
      sCum[l] = cum[half];
      sE[l] = expf(cum[half]);
      sER[l] = expf(cum[half] - head[l >> 4]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sEC[q * kL + l] = l < 16 * q ? expf(head[q] - cum[half]) : 0.0f;
    }
  }
  cp_async_wait_group<1>();       // C and S_prev
  __syncthreads();

  // warp w takes p-columns [8 ng nj, 8 (ng + 1) nj), ng = w % 4, of the
  // two 16-row tiles [2 mh, 2 mh + 2), mh = w / 4
  const int nj = P.pp / 32, ng = w & 3, m0 = 2 * (w >> 2);
  float acc[2][4][4] = {};
  // y_off = C S_prev^T, then scaled by exp(cum) row by row.  B[k][n] =
  // S_prev[n][k] is read from the accumulator order: row n = 8 nt + g is
  // lane 4 (n % 8) + ., half n / 8 % 2 of tile (n / 16, k / 8)
#pragma unroll 2
  for (int k0 = 0; k0 < P.nn; k0 += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const T* ar = sC + (16 * (m0 + mi) + g) * lda + k0 + t;
      float av[4] = {to_f32(ar[0]), to_f32(ar[8 * lda]), to_f32(ar[4]),
                     to_f32(ar[8 * lda + 4])};
      split(av, ah[mi], al[mi]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (jj < nj) {
        const int nt = ng * nj + jj;
        const float* tile =
            sS + ((nt >> 1) * (P.nn / 8) + (k0 >> 3)) * 128 + (nt & 1) * 2;
        float bv[2] = {tile[(4 * g + (t >> 1)) * 4 + (t & 1)],
                       tile[(4 * g + 2 + (t >> 1)) * 4 + (t & 1)]};
        split(bv, bh[jj], bl[jj]);
      }
    }
    mma3(acc, ah, al, bh, bl, 0, 2, nj);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const float e0 = sE[16 * (m0 + mi) + g], e1 = sE[16 * (m0 + mi) + g + 8];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      acc[mi][jj][0] *= e0;
      acc[mi][jj][1] *= e0;
      acc[mi][jj][2] *= e1;
      acc[mi][jj][3] *= e1;
    }
  }

  cp_async_wait_group<0>();       // G and x
  __syncthreads();
  scale_x(sX, ldx, sXr, sDt, P.pp);
  // G o L by 16 x 16 blocks: the diagonal ones by exp of the difference,
  // those below by the two factors, those above 0 (rounded to bfloat16
  // for bfloat16 inputs, as the model rounds the masked scores)
  for (int i = tid; i < kL * kL; i += kThreads) {
    const int blk = i >> 8, rr = (i >> 4) & 15, jj = i & 15;
    const int R = blk >> 2, Cb = blk & 3;       // row and column tiles
    const int r = 16 * R + rr, j = 16 * Cb + jj;
    float* m = sM + r * kLdG + j;
    if (Cb == R)
      *m = jj <= rr ? round_as<T>(*m * expf(sCum[r] - sCum[j])) : 0.0f;
    else if (Cb < R)
      *m = round_as<T>(*m * sER[r] * sEC[R * kL + j]);
    else
      *m = 0.0f;
  }
  __syncthreads();

  // y_diag = (G o L) (x dt), added to the same accumulators
#pragma unroll
  for (int ks = 0; ks < kL / 8; ++ks) {
    const int k0 = 8 * ks;
    if (ks > 2 * m0 + 3) break;   // every tile of this warp is above it
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (jj < nj) {
        const int col = 8 * (ng * nj + jj) + g;
        float bv[2] = {sX[(k0 + t) * ldx + col], sX[(k0 + t + 4) * ldx + col]};
        split(bv, bh[jj], bl[jj]);
      }
    }
    // tiles above the diagonal: G o L is 0
    const int mi_lo = max(0, ks / 2 - m0);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (mi < mi_lo) continue;
      const float* ar = sM + (16 * (m0 + mi) + g) * kLdG + k0 + t;
      float av[4] = {ar[0], ar[8 * kLdG], ar[4], ar[8 * kLdG + 4]};
      split(av, ah[mi], al[mi]);
    }
    mma3(acc, ah, al, bh, bl, mi_lo, 2, nj);
  }
  float* yb = P.y + (size_t(b) * P.s * P.heads + h) * P.p;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (jj >= nj) continue;
      const int col = 8 * (ng * nj + jj) + 2 * t;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int l = 16 * (m0 + mi) + g + 8 * hr;
        if (l < valid)
          store_pair(yb + size_t(pos0 + l) * P.heads * P.p, col, P.p,
                     acc[mi][jj][2 * hr], acc[mi][jj][2 * hr + 1]);
      }
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
cudaError_t launch(const Params& P, int batch, cudaStream_t stream) {
  const int es = sizeof(T);
  const unsigned chunks = unsigned(batch) * P.nc * P.heads;
  const unsigned units = P.pp * P.nn / 4;
  cudaError_t err = run(ssd_chunk_kernel<T>, chunks,
                        chunk_smem(P.pp, P.nn, es), P, stream);
  if (err == cudaSuccess)
    err = run(ssd_pass_kernel, unsigned(batch) * P.heads *
                                   ((units + kThreads - 1) / kThreads),
              0, P, stream);
  if (err == cudaSuccess)
    err = run(ssd_output_kernel<T>, chunks, output_smem(P.pp, P.nn, es), P,
              stream);
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C).  strides: 10 host integers,
// in elements: x (batch, position, head), dt (batch, position, head),
// B (batch, position), C (batch, position).  init may be null.  scratch:
// b h nc pp nn + b nc 64 64 + b h nc floats (nc = ceil(s / 64), pp and nn
// = p and n rounded up to 32).  vec: bit 0 x, bit 1 B, bit 2 C may be
// copied 16 bytes at a time.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* init,
                               void* y, void* state, void* scratch, int dtype,
                               int batch, int heads, int s, int p, int n,
                               int vec, const long long* strides,
                               cudaStream_t stream) {
  if (p < 1 || p > kMaxP || n < 1 || n > kMaxN || heads < 1 || s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  const int nc = (s + kL - 1) / kL;
  const int pp = (p + 31) / 32 * 32, nn = (n + 31) / 32 * 32;
  float* states = static_cast<float*>(scratch);
  float* gram = states + size_t(batch) * heads * nc * pp * nn;
  float* decay = gram + size_t(batch) * nc * kL * kL;
  const Params P{x, static_cast<const float*>(dt),
                 static_cast<const float*>(A), B, C,
                 static_cast<const float*>(init), static_cast<float*>(y),
                 static_cast<float*>(state), states, gram, decay, heads, s,
                 p, n, nc, pp, nn, strides[0], strides[1], strides[2],
                 strides[3], strides[4], strides[5], strides[6], strides[7],
                 strides[8], strides[9], vec & 1, (vec >> 1) & 1,
                 (vec >> 2) & 1};
  const cudaError_t err =
      dtype == 0   ? launch<float>(P, batch, stream)
      : dtype == 1 ? launch<__nv_bfloat16>(P, batch, stream)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
