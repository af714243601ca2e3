// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface loaded
// with ctypes by repro_torch/kernels/ssd_scan/kernel.py.
//
// Replaces the Pallas TPU kernel ssd_scan_kernel (body _kernel) of
// src/repro/kernels/ssd_scan/kernel.py, and computes the function of the
// JAX model's ssd_scan (src/repro/models/ssm.py) and of the recurrence
// ssd_scan_ref:
//   S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t
// per (batch, head), with the fp32 (p, n) state S carried across chunks.
// Per chunk of kL positions (cum = inclusive cumsum of dt A in the chunk):
//   y   = (C B^T o L)(x dt) + exp(cum) (C S^T),  L[i,j] = exp(cum_i - cum_j)
//         for j <= i and 0 above the diagonal (selected, never multiplied:
//         exp overflows there, and inf * 0 is NaN);
//   S  <- exp(cum_end) S + (x dt exp(cum_end - cum))^T B.
// Any length s: positions past s in the last chunk take dt = 0 and x = 0,
// so their decay is 1 and their update 0, and no y is written there (the
// Pallas wrapper asserts s % chunk == 0 instead).  The chunk is the
// kernel's own (kL = 64), independent of the model's ssm_chunk: it
// changes the rounding, not the function.
//
// Layout: x (b, s, h, p), dt (b, s, h) and B/C (b, s, n) are read in the
// model's layout through their strides (p and n contiguous); B and C are
// shared by the h heads of a batch row and read at row bh / h, with no
// broadcast copy and no transpose.  y is written as (b, s, h, p) fp32 and
// the final state as (b, h, p, n) fp32; an optional initial state
// (b, h, p, n) fp32 (null means zeros).  x, B and C are float32 or
// bfloat16 (widened to fp32 exactly on load); dt, A and every sum fp32.
//
// Bound: the recurrence needs 4 p n flops per (batch, head, position)
// (update and readout), far above its bytes at the model's widths, so
// operations bound it.  Design, simple first: one block of 256 threads
// per (batch, head); each chunk's x dt, B, C, the L-masked score tile and
// the state live in shared memory; every product is fp32 FMAs on the CUDA
// cores, each thread owning a 4 x 4 patch of the score tile, a 4-row x
// (p/16)-column patch of y and a (p/16)-row strip of the state.  The
// chunk's cumsum is one warp's shuffle scan.  No tensor cores, no TMA,
// and C B^T is recomputed by every head of a batch row: those are for a
// later kernel.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kL = 64;            // positions per chunk
constexpr int kThreads = 256;     // 16 x 16
constexpr int kTM = 4;            // score / y rows per thread
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr int kLG = kL + 1;       // padded row stride of the score tile

struct Strides {                  // in elements
  long long x_b, x_s, x_h;        // x (b, s, h, p), p contiguous
  long long dt_b, dt_s, dt_h;     // dt (b, s, h)
  long long B_b, B_s;             // B (b, s, n), n contiguous
  long long C_b, C_s;             // C (b, s, n), n contiguous
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// shared-memory layout, in floats: B and C tiles (kL x ldn), x dt
// (kL x PP), the state (PP x ldn), the score tile (kL x kLG), and four
// kL vectors (dt A, cum, exp(cum_end - cum), exp(cum))
__host__ __device__ inline int row_stride_n(int n) { return n | 1; }
__host__ __device__ inline size_t smem_floats(int pp, int n) {
  const int ldn = row_stride_n(n);
  return size_t(2 * kL + pp) * ldn + size_t(kL) * pp + size_t(kL) * kLG +
         4 * kL;
}

// NJ = padded p / 16: the y columns and state rows each thread owns
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init,
                float* __restrict__ y, float* __restrict__ state_out,
                int heads, int s, int p, int n, Strides st) {
  constexpr int PP = NJ * 16;
  const int ldn = row_stride_n(n);
  extern __shared__ float smem[];
  float* sB = smem;                   // kL x ldn
  float* sC = sB + kL * ldn;          // kL x ldn
  float* sS = sC + kL * ldn;          // PP x ldn
  float* sX = sS + PP * ldn;          // kL x PP (x * dt)
  float* sG = sX + kL * PP;           // kL x kLG
  float* sDa = sG + kL * kLG;         // kL
  float* sCum = sDa + kL;             // kL
  float* sW = sCum + kL;              // kL: exp(cum_end - cum)
  float* sE = sW + kL;                // kL: exp(cum)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const float a = A[h];
  const T* xb = x + b * st.x_b + h * st.x_h;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const T* Bb = Bm + b * st.B_b;
  const T* Cb = Cm + b * st.C_b;

  // state rows >= p and x dt columns >= p stay zero throughout
  for (int i = tid; i < PP * ldn; i += kThreads) {
    const int r = i / ldn, c = i % ldn;
    sS[i] = (init != nullptr && r < p && c < n)
                ? init[(size_t(bh) * p + r) * n + c] : 0.0f;
  }
  for (int i = tid; i < kL * PP; i += kThreads) sX[i] = 0.0f;

  for (int c0 = 0; c0 < s; c0 += kL) {
    __syncthreads();              // last chunk's reads of the tiles done
    for (int i = tid; i < kL * p; i += kThreads) {
      const int l = i / p, c = i % p, pos = c0 + l;
      sX[l * PP + c] = pos < s ? to_f32(xb[pos * st.x_s + c]) *
                                     dtb[pos * st.dt_s]
                               : 0.0f;
    }
    for (int i = tid; i < kL * n; i += kThreads) {
      const int l = i / n, k = i % n, pos = c0 + l;
      const bool ok = pos < s;
      sB[l * ldn + k] = ok ? to_f32(Bb[pos * st.B_s + k]) : 0.0f;
      sC[l * ldn + k] = ok ? to_f32(Cb[pos * st.C_s + k]) : 0.0f;
    }
    if (tid < kL) {
      const int pos = c0 + tid;
      sDa[tid] = pos < s ? dtb[pos * st.dt_s] * a : 0.0f;
    }
    __syncthreads();
    if (tid < 32) {               // inclusive cumsum of dt A, one warp
      float carry = 0.0f;
      for (int base = 0; base < kL; base += 32) {
        float v = sDa[base + tid];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        sCum[base + tid] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cum_end = sCum[kL - 1];
    if (tid < kL) {
      sW[tid] = expf(cum_end - sCum[tid]);
      sE[tid] = expf(sCum[tid]);
    }

    // score tile G = (C B^T) o L
    {
      float g[kTM][4];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
      for (int k = 0; k < n; ++k) {
        float cv[kTM], bv[4];
#pragma unroll
        for (int i = 0; i < kTM; ++i) cv[i] = sC[(ty * kTM + i) * ldn + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + 16 * j) * ldn + k];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int r = ty * kTM + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          sG[r * kLG + c] = c <= r ? g[i][j] * expf(sCum[r] - sCum[c]) : 0.0f;
        }
      }
    }
    __syncthreads();

    // y = exp(cum) (C S^T) + G (x dt)
    {
      float acc[kTM][NJ];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.0f;
      for (int k = 0; k < n; ++k) {
        float cv[kTM], sv[NJ];
#pragma unroll
        for (int i = 0; i < kTM; ++i) cv[i] = sC[(ty * kTM + i) * ldn + k];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) sv[jj] = sS[(tx + 16 * jj) * ldn + k];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
            acc[i][jj] = fmaf(cv[i], sv[jj], acc[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float e = sE[ty * kTM + i];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= e;
      }
      const int j_end = ty * kTM + kTM;   // G is zero past the last row
      for (int j = 0; j < j_end; ++j) {
        float gv[kTM], xv[NJ];
#pragma unroll
        for (int i = 0; i < kTM; ++i) gv[i] = sG[(ty * kTM + i) * kLG + j];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) xv[jj] = sX[j * PP + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
            acc[i][jj] = fmaf(gv[i], xv[jj], acc[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int pos = c0 + ty * kTM + i;
        if (pos >= s) continue;
        float* yrow = y + ((size_t(b) * s + pos) * heads + h) * p;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int c = tx + 16 * jj;
          if (c < p) yrow[c] = acc[i][jj];
        }
      }
    }
    __syncthreads();              // every read of the entering state done

    // S <- exp(cum_end) S + (x dt exp(cum_end - cum))^T B
    {
      const float dec = expf(cum_end);
      for (int k = tx; k < n; k += 16) {
        float acc[NJ];
#pragma unroll
        for (int i = 0; i < NJ; ++i) acc[i] = dec * sS[(ty + 16 * i) * ldn + k];
        for (int l = 0; l < kL; ++l) {
          const float bw = sB[l * ldn + k] * sW[l];
#pragma unroll
          for (int i = 0; i < NJ; ++i)
            acc[i] = fmaf(sX[l * PP + ty + 16 * i], bw, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < NJ; ++i)
          if (ty + 16 * i < p) sS[(ty + 16 * i) * ldn + k] = acc[i];
      }
    }
  }
  __syncthreads();
  float* so = state_out + size_t(bh) * p * n;
  for (int i = tid; i < p * n; i += kThreads)
    so[i] = sS[(i / n) * ldn + i % n];
}

template <typename T, int NJ>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const float* init, float* y,
                   float* state, int batch, int heads, int s, int p, int n,
                   const Strides& st, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T, NJ>;
  const size_t smem = smem_floats(NJ * 16, n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<unsigned(batch) * unsigned(heads), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), init, y, state, heads, s, p, n, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* dt, const float* A,
                     const void* B, const void* C, const float* init, float* y,
                     float* state, int batch, int heads, int s, int p, int n,
                     const Strides& st, cudaStream_t stream) {
  switch ((p + 15) / 16) {
#define REPRO_SSD_CASE(NJ)                                                 \
  case NJ:                                                                 \
    return launch<T, NJ>(x, dt, A, B, C, init, y, state, batch, heads, s,  \
                         p, n, st, stream);
    REPRO_SSD_CASE(1)
    REPRO_SSD_CASE(2)
    REPRO_SSD_CASE(3)
    REPRO_SSD_CASE(4)
    REPRO_SSD_CASE(5)
    REPRO_SSD_CASE(6)
    REPRO_SSD_CASE(7)
    REPRO_SSD_CASE(8)
#undef REPRO_SSD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C).  strides: 10 host integers,
// in elements: x (batch, position, head), dt (batch, position, head),
// B (batch, position), C (batch, position).  init may be null.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* init,
                               void* y, void* state, int dtype, int batch,
                               int heads, int s, int p, int n,
                               const long long* strides,
                               cudaStream_t stream) {
  if (p < 1 || p > kMaxP || n < 1 || n > kMaxN || heads < 1 || s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9]};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* initf = static_cast<const float*>(init);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(x, dtf, Af, B, C, initf, yf, sf, batch, heads, s,
                            p, n, st, stream)
      : dtype == 1
          ? dispatch<__nv_bfloat16>(x, dtf, Af, B, C, initf, yf, sf, batch,
                                    heads, s, p, n, st, stream)
          : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
