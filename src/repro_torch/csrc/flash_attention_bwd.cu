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
//   dP = dO v^T,   D = rowsum(P dP),   dS = P (dP - D)
//   dv = P^T dO,   dk = dS^T q d^-1/2,   dq = dS k d^-1/2
// P is recomputed from the forward's per-row log-sum-exp (fp32 (b, h, sq),
// natural log of the scaled scores) and renormalised here:
//   P~ = exp2(S d^-1/2 log2 e - lse log2 e),   l = rowsum(P~),   P = P~ / l.
// l is 1 up to rounding, but dividing by it cancels any error common to a
// row: the fp32 lse near 8 carries ~1e-6 of rounding, and the forward's
// 3xTF32 scores differ from these fp32 ones, and either put dq's and dk's
// errors against float64 at over twice the plain version's on an H100.
// For the same reason D is summed from P dP here, not taken as
// rowsum(dO o) (FlashAttention-2's shortcut reads the forward's o).
// GQA: query head h reads kv head h / g; dk and dv sum over the g query
// heads of the group.
//
// Layout and types: q, dO (b, sq, h, d) and k, v (b, sk, m, d) read in
// place through their batch/position/head strides (head_dim contiguous),
// float32 or bfloat16, widened to fp32 in shared memory; dq (b, sq, h, d)
// and dk, dv (b, sk, m, d) are written contiguous in the input type; every
// sum is fp32.  Any head_dim <= 128, any sq and sk (ragged tiles masked).
//
// Bound: five s x s x d products (the two recomputed score products S and
// dP, and dv, dk, dq), about halved when causal, far above the bytes of the
// tensors.  A simple design, on the CUDA cores in fp32 FMAs, that does
// nine: S and dP three times each.
// - Two launches on the caller's stream: dq (one block of 256 threads per
//   (b, query head, 64-row tile), heavy causal tiles first, walking the
//   64-key tiles its rows can see twice: once for l and D, which it also
//   writes out, then for dq); then dk and dv (one block per (b, kv head,
//   64-key tile), walking the g query heads of its group and the query
//   tiles that can see its keys, 32 rows at a time: the block owns its
//   keys' gradients, so no atomics).
// - Each step stages the two tiles in shared memory (rows padded to an odd
//   stride, so a warp's reads of 32 rows at one column are conflict-free),
//   computes the tile's S and dP (each thread 8 or 16 entries of one
//   column, the other operand broadcast), writes P and dS to shared memory,
//   and accumulates the products it owns from there.
// - Each step's contribution is summed from zero and then added to the
//   fp32 accumulator, so long sums lose fewer bits (as the forward does).
//
// Allocates nothing (l and D live in a scratch buffer the wrapper
// allocates), and returns cudaGetLastError() so the wrapper can raise on a
// refused launch.  dq's launch must finish before dk/dv's, which reads l
// and D: both run on one stream, in that order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;    // keys per dk/dv block and per dq step
constexpr int kBQ = 32;    // query rows per dk/dv step
constexpr int kBQ2 = 64;   // query rows per dq block
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {           // in elements; head_dim is contiguous
  long long b, s, h;
};

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;        // (b, h, sq) from the forward
  float* rows;             // (b, h, sq, 2) scratch: l and D per row
  T* dq;
  T* dk;
  T* dv;
  int batch, heads, kv_heads, group, sq, sk, d;
  Strides qs, ks, vs, dos;
  float sm_scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [r0, r0 + n) of one head of a (b, s, head) strided tensor into a
// shared n x ld fp32 tile; rows at or past `limit` are zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          long long row_stride, int r0, int n,
                                          int limit, int d) {
  for (int idx = threadIdx.x; idx < n * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    const int row = r0 + r;
    dst[r * ld + c] =
        row < limit ? to_f32(base[static_cast<long long>(row) * row_stride + c])
                    : 0.0f;
  }
}

// S = Q K^T and dP = dO V^T over an NI x NJ tile (query rows q0 + i, keys
// k0 + j) from shared tiles; P = exp2(S scale2 - rm) / rl where the mask
// keeps the pair, else 0; writes P (when Ps is not null) and dS = P (dP -
// D) (with rl = 1 and D = 0: P~ and P~ dP, the terms of l and D).  Thread
// t takes key column t % NJ and rows t / NJ + (256 / NJ) r.
template <int NI, int NJ>
__device__ __forceinline__ void p_ds_tile(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    int ld, int d, const float* rm, const float* rl, const float* dl, int q0,
    int k0, int sq, int sk, int causal, float scale2, float* Ps, float* dSs,
    int ldp) {
  constexpr int kRows = kThreads / NJ;
  constexpr int kR = NI / kRows;
  const int j = threadIdx.x % NJ, i0 = threadIdx.x / NJ;
  float s[kR], dp[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) s[r] = dp[r] = 0.0f;
  for (int c = 0; c < d; ++c) {
    const float kc = Ks[j * ld + c], vc = Vs[j * ld + c];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = i0 + kRows * r;
      s[r] = fmaf(Qs[i * ld + c], kc, s[r]);
      dp[r] = fmaf(dOs[i * ld + c], vc, dp[r]);
    }
  }
  const int key = k0 + j;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + kRows * r, row = q0 + i;
    const bool keep = row < sq && key < sk && !(causal && key > row);
    const float p = keep ? exp2f(s[r] * scale2 - rm[i]) / rl[i] : 0.0f;
    if (Ps != nullptr) Ps[i * ldp + j] = p;
    dSs[i * ldp + j] = p * (dp[r] - dl[i]);
  }
}

// lse (as base 2) of query rows [q0, q0 + n) of one head into shared, and
// their l and D from ``rows`` unless it is null (then 1 and 0); rows past
// sq get (0, 1, 0)
template <int N>
__device__ __forceinline__ void load_rows(float* rm, float* rl, float* dl,
                                          const float* lse,
                                          const float* rows, int q0,
                                          int sq) {
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const int row = q0 + i;
    const bool ok = row < sq;
    rm[i] = ok ? lse[row] * kLog2e : 0.0f;
    rl[i] = ok && rows != nullptr ? rows[2 * row] : 1.0f;
    dl[i] = ok && rows != nullptr ? rows[2 * row + 1] : 0.0f;
  }
}

template <int NC>
__host__ __device__ constexpr size_t dkdv_smem_floats() {
  return size_t(2 * kBK + 2 * kBQ) * (16 * NC + 1) +
         size_t(2 * kBQ) * (kBK + 1) + 3 * kBQ;
}
template <int NC>
__host__ __device__ constexpr size_t dq_smem_floats() {
  return size_t(2 * kBQ2 + 2 * kBK) * (16 * NC + 1) +
         size_t(2 * kBQ2) * (kBK + 1) + 3 * kBQ2;
}

// dk and dv of one (b, kv head, 64-key tile); NC = padded head_dim / 16
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Params<T> P) {
  constexpr int kDP = 16 * NC, kLD = kDP + 1, kLDP = kBK + 1;
  constexpr int kU = kBK * kDP / kThreads;   // accumulator entries a thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * kLD;
  float* Qs = Vs + kBK * kLD;
  float* dOs = Qs + kBQ * kLD;
  float* Ps = dOs + kBQ * kLD;
  float* dSs = Ps + kBQ * kLDP;
  float* rm = dSs + kBQ * kLDP;
  float* rl = rm + kBQ;
  float* dl = rl + kBQ;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / P.kv_heads, kvh = blockIdx.x % P.kv_heads;
  const int k0 = blockIdx.y * kBK;
  load_tile(Ks, kLD, P.k + b * P.ks.b + kvh * P.ks.h, P.ks.s, k0, kBK, P.sk,
            P.d);
  load_tile(Vs, kLD, P.v + b * P.vs.b + kvh * P.vs.h, P.vs.s, k0, kBK, P.sk,
            P.d);
  const float scale2 = P.sm_scale * kLog2e;

  float dk[kU], dv[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) dk[u] = dv[u] = 0.0f;
  // query rows before k0 see none of these keys when causal
  const int q_first = P.causal ? (k0 / kBQ) * kBQ : 0;
  for (int gi = 0; gi < P.group; ++gi) {
    const int h = kvh * P.group + gi;
    const T* qb = P.q + b * P.qs.b + h * P.qs.h;
    const T* dob = P.dout + b * P.dos.b + h * P.dos.h;
    const long long row0 = (static_cast<long long>(b) * P.heads + h) * P.sq;
    for (int q0 = q_first; q0 < P.sq; q0 += kBQ) {
      __syncthreads();              // the last step's readers are done
      load_tile(Qs, kLD, qb, P.qs.s, q0, kBQ, P.sq, P.d);
      load_tile(dOs, kLD, dob, P.dos.s, q0, kBQ, P.sq, P.d);
      load_rows<kBQ>(rm, rl, dl, P.lse + row0, P.rows + 2 * row0, q0, P.sq);
      __syncthreads();
      p_ds_tile<kBQ, kBK>(Qs, dOs, Ks, Vs, kLD, P.d, rm, rl, dl, q0, k0,
                          P.sq, P.sk, P.causal, scale2, Ps, dSs, kLDP);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = tid + kThreads * u, r = e / kDP, c = e % kDP;
        if (c >= P.d) continue;
        float tv = 0.0f, tk = 0.0f;
#pragma unroll 8
        for (int i = 0; i < kBQ; ++i) {
          tv = fmaf(Ps[i * kLDP + r], dOs[i * kLD + c], tv);
          tk = fmaf(dSs[i * kLDP + r], Qs[i * kLD + c], tk);
        }
        dv[u] += tv;
        dk[u] += tk;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int e = tid + kThreads * u, r = e / kDP, c = e % kDP;
    const int key = k0 + r;
    if (c >= P.d || key >= P.sk) continue;
    const long long at =
        ((static_cast<long long>(b) * P.sk + key) * P.kv_heads + kvh) * P.d +
        c;
    store(P.dk + at, dk[u] * P.sm_scale);
    store(P.dv + at, dv[u]);
  }
}

// l, D and dq of one (b, query head, 64-row tile)
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params<T> P) {
  constexpr int kDP = 16 * NC, kLD = kDP + 1, kLDP = kBK + 1;
  constexpr int kU = kBQ2 * kDP / kThreads;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBQ2 * kLD;
  float* Ks = dOs + kBQ2 * kLD;
  float* Vs = Ks + kBK * kLD;
  float* Ps = Vs + kBK * kLD;
  float* dSs = Ps + kBQ2 * kLDP;
  float* rm = dSs + kBQ2 * kLDP;
  float* rl = rm + kBQ2;
  float* dl = rl + kBQ2;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / P.heads, h = blockIdx.x % P.heads;
  const int kvh = h / P.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ2;   // heavy tiles first
  const long long row0 = (static_cast<long long>(b) * P.heads + h) * P.sq;
  load_tile(Qs, kLD, P.q + b * P.qs.b + h * P.qs.h, P.qs.s, q0, kBQ2, P.sq,
            P.d);
  load_tile(dOs, kLD, P.dout + b * P.dos.b + h * P.dos.h, P.dos.s, q0, kBQ2,
            P.sq, P.d);
  load_rows<kBQ2>(rm, rl, dl, P.lse + row0, nullptr, q0, P.sq);
  const T* kb = P.k + b * P.ks.b + kvh * P.ks.h;
  const T* vb = P.v + b * P.vs.b + kvh * P.vs.h;
  const float scale2 = P.sm_scale * kLog2e;
  const int k_end = P.causal ? min(P.sk, min(q0 + kBQ2, P.sq)) : P.sk;

  auto stage = [&](int k0) {        // K/V tile k0 into shared
    __syncthreads();                // the last step's readers are done
    load_tile(Ks, kLD, kb, P.ks.s, k0, kBK, P.sk, P.d);
    load_tile(Vs, kLD, vb, P.vs.s, k0, kBK, P.sk, P.d);
    __syncthreads();
  };
  // pass 1: l = rowsum(P~) and D = rowsum(P~ dP) / l, each tile's part
  // summed from zero (rl is 1 and dl 0 here, so the tile's P is P~ and its
  // dS is P~ dP); thread i < 64 owns row i
  float l_acc = 0.0f, d_acc = 0.0f;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    stage(k0);
    p_ds_tile<kBQ2, kBK>(Qs, dOs, Ks, Vs, kLD, P.d, rm, rl, dl, q0, k0,
                         P.sq, P.sk, P.causal, scale2, Ps, dSs, kLDP);
    __syncthreads();
    if (tid < kBQ2) {
      float tl = 0.0f, td = 0.0f;
      for (int j = 0; j < kBK; ++j) {
        tl += Ps[tid * kLDP + j];
        td += dSs[tid * kLDP + j];
      }
      l_acc += tl;
      d_acc += td;
    }
  }
  __syncthreads();                  // every pass-1 read of rl and dl is done
  if (tid < kBQ2) {
    const float l = fmaxf(l_acc, 1e-30f), dd = d_acc / l;
    rl[tid] = l;
    dl[tid] = dd;
    if (q0 + tid < P.sq) {
      P.rows[2 * (row0 + q0 + tid)] = l;
      P.rows[2 * (row0 + q0 + tid) + 1] = dd;
    }
  }

  // pass 2: dS = P (dP - D) and dq = dS K
  float dq[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) dq[u] = 0.0f;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    stage(k0);
    p_ds_tile<kBQ2, kBK>(Qs, dOs, Ks, Vs, kLD, P.d, rm, rl, dl, q0, k0,
                         P.sq, P.sk, P.causal, scale2, nullptr, dSs, kLDP);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = tid + kThreads * u, i = e / kDP, c = e % kDP;
      if (c >= P.d) continue;
      float t = 0.0f;
#pragma unroll 8
      for (int j = 0; j < kBK; ++j)
        t = fmaf(dSs[i * kLDP + j], Ks[j * kLD + c], t);
      dq[u] += t;
    }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int e = tid + kThreads * u, i = e / kDP, c = e % kDP;
    const int row = q0 + i;
    if (c >= P.d || row >= P.sq) continue;
    const long long at =
        ((static_cast<long long>(b) * P.sq + row) * P.heads + h) * P.d + c;
    store(P.dq + at, dq[u] * P.sm_scale);
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <typename T, int NC>
cudaError_t launch(const Params<T>& P, cudaStream_t stream) {
  const size_t dq_bytes = sizeof(float) * dq_smem_floats<NC>();
  cudaError_t err = allow_smem(dq_kernel<T, NC>, dq_bytes);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(unsigned(P.batch) * unsigned(P.heads),
                     unsigned((P.sq + kBQ2 - 1) / kBQ2));
  dq_kernel<T, NC><<<dq_grid, kThreads, dq_bytes, stream>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkdv_bytes = sizeof(float) * dkdv_smem_floats<NC>();
  err = allow_smem(dkdv_kernel<T, NC>, dkdv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 dkdv_grid(unsigned(P.batch) * unsigned(P.kv_heads),
                       unsigned((P.sk + kBK - 1) / kBK));
  dkdv_kernel<T, NC><<<dkdv_grid, kThreads, dkdv_bytes, stream>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params<T>& P, cudaStream_t stream) {
  switch ((P.d + 15) / 16) {
#define REPRO_FAB_CASE(NC) \
  case NC:                 \
    return launch<T, NC>(P, stream);
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
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, float* rows, void* dq,
                void* dk, void* dv, int batch, int heads, int kv_heads,
                int sq, int sk, int d, const Strides* st, float sm_scale,
                int causal, cudaStream_t stream) {
  const Params<T> P{static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<const T*>(dout),
                    lse, rows, static_cast<T*>(dq), static_cast<T*>(dk),
                    static_cast<T*>(dv), batch, heads, kv_heads,
                    heads / kv_heads, sq, sk, d, st[0], st[1], st[2], st[3],
                    sm_scale, causal};
  return dispatch<T>(P, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 host integers, the
// (batch, position, head) strides in elements of q, k, v and dout.  lse:
// fp32 (b, h, sq) from the forward; rows: fp32 (b, h, sq, 2) scratch; dq
// (b, sq, h, d), dk and dv (b, sk, m, d) contiguous.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* rows, void* dq, void* dk, void* dv,
    int dtype, int batch, int heads, int kv_heads, int sq, int sk, int d,
    const long long* strides, float sm_scale, int causal,
    cudaStream_t stream) {
  if (d < 1 || d > 128 || kv_heads < 1 || heads % kv_heads != 0 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * heads == 0 || sq == 0)
    return static_cast<int>(cudaGetLastError());
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaError_t err =
      dtype == 0
          ? run<float>(q, k, v, dout, lse, rows, dq, dk, dv, batch, heads,
                       kv_heads, sq, sk, d, st, sm_scale, causal, stream)
      : dtype == 1
          ? run<__nv_bfloat16>(q, k, v, dout, lse, rows, dq, dk, dv,
                               batch, heads, kv_heads, sq, sk, d, st,
                               sm_scale, causal, stream)
          : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
