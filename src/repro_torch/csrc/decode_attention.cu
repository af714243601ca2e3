// Flash decoding for Hopper (sm_90a), split over the KV prefix, plain C
// interface loaded with ctypes by repro_torch/kernels/decode_attention/
// kernel.py.
//
// Replaces the Pallas TPU kernel decode_attention_kernel (body _kernel) of
// src/repro/kernels/decode_attention/kernel.py, and computes the
// score/mask/softmax/PV block of the JAX model's gqa_decode
// (src/repro/models/attention.py): for each batch row b and query head
// h = kvh * g + i,
//   o[b, h] = softmax_{t < length}(q[b, h] . k[b, t, kvh] * d^-1/2) v[b, t, kvh]
// with an fp32 softmax; cache positions >= length are neither read nor
// counted (the Pallas kernel masks them to -1e30, which gives them weight
// 0; the model masks t <= pos, so length = pos + 1).
//
// Layout: q (b, h, d) and the cache k/v (b, S, m, d) read in place through
// their strides (head_dim contiguous).  Types: float32 or bfloat16 in and
// out, fp32 inside; any head_dim <= 128, any group g = h / m.  length is a
// plain int argument: no host sync.
//
// Bound: device-memory bytes -- the cache prefix (2 * length * d per
// (b, kv head)) is read once, and each element feeds 2g flops.  Design:
// - Grid (b * m * head chunks) x n_splits.  The valid prefix is cut into
//   n_splits ranges of whole 64-position tiles (the wrapper plans them
//   from b, m and length, so a small batch still fills the 132 SMs).  A
//   block serves up to kGM query heads of one kv head (more heads of a
//   group take more blocks), so the g heads share every K/V tile.
// - K/V tiles stream through a two-stage ring in shared memory by cp.async
//   (16-byte copies where the layout allows, else 8 or 4, else plain
//   loads); the next tile is in flight while the current one is scored,
//   and positions past length are zero-filled, never read.  One barrier
//   per tile.
// - Each of the 4 warps owns 16 rows of every tile and runs its own
//   online softmax over them: lanes j and j + 16 take the two halves of
//   row j's dot products for every head, lanes split head_dim for P V,
//   and p comes from the scoring lane by shuffle -- every lane busy at
//   any g.  The warps' (max, sum, accumulator) merge at the end in warp
//   order, by the log-sum-exp rule, in fp32.
// - With more than one split, each block writes its fp32 partials to the
//   wrapper's scratch; the last block of a (b, kv head, head chunk) to
//   finish -- it draws the last ticket of an int counter -- merges them
//   in split order and sets the counter back to 0.  One launch, no float
//   atomics: the result is the same bits from call to call.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;           // cache positions per tile
constexpr int kThreads = 128;     // 4 warps x 16 rows of each tile
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kBK / kWarps;
constexpr int kGM = 8;            // query heads per block at most
constexpr int kMaxD = 128;
constexpr int kCols = kMaxD / 32; // P V columns per lane
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// one CB-byte piece of a row into shared memory; zero-filled (nothing
// read) when !valid
template <int CB>
__device__ __forceinline__ void copy_piece(unsigned char* dst,
                                           const unsigned char* src,
                                           bool valid) {
  if constexpr (CB >= 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? CB : 0;
    if constexpr (CB == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(s), "l"(src), "r"(n));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                   :: "r"(s), "l"(src), "n"(CB), "r"(n));
  } else {                        // 2 bytes: one bf16, a plain load
    *reinterpret_cast<uint16_t*>(dst) =
        valid ? *reinterpret_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// the CB / sizeof(T) elements of one piece in shared memory, widened
template <typename T, int CB>
__device__ __forceinline__ void load_piece(const unsigned char* p,
                                           float* out) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if constexpr (CB == 2) {
    out[0] = __uint_as_float(
        uint32_t(*reinterpret_cast<const uint16_t*>(p)) << 16);
  } else {
    uint32_t w[CB / 4];
    if constexpr (CB == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (CB == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < CB / 4; ++i) {
      if constexpr (kBf16) {      // little endian: element 2i is the low half
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        out[i] = __uint_as_float(w[i]);
      }
    }
  }
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;                    // units x n_splits x kGM x (d + 2), or null
  int* tickets;                   // units, zero between calls
  int kv_heads, group, head_chunks, length, d, n_splits, tiles_per_split;
  long long qsb, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, osh;
  float sm_scale;
};

// shared memory: the ring (kStages x {K, V} x kBK rows of d * sizeof(T)
// + 16 bytes), then q (kGM x d fp32).  The warps' merge reuses the ring.
__host__ __device__ inline int row_bytes(int d, int esize) {
  return d * esize + 16;
}
__host__ __device__ inline size_t ring_bytes(int d, int esize) {
  return size_t(kStages) * 2 * kBK * row_bytes(d, esize);
}

template <typename T, int CB>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kE = CB / int(sizeof(T));        // elements per piece
  const int d = P.d;
  const int rb = row_bytes(d, sizeof(T));
  const int pieces = d * int(sizeof(T)) / CB;    // per row
  unsigned char* ring = smem;
  float* sQ = reinterpret_cast<float*>(smem + ring_bytes(d, sizeof(T)));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit = blockIdx.x, split = blockIdx.y;
  const int chunk = unit % P.head_chunks;
  const int bm = unit / P.head_chunks;
  const int b = bm / P.kv_heads, kvh = bm % P.kv_heads;
  const int i0 = chunk * kGM;
  const int gl = min(kGM, P.group - i0);         // this block's heads

  const unsigned char* kb = reinterpret_cast<const unsigned char*>(
      static_cast<const T*>(P.k) + b * P.ksb + kvh * P.ksh);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(
      static_cast<const T*>(P.v) + b * P.vsb + kvh * P.vsh);
  const long long kss = P.kss * sizeof(T), vss = P.vss * sizeof(T);

  const int n_tiles = (P.length + kBK - 1) / kBK;
  const int t0 = split * P.tiles_per_split;
  const int t1 = min(n_tiles, t0 + P.tiles_per_split);

  auto issue = [&](int t) {       // tile t into its ring stage
    unsigned char* sk = ring + size_t((t - t0) % kStages) * 2 * kBK * rb;
    unsigned char* sv = sk + size_t(kBK) * rb;
    const int k0 = t * kBK;
    for (int i = tid; i < kBK * pieces; i += kThreads) {
      const int r = i / pieces, c = (i % pieces) * CB;
      const bool ok = k0 + r < P.length;
      const long long row = ok ? k0 + r : 0;
      copy_piece<CB>(sk + r * rb + c, kb + row * kss + c, ok);
      copy_piece<CB>(sv + r * rb + c, vb + row * vss + c, ok);
    }
    cp_async_commit();
  };

  if (t0 < t1) issue(t0);
  const T* qb = static_cast<const T*>(P.q) + b * P.qsb;
  for (int i = tid; i < gl * d; i += kThreads) {
    const int g = i / d, c = i % d;
    sQ[i] = to_f32(qb[(kvh * P.group + i0 + g) * P.qsh + c]);
  }

  // this warp's online softmax over its rows of every tile
  float m[kGM], l[kGM], acc[kGM][kCols];
#pragma unroll
  for (int i = 0; i < kGM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }
  const int j = lane & 15, half = lane >> 4;
  const int row = warp * kRows + j;
  const int p_lo = half == 0 ? 0 : (pieces + 1) / 2;
  const int p_hi = half == 0 ? (pieces + 1) / 2 : pieces;

  for (int t = t0; t < t1; ++t) {
    cp_async_wait_all();          // tile t has landed (this thread's part)
    __syncthreads();              // ... everyone's; stage of t - 1 is free
    if (t + 1 < t1) issue(t + 1);
    const unsigned char* sk =
        ring + size_t((t - t0) % kStages) * 2 * kBK * rb;
    const unsigned char* sv = sk + size_t(kBK) * rb;
    const int kn = min(kBK, P.length - t * kBK);
    const bool valid = row < kn;

    float sc[kGM];
#pragma unroll
    for (int i = 0; i < kGM; ++i) sc[i] = 0.0f;
    const unsigned char* kr = sk + row * rb;
    for (int pc = p_lo; pc < p_hi; ++pc) {
      float e[kE];
      load_piece<T, CB>(kr + pc * CB, e);
#pragma unroll
      for (int i = 0; i < kGM; ++i) {
        if (i < gl) {
          const float* qr = sQ + i * d + pc * kE;
          if constexpr (kE % 4 == 0) {  // then d % 4 == 0: aligned float4
#pragma unroll
            for (int u = 0; u < kE; u += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qr + u);
              sc[i] = fmaf(q4.x, e[u], sc[i]);
              sc[i] = fmaf(q4.y, e[u + 1], sc[i]);
              sc[i] = fmaf(q4.z, e[u + 2], sc[i]);
              sc[i] = fmaf(q4.w, e[u + 3], sc[i]);
            }
          } else {
#pragma unroll
            for (int u = 0; u < kE; ++u) sc[i] = fmaf(qr[u], e[u], sc[i]);
          }
        }
      }
    }
    float pr[kGM];
#pragma unroll
    for (int i = 0; i < kGM; ++i) {
      if (i < gl) {
        const float dot = sc[i] + __shfl_xor_sync(0xffffffffu, sc[i], 16);
        const float s = valid ? dot * P.sm_scale : kNegInf;
        float mx = s;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float pe = valid ? expf(s - m_new) : 0.0f;
        float sum = pe;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + sum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
        pr[i] = pe;
      }
    }
    const int rows = min(kRows, max(0, kn - warp * kRows));
    for (int jj = 0; jj < rows; ++jj) {
      float pj[kGM];
#pragma unroll
      for (int i = 0; i < kGM; ++i)
        pj[i] = i < gl ? __shfl_sync(0xffffffffu, pr[i], jj) : 0.0f;
      const T* vr = reinterpret_cast<const T*>(sv + (warp * kRows + jj) * rb);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        if (col < d) {
          const float vv = to_f32(vr[col]);
#pragma unroll
          for (int i = 0; i < kGM; ++i)
            if (i < gl) acc[i][c] = fmaf(pj[i], vv, acc[i][c]);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();                // every read of the ring is done

  // merge the warps (the ring holds kWarps x kGM x (d + 2) floats)
  float* wm = reinterpret_cast<float*>(ring);      // kWarps x kGM
  float* wl = wm + kWarps * kGM;                   // kWarps x kGM
  float* wa = wl + kWarps * kGM;                   // kWarps x kGM x d
#pragma unroll
  for (int i = 0; i < kGM; ++i) {
    if (i < gl) {
      if (lane == 0) {
        wm[warp * kGM + i] = m[i];
        wl[warp * kGM + i] = l[i];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        if (col < d) wa[(warp * kGM + i) * d + col] = acc[i][c];
      }
    }
  }
  __syncthreads();

  const size_t stride = size_t(kGM) * (d + 2);     // one split's partials
  float* mine = P.n_splits > 1
                    ? P.part + (size_t(unit) * P.n_splits + split) * stride
                    : nullptr;
  T* ob = static_cast<T*>(P.o) + b * P.osb;
  for (int x = tid; x < gl * d; x += kThreads) {
    const int i = x / d, c = x % d;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * kGM + i]);
    float L = 0.0f, Acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w * kGM + i] - M);
      L = fmaf(wl[w * kGM + i], f, L);
      Acc = fmaf(wa[(w * kGM + i) * d + c], f, Acc);
    }
    if (mine == nullptr) {
      store(ob + (kvh * P.group + i0 + i) * P.osh + c,
            Acc / fmaxf(L, 1e-30f));
    } else {
      mine[2 * kGM + i * d + c] = Acc;
      if (c == 0) {
        mine[i] = M;
        mine[kGM + i] = L;
      }
    }
  }
  if (mine == nullptr) return;

  __shared__ int last;
  __threadfence();                // the partials are visible device-wide
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(P.tickets + unit, 1) == P.n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* all = P.part + size_t(unit) * P.n_splits * stride;
  for (int x = tid; x < gl * d; x += kThreads) {
    const int i = x / d, c = x % d;
    float M = kNegInf;
#pragma unroll 8
    for (int s = 0; s < P.n_splits; ++s)
      M = fmaxf(M, __ldcg(all + s * stride + i));
    float L = 0.0f, Acc = 0.0f;
#pragma unroll 8
    for (int s = 0; s < P.n_splits; ++s) {
      const float* ps = all + s * stride;
      const float f = expf(__ldcg(ps + i) - M);
      L = fmaf(__ldcg(ps + kGM + i), f, L);
      Acc = fmaf(__ldcg(ps + 2 * kGM + i * d + c), f, Acc);
    }
    store(ob + (kvh * P.group + i0 + i) * P.osh + c, Acc / fmaxf(L, 1e-30f));
  }
  if (tid == 0) P.tickets[unit] = 0;
}

template <typename T, int CB>
cudaError_t launch(const Params& P, int units, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, CB>;
  const int gl = P.group < kGM ? P.group : kGM;
  const size_t smem =
      ring_bytes(P.d, sizeof(T)) + sizeof(float) * size_t(gl) * P.d;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess)         // as many blocks per SM as fit
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  kern<<<dim3(unsigned(units), unsigned(P.n_splits)), kThreads, smem,
         stream>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& P, int units, int piece,
                     cudaStream_t stream) {
  switch (piece) {
    case 16: return launch<T, 16>(P, units, stream);
    case 8: return launch<T, 8>(P, units, stream);
    case 4: return launch<T, 4>(P, units, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 10 host integers in
// elements -- q (batch, head), k (batch, position, head), v (batch,
// position, head), o (batch, head).  piece: the bytes of each copy (16, 8,
// 4, or 2 for bfloat16 only), which must divide d * sizeof(T), every k/v
// stride in bytes and both cache pointers.  n_splits ranges of
// tiles_per_split 64-position tiles cover the prefix; with n_splits > 1,
// part holds units x n_splits x 8 x (d + 2) floats and tickets units ints
// that are 0 (units = batch * kv_heads * ceil(group / 8)).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* part,
    void* tickets, int dtype, int batch, int heads, int kv_heads, int length,
    int d, int n_splits, int tiles_per_split, int piece,
    const long long* strides, float sm_scale, cudaStream_t stream) {
  if (d < 1 || d > kMaxD || kv_heads < 1 || heads % kv_heads != 0 ||
      length < 0 || n_splits < 1 || tiles_per_split < 0 ||
      (n_splits > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = heads / kv_heads;
  const int chunks = (group + kGM - 1) / kGM;
  const int units = batch * kv_heads * chunks;
  if (units == 0) return static_cast<int>(cudaGetLastError());
  const Params P{q, k, v, o, static_cast<float*>(part),
                 static_cast<int*>(tickets), kv_heads, group, chunks, length,
                 d, n_splits, tiles_per_split, strides[0], strides[1],
                 strides[2], strides[3], strides[4], strides[5], strides[6],
                 strides[7], strides[8], strides[9], sm_scale};
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(P, units, piece, stream);
  else if (dtype == 1)
    err = piece == 2 ? launch<__nv_bfloat16, 2>(P, units, stream)
                     : dispatch<__nv_bfloat16>(P, units, piece, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
