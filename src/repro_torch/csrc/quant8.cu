// Blockwise int8 quantization kernels for Hopper (sm_90a), plain C interface
// loaded with ctypes by repro_torch/kernels/quant8/kernel.py.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quant8/kernel.py:
//   quantize8_ef_kernel (_quant_ef_kernel) -> quantize8_ef_launch
//   quantize8_kernel    (_quant_kernel)    -> quantize8_launch
//   dequantize8_kernel  (_dequant_kernel)  -> dequantize8_launch
//
// Math, per 256-element block of the flat fp32 vector (bitwise equal to the
// plain versions in kernels/quant8/ref.py and to the JAX package's results):
//   scale = max(max|x|, 1e-12) * fp32(1/127)
//   q     = clip(rint(x / scale), -127, 127)  (rint rounds half to even)
//   deq   = float(q) * scale,  res = x - deq  (no FMA contraction)
// The scale multiplies by the fp32 reciprocal of 127 because that is what
// the JAX reference computes: XLA rewrites its division by the constant 127
// into that multiply, and a true IEEE division differs from it in some
// blocks (tests/test_torch_kernels.py).  The residual stays unfused so that
// it equals the plain version's x - deq bitwise; JAX may fuse it into one
// FMA, which moves it by at most one ulp of x.
//
// Bound: device-memory bytes.  The EF kernel reads 4n bytes and writes
// n codes + 4 ceil(n/256) scales + 8n (deq, res); there is no reuse, so the
// design is one pass: one warp owns one 256-element block, each lane loads
// its 8 floats as two 16-byte float4 (neighbouring lanes on neighbouring
// addresses), the block max-abs is a 5-step __shfl_xor_sync butterfly in
// registers, and every output is written once with 4- or 16-byte stores.
// The TPU's (256, 256) row tiling is a grid artifact and is not copied: the
// grid covers ceil(n/256) blocks and the ragged tail block is masked with
// zeros, which never changes a block's max-abs.
//
// Each entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;           // elements per quantization block
constexpr int kWarpsPerCta = 8;       // quant blocks per thread block
constexpr int kThreads = 32 * kWarpsPerCta;
constexpr float kInv127 = 0x1.020408p-7f;   // fp32(1/127), bits 0x3c010204

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Loads the lane's 8 elements of quant block `blk`: positions
// [4*lane, 4*lane+4) and [128 + 4*lane, 128 + 4*lane + 4).  Elements at or
// beyond n read as 0.0f.
__device__ __forceinline__ void load8(const float* __restrict__ x, long long n,
                                      long long blk, int lane, float v[8]) {
  const long long base = blk * kBlock;
  if (base + kBlock <= n) {
    const float4 a = reinterpret_cast<const float4*>(x + base)[lane];
    const float4 b = reinterpret_cast<const float4*>(x + base + 128)[lane];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long i = base + (j < 4 ? 4 * lane + j : 128 + 4 * lane + j - 4);
      v[j] = i < n ? x[i] : 0.0f;
    }
  }
}

__device__ __forceinline__ float block_scale(const float v[8]) {
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
  m = warp_max(m);
  return __fmul_rn(fmaxf(m, 1e-12f), kInv127);
}

__device__ __forceinline__ int8_t code_of(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// Writes the lane's 8 codes as two 4-byte words (codes always cover the
// whole padded block, so no masking is needed).
__device__ __forceinline__ void store_codes(int8_t* __restrict__ q,
                                            long long blk, int lane,
                                            const int8_t c[8]) {
  char4* row = reinterpret_cast<char4*>(q + blk * kBlock);
  row[lane] = make_char4(c[0], c[1], c[2], c[3]);
  row[32 + lane] = make_char4(c[4], c[5], c[6], c[7]);
}

// Stores the lane's 8 floats of block `blk` into an n-element output.
__device__ __forceinline__ void store8(float* __restrict__ out, long long n,
                                       long long blk, int lane,
                                       const float v[8]) {
  const long long base = blk * kBlock;
  if (base + kBlock <= n) {
    reinterpret_cast<float4*>(out + base)[lane] =
        make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(out + base + 128)[lane] =
        make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long i = base + (j < 4 ? 4 * lane + j : 128 + 4 * lane + j - 4);
      if (i < n) out[i] = v[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
quantize8_ef_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ s, float* __restrict__ deq,
                    float* __restrict__ res, long long n, long long blocks) {
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (blk >= blocks) return;
  float v[8];
  load8(x, n, blk, lane, v);
  const float scale = block_scale(v);
  int8_t c[8];
  float d[8], e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = code_of(v[j], scale);
    // float(int8) keeps +0.0 for a zero code, as the plain version does
    d[j] = __fmul_rn(static_cast<float>(c[j]), scale);
    e[j] = __fsub_rn(v[j], d[j]);
  }
  store_codes(q, blk, lane, c);
  if (lane == 0) s[blk] = scale;
  store8(deq, n, blk, lane, d);
  store8(res, n, blk, lane, e);
}

__global__ void __launch_bounds__(kThreads)
quantize8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ s, long long n, long long blocks) {
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (blk >= blocks) return;
  float v[8];
  load8(x, n, blk, lane, v);
  const float scale = block_scale(v);
  int8_t c[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j] = code_of(v[j], scale);
  store_codes(q, blk, lane, c);
  if (lane == 0) s[blk] = scale;
}

__global__ void __launch_bounds__(kThreads)
dequantize8_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                   float* __restrict__ out, long long n, long long blocks) {
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (blk >= blocks) return;
  const char4* row = reinterpret_cast<const char4*>(q + blk * kBlock);
  const char4 a = row[lane];
  const char4 b = row[32 + lane];
  const float scale = s[blk];
  const int8_t c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  float d[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    d[j] = __fmul_rn(static_cast<float>(c[j]), scale);
  store8(out, n, blk, lane, d);
}

unsigned grid_for(long long blocks) {
  return static_cast<unsigned>((blocks + kWarpsPerCta - 1) / kWarpsPerCta);
}

}  // namespace

extern "C" int quantize8_ef_launch(const float* x, int8_t* q, float* s,
                                   float* deq, float* res, long long n,
                                   cudaStream_t stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  if (blocks > 0)
    quantize8_ef_kernel<<<grid_for(blocks), kThreads, 0, stream>>>(
        x, q, s, deq, res, n, blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quantize8_launch(const float* x, int8_t* q, float* s,
                                long long n, cudaStream_t stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  if (blocks > 0)
    quantize8_kernel<<<grid_for(blocks), kThreads, 0, stream>>>(
        x, q, s, n, blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize8_launch(const int8_t* q, const float* s, float* out,
                                  long long n, cudaStream_t stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  if (blocks > 0)
    dequantize8_kernel<<<grid_for(blocks), kThreads, 0, stream>>>(
        q, s, out, n, blocks);
  return static_cast<int>(cudaGetLastError());
}
