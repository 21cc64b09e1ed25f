// Blockwise int8 quantise, dequantise, and the fused quantise + error
// feedback, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quant.py:30 `_quant_kernel` (entry
// `quantize_int8`, :69), :39 `_dequant_kernel` (`dequantize_int8`, :89) and
// :44 `_quant_ef_kernel` (`quantize_ef_int8`, :107), the Pallas TPU kernels
// of the int8 slow-hop exchange of the multilevel gradient all-reduce.
// Per block of 256 elements (one f32 scale each):
//   scale = max(amax / 127, 1e-12), q = clip(rint(x / scale), -127, 127),
//   dequant = q * scale, and in the fused kernel x is x + ef and the new
//   residual is (x + ef) - q * scale.
//
// Bit for bit.  The plain PyTorch versions (repro_torch/core/
// compression.py) are the reference's eager jnp path, and each kernel
// must equal them to the bit:
// - both divisions are correctly rounded (__fdiv_rn), never a product with
//   the reciprocal;
// - rintf rounds half to even, as jnp.round and torch.round do;
// - the product q * scale is rounded before the subtract (__fmul_rn,
//   __fsub_rn): nvcc's default -fmad=true would otherwise contract
//   x - q * scale into one FMA, the hazard the Pallas kernel guards against
//   at quant.py:52-59; the product is clamped to +-F32_MAX so a block whose
//   largest magnitude is F32_MAX leaves a finite residual;
// - the amax propagates NaN (fmaxf would drop it), so a block holding a
//   NaN gets a NaN scale, and a NaN quotient stores q = 0, as XLA's convert
//   does.
//
// Design.  The Pallas kernels run a sequential grid over tiles of 32 blocks
// in VMEM.  Here one warp owns one 256-element block: each lane loads 8
// consecutive floats as two 16-byte loads (the warp reads 1 KB
// contiguously), the block's amax is a shuffle reduction inside the warp,
// and each lane stores its 8 int8 values as one 8-byte store.  No shared
// memory, no synchronisation between warps; 8 warps per thread block.
//
// What bounds it on the H100: device-memory bandwidth.  Each element is
// read and written once: 4 + 1 bytes (+ 4/256 of scale) for quantise,
// 1 + 4 for dequantise, 4 + 4 + 1 + 4 for the fused EF kernel, at
// 3.35 TB/s.  A handful of arithmetic operations per element is far below
// the card's rate, so the design only has to keep enough 16-byte loads in
// flight: every lane issues its loads before any use.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() (0 on success).  Pointers must be 16-byte aligned and
// the lengths a multiple of 256 (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;          // elements per scale
constexpr int PER_LANE = BLOCK / 32;
constexpr int WARPS = 8;            // quant blocks per thread block
constexpr float F32_MAX = 3.40282347e38f;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;   // a NaN wins, as in jnp.max
}

__device__ __forceinline__ void load8(const float* p, float (&v)[PER_LANE]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[PER_LANE]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// scale = max(amax / 127, 1e-12) over the warp's 256 values; NaN stays NaN
__device__ __forceinline__ float block_scale(const float (&v)[PER_LANE]) {
  float m = fabsf(v[0]);
#pragma unroll
  for (int i = 1; i < PER_LANE; ++i) m = nan_max(m, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float s = __fdiv_rn(m, 127.0f);
  return s < 1e-12f ? 1e-12f : s;
}

// the int8 payload of one value: clip(rint(x / scale)), NaN -> 0
__device__ __forceinline__ int8_t quant1(float x, float scale) {
  float q = rintf(__fdiv_rn(x, scale));
  q = q < -127.0f ? -127.0f : (q > 127.0f ? 127.0f : q);
  return q != q ? (int8_t)0 : (int8_t)(int)q;
}

__device__ __forceinline__ void store_q(int8_t* p, const int8_t (&q)[PER_LANE]) {
  uint2 w;
  w.x = (uint32_t)(uint8_t)q[0] | ((uint32_t)(uint8_t)q[1] << 8) |
        ((uint32_t)(uint8_t)q[2] << 16) | ((uint32_t)(uint8_t)q[3] << 24);
  w.y = (uint32_t)(uint8_t)q[4] | ((uint32_t)(uint8_t)q[5] << 8) |
        ((uint32_t)(uint8_t)q[6] << 16) | ((uint32_t)(uint8_t)q[7] << 24);
  *reinterpret_cast<uint2*>(p) = w;
}

__global__ void __launch_bounds__(WARPS * 32)
quant_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ scales, long long nblk) {
  const long long blk = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (blk >= nblk) return;            // uniform per warp
  const size_t off = (size_t)blk * BLOCK + (threadIdx.x & 31) * PER_LANE;
  float v[PER_LANE];
  load8(x + off, v);
  const float s = block_scale(v);
  int8_t qv[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) qv[i] = quant1(v[i], s);
  store_q(q + off, qv);
  if ((threadIdx.x & 31) == 0) scales[blk] = s;
}

__global__ void __launch_bounds__(WARPS * 32)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
               float* __restrict__ x, long long nblk) {
  const long long blk = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (blk >= nblk) return;
  const size_t off = (size_t)blk * BLOCK + (threadIdx.x & 31) * PER_LANE;
  const uint2 w = *reinterpret_cast<const uint2*>(q + off);
  const float s = scales[blk];
  float v[PER_LANE];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = __fmul_rn((float)(int8_t)(w.x >> (8 * i)), s);
    v[i + 4] = __fmul_rn((float)(int8_t)(w.y >> (8 * i)), s);
  }
  store8(x + off, v);
}

__global__ void __launch_bounds__(WARPS * 32)
quant_ef_kernel(const float* __restrict__ x, const float* __restrict__ ef,
                int8_t* __restrict__ q, float* __restrict__ scales,
                float* __restrict__ resid, long long nblk) {
  const long long blk = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (blk >= nblk) return;
  const size_t off = (size_t)blk * BLOCK + (threadIdx.x & 31) * PER_LANE;
  float v[PER_LANE], e[PER_LANE];
  load8(x + off, v);
  load8(ef + off, e);
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) v[i] = __fadd_rn(v[i], e[i]);
  const float s = block_scale(v);
  int8_t qv[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    qv[i] = quant1(v[i], s);
    float d = __fmul_rn((float)qv[i], s);
    d = d > F32_MAX ? F32_MAX : (d < -F32_MAX ? -F32_MAX : d);  // NaN stays
    e[i] = __fsub_rn(v[i], d);
  }
  store_q(q + off, qv);
  store8(resid + off, e);
  if ((threadIdx.x & 31) == 0) scales[blk] = s;
}

inline dim3 grid_of(long long nblk) {
  return dim3((unsigned)((nblk + WARPS - 1) / WARPS));
}

}  // namespace

extern "C" {

// x f32 [nblk*256] -> q int8 [nblk*256], scales f32 [nblk]
int quant_int8(const void* x, void* q, void* scales, long long nblk,
               int device, void* stream) {
  if (nblk < 0 || (nblk + WARPS - 1) / WARPS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (nblk == 0) return 0;
  quant_kernel<<<grid_of(nblk), WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)x, (int8_t*)q, (float*)scales, nblk);
  return (int)cudaGetLastError();
}

// q int8 [nblk*256], scales f32 [nblk] -> x f32 [nblk*256]
int dequant_int8(const void* q, const void* scales, void* x, long long nblk,
                 int device, void* stream) {
  if (nblk < 0 || (nblk + WARPS - 1) / WARPS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (nblk == 0) return 0;
  dequant_kernel<<<grid_of(nblk), WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)scales, (float*)x, nblk);
  return (int)cudaGetLastError();
}

// x, ef f32 [nblk*256] -> q int8, scales f32 [nblk], resid f32 [nblk*256]
int quant_ef_int8(const void* x, const void* ef, void* q, void* scales,
                  void* resid, long long nblk, int device, void* stream) {
  if (nblk < 0 || (nblk + WARPS - 1) / WARPS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (nblk == 0) return 0;
  quant_ef_kernel<<<grid_of(nblk), WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)ef, (int8_t*)q, (float*)scales,
      (float*)resid, nblk);
  return (int)cudaGetLastError();
}

const char* quant_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
