// Flash-attention forward for Hopper (sm_90a), GQA-folded, f32 math.
//
// Replaces: src/repro/kernels/flash_attention.py:68 `_flash_kernel`
// (entry `flash_attention_fwd`, :129), the Pallas TPU kernel behind every
// prefill.  It computes the same function: online-softmax attention with
// the causal / sliding-window / q_offset mask of `_block_mask` (:45), the
// finite NEG_INF = -1e30 for masked scores (a fully masked row then
// averages V instead of dividing 0 by 0), the max(l, 1e-30) guard, and
// returns o (B,Sq,H,hd) in the input dtype plus lse (B,Hkv,G,Sq) in f32.
//
// Design.  The TPU kernel walks the KV blocks on a sequential grid axis
// and carries m, l and acc in VMEM scratch across grid steps.  Blocks on a
// GPU run in parallel and in no order, so here one thread block owns one
// (batch * kv head, query tile) pair and loops over the KV tiles itself,
// keeping m and l in shared memory and acc in registers.  The G query heads
// of a KV group are folded into the block's 64 query rows (G * bq = 64 for
// G | 64), so every K/V tile staged in shared memory serves all G heads and
// K/V are read from device memory once per query tile instead of G times.
// Ragged lengths are masked in the kernel: key rows past Sk are excluded
// (-inf, weight exactly 0) and query rows past Sq are never stored, so any
// Sq, Sk run here; the 512-multiple restriction of the JAX dispatch does
// not apply.  For causal attention without a window and q_offset >= 0 the
// KV loop stops at the tile's last query position: the tiles it skips are
// fully masked for every row of the block and would add exactly zero.
//
// What bounds it on the H100.  The roofline bound of attention at the
// serving shapes (S = 512..2048, hd 64..128) is the bf16 tensor-core rate
// for long sequences and HBM bandwidth for short ones.  This first kernel
// does its arithmetic in f32 FMA on the CUDA cores (67 TFLOP/s peak, not
// 989), so it is bound by the FMA pipe and by shared-memory traffic long
// before either roofline limit.  What the design does about it: 4x4
// register micro-tiles for S = QK^T and 4 x (hd/16) micro-tiles for the PV
// product give 16 FMAs per 8 shared loads, and the row strides are padded
// so the tiles are read without bank conflicts.  Tensor cores (mma.sync /
// wgmma with bf16 operands), TMA staging and a deeper pipeline are the
// next steps.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() (0 on success).  Inputs must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int ROWS = 64;            // query rows per block (G heads x bq)
constexpr int BK = 64;              // keys per KV tile
constexpr int THREADS = 256;
constexpr int S_STRIDE = BK + 16;   // score row stride (conflict-free)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(ROWS * (HD + 1) + BK * (HD + 1) + BK * HD +
                                  ROWS * S_STRIDE + 3 * ROWS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                 int bq, float scale, int causal, int window, int q_offset) {
  constexpr int QS = HD + 1;   // padded row stride of the Q and K tiles
  constexpr int CPT = HD / 16; // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                    // ROWS x QS
  float* k_s = q_s + ROWS * QS;         // BK x QS
  float* v_s = k_s + BK * QS;           // BK x HD
  float* s_s = v_s + BK * HD;           // ROWS x S_STRIDE (scores, then p)
  float* m_s = s_s + ROWS * S_STRIDE;   // running max per row
  float* l_s = m_s + ROWS;              // running sum per row
  float* a_s = l_s + ROWS;              // this tile's rescale factor

  const int G = H / Hkv;
  const int rows = G * bq;
  const int b = blockIdx.y / Hkv;
  const int hkv = blockIdx.y % Hkv;
  const int q0 = blockIdx.x * bq;       // first query of this tile
  const int tid = threadIdx.x;
  const int tr = tid / 16;              // micro-tile rows tr + 16 i
  const int tc = tid % 16;              // micro-tile cols tc + 16 j

  // Row r of the tile is query q0 + r % bq of head hkv * G + r / bq.
  for (int i = tid; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    const int s = q0 + r % bq;
    if (r < rows && s < Sq)
      x = to_f32(q[((size_t)(b * Sq + s) * H + hkv * G + r / bq) * HD + d]);
    q_s[r * QS + d] = x;
  }
  for (int r = tid; r < ROWS; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  int n_kv = (Sk + BK - 1) / BK;
  if (causal && window <= 0 && q_offset >= 0) {
    const int last = q_offset + min(q0 + bq, Sq) - 1;
    n_kv = min(n_kv, last / BK + 1);
  }

  const int warp = tid / 32, lane = tid % 32;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is done with k_s, v_s, s_s
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int c = i / HD, d = i % HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Sk) {
        const size_t off = ((size_t)(b * Sk + k0 + c) * Hkv + hkv) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      k_s[c * QS + d] = kx;
      v_s[c * HD + d] = vx;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4x4 micro-tile.
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(tr + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tc + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s_s[(tr + 16 * i) * S_STRIDE + tc + 16 * j] = sacc[i][j];
    __syncthreads();

    // Online softmax: each warp owns ROWS / 8 rows, each lane two columns.
    for (int rr = 0; rr < ROWS / 8; ++rr) {
      const int r = warp * (ROWS / 8) + rr;
      const int qpos = q_offset + q0 + r % bq;
      float x[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const int kpos = k0 + c;
        float sv = s_s[r * S_STRIDE + c] * scale;
        bool keep = true;
        if (causal) keep = keep && qpos >= kpos;
        if (window > 0) keep = keep && qpos - kpos < window;
        sv = keep ? sv : NEG_INF;
        x[h] = kpos < Sk ? sv : -INFINITY;  // past the ragged edge: no key
      }
      float mx = fmaxf(x[0], x[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x[0] - m_new), p1 = expf(x[1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      s_s[r * S_STRIDE + lane] = p0;
      s_s[r * S_STRIDE + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for this thread's 4 x CPT micro-tile.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[tr + 16 * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_s[(tr + 16 * i) * S_STRIDE + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = v_s[c * HD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // Finalize: o = acc / max(l, 1e-30), lse = m + log(l).
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const int s = q0 + r % bq;
    if (r >= rows || s >= Sq) continue;
    const int g = r / bq;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = o + ((size_t)(b * Sq + s) * H + hkv * G + g) * HD;
#pragma unroll
    for (int j = 0; j < CPT; ++j) put(orow + tc + 16 * j, acc[i][j] / l);
    if (tc == 0)
      lse[((size_t)(b * Hkv + hkv) * G + g) * Sq + s] = m_s[r] + logf(l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Sk, int H, int Hkv, int causal, int window,
           int q_offset, cudaStream_t stream) {
  const int G = H / Hkv;
  const int bq = ROWS / G;
  const size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const float scale = (float)(1.0 / sqrt((double)(HD)));
  dim3 grid((Sq + bq - 1) / bq, B * Hkv);
  kern<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, Sq, Sk, H,
      Hkv, bq, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             void* lse, int B, int Sq, int Sk, int H, int Hkv, int causal,
             int window, int q_offset, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, q_offset, st);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, q_offset, st);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, q_offset, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, q_offset, st);
    case 256: return launch<T, 256>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, q_offset, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd), o like q, lse (B,Hkv,G,Sq) f32; all
// contiguous on `device`.  window <= 0 means no window.  The wrapper checks
// shapes and types; the bounds here only keep a bad call from launching.
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int Sq, int Sk, int H, int Hkv, int hd, int is_bf16,
              int causal, int window, int q_offset, int device,
              void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv || H / Hkv > ROWS)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, lse, B, Sq, Sk, H, Hkv,
                                   causal, window, q_offset, st);
  return dispatch<float>(hd, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal,
                         window, q_offset, st);
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
