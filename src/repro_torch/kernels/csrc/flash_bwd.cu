// Flash-attention backward for Hopper (sm_90a), GQA-folded, f32 math.
//
// Replaces: src/repro/kernels/flash_attention.py:186 `_flash_bwd_dq_kernel`
// and :224 `_flash_bwd_dkv_kernel` (entry `flash_attention_bwd`, :265), the
// two Pallas TPU kernels behind the custom VJP of every training step.  They
// compute the same functions: the probabilities are recomputed blockwise
// from the forward's saved lse,
//     p  = mask ? exp(s * scale - lse) : 0        s = q k^T
//     ds = p * (dp - delta) * scale               dp = do v^T
//     dq = sum_k ds k,  dk = sum_q ds^T q,  dv = sum_q p^T do,
// with delta = rowsum(do * o) computed by the caller from the stored o.  The
// mask is applied explicitly, as the Pallas kernels do (:210-212): a fully
// masked row has lse ~ -1e30, and exp(s - lse) would be 1, not 0.  Sums and
// math are f32; dq, dk and dv are written in the input dtype.
//
// Design.  The TPU kernels walk the inner loop on a sequential grid axis and
// carry the accumulator in VMEM scratch across grid steps.  Blocks on a GPU
// run in parallel and in no order, so each kernel's block owns one output
// tile and loops over the other axis itself, the accumulator in registers:
//   * dq: one block per (batch * kv head, query tile).  The G query heads of
//     a KV group are folded into the 64 rows of the tile (G * bq = 64 for
//     G | 64), as in flash_fwd.cu, so each K/V tile staged in shared memory
//     serves all G heads.  The block loops over the KV tiles.
//   * dk/dv: one block per (batch * kv head, 64-key tile), looping over the
//     query tiles of all G heads, so the G-head sum of dk and dv happens in
//     the block's registers, with no atomics and no second pass.
// Ragged lengths are masked in the kernels: keys past Sk and queries past Sq
// get p = 0 and contribute exactly nothing.  Because the mask is explicit,
// a tile that is masked for every (query, key) pair adds exactly zero, so
// the loops visit only the tiles inside the causal and window bounds: dq
// stops at the diagonal tile, dk/dv start from it (offset by q_offset).
//
// What bounds it on the H100.  The roofline bound of the backward at the
// training shapes (S = 1024, hd 64) is the bf16 tensor-core rate (6 hd
// FLOPs per unmasked pair for dq, 8 hd for dk/dv).  These kernels do their
// arithmetic in f32 FMA on the CUDA cores (67 TFLOP/s peak, not 989), so
// they are bound by the FMA pipe and by shared-memory traffic long before
// either roofline limit.  What the design does about it: 4x4 register
// micro-tiles for the two score products and 4 x (hd/16) micro-tiles for the
// accumulating products, with padded row strides so the tiles are read
// without bank conflicts.  Tensor cores (mma.sync / wgmma on bf16 operands),
// TMA staging and a deeper pipeline are the next steps.  Head dims above
// 128 do not fit the four f32 tiles in shared memory and are refused.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() (0 on success).  Inputs must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int ROWS = 64;            // query rows per tile (G heads x bq)
constexpr int BK = 64;              // keys per KV tile
constexpr int THREADS = 256;
constexpr int S_STRIDE = BK + 16;   // p / ds row stride (conflict-free)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The fixed arguments of one backward call.
struct Args {
  int Sq, Sk, H, Hkv, G, bq, rows, causal, window, q_offset;
  float scale;
};

// ROWS rows of a (B,Sq,H,HD) tensor into a padded f32 tile: row r is query
// q0 + r % bq of head hkv * G + r / bq; zeros past the ragged edge.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          const Args& a, int b, int hkv,
                                          int q0) {
  constexpr int QS = HD + 1;
  for (int i = threadIdx.x; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r % a.bq;
    float x = 0.f;
    if (r < a.rows && s < a.Sq)
      x = to_f32(src[((size_t)(b * a.Sq + s) * a.H + hkv * a.G + r / a.bq) *
                         HD + d]);
    dst[r * QS + d] = x;
  }
}

// BK keys of a (B,Sk,Hkv,HD) tensor into a padded f32 tile; zeros past Sk.
template <typename T, int HD>
__device__ __forceinline__ void load_keys(float* dst, const T* __restrict__ src,
                                          const Args& a, int b, int hkv,
                                          int k0) {
  constexpr int QS = HD + 1;
  for (int i = threadIdx.x; i < BK * HD; i += THREADS) {
    const int c = i / HD, d = i % HD;
    float x = 0.f;
    if (k0 + c < a.Sk)
      x = to_f32(src[((size_t)(b * a.Sk + k0 + c) * a.Hkv + hkv) * HD + d]);
    dst[c * QS + d] = x;
  }
}

// lse and delta ((B,Hkv,G,Sq) f32) of the tile's rows.
__device__ __forceinline__ void load_stats(float* lse_s, float* dl_s,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           const Args& a, int b, int hkv,
                                           int q0) {
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    const int s = q0 + r % a.bq;
    float l = 0.f, dl = 0.f;
    if (r < a.rows && s < a.Sq) {
      const size_t i = ((size_t)(b * a.Hkv + hkv) * a.G + r / a.bq) * a.Sq + s;
      l = lse[i];
      dl = delta[i];
    }
    lse_s[r] = l;
    dl_s[r] = dl;
  }
}

// This thread's 4x4 micro-tile (rows tr + 16 i, keys tc + 16 j) of
// p = mask ? exp(s * scale - lse) : 0 and ds = p * (dp - delta) * scale.
template <int HD>
__device__ __forceinline__ void probs(const float* q_s, const float* do_s,
                                      const float* k_s, const float* v_s,
                                      const float* lse_s, const float* dl_s,
                                      const Args& a, int q0, int k0,
                                      float p[4][4], float ds[4][4]) {
  constexpr int QS = HD + 1;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float qv[4], kv[4], ov[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = q_s[(tr + 16 * i) * QS + d];
      ov[i] = do_s[(tr + 16 * i) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = k_s[(tc + 16 * j) * QS + d];
      vv[j] = v_s[(tc + 16 * j) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const bool row_ok = r < a.rows && q0 + r % a.bq < a.Sq;
    const int qpos = a.q_offset + q0 + r % a.bq;
    const float l = lse_s[r], dl = dl_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tc + 16 * j;
      bool keep = row_ok && kpos < a.Sk;
      if (a.causal) keep = keep && qpos >= kpos;
      if (a.window > 0) keep = keep && qpos - kpos < a.window;
      const float pv = keep ? expf(s[i][j] * a.scale - l) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - dl) * a.scale;
    }
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(2 * ROWS * (HD + 1) + 2 * BK * (HD + 1) +
                                  ROWS * S_STRIDE + 2 * ROWS);
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(2 * ROWS * (HD + 1) + 2 * BK * (HD + 1) +
                                  2 * ROWS * S_STRIDE + 2 * ROWS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Args a) {
  constexpr int QS = HD + 1;
  constexpr int CPT = HD / 16;          // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                    // ROWS x QS
  float* do_s = q_s + ROWS * QS;        // ROWS x QS
  float* k_s = do_s + ROWS * QS;        // BK x QS
  float* v_s = k_s + BK * QS;           // BK x QS
  float* ds_s = v_s + BK * QS;          // ROWS x S_STRIDE
  float* lse_s = ds_s + ROWS * S_STRIDE;
  float* dl_s = lse_s + ROWS;

  const int b = blockIdx.y / a.Hkv;
  const int hkv = blockIdx.y % a.Hkv;
  const int q0 = blockIdx.x * a.bq;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  load_rows<T, HD>(q_s, q, a, b, hkv, q0);
  load_rows<T, HD>(do_s, dout, a, b, hkv, q0);
  load_stats(lse_s, dl_s, lse, delta, a, b, hkv, q0);

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // The KV tiles with an unmasked key for some row of this tile.
  const int first = a.q_offset + q0;
  const int last = a.q_offset + min(q0 + a.bq, a.Sq) - 1;
  int kt0 = 0, kt1 = (a.Sk + BK - 1) / BK;
  if (a.causal) kt1 = min(kt1, last < 0 ? 0 : last / BK + 1);
  if (a.window > 0) kt0 = max(0, first - a.window + 1) / BK;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is done with k_s, v_s, ds_s
    load_keys<T, HD>(k_s, k, a, b, hkv, k0);
    load_keys<T, HD>(v_s, v, a, b, hkv, k0);
    __syncthreads();

    float p[4][4], ds[4][4];
    probs<HD>(q_s, do_s, k_s, v_s, lse_s, dl_s, a, q0, k0, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds_s[(tr + 16 * i) * S_STRIDE + tc + 16 * j] = ds[i][j];
    __syncthreads();

    // dq += ds K for this thread's 4 x CPT micro-tile.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(tr + 16 * i) * S_STRIDE + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = k_s[c * QS + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const int s = q0 + r % a.bq;
    if (r >= a.rows || s >= a.Sq) continue;
    T* row = dq + ((size_t)(b * a.Sq + s) * a.H + hkv * a.G + r / a.bq) * HD;
#pragma unroll
    for (int j = 0; j < CPT; ++j) put(row + tc + 16 * j, acc[i][j]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Args a) {
  constexpr int QS = HD + 1;
  constexpr int CPT = HD / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                    // BK x QS
  float* v_s = k_s + BK * QS;           // BK x QS
  float* q_s = v_s + BK * QS;           // ROWS x QS
  float* do_s = q_s + ROWS * QS;        // ROWS x QS
  float* p_s = do_s + ROWS * QS;        // ROWS x S_STRIDE
  float* ds_s = p_s + ROWS * S_STRIDE;  // ROWS x S_STRIDE
  float* lse_s = ds_s + ROWS * S_STRIDE;
  float* dl_s = lse_s + ROWS;

  const int b = blockIdx.y / a.Hkv;
  const int hkv = blockIdx.y % a.Hkv;
  const int k0 = blockIdx.x * BK;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  load_keys<T, HD>(k_s, k, a, b, hkv, k0);
  load_keys<T, HD>(v_s, v, a, b, hkv, k0);

  // keys k0 + tr + 16 i, columns tc + 16 j
  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // The query tiles with an unmasked query for some key of this tile.
  int qt0 = 0, qt1 = (a.Sq + a.bq - 1) / a.bq;
  if (a.causal) {
    const int x = k0 - a.q_offset;
    qt0 = x > 0 ? x / a.bq : 0;
  }
  if (a.window > 0) {
    const int x = a.window + k0 + BK - 1 - a.q_offset;
    qt1 = min(qt1, x > 0 ? (x + a.bq - 1) / a.bq : 0);
  }

  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * a.bq;
    __syncthreads();  // the previous tile is done with q_s, do_s, p_s, ds_s
    load_rows<T, HD>(q_s, q, a, b, hkv, q0);
    load_rows<T, HD>(do_s, dout, a, b, hkv, q0);
    load_stats(lse_s, dl_s, lse, delta, a, b, hkv, q0);
    __syncthreads();

    float p[4][4], ds[4][4];
    probs<HD>(q_s, do_s, k_s, v_s, lse_s, dl_s, a, q0, k0, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p_s[(tr + 16 * i) * S_STRIDE + tc + 16 * j] = p[i][j];
        ds_s[(tr + 16 * i) * S_STRIDE + tc + 16 * j] = ds[i][j];
      }
    __syncthreads();

    // dv += p^T dO and dk += ds^T Q over the tile's rows (all G heads).
#pragma unroll 2
    for (int r = 0; r < ROWS; ++r) {
      float pv[4], dsv[4], ov[CPT], qv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = p_s[r * S_STRIDE + tr + 16 * i];
        dsv[i] = ds_s[r * S_STRIDE + tr + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        ov[j] = do_s[r * QS + tc + 16 * j];
        qv[j] = q_s[r * QS + tc + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + tr + 16 * i;
    if (key >= a.Sk) continue;
    const size_t off = ((size_t)(b * a.Sk + key) * a.Hkv + hkv) * HD;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      put(dk + off + tc + 16 * j, dk_acc[i][j]);
      put(dv + off + tc + 16 * j, dv_acc[i][j]);
    }
  }
}

Args make_args(int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
               int q_offset) {
  Args a;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Hkv = Hkv;
  a.G = H / Hkv;
  a.bq = ROWS / a.G;
  a.rows = a.G * a.bq;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.scale = (float)(1.0 / sqrt((double)hd));
  return a;
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B,
              const Args& a, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<HD>();
  auto kern = flash_bwd_dq_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + a.bq - 1) / a.bq, B * a.Hkv);
  kern<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, a);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               const Args& a, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<HD>();
  auto kern = flash_bwd_dkv_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sk + BK - 1) / BK, B * a.Hkv);
  kern<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, a);
  return (int)cudaGetLastError();
}

#define FLASH_BWD_HEAD_DIMS(X) X(16) X(32) X(64) X(128)

template <typename T>
int dispatch_dq(int hd, const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta, void* dq,
                int B, const Args& a, cudaStream_t st) {
  switch (hd) {
#define CASE(D) \
  case D: return launch_dq<T, D>(q, k, v, dout, lse, delta, dq, B, a, st);
    FLASH_BWD_HEAD_DIMS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dkv(int hd, const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int B, const Args& a, cudaStream_t st) {
  switch (hd) {
#define CASE(D) \
  case D: return launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, B, a, st);
    FLASH_BWD_HEAD_DIMS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int Sq, int Sk, int H, int Hkv) {
  return B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv || H / Hkv > ROWS;
}

}  // namespace

extern "C" {

// q, do (B,Sq,H,hd); k, v (B,Sk,Hkv,hd); lse, delta (B,Hkv,G,Sq) f32; dq
// like q; all contiguous on `device`.  window <= 0 means no window.  The
// wrapper checks shapes and types; the bounds here only keep a bad call
// from launching.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int B, int Sq, int Sk, int H, int Hkv, int hd,
                 int is_bf16, int causal, int window, int q_offset, int device,
                 void* stream) {
  if (bad_shape(B, Sq, Sk, H, Hkv)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Args a = make_args(Sq, Sk, H, Hkv, hd, causal, window, q_offset);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch_dq<__nv_bfloat16>(hd, q, k, v, dout, lse, delta, dq, B, a,
                                      st);
  return dispatch_dq<float>(hd, q, k, v, dout, lse, delta, dq, B, a, st);
}

// As flash_bwd_dq; dk and dv like k.
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int B, int Sq, int Sk, int H, int Hkv,
                  int hd, int is_bf16, int causal, int window, int q_offset,
                  int device, void* stream) {
  if (bad_shape(B, Sq, Sk, H, Hkv)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Args a = make_args(Sq, Sk, H, Hkv, hd, causal, window, q_offset);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch_dkv<__nv_bfloat16>(hd, q, k, v, dout, lse, delta, dk, dv,
                                       B, a, st);
  return dispatch_dkv<float>(hd, q, k, v, dout, lse, delta, dk, dv, B, a, st);
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
