// Flash-attention forward for Hopper (sm_90a), GQA-folded: bf16 on the
// tensor cores, f32 on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py:68 `_flash_kernel`
// (entry `flash_attention_fwd`, :129), the Pallas TPU kernel behind every
// prefill.  It computes the same function: online-softmax attention with
// the causal / sliding-window / q_offset mask of `_block_mask` (:45), the
// finite NEG_INF = -1e30 for masked scores (a fully masked row then
// averages V instead of dividing 0 by 0), the max(l, 1e-30) guard, and
// returns o (B,Sq,H,hd) in the input dtype plus lse (B,Hkv,G,Sq) in f32.
//
// Shared by both designs.  The TPU kernel walks the KV blocks on a
// sequential grid axis and carries m, l and acc in VMEM scratch across grid
// steps.  Blocks on a GPU run in parallel and in no order, so here one
// thread block owns one (batch * kv head, query tile) pair and loops over
// the KV tiles itself.  The G query heads of a KV group are folded into the
// block's 64 query rows (G * bq = 64 for G | 64, fewer live rows
// otherwise), so every K/V tile staged in shared memory serves all G heads
// and K/V are read from device memory once per query tile instead of G
// times.  Ragged lengths are masked in the kernel: key rows past Sk are
// excluded (-inf, weight exactly 0) and query rows past Sq are never
// stored, so any Sq, Sk run here; the 512-multiple restriction of the JAX
// dispatch does not apply.
//
// bf16 inputs (every prefill and training forward).  What bounds it on the
// H100: the two products S = Q K^T and O += P V, 4 hd FLOPs per unmasked
// (query, key) pair, against the bf16 tensor-core rate of 989 TFLOP/s, for
// long sequences; the bytes of q, k, v and o at 3.35 TB/s for short ones.
// What the design does about it:
//   * four warps, each owning 16 query rows of the 64-row tile; both
//     products are `mma.sync.m16n8k16` with bf16 operands and f32
//     accumulators, fed by `ldmatrix` (V through `.trans`), from bf16 tiles
//     in shared memory whose rows are padded by 8 elements (flash_mma.cuh);
//   * the online softmax runs on the S accumulator fragments in registers:
//     each thread holds two rows of its warp's 16, their running max m and
//     (partial) sum l; the row max is reduced over the 4 threads of a row
//     with two shuffles, the sum only once at the end.  Scores are scaled
//     into log2 units once, so p = exp2(s - m) is one FFMA and one MUFU;
//   * P goes from the S accumulators into the A fragment of the P V product
//     as bf16 in registers (`to_a`), never through shared memory.  This
//     rounding is the one numerical difference from the Pallas kernel,
//     which keeps p in f32; l sums the unrounded f32 p.
//     `flash_attention_fwd_bf16_ref` in flash_attention.py mirrors both;
//   * the next K/V tile is loaded with 16-byte `cp.async` (plain loads
//     where hd % 8 != 0) into the second buffer of a 2-stage ring while
//     the current tile is computed;
//   * tiles inside the causal and window band skip the per-element mask;
//   * Q's A fragments are held in registers up to width 128.  Above it (at
//     256 the O accumulator of a 16-row warp tile alone is 128 f32
//     registers a thread) Q is read from shared memory for each KV tile
//     and the KV tiles are 32 keys instead of 64 (the S fragments then take
//     16 registers, not 32);
//   * blocks are ordered longest rows first, so the causal tail of the
//     grid is short.
// Tile skipping: tiles outside the causal and window band are fully masked
// for every row of the block.  For a row with some unmasked key they add
// exactly zero (its running max is a real score, and exp2 of NEG_INF minus
// it is 0).  A row with no unmasked key must average V over every key, as
// the Pallas kernel (which visits every KV block) gives it, so the band
// limits apply only to a block whose every live row has an unmasked key.
//
// f32 inputs (the card-against-CPU answers, held to 1e-4 and 1e-6, which
// bf16 or TF32 products cannot meet) keep the first design: f32 FMA on the
// CUDA cores (67 TFLOP/s peak), 4x4 register micro-tiles for S = QK^T and
// 4 x (hd/16) micro-tiles for the PV product (16 FMAs per 8 shared loads),
// padded f32 tiles, S and P staged through shared memory, three
// __syncthreads per KV tile.  For causal attention without a window and
// q_offset >= 0 its KV loop stops at the tile's last query position.
//
// Any head dim from 1 to 256 runs, at the tile width of flash_mma.cuh's
// `head_width`: the columns past hd are zeros in shared memory and are
// never stored.  Both designs are instantiated twice a width (EXACT: hd
// equal to it, the code of a kernel written for that head dim; or below
// it, hd read at run time; see flash_mma.cuh).
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() (0 on success).  Inputs must be contiguous, and bf16
// ones 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ======================================================================
// f32: FMA on the CUDA cores
// ======================================================================

constexpr int BK = 64;              // keys per KV tile
constexpr int THREADS = 256;
constexpr int S_STRIDE = BK + 16;   // score row stride (conflict-free)

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(ROWS * (HD + 1) + BK * (HD + 1) + BK * HD +
                                  ROWS * S_STRIDE + 3 * ROWS);
}

template <int HD, bool EXACT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                 int hd_arg, int bq, float scale, int causal, int window,
                 int q_offset) {
  constexpr int QS = HD + 1;   // padded row stride of the Q and K tiles
  const int hd = EXACT ? HD : hd_arg;
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

  // Row r of the tile is query q0 + r % bq of head hkv * G + r / bq; the
  // columns from hd on are zeros.
  for (int i = tid; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    const int s = q0 + r % bq;
    if (r < rows && s < Sq && (EXACT || d < hd))
      x = q[((size_t)(b * Sq + s) * H + hkv * G + r / bq) * hd + d];
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
      if (k0 + c < Sk && (EXACT || d < hd)) {
        const size_t off = ((size_t)(b * Sk + k0 + c) * Hkv + hkv) * hd + d;
        kx = k[off];
        vx = v[off];
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
    float* orow = o + ((size_t)(b * Sq + s) * H + hkv * G + g) * hd;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (EXACT || tc + 16 * j < hd) orow[tc + 16 * j] = acc[i][j] / l;
    if (tc == 0)
      lse[((size_t)(b * Hkv + hkv) * G + g) * Sq + s] = m_s[r] + logf(l);
  }
}

template <int HD, bool EXACT>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Sq, int Sk, int H, int Hkv, int hd,
               int causal, int window, int q_offset, cudaStream_t stream) {
  const int G = H / Hkv;
  const int bq = ROWS / G;
  const size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<HD, EXACT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const float scale = (float)(1.0 / sqrt((double)hd));
  dim3 grid((Sq + bq - 1) / bq, B * Hkv);
  kern<<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, Sq, Sk, H, Hkv, hd, bq, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

// ======================================================================
// bf16: mma.sync on the tensor cores
// ======================================================================

constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG2 = NEG_INF * LOG2E;   // a masked score in log2 units

// Keys per KV tile: 32 at the widths above 128, where registers are short,
// else 64 (`kernel_block_k` in flash_attention.py, the mirror's tiles, must
// agree).
template <int HD>
__host__ __device__ constexpr int keys_per_tile() {
  return HD > 128 ? 32 : 64;
}

template <int HD>
constexpr size_t bf16_smem_bytes() {   // Q, two stages of K and V
  return sizeof(bf16) * (size_t)(ROWS + 4 * keys_per_tile<HD>()) * ld<HD>();
}

// The NK-key tiles kt0..kt1 - 1 the block at q0 visits: those inside the
// causal and window band when every live row of the block has an unmasked
// key, else all of them (a row with none averages V over every key).
template <int NK>
__device__ __forceinline__ void fwd_key_tiles(const Args& a, int q0, int& kt0,
                                              int& kt1) {
  const int first = a.q_offset + q0;
  const int last = a.q_offset + min(q0 + a.bq, a.Sq) - 1;
  kt0 = 0;
  kt1 = (a.Sk + NK - 1) / NK;
  // query qpos keeps keys max(0, qpos - window + 1)..min(qpos, Sk - 1)
  // (causal) or ..Sk - 1: one exists iff qpos >= 0 (causal) and
  // qpos - window + 1 <= Sk - 1 (window); both are monotone in qpos
  const bool keyed = (!a.causal || first >= 0) &&
                     (a.window <= 0 || last - a.window + 2 <= a.Sk);
  if (!keyed) return;
  if (a.causal) kt1 = min(kt1, last / NK + 1);
  if (a.window > 0) kt0 = max(0, first - a.window + 1) / NK;
}

template <int HD, bool EXACT>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int BH, Args a) {
  constexpr int NK = keys_per_tile<HD>(), LD = ld<HD>(), KT = NK * LD;
  constexpr bool QREG = HD <= 128;      // Q's A fragments in registers
  const int hd = EXACT ? HD : a.hd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + tile<HD>();        // [stage][K, V][KT]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // one block per (query tile, batch * kv head), the longest rows first
  const int tiles = gridDim.x / BH;
  const int bh = blockIdx.x % BH;
  const int q0 = (tiles - 1 - (int)(blockIdx.x / BH)) * a.bq;
  const int b = bh / a.Hkv, hkv = bh % a.Hkv;
  const float sl2 = a.scale * LOG2E;

  // this thread's rows warp * 16 + g and + 8: position, whether stored,
  // running max (log2 units) and this thread's part of the running sum
  int qpos[2];
  bool rok[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    const int s = q0 + r % a.bq;
    rok[h] = r < a.rows && s < a.Sq;
    qpos[h] = a.q_offset + s;
    m[h] = NEG2;
    l[h] = 0.f;
  }

  // columns 8 j + 2 t (+ 1) of the two rows
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int kt0, kt1;                         // kt0 < kt1 always
  fwd_key_tiles<NK>(a, q0, kt0, kt1);
  stage_rows<HD, EXACT>(q_s, q, a, b, hkv, q0);
  stage_keys<HD, NK, EXACT>(kv_s, k, a, b, hkv, kt0 * NK);
  stage_keys<HD, NK, EXACT>(kv_s + KT, v, a, b, hkv, kt0 * NK);
  cp_async_commit();

  [[maybe_unused]] uint32_t qa[QREG ? HD / 16 : 1][4];
  for (int kt = kt0; kt < kt1; ++kt) {
    const bf16* k_s = kv_s + ((kt - kt0) & 1) * 2 * KT;
    const bf16* v_s = k_s + KT;
    if (kt + 1 < kt1) {               // the next tile into the other stage
      bf16* nk = kv_s + ((kt + 1 - kt0) & 1) * 2 * KT;
      stage_keys<HD, NK, EXACT>(nk, k, a, b, hkv, (kt + 1) * NK);
      stage_keys<HD, NK, EXACT>(nk + KT, v, a, b, hkv, (kt + 1) * NK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (kt == kt0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          load_a<LD>(qa[kk], q_s, warp * 16, kk * 16, lane);
      }
    }

    // S = Q K^T for the warp's 16 rows x NK keys
    float s[NK / 8][4];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qf[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[e] = qa[kk][e];
      } else {
        load_a<LD>(qf, q_s, warp * 16, kk * 16, lane);
      }
#pragma unroll
      for (int np = 0; np < NK / 16; ++np) {
        uint32_t kb[4];
        load_b_nk<LD>(kb, k_s, np * 16, kk * 16, lane);
        mma(s[2 * np], qf, kb[0], kb[1]);
        mma(s[2 * np + 1], qf, kb[2], kb[3]);
      }
    }

    // scores in log2 units, masked: element e of fragment j is row
    // warp * 16 + g + 8 (e / 2), key k0 + 8 j + 2 t + e % 2
    const int k0 = kt * NK;
    const bool full = tile_full<NK>(a, q0, k0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = s[j][e] * sl2;
        if (!full) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          bool keep = true;
          if (a.causal) keep = qpos[h] >= kpos;
          if (a.window > 0) keep = keep && qpos[h] - kpos < a.window;
          x = keep ? x : NEG2;
          if (kpos >= a.Sk) x = -INFINITY;  // past the ragged edge: no key
        }
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }

    // the new row max over the 4 threads of each row, then rescale
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float alpha = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[j][2 * h] *= alpha;
        acc[j][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[j][e] = p;
      }

    // O += P V, P from the registers as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t pa[4];
      to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t vb[4];
        load_b_kn<LD>(vb, v_s, np * 16, kk * 16, lane);
        mma(acc[2 * np], pa, vb[0], vb[1]);
        mma(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the stage is free for the load after next
  }

  // o = acc / max(l, 1e-30), lse = m + log(l) in natural units; a row with
  // no unmasked key has m = NEG2 exactly, and its lse is NEG_INF + log(l)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rok[h]) continue;
    const int r = warp * 16 + g + 8 * h;
    const int s = q0 + r % a.bq;
    const float lh = fmaxf(l[h], 1e-30f);
    bf16* row =
        o + ((size_t)(b * a.Sq + s) * a.H + hkv * a.G + r / a.bq) * hd;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store_pair<EXACT>(row, 8 * j + 2 * t, hd, acc[j][2 * h] / lh,
                 acc[j][2 * h + 1] / lh);
    if (t == 0) {
      const float mn = m[h] == NEG2 ? NEG_INF : m[h] * LN2;
      lse[((size_t)(b * a.Hkv + hkv) * a.G + r / a.bq) * a.Sq + s] =
          mn + logf(lh);
    }
  }
}

template <int HD, bool EXACT>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, const Args& a, cudaStream_t stream) {
  const long long bh = (long long)B * a.Hkv;
  const long long blocks = bh * ((a.Sq + a.bq - 1) / a.bq);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = bf16_smem_bytes<HD>();
  auto kern = flash_fwd_bf16_kernel<HD, EXACT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)blocks, MMA_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      (int)bh, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd), o like q, lse (B,Hkv,G,Sq) f32; all
// contiguous on `device`, bf16 ones 16-byte aligned; 1 <= hd <= 256, run at
// the tile width `head_width(hd)`.  window <= 0 means no window.  The
// wrapper checks shapes and types; the bounds here only keep a bad call
// from launching.
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int Sq, int Sk, int H, int Hkv, int hd, int is_bf16,
              int causal, int window, int q_offset, int device,
              void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv || H / Hkv > ROWS)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const Args a = make_args(Sq, Sk, H, Hkv, hd, causal, window, q_offset);
  switch (head_width(hd)) {
#define LAUNCH(D, EXACT)                                                   \
  (is_bf16 ? launch_bf16<D, EXACT>(q, k, v, o, lse, B, a, st)              \
           : launch_f32<D, EXACT>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd,  \
                                  causal, window, q_offset, st))
#define CASE(D) \
  case D: return hd == D ? LAUNCH(D, true) : LAUNCH(D, false);
    FLASH_HEAD_WIDTHS(CASE)
#undef CASE
#undef LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
