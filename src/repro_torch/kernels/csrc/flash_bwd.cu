// Flash-attention backward for Hopper (sm_90a), GQA-folded: bf16 on the
// tensor cores, f32 on the CUDA cores.
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
// masked row has lse ~ -1e30, and exp(s - lse) would be 1, not 0.  Sums are
// f32; dq, dk and dv are written in the input dtype.
//
// Shared by both designs.  The TPU kernels walk the inner loop on a
// sequential grid axis and carry the accumulator in VMEM scratch across
// grid steps.  Blocks on a GPU run in parallel and in no order, so each
// kernel's block owns one output tile and loops over the other axis itself,
// the accumulator in registers, with no atomics (the result is
// deterministic):
//   * dq: one block per (batch * kv head, query tile).  The G query heads of
//     a KV group are folded into the 64 rows of the tile (G * bq = 64 for
//     G | 64), as in flash_fwd.cu, so each K/V tile staged in shared memory
//     serves all G heads.  The block loops over the KV tiles.
//   * dk/dv: one block per (batch * kv head, 64-key tile), looping over the
//     query tiles of all G heads, so the G-head sum of dk and dv happens in
//     the block's registers, with no atomics and no second pass.  The
//     heads stay folded into the 64-row query tile here too, rather than
//     each head walking its own 64-row tiles: the tiles stay full at any G,
//     and lse and delta are staged with them in one layout.
// Ragged lengths are masked in the kernels: keys past Sk and queries past Sq
// get p = 0 and contribute exactly nothing.  Because the mask is explicit,
// a tile that is masked for every (query, key) pair adds exactly zero, so
// the loops visit only the tiles inside the causal and window bounds: dq
// stops at the diagonal tile, dk/dv start from it (offset by q_offset).
//
// bf16 inputs (the training path).  What bounds them on the H100: the four
// products of each kernel (dq: S = Q K^T, dP = dO V^T, dQ += dS K; dk/dv:
// S, dP, dV += P^T dO, dK += dS^T Q) at 6 hd (dq) and 8 hd (dk/dv) FLOPs per
// unmasked pair, against the bf16 tensor-core rate of 989 TFLOP/s: at the
// training shape (8 x 1024, 12 heads of 64, causal) they are bound by
// operations, not bytes.  What the design does about it:
//   * every product is `mma.sync.m16n8k16` with bf16 operands and f32
//     accumulators, fed by `ldmatrix` (`.trans` where the operand is read
//     transposed); the tiles stay bf16 in shared memory, rows padded by 8
//     elements so that the 8 rows an `ldmatrix` reads fall in 8 different
//     bank groups (these building blocks, shared with the forward, are in
//     flash_mma.cuh);
//   * four warps; in dq a warp owns 16 query rows, in dk/dv 16 keys, and
//     computes the transposed scores S^T = K Q^T and dP^T = V dO^T there.
//     The f32 accumulator fragment of one m16n8k16 has the layout of the A
//     fragment of the next, so P (dk/dv) and dS go from the score
//     accumulators straight into the A operand of the accumulating product,
//     rounded to bf16 in registers, with no round trip through shared
//     memory; the Pallas kernels keep them in f32, and this rounding is the
//     one numerical difference (`flash_bwd_dq_bf16_ref` and
//     `flash_bwd_dkv_bf16_ref` in flash_attention.py mirror it);
//   * the next K/V tile (dq) or Q/dO tile with its lse and delta (dk/dv) is
//     loaded with 16-byte `cp.async` (plain loads where hd % 8 != 0) into
//     the second buffer of a 2-stage ring while the current one is
//     computed;
//   * lse and delta of a dq block's rows sit in registers; in dk/dv, where
//     they index the columns of S^T, in shared memory beside the Q tile;
//   * tiles inside the band skip the per-element mask, and the longest dq
//     rows start first, so the causal tail of the grid is short.
// dk/dv computes S^T in chunks of 32 query rows (16 at the widths above
// 96), so that the dk and dv accumulators (HD / 2 f32 each a thread) and the
// scores fit the registers up to width 128.
//
// Head dims.  Any hd from 1 to 256 runs at the tile width of flash_mma.cuh's
// `head_width` (every multiple of 16 up to 128, of 32 above): the columns
// past hd are zeros in shared memory and are never stored; each kernel is
// instantiated twice a width (EXACT, see flash_mma.cuh).  The widths above
// 128 take the design of hd 256 below, the f32 kernels' 32-key tiles
// included.
//
// hd 256 (recurrentgemma-2b's and gemma3-12b's local layers).  A warp's dk
// and dv of 16 keys would be 256 f32 registers a thread, and dq's 16 rows x
// 256 columns 128, beside the scores: above or at the limit of 255.  So the
// output columns are split over NS = 2 blocks (grid dim z): each block of a
// key tile (dk/dv) or query tile (dq) stages the full rows, recomputes S and
// dP over the full hd, and accumulates and writes only its half of the
// columns (128), with the registers of the hd 128 kernels.  The score
// products are done twice, which a later design that passes P^T and dS^T
// between two warps through shared memory would save; nothing else is
// added, no data path and no atomics.  Shared memory: six 64 x 264 bf16
// tiles, 202,752 bytes (dq) and 203,776 with the stats (dk/dv), of the
// 232,448 a block may take, so one block an SM.
//
// f32 inputs (the card-against-CPU answers, held to 1e-4, which bf16 or
// TF32 products cannot meet) keep the first design: f32 FMA on the CUDA
// cores (67 TFLOP/s peak), 4x4 register micro-tiles for the two score
// products and 4 x (hd/16) micro-tiles for the accumulating products, with
// padded f32 tiles and P and dS staged through shared memory.  Its tiles
// are 64 query rows and NK keys: NK = 64 up to width 128; at 256 four f32
// tiles of 64 rows (263,168 bytes) exceed a block's shared memory, so the
// key tile is halved to 32 (a thread then holds 4 x 2 scores and, in
// dk/dv, 2 keys x 16 columns of each accumulator): 210,176 bytes (dq) and
// 222,464 (dk/dv), and at every width above 128 (224 with 64 keys would
// take 251,392 bytes in dq).
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() (0 on success).  Inputs must be contiguous, and bf16
// ones 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int BK = 64;              // keys per KV tile

// The NK-key tiles with an unmasked key for some row of the query tile at q0.
template <int NK>
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int& kt0,
                                          int& kt1) {
  const int first = a.q_offset + q0;
  const int last = a.q_offset + min(q0 + a.bq, a.Sq) - 1;
  kt0 = 0;
  kt1 = (a.Sk + NK - 1) / NK;
  if (a.causal) kt1 = min(kt1, last < 0 ? 0 : last / NK + 1);
  if (a.window > 0) kt0 = max(0, first - a.window + 1) / NK;
}

// The query tiles with an unmasked query for some key of the NK-key tile at
// k0.
template <int NK>
__device__ __forceinline__ void query_tiles(const Args& a, int k0, int& qt0,
                                            int& qt1) {
  qt0 = 0;
  qt1 = (a.Sq + a.bq - 1) / a.bq;
  if (a.causal) {
    const int x = k0 - a.q_offset;
    qt0 = x > 0 ? x / a.bq : 0;
  }
  if (a.window > 0) {
    const int x = a.window + k0 + NK - 1 - a.q_offset;
    qt1 = min(qt1, x > 0 ? (x + a.bq - 1) / a.bq : 0);
  }
}

// Whether row r of the query tile at q0 (query q0 + r % bq) keeps key kpos.
__device__ __forceinline__ bool keeps(const Args& a, int q0, int r, int kpos) {
  const int s = q0 + r % a.bq;
  const int qpos = a.q_offset + s;
  bool keep = r < a.rows && s < a.Sq && kpos < a.Sk;
  if (a.causal) keep = keep && qpos >= kpos;
  if (a.window > 0) keep = keep && qpos - kpos < a.window;
  return keep;
}

// ======================================================================
// f32: FMA on the CUDA cores
// ======================================================================

constexpr int THREADS = 256;

// Keys a tile of the f32 kernels at width HD (see the note at the top).
__host__ __device__ constexpr int f32_keys(int HD) {
  return HD > 128 ? 32 : BK;
}
// p / ds row stride of an NK-key tile (conflict-free)
template <int NK>
__host__ __device__ constexpr int s_stride() { return NK + 16; }

// ROWS rows of a (B,Sq,H,hd) tensor into a padded f32 tile: row r is query
// q0 + r % bq of head hkv * G + r / bq; zeros past the ragged edge and in
// the columns from hd on.
template <int HD, bool EXACT>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          const Args& a, int b, int hkv,
                                          int q0) {
  constexpr int QS = HD + 1;
  const int hd = EXACT ? HD : a.hd;
  for (int i = threadIdx.x; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r % a.bq;
    float x = 0.f;
    if (r < a.rows && s < a.Sq && (EXACT || d < hd))
      x = src[((size_t)(b * a.Sq + s) * a.H + hkv * a.G + r / a.bq) * hd + d];
    dst[r * QS + d] = x;
  }
}

// NK keys of a (B,Sk,Hkv,hd) tensor into a padded f32 tile; zeros past Sk
// and in the columns from hd on.
template <int HD, int NK, bool EXACT>
__device__ __forceinline__ void load_keys(float* dst,
                                          const float* __restrict__ src,
                                          const Args& a, int b, int hkv,
                                          int k0) {
  constexpr int QS = HD + 1;
  const int hd = EXACT ? HD : a.hd;
  for (int i = threadIdx.x; i < NK * HD; i += THREADS) {
    const int c = i / HD, d = i % HD;
    float x = 0.f;
    if (k0 + c < a.Sk && (EXACT || d < hd))
      x = src[((size_t)(b * a.Sk + k0 + c) * a.Hkv + hkv) * hd + d];
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

// This thread's 4 x NK/16 micro-tile (rows tr + 16 i, keys tc + 16 j) of
// p = mask ? exp(s * scale - lse) : 0 and ds = p * (dp - delta) * scale.
template <int HD, int NK>
__device__ __forceinline__ void probs(const float* q_s, const float* do_s,
                                      const float* k_s, const float* v_s,
                                      const float* lse_s, const float* dl_s,
                                      const Args& a, int q0, int k0,
                                      float p[4][NK / 16],
                                      float ds[4][NK / 16]) {
  constexpr int QS = HD + 1, NJ = NK / 16;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float s[4][NJ], dp[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float qv[4], kv[NJ], ov[4], vv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = q_s[(tr + 16 * i) * QS + d];
      ov[i] = do_s[(tr + 16 * i) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      kv[j] = k_s[(tc + 16 * j) * QS + d];
      vv[j] = v_s[(tc + 16 * j) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const float l = lse_s[r], dl = dl_s[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float pv =
          keeps(a, q0, r, k0 + tc + 16 * j) ? expf(s[i][j] * a.scale - l) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - dl) * a.scale;
    }
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  constexpr int NK = f32_keys(HD);
  return sizeof(float) * (size_t)(2 * ROWS * (HD + 1) + 2 * NK * (HD + 1) +
                                  ROWS * s_stride<NK>() + 2 * ROWS);
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  constexpr int NK = f32_keys(HD);
  return sizeof(float) * (size_t)(2 * ROWS * (HD + 1) + 2 * NK * (HD + 1) +
                                  2 * ROWS * s_stride<NK>() + 2 * ROWS);
}

template <int HD, bool EXACT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    Args a) {
  constexpr int QS = HD + 1;
  constexpr int CPT = HD / 16;          // output columns per thread
  constexpr int NK = f32_keys(HD), NJ = NK / 16, SS = s_stride<NK>();
  const int hd = EXACT ? HD : a.hd;
  extern __shared__ float smem[];
  float* q_s = smem;                    // ROWS x QS
  float* do_s = q_s + ROWS * QS;        // ROWS x QS
  float* k_s = do_s + ROWS * QS;        // NK x QS
  float* v_s = k_s + NK * QS;           // NK x QS
  float* ds_s = v_s + NK * QS;          // ROWS x SS
  float* lse_s = ds_s + ROWS * SS;
  float* dl_s = lse_s + ROWS;

  const int b = blockIdx.y / a.Hkv;
  const int hkv = blockIdx.y % a.Hkv;
  const int q0 = blockIdx.x * a.bq;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  load_rows<HD, EXACT>(q_s, q, a, b, hkv, q0);
  load_rows<HD, EXACT>(do_s, dout, a, b, hkv, q0);
  load_stats(lse_s, dl_s, lse, delta, a, b, hkv, q0);

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  int kt0, kt1;
  key_tiles<NK>(a, q0, kt0, kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * NK;
    __syncthreads();  // the previous tile is done with k_s, v_s, ds_s
    load_keys<HD, NK, EXACT>(k_s, k, a, b, hkv, k0);
    load_keys<HD, NK, EXACT>(v_s, v, a, b, hkv, k0);
    __syncthreads();

    float p[4][NJ], ds[4][NJ];
    probs<HD, NK>(q_s, do_s, k_s, v_s, lse_s, dl_s, a, q0, k0, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ds_s[(tr + 16 * i) * SS + tc + 16 * j] = ds[i][j];
    __syncthreads();

    // dq += ds K for this thread's 4 x CPT micro-tile.
#pragma unroll 4
    for (int c = 0; c < NK; ++c) {
      float dsv[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(tr + 16 * i) * SS + c];
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
    float* row =
        dq + ((size_t)(b * a.Sq + s) * a.H + hkv * a.G + r / a.bq) * hd;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (EXACT || tc + 16 * j < hd) row[tc + 16 * j] = acc[i][j];
  }
}

template <int HD, bool EXACT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, Args a) {
  constexpr int QS = HD + 1;
  constexpr int CPT = HD / 16;
  constexpr int NK = f32_keys(HD), NJ = NK / 16, SS = s_stride<NK>();
  const int hd = EXACT ? HD : a.hd;
  extern __shared__ float smem[];
  float* k_s = smem;                    // NK x QS
  float* v_s = k_s + NK * QS;           // NK x QS
  float* q_s = v_s + NK * QS;           // ROWS x QS
  float* do_s = q_s + ROWS * QS;        // ROWS x QS
  float* p_s = do_s + ROWS * QS;        // ROWS x SS
  float* ds_s = p_s + ROWS * SS;        // ROWS x SS
  float* lse_s = ds_s + ROWS * SS;
  float* dl_s = lse_s + ROWS;

  const int b = blockIdx.y / a.Hkv;
  const int hkv = blockIdx.y % a.Hkv;
  const int k0 = blockIdx.x * NK;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  load_keys<HD, NK, EXACT>(k_s, k, a, b, hkv, k0);
  load_keys<HD, NK, EXACT>(v_s, v, a, b, hkv, k0);

  // keys k0 + tr + 16 i, columns tc + 16 j
  float dk_acc[NJ][CPT], dv_acc[NJ][CPT];
#pragma unroll
  for (int i = 0; i < NJ; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  int qt0, qt1;
  query_tiles<NK>(a, k0, qt0, qt1);
  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * a.bq;
    __syncthreads();  // the previous tile is done with q_s, do_s, p_s, ds_s
    load_rows<HD, EXACT>(q_s, q, a, b, hkv, q0);
    load_rows<HD, EXACT>(do_s, dout, a, b, hkv, q0);
    load_stats(lse_s, dl_s, lse, delta, a, b, hkv, q0);
    __syncthreads();

    float p[4][NJ], ds[4][NJ];
    probs<HD, NK>(q_s, do_s, k_s, v_s, lse_s, dl_s, a, q0, k0, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        p_s[(tr + 16 * i) * SS + tc + 16 * j] = p[i][j];
        ds_s[(tr + 16 * i) * SS + tc + 16 * j] = ds[i][j];
      }
    __syncthreads();

    // dv += p^T dO and dk += ds^T Q over the tile's rows (all G heads).
#pragma unroll 2
    for (int r = 0; r < ROWS; ++r) {
      float pv[NJ], dsv[NJ], ov[CPT], qv[CPT];
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        pv[i] = p_s[r * SS + tr + 16 * i];
        dsv[i] = ds_s[r * SS + tr + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        ov[j] = do_s[r * QS + tc + 16 * j];
        qv[j] = q_s[r * QS + tc + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < NJ; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const int key = k0 + tr + 16 * i;
    if (key >= a.Sk) continue;
    const size_t off = ((size_t)(b * a.Sk + key) * a.Hkv + hkv) * hd;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (!EXACT && tc + 16 * j >= hd) continue;
      dk[off + tc + 16 * j] = dk_acc[i][j];
      dv[off + tc + 16 * j] = dv_acc[i][j];
    }
  }
}

// ======================================================================
// bf16: mma.sync on the tensor cores
// ======================================================================

static_assert(MMA_THREADS == 2 * ROWS, "stage_stats: one thread a value");

// Blocks a tile's output columns are split over at width HD (see the note
// at the top): each owns HD / NS of them.
__host__ __device__ constexpr int col_splits(int HD) {
  return HD > 128 ? 2 : 1;
}
static_assert(BK == ROWS, "four warps of 16 keys");

// lse (dst[0, ROWS)) and delta (dst[ROWS, 2 ROWS)) of the tile's rows.
__device__ __forceinline__ void stage_stats(float* dst,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            const Args& a, int b, int hkv,
                                            int q0) {
  const int r = threadIdx.x % ROWS;
  const float* src = threadIdx.x < ROWS ? lse : delta;
  const int s = q0 + r % a.bq;
  const bool ok = r < a.rows && s < a.Sq;
  const float* p =
      ok ? src + ((size_t)(b * a.Hkv + hkv) * a.G + r / a.bq) * a.Sq + s : src;
  cp_async4(dst + threadIdx.x, p, ok);
}

template <int HD>
constexpr size_t dq_bf16_smem_bytes() {   // Q, dO, two stages of K, V
  return sizeof(bf16) * 6 * (size_t)tile<HD>();
}

template <int HD>
constexpr size_t dkv_bf16_smem_bytes() {  // K, V, two stages of Q, dO, stats
  return sizeof(bf16) * 6 * (size_t)tile<HD>() + sizeof(float) * 4 * ROWS;
}

template <int HD, bool EXACT>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, Args a) {
  constexpr int LD = ld<HD>(), TILE = tile<HD>();
  constexpr int OUT = HD / col_splits(HD);   // this block's dq columns
  // 0 at compile time where there is no split, so that hd <= 128 keeps
  // constant fragment offsets
  const int col0 = col_splits(HD) > 1 ? blockIdx.z * OUT : 0;
  const int hd = EXACT ? HD : a.hd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + TILE;
  bf16* kv_s = do_s + TILE;             // [stage][K, V][TILE]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / a.Hkv, hkv = blockIdx.x % a.Hkv;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * a.bq;  // longest rows first
  const float sl2 = a.scale * LOG2E;

  // this thread's rows warp * 16 + g and + 8: lse (log2 units), delta
  float lse2[2], dl[2];
  int qpos[2];
  bool rok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    const int s = q0 + r % a.bq;
    rok[h] = r < a.rows && s < a.Sq;
    qpos[h] = a.q_offset + s;
    lse2[h] = dl[h] = 0.f;
    if (rok[h]) {
      const size_t i = ((size_t)(b * a.Hkv + hkv) * a.G + r / a.bq) * a.Sq + s;
      lse2[h] = lse[i] * LOG2E;
      dl[h] = delta[i];
    }
  }

  float acc[OUT / 8][4];
#pragma unroll
  for (int j = 0; j < OUT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int kt0, kt1;
  key_tiles<BK>(a, q0, kt0, kt1);
  if (kt0 < kt1) {
    stage_rows<HD, EXACT>(q_s, q, a, b, hkv, q0);
    stage_rows<HD, EXACT>(do_s, dout, a, b, hkv, q0);
    stage_keys<HD, BK, EXACT>(kv_s, k, a, b, hkv, kt0 * BK);
    stage_keys<HD, BK, EXACT>(kv_s + TILE, v, a, b, hkv, kt0 * BK);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const bf16* k_s = kv_s + ((kt - kt0) & 1) * 2 * TILE;
    const bf16* v_s = k_s + TILE;
    if (kt + 1 < kt1) {               // the next tile into the other stage
      bf16* nk = kv_s + ((kt + 1 - kt0) & 1) * 2 * TILE;
      stage_keys<HD, BK, EXACT>(nk, k, a, b, hkv, (kt + 1) * BK);
      stage_keys<HD, BK, EXACT>(nk + TILE, v, a, b, hkv, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x BK keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], oa[4];
      load_a<LD>(qa, q_s, warp * 16, kk * 16, lane);
      load_a<LD>(oa, do_s, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kb[4], vb[4];
        load_b_nk<LD>(kb, k_s, np * 16, kk * 16, lane);
        load_b_nk<LD>(vb, v_s, np * 16, kk * 16, lane);
        mma(s[2 * np], qa, kb[0], kb[1]);
        mma(s[2 * np + 1], qa, kb[2], kb[3]);
        mma(dp[2 * np], oa, vb[0], vb[1]);
        mma(dp[2 * np + 1], oa, vb[2], vb[3]);
      }
    }

    // p, then ds in place of s: element e of fragment j is row
    // warp * 16 + g + 8 (e / 2), key k0 + 8 j + 2 t + e % 2
    const int k0 = kt * BK;
    const bool full = tile_full<BK>(a, q0, k0);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, kpos = k0 + 8 * j + 2 * t + (e & 1);
        bool keep = full;
        if (!full) {
          keep = rok[h] && kpos < a.Sk;
          if (a.causal) keep = keep && qpos[h] >= kpos;
          if (a.window > 0) keep = keep && qpos[h] - kpos < a.window;
        }
        const float p = keep ? exp2f(s[j][e] * sl2 - lse2[h]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[h]) * a.scale;
      }

    // dQ += dS K over this block's columns, dS from the registers as bf16
    // A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < OUT / 16; ++np) {
        uint32_t kb[4];
        load_b_kn<LD>(kb, k_s, col0 + np * 16, kk * 16, lane);
        mma(acc[2 * np], da, kb[0], kb[1]);
        mma(acc[2 * np + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();  // the stage is free for the load after next
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rok[h]) continue;
    const int r = warp * 16 + g + 8 * h;
    bf16* row = dq + ((size_t)(b * a.Sq + q0 + r % a.bq) * a.H + hkv * a.G +
                      r / a.bq) * hd;
#pragma unroll
    for (int j = 0; j < OUT / 8; ++j)
      store_pair<EXACT>(row, col0 + 8 * j + 2 * t, hd, acc[j][2 * h],
                 acc[j][2 * h + 1]);
  }
}

template <int HD, bool EXACT>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          Args a) {
  constexpr int LD = ld<HD>(), TILE = tile<HD>();
  constexpr int QC = HD > 96 ? 16 : 32;     // query rows per S^T chunk
  constexpr int OUT = HD / col_splits(HD);  // this block's dk, dv columns
  const int col0 = col_splits(HD) > 1 ? blockIdx.z * OUT : 0;
  const int hd = EXACT ? HD : a.hd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + TILE;
  bf16* qo_s = v_s + TILE;              // [stage][Q, dO][TILE]
  float* st_s = reinterpret_cast<float*>(qo_s + 4 * TILE);  // [stage][2 ROWS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / a.Hkv, hkv = blockIdx.x % a.Hkv;
  const int k0 = blockIdx.y * BK;       // causal: the longest keys first
  const float sl2 = a.scale * LOG2E;

  // keys k0 + warp * 16 + g (+ 8), columns 8 j + 2 t (+ 1)
  float dk_acc[OUT / 8][4], dv_acc[OUT / 8][4];
#pragma unroll
  for (int j = 0; j < OUT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  int qt0, qt1;
  query_tiles<BK>(a, k0, qt0, qt1);
  if (qt0 < qt1) {
    stage_keys<HD, BK, EXACT>(k_s, k, a, b, hkv, k0);
    stage_keys<HD, BK, EXACT>(v_s, v, a, b, hkv, k0);
    stage_rows<HD, EXACT>(qo_s, q, a, b, hkv, qt0 * a.bq);
    stage_rows<HD, EXACT>(qo_s + TILE, dout, a, b, hkv, qt0 * a.bq);
    stage_stats(st_s, lse, delta, a, b, hkv, qt0 * a.bq);
    cp_async_commit();
  }
  for (int qt = qt0; qt < qt1; ++qt) {
    const int stage = (qt - qt0) & 1;
    const bf16* q_s = qo_s + stage * 2 * TILE;
    const bf16* do_s = q_s + TILE;
    const float* lse_s = st_s + stage * 2 * ROWS;
    const float* dl_s = lse_s + ROWS;
    if (qt + 1 < qt1) {               // the next tile into the other stage
      const int nq0 = (qt + 1) * a.bq;
      bf16* nq = qo_s + (stage ^ 1) * 2 * TILE;
      stage_rows<HD, EXACT>(nq, q, a, b, hkv, nq0);
      stage_rows<HD, EXACT>(nq + TILE, dout, a, b, hkv, nq0);
      stage_stats(st_s + (stage ^ 1) * 2 * ROWS, lse, delta, a, b, hkv, nq0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int q0 = qt * a.bq;
    const bool full = tile_full<BK>(a, q0, k0);
#pragma unroll
    for (int c = 0; c < ROWS / QC; ++c) {
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x QC rows
      float s[QC / 8][4], dp[QC / 8][4];
#pragma unroll
      for (int j = 0; j < QC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, k_s, warp * 16, kk * 16, lane);
        load_a<LD>(va, v_s, warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < QC / 16; ++np) {
          uint32_t qb[4], ob[4];
          load_b_nk<LD>(qb, q_s, c * QC + np * 16, kk * 16, lane);
          load_b_nk<LD>(ob, do_s, c * QC + np * 16, kk * 16, lane);
          mma(s[2 * np], ka, qb[0], qb[1]);
          mma(s[2 * np + 1], ka, qb[2], qb[3]);
          mma(dp[2 * np], va, ob[0], ob[1]);
          mma(dp[2 * np + 1], va, ob[2], ob[3]);
        }
      }

      // p^T in place of s, ds^T in place of dp: element e of fragment j is
      // key k0 + warp * 16 + g + 8 (e / 2), row c QC + 8 j + 2 t + e % 2
#pragma unroll
      for (int j = 0; j < QC / 8; ++j) {
        const int r = c * QC + 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + r);
        const float2 d2 = *reinterpret_cast<const float2*>(dl_s + r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + warp * 16 + g + 8 * (e >> 1);
          const bool keep = full || keeps(a, q0, r + (e & 1), kpos);
          const float l = (e & 1) ? l2.y : l2.x;
          const float d = (e & 1) ? d2.y : d2.x;
          const float p = keep ? exp2f(s[j][e] * sl2 - l * LOG2E) : 0.f;
          dp[j][e] = p * (dp[j][e] - d) * a.scale;
          s[j][e] = p;
        }
      }

      // dV += P^T dO and dK += dS^T Q over the chunk's rows and this
      // block's columns, P^T and dS^T from the registers as bf16 A fragments
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        uint32_t pa[4], da[4];
        to_a(pa, s[2 * kk], s[2 * kk + 1]);
        to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < OUT / 16; ++np) {
          uint32_t ob[4], qb[4];
          load_b_kn<LD>(ob, do_s, col0 + np * 16, c * QC + kk * 16, lane);
          load_b_kn<LD>(qb, q_s, col0 + np * 16, c * QC + kk * 16, lane);
          mma(dv_acc[2 * np], pa, ob[0], ob[1]);
          mma(dv_acc[2 * np + 1], pa, ob[2], ob[3]);
          mma(dk_acc[2 * np], da, qb[0], qb[1]);
          mma(dk_acc[2 * np + 1], da, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the load after next
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + warp * 16 + g + 8 * h;
    if (key >= a.Sk) continue;
    const size_t off = ((size_t)(b * a.Sk + key) * a.Hkv + hkv) * hd;
#pragma unroll
    for (int j = 0; j < OUT / 8; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      store_pair<EXACT>(dk + off, col, hd, dk_acc[j][2 * h],
                        dk_acc[j][2 * h + 1]);
      store_pair<EXACT>(dv + off, col, hd, dv_acc[j][2 * h],
                        dv_acc[j][2 * h + 1]);
    }
  }
}

// ======================================================================
// Launch
// ======================================================================

// Raise the dynamic shared memory limit of `kern`, then launch it.
template <typename Kernel, typename... Ptrs>
int launch(Kernel kern, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, const Args& a, Ptrs... ptrs) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kern<<<grid, threads, smem, stream>>>(ptrs..., a);
  return (int)cudaGetLastError();
}

template <int HD, bool EXACT>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B,
              const Args& a, bool bf, cudaStream_t st) {
  const int tiles = (a.Sq + a.bq - 1) / a.bq;
  if (bf)
    return launch(flash_bwd_dq_bf16_kernel<HD, EXACT>,
                  dim3(B * a.Hkv, tiles, col_splits(HD)),
                  MMA_THREADS, dq_bf16_smem_bytes<HD>(), st, a,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v,
                  (const bf16*)dout, (const float*)lse, (const float*)delta,
                  (bf16*)dq);
  return launch(flash_bwd_dq_kernel<HD, EXACT>, dim3(tiles, B * a.Hkv),
                THREADS, dq_smem_bytes<HD>(), st, a, (const float*)q,
                (const float*)k,
                (const float*)v, (const float*)dout, (const float*)lse,
                (const float*)delta, (float*)dq);
}

template <int HD, bool EXACT>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               const Args& a, bool bf, cudaStream_t st) {
  if (bf)
    return launch(flash_bwd_dkv_bf16_kernel<HD, EXACT>,
                  dim3(B * a.Hkv, (a.Sk + BK - 1) / BK, col_splits(HD)),
                  MMA_THREADS, dkv_bf16_smem_bytes<HD>(), st, a,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v,
                  (const bf16*)dout, (const float*)lse, (const float*)delta,
                  (bf16*)dk, (bf16*)dv);
  constexpr int NK = f32_keys(HD);
  return launch(flash_bwd_dkv_kernel<HD, EXACT>,
                dim3((a.Sk + NK - 1) / NK, B * a.Hkv), THREADS,
                dkv_smem_bytes<HD>(), st, a, (const float*)q, (const float*)k,
                (const float*)v, (const float*)dout, (const float*)lse,
                (const float*)delta, (float*)dk, (float*)dv);
}

bool bad_shape(int B, int Sq, int Sk, int H, int Hkv) {
  return B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv || H / Hkv > ROWS;
}

}  // namespace

extern "C" {

// q, do (B,Sq,H,hd); k, v (B,Sk,Hkv,hd); lse, delta (B,Hkv,G,Sq) f32; dq
// like q; all contiguous on `device`, bf16 ones 16-byte aligned; 1 <= hd <=
// 256, run at the tile width `head_width(hd)`.  window <= 0 means no
// window.  The wrapper checks shapes and types; the bounds here only keep a
// bad call from launching.
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
  switch (head_width(hd)) {
#define LAUNCH(D, EXACT) \
  launch_dq<D, EXACT>(q, k, v, dout, lse, delta, dq, B, a, is_bf16, st)
#define CASE(D) \
  case D: return hd == D ? LAUNCH(D, true) : LAUNCH(D, false);
    FLASH_HEAD_WIDTHS(CASE)
#undef CASE
#undef LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
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
  switch (head_width(hd)) {
#define LAUNCH(D, EXACT)                                                  \
  launch_dkv<D, EXACT>(q, k, v, dout, lse, delta, dk, dv, B, a, is_bf16, st)
#define CASE(D) \
  case D: return hd == D ? LAUNCH(D, true) : LAUNCH(D, false);
    FLASH_HEAD_WIDTHS(CASE)
#undef CASE
#undef LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
