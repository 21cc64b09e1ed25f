// bf16 tensor-core building blocks shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): the call's fixed arguments, the tile widths
// and the head dims they take, `cp.async` staging of query rows and key
// tiles into bf16 shared-memory tiles, `ldmatrix` fragment loads and
// `mma.sync.m16n8k16` with bf16 operands and f32 accumulators, and the
// outputs' stores.  wkv.cu takes its `cp.async` helpers.
//
// Layouts.  Query rows are folded: row r of a ROWS-row tile is query
// q0 + r % bq of head hkv * G + r / bq (G * bq <= ROWS), so one K/V tile in
// shared memory serves all G heads of a KV group.  Tiles are [rows][HD]
// bf16 with each row padded by 8 elements (16 bytes): the 8 rows one
// `ldmatrix` reads then start in 8 different bank groups.  Every tensor a
// tile is staged from must be contiguous and 16-byte aligned.
//
// Head dims.  The kernels are instantiated at a few tile widths HD
// (FLASH_HEAD_WIDTHS: every multiple of 16 up to 128, of 32 above, so that
// `m16n8k16` steps 16 along HD in S = Q K^T and 8 in P V), and a call at
// head dim hd runs the least width that holds it (`head_width`).  The
// columns hd..HD - 1 of a tile are zeros, staged in shared memory only: a
// zero column of Q and K adds exactly nothing to S, and the outputs'
// columns from hd on are never stored.  Each kernel is instantiated twice a
// width (template argument EXACT): at hd == HD, the head dims of the
// configs, with HD as the row stride and 16-byte `cp.async` staging, the
// code of a kernel written for that one head dim; and below it with hd
// read at run time and the padding masked.  Rows hd elements apart are
// 16-byte aligned only where hd % 8 == 0: there the padded instance stages
// by 16-byte `cp.async` too, elsewhere an element at a time by plain
// loads, outside the asynchronous ring.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;            // query rows per tile (G heads x bq)
constexpr int MMA_THREADS = 128;    // 4 warps of 16 rows
constexpr float LOG2E = 1.4426950408889634f;
static_assert(ROWS == 4 * 16, "four warps of 16 rows");

// The tile widths the kernels are instantiated at.
#define FLASH_HEAD_WIDTHS(X) \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(160) X(192) X(224) X(256)

// The width a call at head dim hd runs: the least multiple of 16 (hd <= 128)
// or 32 (above) that holds it; 0 outside 1..256 (no kernel).
inline int head_width(int hd) {
  if (hd < 1 || hd > 256) return 0;
  return hd <= 128 ? (hd + 15) / 16 * 16 : (hd + 31) / 32 * 32;
}

// The fixed arguments of one call.  hd is the real head dim: the row stride
// in device memory; the scale is 1/sqrt(hd).
struct Args {
  int Sq, Sk, H, Hkv, G, bq, rows, causal, window, q_offset, hd;
  float scale;
};

Args make_args(int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
               int q_offset) {
  Args a;
  a.hd = hd;
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

// Row stride of a bf16 tile of HD columns, and the size of a ROWS-row one.
template <int HD>
__host__ __device__ constexpr int ld() { return HD + 8; }
template <int HD>
__host__ __device__ constexpr int tile() { return ROWS * ld<HD>(); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros where !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  With .trans each is delivered transposed.
__device__ __forceinline__ void ldsm4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, round to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragments c[2i], c[2i+1] (16 x 16, columns 16 i..16 i+15) as
// the A fragment of a product over those 16 columns, rounded to bf16.
__device__ __forceinline__ void to_a(uint32_t a[4], const float c0[4],
                                     const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The A fragment of rows m0.., columns k0.. of a [rows][LD] tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* t, int m0,
                                       int k0, int lane) {
  ldsm4(a, t + (m0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}
// B fragments of two 8-column tiles (n0.., n0 + 8..) over k0..k0 + 15, from
// a tile stored [n][k] (b[0], b[1] the first, b[2], b[3] the second).
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t b[4], const bf16* t,
                                          int n0, int k0, int lane) {
  ldsm4(b, t + (n0 + ((lane >> 4) << 3) + (lane & 7)) * LD + k0 +
               ((lane >> 3) & 1) * 8);
}
// The same from a tile stored [k][n].
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t b[4], const bf16* t,
                                          int n0, int k0, int lane) {
  ldsm4t(b, t + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + n0 +
                (lane >> 4) * 8);
}

// ROWS rows of a (B,Sq,H,hd) tensor into a bf16 tile of HD columns: row r
// is query q0 + r % bq of head hkv * G + r / bq; zeros past the ragged edge
// and in the columns from hd on.  By 16-byte `cp.async` copies,
// asynchronous, where hd % 8 == 0 (always where EXACT: hd == HD), else one
// element a plain load.
template <int HD, bool EXACT>
__device__ __forceinline__ void stage_rows(bf16* dst,
                                           const bf16* __restrict__ src,
                                           const Args& a, int b, int hkv,
                                           int q0) {
  const int hd = EXACT ? HD : a.hd;
  if (!EXACT && hd % 8) {
    for (int i = threadIdx.x; i < ROWS * HD; i += MMA_THREADS) {
      const int r = i / HD, c = i % HD;
      const int s = q0 + r % a.bq;
      const bool ok = r < a.rows && s < a.Sq && c < hd;
      dst[r * ld<HD>() + c] =
          ok ? src[((size_t)(b * a.Sq + s) * a.H + hkv * a.G + r / a.bq) * hd +
                   c]
             : __float2bfloat16_rn(0.f);
    }
    return;
  }
  constexpr int CH = HD / 8;           // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i % CH * 8;
    const int s = q0 + r % a.bq;
    const bool ok = r < a.rows && s < a.Sq && (EXACT || c < hd);
    const bf16* p =
        ok ? src + ((size_t)(b * a.Sq + s) * a.H + hkv * a.G + r / a.bq) * hd +
                 c
           : src;
    cp_async16(dst + r * ld<HD>() + c, p, ok);
  }
}

// NK keys of a (B,Sk,Hkv,hd) tensor into a bf16 tile, as stage_rows; zeros
// past Sk and in the columns from hd on.
template <int HD, int NK, bool EXACT>
__device__ __forceinline__ void stage_keys(bf16* dst,
                                           const bf16* __restrict__ src,
                                           const Args& a, int b, int hkv,
                                           int k0) {
  const int hd = EXACT ? HD : a.hd;
  if (!EXACT && hd % 8) {
    for (int i = threadIdx.x; i < NK * HD; i += MMA_THREADS) {
      const int r = i / HD, c = i % HD;
      const bool ok = k0 + r < a.Sk && c < hd;
      dst[r * ld<HD>() + c] =
          ok ? src[((size_t)(b * a.Sk + k0 + r) * a.Hkv + hkv) * hd + c]
             : __float2bfloat16_rn(0.f);
    }
    return;
  }
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < NK * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i % CH * 8;
    const bool ok = k0 + r < a.Sk && (EXACT || c < hd);
    const bf16* p =
        ok ? src + ((size_t)(b * a.Sk + k0 + r) * a.Hkv + hkv) * hd + c : src;
    cp_async16(dst + r * ld<HD>() + c, p, ok);
  }
}

// Columns col and col + 1 of a bf16 output row of hd elements.  EXACT: one
// 4-byte store; else one a column, none from hd on (the padding).
template <bool EXACT>
__device__ __forceinline__ void store_pair(bf16* row, int col, int hd, float x,
                                           float y) {
  if constexpr (EXACT) {
    *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(x, y);
  } else {
    if (col < hd) row[col] = __float2bfloat16_rn(x);
    if (col + 1 < hd) row[col + 1] = __float2bfloat16_rn(y);
  }
}

// Whether every (row, key) pair of the query tile at q0 and the NK-key tile
// at k0 is in range and unmasked: then the kernels skip the per-element
// mask.
template <int NK>
__device__ __forceinline__ bool tile_full(const Args& a, int q0, int k0) {
  const int first = a.q_offset + q0, last = first + a.bq - 1;
  return a.rows == ROWS && q0 + a.bq <= a.Sq && k0 + NK <= a.Sk &&
         (!a.causal || first >= k0 + NK - 1) &&
         (a.window <= 0 || last - k0 < a.window);
}

}  // namespace
