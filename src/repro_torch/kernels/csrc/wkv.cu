// RWKV-6 chunked WKV recurrence for Hopper (sm_90a), f32.
//
// Replaces: src/repro/kernels/wkv.py:32 `_wkv_kernel` (entry `wkv_chunked`,
// :73), the Pallas TPU kernel of the chunked form of
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//   o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t,
// which is exactly `models/layers.py:852 _wkv_chunk_scan`, the oracle the
// reference's model calls.  Per chunk of `chunk` steps, with the oracle's
// clamps:
//   e_t = exp(cumsum_t log max(w, 1e-8)),  e_excl = e / max(w, 1e-8),
//   o   = (r e_excl) S + strict_lower((r e_excl)(k / max(e, 1e-30))^T) v
//         + (r . (u k)) v,
//   S   = e_C^T * S + ((k / max(e, 1e-30)) * e_C)^T v.
// The factored form is kept term by term (the products and quotients are
// rounded where the oracle rounds them): at the decay clip w >= 0.1923
// e_t falls to 3.5e-12 within a chunk of 16 and k / e grows to 3e11 |k|,
// so a rearranged form would round differently.  Logs and exps are logf
// and expf (no fast-math intrinsics) and the cumulative sum runs in order.
//
// Instances.  The chunk length C (16, 32, 64) and the head width W (64,
// 128, 256) are template arguments, with C * W <= 4096 (one block's shared
// memory: 12 tiles of C x (W + 4) floats): (16, 64), (16, 128), (16, 256),
// (32, 64), (32, 128), (64, 64).  A call runs the smallest instance that
// holds its chunk and head dim.  Each is built exact (chunk == C and
// hd == W, rows staged by 16-byte copies) and padded (chunk and hd read at
// run time).  A padded instance stages only the call's rows and columns;
// the rest of its tiles hold zero r, k, v and w = 1 (pad steps), or zeros
// (pad columns, whose decays are zeroed by hand).  Such a row adds exactly
// nothing: log 1 = 0 leaves the prefix sum, k / e = 0, r e_excl = 0, and
// a column past hd has e_C = 0, u = 0 and v = 0.  The arithmetic runs over
// all C steps and W rows in the exact instance's order, so a padded call
// gives, bit for bit, what the exact instance gives on the same inputs
// padded by the caller (a pad step after each chunk's last, a zero column
// past hd).
//
// Design.  The Pallas kernel runs one program per batch * head and walks
// the chunks with a fori_loop carrying the (hd, hd) state.  Here a head's
// chunks run in order inside one thread block, and the state lives in
// registers:
//   - Value columns.  Column e of o and of the state needs only column e
//     of v and of the state, so a head's columns may be split over
//     n_split blocks (tiles of ceil(hd / n_split) columns, the last one
//     short) that never talk.  A column is held by P lanes of one warp
//     (P = 4 at W 64, W / 16 above), 16 rows each: lane q of column e
//     holds rows d = 4 P m + 4 q + l (m, l < 4), and thread 32 w + (32 /
//     P) q + i holds column e0 + (32 / P) w + i.  A block holds at most
//     CB = min(W, 512 / P) columns (64, 64, 32 at W 64, 128, 256; 256 / P
//     above chunk 16: 32 at (32, 128)), so a head of hd > CB takes at
//     least ceil(hd / CB) blocks: its state (hd^2 floats, all of an SM's
//     registers at hd 256) does not fit one.
//     Above that floor the launcher splits only where one block per
//     (b, h) would leave SMs idle (batch 1): every block repeats the
//     decays and the scores, which need all hd columns.
//   - Staging (A).  Each chunk's r, k, w, v rows (chunk x hd f32 each) are
//     copied from the caller's (B, S, H, hd) layout by `cp.async` (16 bytes
//     where hd % 4 == 0 and the pointers are 16-byte aligned, else 4) into a
//     two-stage ring in shared memory: chunk c + 1 is in flight while
//     chunk c computes.
// Per chunk, every thread of the block works in each phase:
//   B. the decays: log max(w, 1e-8) of every entry in parallel, then the
//      C-step prefix sum in order, one thread per column (the only
//      sequential part), then exp, r e_excl, k / e, (k / e) e_C and u k of
//      every entry in parallel, rounded as the oracle rounds them;
//   C. the inter-chunk term, 16 steps at a time: each state thread sums
//      re[t] . S[:, e] over its 16 rows for the 16 t from float4 reads of
//      r e_excl (4 FMAs a read, one address for the lanes of a column
//      group), and a column's P partial sums are added by log2 P warp
//      shuffles, lane q keeping t = P i + q of the 16; meanwhile the other
//      threads take the chunk's chunk (chunk + 1) / 2 scores (the strictly
//      lower triangle and the bonus r . (u k) on the diagonal), float4 dot
//      products, one thread each;
//   D. each state thread finishes o for its C / P steps and updates its 16
//      state entries from float4 reads of (k / e) e_C; v's column is held
//      in registers at C 16 and read from shared memory above.
// Tile rows are padded to W + 4 floats: float4 rows, and 8 consecutive rows
// start in 8 different bank groups.  A column's arithmetic (which rows a
// thread sums, in which order, and how the P sums are added) depends on
// the instance only, never on the split, and every score is one thread's
// in a fixed order, so any n_split gives the same o and state bit for bit.
// No tensor cores: TF32 keeps 10 mantissa bits, and at the decay clip
// k / e reaches 3e11 |k| within a chunk, so the chunk products would miss
// the kernel's 1e-4 tolerance.
//
// What bounds it on the H100.  Per (b, h) and chunk it does about
// 4 C hd^2 + 2 C^2 hd flops (0.29 MFLOP at hd 64) on 5 C hd floats it
// must read or write (r, k, v, w in, o out): hd / 5 flops a byte against
// the f32 FMA machine balance (67 TFLOP/s / 3.35 TB/s = 20), so the
// roofline bound is device-memory bandwidth up to hd 64 and compute above.
// The kernel is bound instead by one chunk's latency times the chunks of
// a head, which run in order: all blocks of the prefill shape are
// resident at once.  Within a chunk the inter-chunk product and the state
// update read one float of shared memory for each FMA (the state is in
// registers, its multiplier is not), then come the decays, the scores and
// five barriers.  Moving the state-independent work (decays, scores) of
// the next chunk off this chain is later work.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() (0 on success).  Inputs contiguous f32; hd 1-256 and
// chunk 1-64 with chunk x (hd's width) <= 4096 (`wkv_supported`), S a
// multiple of chunk; s_fin may be null.

#include "flash_mma.cuh"            // cp.async and smem_u32

namespace {

constexpr int STAGES = 2;           // the ring of staged chunks
constexpr int MAX_TILE = 4096;      // chunk x head width of an instance
constexpr size_t MAX_SMEM = 232448; // shared bytes an H100 block may take

// The instance of chunk length C and head width W.
template <int C, int W>
struct Inst {
  static constexpr int P = W <= 64 ? 4 : W / 16;   // lanes a column
  static constexpr int LOG_P = P == 4 ? 2 : P == 8 ? 3 : 4;
  static constexpr int CPW = 32 / P;               // columns a warp
  // columns a block: at most 512 threads, 256 above chunk 16 (a padded
  // (32, 128) block of 512 spills at the 128 registers that leaves)
  static constexpr int MAX_THREADS = C == 16 ? 512 : 256;
  static constexpr int CB = W < MAX_THREADS / P ? W : MAX_THREADS / P;
  static constexpr int THREADS = P * CB;
  static constexpr int LD = W + 4;                 // tile row stride
  static constexpr int TILE = C * LD;
  static constexpr int SLD = C + 4;                // score row stride
  static constexpr int PAIRS = C * (C + 1) / 2;    // scores on and below
                                                   // the diagonal
  // floats of shared memory: r, k, w, v of each stage; r e_excl, k / e,
  // (k / e) e_C (the logs before it), u k; the scores; e_C and u
  static constexpr int SMEM_FLOATS =
      (4 * STAGES + 4) * TILE + C * SLD + 2 * W;
  static constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
  static constexpr int MIN_BLOCKS =
      THREADS <= 256 && 2 * SMEM_BYTES <= MAX_SMEM ? 2 : 1;
  static_assert(C % 16 == 0 && C * W <= MAX_TILE && SMEM_BYTES <= MAX_SMEM,
                "an instance's tiles must fit one block");
  static_assert(P * 16 == W || (P == 4 && W <= 64), "16 rows a lane");
};

// VEC floats global -> shared, asynchronously
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if (VEC == 4)
    cp_async16(dst, src, true);
  else
    cp_async4(dst, src, true);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// Start copying a chunk's cl r, k, w, v rows of hd columns into the stage
// at `tiles` (four tiles: r, k, w, v), VEC floats per copy; one commit
// group.
template <int LD, int TILE, int VEC>
__device__ __forceinline__ void stage(
    float* tiles, const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ w, const float* __restrict__ v, size_t off,
    size_t step, int hd, int cl) {
  const int per_row = hd / VEC;
  for (int i = threadIdx.x; i < cl * per_row; i += blockDim.x) {
    const int t = i / per_row, d = (i - t * per_row) * VEC;
    const size_t g = off + (size_t)t * step + d;
    float* const x = tiles + t * LD + d;
    cp_async<VEC>(x, r + g);
    cp_async<VEC>(x + TILE, k + g);
    cp_async<VEC>(x + 2 * TILE, w + g);
    cp_async<VEC>(x + 3 * TILE, v + g);
  }
  cp_async_commit();
}

template <int C, int W, bool EXACT, int VEC>
__global__ void __launch_bounds__(Inst<C, W>::THREADS,
                                  Inst<C, W>::MIN_BLOCKS)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ o,
           float* __restrict__ s_fin, int S, int H, int hd_arg,
           int chunk_arg, int n_split, int cols) {
  using I = Inst<C, W>;
  constexpr int P = I::P, CPW = I::CPW, LD = I::LD, TILE = I::TILE;
  constexpr int SLD = I::SLD, Q = W / 4;
  constexpr int KEEP = 16 / P;      // steps a lane keeps of 16
  const int hd = EXACT ? W : hd_arg;
  const int cl = EXACT ? C : chunk_arg;
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const re = ring + 4 * STAGES * TILE;   // r * e_excl
  float* const kk = re + TILE;      // k / max(e, 1e-30)
  float* const ke = kk + TILE;      // the logs' prefix sums, then kk * e_C
  float* const uk = ke + TILE;      // u * k
  float* const sc = uk + TILE;      // scores; the bonus on the diagonal
  float* const ec = sc + C * SLD;   // e at the chunk's last step
  float* const us = ec + W;         // u of this head

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int bh = blockIdx.x / n_split;     // the head
  const int e0 = (blockIdx.x - bh * n_split) * cols;   // its first column
  const int h = bh % H;
  const size_t step = (size_t)H * hd;       // one time step of (B,S,H,hd)
  const size_t base = (size_t)(bh / H) * S * step + (size_t)h * hd;
  // this block's columns e0 .. e0 + cols - 1 (fewer in the last block)
  // are held by its first warps: thread 32 w + CPW q + i holds column
  // e0 + CPW w + i; the other warps only stage and share the decays and
  // the scores
  const int q = (tid / CPW) % P;            // row quarter of the column
  const int ci = (tid >> 5) * CPW + tid % CPW;   // the column in the tile
  const int e = e0 + ci;                    // the column
  const bool col = ci < cols && e < hd;
  const bool state_warp = (tid & ~31) < P * cols;
  const int n4 = (hd + 3) >> 2;             // float4s a row's dot reads
  const int ng = (hd + 4 * P - 1) / (4 * P);   // row groups below hd

  // the pad columns the float4 reads reach stay zero, and the pad steps
  // of a short chunk hold zero r, k, v and w = 1; e_C and u of the pad
  // rows are zero, so their state rows stay zero
  for (int i = tid; i < 4 * STAGES * TILE; i += nt) {
    if (i % LD >= hd)
      ring[i] = 0.f;
    else if (!EXACT && (i / LD) % C >= cl)
      ring[i] = (i / TILE) % 4 == 2 ? 1.f : 0.f;
  }
  for (int d = tid; d < W; d += nt) {
    ec[d] = 0.f;
    us[d] = d < hd ? u[h * hd + d] : 0.f;
  }
  float st[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) st[i] = 0.f;
  const int n_chunks = S / cl;
  if (n_chunks > 0)
    stage<LD, TILE, VEC>(ring, r, k, w, v, base, step, hd, cl);

  for (int c = 0; c < n_chunks; ++c) {
    const size_t off = base + (size_t)c * cl * step;
    float* const rs = ring + (c % STAGES) * 4 * TILE;
    float* const ks = rs + TILE;
    float* const ws = ks + TILE;
    float* const vs = ws + TILE;
    // chunk c has landed and every thread is past chunk c - 1, whose
    // stage now takes chunk c + 1 while this one computes
    cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < n_chunks)
      stage<LD, TILE, VEC>(ring + ((c + 1) % STAGES) * 4 * TILE, r, k, w,
                           v, off + (size_t)cl * step, step, hd, cl);

    // B. decays: the logs of every entry ...
    for (int i = tid; i < C * Q; i += nt) {
      const int x = (i / Q) * LD + 4 * (i % Q);
      if (4 * (i % Q) < hd) {
        const float4 wt = ld4(ws + x);
        st4(ke + x, make_float4(logf(fmaxf(wt.x, 1e-8f)),
                                logf(fmaxf(wt.y, 1e-8f)),
                                logf(fmaxf(wt.z, 1e-8f)),
                                logf(fmaxf(wt.w, 1e-8f))));
      }
    }
    __syncthreads();
    // ... their sum in order over the chunk, one thread per column ...
    if (tid < hd) {
      float cum = 0.f;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        cum += ke[t * LD + tid];
        ke[t * LD + tid] = cum;
      }
      ec[tid] = expf(cum);
    }
    __syncthreads();
    // ... and every entry's products and quotients (zero past hd)
    for (int i = tid; i < C * Q; i += nt) {
      const int d0 = 4 * (i % Q);
      if (d0 < 4 * P * ng) {
        const int x = (i / Q) * LD + d0;
        const float4 wt = ld4(ws + x), rt = ld4(rs + x), kt = ld4(ks + x);
        const float4 cs = ld4(ke + x), e4 = ld4(ec + d0), u4 = ld4(us + d0);
        float rv[4], kv[4], kev[4], ukv[4];
        const float wa[4] = {wt.x, wt.y, wt.z, wt.w};
        const float ra[4] = {rt.x, rt.y, rt.z, rt.w};
        const float ka[4] = {kt.x, kt.y, kt.z, kt.w};
        const float ca[4] = {cs.x, cs.y, cs.z, cs.w};
        const float ea[4] = {e4.x, e4.y, e4.z, e4.w};
        const float ua[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (d0 + l < hd) {
            const float ed = expf(ca[l]);
            const float kq = ka[l] / fmaxf(ed, 1e-30f);
            rv[l] = ra[l] * (ed / fmaxf(wa[l], 1e-8f));
            kv[l] = kq;
            kev[l] = kq * ea[l];
            ukv[l] = ua[l] * ka[l];
          } else {
            rv[l] = kv[l] = kev[l] = ukv[l] = 0.f;
          }
        }
        st4(re + x, make_float4(rv[0], rv[1], rv[2], rv[3]));
        st4(kk + x, make_float4(kv[0], kv[1], kv[2], kv[3]));
        st4(ke + x, make_float4(kev[0], kev[1], kev[2], kev[3]));
        st4(uk + x, make_float4(ukv[0], ukv[1], ukv[2], ukv[3]));
      }
    }
    __syncthreads();

    // C. inter-chunk term, 16 steps at a time: this thread's rows of
    // column e, all 16 t ...
    float inter[C / P];
#pragma unroll
    for (int b = 0; b < C / 16; ++b) {
      float part[16];
#pragma unroll
      for (int t = 0; t < 16; ++t) part[t] = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (state_warp && m < ng) {
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            const float4 a = ld4(re + (16 * b + t) * LD + 4 * P * m + 4 * q);
            part[t] = fmaf(a.x, st[4 * m], part[t]);
            part[t] = fmaf(a.y, st[4 * m + 1], part[t]);
            part[t] = fmaf(a.z, st[4 * m + 2], part[t]);
            part[t] = fmaf(a.w, st[4 * m + 3], part[t]);
          }
        }
      }
      // ... summed over the column's P lanes (CPW apart), halving the
      // steps at each level; lane q keeps t = 16 b + P i + q
      if (state_warp) {
#pragma unroll
        for (int lv = 0; lv < I::LOG_P; ++lv) {
          const bool hi = (q >> lv) & 1;
#pragma unroll
          for (int i = 0; i < (8 >> lv); ++i) {
            const float mine = hi ? part[2 * i + 1] : part[2 * i];
            const float give = hi ? part[2 * i] : part[2 * i + 1];
            part[i] = mine + __shfl_xor_sync(0xffffffffu, give, CPW << lv);
          }
        }
#pragma unroll
        for (int i = 0; i < KEEP; ++i) inter[KEEP * b + i] = part[i];
      }
    }
    // the scores of the chunk's steps, one thread each, from the top
    // thread down
    const int pairs = EXACT ? I::PAIRS : cl * (cl + 1) / 2;
    for (int p = nt - 1 - tid; p < pairs; p += nt) {
      int t = 0, j = p;             // row-major over the lower triangle
      while (j > t) j -= ++t;
      const float* a = (j == t ? rs : re) + t * LD;
      const float* b = (j == t ? uk : kk) + j * LD;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        if (i < n4) {
          const float4 x = ld4(a + 4 * i), y = ld4(b + 4 * i);
          acc.x = fmaf(x.x, y.x, acc.x);
          acc.y = fmaf(x.y, y.y, acc.y);
          acc.z = fmaf(x.z, y.z, acc.z);
          acc.w = fmaf(x.w, y.w, acc.w);
        }
      }
      sc[t * SLD + j] = (acc.x + acc.y) + (acc.z + acc.w);
    }
    __syncthreads();

    // D. o for this lane's C / P steps; then its 16 state entries
    if (state_warp) {
      // v's column: in registers at C 16, read from shared memory above
      float vr[C == 16 ? C : 1];
      if constexpr (C == 16) {
#pragma unroll
        for (int j = 0; j < C; ++j) vr[j] = col ? vs[j * LD + e] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < C / P; ++i) {
        const int t = 16 * (i / KEEP) + P * (i % KEEP) + q;
        float intra = 0.f, bonus = 0.f;
        if constexpr (C == 16) {
#pragma unroll
          for (int j4 = 0; j4 < C / 4; ++j4) {
            const float4 s4 = ld4(sc + t * SLD + 4 * j4);
            const float sa[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              const int j = 4 * j4 + l;
              if (j < t) intra = fmaf(sa[l], vr[j], intra);
              if (j == t) bonus = sa[l] * vr[j];
            }
          }
        } else if (col && t < cl) {
          for (int j = 0; j < t; ++j)
            intra = fmaf(sc[t * SLD + j], vs[j * LD + e], intra);
          bonus = sc[t * SLD + t] * vs[t * LD + e];
        }
        if (col && t < cl)
          o[off + (size_t)t * step + e] = (inter[i] + intra) + bonus;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m < ng) {
          float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
          for (int j = 0; j < C; ++j) {
            const float4 x = ld4(ke + j * LD + 4 * P * m + 4 * q);
            float vj;
            if constexpr (C == 16)
              vj = vr[j];
            else
              vj = col ? vs[j * LD + e] : 0.f;
            a[0] = fmaf(x.x, vj, a[0]);
            a[1] = fmaf(x.y, vj, a[1]);
            a[2] = fmaf(x.z, vj, a[2]);
            a[3] = fmaf(x.w, vj, a[3]);
          }
          const float4 e4 = ld4(ec + 4 * P * m + 4 * q);
          st[4 * m] = fmaf(e4.x, st[4 * m], a[0]);
          st[4 * m + 1] = fmaf(e4.y, st[4 * m + 1], a[1]);
          st[4 * m + 2] = fmaf(e4.z, st[4 * m + 2], a[2]);
          st[4 * m + 3] = fmaf(e4.w, st[4 * m + 3], a[3]);
        }
      }
    }
  }
  if (s_fin != nullptr && col) {
    float* out = s_fin + (size_t)bh * hd * hd + e;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int d = 4 * P * m + 4 * q + l;
        if (d < hd) out[(size_t)d * hd] = st[4 * m + l];
      }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int sm_count(int device) {
  static int sms[64];
  if (device < 64 && sms[device]) return sms[device];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device)
      != cudaSuccess)
    return 0;
  if (device < 64) sms[device] = n;
  return n;
}

int wkv_width(int hd) { return hd <= 64 ? 64 : hd <= 128 ? 128 : 256; }
int wkv_chunk(int chunk) { return chunk <= 16 ? 16 : chunk <= 32 ? 32 : 64; }

bool supported(int hd, int chunk) {
  return hd >= 1 && hd <= 256 && chunk >= 1 && chunk <= 64
         && chunk * wkv_width(hd) <= MAX_TILE;
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const float*, float*, float*, int, int,
                        int, int, int, int);

// One compiled kernel: its entry, shared bytes, lanes a column, columns a
// block, and the opt-in to its shared memory.
struct Entry {
  Kernel fn;
  size_t smem;
  int P, CB, C, W;
  bool exact;
  cudaError_t (*opt_in)(int device);
};

template <int C, int W, bool EXACT, int VEC>
cudaError_t opt_in(int device) {
  static bool opted[64];          // dynamic shared memory above 48 KB
  if (device < 64 && opted[device]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      wkv_kernel<C, W, EXACT, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Inst<C, W>::SMEM_BYTES);
  if (e == cudaSuccess && device < 64) opted[device] = true;
  return e;
}

template <int C, int W, bool EXACT, int VEC>
Entry entry() {
  using I = Inst<C, W>;
  return {wkv_kernel<C, W, EXACT, VEC>, I::SMEM_BYTES, I::P, I::CB, C, W,
          EXACT, opt_in<C, W, EXACT, VEC>};
}

template <int C, int W>
Entry entry(bool exact, bool vec) {
  return exact ? entry<C, W, true, 4>()
               : vec ? entry<C, W, false, 4>() : entry<C, W, false, 1>();
}

// The instance a supported (hd, chunk) runs: the exact one where both
// equal its widths and the rows go by 16-byte copies, else the padded one.
Entry pick(int hd, int chunk, bool vec) {
  const int C = wkv_chunk(chunk), W = wkv_width(hd);
  const bool exact = vec && hd == W && chunk == C;
  if (C == 16)
    return W == 64 ? entry<16, 64>(exact, vec)
         : W == 128 ? entry<16, 128>(exact, vec)
                    : entry<16, 256>(exact, vec);
  if (C == 32)
    return W == 64 ? entry<32, 64>(exact, vec) : entry<32, 128>(exact, vec);
  return entry<64, 64>(exact, vec);
}

// The launch of one call.  A head of hd > CB columns needs at least
// ceil(hd / CB) blocks.  Above that, n_split blocks share a head's value
// columns only where one block per (b, h) would leave SMs idle: as many
// as the SMs hold heads, at most ceil(hd / 16), so each block keeps at
// least 16 columns against the decays and scores it repeats.  A caller's
// own n_split (a test's) is raised to the floor and rounded to the blocks
// its column tiles need.
struct Plan {
  int n_split, cols, blocks, threads;
};

Plan plan_of(int B, int H, int hd, const Entry& k, int n_split, int sms) {
  if (n_split == 0) {
    const long long heads = (long long)B * H;
    n_split = heads > 0 && heads < sms ? (int)(sms / heads) : 1;
    n_split = n_split < (hd + 15) / 16 ? n_split : (hd + 15) / 16;
  }
  const int floor = (hd + k.CB - 1) / k.CB;
  n_split = n_split > floor ? n_split : floor;
  Plan p;
  p.cols = (hd + n_split - 1) / n_split;
  p.n_split = (hd + p.cols - 1) / p.cols;
  p.blocks = B * H * p.n_split;
  p.threads = (k.P * (hd < k.CB ? hd : k.CB) + 31) / 32 * 32;
  return p;
}

bool args_ok(int B, int H, int hd, int chunk, int n_split) {
  return B >= 0 && H >= 1 && supported(hd, chunk) && n_split >= 0
         && n_split <= hd && (long long)B * H * hd <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// Whether the kernel takes head dim hd at this chunk length.
int wkv_supported(int hd, int chunk) { return supported(hd, chunk); }

// r, k, v, w f32 (B,S,H,hd), u f32 (H,hd) -> o f32 (B,S,H,hd) and, if
// s_fin is not null, the final state f32 (B,H,hd,hd), in chunks of
// `chunk` steps.  n_split 0 is the launcher's choice of blocks per head;
// 1..hd asks for that many (tests), raised to the head's floor.
int wkv_fwd(const void* r, const void* k, const void* v, const void* w,
            const void* u, void* o, void* s_fin, int B, int S, int H, int hd,
            int chunk, int device, void* stream, int n_split) {
  if (!args_ok(B, H, hd, chunk, n_split) || S < 0 || S % chunk)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return 0;
  const bool vec = hd % 4 == 0 && aligned16(r) && aligned16(k)
                   && aligned16(v) && aligned16(w);
  const Entry kern = pick(hd, chunk, vec);
  const Plan p = plan_of(B, H, hd, kern, n_split, sm_count(device));
  e = kern.opt_in(device);
  if (e != cudaSuccess) return (int)e;
  int n_split_ = p.n_split, cols = p.cols;
  void* args[] = {&r, &k, &v, &w, &u, &o, &s_fin, &S, &H, &hd, &chunk,
                  &n_split_, &cols};
  e = cudaLaunchKernel((const void*)kern.fn, dim3(p.blocks),
                       dim3(p.threads), args, kern.smem,
                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What wkv_fwd would launch (rows by 16-byte copies where hd % 4 == 0):
// plan = {n_split, blocks, threads a block, dynamic shared bytes a block,
// blocks an SM holds at once, the instance's chunk length, its head
// width, 1 if exact}.
int wkv_plan(int B, int H, int hd, int chunk, int n_split, int device,
             int* plan) {
  if (!args_ok(B, H, hd, chunk, n_split)) return (int)cudaErrorInvalidValue;
  const Entry kern = pick(hd, chunk, hd % 4 == 0);
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = kern.opt_in(device);
  if (e != cudaSuccess) return (int)e;
  const Plan p = plan_of(B, H, hd, kern, n_split, sm_count(device));
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern.fn, p.threads, kern.smem);
  if (e != cudaSuccess) return (int)e;
  plan[0] = p.n_split;
  plan[1] = p.blocks;
  plan[2] = p.threads;
  plan[3] = (int)kern.smem;
  plan[4] = per_sm;
  plan[5] = kern.C;
  plan[6] = kern.W;
  plan[7] = kern.exact;
  return 0;
}

const char* wkv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
