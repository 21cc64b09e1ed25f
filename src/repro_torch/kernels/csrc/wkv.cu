// RWKV-6 chunked WKV recurrence for Hopper (sm_90a), f32.
//
// Replaces: src/repro/kernels/wkv.py:32 `_wkv_kernel` (entry `wkv_chunked`,
// :73), the Pallas TPU kernel of the chunked form of
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//   o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t,
// which is exactly `models/layers.py:852 _wkv_chunk_scan`, the oracle the
// reference's model calls.  Per chunk of C = 16 steps, with the oracle's
// clamps:
//   e_t = exp(cumsum_t log max(w, 1e-8)),  e_excl = e / max(w, 1e-8),
//   o   = (r e_excl) S + strict_lower((r e_excl)(k / max(e, 1e-30))^T) v
//         + (r . (u k)) v,
//   S   = e_C^T * S + ((k / max(e, 1e-30)) * e_C)^T v.
// The factored form is kept term by term (the products and quotients are
// rounded where the oracle rounds them): at the decay clip w >= 0.1923
// e_t falls to 3.5e-12 within a chunk and k / e grows to 3e11 |k|, so a
// rearranged form would round differently.  Logs and exps are logf and
// expf (no fast-math intrinsics) and the cumulative sum runs in order.
//
// Design.  The Pallas kernel runs one program per batch * head, stages the
// whole (S, hd) sequence in VMEM and walks the chunks with a fori_loop
// carrying the (hd, hd) state.  Here one thread block per (b, h) walks the
// chunks the same way, but stages only one chunk at a time: the state
// (hd x hd f32, 16 KB at hd 64) lives in shared memory for the whole
// sequence and each chunk's r, k, v, w rows (16 x hd f32 each) are loaded
// into shared memory in the (B, S, H, hd) layout of the caller, so the
// (B*H, S, hd) transpose of the Pallas wrapper is never made.  4 * hd
// threads: thread (row tr, column e) owns output rows t = tr + 4i of
// column e and state rows d = tr + 4i of column e.  Per chunk:
//   A. stage the chunk (coalesced rows of hd floats);
//   B. one thread per column d computes the decays in order over the 16
//      steps and writes r e_excl, k / e and u k;
//   C. the inter-chunk term into registers, and the 16 x 16 scores (the
//      diagonal holds the bonus r . (u k)) into shared memory;
//   D. the intra-chunk product and the bonus finish o, which is written;
//      then each thread updates its state entries in place.
// Tile rows are padded to 65 floats so column reads hit distinct banks.
//
// What bounds it on the H100.  Per (b, h) and chunk it does about
// 4 C hd^2 + 2 C^2 hd flops (0.29 MFLOP at hd 64) on 5 C hd floats it
// must read or write (r, k, v, w in, o out): 14 flops a byte, under the
// f32 FMA machine balance (67 TFLOP/s / 3.35 TB/s = 20), so the roofline
// bound is device-memory bandwidth.  This first kernel is far from it: it
// is plain f32 FMA fed from shared memory, the decay pass runs on hd of the
// 4 hd threads, no chunk's loads overlap the previous chunk's work, and at
// batch 1 the 32 heads of rwkv6-1.6b fill 32 of the card's 132 SMs.
// Tensor cores, several blocks per head and a pipelined staging ring are
// later work.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() (0 on success).  Inputs contiguous f32, hd <= 64,
// S a multiple of 16 (the wrapper checks); s_fin may be null.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int C = 16;               // chunk length (the reference's CHUNK)
constexpr int MAX_HD = 64;
constexpr int LD = MAX_HD + 1;      // tile row stride: column reads conflict-free
constexpr int ROWS = C / 4;         // chunk rows per thread

__global__ void __launch_bounds__(4 * MAX_HD)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ o,
           float* __restrict__ s_fin, int S, int H, int hd) {
  __shared__ float st[MAX_HD * MAX_HD];     // state, row d, column e
  __shared__ float rs[C * LD], ks[C * LD], vs[C * LD];
  __shared__ float uk[C * LD];              // w, then u * k
  __shared__ float re[C * LD];              // r * e_excl
  __shared__ float kk[C * LD];              // k / max(e, 1e-30)
  __shared__ float sc[C * C];               // scores; bonus on the diagonal
  __shared__ float ec[MAX_HD];              // e at the chunk's last step

  const int bh = blockIdx.x;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int e = tid % hd;
  const int tr = tid / hd;
  const size_t step = (size_t)H * hd;       // one time step of (B,S,H,hd)
  const size_t base = (size_t)(bh / H) * S * step + (size_t)h * hd;

  for (int d = tr; d < hd; d += 4) st[d * hd + e] = 0.f;

  for (int c = 0; c < S / C; ++c) {
    const size_t off = base + (size_t)c * C * step;
    // A. stage the chunk
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int t = tr + 4 * i;
      const size_t g = off + (size_t)t * step + e;
      rs[t * LD + e] = r[g];
      ks[t * LD + e] = k[g];
      vs[t * LD + e] = v[g];
      uk[t * LD + e] = w[g];
    }
    __syncthreads();

    // B. decays, one column per thread, in order over the chunk
    if (tid < hd) {
      const int d = tid;
      const float ud = u[h * hd + d];
      float cum = 0.f, ed = 1.f;
      for (int t = 0; t < C; ++t) {
        const float wt = fmaxf(uk[t * LD + d], 1e-8f);
        cum += logf(wt);
        ed = expf(cum);
        const float kt = ks[t * LD + d];
        re[t * LD + d] = rs[t * LD + d] * (ed / wt);
        kk[t * LD + d] = kt / fmaxf(ed, 1e-30f);
        uk[t * LD + d] = ud * kt;
      }
      ec[d] = ed;
    }
    __syncthreads();

    // C. inter-chunk term (registers) and the scores (shared memory)
    float acc[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) acc[i] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float s = st[d * hd + e];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        acc[i] = fmaf(re[(tr + 4 * i) * LD + d], s, acc[i]);
    }
    for (int idx = tid; idx < C * C; idx += 4 * hd) {
      const int t = idx / C, j = idx % C;
      float a = 0.f;
      if (j < t) {
        for (int d = 0; d < hd; ++d)
          a = fmaf(re[t * LD + d], kk[j * LD + d], a);
      } else if (j == t) {
        for (int d = 0; d < hd; ++d)
          a = fmaf(rs[t * LD + d], uk[t * LD + d], a);
      }
      sc[idx] = a;
    }
    __syncthreads();

    // D. finish and write o; then the state update
    float vr[C];
#pragma unroll
    for (int j = 0; j < C; ++j) vr[j] = vs[j * LD + e];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int t = tr + 4 * i;
      float intra = 0.f, bonus = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (j < t) intra = fmaf(sc[t * C + j], vr[j], intra);
        if (j == t) bonus = sc[t * C + j] * vr[j];
      }
      o[off + (size_t)t * step + e] = (acc[i] + intra) + bonus;
    }
    for (int d = tr; d < hd; d += 4) {
      const float ecd = ec[d];
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) a = fmaf(kk[j * LD + d] * ecd, vr[j], a);
      st[d * hd + e] = ecd * st[d * hd + e] + a;
    }
    __syncthreads();
  }

  if (s_fin != nullptr) {
    float* out = s_fin + (size_t)bh * hd * hd;
    for (int d = tr; d < hd; d += 4) out[d * hd + e] = st[d * hd + e];
  }
}

}  // namespace

extern "C" {

// r, k, v, w f32 (B,S,H,hd), u f32 (H,hd) -> o f32 (B,S,H,hd) and, if
// s_fin is not null, the final state f32 (B,H,hd,hd)
int wkv_fwd(const void* r, const void* k, const void* v, const void* w,
            const void* u, void* o, void* s_fin, int B, int S, int H, int hd,
            int device, void* stream) {
  if (B < 0 || S < 0 || S % C || H < 1 || hd < 1 || hd > MAX_HD
      || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return 0;
  wkv_kernel<<<B * H, 4 * hd, 0, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (float*)o, (float*)s_fin, S, H, hd);
  return (int)cudaGetLastError();
}

const char* wkv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
