// Flash-attention backward for Hopper (sm_90a): bf16 in, f32 accumulation.
//
// Replaces: tpu_operator/payload/flash_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (both launched by `_bwd_pallas`), the TPU kernels
// behind `attention_block_grads` and the custom VJP of `flash_attention`.
// Training runs both once per layer per microbatch.
//
// What it computes, for q/dO/O [B,Tq,H,D], k/v [B,Tk,KVH,D] bf16 and the
// forward's row logsumexp L [B,H,Tq] f32 (query head h reads K/V head
// h / group, group = H / KVH; query slot i sits at global position
// q_off + stride*i, key slot j at k_off + stride*j):
//   S  = scale Q K^T (causal: masked where q_pos < k_pos)
//   P  = exp(S - L);  dP = dO V^T;  dS = P (dP - D),  D = rowsum(dO O)
//   dQ = scale dS K;  dK = scale dS^T Q;  dV = P^T dO
// D is fused (the dq kernel computes rowsum(dO*O) in f32 per panel and
// writes it to a [B,H,Tq] f32 buffer) or read from a given [B,H,Tq] f32
// array; the dkv kernel always reads a given D, launched after dq on the
// same stream. As in the TPU kernels, P and dS are rounded to bf16 before
// their products and every product accumulates in f32; the outputs are
// written once, in bf16 or f32. A masked entry has P = 0, so a row that
// saw no key (L = 0) gets no gradient.
//
// What bounds it on an H100: operations. At the training shape (B 8,
// T 2048, H 16, KVH 4, D 128, causal) the five products (S and dP in both
// kernels, then dQ, dK, dV) are 10 D B H T(T+1)/2 = 344 GFLOP, 0.348 ms at
// the 989 TFLOP/s bf16 tensor-core peak (dkv's four: 0.278 ms), against
// ~100 MB of q/k/v/dO/O/L reads and dq/dk/dv writes (0.03 ms at 3.35 TB/s).
//
// Every accumulator has exactly one owning CTA, so there are no atomics
// and two launches give bit-equal results.
// - dq kernel (the first port's design, to be redesigned next): one CTA per
//   (q-tile, KV head, batch); the q-tile's `group` query heads form one
//   64-row panel (64 / group positions x group heads, head-major); the key
//   loop runs inside the CTA up to the causal limit; WMMA 16x16x16
//   products, S and dP round-trip shared memory, dQ stays in registers.
// - dkv kernel (Hopper): one CTA per (64-key tile, KV head, batch), one
//   warpgroup, two CTAs per SM. K and V stay resident in shared memory;
//   the Q and dO panels (64 rows, slot-major: row = slot * group + head)
//   with their L and D rows stream through a 2-stage cp.async ring in
//   wgmma's 128-byte-swizzled layout, starting at the first q-tile the
//   causal mask lets through, so panel i + 1 is in flight while panel i is
//   multiplied. It works transposed, as FlashAttention-3 does: S^T = K Q^T
//   and dP^T = V dO^T with wgmma from shared memory; P^T = exp2(S^T scale
//   log2e - L log2e) and dS^T = P^T (dP^T - D) in registers, each packed to
//   bf16; dV += P^T dO and dK += dS^T Q with the scores as register
//   operands. No score touches shared memory; the contraction over the
//   panel's rows sums the group into the KV head; dK and dV (64 x 128 f32
//   each) stay in registers. The mask runs only on panels that straddle
//   the diagonal or a ragged end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"
#include "smem_once.cuh"

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;       // head dim (the wrapper checks it)
constexpr int ROWS = 64;     // flattened group x q-slot panel rows
constexpr int BK = 64;       // keys per tile
constexpr int NT = 128;      // 4 warps
constexpr int CH = D / 8;    // 16-byte chunks per row
constexpr int LDH = D + 8;   // bf16 pitch of the Q/dO/K/V tiles
constexpr int LDS = BK + 4;  // f32 pitch of S and dP
constexpr int LDP = BK + 8;  // bf16 pitch of P and dS

// dq: Q, dO, K, V tiles; S, dP in f32; one bf16 [ROWS][LDP] panel; L and D.
constexpr size_t SMEM_BYTES = 4 * (size_t)ROWS * LDH * 2 + 2 * (size_t)ROWS * LDS * 4 +
                              (size_t)ROWS * LDP * 2 + 2 * (size_t)ROWS * 4;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

struct Smem {
  bf16* q;    // [ROWS][LDH] query panel
  bf16* g;    // [ROWS][LDH] dO panel
  bf16* k;    // [BK][LDH]
  bf16* v;    // [BK][LDH]
  float* s;   // [ROWS][LDS] S
  float* dp;  // [ROWS][LDS] dP
  bf16* p;    // [ROWS][LDP] dS, bf16
  float* L;   // [ROWS]
  float* Dr;  // [ROWS]
};

__device__ __forceinline__ Smem carve(unsigned char* base) {
  Smem m;
  m.q = reinterpret_cast<bf16*>(base);
  m.g = m.q + ROWS * LDH;
  m.k = m.g + ROWS * LDH;
  m.v = m.k + BK * LDH;
  m.s = reinterpret_cast<float*>(m.v + BK * LDH);
  m.dp = m.s + ROWS * LDS;
  m.p = reinterpret_cast<bf16*>(m.dp + ROWS * LDS);
  m.L = reinterpret_cast<float*>(m.p + ROWS * LDP);
  m.Dr = m.L + ROWS;
  return m;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(bf16* p, float x) { *p = __float2bfloat16(x); }

// Panel row r of a q-tile: query slot q0 + r % blk_q of head kvh*group + r / blk_q.
__device__ __forceinline__ void load_panel(bf16* dst, const bf16* __restrict__ src, int b,
                                           int q0, int blk_q, int kvh, int group, int T,
                                           int H) {
  for (int c = threadIdx.x; c < ROWS * CH; c += NT) {
    const int r = c / CH, ch = c % CH;
    const int t = q0 + r % blk_q;
    const int h = kvh * group + r / blk_q;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < T) val = *reinterpret_cast<const uint4*>(src + (((size_t)b * T + t) * H + h) * D + ch * 8);
    *reinterpret_cast<uint4*>(dst + r * LDH + ch * 8) = val;
  }
}

__device__ __forceinline__ void load_kv_tile(bf16* dst, const bf16* __restrict__ src, int b,
                                             int k0, int kvh, int T, int KVH) {
  for (int c = threadIdx.x; c < BK * CH; c += NT) {
    const int j = c / CH, ch = c % CH;
    const int t = k0 + j;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < T) val = *reinterpret_cast<const uint4*>(src + (((size_t)b * T + t) * KVH + kvh) * D + ch * 8);
    *reinterpret_cast<uint4*>(dst + j * LDH + ch * 8) = val;
  }
}

// L and D of this warp's 16 panel rows (0 for rows past Tq). Fused D is
// the f32 rowsum of dO*O, dO from the shared panel, O from device memory.
__device__ __forceinline__ void load_row_stats(const Smem& sm, const float* __restrict__ L,
                                               const bf16* __restrict__ o,
                                               const float* __restrict__ dvec,
                                               float* __restrict__ d_out, int b, int q0,
                                               int blk_q, int kvh, int group, int T, int H,
                                               int r0, int lane) {
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const int t = q0 + r % blk_q;
    const int h = kvh * group + r / blk_q;
    float l_row = 0.f, d_row = 0.f;
    if (t < T) {
      const size_t row = ((size_t)b * H + h) * T + t;
      l_row = L[row];
      if (o != nullptr) {
        const bf16* orow = o + (((size_t)b * T + t) * H + h) * D + lane * 4;
        const bf16* grow = sm.g + r * LDH + lane * 4;
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc += __bfloat162float(grow[e]) * __bfloat162float(orow[e]);
        d_row = warp_sum(acc);
        if (lane == 0) d_out[row] = d_row;  // this warp is the row's only writer
      } else {
        d_row = dvec[row];
      }
    }
    if (lane == 0) {
      sm.L[r] = l_row;
      sm.Dr[r] = d_row;
    }
  }
}

// S = Q K^T and dP = dO V^T for a 16 x 16 block: rows a_row0.. of the
// panels, keys k_row0.. of the tiles. Stored to sm.s / sm.dp at (a_row0, col).
__device__ __forceinline__ void scores_block(const Smem& sm, int a_row0, int k_row0) {
  Acc acc_s, acc_p;
  wmma::fill_fragment(acc_s, 0.f);
  wmma::fill_fragment(acc_p, 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ARow a;
    BCol bt;
    wmma::load_matrix_sync(a, sm.q + a_row0 * LDH + kk * 16, LDH);
    wmma::load_matrix_sync(bt, sm.k + k_row0 * LDH + kk * 16, LDH);
    wmma::mma_sync(acc_s, a, bt, acc_s);
    wmma::load_matrix_sync(a, sm.g + a_row0 * LDH + kk * 16, LDH);
    wmma::load_matrix_sync(bt, sm.v + k_row0 * LDH + kk * 16, LDH);
    wmma::mma_sync(acc_p, a, bt, acc_p);
  }
  wmma::store_matrix_sync(sm.s + a_row0 * LDS + k_row0, acc_s, LDS, wmma::mem_row_major);
  wmma::store_matrix_sync(sm.dp + a_row0 * LDS + k_row0, acc_p, LDS, wmma::mem_row_major);
}

// P and dS of panel row r, key column j (key slot k0 + j).
struct Entry {
  float p, ds;
};

__device__ __forceinline__ Entry tile_entry(const Smem& sm, int r, int j, int q0, int blk_q,
                                            int k0, int Tq, int Tk, int causal, int q_off,
                                            int k_off, int stride, float scale) {
  const int t = q0 + r % blk_q;
  const int kt = k0 + j;
  bool valid = t < Tq && kt < Tk;
  if (causal) valid = valid && q_off + stride * t >= k_off + stride * kt;
  Entry e;
  e.p = valid ? expf(sm.s[r * LDS + j] * scale - sm.L[r]) : 0.f;
  e.ds = e.p * (sm.dp[r * LDS + j] - sm.Dr[r]);
  return e;
}

// Write a warp's 16 rows x 128 f32 accumulators (8 fragments) to rows of
// an output, through a 16 x LDS f32 staging area, 64 columns at a time.
// `out_row(rr)` is the element offset of row rr, or -1 to skip it.
template <typename OutT, typename RowFn>
__device__ __forceinline__ void emit_rows(Acc (&acc)[D / 16], float* stage, OutT* __restrict__ out,
                                          RowFn out_row, float mul, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(stage + n * 16, acc[half * 4 + n], LDS, wmma::mem_row_major);
    __syncwarp();
    for (int c = lane; c < 16 * 64; c += 32) {
      const int rr = c / 64, col = c % 64;
      const long long off = out_row(rr);
      if (off >= 0) store_out(out + off + half * 64 + col, stage[rr * LDS + col] * mul);
    }
    __syncwarp();
  }
}

template <typename OutT>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ L, const bf16* __restrict__ o,
                    const float* __restrict__ dvec, float* __restrict__ d_out,
                    OutT* __restrict__ dq, int Tq, int Tk,
                    int H, int KVH, int group, int causal, int q_off, int k_off, int stride,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int blk_q = ROWS / group;
  const int q0 = blockIdx.x * blk_q;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = warp * 16;  // this warp's panel rows

  load_panel(sm.q, q, b, q0, blk_q, kvh, group, Tq, H);
  load_panel(sm.g, g, b, q0, blk_q, kvh, group, Tq, H);
  __syncthreads();
  load_row_stats(sm, L, o, dvec, d_out, b, q0, blk_q, kvh, group, Tq, H, r0, lane);
  __syncwarp();

  Acc acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  const int q_hi = q_off + stride * (min(q0 + blk_q, Tq) - 1);  // last position in the panel
  const int n_tiles = (Tk + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    if (causal && k_off + stride * k0 > q_hi) break;  // this and later tiles are masked
    __syncthreads();  // every warp is done with the previous K/V tile
    load_kv_tile(sm.k, k, b, k0, kvh, Tk, KVH);
    load_kv_tile(sm.v, v, b, k0, kvh, Tk, KVH);
    __syncthreads();

#pragma unroll
    for (int n = 0; n < BK / 16; ++n) scores_block(sm, r0, n * 16);
    __syncwarp();

    // dS for this warp's rows, 2 keys per lane, rounded to bf16.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        const Entry e = tile_entry(sm, r, j, q0, blk_q, k0, Tq, Tk, causal, q_off, k_off,
                                   stride, scale);
        sm.p[r * LDP + j] = __float2bfloat16(e.ds);
      }
    }
    __syncwarp();

    // dQ += dS K for this warp's rows.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      ARow a;
      wmma::load_matrix_sync(a, sm.p + r0 * LDP + kk * 16, LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        BRow bk;
        wmma::load_matrix_sync(bk, sm.k + (kk * 16) * LDH + n * 16, LDH);
        wmma::mma_sync(acc[n], a, bk, acc[n]);
      }
    }
  }
  __syncwarp();

  // Emit dQ = scale * acc through this warp's rows of the S panel.
  auto dq_row = [&](int rr) -> long long {
    const int r = r0 + rr;
    const int t = q0 + r % blk_q;
    if (t >= Tq) return -1;
    const int h = kvh * group + r / blk_q;
    return (((long long)b * Tq + t) * H + h) * D;
  };
  emit_rows(acc, sm.s + r0 * LDS, dq, dq_row, scale, lane);
}

// --- dkv: Hopper kernel (wgmma, cp.async ring, scores in registers) ---------

constexpr int DKV_NT = 128;  // one warpgroup: 64 keys
static_assert(DKV_NT == 2 * ROWS, "one thread per L and D row of a panel");
constexpr int PANEL_ELEMS = ROWS * D;
constexpr int KEY_ELEMS = BK * D;
constexpr float LOG2E = 1.4426950408889634f;
// K, V, then two stages of (Q panel, dO panel), then two stages of the
// panel's L and D rows; 1024 bytes of slack to align the base.
constexpr size_t DKV_SMEM_BYTES =
    1024 + 2 * (2 * (size_t)KEY_ELEMS + 4 * (size_t)PANEL_ELEMS) + 2 * 2 * ROWS * 4;

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// One CTA per (64-key tile, KV head, batch), one warpgroup; thread rows
// are keys. Works transposed: S^T = K Q^T and dP^T = V dO^T (K-major
// operands in shared memory), P^T and dS^T in registers, then dV += P^T dO
// and dK += dS^T Q with P^T / dS^T as register operands and the panels
// MN-major. The contraction over the panel's rows sums the GQA group.
template <typename OutT>
__global__ void __launch_bounds__(DKV_NT, 2)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ L, const float* __restrict__ dvec,
                     OutT* __restrict__ dk, OutT* __restrict__ dv, int Tq, int Tk, int H,
                     int KVH, int group, int causal, int q_off, int k_off, int stride,
                     float scale) {
  extern __shared__ unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* sV = sK + KEY_ELEMS;
  bf16* sPanel = sV + KEY_ELEMS;  // stage s: Q at sPanel + 2 s PANEL_ELEMS, dO after it
  float* sStats = reinterpret_cast<float*>(sPanel + 4 * PANEL_ELEMS);  // stage s: L, D

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int blk_q = ROWS / group;
  const int k0 = blockIdx.x * BK;  // key tile 0, which sees every q-tile, first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;

  auto key_row = [&](const bf16* base) {
    return [=](int j) -> const bf16* {
      const int t = k0 + j;
      return t < Tk ? base + (((size_t)b * Tk + t) * KVH + kvh) * D : nullptr;
    };
  };
  load_tile<BK, DKV_NT>(sK, tid, key_row(k), k);
  load_tile<BK, DKV_NT>(sV, tid, key_row(v), v);

  // Panel row r of q-tile qt: query slot qt * blk_q + r / group of head
  // kvh * group + r % group.
  auto load_panel = [&](int qt, int st) {
    const int q0 = qt * blk_q;
    auto row = [&](const bf16* base) {
      return [=](int r) -> const bf16* {
        const int t = q0 + r / group;
        return t < Tq ? base + (((size_t)b * Tq + t) * H + kvh * group + r % group) * D
                      : nullptr;
      };
    };
    bf16* dst = sPanel + 2 * st * PANEL_ELEMS;
    load_tile<ROWS, DKV_NT>(dst, tid, row(q), q);
    load_tile<ROWS, DKV_NT>(dst + PANEL_ELEMS, tid, row(g), g);
    // Thread i < 64 copies row i's L, thread 64 + i its D.
    const int r = tid % ROWS;
    const int t = q0 + r / group;
    const size_t idx = ((size_t)b * H + kvh * group + r % group) * Tq + t;
    const float* src = tid < ROWS ? L : dvec;
    cp_async_4(sStats + 2 * st * ROWS + tid, t < Tq ? src + idx : src, t < Tq);
  };

  // Skip q-tiles wholly before this key tile: their entries are masked.
  const int n_qt = (Tq + blk_q - 1) / blk_q;
  const int k_lo = k_off + stride * k0;
  int qt0 = 0;
  if (causal)
    while (qt0 < n_qt && q_off + stride * (min((qt0 + 1) * blk_q, Tq) - 1) < k_lo) ++qt0;
  if (qt0 < n_qt) load_panel(qt0, 0);
  cp_async_commit();

  // This thread's keys: accumulator rows l/4 and l/4 + 8 of its warp's 16.
  const int kpos_a = k0 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int kpos_b = kpos_a + 8;
  const int k_last = k_off + stride * (min(k0 + BK, Tk) - 1);
  const float c = scale * LOG2E;

  float acc_k[64], acc_v[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < n_qt) load_panel(qt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // panel qt (and K, V) landed for this thread's copies
    fence_proxy_async();
    __syncthreads();     // ... and for every thread's
    const bf16* sQ = sPanel + 2 * st * PANEL_ELEMS;
    const bf16* sG = sQ + PANEL_ELEMS;
    const float* sL = sStats + 2 * st * ROWS;
    const float* sD = sL + ROWS;
    const int q0 = qt * blk_q;

    float s[32], dp[32];
    wgmma_fence();
    gemm_nt_64x64x128(s, sK, BK, sQ, ROWS);
    gemm_nt_64x64x128(dp, sV, BK, sG, ROWS);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp2(S^T scale log2e - L log2e), dS^T = P^T (dP^T - D), in place.
    const bool masked = q0 + blk_q > Tq || k0 + BK > Tk ||
                        (causal && q_off + stride * q0 < k_last);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * i + 2 * (lane & 3) + e;  // panel row (column of S^T)
        const float l2 = sL[r] * LOG2E, dr = sD[r];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * i + 2 * h + e;
          float p = exp2f(fmaf(s[x], c, -l2));
          if (masked) {
            const int t = q0 + r / group;
            const int kpos = h ? kpos_b : kpos_a;
            bool valid = t < Tq && kpos < Tk;
            if (causal) valid = valid && q_off + stride * t >= k_off + stride * kpos;
            p = valid ? p : 0.f;
          }
          s[x] = p;
          dp[x] = p * (dp[x] - dr);
        }
      }
    uint32_t pp[16], pd[16];
    pack_scores(pp, s);
    pack_scores(pd, dp);

    wgmma_fence();
    gemm_rs_64x128x64(acc_v, pp, sG, ROWS);
    gemm_rs_64x128x64(acc_k, pd, sQ, ROWS);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    __syncthreads();  // every warp is done with stage st
  }

  const int col0 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = h ? kpos_b : kpos_a;
    if (t >= Tk) continue;
    const size_t row = (((size_t)b * Tk + t) * KVH + kvh) * D;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int x = 4 * i + 2 * h;
      store2(dk + row + 8 * i + col0, acc_k[x] * scale, acc_k[x + 1] * scale);
      store2(dv + row + 8 * i + col0, acc_v[x], acc_v[x + 1]);
    }
  }
}

template <auto kernel>
cudaError_t prepare(size_t smem_bytes) {
  return set_smem_once<kernel>(smem_bytes, true);
}

bool shape_ok(int B, int Tq, int Tk, int H, int KVH, int head_dim, int stride) {
  return head_dim == D && B > 0 && Tq > 0 && Tk > 0 && KVH > 0 && H % KVH == 0 &&
         ROWS % (H / KVH) == 0 && stride > 0;
}

template <typename OutT>
cudaError_t launch_dq(dim3 grid, cudaStream_t s, const void* q, const void* k, const void* v,
                      const void* g, const void* L, const void* o, const void* dvec,
                      void* d_out, void* dq, int Tq, int Tk, int H, int KVH, int causal,
                      int q_off, int k_off, int stride, float scale) {
  cudaError_t err = prepare<flash_bwd_dq_kernel<OutT>>(SMEM_BYTES);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<OutT><<<grid, NT, SMEM_BYTES, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)L,
      (const bf16*)o, (const float*)dvec, (float*)d_out, (OutT*)dq, Tq, Tk, H, KVH, H / KVH,
      causal, q_off, k_off, stride, scale);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_dkv(dim3 grid, cudaStream_t s, const void* q, const void* k, const void* v,
                       const void* g, const void* L, const void* dvec, void* dk, void* dv,
                       int Tq, int Tk, int H, int KVH, int causal, int q_off, int k_off,
                       int stride, float scale) {
  cudaError_t err = prepare<flash_bwd_dkv_kernel<OutT>>(DKV_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<OutT><<<grid, DKV_NT, DKV_SMEM_BYTES, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)L,
      (const float*)dvec, (OutT*)dk, (OutT*)dv, Tq, Tk, H, KVH, H / KVH, causal, q_off, k_off,
      stride, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes). dq: `o` non-null fuses D =
// rowsum(dO*O) and writes it to `d_out` ([B,H,Tq] f32) for dkv; otherwise
// `dvec` ([B,H,Tq] f32) is D. dkv always reads D from `dvec`. `out_f32`
// picks the gradient dtype (f32, else bf16). Each launches on `stream` and
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* g,
                                 const void* L, const void* o, const void* dvec, void* d_out,
                                 void* dq, int B, int Tq, int Tk, int H, int KVH,
                                 int head_dim, int causal, int q_off, int k_off, int stride,
                                 float scale, int out_f32, void* stream) {
  if (!shape_ok(B, Tq, Tk, H, KVH, head_dim, stride) ||
      (o == nullptr ? dvec == nullptr : d_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blk_q = ROWS / (H / KVH);
  dim3 grid((Tq + blk_q - 1) / blk_q, KVH, B);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(out_f32 ? launch_dq<float>(grid, s, q, k, v, g, L, o, dvec, d_out, dq, Tq, Tk,
                                          H, KVH, causal, q_off, k_off, stride, scale)
                       : launch_dq<bf16>(grid, s, q, k, v, g, L, o, dvec, d_out, dq, Tq, Tk,
                                         H, KVH, causal, q_off, k_off, stride, scale));
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* g,
                                  const void* L, const void* dvec, void* dk, void* dv, int B,
                                  int Tq, int Tk, int H, int KVH, int head_dim, int causal,
                                  int q_off, int k_off, int stride, float scale, int out_f32,
                                  void* stream) {
  if (!shape_ok(B, Tq, Tk, H, KVH, head_dim, stride) || dvec == nullptr)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Tk + BK - 1) / BK, KVH, B);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(out_f32 ? launch_dkv<float>(grid, s, q, k, v, g, L, dvec, dk, dv, Tq, Tk, H,
                                           KVH, causal, q_off, k_off, stride, scale)
                       : launch_dkv<bf16>(grid, s, q, k, v, g, L, dvec, dk, dv, Tq, Tk, H,
                                          KVH, causal, q_off, k_off, stride, scale));
}
