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
// D is fused (rowsum of dO*O in f32, per panel) or read from a given
// [B,H,Tq] f32 array. As in the TPU kernels, P and dS are rounded to bf16
// before their products and every product accumulates in f32; the
// outputs are written once, in bf16 or f32. A masked entry has P = 0, so
// a row that saw no key (L = 0) gets no gradient.
//
// What bounds it on an H100: operations. At the training shape (B 8,
// T 2048, H 16, KVH 4, D 128, causal) the five products (S and dP in both
// kernels, then dQ, dK, dV) are 10 D B H T(T+1)/2 = 344 GFLOP, 0.348 ms at
// the 989 TFLOP/s bf16 tensor-core peak, against ~100 MB of q/k/v/dO/O/L
// reads and dq/dk/dv writes (0.03 ms at 3.35 TB/s).
//
// What this simple design does about it:
// - every accumulator has exactly one owning CTA, so there are no atomics
//   and two launches give bit-equal results:
//   - dq kernel: one CTA per (q-tile, KV head, batch); the q-tile's
//     `group` query heads form one 64-row panel (64 / group positions x
//     group heads), as in flash_fwd.cu; the key loop runs inside the CTA up
//     to the causal limit; dQ stays in registers (WMMA accumulators);
//   - dkv kernel: one CTA per (64-key tile, KV head, batch); the q loop
//     runs inside the CTA from the first q-tile the causal mask lets
//     through; each warp owns 16 keys, and its products contract over the
//     panel's 64 rows, so the group's sum lands at KV size with no
//     reduction afterwards; dK and dV stay in registers;
// - all products run on the tensor cores (WMMA 16x16x16 bf16 -> f32);
// - S and dP round-trip shared memory only, so no [T,T] tensor touches
//   device memory; ragged tiles are zero-filled and masked in-kernel, so
//   any T works;
// - 114 KB of shared memory per CTA, so two CTAs share an SM.
// It does not yet overlap loads with compute (no cp.async/TMA pipeline, no
// wgmma, no register-resident softmax); that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

// Q, dO, K, V tiles; S, dP in f32; one bf16 [ROWS][LDP] panel; L and D.
constexpr size_t SMEM_BYTES = 4 * (size_t)ROWS * LDH * 2 + 2 * (size_t)ROWS * LDS * 4 +
                              (size_t)ROWS * LDP * 2 + 2 * (size_t)ROWS * 4;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

struct Smem {
  bf16* q;    // [ROWS][LDH] query panel
  bf16* g;    // [ROWS][LDH] dO panel
  bf16* k;    // [BK][LDH]
  bf16* v;    // [BK][LDH]
  float* s;   // [ROWS][LDS] S (then dS in the dkv kernel)
  float* dp;  // [ROWS][LDS] dP
  bf16* p;    // [ROWS][LDP] dS (dq kernel) or P then dS (dkv kernel), bf16
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
                                               const float* __restrict__ dvec, int b, int q0,
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
                    const float* __restrict__ dvec, OutT* __restrict__ dq, int Tq, int Tk,
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
  load_row_stats(sm, L, o, dvec, b, q0, blk_q, kvh, group, Tq, H, r0, lane);
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

template <typename OutT>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ L, const bf16* __restrict__ o,
                     const float* __restrict__ dvec, OutT* __restrict__ dk,
                     OutT* __restrict__ dv, int Tq, int Tk, int H, int KVH, int group,
                     int causal, int q_off, int k_off, int stride, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int blk_q = ROWS / group;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = warp * 16;  // this warp's keys (tile columns)

  load_kv_tile(sm.k, k, b, k0, kvh, Tk, KVH);
  load_kv_tile(sm.v, v, b, k0, kvh, Tk, KVH);

  Acc acc_k[D / 16], acc_v[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(acc_k[n], 0.f);
    wmma::fill_fragment(acc_v[n], 0.f);
  }

  const int k_lo = k_off + stride * k0;  // first key position of the tile
  const int n_qt = (Tq + blk_q - 1) / blk_q;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * blk_q;
    // Skip q-tiles wholly before this key tile: their entries are masked.
    if (causal && q_off + stride * (min(q0 + blk_q, Tq) - 1) < k_lo) continue;
    __syncthreads();  // every warp is done with the previous panels
    load_panel(sm.q, q, b, q0, blk_q, kvh, group, Tq, H);
    load_panel(sm.g, g, b, q0, blk_q, kvh, group, Tq, H);
    __syncthreads();
    load_row_stats(sm, L, o, dvec, b, q0, blk_q, kvh, group, Tq, H, warp * 16, lane);
    __syncthreads();  // every warp reads every row's L and D

    // S and dP: all 64 panel rows x this warp's 16 keys.
#pragma unroll
    for (int m = 0; m < ROWS / 16; ++m) scores_block(sm, m * 16, c0);
    __syncwarp();

    // P (bf16, for dV) and dS (f32, in place of S) at this warp's columns.
    for (int c = lane; c < ROWS * 16; c += 32) {
      const int r = c / 16, j = c0 + c % 16;
      const Entry e = tile_entry(sm, r, j, q0, blk_q, k0, Tq, Tk, causal, q_off, k_off,
                                 stride, scale);
      sm.p[r * LDP + j] = __float2bfloat16(e.p);
      sm.s[r * LDS + j] = e.ds;
    }
    __syncwarp();

    // dV += P^T dO: the product contracts over the panel's rows, which
    // sums the whole group into this KV head.
#pragma unroll
    for (int m = 0; m < ROWS / 16; ++m) {
      ACol a;
      wmma::load_matrix_sync(a, sm.p + (m * 16) * LDP + c0, LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        BRow bg;
        wmma::load_matrix_sync(bg, sm.g + (m * 16) * LDH + n * 16, LDH);
        wmma::mma_sync(acc_v[n], a, bg, acc_v[n]);
      }
    }
    __syncwarp();
    for (int c = lane; c < ROWS * 16; c += 32) {
      const int r = c / 16, j = c0 + c % 16;
      sm.p[r * LDP + j] = __float2bfloat16(sm.s[r * LDS + j]);
    }
    __syncwarp();

    // dK += dS^T Q (scaled at the end).
#pragma unroll
    for (int m = 0; m < ROWS / 16; ++m) {
      ACol a;
      wmma::load_matrix_sync(a, sm.p + (m * 16) * LDP + c0, LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        BRow bq;
        wmma::load_matrix_sync(bq, sm.q + (m * 16) * LDH + n * 16, LDH);
        wmma::mma_sync(acc_k[n], a, bq, acc_k[n]);
      }
    }
  }
  __syncthreads();  // the staging rows below overlap other warps' columns

  auto kv_row = [&](int rr) -> long long {
    const int t = k0 + c0 + rr;
    if (t >= Tk) return -1;
    return (((long long)b * Tk + t) * KVH + kvh) * D;
  };
  float* stage = sm.s + c0 * LDS;
  emit_rows(acc_k, stage, dk, kv_row, scale, lane);
  emit_rows(acc_v, stage, dv, kv_row, 1.f, lane);
}

template <auto kernel>
cudaError_t prepare() {
  return set_smem_once<kernel>(SMEM_BYTES, true);
}

bool shape_ok(int B, int Tq, int Tk, int H, int KVH, int head_dim, int stride) {
  return head_dim == D && B > 0 && Tq > 0 && Tk > 0 && KVH > 0 && H % KVH == 0 &&
         ROWS % (H / KVH) == 0 && stride > 0;
}

}  // namespace

// C entry points (bound with ctypes). `o` non-null fuses D = rowsum(dO*O);
// otherwise `dvec` ([B,H,Tq] f32) is D. `out_f32` picks the gradient dtype
// (f32, else bf16). Each launches on `stream` and returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* g,
                                 const void* L, const void* o, const void* dvec, void* dq,
                                 int B, int Tq, int Tk, int H, int KVH, int head_dim,
                                 int causal, int q_off, int k_off, int stride, float scale,
                                 int out_f32, void* stream) {
  if (!shape_ok(B, Tq, Tk, H, KVH, head_dim, stride) || (o == nullptr && dvec == nullptr))
    return (int)cudaErrorInvalidValue;
  const int group = H / KVH;
  const int blk_q = ROWS / group;
  dim3 grid((Tq + blk_q - 1) / blk_q, KVH, B);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (out_f32) {
    err = prepare<flash_bwd_dq_kernel<float>>();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_kernel<float><<<grid, NT, SMEM_BYTES, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)L,
        (const bf16*)o, (const float*)dvec, (float*)dq, Tq, Tk, H, KVH, group, causal, q_off,
        k_off, stride, scale);
  } else {
    err = prepare<flash_bwd_dq_kernel<bf16>>();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_kernel<bf16><<<grid, NT, SMEM_BYTES, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)L,
        (const bf16*)o, (const float*)dvec, (bf16*)dq, Tq, Tk, H, KVH, group, causal, q_off,
        k_off, stride, scale);
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* g,
                                  const void* L, const void* o, const void* dvec, void* dk,
                                  void* dv, int B, int Tq, int Tk, int H, int KVH,
                                  int head_dim, int causal, int q_off, int k_off, int stride,
                                  float scale, int out_f32, void* stream) {
  if (!shape_ok(B, Tq, Tk, H, KVH, head_dim, stride) || (o == nullptr && dvec == nullptr))
    return (int)cudaErrorInvalidValue;
  const int group = H / KVH;
  dim3 grid((Tk + BK - 1) / BK, KVH, B);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (out_f32) {
    err = prepare<flash_bwd_dkv_kernel<float>>();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_kernel<float><<<grid, NT, SMEM_BYTES, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)L,
        (const bf16*)o, (const float*)dvec, (float*)dk, (float*)dv, Tq, Tk, H, KVH, group,
        causal, q_off, k_off, stride, scale);
  } else {
    err = prepare<flash_bwd_dkv_kernel<bf16>>();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_kernel<bf16><<<grid, NT, SMEM_BYTES, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)L,
        (const bf16*)o, (const float*)dvec, (bf16*)dk, (bf16*)dv, Tq, Tk, H, KVH, group,
        causal, q_off, k_off, stride, scale);
  }
  return (int)cudaGetLastError();
}
