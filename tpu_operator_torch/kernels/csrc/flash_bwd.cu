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
// the 989 TFLOP/s bf16 tensor-core peak (dq's three: 0.209 ms; dkv's four:
// 0.278 ms), against ~100 MB of q/k/v/dO/O/L reads and dq/dk/dv writes
// (0.03 ms at 3.35 TB/s).
//
// The head dim D is a template parameter of both kernels, built for 64
// and 128 (the entry points pick by `head_dim`; the wrapper zero-pads any
// other D <= 128 to the next of them). At D 64 every tile is one 64-column
// half of the swizzle, S and dP take 4 k16 steps instead of 8, and dQ, dK
// and dV are 64 columns (32 accumulator registers a thread each). Above
// 128, at any multiple of dq's 256-column block, the wide kernels below
// run instead.
//
// Every accumulator has exactly one owning CTA, so there are no atomics
// and two launches give bit-equal results. Both kernels are one warpgroup
// on hopper.cuh (wgmma from 128-byte-swizzled shared-memory tiles filled
// by cp.async, scores in registers), two CTAs per SM, and they are each
// other's transpose:
// - dq kernel: one CTA per (64-row panel, KV head, batch), heaviest causal
//   panels first. The panel is slot-major (row = slot * group + head), so
//   the causal position, the L/D row and the epilogue's (t, h) all divide
//   by the group. Q and dO stay resident; K/V tiles of 64 keys stream
//   through a 2-stage cp.async ring, so tile j + 1 is in flight while tile
//   j is multiplied, up to the causal limit. S = Q K^T and dP = dO V^T run
//   on wgmma from shared memory; P = exp2(S scale log2e - L log2e) and
//   dS = P (dP - D) in registers, dS packed to bf16 in place; dQ += dS K
//   with dS as the register A operand and K MN-major. The 64 x 128 f32 dQ
//   stays in registers and is written once, times the scale. The fused D
//   (rowsum(dO O) in f32, two threads per row from the resident dO and O
//   read once) is written to `d_out` by the row's single owner, for dkv.
// - dkv kernel: one CTA per (64-key tile, KV head, batch). K and V stay
//   resident; the Q and dO panels with their L and D rows stream through
//   the same kind of ring, starting at the first q-tile the causal mask
//   lets through. It works transposed, as FlashAttention-3 does: S^T =
//   K Q^T and dP^T = V dO^T from shared memory; P^T and dS^T in registers,
//   each packed to bf16; dV += P^T dO and dK += dS^T Q with the scores as
//   register operands. The contraction over the panel's rows sums the
//   group into the KV head; dK and dV (64 x 128 f32 each) stay in
//   registers.
// No score touches shared memory, and the mask runs only on tiles that
// straddle the diagonal or a ragged end (rows and keys past Tq / Tk are
// zero-filled by the copies). Loads are issued by the warps that compute
// (no producer warp, no TMA); each CTA waits on its products once per
// tile, and the second CTA on the SM fills the tensor cores meanwhile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "smem_once.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;   // flattened q-slot x group panel rows
constexpr int BK = 64;     // keys per tile
constexpr int NT = 128;    // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;
static_assert(NT == 2 * ROWS, "two threads per panel row");
// dq: Q, dO, then two stages of (K, V), then the panel's L and D rows;
// 1024 bytes of slack to align the base.
template <int D>
constexpr size_t dq_smem_bytes() {
  return 1024 + 2 * (2 * (size_t)ROWS * D + 4 * (size_t)BK * D) + 2 * ROWS * 4;
}
// dkv: K, V, then two stages of (Q panel, dO panel), then two stages of
// the panel's L and D rows.
template <int D>
constexpr size_t dkv_smem_bytes() {
  return 1024 + 2 * (2 * (size_t)BK * D + 4 * (size_t)ROWS * D) + 2 * 2 * ROWS * 4;
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// One CTA per (64-row panel, KV head, batch), one warpgroup; thread rows
// are panel rows (query slot q0 + r / group of head kvh * group + r % group).
template <int D, typename OutT>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ L, const bf16* __restrict__ o,
                    const float* __restrict__ dvec, float* __restrict__ d_out,
                    OutT* __restrict__ dq, int Tq, int Tk, int H, int KVH, int group,
                    int causal, int q_off, int k_off, int stride, float scale) {
  constexpr int PANEL_ELEMS = ROWS * D;
  constexpr int KEY_ELEMS = BK * D;
  extern __shared__ unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* sG = sQ + PANEL_ELEMS;
  bf16* sKV = sG + PANEL_ELEMS;  // stage s: K at sKV + 2 s KEY_ELEMS, V after it
  float* sL = reinterpret_cast<float*>(sKV + 4 * KEY_ELEMS);
  float* sD = sL + ROWS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int blk_q = ROWS / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * blk_q;  // heaviest first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;

  auto panel_row = [&](const bf16* base) {
    return [=](int r) -> const bf16* {
      const int t = q0 + r / group;
      return t < Tq ? base + (((size_t)b * Tq + t) * H + kvh * group + r % group) * D
                    : nullptr;
    };
  };
  load_tile<ROWS, NT, D>(sQ, tid, panel_row(q), q);
  load_tile<ROWS, NT, D>(sG, tid, panel_row(g), g);
  cp_async_commit();

  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * BK;
    auto row = [&](const bf16* base) {
      return [=](int j) -> const bf16* {
        const int t = k0 + j;
        return t < Tk ? base + (((size_t)b * Tk + t) * KVH + kvh) * D : nullptr;
      };
    };
    bf16* dst = sKV + 2 * st * KEY_ELEMS;
    load_tile<BK, NT, D>(dst, tid, row(k), k);
    load_tile<BK, NT, D>(dst + KEY_ELEMS, tid, row(v), v);
  };

  // Key tiles up to the causal limit: the last query position in the panel.
  const int q_last = min(q0 + blk_q, Tq) - 1;
  const int q_hi = q_off + stride * q_last;
  int n_tiles = (Tk + BK - 1) / BK;
  if (causal)
    while (n_tiles > 0 && k_off + stride * (n_tiles - 1) * BK > q_hi) --n_tiles;
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // Row stats: thread pair (2r, 2r + 1) owns panel row r. Fused D sums
  // dO * O over the pair's two D/2-column halves in f32.
  {
    const int r = tid >> 1, half = tid & 1;
    const int t = q0 + r / group;
    const size_t row = ((size_t)b * H + kvh * group + r % group) * Tq + t;
    float d_row = 0.f;
    if (o != nullptr) {
      constexpr int HALF_CHUNKS = D / 16;  // 16-byte chunks of D/2 columns
      uint4 ov[HALF_CHUNKS];
      if (t < Tq) {
        const bf16* orow =
            o + (((size_t)b * Tq + t) * H + kvh * group + r % group) * D + half * (D / 2);
#pragma unroll
        for (int ch = 0; ch < HALF_CHUNKS; ++ch)
          ov[ch] = *reinterpret_cast<const uint4*>(orow + ch * 8);
      }
      cp_async_wait<1>();  // this thread's Q and dO copies landed
      __syncthreads();     // ... and every thread's
      if (t < Tq) {
#pragma unroll
        for (int ch = 0; ch < HALF_CHUNKS; ++ch)
          d_row = dot8(
              *reinterpret_cast<const uint4*>(sG + swz(ROWS, r, half * (D / 2) + ch * 8)),
              ov[ch], d_row);
      }
      d_row += __shfl_xor_sync(0xffffffffu, d_row, 1);
      if (t < Tq && half == 0) d_out[row] = d_row;  // the row's only writer
    } else if (t < Tq) {
      d_row = dvec[row];
    }
    if (half == 0) {
      sL[r] = t < Tq ? L[row] : 0.f;
      sD[r] = d_row;
    }
  }
  __syncthreads();

  // This thread's panel rows: accumulator rows l/4 and l/4 + 8 of its
  // warp's 16.
  const int r_a = (tid >> 5) * 16 + (lane >> 2);
  const int r_b = r_a + 8;
  const int t_a = q0 + r_a / group, t_b = q0 + r_b / group;
  const float l2_a = sL[r_a] * LOG2E, l2_b = sL[r_b] * LOG2E;
  const float d_a = sD[r_a], d_b = sD[r_b];
  const float c = scale * LOG2E;
  const int col0 = 2 * (lane & 3);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) load_kv(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q, dO) landed for this thread's copies
    fence_proxy_async();
    __syncthreads();     // ... and for every thread's
    const bf16* sK = sKV + 2 * st * KEY_ELEMS;
    const bf16* sV = sK + KEY_ELEMS;
    const int k0 = kt * BK;

    float s[32], dp[32];
    wgmma_fence();
    gemm_nt_64x64<D>(s, sQ, ROWS, sK, BK);
    gemm_nt_64x64<D>(dp, sG, ROWS, sV, BK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P = exp2(S scale log2e - L log2e) (0 where masked), dS = P (dP - D),
    // in place in dp.
    const int k_last = k_off + stride * (min(k0 + BK, Tk) - 1);
    const bool masked = q0 + blk_q > Tq || k0 + BK > Tk ||
                        (causal && q_off + stride * q0 < k_last);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * i + col0 + e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * i + 2 * h + e;
          float p = exp2f(fmaf(s[x], c, -(h ? l2_b : l2_a)));
          if (masked) {
            const int t = h ? t_b : t_a;
            bool valid = t < Tq && kpos < Tk;
            if (causal) valid = valid && q_off + stride * t >= k_off + stride * kpos;
            p = valid ? p : 0.f;
          }
          dp[x] = p * (dp[x] - (h ? d_b : d_a));
        }
      }
    uint32_t pd[16];
    pack_scores(pd, dp);

    wgmma_fence();
    gemm_rs_64xN<D>(acc, pd, sK, BK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp is done with stage st
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r_b : r_a;
    const int t = h ? t_b : t_a;
    if (t >= Tq) continue;
    OutT* row = dq + (((size_t)b * Tq + t) * H + kvh * group + r % group) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int x = 4 * i + 2 * h;
      store2(row + 8 * i + col0, acc[x] * scale, acc[x + 1] * scale);
    }
  }
}

// One CTA per (64-key tile, KV head, batch), one warpgroup; thread rows
// are keys. Works transposed: S^T = K Q^T and dP^T = V dO^T (K-major
// operands in shared memory), P^T and dS^T in registers, then dV += P^T dO
// and dK += dS^T Q with P^T / dS^T as register operands and the panels
// MN-major. The contraction over the panel's rows sums the GQA group.
template <int D, typename OutT>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ L, const float* __restrict__ dvec,
                     OutT* __restrict__ dk, OutT* __restrict__ dv, int Tq, int Tk, int H,
                     int KVH, int group, int causal, int q_off, int k_off, int stride,
                     float scale) {
  constexpr int PANEL_ELEMS = ROWS * D;
  constexpr int KEY_ELEMS = BK * D;
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
  load_tile<BK, NT, D>(sK, tid, key_row(k), k);
  load_tile<BK, NT, D>(sV, tid, key_row(v), v);

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
    load_tile<ROWS, NT, D>(dst, tid, row(q), q);
    load_tile<ROWS, NT, D>(dst + PANEL_ELEMS, tid, row(g), g);
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

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

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
    gemm_nt_64x64<D>(s, sK, BK, sQ, ROWS);
    gemm_nt_64x64<D>(dp, sV, BK, sG, ROWS);
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
    gemm_rs_64xN<D>(acc_v, pp, sG, ROWS);
    gemm_rs_64xN<D>(acc_k, pd, sQ, ROWS);
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
    for (int i = 0; i < D / 8; ++i) {
      const int x = 4 * i + 2 * h;
      store2(dk + row + 8 * i + col0, acc_k[x] * scale, acc_k[x + 1] * scale);
      store2(dv + row + 8 * i + col0, acc_v[x], acc_v[x + 1]);
    }
  }
}

// --- head dims above 128 ------------------------------------------------------
//
// Any multiple of 128: a grid axis over column blocks of the output (dQ
// in dq; dK and dV in dkv; blockIdx.y = KV head x blocks + block cb).
// D = rowsum(dO O) spans the whole head dim, so these kernels always read
// a given D. Both compute each score tile once per thread-block cluster of
// column blocks (flash_wide.cuh's design): each rank sums its chunks'
// share of S and dP into partials, the cluster reduces them through
// distributed shared memory, and each rank's block takes its own product
// of the reduced scores.

constexpr int CD = 128;                      // head-dim columns of one chunk
constexpr int WIDE_PANEL = ROWS * CD;        // one chunk of a 64-row panel
constexpr int WIDE_KEYS = BK * CD;           // one chunk of a 64-key tile
constexpr int WIDE_STAGE = 2 * WIDE_PANEL + 2 * WIDE_KEYS;
// dq: 128-column chunks in a column block of dQ (its block is
// DQ_CB * 128 columns wide; flash_attention.WIDE_BLOCKS). The exchange,
// not the products, bounds a cluster kernel, and a 256-column block
// halves the scores exchanged per product: on an H100 at the TP shard
// shape (B 16, T 2048, one head, D 1024) dq read 1.63-1.64 ms at 256
// columns against 2.74-2.78 at 128 (PERF.md).
constexpr int DQ_CB = 2;
// dq (bytes from the aligned base): the Q and dO slot (resident when
// m = 1, else the step's chunk), two stages of K, V; the partials S and
// dP [ROWS][BK] f32; dS [ROWS][BK] bf16; the panel's L and D rows.
constexpr size_t WIDE_DQ_PART = 2 * (2 * (size_t)DQ_CB * WIDE_PANEL + 3 * (size_t)DQ_CB * WIDE_KEYS);
constexpr size_t WIDE_DQ_SMEM =
    1024 + WIDE_DQ_PART + 2 * 4 * ROWS * BK + 2 * ROWS * BK + 2 * ROWS * 4;
// dkv (bytes from the aligned base): resident K_cb, V_cb; two stages of
// (Q_c, dO_c, K_c, V_c); the partials S^T and dP^T [BK][ROWS] f32; P^T and
// dS^T [BK][ROWS] bf16; two stages of the panel's L and D rows.
constexpr size_t WIDE_DKV_PART = 2 * (2 * (size_t)WIDE_KEYS + 2 * (size_t)WIDE_STAGE);
constexpr size_t WIDE_DKV_SMEM =
    1024 + WIDE_DKV_PART + 2 * 4 * BK * ROWS + 2 * 2 * BK * ROWS + 2 * 2 * ROWS * 4;

// dq at head dims above 128: the forward's loop order, dkv's exchange.
// One CTA per (64-row panel, KV head x column block, batch), two
// warpgroups, in clusters of cs = wide_cluster_size(nb) CTAs along y
// (nb = D / W blocks of W = 128 DQ_CB columns; a cluster is blocks
// cl cs .. cl cs + cs - 1 of one panel). Rank r sums the m = nb / cs
// blocks r, r + cs, ... of the head dim (ordered to end on its own block
// cb = cl cs + r; at m = 1 the only one is cb), Q_cb and dO_cb resident
// when m = 1 and streamed through the same slot otherwise. Per key tile,
// K_c streaming through a 2-stage cp.async ring and V_c through one
// buffer (each step's copies issued once the previous step's products are
// done, so they overlap the exchange):
// - warpgroup 0 computes the partial S_r = Q_r K_r^T, warpgroup 1
//   dP_r = dO_r V_r^T (64 x 64 f32 each), and both go to shared memory;
// - after a cluster barrier rank r reduces its 1/cs of the panel rows
//   over every rank's partials through distributed shared memory (in rank
//   order: at m = 1 block order, so every column block of the panel holds
//   a bit-identical dS), forms P = exp(S scale - L) and dS = P (dP - D)
//   with the causal, ragged and offset / stride masks, and stores dS in
//   bf16 into every rank's shared memory (dQ needs no P);
// - after a second cluster barrier dQ_cb += dS K_cb, dS read back as
//   wgmma register fragments, warpgroup w taking dQ_cb's W / 2 columns
//   [w W / 2, (w + 1) W / 2) (both warpgroups hold all 64 panel rows, and
//   wgmma's M is 64: the columns are what splits).
// The second barrier frees the partials for the next tile, and the
// fragments are read before the next tile's first barrier, so one buffer
// of each suffices. Every CTA of a cluster runs the same panel, hence the
// same tile count and barriers. At m > 1 each rank's chunk order ends on
// its own block, so the panel's clusters sum S in different orders and
// may differ in the last bits.
template <typename OutT>
__global__ void __launch_bounds__(2 * NT, 1)
flash_bwd_dq_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         const float* __restrict__ L, const float* __restrict__ dvec,
                         OutT* __restrict__ dq, int Tq, int Tk, int H, int KVH, int group,
                         int nb, int causal, int q_off, int k_off, int stride, float scale) {
  constexpr int W = DQ_CB * CD;  // columns of a block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sb = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(sb);     // Q's block, DQ_CB chunks
  bf16* sG = sQ + DQ_CB * WIDE_PANEL;         // dO's block
  bf16* sKring = sG + DQ_CB * WIDE_PANEL;     // stage s: K's block at s DQ_CB WIDE_KEYS
  bf16* sV = sKring + 2 * DQ_CB * WIDE_KEYS;  // V's block
  float* sPartS = reinterpret_cast<float*>(sb + WIDE_DQ_PART);
  float* sPartP = sPartS + ROWS * BK;
  bf16* sDS = reinterpret_cast<bf16*>(sPartP + ROWS * BK);
  float* sL = reinterpret_cast<float*>(sDS + ROWS * BK);
  float* sD = sL + ROWS;

  const int D = nb * W;
  const int cs = wide_cluster_size(nb), mch = nb / cs;
  const bool resident = mch == 1;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int blk_q = ROWS / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * blk_q;  // heaviest first
  const int kvh = blockIdx.y / nb;
  const int cb = blockIdx.y - kvh * nb;
  const int rank = cb % cs, cl = cb / cs;  // cs divides nb
  const int b = blockIdx.z;

  // Key tiles up to the causal limit: the last query position in the panel
  // (the same in every CTA of the cluster).
  const int q_hi = q_off + stride * (min(q0 + blk_q, Tq) - 1);
  int n_tiles = (Tk + BK - 1) / BK;
  if (causal)
    while (n_tiles > 0 && k_off + stride * (n_tiles - 1) * BK > q_hi) --n_tiles;
  const int steps = n_tiles * mch;

  auto panel_row = [&](const bf16* src, int c0) {
    return [=](int r) -> const bf16* {
      const int t = q0 + r / group;
      return t < Tq ? src + (((size_t)b * Tq + t) * H + kvh * group + r % group) * D + c0
                    : nullptr;
    };
  };
  auto key_row = [&](const bf16* src, int k0, int c0) {
    return [=](int r) -> const bf16* {
      const int t = k0 + r;
      return t < Tk ? src + (((size_t)b * Tk + t) * KVH + kvh) * D + c0 : nullptr;
    };
  };
  auto load_panel = [&](int c0) {
#pragma unroll
    for (int x = 0; x < DQ_CB; ++x) {
      load_tile<ROWS, 2 * NT>(sQ + x * WIDE_PANEL, tid, panel_row(q, c0 + x * CD), q);
      load_tile<ROWS, 2 * NT>(sG + x * WIDE_PANEL, tid, panel_row(g, c0 + x * CD), g);
    }
  };
  // Step j: key tile j / m, block rank + cs ((cl + 1 + j % m) % m) (cb
  // last): K's block into stage j & 1, V's into its buffer and, when Q and
  // dO are not resident, theirs into the slot.
  auto load_step = [&](int j) {
    const int kt = j / mch, i = j - kt * mch;
    const int col = (rank + cs * ((cl + 1 + i) % mch)) * W;
    bf16* sK = sKring + (j & 1) * DQ_CB * WIDE_KEYS;
#pragma unroll
    for (int x = 0; x < DQ_CB; ++x) {
      load_tile<BK, 2 * NT>(sK + x * WIDE_KEYS, tid, key_row(k, kt * BK, col + x * CD), k);
      load_tile<BK, 2 * NT>(sV + x * WIDE_KEYS, tid, key_row(v, kt * BK, col + x * CD), v);
    }
    if (!resident) load_panel(col);
  };
  if (resident) load_panel(cb * W);
  if (steps > 0) load_step(0);
  cp_async_commit();

  // Thread i < 64 stages panel row i's L, thread 64 + i its D (read after
  // the first step's barrier).
  if (tid < 2 * ROWS) {
    const int r = tid % ROWS;
    const int t = q0 + r / group;
    const size_t row = ((size_t)b * H + kvh * group + r % group) * Tq + t;
    if (tid < ROWS) sL[r] = t < Tq ? L[row] : 0.f;
    else sD[r] = t < Tq ? dvec[row] : 0.f;
  }

  const float c = scale * LOG2E;
  // The panel rows this rank reduces, as (row, 4-key chunk) tasks.
  const int lo = rank * ROWS / cs, hi = (rank + 1) * ROWS / cs;
  const int n_tasks = (hi - lo) * 16;

  float acc[W / 4];  // dQ_cb's W / 2 columns of this warpgroup
#pragma unroll
  for (int x = 0; x < W / 4; ++x) acc[x] = 0.f;
  float s[32];

  for (int j = 0; j < steps; ++j) {
    const int kt = j / mch, i = j - kt * mch;
    cp_async_wait<0>();  // step j landed for this thread's copies
    fence_proxy_async();
    __syncthreads();     // ... and for every thread's
    const bf16* sK = sKring + (j & 1) * DQ_CB * WIDE_KEYS;

    // Warpgroup 0: S (+)= Q_c K_c^T; warpgroup 1: dP (+)= dO_c V_c^T.
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < DQ_CB; ++x)
      gemm_nt_64x64_chunk(s, (wg ? sG : sQ) + x * WIDE_PANEL, ROWS,
                          (wg ? sV : sK) + x * WIDE_KEYS, BK, i > 0 || x > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    __syncthreads();  // every warpgroup is done with the slot, V and stage j & 1's reads
    if (j + 1 < steps) load_step(j + 1);
    cp_async_commit();

    if (i == mch - 1) {
      store_scores(wg ? sPartP : sPartS, 0, lane, warp, s);
      cluster_sync();

      // Reduce this rank's rows over the cluster: dS to every rank.
      const int k0 = kt * BK;
      for (int task = tid; task < n_tasks; task += 2 * NT) {
        const int row = lo + (task >> 4), c4 = task & 15;
        float4 sv, dpv;
        cluster_sum_f4x2(sPartS + fswz(row, 4 * c4), sPartP + fswz(row, 4 * c4), cs, sv, dpv);
        const float ss[4] = {sv.x, sv.y, sv.z, sv.w};
        const float dd[4] = {dpv.x, dpv.y, dpv.z, dpv.w};
        const int t = q0 + row / group;
        const float l2 = sL[row] * LOG2E, dr = sD[row];
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 4 * c4 + e;
          bool valid = t < Tq && kpos < Tk;
          if (causal) valid = valid && q_off + stride * t >= k_off + stride * kpos;
          const float p = valid ? exp2f(fmaf(ss[e], c, -l2)) : 0.f;
          ds[e] = p * (dd[e] - dr);
        }
        const uint32_t d01 = pack_bf16x2(ds[0], ds[1]), d23 = pack_bf16x2(ds[2], ds[3]);
        const bf16* dst = sDS + swz(ROWS, row, 4 * c4);
        for (int r = 0; r < cs; ++r) st_dsmem_u32x2(dsmem(dst, r), d01, d23);
      }
      cluster_sync();

      // This step's block is cb: dQ_cb += dS K_cb on this warpgroup's
      // columns.
      uint32_t pf[16];
      load_fragments(pf, sDS, ROWS, 0, lane, warp);
      wgmma_fence();
      gemm_rs_64xN<W / 2>(acc, pf, sK + wg * BK * (W / 2), BK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
  }
  cp_async_wait<0>();

  // No peer touches this CTA's shared memory after the last barrier.
  const int col0 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + (lane >> 2) + 8 * h;
    const int t = q0 + r / group;
    if (t >= Tq) continue;
    OutT* row = dq + (((size_t)b * Tq + t) * H + kvh * group + r % group) * D + cb * W +
                wg * (W / 2);
#pragma unroll
    for (int x = 0; x < W / 16; ++x) {
      const int y = 4 * x + 2 * h;
      store2(row + 8 * x + col0, acc[y] * scale, acc[y + 1] * scale);
    }
  }
}

// dkv at head dims above 128: flash_wide.cuh's cluster design, transposed.
// One CTA per (64-key tile, KV head x column block, batch), two warpgroups,
// in clusters of cs = wide_cluster_size(nc) CTAs along y: column blocks
// cl cs .. cl cs + cs - 1 of one key tile. Rank r sums the m = nc / cs
// chunks r, r + cs, ... of the head dim (ordered to end on its own chunk
// cb = cl cs + r; at m = 1, cs = nc, the only chunk is cb), K_c and V_c
// resident when m = 1 and streamed otherwise. Per q-panel step, with Q_c,
// dO_c, L and D streaming through a 2-stage cp.async ring:
// - warpgroup 0 computes the partial S^T_r = K_r Q_r^T, warpgroup 1
//   dP^T_r = V_r dO_r^T (64 x 64 f32 each), and both go to shared memory;
// - after a cluster barrier rank r reduces its 1/cs of the keys over every
//   rank's partials through distributed shared memory (in rank order: at
//   m = 1 chunk order, so every column block holds a bit-identical S and
//   dP), forms P^T = exp(S^T scale - L) and dS^T = P^T (dP^T - D) with the
//   causal and ragged masks, and stores both in bf16 into every rank's
//   shared memory;
// - after a second cluster barrier warpgroup 0 adds dS^T Q_cb to dK_cb and
//   warpgroup 1 P^T dO_cb to dV_cb (64 x 128 f32 each, 64 registers a
//   thread), the scores read back as wgmma register fragments.
// As in the forward, the second barrier frees the partials for the next
// step and the fragments are read before the next step's first barrier.
// The contraction over the panel's rows sums the GQA group into the KV
// head. At m > 1 each rank's chunk order ends on its own chunk, so the
// panel's clusters sum S in different orders and may differ in the last
// bits.
template <typename OutT>
__global__ void __launch_bounds__(2 * NT, 1)
flash_bwd_dkv_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ g,
                          const float* __restrict__ L, const float* __restrict__ dvec,
                          OutT* __restrict__ dk, OutT* __restrict__ dv, int Tq, int Tk, int H,
                          int KVH, int group, int nc, int causal, int q_off, int k_off,
                          int stride, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sb = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sKres = reinterpret_cast<bf16*>(sb);
  bf16* sVres = sKres + WIDE_KEYS;
  bf16* stages = sVres + WIDE_KEYS;  // stage s: Q_c, dO_c, (m > 1) K_c, V_c
  float* sPartS = reinterpret_cast<float*>(sb + WIDE_DKV_PART);
  float* sPartP = sPartS + BK * ROWS;
  bf16* sPT = reinterpret_cast<bf16*>(sPartP + BK * ROWS);
  bf16* sDST = sPT + BK * ROWS;
  float* sStats = reinterpret_cast<float*>(sDST + BK * ROWS);  // stage s: L, D

  const int D = nc * CD;
  const int cs = wide_cluster_size(nc), mch = nc / cs;
  const bool resident = mch == 1;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int blk_q = ROWS / group;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y / nc;
  const int cb = blockIdx.y - kvh * nc;
  const int rank = cb % cs, cl = cb / cs;  // cs divides nc
  const int b = blockIdx.z;

  const int n_qt = (Tq + blk_q - 1) / blk_q;
  const int k_lo = k_off + stride * k0;
  int qt0 = 0;
  if (causal)
    while (qt0 < n_qt && q_off + stride * (min((qt0 + 1) * blk_q, Tq) - 1) < k_lo) ++qt0;
  const int steps = (n_qt - qt0) * mch;

  auto key_row = [&](const bf16* src, int c0) {
    return [=](int r) -> const bf16* {
      const int t = k0 + r;
      return t < Tk ? src + (((size_t)b * Tk + t) * KVH + kvh) * D + c0 : nullptr;
    };
  };
  // Step j: q-tile qt0 + j / m, chunk rank + cs ((cl + 1 + j % m) % m) (cb
  // last); the q-tile's last step also brings the L and D rows.
  auto load_step = [&](int j) {
    const int qi = j / mch, i = j - qi * mch;
    const int q0 = (qt0 + qi) * blk_q;
    const int col = (rank + cs * ((cl + 1 + i) % mch)) * CD;
    bf16* sQ = stages + (j & 1) * WIDE_STAGE;
    auto panel_row = [&](const bf16* src) {
      return [=](int r) -> const bf16* {
        const int t = q0 + r / group;
        return t < Tq ? src + (((size_t)b * Tq + t) * H + kvh * group + r % group) * D + col
                      : nullptr;
      };
    };
    load_tile<ROWS, 2 * NT>(sQ, tid, panel_row(q), q);
    load_tile<ROWS, 2 * NT>(sQ + WIDE_PANEL, tid, panel_row(g), g);
    if (!resident) {
      load_tile<BK, 2 * NT>(sQ + 2 * WIDE_PANEL, tid, key_row(k, col), k);
      load_tile<BK, 2 * NT>(sQ + 2 * WIDE_PANEL + WIDE_KEYS, tid, key_row(v, col), v);
    }
    if (i == mch - 1 && tid < 2 * ROWS) {
      // Thread i < 64 copies row i's L, thread 64 + i its D.
      const int r = tid % ROWS;
      const int t = q0 + r / group;
      const size_t idx = ((size_t)b * H + kvh * group + r % group) * Tq + t;
      const float* src = tid < ROWS ? L : dvec;
      cp_async_4(sStats + 2 * (j & 1) * ROWS + tid, t < Tq ? src + idx : src, t < Tq);
    }
  };
  if (resident) {
    load_tile<BK, 2 * NT>(sKres, tid, key_row(k, cb * CD), k);
    load_tile<BK, 2 * NT>(sVres, tid, key_row(v, cb * CD), v);
  }
  if (steps > 0) load_step(0);
  cp_async_commit();

  const float c = scale * LOG2E;
  // The keys this rank reduces, as (key, 4-row chunk of the panel) tasks.
  const int lo = rank * BK / cs, hi = (rank + 1) * BK / cs;
  const int n_tasks = (hi - lo) * 16;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float s[32];

  for (int j = 0; j < steps; ++j) {
    const int st = j & 1;
    if (j + 1 < steps) load_step(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // step j landed for this thread's copies
    fence_proxy_async();
    __syncthreads();     // ... and for every thread's
    const bf16* sQ = stages + st * WIDE_STAGE;
    const bf16* sG = sQ + WIDE_PANEL;
    const bf16* sK = resident ? sKres : sG + WIDE_PANEL;
    const bf16* sV = resident ? sVres : sG + WIDE_PANEL + WIDE_KEYS;
    const int qi = j / mch, i = j - qi * mch;

    // Warpgroup 0: S^T (+)= K_c Q_c^T; warpgroup 1: dP^T (+)= V_c dO_c^T.
    wgmma_fence();
    gemm_nt_64x64_chunk(s, wg ? sV : sK, BK, wg ? sG : sQ, ROWS, i > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    if (i == mch - 1) {
      store_scores(wg ? sPartP : sPartS, 0, lane, warp, s);
      cluster_sync();

      // Reduce this rank's keys over the cluster: P^T and dS^T to every
      // rank.
      const float* sL = sStats + 2 * st * ROWS;
      const float* sD = sL + ROWS;
      const int q0 = (qt0 + qi) * blk_q;
      for (int task = tid; task < n_tasks; task += 2 * NT) {
        const int key = lo + (task >> 4), c4 = task & 15;
        float4 sv, dpv;
        cluster_sum_f4x2(sPartS + fswz(key, 4 * c4), sPartP + fswz(key, 4 * c4), cs, sv, dpv);
        const float ss[4] = {sv.x, sv.y, sv.z, sv.w};
        const float dd[4] = {dpv.x, dpv.y, dpv.z, dpv.w};
        const int kpos = k0 + key;
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * c4 + e;  // panel row
          const int t = q0 + r / group;
          bool valid = t < Tq && kpos < Tk;
          if (causal) valid = valid && q_off + stride * t >= k_off + stride * kpos;
          p[e] = valid ? exp2f(fmaf(ss[e], c, -sL[r] * LOG2E)) : 0.f;
          ds[e] = p[e] * (dd[e] - sD[r]);
        }
        const uint32_t p01 = pack_bf16x2(p[0], p[1]), p23 = pack_bf16x2(p[2], p[3]);
        const uint32_t d01 = pack_bf16x2(ds[0], ds[1]), d23 = pack_bf16x2(ds[2], ds[3]);
        const int off = swz(BK, key, 4 * c4);
        for (int r = 0; r < cs; ++r) {
          st_dsmem_u32x2(dsmem(sPT + off, r), p01, p23);
          st_dsmem_u32x2(dsmem(sDST + off, r), d01, d23);
        }
      }
      cluster_sync();

      // This step's chunk is cb: dK += dS^T Q_cb, dV += P^T dO_cb.
      uint32_t pf[16];
      load_fragments(pf, wg ? sPT : sDST, BK, 0, lane, warp);
      wgmma_fence();
      gemm_rs_64xN<CD>(acc, pf, wg ? sG : sQ, ROWS);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();  // every warp is done with stage st
  }
  cp_async_wait<0>();

  // No peer touches this CTA's shared memory after the last barrier.
  const int col0 = 2 * (lane & 3);
  OutT* dout = wg ? dv : dk;
  const float out_scale = wg ? 1.f : scale;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = k0 + warp * 16 + (lane >> 2) + 8 * h;
    if (t >= Tk) continue;
    OutT* row = dout + (((size_t)b * Tk + t) * KVH + kvh) * D + cb * CD;
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int y = 4 * x + 2 * h;
      store2(row + 8 * x + col0, acc[y] * out_scale, acc[y + 1] * out_scale);
    }
  }
}

template <auto kernel>
cudaError_t prepare(size_t smem_bytes) {
  return set_smem_once<kernel>(smem_bytes, true);
}

bool shape_ok(int B, int Tq, int Tk, int H, int KVH, int head_dim, int stride) {
  return (head_dim == 64 || head_dim % CD == 0) && head_dim > 0 && B > 0 && Tq > 0 && Tk > 0 && KVH > 0 &&
         H % KVH == 0 && ROWS % (H / KVH) == 0 && stride > 0;
}

template <int D, typename OutT>
cudaError_t launch_dq(dim3 grid, cudaStream_t s, const void* q, const void* k, const void* v,
                      const void* g, const void* L, const void* o, const void* dvec,
                      void* d_out, void* dq, int Tq, int Tk, int H, int KVH, int causal,
                      int q_off, int k_off, int stride, float scale) {
  cudaError_t err = prepare<flash_bwd_dq_kernel<D, OutT>>(dq_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D, OutT><<<grid, NT, dq_smem_bytes<D>(), s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)L,
      (const bf16*)o, (const float*)dvec, (float*)d_out, (OutT*)dq, Tq, Tk, H, KVH, H / KVH,
      causal, q_off, k_off, stride, scale);
  return cudaGetLastError();
}

template <int D, typename OutT>
cudaError_t launch_dkv(dim3 grid, cudaStream_t s, const void* q, const void* k, const void* v,
                       const void* g, const void* L, const void* dvec, void* dk, void* dv,
                       int Tq, int Tk, int H, int KVH, int causal, int q_off, int k_off,
                       int stride, float scale) {
  cudaError_t err = prepare<flash_bwd_dkv_kernel<D, OutT>>(dkv_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D, OutT><<<grid, NT, dkv_smem_bytes<D>(), s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)L,
      (const float*)dvec, (OutT*)dk, (OutT*)dv, Tq, Tk, H, KVH, H / KVH, causal, q_off, k_off,
      stride, scale);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_dq_wide(cudaStream_t s, const void* q, const void* k, const void* v,
                           const void* g, const void* L, const void* dvec, void* dq, int B,
                           int Tq, int Tk, int H, int KVH, int head_dim, int causal, int q_off,
                           int k_off, int stride, float scale) {
  cudaError_t err = prepare<flash_bwd_dq_wide_kernel<OutT>>(WIDE_DQ_SMEM);
  if (err != cudaSuccess) return err;
  const int nb = head_dim / (DQ_CB * CD), blk_q = ROWS / (H / KVH);
  ClusterLaunch l(dim3((Tq + blk_q - 1) / blk_q, KVH * nb, B), 2 * NT, WIDE_DQ_SMEM,
                  wide_cluster_size(nb), s);
  err = cudaLaunchKernelEx(&l.cfg, flash_bwd_dq_wide_kernel<OutT>, (const bf16*)q,
                           (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)L,
                           (const float*)dvec, (OutT*)dq, Tq, Tk, H, KVH, H / KVH, nb, causal,
                           q_off, k_off, stride, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_dkv_wide(cudaStream_t s, const void* q, const void* k, const void* v,
                            const void* g, const void* L, const void* dvec, void* dk, void* dv,
                            int B, int Tq, int Tk, int H, int KVH, int head_dim, int causal,
                            int q_off, int k_off, int stride, float scale) {
  cudaError_t err = prepare<flash_bwd_dkv_wide_kernel<OutT>>(WIDE_DKV_SMEM);
  if (err != cudaSuccess) return err;
  const int nc = head_dim / CD;
  ClusterLaunch l(dim3((Tk + BK - 1) / BK, KVH * nc, B), 2 * NT, WIDE_DKV_SMEM,
                  wide_cluster_size(nc), s);
  err = cudaLaunchKernelEx(&l.cfg, flash_bwd_dkv_wide_kernel<OutT>, (const bf16*)q,
                           (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)L,
                           (const float*)dvec, (OutT*)dk, (OutT*)dv, Tq, Tk, H, KVH, H / KVH,
                           nc, causal, q_off, k_off, stride, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes); head_dim 64, 128 or a multiple of
// 128 above it (the wide kernels, which take a given D only; dq's a
// multiple of its DQ_CB * 128-column block). dq: `o`
// non-null fuses D = rowsum(dO*O) and writes it to `d_out` ([B,H,Tq] f32)
// for dkv; otherwise `dvec` ([B,H,Tq] f32) is D. dkv always reads D from `dvec`. `out_f32`
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
  cudaStream_t s = (cudaStream_t)stream;
  if (head_dim > CD) {
    if (o != nullptr || head_dim % (DQ_CB * CD) != 0) return (int)cudaErrorInvalidValue;
#define WIDE_ARGS s, q, k, v, g, L, dvec, dq, B, Tq, Tk, H, KVH, head_dim, causal, q_off, k_off, \
                  stride, scale
    return (int)(out_f32 ? launch_dq_wide<float>(WIDE_ARGS) : launch_dq_wide<bf16>(WIDE_ARGS));
#undef WIDE_ARGS
  }
  const int blk_q = ROWS / (H / KVH);
  dim3 grid((Tq + blk_q - 1) / blk_q, KVH, B);
#define DQ_ARGS grid, s, q, k, v, g, L, o, dvec, d_out, dq, Tq, Tk, H, KVH, causal, q_off, \
                k_off, stride, scale
  cudaError_t err;
  if (head_dim == 64)
    err = out_f32 ? launch_dq<64, float>(DQ_ARGS) : launch_dq<64, bf16>(DQ_ARGS);
  else
    err = out_f32 ? launch_dq<128, float>(DQ_ARGS) : launch_dq<128, bf16>(DQ_ARGS);
#undef DQ_ARGS
  return (int)err;
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* g,
                                  const void* L, const void* dvec, void* dk, void* dv, int B,
                                  int Tq, int Tk, int H, int KVH, int head_dim, int causal,
                                  int q_off, int k_off, int stride, float scale, int out_f32,
                                  void* stream) {
  if (!shape_ok(B, Tq, Tk, H, KVH, head_dim, stride) || dvec == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (head_dim > CD) {
#define WIDE_ARGS s, q, k, v, g, L, dvec, dk, dv, B, Tq, Tk, H, KVH, head_dim, causal, q_off, \
                  k_off, stride, scale
    return (int)(out_f32 ? launch_dkv_wide<float>(WIDE_ARGS)
                         : launch_dkv_wide<bf16>(WIDE_ARGS));
#undef WIDE_ARGS
  }
  dim3 grid((Tk + BK - 1) / BK, KVH, B);
#define DKV_ARGS grid, s, q, k, v, g, L, dvec, dk, dv, Tq, Tk, H, KVH, causal, q_off, k_off, \
                 stride, scale
  cudaError_t err;
  if (head_dim == 64)
    err = out_f32 ? launch_dkv<64, float>(DKV_ARGS) : launch_dkv<64, bf16>(DKV_ARGS);
  else
    err = out_f32 ? launch_dkv<128, float>(DKV_ARGS) : launch_dkv<128, bf16>(DKV_ARGS);
#undef DKV_ARGS
  return (int)err;
}

// The wide dq kernel's cluster at `head_dim` (a multiple of its column
// block above 128): its size and the most such clusters the device holds
// at once.
extern "C" int flash_bwd_dq_wide_cluster(int head_dim, int* cluster_size, int* max_clusters) {
  if (head_dim <= CD || head_dim % (DQ_CB * CD) != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<flash_bwd_dq_wide_kernel<bf16>>(WIDE_DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int cs = wide_cluster_size(head_dim / (DQ_CB * CD));
  *cluster_size = cs;
  return (int)max_active_clusters(flash_bwd_dq_wide_kernel<bf16>, 2 * NT, WIDE_DQ_SMEM, cs,
                                  max_clusters);
}

// The wide dkv kernel's cluster at `head_dim` (a multiple of 128 above
// it): its size and the most such clusters the device holds at once.
extern "C" int flash_bwd_dkv_wide_cluster(int head_dim, int* cluster_size,
                                          int* max_clusters) {
  if (head_dim <= CD || head_dim % CD != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<flash_bwd_dkv_wide_kernel<bf16>>(WIDE_DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int cs = wide_cluster_size(head_dim / CD);
  *cluster_size = cs;
  return (int)max_active_clusters(flash_bwd_dkv_wide_kernel<bf16>, 2 * NT, WIDE_DKV_SMEM, cs,
                                  max_clusters);
}
