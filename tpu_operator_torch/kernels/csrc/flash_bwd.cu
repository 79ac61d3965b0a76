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

constexpr int D = 128;     // head dim (the wrapper checks it)
constexpr int ROWS = 64;   // flattened q-slot x group panel rows
constexpr int BK = 64;     // keys per tile
constexpr int NT = 128;    // one warpgroup
constexpr int PANEL_ELEMS = ROWS * D;
constexpr int KEY_ELEMS = BK * D;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(NT == 2 * ROWS, "two threads per panel row");
// dq: Q, dO, then two stages of (K, V), then the panel's L and D rows;
// 1024 bytes of slack to align the base.
constexpr size_t DQ_SMEM_BYTES =
    1024 + 2 * (2 * (size_t)PANEL_ELEMS + 4 * (size_t)KEY_ELEMS) + 2 * ROWS * 4;
// dkv: K, V, then two stages of (Q panel, dO panel), then two stages of
// the panel's L and D rows.
constexpr size_t DKV_SMEM_BYTES =
    1024 + 2 * (2 * (size_t)KEY_ELEMS + 4 * (size_t)PANEL_ELEMS) + 2 * 2 * ROWS * 4;

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// One CTA per (64-row panel, KV head, batch), one warpgroup; thread rows
// are panel rows (query slot q0 + r / group of head kvh * group + r % group).
template <typename OutT>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ L, const bf16* __restrict__ o,
                    const float* __restrict__ dvec, float* __restrict__ d_out,
                    OutT* __restrict__ dq, int Tq, int Tk, int H, int KVH, int group,
                    int causal, int q_off, int k_off, int stride, float scale) {
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
  load_tile<ROWS, NT>(sQ, tid, panel_row(q), q);
  load_tile<ROWS, NT>(sG, tid, panel_row(g), g);
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
    load_tile<BK, NT>(dst, tid, row(k), k);
    load_tile<BK, NT>(dst + KEY_ELEMS, tid, row(v), v);
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
  // dO * O over the pair's two 64-column halves in f32.
  {
    const int r = tid >> 1, half = tid & 1;
    const int t = q0 + r / group;
    const size_t row = ((size_t)b * H + kvh * group + r % group) * Tq + t;
    float d_row = 0.f;
    if (o != nullptr) {
      uint4 ov[8];
      if (t < Tq) {
        const bf16* orow = o + (((size_t)b * Tq + t) * H + kvh * group + r % group) * D + half * 64;
#pragma unroll
        for (int ch = 0; ch < 8; ++ch) ov[ch] = *reinterpret_cast<const uint4*>(orow + ch * 8);
      }
      cp_async_wait<1>();  // this thread's Q and dO copies landed
      __syncthreads();     // ... and every thread's
      if (t < Tq) {
#pragma unroll
        for (int ch = 0; ch < 8; ++ch)
          d_row = dot8(*reinterpret_cast<const uint4*>(sG + swz(ROWS, r, half * 64 + ch * 8)),
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

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

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
    gemm_nt_64x64x128(s, sQ, ROWS, sK, BK);
    gemm_nt_64x64x128(dp, sG, ROWS, sV, BK);
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
    gemm_rs_64x128x64(acc, pd, sK, BK);
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
    for (int i = 0; i < 16; ++i) {
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
template <typename OutT>
__global__ void __launch_bounds__(NT, 2)
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
  load_tile<BK, NT>(sK, tid, key_row(k), k);
  load_tile<BK, NT>(sV, tid, key_row(v), v);

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
    load_tile<ROWS, NT>(dst, tid, row(q), q);
    load_tile<ROWS, NT>(dst + PANEL_ELEMS, tid, row(g), g);
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
  cudaError_t err = prepare<flash_bwd_dq_kernel<OutT>>(DQ_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<OutT><<<grid, NT, DQ_SMEM_BYTES, s>>>(
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
  flash_bwd_dkv_kernel<OutT><<<grid, NT, DKV_SMEM_BYTES, s>>>(
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
