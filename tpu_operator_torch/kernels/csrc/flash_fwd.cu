// Fused flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces: tpu_operator/payload/flash_attention.py `_fwd_kernel` (launched
// by `_flash_fwd_pallas`), the TPU kernel behind `flash_attention`. It is
// the serve path's prefill attention (one launch per layer per admission).
//
// What it computes, for q [B,T,H,D], k/v [B,T,KVH,D] bf16 (query head h
// reads K/V head h / group, group = H / KVH):
//   O [B,T,H,D] bf16 = softmax(scale * Q K^T, causal mask) V
//   L [B,H,T,1] f32  = m + log(l), the per-row logsumexp
// with the online-softmax recurrence of the TPU kernel:
//   m' = max(m, rowmax S);  l' = l e^{m-m'} + rowsum e^{S-m'};
//   o' = o e^{m-m'} + e^{S-m'} V
// Masked scores are -1e30 (not -inf), so a masked key adds exactly 0 once
// a row has seen a valid key, and a row that saw none ends with O = 0 and
// L = 0 (the TPU kernel's `valid` guard).
//
// What bounds it on an H100: operations. At the prefill shape (T 1920,
// H 16, KVH 4, D 128, causal) the two products are 4 D H T(T+1)/2 = 15.1
// GFLOP, about 15 us at the 989 TFLOP/s bf16 tensor-core peak, against
// about 20 MB of q/k/v/O/L traffic (6 us at 3.35 TB/s).
//
// What this simple design does about it:
// - one CTA per (q-tile, KV head, batch); the q-tile's `group` query heads
//   are flattened into one 64-row panel (64 / group positions x group
//   heads), so each K/V tile is read once per group, not once per head;
// - both products run on the tensor cores (WMMA 16x16x16 bf16 -> f32);
// - K/V tiles of 64 keys are staged in shared memory; scores, the bf16
//   probabilities and the f32 output accumulator stay in shared memory, so
//   no [T,T] tensor touches device memory;
// - causal tiles wholly beyond the q-tile are never loaded;
// - ragged T is masked in-kernel (zero-filled rows, masked scores), so any
//   T works: there is no TPU-style feasibility fallback.
// It does not yet overlap loads with compute (no cp.async/TMA pipeline, no
// wgmma); that is later work.

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
constexpr int NT = 128;      // 4 warps, 16 panel rows each
constexpr int LDH = D + 8;   // bf16 pitch of the Q/K/V tiles
constexpr int LDS = BK + 4;  // f32 pitch of the scores
constexpr int LDP = BK + 8;  // bf16 pitch of the probabilities
constexpr int LDO = D + 4;   // f32 pitch of the output accumulator
constexpr float NEG_INF = -1e30f;

constexpr size_t SMEM_BYTES =
    (size_t)ROWS * LDH * 2 + 2 * (size_t)BK * LDH * 2 + (size_t)ROWS * LDS * 4 +
    (size_t)ROWS * LDP * 2 + (size_t)ROWS * LDO * 4 + 3 * (size_t)ROWS * 4;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int H, int KVH, int group,
                 int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + ROWS * LDH;
  bf16* sV = sK + BK * LDH;
  float* sS = reinterpret_cast<float*>(sV + BK * LDH);
  bf16* sP = reinterpret_cast<bf16*>(sS + ROWS * LDS);
  float* sO = reinterpret_cast<float*>(sP + ROWS * LDP);
  float* sM = sO + ROWS * LDO;
  float* sL = sM + ROWS;
  float* sA = sL + ROWS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int blk_q = ROWS / group;
  const int q0 = blockIdx.x * blk_q;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  constexpr int CH = D / 8;  // 16-byte chunks per row

  // Q panel: row r is query slot r % blk_q of head kvh*group + r / blk_q.
  for (int c = tid; c < ROWS * CH; c += NT) {
    const int r = c / CH, ch = c % CH;
    const int t = q0 + r % blk_q;
    const int h = kvh * group + r / blk_q;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < T)
      val = *reinterpret_cast<const uint4*>(q + (((size_t)b * T + t) * H + h) * D + ch * 8);
    *reinterpret_cast<uint4*>(sQ + r * LDH + ch * 8) = val;
  }
  for (int c = tid; c < ROWS * D; c += NT) sO[(c / D) * LDO + c % D] = 0.f;
  if (tid < ROWS) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  const int q_last = min(q0 + blk_q, T) - 1;
  const int kv_end = causal ? q_last + 1 : T;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int r0 = warp * 16;  // this warp's panel rows

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int c = tid; c < BK * CH; c += NT) {
      const int j = c / CH, ch = c % CH;
      const int t = k0 + j;
      uint4 kval = make_uint4(0, 0, 0, 0), vval = make_uint4(0, 0, 0, 0);
      if (t < T) {
        const size_t off = (((size_t)b * T + t) * KVH + kvh) * D + ch * 8;
        kval = *reinterpret_cast<const uint4*>(k + off);
        vval = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sK + j * LDH + ch * 8) = kval;
      *reinterpret_cast<uint4*>(sV + j * LDH + ch * 8) = vval;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, sQ + r0 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(bt, sK + (n * 16) * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(sS + r0 * LDS + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over the tile, one row at a time, 2 keys per lane.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int qpos = q0 + r % blk_q;
      float s[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        const int kpos = k0 + j;
        const bool valid = kpos < T && (!causal || kpos <= qpos);
        s[c] = valid ? sS[r * LDS + j] * scale : NEG_INF;
      }
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(s[0] - m_new);
      const float p1 = expf(s[1] - m_new);
      const float alpha = expf(m_old - m_new);
      const float psum = warp_sum(p0 + p1);
      sP[r * LDP + lane] = __float2bfloat16(p0);
      sP[r * LDP + lane + 32] = __float2bfloat16(p1);
      if (lane == 0) {
        sL[r] = sL[r] * alpha + psum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncwarp();
    for (int c = lane; c < 16 * D; c += 32) {
      const int r = r0 + c / D;
      sO[r * LDO + c % D] *= sA[r];
    }
    __syncwarp();

    // O += P V for this warp's rows.
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + r0 * LDO + n * 16, LDO, wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sP + r0 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(bv, sV + (kk * 16) * LDH + n * 16, LDH);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(sO + r0 * LDO + n * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncwarp();

  // Emit: O = acc / l (0 for a row that saw no key), L = m + log l.
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = r0 + c / CH, ch = c % CH;
    const int t = q0 + r % blk_q;
    if (t >= T) continue;
    const int h = kvh * group + r / blk_q;
    const bool valid = sM[r] > NEG_INF / 2;
    const float inv = 1.f / fmaxf(sL[r], 1e-30f);
    __align__(16) bf16 out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      out[e] = __float2bfloat16(valid ? sO[r * LDO + ch * 8 + e] * inv : 0.f);
    *reinterpret_cast<uint4*>(o + (((size_t)b * T + t) * H + h) * D + ch * 8) =
        *reinterpret_cast<const uint4*>(out);
  }
  if (lane < 16) {
    const int r = r0 + lane;
    const int t = q0 + r % blk_q;
    if (t < T) {
      const int h = kvh * group + r / blk_q;
      const bool valid = sM[r] > NEG_INF / 2;
      lse[((size_t)b * H + h) * T + t] = valid ? sM[r] + logf(fmaxf(sL[r], 1e-30f)) : 0.f;
    }
  }
}

}  // namespace

// C entry point (bound with ctypes). Launches on `stream`; returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                              void* lse, int B, int T, int H, int KVH, int head_dim,
                              int causal, float scale, void* stream) {
  if (head_dim != D || B <= 0 || T <= 0 || KVH <= 0 || H % KVH != 0 ||
      ROWS % (H / KVH) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_once<flash_fwd_kernel>(SMEM_BYTES, false);
  if (err != cudaSuccess) return (int)err;
  const int group = H / KVH;
  const int blk_q = ROWS / group;
  dim3 grid((T + blk_q - 1) / blk_q, KVH, B);
  flash_fwd_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, T, H, KVH,
      group, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
