// Ring-attention merge for Hopper (sm_90a): fold one visiting K/V block into
// a resident f32 streaming-softmax carry. bf16 q/k/v, f32 carry.
//
// Replaces: tpu_operator/payload/flash_attention.py `_merge_kernel`
// (launched by `_merge_pallas`), the TPU kernel behind `merge_kv_block`.
// The forward ring of sequence-parallel training runs it once per (query
// shard, visiting K/V block) pair: N^2 launches per layer per microbatch
// for N shards held by one process.
//
// What it computes, for q [B,Tq,H,D], k/v [B,Tk,KVH,D] bf16 (query head h
// reads K/V head h / group, group = H / KVH) and the carry o [B,H,Tq,D],
// l, m [B,H,Tq,1] f32 (query slot i sits at global position
// q_off + stride*i, key slot j at k_off + stride*j):
//   S  = scale Q K^T (causal: masked where q_pos < k_pos, in int32)
//   m' = max(m, rowmax S);  l' = l e^{m-m'} + rowsum e^{S-m'};
//   o' = o e^{m-m'} + bf16(e^{S-m'}) V
// and writes (o', l', m') to the output carry: no finalize. Masked scores
// are -1e30 (not -inf), so a masked key adds exactly 0 once a row has
// seen a valid key; a row that has seen none keeps m = -1e30 and carries
// weight-1 sums of whatever masked keys it met, which the first valid key
// (alpha = 0) or `finalize` (m guard) discards, as in the TPU kernel.
//
// What bounds it on an H100: both, about evenly. At the ring shape of the
// long-context flagship (B 2, Tq = Tk = 2048, H 16, KVH 4, D 128, half the
// pairs causal-masked) the two products are 4 D H B pairs = 34 GFLOP,
// 0.035 ms at the 989 TFLOP/s bf16 tensor-core peak, against ~94 MB of
// q/k/v reads plus the f32 carry read and written (0.028 ms at 3.35 TB/s).
//
// What this simple design does about it (flash_fwd.cu's tile loop):
// - one CTA per (q-tile, KV head, batch); the q-tile's `group` query heads
//   form one 64-row panel (64 / group positions x group heads), so each
//   K/V tile is read once per group, not once per head;
// - the carry rows of the panel are read once into shared memory, updated
//   across every K/V tile, and written once; no CTA touches another's rows;
// - both products on the tensor cores (WMMA 16x16x16 bf16 -> f32); scores,
//   the bf16 probabilities and the f32 accumulator stay in shared memory;
// - causal tiles wholly in the panel's future are never loaded: the key
//   loop breaks at the first tile whose first position is past the panel's
//   last, comparing global positions (off + stride*slot), so a wholly
//   future block writes its carry back unchanged;
// - ragged Tq and Tk are masked in-kernel (zero-filled rows, masked
//   scores), so any lengths work.
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
constexpr int CH = D / 8;    // 16-byte bf16 chunks per row
constexpr int CF = D / 4;    // 16-byte f32 chunks per row
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
flash_merge_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ o_in,
                   const float* __restrict__ l_in, const float* __restrict__ m_in,
                   float* __restrict__ o_out, float* __restrict__ l_out,
                   float* __restrict__ m_out, int Tq, int Tk, int H, int KVH, int group,
                   int causal, int q_off, int k_off, int stride, float scale) {
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

  // Q panel: row r is query slot q0 + r % blk_q of head kvh*group + r / blk_q.
  for (int c = tid; c < ROWS * CH; c += NT) {
    const int r = c / CH, ch = c % CH;
    const int t = q0 + r % blk_q;
    const int h = kvh * group + r / blk_q;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < Tq)
      val = *reinterpret_cast<const uint4*>(q + (((size_t)b * Tq + t) * H + h) * D + ch * 8);
    *reinterpret_cast<uint4*>(sQ + r * LDH + ch * 8) = val;
  }
  // Seed the accumulators from the carry (rows past Tq: an empty row).
  for (int c = tid; c < ROWS * CF; c += NT) {
    const int r = c / CF, ch = c % CF;
    const int t = q0 + r % blk_q;
    const int h = kvh * group + r / blk_q;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < Tq)
      val = *reinterpret_cast<const float4*>(o_in + (((size_t)b * H + h) * Tq + t) * D + ch * 4);
    *reinterpret_cast<float4*>(sO + r * LDO + ch * 4) = val;
  }
  if (tid < ROWS) {
    const int t = q0 + tid % blk_q;
    const int h = kvh * group + tid / blk_q;
    const size_t row = ((size_t)b * H + h) * Tq + t;
    sM[tid] = t < Tq ? m_in[row] : NEG_INF;
    sL[tid] = t < Tq ? l_in[row] : 0.f;
  }
  __syncthreads();  // the loop below may run no tile at all

  const int q_hi = q_off + stride * (min(q0 + blk_q, Tq) - 1);  // last position in the panel
  const int n_tiles = (Tk + BK - 1) / BK;
  const int r0 = warp * 16;  // this warp's panel rows

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    if (causal && k_off + stride * k0 > q_hi) break;  // this and later tiles are masked
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int c = tid; c < BK * CH; c += NT) {
      const int j = c / CH, ch = c % CH;
      const int t = k0 + j;
      uint4 kval = make_uint4(0, 0, 0, 0), vval = make_uint4(0, 0, 0, 0);
      if (t < Tk) {
        const size_t off = (((size_t)b * Tk + t) * KVH + kvh) * D + ch * 8;
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
      // Rows past Tq are never written back; clamping keeps their
      // position inside the range the wrapper checked for int32 overflow.
      const int qpos = q_off + stride * min(q0 + r % blk_q, Tq - 1);
      float s[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        const int kslot = k0 + j;
        const bool valid = kslot < Tk && (!causal || qpos >= k_off + stride * kslot);
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

  // Write this warp's rows of the carry back: o, l, m as they stand.
  for (int c = lane; c < 16 * CF; c += 32) {
    const int r = r0 + c / CF, ch = c % CF;
    const int t = q0 + r % blk_q;
    if (t >= Tq) continue;
    const int h = kvh * group + r / blk_q;
    *reinterpret_cast<float4*>(o_out + (((size_t)b * H + h) * Tq + t) * D + ch * 4) =
        *reinterpret_cast<const float4*>(sO + r * LDO + ch * 4);
  }
  if (lane < 16) {
    const int r = r0 + lane;
    const int t = q0 + r % blk_q;
    if (t < Tq) {
      const int h = kvh * group + r / blk_q;
      const size_t row = ((size_t)b * H + h) * Tq + t;
      l_out[row] = sL[r];
      m_out[row] = sM[r];
    }
  }
}

}  // namespace

// C entry point (bound with ctypes). Reads the carry (o_in, l_in, m_in)
// and writes the merged one to (o_out, l_out, m_out), which must not
// overlap it. Launches on `stream`; returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int flash_merge_bf16(const void* q, const void* k, const void* v, const void* o_in,
                                const void* l_in, const void* m_in, void* o_out, void* l_out,
                                void* m_out, int B, int Tq, int Tk, int H, int KVH,
                                int head_dim, int causal, int q_off, int k_off, int stride,
                                float scale, void* stream) {
  if (head_dim != D || B <= 0 || Tq <= 0 || Tk <= 0 || KVH <= 0 || H % KVH != 0 ||
      ROWS % (H / KVH) != 0 || stride <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_once<flash_merge_kernel>(SMEM_BYTES, false);
  if (err != cudaSuccess) return (int)err;
  const int group = H / KVH;
  const int blk_q = ROWS / group;
  dim3 grid((Tq + blk_q - 1) / blk_q, KVH, B);
  flash_merge_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)o_in, (const float*)l_in,
      (const float*)m_in, (float*)o_out, (float*)l_out, (float*)m_out, Tq, Tk, H, KVH, group,
      causal, q_off, k_off, stride, scale);
  return (int)cudaGetLastError();
}
