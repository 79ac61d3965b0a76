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
// and writes (o', l', m') to the output carry: no finalize. m is in
// natural-log units, as the carry holds it. Masked scores are -1e30 (not
// -inf), so a masked key adds exactly 0 once a row has seen a valid key; a
// row that has seen none keeps m = -1e30 and carries weight-1 sums of
// whatever masked keys it met, which the first valid key (alpha = 0) or
// `finalize` (m guard) discards, as in the TPU kernel.
//
// What bounds it on an H100: operations, closely followed by bytes. At the
// ring shape of the long-context flagship (B 2, Tq = Tk = 2048, H 16,
// KVH 4, D 128, striped offsets (1, 0, 4): 2,098,176 unmasked pairs) the
// two products are 4 D H B pairs = 34.4 GFLOP, 0.035 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against ~93 MB of q/k/v reads plus the f32 carry
// read and written (0.028 ms at 3.35 TB/s).
//
// The design is flash_fwd.cu's (hopper.cuh holds the wgmma and cp.async
// building blocks):
// - one CTA per (q-tile, KV head, batch), heaviest causal q-tiles first;
//   the q-tile's `group` query heads are flattened into one 128-row panel,
//   slot-major (row = slot * group + head), so each K/V tile is read once
//   for 128 / group slots of every head of the group;
// - two warpgroups of 64 panel rows each; Q is loaded once, K/V tiles of
//   64 keys stream through a 2-stage cp.async ring in wgmma's
//   128-byte-swizzled layout; S = Q K^T with wgmma, the online softmax on
//   the accumulator in registers (quad shuffles), P packed to bf16 in
//   registers and O += P V with P as the register operand. Nothing goes
//   through shared memory but the operands;
// - the carry never enters shared memory (staging its f32 rows would cost
//   64 KB and the second CTA per SM): the running max starts at the
//   carry's m, the accumulator and the row sum at 0, and the epilogue
//   folds the carry in, o' = o e^{m-m'} + acc, l' = l e^{m-m'} + l_acc,
//   the grouping `_merge_ref` uses. An accumulator register pair sits at
//   (row, 8i + 2(lane % 4)) and the carry is [B,H,Tq,D], so a quad reads
//   and writes 32 contiguous bytes of a row: whole sectors;
// - masks compare global positions (off + stride * slot) in int32: the key
//   loop stops at the first tile wholly past the panel's last position, a
//   tile wholly at or before the panel's first position runs unmasked, and
//   only tiles that straddle the diagonal or the ragged Tk end are masked
//   (rows past Tq are zero-filled and never written back), so any lengths
//   work. A CTA that runs no tile (a wholly future block) copies its carry
//   rows as they are, bit-equal;
// - 128 registers a thread and 97 KB of shared memory, so two CTAs share
//   an SM: one's softmax runs while the other's products are on the
//   tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wide.cuh"
#include "hopper.cuh"
#include "smem_once.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;      // head dim; any multiple above it: flash_wide.cuh
constexpr int ROWS = 128;   // flattened q-slot x group panel rows
constexpr int BK = 64;      // keys per tile
constexpr int NT = 256;     // two warpgroups, 64 panel rows each
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int Q_ELEMS = ROWS * D;
constexpr int KV_ELEMS = BK * D;
// Q, then two stages of (K, V); 1024 bytes of slack to align the base.
constexpr size_t SMEM_BYTES = 1024 + 2 * ((size_t)Q_ELEMS + 4 * (size_t)KV_ELEMS);

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(NT, 2)
flash_merge_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ o_in,
                   const float* __restrict__ l_in, const float* __restrict__ m_in,
                   float* __restrict__ o_out, float* __restrict__ l_out,
                   float* __restrict__ m_out, int Tq, int Tk, int H, int KVH, int group,
                   int causal, int q_off, int k_off, int stride, float scale) {
  extern __shared__ unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* sKV = sQ + Q_ELEMS;  // stage s: K at sKV + 2 s KV_ELEMS, V after it

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int blk_q = ROWS / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * blk_q;  // heaviest first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;

  // Key tiles up to the causal limit: the last query position in the panel.
  const int q_lo = q_off + stride * q0;
  const int q_hi = q_off + stride * (min(q0 + blk_q, Tq) - 1);
  int n_tiles = (Tk + BK - 1) / BK;
  if (causal)
    while (n_tiles > 0 && k_off + stride * (n_tiles - 1) * BK > q_hi) --n_tiles;

  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * BK;
    auto row = [&](const bf16* base) {
      return [=](int j) -> const bf16* {
        const int t = k0 + j;
        return t < Tk ? base + (((size_t)b * Tk + t) * KVH + kvh) * D : nullptr;
      };
    };
    bf16* dst = sKV + 2 * st * KV_ELEMS;
    load_tile<BK, NT>(dst, tid, row(k), k);
    load_tile<BK, NT>(dst + KV_ELEMS, tid, row(v), v);
  };
  if (n_tiles > 0) {
    load_tile<ROWS, NT>(sQ, tid, [&](int r) -> const bf16* {
      const int t = q0 + r / group;
      return t < Tq ? q + (((size_t)b * Tq + t) * H + kvh * group + r % group) * D : nullptr;
    }, q);
    load_kv(0, 0);
  }
  cp_async_commit();

  // This thread's two panel rows (accumulator rows l/4 and l/4 + 8 of its
  // warp's 16), their carry rows ([B,H,Tq] index; a row past Tq borrows
  // row Tq - 1's, and is never written) and their query positions.
  const int r_a = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int r_b = r_a + 8;
  const int t_a = q0 + r_a / group, t_b = q0 + r_b / group;
  auto carry_row = [&](int r, int t) {
    return ((size_t)b * H + kvh * group + r % group) * Tq + min(t, Tq - 1);
  };
  const int qpos_a = q_off + stride * min(t_a, Tq - 1);
  const int qpos_b = q_off + stride * min(t_b, Tq - 1);
  const float c = scale * LOG2E;
  const int col0 = 2 * (lane & 3);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // Running max in natural-log units, seeded from the carry; the row sum
  // of this launch's keys only (the carry's l joins in the epilogue).
  float m_a = m_in[carry_row(r_a, t_a)], m_b = m_in[carry_row(r_b, t_b)];
  float l_a = 0.f, l_b = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) load_kv(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q) landed for this thread's copies
    fence_proxy_async();
    __syncthreads();     // ... and for every thread's
    const bf16* sK = sKV + 2 * st * KV_ELEMS;
    const bf16* sV = sK + KV_ELEMS;
    const int k0 = kt * BK;

    float s[32];
    wgmma_fence();
    gemm_nt_64x64<D>(s, sQ + wg * 64 * HALF_COLS, ROWS, sK, BK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Masked entries become -inf here (for the row max) and take
    // e^{NEG_INF - m} below, which is 1 for a row that has seen no key.
    const bool masked = k0 + BK > Tk || (causal && k_off + stride * (k0 + BK - 1) > q_lo);
    if (masked) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = k0 + 8 * i + col0 + e;
          const bool out = j >= Tk;
          if (out || (causal && k_off + stride * j > qpos_a)) s[4 * i + e] = -INFINITY;
          if (out || (causal && k_off + stride * j > qpos_b)) s[4 * i + 2 + e] = -INFINITY;
        }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * i], s[4 * i + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    const float mn_a = fmaxf(m_a, mx_a == -INFINITY ? NEG_INF : mx_a * scale);
    const float mn_b = fmaxf(m_b, mx_b == -INFINITY ? NEG_INF : mx_b * scale);
    const float alpha_a = exp2f((m_a - mn_a) * LOG2E);
    const float alpha_b = exp2f((m_b - mn_b) * LOG2E);
    m_a = mn_a;
    m_b = mn_b;
    const float ml_a = mn_a * LOG2E, ml_b = mn_b * LOG2E;
    const float dead_a = exp2f((NEG_INF - mn_a) * LOG2E);
    const float dead_b = exp2f((NEG_INF - mn_b) * LOG2E);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& pa = s[4 * i + e];
        float& pb = s[4 * i + 2 + e];
        pa = (masked && pa == -INFINITY) ? dead_a : exp2f(fmaf(pa, c, -ml_a));
        pb = (masked && pb == -INFINITY) ? dead_b : exp2f(fmaf(pb, c, -ml_b));
        sum_a += pa;
        sum_b += pb;
      }
    l_a = l_a * alpha_a + quad_sum(sum_a);
    l_b = l_b * alpha_b + quad_sum(sum_b);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      acc[4 * i] *= alpha_a;
      acc[4 * i + 1] *= alpha_a;
      acc[4 * i + 2] *= alpha_b;
      acc[4 * i + 3] *= alpha_b;
    }
    uint32_t p[16];
    pack_scores(p, s);

    wgmma_fence();
    gemm_rs_64xN<D>(acc, p, sV, BK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warpgroup is done with stage st
  }

  // Fold the carry in: o' = o e^{m - m'} + acc, l' = l e^{m - m'} + l_acc.
  // A CTA that ran no tile copies the carry (o * 1 + 0 would turn -0 into
  // +0).
  const bool ran = n_tiles > 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = half ? t_b : t_a;
    if (t >= Tq) continue;
    const size_t row = carry_row(half ? r_b : r_a, t);
    const float m = half ? m_b : m_a;
    const float alpha = exp2f((m_in[row] - m) * LOG2E);
    const float* src = o_in + row * D + col0;
    float* dst = o_out + row * D + col0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 x = *reinterpret_cast<const float2*>(src + 8 * i);
      const int a = 4 * i + 2 * half;
      *reinterpret_cast<float2*>(dst + 8 * i) =
          ran ? make_float2(fmaf(x.x, alpha, acc[a]), fmaf(x.y, alpha, acc[a + 1])) : x;
    }
    if ((lane & 3) == 0) {
      const float l = l_in[row];
      l_out[row] = ran ? fmaf(l, alpha, half ? l_b : l_a) : l;
      m_out[row] = m;  // the carry's m where no tile ran
    }
  }
}

// Head dims above 128, any multiple of 256: flash_wide.cuh's cluster
// design in its merge form (a grid axis over 256-column blocks of the
// carry's o; a cluster of column blocks computes each score tile once and
// exchanges it through distributed shared memory; block 0 writes l and
// m).
__global__ void __launch_bounds__(wide::NT, 1) flash_merge_wide_kernel(wide::Args a) {
  wide::attend_cluster<true>(a);
}

}  // namespace

// C entry point (bound with ctypes); head_dim 128 or a multiple of 256
// above it (the wide kernel's column block). Reads the carry (o_in, l_in,
// m_in) and writes the merged one to (o_out, l_out, m_out), which must not
// overlap it. Launches on `stream`; returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int flash_merge_bf16(const void* q, const void* k, const void* v, const void* o_in,
                                const void* l_in, const void* m_in, void* o_out, void* l_out,
                                void* m_out, int B, int Tq, int Tk, int H, int KVH,
                                int head_dim, int causal, int q_off, int k_off, int stride,
                                float scale, void* stream) {
  if (head_dim < D || (head_dim > D && head_dim % wide::C_CD != 0) || B <= 0 || Tq <= 0 ||
      Tk <= 0 || KVH <= 0 || H % KVH != 0 || ROWS % (H / KVH) != 0 || stride <= 0)
    return (int)cudaErrorInvalidValue;
  if (head_dim > D) {
    cudaError_t err = set_smem_once<flash_merge_wide_kernel>(wide::CLUSTER_SMEM_BYTES, true);
    if (err != cudaSuccess) return (int)err;
    const int nb = head_dim / wide::C_CD;
    wide::Args a{(const bf16*)q,      (const bf16*)k,      (const bf16*)v,
                 (const float*)o_in,  (const float*)l_in,  (const float*)m_in,
                 o_out,               (float*)l_out,       (float*)m_out,
                 Tq, Tk, H, KVH, H / KVH, nb, causal, q_off, k_off, stride, scale};
    ClusterLaunch l(wide::grid(Tq, KVH, nb, B, H / KVH), wide::NT, wide::CLUSTER_SMEM_BYTES,
                    wide_cluster_size(nb), (cudaStream_t)stream);
    err = cudaLaunchKernelEx(&l.cfg, flash_merge_wide_kernel, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  cudaError_t err = set_smem_once<flash_merge_kernel>(SMEM_BYTES, true);
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

// The wide merge kernel's cluster at `head_dim` (a multiple of 256): its
// size and the most such clusters the device holds at once.
extern "C" int flash_merge_wide_cluster(int head_dim, int* cluster_size, int* max_clusters) {
  if (head_dim <= D || head_dim % wide::C_CD != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_once<flash_merge_wide_kernel>(wide::CLUSTER_SMEM_BYTES, true);
  if (err != cudaSuccess) return (int)err;
  const int cs = wide_cluster_size(head_dim / wide::C_CD);
  *cluster_size = cs;
  return (int)max_active_clusters(flash_merge_wide_kernel, wide::NT, wide::CLUSTER_SMEM_BYTES,
                                  cs, max_clusters);
}
