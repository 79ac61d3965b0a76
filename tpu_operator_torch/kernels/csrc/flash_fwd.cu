// Fused flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces: tpu_operator/payload/flash_attention.py `_fwd_kernel` (launched
// by `_flash_fwd_pallas`), the TPU kernel behind `flash_attention`. It is
// the serve path's prefill attention (one launch per layer per admission)
// and the training forward (one launch per layer per microbatch).
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
// L = 0 (the TPU kernel's `valid` guard). P is rounded to bf16 before P V,
// as in the TPU kernel; l sums the f32 P.
//
// What bounds it on an H100: operations. At the training shape (B 8,
// T 2048, H 16, KVH 4, D 128, causal) the two products are 4 D B H T(T+1)/2
// = 137.5 GFLOP, 0.139 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against ~50 MB of q/k/v/O/L traffic (0.015 ms at 3.35 TB/s).
//
// The design (hopper.cuh holds the wgmma and cp.async building blocks):
// - one CTA per (q-tile, KV head, batch), heaviest causal q-tiles first;
//   the q-tile's `group` query heads are flattened into one 128-row panel,
//   slot-major (row = slot * group + head), so each K/V tile is read once
//   for 128 / group positions of every head of the group;
// - two warpgroups of 64 panel rows each; Q is loaded once, K/V tiles of
//   64 keys stream through a 2-stage shared-memory ring of cp.async copies
//   in wgmma's 128-byte-swizzled layout: tile kt + 1 is in flight while
//   tile kt is multiplied;
// - S = Q K^T with wgmma (both operands K-major in shared memory); the
//   online softmax runs on the accumulator in registers (a row's entries
//   sit in one quad of threads: two shuffles for its max and its sum;
//   exp2 with scale * log2(e) folded into one FMA); P is packed to bf16 in
//   registers and O += P V runs with A = P from registers and V
//   MN-major from shared memory; O stays in registers;
// - causal tiles wholly beyond the q-tile are never loaded; the mask runs
//   only on tiles that straddle the diagonal or the ragged end (rows and
//   keys past T are zero-filled by the copies), so any T works.
// Loads are issued by the same warps that compute (no producer warp, no
// TMA), and both warpgroups meet at a barrier per tile. The kernel is held
// to 128 registers a thread (ptxas spills nothing) and 97 KB of shared
// memory, so two CTAs share an SM: one's softmax runs while the other's
// products are on the tensor cores (one CTA per SM, at 136 registers, was
// slower at the training shape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "smem_once.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;      // head dim (the wrapper checks it)
constexpr int ROWS = 128;   // flattened q-slot x group panel rows
constexpr int BK = 64;      // keys per tile
constexpr int NT = 256;     // two warpgroups, 64 panel rows each
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int H, int KVH, int group,
                 int causal, float scale) {
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

  load_tile<ROWS, NT>(sQ, tid, [&](int r) -> const bf16* {
    const int t = q0 + r / group;
    return t < T ? q + (((size_t)b * T + t) * H + kvh * group + r % group) * D : nullptr;
  }, q);
  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * BK;
    auto row = [&](const bf16* base) {
      return [=](int j) -> const bf16* {
        const int t = k0 + j;
        return t < T ? base + (((size_t)b * T + t) * KVH + kvh) * D : nullptr;
      };
    };
    bf16* dst = sKV + 2 * st * KV_ELEMS;
    load_tile<BK, NT>(dst, tid, row(k), k);
    load_tile<BK, NT>(dst + KV_ELEMS, tid, row(v), v);
  };

  const int q_last = min(q0 + blk_q, T) - 1;
  const int kv_end = causal ? q_last + 1 : T;
  const int n_tiles = (kv_end + BK - 1) / BK;
  load_kv(0, 0);
  cp_async_commit();

  // This thread's two panel rows (accumulator rows l/4 and l/4 + 8 of its
  // warp's 16) and their query positions.
  const int r_a = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int r_b = r_a + 8;
  const int qpos_a = q0 + r_a / group;
  const int qpos_b = q0 + r_b / group;
  const float c = scale * LOG2E;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;  // m in log2 units

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
    gemm_nt_64x64x128(s, sQ + wg * 64 * HALF_COLS, ROWS, sK, BK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Masked entries become -inf here (for the row max) and take
    // exp2(NEG_INF - m) below, which is 1 for a row that has seen no key.
    const bool masked = k0 + BK > T || (causal && k0 + BK - 1 > q0);
    if (masked) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * i + 2 * (lane & 3) + e;
          if (kpos >= T || (causal && kpos > qpos_a)) s[4 * i + e] = -INFINITY;
          if (kpos >= T || (causal && kpos > qpos_b)) s[4 * i + 2 + e] = -INFINITY;
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
    const float mn_a = fmaxf(m_a, mx_a == -INFINITY ? NEG_INF : mx_a * c);
    const float mn_b = fmaxf(m_b, mx_b == -INFINITY ? NEG_INF : mx_b * c);
    const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    const float dead_a = exp2f(NEG_INF - mn_a), dead_b = exp2f(NEG_INF - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& pa = s[4 * i + e];
        float& pb = s[4 * i + 2 + e];
        pa = (masked && pa == -INFINITY) ? dead_a : exp2f(fmaf(pa, c, -mn_a));
        pb = (masked && pb == -INFINITY) ? dead_b : exp2f(fmaf(pb, c, -mn_b));
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
    gemm_rs_64x128x64(acc, p, sV, BK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warpgroup is done with stage st
  }

  // Emit: O = acc / l (0 for a row that saw no key), L = m + log l.
  const int col0 = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r_b : r_a;
    const int t = half ? qpos_b : qpos_a;
    if (t >= T) continue;
    const float m = half ? m_b : m_a;
    const float l = half ? l_b : l_a;
    const bool valid = m > NEG_INF / 2;
    const float inv = valid ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    const int h = kvh * group + r % group;
    bf16* orow = o + (((size_t)b * T + t) * H + h) * D;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + col0) =
          __floats2bfloat162_rn(acc[4 * i + 2 * half] * inv, acc[4 * i + 2 * half + 1] * inv);
    if ((lane & 3) == 0)
      lse[((size_t)b * H + h) * T + t] = valid ? m * LN2 + logf(fmaxf(l, 1e-30f)) : 0.f;
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
  cudaError_t err = set_smem_once<flash_fwd_kernel>(SMEM_BYTES, true);
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
