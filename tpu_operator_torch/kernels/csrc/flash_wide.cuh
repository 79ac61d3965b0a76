// The wide-head forward shared by flash_fwd.cu (K1) and flash_merge.cu
// (K4): attention at any head dim D = nc x 128 above 128.
//
// Two limits fall above D 128 for the narrow kernels' design: a 64 x D f32
// output accumulator per warpgroup no longer fits in registers (256 KB at
// D 1024), and a Q tile plus a K tile of D columns no longer fit in shared
// memory (256 KB at D 1024). So the head dim is cut into nc chunks of 128
// columns:
// - the grid gains an axis over the nc column blocks of the output
//   (blockIdx.y = KV head x nc + column block cb); each CTA keeps the f32
//   accumulator of its own 128 columns only;
// - every CTA computes the full scores, S = sum_c Q_c K_c^T, by streaming
//   the (Q_c, K_c) chunk pairs of each key tile through a 2-stage cp.async
//   ring (gemm_nt_64x64_chunk adds each chunk's product into S), the chunk
//   order rotated so that chunk cb comes last; the last step of a key tile
//   also brings V's column block cb, and runs the online softmax and
//   O_cb += P V_cb exactly as the narrow kernels do;
// - the row statistics (m, l; L for K1, the carry's l and m for K4) are
//   the same in every column block, and only block 0 writes them.
// This recomputes Q K^T nc times: at D 1024 the kernel does 8 / 9 of its
// products on scores one block would share. A design that shares S across
// the column blocks (through shared memory or a cluster) is the redesign
// ROADMAP Queue B lists.
//
// Layouts are the narrow kernels': q [B,Tq,H,D], k/v [B,Tk,KVH,D] bf16;
// K1 writes O [B,Tq,H,D] bf16 and L [B,H,Tq] f32; K4 reads the carry o
// [B,H,Tq,D], l, m [B,H,Tq] f32 and writes a new one. Masking, offsets
// and the NEG_INF conventions are flash_merge.cu's; K1 runs at offsets
// (0, 0, 1).

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {
namespace wide {

typedef __nv_bfloat16 bf16;

constexpr int CD = 128;     // head-dim columns of one chunk
constexpr int ROWS = 128;   // flattened q-slot x group panel rows
constexpr int BK = 64;      // keys per tile
constexpr int NT = 256;     // two warpgroups, 64 panel rows each
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int Q_ELEMS = ROWS * CD;
constexpr int KV_ELEMS = BK * CD;
// One stage: Q_c, K_c and (on a key tile's last step) V_cb.
constexpr int STAGE_ELEMS = Q_ELEMS + 2 * KV_ELEMS;
// Two stages; 1024 bytes of slack to align the base.
constexpr size_t SMEM_BYTES = 1024 + 2 * 2 * (size_t)STAGE_ELEMS;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* o_in;  // K4: the carry read (null for K1)
  const float* l_in;
  const float* m_in;
  void* o;            // K1: O bf16 [B,Tq,H,D]; K4: o' f32 [B,H,Tq,D]
  float* l;           // K1: L [B,H,Tq]; K4: l'
  float* m;           // K4: m' (null for K1)
  int Tq, Tk, H, KVH, group, nc, causal, q_off, k_off, stride;
  float scale;
};

// One CTA per (q-tile, KV head x column block, batch), NT threads.
template <bool MERGE>
__device__ __forceinline__ void attend(const Args& a) {
  extern __shared__ unsigned char smem_raw[];
  bf16* base =
      reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int Tq = a.Tq, Tk = a.Tk, H = a.H, KVH = a.KVH, group = a.group, nc = a.nc;
  const int q_off = a.q_off, k_off = a.k_off, stride = a.stride, causal = a.causal;
  const int D = nc * CD;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int blk_q = ROWS / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * blk_q;  // heaviest first
  const int kvh = blockIdx.y / nc;
  const int cb = blockIdx.y - kvh * nc;
  const int b = blockIdx.z;
  const bf16* q = a.q;
  const bf16* k = a.k;
  const bf16* v = a.v;

  // Key tiles up to the causal limit: the last query position in the panel.
  const int q_lo = q_off + stride * q0;
  const int q_hi = q_off + stride * (min(q0 + blk_q, Tq) - 1);
  int n_tiles = (Tk + BK - 1) / BK;
  if (causal)
    while (n_tiles > 0 && k_off + stride * (n_tiles - 1) * BK > q_hi) --n_tiles;
  const int steps = n_tiles * nc;

  // Step j: key tile j / nc, chunk (cb + 1 + j % nc) % nc (cb last), into
  // stage j & 1; the tile's last step also loads V's column block cb.
  auto load_step = [&](int j) {
    const int kt = j / nc, i = j - kt * nc;
    const int col = ((cb + 1 + i) % nc) * CD;
    bf16* sQ = base + (j & 1) * STAGE_ELEMS;
    bf16* sK = sQ + Q_ELEMS;
    load_tile<ROWS, NT>(sQ, tid, [&](int r) -> const bf16* {
      const int t = q0 + r / group;
      return t < Tq ? q + (((size_t)b * Tq + t) * H + kvh * group + r % group) * D + col
                    : nullptr;
    }, q);
    const int k0 = kt * BK;
    auto key_row = [&](const bf16* src, int c0) {
      return [=](int r) -> const bf16* {
        const int t = k0 + r;
        return t < Tk ? src + (((size_t)b * Tk + t) * KVH + kvh) * D + c0 : nullptr;
      };
    };
    load_tile<BK, NT>(sK, tid, key_row(k, col), k);
    if (i == nc - 1) load_tile<BK, NT>(sK + KV_ELEMS, tid, key_row(v, cb * CD), v);
  };
  if (steps > 0) load_step(0);
  cp_async_commit();

  // This thread's two panel rows (accumulator rows l/4 and l/4 + 8 of its
  // warp's 16), their [B,H,Tq] rows (a row past Tq borrows row Tq - 1's
  // and is never written) and their query positions.
  const int r_a = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int r_b = r_a + 8;
  const int t_a = q0 + r_a / group, t_b = q0 + r_b / group;
  auto stat_row = [&](int r, int t) {
    return ((size_t)b * H + kvh * group + r % group) * Tq + min(t, Tq - 1);
  };
  const int qpos_a = q_off + stride * min(t_a, Tq - 1);
  const int qpos_b = q_off + stride * min(t_b, Tq - 1);
  const float scale = a.scale;
  const float c = scale * LOG2E;
  const int col0 = 2 * (lane & 3);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // Running max in natural-log units (K4: seeded from the carry); the row
  // sum of this launch's keys only (K4's carry l joins in the epilogue).
  float m_a = MERGE ? a.m_in[stat_row(r_a, t_a)] : NEG_INF;
  float m_b = MERGE ? a.m_in[stat_row(r_b, t_b)] : NEG_INF;
  float l_a = 0.f, l_b = 0.f;
  float s[32];

  for (int j = 0; j < steps; ++j) {
    const int st = j & 1;
    if (j + 1 < steps) load_step(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // step j landed for this thread's copies
    fence_proxy_async();
    __syncthreads();     // ... and for every thread's
    const bf16* sQ = base + st * STAGE_ELEMS;
    const bf16* sK = sQ + Q_ELEMS;
    const bf16* sV = sK + KV_ELEMS;
    const int kt = j / nc, i = j - kt * nc;

    wgmma_fence();
    gemm_nt_64x64_chunk(s, sQ + wg * 64 * HALF_COLS, ROWS, sK, BK, i > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    if (i == nc - 1) {
      // S is whole: flash_merge.cu's online softmax and O += P V on
      // column block cb.
      const int k0 = kt * BK;
      const bool masked =
          k0 + BK > Tk || (causal && k_off + stride * (k0 + BK - 1) > q_lo);
      if (masked) {
#pragma unroll
        for (int x = 0; x < 8; ++x)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jj = k0 + 8 * x + col0 + e;
            const bool out = jj >= Tk;
            if (out || (causal && k_off + stride * jj > qpos_a)) s[4 * x + e] = -INFINITY;
            if (out || (causal && k_off + stride * jj > qpos_b)) s[4 * x + 2 + e] = -INFINITY;
          }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * x], s[4 * x + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * x + 2], s[4 * x + 3]));
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
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& pa = s[4 * x + e];
          float& pb = s[4 * x + 2 + e];
          pa = (masked && pa == -INFINITY) ? dead_a : exp2f(fmaf(pa, c, -ml_a));
          pb = (masked && pb == -INFINITY) ? dead_b : exp2f(fmaf(pb, c, -ml_b));
          sum_a += pa;
          sum_b += pb;
        }
      l_a = l_a * alpha_a + quad_sum(sum_a);
      l_b = l_b * alpha_b + quad_sum(sum_b);
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        acc[4 * x] *= alpha_a;
        acc[4 * x + 1] *= alpha_a;
        acc[4 * x + 2] *= alpha_b;
        acc[4 * x + 3] *= alpha_b;
      }
      uint32_t p[16];
      pack_scores(p, s);

      wgmma_fence();
      gemm_rs_64xN<CD>(acc, p, sV, BK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();  // every warpgroup is done with stage st
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = half ? t_b : t_a;
    if (t >= Tq) continue;
    const int r = half ? r_b : r_a;
    const size_t row = stat_row(r, t);
    const float m = half ? m_b : m_a;
    const float l = half ? l_b : l_a;
    if constexpr (MERGE) {
      // Fold the carry in: o' = o e^{m - m'} + acc, l' = l e^{m - m'} + l_acc;
      // a CTA that ran no tile copies the carry.
      const bool ran = n_tiles > 0;
      const float alpha = exp2f((a.m_in[row] - m) * LOG2E);
      const float* src = a.o_in + row * D + cb * CD + col0;
      float* dst = reinterpret_cast<float*>(a.o) + row * D + cb * CD + col0;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const float2 y = *reinterpret_cast<const float2*>(src + 8 * x);
        const int ai = 4 * x + 2 * half;
        *reinterpret_cast<float2*>(dst + 8 * x) =
            ran ? make_float2(fmaf(y.x, alpha, acc[ai]), fmaf(y.y, alpha, acc[ai + 1])) : y;
      }
      if (cb == 0 && (lane & 3) == 0) {
        const float lc = a.l_in[row];
        a.l[row] = ran ? fmaf(lc, alpha, l) : lc;
        a.m[row] = m;
      }
    } else {
      // O = acc / l (0 for a row that saw no key), L = m + log l.
      const bool valid = m > NEG_INF / 2;
      const float inv = valid ? 1.f / fmaxf(l, 1e-30f) : 0.f;
      const int h = kvh * group + r % group;
      bf16* orow = reinterpret_cast<bf16*>(a.o) + (((size_t)b * Tq + t) * H + h) * D + cb * CD;
#pragma unroll
      for (int x = 0; x < 16; ++x)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * x + col0) = __floats2bfloat162_rn(
            acc[4 * x + 2 * half] * inv, acc[4 * x + 2 * half + 1] * inv);
      if (cb == 0 && (lane & 3) == 0) a.l[row] = valid ? m + logf(fmaxf(l, 1e-30f)) : 0.f;
    }
  }
}

inline dim3 grid(int Tq, int KVH, int nc, int B, int group) {
  const int blk_q = ROWS / group;
  return dim3((Tq + blk_q - 1) / blk_q, KVH * nc, B);
}

}  // namespace wide
}  // namespace
