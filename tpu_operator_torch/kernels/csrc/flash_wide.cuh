// The wide-head forward of flash_fwd.cu (K1) and flash_merge.cu (K4):
// attention at head dims above 128.
//
// Two limits fall above D 128 for the narrow kernels' design: a 64 x D f32
// output accumulator per warpgroup no longer fits in registers (256 KB at
// D 1024), and a Q tile plus a K tile of D columns no longer fit in shared
// memory (256 KB at D 1024). So the grid gains an axis over column blocks
// of the output (blockIdx.y = KV head x blocks + block cb); each CTA keeps
// the f32 accumulator of its own block only. The scores S = sum_c Q_c K_c^T
// span every block.
//
// K1 and K4 are one kernel body, attend_cluster<MERGE>, which computes
// each score tile once per thread-block cluster. Its CTAs own 256-column
// blocks of the output (two 128-column f32 accumulators a thread; the
// wrapper pads D to a multiple of 256), nb = D / 256 of them, and a
// cluster is cs = wide_cluster_size(nb) consecutive blocks of one
// (q-panel, KV head, batch) (cs = nb up to D 2048). Rank r of a cluster
// sums the m = nb / cs blocks r, r + cs, ... of the head dim into a
// partial S_r (128 x 64 f32); its Q block is resident when m = 1 and
// streamed through the same slot otherwise. Per 64-key tile:
// - S_r = Q_r K_r^T runs on wgmma; K's block streams through a 2-stage
//   cp.async ring, each step's copy issued once the previous product is
//   done, so it overlaps the exchange below; V_cb's block is one buffer,
//   its copy issued after the previous tile's P V;
// - S_r goes to shared memory, and after a cluster barrier rank r reduces
//   its 1/cs of the rows over every rank's partial through distributed
//   shared memory (in rank order: at m = 1 in block order, so every
//   column block of the panel holds a bit-identical S), runs the online
//   softmax on them (masks, running max, the rescale alpha, P in f32 and
//   the row sum), keeps their m and l, and stores P in bf16 and m, l,
//   alpha into every rank's shared memory (a reduce-scatter, then an
//   all-gather: 24 + 12 KB per CTA and tile at cs 4, for 256 output
//   columns; the exchange is what bounds the kernel (PERF.md), so a block
//   is 256 columns wide and not 128);
// - after a second cluster barrier each rank rescales its O_cb by alpha
//   and adds P V_cb (P read back as wgmma register fragments).
// The second barrier also frees each partial for the next tile (every
// reader has passed it), and P, alpha are read into registers before the
// next tile's first barrier, so one buffer of each suffices.
//
// K1 (MERGE false) starts every row at m = NEG_INF, l = 0 and runs at
// offsets (0, 0, 1); block 0 writes L from the all-gathered m and l, and
// the epilogue is the narrow K1's. K4 (MERGE true) is the ring's merge:
// it takes offsets and a stride, seeds each row's running max from the
// carry's m (the accumulators and the row sum start at 0), and its
// epilogue folds the carry in, o' = o e^{m - m'} + acc and
// l' = l e^{m - m'} + l_acc in f32, unnormalised (flash_merge.cu's
// contract and `_merge_ref`'s grouping); block 0 writes l' and m'. A row
// that ends the block at m = NEG_INF (no key yet; a CTA that ran no tile
// too) writes its carry back as it was, bit-equal.
//
// Layouts are the narrow kernels': q [B,Tq,H,D], k/v [B,Tk,KVH,D] bf16;
// K1 writes O [B,Tq,H,D] bf16 and L [B,H,Tq] f32; K4 reads the carry o
// [B,H,Tq,D], l, m [B,H,Tq] f32 and writes a new one. Masking, offsets
// and the NEG_INF conventions are flash_merge.cu's.

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
// A CTA owns a 256-column block of the output (two 128-column
// accumulators a thread), so a score tile exchanged serves twice the
// output columns of a 128-column block (half the cluster traffic per
// product). Shared memory (from the aligned base; 1024 bytes of slack to
// align it): the Q slot (Q's block, resident when m = 1, else the
// step's), two stages of K's block, V's block, the partial S [ROWS][BK]
// f32, P [ROWS][BK] bf16, the rows' m, l and alpha.
constexpr int C_CD = 2 * CD;
constexpr int C_Q_ELEMS = ROWS * C_CD;
constexpr int C_KV_ELEMS = BK * C_CD;
constexpr size_t CLUSTER_SMEM_BYTES = 1024 + 2 * ((size_t)C_Q_ELEMS + 3 * C_KV_ELEMS) +
                                      4 * ROWS * BK + 2 * ROWS * BK + 3 * 4 * ROWS;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Over the 16 lanes that hold one row of the reduction.
__device__ __forceinline__ float row16_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row16_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

// One CTA per (q-tile, KV head x 256-column block, batch), NT threads, in
// clusters of wide_cluster_size(nb) CTAs along y (nb = D / 256); K1
// (MERGE false) or K4 (MERGE true).
template <bool MERGE>
__device__ __forceinline__ void attend_cluster(const Args& a) {
  extern __shared__ unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* sKring = sQ + C_Q_ELEMS;           // stage s: K_c at s C_KV_ELEMS
  bf16* sV = sKring + 2 * C_KV_ELEMS;
  float* sPart = reinterpret_cast<float*>(sV + C_KV_ELEMS);
  bf16* sP = reinterpret_cast<bf16*>(sPart + ROWS * BK);
  float* sM = reinterpret_cast<float*>(sP + ROWS * BK);  // the rows' running max
  float* sL = sM + ROWS;                                 // ... row sum
  float* sAlpha = sL + ROWS;                             // ... this tile's rescale

  const int Tq = a.Tq, Tk = a.Tk, H = a.H, KVH = a.KVH, group = a.group;
  const int q_off = a.q_off, k_off = a.k_off, stride = a.stride, causal = a.causal;
  const int nb = a.nc;  // 256-column blocks of the head dim
  const int D = nb * C_CD;
  const int cs = wide_cluster_size(nb), mch = nb / cs;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int blk_q = ROWS / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * blk_q;  // heaviest first
  const int kvh = blockIdx.y / nb;
  const int cb = blockIdx.y - kvh * nb;
  const int rank = cb % cs;  // cs divides nb: the cluster's rank of this CTA
  const int b = blockIdx.z;
  const bf16* q = a.q;
  const bf16* k = a.k;
  const bf16* v = a.v;

  // Key tiles up to the causal limit: the last query position in the panel
  // (the same in every CTA of the cluster).
  const int q_hi = q_off + stride * (min(q0 + blk_q, Tq) - 1);
  int n_tiles = (Tk + BK - 1) / BK;
  if (causal)
    while (n_tiles > 0 && k_off + stride * (n_tiles - 1) * BK > q_hi) --n_tiles;
  const int steps = n_tiles * mch;

  auto q_row = [&](int c0) {
    return [=](int r) -> const bf16* {
      const int t = q0 + r / group;
      return t < Tq ? q + (((size_t)b * Tq + t) * H + kvh * group + r % group) * D + c0
                    : nullptr;
    };
  };
  auto key_row = [&](const bf16* src, int k0, int c0) {
    return [=](int r) -> const bf16* {
      const int t = k0 + r;
      return t < Tk ? src + (((size_t)b * Tk + t) * KVH + kvh) * D + c0 : nullptr;
    };
  };
  // A 256-column block is two 128-column tiles.
  auto load_q = [&](int c0) {
    load_tile<ROWS, NT>(sQ, tid, q_row(c0), q);
    load_tile<ROWS, NT>(sQ + Q_ELEMS, tid, q_row(c0 + CD), q);
  };
  auto load_kv = [&](bf16* dst, const bf16* src, int k0, int c0) {
    load_tile<BK, NT>(dst, tid, key_row(src, k0, c0), src);
    load_tile<BK, NT>(dst + KV_ELEMS, tid, key_row(src, k0, c0 + CD), src);
  };
  // Step j: key tile j / m, block rank + cs (j % m) of the head dim (the
  // same order in every cluster): K's block into stage j & 1 and, when Q is
  // not resident (m > 1), Q's into the Q slot.
  auto load_step = [&](int j) {
    const int kt = j / mch, i = j - kt * mch;
    const int col = (rank + cs * i) * C_CD;
    load_kv(sKring + (j & 1) * C_KV_ELEMS, k, kt * BK, col);
    if (mch > 1) load_q(col);
  };
  // Copy groups: step j's (K, and Q when m > 1) after step j - 1's product;
  // V_cb of a tile after the previous tile's P V. Group order: Q (m = 1)
  // and step 0, then V of tile 0.
  if (mch == 1) load_q(cb * C_CD);
  if (steps > 0) load_step(0);
  cp_async_commit();
  if (steps > 0) load_kv(sV, v, 0, cb * C_CD);
  cp_async_commit();

  // Panel row r's [B,H,Tq] row (a row past Tq borrows row Tq - 1's and
  // is never written).
  auto stat_row = [&](int r) {
    return ((size_t)b * H + kvh * group + r % group) * Tq + min(q0 + r / group, Tq - 1);
  };
  // The rows' running max (K4: the carry's) and sum. With a cluster of one
  // (cs 1) no partial travels, and its buffer holds them instead, two
  // copies (tile kt reads copy kt & 1 and writes the other).
  float* sStat1 = sPart;
  for (int r = tid; r < 2 * ROWS; r += NT) {
    const float m0 = MERGE ? a.m_in[stat_row(r % ROWS)] : NEG_INF;
    if (r < ROWS) {
      sM[r] = m0;
      sL[r] = 0.f;
    }
    if (cs == 1) {
      sStat1[r] = m0;
      sStat1[2 * ROWS + r] = 0.f;
    }
  }
  __syncthreads();

  // This thread's two accumulator rows.
  const int r_a = wg * 64 + warp * 16 + (lane >> 2);
  const int r_b = r_a + 8;
  const int t_a = q0 + r_a / group, t_b = q0 + r_b / group;
  const float scale = a.scale;
  const float c = scale * LOG2E;
  const int col0 = 2 * (lane & 3);

  // O_cb's two 128-column halves.
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  float s[32];

  for (int j = 0; j < steps; ++j) {
    const int kt = j / mch, i = j - kt * mch;
    // Step j landed (a tile's first step may leave its V in flight).
    if (i == 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    const bf16* sK = sKring + (j & 1) * C_KV_ELEMS;

    wgmma_fence();
    gemm_nt_64x64_chunk(s, sQ + wg * 64 * HALF_COLS, ROWS, sK, BK, i > 0);
    gemm_nt_64x64_chunk(s, sQ + Q_ELEMS + wg * 64 * HALF_COLS, ROWS, sK + KV_ELEMS, BK, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    __syncthreads();  // every warpgroup is done with the Q slot and stage j & 1
    if (j + 1 < steps) load_step(j + 1);
    cp_async_commit();

    if (i == mch - 1) {
      const int k0 = kt * BK;
      uint32_t pf[16];
      float alpha_a, alpha_b;
      if (cs == 1) {
        // One CTA holds the whole S: the narrow kernels' online softmax,
        // in registers.
        const float* cur = sStat1 + (kt & 1) * ROWS;  // m; l at + 2 ROWS
        float* nxt = sStat1 + ((kt + 1) & 1) * ROWS;
        const float m_a = cur[r_a], m_b = cur[r_b];
        const float l_a = cur[2 * ROWS + r_a], l_b = cur[2 * ROWS + r_b];
        const int q_lo = q_off + stride * q0;
        const int qpos_a = q_off + stride * min(t_a, Tq - 1);
        const int qpos_b = q_off + stride * min(t_b, Tq - 1);
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
        alpha_a = exp2f((m_a - mn_a) * LOG2E);
        alpha_b = exp2f((m_b - mn_b) * LOG2E);
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
        sum_a = l_a * alpha_a + quad_sum(sum_a);
        sum_b = l_b * alpha_b + quad_sum(sum_b);
        if ((lane & 3) == 0) {
          nxt[r_a] = mn_a;
          nxt[r_b] = mn_b;
          nxt[2 * ROWS + r_a] = sum_a;
          nxt[2 * ROWS + r_b] = sum_b;
        }
        pack_scores(pf, s);
      } else {
        // The partial is whole: publish it (its last readers passed the
        // previous tile's second barrier).
        store_scores(sPart, wg * 64, lane, warp, s);
        cluster_sync();

        // Reduce this rank's rows over the cluster and run the online
        // softmax on them; P, m, l and alpha go to every rank. The rows
        // are (row, 4-column chunk) tasks, 16 lanes a row; a warp runs
        // whole rows, so the row shuffles see every lane.
        const int lo = rank * ROWS / cs, hi = (rank + 1) * ROWS / cs;
        const int n_tasks = (hi - lo) * 16;
        const int n_iter = (n_tasks + 31) & ~31;
        for (int task = tid; task < n_iter; task += NT) {
          const bool live = task < n_tasks;
          const int row = lo + (live ? task >> 4 : 0);
          const int c4 = task & 15;
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
          if (live) sum = cluster_sum_f4(sPart + fswz(row, 4 * c4), cs);
          const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
          const int qpos = q_off + stride * min(q0 + row / group, Tq - 1);
          bool out[4];
          float mx = -INFINITY;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = k0 + 4 * c4 + e;
            out[e] = jj >= Tk || (causal && k_off + stride * jj > qpos);
            if (!out[e]) mx = fmaxf(mx, sv[e]);
          }
          mx = row16_max(mx);
          const float m_old = sM[row], l_old = sL[row];
          const float mn = fmaxf(m_old, mx == -INFINITY ? NEG_INF : mx * scale);
          const float alpha = exp2f((m_old - mn) * LOG2E);
          const float dead = exp2f((NEG_INF - mn) * LOG2E);
          const float ml = mn * LOG2E;
          float p[4], rs = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = out[e] ? dead : exp2f(fmaf(sv[e], c, -ml));
            rs += p[e];
          }
          rs = row16_sum(rs);
          if (live) {
            const uint32_t p01 = pack_bf16x2(p[0], p[1]), p23 = pack_bf16x2(p[2], p[3]);
            const bf16* dst = sP + swz(ROWS, row, 4 * c4);
            for (int r = 0; r < cs; ++r) st_dsmem_u32x2(dsmem(dst, r), p01, p23);
            if (c4 == 0) {
              const float l_new = l_old * alpha + rs;
              for (int r = 0; r < cs; ++r) {
                st_dsmem_f32(dsmem(sM + row, r), mn);
                st_dsmem_f32(dsmem(sL + row, r), l_new);
                st_dsmem_f32(dsmem(sAlpha + row, r), alpha);
              }
            }
          }
        }
        cluster_sync();
        alpha_a = sAlpha[r_a];
        alpha_b = sAlpha[r_b];
        load_fragments(pf, sP, ROWS, wg * 64, lane, warp);
      }

      // O_cb = O_cb alpha + P V_cb, once V_cb landed (the next step's
      // copies may still be in flight).
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        acc0[4 * x] *= alpha_a;
        acc0[4 * x + 1] *= alpha_a;
        acc0[4 * x + 2] *= alpha_b;
        acc0[4 * x + 3] *= alpha_b;
        acc1[4 * x] *= alpha_a;
        acc1[4 * x + 1] *= alpha_a;
        acc1[4 * x + 2] *= alpha_b;
        acc1[4 * x + 3] *= alpha_b;
      }
      cp_async_wait<1>();
      fence_proxy_async();
      __syncthreads();

      wgmma_fence();
      gemm_rs_64xN<CD>(acc0, pf, sV, BK);
      gemm_rs_64xN<CD>(acc1, pf, sV + KV_ELEMS, BK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
      __syncthreads();  // every warpgroup is done with V
      if (kt + 1 < n_tiles) load_kv(sV, v, (kt + 1) * BK, cb * C_CD);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // No peer touches this CTA's shared memory after the last barrier.
  const float* fin = sStat1 + (n_tiles & 1) * ROWS;  // cs 1: the last tile's copy
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = half ? t_b : t_a;
    if (t >= Tq) continue;
    const int r = half ? r_b : r_a;
    const float m = cs == 1 ? fin[r] : sM[r];
    const float l = cs == 1 ? fin[2 * ROWS + r] : sL[r];
    const bool valid = m > NEG_INF / 2;
    const size_t row = stat_row(r);
    if constexpr (MERGE) {
      // o' = o e^{m - m'} + acc, l' = l e^{m - m'} + l_acc; a row with no
      // key yet keeps its carry (o * 1 + 0 would turn -0 into +0).
      const bool keep = n_tiles == 0 || !valid;
      const float alpha = exp2f((a.m_in[row] - m) * LOG2E);
      const float* src = a.o_in + row * D + cb * C_CD + col0;
      float* dst = reinterpret_cast<float*>(a.o) + row * D + cb * C_CD + col0;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int ai = 4 * x + 2 * half;
        const float2 y0 = *reinterpret_cast<const float2*>(src + 8 * x);
        const float2 y1 = *reinterpret_cast<const float2*>(src + CD + 8 * x);
        *reinterpret_cast<float2*>(dst + 8 * x) =
            keep ? y0 : make_float2(fmaf(y0.x, alpha, acc0[ai]), fmaf(y0.y, alpha, acc0[ai + 1]));
        *reinterpret_cast<float2*>(dst + CD + 8 * x) =
            keep ? y1 : make_float2(fmaf(y1.x, alpha, acc1[ai]), fmaf(y1.y, alpha, acc1[ai + 1]));
      }
      if (cb == 0 && (lane & 3) == 0) {
        const float lc = a.l_in[row];
        a.l[row] = keep ? lc : fmaf(lc, alpha, l);
        a.m[row] = keep ? a.m_in[row] : m;
      }
    } else {
      // O = acc / l (0 for a row that saw no key), L = m + log l.
      const float inv = valid ? 1.f / fmaxf(l, 1e-30f) : 0.f;
      const int h = kvh * group + r % group;
      bf16* orow = reinterpret_cast<bf16*>(a.o) + (((size_t)b * Tq + t) * H + h) * D + cb * C_CD;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * x + col0) = __floats2bfloat162_rn(
            acc0[4 * x + 2 * half] * inv, acc0[4 * x + 2 * half + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(orow + CD + 8 * x + col0) = __floats2bfloat162_rn(
            acc1[4 * x + 2 * half] * inv, acc1[4 * x + 2 * half + 1] * inv);
      }
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
