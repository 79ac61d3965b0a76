// Length-masked cached-decode attention for Hopper (sm_90a), bf16 in, f32
// softmax.
//
// Replaces: tpu_operator/payload/flash_attention.py `_decode_kernel`
// (launched by `_flash_decode_pallas`), the TPU kernel behind
// `flash_decode`. It runs on every decode step of the serve path, once
// per layer, against the gathered page span of each slot.
//
// What it computes, for q [B,Tq,H,D], k/v [B,S,KVH,D] bf16 and int32
// lengths [B] (query head h reads K/V head h / group):
//   query slot j of row b sits at position lengths[b] - Tq + j and
//   attends keys at positions < lengths[b] that are <= its own position;
//   O [B,Tq,H,D] bf16, O = 0 for a row that sees no key.
// Keys at positions >= lengths[b] are never read, so whatever lies there
// (stale pages, the padded prompt tail, NaN) contributes exactly nothing,
// and a paged gather gives bit-for-bit the output of a dense cache.
//
// What bounds it on an H100: bytes. At the serve shape (B 8, S 2048,
// KVH 4, D 128, full length) it must read 33.6 MB of K and V per launch,
// about 10 us at 3.35 TB/s; its 0.13 GFLOP of f32 arithmetic is about
// 2 us at the 67 TFLOP/s f32 rate. Reaching the byte rate takes many
// loads in flight on every SM, so the key range is split over CTAs:
// - the grid is (ceil(S / CHUNK), KVH, B): CTA c owns the keys at absolute
//   positions [c CHUNK, (c + 1) CHUNK) of one (KV head, batch row), 256
//   CTAs at the serve shape. A CTA whose chunk starts at or past
//   lengths[b] returns at once (chunk 0 always runs, so a row of length 0
//   still gets O = 0); keys at or past lengths[b] are never read;
// - inside a chunk, K/V tiles of 64 keys stream through a 2-stage
//   cp.async ring (32 KB a tile in flight while the previous one is used;
//   at most 74 KB of shared memory and 85 registers a thread, so three
//   CTAs share an SM). Each tile is
//   scored first (one thread per (key, group of query rows), the group x
//   Tq query rows read from shared memory), then each row takes one max
//   and one rescale for the whole tile (a warp per row, exp2 with scale *
//   log2(e) folded in), then O += P V with P in f32 (a thread per pair of
//   columns). A masked entry has P = 0;
// - each chunk writes its f32 partial state (m, l, acc[rows][128]) to a
//   workspace; the last CTA of a (KV head, batch row) to arrive (an
//   arrival counter per pair, after a __threadfence) merges the partials
//   of chunks 0 .. ceil(len / CHUNK) - 1 in chunk order and resets the
//   counter to 0. The output is deterministic, and the same for any
//   capacity S that holds the same valid keys: chunk and tile boundaries
//   are absolute positions.
// One launch per call; the wrapper allocates the workspace per call and
// the counters once per device and stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "smem_once.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;        // head dim; any multiple above it: the wide kernel
constexpr int CHUNK = 256;    // keys per CTA
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // 8 warps
constexpr int NW = NT / 32;
constexpr int PART = D + 2;   // floats of one row's partial: acc[D], m, l
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(NT == 4 * BK, "four row groups of one thread per key");

template <int R>
constexpr size_t smem_bytes() {
  // Two stages of (K, V), the query rows, the tile's scores, the rescales.
  return 2 * 2 * (size_t)BK * D * sizeof(bf16) + (size_t)R * D * sizeof(bf16) +
         (size_t)R * BK * sizeof(float) + (size_t)R * sizeof(float);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// R: query rows (group x Tq, head-major: row = g * Tq + slot) rounded up
// to a power of two, at most 16.
template <int R>
__global__ void __launch_bounds__(NT, 3)
flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ lengths,
                    bf16* __restrict__ o, float* __restrict__ ws, int* __restrict__ counters,
                    int Tq, int S, int H, int KVH, int group, float scale) {
  constexpr int RT = R >= 4 ? R / 4 : 1;  // rows per thread (score and P V)
  constexpr int RW = (R + NW - 1) / NW;  // rows per warp (softmax)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sKV = reinterpret_cast<bf16*>(smem_raw);  // stage s: K at sKV + 2 s BK D, V after it
  bf16* sQ = sKV + 2 * 2 * BK * D;                 // [R][D]
  float* sS = reinterpret_cast<float*>(sQ + R * D);  // [R][BK] scores, then P
  float* sAlpha = sS + R * BK;                     // [R] the tile's rescale
  __shared__ int s_ticket;

  const int c = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rows = group * Tq;
  const int len = lengths[b];
  const int n = min(max(len, 0), S);
  const int n_chunks = max(1, (n + CHUNK - 1) / CHUNK);
  if (c >= n_chunks) return;
  const int k_begin = c * CHUNK;
  const int k_end = min(k_begin + CHUNK, n);
  const int n_tiles = max(0, (k_end - k_begin + BK - 1) / BK);

  // Query rows, zero-filled past `rows`.
  if (tid < R * 16) {
    const int r = tid >> 4, ch = tid & 15;
    const bool ok = r < rows;
    const int g = ok ? r / Tq : 0, i = ok ? r % Tq : 0;
    cp_async_16(sQ + r * D + ch * 8,
                q + (((size_t)b * Tq + i) * H + kvh * group + g) * D + ch * 8, ok);
  }
  auto load_kv = [&](int t, int st) {
    const int k0 = k_begin + t * BK;
    bf16* dK = sKV + 2 * st * BK * D;
    bf16* dV = dK + BK * D;
#pragma unroll
    for (int u = 0; u < BK * 16 / NT; ++u) {
      const int j = (tid + u * NT) >> 4, ch = tid & 15;
      const bool ok = k0 + j < k_end;
      const size_t off = (((size_t)b * S + (ok ? k0 + j : 0)) * KVH + kvh) * D + ch * 8;
      cp_async_16(dK + j * D + ch * 8, k + off, ok);
      cp_async_16(dV + j * D + ch * 8, v + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1, 1);
  cp_async_commit();

  const float cscale = scale * LOG2E;
  const int kj = tid % BK;  // score phase: this thread's key; P V: its column pair
  const int rg = tid / BK;  // row group: rows rg + 4 i
  float m_run[RW], l_run[RW], acc[RT][2];
#pragma unroll
  for (int x = 0; x < RW; ++x) {
    m_run[x] = NEG_INF;
    l_run[x] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int k0 = k_begin + t * BK;
    cp_async_wait<1>();  // tile t (and the query rows) landed for this thread's copies
    __syncthreads();     // ... and for every thread's
    const bf16* sK = sKV + 2 * st * BK * D;
    const bf16* sV = sK + BK * D;

    // Scores of key kj against rows rg + 4 i, in log2 units. Each thread
    // starts its row at chunk kj % 16, so a quarter-warp's 16-byte reads
    // hit 8 different bank groups.
    if (rg < R) {
      float sacc[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) sacc[i] = 0.f;
      const bf16* kr = sK + kj * D;
#pragma unroll
      for (int cc = 0; cc < 16; ++cc) {
        const int ch = (cc + kj) & 15;
        const uint4 ku = *reinterpret_cast<const uint4*>(kr + ch * 8);
#pragma unroll
        for (int i = 0; i < RT; ++i)
          sacc[i] = dot8(*reinterpret_cast<const uint4*>(sQ + (rg + 4 * i) * D + ch * 8), ku,
                         sacc[i]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) sS[(rg + 4 * i) * BK + kj] = sacc[i] * cscale;
    }
    __syncthreads();

    // One max and one rescale per row for the tile; P in place of S.
#pragma unroll
    for (int x = 0; x < RW; ++x) {
      const int r = warp + NW * x;
      if (r >= R) continue;
      const int qpos = len - Tq + r % Tq;
      const int key0 = k0 + lane, key1 = key0 + 32;
      const bool v0 = r < rows && key0 < k_end && key0 <= qpos;
      const bool v1 = r < rows && key1 < k_end && key1 <= qpos;
      const float s0 = sS[r * BK + lane], s1 = sS[r * BK + lane + 32];
      const float mx = warp_max(fmaxf(v0 ? s0 : -INFINITY, v1 ? s1 : -INFINITY));
      const float m_new = fmaxf(m_run[x], mx);
      const float alpha = exp2f(m_run[x] - m_new);
      const float p0 = v0 ? exp2f(s0 - m_new) : 0.f;
      const float p1 = v1 ? exp2f(s1 - m_new) : 0.f;
      sS[r * BK + lane] = p0;
      sS[r * BK + lane + 32] = p1;
      l_run[x] = l_run[x] * alpha + warp_sum(p0 + p1);
      m_run[x] = m_new;
      if (lane == 0) sAlpha[r] = alpha;
    }
    __syncthreads();

    // O += P V for rows rg + 4 i, columns 2 kj and 2 kj + 1.
    if (rg < R) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float a = sAlpha[rg + 4 * i];
        acc[i][0] *= a;
        acc[i][1] *= a;
      }
#pragma unroll 4
      for (int jj = 0; jj < BK; jj += 4) {
        float4 p4[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          p4[i] = *reinterpret_cast<const float4*>(sS + (rg + 4 * i) * BK + jj);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 vf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sV + (jj + u) * D + 2 * kj));
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
            acc[i][0] = fmaf(p, vf.x, acc[i][0]);
            acc[i][1] = fmaf(p, vf.y, acc[i][1]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with stage st and the scores
    if (t + 2 < n_tiles) load_kv(t + 2, st);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // This chunk's partial state, [b][kvh][chunk][row][acc D, m, l].
  const size_t chunk_stride = (size_t)rows * PART;
  float* part = ws + ((size_t)(b * KVH + kvh) * gridDim.x + c) * chunk_stride;
  if (rg < R) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = rg + 4 * i;
      if (r < rows)
        *reinterpret_cast<float2*>(part + r * PART + 2 * kj) = make_float2(acc[i][0], acc[i][1]);
    }
  }
#pragma unroll
  for (int x = 0; x < RW; ++x) {
    const int r = warp + NW * x;
    if (r < rows && lane == 0) {
      part[r * PART + D] = m_run[x];
      part[r * PART + D + 1] = l_run[x];
    }
  }
  __threadfence();
  __syncthreads();
  int* counter = counters + b * KVH + kvh;
  if (tid == 0) s_ticket = atomicAdd(counter, 1);
  __syncthreads();
  if (s_ticket != n_chunks - 1) return;
  __threadfence();

  // The last chunk to arrive merges chunks 0 .. n_chunks - 1 in order.
  const float* first = ws + (size_t)(b * KVH + kvh) * gridDim.x * chunk_stride;
  for (int x = tid; x < rows * (D / 2); x += NT) {
    const int r = x / (D / 2), col = 2 * (x % (D / 2));
    const float* row = first + r * PART;
    float mt = NEG_INF;
    for (int cc = 0; cc < n_chunks; ++cc) mt = fmaxf(mt, __ldcg(row + cc * chunk_stride + D));
    float l = 0.f, o0 = 0.f, o1 = 0.f;
    for (int cc = 0; cc < n_chunks; ++cc) {
      const float* pc = row + cc * chunk_stride;
      const float a = exp2f(__ldcg(pc + D) - mt);
      const float2 y = __ldcg(reinterpret_cast<const float2*>(pc + col));
      l = fmaf(__ldcg(pc + D + 1), a, l);
      o0 = fmaf(y.x, a, o0);
      o1 = fmaf(y.y, a, o1);
    }
    const bool alive = mt > NEG_INF / 2;
    const float den = fmaxf(l, 1e-30f);
    const int g = r / Tq, i = r % Tq;
    *reinterpret_cast<__nv_bfloat162*>(o + (((size_t)b * Tq + i) * H + kvh * group + g) * D +
                                       col) =
        __floats2bfloat162_rn(alive ? o0 / den : 0.f, alive ? o1 / den : 0.f);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch on this stream
}

// --- head dims above 128 ------------------------------------------------------
//
// Any multiple of 128: the grid gains an axis over the 128-column blocks of
// O ((chunk, KV head x nc + column block cb, batch row)), and the CTAs of
// one (chunk, KV head, batch row) form thread-block clusters of
// cs = wide_cluster_size(nc) consecutive column blocks along grid y
// (hopper.cuh; cs = nc up to D 1024). Rank r = cb % cs of a cluster scores
// the keys over the m = nc / cs head-dim blocks r, r + cs, ... (its own
// block when m = 1, as flash_wide.cuh's K1 does past 8 blocks), so a
// cluster reads each key's K once and computes each score tile once. Per
// tile of 64 keys:
// - m steps of K (one [64][128] block each, through a WNSTAGE-deep
//   cp.async ring; the query rows' columns of those blocks stay resident)
//   give rank r's partial scores [R][64] in f32: every thread scores one
//   key over a quarter of each block's 16-byte chunks, and the key's four
//   lanes add their quarters by two shuffles;
// - the partial goes to shared memory (two buffers, by tile parity), one
//   cluster barrier, and every rank sums all ranks' partials of the whole
//   tile in rank order through distributed shared memory (the tile is only
//   R x 64 floats): every rank holds bit-identical scores, so the same m,
//   l and P, and nothing is pushed back. A rank overwrites a buffer two
//   tiles later, after the next tile's barrier, which every reader of it
//   has passed;
// - one step of V's block cb: O_cb += P V_cb, each quarter of the threads
//   over 16 of the tile's keys into its own accumulator (summed in key
//   group order once per chunk), so every thread works at R = 1 too.
// Every column block keeps its own partials and arrival counter (B x KVH x
// nc of them), so the last CTA of a (batch row, KV head, column block)
// merges that block's chunks, as in the narrow kernel; m and l are the
// same in every block. Chunk and tile boundaries are absolute positions
// and keys at or past lengths[b] are never read, as above. A cluster
// shares its chunk and row, so its early return is uniform, and a last
// cluster barrier keeps every rank's partials alive until its peers have
// read them.

constexpr int CD = 128;          // head-dim columns of one block
constexpr int WPART = CD + 2;    // floats of one row's partial: acc[CD], m, l
constexpr int WNSTAGE = 3;       // [64][128] blocks of K or V in flight
constexpr int KG = NT / 64;      // key groups of P V (16 keys each)
// The dynamic shared memory limit set for the wide kernel: sm_90's 227 KB
// a CTA, less 1 KB for its static shared memory.
constexpr size_t WIDE_SMEM_MAX = 232448 - 1024;
static_assert(NT == 256 && BK == 64, "the score and P V thread maps");

// The ring, this rank's columns of the query rows ([m][R][CD] bf16), the
// two partial-score buffers, the tile's scores, the rescales. At the end
// the ring holds the key groups' accumulators, [KG][R][CD] f32.
__host__ __device__ constexpr size_t wide_smem_bytes(int R, int m) {
  return (size_t)WNSTAGE * BK * CD * sizeof(bf16) + (size_t)m * R * CD * sizeof(bf16) +
         3 * (size_t)R * BK * sizeof(float) + (size_t)R * sizeof(float);
}

// CTAs an SM holds: the accumulators and scores grow with R, so fewer
// CTAs (more registers each) at more query rows, each as many as spill
// nothing; at R = 1 four (64 registers), which took the serve_wide shape
// from 0.129 to 0.119 ms (PERF.md).
template <int R>
__global__ void __launch_bounds__(NT, R >= 16 ? 1 : R >= 4 ? 2 : R == 2 ? 3 : 4)
flash_decode_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const int* __restrict__ lengths,
                         bf16* __restrict__ o, float* __restrict__ ws,
                         int* __restrict__ counters, int Tq, int S, int H, int KVH, int group,
                         int nc, float scale) {
  constexpr int RW = (R + NW - 1) / NW;  // rows per warp (softmax)
  static_assert(WNSTAGE * BK * CD * sizeof(bf16) >= KG * R * CD * sizeof(float),
                "the ring holds the key groups' accumulators");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cs = wide_cluster_size(nc), m = nc / cs;
  bf16* sRing = reinterpret_cast<bf16*>(smem_raw);        // [WNSTAGE][BK][CD]
  bf16* sQ = sRing + WNSTAGE * BK * CD;                   // [m][R][CD]
  float* sPart = reinterpret_cast<float*>(sQ + m * R * CD);  // [2][R][BK]
  float* sS = sPart + 2 * R * BK;                         // [R][BK] scores, then P
  float* sAlpha = sS + R * BK;                            // [R]
  __shared__ int s_ticket;

  const int D = nc * CD;
  const int c = blockIdx.x;
  const int kvh = blockIdx.y / nc;
  const int cb = blockIdx.y - kvh * nc;
  const int rank = cb % cs;  // cs divides nc: the cluster's rank of this CTA
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rows = group * Tq;
  const int len = lengths[b];
  const int n = min(max(len, 0), S);
  const int n_chunks = max(1, (n + CHUNK - 1) / CHUNK);
  if (c >= n_chunks) return;  // the whole cluster: it shares c and b
  const int k_begin = c * CHUNK;
  const int k_end = min(k_begin + CHUNK, n);
  const int n_tiles = max(0, (k_end - k_begin + BK - 1) / BK);
  const int per_tile = m + 1;
  const int steps = n_tiles * per_tile;

  // The query rows' columns of blocks rank + cs u, zero-filled past `rows`.
  for (int x = tid; x < m * R * 16; x += NT) {
    const int u = x / (R * 16), r = (x >> 4) % R, ch = x & 15;
    const bool ok = r < rows;
    const int g = ok ? r / Tq : 0, i = ok ? r % Tq : 0;
    cp_async_16(sQ + (u * R + r) * CD + ch * 8,
                q + (((size_t)b * Tq + i) * H + kvh * group + g) * D + (rank + cs * u) * CD +
                    ch * 8,
                ok);
  }
  // Step j of tile t = j / (m + 1): u = j % (m + 1) < m loads block
  // rank + cs u of K, u = m V's block cb, into ring slot j % WNSTAGE.
  auto load_step = [&](int j) {
    const int t = j / per_tile, u = j - t * per_tile;
    const int k0 = k_begin + t * BK;
    bf16* dst = sRing + (j % WNSTAGE) * BK * CD;
    const bf16* src = u < m ? k : v;
    const int col = (u < m ? rank + cs * u : cb) * CD;
#pragma unroll
    for (int x = 0; x < BK * 16 / NT; ++x) {
      const int jj = (tid + x * NT) >> 4, ch = tid & 15;
      const bool ok = k0 + jj < k_end;
      const size_t off = (((size_t)b * S + (ok ? k0 + jj : 0)) * KVH + kvh) * D + col + ch * 8;
      cp_async_16(dst + jj * CD + ch * 8, src + off, ok);
    }
  };
#pragma unroll
  for (int j = 0; j < WNSTAGE - 1; ++j) {
    if (j < steps) load_step(j);
    cp_async_commit();  // the query rows ride with step 0
  }

  const float cscale = scale * LOG2E;
  // Scores: key skey (8 a warp), its quarter sg of each block's chunks;
  // the chunk rotates with the key, so a quarter-warp's 16-byte reads hit
  // the 8 bank groups once each.
  const int skey = warp * 8 + (lane >> 2), sg = lane & 3;
  // P V: keys 16 pg .. 16 pg + 15, columns 2 pc and 2 pc + 1.
  const int pg = tid >> 6, pc = tid & 63;
  float m_run[RW], l_run[RW], acc[R][2], sacc[R];
#pragma unroll
  for (int x = 0; x < RW; ++x) {
    m_run[x] = NEG_INF;
    l_run[x] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = sacc[r] = 0.f;

  for (int j = 0; j < steps; ++j) {
    const int t = j / per_tile, u = j - t * per_tile;
    const int k0 = k_begin + t * BK;
    cp_async_wait<WNSTAGE - 2>();  // step j landed for this thread's copies
    __syncthreads();               // ... and every thread's; slot (j - 1) is free
    if (j + WNSTAGE - 1 < steps) load_step(j + WNSTAGE - 1);
    cp_async_commit();
    const bf16* blk = sRing + (j % WNSTAGE) * BK * CD;

    if (u < m) {
      const bf16* kr = blk + skey * CD;
      const bf16* qu = sQ + u * R * CD;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int ch = sg + 4 * ((cc + skey) & 3);
        const uint4 ku = *reinterpret_cast<const uint4*>(kr + ch * 8);
#pragma unroll
        for (int r = 0; r < R; ++r)
          sacc[r] = dot8(*reinterpret_cast<const uint4*>(qu + r * CD + ch * 8), ku, sacc[r]);
      }
      if (u == m - 1) {
        // This rank's partial, then the whole tile's scores: every rank's
        // partial in rank order, in log2 units.
        float* part = sPart + (t & 1) * R * BK;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float x = sacc[r];
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
          if (sg == 0) part[r * BK + skey] = x;
          sacc[r] = 0.f;
        }
        cluster_sync();
        for (int x = tid; x < R * BK / 4; x += NT) {
          const float4 s4 = cluster_sum_f4(part + 4 * x, cs);
          *reinterpret_cast<float4*>(sS + 4 * x) =
              make_float4(s4.x * cscale, s4.y * cscale, s4.z * cscale, s4.w * cscale);
        }
        __syncthreads();
        // One max and one rescale per row for the tile; P in place of S.
#pragma unroll
        for (int x = 0; x < RW; ++x) {
          const int r = warp + NW * x;
          if (r >= R) continue;
          const int qpos = len - Tq + r % Tq;
          const int key0 = k0 + lane, key1 = key0 + 32;
          const bool v0 = r < rows && key0 < k_end && key0 <= qpos;
          const bool v1 = r < rows && key1 < k_end && key1 <= qpos;
          const float s0 = sS[r * BK + lane], s1 = sS[r * BK + lane + 32];
          const float mx = warp_max(fmaxf(v0 ? s0 : -INFINITY, v1 ? s1 : -INFINITY));
          const float m_new = fmaxf(m_run[x], mx);
          const float alpha = exp2f(m_run[x] - m_new);
          const float p0 = v0 ? exp2f(s0 - m_new) : 0.f;
          const float p1 = v1 ? exp2f(s1 - m_new) : 0.f;
          sS[r * BK + lane] = p0;
          sS[r * BK + lane + 32] = p1;
          l_run[x] = l_run[x] * alpha + warp_sum(p0 + p1);
          m_run[x] = m_new;
          if (lane == 0) sAlpha[r] = alpha;
        }
        // P and alpha are published by the next step's barrier.
      }
    } else {
      // O += P V_cb over this thread's 16 keys.
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float a = sAlpha[r];
        acc[r][0] *= a;
        acc[r][1] *= a;
      }
#pragma unroll
      for (int jj = 0; jj < 16; jj += 4) {
        const int key = pg * 16 + jj;
        float2 vf[4];
#pragma unroll
        for (int w = 0; w < 4; ++w)
          vf[w] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(blk + (key + w) * CD + 2 * pc));
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(sS + r * BK + key);
          acc[r][0] = fmaf(p4.x, vf[0].x, acc[r][0]);
          acc[r][1] = fmaf(p4.x, vf[0].y, acc[r][1]);
          acc[r][0] = fmaf(p4.y, vf[1].x, acc[r][0]);
          acc[r][1] = fmaf(p4.y, vf[1].y, acc[r][1]);
          acc[r][0] = fmaf(p4.z, vf[2].x, acc[r][0]);
          acc[r][1] = fmaf(p4.z, vf[2].y, acc[r][1]);
          acc[r][0] = fmaf(p4.w, vf[3].x, acc[r][0]);
          acc[r][1] = fmaf(p4.w, vf[3].y, acc[r][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  cluster_sync();  // every peer has read this rank's partials; the ring is free

  // The key groups' accumulators, summed in group order: this chunk's
  // partial state, [b][kvh][cb][chunk][row][acc CD, m, l].
  float* sRed = reinterpret_cast<float*>(sRing);  // [KG][R][CD]
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < rows)
      *reinterpret_cast<float2*>(sRed + (pg * R + r) * CD + 2 * pc) =
          make_float2(acc[r][0], acc[r][1]);
  __syncthreads();
  const size_t chunk_stride = (size_t)rows * WPART;
  const size_t pair = ((size_t)b * KVH + kvh) * nc + cb;
  float* part = ws + (pair * gridDim.x + c) * chunk_stride;
  for (int x = tid; x < rows * (CD / 2); x += NT) {
    const int r = x / (CD / 2), col = 2 * (x % (CD / 2));
    float2 y = *reinterpret_cast<const float2*>(sRed + r * CD + col);
#pragma unroll
    for (int g = 1; g < KG; ++g) {
      const float2 z = *reinterpret_cast<const float2*>(sRed + (g * R + r) * CD + col);
      y.x += z.x;
      y.y += z.y;
    }
    *reinterpret_cast<float2*>(part + r * WPART + col) = y;
  }
#pragma unroll
  for (int x = 0; x < RW; ++x) {
    const int r = warp + NW * x;
    if (r < rows && lane == 0) {
      part[r * WPART + CD] = m_run[x];
      part[r * WPART + CD + 1] = l_run[x];
    }
  }
  __threadfence();
  __syncthreads();
  int* counter = counters + pair;
  if (tid == 0) s_ticket = atomicAdd(counter, 1);
  __syncthreads();
  if (s_ticket != n_chunks - 1) return;
  __threadfence();

  // The last chunk to arrive merges chunks 0 .. n_chunks - 1 in order.
  const float* first = ws + pair * gridDim.x * chunk_stride;
  for (int x = tid; x < rows * (CD / 2); x += NT) {
    const int r = x / (CD / 2), col = 2 * (x % (CD / 2));
    const float* row = first + r * WPART;
    float mt = NEG_INF;
    for (int cc = 0; cc < n_chunks; ++cc) mt = fmaxf(mt, __ldcg(row + cc * chunk_stride + CD));
    float l = 0.f, o0 = 0.f, o1 = 0.f;
    for (int cc = 0; cc < n_chunks; ++cc) {
      const float* pch = row + cc * chunk_stride;
      const float a = exp2f(__ldcg(pch + CD) - mt);
      const float2 y = __ldcg(reinterpret_cast<const float2*>(pch + col));
      l = fmaf(__ldcg(pch + CD + 1), a, l);
      o0 = fmaf(y.x, a, o0);
      o1 = fmaf(y.y, a, o1);
    }
    const bool alive = mt > NEG_INF / 2;
    const float den = fmaxf(l, 1e-30f);
    const int g = r / Tq, i = r % Tq;
    *reinterpret_cast<__nv_bfloat162*>(o + (((size_t)b * Tq + i) * H + kvh * group + g) * D +
                                       cb * CD + col) =
        __floats2bfloat162_rn(alive ? o0 / den : 0.f, alive ? o1 / den : 0.f);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch on this stream
}

template <int R>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* lengths,
                        void* o, void* ws, void* counters, int B, int Tq, int S, int H,
                        int KVH, int nc, float scale, cudaStream_t stream) {
  const int cs = wide_cluster_size(nc);
  const size_t smem = wide_smem_bytes(R, nc / cs);
  if (smem > WIDE_SMEM_MAX) return cudaErrorInvalidValue;
  // The limit is set once for every head dim: the largest a CTA may take.
  cudaError_t err = set_smem_once<flash_decode_wide_kernel<R>>(WIDE_SMEM_MAX, false);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(dim3((S + CHUNK - 1) / CHUNK, KVH * nc, B), NT, smem, cs, stream);
  err = cudaLaunchKernelEx(&l.cfg, flash_decode_wide_kernel<R>, (const bf16*)q, (const bf16*)k,
                           (const bf16*)v, (const int*)lengths, (bf16*)o, (float*)ws,
                           (int*)counters, Tq, S, H, KVH, H / KVH, nc, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int R>
cudaError_t wide_cluster(int nc, int* cluster_size, int* max_clusters) {
  const int cs = wide_cluster_size(nc);
  const size_t smem = wide_smem_bytes(R, nc / cs);
  if (smem > WIDE_SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = set_smem_once<flash_decode_wide_kernel<R>>(WIDE_SMEM_MAX, false);
  if (err != cudaSuccess) return err;
  *cluster_size = cs;
  return max_active_clusters(flash_decode_wide_kernel<R>, NT, smem, cs, max_clusters);
}

template <int R>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* o,
           void* ws, void* counters, int B, int Tq, int S, int H, int KVH, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<R>();
  cudaError_t err = set_smem_once<flash_decode_kernel<R>>(smem, false);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + CHUNK - 1) / CHUNK, KVH, B);
  flash_decode_kernel<R><<<grid, NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths, (bf16*)o,
      (float*)ws, (int*)counters, Tq, S, H, KVH, H / KVH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). Launches on `stream`; returns
// cudaGetLastError() after the launch (0 = launched). group x Tq <= 16.
// head_dim 128 or a multiple of 128 above it (nc = head_dim / 128). `ws`
// holds ws_floats f32, at least B x KVH x ceil(S / 256) x group x Tq x
// (130 x nc); `counters` B x KVH x nc int32, zero before the first launch
// and left zero by every launch. One stream at a time may use a `counters`.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* lengths, void* o, void* ws, void* counters,
                                 int B, int Tq, int S, int H, int KVH, int head_dim,
                                 int ws_floats, float scale, void* stream) {
  if (head_dim < D || head_dim % CD != 0 || B <= 0 || Tq <= 0 || S <= 0 || KVH <= 0 ||
      H % KVH != 0 || ws == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const int rows = (H / KVH) * Tq;
  const int nc = head_dim / CD;
  // The narrow kernel's partials are D + 2 floats a row; the wide one's
  // CD + 2 for each of the nc column blocks.
  const long long need =
      (long long)B * KVH * ((S + CHUNK - 1) / CHUNK) * rows * (nc == 1 ? PART : nc * WPART);
  if ((long long)ws_floats < need) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (nc > 1) {
#define WIDE_ARGS q, k, v, lengths, o, ws, counters, B, Tq, S, H, KVH, nc, scale, st
    if (rows <= 1) return (int)launch_wide<1>(WIDE_ARGS);
    if (rows <= 2) return (int)launch_wide<2>(WIDE_ARGS);
    if (rows <= 4) return (int)launch_wide<4>(WIDE_ARGS);
    if (rows <= 8) return (int)launch_wide<8>(WIDE_ARGS);
    if (rows <= 16) return (int)launch_wide<16>(WIDE_ARGS);
#undef WIDE_ARGS
    return (int)cudaErrorInvalidValue;
  }
  if (rows <= 1) return launch<1>(q, k, v, lengths, o, ws, counters, B, Tq, S, H, KVH, scale, st);
  if (rows <= 2) return launch<2>(q, k, v, lengths, o, ws, counters, B, Tq, S, H, KVH, scale, st);
  if (rows <= 4) return launch<4>(q, k, v, lengths, o, ws, counters, B, Tq, S, H, KVH, scale, st);
  if (rows <= 8) return launch<8>(q, k, v, lengths, o, ws, counters, B, Tq, S, H, KVH, scale, st);
  if (rows <= 16)
    return launch<16>(q, k, v, lengths, o, ws, counters, B, Tq, S, H, KVH, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The wide kernel's cluster at `head_dim` (a multiple of 128 above it) and
// `rows` = group x Tq query rows (at most 16): its size and the most such
// clusters the device holds at once.
extern "C" int flash_decode_wide_cluster(int head_dim, int rows, int* cluster_size,
                                         int* max_clusters) {
  if (head_dim <= D || head_dim % CD != 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  const int nc = head_dim / CD;
  if (rows <= 1) return (int)wide_cluster<1>(nc, cluster_size, max_clusters);
  if (rows <= 2) return (int)wide_cluster<2>(nc, cluster_size, max_clusters);
  if (rows <= 4) return (int)wide_cluster<4>(nc, cluster_size, max_clusters);
  if (rows <= 8) return (int)wide_cluster<8>(nc, cluster_size, max_clusters);
  if (rows <= 16) return (int)wide_cluster<16>(nc, cluster_size, max_clusters);
  return (int)cudaErrorInvalidValue;
}
