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

constexpr int D = 128;        // head dim (the wrapper checks it)
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
// `ws` holds ws_floats f32, at least B x KVH x ceil(S / 256) x group x Tq
// x (D + 2); `counters` B x KVH int32, zero before the first launch and
// left zero by every launch. One stream at a time may use a `counters`.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* lengths, void* o, void* ws, void* counters,
                                 int B, int Tq, int S, int H, int KVH, int head_dim,
                                 int ws_floats, float scale, void* stream) {
  if (head_dim != D || B <= 0 || Tq <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0 ||
      ws == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const int rows = (H / KVH) * Tq;
  const long long need = (long long)B * KVH * ((S + CHUNK - 1) / CHUNK) * rows * PART;
  if ((long long)ws_floats < need) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 1) return launch<1>(q, k, v, lengths, o, ws, counters, B, Tq, S, H, KVH, scale, st);
  if (rows <= 2) return launch<2>(q, k, v, lengths, o, ws, counters, B, Tq, S, H, KVH, scale, st);
  if (rows <= 4) return launch<4>(q, k, v, lengths, o, ws, counters, B, Tq, S, H, KVH, scale, st);
  if (rows <= 8) return launch<8>(q, k, v, lengths, o, ws, counters, B, Tq, S, H, KVH, scale, st);
  if (rows <= 16)
    return launch<16>(q, k, v, lengths, o, ws, counters, B, Tq, S, H, KVH, scale, st);
  return (int)cudaErrorInvalidValue;
}
