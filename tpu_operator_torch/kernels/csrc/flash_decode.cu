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
// 2 us at the 67 TFLOP/s f32 rate.
//
// What this simple design does about it:
// - one CTA per (KV head, batch row) of 8 warps; the group x Tq query rows
//   stay in registers (f32), so K/V are read once per group;
// - keys are walked only up to lengths[b]: the cost is O(length), not
//   O(capacity);
// - each half-warp reads one key row as 16 x 16-byte coalesced loads, and
//   each warp keeps 8 keys (4 KB of K and V) in flight per iteration;
// - every half-warp runs its own online softmax over its keys; the 16
//   partial states are merged in a fixed order at the end (shuffles, then
//   shared memory), so the result is deterministic run to run.
// With only B x KVH CTAs (32 at the serve shape) the loads in flight per
// SM limit the bandwidth reached; splitting the key range over more CTAs
// (split-K) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_once.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;   // head dim (the wrapper checks it)
constexpr int NW = 8;    // warps per CTA
constexpr int U = 4;     // key pairs per warp per iteration
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 p = __bfloat1622float2(h[e]);
    f[2 * e] = p.x;
    f[2 * e + 1] = p.y;
  }
}

template <int R>
__global__ void __launch_bounds__(NW * 32)
flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ lengths,
                    bf16* __restrict__ o, int Tq, int S, int H, int KVH, int group,
                    float scale) {
  extern __shared__ __align__(16) float red[];  // [NW][R][D] acc, then m, l
  float* red_m = red + NW * R * D;
  float* red_l = red_m + NW * R;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;  // which key of the pair
  const int hl = lane & 15;    // this lane's 8-wide slice of D
  const int rows = group * Tq;
  const int len = lengths[b];
  const int n = min(max(len, 0), S);

  float qr[R][8];
  int qpos[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = r / Tq, i = r % Tq;
    qpos[r] = len - Tq + i;
    if (r < rows) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * Tq + i) * H + kvh * group + g) * D + hl * 8);
      unpack8(u, qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[r][e] = 0.f;
    }
  }

  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  for (int base = warp * 2 * U; base < n; base += NW * 2 * U) {
    uint4 kk[U], vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + 2 * u + half;
      if (j < n) {
        const size_t off = (((size_t)b * S + j) * KVH + kvh) * D + hl * 8;
        kk[u] = *reinterpret_cast<const uint4*>(k + off);
        vv[u] = *reinterpret_cast<const uint4*>(v + off);
      } else {
        kk[u] = make_uint4(0, 0, 0, 0);
        vv[u] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + 2 * u + half;
      float kf[8], vf[8];
      unpack8(kk[u], kf);
      unpack8(vv[u], vf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qr[r][e], kf[e], dot);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (j < n && r < rows) {
          const float s = j <= qpos[r] ? dot * scale : NEG_INF;
          const float m_new = fmaxf(m[r], s);
          const float alpha = expf(m[r] - m_new);
          const float p = expf(s - m_new);
          l[r] = l[r] * alpha + p;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = acc[r][e] * alpha + p * vf[e];
          m[r] = m_new;
        }
      }
    }
  }

  // Merge the two half-warps' states, then the warps' states in order.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float mo = __shfl_xor_sync(0xffffffffu, m[r], 16);
    const float lo = __shfl_xor_sync(0xffffffffu, l[r], 16);
    const float mm = fmaxf(m[r], mo);
    const float a = expf(m[r] - mm), ao = expf(mo - mm);
    l[r] = l[r] * a + lo * ao;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float other = __shfl_xor_sync(0xffffffffu, acc[r][e], 16);
      acc[r][e] = acc[r][e] * a + other * ao;
    }
    m[r] = mm;
  }
  if (half == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red[(warp * R + r) * D + hl * 8 + e] = acc[r][e];
      if (hl == 0) {
        red_m[warp * R + r] = m[r];
        red_l[warp * R + r] = l[r];
      }
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < rows * D; idx += NW * 32) {
    const int r = idx / D, d = idx % D;
    float mm = NEG_INF;
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, red_m[w * R + r]);
    float lsum = 0.f, osum = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float a = expf(red_m[w * R + r] - mm);
      lsum += red_l[w * R + r] * a;
      osum += red[(w * R + r) * D + d] * a;
    }
    const float out = mm > NEG_INF / 2 ? osum / fmaxf(lsum, 1e-30f) : 0.f;
    const int g = r / Tq, i = r % Tq;
    o[(((size_t)b * Tq + i) * H + kvh * group + g) * D + d] = __float2bfloat16(out);
  }
}

template <int R>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* o,
           int B, int Tq, int S, int H, int KVH, float scale, cudaStream_t stream) {
  const size_t smem = ((size_t)NW * R * D + 2 * NW * R) * sizeof(float);
  cudaError_t err = set_smem_once<flash_decode_kernel<R>>(smem, false);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KVH, B);
  flash_decode_kernel<R><<<grid, NW * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths, (bf16*)o, Tq,
      S, H, KVH, H / KVH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). Launches on `stream`; returns
// cudaGetLastError() after the launch (0 = launched). group x Tq <= 16.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* lengths, void* o, int B, int Tq, int S,
                                 int H, int KVH, int head_dim, float scale, void* stream) {
  if (head_dim != D || B <= 0 || Tq <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  const int rows = (H / KVH) * Tq;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 1) return launch<1>(q, k, v, lengths, o, B, Tq, S, H, KVH, scale, st);
  if (rows <= 2) return launch<2>(q, k, v, lengths, o, B, Tq, S, H, KVH, scale, st);
  if (rows <= 4) return launch<4>(q, k, v, lengths, o, B, Tq, S, H, KVH, scale, st);
  if (rows <= 8) return launch<8>(q, k, v, lengths, o, B, Tq, S, H, KVH, scale, st);
  if (rows <= 16) return launch<16>(q, k, v, lengths, o, B, Tq, S, H, KVH, scale, st);
  return (int)cudaErrorInvalidValue;
}
