// Hopper (sm_90a) building blocks shared by the attention kernels: the
// 128-byte-swizzled shared-memory tile layout, cp.async copies that fill
// it, and warpgroup matrix multiplies (wgmma) that read it.
//
// Tile layout. A bf16 tile of R rows x 128 columns (one head dim) is kept
// as two 64-column halves, each R rows of 128 bytes, 1024-byte aligned; a
// tile of 64 columns (head dim 64) is one such half.
// Inside a half, the 16-byte chunk c of row r sits at chunk c ^ (r % 8):
// the layout TMA's CU_TENSOR_MAP_SWIZZLE_128B writes and wgmma's 128-byte
// swizzle mode reads, so the eight rows of an 8x8 block hit eight banks.
//
// wgmma operands (bf16 in, f32 accumulate), PTX ISA "Asynchronous
// Warpgroup Level Matrix Multiply":
// - K-major (the contraction dimension contiguous, e.g. Q or K as [rows][D]
//   for S = Q K^T): descriptor with SBO = 1024 bytes (8 rows of 128 bytes),
//   LBO unused; a k16 step advances the start address by 32 bytes inside a
//   half, and the next half starts R * 128 bytes further on.
// - MN-major (the output dimension contiguous, e.g. V as [keys][D] for
//   O = P V, "transpose" flag set): SBO = 1024 bytes between groups of 8
//   contraction rows, LBO = the distance between the two 64-column halves;
//   a k16 step advances 16 rows (2048 bytes).
// - A from registers (RS): an m64k16 bf16 fragment is 4 x 32-bit per
//   thread, the same places an m64nN f32 accumulator holds, so a score
//   accumulator becomes an operand by packing adjacent pairs (pack_bf16x2).
//
// Accumulator layout of m64nNk16 (f32), thread = (warp w of the warpgroup,
// lane l): d[4i + 0..1] at row 16w + l/4, columns 8i + 2(l%4) + {0,1};
// d[4i + 2..3] at row 16w + l/4 + 8, the same columns.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HALF_COLS = 64;  // bf16 columns in a 128-byte swizzled row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (row, col) in a swizzled [rows][128] tile.
__device__ __forceinline__ int swz(int rows, int row, int col) {
  return (col >> 6) * rows * HALF_COLS + row * HALF_COLS +
         ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7);
}

// --- cp.async ------------------------------------------------------------------

// 16 bytes global -> shared, zero-filled when !pred (gmem must still be a
// valid address).
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies written by this thread through the generic proxy (cp.async) made
// visible to the async proxy that wgmma reads shared memory through. Call
// after the copies landed and before the barrier that publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy one [rows][COLS] bf16 tile (COLS 64 or 128) into the swizzled
// layout with `nthreads` threads (thread `tid`). `src(row)` is the row's
// global address, or nullptr for a zero-filled row; `fallback` is any
// valid global address.
template <int ROWS, int NTHREADS, int COLS = 128, typename RowFn>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int tid, RowFn src,
                                          const void* fallback) {
  static_assert(COLS == 64 || COLS == 128, "a tile is one or two halves");
  constexpr int SHIFT = COLS == 128 ? 4 : 3;  // log2 of a row's 16-byte chunks
  constexpr int CHUNKS = ROWS << SHIFT;
  static_assert(CHUNKS % NTHREADS == 0, "tile chunks must split evenly");
#pragma unroll
  for (int i = 0; i < CHUNKS / NTHREADS; ++i) {
    const int c = tid + i * NTHREADS;
    const int row = c >> SHIFT, ch = c & ((1 << SHIFT) - 1);
    const __nv_bfloat16* g = src(row);
    cp_async_16(dst + swz(ROWS, row, ch * 8), g ? (const void*)(g + ch * 8) : fallback,
                g != nullptr);
  }
}

// --- wgmma -------------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_encode(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4);
}

// K-major operand, 128-byte swizzle, at `p` (a k16 step is +32 bytes).
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  return desc_encode(smem_u32(p)) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// MN-major operand, 128-byte swizzle, at `p`; `lbo` bytes between the two
// 64-column halves (a k16 step is +16 rows).
__device__ __forceinline__ uint64_t desc_mnmajor(const void* p, uint32_t lbo) {
  return desc_encode(smem_u32(p)) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of accumulator registers across
// a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HP_F8(d, i)                                                                    \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),     \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64x64] (+)= A[64x16] B[16x64], both K-major in shared memory.
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : HP_F8(d, 0), HP_F8(d, 8), HP_F8(d, 16), HP_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x128] += A[64x16] B[16x128]: A from registers (4 x bf16x2), B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HP_F8(d, 0), HP_F8(d, 8), HP_F8(d, 16), HP_F8(d, 24), HP_F8(d, 32), HP_F8(d, 40),
        HP_F8(d, 48), HP_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64x64] += A[64x16] B[16x64]: A from registers (4 x bf16x2), B
// MN-major in shared memory (one 64-column half: the LBO is not read).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HP_F8(d, 0), HP_F8(d, 8), HP_F8(d, 16), HP_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HP_F8

// S[64 x 64] = A[64 rows of a, KD] B[64 rows of b, KD]^T, both swizzled
// [rows][KD] tiles, KD (the head dim) 64 or 128 (A's 64 rows start at `a`,
// whose half holds a_rows rows; likewise b). Issued and committed; the
// caller waits.
template <int KD>
__device__ __forceinline__ void gemm_nt_64x64(float (&s)[32], const __nv_bfloat16* a,
                                              int a_rows, const __nv_bfloat16* b,
                                              int b_rows) {
  static_assert(KD == 64 || KD == 128, "one or two 64-column halves");
#pragma unroll
  for (int k = 0; k < KD / 16; ++k) {
    const int half = k >> 2, off = (k & 3) * 16;  // elements
    wgmma_m64n64k16_ss(s, desc_kmajor(a + half * a_rows * HALF_COLS + off),
                       desc_kmajor(b + half * b_rows * HALF_COLS + off), k > 0);
  }
}

// S[64 x 64] (+)= A B^T over one 128-column chunk of a wider head dim:
// gemm_nt_64x64<128> whose first k16 step adds to S when `accumulate` is
// non-zero (the wide kernels sum S over the chunks of the head dim).
__device__ __forceinline__ void gemm_nt_64x64_chunk(float (&s)[32], const __nv_bfloat16* a,
                                                    int a_rows, const __nv_bfloat16* b,
                                                    int b_rows, int accumulate) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int half = k >> 2, off = (k & 3) * 16;  // elements
    wgmma_m64n64k16_ss(s, desc_kmajor(a + half * a_rows * HALF_COLS + off),
                       desc_kmajor(b + half * b_rows * HALF_COLS + off), k > 0 ? 1 : accumulate);
  }
}

// O[64 x N] += P[64 x 64] B[64 rows, N], N (the head dim) 64 or 128, P as
// 4 k16 register fragments (from pack_scores), B a swizzled [b_rows][N]
// tile whose contraction rows start at `b`.
template <int N>
__device__ __forceinline__ void gemm_rs_64xN(float (&o)[N / 2], const uint32_t (&p)[16],
                                             const __nv_bfloat16* b, int b_rows) {
  static_assert(N == 64 || N == 128, "one or two 64-column halves");
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t a[4] = {p[4 * k], p[4 * k + 1], p[4 * k + 2], p[4 * k + 3]};
    const uint64_t db = desc_mnmajor(b + k * 16 * HALF_COLS, b_rows * 128);
    if constexpr (N == 128)
      wgmma_m64n128k16_rs(o, a, db);
    else
      wgmma_m64n64k16_rs(o, a, db);
  }
}

// acc + sum_e a[e] b[e] over two rows of 8 bf16 (16 bytes each), in f32.
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(x[e]), w = __bfloat1622float2(y[e]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 f32 score accumulator -> 4 k16 A fragments in bf16.
__device__ __forceinline__ void pack_scores(uint32_t (&p)[16], const float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = pack_bf16x2(s[2 * i], s[2 * i + 1]);
}

// --- thread-block clusters (the wide kernels' score exchange) -------------------
//
// A wide kernel's cluster is the column blocks of one output tile: its
// CTAs each hold a partial score tile (their chunks' share of the head
// dim), exchange them through distributed shared memory and sum them.
// Score tiles travel as f32 [rows][64]: the 16-byte chunk c of row r sits
// at chunk c ^ (r % 8), so the accumulator's float2 stores and the
// reduction's float4 loads hit distinct banks. P (and dS) travel as bf16
// [rows][64] in hopper's swizzle (`swz`), read back as wgmma A fragments.

// The cluster size of a head dim of nc column blocks: the largest divisor
// of nc that is at most 8, the portable limit.
__host__ __device__ __forceinline__ int wide_cluster_size(int nc) {
  for (int c = nc < 8 ? nc : 8; c > 1; --c)
    if (nc % c == 0) return c;
  return 1;
}

// Element offset of (row, col) in a swizzled f32 [rows][64] score tile.
__device__ __forceinline__ int fswz(int row, int col) {
  return row * 64 + ((((col >> 2) ^ (row & 7))) << 2) + (col & 3);
}

// The shared::cluster address of this CTA's shared `p` in CTA `rank`.
__device__ __forceinline__ uint32_t dsmem(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ float4 ld_dsmem_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_dsmem_u32x2(uint32_t addr, uint32_t a, uint32_t b) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a), "r"(b)
               : "memory");
}

__device__ __forceinline__ void st_dsmem_f32(uint32_t addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(x) : "memory");
}

// Every thread of every CTA of the cluster: what each wrote before
// (shared memory, local or remote) is visible to all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Sums over the cluster's ranks 0..cs-1 (cs <= 8), in rank order, of the
// float4 at `a` (and at `b`) in each rank's copy of a score tile. Every
// rank's load is issued before the first add, so a reduction waits on the
// network once, not cs times.
__device__ __forceinline__ float4 cluster_sum_f4(const float* a, int cs) {
  float4 x[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (r < cs) x[r] = ld_dsmem_f4(dsmem(a, r));
  float4 acc = x[0];
#pragma unroll
  for (int r = 1; r < 8; ++r)
    if (r < cs) {
      acc.x += x[r].x;
      acc.y += x[r].y;
      acc.z += x[r].z;
      acc.w += x[r].w;
    }
  return acc;
}

__device__ __forceinline__ void cluster_sum_f4x2(const float* a, const float* b, int cs,
                                                 float4& sa, float4& sb) {
  float4 x[8], y[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (r < cs) {
      x[r] = ld_dsmem_f4(dsmem(a, r));
      y[r] = ld_dsmem_f4(dsmem(b, r));
    }
  sa = x[0];
  sb = y[0];
#pragma unroll
  for (int r = 1; r < 8; ++r)
    if (r < cs) {
      sa.x += x[r].x;
      sa.y += x[r].y;
      sa.z += x[r].z;
      sa.w += x[r].w;
      sb.x += y[r].x;
      sb.y += y[r].y;
      sb.z += y[r].z;
      sb.w += y[r].w;
    }
}

// A 64 x 64 f32 accumulator (rows 16w + l/4 and + 8 of the warpgroup's
// tile, starting at row `row0`) stored to a swizzled f32 score tile.
__device__ __forceinline__ void store_scores(float* tile, int row0, int lane, int warp,
                                             const float (&s)[32]) {
  const int ra = row0 + warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + fswz(ra + 8 * h, 8 * x + c0)) =
          make_float2(s[4 * x + 2 * h], s[4 * x + 2 * h + 1]);
}

// The 4 k16 A fragments of rows [row0, row0 + 64) (this thread's rows
// 16w + l/4 and + 8) of a swizzled bf16 [rows][64] tile: pack_scores's
// layout.
__device__ __forceinline__ void load_fragments(uint32_t (&p)[16], const __nv_bfloat16* tile,
                                               int rows, int row0, int lane, int warp) {
  const int ra = row0 + warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      p[2 * x + h] = *reinterpret_cast<const uint32_t*>(tile + swz(rows, ra + 8 * h, 8 * x + c0));
}

}  // namespace
