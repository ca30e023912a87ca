// Shared device helpers for the flash-attention kernels: bf16 tensor-core
// products through mma.sync m16n8k16 with fp32 accumulators and fragment
// loads from padded shared-memory tiles (the dQ kernel, flash_bwd.cu); the
// packing of accumulators into A fragments, the causal / sliding-window
// visibility rule and the tile ranges it leaves (all kernels; the Hopper
// building blocks of flash_fwd.cu and flash_bwd_dkv.cu are in hopper.cuh).
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4*g + t, g = lane/4, t = lane%4):
//   A (16x16, row-major):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16x8, k by n):      b0 (k=2t..2t+1, n=g)  b1 (k=2t+8..2t+9, n=g)
//   C (16x8, f32):         c0,c1 (g, 2t..2t+1)   c2,c3 (g+8, 2t..2t+1)
// A C fragment pair over 16 columns is, packed to bf16, exactly an A fragment
// over the same 16 columns: a probability tile computed by one product feeds
// the next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nexus {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // four warps, sixteen tile rows each

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 values from two rows of one column
__device__ __forceinline__ uint32_t ld_pair(const bf16* p0, const bf16* p1) {
  uint32_t lo = *reinterpret_cast<const uint16_t*>(p0);
  uint32_t hi = *reinterpret_cast<const uint16_t*>(p1);
  return lo | (hi << 16);
}

// Copy ROWS rows of D bf16 (row r at base + (row0 + r) * row_stride) into a
// shared tile with leading dimension LD = D + 8. The pad of 16 bytes puts
// the eight rows a fragment load touches on distinct banks.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          long row_stride, int row0) {
  constexpr int LD = D + 8;
  constexpr int VEC = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < ROWS * VEC; i += kThreads) {
    int r = i / VEC, c = (i % VEC) * 8;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(base + (long)(row0 + r) * row_stride + c);
  }
}

// A fragment: rows row0..row0+15, columns 16*kk.. of a row-major tile
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* s, int row0,
                                       int kk, int g, int t) {
  const bf16* p = s + (row0 + g) * LD + kk * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B fragment when the tile holds B transposed, one row per n:
// n-block nb, k-chunk kk (the K tile in Q K^T)
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t* b, const bf16* s, int nb,
                                          int kk, int g, int t) {
  const bf16* p = s + (nb * 8 + g) * LD + kk * 16 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment when the tile holds B as it is, one row per k:
// k-chunk kk, n-block nb (the V tile in P V)
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t* b, const bf16* s, int kk,
                                          int nb, int g, int t) {
  const bf16* p = s + (kk * 16 + 2 * t) * LD + nb * 8 + g;
  b[0] = ld_pair(p, p + LD);
  b[1] = ld_pair(p + 8 * LD, p + 9 * LD);
}

// The C fragments of n-blocks 2kk and 2kk+1, packed as one A fragment.
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0,
                                       const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Query at sequence row `row` (global position row + q_offset) sees key `col`.
__device__ __forceinline__ bool visible(int row, int col, int causal,
                                        int q_offset, int window) {
  if (!causal) return true;
  int pos = row + q_offset;
  return col <= pos && (window <= 0 || col > pos - window);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Key tiles [*begin, *end) of width bn that hold a key visible to some query
// row in [m0, m0 + bm). Derived from the mask itself: the newest row bounds
// the causal edge, the oldest row the window's floor; clamped to the array.
// A tile that passes the end of the keys (sk not a multiple of bn) counts;
// its kernel masks the keys past sk.
__device__ __forceinline__ void key_tile_range(int m0, int bm, int bn, int sk,
                                               int causal, int q_offset,
                                               int window, int* begin,
                                               int* end) {
  *begin = 0;
  *end = (sk + bn - 1) / bn;  // a last tile may pass the end of the keys
  if (!causal) return;
  long kend = (long)m0 + bm - 1 + q_offset + 1;  // exclusive
  kend = kend < 0 ? 0 : (kend > sk ? sk : kend);
  long kstart = 0;
  if (window > 0) {
    kstart = (long)m0 + q_offset - window + 1;
    kstart = kstart < 0 ? 0 : kstart;
  }
  if (kstart >= kend) {
    *end = *begin;
    return;
  }
  *begin = (int)(kstart / bn);
  *end = (int)((kend + bn - 1) / bn);
}

// Query tiles [*begin, *end) of width bm that hold a row seeing some key in
// [c0, c0 + bn): the mirror of key_tile_range for the dK/dV kernel.
__device__ __forceinline__ void query_tile_range(int c0, int bn, int bm,
                                                 int sq, int causal,
                                                 int q_offset, int window,
                                                 int* begin, int* end) {
  *begin = 0;
  *end = sq / bm;
  if (!causal) return;
  long rstart = (long)c0 - q_offset;  // oldest row whose position reaches c0
  rstart = rstart < 0 ? 0 : rstart;
  long rend = sq;  // exclusive
  if (window > 0) {
    long w = (long)c0 + bn - 1 - q_offset + window;
    rend = w < rend ? w : rend;
  }
  if (rstart >= rend) {
    *end = *begin;
    return;
  }
  *begin = (int)(rstart / bm);
  *end = (int)((rend + bm - 1) / bm);
}

}  // namespace nexus
