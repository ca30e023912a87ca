// Shared device helpers for the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu, flash_bwd_dkv.cu; their Hopper building blocks are in
// hopper.cuh): the packing of fp32 accumulators into bf16 A fragments, the
// causal / sliding-window visibility rule and the tile ranges it leaves,
// and the reductions over the four lanes that share a row.
//
// Accumulator and A fragment layouts, per 16 rows and per 8 (C) or 16 (A)
// columns (lane = 4*g + t, g = lane/4, t = lane%4):
//   C (16x8, f32):         c0,c1 (g, 2t..2t+1)   c2,c3 (g+8, 2t..2t+1)
//   A (16x16, bf16 pairs): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
