// Paged-decode attention for Hopper (sm_90a): the serving engine's attention
// over its paged KV block pool, bf16 queries, bf16 or int8 pool, fp32
// softmax and accumulation.
//
// Replaces `fused_paged_decode_attention` (nexus_tpu/ops/attention.py), a
// plain JAX function with no pl.pallas_call: `paged_attention_partials` +
// `shared_prefix_attention_partials` + `merge_attention_partials`, whose
// slot loop runs `lax.fori_loop` to a TRACED trip count max(n_blocks). A
// plain PyTorch loop would need that count on the host, one device-to-host
// sync per layer per decode step; this kernel reads the valid-block counts,
// the row depths and the Hydragen split length on the device.
//
// Same function, element for element:
//   * q (B,T,Hq,D); one layer's pool k/v (N,Bs,Hkv,D), int8 with f32 scales
//     (N,Bs,Hkv); block_table (B,M); start, n_blocks (B,); shared_table (M,)
//     and shared_blocks (one int) for the Hydragen split; out (B,T,Hq,D).
//   * row b attends over its virtual positions 0 .. n_blocks[b]*Bs, with
//     n_blocks clipped to [1, M]: slot s < s_eff = clip(shared_blocks, 0,
//     max_b n_blocks[b]) reads pool block shared_table[s], any other slot
//     block_table[b, s]; slots at or past n_blocks[b] are invisible (never
//     read here: they would only ever add exactly nothing).
//   * position pos is visible to query t of row b when pos <= start[b] + t
//     and, with window > 0, pos > start[b] + t - window. Logits q.k * D^-0.5
//     in fp32; invisible positions take probability exactly 0; the running
//     max starts at the finite mask value -0.7*FLT_MAX, so a query row that
//     sees nothing keeps l == 0 and outputs 0.
//   * int8: each element dequantizes as bf16(float(x) * scale) before the
//     dot, bitwise the JAX `_dequant_block`.
//   * GQA: query head h reads kv head h / (Hq/Hkv); the raw Hkv blocks are
//     read, never repeated.
//
// What bounds it on the H100: bytes. At the serve shape (Llama-3-8B widths,
// Hkv 8, D 128, bf16) every visible position costs 2*8*128*2 = 4 KiB of K+V
// per layer, against 3.35 TB/s; the products are 2*D FLOP per (query,
// position) on CUDA cores, a few percent of the time the bytes take. So the
// design spends nothing on tensor cores and everything on keeping loads in
// flight over the whole card:
//   * one CTA (4 warps) per (row, kv head, slot split, row group). A row's
//     visible slot range (n_blocks, the causal edge of its newest query and
//     the window's floor, all read on the device) is cut into `splits`
//     equal parts, so B*Hkv*splits CTAs stream disjoint blocks at once
//     instead of B*Hkv (64 at the serve shape, under half of 132 SMs);
//   * a CTA holds its n_rep*T query rows (up to 32; more rows take more row
//     groups) in shared memory as fp32 and streams 32-position K/V tiles:
//     each thread issues the 16-byte loads of the NEXT tile into registers
//     before the current tile's arithmetic, then converts them (dequantizes
//     int8) into bf16 shared-memory tiles;
//   * q.k: lane j owns key j of the tile (K rows padded by 16 bytes, so a
//     warp's 16-byte row reads are conflict-free); each warp owns every
//     fourth query row (the kernel is instantiated for 1, 2, 4 or 8 rows a
//     warp, the fewest that hold the CTA's rows), reduces its max and sum
//     with shuffles, and folds P.V with lanes over the head dim, reading
//     the probabilities back from shared memory four keys at a time;
//   * each CTA writes its (m, l, acc) partial in fp32; a second small kernel
//     merges a query row's splits by log-sum-exp (the JAX merge) and casts.
// Reading a Hydragen shared block once for the whole wave, wgmma for the
// T > 1 prefill feeds and a tuned split count are later work (ROADMAP).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nexus_decode {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TK = 32;                     // positions per K/V tile
constexpr int RPW = 8;                     // query rows per warp, at most
constexpr int ROWS = WARPS * RPW;          // query rows per CTA, at most (the
                                           // wrapper's row groups assume it)
constexpr float MASK = -0.7f * 3.402823466e38f;

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

__device__ __forceinline__ void unpack8(uint4 u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

struct Args {
  const bf16* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* block_table;
  const int* start;
  const int* n_blocks;
  const int* shared_table;
  const int* shared_blocks;
  float* part_m;
  float* part_l;
  float* part_acc;
  int B, T, Hq, Hkv, N, Bs, M, window, splits;
  float scale;
};

// The 16-byte chunks of one tile (K then V), spread over the threads.
template <int D, bool INT8>
struct Loads {
  static constexpr int ELEMS = INT8 ? 16 : 8;        // elements per chunk
  static constexpr int CPR = D / ELEMS;              // chunks per row
  static constexpr int PER_KV = TK * CPR;            // chunks per K tile
  static constexpr int PER_THREAD = (2 * PER_KV + THREADS - 1) / THREADS;
};

// RW: query rows per warp (1, 2, 4 or 8), the fewest that hold a CTA's
// rows, so that no warp loops over rows it does not have.
template <int D, bool INT8, int RW>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(Args a) {
  using L = Loads<D, INT8>;
  constexpr int KSTRIDE = D + 8;  // bf16 elements per padded K row
  constexpr int DPL = D / 32;     // head-dim elements per lane in P.V
  constexpr int CTA_ROWS = WARPS * RW;

  __shared__ __align__(16) float qs[CTA_ROWS * D];
  __shared__ __align__(16) float ps[CTA_ROWS * TK];  // each row's tile probabilities
  __shared__ __align__(16) bf16 ks[TK * KSTRIDE];
  __shared__ __align__(16) bf16 vs[TK * D];

  const int b = blockIdx.x / a.Hkv;
  const int g = blockIdx.x % a.Hkv;
  const int split = blockIdx.y;
  const int n_rep = a.Hq / a.Hkv;
  const int R = n_rep * a.T;
  const int row0 = blockIdx.z * CTA_ROWS;
  const int nrows = min(CTA_ROWS, R - row0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the loop bounds, on the device: max clipped n_blocks over the batch for
  // the Hydragen split, this row's own count and its visible slot range
  int hi = 1;
  for (int r = 0; r < a.B; ++r) hi = max(hi, min(max(a.n_blocks[r], 1), a.M));
  const int nb = min(max(a.n_blocks[b], 1), a.M);
  const int s_eff = a.shared_blocks ? min(max(a.shared_blocks[0], 0), hi) : 0;
  const int st = a.start[b];
  const int last = st + a.T - 1;  // newest query position
  int s_hi = last < 0 ? 0 : min(nb, last / a.Bs + 1);
  int s_lo = 0;
  if (a.window > 0 && st - a.window + 1 > 0) s_lo = (st - a.window + 1) / a.Bs;
  if (s_hi < s_lo) s_hi = s_lo;
  const int span = s_hi - s_lo;
  const int s_begin = s_lo + (int)((long)span * split / a.splits);
  const int s_end = s_lo + (int)((long)span * (split + 1) / a.splits);
  const int n_sub = (a.Bs + TK - 1) / TK;
  const int n_tiles = (s_end - s_begin) * n_sub;

  // this CTA's query rows: local row lr = warp + WARPS*i is query row
  // row0 + lr = rep*T + t of kv head g
  for (int i = tid; i < nrows * D; i += THREADS) {
    int lr = i / D, d = i % D;
    int ri = row0 + lr, rep = ri / a.T, t = ri % a.T;
    int h = g * n_rep + rep;
    qs[lr * D + d] = __bfloat162float(a.q[(((size_t)b * a.T + t) * a.Hq + h) * D + d]);
  }

  float m[RW], l[RW], acc[RW][DPL];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = MASK;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  uint4 raw[L::PER_THREAD];
  float rsc[L::PER_THREAD];

  // issue the loads of tile u (slot s_begin + u/n_sub, positions
  // (u%n_sub)*TK ..) into registers; rows past the block's end read nothing
  // and land as zeros
  auto fetch = [&](int u) {
    const int s = s_begin + u / n_sub;
    const int p0 = (u % n_sub) * TK;
    const int blk = s < s_eff ? a.shared_table[s] : a.block_table[(size_t)b * a.M + s];
#pragma unroll
    for (int n = 0; n < L::PER_THREAD; ++n) {
      const int i = tid + n * THREADS;
      raw[n] = make_uint4(0, 0, 0, 0);
      rsc[n] = 0.f;
      if (i >= 2 * L::PER_KV) continue;
      const int which = i / L::PER_KV, r = i % L::PER_KV;
      const int j = r / L::CPR, cc = r % L::CPR;
      if (p0 + j >= a.Bs) continue;
      const size_t row = ((size_t)blk * a.Bs + p0 + j) * a.Hkv + g;
      const char* base = static_cast<const char*>(which ? a.v_pool : a.k_pool);
      raw[n] = *reinterpret_cast<const uint4*>(base + (row * D + cc * L::ELEMS) * (INT8 ? 1 : 2));
      if (INT8) rsc[n] = (which ? a.v_scale : a.k_scale)[row];
    }
  };

  // registers → bf16 shared-memory tiles (int8: dequantized, then rounded
  // to bf16 as the JAX function casts to the compute dtype)
  auto commit = [&]() {
#pragma unroll
    for (int n = 0; n < L::PER_THREAD; ++n) {
      const int i = tid + n * THREADS;
      if (i >= 2 * L::PER_KV) continue;
      const int which = i / L::PER_KV, r = i % L::PER_KV;
      const int j = r / L::CPR, cc = r % L::CPR;
      bf16* dst = which ? vs + j * D + cc * L::ELEMS : ks + j * KSTRIDE + cc * L::ELEMS;
      if (INT8) {
        const int8_t* x = reinterpret_cast<const int8_t*>(&raw[n]);
        uint4 w[2];
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(w);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = __floats2bfloat162_rn((float)x[2 * e] * rsc[n], (float)x[2 * e + 1] * rsc[n]);
        reinterpret_cast<uint4*>(dst)[0] = w[0];
        reinterpret_cast<uint4*>(dst)[1] = w[1];
      } else {
        *reinterpret_cast<uint4*>(dst) = raw[n];
      }
    }
  };

  if (n_tiles > 0) fetch(0);
  for (int u = 0; u < n_tiles; ++u) {
    __syncthreads();  // the previous tile's readers are done (and qs is filled)
    commit();
    __syncthreads();
    if (u + 1 < n_tiles) fetch(u + 1);  // in flight during this tile's arithmetic

    const int s = s_begin + u / n_sub;
    const int p0 = (u % n_sub) * TK;
    const int nk = min(TK, a.Bs - p0);
    const int pos = s * a.Bs + p0 + lane;

    // scores: lane owns key `lane`, every row of this warp
    float sc[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) sc[i] = 0.f;
    const bf16* krow = ks + lane * KSTRIDE;
#pragma unroll
    for (int c8 = 0; c8 < D / 8; ++c8) {
      float kf[8];
      unpack8(*reinterpret_cast<const uint4*>(krow + c8 * 8), kf);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int lr = warp + WARPS * i;
        if (lr < nrows) {
          const float4* qv = reinterpret_cast<const float4*>(qs + lr * D + c8 * 8);
          const float4 x = qv[0], y = qv[1];
          sc[i] += x.x * kf[0] + x.y * kf[1] + x.z * kf[2] + x.w * kf[3] +
                   y.x * kf[4] + y.y * kf[5] + y.z * kf[6] + y.w * kf[7];
        }
      }
    }

    // online softmax per row; lane j's probability goes to the row's slot
    // j of ps (0 for an invisible key), read back four at a time in P.V
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int lr = warp + WARPS * i;
      if (lr >= nrows) continue;  // uniform over the warp
      const int qpos = st + (row0 + lr) % a.T;
      const bool vis = lane < nk && pos <= qpos && (a.window <= 0 || pos > qpos - a.window);
      const float sv = vis ? sc[i] * a.scale : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(sv));
      const float p = vis ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p);
      m[i] = m_new;
      ps[lr * TK + lane] = p;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha;
    }
    __syncwarp();

    // P.V: lanes over the head dim, four keys at a time; keys past nk have
    // zero values and zero probability
    for (int j = 0; j < nk; j += 4) {
      float vf[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const bf16* vrow = vs + (j + jj) * D + lane * DPL;
        if constexpr (DPL == 4) {  // one 8-byte load
          const uint2 w = *reinterpret_cast<const uint2*>(vrow);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
          const float2 up = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
          vf[jj][0] = lo.x;
          vf[jj][1] = lo.y;
          vf[jj][2] = up.x;
          vf[jj][3] = up.y;
        } else {
#pragma unroll
          for (int e = 0; e < DPL; e += 2) {
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vrow + e));
            vf[jj][e] = x.x;
            vf[jj][e + 1] = x.y;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int lr = warp + WARPS * i;
        if (lr >= nrows) continue;  // uniform over the warp
        const float4 p4 = *reinterpret_cast<const float4*>(ps + lr * TK + j);
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          acc[i][e] += p4.x * vf[0][e] + p4.y * vf[1][e] + p4.z * vf[2][e] + p4.w * vf[3][e];
      }
    }
  }

  // this split's partial state of each of the warp's rows
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int lr = warp + WARPS * i;
    if (lr >= nrows) continue;
    const int ri = row0 + lr, rep = ri / a.T, t = ri % a.T;
    const int h = g * n_rep + rep;
    const size_t at = (((size_t)b * a.Hq + h) * a.T + t) * a.splits + split;
    if (lane == 0) {
      a.part_m[at] = m[i];
      a.part_l[at] = l[i];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) a.part_acc[at * D + lane * DPL + e] = acc[i][e];
  }
}

// One query row (b, t, h) per block, one head-dim element per thread: the
// log-sum-exp merge of its splits' partials, then acc / l (0 when l == 0).
__global__ void paged_decode_merge_kernel(const float* part_m, const float* part_l,
                                          const float* part_acc, bf16* out, int T,
                                          int Hq, int D, int splits) {
  const int bth = blockIdx.x;  // (b*T + t)*Hq + h, the layout of out
  const int h = bth % Hq, t = (bth / Hq) % T, b = bth / (Hq * T);
  const size_t at = (((size_t)b * Hq + h) * T + t) * splits;
  const int d = threadIdx.x;
  float m = MASK;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_m[at + s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float e = expf(part_m[at + s] - m);
    l += part_l[at + s] * e;
    acc += part_acc[(at + s) * D + d] * e;
  }
  out[(size_t)bth * D + d] = __float2bfloat16_rn(l == 0.f ? 0.f : acc / l);
}

template <int D, bool INT8, int RW>
int launch_rows(const Args& a, bf16* out, cudaStream_t st) {
  const int R = (a.Hq / a.Hkv) * a.T;
  dim3 grid(a.B * a.Hkv, a.splits, (R + WARPS * RW - 1) / (WARPS * RW));
  paged_decode_kernel<D, INT8, RW><<<grid, THREADS, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_merge_kernel<<<a.B * a.T * a.Hq, D, 0, st>>>(
      a.part_m, a.part_l, a.part_acc, out, a.T, a.Hq, D, a.splits);
  return (int)cudaGetLastError();
}

// Rows per warp: the fewest of 1, 2, 4, 8 that hold min(R, ROWS) rows in
// four warps (more than ROWS rows take more row groups, grid.z).
template <int D, bool INT8>
int launch(const Args& a, bf16* out, cudaStream_t st) {
  const int R = (a.Hq / a.Hkv) * a.T;
  if (R <= WARPS) return launch_rows<D, INT8, 1>(a, out, st);
  if (R <= 2 * WARPS) return launch_rows<D, INT8, 2>(a, out, st);
  if (R <= 4 * WARPS) return launch_rows<D, INT8, 4>(a, out, st);
  return launch_rows<D, INT8, RPW>(a, out, st);
}

}  // namespace nexus_decode

extern "C" int nexus_paged_decode(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* block_table, const void* start, const void* n_blocks,
    const void* shared_table, const void* shared_blocks, void* out, void* part_m,
    void* part_l, void* part_acc, int B, int T, int Hq, int Hkv, int D, int N, int Bs,
    int M, int window, int splits, int int8, float scale, void* stream) {
  using namespace nexus_decode;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.block_table = static_cast<const int*>(block_table);
  a.start = static_cast<const int*>(start);
  a.n_blocks = static_cast<const int*>(n_blocks);
  a.shared_table = static_cast<const int*>(shared_table);
  a.shared_blocks = static_cast<const int*>(shared_blocks);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.B = B; a.T = T; a.Hq = Hq; a.Hkv = Hkv; a.N = N; a.Bs = Bs; a.M = M;
  a.window = window; a.splits = splits; a.scale = scale;
  if (Hkv <= 0 || Hq % Hkv || T < 1 || Bs < 1 || M < 1 || splits < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* o = static_cast<bf16*>(out);
  if (D == 64) return int8 ? launch<64, true>(a, o, st) : launch<64, false>(a, o, st);
  if (D == 128) return int8 ? launch<128, true>(a, o, st) : launch<128, false>(a, o, st);
  return (int)cudaErrorInvalidValue;
}
