// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces the TPU kernel `_flash_kernel` (nexus_tpu/ops/attention.py), which
// `_flash_impl` launches through pl.pallas_call. Same function: online-softmax
// attention over q (B,Sq,Hq,D) and k/v (B,Sk,Hkv,D), causal or not, with an
// optional q_offset and sliding window, GQA by head index (query head h reads
// kv head h / (Hq/Hkv); K/V are never repeated in memory). Writes out
// (B,Sq,Hq,D) in bf16 and the per-row logsumexp as a compact (B,Hq,Sq) f32
// buffer. A row that sees no key gets output 0 and logsumexp -inf.
//
// What bounds it on the H100: at the training shapes (S 4096, D 128) the
// causal work is ~2.7e11 FLOP per call against ~0.2 GB of traffic, so it is
// bound by tensor-core operations (989 TFLOP/s bf16 dense). The design keeps
// the S x S scores out of device memory: one block of four warps owns a
// 64-row q tile, walks the band of 64-wide k tiles that the mask leaves
// (the loop replaces the TPU grid's sequential dimension), stages each K/V
// tile in shared memory, and keeps the running max, sum and output
// accumulator in registers. Products are mma.sync m16n8k16; P goes from the
// score accumulators to the PV product without leaving registers, cast to
// bf16 as the TPU kernel casts it to V's dtype.
// Not yet done (later work): wgmma, TMA loads and warp specialisation, and
// double-buffered tiles, which the card needs for its full rate.

#include "flash_common.cuh"

namespace nexus {

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                     int causal, int q_offset, int window, float scale) {
  constexpr int BM = 64, BN = 64, LD = D + 8, ND = D / 8, NN = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BM * LD;
  bf16* sV = sK + BN * LD;

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;  // this warp's first row in the tile

  const long q_stride = (long)Hq * D, kv_stride = (long)Hkv * D;
  const bf16* qb = q + ((long)b * Sq * Hq + h) * D;
  const bf16* kb = k + ((long)b * Sk * Hkv + hk) * D;
  const bf16* vb = v + ((long)b * Sk * Hkv + hk) * D;

  load_tile<BM, D>(sQ, qb, q_stride, m0);

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  int kt0, kt1;
  key_tile_range(m0, BM, BN, Sk, causal, q_offset, window, &kt0, &kt1);
  const int row_a = m0 + wr + g, row_b = row_a + 8;

  for (int kt = kt0; kt < kt1; ++kt) {
    __syncthreads();  // the previous tiles are no longer read
    load_tile<BN, D>(sK, kb, kv_stride, kt * BN);
    load_tile<BN, D>(sV, vb, kv_stride, kt * BN);
    __syncthreads();

    float s[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      frag_a<LD>(a, sQ, wr, kk, g, t);
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        uint32_t bb[2];
        frag_b_nk<LD>(bb, sK, n, kk, g, t);
        mma16816(s[n], a, bb);
      }
    }

    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int col = kt * BN + n * 8 + 2 * t + (e & 1);
        int row = e < 2 ? row_a : row_b;
        float x = s[n][e] * scale;
        if (!visible(row, col, causal, q_offset, window)) x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_use[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      // a row with nothing visible yet keeps max -inf; subtract 0 instead
      // so that exp gives 0 and not NaN
      m_use[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = __expf(m_run[r] - m_use[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - m_use[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        uint32_t bb[2];
        frag_b_kn<LD>(bb, sV, kk, i, g, t);
        mma16816(acc[i], a, bb);
      }
    }
  }

  // a row that saw no key has l == 0 and acc == 0: output 0, lse -inf
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = l_run[r] == 0.f ? 0.f : 1.f / l_run[r];
  bf16* oa = o + (((long)b * Sq + row_a) * Hq + h) * D;
  bf16* ob = o + (((long)b * Sq + row_b) * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    int c = i * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(oa + c) = pack_bf16(acc[i][0] * inv[0], acc[i][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(ob + c) = pack_bf16(acc[i][2] * inv[1], acc[i][3] * inv[1]);
  }
  if (t == 0) {
    float* lb = lse + (long)bh * Sq;
    lb[row_a] = l_run[0] == 0.f ? -INFINITY : m_run[0] + logf(l_run[0]);
    lb[row_b] = l_run[1] == 0.f ? -INFINITY : m_run[1] + logf(l_run[1]);
  }
}

template <int D>
static int launch_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                      int causal, int q_offset, int window, float scale,
                      cudaStream_t stream) {
  const int smem = 3 * 64 * (D + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Sq / 64, B * Hq);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), Sq, Sk, Hq, Hkv, causal, q_offset, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace nexus

// Plain C entry for ctypes. Shapes are checked by the Python wrapper:
// Sq and Sk multiples of 64, D 64 or 128, Hq a multiple of Hkv, all tensors
// contiguous. Returns the cudaError_t of the launch.
extern "C" int nexus_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int Sq, int Sk,
                               int Hq, int Hkv, int D, int causal,
                               int q_offset, int window, float scale,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return nexus::launch_fwd<64>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal,
                                 q_offset, window, scale, st);
  if (D == 128)
    return nexus::launch_fwd<128>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal,
                                  q_offset, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
