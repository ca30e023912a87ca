// Flash-attention backward, dQ, for Hopper (sm_90a): bf16 in, fp32
// accumulation.
//
// Replaces the TPU kernel `_flash_bwd_dq_kernel` (nexus_tpu/ops/attention.py),
// which `_flash_bwd_impl` launches through pl.pallas_call. With
// S = scale * Q K^T and P = exp(S - lse) recomputed tile by tile from the
// forward's logsumexp:
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O) - g_lse
//   dQ = scale * dS K
// delta is computed by the caller in PyTorch, as the JAX package computes it
// outside Pallas. (dK and dV are flash_bwd_dkv.cu.)
//
// What bounds it on the H100: at the training shapes it does 1.5x the
// forward's tensor-core work on the same few hundred MB, so it is bound by
// operations. The design keeps S, P and dS out of device memory: one block
// per (b*Hq, 64-row q tile) loops over the k tiles of the mask's band, K/V
// staged in shared memory, dQ in registers; products are mma.sync m16n8k16.
// This is still the first, simple design: no wgmma, no TMA, no warp
// specialisation and single-buffered tiles (ROADMAP: K2 Hopper redesign).

#include "flash_common.cuh"

namespace nexus {

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int Sq, int Sk, int Hq, int Hkv, int causal,
                        int q_offset, int window, float scale) {
  constexpr int BM = 64, BN = 64, LD = D + 8, ND = D / 8, NN = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BM * LD;
  bf16* sK = sdO + BM * LD;
  bf16* sV = sK + BN * LD;

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;

  const long q_stride = (long)Hq * D, kv_stride = (long)Hkv * D;
  const long qoff = ((long)b * Sq * Hq + h) * D;
  const bf16* kb = k + ((long)b * Sk * Hkv + hk) * D;
  const bf16* vb = v + ((long)b * Sk * Hkv + hk) * D;

  load_tile<BM, D>(sQ, q + qoff, q_stride, m0);
  load_tile<BM, D>(sdO, dout + qoff, q_stride, m0);

  const int row_a = m0 + wr + g, row_b = row_a + 8;
  const float lse_r[2] = {lse[(long)bh * Sq + row_a], lse[(long)bh * Sq + row_b]};
  const float dlt_r[2] = {delta[(long)bh * Sq + row_a], delta[(long)bh * Sq + row_b]};

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int kt0, kt1;
  key_tile_range(m0, BM, BN, Sk, causal, q_offset, window, &kt0, &kt1);

  for (int kt = kt0; kt < kt1; ++kt) {
    __syncthreads();
    load_tile<BN, D>(sK, kb, kv_stride, kt * BN);
    load_tile<BN, D>(sV, vb, kv_stride, kt * BN);
    __syncthreads();

    float s[NN][4], dp[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      frag_a<LD>(aq, sQ, wr, kk, g, t);
      frag_a<LD>(ado, sdO, wr, kk, g, t);
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        uint32_t bb[2];
        frag_b_nk<LD>(bb, sK, n, kk, g, t);
        mma16816(s[n], aq, bb);
        frag_b_nk<LD>(bb, sV, n, kk, g, t);
        mma16816(dp[n], ado, bb);
      }
    }
    // dS = P * (dP - delta), P recomputed from the saved logsumexp
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int col = kt * BN + n * 8 + 2 * t + (e & 1);
        int r = e >> 1;
        float p = visible(r ? row_b : row_a, col, causal, q_offset, window)
                      ? __expf(s[n][e] * scale - lse_r[r])
                      : 0.f;
        s[n][e] = p * (dp[n][e] - dlt_r[r]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        uint32_t bb[2];
        frag_b_kn<LD>(bb, sK, kk, i, g, t);
        mma16816(acc[i], a, bb);
      }
    }
  }

  bf16* da = dq + qoff + (long)row_a * q_stride;
  bf16* db = dq + qoff + (long)row_b * q_stride;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    int c = i * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(da + c) = pack_bf16(acc[i][0] * scale, acc[i][1] * scale);
    *reinterpret_cast<uint32_t*>(db + c) = pack_bf16(acc[i][2] * scale, acc[i][3] * scale);
  }
}

template <int D>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int Sq, int Sk, int Hq, int Hkv,
                     int causal, int q_offset, int window, float scale,
                     cudaStream_t stream) {
  const int smem = 4 * 64 * (D + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Sq / 64, B * Hq);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Sq, Sk, Hq, Hkv, causal, q_offset, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace nexus

// Plain C entries for ctypes; the Python wrapper checks shapes (Sq, Sk
// multiples of 64, D 64 or 128, Hq a multiple of Hkv, contiguous tensors).
// lse and delta are (B, Hq, Sq) f32. Return the cudaError_t of the launch.
extern "C" int nexus_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int B, int Sq,
                                  int Sk, int Hq, int Hkv, int D, int causal,
                                  int q_offset, int window, float scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return nexus::launch_dq<64>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, Hq,
                                Hkv, causal, q_offset, window, scale, st);
  if (D == 128)
    return nexus::launch_dq<128>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, Hq,
                                 Hkv, causal, q_offset, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
