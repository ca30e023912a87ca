// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, bf16 in, fp32 accumulation.
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`
// (nexus_tpu/ops/attention.py), which `_flash_bwd_impl` launches through
// pl.pallas_call. With S = scale * Q K^T and P = exp(S - lse) recomputed
// tile by tile from the forward's logsumexp:
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O) - g_lse
//   dQ = scale * dS K            (flash_bwd_dq_kernel)
//   dK = scale * dS^T Q, dV = P^T dO, summed over the n_rep query heads of
//   each kv head                 (flash_bwd_dkv_kernel)
// delta is computed by the caller in PyTorch, as the JAX package computes it
// outside Pallas.
//
// What bounds them on the H100: at the training shapes each kernel does
// 2-3x the forward's tensor-core work on the same few hundred MB, so both are
// bound by operations. The designs keep S, P and dS out of device memory:
//   dQ:   one block per (b*Hq, 64-row q tile); loops over the k tiles of the
//         mask's band, K/V staged in shared memory, dQ in registers.
//   dK/dV: one block per (b*Hkv, 64-row k tile); loops over the n_rep query
//         heads of the group and, for each, over the 32-row q tiles of the
//         band. dK and dV of the whole group accumulate in one fp32 register
//         tile, so no atomics and no per-query-head buffer are needed (the
//         TPU kernel's group-summing grid does the same in VMEM scratch).
// Not yet done (later work): wgmma, TMA loads, warp specialisation and
// double-buffered tiles.

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
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                         int Sk, int Hq, int Hkv, int causal, int q_offset,
                         int window, float scale) {
  // BN key rows per block (16 per warp), BM query rows per inner step
  constexpr int BN = 64, BM = 32, LD = D + 8, ND = D / 8, NM = BM / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BN * LD;
  bf16* sQ = sV + BN * LD;
  bf16* sdO = sQ + BM * LD;
  float* sL = reinterpret_cast<float*>(sdO + BM * LD);
  float* sD = sL + BM;

  const int bhk = blockIdx.y, b = bhk / Hkv, hk = bhk % Hkv;
  const int n_rep = Hq / Hkv;
  const int c0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;

  const long q_stride = (long)Hq * D, kv_stride = (long)Hkv * D;
  const long kvoff = ((long)b * Sk * Hkv + hk) * D;
  load_tile<BN, D>(sK, k + kvoff, kv_stride, c0);
  load_tile<BN, D>(sV, v + kvoff, kv_stride, c0);

  const int key_a = c0 + wr + g, key_b = key_a + 8;

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  }

  int it0, it1;
  query_tile_range(c0, BN, BM, Sq, causal, q_offset, window, &it0, &it1);

  for (int member = 0; member < n_rep; ++member) {
    const int h = hk * n_rep + member;
    const long qoff = ((long)b * Sq * Hq + h) * D;
    const float* lrow = lse + ((long)b * Hq + h) * Sq;
    const float* drow = delta + ((long)b * Hq + h) * Sq;
    for (int it = it0; it < it1; ++it) {
      const int r0 = it * BM;
      __syncthreads();
      load_tile<BM, D>(sQ, q + qoff, q_stride, r0);
      load_tile<BM, D>(sdO, dout + qoff, q_stride, r0);
      if (threadIdx.x < BM) {
        sL[threadIdx.x] = lrow[r0 + threadIdx.x];
        sD[threadIdx.x] = drow[r0 + threadIdx.x];
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T, rows = keys, columns = queries
      float s[NM][4], dp[NM][4];
#pragma unroll
      for (int n = 0; n < NM; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        frag_a<LD>(ak, sK, wr, kk, g, t);
        frag_a<LD>(av, sV, wr, kk, g, t);
#pragma unroll
        for (int n = 0; n < NM; ++n) {
          uint32_t bb[2];
          frag_b_nk<LD>(bb, sQ, n, kk, g, t);
          mma16816(s[n], ak, bb);
          frag_b_nk<LD>(bb, sdO, n, kk, g, t);
          mma16816(dp[n], av, bb);
        }
      }
      // P^T into s, dS^T into dp
#pragma unroll
      for (int n = 0; n < NM; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int lc = n * 8 + 2 * t + (e & 1);
          int key = (e >> 1) ? key_b : key_a;
          float p = visible(r0 + lc, key, causal, q_offset, window)
                        ? __expf(s[n][e] * scale - sL[lc])
                        : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - sD[lc]);
        }
      }
      // dV += P^T dO, dK += dS^T Q (B operands indexed by query row)
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        uint32_t ap[4], ads[4];
        c_to_a(ap, s[2 * kk], s[2 * kk + 1]);
        c_to_a(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          uint32_t bb[2];
          frag_b_kn<LD>(bb, sdO, kk, i, g, t);
          mma16816(dv_acc[i], ap, bb);
          frag_b_kn<LD>(bb, sQ, kk, i, g, t);
          mma16816(dk_acc[i], ads, bb);
        }
      }
    }
  }

  bf16* dka = dk + kvoff + (long)key_a * kv_stride;
  bf16* dkb = dk + kvoff + (long)key_b * kv_stride;
  bf16* dva = dv + kvoff + (long)key_a * kv_stride;
  bf16* dvb = dv + kvoff + (long)key_b * kv_stride;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    int c = i * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dka + c) = pack_bf16(dk_acc[i][0] * scale, dk_acc[i][1] * scale);
    *reinterpret_cast<uint32_t*>(dkb + c) = pack_bf16(dk_acc[i][2] * scale, dk_acc[i][3] * scale);
    *reinterpret_cast<uint32_t*>(dva + c) = pack_bf16(dv_acc[i][0], dv_acc[i][1]);
    *reinterpret_cast<uint32_t*>(dvb + c) = pack_bf16(dv_acc[i][2], dv_acc[i][3]);
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

template <int D>
static int launch_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int Sq, int Sk, int Hq,
                      int Hkv, int causal, int q_offset, int window,
                      float scale, cudaStream_t stream) {
  const int smem =
      (2 * 64 + 2 * 32) * (D + 8) * (int)sizeof(bf16) + 2 * 32 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Sk / 64, B * Hkv);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, Hq, Hkv,
      causal, q_offset, window, scale);
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

extern "C" int nexus_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int B, int Sq, int Sk, int Hq, int Hkv,
                                   int D, int causal, int q_offset, int window,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return nexus::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk,
                                 Hq, Hkv, causal, q_offset, window, scale, st);
  if (D == 128)
    return nexus::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, Sq,
                                  Sk, Hq, Hkv, causal, q_offset, window, scale,
                                  st);
  return (int)cudaErrorInvalidValue;
}
