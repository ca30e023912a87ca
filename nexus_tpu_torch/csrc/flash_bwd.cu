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
// outside Pallas; lse and delta are (B, Hq, Sq) f32. dS is cast to bf16
// before the dS K product, as the TPU kernel casts it to K's dtype. A row
// that sees no key gets dQ 0: P is masked before it meets delta. (dK and dV
// are flash_bwd_dkv.cu.)
//
// What bounds it on the H100: three products per visible (query, key) pair,
// 6D FLOP, 1.5x the forward's tensor-core work on the same few hundred MB,
// so it is bound by operations (989 TFLOP/s bf16 dense), which only wgmma
// reaches. The design follows the forward's (flash_fwd.cu), with a second
// score product and another epilogue:
//   * one block per 128 query rows of one (batch, query head): a producer
//     warpgroup and two consumer warpgroups of 64 rows each; setmaxnreg
//     moves the producer's registers to the consumers;
//   * the producer (one thread) TMA-loads the Q and dO tiles once, then
//     streams the K and V tiles (64 keys) of the mask's band through a
//     three-stage ring; K and V have their own full/empty mbarriers: V is
//     free once dP = dO V^T has read it, K only after dQ += dS K, one tile
//     later, so the ring is one stage deeper than the forward's;
//   * S = Q K^T and dP = dO V^T are wgmma m64n64k16 with all four operands
//     in shared memory (K-major); P and dS stay in registers, dS cast to
//     bf16 as the A operand of dQ += dS K (K MN-major, transpose bit), and
//     dQ accumulates in fp32 registers;
//   * each consumer issues S_i and dP_i together with dQ += dS_{i-1} K_{i-1}
//     and computes dS_i while that product is on the tensor cores. The two
//     consumer warpgroups are not made to take turns on the tensor cores
//     (the forward's ping-pong): on the H100 that measured no faster here;
//   * P = exp2(S scale log2(e) - lse log2(e)): one fma and one exp2 a score;
//     per-element masks only in the tiles that cross the causal diagonal or
//     the window's floor, a separate instantiation, so that the others carry
//     no per-element test;
//   * under causal masking the grid walks the query tiles from the last
//     (the most key tiles) to the first, so the heaviest blocks start first;
//   * dQ * scale is written in bf16 into the warpgroup's rows of the Q tile,
//     in the TMA's swizzle, and stored by TMA, 64 rows by 64 columns a box.
// Rows past Sq (a ragged last tile) read zeros from the TMA and are not
// stored; each thread reads lse and delta for its own two rows, guarded by
// row < Sq. A key tile never passes Sk: both are multiples of 64.

#include "hopper.cuh"

namespace nexus {

template <int D>
struct DqTiles {
  static constexpr int BM = 128, BN = 64, STAGES = 3;
  static constexpr int Q_BYTES = BM * D * 2;   // a Q or dO tile
  static constexpr int KV_BYTES = BN * D * 2;  // one K or V tile
  static constexpr int BARRIERS = 1 + 4 * STAGES;
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + BARRIERS * 8;
};

// P = exp2(S scale log2(e) - lse log2(e)) and dS = P (dP - delta) of one
// tile, dS in place of dP. P is masked before it meets delta, so a row that
// sees no key (lse -inf) gives 0. MASK is a template argument so that the
// tiles inside the band carry no per-element test.
template <int BN, bool MASK>
__device__ __forceinline__ void grad_tile(const float* s, float* dp, int c0,
                                          const int* rows, int t, int causal,
                                          int q_offset, int window,
                                          float scale_log2, const float* lse2,
                                          const float* dlt) {
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = exp2_approx(fmaf(s[4 * n + e], scale_log2, -lse2[r]));
      if (MASK) {
        const int col = c0 + 8 * n + 2 * t + (e & 1);
        if (!visible(rows[r], col, causal, q_offset, window)) p = 0.f;
      }
      dp[4 * n + e] = p * (dp[4 * n + e] - dlt[r]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tdq,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, int Sq, int Sk,
                        int Hq, int Hkv, int causal, int q_offset, int window,
                        float scale) {
  using T = DqTiles<D>;
  constexpr int BM = T::BM, BN = T::BN, STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sdO = sQ + T::Q_BYTES;
  unsigned char* sK = sdO + T::Q_BYTES;
  unsigned char* sV = sK + STAGES * T::KV_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + STAGES * T::KV_BYTES);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int mt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int m0 = mt * BM;
  int kt0, kt1;
  key_tile_range(m0, BM, BN, Sk, causal, q_offset, window, &kt0, &kt1);
  const int n_tiles = kt1 - kt0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 2 * kWarpgroup);
      mbar_init(&empty_v[s], 2 * kWarpgroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  if (wg == 0) {
    // producer: one thread issues every copy. V of a stage is free once
    // dO V^T has read it, K only after dQ += dS K, one tile later.
    regs_dec<kProducerRegs>();
    if (tid == 0) {
      mbar_expect_tx(bar_q, 2 * T::Q_BYTES);
#pragma unroll
      for (int r = 0; r < D / 64; ++r) {
        tma_load_4d(sQ + r * BM * 128, &tq, bar_q, r * 64, h, m0, b);
        tma_load_4d(sdO + r * BM * 128, &tdo, bar_q, r * 64, h, m0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, kt = kt0 + i;
        const int phase = (i / STAGES - 1) & 1;
        unsigned char* k_s = sK + s * T::KV_BYTES;
        unsigned char* v_s = sV + s * T::KV_BYTES;
        if (i >= STAGES) mbar_wait(&empty_v[s], phase);
        mbar_expect_tx(&full_v[s], T::KV_BYTES);
#pragma unroll
        for (int r = 0; r < D / 64; ++r)
          tma_load_4d(v_s + r * BN * 128, &tv, &full_v[s], r * 64, hk, kt * BN, b);
        if (i >= STAGES) mbar_wait(&empty_k[s], phase);
        mbar_expect_tx(&full_k[s], T::KV_BYTES);
#pragma unroll
        for (int r = 0; r < D / 64; ++r)
          tma_load_4d(k_s + r * BN * 128, &tk, &full_k[s], r * 64, hk, kt * BN, b);
      }
    }
  } else {
    // consumers: warpgroup cw owns query rows m0 + 64 cw .. + 63.
    // Software pipeline: iteration i issues S_i = Q K_i^T, dP_i = dO V_i^T
    // and dQ += dS_{i-1} K_{i-1} together, then computes dS_i while the dQ
    // product is still on the tensor cores.
    regs_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32, t = lane % 4;
    const int row0 = m0 + 64 * cw;
    const int rows[2] = {row0 + 16 * warp + lane / 4,
                         row0 + 16 * warp + lane / 4 + 8};
    const uint32_t q_base = smem_u32(sQ) + cw * 64 * 128;
    const uint32_t do_base = smem_u32(sdO) + cw * 64 * 128;
    const float scale_log2 = scale * kLog2e;
    // lse (base 2) and delta of this thread's two rows; rows past Sq have
    // zero Q and dO rows from the TMA and are not stored
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = rows[r] < Sq;
      lse2[r] = in ? lse[(long)bh * Sq + rows[r]] * kLog2e : 0.f;
      dlt[r] = in ? delta[(long)bh * Sq + rows[r]] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[BN / 2], dp[BN / 2];
    uint32_t da[BN / 16][4];

    auto issue_s_dp = [&](int i) {
      const uint32_t k_base = smem_u32(sK + (i % STAGES) * T::KV_BYTES);
      const uint32_t v_base = smem_u32(sV + (i % STAGES) * T::KV_BYTES);
      wgmma_ss_zero<BN>(sc, kmajor_desc(q_base, 0, BM * 128),
                        kmajor_desc(k_base, 0, BN * 128));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss<BN>(sc, kmajor_desc(q_base, kk, BM * 128),
                     kmajor_desc(k_base, kk, BN * 128));
      wgmma_ss_zero<BN>(dp, kmajor_desc(do_base, 0, BM * 128),
                        kmajor_desc(v_base, 0, BN * 128));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss<BN>(dp, kmajor_desc(do_base, kk, BM * 128),
                     kmajor_desc(v_base, kk, BN * 128));
      wgmma_commit();
    };
    auto issue_dq = [&](int i) {
      const uint32_t k_base = smem_u32(sK + (i % STAGES) * T::KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<D>(acc, da[kk], mnmajor_desc(k_base, kk, BN * 128));
      wgmma_commit();
    };
    // dS_i into dp; masks per element only where the tile is not wholly
    // visible to this warpgroup's rows
    auto grad = [&](int i) {
      const int c0 = (kt0 + i) * BN;
      const bool edge =
          causal && !(c0 + BN - 1 <= row0 + q_offset &&
                      (window <= 0 || c0 > row0 + 63 + q_offset - window));
      if (edge)
        grad_tile<BN, true>(sc, dp, c0, rows, t, causal, q_offset, window,
                            scale_log2, lse2, dlt);
      else
        grad_tile<BN, false>(sc, dp, c0, rows, t, causal, q_offset, window,
                             scale_log2, lse2, dlt);
    };
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) c_to_a(da[kk], &dp[8 * kk], &dp[8 * kk + 4]);
    };

    mbar_wait(bar_q, 0);
    if (n_tiles > 0) {
      mbar_wait(&full_v[0], 0);
      mbar_wait(&full_k[0], 0);
      wgmma_fence();
      issue_s_dp(0);
      wgmma_wait<0>();
      fence_regs<BN / 2>(sc);
      fence_regs<BN / 2>(dp);
      mbar_arrive(&empty_v[0]);
      grad(0);
      pack();
      for (int i = 1; i < n_tiles; ++i) {
        const int s = i % STAGES, p = (i - 1) % STAGES;
        // both waits come before the fence, so that no branch separates
        // the fence from the products
        mbar_wait(&full_v[s], (i / STAGES) & 1);
        mbar_wait(&full_k[s], (i / STAGES) & 1);
        fence_regs<D / 2>(acc);
        fence_regs<BN / 16>(da);
        wgmma_fence();
        issue_s_dp(i);
        issue_dq(i - 1);
        wgmma_wait<1>();
        fence_regs<BN / 2>(sc);
        fence_regs<BN / 2>(dp);
        mbar_arrive(&empty_v[s]);
        grad(i);
        // pin dS before the wait, so that it is computed while dQ += dS K
        // is on the tensor cores (the compiler would otherwise sink it)
        fence_regs<BN / 2>(dp);
        wgmma_wait<0>();
        fence_regs<D / 2>(acc);
        fence_regs<BN / 16>(da);
        mbar_arrive(&empty_k[p]);
        pack();
      }
      const int last = n_tiles - 1;
      fence_regs<D / 2>(acc);
      fence_regs<BN / 16>(da);
      wgmma_fence();
      issue_dq(last);
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
      mbar_arrive(&empty_k[last % STAGES]);
    }

    // epilogue: dQ * scale in bf16 into this warpgroup's rows of the Q tile
    // (its own products are done with them), D/64 regions of 64 rows x 128
    // bytes in the TMA's swizzle, then one TMA store a region. A row that
    // saw no key has dQ 0.
    unsigned char* out = sQ + cw * 64 * 128;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = 16 * warp + lane / 4 + 8 * r;
#pragma unroll
      for (int i2 = 0; i2 < D / 8; ++i2) {
        const uint32_t off =
            (i2 / 8) * BM * 128 + lr * 128 + (i2 % 8) * 16 + 4 * t;
        *reinterpret_cast<uint32_t*>(out + sw128_offset(off)) =
            pack_bf16(acc[4 * i2 + 2 * r] * scale, acc[4 * i2 + 2 * r + 1] * scale);
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + cw, kWarpgroup);
    if (tid == 0 && row0 < Sq) {
#pragma unroll
      for (int r = 0; r < D / 64; ++r)
        tma_store_4d(&tdq, out + r * BM * 128, r * 64, h, row0, b);
      tma_store_commit_and_wait();
    }
  }
}

template <int D>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int Sq, int Sk, int Hq, int Hkv,
                     int causal, int q_offset, int window, float scale,
                     cudaStream_t stream) {
  using T = DqTiles<D>;
  CUtensorMap tq, tk, tv, tdo, tdq;
  int err = bshd_map(&tq, q, B, Sq, Hq, D, T::BM);
  if (!err) err = bshd_map(&tdo, dout, B, Sq, Hq, D, T::BM);
  if (!err) err = bshd_map(&tk, k, B, Sk, Hkv, D, T::BN);
  if (!err) err = bshd_map(&tv, v, B, Sk, Hkv, D, T::BN);
  if (!err) err = bshd_map(&tdq, dq, B, Sq, Hq, D, 64);
  if (err) return err;
  cudaError_t st = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (st != cudaSuccess) return (int)st;
  dim3 grid(B * Hq, (Sq + T::BM - 1) / T::BM);
  flash_bwd_dq_kernel<D><<<grid, kWsThreads, T::SMEM, stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), Sq, Sk, Hq, Hkv, causal, q_offset,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace nexus

// Plain C entries for ctypes; the Python wrapper checks shapes (Sq, Sk
// multiples of 64, D 64 or 128, Hq a multiple of Hkv, contiguous tensors).
// lse and delta are (B, Hq, Sq) f32. Return the cudaError_t of the launch
// (or of the tensor maps).
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
