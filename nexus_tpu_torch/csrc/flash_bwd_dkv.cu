// Flash-attention backward, dK and dV, for Hopper (sm_90a): bf16 in, fp32
// accumulation.
//
// Replaces the TPU kernel `_flash_bwd_dkv_kernel` (nexus_tpu/ops/attention.py),
// which `_flash_bwd_impl` launches through pl.pallas_call. With S = scale Q K^T
// and P = exp(S - lse) recomputed tile by tile from the forward's logsumexp:
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O) - g_lse
//   dK = scale * dS^T Q,  dV = P^T dO, each summed over the n_rep query heads
//   of its kv head.
// delta is computed by the caller in PyTorch, as the JAX package computes it
// outside Pallas. lse and delta are (B, Hq, Sq) f32.
//
// What bounds it on the H100: four products per (key, query) pair, 8D FLOP,
// twice the forward's tensor-core work on the same few hundred MB, so it is
// bound by operations, which only wgmma reaches. The design:
//   * one block per (batch, kv head, 128 keys): a producer warpgroup and two
//     consumer warpgroups of 64 keys each; setmaxnreg moves the producer's
//     registers to the consumers, whose dK and dV accumulators alone take 128
//     registers a thread at D 128;
//   * the producer (one thread) TMA-loads K and V once, then walks the n_rep
//     query heads of the group and, for each, the 64-row query tiles of the
//     mask's band, streaming Q, dO and the matching lse and delta rows through
//     a two-stage ring under full/empty mbarriers;
//   * S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with both operands
//     in shared memory (K-major); P^T and dS^T stay in registers, cast to
//     bf16, as the A operands of dV += P^T dO and dK += dS^T Q (dO and Q
//     MN-major, transpose bit);
//   * dK and dV of the whole group accumulate in fp32 registers, so no
//     atomics and no per-query-head buffer are needed (the TPU kernel's
//     group-summing grid does the same in VMEM scratch);
//   * P is masked per element (before it meets delta, so a row that sees no
//     key, lse -inf, contributes 0) only in the tiles that cross the causal
//     diagonal or the window's floor, a separate instantiation, so that the
//     others carry no per-element test;
//   * the grid walks the key tiles upwards: under causal masking the first
//     key tiles see the most query rows, so the heaviest blocks start first.
// Keys past Sk (a ragged last tile) read zeros and are not stored.

#include "hopper.cuh"

namespace nexus {

template <int D>
struct DkvTiles {
  static constexpr int BN = 128, BM = 64, STAGES = 2;
  static constexpr int KV_BYTES = BN * D * 2;  // K or V of the block
  static constexpr int Q_BYTES = BM * D * 2;   // a Q or dO tile
  static constexpr int ROW_BYTES = BM * 4;     // lse or delta of a tile
  static constexpr int BARRIERS = 1 + 2 * STAGES;
  static constexpr int SMEM = 1024 + 2 * KV_BYTES +
                              STAGES * (2 * Q_BYTES + 2 * ROW_BYTES) +
                              BARRIERS * 8;
};

// P^T = exp2(S^T scale log2(e) - lse log2(e)) and dS^T = P^T (dP^T - delta)
// of one tile, in place (st, dpt: rows = keys, columns = query rows r0 ..).
// P is masked before it meets delta, so a row that sees no key (lse -inf)
// gives 0. MASK is a template argument so that the tiles inside the band
// carry no per-element test.
template <int BM, bool MASK>
__device__ __forceinline__ void grad_tile(float* st, float* dpt,
                                          const float* l_s, const float* d_s,
                                          int r0, const int* keys, int t,
                                          float scale_log2, int causal,
                                          int q_offset, int window) {
#pragma unroll
  for (int n = 0; n < BM / 8; ++n) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int lc = 8 * n + 2 * t + c;
      const float l2 = l_s[lc] * kLog2e, dl = d_s[lc];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = 2 * r + c;
        float p = exp2_approx(fmaf(st[4 * n + e], scale_log2, -l2));
        if (MASK && !visible(r0 + lc, keys[r], causal, q_offset, window)) p = 0.f;
        st[4 * n + e] = p;
        dpt[4 * n + e] = p * (dpt[4 * n + e] - dl);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                         int Sk, int Hq, int Hkv, int causal, int q_offset,
                         int window, float scale) {
  using T = DkvTiles<D>;
  constexpr int BN = T::BN, BM = T::BM, STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + T::KV_BYTES;
  unsigned char* sQ = sV + T::KV_BYTES;            // STAGES tiles
  unsigned char* sdO = sQ + STAGES * T::Q_BYTES;   // STAGES tiles
  float* sL = reinterpret_cast<float*>(sdO + STAGES * T::Q_BYTES);
  float* sD = sL + STAGES * BM;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sD + STAGES * BM);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int bhk = blockIdx.x, b = bhk / Hkv, hk = bhk % Hkv;
  const int n_rep = Hq / Hkv;
  const int c0 = blockIdx.y * BN;
  int it0, it1;
  query_tile_range(c0, BN, BM, Sq, causal, q_offset, window, &it0, &it1);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWarpgroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  if (wg == 0) {
    // producer: one thread issues every copy
    regs_dec<kProducerRegs>();
    if (tid == 0) {
      mbar_expect_tx(bar_kv, 2 * T::KV_BYTES);
#pragma unroll
      for (int r = 0; r < D / 64; ++r) {
        tma_load_4d(sK + r * BN * 128, &tk, bar_kv, r * 64, hk, c0, b);
        tma_load_4d(sV + r * BN * 128, &tv, bar_kv, r * 64, hk, c0, b);
      }
      int i = 0;
      for (int member = 0; member < n_rep; ++member) {
        const int h = hk * n_rep + member;
        const long row_off = ((long)b * Hq + h) * Sq;
        for (int it = it0; it < it1; ++it, ++i) {
          const int s = i % STAGES;
          if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
          mbar_expect_tx(&full[s], 2 * T::Q_BYTES + 2 * T::ROW_BYTES);
          unsigned char* q_s = sQ + s * T::Q_BYTES;
          unsigned char* do_s = sdO + s * T::Q_BYTES;
#pragma unroll
          for (int r = 0; r < D / 64; ++r) {
            tma_load_4d(q_s + r * BM * 128, &tq, &full[s], r * 64, h, it * BM, b);
            tma_load_4d(do_s + r * BM * 128, &tdo, &full[s], r * 64, h, it * BM, b);
          }
          bulk_load(sL + s * BM, lse + row_off + it * BM, T::ROW_BYTES, &full[s]);
          bulk_load(sD + s * BM, delta + row_off + it * BM, T::ROW_BYTES, &full[s]);
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns keys c0 + 64 cw .. + 63
    regs_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int key0 = c0 + 64 * cw;
    const int keys[2] = {key0 + 16 * warp + g, key0 + 16 * warp + g + 8};
    const uint32_t k_base = smem_u32(sK) + cw * 64 * 128;
    const uint32_t v_base = smem_u32(sV) + cw * 64 * 128;
    const float scale_log2 = scale * kLog2e;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(bar_kv, 0);
    int i = 0;
    for (int member = 0; member < n_rep; ++member) {
      for (int it = it0; it < it1; ++it, ++i) {
        const int s = i % STAGES, parity = (i / STAGES) & 1;
        const int r0 = it * BM;
        const uint32_t q_base = smem_u32(sQ + s * T::Q_BYTES);
        const uint32_t do_base = smem_u32(sdO + s * T::Q_BYTES);
        const float* l_s = sL + s * BM;
        const float* d_s = sD + s * BM;

        // S^T = K Q^T and dP^T = V dO^T: rows = keys, columns = queries
        float st[BM / 2], dpt[BM / 2];
        mbar_wait(&full[s], parity);
        wgmma_fence();
        wgmma_ss_zero<BM>(st, kmajor_desc(k_base, 0, BN * 128),
                          kmajor_desc(q_base, 0, BM * 128));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<BM>(st, kmajor_desc(k_base, kk, BN * 128),
                       kmajor_desc(q_base, kk, BM * 128));
        wgmma_ss_zero<BM>(dpt, kmajor_desc(v_base, 0, BN * 128),
                          kmajor_desc(do_base, 0, BM * 128));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<BM>(dpt, kmajor_desc(v_base, kk, BN * 128),
                       kmajor_desc(do_base, kk, BM * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<BM / 2>(st);
        fence_regs<BM / 2>(dpt);

        // P^T into st, dS^T into dpt; per-element masks only where the
        // tile is not wholly visible to this warpgroup's keys
        const bool edge =
            causal && !(key0 + 63 <= r0 + q_offset &&
                        (window <= 0 || key0 > r0 + BM - 1 + q_offset - window));
        if (edge)
          grad_tile<BM, true>(st, dpt, l_s, d_s, r0, keys, t, scale_log2,
                              causal, q_offset, window);
        else
          grad_tile<BM, false>(st, dpt, l_s, d_s, r0, keys, t, scale_log2,
                               causal, q_offset, window);
        uint32_t pa[BM / 16][4], da[BM / 16][4];
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          c_to_a(pa[kk], &st[8 * kk], &st[8 * kk + 4]);
          c_to_a(da[kk], &dpt[8 * kk], &dpt[8 * kk + 4]);
        }
        // dV += P^T dO, dK += dS^T Q: the reduction runs over query rows
        fence_regs<BM / 16>(pa);
        fence_regs<BM / 16>(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          wgmma_rs<D>(dv_acc, pa[kk], mnmajor_desc(do_base, kk, BM * 128));
          wgmma_rs<D>(dk_acc, da[kk], mnmajor_desc(q_base, kk, BM * 128));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(dv_acc);
        fence_regs<D / 2>(dk_acc);
        mbar_arrive(&empty[s]);
      }
    }

    const long kv_stride = (long)Hkv * D;
    const long kvoff = ((long)b * Sk * Hkv + hk) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (keys[r] >= Sk) continue;
      bf16* dkr = dk + kvoff + (long)keys[r] * kv_stride;
      bf16* dvr = dv + kvoff + (long)keys[r] * kv_stride;
#pragma unroll
      for (int i2 = 0; i2 < D / 8; ++i2) {
        const int c = 8 * i2 + 2 * t, e = 4 * i2 + 2 * r;
        *reinterpret_cast<uint32_t*>(dkr + c) =
            pack_bf16(dk_acc[e] * scale, dk_acc[e + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvr + c) = pack_bf16(dv_acc[e], dv_acc[e + 1]);
      }
    }
  }
}

template <int D>
static int launch_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int Sq, int Sk, int Hq,
                      int Hkv, int causal, int q_offset, int window,
                      float scale, cudaStream_t stream) {
  using T = DkvTiles<D>;
  CUtensorMap tq, tk, tv, tdo;
  int err = bshd_map(&tq, q, B, Sq, Hq, D, T::BM);
  if (!err) err = bshd_map(&tdo, dout, B, Sq, Hq, D, T::BM);
  if (!err) err = bshd_map(&tk, k, B, Sk, Hkv, D, T::BN);
  if (!err) err = bshd_map(&tv, v, B, Sk, Hkv, D, T::BN);
  if (err) return err;
  if (reinterpret_cast<uintptr_t>(lse) % 16 || reinterpret_cast<uintptr_t>(delta) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t st = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (st != cudaSuccess) return (int)st;
  dim3 grid(B * Hkv, (Sk + T::BN - 1) / T::BN);
  flash_bwd_dkv_kernel<D><<<grid, kWsThreads, T::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, Hq, Hkv, causal, q_offset, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace nexus

// Plain C entry for ctypes; the Python wrapper checks shapes (Sq, Sk
// multiples of 64, D 64 or 128, Hq a multiple of Hkv, contiguous tensors).
// lse and delta are (B, Hq, Sq) f32. Returns the cudaError_t of the launch
// (or of the tensor maps).
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
