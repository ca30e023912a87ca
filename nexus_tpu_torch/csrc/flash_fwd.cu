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
// bound by tensor-core operations (989 TFLOP/s bf16 dense), which only
// wgmma reaches, and only when its operands arrive without stalling it.
// The design:
//   * one block per 128 query rows of one (batch, query head): a producer
//     warpgroup and two consumer warpgroups of 64 rows each; setmaxnreg
//     moves the producer's registers to the consumers;
//   * the producer (one thread) TMA-loads the Q tile once, then streams the
//     K and V tiles (128 keys) of the mask's band through a two-stage ring
//     of shared-memory buffers; K and V each have full/empty mbarrier pairs,
//     so Q K^T starts before V lands and K is refilled before P V is done;
//   * S = Q K^T is wgmma m64n128k16 with both operands in shared memory;
//     P, cast to bf16 as the TPU kernel casts it to V's dtype, stays in
//     registers as the A operand of O += P V (V MN-major, transpose bit);
//   * what bounds the loop once the products run on wgmma is the softmax
//     (one exp2 per score on the 16-a-clock special-function units, about
//     half the products' time): each consumer issues S_i = Q K_i^T together
//     with O += P_{i-1} V_{i-1} and runs the softmax of S_i while P V is on
//     the tensor cores, and two named barriers hand the tensor cores from
//     one warpgroup to the other (ping-pong), so that one's softmax overlaps
//     the other's products;
//   * the softmax runs in registers in base 2 (log2(e) folded into the
//     scale, one fma and one exp2 per score); per-element masks only in the
//     tiles that cross the causal diagonal, the window's floor or the end
//     of the keys, a separate instantiation, so that the others carry no
//     per-element test;
//   * under causal masking the grid walks the query tiles from the last
//     (the most key tiles) to the first, so the heaviest blocks start first.
// Rows past Sq (a ragged last tile) read zeros from the TMA and are not
// stored; keys past Sk read zeros and are masked.

#include "hopper.cuh"

namespace nexus {

template <int D>
struct FwdTiles {
  static constexpr int BM = 128, BN = 128, STAGES = 2;
  static constexpr int Q_BYTES = BM * D * 2;   // D/64 regions of BM x 128 B
  static constexpr int KV_BYTES = BN * D * 2;  // one K or V tile
  static constexpr int BARRIERS = 1 + 4 * STAGES;
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BARRIERS * 8;
};

// Online softmax of one tile of raw scores Q K^T, in place: masks per
// element if MASK, scales to base 2, updates the running max and this
// thread's part of the row sums, leaves P = exp2(x - max) in sc and the
// factor that rescales the output accumulator in alpha. MASK is a template
// argument so that the tiles inside the band carry no per-element test.
template <int BN, bool MASK>
__device__ __forceinline__ void softmax_tile(float* sc, int c0,
                                             const int* rows, int t, int Sk,
                                             int causal, int q_offset,
                                             int window, float scale_log2,
                                             float* m_run, float* l_part,
                                             float* alpha) {
  // the max is taken over raw scores (the scale is positive) and scaled
  // once; each element then costs one fma and one exp2
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) {
        const int col = c0 + 8 * n + 2 * t + (e & 1);
        if (col >= Sk || !visible(rows[e >> 1], col, causal, q_offset, window))
          sc[4 * n + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n + e]);
    }
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_run[r], quad_max(mx[r]) * scale_log2);
    // a row with nothing visible yet keeps max -inf; subtract 0 instead so
    // that exp2 gives 0 and not NaN
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = exp2_approx(m_run[r] - m_use[r]);
    m_run[r] = m_new;
    l_part[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(fmaf(sc[4 * n + e], scale_log2, -m_use[e >> 1]));
      sc[4 * n + e] = p;
      l_part[e >> 1] += p;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ o, float* __restrict__ lse, int Sq,
                     int Sk, int Hq, int Hkv, int causal, int q_offset,
                     int window, float scale_log2) {
  using T = FwdTiles<D>;
  constexpr int BM = T::BM, BN = T::BN, STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sK = sQ + T::Q_BYTES;
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
    // producer: one thread issues every copy. K and V have their own
    // empty barriers: K of a stage is free once Q K^T has read it, V only
    // after P V, one tile later.
    regs_dec<kProducerRegs>();
    if (tid == 0) {
      mbar_expect_tx(bar_q, T::Q_BYTES);
#pragma unroll
      for (int r = 0; r < D / 64; ++r)
        tma_load_4d(sQ + r * BM * 128, &tq, bar_q, r * 64, h, m0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, kt = kt0 + i;
        const int phase = (i / STAGES - 1) & 1;
        unsigned char* k_s = sK + s * T::KV_BYTES;
        unsigned char* v_s = sV + s * T::KV_BYTES;
        if (i >= STAGES) mbar_wait(&empty_k[s], phase);
        mbar_expect_tx(&full_k[s], T::KV_BYTES);
#pragma unroll
        for (int r = 0; r < D / 64; ++r)
          tma_load_4d(k_s + r * BN * 128, &tk, &full_k[s], r * 64, hk, kt * BN, b);
        if (i >= STAGES) mbar_wait(&empty_v[s], phase);
        mbar_expect_tx(&full_v[s], T::KV_BYTES);
#pragma unroll
        for (int r = 0; r < D / 64; ++r)
          tma_load_4d(v_s + r * BN * 128, &tv, &full_v[s], r * 64, hk, kt * BN, b);
      }
    }
  } else {
    // consumers: warpgroup cw owns query rows m0 + 64 cw .. + 63.
    // Software pipeline: iteration i issues S_i = Q K_i^T and O += P_{i-1}
    // V_{i-1} together, then runs the softmax of S_i while P V is still on
    // the tensor cores. Named barriers 1 and 2 hand the tensor cores from
    // one warpgroup to the other (ping-pong), so that one warpgroup's
    // softmax overlaps the other's products.
    regs_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int my_turn = 1 + cw, their_turn = 2 - cw;
    const int warp = tid / 32, lane = tid % 32, t = lane % 4;
    const int row0 = m0 + 64 * cw;
    const int rows[2] = {row0 + 16 * warp + lane / 4,
                         row0 + 16 * warp + lane / 4 + 8};
    const uint32_t q_base = smem_u32(sQ) + cw * 64 * 128;
    if (cw == 1) named_bar_arrive(1, 2 * kWarpgroup);  // warpgroup 0 goes first

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // running max (base 2, -inf until a key is seen) and this thread's part
    // of the running sum of its two rows
    float m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};
    float sc[BN / 2], alpha[2];
    uint32_t pa[BN / 16][4];

    auto issue_s = [&](int i) {
      const uint32_t k_base = smem_u32(sK + (i % STAGES) * T::KV_BYTES);
      wgmma_ss_zero<BN>(sc, kmajor_desc(q_base, 0, BM * 128),
                        kmajor_desc(k_base, 0, BN * 128));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss<BN>(sc, kmajor_desc(q_base, kk, BM * 128),
                     kmajor_desc(k_base, kk, BN * 128));
      wgmma_commit();
    };
    auto issue_pv = [&](int i) {
      const uint32_t v_base = smem_u32(sV + (i % STAGES) * T::KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<D>(acc, pa[kk], mnmajor_desc(v_base, kk, BN * 128));
      wgmma_commit();
    };
    // softmax of S_i; masks per element only where the tile is not wholly
    // visible to this warpgroup's rows
    auto softmax = [&](int i) {
      const int c0 = (kt0 + i) * BN;
      const bool edge =
          c0 + BN > Sk ||
          (causal && !(c0 + BN - 1 <= row0 + q_offset &&
                       (window <= 0 || c0 > row0 + 63 + q_offset - window)));
      if (edge)
        softmax_tile<BN, true>(sc, c0, rows, t, Sk, causal, q_offset, window,
                               scale_log2, m_run, l_part, alpha);
      else
        softmax_tile<BN, false>(sc, c0, rows, t, Sk, causal, q_offset, window,
                                scale_log2, m_run, l_part, alpha);
    };
    // rescale O by the last softmax's alpha and pack its P for P V
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int i2 = 0; i2 < D / 8; ++i2) {
        acc[4 * i2 + 0] *= alpha[0];
        acc[4 * i2 + 1] *= alpha[0];
        acc[4 * i2 + 2] *= alpha[1];
        acc[4 * i2 + 3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        c_to_a(pa[kk], &sc[8 * kk], &sc[8 * kk + 4]);
    };

    mbar_wait(bar_q, 0);
    if (n_tiles > 0) {
      mbar_wait(&full_k[0], 0);
      named_bar_sync(my_turn, 2 * kWarpgroup);
      wgmma_fence();
      issue_s(0);
      named_bar_arrive(their_turn, 2 * kWarpgroup);
      wgmma_wait<0>();
      fence_regs<BN / 2>(sc);
      mbar_arrive(&empty_k[0]);
      softmax(0);
      rescale_and_pack();
      for (int i = 1; i < n_tiles; ++i) {
        const int s = i % STAGES, p = (i - 1) % STAGES;
        // V_{i-1} was loaded before K_i; both waits come before the fence,
        // so that no branch separates the fence from the products
        mbar_wait(&full_v[p], ((i - 1) / STAGES) & 1);
        mbar_wait(&full_k[s], (i / STAGES) & 1);
        fence_regs<D / 2>(acc);
        fence_regs<BN / 16>(pa);
        named_bar_sync(my_turn, 2 * kWarpgroup);
        wgmma_fence();
        issue_s(i);
        issue_pv(i - 1);
        named_bar_arrive(their_turn, 2 * kWarpgroup);
        wgmma_wait<1>();
        fence_regs<BN / 2>(sc);
        mbar_arrive(&empty_k[s]);
        softmax(i);
        // pin the softmax before the wait, so that it runs while P V is on
        // the tensor cores (the compiler would otherwise sink it below)
        fence_regs<BN / 2>(sc);
        wgmma_wait<0>();
        fence_regs<D / 2>(acc);
        fence_regs<BN / 16>(pa);
        mbar_arrive(&empty_v[p]);
        rescale_and_pack();
      }
      const int last = n_tiles - 1, p = last % STAGES;
      mbar_wait(&full_v[p], (last / STAGES) & 1);
      fence_regs<D / 2>(acc);
      fence_regs<BN / 16>(pa);
      named_bar_sync(my_turn, 2 * kWarpgroup);
      wgmma_fence();
      issue_pv(last);
      named_bar_arrive(their_turn, 2 * kWarpgroup);
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
      mbar_arrive(&empty_v[p]);
    }

    // a row that saw no key has l == 0 and acc == 0: output 0, lse -inf
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l_run = quad_sum(l_part[r]);
      const float inv = l_run == 0.f ? 0.f : 1.f / l_run;
      if (rows[r] >= Sq) continue;
      bf16* orow = o + (((long)b * Sq + rows[r]) * Hq + h) * D;
#pragma unroll
      for (int i2 = 0; i2 < D / 8; ++i2)
        *reinterpret_cast<uint32_t*>(orow + 8 * i2 + 2 * t) =
            pack_bf16(acc[4 * i2 + 2 * r] * inv, acc[4 * i2 + 2 * r + 1] * inv);
      if (t == 0)
        lse[(long)bh * Sq + rows[r]] =
            l_run == 0.f ? -INFINITY : m_run[r] * kLn2 + logf(l_run);
    }
  }
}

template <int D>
static int launch_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                      int causal, int q_offset, int window, float scale,
                      cudaStream_t stream) {
  using T = FwdTiles<D>;
  CUtensorMap tq, tk, tv;
  int err = bshd_map(&tq, q, B, Sq, Hq, D, T::BM);
  if (!err) err = bshd_map(&tk, k, B, Sk, Hkv, D, T::BN);
  if (!err) err = bshd_map(&tv, v, B, Sk, Hkv, D, T::BN);
  if (err) return err;
  cudaError_t st = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (st != cudaSuccess) return (int)st;
  dim3 grid(B * Hq, (Sq + T::BM - 1) / T::BM);
  flash_fwd_kernel<D><<<grid, kWsThreads, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Sk, Hq,
      Hkv, causal, q_offset, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace nexus

// Plain C entry for ctypes. Shapes are checked by the Python wrapper:
// Sq a multiple of 64, Sk >= 1, D 64 or 128, Hq a multiple of Hkv, all tensors
// contiguous. Returns the cudaError_t of the launch (or of the tensor maps).
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
