// Paged-decode attention for Hopper (sm_90a): the serving engine's attention
// over its paged KV block pool, bf16 queries, bf16 or int8 pool, fp32
// softmax and accumulation. One launch: a persistent grid that walks a work
// list derived on the device, and folds the log-sum-exp merge into the
// last unit that finishes each (row, kv head).
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
// What bounds it on the H100: bytes. Every visible position costs
// 2*Hkv*D*2 bytes of K+V (4 KiB a layer at Llama-3-8B widths) against
// 3.35 TB/s; the products are 4*D FLOP per (query, position), ~32 FLOP a
// byte at T 8, far under the card's ~295. What the design does about it:
//
//   * Work units, listed on the device. A unit is (kv head, up to ROWS = 64
//     query rows, a chunk of `span` table slots): either one row's own
//     visible slots past the Hydragen split (its query rows are the
//     n_rep*T rows of that (row, kv head)), or a chunk of the shared run
//     (its query rows are ALL rows' n_rep*T rows for that kv head, stacked,
//     64 at a time: the run is read once per kv head per 64 query rows,
//     once per wave at T 1 with up to 16 rows of n_rep 4). Each CTA copies
//     the rows' operands into a shared-memory row table once; every warp
//     then derives the same plan and list from it (the units per row and
//     their prefix sum): no host sync, no list in memory. `span` (slots) is
//     the work per CTA, raised by a binary search to the smallest span up
//     to twice that whose units fit in one wave of the grid, kept within
//     64..2048 positions and at least M / (pmax - 1) slots, so that no row
//     has more than pmax partials (the wrapper's workspace). A persistent
//     grid (occupancy x SMs CTAs) strides over the list: the deepest row is
//     cut into many units and no longer sets the tail, and a short batch
//     runs in one wave.
//   * A producer warp and four consumer warps. The producer fills a ring of
//     STAGES = 4 shared-memory stages of TILE = 64 positions (K then V)
//     with TMA boxes of one pool block (up to 64 positions) of one kv head
//     through two 3-d tensor maps over the pool (N*Bs, Hkv, D), encoded per
//     call on the host (the pool's address changes with the layer); boxes
//     past a unit's end read past the pool's end and land as zeros. bf16
//     boxes of 64 columns land in 128-byte swizzled rows, so ldmatrix reads
//     are conflict-free. A block size that is not a power of two from 8 up
//     is copied row by row instead (bf16: 16-byte cp.async into the same
//     swizzled places; int8: 1-d bulk copies). Copies complete on the
//     stage's `full` mbarrier; consumers free a stage on its `empty` one.
//     int8 stages hold dense raw rows; the consumers dequantize a stage
//     into one bf16 work tile (scales by plain loads). The producer also
//     copies each unit's query rows into one of two query buffers.
//   * Tensor cores for every unit: S = Q K^T and O += P V with mma.sync
//     m16n8k16 (bf16, fp32 accumulators). A consumer warp holds 16 query
//     rows (A fragments of Q in registers, from the query buffer); a unit
//     of <= 16 rows (T 1 at n_rep <= 16) splits each stage's 64 keys over
//     the four warps, <= 32 rows over two, more rows give each warp a
//     16-row slice of all 64 keys. P goes from the S accumulators to A
//     fragments in registers as two bf16 parts, hi = bf16(P) and lo =
//     bf16(P - hi), each multiplied by V into the same fp32 accumulators:
//     P keeps ~16 bits, where the plain version (and the JAX function)
//     keep it in fp32 and one bf16 rounding would cost 8. The second
//     product doubles the P V MMAs, which the bytes leave idle.
//     (Building with -DNEXUS_DECODE_P_BF16 keeps only hi, for comparing
//     the two.) wgmma is not used: its 64-row tile fits only the shared
//     units at T >= 8 (a small share of the bytes), and mma.sync's rate is
//     far above what ~32 FLOP a byte needs.
//   * The merge, folded in. At a unit's end its warps combine their key
//     splits in shared memory and write one fp32 partial (m, l, acc) per
//     query row to the workspace (slot j of the row for shared chunk j,
//     nsh + j for its own chunk j). Then one lane per (row, kv head) the
//     unit fed bumps that pair's arrival counter with an acq_rel atomic
//     (after a barrier over the writers); the unit that brings it to the
//     count expected merges that (row, kv head)'s partials by log-sum-exp
//     (four items a thread, their loads in flight together), writes out in
//     bf16 and sets the counter back to 0. The counters start at 0 (the
//     wrapper zeroes its workspace once) and end every launch at 0, so
//     replaying the launch in a CUDA graph is safe. (A launch that fails
//     midway would leave counts behind; the wrapper raises on it.)

#include <algorithm>
#include <cstring>

#include "hopper.cuh"

namespace nexus_decode {

using nexus::bf16;

constexpr int CONSUMERS = 4;                     // consumer warps
constexpr int THREADS = 32 * (CONSUMERS + 1);    // + the producer warp
constexpr int ROWS = 16 * CONSUMERS;             // query rows a unit takes
constexpr int TILE = 64;                         // positions per ring stage
constexpr int STAGES = 4;
constexpr int MAX_ROWS = 1024;                   // rows B the row table holds
constexpr int MAX_PARTIALS = 17;                 // partials per query row, at most
constexpr int UNIT_MIN_POS = 64;                 // a unit's span, in positions
constexpr int UNIT_MAX_POS = 2048;
constexpr int MERGE_BAR = 1;                     // named barrier of the consumers
constexpr float MASK = -0.7f * 3.402823466e38f;
#ifdef NEXUS_DECODE_P_BF16
constexpr bool P_SPLIT = false;  // P rounded to bf16 before P V
#else
constexpr bool P_SPLIT = true;   // P as bf16 hi + lo, two products
#endif
constexpr float LOG2E = 1.4426950408889634f;

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
  bf16* out;
  float* part_m;
  float* part_l;
  float* part_acc;
  int* counters;
  int B, T, Hq, Hkv, Bs, M, window, pmax, ctas;
  int box_rows;  // positions of one TMA box (0: copy row by row instead)
  int N;         // pool blocks
  float scale_log2;  // D^-0.5 * log2(e): the softmax runs in base 2
};

// Shared-memory layout of one instantiation (the base aligned to 1024
// bytes). A bf16 tile of TILE positions is D/64 regions of TILE rows of 128
// bytes (64 columns), in the 128-byte swizzle a TMA box of 64 bf16 columns
// writes: the 16-byte chunk c of row r sits at chunk c ^ (r % 8). An int8
// stage holds dense rows of D bytes, dequantized into a bf16 work tile.
template <int D, bool INT8>
struct Geo {
  static constexpr int REGION = TILE * 128;           // 64 columns of a tile
  static constexpr int TILE_BF = (D / 64) * REGION;   // one bf16 K or V tile
  static constexpr int ESZ = INT8 ? 1 : 2;            // pool element bytes
  static constexpr int STAGE = INT8 ? 2 * TILE * D : 2 * TILE_BF;  // K, then V
  static constexpr int WORK = INT8 ? 2 * TILE_BF : 0;  // a dequantized stage
  static constexpr int ACC_STRIDE = D + 4;            // floats per merge row
  static constexpr int MERGE = CONSUMERS * 16 * (ACC_STRIDE + 2) * 4;
  static constexpr int QROW = D * 2 + 16;             // padded query row, bytes
  static constexpr int QBUF = ROWS * QROW;            // a unit's query rows
  static constexpr int ROW_TABLE = (5 * MAX_ROWS + 2) * 4;
  static constexpr int BARS = (2 * STAGES + 4) * 8;
  static constexpr int LIST = (ROWS + 2) * 4;
  static constexpr int SMEM =
      1024 + STAGES * STAGE + WORK + MERGE + 2 * QBUF + ROW_TABLE + BARS + LIST;
  static_assert(STAGE % 1024 == 0, "stages must keep the swizzle's alignment");
};

__device__ __forceinline__ int warp_sum_i(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int warp_max_i(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_min_i(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The bf16 pair of (x0 - hi.x, x1 - hi.y), for `hi` the bf16 pair packed
// from (x0, x1): the part of P one bf16 rounding drops (exact in fp32).
__device__ __forceinline__ uint32_t bf16_residual(uint32_t hi, float x0, float x1) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return nexus::pack_bf16(x0 - h.x, x1 - h.y);
}

__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// The rows' operands and visible slot ranges, read from global once per CTA
// into shared memory: nb (n_blocks clipped to [1, M]), st (start), and
// [lo, hi), the slots between the window's floor under the row's oldest
// query and the causal edge of its newest.
struct Rows {
  int* lo;
  int* hi;
  int* nb;
  int* st;
  int* pre;  // units of the rows before b (B + 1 entries), once the plan is known
};

__device__ __forceinline__ void fill_rows(const Args& a, const Rows& r, int tid, int threads) {
  for (int b = tid; b < a.B; b += threads) {
    const int nb = min(max(a.n_blocks[b], 1), a.M);
    const int st = a.start[b];
    const int last = st + a.T - 1;
    const int h = last < 0 ? 0 : min(nb, last / a.Bs + 1);
    int l = 0;
    if (a.window > 0 && st - a.window + 1 > 0) l = (st - a.window + 1) / a.Bs;
    r.lo[b] = l;
    r.hi[b] = max(h, l);
    r.nb[b] = nb;
    r.st[b] = st;
  }
}

// The per-call quantities of the work list, derived by each warp alone
// (every lane ends with the same values).
struct Plan {
  int s_eff;    // the Hydragen split, clipped
  int sh_lo;    // shared chunks cover [sh_lo, sh_hi)
  int sh_hi;
  int span;     // slots per unit
  int nsh;      // shared chunks
  int R;        // query rows of one (row, kv head): n_rep * T
  int rg_row;   // 64-row groups of a row's own units
  int rg_sh;    // 64-row groups of the shared units (all rows stacked)
  int per_head; // units per kv head
};

__device__ __forceinline__ int own_lo(const Plan& p, int lo) { return max(lo, p.s_eff); }

// Own chunks of row b.
__device__ __forceinline__ int row_chunks(const Rows& r, const Plan& p, int b) {
  return cdiv(max(0, r.hi[b] - own_lo(p, r.lo[b])), p.span);
}

__device__ Plan make_plan(const Args& a, const Rows& r, int split, int lane) {
  Plan p;
  p.R = (a.Hq / a.Hkv) * a.T;
  p.rg_row = cdiv(p.R, ROWS);
  p.rg_sh = cdiv(a.B * p.R, ROWS);
  int nb_max = 1, lo_min = 1 << 30, hi_max = 0;
  for (int b = lane; b < a.B; b += 32) {
    nb_max = max(nb_max, r.nb[b]);
    lo_min = min(lo_min, r.lo[b]);
    hi_max = max(hi_max, r.hi[b]);
  }
  nb_max = warp_max_i(nb_max);
  lo_min = warp_min_i(lo_min);
  hi_max = warp_max_i(hi_max);
  p.s_eff = min(max(split, 0), nb_max);
  p.sh_lo = lo_min;
  p.sh_hi = max(lo_min, min(p.s_eff, hi_max));
  // the span: at least the work per CTA (slots x row groups over the
  // grid), then the smallest span up to twice that whose units fit in one
  // wave of the grid (a binary search: the count falls as the span grows),
  // within [c_min, c_max] slots and at least c_cap (pmax partials a row)
  const int sh_len = p.sh_hi - p.sh_lo;
  int own = 0;
  for (int b = lane; b < a.B; b += 32) own += max(0, r.hi[b] - max(r.lo[b], p.s_eff));
  own = warp_sum_i(own);
  const int work = own * p.rg_row + sh_len * p.rg_sh;
  const int c_min = max(1, UNIT_MIN_POS / a.Bs);
  const int c_max = max(c_min, UNIT_MAX_POS / a.Bs);
  const int c_cap = cdiv(a.M, a.pmax - 1);
  auto units_at = [&](int span) {
    int n = 0;
    for (int b = lane; b < a.B; b += 32) n += cdiv(max(0, r.hi[b] - max(r.lo[b], p.s_eff)), span);
    return (warp_sum_i(n) * p.rg_row + cdiv(sh_len, span) * p.rg_sh) * a.Hkv;
  };
  int lo_s = min(max(cdiv(work * a.Hkv, a.ctas), c_min), c_max);
  int hi_s = min(2 * lo_s, c_max);
  while (lo_s < hi_s) {
    const int mid = (lo_s + hi_s) / 2;
    if (units_at(mid) <= a.ctas) hi_s = mid; else lo_s = mid + 1;
  }
  p.span = max(c_cap, lo_s);
  p.nsh = cdiv(sh_len, p.span);
  int units = 0;
  for (int b = lane; b < a.B; b += 32) units += row_chunks(r, p, b);
  p.per_head = warp_sum_i(units) * p.rg_row + p.nsh * p.rg_sh;
  return p;
}

// rows.pre: the exclusive prefix sum of the rows' units, by one warp.
__device__ __forceinline__ void fill_prefix(const Args& a, const Rows& rows, const Plan& p,
                                            int lane) {
  int base = 0;
  for (int b0 = 0; b0 < a.B; b0 += 32) {
    const int b = b0 + lane;
    const int cnt = b < a.B ? row_chunks(rows, p, b) * p.rg_row : 0;
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (b < a.B) rows.pre[b] = base + incl - cnt;
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) rows.pre[a.B] = base;
}

// Arrivals that complete (row b, kv head): its own units and the shared
// units whose 64-row group holds one of its rows.
__device__ __forceinline__ int expected_arrivals(const Rows& r, const Plan& p, int b) {
  const int groups = (b * p.R + p.R - 1) / ROWS - (b * p.R) / ROWS + 1;
  return row_chunks(r, p, b) * p.rg_row + p.nsh * groups;
}

struct Unit {
  int g;      // kv head
  int b;      // the row, or -1 for a shared unit
  int qr0;    // first query row: of the row's R rows, or of the B*R stacked
  int nrows;  // query rows, <= ROWS
  int s0, s1; // table slots [s0, s1)
  int pslot;  // the partial slot its rows write
};

// Unit u of the list (every lane of the warp returns the same unit).
__device__ Unit unit_at(const Args& a, const Rows& rows, const Plan& p, int u, int lane) {
  Unit w;
  w.g = u / p.per_head;
  int r = u % p.per_head;
  if (r < p.nsh * p.rg_sh) {
    const int j = r / p.rg_sh, rg = r % p.rg_sh;
    w.b = -1;
    w.qr0 = rg * ROWS;
    w.nrows = min(ROWS, a.B * p.R - w.qr0);
    w.s0 = p.sh_lo + j * p.span;
    w.s1 = min(w.s0 + p.span, p.sh_hi);
    w.pslot = j;
    return w;
  }
  r -= p.nsh * p.rg_sh;
  // the row whose units hold r, from the prefix table, 32 rows at a time
  for (int b0 = 0; b0 < a.B; b0 += 32) {
    const int b = b0 + lane;
    const unsigned hit =
        __ballot_sync(0xffffffffu, b < a.B && rows.pre[b] <= r && r < rows.pre[b + 1]);
    if (hit) {
      const int rb = b0 + __ffs(hit) - 1;
      const int k = r - rows.pre[rb], j = k / p.rg_row, rg = k % p.rg_row;
      w.b = rb;
      w.qr0 = rg * ROWS;
      w.nrows = min(ROWS, p.R - w.qr0);
      w.s0 = own_lo(p, rows.lo[rb]) + j * p.span;
      w.s1 = min(w.s0 + p.span, rows.hi[rb]);
      w.pslot = p.nsh + j;
      return w;
    }
  }
  w.b = 0; w.qr0 = 0; w.nrows = 0; w.s0 = w.s1 = 0; w.pslot = 0;  // not reached
  return w;
}

// Query row i of unit w → (row b, query head h, token t).
__device__ __forceinline__ void query_row(const Args& a, const Plan& p, const Unit& w, int i,
                                          int* b, int* h, int* t) {
  const int n_rep = a.Hq / a.Hkv;
  int local;
  if (w.b < 0) {
    const int qi = w.qr0 + i;
    *b = qi / p.R;
    local = qi % p.R;
  } else {
    *b = w.b;
    local = w.qr0 + i;
  }
  *h = w.g * n_rep + local / a.T;
  *t = local % a.T;
}

__device__ __forceinline__ size_t part_row(const Args& a, int b, int h, int t, int slot) {
  return (((size_t)b * a.Hq + h) * a.T + t) * a.pmax + slot;
}

__device__ __forceinline__ int pool_block(const Args& a, int b, int slot) {
  return b < 0 ? a.shared_table[slot] : a.block_table[(size_t)b * a.M + slot];
}

// One stage for one consumer warp: S = Q K^T over the warp's PW = 8*NT
// keys, the online softmax in base 2, O += P V. kb / vb: shared addresses
// of the warp's first K / V row in the swizzled tiles (rows 128 bytes
// apart in each 64-column region); pos0: the virtual
// position of that key; [lo, hi]: the visible positions of the warp's two
// rows (g and g + 8).
template <int D, int NT>
__device__ __forceinline__ void attend(const uint32_t (&qf)[D / 16][4], float (&acc)[D / 8][4],
                                       float (&m)[2], float (&l)[2], uint32_t kb, uint32_t vb,
                                       int pos0, const int (&lo)[2], const int (&hi)[2],
                                       float scale_log2, int lane) {
  constexpr int REGION = TILE * 128;
  const int x = lane & 7;  // the row's swizzle (every row offset below is a multiple of 8)
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // K rows are the B operand's columns: matrix lane/8 is (key half
  // lane/16, d half (lane/8)%2)
  const uint32_t k_lane = kb + (((lane >> 4) << 3) + x) * 128;
  const int k_half = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t bq[4];
      nexus::ldsm_x4(bq, k_lane + (kk >> 2) * REGION + jj * 16 * 128 +
                             (((((kk & 3) << 1) | k_half) ^ x) << 4));
      nexus::mma_16816(s[2 * jj], qf[kk], bq[0], bq[1]);
      nexus::mma_16816(s[2 * jj + 1], qf[kk], bq[2], bq[3]);
    }
  }
  const int t4 = lane & 3;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, pos = pos0 + j * 8 + 2 * t4 + (e & 1);
      const bool vis = pos >= lo[r] && pos <= hi[r];
      s[j][e] = vis ? s[j][e] * scale_log2 : -INFINITY;
      mx[r] = fmaxf(mx[r], s[j][e]);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = nexus::quad_max(mx[r]);
    alpha[r] = nexus::exp2_approx(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float pv = s[j][e] == -INFINITY ? 0.f : nexus::exp2_approx(s[j][e] - m[r]);
      s[j][e] = pv;
      l[r] += pv;
    }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }
  // V rows are the B operand's rows (keys): matrix lane/8 is (key half
  // (lane/8)%2, d half lane/16), read transposed
  const uint32_t v_lane = vb + (x + ((lane >> 3) & 1) * 8) * 128;
  const int v_half = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t pa[4], pl[4];
    nexus::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
    if constexpr (P_SPLIT) {
      pl[0] = bf16_residual(pa[0], s[2 * kk][0], s[2 * kk][1]);
      pl[1] = bf16_residual(pa[1], s[2 * kk][2], s[2 * kk][3]);
      pl[2] = bf16_residual(pa[2], s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pl[3] = bf16_residual(pa[3], s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      uint32_t bv[4];
      nexus::ldsm_x4_trans(bv, v_lane + (dj >> 2) * REGION + kk * 16 * 128 +
                                   (((((dj & 3) << 1) | v_half) ^ x) << 4));
      nexus::mma_16816(acc[2 * dj], pa, bv[0], bv[1]);
      nexus::mma_16816(acc[2 * dj + 1], pa, bv[2], bv[3]);
      if constexpr (P_SPLIT) {
        nexus::mma_16816(acc[2 * dj], pl, bv[0], bv[1]);
        nexus::mma_16816(acc[2 * dj + 1], pl, bv[2], bv[3]);
      }
    }
  }
}

// int8 stage → the bf16 work tile, by the 128 consumer threads: each
// element bf16(float(x) * scale), its position's scale read from global.
template <int D>
__device__ __forceinline__ void dequant_stage(const Args& a, const unsigned char* raw,
                                              unsigned char* work, int b, int g, int p0,
                                              int nvalid, int tid) {
  constexpr int CPR = D / 16, TILE_BF = (D / 64) * TILE * 128;
  for (int i = tid; i < 2 * TILE * CPR; i += 32 * CONSUMERS) {
    const int which = i / (TILE * CPR), rem = i % (TILE * CPR);
    const int row = rem / CPR, c = rem % CPR;
    const int pos = p0 + row;
    float sc = 0.f;  // rows past the stage's end become zeros
    if (row < nvalid) {
      const int blk = pool_block(a, b, pos / a.Bs);
      sc = (which ? a.v_scale : a.k_scale)[((size_t)blk * a.Bs + pos % a.Bs) * a.Hkv + g];
    }
    const uint4 u = *reinterpret_cast<const uint4*>(raw + (which * TILE + row) * D + c * 16);
    const int8_t* x = reinterpret_cast<const int8_t*>(&u);
    uint4 o[2];
    uint32_t* w = reinterpret_cast<uint32_t*>(o);
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = nexus::pack_bf16((float)x[2 * e] * sc, (float)x[2 * e + 1] * sc);
    // 16 elements = bf16 chunks 2c and 2c + 1 of the row, swizzled
    unsigned char* dst = work + which * TILE_BF + (c >> 2) * TILE * 128 + row * 128;
    const int ch = (c & 3) << 1;
    *reinterpret_cast<uint4*>(dst + ((ch ^ (row & 7)) << 4)) = o[0];
    *reinterpret_cast<uint4*>(dst + (((ch + 1) ^ (row & 7)) << 4)) = o[1];
  }
}

// The consumer side of one unit: 16-row slices and key splits by MT, the
// stages, the in-CTA merge (in `area`: its own region for bf16, the work
// tile for int8), the partial, the arrivals and the final merge.
template <int D, bool INT8, int MT>
__device__ __forceinline__ void consume_unit(const Args& a, const Rows& rows, const Plan& p,
                                             const Unit& w, unsigned char* ring,
                                             unsigned char* work, unsigned char* area,
                                             unsigned char* qbuf, uint64_t* full,
                                             uint64_t* empty, uint64_t* qfull,
                                             uint64_t* qempty, int* list, int& it, int n,
                                             int warp, int lane) {
  using G = Geo<D, INT8>;
  constexpr int KS = CONSUMERS / MT;  // key splits
  constexpr int PW = TILE / KS;       // keys per warp per stage
  const int mt = warp % MT, ks = warp / MT;
  const int tid = warp * 32 + lane;
  const int g4 = lane >> 2, t4 = lane & 3;

  // this warp's two query rows: Q fragments (from the unit's query buffer,
  // which the producer filled) and visible position ranges
  uint32_t qf[D / 16][4];
  int lo[2], hi[2];
  const int end_pos = w.s1 * a.Bs - 1;
  const unsigned char* qs = qbuf + (n & 1) * G::QBUF;
  nexus::mbar_wait(&qfull[n & 1], (n >> 1) & 1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = mt * 16 + g4 + 8 * r;
    lo[r] = 0;
    hi[r] = -1;
    const uint32_t* qrow = nullptr;
    if (i < w.nrows) {
      int b, h, t;
      query_row(a, p, w, i, &b, &h, &t);
      const int qpos = rows.st[b] + t;
      const int nb = rows.nb[b];
      hi[r] = min(min(qpos, nb * a.Bs - 1), end_pos);
      lo[r] = a.window > 0 ? qpos - a.window + 1 : 0;
      qrow = reinterpret_cast<const uint32_t*>(qs + i * G::QROW);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][r] = qrow ? qrow[kk * 8 + t4] : 0u;
      qf[kk][r + 2] = qrow ? qrow[kk * 8 + 4 + t4] : 0u;
    }
  }

  __syncwarp();
  if (lane == 0) nexus::mbar_arrive(&qempty[n & 1]);  // the query rows are in registers

  float m[2] = {MASK, MASK}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int p_begin = w.s0 * a.Bs, n_pos = (w.s1 - w.s0) * a.Bs;
  const int n_stages = cdiv(n_pos, TILE);
  for (int sidx = 0; sidx < n_stages; ++sidx, ++it) {
    const int slot = it % STAGES;
    const int p0 = p_begin + sidx * TILE;
    unsigned char* st = ring + slot * G::STAGE;
    nexus::mbar_wait(&full[slot], (it / STAGES) & 1);
    unsigned char* tile = st;
    if constexpr (INT8) {
      dequant_stage<D>(a, st, work, w.b, w.g, p0, min(TILE, p_begin + n_pos - p0), tid);
      __syncwarp();
      if (lane == 0) nexus::mbar_arrive(&empty[slot]);  // the raw stage is read
      nexus::named_bar_sync(MERGE_BAR, 32 * CONSUMERS);
      tile = work;
    }
    const uint32_t kb = nexus::smem_u32(tile) + ks * PW * 128;
    const uint32_t vb = kb + G::TILE_BF;
    attend<D, PW / 8>(qf, acc, m, l, kb, vb, p0 + ks * PW, lo, hi, a.scale_log2, lane);
    if constexpr (INT8) {
      nexus::named_bar_sync(MERGE_BAR, 32 * CONSUMERS);  // the work tile is read
    } else {
      __syncwarp();
      if (lane == 0) nexus::mbar_arrive(&empty[slot]);
    }
  }

  // in-CTA merge of the key splits, in the merge area
  float* macc = reinterpret_cast<float*>(area);
  float* mml = macc + CONSUMERS * 16 * G::ACC_STRIDE;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = nexus::quad_sum(l[r]);
    const int row = warp * 16 + g4 + 8 * r;
    if (t4 == 0) {
      mml[row * 2] = m[r];
      mml[row * 2 + 1] = l[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(macc + row * G::ACC_STRIDE + j * 8 + 2 * t4) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  }
  nexus::named_bar_sync(MERGE_BAR, 32 * CONSUMERS);
  for (int i = tid; i < w.nrows * (D / 4); i += 32 * CONSUMERS) {
    const int row = i / (D / 4), c4 = i % (D / 4);
    const int rmt = row / 16, rr = row % 16;
    float mm = MASK;
#pragma unroll
    for (int k = 0; k < KS; ++k) mm = fmaxf(mm, mml[((k * MT + rmt) * 16 + rr) * 2]);
    float ll = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int src = (k * MT + rmt) * 16 + rr;
      const float e = nexus::exp2_approx(mml[src * 2] - mm);
      ll += mml[src * 2 + 1] * e;
      const float4 x = *reinterpret_cast<const float4*>(macc + src * G::ACC_STRIDE + c4 * 4);
      o.x += x.x * e;
      o.y += x.y * e;
      o.z += x.z * e;
      o.w += x.w * e;
    }
    int b, h, t;
    query_row(a, p, w, row, &b, &h, &t);
    const size_t at = part_row(a, b, h, t, w.pslot);
    reinterpret_cast<float4*>(a.part_acc + at * D)[c4] = o;
    if (c4 == 0) {
      a.part_m[at] = mm;
      a.part_l[at] = ll;
    }
  }
  // the arrivals: one lane of warp 0 for each (row, kv head) the unit fed,
  // an acq_rel atomic after the barrier (which orders every thread's
  // partial writes before it), read back by the unit that completes a row
  nexus::named_bar_sync(MERGE_BAR, 32 * CONSUMERS);
  if (warp == 0) {
    const int b_lo = w.b < 0 ? w.qr0 / p.R : w.b;
    const int b_hi = w.b < 0 ? (w.qr0 + w.nrows - 1) / p.R : w.b;
    int n = 0;
    for (int b0 = b_lo; b0 <= b_hi; b0 += 32) {
      const int b = b0 + lane;
      bool done = false;
      if (b <= b_hi) {
        int* cnt = a.counters + (size_t)b * a.Hkv + w.g;
        done = atomic_add_acq_rel(cnt, 1) + 1 == expected_arrivals(rows, p, b);
        if (done) *cnt = 0;  // every arrival of this launch is in
      }
      const unsigned mask = __ballot_sync(0xffffffffu, done);
      if (done) list[1 + n + __popc(mask & ((1u << lane) - 1))] = b;
      n += __popc(mask);
    }
    if (lane == 0) list[0] = n;
  }
  nexus::named_bar_sync(MERGE_BAR, 32 * CONSUMERS);
  const int n_done = list[0];
  if (n_done > 0) {
    const int n_rep = a.Hq / a.Hkv;
    // every completed row's query rows at once, four columns an item and
    // four items a thread side by side (their loads in flight together),
    // a running log-sum-exp over each item's partials
    constexpr int K = 4;
    const int n_items = n_done * p.R * (D / 4);
    for (int i0 = tid; i0 < n_items; i0 += K * 32 * CONSUMERS) {
      int np[K], c4[K], b[K], h[K], t[K];
      size_t at[K];
      float mm[K], ll[K];
      float4 o[K];
      int s_max = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = i0 + k * 32 * CONSUMERS;
        np[k] = 0;
        c4[k] = i % (D / 4);
        const int local = (i / (D / 4)) % p.R;
        b[k] = i < n_items ? list[1 + i / (p.R * (D / 4))] : 0;
        h[k] = w.g * n_rep + local / a.T;
        t[k] = local % a.T;
        at[k] = part_row(a, b[k], h[k], t[k], 0);
        if (i < n_items) np[k] = p.nsh + row_chunks(rows, p, b[k]);
        s_max = max(s_max, np[k]);
        mm[k] = MASK;
        ll[k] = 0.f;
        o[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int s = 0; s < s_max; ++s) {
        // the loads first, unconditionally (a finished item re-reads its
        // last partial), so that all of them are in flight at once
        float ms[K], ls[K];
        float4 x[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const size_t q = at[k] + min(s, max(np[k] - 1, 0));
          ms[k] = __ldcg(a.part_m + q);
          ls[k] = __ldcg(a.part_l + q);
          x[k] = __ldcg(reinterpret_cast<const float4*>(a.part_acc + q * D) + c4[k]);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool use = s < np[k];
          const float m_new = use ? fmaxf(mm[k], ms[k]) : mm[k];
          const float e_old = nexus::exp2_approx(mm[k] - m_new);
          const float e = use ? nexus::exp2_approx(ms[k] - m_new) : 0.f;
          mm[k] = m_new;
          ll[k] = ll[k] * e_old + ls[k] * e;
          o[k].x = o[k].x * e_old + x[k].x * e;
          o[k].y = o[k].y * e_old + x[k].y * e;
          o[k].z = o[k].z * e_old + x[k].z * e;
          o[k].w = o[k].w * e_old + x[k].w * e;
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (np[k] == 0) continue;
        const float inv = ll[k] == 0.f ? 0.f : 1.f / ll[k];
        uint2 packed;
        packed.x = nexus::pack_bf16(o[k].x * inv, o[k].y * inv);
        packed.y = nexus::pack_bf16(o[k].z * inv, o[k].w * inv);
        reinterpret_cast<uint2*>(a.out + (((size_t)b[k] * a.T + t[k]) * a.Hq + h[k]) * D)[c4[k]] =
            packed;
      }
    }
  }
  nexus::named_bar_sync(MERGE_BAR, 32 * CONSUMERS);  // list and merge area reused
}

template <int D, bool INT8>
__global__ void __launch_bounds__(THREADS, 1)
    paged_decode_kernel(const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map, Args a) {
  using G = Geo<D, INT8>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = nexus::align1024(smem_raw);
  unsigned char* ring = smem;
  unsigned char* work = smem + STAGES * G::STAGE;
  unsigned char* area = work + G::WORK;
  unsigned char* qbuf = area + G::MERGE;
  int* table = reinterpret_cast<int*>(qbuf + 2 * G::QBUF);
  const Rows rows{table, table + MAX_ROWS, table + 2 * MAX_ROWS, table + 3 * MAX_ROWS,
                  table + 4 * MAX_ROWS};
  uint64_t* full = reinterpret_cast<uint64_t*>(table + 5 * MAX_ROWS + 2);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;  // the two query buffers
  uint64_t* qempty = qfull + 2;
  int* list = reinterpret_cast<int*>(qempty + 2);  // [0]: count, [1..]: rows
  int* split = list + ROWS + 1;                        // shared_blocks, read once
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // row-by-row copies leave the rows past a stage's end as they are: zero
  // the ring once, so that they hold finite values, which masked
  // probabilities multiply by 0 (TMA stages fill those rows with zeros)
  if (a.box_rows == 0) {
    for (int i = tid; i < STAGES * G::STAGE / 16; i += THREADS)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
    nexus::fence_proxy_async();
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      nexus::mbar_init(&full[s], 1);
      nexus::mbar_init(&empty[s], CONSUMERS);
    }
    for (int s = 0; s < 2; ++s) {
      nexus::mbar_init(&qfull[s], 1);
      nexus::mbar_init(&qempty[s], CONSUMERS);
    }
    nexus::mbar_init_fence();
    *split = a.shared_blocks ? a.shared_blocks[0] : 0;
  }
  fill_rows(a, rows, tid, THREADS);
  __syncthreads();
  const Plan p = make_plan(a, rows, *split, lane);
  if (warp == 0) fill_prefix(a, rows, p, lane);
  __syncthreads();
  const int units = p.per_head * a.Hkv;
  int it = 0;  // stages so far: ring slot it % STAGES, its use it / STAGES

  if (warp == CONSUMERS) {  // the producer
    const size_t row_bytes = (size_t)D * G::ESZ;
    const char* kp = static_cast<const char*>(a.k_pool);
    const char* vp = static_cast<const char*>(a.v_pool);
    for (int u = blockIdx.x, n = 0; u < units; u += gridDim.x, ++n) {
      const Unit w = unit_at(a, rows, p, u, lane);
      // the unit's query rows, one bulk copy each, into query buffer n % 2
      if (n >= 2) nexus::mbar_wait(&qempty[n & 1], ((n >> 1) - 1) & 1);
      if (lane == 0) nexus::mbar_expect_tx(&qfull[n & 1], (uint32_t)(w.nrows * D * 2));
      __syncwarp();
      for (int i = lane; i < w.nrows; i += 32) {
        int b, h, t;
        query_row(a, p, w, i, &b, &h, &t);
        nexus::bulk_load(qbuf + (n & 1) * G::QBUF + i * G::QROW,
                         a.q + (((size_t)b * a.T + t) * a.Hq + h) * D, D * 2, &qfull[n & 1]);
      }
      const int p_begin = w.s0 * a.Bs, p_end = w.s1 * a.Bs;
      for (int p0 = p_begin; p0 < p_end; p0 += TILE, ++it) {
        const int slot = it % STAGES;
        const int nvalid = min(TILE, p_end - p0);
        unsigned char* st = ring + slot * G::STAGE;
        if (it >= STAGES) nexus::mbar_wait(&empty[slot], (it / STAGES - 1) & 1);
        if (a.box_rows > 0) {
          // TMA: one box per (pool block, K or V, 64 columns); lane j
          // looks up box j's block
          // boxes past the stage's end read past the pool's end: zeros
          const int nbox = TILE / a.box_rows;
          if (lane == 0) nexus::mbar_expect_tx(&full[slot], (uint32_t)(2 * TILE * row_bytes));
          __syncwarp();
          for (int j = lane; j < nbox; j += 32) {
            const int pos = p0 + j * a.box_rows;
            const int row = j * a.box_rows < nvalid
                                ? pool_block(a, w.b, pos / a.Bs) * a.Bs + pos % a.Bs
                                : a.N * a.Bs;
            if constexpr (INT8) {
              nexus::tma_load_3d(st + j * a.box_rows * D, &k_map, &full[slot], 0, w.g, row);
              nexus::tma_load_3d(st + (TILE + j * a.box_rows) * D, &v_map, &full[slot], 0, w.g,
                                 row);
            } else {
#pragma unroll
              for (int r = 0; r < D / 64; ++r) {
                const int off = r * G::REGION + j * a.box_rows * 128;
                nexus::tma_load_3d(st + off, &k_map, &full[slot], r * 64, w.g, row);
                nexus::tma_load_3d(st + G::TILE_BF + off, &v_map, &full[slot], r * 64, w.g, row);
              }
            }
          }
        } else {
          // row by row (a block size TMA boxes do not fit): int8 rows
          // whole with 1-d bulk copies, bf16 rows in 16-byte chunks at
          // their swizzled places
          if constexpr (!INT8) {
            for (int i = lane; i < nvalid; i += 32) {
              const int pos = p0 + i;
              const size_t row =
                  ((size_t)pool_block(a, w.b, pos / a.Bs) * a.Bs + pos % a.Bs) * a.Hkv + w.g;
#pragma unroll
              for (int c = 0; c < D / 8; ++c) {
                const int off = (c >> 3) * G::REGION + i * 128 + (((c & 7) ^ (i & 7)) << 4);
                nexus::cp_async16(st + off, kp + row * row_bytes + c * 16);
                nexus::cp_async16(st + G::TILE_BF + off, vp + row * row_bytes + c * 16);
              }
            }
            nexus::cp_async_arrive(&full[slot]);
            __syncwarp();
            if (lane == 0) nexus::mbar_arrive(&full[slot]);
          } else {
            if (lane == 0) nexus::mbar_expect_tx(&full[slot], (uint32_t)(2 * nvalid * row_bytes));
            __syncwarp();
            for (int i = lane; i < nvalid; i += 32) {
              const int pos = p0 + i;
              const size_t row =
                  ((size_t)pool_block(a, w.b, pos / a.Bs) * a.Bs + pos % a.Bs) * a.Hkv + w.g;
              nexus::bulk_load(st + i * D, kp + row * row_bytes, (uint32_t)row_bytes, &full[slot]);
              nexus::bulk_load(st + (TILE + i) * D, vp + row * row_bytes, (uint32_t)row_bytes,
                               &full[slot]);
            }
          }
        }
      }
    }
    return;
  }

  // consumers: first the (row, kv head) pairs no unit feeds (nothing
  // visible) get their zeros, then the units
  for (int pair = blockIdx.x; pair < a.B * a.Hkv; pair += gridDim.x) {
    const int b = pair / a.Hkv, g = pair % a.Hkv;
    if (expected_arrivals(rows, p, b) != 0) continue;
    const int n_rep = a.Hq / a.Hkv;
    for (int i = tid; i < p.R * (D / 4); i += 32 * CONSUMERS) {
      const int local = i / (D / 4), c4 = i % (D / 4);
      const int h = g * n_rep + local / a.T, t = local % a.T;
      reinterpret_cast<uint2*>(a.out + (((size_t)b * a.T + t) * a.Hq + h) * D)[c4] =
          make_uint2(0, 0);
    }
  }
  for (int u = blockIdx.x, n = 0; u < units; u += gridDim.x, ++n) {
    const Unit w = unit_at(a, rows, p, u, lane);
    if (w.nrows <= 16)
      consume_unit<D, INT8, 1>(a, rows, p, w, ring, work, area, qbuf, full, empty, qfull,
                               qempty, list, it, n, warp, lane);
    else if (w.nrows <= 32)
      consume_unit<D, INT8, 2>(a, rows, p, w, ring, work, area, qbuf, full, empty, qfull,
                               qempty, list, it, n, warp, lane);
    else
      consume_unit<D, INT8, 4>(a, rows, p, w, ring, work, area, qbuf, full, empty, qfull,
                               qempty, list, it, n, warp, lane);
  }
}

// Resident CTAs an SM, once per instantiation ([D == 128][INT8]). Internal
// linkage: a static local of the template below would be one object for the
// whole process (a GNU unique symbol), shared with any other build of this
// source loaded beside it, which would then skip its own attribute call.
static int per_sm_cache[2][2];

template <int D, bool INT8>
int launch(const CUtensorMap& k_map, const CUtensorMap& v_map, Args a, int max_units,
           cudaStream_t st) {
  using G = Geo<D, INT8>;
  int& per_sm = per_sm_cache[D == 128][INT8];
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<D, INT8>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, paged_decode_kernel<D, INT8>,
                                                        THREADS, G::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  a.ctas = std::max(1, per_sm * sms);
  const int grid = std::max(1, std::min(a.ctas, max_units));
  paged_decode_kernel<D, INT8><<<grid, THREADS, G::SMEM, st>>>(k_map, v_map, a);
  return (int)cudaGetLastError();
}

}  // namespace nexus_decode

// part_m, part_l: (B, Hq, T, pmax) f32; part_acc: (B, Hq, T, pmax, D) f32;
// counters: (B, Hkv) int32, all 0 before the first launch (each launch
// leaves them at 0). Block sizes that are a power of two from 8 up are read
// by TMA boxes through two tensor maps encoded here, per call (the pools'
// addresses change with the layer); other block sizes row by row. Returns 0
// or a cudaError_t.
extern "C" int nexus_paged_decode(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* block_table, const void* start, const void* n_blocks,
    const void* shared_table, const void* shared_blocks, void* out, void* part_m,
    void* part_l, void* part_acc, void* counters, int B, int T, int Hq, int Hkv, int D,
    int N, int Bs, int M, int window, int pmax, int int8, float scale, void* stream) {
  using namespace nexus_decode;
  if (B < 1 || B > MAX_ROWS || Hkv <= 0 || Hq % Hkv || T < 1 || Bs < 1 || M < 1 || N < 1 ||
      pmax < 2 || pmax > MAX_PARTIALS || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
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
  a.out = static_cast<bf16*>(out);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.counters = static_cast<int*>(counters);
  a.B = B; a.T = T; a.Hq = Hq; a.Hkv = Hkv; a.Bs = Bs; a.M = M; a.window = window;
  a.pmax = pmax; a.ctas = 1; a.N = N;
  a.scale_log2 = scale * LOG2E;
  const bool pow2 = Bs >= 8 && (Bs & (Bs - 1)) == 0;
  a.box_rows = pow2 ? std::min(Bs, TILE) : 0;
  CUtensorMap k_map, v_map;
  memset(&k_map, 0, sizeof(k_map));
  memset(&v_map, 0, sizeof(v_map));
  if (pow2) {
    const int elem = int8 ? 1 : 2, cols = int8 ? D : 64;
    int err = nexus::pool_map(&k_map, k_pool, (long)N * Bs, Hkv, D, elem, cols, a.box_rows);
    if (err == 0) err = nexus::pool_map(&v_map, v_pool, (long)N * Bs, Hkv, D, elem, cols, a.box_rows);
    if (err != 0) return err;
  }
  // an upper bound of the units (the grid never exceeds it): every row's
  // own slots and the shared run, cut at the smallest span
  const int R = (Hq / Hkv) * T;
  const int c_min = std::max(1, UNIT_MIN_POS / Bs);
  const long chunks = (long)B * ((M + c_min - 1) / c_min + 1) * ((R + ROWS - 1) / ROWS) +
                      (long)((M + c_min - 1) / c_min) * ((B * R + ROWS - 1) / ROWS);
  const int max_units = (int)std::min(chunks * Hkv, 1L << 30);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return int8 ? launch<64, true>(k_map, v_map, a, max_units, st)
                : launch<64, false>(k_map, v_map, a, max_units, st);
  return int8 ? launch<128, true>(k_map, v_map, a, max_units, st)
              : launch<128, false>(k_map, v_map, a, max_units, st);
}
