// K1: packed-segment flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel prime_rl_tpu/ops/flash_attention.py `_fwd_kernel`
// (pallas_call in `_fwd`). Same contract: q [B, Lq, NH, HD], k/v
// [B, Lk, NKV, HD] bf16; segment ids [B, L] int32 with 0 = padding; a query
// attends a key iff seg_q == seg_kv, seg_q != 0, (causal) row >= col and
// (window > 0) row - col < window; GQA maps q head h to kv head h / (NH /
// NKV); online softmax with f32 accumulators; out bf16 [B, Lq, NH, HD] and
// lse f32 [B, NH, Lq] (natural log, m + log l). A row that sees no key
// (padding, dummy prefill rows) gets out 0 and lse -1e30, as the TPU kernel's
// finalize does. Attention sinks (one learned logit per q head, f32 [NH];
// null = none) join the softmax denominator at the finalize as a virtual key
// of value 0: m_f = max(m, sink), l_f = l e^(m - m_f) + e^(sink - m_f), out =
// acc e^(m - m_f) / l_f, lse = m_f + log l_f; a row that sees no key then gets
// out 0 and lse = the sink. The window is a template flag (WINDOW) besides its
// value. No atomics and no split over kv: two runs give equal bits.
//
// What bounds it on the H100: at prefill and training lengths (64..4096)
// attention is compute-bound (4 HD flops per visible (query, key) pair and
// head against 4 L HD bytes a head), so the tensor cores are the resource,
// and only wgmma reaches their full rate. The design (FlashAttention-3's
// shape):
// - Work items of (q tile of 128 rows, q head, batch row), the q tiles with
//   the most kv tiles first under `causal`. Persistent blocks, one an SM,
//   each walking items i, i + grid, ...: with a window or packed rows an item
//   has two or three kv tiles, and a block an item would spend as long
//   starting and ending as computing. A block has two consumer warpgroups of
//   64 q rows each and one producer warp (168 registers a thread; no
//   `setmaxnreg`: with a producer warpgroup and 24/240 registers, ptxas
//   still allocated the consumers within the 168 of the launch, and spilled).
// - The producer warp runs one item ahead: it scans the item's kv segment ids
//   (the tile skip below), loads q by TMA into one of two q buffers, then the
//   visited k/v tiles of 128 rows, with each tile's 128 kv segment ids (a 1-D
//   map over the flat ids, each box from the 16-byte bound below its start),
//   into a ring guarded by full/empty mbarriers:
//   three stages at head dim 64, two at 128, as shared memory allows. The
//   k/v/q maps are 4-D (HD, heads, L, B), so rows past a batch row's end are
//   zero-filled instead of read from the next row; 128-byte swizzle, so HD
//   128 is two 64-column boxes.
// - S = Q K^T by wgmma m64n{SN}k16 with both operands in shared memory
//   (SN = 128 keys, or two chunks of 64 at head dim 128 and in the banded
//   form); S, the softmax statistics and the output accumulator O stay in
//   registers (each row is held by 4 threads: two shuffles reduce it). P is
//   rounded to bf16 in registers and is the register A operand of O += P V
//   (wgmma m64n{HD}k16, V MN-major). O leaves registers only in the epilogue, which
//   stages it through the item's q buffer for 16-byte coalesced stores.
// - Masks select: a masked score becomes -inf, and the running max starts at
//   -1e30 and stays finite, so a masked probability is exactly exp2(-inf) = 0
//   (with -1e30 for both, a row that has seen no key yet would get exp(0) =
//   1). Tiles wholly inside one segment, below the diagonal and inside the
//   band skip the mask; the others compare each column with its row's
//   causal/band range and, unless the tile is in one segment, its segment.
// - Tiles skipped: before an item's loads, the producer scans the kv segment
//   ids of its candidate tiles (the causal cut and the band's start), SCAN
//   tiles' ids in flight at once, and keeps only the tiles that hold a key
//   whose segment lies in [smallest non-zero, largest] of the q tile's ids.
//   That never drops a visible pair, whatever the order of the ids; a row of
//   four packed sequences visits about a quarter of its causal triangle.
//   `flash_tiles_visited` in ops/flash_attention.py is the plain mirror of
//   this rule. Given a `tiles` buffer (the `flash_attn_fwd_tiles` entry
//   point), the producer writes each item's visited and candidate tile counts
//   there, one slot an item, so a run can hold the kernel's visits against
//   the mirror.
// - Head dim 256 (Qwen3-Next): O of 64 rows is 64 x 256 f32, 128 registers a
//   thread, which two consumer warpgroups cannot hold within the 168 a
//   288-thread block gets; so an item is 64 q rows in one consumer warpgroup
//   (160 threads, up to 255 registers), a kv tile 64 rows (one chunk of S),
//   O += P V two m64n128 products a k step (`wgmma_rs<256>`), and shared
//   memory two q buffers and two k/v stages of 32 KB each (`Tiles<HD>`).
//   The skip rule's mirror runs at 64 x 64 there (`fwd_tiles`).

#include <climits>

#include "flash_attn_common.cuh"

namespace {

// the tiles and threads by head dim: 128 q rows an item in two consumer
// warpgroups of 64 and kv tiles of 128 rows at head dim 64 and 128; at 256 an
// output accumulator of 64 x 256 f32 takes 128 registers a thread, which two
// warpgroups cannot hold at the 168 a 288-thread block gets, so an item is 64
// q rows in one consumer warpgroup (160 threads, up to 255 registers) and a kv
// tile 64 rows, as shared memory allows (below)
template <int HD>
struct Tiles {
  static constexpr int BQ = HD == 256 ? 64 : 128;  // q rows a work item
  static constexpr int BK = HD == 256 ? 64 : 128;  // kv rows a tile
  static constexpr int CONSUMERS = BQ / 64;        // warpgroups of 64 q rows
  static constexpr int NTHREADS = 128 * CONSUMERS + 32;  // and one producer warp
  static constexpr int PRODUCER = 4 * CONSUMERS;         // the producer's warp index
};
constexpr int SCAN = 8;             // kv tiles whose segment ids the producer reads at once
constexpr float NEG_INF = -1e30f;   // the running max's floor and a no-key row's lse
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SMEM = 232448;    // what a block may use on the H100

// Shared memory. Tiles are 64-column boxes, each box [rows][64] bf16 with
// rows of 128 bytes in the 128-byte swizzle, the boxes of a tile back to
// back. q, the q tile's segment ids, its item's description and its kv tile
// flags are double-buffered by item; k, v and their segment ids by ring stage.
// At head dim 256: two q buffers of 32 KB and two stages of k and v of 32 KB
// each, about 194 KB.
template <int HD>
struct Smem {
  static constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  static constexpr int HALVES = HD / 64;  // 64-column boxes a row
  // k/v ring depth: three stages where they fit (head dim 64), else two
  static constexpr int STAGES = HD == 64 ? 3 : 2;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int q_off = 0;                              // [2] q tiles
  static constexpr int k_off = q_off + 2 * Q_BYTES;            // [STAGES] k tiles
  static constexpr int v_off = k_off + STAGES * KV_BYTES;      // [STAGES] v tiles
  static constexpr int SEG_SLOT = flat_slot_bytes(BK);        // a tile's kv ids
  static constexpr int seg_off = v_off + STAGES * KV_BYTES;    // [STAGES] id slots
  static constexpr int segq_off = seg_off + STAGES * SEG_SLOT;  // int [2][BQ]
  static constexpr int item_off = segq_off + 2 * BQ * 4;       // Item [2]
  static constexpr int bar_off = item_off + 64;  // full[S], empty[S], q_full[2], q_empty[2]
  static constexpr int flag_off = bar_off + 8 * (2 * STAGES + 4);  // uint8 [2][n_tiles]
  // 1024 bytes of slack: the swizzled tiles need a 1024-aligned base
  static size_t bytes(int n_tiles) { return 1024 + flag_off + 2 * n_tiles; }
};

// one work item: a q tile of one head and batch row, and its candidate kv
// tiles [j0, j0 + nt), of which flags say which are visited
struct Item {
  int q0, h, b, j0, nt;
};

// finalize of one row: (1 / denominator, lse); m is the row's raw max score
__device__ __forceinline__ void finalize(float m, float l, float scale, const float* sinks, int h,
                                         float& inv, float& row_lse) {
  const float m_nat = m * scale;  // rows that saw no key: about -1e30 * scale
  if (sinks != nullptr) {
    const float sink = sinks[h];
    const float m_f = fmaxf(m_nat, sink);
    const float alpha = expf(m_nat - m_f);
    const float l_f = l * alpha + expf(sink - m_f);
    inv = alpha / l_f;
    row_lse = m_f + logf(l_f);
  } else {
    inv = l > 0.f ? 1.f / l : 1.f;
    row_lse = l > 0.f ? m_nat + logf(l) : NEG_INF;
  }
}

template <int HD, bool WINDOW>
__global__ void __launch_bounds__(Tiles<HD>::NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_seg, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, const float* __restrict__ sinks,
                 int* __restrict__ tiles, int B, int Lq, int Lk, int NH, int NKV, float scale,
                 int causal, int window) {
  using S = Smem<HD>;
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK, CONSUMERS = Tiles<HD>::CONSUMERS;
  // keys of S a consumer holds at once: at head dim 128, O takes 64 registers
  // a thread and S of all 128 keys another 64, which with the rest passes the
  // 168 a thread that ptxas gives a block of 288 threads (9 warps: 3 on one
  // of the SM's four register files), so S goes in two chunks of 64 keys. So
  // does the banded form: a 128-row band's tiles hold chunks that a
  // warpgroup's 64 rows do not see at all, or see whole. At head dim 256 a
  // tile is one chunk of 64 keys.
  constexpr int SN = HD >= 128 || WINDOW ? 64 : 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  int* seg_s = reinterpret_cast<int*>(smem + S::seg_off);
  int* segq_s = reinterpret_cast<int*>(smem + S::segq_off);
  Item* items = reinterpret_cast<Item*>(smem + S::item_off);
  const int n_tiles = (Lk + BK - 1) / BK;
  uint8_t* flags = smem + S::flag_off;  // [2][n_tiles]
  const uint32_t full_bar = sbase + S::bar_off;
  const uint32_t empty_bar = full_bar + 8 * S::STAGES;
  const uint32_t q_full = full_bar + 16 * S::STAGES;
  const uint32_t q_empty = q_full + 16;

  const int n_q = (Lq + BQ - 1) / BQ, n_items = n_q * NH * B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);   // the loads' expect_tx
      mbar_init(empty_bar + 8 * s, 128 * CONSUMERS);  // every consumer thread
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 33);  // q's expect_tx + 32 lanes writing its item
      mbar_init(q_empty + 8 * i, 128 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == Tiles<HD>::PRODUCER) {
    // ---- producer warp: for each item, wait until its buffers are free (the
    // consumers finished the item two back), scan the kv segment ids of its
    // candidate tiles, load q, then the visited k/v tiles into the ring. It
    // runs up to one item ahead, so an item's scan and first loads overlap the
    // previous item's products.
    int stage = 0;
    uint32_t phase = 0;
    int it = 0;
    for (int e = blockIdx.x; e < n_items; e += gridDim.x, ++it) {
      const int buf = it & 1;
      // items with the most kv tiles first under `causal`
      const int qi = e / (NH * B), hb = e % (NH * B);
      const int h = hb % NH, b = hb / NH;
      const int q0 = (causal ? n_q - 1 - qi : qi) * BQ;
      int j1 = n_tiles;
      if (causal) j1 = min(j1, (min(q0 + BQ, Lq) - 1) / BK + 1);
      const int j0 = WINDOW ? max(0, q0 - window + 1) / BK : 0;
      const int nt = max(j1 - j0, 0);
      // the ids the scan needs are read before the wait for this item's
      // buffers (reads of global memory only), and q's load starts right
      // after it, under the scan
      const size_t kv_row = (size_t)b * Lk;
      int sq[BQ / 32];
#pragma unroll
      for (int u = 0; u < BQ / 32; ++u) {
        const int r = q0 + lane + 32 * u;
        sq[u] = r < Lq ? seg_q[(size_t)b * Lq + r] : 0;
      }
      int v[SCAN][BK / 32];  // SCAN tiles' kv ids in flight at once
      auto read_ids = [&](int t0) {
#pragma unroll
        for (int a = 0; a < SCAN; ++a) {
#pragma unroll
          for (int u = 0; u < BK / 32; ++u) {
            const int c = (j0 + t0 + a) * BK + lane + 32 * u;
            v[a][u] = t0 + a < nt && c < Lk ? seg_kv[kv_row + c] : 0;
          }
        }
      };
      read_ids(0);
      if (it >= 2) mbar_wait(q_empty + 8 * buf, ((it >> 1) - 1) & 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(q_full + 8 * buf, S::Q_BYTES);
#pragma unroll
        for (int hf = 0; hf < S::HALVES; ++hf)
          tma_load(sbase + S::q_off + buf * S::Q_BYTES + hf * BQ * 128, &tm_q, q_full + 8 * buf,
                   hf * 64, h, q0, b);
      }

      // the q tile's segment range [q_lo, q_hi] and whether it is one segment
      int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
      for (int u = 0; u < BQ / 32; ++u) {
        segq_s[buf * BQ + lane + 32 * u] = sq[u];
        if (sq[u] != 0) {
          lo = min(lo, sq[u]);
          hi = max(hi, sq[u]);
        }
      }
      const int q_lo = __reduce_min_sync(0xffffffffu, lo);
      const int q_hi = __reduce_max_sync(0xffffffffu, hi);
      bool one = q_lo == q_hi;
#pragma unroll
      for (int u = 0; u < BQ / 32; ++u) one = one && sq[u] == q_lo;
      const bool q_one = __all_sync(0xffffffffu, one);

      // flags[t]: bit 0 = visit tile j0 + t (it holds a key whose segment lies
      // in [q_lo, q_hi]); bit 1 = all its keys and all q rows share one segment
      uint8_t* fl = flags + buf * n_tiles;
      int visited = 0;
      for (int t0 = 0; t0 < nt; t0 += SCAN) {
        if (t0 > 0) read_ids(t0);
#pragma unroll
        for (int a = 0; a < SCAN; ++a) {
          bool any = false, all = true;
#pragma unroll
          for (int u = 0; u < BK / 32; ++u) {
            any = any || (v[a][u] != 0 && v[a][u] >= q_lo && v[a][u] <= q_hi);
            all = all && v[a][u] == q_lo;
          }
          any = __any_sync(0xffffffffu, any);
          all = __all_sync(0xffffffffu, all);
          if (t0 + a < nt) visited += any;
          if (lane == 0 && t0 + a < nt)
            fl[t0 + a] = (any ? 1 : 0) | (any && all && q_one ? 2 : 0);
        }
      }
      if (tiles != nullptr && lane == 0) {  // [B, NH, n_q, 2]: visited, candidates
        int* slot = tiles + 2 * (((size_t)b * NH + h) * n_q + q0 / BQ);
        slot[0] = visited;
        slot[1] = nt;
      }
      if (lane == 0) items[buf] = Item{q0, h, b, j0, nt};
      __syncwarp();
      mbar_arrive(q_full + 8 * buf);

      const int kvh = h / (NH / NKV);
      for (int t = 0; t < nt; ++t) {
        if (!(fl[t] & 1)) continue;
        const int k0 = (j0 + t) * BK;
        if (lane == 0) {  // k and v, each in HALVES boxes, and the tile's segment ids
          mbar_wait(empty_bar + 8 * stage, phase ^ 1);
          const uint32_t bar = full_bar + 8 * stage;
          mbar_arrive_expect_tx(bar, 2 * S::KV_BYTES + (BK + FLAT_PAD) * 4);
#pragma unroll
          for (int hf = 0; hf < S::HALVES; ++hf) {
            const int off = stage * S::KV_BYTES + hf * BK * 128;
            tma_load(sbase + S::k_off + off, &tm_k, bar, hf * 64, kvh, k0, b);
            tma_load(sbase + S::v_off + off, &tm_v, bar, hf * 64, kvh, k0, b);
          }
          tma_load_flat(sbase + S::seg_off + stage * S::SEG_SLOT, &tm_seg, bar, (int)kv_row + k0);
        }
        if (++stage == S::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64) of
  // each item
  const int wg = warp / 4, w = warp % 4;
  const float sl2 = scale * LOG2E;
  int stage = 0;
  uint32_t phase = 0;
  int it = 0;
  for (int e = blockIdx.x; e < n_items; e += gridDim.x, ++it) {
    const int buf = it & 1;
    mbar_wait(q_full + 8 * buf, (it >> 1) & 1);
    const Item item = items[buf];
    const uint8_t* fl = flags + buf * n_tiles;
    const uint32_t q_base = sbase + S::q_off + buf * S::Q_BYTES;
    const int row_base = item.q0 + 64 * wg;
    // this thread's two rows; its columns of every 8-wide group: 2 (lane % 4) + {0, 1}
    const int lr = 16 * w + lane / 4;  // local row of r0 in the warpgroup; r1 = lr + 8
    const int r0 = row_base + lr, r1 = r0 + 8;
    const int sq0 = segq_s[buf * BQ + 64 * wg + lr], sq1 = segq_s[buf * BQ + 64 * wg + lr + 8];
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // raw max; this thread's share of l

    for (int t = 0; t < item.nt; ++t) {
      const int f = fl[t];
      if (!(f & 1)) continue;
      const int k0 = (item.j0 + t) * BK;
      mbar_wait(full_bar + 8 * stage, phase);

      // the tile in chunks of SN keys: S[64 x SN] = Q K^T, the online
      // softmax, then O += P V over the chunk's SN rows of v. A chunk that no
      // row of this warpgroup sees (above the diagonal, below the band) is
      // skipped; one that every row sees whole needs no position mask.
      const bool seg_mask = !(f & 2);
#pragma unroll
      for (int ch = 0; ch < BK / SN; ++ch) {
        const int c0 = k0 + ch * SN, c1 = c0 + SN - 1;
        if ((causal && c0 > row_base + 63) || (WINDOW && c1 < row_base - window + 1)) continue;
        const bool pos_mask =
            (causal && c1 > row_base) || (WINDOW && c0 < row_base + 63 - window + 1);
        // K-major operands: +32 bytes a k16 step inside a box, the next box
        // BQ (BK) rows on; descriptors are offset from one base each, so
        // that only the base stays live
        const uint64_t dq = smem_desc(q_base + wg * 64 * 128, 16, 1024);
        const uint64_t dk =
            smem_desc(sbase + S::k_off + stage * S::KV_BYTES + ch * SN * 128, 16, 1024);
        float s[SN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int hf = kk / 4, kin = kk % 4;
          wgmma_ss<SN>(s, dq + ((hf * BQ * 128 + kin * 32) >> 4),
                       dk + ((hf * BK * 128 + kin * 32) >> 4), kk > 0);
        }
        wgmma_commit_and_wait();
        pin(s);

        // masks select: a masked score becomes -inf, and the running max
        // starts at -1e30 and stays finite, so a masked probability is
        // exactly 0 (no row computes exp(0) for a masked entry). Only tiles
        // that cross the diagonal, the band's edge or a segment's bounds are
        // masked.
        if (seg_mask || pos_mask) {
          // each row's visible columns of the chunk: [lo, hi] (causal, band;
          // r1's lo is r0's + 8) and none past Lk: the segment ids come from
          // a flat [B * Lk] map, so past a row's end they are the next row's
          const int hi0 = min(causal ? r0 - c0 : INT_MAX, Lk - 1 - c0);
          const int hi1 = min(causal ? r1 - c0 : INT_MAX, Lk - 1 - c0);
          const int lo = WINDOW ? r0 - c0 - window + 1 : INT_MIN;
          const int* sk = seg_s + stage * (S::SEG_SLOT / 4) + ((item.b * Lk + k0) & 3) + ch * SN;
#pragma unroll
          for (int i = 0; i < SN / 8; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int c = 8 * i + 2 * (lane % 4) + j;
              bool v0 = c >= lo && c <= hi0, v1 = c >= lo + 8 && c <= hi1;
              if (seg_mask) {
                const int ks = sk[c];
                v0 = v0 && sq0 != 0 && ks == sq0;
                v1 = v1 && sq1 != 0 && ks == sq1;
              }
              s[4 * i + j] = v0 ? s[4 * i + j] : MASKED;
              s[4 * i + 2 + j] = v1 ? s[4 * i + 2 + j] : MASKED;
            }
          }
        }

        // online softmax: the row max over the 4 threads of a row, two shuffles
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int i = 0; i < SN / 8; ++i) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
        }
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
        }
        const float alpha0 = ex2((m0 - mx0) * sl2), alpha1 = ex2((m1 - mx1) * sl2);
        m0 = mx0;
        m1 = mx1;
        const float b0 = mx0 * sl2, b1 = mx1 * sl2;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int i = 0; i < SN / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float p0 = ex2(fmaf(s[4 * i + j], sl2, -b0));  // masked: ex2(-inf) = 0
            const float p1 = ex2(fmaf(s[4 * i + 2 + j], sl2, -b1));
            s[4 * i + j] = p0;
            s[4 * i + 2 + j] = p1;
            sum0 += p0;
            sum1 += p1;
          }
        }
        l0 = l0 * alpha0 + sum0;
        l1 = l1 * alpha1 + sum1;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
          o[4 * i] *= alpha0;
          o[4 * i + 1] *= alpha0;
          o[4 * i + 2] *= alpha1;
          o[4 * i + 3] *= alpha1;
        }

        // O += P V: S's accumulator fragment of columns [16 kk, 16 kk + 16)
        // is the register A fragment of k step kk; V is MN-major (+2048 bytes
        // a k16 step, its two 64-column boxes BK * 128 bytes apart)
        uint32_t pa[SN / 16][4];
#pragma unroll
        for (int kk = 0; kk < SN / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
        }
        const uint64_t dv =
            smem_desc(sbase + S::v_off + stage * S::KV_BYTES + ch * SN * 128, BK * 128, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SN / 16; ++kk) wgmma_rs<HD>(o, pa[kk], dv + ((kk * 16 * 128) >> 4));
        wgmma_commit_and_wait();
        pin(o);
      }
      mbar_arrive(empty_bar + 8 * stage);
      if (++stage == S::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- epilogue: l summed over the row's 4 threads, the finalize, out
    // staged in this warpgroup's own rows of the q tile (its last reads of
    // them are complete), then 16-byte coalesced stores; the q buffer is free
    // for the item two ahead once every consumer thread has read its rows back
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    float inv0, inv1, lse0, lse1;
    finalize(m0, l0, scale, sinks, item.h, inv0, lse0);
    finalize(m1, l1, scale, sinks, item.h, inv1, lse1);
    if (lane % 4 == 0) {
      float* lrow = lse + ((size_t)item.b * NH + item.h) * Lq;
      if (r0 < Lq) lrow[r0] = lse0;
      if (r1 < Lq) lrow[r1] = lse1;
    }
    stage_rows<HD>(o, inv0, inv1, q_base, BQ, 64 * wg, lr, lane);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    store_rows<HD>(out + (((size_t)item.b * Lq + row_base) * NH + item.h) * HD, (size_t)NH * HD,
                   smem + (q_base - sbase), BQ, 64 * wg, Lq - row_base);
    // the next TMA write of this buffer comes through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(q_empty + 8 * buf);
  }
}

// ---- head dims 384 and 512: the plain form ----------------------------------
// A block a (q tile of 16 rows, q head, batch row); kv tiles of 32 keys, the
// same candidate and segment-range rule as above (fwd_tiles in
// ops/flash_attention.py gives the wrapper these tiles). Scores go through
// shared memory as f32, the online softmax is one warp a row (a lane a key)
// in base 2, and each thread keeps two adjacent columns of the 16 rows'
// output in registers. Slow next to the wgmma form, but right: at these
// widths the bound is the operations, and this form does them on the f32
// units (67 TFLOP/s on the H100's data sheet) at the rate its shared-memory
// reads allow.
namespace wide {
constexpr int FWD_BQ = 16, FWD_BK = 32;

template <int HD>
constexpr size_t fwd_smem() {
  return (size_t)(FWD_BQ + 2 * FWD_BK) * pitch<HD>() * 2;
}
}  // namespace wide

template <int HD>
__global__ void __launch_bounds__(wide::THREADS)
flash_fwd_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
                      const int* __restrict__ seg_kv, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, const float* __restrict__ sinks, int* tiles, int Lq,
                      int Lk, int NH, int NKV, float scale, int causal, int window) {
  using namespace wide;
  constexpr int BQ = FWD_BQ, BK = FWD_BK, PT = pitch<HD>();
  static_assert(BK == 32, "the softmax step gives each lane one key");
  extern __shared__ __align__(16) uint8_t wide_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(wide_smem);
  __nv_bfloat16* ks = qs + BQ * PT;
  __nv_bfloat16* vs = ks + BK * PT;
  __shared__ float ps[BQ][BK];
  __shared__ float m_run[BQ], l_run[BQ], alpha[BQ];
  __shared__ int sq[BQ], sk[BK], seg_lo, seg_hi;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, kh = h / (NH / NKV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = qt * BQ;
  const float sl2 = scale * LOG2E;
  if (tid < BQ) {
    const int r = row0 + tid;
    sq[tid] = r < Lq ? seg_q[(size_t)b * Lq + r] : 0;
    m_run[tid] = MASKED;
    l_run[tid] = 0.f;
  }
  load_rows<HD>(qs, q, b, Lq, NH, h, row0, BQ);
  segment_range(sq, BQ, &seg_lo, &seg_hi);
  const int lo = seg_lo, hi = seg_hi;

  const int nk = (Lk + BK - 1) / BK;
  const int j_end = causal ? min(nk, (min(row0 + BQ, Lq) - 1) / BK + 1) : nk;
  const int j_begin = window > 0 ? max(row0 - window + 1, 0) / BK : 0;
  const int d0 = 2 * tid;  // this thread's columns d0, d0 + 1 (none past HD)
  float acc[BQ][2];
#pragma unroll
  for (int i = 0; i < BQ; ++i) acc[i][0] = acc[i][1] = 0.f;
  int visited = 0;

  for (int j = j_begin; j < j_end; ++j) {
    const int c0 = j * BK;
    int key_seg = 0;
    if (tid < BK) {
      key_seg = c0 + tid < Lk ? seg_kv[(size_t)b * Lk + c0 + tid] : 0;
      sk[tid] = key_seg;
    }
    if (!__syncthreads_or(key_seg != 0 && key_seg >= lo && key_seg <= hi)) continue;
    ++visited;
    load_rows<HD>(ks, k, b, Lk, NKV, kh, c0, BK);
    load_rows<HD>(vs, v, b, Lk, NKV, kh, c0, BK);
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += THREADS) {
      const int i = e / BK, jj = e % BK, r = row0 + i, c = c0 + jj;
      float sc = MASKED;
      if (r < Lq && c < Lk && visible(r, c, sq[i], sk[jj], causal, window))
        sc = dot_rows<HD>(qs + i * PT, ks + jj * PT) * sl2;
      ps[i][jj] = sc;
    }
    __syncthreads();
    for (int i = warp; i < BQ; i += THREADS / 32) {
      const float sc = ps[i][lane];
      const float m_old = m_run[i], m_new = fmaxf(m_old, warp_max(sc));
      const float p = m_new == MASKED ? 0.f : exp2f(sc - m_new);
      const float a = m_new == MASKED ? 1.f : exp2f(m_old - m_new);
      const float sum = warp_sum(p);
      ps[i][lane] = p;
      if (lane == 0) {
        m_run[i] = m_new;
        l_run[i] = l_run[i] * a + sum;
        alpha[i] = a;
      }
    }
    __syncthreads();
    if (d0 < HD) {
#pragma unroll
      for (int i = 0; i < BQ; ++i) {
        acc[i][0] *= alpha[i];
        acc[i][1] *= alpha[i];
      }
      for (int jj = 0; jj < BK; ++jj) {
        const float2 vv = pair_at(vs + jj * PT, d0);
#pragma unroll
        for (int i = 0; i < BQ; ++i) {
          acc[i][0] = fmaf(ps[i][jj], vv.x, acc[i][0]);
          acc[i][1] = fmaf(ps[i][jj], vv.y, acc[i][1]);
        }
      }
    }
    __syncthreads();
  }

  if (tiles != nullptr && tid == 0) {
    int* t = tiles + (((size_t)b * NH + h) * gridDim.x + qt) * 2;
    t[0] = visited;
    t[1] = max(j_end - j_begin, 0);
  }
  // each row's factor and lse, once (thread i takes row i), into alpha[]
  // in natural units, so that a row that saw no key gets exactly the sink
  if (tid < BQ) {
    const float m = m_run[tid] / LOG2E;
    float l = l_run[tid], c = 1.f, m_f = m;
    if (sinks != nullptr) {  // a virtual key of value 0 in the denominator
      m_f = fmaxf(m, sinks[h]);
      c = m_run[tid] == MASKED ? 0.f : expf(m - m_f);
      l = l * c + expf(sinks[h] - m_f);
    }
    alpha[tid] = l > 0.f ? c / l : 0.f;
    if (row0 + tid < Lq)
      lse[((size_t)b * NH + h) * Lq + row0 + tid] = l > 0.f ? m_f + logf(l) : NEG_INF;
  }
  __syncthreads();
  if (d0 < HD) {
#pragma unroll
    for (int i = 0; i < BQ; ++i) {
      if (row0 + i < Lq)
        *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * Lq + row0 + i) * NH + h) * HD +
                                           d0) =
            __floats2bfloat162_rn(acc[i][0] * alpha[i], acc[i][1] * alpha[i]);
    }
  }
}

template <int HD>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const int* seg_q,
                        const int* seg_kv, void* out, float* lse, const float* sinks, int* tiles,
                        int B, int Lq, int Lk, int NH, int NKV, float scale, int causal,
                        int window, cudaStream_t stream) {
  if (B == 0 || Lq == 0) return cudaSuccess;
  if (Lk == 0) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_wide_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)wide::fwd_smem<HD>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Lq + wide::FWD_BQ - 1) / wide::FWD_BQ, NH, B);
  flash_fwd_wide_kernel<HD><<<grid, wide::THREADS, wide::fwd_smem<HD>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg_q, seg_kv, static_cast<__nv_bfloat16*>(out), lse,
      sinks, tiles, Lq, Lk, NH, NKV, scale, causal, window);
  return cudaGetLastError();
}

// ---- host side ---------------------------------------------------------------


template <int HD>
size_t smem_of(int Lk) {
  return Smem<HD>::bytes((Lk + Tiles<HD>::BK - 1) / Tiles<HD>::BK);
}

size_t smem_bytes(int hd, int Lk) {
  if (hd == 384) return wide::fwd_smem<384>();
  if (hd == 512) return wide::fwd_smem<512>();
  return hd == 256 ? smem_of<256>(Lk) : hd == 128 ? smem_of<128>(Lk) : smem_of<64>(Lk);
}

template <int HD, bool WINDOW>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg_q,
                   const int* seg_kv, void* out, float* lse, const float* sinks, int* tiles, int B,
                   int Lq, int Lk, int NH, int NKV, float scale, int causal, int window,
                   cudaStream_t stream) {
  if (B == 0 || Lq == 0) return cudaSuccess;
  const size_t smem = smem_bytes(HD, Lk);
  if (smem > MAX_SMEM || Lk == 0) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD, WINDOW>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tseg;
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  if (!tensor_map(&tq, encode, q, HD, NH, Lq, B, BQ) ||
      !tensor_map(&tk, encode, k, HD, NKV, Lk, B, BK) ||
      !tensor_map(&tv, encode, v, HD, NKV, Lk, B, BK) ||
      !flat_map(&tseg, encode, seg_kv, B * Lk, BK + FLAT_PAD, CU_TENSOR_MAP_DATA_TYPE_INT32))
    return cudaErrorInvalidValue;
  // persistent: one block an SM (its shared memory allows no second), each
  // walking the items i, i + grid, ...
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int n_items = (Lq + BQ - 1) / BQ * NH * B;
  flash_fwd_kernel<HD, WINDOW><<<min(n_items, sms), Tiles<HD>::NTHREADS, smem, stream>>>(
      tq, tk, tv, tseg, seg_q, seg_kv, static_cast<__nv_bfloat16*>(out), lse, sinks, tiles, B, Lq,
      Lk, NH, NKV, scale, causal, window);
  return cudaGetLastError();
}

int run(const void* q, const void* k, const void* v, const void* seg_q, const void* seg_kv,
        void* out, void* lse, const void* sinks, int* tiles, int B, int Lq, int Lk, int NH,
        int NKV, int HD, float scale, int causal, int window, void* stream) {
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_kv);
  float* l = static_cast<float*>(lse);
  const float* snk = static_cast<const float*>(sinks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRT_FWD_CASE(hd, w)                                                                  \
  if (HD == hd && (window > 0) == w)                                                          \
    return launch<hd, w>(q, k, v, sq, sk, out, l, snk, tiles, B, Lq, Lk, NH, NKV, scale,      \
                         causal, window, st);
  PRT_FWD_CASE(64, false) PRT_FWD_CASE(64, true) PRT_FWD_CASE(128, false) PRT_FWD_CASE(128, true)
  PRT_FWD_CASE(256, false) PRT_FWD_CASE(256, true)
#undef PRT_FWD_CASE
  if (HD == 384 || HD == 512)
    return (HD == 384 ? launch_wide<384> : launch_wide<512>)(q, k, v, sq, sk, out, l, snk, tiles,
                                                             B, Lq, Lk, NH, NKV, scale, causal,
                                                             window, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const void* seg_q,
                              const void* seg_kv, void* out, void* lse, const void* sinks, int B,
                              int Lq, int Lk, int NH, int NKV, int HD, float scale, int causal,
                              int window, void* stream) {
  return run(q, k, v, seg_q, seg_kv, out, lse, sinks, nullptr, B, Lq, Lk, NH, NKV, HD, scale,
             causal, window, stream);
}

// the same launch, also writing each work item's kv tile counts into `tiles`
// (int32 [B, NH, ceil(Lq / BQ), 2]: visited, candidates; BQ = 128, 64 at
// head dim 256, 16 at 384 and 512)
extern "C" int flash_attn_fwd_tiles(const void* q, const void* k, const void* v,
                                    const void* seg_q, const void* seg_kv, void* out, void* lse,
                                    const void* sinks, int B, int Lq, int Lk, int NH, int NKV,
                                    int HD, float scale, int causal, int window, void* stream,
                                    void* tiles) {
  return run(q, k, v, seg_q, seg_kv, out, lse, sinks, static_cast<int*>(tiles), B, Lq, Lk, NH,
             NKV, HD, scale, causal, window, stream);
}

// dynamic shared memory of one block at head dim `hd` over `Lk` keys
extern "C" int flash_attn_fwd_smem(int hd, int Lk) { return (int)smem_bytes(hd, Lk); }

// the compiled kernel of head dim `hd` and form `window` (0 dense, 1 banded)
// as the runtime loaded it: attrs = {registers a thread, local memory a
// thread in bytes (spills; 0 when none), static shared memory in bytes,
// threads a block}
extern "C" int flash_attn_fwd_attributes(int hd, int window, int* attrs) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  if (hd == 64) {
    err = window ? cudaFuncGetAttributes(&a, flash_fwd_kernel<64, true>)
                 : cudaFuncGetAttributes(&a, flash_fwd_kernel<64, false>);
  } else if (hd == 128) {
    err = window ? cudaFuncGetAttributes(&a, flash_fwd_kernel<128, true>)
                 : cudaFuncGetAttributes(&a, flash_fwd_kernel<128, false>);
  } else if (hd == 256) {
    err = window ? cudaFuncGetAttributes(&a, flash_fwd_kernel<256, true>)
                 : cudaFuncGetAttributes(&a, flash_fwd_kernel<256, false>);
  } else if (hd == 384) {  // the plain form: one kernel for both forms
    err = cudaFuncGetAttributes(&a, flash_fwd_wide_kernel<384>);
  } else if (hd == 512) {
    err = cudaFuncGetAttributes(&a, flash_fwd_wide_kernel<512>);
  }
  if (err != cudaSuccess) return (int)err;
  attrs[0] = a.numRegs;
  attrs[1] = (int)a.localSizeBytes;
  attrs[2] = (int)a.sharedSizeBytes;
  attrs[3] = a.maxThreadsPerBlock;
  return 0;
}
