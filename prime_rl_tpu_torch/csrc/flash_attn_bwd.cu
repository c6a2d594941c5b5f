// K2a / K2b: packed-segment flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels prime_rl_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` (K2a, the first pallas_call in `_bwd`) and
// `_bwd_dkv_kernel` (K2b, the second). Same contract as the forward (K1,
// flash_attn_fwd.cu): q/do/dq [B, Lq, NH, HD], k/v/dk/dv [B, Lk, NKV, HD]
// bf16; segment ids [B, L] int32 with 0 = padding; lse and delta f32
// [B, NH, Lq], where delta = sum(out * do, -1) minus the lse cotangent (the
// wrapper computes it). With mask = same non-zero segment, (causal) row >= col
// and (window > 0) row - col < window:
//
//   s  = q k^T * scale              p  = mask ? exp(s - lse) : 0
//   dp = do v^T                     ds = bf16(p * (dp - delta))
//   dq = (sum_kv ds k) * scale                                   (K2a)
//   dv = sum_{g, q} bf16(p)^T do    dk = (sum_{g, q} ds^T q) * scale   (K2b)
//
// The mask selects: a masked score becomes -inf before the exponential, so a
// row that saw no key (lse = -1e30: padding, dummy rows) never evaluates
// exp(s + 1e30): it gives dq = 0 and adds nothing to dk/dv whatever `do`
// holds. Attention sinks need no input here: the sink is inside the saved lse,
// and its own gradient is a reduction over (lse, delta) that the wrapper does.
// The window is a template flag (WINDOW) besides its value. No atomics and no
// split of a sum over blocks: two runs give equal bits.
//
// What bounds them on the H100: like the forward they are compute-bound at
// training lengths: K2a does three and K2b four products of 2 * 64 * 64 * HD
// flops for each visited pair of 64-row tiles, against a few bytes an
// element, so the tensor cores are the resource and only wgmma reaches their
// rate. The design is K1's (flash_attn_fwd.cu) with one more product a tile:
// work items heaviest first under `causal`, walked by persistent blocks in
// rounds that go up and down the blocks in turn (`snake_item`) where one block
// fills an SM, else one block an item (`grid_size`); one producer warp scans
// the segment ids, then loads the visited tiles by TMA (4-D maps (HD, heads,
// L, B) in the 128-byte swizzle, so rows past a batch row's end read as 0; 1-D
// maps over the flat ids, lse and delta, each box from the 16-byte bound below
// its start) into a ring behind full/empty mbarriers, one item ahead of the
// consumers; every product is a wgmma, the score-sized tiles (S, dP, P, dS)
// live only in registers, and accumulators stay in registers until an
// epilogue that stages them through shared memory for 16-byte stores.
// - K2a (dq): items of (128 q rows, q head, batch row) and two consumer
//   warpgroups of 64 q rows, as in K1. A k/v ring stage is a 64-row tile:
//   S = Q K^T and dP = dO V^T (both operands K-major), dS in registers, then
//   dq += dS K with dS as the register A operand and K read MN-major. Its
//   kv tiles are skipped by K1's rule at 128 x 64 tiles (`flash_tiles_visited`
//   with bk = 64). 288 threads get 168 registers: at head dim 128 dq takes 64
//   a thread, so S and dP go in chunks of 32 keys (16 registers each).
// - K2b (dk, dv): items of (64 kv rows, kv head, batch row), k and v held by
//   item (double-buffered), the q heads of the GQA group and their visited
//   64-row q tiles streamed through the ring with their lse, delta and ids.
//   One consumer warpgroup computes the transposed tiles S^T = K Q^T and
//   dP^T = V dO^T (SS), P^T and dS^T in registers, dv += bf16(P^T) dO and
//   dk += dS^T Q (RS, dO and Q read MN-major from the tiles S^T read K-major).
//   dk + dv take 128 registers a thread at head dim 128, which two warpgroups
//   could not hold at the 168 a 288-thread block gets, so a block is one
//   consumer warpgroup and the producer warp (160 threads, up to 255
//   registers: about 246 at head dim 128, one block an SM; 168 at head dim
//   64, two blocks an SM). A q tile is visited only if it lies from the
//   causal diagonal to the band's end and holds a query whose segment lies in
//   [smallest non-zero, largest] of the kv tile's ids
//   (`flash_bwd_dkv_tiles_visited`); every dk/dv element is written by one
//   block once.
// - Head dim 256 (Qwen3-Next): K2a's dq takes 128 registers a thread, so an
//   item is 64 q rows in one consumer warpgroup (160 threads), q and dO
//   single-buffered (`DqCfg`: the k/v ring's two stages of 64 KB leave room
//   for one of each); its mirror runs at 64 x 64. K2b's dk + dv would take
//   256, so an item computes one half of D of both (`DkvCfg`: 128 columns,
//   S^T and dP^T still over all of D, so those two products run twice a kv
//   tile), k and v single-buffered; every dk/dv element is still written by
//   one block once.
// Given a `tiles` buffer (the `*_tiles` entry points; null on the path), the
// producer writes each item's visited and candidate tile counts there, one
// slot an item, so a run can hold the kernel's visits against the mirrors.

#include <climits>

#include "flash_attn_common.cuh"

namespace {

constexpr int SCAN = 8;            // tiles whose segment ids the producer reads at once
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SMEM = 232448;   // what a block may use on the H100

// K2a: 128 q rows an item in two consumer warpgroups, 64-row k/v tiles; at
// head dim 256, where dq takes 128 registers a thread, 64 q rows in one
// consumer warpgroup (160 threads, up to 255 registers), and q and dO
// single-buffered: two k/v stages of 64 KB leave room for one q and one dO
// tile of 32 KB each, about 194 KB
template <int HD>
struct DqCfg {
  static constexpr int BQ = HD == 256 ? 64 : 128;
  static constexpr int BK = 64;
  static constexpr int CONSUMERS = BQ / 64;
  static constexpr int THREADS = 128 * CONSUMERS + 32;
  static constexpr int PRODUCER = 4 * CONSUMERS;  // the producer's warp index
  static constexpr int QBUF = HD == 256 ? 1 : 2;  // q/dO buffers: items in flight
};

// K2b: 64 kv rows an item in one consumer warpgroup, 64-row q tiles. dk and
// dv take HD / 2 registers a thread each; at head dim 256 that is 256, so an
// item there computes one half of D (DH = 128 columns) of dk and dv: S^T and
// dP^T still run over all of D, twice a kv tile, and the products into dk
// and dv over the item's half. k and v (64 KB at 256) are single-buffered
// there, beside two stages of q and dO, about 195 KB.
constexpr int KV_BK = 64;
constexpr int KV_BQ = 64;
constexpr int KV_THREADS = 128 + 32;
constexpr int KV_PRODUCER = 4;

template <int HD>
struct DkvCfg {
  static constexpr int DH = HD == 256 ? 128 : HD;  // columns of dk and dv an item
  static constexpr int NSPLIT = HD / DH;            // items a kv tile
  static constexpr int KVBUF = HD == 256 ? 1 : 2;   // k/v buffers: items in flight
};

// Shared memory of K2a. Tiles are 64-column boxes, each [rows][64] bf16 with
// rows of 128 bytes in the 128-byte swizzle, the boxes of a tile back to back.
// q, dO and the q rows' ids, lse and delta are double-buffered by item; k, v
// and their ids by ring stage.
template <int HD>
struct DqSmem {
  static constexpr int BQ = DqCfg<HD>::BQ, BK = DqCfg<HD>::BK, QBUF = DqCfg<HD>::QBUF;
  static constexpr int HALVES = HD / 64;
  static constexpr int STAGES = HD == 64 ? 4 : 2;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int q_off = 0;                              // [QBUF] q tiles
  static constexpr int do_off = q_off + QBUF * Q_BYTES;        // [QBUF] dO tiles
  static constexpr int k_off = do_off + QBUF * Q_BYTES;        // [STAGES] k tiles
  static constexpr int v_off = k_off + STAGES * KV_BYTES;      // [STAGES] v tiles
  static constexpr int SEG_SLOT = flat_slot_bytes(BK);         // a tile's kv ids
  static constexpr int seg_off = v_off + STAGES * KV_BYTES;    // [STAGES] id slots
  static constexpr int row_off = seg_off + STAGES * SEG_SLOT;  // {ids, lse, delta}[QBUF][BQ]
  static constexpr int item_off = row_off + QBUF * 3 * BQ * 4;  // DqItem [QBUF]
  static constexpr int bar_off = item_off + 64;  // full[S], empty[S], q_full[2], q_empty[2]
  static constexpr int flag_off = bar_off + 8 * (2 * STAGES + 4);  // uint8 [QBUF][n_tiles]
  // 1024 bytes of slack: the swizzled tiles need a 1024-aligned base
  static size_t bytes(int n_tiles) { return 1024 + flag_off + 2 * n_tiles; }
};

// Shared memory of K2b: k and v (and the kv ids) double-buffered by item; q,
// dO and the q rows' lse, delta and ids by ring stage.
template <int HD>
struct DkvSmem {
  static constexpr int KVBUF = DkvCfg<HD>::KVBUF;
  static constexpr int HALVES = HD / 64;
  static constexpr int STAGES = HD == 64 ? 4 : HD == 128 ? 3 : 2;
  static constexpr int TILE_BYTES = 64 * HD * 2;  // a 64-row tile of k, v, q or dO
  static constexpr int SLOT = flat_slot_bytes(KV_BQ);  // a q tile's lse, delta or ids
  static constexpr int ROW_BYTES = 3 * SLOT;
  static constexpr int k_off = 0;                              // [KVBUF] k tiles
  static constexpr int v_off = k_off + KVBUF * TILE_BYTES;     // [KVBUF] v tiles
  static constexpr int q_off = v_off + KVBUF * TILE_BYTES;     // [STAGES] q tiles
  static constexpr int do_off = q_off + STAGES * TILE_BYTES;   // [STAGES] dO tiles
  static constexpr int row_off = do_off + STAGES * TILE_BYTES;  // [STAGES] x {lse, delta, ids}
  static constexpr int segk_off = row_off + STAGES * ROW_BYTES;  // int [KVBUF][BK]
  static constexpr int item_off = segk_off + KVBUF * KV_BK * 4;  // DkvItem [KVBUF]
  static constexpr int bar_off = item_off + 64;  // full[S], empty[S], kv_full[2], kv_empty[2]
  static constexpr int flag_off = bar_off + 8 * (2 * STAGES + 4);  // uint8 [KVBUF][n_q_tiles]
  static size_t bytes(int n_tiles) { return 1024 + flag_off + 2 * n_tiles; }
};

// a K2a item: a q tile of one head and batch row, and its candidate kv tiles
// [j0, j0 + nt), of which flags say which are visited
struct DqItem {
  int q0, h, b, j0, nt;
};

// a K2b item: a kv tile of one kv head and batch row, its candidate q tiles
// [i0, i0 + nt) (the same for every head of the group), and the half of D
// whose dk and dv it computes (0 below head dim 256)
struct DkvItem {
  int k0, kvh, b, i0, nt, half;
};

// the work item a block takes in round r: with the items sorted heaviest
// first, the rounds walk the blocks up and down in turn, so that each block's
// items sum to near the mean (round-robin gave block 0 the heaviest of every
// round: with two items a block, 1.5x the mean at L = 4096)
__device__ __forceinline__ int snake_item(int r) {
  return r * gridDim.x + (r & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// the visit flags of SCAN candidate tiles at once, from 64 ids a tile (two a
// lane) against the other side's segment range [lo, hi]: bit 0 = visit (a
// non-zero id in the range), bit 1 = visited and every id equals lo while the
// other side is one segment (`one`); returns the number visited
__device__ __forceinline__ int scan_flags(const int (&v)[SCAN][2], int t0, int nt, int lo, int hi,
                                          bool one, uint8_t* fl, int lane) {
  int visited = 0;
#pragma unroll
  for (int a = 0; a < SCAN; ++a) {
    bool any = false, all = true;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      any = any || (v[a][u] != 0 && v[a][u] >= lo && v[a][u] <= hi);
      all = all && v[a][u] == lo;
    }
    any = __any_sync(0xffffffffu, any);
    all = __all_sync(0xffffffffu, all);
    if (t0 + a < nt) {
      visited += any;
      if (lane == 0) fl[t0 + a] = (any ? 1 : 0) | (any && all && one ? 2 : 0);
    }
  }
  return visited;
}

// the segment range [lo, hi] of the ids a warp holds (n a lane) and whether
// they are all one non-zero segment
template <int N>
__device__ __forceinline__ void segment_range(const int (&ids)[N], int& lo, int& hi, bool& one) {
  int l = INT_MAX, h = INT_MIN;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    if (ids[u] != 0) {
      l = min(l, ids[u]);
      h = max(h, ids[u]);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, l);
  hi = __reduce_max_sync(0xffffffffu, h);
  bool same = lo == hi;
#pragma unroll
  for (int u = 0; u < N; ++u) same = same && ids[u] == lo;
  one = __all_sync(0xffffffffu, same);
}

// ---------------------------------------------------------------------------
// K2a: dq
// ---------------------------------------------------------------------------
template <int HD, bool WINDOW>
__global__ void __launch_bounds__(DqCfg<HD>::THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_seg, const int* __restrict__ seg_q,
                    const int* __restrict__ seg_kv, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                    int* __restrict__ tiles, int B, int Lq, int Lk, int NH, int NKV, float scale,
                    int causal, int window) {
  using S = DqSmem<HD>;
  constexpr int BQ = S::BQ, BK = S::BK, QBUF = S::QBUF, CONSUMERS = DqCfg<HD>::CONSUMERS;
  // keys of S and dP a consumer holds at once: at head dim 128, dq takes 64
  // registers a thread, and S and dP of all 64 keys another 64, which with the
  // rest passes the 168 a thread that ptxas gives a block of 288 threads (9
  // warps: 3 on one of the SM's four register files), so they go in two
  // chunks of 32 keys; at 256 dq takes 128 of the 255 a 160-thread block gets
  constexpr int SN = HD == 64 ? 64 : 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  int* seg_s = reinterpret_cast<int*>(smem + S::seg_off);             // [STAGES] id slots
  int* segq_s = reinterpret_cast<int*>(smem + S::row_off);  // [QBUF][BQ]
  float* lse_s = reinterpret_cast<float*>(smem + S::row_off) + QBUF * BQ;  // * log2(e)
  float* delta_s = lse_s + QBUF * BQ;                                     // [QBUF][BQ]
  DqItem* items = reinterpret_cast<DqItem*>(smem + S::item_off);
  const int n_tiles = (Lk + BK - 1) / BK;
  uint8_t* flags = smem + S::flag_off;  // [QBUF][n_tiles]
  const uint32_t full_bar = sbase + S::bar_off;
  const uint32_t empty_bar = full_bar + 8 * S::STAGES;
  const uint32_t q_full = full_bar + 16 * S::STAGES;
  const uint32_t q_empty = q_full + 16;

  const int n_q = (Lq + BQ - 1) / BQ, n_items = n_q * NH * B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);                    // the loads' expect_tx
      mbar_init(empty_bar + 8 * s, 128 * CONSUMERS);  // every consumer thread
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 33);  // q/dO's expect_tx + 32 lanes writing the item
      mbar_init(q_empty + 8 * i, 128 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == DqCfg<HD>::PRODUCER) {
    // ---- producer warp: for each item, read the q rows' ids, lse and delta,
    // wait until its buffers are free (the consumers finished the item QBUF
    // back), load q and dO, scan the kv ids of its candidate tiles, then load
    // the visited k/v tiles into the ring
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0, e = snake_item(0); e < n_items; e = snake_item(++it)) {
      const int buf = it % QBUF;
      const int qi = e / (NH * B), hb = e % (NH * B);
      const int h = hb % NH, b = hb / NH;
      const int q0 = (causal ? n_q - 1 - qi : qi) * BQ;  // most kv tiles first under `causal`
      int j1 = n_tiles;
      if (causal) j1 = min(j1, (min(q0 + BQ, Lq) - 1) / BK + 1);
      const int j0 = WINDOW ? max(0, q0 - window + 1) / BK : 0;
      const int nt = max(j1 - j0, 0);
      const size_t kv_row = (size_t)b * Lk;
      const size_t lrow = ((size_t)b * NH + h) * Lq;
      int sq[BQ / 32];
      float lv[BQ / 32], dv[BQ / 32];
#pragma unroll
      for (int u = 0; u < BQ / 32; ++u) {
        const int r = q0 + lane + 32 * u;
        const bool in = r < Lq;
        sq[u] = in ? seg_q[(size_t)b * Lq + r] : 0;
        lv[u] = in ? lse[lrow + r] * LOG2E : 0.f;
        dv[u] = in ? delta[lrow + r] : 0.f;
      }
      int v[SCAN][2];
      auto read_ids = [&](int t0) {
#pragma unroll
        for (int a = 0; a < SCAN; ++a) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int c = (j0 + t0 + a) * BK + lane + 32 * u;
            v[a][u] = t0 + a < nt && c < Lk ? seg_kv[kv_row + c] : 0;
          }
        }
      };
      read_ids(0);
      if (it >= QBUF) mbar_wait(q_empty + 8 * buf, (it / QBUF - 1) & 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(q_full + 8 * buf, 2 * S::Q_BYTES);
#pragma unroll
        for (int hf = 0; hf < S::HALVES; ++hf) {
          const int off = buf * S::Q_BYTES + hf * BQ * 128;
          tma_load(sbase + S::q_off + off, &tm_q, q_full + 8 * buf, hf * 64, h, q0, b);
          tma_load(sbase + S::do_off + off, &tm_do, q_full + 8 * buf, hf * 64, h, q0, b);
        }
      }
#pragma unroll
      for (int u = 0; u < BQ / 32; ++u) {
        segq_s[buf * BQ + lane + 32 * u] = sq[u];
        lse_s[buf * BQ + lane + 32 * u] = lv[u];
        delta_s[buf * BQ + lane + 32 * u] = dv[u];
      }
      int q_lo, q_hi;
      bool q_one;
      segment_range(sq, q_lo, q_hi, q_one);

      uint8_t* fl = flags + buf * n_tiles;
      int visited = 0;
      for (int t0 = 0; t0 < nt; t0 += SCAN) {
        if (t0 > 0) read_ids(t0);
        visited += scan_flags(v, t0, nt, q_lo, q_hi, q_one, fl, lane);
      }
      if (tiles != nullptr && lane == 0) {  // [B, NH, n_q, 2]: visited, candidates
        int* slot = tiles + 2 * (((size_t)b * NH + h) * n_q + q0 / BQ);
        slot[0] = visited;
        slot[1] = nt;
      }
      if (lane == 0) items[buf] = DqItem{q0, h, b, j0, nt};
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
  // each item; this thread holds rows r0 = row_base + lr and r1 = r0 + 8, and
  // of every 8-column group the columns 2 (lane % 4) + {0, 1}
  const int wg = warp / 4, w = warp % 4;
  const float sl2 = scale * LOG2E;
  const int lr = 16 * w + lane / 4;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0, e = snake_item(0); e < n_items; e = snake_item(++it)) {
    const int buf = it % QBUF;
    mbar_wait(q_full + 8 * buf, (it / QBUF) & 1);
    const DqItem item = items[buf];
    const uint8_t* fl = flags + buf * n_tiles;
    const uint32_t q_base = sbase + S::q_off + buf * S::Q_BYTES;
    const int row_base = item.q0 + 64 * wg;
    const int r0 = row_base + lr, r1 = r0 + 8;
    // the rows' ids, lse and delta are read from shared memory where they
    // are used, which keeps dq, S and dP within 168 registers at head dim 128
    const int ri = buf * BQ + 64 * wg + lr;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    for (int t = 0; t < item.nt; ++t) {
      const int f = fl[t];
      if (!(f & 1)) continue;
      mbar_wait(full_bar + 8 * stage, phase);
      // the tile in chunks of SN keys: S and dP of the chunk, then its dS
      // into the register A fragments of dq += dS K. A chunk that no row of
      // this warpgroup sees (above the diagonal, below the band) is skipped
      // (its dS is 0); one that every row sees whole needs no position mask,
      // one inside one segment no segment mask. K-major operands: +32 bytes a
      // k16 step inside a box, the next box BQ (BK) rows on; dO and V are
      // constant offsets from q and k (their buffers QBUF Q_BYTES and STAGES
      // KV_BYTES on), so only two bases stay live.
      const uint64_t dsc_q = smem_desc(q_base + wg * 64 * 128, 16, 1024);
      const uint64_t dsc_k = smem_desc(sbase + S::k_off + stage * S::KV_BYTES, 16, 1024);
      const bool seg_mask = !(f & 2);
      uint32_t da[BK / 16][4];
      bool any = false;
#pragma unroll
      for (int ch = 0; ch < BK / SN; ++ch) {
        const int c0 = (item.j0 + t) * BK + ch * SN, c1 = c0 + SN - 1;
        if ((causal && c0 > row_base + 63) || (WINDOW && c1 < row_base - window + 1)) {
#pragma unroll
          for (int kk = 0; kk < SN / 16; ++kk) {
#pragma unroll
            for (int x = 0; x < 4; ++x) da[ch * (SN / 16) + kk][x] = 0u;
          }
          continue;
        }
        any = true;
        const bool pos_mask =
            (causal && c1 > row_base) || (WINDOW && c0 < row_base + 63 - window + 1);
        float s[SN / 2], dp[SN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int qo = ((kk / 4) * BQ * 128 + (kk % 4) * 32) >> 4;
          const int ko = ((kk / 4) * BK * 128 + ch * SN * 128 + (kk % 4) * 32) >> 4;
          wgmma_ss<SN>(s, dsc_q + qo, dsc_k + ko, kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int qo = ((kk / 4) * BQ * 128 + (kk % 4) * 32 + QBUF * S::Q_BYTES) >> 4;
          const int ko =
              ((kk / 4) * BK * 128 + ch * SN * 128 + (kk % 4) * 32 + S::STAGES * S::KV_BYTES) >> 4;
          wgmma_ss<SN>(dp, dsc_q + qo, dsc_k + ko, kk > 0);
        }
        wgmma_commit_and_wait();
        pin(s);
        pin(dp);

        if (seg_mask || pos_mask) {
          // each row's visible columns of the chunk: [lo, hi] (causal, band;
          // r1's lo is r0's + 8) and none past Lk: the ids come from a flat
          // [B * Lk] map, so past a row's end they are the next row's
          const int hi0 = min(causal ? r0 - c0 : INT_MAX, Lk - 1 - c0);
          const int hi1 = min(causal ? r1 - c0 : INT_MAX, Lk - 1 - c0);
          const int lo = WINDOW ? r0 - c0 - window + 1 : INT_MIN;
          const int* sk = seg_s + stage * (S::SEG_SLOT / 4) +
                          ((item.b * Lk + (item.j0 + t) * BK) & 3) + ch * SN;
          const int sq0 = segq_s[ri], sq1 = segq_s[ri + 8];
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
        // p = 2^(s scale log2(e) - lse log2(e)): a masked score is -inf, so
        // its p is exactly 0; ds = p (dp - delta), packed to bf16 as it comes
        // (the register A fragment of k step kk is the columns [16 kk, 16 kk +
        // 16): x = 0, 2 are row r0's, x = 1, 3 row r1's)
        const float l0 = lse_s[ri], l1 = lse_s[ri + 8];
        const float d0 = delta_s[ri], d1 = delta_s[ri + 8];
#pragma unroll
        for (int kk = 0; kk < SN / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int e = 8 * kk + 2 * x;
            const float l = x & 1 ? l1 : l0, d = x & 1 ? d1 : d0;
            da[ch * (SN / 16) + kk][x] = pack_bf16(ex2(fmaf(s[e], sl2, -l)) * (dp[e] - d),
                                                   ex2(fmaf(s[e + 1], sl2, -l)) * (dp[e + 1] - d));
          }
        }
      }
      if (any) {
        // dq += dS K: K is MN-major here (+2048 bytes a k16 step, its two
        // 64-column boxes BK * 128 bytes apart: the leading byte offset)
        const uint64_t dsc_km = dsc_k + ((uint64_t)((BK * 128 - 16) >> 4) << 16);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<HD>(acc, da[kk], dsc_km + ((kk * 16 * 128) >> 4));
        wgmma_commit_and_wait();
        pin(acc);
      }
      mbar_arrive(empty_bar + 8 * stage);
      if (++stage == S::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- epilogue: dq * scale staged in this warpgroup's own rows of the q
    // tile (its last reads of them are complete), then 16-byte stores; the q
    // buffer is free for the item QBUF ahead once every consumer thread is done
    stage_rows<HD>(acc, scale, scale, q_base, BQ, 64 * wg, lr, lane);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    store_rows<HD>(dq + (((size_t)item.b * Lq + row_base) * NH + item.h) * HD, (size_t)NH * HD,
                   smem + (q_base - sbase), BQ, 64 * wg, Lq - row_base);
    // the next TMA write of this buffer comes through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(q_empty + 8 * buf);
  }
}

// ---------------------------------------------------------------------------
// K2b: dk, dv
// ---------------------------------------------------------------------------
template <int HD, bool WINDOW>
__global__ void __launch_bounds__(KV_THREADS, HD == 64 ? 2 : 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_lse,
                     const __grid_constant__ CUtensorMap tm_delta,
                     const __grid_constant__ CUtensorMap tm_segq, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int* __restrict__ tiles, int B, int Lq, int Lk,
                     int NH, int NKV, float scale, int causal, int window) {
  using S = DkvSmem<HD>;
  constexpr int BQ = KV_BQ, BK = KV_BK, KVBUF = S::KVBUF;
  constexpr int DH = DkvCfg<HD>::DH, NSPLIT = DkvCfg<HD>::NSPLIT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  int* segk_s = reinterpret_cast<int*>(smem + S::segk_off);  // [KVBUF][BK]
  DkvItem* items = reinterpret_cast<DkvItem*>(smem + S::item_off);
  const int n_qt = (Lq + BQ - 1) / BQ;
  uint8_t* flags = smem + S::flag_off;  // [KVBUF][n_qt]
  const uint32_t full_bar = sbase + S::bar_off;
  const uint32_t empty_bar = full_bar + 8 * S::STAGES;
  const uint32_t kv_full = full_bar + 16 * S::STAGES;
  const uint32_t kv_empty = kv_full + 16;

  const int n_kt = (Lk + BK - 1) / BK, n_items = n_kt * NKV * B * NSPLIT;
  const int group = NH / NKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);  // the loads' expect_tx
      mbar_init(empty_bar + 8 * s, 128);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(kv_full + 8 * i, 33);  // k/v's expect_tx + 32 lanes writing the item
      mbar_init(kv_empty + 8 * i, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == KV_PRODUCER) {
    // ---- producer warp: for each item, read the kv tile's ids and the ids of
    // its candidate q tiles, wait until its k/v buffers are free, load k and v,
    // then for every q head of the group the visited q tiles with their dO,
    // lse, delta and ids into the ring
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0, e = snake_item(0); e < n_items; e = snake_item(++it)) {
      const int buf = it % KVBUF;
      // the first kv tiles have the most q tiles
      const int ki = e / (NKV * B * NSPLIT), hbh = e % (NKV * B * NSPLIT);
      const int half = hbh % NSPLIT, hb = hbh / NSPLIT;
      const int kvh = hb % NKV, b = hb / NKV;
      const int k0 = ki * BK;
      // candidates: from the q tile that holds the diagonal to the last q tile
      // whose rows reach this kv tile through the band
      const int i0 = causal ? min(k0 / BQ, n_qt) : 0;
      const int i1 = WINDOW ? min(n_qt, (k0 + BK - 1 + window - 1) / BQ + 1) : n_qt;
      const int nt = max(i1 - i0, 0);
      int sk[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = k0 + lane + 32 * u;
        sk[u] = c < Lk ? seg_kv[(size_t)b * Lk + c] : 0;
      }
      int v[SCAN][2];
      auto read_ids = [&](int t0) {
#pragma unroll
        for (int a = 0; a < SCAN; ++a) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int r = (i0 + t0 + a) * BQ + lane + 32 * u;
            v[a][u] = t0 + a < nt && r < Lq ? seg_q[(size_t)b * Lq + r] : 0;
          }
        }
      };
      read_ids(0);
      if (it >= KVBUF) mbar_wait(kv_empty + 8 * buf, (it / KVBUF - 1) & 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full + 8 * buf, 2 * S::TILE_BYTES);
#pragma unroll
        for (int hf = 0; hf < S::HALVES; ++hf) {
          const int off = buf * S::TILE_BYTES + hf * BK * 128;
          tma_load(sbase + S::k_off + off, &tm_k, kv_full + 8 * buf, hf * 64, kvh, k0, b);
          tma_load(sbase + S::v_off + off, &tm_v, kv_full + 8 * buf, hf * 64, kvh, k0, b);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) segk_s[buf * BK + lane + 32 * u] = sk[u];
      int k_lo, k_hi;
      bool k_one;
      segment_range(sk, k_lo, k_hi, k_one);

      uint8_t* fl = flags + buf * n_qt;
      int visited = 0;
      for (int t0 = 0; t0 < nt; t0 += SCAN) {
        if (t0 > 0) read_ids(t0);
        visited += scan_flags(v, t0, nt, k_lo, k_hi, k_one, fl, lane);
      }
      if (tiles != nullptr && lane == 0 && half == 0) {  // [B, NKV, n_kt, 2]: visited, candidates
        int* slot = tiles + 2 * (((size_t)b * NKV + kvh) * n_kt + ki);
        slot[0] = visited;
        slot[1] = nt;
      }
      if (lane == 0) items[buf] = DkvItem{k0, kvh, b, i0, nt, half};
      __syncwarp();
      mbar_arrive(kv_full + 8 * buf);

      for (int g = 0; g < group; ++g) {
        const int h = kvh * group + g;
        for (int t = 0; t < nt; ++t) {
          if (!(fl[t] & 1)) continue;
          const int q0 = (i0 + t) * BQ;
          if (lane == 0) {  // q and dO in HALVES boxes each; lse, delta and ids
            mbar_wait(empty_bar + 8 * stage, phase ^ 1);
            const uint32_t bar = full_bar + 8 * stage;
            mbar_arrive_expect_tx(bar, 2 * S::TILE_BYTES + 3 * (BQ + FLAT_PAD) * 4);
#pragma unroll
            for (int hf = 0; hf < S::HALVES; ++hf) {
              const int off = stage * S::TILE_BYTES + hf * BQ * 128;
              tma_load(sbase + S::q_off + off, &tm_q, bar, hf * 64, h, q0, b);
              tma_load(sbase + S::do_off + off, &tm_do, bar, hf * 64, h, q0, b);
            }
            const uint32_t rows = sbase + S::row_off + stage * S::ROW_BYTES;
            const int lrow = (b * NH + h) * Lq + q0;
            tma_load_flat(rows, &tm_lse, bar, lrow);
            tma_load_flat(rows + S::SLOT, &tm_delta, bar, lrow);
            tma_load_flat(rows + 2 * S::SLOT, &tm_segq, bar, b * Lq + q0);
          }
          if (++stage == S::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: this thread holds kv rows r0 = k0 + lr and
  // r1 = r0 + 8 of the transposed tiles, and of every 8-column group (q rows)
  // the columns 2 (lane % 4) + {0, 1}
  const float sl2 = scale * LOG2E;
  const int lr = 16 * warp + lane / 4;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0, e = snake_item(0); e < n_items; e = snake_item(++it)) {
    const int buf = it % KVBUF;
    mbar_wait(kv_full + 8 * buf, (it / KVBUF) & 1);
    const DkvItem item = items[buf];
    const uint8_t* fl = flags + buf * n_qt;
    const uint32_t k_base = sbase + S::k_off + buf * S::TILE_BYTES;
    const uint32_t v_base = sbase + S::v_off + buf * S::TILE_BYTES;
    const int r0 = item.k0 + lr, r1 = r0 + 8;
    const int sk0 = segk_s[buf * BK + lr], sk1 = segk_s[buf * BK + lr + 8];
    float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }
    // K-major A operands: +32 bytes a k16 step inside a box, the next box BK rows on
    const uint64_t dsc_k = smem_desc(k_base, 16, 1024);
    const uint64_t dsc_v = smem_desc(v_base, 16, 1024);

    for (int g = 0; g < group; ++g) {
      for (int t = 0; t < item.nt; ++t) {
        const int f = fl[t];
        if (!(f & 1)) continue;
        const int q0 = (item.i0 + t) * BQ;
        mbar_wait(full_bar + 8 * stage, phase);
        const uint32_t q_base = sbase + S::q_off + stage * S::TILE_BYTES;
        const uint32_t do_base = sbase + S::do_off + stage * S::TILE_BYTES;
        const unsigned char* rows = smem + S::row_off + stage * S::ROW_BYTES;
        const int lrow = (item.b * NH + (item.kvh * group + g)) * Lq + q0;
        const float* lse_r = reinterpret_cast<const float*>(rows) + (lrow & 3);
        const float* delta_r = reinterpret_cast<const float*>(rows + S::SLOT) + (lrow & 3);
        const int* sq_r =
            reinterpret_cast<const int*>(rows + 2 * S::SLOT) + ((item.b * Lq + q0) & 3);
        // a tile inside one segment needs no segment mask; one below the
        // diagonal and inside the band no position mask
        const bool seg_mask = !(f & 2);
        const bool pos_mask =
            (causal && q0 < item.k0 + BK - 1) || (WINDOW && q0 + BQ - 1 - item.k0 >= window);

        // S^T = K Q^T and dP^T = V dO^T, the q and dO tiles K-major as B
        const uint64_t dsc_q = smem_desc(q_base, 16, 1024);
        const uint64_t dsc_do = smem_desc(do_base, 16, 1024);
        float s[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int off = ((kk / 4) * 64 * 128 + (kk % 4) * 32) >> 4;
          wgmma_ss<64>(s, dsc_k + off, dsc_q + off, kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int off = ((kk / 4) * 64 * 128 + (kk % 4) * 32) >> 4;
          wgmma_ss<64>(dp, dsc_v + off, dsc_do + off, kk > 0);
        }
        wgmma_commit_and_wait();
        pin(s);
        pin(dp);

        // P^T and dS^T: a column is one q row, with its lse, delta and id;
        // masked entries are -inf before the exponential, so their p is 0.
        // Rows past Lq read the next row's ids through the flat map: bounded.
#pragma unroll
        for (int i = 0; i < BQ / 8; ++i) {
          const int c = 8 * i + 2 * (lane % 4);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int q = q0 + c + j;
            float x0 = s[4 * i + j], x1 = s[4 * i + 2 + j];
            if (seg_mask || pos_mask) {
              bool v0 = (!causal || q >= r0) && (!WINDOW || q - r0 < window);
              bool v1 = (!causal || q >= r1) && (!WINDOW || q - r1 < window);
              if (seg_mask) {
                const int id = sq_r[c + j];
                const bool in = q < Lq && id != 0;
                v0 = v0 && in && id == sk0;
                v1 = v1 && in && id == sk1;
              }
              x0 = v0 ? x0 : MASKED;
              x1 = v1 ? x1 : MASKED;
            }
            const float lj = lse_r[c + j] * LOG2E, dj = delta_r[c + j];
            const float p0 = ex2(fmaf(x0, sl2, -lj)), p1 = ex2(fmaf(x1, sl2, -lj));
            s[4 * i + j] = p0;
            s[4 * i + 2 + j] = p1;
            dp[4 * i + j] = p0 * (dp[4 * i + j] - dj);
            dp[4 * i + 2 + j] = p1 * (dp[4 * i + 2 + j] - dj);
          }
        }
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
            da[kk][x] = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
          }
        }
        // dv += P^T dO and dk += dS^T Q over the item's columns: dO and Q
        // MN-major (+2048 bytes a k16 step, their 64-column boxes BQ * 128
        // bytes apart, the item's half DH / 64 boxes on)
        const uint32_t cols = item.half * (DH / 64) * BQ * 128;
        const uint64_t dsc_dom = smem_desc(do_base + cols, BQ * 128, 1024);
        const uint64_t dsc_qm = smem_desc(q_base + cols, BQ * 128, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<DH>(dv_acc, pa[kk], dsc_dom + ((kk * 16 * 128) >> 4));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<DH>(dk_acc, da[kk], dsc_qm + ((kk * 16 * 128) >> 4));
        wgmma_commit_and_wait();
        pin(dv_acc);
        pin(dk_acc);
        mbar_arrive(empty_bar + 8 * stage);
        if (++stage == S::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }

    // ---- epilogue: dv and dk * scale staged in the item's columns of its own
    // v and k tiles (their last reads are complete), then 16-byte stores; the
    // k/v buffers are free for the item KVBUF ahead once every consumer
    // thread is done
    const uint32_t cols = item.half * (DH / 64) * BK * 128;
    stage_rows<DH>(dv_acc, 1.f, 1.f, v_base + cols, BK, 0, lr, lane);
    stage_rows<DH>(dk_acc, scale, scale, k_base + cols, BK, 0, lr, lane);
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    const size_t out = (((size_t)item.b * Lk + item.k0) * NKV + item.kvh) * HD + item.half * DH;
    store_rows<DH>(dv + out, (size_t)NKV * HD, smem + (v_base - sbase) + cols, BK, 0,
                   Lk - item.k0);
    store_rows<DH>(dk + out, (size_t)NKV * HD, smem + (k_base - sbase) + cols, BK, 0,
                   Lk - item.k0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(kv_empty + 8 * buf);
  }
}

// ---- host side ---------------------------------------------------------------

size_t dq_smem(int hd, int Lk) {
  const int n = (Lk + 63) / 64;  // DqCfg<HD>::BK at every head dim
  return hd == 256 ? DqSmem<256>::bytes(n) : hd == 128 ? DqSmem<128>::bytes(n)
                                                       : DqSmem<64>::bytes(n);
}

size_t dkv_smem(int hd, int Lq) {
  const int n = (Lq + KV_BQ - 1) / KV_BQ;
  return hd == 256 ? DkvSmem<256>::bytes(n) : hd == 128 ? DkvSmem<128>::bytes(n)
                                                        : DkvSmem<64>::bytes(n);
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess) *configured = true;
  return err;
}

// the grid: where one block fills an SM, persistent blocks, one an SM, each
// walking its items (`snake_item`), so that an item's scan and first loads
// overlap the previous item's products; where two or more fit, one block an
// item: a co-resident block hides another's start, and the hardware hands the
// next item to the SM that frees first, which balances rows whose item
// weights no static order can know (packed segments: 0.36 against 0.44 ms for
// K2b over gpt-oss's four sequences of 1024 on an H100)
template <typename Kernel>
cudaError_t grid_size(Kernel kernel, int threads, size_t smem, int n_items, int* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  *grid = per_sm > 1 ? n_items : min(n_items, sms);
  return cudaSuccess;
}

template <int HD, bool WINDOW>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const int* seg_q, const int* seg_kv, const float* lse, const float* delta,
                      void* dq, int* tiles, int B, int Lq, int Lk, int NH, int NKV, float scale,
                      int causal, int window, cudaStream_t stream) {
  if (B == 0 || Lq == 0) return cudaSuccess;
  const size_t smem = dq_smem(HD, Lk);
  if (smem > MAX_SMEM || Lk == 0) return cudaErrorInvalidValue;
  static bool configured = false;
  cudaError_t err = configure(flash_bwd_dq_kernel<HD, WINDOW>, &configured);
  if (err != cudaSuccess) return err;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tdo, tk, tv, tseg;
  using C = DqCfg<HD>;
  if (!tensor_map(&tq, encode, q, HD, NH, Lq, B, C::BQ) ||
      !tensor_map(&tdo, encode, dout, HD, NH, Lq, B, C::BQ) ||
      !tensor_map(&tk, encode, k, HD, NKV, Lk, B, C::BK) ||
      !tensor_map(&tv, encode, v, HD, NKV, Lk, B, C::BK) ||
      !flat_map(&tseg, encode, seg_kv, B * Lk, C::BK + FLAT_PAD, CU_TENSOR_MAP_DATA_TYPE_INT32))
    return cudaErrorInvalidValue;
  const int n_items = (Lq + C::BQ - 1) / C::BQ * NH * B;
  int grid = 0;
  err = grid_size(flash_bwd_dq_kernel<HD, WINDOW>, C::THREADS, smem, n_items, &grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<HD, WINDOW><<<grid, C::THREADS, smem, stream>>>(
      tq, tdo, tk, tv, tseg, seg_q, seg_kv, lse, delta, static_cast<__nv_bfloat16*>(dq), tiles, B,
      Lq, Lk, NH, NKV, scale, causal, window);
  return cudaGetLastError();
}

template <int HD, bool WINDOW>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const int* seg_q, const int* seg_kv, const float* lse, const float* delta,
                       void* dk, void* dv, int* tiles, int B, int Lq, int Lk, int NH, int NKV,
                       float scale, int causal, int window, cudaStream_t stream) {
  if (B == 0 || Lk == 0) return cudaSuccess;
  const size_t smem = dkv_smem(HD, Lq);
  if (smem > MAX_SMEM || Lq == 0) return cudaErrorInvalidValue;
  static bool configured = false;
  cudaError_t err = configure(flash_bwd_dkv_kernel<HD, WINDOW>, &configured);
  if (err != cudaSuccess) return err;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tdo, tk, tv, tlse, tdelta, tsegq;
  if (!tensor_map(&tq, encode, q, HD, NH, Lq, B, KV_BQ) ||
      !tensor_map(&tdo, encode, dout, HD, NH, Lq, B, KV_BQ) ||
      !tensor_map(&tk, encode, k, HD, NKV, Lk, B, KV_BK) ||
      !tensor_map(&tv, encode, v, HD, NKV, Lk, B, KV_BK) ||
      !flat_map(&tlse, encode, lse, B * NH * Lq, KV_BQ + FLAT_PAD,
                CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !flat_map(&tdelta, encode, delta, B * NH * Lq, KV_BQ + FLAT_PAD,
                CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !flat_map(&tsegq, encode, seg_q, B * Lq, KV_BQ + FLAT_PAD, CU_TENSOR_MAP_DATA_TYPE_INT32))
    return cudaErrorInvalidValue;
  const int n_items = (Lk + KV_BK - 1) / KV_BK * NKV * B * DkvCfg<HD>::NSPLIT;
  int grid = 0;
  err = grid_size(flash_bwd_dkv_kernel<HD, WINDOW>, KV_THREADS, smem, n_items, &grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<HD, WINDOW><<<grid, KV_THREADS, smem, stream>>>(
      tq, tdo, tk, tv, tlse, tdelta, tsegq, seg_q, seg_kv, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), tiles, B, Lq, Lk, NH, NKV, scale, causal, window);
  return cudaGetLastError();
}

int run_dq(const void* q, const void* k, const void* v, const void* dout, const void* seg_q,
           const void* seg_kv, const void* lse, const void* delta, void* dq, int* tiles, int B,
           int Lq, int Lk, int NH, int NKV, int HD, float scale, int causal, int window,
           void* stream) {
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_kv);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRT_DQ_CASE(hd, w)                                                                      \
  if (HD == hd && (window > 0) == w)                                                             \
    return launch_dq<hd, w>(q, k, v, dout, sq, sk, l, d, dq, tiles, B, Lq, Lk, NH, NKV, scale,   \
                            causal, window, st);
  PRT_DQ_CASE(64, false) PRT_DQ_CASE(64, true) PRT_DQ_CASE(128, false) PRT_DQ_CASE(128, true)
  PRT_DQ_CASE(256, false) PRT_DQ_CASE(256, true)
#undef PRT_DQ_CASE
  return (int)cudaErrorInvalidValue;
}

int run_dkv(const void* q, const void* k, const void* v, const void* dout, const void* seg_q,
            const void* seg_kv, const void* lse, const void* delta, void* dk, void* dv, int* tiles,
            int B, int Lq, int Lk, int NH, int NKV, int HD, float scale, int causal, int window,
            void* stream) {
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_kv);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRT_DKV_CASE(hd, w)                                                                     \
  if (HD == hd && (window > 0) == w)                                                             \
    return launch_dkv<hd, w>(q, k, v, dout, sq, sk, l, d, dk, dv, tiles, B, Lq, Lk, NH, NKV,     \
                             scale, causal, window, st);
  PRT_DKV_CASE(64, false) PRT_DKV_CASE(64, true) PRT_DKV_CASE(128, false) PRT_DKV_CASE(128, true)
  PRT_DKV_CASE(256, false) PRT_DKV_CASE(256, true)
#undef PRT_DKV_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename Kernel>
int attributes(Kernel kernel, int* attrs) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  attrs[0] = a.numRegs;
  attrs[1] = (int)a.localSizeBytes;
  attrs[2] = (int)a.sharedSizeBytes;
  attrs[3] = a.maxThreadsPerBlock;
  return 0;
}

}  // namespace

extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* seg_q, const void* seg_kv, const void* lse,
                                 const void* delta, void* dq, int B, int Lq, int Lk, int NH,
                                 int NKV, int HD, float scale, int causal, int window,
                                 void* stream) {
  return run_dq(q, k, v, dout, seg_q, seg_kv, lse, delta, dq, nullptr, B, Lq, Lk, NH, NKV, HD,
                scale, causal, window, stream);
}

// the same launch, also writing each item's kv tile counts into `tiles`
// (int32 [B, NH, ceil(Lq / BQ), 2]: visited, candidates; BQ = 128, or 64 at
// head dim 256)
extern "C" int flash_attn_bwd_dq_tiles(const void* q, const void* k, const void* v,
                                       const void* dout, const void* seg_q, const void* seg_kv,
                                       const void* lse, const void* delta, void* dq, int B, int Lq,
                                       int Lk, int NH, int NKV, int HD, float scale, int causal,
                                       int window, void* stream, void* tiles) {
  return run_dq(q, k, v, dout, seg_q, seg_kv, lse, delta, dq, static_cast<int*>(tiles), B, Lq, Lk,
                NH, NKV, HD, scale, causal, window, stream);
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* seg_q, const void* seg_kv, const void* lse,
                                  const void* delta, void* dk, void* dv, int B, int Lq, int Lk,
                                  int NH, int NKV, int HD, float scale, int causal, int window,
                                  void* stream) {
  return run_dkv(q, k, v, dout, seg_q, seg_kv, lse, delta, dk, dv, nullptr, B, Lq, Lk, NH, NKV,
                 HD, scale, causal, window, stream);
}

// the same launch, also writing each item's q tile counts (for one head of
// the group) into `tiles` (int32 [B, NKV, ceil(Lk / 64), 2]: visited, candidates)
extern "C" int flash_attn_bwd_dkv_tiles(const void* q, const void* k, const void* v,
                                        const void* dout, const void* seg_q, const void* seg_kv,
                                        const void* lse, const void* delta, void* dk, void* dv,
                                        int B, int Lq, int Lk, int NH, int NKV, int HD, float scale,
                                        int causal, int window, void* stream, void* tiles) {
  return run_dkv(q, k, v, dout, seg_q, seg_kv, lse, delta, dk, dv, static_cast<int*>(tiles), B, Lq,
                 Lk, NH, NKV, HD, scale, causal, window, stream);
}

// dynamic shared memory of one block of K2a (kernel 0, over `len` = Lk keys)
// or K2b (kernel 1, over `len` = Lq queries) at head dim `hd`
extern "C" int flash_attn_bwd_smem(int kernel, int hd, int len) {
  return (int)(kernel == 0 ? dq_smem(hd, len) : dkv_smem(hd, len));
}

// blocks of K2a (kernel 0) or K2b (kernel 1) at head dim `hd`, form `window`,
// that one SM holds at once over `len` keys (K2a) or queries (K2b): 1 gives a
// persistent grid, more one block an item (`grid_size`)
extern "C" int flash_attn_bwd_blocks_per_sm(int kernel, int hd, int window, int len) {
  int n = 0;
#define PRT_OCC_CASE(kn, fn, h, w, threads, smem)                                           \
  if (kernel == kn && hd == h && (window != 0) == w)                                         \
    return cudaFuncSetAttribute(fn<h, w>, cudaFuncAttributeMaxDynamicSharedMemorySize,      \
                                MAX_SMEM) == cudaSuccess &&                                  \
                   cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn<h, w>, threads,      \
                                                                 smem) == cudaSuccess        \
               ? n                                                                           \
               : -1;
  PRT_OCC_CASE(0, flash_bwd_dq_kernel, 64, false, DqCfg<64>::THREADS, dq_smem(64, len))
  PRT_OCC_CASE(0, flash_bwd_dq_kernel, 64, true, DqCfg<64>::THREADS, dq_smem(64, len))
  PRT_OCC_CASE(0, flash_bwd_dq_kernel, 128, false, DqCfg<128>::THREADS, dq_smem(128, len))
  PRT_OCC_CASE(0, flash_bwd_dq_kernel, 128, true, DqCfg<128>::THREADS, dq_smem(128, len))
  PRT_OCC_CASE(0, flash_bwd_dq_kernel, 256, false, DqCfg<256>::THREADS, dq_smem(256, len))
  PRT_OCC_CASE(0, flash_bwd_dq_kernel, 256, true, DqCfg<256>::THREADS, dq_smem(256, len))
  PRT_OCC_CASE(1, flash_bwd_dkv_kernel, 64, false, KV_THREADS, dkv_smem(64, len))
  PRT_OCC_CASE(1, flash_bwd_dkv_kernel, 64, true, KV_THREADS, dkv_smem(64, len))
  PRT_OCC_CASE(1, flash_bwd_dkv_kernel, 128, false, KV_THREADS, dkv_smem(128, len))
  PRT_OCC_CASE(1, flash_bwd_dkv_kernel, 128, true, KV_THREADS, dkv_smem(128, len))
  PRT_OCC_CASE(1, flash_bwd_dkv_kernel, 256, false, KV_THREADS, dkv_smem(256, len))
  PRT_OCC_CASE(1, flash_bwd_dkv_kernel, 256, true, KV_THREADS, dkv_smem(256, len))
#undef PRT_OCC_CASE
  return -1;
}

// the compiled K2a (kernel 0) or K2b (kernel 1) of head dim `hd` and form
// `window` (0 dense, 1 banded) as the runtime loaded it: attrs = {registers a
// thread, local memory a thread in bytes (spills; 0 when none), static shared
// memory in bytes, threads a block}
extern "C" int flash_attn_bwd_attributes(int kernel, int hd, int window, int* attrs) {
#define PRT_ATTR_CASE(kn, fn, h, w) \
  if (kernel == kn && hd == h && (window != 0) == w) return attributes(fn<h, w>, attrs);
  PRT_ATTR_CASE(0, flash_bwd_dq_kernel, 64, false) PRT_ATTR_CASE(0, flash_bwd_dq_kernel, 64, true)
  PRT_ATTR_CASE(0, flash_bwd_dq_kernel, 128, false) PRT_ATTR_CASE(0, flash_bwd_dq_kernel, 128, true)
  PRT_ATTR_CASE(1, flash_bwd_dkv_kernel, 64, false) PRT_ATTR_CASE(1, flash_bwd_dkv_kernel, 64, true)
  PRT_ATTR_CASE(1, flash_bwd_dkv_kernel, 128, false)
  PRT_ATTR_CASE(1, flash_bwd_dkv_kernel, 128, true)
  PRT_ATTR_CASE(0, flash_bwd_dq_kernel, 256, false) PRT_ATTR_CASE(0, flash_bwd_dq_kernel, 256, true)
  PRT_ATTR_CASE(1, flash_bwd_dkv_kernel, 256, false)
  PRT_ATTR_CASE(1, flash_bwd_dkv_kernel, 256, true)
#undef PRT_ATTR_CASE
  return (int)cudaErrorInvalidValue;
}
