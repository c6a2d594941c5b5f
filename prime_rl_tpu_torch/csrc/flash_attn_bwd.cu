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
// - Head dims 384 and 512: `flash_bwd_dq_wide_kernel` and
//   `flash_bwd_dkv_wide_kernel`, the same shape with a part of D an item and
//   32-row streamed tiles in a ring of single-tensor slots (the note before
//   them).
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

// ---- head dims 384 and 512 ---------------------------------------------------
// K2a and K2b at head dims 384 and 512 (any head dim in (256, 512] is
// zero-padded to one of them by the wrapper). What holds them back at these
// widths is room, not arithmetic: a 64-row bf16 tile is 64 KB at 512, so q,
// dO, k and v (256 KB) do not fit a block's 227 KB at once, and a 64-row f32
// accumulator over all of D is 256 registers a thread in one warpgroup (dq),
// or 512 (dk + dv). The design keeps the <= 256 forms' shape (a producer warp
// that scans the segment ids and loads by TMA behind full/empty mbarriers,
// one consumer warpgroup whose products are all wgmma, bf16 in and f32
// accumulated, the score-sized tiles in registers, 160 threads, one block an
// SM, persistent blocks, items heaviest first) and solves the room so:
// - The split of D: an item computes a part of D of its outputs, each part in
//   another item (block). K2a: halves (DH = 256 at 512, 192 at 384: 128 or 96
//   registers of dq a thread). K2b: quarters at 512, thirds at 384 (DH = 128:
//   dk + dv 128 registers a thread). Every item still computes S and dP over
//   all of D: a split over K between two warpgroups, summed in shared memory,
//   would need a second warpgroup's registers that a 288-thread block (168 a
//   thread) cannot give beside dq, and the f32 hand-off's room. So S and dP
//   run NSPLIT times a tile pair: K2a does 2 x (2 + 2 + 1) = 10 products of
//   64 x 32 x 256 MACs for every 64 x 32 tile pair where 6 would do (1.67x);
//   K2b 4 x (4 + 4 + 1 + 1) = 40 of 64 x 32 x 128 where 16 would do (2.5x;
//   at 384: 3 x 8 = 24 where 12 would, 2x), all on the tensor cores.
// - The tiles: the item's resident operands are 64 rows (K2a: q and dO,
//   128 KB at 512; K2b: k and v), and the streamed ones are 32-row tiles
//   (K2a: k and v; K2b: q and dO), each 32 KB at 512 (24 KB at 384), in a ring
//   of SLOTS single-tensor slots: 3 at 512, 4 at 384. A tile pair takes two
//   slots in the order its products free them: K2a v then k (dP = dO V^T
//   frees v; k stays for dq += dS K), K2b dO then q (both stay for dv and
//   dk). So while the consumers work on pair t, the producer has pair t + 1's
//   first slot in flight (its second as soon as pair t's first slot frees at
//   512), and the next item's first pair is loaded before its resident
//   operands wait for the previous item's epilogue. Shared memory at 512
//   (bytes): K2a q + dO 131,072, slots 98,304, the k slots' ids 768, the q
//   rows' ids, lse and delta 768, headers, item and mbarriers 128, + 1,024
//   of alignment slack = 232,064; K2b k + v 131,072, slots 98,304, the kv ids
//   256, the rest 128 + 1,024 = 230,784 (of the 232,448 a block may use). No
//   array grows with the length: the producer scans the ids twice (once to
//   count an item's visited tiles for the consumers, once to load them), and
//   each slot's header carries its tile's first row and flags.
// - Which instruction takes which product: all wgmma, M = the item's 64
//   resident rows. S = Q K^T and dP = dO V^T (K2a) and S^T = K Q^T and dP^T =
//   V dO^T (K2b) are m64n32k16 with both operands K-major in shared memory
//   (HD / 16 k steps); dq += dS K (K2a) and dv += bf16(P^T) dO, dk += dS^T Q
//   (K2b) take dS or P from registers and the 32-row tile MN-major, two k16
//   steps, N = DH: m64n256 as two n128, m64n192 as n128 + n64, m64n128.
//   mma.sync's m16 would reread the streamed tile for every 16 rows.
// - K2b's q rows' lse, delta and ids are read by each consumer thread from
//   global memory (its 8 columns of a tile, issued before the products'
//   wait); K2a's q rows' come once an item through the producer.
// - The blocks take their items from a queue (an int the wrapper zeroes; its
//   atomic is the kernels' only one), in the order heaviest first, so the
//   card balances the items of packed sequences, whose weights no static
//   order knows: the rounds over the blocks that the <= 256 forms walk gave
//   K2b's busiest block at 384 1.50x the mean over [1100, 948] (0.50 ms
//   against 0.39 with the queue).
// The candidates and the skip rule are the <= 256 forms': K2a's kv tiles of 32
// for each q tile of 64 (`flash_tiles_visited` at 64 x 32: `dq_tiles`), K2b's
// q tiles of 32 for each kv tile of 64 (`flash_bwd_dkv_tiles_visited` at 32 x
// 64: `dkv_tiles`), counted into `tiles` by the part-0 item. Every dq, dk and
// dv element is written once, by one block, from sums in a fixed order: no
// atomics on them, equal bits from run to run. The roundings are the plain
// version's: p = 2^(s scale log2e - lse log2e) where visible, ds = bf16(p (dp
// - delta)), bf16(p) for dv, the scale on dq and dk once at the end.
// Measured (chip_smoke.py's range-repairs rows and
// scripts/torch_flash_bwd_bench.py --hd, B=1 L=2048 in sequences of 1100 and
// 948, 16/4 heads; an NVIDIA H100 80GB HBM3 at 700 W): at 512 K2a 0.28 ms
// (202-204 registers) and K2b 0.60 (255, no spills), the SIMT forms they
// replace 4.05 and 6.13; at 384 0.22 and 0.38 (168-173, 248). What holds
// them is the streamed tiles' latency, not their bytes nor S and dP: loading
// only the part's boxes of them (-DK2W_PART_BOXES) takes 4% off K2b and K2a,
// S and dP over the part only (-DK2W_PART_KSTEPS) 4% off K2b and 16% off
// K2a, while a ring of 2 slots adds 23% (512) and 31% (384) to K2b, and 3
// slots at 384 12% against 4 (5 gain nothing): at 512 the q tile of pair t +
// 1 is loaded only when pair t ends.

constexpr int WIDE_THREADS = 128 + 32;  // one consumer warpgroup and the producer warp

// The ring's depth in slots: 3 at 512 (all that fit), 4 at 384; the
// measurement variant K2W_SLOTS (scripts/torch_flash_bwd_bench.py
// --variants) sets it, up to 3 at 512 and 5 at 384.
#ifndef K2W_SLOTS
#define K2W_SLOTS 0
#endif
constexpr int wide_slots(int hd) {
  return K2W_SLOTS <= 0 ? (hd == 512 ? 3 : 4) : K2W_SLOTS < (hd == 512 ? 3 : 5) ? K2W_SLOTS
                                                                               : hd == 512 ? 3 : 5;
}
constexpr int WIDE_PRODUCER = 4;        // the producer's warp index

// Offsets into a block's dynamic shared memory after its 1024-byte alignment
// (tiles are 64-column boxes, [rows][64] bf16 in the 128-byte swizzle, the
// boxes of a tile back to back).
template <int HD>
struct DqWide {  // K2a
  static constexpr int BQ = 64, BK = 32;           // resident q rows, streamed kv rows
  static constexpr int NSPLIT = 2, DH = HD / NSPLIT;  // columns of dq an item
  static constexpr int SLOTS = wide_slots(HD);
  static constexpr int Q_BYTES = BQ * HD * 2;      // the q or the dO tile
  static constexpr int SLOT_BYTES = BK * HD * 2;   // a k or a v tile
  static constexpr int SEG_SLOT = flat_slot_bytes(BK);
  static constexpr int q_off = 0;                               // q, then dO
  static constexpr int slot_off = 2 * Q_BYTES;                  // [SLOTS] k or v tiles
  static constexpr int seg_off = slot_off + SLOTS * SLOT_BYTES;  // [SLOTS] a k tile's ids
  static constexpr int row_off = seg_off + SLOTS * SEG_SLOT;    // {ids, lse, delta}[BQ]
  static constexpr int hdr_off = row_off + 3 * BQ * 4;          // int2 [SLOTS]
  static constexpr int item_off = hdr_off + 32;                 // WideItem
  static constexpr int bar_off = item_off + 32;  // full[SLOTS], empty[SLOTS], q_full, q_empty
  static constexpr int BYTES = 1024 + bar_off + 8 * (2 * SLOTS + 2);
  static_assert(BYTES <= MAX_SMEM, "K2a's shared memory exceeds what a block may use");
};

template <int HD>
struct DkvWide {  // K2b
  static constexpr int BK = 64, BQ = 32;           // resident kv rows, streamed q rows
  static constexpr int DH = 128, NSPLIT = HD / DH;  // columns of dk and dv an item
  static constexpr int SLOTS = wide_slots(HD);
  static constexpr int TILE_BYTES = BK * HD * 2;   // the k or the v tile
  static constexpr int SLOT_BYTES = BQ * HD * 2;   // a q or a dO tile
  static constexpr int k_off = 0, v_off = TILE_BYTES;
  static constexpr int slot_off = 2 * TILE_BYTES;               // [SLOTS] dO or q tiles
  static constexpr int segk_off = slot_off + SLOTS * SLOT_BYTES;  // int [BK]
  static constexpr int hdr_off = segk_off + BK * 4;              // int2 [SLOTS]
  static constexpr int item_off = hdr_off + 32;                  // WideItem
  static constexpr int bar_off = item_off + 32;  // full[SLOTS], empty[SLOTS], kv_full, kv_empty
  static constexpr int BYTES = 1024 + bar_off + 8 * (2 * SLOTS + 2);
  static_assert(BYTES <= MAX_SMEM, "K2b's shared memory exceeds what a block may use");
};

// a wide item: the first resident row, its head (K2a: q head, K2b: kv head),
// batch row, visited tiles (a head), and the part of D it computes
struct WideItem {
  int r0, h, b, visited, part;
};

// The visit bits of n <= SCAN candidate tiles of 32 ids from tile `first`
// (the ids of one batch row, one a lane; 0 at or past `len`) against the
// other side's segment range [lo, hi]: bit a is set if tile first + a holds a
// non-zero id in the range; in `ones` if besides every id equals lo and the
// other side is one segment (`one`), so that no segment mask is needed.
__device__ __forceinline__ uint32_t scan32(const int* __restrict__ ids, int first, int n, int len,
                                           int lo, int hi, bool one, int lane, uint32_t& ones) {
  int v[SCAN];
#pragma unroll
  for (int a = 0; a < SCAN; ++a) {
    const int c = (first + a) * 32 + lane;
    v[a] = a < n && c < len ? ids[c] : 0;
  }
  uint32_t bits = 0;
  ones = 0;
#pragma unroll
  for (int a = 0; a < SCAN; ++a) {
    const bool any = __any_sync(0xffffffffu, v[a] != 0 && v[a] >= lo && v[a] <= hi);
    const bool all = __all_sync(0xffffffffu, v[a] == lo);
    if (any) {
      bits |= 1u << a;
      if (all && one) ones |= 1u << a;
    }
  }
  return bits;
}

// the next item of a wide kernel's queue (`queue`: an int the wrapper zeroes
// before the launch), for the whole producer warp: a block takes its next
// item when its producer is done with the last one, so the card balances
// items whose weights no static order knows (packed sequences)
__device__ __forceinline__ int next_item(int* queue, int lane) {
  int e = 0;
  if (lane == 0) e = atomicAdd(queue, 1);
  return __shfl_sync(0xffffffffu, e, 0);
}

// Measurement variants (scripts/torch_flash_bwd_bench.py --variants), each a
// wrong result: K2W_PART_BOXES loads only the boxes of the item's part of D
// of each streamed tile, which prices the streamed loads; K2W_PART_KSTEPS
// runs S and dP over the item's part of D only, which prices their
// recomputation in every part.
#ifdef K2W_PART_BOXES
constexpr bool PART_BOXES = true;
#else
constexpr bool PART_BOXES = false;
#endif
#ifdef K2W_PART_KSTEPS
constexpr bool PART_KSTEPS = true;
#else
constexpr bool PART_KSTEPS = false;
#endif

// whether k16 step kk (of HD / 16) of S and dP runs in an item of part
// `part` (DH / 16 steps a part): always, but in the K2W_PART_KSTEPS variant
template <int DH>
__device__ __forceinline__ bool kstep_runs(int kk, int part) {
  return !PART_KSTEPS || kk / (DH / 16) == part;
}

template <int HD, bool WINDOW>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_seg, const int* __restrict__ seg_q,
                         const int* __restrict__ seg_kv, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                         int* __restrict__ tiles, int* __restrict__ queue, int B, int Lq, int Lk,
                         int NH, int NKV, float scale, int causal, int window) {
  using S = DqWide<HD>;
  constexpr int BQ = S::BQ, BK = S::BK, DH = S::DH, SLOTS = S::SLOTS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const int* seg_s = reinterpret_cast<const int*>(smem + S::seg_off);
  int* segq_s = reinterpret_cast<int*>(smem + S::row_off);
  float* lse_s = reinterpret_cast<float*>(segq_s + BQ);  // * log2(e)
  float* delta_s = lse_s + BQ;
  int2* hdr = reinterpret_cast<int2*>(smem + S::hdr_off);  // a k slot's first key and flags
  WideItem* item_s = reinterpret_cast<WideItem*>(smem + S::item_off);
  const uint32_t full_bar = sbase + S::bar_off;
  const uint32_t empty_bar = full_bar + 8 * SLOTS;
  const uint32_t q_full = full_bar + 16 * SLOTS;
  const uint32_t q_empty = q_full + 8;

  const int n_q = (Lq + BQ - 1) / BQ, n_tiles = (Lk + BK - 1) / BK;
  const int n_items = n_q * NH * B * S::NSPLIT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full_bar + 8 * s, 1);     // the loads' expect_tx
      mbar_init(empty_bar + 8 * s, 128);  // every consumer thread
    }
    mbar_init(q_full, 33);  // q/dO's expect_tx + 32 lanes writing the rows and the item
    mbar_init(q_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WIDE_PRODUCER) {
    // ---- producer warp: for each item, read the q rows' ids, lse and delta
    // and count the visited kv tiles; load the visited tiles' v and k (with
    // their ids) into the slots, publishing the item (q, dO, rows, counts)
    // once its first pair is on its way and the consumers are done with the
    // previous item
    uint32_t pos = 0;  // slots filled: slot pos % SLOTS, its fill pos / SLOTS
    for (int it = 0;; ++it) {
      const int e = next_item(queue, lane);
      if (e >= n_items) {  // none left: the consumers' sentinel
        if (it > 0) mbar_wait(q_empty, (it - 1) & 1);
        if (lane == 0) {
          item_s->r0 = -1;
          mbar_arrive(q_full);
        }
        __syncwarp();
        mbar_arrive(q_full);
        break;
      }
      const int part = e % S::NSPLIT, r = e / S::NSPLIT;
      const int qi = r / (NH * B), hb = r % (NH * B);
      const int h = hb % NH, b = hb / NH, kvh = h / (NH / NKV);
      const int q0 = (causal ? n_q - 1 - qi : qi) * BQ;  // most kv tiles first under `causal`
      int j1 = n_tiles;
      if (causal) j1 = min(j1, (min(q0 + BQ, Lq) - 1) / BK + 1);
      const int j0 = WINDOW ? max(0, q0 - window + 1) / BK : 0;
      const int nt = max(j1 - j0, 0);
      const int* ids = seg_kv + (size_t)b * Lk;
      const size_t lrow = ((size_t)b * NH + h) * Lq;
      int sq[2];
      float lv[2], dv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = q0 + lane + 32 * u;
        const bool in = row < Lq;
        sq[u] = in ? seg_q[(size_t)b * Lq + row] : 0;
        lv[u] = in ? lse[lrow + row] * LOG2E : 0.f;
        dv[u] = in ? delta[lrow + row] : 0.f;
      }
      int q_lo, q_hi;
      bool q_one;
      segment_range(sq, q_lo, q_hi, q_one);
      int visited = 0;
      for (int t0 = 0; t0 < nt; t0 += SCAN) {
        uint32_t ones;
        visited += __popc(scan32(ids, j0 + t0, min(SCAN, nt - t0), Lk, q_lo, q_hi, q_one, lane, ones));
      }
      auto publish = [&]() {
        if (it > 0) mbar_wait(q_empty, (it - 1) & 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(q_full, 2 * S::Q_BYTES);
#pragma unroll
          for (int hf = 0; hf < HD / 64; ++hf) {
            tma_load(sbase + S::q_off + hf * BQ * 128, &tm_q, q_full, hf * 64, h, q0, b);
            tma_load(sbase + S::q_off + S::Q_BYTES + hf * BQ * 128, &tm_do, q_full, hf * 64, h,
                     q0, b);
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          segq_s[lane + 32 * u] = sq[u];
          lse_s[lane + 32 * u] = lv[u];
          delta_s[lane + 32 * u] = dv[u];
        }
        if (lane == 0) {
          *item_s = WideItem{q0, h, b, visited, part};
          if (tiles != nullptr && part == 0) {  // [B, NH, n_q, 2]: visited, candidates
            int* slot = tiles + 2 * (((size_t)b * NH + h) * n_q + q0 / BQ);
            slot[0] = visited;
            slot[1] = nt;
          }
        }
        __syncwarp();
        mbar_arrive(q_full);
      };
      int issued = 0;
      for (int t0 = 0; t0 < nt; t0 += SCAN) {
        uint32_t ones;
        const uint32_t bits = scan32(ids, j0 + t0, min(SCAN, nt - t0), Lk, q_lo, q_hi, q_one,
                                     lane, ones);
        for (int a = 0; a < SCAN; ++a) {
          if (!((bits >> a) & 1)) continue;
          const int k0 = (j0 + t0 + a) * BK;
          if (lane == 0) {
#pragma unroll
            for (int x = 0; x < 2; ++x) {  // v, then k with its ids and header
              const uint32_t slot = (pos + x) % SLOTS;
              mbar_wait(empty_bar + 8 * slot, (((pos + x) / SLOTS) & 1) ^ 1);
              const uint32_t bar = full_bar + 8 * slot;
              const uint32_t dst = sbase + S::slot_off + slot * S::SLOT_BYTES;
              if (x == 1) hdr[slot] = make_int2(k0, 1 | ((ones >> a) & 1 ? 2 : 0));
              mbar_arrive_expect_tx(bar, S::SLOT_BYTES / (PART_BOXES ? S::NSPLIT : 1) +
                                             (x == 1 ? (BK + FLAT_PAD) * 4 : 0));
#pragma unroll
              for (int hf = 0; hf < HD / 64; ++hf)
                if (!PART_BOXES || hf / (DH / 64) == part)
                  tma_load(dst + hf * BK * 128, x == 1 ? &tm_k : &tm_v, bar, hf * 64, kvh, k0, b);
              if (x == 1)
                tma_load_flat(sbase + S::seg_off + slot * S::SEG_SLOT, &tm_seg, bar,
                              b * Lk + k0);
            }
          }
          pos += 2;
          if (++issued == 1) publish();
        }
      }
      if (issued == 0) publish();
    }
    return;
  }

  // ---- the consumer warpgroup: this thread holds q rows r0 = q0 + lr and r1
  // = r0 + 8, and of every 8-column group the columns 2 (lane % 4) + {0, 1}
  const float sl2 = scale * LOG2E;
  const int lr = 16 * warp + lane / 4;
  uint32_t pos = 0;
  for (int it = 0;; ++it) {
    mbar_wait(q_full, it & 1);
    const WideItem item = *item_s;
    if (item.r0 < 0) break;
    const int r0 = item.r0 + lr, r1 = r0 + 8;
    const int sq0 = segq_s[lr], sq1 = segq_s[lr + 8];
    const float l0 = lse_s[lr], l1 = lse_s[lr + 8], d0 = delta_s[lr], d1 = delta_s[lr + 8];
    // K-major operands: +32 bytes a k16 step inside a box, the next box BQ
    // (q, dO: Q_BYTES after q) or BK (k, v) rows on
    const uint64_t dsc_q = smem_desc(sbase + S::q_off, 16, 1024);
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

    for (int t = 0; t < item.visited; ++t, pos += 2) {
      const uint32_t sv = pos % SLOTS, sk = (pos + 1) % SLOTS;
      const uint32_t k_base = sbase + S::slot_off + sk * S::SLOT_BYTES;
      float s[BK / 2], dp[BK / 2];
      // dP = dO V^T as soon as v lands, then S = Q K^T
      mbar_wait(full_bar + 8 * sv, (pos / SLOTS) & 1);
      const uint64_t dsc_v = smem_desc(sbase + S::slot_off + sv * S::SLOT_BYTES, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int qo = ((kk / 4) * BQ * 128 + (kk % 4) * 32 + S::Q_BYTES) >> 4;
        const int ko = ((kk / 4) * BK * 128 + (kk % 4) * 32) >> 4;
        if (kstep_runs<DH>(kk, item.part))
          wgmma_ss<BK>(dp, dsc_q + qo, dsc_v + ko, PART_KSTEPS ? kk % (DH / 16) > 0 : kk > 0);
      }
      mbar_wait(full_bar + 8 * sk, ((pos + 1) / SLOTS) & 1);
      const uint64_t dsc_k = smem_desc(k_base, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int qo = ((kk / 4) * BQ * 128 + (kk % 4) * 32) >> 4;
        const int ko = ((kk / 4) * BK * 128 + (kk % 4) * 32) >> 4;
        if (kstep_runs<DH>(kk, item.part))
          wgmma_ss<BK>(s, dsc_q + qo, dsc_k + ko, PART_KSTEPS ? kk % (DH / 16) > 0 : kk > 0);
      }
      wgmma_commit_and_wait();
      pin(s);
      pin(dp);
      mbar_arrive(empty_bar + 8 * sv);  // v is done with

      // the mask: a tile inside one segment needs no segment mask, one below
      // the diagonal and inside the band no position mask; each row's visible
      // columns are [lo, hi] (causal, band; r1's lo is r0's + 8) and none past
      // Lk (the ids come from a flat [B * Lk] map: past a row's end they are
      // the next row's)
      const int2 hk = hdr[sk];
      const int k0 = hk.x;
      const bool seg_mask = !(hk.y & 2);
      const bool pos_mask =
          (causal && k0 + BK - 1 > item.r0) || (WINDOW && k0 < item.r0 + BQ - window);
      if (seg_mask || pos_mask) {
        const int hi0 = min(causal ? r0 - k0 : INT_MAX, Lk - 1 - k0);
        const int hi1 = min(causal ? r1 - k0 : INT_MAX, Lk - 1 - k0);
        const int lo = WINDOW ? r0 - k0 - window + 1 : INT_MIN;
        const int* skp = seg_s + sk * (S::SEG_SLOT / 4) + ((item.b * Lk + k0) & 3);
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = 8 * i + 2 * (lane % 4) + j;
            bool v0 = c >= lo && c <= hi0, v1 = c >= lo + 8 && c <= hi1;
            if (seg_mask) {
              const int ks = skp[c];
              v0 = v0 && sq0 != 0 && ks == sq0;
              v1 = v1 && sq1 != 0 && ks == sq1;
            }
            s[4 * i + j] = v0 ? s[4 * i + j] : MASKED;
            s[4 * i + 2 + j] = v1 ? s[4 * i + 2 + j] : MASKED;
          }
        }
      }
      // p = 2^(s scale log2(e) - lse log2(e)) (a masked score is -inf: p = 0),
      // ds = bf16(p (dp - delta)) packed as the register A fragments of
      // dq += dS K (k step kk: columns [16 kk, 16 kk + 16); x = 0, 2 row r0's)
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int c = 8 * kk + 2 * x;
          const float l = x & 1 ? l1 : l0, d = x & 1 ? d1 : d0;
          da[kk][x] = pack_bf16(ex2(fmaf(s[c], sl2, -l)) * (dp[c] - d),
                                ex2(fmaf(s[c + 1], sl2, -l)) * (dp[c + 1] - d));
        }
      }
      // dq += dS K over the item's columns: K MN-major (+2048 bytes a k16
      // step, its 64-column boxes BK * 128 bytes apart, the part DH / 64
      // boxes on)
      const uint64_t dsc_km =
          smem_desc(k_base + item.part * (DH / 64) * BK * 128, BK * 128, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DH>(acc, da[kk], dsc_km + ((kk * 16 * 128) >> 4));
      wgmma_commit_and_wait();
      pin(acc);
      mbar_arrive(empty_bar + 8 * sk);  // k is done with
    }

    // ---- epilogue: dq * scale staged in the item's columns of the q tile
    // (its last reads are complete), then 16-byte stores; q and dO are free
    // for the next item once every consumer thread is done
    const uint32_t cols = item.part * (DH / 64) * BQ * 128;
    stage_rows<DH>(acc, scale, scale, sbase + S::q_off + cols, BQ, 0, lr, lane);
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    store_rows<DH>(dq + (((size_t)item.b * Lq + item.r0) * NH + item.h) * HD + item.part * DH,
                   (size_t)NH * HD, smem + S::q_off + cols, BQ, 0, Lq - item.r0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(q_empty);
  }
}

template <int HD, bool WINDOW>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ seg_q,
                          const int* __restrict__ seg_kv, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int* __restrict__ tiles,
                          int* __restrict__ queue, int B, int Lq, int Lk, int NH, int NKV,
                          float scale, int causal, int window) {
  using S = DkvWide<HD>;
  constexpr int BQ = S::BQ, BK = S::BK, DH = S::DH, SLOTS = S::SLOTS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  int* segk_s = reinterpret_cast<int*>(smem + S::segk_off);
  int2* hdr = reinterpret_cast<int2*>(smem + S::hdr_off);  // a dO slot's first q row and flags
  WideItem* item_s = reinterpret_cast<WideItem*>(smem + S::item_off);
  const uint32_t full_bar = sbase + S::bar_off;
  const uint32_t empty_bar = full_bar + 8 * SLOTS;
  const uint32_t kv_full = full_bar + 16 * SLOTS;
  const uint32_t kv_empty = kv_full + 8;

  const int n_qt = (Lq + BQ - 1) / BQ, n_kt = (Lk + BK - 1) / BK;
  const int n_items = n_kt * NKV * B * S::NSPLIT;
  const int group = NH / NKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 128);
    }
    mbar_init(kv_full, 33);  // k/v's expect_tx + 32 lanes writing the ids and the item
    mbar_init(kv_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WIDE_PRODUCER) {
    // ---- producer warp: for each item, read the kv tile's ids and count its
    // visited q tiles; for every q head of the group load the visited tiles'
    // dO (with a header) and q into the slots, publishing the item (k, v, ids,
    // counts) once its first pair is on its way and the consumers are done
    // with the previous item
    uint32_t pos = 0;
    for (int it = 0;; ++it) {
      const int e = next_item(queue, lane);
      if (e >= n_items) {  // none left: the consumers' sentinel
        if (it > 0) mbar_wait(kv_empty, (it - 1) & 1);
        if (lane == 0) {
          item_s->r0 = -1;
          mbar_arrive(kv_full);
        }
        __syncwarp();
        mbar_arrive(kv_full);
        break;
      }
      const int part = e % S::NSPLIT, r = e / S::NSPLIT;
      const int ki = r / (NKV * B), hb = r % (NKV * B);
      const int kvh = hb % NKV, b = hb / NKV, k0 = ki * BK;
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
      int k_lo, k_hi;
      bool k_one;
      segment_range(sk, k_lo, k_hi, k_one);
      const int* ids = seg_q + (size_t)b * Lq;
      int visited = 0;
      for (int t0 = 0; t0 < nt; t0 += SCAN) {
        uint32_t ones;
        visited += __popc(scan32(ids, i0 + t0, min(SCAN, nt - t0), Lq, k_lo, k_hi, k_one, lane, ones));
      }
      auto publish = [&]() {
        if (it > 0) mbar_wait(kv_empty, (it - 1) & 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(kv_full, 2 * S::TILE_BYTES);
#pragma unroll
          for (int hf = 0; hf < HD / 64; ++hf) {
            tma_load(sbase + S::k_off + hf * BK * 128, &tm_k, kv_full, hf * 64, kvh, k0, b);
            tma_load(sbase + S::v_off + hf * BK * 128, &tm_v, kv_full, hf * 64, kvh, k0, b);
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) segk_s[lane + 32 * u] = sk[u];
        if (lane == 0) {
          *item_s = WideItem{k0, kvh, b, visited, part};
          if (tiles != nullptr && part == 0) {  // [B, NKV, n_kt, 2]: visited, candidates
            int* slot = tiles + 2 * (((size_t)b * NKV + kvh) * n_kt + ki);
            slot[0] = visited;
            slot[1] = nt;
          }
        }
        __syncwarp();
        mbar_arrive(kv_full);
      };
      int issued = 0;
      for (int g = 0; g < group; ++g) {
        const int h = kvh * group + g;
        for (int t0 = 0; t0 < nt; t0 += SCAN) {
          uint32_t ones;
          const uint32_t bits = scan32(ids, i0 + t0, min(SCAN, nt - t0), Lq, k_lo, k_hi, k_one,
                                       lane, ones);
          for (int a = 0; a < SCAN; ++a) {
            if (!((bits >> a) & 1)) continue;
            const int q0 = (i0 + t0 + a) * BQ;
            if (lane == 0) {
#pragma unroll
              for (int x = 0; x < 2; ++x) {  // dO with the header, then q
                const uint32_t slot = (pos + x) % SLOTS;
                mbar_wait(empty_bar + 8 * slot, (((pos + x) / SLOTS) & 1) ^ 1);
                const uint32_t bar = full_bar + 8 * slot;
                const uint32_t dst = sbase + S::slot_off + slot * S::SLOT_BYTES;
                if (x == 0) hdr[slot] = make_int2(q0, 1 | ((ones >> a) & 1 ? 2 : 0));
                mbar_arrive_expect_tx(bar, S::SLOT_BYTES / (PART_BOXES ? S::NSPLIT : 1));
#pragma unroll
                for (int hf = 0; hf < HD / 64; ++hf)
                  if (!PART_BOXES || hf / (DH / 64) == part)
                    tma_load(dst + hf * BQ * 128, x == 1 ? &tm_q : &tm_do, bar, hf * 64, h, q0,
                             b);
              }
            }
            pos += 2;
            if (++issued == 1) publish();
          }
        }
      }
      if (issued == 0) publish();
    }
    return;
  }

  // ---- the consumer warpgroup: this thread holds kv rows r0 = k0 + lr and
  // r1 = r0 + 8 of the transposed tiles, and of every 8-column group (q rows)
  // the columns 2 (lane % 4) + {0, 1}
  const float sl2 = scale * LOG2E;
  const int lr = 16 * warp + lane / 4;
  uint32_t pos = 0;
  for (int it = 0;; ++it) {
    mbar_wait(kv_full, it & 1);
    const WideItem item = *item_s;
    if (item.r0 < 0) break;
    const int r0 = item.r0 + lr, r1 = r0 + 8;
    const int sk0 = segk_s[lr], sk1 = segk_s[lr + 8];
    const int* ids = seg_q + (size_t)item.b * Lq;
    float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }
    // K-major A operands: +32 bytes a k16 step inside a box, the next box BK rows on
    const uint64_t dsc_k = smem_desc(sbase + S::k_off, 16, 1024);
    const uint64_t dsc_v = smem_desc(sbase + S::v_off, 16, 1024);

    for (int g = 0; g < group; ++g) {
      const size_t lrow = ((size_t)item.b * NH + item.h * group + g) * Lq;
      for (int t = 0; t < item.visited; ++t, pos += 2) {
        const uint32_t sd = pos % SLOTS, sq = (pos + 1) % SLOTS;
        const uint32_t do_base = sbase + S::slot_off + sd * S::SLOT_BYTES;
        const uint32_t q_base = sbase + S::slot_off + sq * S::SLOT_BYTES;
        mbar_wait(full_bar + 8 * sd, (pos / SLOTS) & 1);
        const int2 hq = hdr[sd];
        const int q0 = hq.x;
        // this thread's q rows (columns 8 i + 2 (lane % 4) + j): lse, delta
        // and ids, read while the products run; rows past Lq are padding
        float lj[BQ / 4], dj[BQ / 4];
        int idj[BQ / 4];
#pragma unroll
        for (int i = 0; i < BQ / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int q = q0 + 8 * i + 2 * (lane % 4) + j;
            const bool in = q < Lq;
            lj[2 * i + j] = in ? __ldg(lse + lrow + q) : 0.f;
            dj[2 * i + j] = in ? __ldg(delta + lrow + q) : 0.f;
            idj[2 * i + j] = in ? __ldg(ids + q) : 0;
          }
        }
        // dP^T = V dO^T as soon as dO lands, then S^T = K Q^T; the B tiles
        // K-major, their boxes BQ rows apart
        const uint64_t dsc_do = smem_desc(do_base, 16, 1024);
        wgmma_fence();
        float s[BQ / 2], dp[BQ / 2];
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int ao = ((kk / 4) * BK * 128 + (kk % 4) * 32) >> 4;
          const int bo = ((kk / 4) * BQ * 128 + (kk % 4) * 32) >> 4;
          if (kstep_runs<DH>(kk, item.part))
            wgmma_ss<BQ>(dp, dsc_v + ao, dsc_do + bo, PART_KSTEPS ? kk % (DH / 16) > 0 : kk > 0);
        }
        mbar_wait(full_bar + 8 * sq, ((pos + 1) / SLOTS) & 1);
        const uint64_t dsc_q = smem_desc(q_base, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int ao = ((kk / 4) * BK * 128 + (kk % 4) * 32) >> 4;
          const int bo = ((kk / 4) * BQ * 128 + (kk % 4) * 32) >> 4;
          if (kstep_runs<DH>(kk, item.part))
            wgmma_ss<BQ>(s, dsc_k + ao, dsc_q + bo, PART_KSTEPS ? kk % (DH / 16) > 0 : kk > 0);
        }
        wgmma_commit_and_wait();
        pin(s);
        pin(dp);

        // P^T and dS^T: a column is one q row; masked entries are -inf before
        // the exponential, so their p is 0. A tile inside one segment needs no
        // segment mask, one below the diagonal and inside the band no position mask.
        const bool seg_mask = !(hq.y & 2);
        const bool pos_mask =
            (causal && q0 < item.r0 + BK - 1) || (WINDOW && q0 + BQ - 1 - item.r0 >= window);
#pragma unroll
        for (int i = 0; i < BQ / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int q = q0 + 8 * i + 2 * (lane % 4) + j;
            float x0 = s[4 * i + j], x1 = s[4 * i + 2 + j];
            if (seg_mask || pos_mask) {
              bool v0 = (!causal || q >= r0) && (!WINDOW || q - r0 < window);
              bool v1 = (!causal || q >= r1) && (!WINDOW || q - r1 < window);
              if (seg_mask) {
                const int id = idj[2 * i + j];
                v0 = v0 && id != 0 && id == sk0;
                v1 = v1 && id != 0 && id == sk1;
              }
              x0 = v0 ? x0 : MASKED;
              x1 = v1 ? x1 : MASKED;
            }
            const float l = lj[2 * i + j] * LOG2E, d = dj[2 * i + j];
            const float p0 = ex2(fmaf(x0, sl2, -l)), p1 = ex2(fmaf(x1, sl2, -l));
            s[4 * i + j] = p0;
            s[4 * i + 2 + j] = p1;
            dp[4 * i + j] = p0 * (dp[4 * i + j] - d);
            dp[4 * i + 2 + j] = p1 * (dp[4 * i + 2 + j] - d);
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
        // bytes apart, the part DH / 64 boxes on)
        const uint32_t cols = item.part * (DH / 64) * BQ * 128;
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
        mbar_arrive(empty_bar + 8 * sd);
        mbar_arrive(empty_bar + 8 * sq);
      }
    }

    // ---- epilogue: dv and dk * scale staged in the item's columns of its v
    // and k tiles (their last reads are complete), then 16-byte stores; k and
    // v are free for the next item once every consumer thread is done
    const uint32_t cols = item.part * (DH / 64) * BK * 128;
    stage_rows<DH>(dv_acc, 1.f, 1.f, sbase + S::v_off + cols, BK, 0, lr, lane);
    stage_rows<DH>(dk_acc, scale, scale, sbase + S::k_off + cols, BK, 0, lr, lane);
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    const size_t out = (((size_t)item.b * Lk + item.r0) * NKV + item.h) * HD + item.part * DH;
    store_rows<DH>(dv + out, (size_t)NKV * HD, smem + S::v_off + cols, BK, 0, Lk - item.r0);
    store_rows<DH>(dk + out, (size_t)NKV * HD, smem + S::k_off + cols, BK, 0, Lk - item.r0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(kv_empty);
  }
}

template <int HD, bool WINDOW>
cudaError_t launch_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                           const int* seg_q, const int* seg_kv, const float* lse,
                           const float* delta, void* dq, int* tiles, int* queue, int B, int Lq,
                           int Lk, int NH, int NKV, float scale, int causal, int window,
                           cudaStream_t stream) {
  using S = DqWide<HD>;
  if (B == 0 || Lq == 0) return cudaSuccess;
  if (Lk == 0 || queue == nullptr) return cudaErrorInvalidValue;
  static bool configured = false;
  cudaError_t err = configure(flash_bwd_dq_wide_kernel<HD, WINDOW>, &configured);
  if (err != cudaSuccess) return err;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tdo, tk, tv, tseg;
  if (!tensor_map(&tq, encode, q, HD, NH, Lq, B, S::BQ) ||
      !tensor_map(&tdo, encode, dout, HD, NH, Lq, B, S::BQ) ||
      !tensor_map(&tk, encode, k, HD, NKV, Lk, B, S::BK) ||
      !tensor_map(&tv, encode, v, HD, NKV, Lk, B, S::BK) ||
      !flat_map(&tseg, encode, seg_kv, B * Lk, S::BK + FLAT_PAD, CU_TENSOR_MAP_DATA_TYPE_INT32))
    return cudaErrorInvalidValue;
  const int n_items = (Lq + S::BQ - 1) / S::BQ * NH * B * S::NSPLIT;
  int grid = 0;
  err = grid_size(flash_bwd_dq_wide_kernel<HD, WINDOW>, WIDE_THREADS, S::BYTES, n_items, &grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wide_kernel<HD, WINDOW><<<grid, WIDE_THREADS, S::BYTES, stream>>>(
      tq, tdo, tk, tv, tseg, seg_q, seg_kv, lse, delta, static_cast<__nv_bfloat16*>(dq), tiles,
      queue, B, Lq, Lk, NH, NKV, scale, causal, window);
  return cudaGetLastError();
}

template <int HD, bool WINDOW>
cudaError_t launch_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                            const int* seg_q, const int* seg_kv, const float* lse,
                            const float* delta, void* dk, void* dv, int* tiles, int* queue, int B,
                            int Lq, int Lk, int NH, int NKV, float scale, int causal, int window,
                            cudaStream_t stream) {
  using S = DkvWide<HD>;
  if (B == 0 || Lk == 0) return cudaSuccess;
  if (Lq == 0 || queue == nullptr) return cudaErrorInvalidValue;
  static bool configured = false;
  cudaError_t err = configure(flash_bwd_dkv_wide_kernel<HD, WINDOW>, &configured);
  if (err != cudaSuccess) return err;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tdo, tk, tv;
  if (!tensor_map(&tq, encode, q, HD, NH, Lq, B, S::BQ) ||
      !tensor_map(&tdo, encode, dout, HD, NH, Lq, B, S::BQ) ||
      !tensor_map(&tk, encode, k, HD, NKV, Lk, B, S::BK) ||
      !tensor_map(&tv, encode, v, HD, NKV, Lk, B, S::BK))
    return cudaErrorInvalidValue;
  const int n_items = (Lk + S::BK - 1) / S::BK * NKV * B * S::NSPLIT;
  int grid = 0;
  err = grid_size(flash_bwd_dkv_wide_kernel<HD, WINDOW>, WIDE_THREADS, S::BYTES, n_items, &grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wide_kernel<HD, WINDOW><<<grid, WIDE_THREADS, S::BYTES, stream>>>(
      tq, tdo, tk, tv, seg_q, seg_kv, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), tiles, queue, B, Lq, Lk, NH, NKV, scale, causal, window);
  return cudaGetLastError();
}

int run_dq(const void* q, const void* k, const void* v, const void* dout, const void* seg_q,
           const void* seg_kv, const void* lse, const void* delta, void* dq, int* tiles,
           int* queue, int B, int Lq, int Lk, int NH, int NKV, int HD, float scale, int causal,
           int window, void* stream) {
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
#define PRT_DQ_WIDE_CASE(hd, w)                                                                 \
  if (HD == hd && (window > 0) == w)                                                             \
    return launch_dq_wide<hd, w>(q, k, v, dout, sq, sk, l, d, dq, tiles, queue, B, Lq, Lk, NH,   \
                                 NKV, scale, causal, window, st);
  PRT_DQ_WIDE_CASE(384, false) PRT_DQ_WIDE_CASE(384, true)
  PRT_DQ_WIDE_CASE(512, false) PRT_DQ_WIDE_CASE(512, true)
#undef PRT_DQ_WIDE_CASE
  return (int)cudaErrorInvalidValue;
}

int run_dkv(const void* q, const void* k, const void* v, const void* dout, const void* seg_q,
            const void* seg_kv, const void* lse, const void* delta, void* dk, void* dv, int* tiles,
            int* queue, int B, int Lq, int Lk, int NH, int NKV, int HD, float scale, int causal,
            int window, void* stream) {
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
#define PRT_DKV_WIDE_CASE(hd, w)                                                                \
  if (HD == hd && (window > 0) == w)                                                             \
    return launch_dkv_wide<hd, w>(q, k, v, dout, sq, sk, l, d, dk, dv, tiles, queue, B, Lq, Lk,  \
                                  NH, NKV, scale, causal, window, st);
  PRT_DKV_WIDE_CASE(384, false) PRT_DKV_WIDE_CASE(384, true)
  PRT_DKV_WIDE_CASE(512, false) PRT_DKV_WIDE_CASE(512, true)
#undef PRT_DKV_WIDE_CASE
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

// `queue`: an int zeroed before the launch, the wide forms' work queue (head
// dims 384 and 512; unused below them, where it may be null)
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* seg_q, const void* seg_kv, const void* lse,
                                 const void* delta, void* dq, void* queue, int B, int Lq, int Lk,
                                 int NH, int NKV, int HD, float scale, int causal, int window,
                                 void* stream) {
  return run_dq(q, k, v, dout, seg_q, seg_kv, lse, delta, dq, nullptr, static_cast<int*>(queue),
                B, Lq, Lk, NH, NKV, HD, scale, causal, window, stream);
}

// the same launch, also writing each item's kv tile counts into `tiles`
// (int32 [B, NH, ceil(Lq / BQ), 2]: visited, candidates; BQ = 128, or 64 at
// head dims 256, 384 and 512)
extern "C" int flash_attn_bwd_dq_tiles(const void* q, const void* k, const void* v,
                                       const void* dout, const void* seg_q, const void* seg_kv,
                                       const void* lse, const void* delta, void* dq, void* queue,
                                       int B, int Lq, int Lk, int NH, int NKV, int HD, float scale,
                                       int causal, int window, void* stream, void* tiles) {
  return run_dq(q, k, v, dout, seg_q, seg_kv, lse, delta, dq, static_cast<int*>(tiles),
                static_cast<int*>(queue), B, Lq, Lk, NH, NKV, HD, scale, causal, window, stream);
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* seg_q, const void* seg_kv, const void* lse,
                                  const void* delta, void* dk, void* dv, void* queue, int B,
                                  int Lq, int Lk, int NH, int NKV, int HD, float scale, int causal,
                                  int window, void* stream) {
  return run_dkv(q, k, v, dout, seg_q, seg_kv, lse, delta, dk, dv, nullptr,
                 static_cast<int*>(queue), B, Lq, Lk, NH, NKV, HD, scale, causal, window, stream);
}

// the same launch, also writing each item's q tile counts (for one head of
// the group) into `tiles` (int32 [B, NKV, ceil(Lk / 64), 2]: visited, candidates)
extern "C" int flash_attn_bwd_dkv_tiles(const void* q, const void* k, const void* v,
                                        const void* dout, const void* seg_q, const void* seg_kv,
                                        const void* lse, const void* delta, void* dk, void* dv,
                                        void* queue, int B, int Lq, int Lk, int NH, int NKV,
                                        int HD, float scale, int causal, int window, void* stream,
                                        void* tiles) {
  return run_dkv(q, k, v, dout, seg_q, seg_kv, lse, delta, dk, dv, static_cast<int*>(tiles),
                 static_cast<int*>(queue), B, Lq, Lk, NH, NKV, HD, scale, causal, window, stream);
}

// dynamic shared memory of one block of K2a (kernel 0, over `len` = Lk keys)
// or K2b (kernel 1, over `len` = Lq queries) at head dim `hd`
extern "C" int flash_attn_bwd_smem(int kernel, int hd, int len) {
  if (hd == 384) return kernel == 0 ? DqWide<384>::BYTES : DkvWide<384>::BYTES;
  if (hd == 512) return kernel == 0 ? DqWide<512>::BYTES : DkvWide<512>::BYTES;
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
  PRT_OCC_CASE(0, flash_bwd_dq_wide_kernel, 384, false, WIDE_THREADS, DqWide<384>::BYTES)
  PRT_OCC_CASE(0, flash_bwd_dq_wide_kernel, 384, true, WIDE_THREADS, DqWide<384>::BYTES)
  PRT_OCC_CASE(0, flash_bwd_dq_wide_kernel, 512, false, WIDE_THREADS, DqWide<512>::BYTES)
  PRT_OCC_CASE(0, flash_bwd_dq_wide_kernel, 512, true, WIDE_THREADS, DqWide<512>::BYTES)
  PRT_OCC_CASE(1, flash_bwd_dkv_wide_kernel, 384, false, WIDE_THREADS, DkvWide<384>::BYTES)
  PRT_OCC_CASE(1, flash_bwd_dkv_wide_kernel, 384, true, WIDE_THREADS, DkvWide<384>::BYTES)
  PRT_OCC_CASE(1, flash_bwd_dkv_wide_kernel, 512, false, WIDE_THREADS, DkvWide<512>::BYTES)
  PRT_OCC_CASE(1, flash_bwd_dkv_wide_kernel, 512, true, WIDE_THREADS, DkvWide<512>::BYTES)
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
  PRT_ATTR_CASE(0, flash_bwd_dq_wide_kernel, 384, false)
  PRT_ATTR_CASE(0, flash_bwd_dq_wide_kernel, 384, true)
  PRT_ATTR_CASE(0, flash_bwd_dq_wide_kernel, 512, false)
  PRT_ATTR_CASE(0, flash_bwd_dq_wide_kernel, 512, true)
  PRT_ATTR_CASE(1, flash_bwd_dkv_wide_kernel, 384, false)
  PRT_ATTR_CASE(1, flash_bwd_dkv_wide_kernel, 384, true)
  PRT_ATTR_CASE(1, flash_bwd_dkv_wide_kernel, 512, false)
  PRT_ATTR_CASE(1, flash_bwd_dkv_wide_kernel, 512, true)
#undef PRT_ATTR_CASE
  return (int)cudaErrorInvalidValue;
}
