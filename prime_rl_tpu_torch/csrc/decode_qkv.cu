// K3: fused decode-time QKV preparation for Hopper (sm_90a).
//
// Replaces the TPU kernel prime_rl_tpu/ops/decode_qkv.py `_kernel` (pallas_call
// in `decode_qkv_prep`). For S decode tokens: rms-norm of x (f32, then cast
// to bf16 as the TPU kernel casts to the weight dtype) -> q/k/v projections
// computed here with f32 accumulation -> optional bias -> per-head RMS
// qk-norm -> half-split rope with partial rotation and a cos/sin `scaling`
// (YaRN). Bias, qk-norm and rope stay in f32 until the one bf16 store.
//
// What bounds it on the H100: the weight read. At decode batch sizes (S <= 64
// rows against D x (NH + 2 NKV) HD weights) a weight byte feeds at most S
// products, far below the ~295 flops a byte at which the tensor cores would
// bind: 8.4 MB of weights for Qwen3-0.6B, 29.5 MB for gpt-oss-20b, a layer.
// So the design reads each weight byte from device memory once a call, keeps
// enough of them in flight to reach the card's read rate, and keeps the
// chain of latencies around that read (x, the norm, the reduction, the
// epilogue) short:
//
// - A column tile is BN = 128 output columns of one of wq, wk, wv (one head
//   at head dim 128, two at 64, four at 32; a tile past a projection's last
//   column reads zeros and stores nothing). A thread-block cluster of k
//   blocks takes one column tile and splits D between its blocks: block r
//   takes the 64-row K tiles [r*b + min(r, e), ...) of D, b + (r < e) of them
//   (b = KT / k, e = KT % k, KT = ceil(D / 64)). Its norm, its x and its
//   weights are those rows only. The grid is (column tiles x k, row groups).
// - The split k (1-8) and the ring's depth (2-4 stages) are sized on the host
//   from cudaOccupancyMaxActiveClusters at the shared memory they need: the
//   least waves x (K tiles a block + SPLIT_COST), where a wave is the
//   clusters the card holds at once (GPCs hold a fixed number of clusters,
//   so a grid that needs a second round pays a second round of weight
//   loads), ties to the smaller split and the deeper ring. The plan is
//   searched once for each shape and kept: every layer of a decode step
//   asks for the same one.
// - Weight tiles (64 rows of D x BN columns, two 64-column boxes in the
//   128-byte swizzle) stream by TMA through the ring behind full/empty
//   mbarriers, issued by one producer warp right after x's boxes: 32-64 KB
//   in flight a block, one or two blocks an SM. (Issuing them only once x
//   was in, and prefetching the tiles past the ring into L2, were as fast or
//   slower: scripts/torch_decode_qkv_bench.py --variants.) Each weight tile is loaded
//   once a call for S <= 128 (each block counts the tiles it loads:
//   `decode_qkv_prep_tiles`).
// - Rows: a block holds up to 128 token rows in 64-row M tiles (MT = 1 for
//   S <= 64, 2 above), each held by two consumer warpgroups whose products
//   take a 64-column half of the tile (m64n64), all reading every staged
//   weight tile. Two warpgroups an M tile give the norm's passes four
//   threads a row and the epilogue eight warps, where one had them wait on
//   their own latency (gpt-oss-20b: x to the normed A 4.5 us). Above 128 rows
//   the grid has ceil(S / 128) row groups, each loading the weights again:
//   once a call per 128 rows.
// - The norm: x's rows of the block's D chunk come by TMA (boxes of 64 rows x
//   64 columns in the 128-byte swizzle; rows at or
//   past S lie outside the map, which TMA fills with zeros without reading
//   memory), and with them norm_w over the chunk, the tile's biases and the
//   qk-norm weights by bulk copies. Each block sums the squares of its chunk
//   in f32 and pushes the sums into every block of the cluster (st.async
//   into distributed shared memory, counted on the receiver's mbarrier: a
//   cluster barrier here waited for the weight tiles in flight into the
//   blocks' shared memory, 2.7 us at Qwen3-0.6B's shape); every block adds
//   the k sums in the fixed order 0..k-1, so all get the same rstd. The
//   products then take bf16(x * rstd * norm_w) (f32 arithmetic, one cast)
//   as their A operand in registers, formed per k16 step from the raw x box
//   (ldmatrix): no second pass over x in shared memory holds them back, and
//   the normalization runs while the weights stream. Positions and
//   inv_freq are loaded at entry and used after the products. (A cluster
//   barrier's release arrival waits for the thread's loads in flight and for
//   the TMA writes into the blocks' shared memory, so the block's only
//   cluster barriers come after the products, and the producer's arrivals
//   are relaxed.)
// - Products on wgmma m64n64k16, A (the normed x) in registers and B (the
//   warpgroup's half of the weight tile) MN-major in shared memory, f32
//   accumulators in registers. The products only keep up with the ring (4 of
//   them a warpgroup a 16 KB tile).
// - Reduction and epilogue in the cluster. Each block writes its f32 partial
//   tile into its own shared memory (over its x); after a cluster barrier,
//   block r reduces rows r, r + k, ... over the k partials in the fixed order
//   0..k-1 through distributed shared memory, one warp a row (the next row's
//   partials loaded while this one is finished), then adds the bias, runs the
//   per-head RMS qk-norm (a shuffle reduction over the head's lanes) and the
//   rope (the row staged in shared memory for the partner columns), and
//   stores bf16. A last cluster barrier, arrived at once a thread's reads of
//   the other blocks are done, keeps every block's shared memory alive until
//   the others have read it. No float atomics, no global workspace, one
//   launch: two launches give equal bits.
// - cos and sin once per (row, frequency) of the block's epilogue rows, into
//   a table while x is in flight: the f32 angle pos * inv_freq (as the plain
//   version forms it) is reduced by pi/2 in double (exact to far below an f32
//   ulp for the positions a cache holds, 131071 with YaRN included), then
//   single-precision minimax polynomials on |r| <= pi/4. The library's
//   sinf/cosf keep a local-memory frame for their slow path (Payne-Hanek),
//   which reads as local memory in the build report; __sinf is wrong at large
//   angles.
//
// Products on m64: at S <= 8 most of A's 64 rows are zero. Swapping A and B
// (the weights as M) would let N be S rounded up to 8, but the products are
// not what binds, and one layout for every S keeps the K-major A tiles in the
// layout TMA delivers and the epilogue row-major.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "flash_attn_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int COL_TILE = 128;   // output columns of a tile: 128 or 256 (a head lies in one)
constexpr int MAX_STAGES = 4;   // deepest ring the plan may take (it tries 4, 3, 2)
constexpr int KT = 64;          // rows of D a weight tile: one 128-byte swizzle box deep
constexpr int BOX_BYTES = 64 * KT * 2;  // a 64-column box of a tile, and an x box
constexpr int MAX_SPLITS = 8;   // the portable cluster size
constexpr int SPLIT_COST = 2;   // a block's fixed work (norm, exchange, epilogue) in weight tiles
// a split of D and a ring depth fixed at build time, 0 for sized on the host
// (scripts/torch_decode_qkv_bench.py --variants rebuilds with others)
constexpr int FORCE_SPLITS = 0;
constexpr int FORCE_STAGES = 0;
constexpr int MAX_SMEM = 232448;
constexpr int PRODUCER_THREADS = 32;
constexpr int WG_M = 2;  // consumer warpgroups an M tile, each a column half of the tile

template <int HD>
struct Cfg {
  static constexpr int BN = COL_TILE;  // columns of a tile
  static constexpr int BOXES = BN / 64;  // 64-column TMA boxes a tile
  static constexpr int TILE_BYTES = BOXES * BOX_BYTES;
  static constexpr int CPL = BN / 32;      // columns a lane holds in the epilogue: 4 or 8
  static constexpr int PSTR = BN + 8;      // f32 row stride of a partial tile (no bank conflicts)
  static constexpr int PART_BYTES = 64 * PSTR * 4;
  static constexpr int NB = BN / WG_M;     // columns a warpgroup's products take
  static_assert(NB == 64 || NB == 128, "a warpgroup takes one or two 64-column boxes");
  static_assert(BN % HD == 0, "a head lies in one tile");
};

// offsets into a block's dynamic shared memory (after its 1024-byte
// alignment): the same in every block of a cluster (distributed shared memory
// addresses are offsets), so sized by the largest D chunk, ceil(KT / k) tiles
struct Layout {
  int region;  // one M tile: its x boxes (the A operand), later its f32 partial
  int ring, nw, bias, qn, kn, ssq, rowbuf, trig, bars, bytes;
};

// tc: K tiles of the largest chunk; k: the split; rows: epilogue rows of a
// block, ceil(64 MT / k). The epilogue's row buffer and cos/sin table lie in
// the ring, free once the products are done.
template <int HD, int MT>
__host__ __device__ constexpr Layout layout(int tc, int stages, int k, int rows) {
  using C = Cfg<HD>;
  Layout l{};
  const int a = tc * BOX_BYTES, p = C::PART_BYTES;
  l.region = ((a > p ? a : p) + 1023) / 1024 * 1024;
  l.ring = MT * l.region;
  l.rowbuf = l.ring;                       // f32 [consumer warps][BN]: a row for the rope
  l.trig = l.rowbuf + 4 * WG_M * MT * C::BN * 4;  // float2 [rows][HD / 2]: cos, sin
  const int ring = stages * C::TILE_BYTES, epi = 4 * WG_M * MT * C::BN * 4 + rows * (HD / 2) * 8;
  l.nw = l.ring + (ring > epi ? ring : (epi + 15) / 16 * 16);  // bf16 [tc * 64]: norm_w
  l.bias = l.nw + tc * KT * 2;             // bf16 [BN]
  l.qn = l.bias + C::BN * 2;               // bf16 [HD]
  l.kn = l.qn + HD * 2;                    // bf16 [HD]
  l.ssq = l.kn + HD * 2;                   // f32 [k][64 MT]: every block's sums
  l.bars = (l.ssq + k * 64 * MT * 4 + 7) / 8 * 8;  // full, empty [MAX_STAGES], x, sums
  l.bytes = l.bars + (2 * MAX_STAGES + 2) * 8 + 1024;  // + the alignment slack
  return l;
}

struct Args {
  const bf16* norm_w;    // [D]
  const bf16* bias[3];   // q, k, v biases [ncols], or null
  const bf16* q_norm_w;  // [HD], null without qk-norm
  const bf16* k_norm_w;
  const int* pos;        // [S]
  const float* inv_freq;  // [rot / 2]
  bf16* out[3];          // q [S, NH*HD], k, v [S, NKV*HD]
  int* tiles;            // [groups, column tiles, k] weight tiles each block loaded, or null
  int ncols[3];          // columns of wq, wk, wv
  int ntiles[3];         // column tiles of each
  int n_ct;              // column tiles in all
  int S, D, kt, splits, stages, rot, qk_norm;
  float scaling, eps;
};

// ---- clusters ----------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// a whole warp arrives (release: its accesses before) and waits (acquire:
// every thread's accesses before its arrival)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// an arrival that publishes nothing: the producer's (a release there waited
// for the producer's own weight loads in flight, 2.7 us at Qwen3-0.6B's shape)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// the shared::cluster address of the same offset in block `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// a float into another block's shared memory, counted (4 bytes) on its mbarrier
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// N (4 or 8) floats from another block's shared memory, 16 bytes a load
template <int N>
__device__ __forceinline__ void ld_cluster_vec(float (&v)[N], uint32_t addr) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v[i]), "=f"(v[i + 1]), "=f"(v[i + 2]), "=f"(v[i + 3])
                 : "r"(addr + 4 * i)
                 : "memory");
}

// four 8x8 bf16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8): the register fragment of a 16x16 A tile
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// two bf16 (low half first) as floats
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// ---- sin and cos without the library's local-memory slow path ----------------

// sin and cos of the f32 angle `a`: reduced by pi/2 in double (k pi/2 in two
// parts, exact to far below an f32 ulp for |a| < 2^30), then single-precision
// minimax polynomials on |r| <= pi/4 (those of Cephes' sinf and cosf)
__device__ __forceinline__ void sin_cos(float a, float& s, float& c) {
  const double x = (double)a;
  const double k = rint(x * 0.63661977236758134308);  // 2 / pi
  const float r = (float)fma(-k, 6.1232339957367658e-17, fma(-k, 1.5707963267948966192, x));
  const float z = r * r;
  const float sr =
      fmaf(r * z, fmaf(fmaf(-1.9515295891e-4f, z, 8.3321608736e-3f), z, -1.6666654611e-1f), r);
  const float cr = fmaf(z * z,
                        fmaf(fmaf(2.443315711809948e-5f, z, -1.388731625493765e-3f), z,
                             4.166664568298827e-2f),
                        fmaf(-0.5f, z, 1.0f));
  const int q = (int)((long long)k & 3);
  s = q == 0 ? sr : q == 1 ? cr : q == 2 ? -sr : -cr;
  c = q == 0 ? cr : q == 1 ? -sr : q == 2 ? -cr : sr;
}

// ---- phase clocks (scripts/torch_decode_qkv_bench.py --timeline builds with
// DECODE_QKV_TIMELINE; the port's build compiles them out) ---------------------

#ifdef DECODE_QKV_TIMELINE
// clock64 at each mark, then globaltimer at entry and exit, then the SM
constexpr int MARKS = 17, WIDTH = MARKS + 3;
__device__ long long qkv_timeline[4096 * WIDTH];
// mark i by the calling thread if it is the recorder (`me`)
__device__ __forceinline__ void mark(int i, bool me = threadIdx.x == 0) {
  const size_t b = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  if (!me || b >= 4096) return;
  long long c, g;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(c));
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(g));
  qkv_timeline[b * WIDTH + i] = c;
  if (i == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(sm));
    qkv_timeline[b * WIDTH + MARKS] = g;
    qkv_timeline[b * WIDTH + MARKS + 2] = sm;
  }
  if (i == 12) qkv_timeline[b * WIDTH + MARKS + 1] = g;
}
#else
__device__ __forceinline__ void mark(int, bool = false) {}
#endif

// ---- the kernel ----------------------------------------------------------------

// two blocks an SM at one M tile (registers: at most 112 a thread)
template <int HD, int MT>
__global__ void __launch_bounds__(128 * WG_M * MT + PRODUCER_THREADS, MT == 1 ? 2 : 1)
decode_qkv_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_wq,
                  const __grid_constant__ CUtensorMap tm_wk,
                  const __grid_constant__ CUtensorMap tm_wv, const Args a) {
  using C = Cfg<HD>;
  constexpr int BN = C::BN, NB = C::NB, CPL = C::CPL;
  constexpr int CONSUMERS = 128 * WG_M * MT, WARPS = 4 * WG_M * MT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const int k = a.splits, stages = a.stages;
  const Layout L = layout<HD, MT>((a.kt + k - 1) / k, stages, k, (64 * MT + k - 1) / k);
  const int rank = (int)cluster_rank();
  const int ct = blockIdx.x / k, row0 = blockIdx.y * 64 * MT;
  const int nrows = min(64 * MT, a.S - row0);  // rows of this group below S
  const int which = ct < a.ntiles[0] ? 0 : ct < a.ntiles[0] + a.ntiles[1] ? 1 : 2;
  const int col0 = (ct - (which > 0 ? a.ntiles[0] : 0) - (which > 1 ? a.ntiles[1] : 0)) * BN;
  // this block's D chunk: K tiles [t0, t0 + tc)
  const int base = a.kt / k, extra = a.kt % k;
  const int tc = base + (rank < extra), t0 = rank * base + min(rank, extra);
  const uint32_t full_bar = sbase + L.bars, empty_bar = full_bar + 8 * MAX_STAGES;
  const uint32_t x_bar = empty_bar + 8 * MAX_STAGES, sum_bar = x_bar + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r2 = a.rot / 2;
  const CUtensorMap* tw = which == 0 ? &tm_wq : which == 1 ? &tm_wk : &tm_wv;
  mark(0);
  if (threadIdx.x == CONSUMERS) {  // the producer's lane 0: the maps' descriptors, early
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_x)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(tw)) : "memory");
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);          // the loads' expect_tx
      mbar_init(empty_bar + 8 * s, CONSUMERS);  // every consumer thread
    }
    mbar_init(x_bar, 1);
    mbar_init(sum_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect_tx(sum_bar, k * 64 * MT * 4);  // the sums every block pushes here
  }
  __syncthreads();
  if (threadIdx.x == CONSUMERS) {
    // x's boxes, and with them norm_w over the chunk, the tile's biases and
    // the qk-norm weights (bf16, by the bulk copy engine: sizes on 16 bytes,
    // as D and the projections' columns are multiples of 16)
    const uint32_t nw_bytes = min(tc * KT, a.D - t0 * KT) * 2;
    const bf16* bias = a.bias[which];
    const uint32_t bias_bytes = bias != nullptr ? min(BN, a.ncols[which] - col0) * 2 : 0;
    const uint32_t norm_bytes = a.qk_norm ? 2 * HD * 2 : 0;
    mbar_arrive_expect_tx(x_bar, MT * tc * BOX_BYTES + nw_bytes + bias_bytes + norm_bytes);
    for (int m = 0; m < MT; ++m)
      for (int t = 0; t < tc; ++t)
        tma_load_2d(sbase + m * L.region + t * BOX_BYTES, &tm_x, x_bar, (t0 + t) * KT,
                    row0 + 64 * m);
    bulk_load(sbase + L.nw, a.norm_w + t0 * KT, nw_bytes, x_bar);
    if (bias_bytes) bulk_load(sbase + L.bias, bias + col0, bias_bytes, x_bar);
    if (norm_bytes) {
      bulk_load(sbase + L.qn, a.q_norm_w, HD * 2, x_bar);
      bulk_load(sbase + L.kn, a.k_norm_w, HD * 2, x_bar);
    }
    mark(1, true);
  }
  __syncwarp();
  // every block's mbarriers initialized before any block pushes its sums into
  // them (relaxed: it need not wait for the loads just issued)
  cluster_arrive_relaxed();
  cluster_wait();
  mark(15);

  if (warp == WARPS) {
    // ---- producer warp: the weight tiles through the ring, then the cluster
    // barriers of the partial tiles and of the exit
    const int first = min(tc, stages);
    int loaded = 0;  // weight tiles this block loaded (`tiles`)
    auto load_tile = [&](int t) {
      ++loaded;
      const int stage = t % stages;
      const uint32_t bar = full_bar + 8 * stage;
      mbar_arrive_expect_tx(bar, C::TILE_BYTES);
#pragma unroll
      for (int b = 0; b < C::BOXES; ++b)
        tma_load_2d(sbase + L.ring + stage * C::TILE_BYTES + b * BOX_BYTES, tw, bar, col0 + 64 * b,
                    (t0 + t) * KT);
    };
    if (lane == 0) {
      for (int t = 0; t < first; ++t) load_tile(t);
      mark(2, true);
      for (int t = first; t < tc; ++t) {
        mbar_wait(empty_bar + 8 * (t % stages), ((t / stages) - 1) & 1);
        load_tile(t);
      }
      if (a.tiles != nullptr) a.tiles[((size_t)blockIdx.y * a.n_ct + ct) * k + rank] = loaded;
    }
    __syncwarp();
    mark(16, lane == 0);
    cluster_arrive_relaxed();  // 2: the partial tiles
    cluster_wait();
    cluster_arrive_relaxed();  // 3: every read of this block's shared memory done
    cluster_wait();
    return;
  }

  // ---- consumers: warpgroup wg holds the M tile m = wg / WG_M, rows [row0 +
  // 64 m, +64), and its products take the column half nh = wg % WG_M
  const int wg = warp / 4, m = wg / WG_M, nh = wg % WG_M;
  const int tid = threadIdx.x % (128 * WG_M);  // among the M tile's threads
  const bf16* bias_s = reinterpret_cast<const bf16*>(smem + L.bias);
  const bf16* qn_s = reinterpret_cast<const bf16*>(smem + L.qn);
  const bf16* kn_s = reinterpret_cast<const bf16*>(smem + L.kn);
  float* ssq_s = reinterpret_cast<float*>(smem + L.ssq);
  float2* trig = reinterpret_cast<float2*>(smem + L.trig);
  // this block's first positions and frequencies (entry e = (i, f):
  // frequency f of row rank + i k), loaded while x arrives and used after
  // the products (cold, they take until the weights are in)
  const int n_trig = which < 2 ? (64 * MT + k - 1) / k * r2 : 0;
  int pos_r[8];
  float freq_r[8];
  auto trig_inputs = [&](int e0) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * CONSUMERS, i = e / max(r2, 1), lr = rank + i * k;
      const bool in = e < n_trig && lr < nrows;
      pos_r[u] = in ? a.pos[row0 + lr] : 0;
      freq_r[u] = in ? a.inv_freq[e - i * r2] : 0.f;
    }
  };
  trig_inputs(threadIdx.x);
  {  // zeros where no copy writes: norm_w past D, biases past the projection (or none)
    bf16* nw_s = reinterpret_cast<bf16*>(smem + L.nw);
    for (int i = min(tc * KT, a.D - t0 * KT) + threadIdx.x; i < tc * KT; i += CONSUMERS)
      nw_s[i] = __float2bfloat16(0.f);
    const int biased = a.bias[which] != nullptr ? min(BN, a.ncols[which] - col0) : 0;
    for (int i = biased + threadIdx.x; i < BN; i += CONSUMERS)
      reinterpret_cast<bf16*>(smem + L.bias)[i] = __float2bfloat16(0.f);
  }

  // ---- the norm: the four threads (r, q) of the M tile take row r, chunks
  // 2q and 2q + 1 of each 128-byte row of each x box (16-byte chunks; a row's
  // chunk p is its logical chunk p ^ (r % 8), the 128-byte swizzle; each
  // thread starts at chunk r so that a warp's accesses meet no bank twice)
  unsigned char* xa = smem + m * L.region;
  const int r = tid / 4, q = tid % 4;
  mark(3);
  mbar_wait(x_bar, 0);
  mark(4);
  float ss = 0.f;
  for (int t = 0; t < tc; ++t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = (2 * q + i + r) & 7;
      const uint4 v = *reinterpret_cast<const uint4*>(xa + t * BOX_BYTES + r * 128 + p * 16);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = unpack_bf16(words[j]);
        ss = fmaf(f.x, f.x, ss);
        ss = fmaf(f.y, f.y, ss);
      }
    }
  }
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  mark(13);
  mark(14, threadIdx.x == 127);
  // the row's sum into slot `rank` of every block of the cluster, counted on
  // that block's mbarrier; then every block's sum, here, added in order
  if (q == 0) {
    const uint32_t slot = sbase + L.ssq + (rank * 64 * MT + 64 * m + r) * 4;
    for (int j = 0; j < k; ++j) st_async(mapa(slot, j), ss, mapa(sum_bar, j));
  }
  mbar_wait(sum_bar, 0);
  mark(5);
  // rstd of this thread's two rows of A's register fragments: fr and fr + 8
  // of the M tile (the sums of the k blocks added in the order 0..k-1)
  const int fr = 16 * (warp % 4) + lane / 4;
  float rstd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float total = ssq_s[64 * m + fr + 8 * h];
    for (int j = 1; j < k; ++j) total += ssq_s[j * 64 * MT + 64 * m + fr + 8 * h];
    rstd[h] = rsqrtf(total / (float)a.D + a.eps);
  }
  mark(6);

  // ---- products: acc[64 x NB] += A[64 x 64] W[64 x NB] a K tile, W the
  // warpgroup's column half of the tile (MN-major: +2048 bytes a k16 step,
  // its 64-column boxes BOX_BYTES apart, the leading byte offset). A is the
  // normed x in registers: each k16 step's fragment comes from the raw x box
  // by ldmatrix (lane l gives the address of row l % 8 + 8 (l / 8 % 2) of the
  // warp's 16, 16-byte chunk 2 kk + l / 16, swizzled), then bf16(x * rstd *
  // norm_w) in f32 per element: no pass over x rewrites it in shared memory,
  // and the normalization runs while the weights stream.
  const uint32_t lrow = 16 * (warp % 4) + lane % 8 + 8 * ((lane / 8) % 2);
  const uint32_t x_rows = sbase + m * L.region + lrow * 128;
  const unsigned char* nw_b = smem + L.nw + (2 * (lane % 4)) * 2;
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < tc; ++t) {
    uint32_t af[KT / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      ldmatrix_x4(af[kk], x_rows + t * BOX_BYTES + (((2 * kk + lane / 16) ^ (lane % 8)) * 16));
      // columns 16 kk + 2 (lane % 4) (+1) of a0/a1, 8 more of a2/a3
      const uint32_t* g = reinterpret_cast<const uint32_t*>(nw_b + (t * KT + 16 * kk) * 2);
      const float2 g0 = unpack_bf16(g[0]), g1 = unpack_bf16(g[4]);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float2 f = unpack_bf16(af[kk][x]), w = x < 2 ? g0 : g1;
        const float rs = rstd[x & 1];
        af[kk][x] = pack_bf16(f.x * rs * w.x, f.y * rs * w.y);
      }
    }
    const int stage = t % stages;
    mbar_wait(full_bar + 8 * stage, (t / stages) & 1);
    if (t == 0) mark(7);
    const uint64_t db = smem_desc(
        sbase + L.ring + stage * C::TILE_BYTES + nh * (NB / 64) * BOX_BYTES, BOX_BYTES, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) wgmma_rs<NB>(acc, af[kk], db + ((kk * 16 * 128) >> 4));
    wgmma_commit_and_wait();
    pin(acc);
    mbar_arrive(empty_bar + 8 * stage);
  }

  // ---- this warpgroup's f32 partial over its x (every wgmma of the block
  // is complete once all its consumers pass the barrier: the partials
  // overwrite the A tiles, the cos/sin table the ring)
  mark(8);
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + MT), "n"(CONSUMERS) : "memory");
  {
    float* pt = reinterpret_cast<float*>(xa);
    const int lr = 16 * (warp % 4) + lane / 4;
#pragma unroll
    for (int i = 0; i < NB / 8; ++i) {
      const int c = nh * NB + 8 * i + 2 * (lane % 4);
      *reinterpret_cast<float2*>(pt + lr * C::PSTR + c) = make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(pt + (lr + 8) * C::PSTR + c) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
  __syncwarp();
  cluster_arrive();  // 2
  // cos and sin of the epilogue rows while the cluster's partials come in
  for (int e0 = threadIdx.x; e0 < n_trig; e0 += 8 * CONSUMERS) {
    if (e0 != threadIdx.x) trig_inputs(e0);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * CONSUMERS;
      if (e < n_trig) {
        float sn, cs;
        sin_cos((float)pos_r[u] * freq_r[u], sn, cs);
        trig[e] = make_float2(cs * a.scaling, sn * a.scaling);
      }
    }
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + MT), "n"(CONSUMERS) : "memory");  // the table
  cluster_wait();
  mark(9);

  // ---- epilogue: block `rank` takes rows rank + i k of the group (i = warp,
  // warp + WARPS, ...), one warp a row, lane l the columns [CPL l, CPL l +
  // CPL) of the tile; the next row's partials load while this one finishes
  float* rb = reinterpret_cast<float*>(smem + L.rowbuf) + warp * BN;
  const int c = lane * CPL;
  const bool valid = col0 + c < a.ncols[which];
  constexpr int LPH = HD / CPL;  // lanes a head
  const bf16* hn = which == 0 ? qn_s : kn_s;
  auto load = [&](float (&pj)[MAX_SPLITS][CPL], int lr) {
    const uint32_t src = sbase + (lr / 64) * L.region + ((lr % 64) * C::PSTR + c) * 4;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j)
      if (j < k) ld_cluster_vec<CPL>(pj[j], mapa(src, j));
  };
  float cur[MAX_SPLITS][CPL], nxt[MAX_SPLITS][CPL];
  bool arrived = false;
  int i = warp;
  if (rank + i * k < nrows) load(cur, rank + i * k);
  for (; rank + i * k < nrows; i += WARPS) {
    const int lr = rank + i * k;
    const bool more = lr + WARPS * k < nrows;
    if (more) load(nxt, lr + WARPS * k);
    float v[CPL];
#pragma unroll
    for (int e = 0; e < CPL; ++e) v[e] = cur[0][e];
#pragma unroll
    for (int j = 1; j < MAX_SPLITS; ++j) {
      if (j < k) {
#pragma unroll
        for (int e = 0; e < CPL; ++e) v[e] += cur[j][e];
      }
    }
    if (!more) {  // this thread's last read of another block's memory is done
      cluster_arrive();  // 3
      arrived = true;
    }
    if (i == warp) mark(10);
#pragma unroll
    for (int e = 0; e < CPL; ++e) v[e] += __bfloat162float(bias_s[c + e]);
    if (which < 2) {
      if (a.qk_norm) {
        float s2 = 0.f;
#pragma unroll
        for (int e = 0; e < CPL; ++e) s2 = fmaf(v[e], v[e], s2);
#pragma unroll
        for (int o = LPH / 2; o > 0; o >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        const float rs = rsqrtf(s2 / (float)HD + a.eps);
#pragma unroll
        for (int e = 0; e < CPL; ++e) v[e] = v[e] * rs * __bfloat162float(hn[(c + e) % HD]);
      }
      if (r2 > 0) {
#pragma unroll
        for (int e = 0; e < CPL; ++e) rb[c + e] = v[e];
        __syncwarp();
        const float2* tr = trig + i * r2;
#pragma unroll
        for (int e = 0; e < CPL; ++e) {
          const int hc = (c + e) % HD;
          if (hc < a.rot) {
            const bool lo = hc < r2;
            const float2 cs = tr[lo ? hc : hc - r2];
            const float partner = rb[lo ? c + e + r2 : c + e - r2];
            v[e] = lo ? v[e] * cs.x - partner * cs.y : v[e] * cs.x + partner * cs.y;
          }
        }
        __syncwarp();
      }
    }
    if (valid) {
      bf16* dst = a.out[which] + (size_t)(row0 + lr) * a.ncols[which] + col0 + c;
      uint32_t o[CPL / 2];
#pragma unroll
      for (int e = 0; e < CPL; e += 2) o[e / 2] = pack_bf16(v[e], v[e + 1]);
      if constexpr (CPL == 4)
        *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    }
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
#pragma unroll
      for (int e = 0; e < CPL; ++e) cur[j][e] = nxt[j][e];
    }
  }
  __syncwarp();
  if (!arrived) cluster_arrive();  // 3: no block leaves while another reads its memory
  mark(11);
  cluster_wait();
  mark(12);
}

// ---- host side ---------------------------------------------------------------

// blocks of 64 rows a block holds: 1 up to 64 rows, 2 above
int m_tiles(int S) { return S <= 64 ? 1 : 2; }

template <int HD, int MT>
cudaError_t configure() {
  static bool done = false;
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(decode_qkv_kernel<HD, MT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

// clusters of k blocks that the card holds at once at this shared memory
template <int HD, int MT>
int active_clusters(int k, int smem) {
  struct Entry {
    int k, smem, n;
  };
  static Entry cache[256];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].k == k && cache[i].smem == smem) return cache[i].n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, 1, 1);
  cfg.blockDim = dim3(128 * WG_M * MT + PRODUCER_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = k;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, decode_qkv_kernel<HD, MT>, &cfg) != cudaSuccess) {
    cudaGetLastError();
    n = 0;
  }
  if (used < 256) cache[used++] = Entry{k, smem, n};
  return n;
}

struct Plan {
  int splits, stages, groups, n_ct, mt, smem, clusters;
};

// the split of D and the ring's depth: the least waves x (K tiles a block +
// SPLIT_COST) over those whose shared memory fits, a wave being the clusters
// the card holds at once; ties to the smaller split, then the deeper ring
template <int HD, int MT>
cudaError_t search(int groups, int kt, int n_ct, Plan* p) {
  cudaError_t err = configure<HD, MT>();
  if (err != cudaSuccess) return err;
  p->mt = MT;
  p->groups = groups;
  p->n_ct = n_ct;
  p->splits = 0;
  long best = -1;
  for (int k = 1; k <= min(MAX_SPLITS, kt); ++k) {
    if (FORCE_SPLITS > 0 && k != FORCE_SPLITS) continue;
    const int tc = (kt + k - 1) / k;
    for (int stages = MAX_STAGES; stages >= 2; --stages) {
      if (FORCE_STAGES > 0 && stages != FORCE_STAGES) continue;
      // at least a third of the SM's shared memory: at most two blocks an SM
      // (three made the norm's passes and the reduction of each SM longer
      // than the weights they save: Qwen3-0.6B at split 8, 0.0212 against
      // 0.0193 ms at split 6)
      const int smem = max(layout<HD, MT>(tc, stages, k, (64 * MT + k - 1) / k).bytes,
                           MAX_SMEM / 3 + 1024);
      if (smem > MAX_SMEM) continue;
      const int n = active_clusters<HD, MT>(k, smem);
      if (n <= 0) continue;
      const long waves = ((long)p->n_ct * p->groups + n - 1) / n;
      const long cost = waves * (tc + SPLIT_COST);
      if (best < 0 || cost < best) {
        best = cost;
        p->splits = k;
        p->stages = stages;
        p->smem = smem;
        p->clusters = n;
      }
    }
  }
  return p->splits > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// the plan of these shapes, searched once: a decode step asks for the same
// one at every layer, and a search makes up to 24 occupancy queries
template <int HD, int MT>
cudaError_t plan(int S, int D, const int (&ntiles)[3], Plan* p) {
  struct Entry {
    int groups, kt, n_ct;
    Plan plan;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex mu;
  const int groups = (S + 64 * MT - 1) / (64 * MT), kt = (D + KT - 1) / KT;
  const int n_ct = ntiles[0] + ntiles[1] + ntiles[2];
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (cache[i].groups == groups && cache[i].kt == kt && cache[i].n_ct == n_ct) {
      *p = cache[i].plan;
      return cudaSuccess;
    }
  }
  cudaError_t err = search<HD, MT>(groups, kt, n_ct, p);
  if (err == cudaSuccess && used < 64) cache[used++] = Entry{groups, kt, n_ct, *p};
  return err;
}

template <int HD, int MT>
cudaError_t launch(const void* x, const void* wq, const void* wk, const void* wv, Args a,
                   cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan<HD, MT>(a.S, a.D, a.ntiles, &p);
  if (err != cudaSuccess) return err;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tx, tq, tk, tv;
  const auto stream_once = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
  if (!matrix_map(&tx, encode, x, a.D, a.S, 64, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !matrix_map(&tq, encode, wq, a.ncols[0], a.D, KT, stream_once) ||
      !matrix_map(&tk, encode, wk, a.ncols[1], a.D, KT, stream_once) ||
      !matrix_map(&tv, encode, wv, a.ncols[2], a.D, KT, stream_once))
    return cudaErrorInvalidValue;
  a.splits = p.splits;
  a.stages = p.stages;
  a.n_ct = p.n_ct;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_ct * p.splits, p.groups, 1);
  cfg.blockDim = dim3(128 * WG_M * MT + PRODUCER_THREADS, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_qkv_kernel<HD, MT>, tx, tq, tk, tv, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool shapes(int S, int D, int NH, int NKV, int HD, int ntiles[3]) {
  if (S < 0 || D <= 0 || D % 16 || NH <= 0 || NKV <= 0 || (HD != 32 && HD != 64 && HD != 128))
    return false;
  ntiles[0] = (NH * HD + COL_TILE - 1) / COL_TILE;
  ntiles[1] = ntiles[2] = (NKV * HD + COL_TILE - 1) / COL_TILE;
  return true;
}

int run(const void* x, const void* norm_w, const void* wq, const void* wk, const void* wv,
        const void* q_bias, const void* k_bias, const void* v_bias, const void* q_norm_w,
        const void* k_norm_w, const void* pos, const void* inv_freq, void* q_out, void* k_out,
        void* v_out, int S, int D, int NH, int NKV, int HD, int rot, float scaling, float eps,
        int qk_norm, void* stream, int* tiles) {
  Args a{};
  if (!shapes(S, D, NH, NKV, HD, a.ntiles) || rot < 0 || rot % 2 || rot > HD ||
      (qk_norm && (q_norm_w == nullptr || k_norm_w == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  a.norm_w = static_cast<const bf16*>(norm_w);
  a.bias[0] = static_cast<const bf16*>(q_bias);
  a.bias[1] = static_cast<const bf16*>(k_bias);
  a.bias[2] = static_cast<const bf16*>(v_bias);
  a.q_norm_w = static_cast<const bf16*>(q_norm_w);
  a.k_norm_w = static_cast<const bf16*>(k_norm_w);
  a.pos = static_cast<const int*>(pos);
  a.inv_freq = static_cast<const float*>(inv_freq);
  a.out[0] = static_cast<bf16*>(q_out);
  a.out[1] = static_cast<bf16*>(k_out);
  a.out[2] = static_cast<bf16*>(v_out);
  a.tiles = tiles;
  a.ncols[0] = NH * HD;
  a.ncols[1] = a.ncols[2] = NKV * HD;
  a.S = S;
  a.D = D;
  a.kt = (D + KT - 1) / KT;
  a.rot = rot;
  a.qk_norm = qk_norm;
  a.scaling = scaling;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mt = m_tiles(S);
  cudaError_t err;
  if (HD == 32)
    err = mt == 1 ? launch<32, 1>(x, wq, wk, wv, a, st) : launch<32, 2>(x, wq, wk, wv, a, st);
  else if (HD == 64)
    err = mt == 1 ? launch<64, 1>(x, wq, wk, wv, a, st) : launch<64, 2>(x, wq, wk, wv, a, st);
  else
    err = mt == 1 ? launch<128, 1>(x, wq, wk, wv, a, st) : launch<128, 2>(x, wq, wk, wv, a, st);
  return (int)err;
}

}  // namespace

extern "C" int decode_qkv_prep(const void* x, const void* norm_w, const void* wq, const void* wk,
                               const void* wv, const void* q_bias, const void* k_bias,
                               const void* v_bias, const void* q_norm_w, const void* k_norm_w,
                               const void* pos, const void* inv_freq, void* q_out, void* k_out,
                               void* v_out, int S, int D, int NH, int NKV, int HD, int rot,
                               float scaling, float eps, int qk_norm, void* stream) {
  return run(x, norm_w, wq, wk, wv, q_bias, k_bias, v_bias, q_norm_w, k_norm_w, pos, inv_freq,
             q_out, k_out, v_out, S, D, NH, NKV, HD, rot, scaling, eps, qk_norm, stream, nullptr);
}

// the same launch, also writing the weight tiles (64 rows of D x one column
// tile) each block loaded into `tiles`: int32 [row groups, column tiles,
// splits], one slot a block (no atomics)
extern "C" int decode_qkv_prep_tiles(const void* x, const void* norm_w, const void* wq,
                                     const void* wk, const void* wv, const void* q_bias,
                                     const void* k_bias, const void* v_bias,
                                     const void* q_norm_w, const void* k_norm_w, const void* pos,
                                     const void* inv_freq, void* q_out, void* k_out, void* v_out,
                                     int S, int D, int NH, int NKV, int HD, int rot,
                                     float scaling, float eps, int qk_norm, void* stream,
                                     void* tiles) {
  return run(x, norm_w, wq, wk, wv, q_bias, k_bias, v_bias, q_norm_w, k_norm_w, pos, inv_freq,
             q_out, k_out, v_out, S, D, NH, NKV, HD, rot, scaling, eps, qk_norm, stream,
             static_cast<int*>(tiles));
}

// the launch these shapes get: plan = {splits, ring stages, row groups,
// column tiles, M tiles a block, dynamic shared memory a block, clusters the
// card holds at once at that shared memory}
extern "C" int decode_qkv_plan(int S, int D, int NH, int NKV, int HD, int* out) {
  int ntiles[3];
  if (!shapes(S, D, NH, NKV, HD, ntiles) || S == 0) return (int)cudaErrorInvalidValue;
  Plan p;
  const int mt = m_tiles(S);
  cudaError_t err = HD == 32   ? (mt == 1 ? plan<32, 1>(S, D, ntiles, &p)
                                          : plan<32, 2>(S, D, ntiles, &p))
                    : HD == 64 ? (mt == 1 ? plan<64, 1>(S, D, ntiles, &p)
                                          : plan<64, 2>(S, D, ntiles, &p))
                               : (mt == 1 ? plan<128, 1>(S, D, ntiles, &p)
                                          : plan<128, 2>(S, D, ntiles, &p));
  if (err != cudaSuccess) return (int)err;
  out[0] = p.splits;
  out[1] = p.stages;
  out[2] = p.groups;
  out[3] = p.n_ct;
  out[4] = p.mt;
  out[5] = p.smem;
  out[6] = p.clusters;
  return 0;
}

#ifdef DECODE_QKV_TIMELINE
// the phase clocks of the last launch's first n values (WIDTH a block)
extern "C" int decode_qkv_timeline(void* dst, size_t n) {
  return (int)cudaMemcpyFromSymbol(dst, qkv_timeline, n * sizeof(long long));
}
#endif

// the compiled kernel of head dim `hd` with `mt` M tiles a block as the
// runtime loaded it: attrs = {registers a thread, local memory a thread in
// bytes (spills; 0 when none), static shared memory in bytes, threads a block}
extern "C" int decode_qkv_attributes(int hd, int mt, int* attrs) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  if (hd == 32 && mt == 1) err = cudaFuncGetAttributes(&attr, decode_qkv_kernel<32, 1>);
  if (hd == 32 && mt == 2) err = cudaFuncGetAttributes(&attr, decode_qkv_kernel<32, 2>);
  if (hd == 64 && mt == 1) err = cudaFuncGetAttributes(&attr, decode_qkv_kernel<64, 1>);
  if (hd == 64 && mt == 2) err = cudaFuncGetAttributes(&attr, decode_qkv_kernel<64, 2>);
  if (hd == 128 && mt == 1) err = cudaFuncGetAttributes(&attr, decode_qkv_kernel<128, 1>);
  if (hd == 128 && mt == 2) err = cudaFuncGetAttributes(&attr, decode_qkv_kernel<128, 2>);
  if (err != cudaSuccess) return (int)err;
  attrs[0] = attr.numRegs;
  attrs[1] = (int)attr.localSizeBytes;
  attrs[2] = (int)attr.sharedSizeBytes;
  attrs[3] = attr.maxThreadsPerBlock;
  return 0;
}
