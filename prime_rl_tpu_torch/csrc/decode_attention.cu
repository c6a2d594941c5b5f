// K4: fused paged decode attention with KV-cache append for Hopper (sm_90a).
//
// Replaces the TPU kernel prime_rl_tpu/ops/decode_attention.py `_kernel`
// (pallas_call in `decode_paged_attention`). For each slot s, with n =
// lengths[s] tokens already cached: store the new token's k/v at position n
// of the slot's paged pool (page page_table[s, n / PS], clamped to the table,
// row n % PS), then attend the slot's GQA group of query heads over the
// cached rows [lo, n) plus the new token, softmax in f32, scale hd^-0.5
// unless given. lo = max(n + 1 - window, 0) with a sliding window (the window
// counts the new token), else 0. Attention sinks (f32 [NH], one logit per q
// head; null = none) join the denominator after the new token's term, as a
// virtual key of value 0. Pools are [NKV, NP, PS, HD] bf16, updated in place.
//
// What bounds it on the H100: every attended k/v row is read once and each
// row costs 4*HD flops per query head, about 2 flops a byte at GQA group 2
// (Qwen3-0.6B) and 8 at group 8 (gpt-oss), far below the ~295 at which the
// tensor cores would bind. So the bound is the bytes of the cached rows, and
// the design is about keeping enough of them in flight on every SM:
//
// - Split-K over the attended rows. A work item is (kv head, slot, split j);
//   split j covers rows [lo + j*C, min(lo + (j+1)*C, n)), C = SPLIT_ROWS. The
//   grid (NKV, S, ceil(P*PS / C)) follows from the shapes alone: the host never
//   reads `lengths` (no sync), blocks beyond a slot's splits return at once,
//   and the split boundaries depend on lengths, window and C only, never on
//   the SM count. Long slots no longer set the pace on a few SMs. (Blocks
//   with nothing to read sit at the grid's end: placed before a slot's last
//   split, so that the short items run last, they held those items back and
//   made the kernel slower.)
// - Tiles staged asynchronously. K and V tiles of TILE rows go through a ring
//   of STAGES stages in shared memory by 16-byte cp.async copies (zero-filled
//   past the split's last row: no row outside [lo, n) is ever read, so stale
//   or poisoned pool rows never reach a product; row n is never read, so the
//   append cannot race the reads). Rows are swizzled by 16-byte chunk (chunk
//   c of row r at c ^ (r % 8)) so that ldmatrix reads no bank twice. The
//   block reads its split's page-table entries into shared memory once.
// - One softmax step a tile. Products go through mma.sync m16n8k16 (bf16 in,
//   f32 out) with the keys as its 16 rows and the G <= 8 query heads as its 8
//   columns, so no accumulator holds a padding row: S^T = K Q^T with K's A
//   fragments by ldmatrix and Q's B fragments in registers (loaded once).
//   Each warp takes 16 rows of each tile and keeps one running max, sum and
//   output a head: one max over the rows (three shuffles across the lanes
//   that hold a head), one rescale, then O^T += V^T P^T with V^T's A
//   fragments by ldmatrix.trans and P^T's B fragments the score registers,
//   bf16 and transposed in registers by movmatrix. No per-row shuffle chain.
//   Not wgmma: its 64-row M would hold 16 keys a warp at best, and the
//   products are not what binds (a build that skips them all is 2-3% faster).
// - Constants (measured on the H100, scripts/torch_decode_attn_bench.py and
//   its variants): C = 256 rows, tiles of 64 rows, 2 stages, 4 warps; 3
//   blocks an SM at head dim 128 (the ring's 64 KB), 6 at 64, 1 at 256 (the
//   ring's 128 KB; not tuned). Deeper rings,
//   larger tiles, more or smaller blocks, C of 128 and L2 prefetch hints were
//   all as fast or slower: the steady state runs near the card's read rate,
//   and what is left is the tail of the last items and each item's first tile.
// - Any GQA group. A block takes the query heads of one chunk of its kv
//   head's group: W = min(8, next power of two of G) heads a chunk, ceil(G / W)
//   chunks (G = 12: chunks of 8 and 4), so the grid is (NKV * chunks, S,
//   splits) and each chunk runs the G <= 8 product above, its 8 columns
//   padding the chunk past its heads. Groups 1, 2, 4 and 8 are one chunk, as
//   they were. Each chunk reads its kv head's rows itself (twice at G = 12):
//   the bytes bound it, so the chunks of a head could share the tiles in a
//   later form.
// - Deterministic combine. The block merges its four warps in order 0..3. A
//   slot whose rows fit one split finishes in that block (new token, sinks,
//   bf16 out). Otherwise each split writes its f32 partial (m, l, acc[HD]) a
//   query head into a workspace the wrapper allocates and draws a ticket from
//   a counter of its (slot, kv head, chunk); the block that draws the last one folds
//   the splits in the fixed order 0..k-1, then the new token's term (from
//   k_new/v_new) and the sinks, and sets the counter back to zero. No second
//   launch, no atomics on floats: two launches on the same inputs give equal
//   bits, whichever block comes last. Where no slot can have two splits
//   (P*PS <= C, or a window of at most C + 1 rows) the grid has one item a
//   slot and needs neither workspace nor counters.
//
// The append is a plain row store by split 0 of chunk 0 (the TPU kernel's 8-row
// read-modify-write exists only because its memory tiling forbids single-row
// DMA). Inactive slots (page-table rows all 0) write into the reserved null
// page 0, whose contents no active slot reads.
//
// `decode_paged_attention_rows` is the same launch that also writes the rows
// each item read (int32 [S, NKV * chunks, max_splits], one slot an item: no
// atomics; each chunk counts the rows it read): ops/decode_attention.
// decode_rows_visited is its plain mirror.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int SPLIT_ROWS = 256;  // C: cached rows a work item covers
// ring stages and rows a stage holds (K and V), by head dim
constexpr int TILE_64 = 64, STAGES_64 = 2;
constexpr int TILE_128 = 64, STAGES_128 = 2;
// at head dim 256 a 64-row tile of K and V is 64 KB: two stages fill 128 KB,
// one block an SM (16 rows a warp is the depth of P.V, so no smaller tile)
constexpr int TILE_256 = 64, STAGES_256 = 2;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_CHUNK = 8;  // query heads a block: the 8 columns of a product
constexpr float LOG2E = 1.4426950408889634f;
#define MASKED __int_as_float(0xff800000)  // -inf: the score of a row outside the split

template <int HD>
struct Cfg {
  static constexpr int TILE = HD == 64 ? TILE_64 : HD == 128 ? TILE_128 : TILE_256;
  static constexpr int STAGES = HD == 64 ? STAGES_64 : HD == 128 ? STAGES_128 : STAGES_256;
  static constexpr int WARP_ROWS = TILE / NWARPS;  // a multiple of 16, the depth of P.V
  static constexpr int CHUNKS = HD / 8;               // 16-byte chunks a row
  static constexpr int TILE_BYTES = TILE * HD * 2;    // one of K, V
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // K then V
  static constexpr int SMEM = STAGES * STAGE_BYTES;
};

struct Args {
  const bf16* q;       // [S, NH, HD]
  const bf16* k_new;   // [S, NKV, HD]
  const bf16* v_new;
  bf16* k_pool;        // [NKV, NP, PS, HD]
  bf16* v_pool;
  const int* lengths;  // [S]
  const int* table;    // [S, P]
  const float* sinks;  // [NH] or null
  bf16* out;           // [S, NH, HD]
  float* work;         // acc [S, NH, MS, HD] then (m, l) [S, NH, MS, 2]; null: one split
  int* tickets;        // [S, NKV, NC] splits finished, 0 before and after a launch
  int* rows;           // [S, NKV, NC, MS] rows read by each item, or null
  int S, NH, NKV, NP, PS, P, MS;
  int G, NC;           // the GQA group, and the chunks of at most W heads it is cut into
  float scale_log2;    // softmax scale * log2(e): scores in base 2
  int window;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `valid` false writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 out
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 8 x 8 bf16 matrix whose row lane/4 holds columns 2*(lane%4) + {0, 1} in
// x, transposed across the warp (the same layout of the transpose)
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared-memory address of 16-byte chunk `chunk` of row `row` of a swizzled tile
template <int HD>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int row, int chunk) {
  return base + row * (HD * 2) + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ int window_lo(int n, int window) {
  return window > 0 ? max(n + 1 - window, 0) : 0;
}

// splits of a slot: at least one (it appends and takes the new token), at
// most the grid's; `work` null means the host gave no workspace (one split a slot)
__device__ __forceinline__ int split_count(const Args& a, int n, int lo) {
  return min(max(1, (n - lo + SPLIT_ROWS - 1) / SPLIT_ROWS), a.work ? a.MS : 1);
}

// scores (base 2) of the new token for the chunk's gc query heads, from
// head qh0 on -> s_new[gc]
template <int HD>
__device__ __forceinline__ void new_token_scores(const Args& a, int s, int h, int qh0, int gc,
                                                 float* s_new) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* kn = a.k_new + ((size_t)s * a.NKV + h) * HD;
  for (int g = warp; g < gc; g += NWARPS) {
    const bf16* qg = a.q + ((size_t)s * a.NH + qh0 + g) * HD;
    float d = 0.f;
#pragma unroll
    for (int e = lane; e < HD; e += 32) d += __bfloat162float(qg[e]) * __bfloat162float(kn[e]);
    d = warp_sum(d);
    if (lane == 0) s_new[g] = d * a.scale_log2;
  }
}

// o = (acc plus the new token's term, then the sink) / their denominator;
// m, s_new and the sink in base 2; m = -inf with l = acc = 0 when no cached
// row was attended
__device__ __forceinline__ float finish(const Args& a, float m, float l, float acc, float s_new,
                                        float v_new, int head) {
  const float m_f = fmaxf(m, s_new);
  const float alpha = ex2(m - m_f), p = ex2(s_new - m_f);
  l = l * alpha + p;
  acc = acc * alpha + p * v_new;
  if (a.sinks != nullptr) {
    const float sink = a.sinks[head] * LOG2E;
    const float m2 = fmaxf(m_f, sink), c = ex2(m_f - m2);
    l = l * c + ex2(sink - m2);
    acc *= c;
  }
  return acc / l;
}

// blocks an SM that the registers must allow: 3 fit the 64 KB ring at head
// dim 128; at 64 the 32 KB ring allows 7, and 6 (80 registers, no spill)
// measured faster than 4 or 5; 1 fits the 128 KB ring at 256
constexpr int MIN_BLOCKS_64 = 6, MIN_BLOCKS_128 = 3, MIN_BLOCKS_256 = 1;

template <int HD>
constexpr int min_blocks() {
  return HD == 64 ? MIN_BLOCKS_64 : HD == 128 ? MIN_BLOCKS_128 : MIN_BLOCKS_256;
}

// G: the heads a chunk holds (W above); a chunk may hold fewer (gc)
template <int HD, int G>
__global__ void __launch_bounds__(NTHREADS, min_blocks<HD>())
decode_split_kernel(const Args a) {
  using C = Cfg<HD>;
  constexpr int TILE = C::TILE, STAGES = C::STAGES, WARP_ROWS = C::WARP_ROWS;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int pages[SPLIT_ROWS + 1];  // the table entries of this split's rows
  __shared__ float s_new[G];
  __shared__ int warp_rows[NWARPS];  // rows each warp's threads copied
  __shared__ bool last;

  const int h = blockIdx.x / a.NC, chunk = blockIdx.x % a.NC, s = blockIdx.y;
  const int qh0 = h * a.G + chunk * G;      // the chunk's first query head
  const int gc = min(G, a.G - chunk * G);  // and its heads
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = a.lengths[s];
  const int lo = window_lo(n, a.window);
  const int splits = split_count(a, n, lo);
  // split j is block z = j: blocks are dispatched in z order, so the blocks
  // past every slot's splits come last and return at once
  const int j = blockIdx.z;
  const size_t block_item = ((size_t)s * a.NKV + h) * a.NC + chunk;  // (slot, kv head, chunk)
  int* rows_out = a.rows == nullptr ? nullptr : a.rows + block_item * a.MS + j;
  if (j >= splits) {
    if (rows_out != nullptr && tid == 0) *rows_out = 0;
    return;
  }
  const int* table = a.table + (size_t)s * a.P;
  const size_t new_off = ((size_t)s * a.NKV + h) * HD;
  if (j == 0 && chunk == 0) {  // the append: a plain row store of the new token at position n
    const int page = table[min(n / a.PS, a.P - 1)];
    const size_t dst = (((size_t)h * a.NP + page) * a.PS + n % a.PS) * HD;
    for (int c = tid; c < HD / 8; c += NTHREADS) {
      reinterpret_cast<uint4*>(a.k_pool + dst)[c] = reinterpret_cast<const uint4*>(a.k_new + new_off)[c];
      reinterpret_cast<uint4*>(a.v_pool + dst)[c] = reinterpret_cast<const uint4*>(a.v_new + new_off)[c];
    }
  }

  const int r0 = lo + j * SPLIT_ROWS, r1 = min(r0 + SPLIT_ROWS, n);
  const int p0 = r0 / a.PS;
  const int n_pages = r1 > r0 ? (r1 - 1) / a.PS - p0 + 1 : 0;
  for (int i = tid; i < n_pages; i += NTHREADS) pages[i] = table[min(p0 + i, a.P - 1)];
  __syncthreads();

  const size_t head_off = (size_t)h * a.NP * a.PS * HD;
  const bf16* kbase = a.k_pool + head_off;
  const bf16* vbase = a.v_pool + head_off;
  const uint32_t sbase = smem_u32(smem);
  const int n_tiles = (r1 - r0 + TILE - 1) / TILE;  // 0 when no cached row is attended
  int my_rows = 0;

  // tile t of the split (rows r0 + t*TILE ...) into ring stage t % STAGES;
  // rows at or past r1 are zero-filled, never read
  auto load = [&](int t) {
    const uint32_t kst = sbase + (t % STAGES) * C::STAGE_BYTES, vst = kst + C::TILE_BYTES;
    const int row0 = r0 + t * TILE;
#pragma unroll
    for (int u = 0; u < TILE * C::CHUNKS / NTHREADS; ++u) {
      const int c = tid + u * NTHREADS;
      const int r = c / C::CHUNKS, ch = c % C::CHUNKS, row = row0 + r;
      const bool valid = row < r1;
      size_t off = 0;
      if (valid) {
        off = ((size_t)pages[row / a.PS - p0] * a.PS + row % a.PS) * HD + ch * 8;
        my_rows += ch == 0;
      }
      cp_async16(tile_addr<HD>(kst, r, ch), kbase + off, valid);
      cp_async16(tile_addr<HD>(vst, r, ch), vbase + off, valid);
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load(t);
    cp_async_commit();
  }

  // B fragments of the queries (k = dims, n = heads): head lane/4 (zero past
  // gc), dims 16*kk + 2*(lane%4) + {0, 1} (b0) and + 8 (b1)
  uint32_t qb[HD / 16][2];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    qb[kk][0] = qb[kk][1] = 0u;
    if ((lane >> 2) < gc) {
      const bf16* qp =
          a.q + ((size_t)s * a.NH + qh0 + (lane >> 2)) * HD + 16 * kk + 2 * (lane & 3);
      qb[kk][0] = *reinterpret_cast<const uint32_t*>(qp);
      qb[kk][1] = *reinterpret_cast<const uint32_t*>(qp + 8);
    }
  }

  // the keys are the 16 rows (M) of each product and the heads its 8 columns
  // (N), so no accumulator holds padding at G = 8. This thread's heads are
  // hq + {0, 1}: a running max (base 2) and its share of the sum each, and
  // out[hq + e][16*p + lane/4 (+ 8)] in o[p][e (+ 2)]
  const int hq = 2 * (lane & 3);
  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
  float o[HD / 16][4];
#pragma unroll
  for (int p = 0; p < HD / 16; ++p) o[p][0] = o[p][1] = o[p][2] = o[p][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed for every thread; stage (t - 1) % STAGES is free
    if (t + STAGES - 1 < n_tiles) load(t + STAGES - 1);
    cp_async_commit();
    const uint32_t kst = sbase + (t % STAGES) * C::STAGE_BYTES, vst = kst + C::TILE_BYTES;
#pragma unroll
    for (int kr = 0; kr < WARP_ROWS / 16; ++kr) {
      const int wrow = warp * WARP_ROWS + 16 * kr;  // this warp's 16 rows of the tile
      const int row0 = r0 + t * TILE + wrow;
      if (row0 >= r1) break;

      // S^T[16 rows x 8 heads] = K Q^T: K's A fragments by ldmatrix, one k16 step each
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ka[4];
        ldsm_x4(tile_addr<HD>(kst, wrow + (lane & 7) + 8 * ((lane >> 3) & 1),
                              2 * kk + (lane >> 4)),
                ka);
        mma16816(sc, ka, qb[kk][0], qb[kk][1]);
      }

      // one softmax step: rows lane/4 (sc[0..1]) and lane/4 + 8 (sc[2..3]) of
      // heads hq + {0, 1}; a head's max over the 16 rows takes three shuffles
      // across the 8 lanes that hold it, then one rescale
      const bool v0 = row0 + (lane >> 2) < r1, v1 = row0 + (lane >> 2) + 8 < r1;
      sc[0] = v0 ? sc[0] * a.scale_log2 : MASKED;
      sc[1] = v0 ? sc[1] * a.scale_log2 : MASKED;
      sc[2] = v1 ? sc[2] * a.scale_log2 : MASKED;
      sc[3] = v1 ? sc[3] * a.scale_log2 : MASKED;
      float alpha[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float tmax = fmaxf(sc[e], sc[2 + e]);
#pragma unroll
        for (int x = 4; x <= 16; x <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, x));
        const float m_new = fmaxf(m[e], tmax);  // finite: the warp's first row is valid
        alpha[e] = ex2(m[e] - m_new);
        m[e] = m_new;
        sc[e] = ex2(sc[e] - m_new);
        sc[2 + e] = ex2(sc[2 + e] - m_new);
        l[e] = l[e] * alpha[e] + (sc[e] + sc[2 + e]);
      }
#pragma unroll
      for (int p = 0; p < HD / 16; ++p) {
        o[p][0] *= alpha[0];
        o[p][1] *= alpha[1];
        o[p][2] *= alpha[0];
        o[p][3] *= alpha[1];
      }

      // O^T += V^T P^T: P^T's B fragments are the score registers transposed
      // (rows 0-7, then 8-15), V^T's A fragments come by ldmatrix.trans
      const uint32_t pb0 = transpose8x8(pack_bf16(sc[0], sc[1]));
      const uint32_t pb1 = transpose8x8(pack_bf16(sc[2], sc[3]));
#pragma unroll
      for (int p = 0; p < HD / 16; ++p) {
        uint32_t va[4];
        ldsm_x4_trans(tile_addr<HD>(vst, wrow + (lane & 7) + 8 * (lane >> 4),
                                    2 * p + ((lane >> 3) & 1)),
                      va);
        mma16816(o[p], va, pb0, pb1);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int x = 4; x <= 16; x <<= 1) l[e] += __shfl_xor_sync(0xffffffffu, l[e], x);

  // merge the four warps in order 0..3 through the (now idle) ring
  const bool single = splits == 1;
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);  // [NWARPS][G]
  float* wl = wm + NWARPS * G;                 // [NWARPS][G]
  float* wo = wl + NWARPS * G;                 // [NWARPS][G][HD]
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int g = hq + e;
    if (g >= gc) continue;
    if (lane < 4) {
      wm[warp * G + g] = m[e];
      wl[warp * G + g] = l[e];
    }
#pragma unroll
    for (int p = 0; p < HD / 16; ++p) {
      wo[(warp * G + g) * HD + 16 * p + (lane >> 2)] = o[p][e];
      wo[(warp * G + g) * HD + 16 * p + (lane >> 2) + 8] = o[p][2 + e];
    }
  }
  if (single) new_token_scores<HD>(a, s, h, qh0, gc, s_new);
  if (rows_out != nullptr) {
    my_rows = __reduce_add_sync(0xffffffffu, my_rows);
    if (lane == 0) warp_rows[warp] = my_rows;
  }
  __syncthreads();

  // the partials of query head qh0 + g, split jj: work[(head0 + g * MS + jj) * HD]
  const size_t head0 = ((size_t)s * a.NH + qh0) * a.MS;
  float* const ml = a.work + (size_t)a.S * a.NH * a.MS * HD;  // (m, l) of each head and split
  for (int i = tid; i < gc * HD; i += NTHREADS) {
    const int gg = i / HD, d = i % HD;
    float mm = MASKED;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mm = fmaxf(mm, wm[w * G + gg]);
    float ll = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float mw = wm[w * G + gg];
      const float c = mw == MASKED ? 0.f : ex2(mw - mm);
      ll += wl[w * G + gg] * c;
      acc += wo[(w * G + gg) * HD + d] * c;
    }
    if (single) {
      a.out[((size_t)s * a.NH + qh0 + gg) * HD + d] = __float2bfloat16(
          finish(a, mm, ll, acc, s_new[gg], __bfloat162float(a.v_new[new_off + d]), qh0 + gg));
    } else {
      const size_t at = head0 + (size_t)gg * a.MS + j;
      a.work[at * HD + d] = acc;
      if (d == 0) {
        ml[at * 2] = mm;
        ml[at * 2 + 1] = ll;
      }
    }
  }
  if (rows_out != nullptr && tid == 0) {
    int rows = 0;
    for (int w = 0; w < NWARPS; ++w) rows += warp_rows[w];
    *rows_out = rows;
  }
  if (single) return;

  // the block that finishes last of its (slot, kv head, chunk) draws ticket
  // splits - 1 and folds the splits' partials in the fixed order 0..k-1,
  // whichever block that is; every block publishes its partial first
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + block_item;
  if (tid == 0) last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* cm = reinterpret_cast<float*>(smem);  // [splits][G] m, then each split's weight
  float* cl = cm + splits * G;                 // [splits][G] l
  float* head_ml = cl + splits * G;            // [G] max, then [G] denominators
  for (int i = tid; i < splits * G; i += NTHREADS) {
    const int jj = i / G, gg = i % G;
    if (gg >= gc) continue;
    cm[i] = __ldcg(ml + (head0 + (size_t)gg * a.MS + jj) * 2);
    cl[i] = __ldcg(ml + (head0 + (size_t)gg * a.MS + jj) * 2 + 1);
  }
  new_token_scores<HD>(a, s, h, qh0, gc, s_new);
  __syncthreads();
  if (tid < gc) {
    float mm = MASKED, ll = 0.f;
    for (int jj = 0; jj < splits; ++jj) mm = fmaxf(mm, cm[jj * G + tid]);
    for (int jj = 0; jj < splits; ++jj) {
      const float mj = cm[jj * G + tid];
      const float c = mj == MASKED ? 0.f : ex2(mj - mm);
      cm[jj * G + tid] = c;
      ll += cl[jj * G + tid] * c;
    }
    head_ml[tid] = mm;
    head_ml[G + tid] = ll;
  }
  __syncthreads();
  for (int i = tid; i < gc * HD; i += NTHREADS) {
    const int gg = i / HD, d = i % HD;
    float acc = 0.f;
#pragma unroll 4
    for (int jj = 0; jj < splits; ++jj)
      acc += __ldcg(a.work + (head0 + (size_t)gg * a.MS + jj) * HD + d) * cm[jj * G + gg];
    a.out[((size_t)s * a.NH + qh0 + gg) * HD + d] =
        __float2bfloat16(finish(a, head_ml[gg], head_ml[G + gg], acc, s_new[gg],
                                __bfloat162float(a.v_new[new_off + d]), qh0 + gg));
  }
  if (tid == 0) *ticket = 0;  // zero again for the next launch on this stream
}

// ---- host side ---------------------------------------------------------------

// the query heads a block takes (W): the group itself up to 8 where it is a
// power of two, else the next one, capped at 8
int chunk_width(int group) {
  int w = 1;
  while (w < group && w < MAX_CHUNK) w *= 2;
  return w;
}

// no slot can have two splits: the table holds at most C rows, or the
// window at most C cached rows
bool one_split(int rows, int window) {
  return rows <= SPLIT_ROWS || (window > 0 && window - 1 <= SPLIT_ROWS);
}

template <int HD, int G>
cudaError_t launch(Args a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<HD, G>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Cfg<HD>::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // the last block's fold keeps (m, l) of every split of its heads in the ring
  if (a.work != nullptr && ((size_t)a.MS * G * 2 + 2 * G) * sizeof(float) > Cfg<HD>::SMEM)
    return cudaErrorInvalidValue;
  if (a.S == 0) return cudaSuccess;
  // one split a slot: one item a (kv head, slot); `rows` keeps its MS columns
  const int z = a.work == nullptr ? 1 : a.MS;
  decode_split_kernel<HD, G><<<dim3(a.NKV * a.NC, a.S, z), NTHREADS, Cfg<HD>::SMEM, stream>>>(a);
  return cudaGetLastError();
}

int run(const void* q, const void* k_new, const void* v_new, void* k_pool, void* v_pool,
        const void* lengths, const void* page_table, const void* sinks, void* out, void* work,
        void* tickets, int* rows, int S, int NH, int NKV, int HD, int NP, int PS, int P,
        float scale, int window, void* stream) {
  if (NKV <= 0 || PS <= 0 || P <= 0 || NH % NKV != 0) return (int)cudaErrorInvalidValue;
  const int group = NH / NKV, width = chunk_width(group);
  const int ms = (P * PS + SPLIT_ROWS - 1) / SPLIT_ROWS;
  const bool single = one_split(P * PS, window);
  if (!single && (work == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
         static_cast<const bf16*>(v_new), static_cast<bf16*>(k_pool), static_cast<bf16*>(v_pool),
         static_cast<const int*>(lengths), static_cast<const int*>(page_table),
         static_cast<const float*>(sinks), static_cast<bf16*>(out),
         single ? nullptr : static_cast<float*>(work), static_cast<int*>(tickets), rows, S, NH,
         NKV, NP, PS, P, ms, group, (group + width - 1) / width, scale * LOG2E, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRT_DECODE_CASE(hd, g) \
  if (HD == hd && width == g) return (int)launch<hd, g>(a, st);
  PRT_DECODE_CASE(64, 1) PRT_DECODE_CASE(64, 2) PRT_DECODE_CASE(64, 4) PRT_DECODE_CASE(64, 8)
  PRT_DECODE_CASE(128, 1) PRT_DECODE_CASE(128, 2) PRT_DECODE_CASE(128, 4) PRT_DECODE_CASE(128, 8)
  PRT_DECODE_CASE(256, 1) PRT_DECODE_CASE(256, 2) PRT_DECODE_CASE(256, 4) PRT_DECODE_CASE(256, 8)
#undef PRT_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C: the cached rows a work item covers (the wrapper sizes the workspace by it)
extern "C" int decode_split_rows() { return SPLIT_ROWS; }

// the chunks a kv head's group of `group` query heads is cut into
extern "C" int decode_group_chunks(int group) {
  const int w = chunk_width(group);
  return (group + w - 1) / w;
}

// `work`: f32, S * NH * ceil(P * PS / C) * (HD + 2) values, and `tickets`:
// int32 [S, NKV, chunks], zero, which the launch leaves zero; both may be
// null where no slot can have two splits (P * PS <= C, or 0 < window <= C + 1)
extern "C" int decode_paged_attention(const void* q, const void* k_new, const void* v_new,
                                      void* k_pool, void* v_pool, const void* lengths,
                                      const void* page_table, const void* sinks, void* out,
                                      void* work, void* tickets, int S, int NH, int NKV, int HD,
                                      int NP, int PS, int P, float scale, int window,
                                      void* stream) {
  return run(q, k_new, v_new, k_pool, v_pool, lengths, page_table, sinks, out, work, tickets,
             nullptr, S, NH, NKV, HD, NP, PS, P, scale, window, stream);
}

// the same launch, also writing the cached rows each work item read into
// `rows` (int32 [S, NKV * chunks, ceil(P * PS / C)]; items past a slot's last split
// write 0, and with one split a slot only column 0 is written)
extern "C" int decode_paged_attention_rows(const void* q, const void* k_new, const void* v_new,
                                           void* k_pool, void* v_pool, const void* lengths,
                                           const void* page_table, const void* sinks, void* out,
                                           void* work, void* tickets, int S, int NH, int NKV,
                                           int HD, int NP, int PS, int P, float scale, int window,
                                           void* stream, void* rows) {
  return run(q, k_new, v_new, k_pool, v_pool, lengths, page_table, sinks, out, work, tickets,
             static_cast<int*>(rows), S, NH, NKV, HD, NP, PS, P, scale, window, stream);
}

// dynamic shared memory of a block at head dim `hd`
extern "C" int decode_attention_smem(int hd) {
  return hd == 256 ? Cfg<256>::SMEM : hd == 128 ? Cfg<128>::SMEM : hd == 64 ? Cfg<64>::SMEM : 0;
}

// the compiled kernel of head dim `hd` and chunk width `group` (1, 2, 4, 8) as the runtime
// loaded it: attrs = {registers a thread, local memory a thread in bytes
// (spills; 0 when none), static shared memory in bytes, threads a block}
extern "C" int decode_attention_attributes(int hd, int group, int* attrs) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
#define PRT_ATTR_CASE(h, g) \
  if (hd == h && group == g) err = cudaFuncGetAttributes(&attr, decode_split_kernel<h, g>);
  PRT_ATTR_CASE(64, 1) PRT_ATTR_CASE(64, 2) PRT_ATTR_CASE(64, 4) PRT_ATTR_CASE(64, 8)
  PRT_ATTR_CASE(128, 1) PRT_ATTR_CASE(128, 2) PRT_ATTR_CASE(128, 4) PRT_ATTR_CASE(128, 8)
  PRT_ATTR_CASE(256, 1) PRT_ATTR_CASE(256, 2) PRT_ATTR_CASE(256, 4) PRT_ATTR_CASE(256, 8)
#undef PRT_ATTR_CASE
  if (err != cudaSuccess) return (int)err;
  attrs[0] = attr.numRegs;
  attrs[1] = (int)attr.localSizeBytes;
  attrs[2] = (int)attr.sharedSizeBytes;
  attrs[3] = attr.maxThreadsPerBlock;
  return 0;
}
