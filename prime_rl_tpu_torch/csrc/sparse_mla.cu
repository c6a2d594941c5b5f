// K5a / K5b: sparse MLA attention (DSA) forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels prime_rl_tpu/ops/sparse_mla_pallas.py `_fwd_kernel`
// (K5a, the pallas_call in `_fwd_call`) and `_bwd_kernel` (K5b, the pallas_call
// in `_bwd_call`), together with the row gather and its transpose (the dKV
// scatter-add) that the JAX package leaves to XLA around them.
//
// Contract (one packed row): q [S, H, Dq] bf16 is the absorbed query of every
// token, kv [Sk, Dq] bf16 the latent KV stream, indices [S, T] int32 the rows
// each token selected; an index outside [0, Sk) is the sentinel and is masked
// out. The value of a row is its first Dv channels. With valid = index in range:
//
//   s   = q kv[idx]^T * scale                  (masked to -1e30 where !valid)
//   out = softmax(s) kv[idx][:, :Dv]           lse = max(m, -5e29) + log(max(l, 1e-30))
//   p   = valid ? exp(s - lse) : 0             dp = do kv[idx][:, :Dv]^T
//   ds  = bf16(p * (dp - delta) * scale)       dq = ds kv[idx]
//         (exactly 0 for a token with one valid slot: see one_valid_slot)
//   dkvg = ds^T q, plus bf16(p)^T do on the first Dv channels      (one f32 row per slot)
//   dkv[r] = sum of the dkvg rows of the slots that selected r     (f32, fixed order)
//
// The 576 K5b keeps each slot's dkvg row in f32: its sum over the 64 heads is
// added in the order of the wgmma k-steps, which no plain version can follow,
// and a row rounded to bf16 on each side then lands one bf16 step apart where
// it lies near a rounding boundary; where such large rows cancel in dkv, that
// step was more than the tolerance. Unrounded rows differ only by f32
// rounding. (The wide K5b, whose rows are summed over 16 heads, still writes
// bf16 rows, as the JAX kernel does.)
//
// A token that selected nothing gets out 0, lse -5e29, dq 0 and adds nothing to
// dkv. The mask selects before the exponential, so no inf * 0 reaches a sum.
// The kernels take Dq = 576, Dv = 512 (the MLA widths: latent 512 + rope 64)
// and work on one group of 64 heads a launch: one token's 64 heads are one
// wgmma M tile. The wrapper takes any H % 8 == 0 (what the JAX kernel takes at
// these widths), pads q's heads (and do's) with zero rows to Hp = ceil(H / 64)
// * 64 and launches once a group: the kernels take the row stride Hp (`hs`)
// and the group's first head (`h0`), so the q and do panels come from TMA row
// tok * Hp + h0 and out, lse and dq are addressed the same way. A padded head
// adds exactly 0: its zero q row gives finite s and its out and lse rows are
// dropped; in the backward its do and delta rows are 0, so its ds and p^T do
// are 0 and its dq rows are dropped. K5b's launches of one chunk go in
// ascending group order through one dkvg buffer, each followed by the dkv
// reduction into the same f32 dkv: dkv is summed in a fixed order and the bits
// are equal from run to run. The cost of this simple form: each group gathers
// its tokens' rows again (at 128 heads twice the L2 gather of K5a and K5b; at
// 8-56 heads a whole 64-row product for the real rows). One gather a tile
// with the groups looped over it is a later step. The wrapper raises for any
// other width.
//
// What differs from the TPU kernels, on purpose. The TPU version gathers the
// selected rows into a [C, T, Dq] tensor outside the kernel, because a TPU serves
// row gathers by DMA. Here the latent stream of a packed row (4096 x 1152 bytes =
// 4.7 MB) sits in the 50 MB L2, so each block reads the rows it needs by index
// (one row is 1152 contiguous bytes) and the gathered tensor is never written.
// The Dq 576 -> 640 padding, the padding of T and S to block multiples and the
// lax.map over chunks are TPU layout work and are not carried over.
//
// What bounds them on the H100: operations, and for K5a the row gather. A
// token's 64 heads against up to 2048 rows of 576 channels is
// 2*64*T*(576+512) flops forward and 2*64*T*(3*576+2*512) backward against
// 1152 bytes per row read from L2.
//   K5a (redesigned for Hopper): its floors at the DSA trainer's S = Sk =
//        4096, T = 2048 with a causal top-k are the products (0.876 TFLOP:
//        0.886 ms at 989 TFLOP/s) and the row gather from L2 (each selected
//        pair reads its row: 7.25 GB). The design:
//        - Persistent blocks, one an SM, walk the tokens in rounds that go up
//          and down the blocks in turn, the last token first (the heaviest
//          under a causal selection). A token's q [64, 576] comes by TMA (nine
//          64 x 64 boxes in the 128-byte swizzle) and stays for all its
//          tiles; the block's next token (q boxes and index row) is
//          prefetched into L2 during the token's last tile.
//        - A tile is BT = 64 slots. At a token's start seven warps read its
//          index row and keep one bit a tile (does it hold a real index?), as
//          K5b does: a tile of sentinels only is neither gathered nor
//          computed, wherever the sentinels lie in the row, and the visited
//          tiles are counted (`sparse_mla_fwd_tiles`).
//        - Rows come by 16-byte cp.async into the 128-byte-swizzled boxes the
//          wgmma descriptors read, 8 threads a row (each warp instruction
//          reads four whole 128-byte lines); sentinel slots read nothing and
//          land as zeros. Two stages: warpgroup 1 gathers tile j + 1 at the
//          start of tile j, its rows' indices loaded one tile earlier.
//        - Two warpgroups and no producer (256 threads, up to 255 registers).
//          Warpgroup 0 computes s = q kvg^T (m64n64k16, both operands
//          K-major, 36 k-steps) and the online softmax in the registers that
//          hold s: scores in log2 units (log2(e) folded into the scale), a
//          masked score -inf before ex2, the running max floored at a finite
//          -1e30 so that a row that saw nothing never forms inf - inf. It
//          stores bf16(p) as one [64 heads][64 slots] box in the 128-byte
//          swizzle and the rows' factors; warpgroup w owns o[:, 256 w, 256 w +
//          256) (128 f32 registers a thread), rescales it and adds bf16(p)
//          vg (m64n256k16, p K-major, vg MN-major from the stage's boxes).
//        - The sums are kept per thread and added at the token's end in a
//          fixed order (the quad's four, warpgroup 0's); o / l goes out as
//          bf16 through the token's q boxes by 16-byte stores, lse as
//          max(m, -5e29) + log(max(l, 1e-30)). No atomics: every element is
//          written once, from sums in a fixed order, and two launches give
//          equal bits.
//        Shared memory (bytes): q 73,728 + two kv stages 147,456 + p 8,192 +
//        the rows' factors (at the end their sums) 256 + indices 512 + tile
//        bits 512 + the mbarrier, + 1,024 of alignment slack = 231,696 of the
//        232,448 a block may use.
//        Measured (K5a alone at the shape above, the L2 flushed,
//        scripts/torch_sparse_mla_bench.py; an NVIDIA H100 80GB HBM3 at 700 W):
//        this design 1.64-1.66 ms, 1.87x the operation bound (the first
//        version: 9.07). A build that only gathers the rows
//        (-DK5A_GATHER_ONLY, a wrong output) takes 1.15-1.21 ms, 6.0-6.3 TB/s
//        from L2: the gather's own floor with one tile in flight, 1.4x below
//        the kernel. The timeline (clocks a tile, warpgroup 0): s 1.59k, the
//        softmax step and p 0.77k, p v 1.39k, the tile end 0.18k, about 4.3k
//        in all; warpgroup 1 waits 2.4k of it. s reads 144 KB of shared memory a tile while the next
//        tile's 72 KB land: at about 135 bytes a clock it is bound by shared
//        memory, not by the tensor cores. Measured on the way and not kept
//        (build variants timed in turn with this design): BT = 32 in three
//        stages, 2.23 ms; s split over both warpgroups at N = 32 with the
//        rows' maxima exchanged, 2.06 ms (twice the q reads); the next
//        tile's s issued before the last tile's p v has completed, 2.65 ms:
//        the gather into the stage that p v reads can then start only when
//        p v is done, and it no longer lands under the products; the gather
//        issued after s (so that s has shared memory to itself), 1.83 ms. The
//        gather needs its whole tile of lead.
//   K5b (redesigned for Hopper): its floor is the products (2.22 TFLOP at the
//        DSA trainer's S = Sk = 4096, T = 2048 with a causal top-k: 2.24 ms at
//        989 TFLOP/s), then the per-slot dkvg rows it must write (7.25 GB
//        there: 2.16 ms at 3.35 TB/s), which have to run under the products.
//        The design:
//        - Persistent blocks, one an SM (shared memory: the table below),
//          walk the chunk's tokens in rounds that go up and down the blocks in
//          turn, the last token first (the heaviest under a causal
//          selection). A token's q [64, 576] and do [64, 512] come by TMA
//          (64 x 64 boxes in the 128-byte swizzle) and stay for all its
//          tiles; the block's next token (panels and index row) is
//          prefetched into L2 during the token's last tile (a whole token
//          ahead, the dkvg stream evicted it first).
//        - A tile is BT = 32 slots. At a token's start eleven warps read its
//          index row (eight tiles' loads in flight a warp) and keep one bit a
//          tile: does it hold a real index? A tile of sentinels only is
//          neither gathered nor computed, wherever the sentinels lie in the
//          row, and the visited tiles are counted (`sparse_mla_bwd_tiles`).
//          Hopper's TMA has no row gather, and a row is 1152 contiguous
//          bytes, so the rows come by 16-byte cp.async into the
//          128-byte-swizzled boxes the wgmma descriptors read; sentinel
//          slots and slots past T read nothing and land as zeros. Two kv
//          stages: the next tile lands while this one is in the products.
//        - Three warpgroups and no producer (12 warps: 168 registers a
//          thread). One token's 64 heads are exactly one wgmma M tile.
//          Phase 1: warpgroup 0 computes s = q kvg^T and 2 dp = do vg^T
//          (m64n32k16, both operands K-major); 0 forms p = 2^(s scale log2e
//          - lse log2e) with a masked score -inf before ex2, hands p in f32
//          to 2 through shared memory and stores bf16(p); 2 forms ds = bf16(p
//          (dp - delta) scale). bf16(p) and ds lie in shared memory as [64
//          heads][32 slots] in the 64-byte swizzle, which serves both as a
//          K-major A and an MN-major B. Meanwhile warpgroup 1 sends the last
//          tile's dkvg rows out (below).
//          Phase 2: warpgroup w owns channels [192 w, 192 w + 192): dq[:, its
//          channels] += ds kvg (m64n192k16, kvg MN-major), dq held in
//          registers (96 a thread) for the whole token; and the tile's dkvg in
//          the transposed form, dkvg^T [its channels, 32 slots] = q^T ds +
//          do^T bf16(p), three m64n32 M tiles with all operands MN-major from
//          shared memory (M = 32 slots is below wgmma's 64). Each M tile goes
//          from the accumulator to the real slots' rows as f32 (a warp's
//          store covers 4 slots x 32 contiguous bytes; staging f32 rows in
//          the consumed kv stage for TMA stores would need twice its room,
//          which the block does not have). Warpgroup 1 first gathers the next
//          tile into the other stage.
//        - dq is staged through the token's q boxes at its end and written by
//          16-byte stores. Every dq and dkvg element is written once, by one
//          block, from sums in a fixed order: two runs give equal bits.
//        Shared memory (bytes): q 73,728 + do 65,536 + two kv stages 73,728 +
//        p and ds 8,192 + the f32 hand-off 8,192 + indices, tile bits and the
//        mbarrier 784, + 1,024 of alignment slack = 231,184 of the 232,448 a
//        block may use. BT = 64 (N = 64 products, the direct form of dkvg)
//        fits only with one kv stage and no room for the hand-off; a cluster
//        of two splitting the channels would trade the panels' room for 32 KB
//        of f32 s and dp partials a tile over distributed shared memory.
//        Measured (K5b's own launches at the shape above, the L2 flushed,
//        scripts/torch_sparse_mla_bench.py; an NVIDIA H100 80GB HBM3 at 700
//        W): with the f32 rows, 7.78 ms over 16 chunks (the rows' 14.5 GB of
//        writes take 4.3 ms at 3.35 TB/s). With bf16 rows, by the stores'
//        route: by thread after each warpgroup's phase 2, 7.99 ms; by TMA
//        while the next tile's products run, 5.05 (no stores at all, 5.24 of
//        an earlier form). Not kept either: s split over
//        warpgroups 0 and 1 with an f32 hand-off, 5.53 ms and spills; the
//        descriptors of the products hoisted out of the tile loop and the
//        warpgroup index taken as threadIdx.x / 128 (spills, and every wgmma
//        serialized by the compiler, which cannot see that a branch on it is
//        warp-uniform: it is broadcast from lane 0).
//   dkv: `sparse_mla_dkv_reduce_kernel` gives every kv row one block that walks
//        the slots that selected it, in the order of a stable sort of the
//        indices made by the wrapper, and sums their dkvg rows (f32 at 576,
//        bf16 in the wide form) in f32: no atomics, so two runs give the same
//        bits. The wrapper runs K5b and the reduction over chunks of queries
//        so that the buffer (rows of 2304 bytes in both forms) stays at 1.2 GB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_attn_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int H = 64;    // heads of one query token: the M dimension of every product
constexpr int DQ = 576;  // latent + rope channels of q and kv
constexpr int DV = 512;  // value channels (the latent part)
constexpr int V8 = DQ / 8;  // 16-byte vectors in one kv row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 16 bytes global -> shared, asynchronously; `valid` false fills zeros and reads nothing
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

// orders this thread's generic-proxy shared accesses before later async-proxy
// ones (wgmma operand reads, TMA writes)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}


// a box of a 2-D tensor map into L2, and `bytes` (a multiple of 16) from
// global `src` (on 16 bytes) into L2
__device__ __forceinline__ void prefetch_box(const CUtensorMap* map, int c0, int c1) {
  asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void prefetch_bytes(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                   reinterpret_cast<uint64_t>(src)),
               "r"(bytes)
               : "memory");
}

// a thread's bulk group (the wide K5b's TMA stores): commit, and wait until
// the committed groups have read their shared memory (or, `bulk_wait_all`,
// completed)
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a wgmma descriptor in the 64-byte swizzle (smem_desc is the 128-byte one)
__device__ __forceinline__ uint64_t smem_desc64(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (smem_desc(addr, lbo, sbo) & ~(3ull << 62)) | (2ull << 62);
}

__device__ __forceinline__ void st_shared32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// D[64 x 192] += A[64 x 16] B[16 x 192], A K-major and B MN-major in shared memory
__device__ __forceinline__ void wgmma_n192_kmn(float (&d)[96], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B MN-major in shared memory
__device__ __forceinline__ void wgmma_n32_mnmn(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 256] += A[64 x 16] B[16 x 256], A K-major and B MN-major in shared memory
__device__ __forceinline__ void wgmma_n256_kmn(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// the byte address of a thread's two bf16 values (slots 8 i + 2 (lane % 4) + {0, 1})
// of head h in a p or ds tile: rows of 64 bytes in the 64-byte swizzle
__device__ __forceinline__ uint32_t pd_addr(uint32_t base, int h, int i, int lane) {
  return base + h * 64 + ((i ^ ((h >> 1) & 3)) << 4) + (lane & 3) * 4;
}

// ---- phase clocks (scripts/torch_sparse_mla_bench.py --timeline builds with
// SPARSE_MLA_TIMELINE; the port's build compiles them out): thread 0 of each
// warpgroup adds the clocks since its previous mark to its block's slot of
// the phase, and counts its tiles in slot K5B_MARKS
#ifdef SPARSE_MLA_TIMELINE
constexpr int K5B_MARKS = 11;
__device__ unsigned long long k5b_timeline[1024 * 3 * (K5B_MARKS + 1)];
#define K5B_MARK_INIT() unsigned tl_prev = clock()
#define K5B_MARK(i)                                                                        \
  do {                                                                                     \
    if (wt == 0 && blockIdx.x < 1024) {                                                    \
      const unsigned now_ = clock();                                                       \
      unsigned long long* slot_ = k5b_timeline + (blockIdx.x * 3 + wg) * (K5B_MARKS + 1);  \
      atomicAdd(slot_ + (i), (unsigned long long)(now_ - tl_prev));                       \
      if ((i) == 9) atomicAdd(slot_ + K5B_MARKS, 1ull);                                    \
      tl_prev = now_;                                                                      \
    }                                                                                      \
  } while (0)
#else
#define K5B_MARK_INIT() \
  do {                  \
  } while (0)
#define K5B_MARK(i) \
  do {              \
  } while (0)
#endif

// the first tile after `t` whose bit is set in `flags`, or n if none is
__device__ __forceinline__ int next_tile(const uint32_t* flags, int t, int n) {
  for (int i = t + 1; i < n; i = (i | 31) + 1) {
    const uint32_t w = flags[i >> 5] >> (i & 31);
    if (w) return min(i + __ffs(w) - 1, n);
  }
  return n;
}

// ---------------------------------------------------------------------------
// K5a: forward
// ---------------------------------------------------------------------------
namespace k5a {

constexpr int BT = 64;               // slots a tile
constexpr int THREADS = 256;         // two warpgroups, no producer
constexpr int QBOXES = DQ / 64;      // 64-column boxes of q and of a kv row: 9
constexpr int PANEL_BOX = 64 * 128;  // a box of the q panel: 64 heads x 128 bytes
constexpr int TILE_BOX = BT * 128;   // a box of a kv tile
constexpr int STAGE = QBOXES * TILE_BOX;
constexpr int P_BYTES = H * BT * 2;  // bf16(p): [64 heads][64 slots], one box
constexpr int KSTEPS_S = DQ / 16;    // k16 steps of s: 36
constexpr int GROWS = BT / 16;       // rows a gathering thread moves a tile
constexpr int WIN = 4096;            // tiles a scan window (one bit each)
constexpr float M_FLOOR = -1e30f;    // the running max's start (log2 units): finite

// Offsets into the block's dynamic shared memory after its 1024-byte
// alignment: the q panel, the kv stages and p are 128-byte-swizzled boxes
// (1024-aligned).
constexpr int q_off = 0;                            // [9] boxes: q, at the token's end o's staging
constexpr int kv_off = q_off + QBOXES * PANEL_BOX;  // [2] stages of [9] boxes
constexpr int p_off = kv_off + 2 * STAGE;           // bf16(p)
constexpr int x_off = p_off + P_BYTES;              // f32 [64]: the rows' factors, at the end sums
constexpr int idx_off = x_off + H * 4;              // int [2][BT]: each stage's rows, -1 sentinel
constexpr int flag_off = idx_off + 2 * BT * 4;      // uint32 [WIN / 32]: tiles with a real index
constexpr int bar_off = flag_off + WIN / 8;         // the panel's mbarrier
constexpr int BYTES = bar_off + 16 + 1024;          // + the alignment slack
static_assert(BYTES <= 232448, "K5a's shared memory exceeds what a block may use");

}  // namespace k5a

// ---- K5a's phase clocks (scripts/torch_sparse_mla_bench.py --timeline builds
// with SPARSE_MLA_TIMELINE; the port's build compiles them out): thread 0 of
// each warpgroup adds the clocks since its previous mark to its block's slot
// of the phase, and counts its tiles in slot K5A_MARKS
#ifdef SPARSE_MLA_TIMELINE
constexpr int K5A_MARKS = 8;
__device__ unsigned long long k5a_timeline[1024 * 2 * (K5A_MARKS + 1)];
#define K5A_MARK_INIT() unsigned tl_prev = clock()
#define K5A_MARK(i)                                                                        \
  do {                                                                                     \
    if (wt == 0 && blockIdx.x < 1024) {                                                    \
      const unsigned now_ = clock();                                                       \
      unsigned long long* slot_ = k5a_timeline + (blockIdx.x * 2 + wg) * (K5A_MARKS + 1);  \
      atomicAdd(slot_ + (i), (unsigned long long)(now_ - tl_prev));                       \
      if ((i) == 6) atomicAdd(slot_ + K5A_MARKS, 1ull);                                    \
      tl_prev = now_;                                                                      \
    }                                                                                      \
  } while (0)
#else
#define K5A_MARK_INIT() \
  do {                  \
  } while (0)
#define K5A_MARK(i) \
  do {              \
  } while (0)
#endif

__global__ void __launch_bounds__(k5a::THREADS, 1)
sparse_mla_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const bf16* __restrict__ kv,
                      const int* __restrict__ indices, bf16* __restrict__ out,
                      float* __restrict__ lse, int* __restrict__ tiles, int S, int Sk, int T,
                      int hs, int h0, float scale) {
  using namespace k5a;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  float* xs = reinterpret_cast<float*>(smem + x_off);
  int* idx_s = reinterpret_cast<int*>(smem + idx_off);
  uint32_t* flags = reinterpret_cast<uint32_t*>(smem + flag_off);
  const uint32_t bar = sbase + bar_off;

  const int tid = threadIdx.x, wt = tid % 128, warp = tid / 32, lane = tid % 32;
  // the warpgroup, broadcast from lane 0: the compiler then knows a branch on
  // it is warp-uniform, and does not serialize the wgmmas inside it
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lr = 16 * (wt / 32) + lane / 4;  // this thread's rows lr, lr + 8 of a 64-row tile
  // warpgroup 1 gathers: thread wt moves the 16-byte chunk `part` of each of
  // the 9 boxes of rows grow + 16 k (k < GROWS), 8 threads a row: each warp
  // instruction reads four whole 128-byte lines
  const int grow = wt / 8, part = wt % 8;
  const float sl2 = scale * LOG2E;
  const int n_tiles = (T + BT - 1) / BT;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  K5A_MARK_INIT();

  // the offset of k16 step kk in a K-major descriptor: +32 bytes a step
  // inside a 64-column box, the next box `box` bytes on
  auto koff = [](int kk, int box) { return (uint64_t)(((kk / 4) * box + (kk % 4) * 32) >> 4); };

  uint32_t parity = 0;
  for (int r = 0;; ++r) {
    const int e = r * gridDim.x + (r & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    if (e >= S) break;
    const int tok = S - 1 - e;  // under a causal selection the late tokens hold the most tiles
    // every thread is done with the previous token's panel, stages and flags
    // (its generic accesses fenced against the TMA writes below)
    __syncthreads();
    K5A_MARK(0);
    // the block's next token (its q boxes and index row) into L2, issued
    // during the token's last tile
    const int en = (r + 1) * gridDim.x + (r & 1 ? blockIdx.x : gridDim.x - 1 - blockIdx.x);
    auto prefetch_next = [&]() {
      if (en >= S) return;
      const int tn = S - 1 - en;
      for (int b = 0; b < QBOXES; ++b) prefetch_box(&tm_q, b * 64, tn * hs + h0);
      const uintptr_t lo = reinterpret_cast<uintptr_t>(indices + (size_t)tn * T) & ~(uintptr_t)15;
      const uintptr_t hi = reinterpret_cast<uintptr_t>(indices + (size_t)(tn + 1) * T);
      prefetch_bytes(reinterpret_cast<const void*>(lo), (uint32_t)((hi - lo + 15) & ~(uintptr_t)15));
    };
    const int* irow = indices + (size_t)tok * T;
    float o[128];  // o[:, 256 wg + ...]: 64 rows x 256 columns
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    // warpgroup 0's running max (log2 units) and this thread's partial sums
    // of rows lr, lr + 8
    float m0 = M_FLOOR, m1 = M_FLOOR, l0 = 0.f, l1 = 0.f;
    int visited = 0;

    for (int w0 = 0; w0 < n_tiles; w0 += WIN) {
      const int nw = min(WIN, n_tiles - w0);
      // one bit a tile: does it hold a real index? The words are zeroed
      // (every thread is past its last read of the previous window's), then
      // warps 0 .. 6 take every seventh tile, one ballot a tile, while warp
      // 7 issues the token's q loads
      if (w0 > 0) __syncthreads();
      for (int i = tid; i < (nw + 31) / 32; i += THREADS) flags[i] = 0;
      __syncthreads();
      if (w0 == 0 && tid == THREADS - 32) {
        mbar_arrive_expect_tx(bar, QBOXES * PANEL_BOX);
        for (int b = 0; b < QBOXES; ++b)
          tma_load_2d(sbase + q_off + b * PANEL_BOX, &tm_q, bar, b * 64, tok * hs + h0);
      }
      constexpr int SCAN_WARPS = THREADS / 32 - 1;
      constexpr int SPL = BT / 32;  // slots a lane reads a tile
      for (int t0 = warp; t0 < nw && warp < SCAN_WARPS; t0 += 8 * SCAN_WARPS) {
        int v[8][SPL];  // eight tiles' indices in flight at once, then their ballots
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int t = t0 + k * SCAN_WARPS;
#pragma unroll
          for (int h = 0; h < SPL; ++h) {
            const int j = (w0 + t) * BT + 32 * h + lane;
            v[k][h] = t < nw && j < T ? irow[j] : -1;
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int t = t0 + k * SCAN_WARPS;
          bool real = false;
#pragma unroll
          for (int h = 0; h < SPL; ++h) real |= v[k][h] >= 0 && v[k][h] < Sk;
          if (__ballot_sync(0xffffffffu, real) && lane == 0)
            atomicOr(flags + (t >> 5), 1u << (t & 31));
        }
      }
      __syncthreads();
      K5A_MARK(1);

      // the kv rows of this thread's rows of window tile t (-1: sentinel,
      // past T, or no such tile)
      auto row_ids = [&](int t, int (&id)[GROWS]) {
#pragma unroll
        for (int k = 0; k < GROWS; ++k) {
          const int j = (w0 + t) * BT + grow + 16 * k;
          int v = -1;
          if (t < nw && j < T) {
            v = irow[j];
            if (v < 0 || v >= Sk) v = -1;
          }
          id[k] = v;
        }
      };
      // a tile's rows into stage st, to their swizzled places (a sentinel
      // slot reads nothing and lands as zeros)
      auto gather = [&](const int (&id)[GROWS], int st) {
#pragma unroll
        for (int k = 0; k < GROWS; ++k) {
          const int row = grow + 16 * k;
          if (part == 0) idx_s[st * BT + row] = id[k];
          const bf16* src = kv + (size_t)(id[k] < 0 ? 0 : id[k]) * DQ + part * 8;
          const uint32_t dst = sbase + kv_off + st * STAGE + row * 128 + ((part ^ (row & 7)) << 4);
#pragma unroll
          for (int u = 0; u < QBOXES; ++u) cp_async16(dst + u * TILE_BOX, src + u * 64, id[k] >= 0);
        }
        cp_async_commit();
      };

      // the first tile into stage 0; `nid` holds the rows of the next one
      // (loaded a tile early: the gather never waits for an index)
      int cur = next_tile(flags, -1, nw);
      int nid[GROWS];
      if (wg == 1) {
        row_ids(cur, nid);
        if (cur < nw) gather(nid, 0);
        row_ids(next_tile(flags, cur, nw), nid);
      }
      if (w0 == 0) mbar_wait(bar, parity);
      cp_async_wait<0>();
      fence_async_smem();
      __syncthreads();
      K5A_MARK(2);

      int st = 0;
      while (cur < nw) {
        const int nxt = next_tile(flags, cur, nw);
        const uint32_t kvb = sbase + kv_off + st * STAGE;
        const uint32_t p_s = sbase + p_off;
        const int* idt = idx_s + st * BT;
        float a0 = 1.f, a1 = 1.f;  // this tile's factors of rows lr, lr + 8

        if (wg == 1) {  // the next tile into the stage the last tile freed
          if (nxt < nw) {
            gather(nid, st ^ 1);
            row_ids(next_tile(flags, nxt, nw), nid);
          } else if (w0 + WIN >= n_tiles && wt == 0) {
            prefetch_next();
          }
        }
#ifndef K5A_GATHER_ONLY  // a measurement variant (the bench's --variants): rows gathered, no products
        // ---- warpgroup 0: s = q kvg^T, the softmax step in the registers
        // that hold it, bf16(p) into the p tile and the rows' factors
        if (wg == 0) {
          float s[BT / 2];
          const uint64_t q0 = smem_desc(sbase + q_off, 16, 1024);
          const uint64_t kd = smem_desc(kvb, 16, 1024);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KSTEPS_S; ++kk)
            wgmma_ss<BT>(s, q0 + koff(kk, PANEL_BOX), kd + koff(kk, TILE_BOX), kk > 0);
          wgmma_commit();
          wgmma_wait_all();
          pin(s);
          K5A_MARK(3);
          // scores in log2 units; a masked one is -inf before the exponential,
          // so its p is exactly 0
          float x0 = MASKED, x1 = MASKED;
#pragma unroll
          for (int i = 0; i < BT / 8; ++i) {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const bool real = idt[8 * i + 2 * (lane & 3) + jj] >= 0;
              s[4 * i + jj] = real ? s[4 * i + jj] * sl2 : MASKED;
              s[4 * i + 2 + jj] = real ? s[4 * i + 2 + jj] * sl2 : MASKED;
              x0 = fmaxf(x0, s[4 * i + jj]);
              x1 = fmaxf(x1, s[4 * i + 2 + jj]);
            }
          }
          x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
          x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
          x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
          x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
          const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
          a0 = ex2(m0 - n0);
          a1 = ex2(m1 - n1);
          m0 = n0;
          m1 = n1;
          float r0 = 0.f, r1 = 0.f;
#pragma unroll
          for (int i = 0; i < BT / 4; ++i) {
            s[2 * i] = ex2(s[2 * i] - ((i & 1) ? n1 : n0));
            s[2 * i + 1] = ex2(s[2 * i + 1] - ((i & 1) ? n1 : n0));
            ((i & 1) ? r1 : r0) += s[2 * i] + s[2 * i + 1];
          }
          l0 = l0 * a0 + r0;
          l1 = l1 * a1 + r1;
#pragma unroll
          for (int i = 0; i < BT / 8; ++i) {  // [64 heads][64 slots] in the 128-byte swizzle
            st_shared32(swizzled(p_s, H, lr, i, lane), pack_bf16(s[4 * i], s[4 * i + 1]));
            st_shared32(swizzled(p_s, H, lr + 8, i, lane), pack_bf16(s[4 * i + 2], s[4 * i + 3]));
          }
          if ((lane & 3) == 0) {  // the factors, for warpgroup 1
            xs[lr] = a0;
            xs[lr + 8] = a1;
          }
          fence_async_smem();
        }
#endif
        bar_sync(1, THREADS);  // p and the factors in place
        K5A_MARK(4);
#ifndef K5A_GATHER_ONLY
        if (wg == 1) {
          a0 = xs[lr];
          a1 = xs[lr + 8];
        }
        // ---- o[:, 256 wg ..] = o alpha + bf16(p) vg[:, 256 wg ..]: vg is
        // MN-major, the kv boxes 4 wg .. 4 wg + 3 of the stage (+2048 bytes a
        // k16 step)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          o[4 * i] *= a0;
          o[4 * i + 1] *= a0;
          o[4 * i + 2] *= a1;
          o[4 * i + 3] *= a1;
        }
        {
          const uint64_t a_p = smem_desc(p_s, 16, 1024);  // K-major: +32 bytes a k16 step
          const uint64_t b_v = smem_desc(kvb + 4 * wg * TILE_BOX, TILE_BOX, 1024);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BT / 16; ++kk)
            wgmma_n256_kmn(o, a_p + ((kk * 32) >> 4), b_v + ((kk * 16 * 128) >> 4));
          wgmma_commit();
          wgmma_wait_all();
          pin(o);
        }
#endif
        K5A_MARK(5);
        // ---- the next tile's rows have landed; every thread is done with this
        // tile's stage and with p
        cp_async_wait<0>();
        fence_async_smem();
        __syncthreads();
        K5A_MARK(6);
        cur = nxt;
        st ^= 1;
        ++visited;
      }
    }
    if (tiles != nullptr && tid == 0) {  // [S, 2]: visited, candidates
      tiles[2 * tok] = visited;
      tiles[2 * tok + 1] = n_tiles;
    }

    // ---- epilogue: the rows' sums (warpgroup 0's quad partials, added in a
    // fixed order, to both warpgroups through shared memory), lse, and o / l
    // as bf16 staged in the warpgroup's q boxes 4 wg .. 4 wg + 3 (their last
    // reads are complete), then 16-byte stores
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if (wg == 0 && (lane & 3) == 0) {
      xs[lr] = l0;
      xs[lr + 8] = l1;
    }
    __syncthreads();
    const float s0 = xs[lr], s1 = xs[lr + 8];
    if (wg == 0 && (lane & 3) == 0) {
      lse[(size_t)tok * hs + h0 + lr] = fmaxf(m0 * LN2, -5e29f) + logf(fmaxf(s0, 1e-30f));
      lse[(size_t)tok * hs + h0 + lr + 8] = fmaxf(m1 * LN2, -5e29f) + logf(fmaxf(s1, 1e-30f));
    }
    stage_rows<256>(o, 1.f / fmaxf(s0, 1e-30f), 1.f / fmaxf(s1, 1e-30f),
                    sbase + q_off + 4 * wg * PANEL_BOX, 64, 0, lr, lane);
    bar_sync(3 + wg, 128);
    store_rows<256>(out + ((size_t)tok * hs + h0) * DV + 256 * wg, DV, smem + q_off + 4 * wg * PANEL_BOX,
                    64, 0, 64);
    fence_async_smem();
    K5A_MARK(7);
    parity ^= 1;
  }
}

// ---------------------------------------------------------------------------
// K5b: backward (dq and the per-slot dkvg rows of one chunk of queries)
// ---------------------------------------------------------------------------
// Whether the token whose index row is `irow` selected exactly one row in
// [0, Sk): a block-wide count, one barrier per THREADS slots, stopping at 2
// (one barrier for almost every token). Such a token's softmax is p = 1 on
// its row, so delta = sum(out do) = dp and its ds = p (dp - delta) is exactly
// 0. Both K5b forms then store ds = 0 rather than the difference of two f32
// sums of the same products added in different orders: that noise (about
// 1e-7) broke the bf16 ties of the exact dkvg row sum_h do_h one way here and
// another in the plain version (`_backward_into`, which applies the same rule).
// The wide K5b calls this; the 576 K5b counts the real indices in its tile
// scan instead (a count at the token's start there costs 3 registers that
// its dq accumulator leaves no room for: 12 bytes of spills), so it applies
// the rule where a token's row fits one scan window (T <= WIN * BT =
// 131,072 slots, above any top-k).
template <int THREADS>
__device__ __forceinline__ bool one_valid_slot(const int* __restrict__ irow, int T, int Sk) {
  int n = 0;
  for (int j0 = 0; j0 < T && n < 2; j0 += THREADS) {
    const int j = j0 + (int)threadIdx.x;
    const int v = j < T ? irow[j] : -1;
    n += __syncthreads_count(v >= 0 && v < Sk);
  }
  return n == 1;
}

namespace k5b {

constexpr int BT = 32;               // selected rows a tile
constexpr int THREADS = 384;         // three consumer warpgroups, no producer
constexpr int QBOXES = DQ / 64;      // 64-column boxes of q and of a kv row: 9
constexpr int OBOXES = DV / 64;      // of do: 8
constexpr int PANEL_BOX = 64 * 128;  // a box of the q or do panel: 64 heads x 128 bytes
constexpr int TILE_BOX = BT * 128;   // a box of a kv tile
constexpr int STAGE = QBOXES * TILE_BOX;
constexpr int PD_BYTES = H * BT * 2;  // p or ds in bf16: [64 heads][32 slots], rows of 64 bytes
constexpr int KSTEPS_S = DQ / 16;    // k16 steps of s: 36
constexpr int KSTEPS_DP = DV / 16;   // of dp: 32
constexpr int WIN = 4096;            // tiles a scan window (one bit each)

// Offsets into the block's dynamic shared memory after its 1024-byte
// alignment. The panels and the kv stages are 128-byte-swizzled boxes
// (1024-aligned); p and ds are 64-byte-swizzled (512-aligned).
constexpr int q_off = 0;                                // [9] boxes: q, later dq's staging
constexpr int do_off = q_off + QBOXES * PANEL_BOX;      // [8] boxes
constexpr int kv_off = do_off + OBOXES * PANEL_BOX;     // [2] stages of [9] boxes
constexpr int p_off = kv_off + 2 * STAGE;               // bf16(p)
constexpr int ds_off = p_off + PD_BYTES;                // ds
constexpr int x_off = ds_off + PD_BYTES;                // f32 [4][128] float4: p, 0 to 2
constexpr int idx_off = x_off + H * BT * 4;             // int [2][BT]: each stage's rows, -1 sentinel
constexpr int flag_off = idx_off + 2 * BT * 4;          // uint32 [WIN / 32]: tiles with a real index
constexpr int bar_off = flag_off + WIN / 8;             // the panels' mbarrier
constexpr int one_off = bar_off + 16;                   // uint32: the token's real indices
constexpr int BYTES = one_off + 16 + 1024;              // + the alignment slack
static_assert(BYTES <= 232448, "K5b's shared memory exceeds what a block may use");
static_assert(128 == 4 * BT, "warpgroup 1 gives each thread 18 of a row's 72 chunks");

}  // namespace k5b

__global__ void __launch_bounds__(k5b::THREADS, 1)
sparse_mla_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do, const bf16* __restrict__ kv,
                      const int* __restrict__ indices, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq,
                      float* __restrict__ dkvg, int* __restrict__ tiles, int C, int Sk, int T,
                      int hs, int h0, float scale) {
  using namespace k5b;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  float4* xs = reinterpret_cast<float4*>(smem + x_off);
  int* idx_s = reinterpret_cast<int*>(smem + idx_off);
  uint32_t* flags = reinterpret_cast<uint32_t*>(smem + flag_off);
  const uint32_t bar = sbase + bar_off;

  const int tid = threadIdx.x, wt = tid % 128, warp = tid / 32, lane = tid % 32;
  // the warpgroup, broadcast from lane 0: the compiler then knows a branch on
  // it is warp-uniform, and does not serialize the wgmmas inside it
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lr = 16 * (wt / 32) + lane / 4;  // this thread's rows lr, lr + 8 of a 64-row tile
  const float sl2 = scale * LOG2E;
  const int n_tiles = (T + BT - 1) / BT;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  K5B_MARK_INIT();

  // the offset of k16 step kk in a K-major descriptor: +32 bytes a step
  // inside a 64-column box, the next box `box` bytes on
  auto koff = [](int kk, int box) { return (uint64_t)(((kk / 4) * box + (kk % 4) * 32) >> 4); };

  uint32_t parity = 0;
  for (int r = 0;; ++r) {
    const int e = r * gridDim.x + (r & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    if (e >= C) break;
    const int c = C - 1 - e;  // under a causal selection the late tokens hold the most tiles
    // every thread is done with the previous token's panels, stages and flags
    // (its generic accesses fenced against the TMA writes below)
    __syncthreads();
    K5B_MARK(0);
    // the block's next token (its panels and index row) into L2, issued by
    // one thread where it waits anyway: phase 1 of the token's last tile (a
    // prefetch a whole token ahead is evicted by the dkvg rows streaming
    // through L2 before it is used)
    const int en = (r + 1) * gridDim.x + (r & 1 ? blockIdx.x : gridDim.x - 1 - blockIdx.x);
    auto prefetch_next = [&]() {
      if (en >= C) return;
      const int cn = C - 1 - en;
      for (int b = 0; b < QBOXES; ++b) prefetch_box(&tm_q, b * 64, cn * hs + h0);
      for (int b = 0; b < OBOXES; ++b) prefetch_box(&tm_do, b * 64, cn * hs + h0);
      const uintptr_t lo = reinterpret_cast<uintptr_t>(indices + (size_t)cn * T) & ~(uintptr_t)15;
      const uintptr_t hi = reinterpret_cast<uintptr_t>(indices + (size_t)(cn + 1) * T);
      prefetch_bytes(reinterpret_cast<const void*>(lo), (uint32_t)((hi - lo + 15) & ~(uintptr_t)15));
    };
    const int* irow = indices + (size_t)c * T;
    float dqa[96];  // dq[:, 192 wg + ...]: 64 rows x 192 columns
#pragma unroll
    for (int i = 0; i < 96; ++i) dqa[i] = 0.f;
    int visited = 0;

    for (int w0 = 0; w0 < n_tiles; w0 += WIN) {
      const int nw = min(WIN, n_tiles - w0);
      // one bit a tile: does it hold a real index? The words are zeroed
      // (every thread is past its last read of the previous window's), then
      // warps 0 .. 10 take every eleventh tile, one ballot a tile, while
      // warp 11 issues the token's panel loads
      if (w0 > 0) __syncthreads();
      for (int i = tid; i < (nw + 31) / 32; i += THREADS) flags[i] = 0;
      if (tid == 0 && w0 == 0) st_shared32(sbase + one_off, 0u);  // the token's real indices
      __syncthreads();
      if (w0 == 0 && tid == THREADS - 32) {
        mbar_arrive_expect_tx(bar, (QBOXES + OBOXES) * PANEL_BOX);
        for (int b = 0; b < QBOXES; ++b)
          tma_load_2d(sbase + q_off + b * PANEL_BOX, &tm_q, bar, b * 64, c * hs + h0);
        for (int b = 0; b < OBOXES; ++b)
          tma_load_2d(sbase + do_off + b * PANEL_BOX, &tm_do, bar, b * 64, c * hs + h0);
      }
      constexpr int SCAN_WARPS = THREADS / 32 - 1;
      for (int t0 = warp; t0 < nw && warp < SCAN_WARPS; t0 += 8 * SCAN_WARPS) {
        int v[8];  // eight tiles' indices in flight at once, then their ballots
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int t = t0 + k * SCAN_WARPS, j = (w0 + t) * BT + lane;
          v[k] = t < nw && j < T ? irow[j] : -1;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int t = t0 + k * SCAN_WARPS;
          const unsigned bal = __ballot_sync(0xffffffffu, v[k] >= 0 && v[k] < Sk);
          if (bal && lane == 0) {  // the tile's bit, and its real indices to the count
            atomicOr(flags + (t >> 5), 1u << (t & 31));
            atomicAdd(reinterpret_cast<unsigned*>(smem + one_off), (unsigned)__popc(bal));
          }
        }
      }
      __syncthreads();
      K5B_MARK(1);

      // warpgroup 1 moves a tile's rows: its thread wt gathers (and, where
      // it stores by thread, stores) the 16-byte chunks part + 4 u (u < 18)
      // of row wt / 4, the 4 threads of a row 64 contiguous bytes an
      // instruction
      const int row = wt / 4, part = wt % 4;
      // row `row` of window tile t: its kv row, or -1 (sentinel, past T)
      auto row_index = [&](int t) {
        const int j = (w0 + t) * BT + row;
        int id = -1;
        if (t < nw && j < T) {
          const int v = irow[j];
          if (v >= 0 && v < Sk) id = v;
        }
        return id;
      };
      // a tile's rows into stage st, to their swizzled places; `id` is this
      // thread's row's index
      auto gather = [&](int id, int st) {
        if (part == 0) idx_s[st * BT + row] = id;
        const bf16* src = kv + (size_t)(id < 0 ? 0 : id) * DQ + part * 8;
        const uint32_t dst = sbase + kv_off + st * STAGE + row * 128;
#pragma unroll
        for (int u = 0; u < 18; ++u) {
          const int ch = part + 4 * u;
          cp_async16(dst + (ch >> 3) * TILE_BOX + (((ch & 7) ^ (row & 7)) << 4), src + u * 32,
                     id >= 0);
        }
        cp_async_commit();
      };

      int cur = next_tile(flags, -1, nw);
      if (wg == 1 && cur < nw) gather(row_index(cur), 0);
      if (w0 == 0) mbar_wait(bar, parity);
      K5B_MARK(2);
      cp_async_wait<0>();
      fence_async_smem();
      __syncthreads();
      K5B_MARK(3);

      // Tile cur is in stage st; after barrier 3 warpgroup 1 gathers the next
      // tile into stage st ^ 1, which the tile before it has done with.
      int st = 0;
      while (cur < nw) {
        const int j0 = (w0 + cur) * BT;
        const int nxt = next_tile(flags, cur, nw);
        // the shared base, opaque to the compiler a tile: the descriptors
        // below are formed where they are used, not hoisted out of the loop
        // into registers that the dq accumulator needs
        uint32_t sb = sbase;
        asm volatile("" : "+r"(sb));
        const uint32_t kvb = sb + kv_off + st * STAGE;
        const uint64_t kvd = smem_desc(kvb, 16, 1024);
        const uint32_t p_s = sb + p_off, ds_s = sb + ds_off;
        const int* idt = idx_s + st * BT;

        // ---- phase 1: s (warpgroup 0) and dp (2), then p and ds into shared
        // memory; warpgroup 1 moves rows
        if (wg == 0) {
          float s[16];
          const uint64_t q0 = smem_desc(sb + q_off, 16, 1024);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KSTEPS_S; ++kk)
            wgmma_ss_n32(s, q0 + koff(kk, PANEL_BOX), kvd + koff(kk, TILE_BOX), kk > 0);
          wgmma_commit();
          // its rows' lse in log2 units (read a tile: a value kept across
          // tiles would hold a register the dq accumulator needs)
          const float rv0 = lse[(size_t)c * hs + h0 + lr] * LOG2E;
          const float rv1 = lse[(size_t)c * hs + h0 + lr + 8] * LOG2E;
          wgmma_wait_all();
          pin(s);
          K5B_MARK(4);
          // p = 2^(s scale log2(e) - lse log2(e)); a masked score is -inf
          // before the exponential, so its p is exactly 0
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const bool real = idt[8 * i + 2 * (lane & 3) + jj] >= 0;
              s[4 * i + jj] = ex2(real ? fmaf(s[4 * i + jj], sl2, -rv0) : MASKED);
              s[4 * i + 2 + jj] = ex2(real ? fmaf(s[4 * i + 2 + jj], sl2, -rv1) : MASKED);
            }
          }
#pragma unroll
          for (int v = 0; v < 4; ++v)
            xs[v * 128 + wt] = make_float4(s[4 * v], s[4 * v + 1], s[4 * v + 2], s[4 * v + 3]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            st_shared32(pd_addr(p_s, lr, i, lane), pack_bf16(s[4 * i], s[4 * i + 1]));
            st_shared32(pd_addr(p_s, lr + 8, i, lane), pack_bf16(s[4 * i + 2], s[4 * i + 3]));
          }
          fence_async_smem();
          bar_arrive(1, 256);
          if (nxt >= nw && w0 + WIN >= n_tiles && wt == 0) prefetch_next();
        } else if (wg == 2) {
          float dp[16];
          const uint64_t do0 = smem_desc(sb + do_off, 16, 1024);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KSTEPS_DP; ++kk)
            wgmma_ss_n32(dp, do0 + koff(kk, PANEL_BOX), kvd + koff(kk, TILE_BOX), kk > 0);
          wgmma_commit();
          const float rv0 = delta[(size_t)c * hs + h0 + lr], rv1 = delta[(size_t)c * hs + h0 + lr + 8];
          wgmma_wait_all();
          pin(dp);
          K5B_MARK(4);
          bar_sync(1, 256);
          // ds = bf16(p (dp - delta) scale), p in f32 from warpgroup 0
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float4 x = xs[v * 128 + wt];
            dp[4 * v] = x.x * (dp[4 * v] - rv0) * scale;
            dp[4 * v + 1] = x.y * (dp[4 * v + 1] - rv0) * scale;
            dp[4 * v + 2] = x.z * (dp[4 * v + 2] - rv1) * scale;
            dp[4 * v + 3] = x.w * (dp[4 * v + 3] - rv1) * scale;
          }
          // ds stored as exactly 0 for a token with one valid slot (the
          // scan's count; see one_valid_slot), where its row fits one window
          const uint32_t keep =
              (ld_shared32(sb + one_off) == 1u && n_tiles <= WIN) ? 0u : 0xffffffffu;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            st_shared32(pd_addr(ds_s, lr, i, lane), pack_bf16(dp[4 * i], dp[4 * i + 1]) & keep);
            st_shared32(pd_addr(ds_s, lr + 8, i, lane),
                        pack_bf16(dp[4 * i + 2], dp[4 * i + 3]) & keep);
          }
          fence_async_smem();
        } else {
          K5B_MARK(4);
        }
        bar_sync(3, THREADS);
        K5B_MARK(5);
        if (wg == 1 && nxt < nw) gather(row_index(nxt), st ^ 1);

        // ---- phase 2: warpgroup wg owns channels [192 wg, 192 wg + 192), the
        // kv boxes 3 wg .. 3 wg + 2: dq += ds kvg (kvg MN-major: its boxes a
        // box apart, +2048 bytes a k16 step), then the tile's dkvg^T box by
        // box = q^T ds (+ do^T bf16(p)), q^T and do^T MN-major (+2048 bytes a
        // k16 step), ds and p MN-major (+1024 bytes), each stored as f32 from
        // the accumulator
        {
          const uint64_t a_ds = smem_desc64(ds_s, 16, 512);
          const uint64_t b_kv = smem_desc(kvb + 3 * wg * TILE_BOX, TILE_BOX, 1024);
          wgmma_fence();
          wgmma_n192_kmn(dqa, a_ds, b_kv, 1);
          wgmma_n192_kmn(dqa, a_ds + (32 >> 4), b_kv + ((16 * 128) >> 4), 1);
          wgmma_commit();
          wgmma_wait_all();
          pin(dqa);
          K5B_MARK(6);
          const uint64_t b_ds = smem_desc64(ds_s, PD_BYTES, 512);
          const uint64_t b_p = smem_desc64(p_s, PD_BYTES, 512);
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            const int b = 3 * wg + m;
            float acc[16];
            const uint64_t a_q = smem_desc(sb + q_off + b * PANEL_BOX, PANEL_BOX, 1024);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_n32_mnmn(acc, a_q + ((kk * 2048) >> 4), b_ds + ((kk * 1024) >> 4), kk > 0);
            if (b < OBOXES) {
              const uint64_t a_o = smem_desc(sb + do_off + b * PANEL_BOX, PANEL_BOX, 1024);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_n32_mnmn(acc, a_o + ((kk * 2048) >> 4), b_p + ((kk * 1024) >> 4), 1);
            }
            wgmma_commit();
            wgmma_wait_all();
            pin(acc);
#ifndef K5B_NO_STORES  // a measurement variant (scripts/torch_sparse_mla_bench.py --variants): wrong dkv
            // f32 from the accumulator to the real slots' rows: acc[4 i + jj]
            // is channel lr of box b at slot 8 i + 2 (lane & 3) + jj, acc[4 i +
            // 2 + jj] channel lr + 8 (a warp's store: 4 slots x 32 contiguous
            // bytes); a sentinel slot's row is never read, so never written
            float* dst = dkvg + ((size_t)c * T + j0) * DQ + b * 64 + lr;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const int slot = 8 * i + 2 * (lane & 3) + jj;
                if (idt[slot] >= 0) {
                  dst[(size_t)slot * DQ] = acc[4 * i + jj];
                  dst[(size_t)slot * DQ + 8] = acc[4 * i + 2 + jj];
                }
              }
            }
#endif
          }
          K5B_MARK(7);
        }

        // ---- the next tile's rows have landed
        cp_async_wait<0>();
        fence_async_smem();
        __syncthreads();
        K5B_MARK(8);
        cur = nxt;
        st ^= 1;
        ++visited;
        K5B_MARK(9);
      }
    }
    if (tiles != nullptr && tid == 0) {  // [C, 2]: visited, candidates
      tiles[2 * c] = visited;
      tiles[2 * c + 1] = n_tiles;
    }

    // ---- dq: staged in the warpgroup's own q boxes (their last reads are
    // complete), then 16-byte stores. The row is opaque to the compiler, so
    // the swizzled addresses are formed here, not kept from the kernel's start.
    int lre = lr;
    asm volatile("" : "+r"(lre));
    stage_rows<192>(dqa, 1.f, 1.f, sbase + q_off + 3 * wg * PANEL_BOX, 64, 0, lre, lane);
    bar_sync(4 + wg, 128);
    store_rows<192>(dq + ((size_t)c * hs + h0) * DQ + 192 * wg, DQ, smem + q_off + 3 * wg * PANEL_BOX, 64,
                    0, 64);
    fence_async_smem();
    K5B_MARK(10);
    parity ^= 1;
  }
}

// ---------------------------------------------------------------------------
// dkv[r] += the dkvg rows of the slots that selected r, in the sorted order
// ---------------------------------------------------------------------------
// a block a kv row, one thread a 16-byte vector of it: at Dq 576, 72 of 96
// threads; at the wide width 1152, 144 of 160
template <int W>
constexpr int reduce_threads() {
  return (W / 8 + 31) / 32 * 32;
}

// the 8 values of a row at `p` (16 bytes of bf16, or 32 of f32) added to acc
__device__ __forceinline__ void load8(float* v, const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(float* v, const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <int W, typename E>
__global__ void __launch_bounds__(reduce_threads<W>())
sparse_mla_dkv_reduce_kernel(const E* __restrict__ dkvg, const long long* __restrict__ order,
                             const int* __restrict__ seg, float* __restrict__ dkv) {
  const int r = blockIdx.x;
  if (threadIdx.x >= W / 8) return;
  const int col = threadIdx.x * 8;
  const int lo = seg[r], hi = seg[r + 1];
  if (lo >= hi) return;
  float acc[8];
  float* drow = dkv + (size_t)r * W + col;
  load8(acc, drow);
  int s = lo;
  for (; s + 4 <= hi; s += 4) {  // four loads in flight, added in order
    float v[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) load8(v[i], dkvg + (size_t)order[s + i] * W + col);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] += v[i][k];
  }
  for (; s < hi; ++s) {
    float v[8];
    load8(v, dkvg + (size_t)order[s] * W + col);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] += v[k];
  }
  *reinterpret_cast<float4*>(drow) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(drow + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// ---------------------------------------------------------------------------
// K5a / K5b at the wide widths: Dq 1152, Dv 1024 (twice the MLA widths; the
// wrapper zero-pads any Dq in (576, 1152] and v_dim <= 1024 to them)
// ---------------------------------------------------------------------------
// At these widths a token's 64-head q panel alone (147 KB) leaves no room for
// the 576 forms' kv stages, so both wide forms take fewer heads a block.
//   K5a: a plain SIMT form. A block a (token, group of 8 heads; H % 8 == 0:
//        no head is padded), tiles of 16 gathered rows in shared memory (rows
//        of Dq + 8 bf16, 16 bytes of skew), s by pairs of threads (halves of
//        a row, one shuffle), the online softmax one warp a head in base 2
//        with the running max floored at -1e30, bf16(p) into shared memory,
//        and o in registers (two channel pairs a thread a head). out = o /
//        max(l, 1e-30), lse = max(m, -5e29) + log(max(l, 1e-30)), as the 576
//        form. What bounds it: the operations, on the f32 units; it is right,
//        not fast (it beats one SDPA call all the same).
//   K5b: redesigned for Hopper (`sparse_mla_bwd_wide_kernel`, below). It
//        replaces `_bwd_kernel` (prime_rl_tpu/ops/sparse_mla_pallas.py:153)
//        at these widths. What bounds it, at S = Sk = 2048 and T = 512 with a
//        causal top-k (917,760 selected pairs) and 16 heads: the products
//        (0.162 TFLOP: 0.163 ms at 989 TFLOP/s), then the per-slot dkvg rows
//        it writes and the dkv reduction reads back (2.1 GB each way: about
//        1.3 ms at 3.35 TB/s for the call), which no form that keeps the dkvg
//        buffer goes below. The SIMT form it replaces (27.1 ms for the call)
//        ran its products on the f32 units from bf16 pairs in shared memory,
//        sent dq through an f32 scratch row in device memory every tile and
//        loaded q and do again every tile. The design:
//        - A block a token of the chunk (the last token first: the heaviest
//          under a causal selection) and a group of HG = 16 heads. The
//          wrapper launches a chunk's groups in ascending order, each
//          followed by the dkv reduction (as the 576 form), so each slot's
//          dkvg row is summed over a group's heads and rounded once. A last
//          group of 8 (H % 16 == 8) is half zero: TMA fills the heads past H
//          with zeros and their p and ds are 0. The token's q [16, 1152] and
//          do [16, 1024] come once by TMA (64 x 16 boxes in the 128-byte
//          swizzle) and stay for all its tiles; panel box b holds q's 16 rows
//          and then do's, so [q; do] is one 32-row K-major operand.
//        - A tile is BT = 64 slots (a tile of sentinels only is neither
//          gathered nor computed; the visited tiles are counted). It lies in
//          shared memory as 18 boxes of 64 slots x 64 channels, and
//          warpgroup w gathers, reads and frees the boxes 9 w .. 9 w + 8
//          (channels [576 w, 576 w + 576)) alone. Two whole tiles (295 KB) do
//          not fit beside the panels, so the boxes are a ring of 18 box
//          stages: as soon as phase 2 has freed box b of a tile (its dq
//          product read it, its dkvg rows left it), the warpgroup gathers box
//          b of the next visited tile into it by 16-byte cp.async (one commit
//          group a box; a sentinel slot reads nothing and lands as zeros).
//          That gather runs under the rest of phase 2 and under the next
//          tile's phase 1, which waits for its boxes one by one. Each
//          selected row is read from L2 once, not twice.
//        - Phase 1, slots on M and heads on N: [s^T | dp^T] [64 slots x 32] =
//          kvg [q; do]^T, wgmma m64n32k16 with both operands K-major over the
//          warpgroup's 576 channels (m64n16, q alone, over channels 1024 ..
//          1151). Warpgroup 1 hands its f32 partial to warpgroup 0 through
//          shared memory, and 0 adds it (a fixed order), forms p = 2^(s scale
//          log2e - lse log2e) (0 where masked) and ds = p (dp - delta) scale
//          in the registers that hold them (a thread holds s and dp of the
//          same pairs), and stores bf16(p) and ds as [16 heads][64 slots]
//          boxes, which serve as K-major B and MN-major A alike.
//        - Phase 2, box by box over the warpgroup's 9 boxes: dq^T [64
//          channels x 16 heads] += kvg^T ds^T (m64n16k16 x 4, kvg MN-major,
//          ds K-major), the token's dq^T kept in registers across its tiles
//          (72 a thread) and rounded once at its end; dkvg [64 slots x 64
//          channels] = ds^T q + bf16(p)^T do (m64n64k16, one k step each: K
//          is the 16 heads; all operands MN-major), rounded to bf16 into the
//          consumed box and sent out by one TMA store (a 3-D map over [C, T,
//          1152]: rows past T are clipped). A sentinel slot's row is written
//          as zeros and never read.
//        Which product takes which instruction: all four are wgmma, whose M
//        of 64 rows is the tile's slots (s, dp, dkvg) or a box's channels
//        (dq), with the 16 heads on N (s, dp, dq) or on K (dkvg); mma.sync's
//        m16 would put the heads on M and read the kv tile once for every
//        16 heads and q and do once for every 8 slots.
//        No atomics (the tile bits too are whole words from ballots): every
//        dq and dkvg element is written once, from sums in a fixed order, so
//        two runs give equal bits. Shared memory (bytes):
//        panels 69,632 + the tile 147,456 + p and ds 4,096 + the f32 hand-off
//        8,192 + lse and delta 128, tile bits 512, the mbarrier 16, + 1,024 of
//        alignment slack = 231,056 of the 232,448 a block may use.
//        Measured (chip_smoke.py's range-repairs and
//        scripts/torch_sparse_mla_bench.py --wide at the shape above; an
//        NVIDIA H100 80GB HBM3 at 700 W): 176 registers, no spills, 1 block an
//        SM; the call 2.33-2.40 ms (the SIMT form: 27.10), of which K5b's own
//        launches 1.01-1.06 ms and the reductions, delta and slot orders the
//        rest; without the dkvg stores (-DK5W_NO_STORES, a wrong dkv) 0.79 ms.
//        Phase clocks a tile (--timeline): about 16.4k in all, phase 2 11.4k
//        (its products, the staging, the stores' reads and the barriers),
//        phase 1 2.1k, the hand-off 1.0-1.3k, the token's start 1.1-1.3k and
//        its dq 0.5-0.8k. Tried in turns with this form and not kept, none
//        faster: box k + 1's products issued before box k is staged (and 22
//        more registers), the next tile's box gathered two or three boxes
//        behind, the two dkvg terms summed apart in f32, phase 1 summed a box
//        at a time in f32. Numerics: a token that selected one row has p = 1,
//        so its dkvg row sum_h do_h is exact and lies on a bf16 tie in a few
//        percent of its channels. Its ds is 0 in exact arithmetic; computed,
//        it is the f32 noise of dp - delta (about 1e-7), which broke those
//        ties here and in the plain version each its own way, and where a
//        few hundred such rows cancel in dkv one bf16 step of a row exceeded
//        K5B_TOL's 2e-2 + 2e-2 |ref| (16 of 120 (case, seed) pairs of the
//        bench's --wide --seeds 20). Both K5b forms and the plain version now
//        store ds = 0 for such a token (one_valid_slot), so the row is
//        bf16(sum_h do_h) in all three.
// The dkv reduction is the 576 one at width 1152.
namespace k5w {

constexpr int DQW = 1152, DVW = 1024;
constexpr int HG = 8;         // heads a group of K5a
constexpr int FWD_BT = 16;    // slots a tile of K5a
constexpr int THREADS = 256;
constexpr int PITCH = DQW + 8;
constexpr int FWD_BYTES = (HG + FWD_BT) * PITCH * 2;
constexpr float M_FLOOR = -1e30f;

// n rows of width w: row r from src + rows[r] * w (zeros where rows[r] < 0),
// or with rows null the n contiguous rows from src, into shared rows of pitch p
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, const int* rows, int n,
                                          int w, int p) {
  const int V = w / 8;
  for (int i = threadIdx.x; i < n * V; i += THREADS) {
    const int r = i / V, c = i % V;
    const long long row = rows == nullptr ? r : rows[r];
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row >= 0) val = reinterpret_cast<const uint4*>(src + (size_t)row * w)[c];
    reinterpret_cast<uint4*>(dst + r * p)[c] = val;
  }
}

// f32 dot product of the 16-byte chunks [c0, c1) of two shared rows
__device__ __forceinline__ float dot_chunks(const bf16* a, const bf16* b, int c0, int c1) {
  float acc = 0.f;
#pragma unroll 4
  for (int c = c0; c < c1; ++c) {
    const uint4 x = reinterpret_cast<const uint4*>(a)[c];
    const uint4 y = reinterpret_cast<const uint4*>(b)[c];
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fx = __bfloat1622float2(xp[e]), fy = __bfloat1622float2(yp[e]);
      acc = fmaf(fx.x, fy.x, acc);
      acc = fmaf(fx.y, fy.y, acc);
    }
  }
  return acc;
}

__device__ __forceinline__ float2 pair_at(const bf16* row, int d) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + d));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the tile's rows into rows[0, n): the index of each slot, -1 for a sentinel
// or a slot past T; true if any is real (every thread of the block calls it)
__device__ __forceinline__ bool tile_rows(const int* idx_row, int t0, int n, int T, int Sk,
                                          int* rows) {
  int r = -1;
  if (threadIdx.x < n && t0 + threadIdx.x < T) {
    const int i = idx_row[t0 + threadIdx.x];
    r = i >= 0 && i < Sk ? i : -1;
  }
  if (threadIdx.x < n) rows[threadIdx.x] = r;
  return __syncthreads_or(r >= 0);
}

}  // namespace k5w

__global__ void __launch_bounds__(k5w::THREADS, 1)
sparse_mla_fwd_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                           const int* __restrict__ indices, bf16* __restrict__ out,
                           float* __restrict__ lse, int* tiles, int S, int Sk, int T, int H,
                           float scale) {
  using namespace k5w;
  constexpr int BT = FWD_BT;
  extern __shared__ __align__(16) uint8_t wide_smem[];
  bf16* qs = reinterpret_cast<bf16*>(wide_smem);
  bf16* kvs = qs + HG * PITCH;
  __shared__ float ps[HG][BT];
  __shared__ float m_run[HG], l_run[HG], alpha[HG];
  __shared__ int rows[BT];
  const int s = blockIdx.x, h0 = blockIdx.y * HG;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float sl2 = scale * LOG2E;
  load_rows(qs, q + ((size_t)s * H + h0) * DQW, nullptr, HG, DQW, PITCH);
  if (tid < HG) {
    m_run[tid] = M_FLOOR;
    l_run[tid] = 0.f;
  }
  float acc[HG][2][2];  // [head][channel pair c: 2 tid + 512 c][2]
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
#pragma unroll
    for (int c = 0; c < 2; ++c) acc[hh][c][0] = acc[hh][c][1] = 0.f;
  const int* idx_row = indices + (size_t)s * T;
  const int n_tiles = (T + BT - 1) / BT;
  int visited = 0;
  for (int t = 0; t < n_tiles; ++t) {
    if (!tile_rows(idx_row, t * BT, BT, T, Sk, rows)) continue;
    ++visited;
    load_rows(kvs, kv, rows, BT, DQW, PITCH);
    __syncthreads();
    {  // s: two threads a (head, slot), each half of the row's 144 chunks
      const int e = tid >> 1, half = tid & 1, hh = e / BT, jj = e % BT;
      float part = dot_chunks(qs + hh * PITCH, kvs + jj * PITCH, half * (DQW / 16),
                              (half + 1) * (DQW / 16));
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (half == 0) ps[hh][jj] = rows[jj] >= 0 ? part * sl2 : MASKED;
    }
    __syncthreads();
    {  // the online softmax: warp w takes head w, lane j slot j
      const float sc = lane < BT ? ps[warp][lane] : MASKED;
      const float m_old = m_run[warp], m_new = fmaxf(m_old, wide::warp_max(sc));
      const float p = exp2f(sc - m_new), a = exp2f(m_old - m_new);
      const float sum = wide::warp_sum(p);
      if (lane < BT) ps[warp][lane] = bf16_round(p);
      if (lane == 0) {
        m_run[warp] = m_new;
        l_run[warp] = l_run[warp] * a + sum;
        alpha[warp] = a;
      }
    }
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const float a = alpha[hh];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 2 * tid + 512 * c;
        float x = acc[hh][c][0] * a, y = acc[hh][c][1] * a;
        for (int jj = 0; jj < BT; ++jj) {
          const float2 vv = pair_at(kvs + jj * PITCH, d);
          x = fmaf(ps[hh][jj], vv.x, x);
          y = fmaf(ps[hh][jj], vv.y, y);
        }
        acc[hh][c][0] = x;
        acc[hh][c][1] = y;
      }
    }
    __syncthreads();
  }
  if (tiles != nullptr && blockIdx.y == 0 && tid == 0) {
    tiles[(size_t)s * 2] = visited;
    tiles[(size_t)s * 2 + 1] = n_tiles;
  }
  if (tid < HG) {  // each head's 1 / l and lse, once, into alpha[]
    const float l = fmaxf(l_run[tid], 1e-30f);
    lse[(size_t)s * H + h0 + tid] = fmaxf(m_run[tid] * LN2, -5e29f) + logf(l);
    alpha[tid] = 1.f / l;
  }
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)s * H + h0 + hh) * DVW + 2 * tid +
                                         512 * c) =
          __floats2bfloat162_rn(acc[hh][c][0] * alpha[hh], acc[hh][c][1] * alpha[hh]);
  }
}

namespace k5bw {

constexpr int DQW = 1152, DVW = 1024;
constexpr int HG = 16;                    // heads a launch: the N of s, dp and dq, the K of dkvg
constexpr int BT = 64;                    // slots a tile: the M of s, dp and dkvg
constexpr int THREADS = 256;              // two warpgroups, each owning half of the channels
constexpr int BOXES = DQW / 64;           // 64-channel boxes of a kv row: 18
constexpr int OBOXES = DVW / 64;          // of a do row: 16
constexpr int WBOXES = BOXES / 2;         // a warpgroup's boxes: 9
constexpr int KV_BOX = BT * 128;          // a box of the tile: 64 slots x 128 bytes
constexpr int Q_BOX = HG * 128;           // a box of q or of do: 16 heads x 128 bytes
constexpr int PD_BYTES = HG * BT * 2;     // p or ds: [16 heads][64 slots] bf16, one box
constexpr int WIN = 4096;                 // tiles a scan window (one bit each)

// Offsets into the block's dynamic shared memory after its 1024-byte
// alignment; every box is 128-byte-swizzled and 1024-aligned. Panel box b <
// 16 holds q's 16 rows and then do's (4 KB); boxes 16, 17 q's alone.
constexpr int panel_off = 0;
constexpr int kv_off = panel_off + OBOXES * 2 * Q_BOX + (BOXES - OBOXES) * Q_BOX;
constexpr int p_off = kv_off + BOXES * KV_BOX;   // bf16(p)
constexpr int ds_off = p_off + PD_BYTES;         // ds
constexpr int x_off = ds_off + PD_BYTES;         // f32 [4][128] float4: warpgroup 1's partials
constexpr int rv_off = x_off + 4 * 128 * 16;     // f32 [2][16]: lse (log2 units), delta
constexpr int flag_off = rv_off + 2 * HG * 4;    // uint32 [WIN / 32]: tiles with a real index
constexpr int bar_off = flag_off + WIN / 8;      // the panels' mbarrier
constexpr int BYTES = bar_off + 16 + 1024;       // + the alignment slack
static_assert(BYTES <= 232448, "the wide K5b's shared memory exceeds what a block may use");
static_assert(BOXES == 2 * WBOXES && OBOXES > WBOXES, "warpgroup 0's boxes all hold do");

// panel box b's byte offset
__host__ __device__ constexpr int panel_box(int b) {
  return b < OBOXES ? panel_off + b * 2 * Q_BOX : panel_off + OBOXES * 2 * Q_BOX + (b - OBOXES) * Q_BOX;
}

}  // namespace k5bw

// D[64 x 16] (+)= A[64 x 16] B[16 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] += A[64 x 16] B[16 x 16], A MN-major and B K-major in shared memory
__device__ __forceinline__ void wgmma_n16_mnk(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B MN-major in shared memory
__device__ __forceinline__ void wgmma_n64_mnmn(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// a box of a 3-D tensor map into shared memory (completion on `bar`), and
// from shared memory to global in this thread's bulk group
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

// waits until at most n of this thread's cp.async groups are pending (n
// folds to a constant where the caller's loop is unrolled)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<8>(); break;
  }
}

// bf16(v) at the byte address of (row h, column s) of a [16][64] bf16 box
// in the 128-byte swizzle
__device__ __forceinline__ void st_pd128(uint32_t base, int h, int s, float v) {
  const uint32_t addr = base + h * 128 + ((((s >> 3) ^ (h & 7))) << 4) + (s & 7) * 2;
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr), "h"(__bfloat16_as_ushort(__float2bfloat16(v)))
               : "memory");
}

// One box of the wide K5b's phase 1 (k: the warpgroup's k-th, at `kvbox`
// in the tile and `panel` in the panels): wait for this thread's cp.async
// groups up to it, fence them for the tensor cores, the warpgroup's barrier,
// then [s^T | dp^T] += kvg [q; do]^T over its 64 channels (with_do) or s^T
// += kvg q^T (channels 1024 .. 1151, where do has none), committed, not
// waited
template <bool WITH_DO>
__device__ __forceinline__ void k5w_phase1_box(float (&acc)[16], int k, int wg, uint32_t kvbox,
                                               uint32_t panel) {
  cp_async_wait_n(k5bw::WBOXES - 1 - k);
  fence_async_smem();
  bar_sync(1 + wg, 128);
  const uint64_t ad = smem_desc(kvbox, 16, 1024);  // K-major: +32 bytes a k16 step
  const uint64_t bd = smem_desc(panel, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (WITH_DO)
      wgmma_ss_n32(acc, ad + 2 * kk, bd + 2 * kk, k > 0 || kk > 0);
    else
      wgmma_ss_n16(*reinterpret_cast<float(*)[8]>(&acc[0]), ad + 2 * kk, bd + 2 * kk, 1);
  }
  wgmma_commit();
}

// One box of the wide K5b's phase 2, its products: dq^T [its 64 channels x 16
// heads] += kvg^T ds^T (kvg MN-major: +2048 bytes a k16 step of 16 slots; ds
// K-major), and g = dkvg [64 slots x its 64 channels] = ds^T q (+ bf16(p)^T
// do, with_do), one k16 step each over the 16 heads, all MN-major; waited
template <bool WITH_DO>
__device__ __forceinline__ void k5w_phase2_products(float (&dqk)[8], float (&g)[32], uint32_t kvbox,
                                                    uint32_t ds_s, uint32_t p_s, uint32_t panel) {
  const uint64_t a_kv = smem_desc(kvbox, k5bw::KV_BOX, 1024);
  const uint64_t b_ds = smem_desc(ds_s, 16, 1024);
  const uint64_t a_ds = smem_desc(ds_s, k5bw::PD_BYTES, 1024);
  const uint64_t b_q = smem_desc(panel, k5bw::Q_BOX, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_n16_mnk(dqk, a_kv + 128 * kk, b_ds + 2 * kk);
  wgmma_n64_mnmn(g, a_ds, b_q, 0);
  if constexpr (WITH_DO)  // do's rows follow q's in the panel box
    wgmma_n64_mnmn(g, smem_desc(p_s, k5bw::PD_BYTES, 1024), b_q + (k5bw::Q_BOX >> 4), 1);
  wgmma_commit();
  wgmma_wait_all();
  pin(g);
  pin(dqk);
}

// ---- the wide K5b's phase clocks (scripts/torch_sparse_mla_bench.py --wide
// --timeline builds with SPARSE_MLA_TIMELINE; the port's build compiles them
// out): thread 0 of each warpgroup adds the clocks since its previous mark to
// its block's slot of the phase, and counts its tiles in slot K5W_MARKS
#ifdef SPARSE_MLA_TIMELINE
constexpr int K5W_MARKS = 5;
__device__ unsigned long long k5w_timeline[1024 * 2 * (K5W_MARKS + 1)];
#define K5W_MARK_INIT() unsigned tl_prev = clock()
#define K5W_MARK(i)                                                                        \
  do {                                                                                     \
    if (wt == 0 && blockIdx.x < 1024) {                                                    \
      const unsigned now_ = clock();                                                       \
      unsigned long long* slot_ = k5w_timeline + (blockIdx.x * 2 + wg) * (K5W_MARKS + 1);  \
      atomicAdd(slot_ + (i), (unsigned long long)(now_ - tl_prev));                       \
      if ((i) == 3) atomicAdd(slot_ + K5W_MARKS, 1ull);                                    \
      tl_prev = now_;                                                                      \
    }                                                                                      \
  } while (0)
#else
#define K5W_MARK_INIT() \
  do {                  \
  } while (0)
#define K5W_MARK(i) \
  do {              \
  } while (0)
#endif

__global__ void __launch_bounds__(k5bw::THREADS, 1)
sparse_mla_bwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_dkvg, const bf16* __restrict__ kv,
                           const int* __restrict__ indices, const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ dq,
                           int* __restrict__ tiles, int C, int Sk, int T, int H, int h0,
                           float scale) {
  using namespace k5bw;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  float4* xs = reinterpret_cast<float4*>(smem + x_off);
  float* rv = reinterpret_cast<float*>(smem + rv_off);
  uint32_t* flags = reinterpret_cast<uint32_t*>(smem + flag_off);
  const uint32_t bar = sbase + bar_off;

  const int tid = threadIdx.x, wt = tid % 128, warp = tid / 32, lane = tid % 32;
  // the warpgroup, broadcast from lane 0: the compiler then knows a branch on
  // it is warp-uniform, and does not serialize the wgmmas inside it
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lr = 16 * (wt / 32) + lane / 4;  // this thread's rows lr, lr + 8 of a 64-row tile
  // a gathering thread moves the 16-byte chunk `part` of rows grow + 16 k (k < 4) of a box:
  // 8 threads a row, so each warp instruction reads four whole 128-byte lines
  const int grow = wt / 8, part = wt % 8;
  const float sl2 = scale * LOG2E;
  const int n_tiles = (T + BT - 1) / BT;
  const int c = C - 1 - blockIdx.x;  // under a causal selection the late tokens hold the most tiles
  const int* irow = indices + (size_t)c * T;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < HG) {  // the group's lse (log2 units) and delta; 0 for a head past H
    const bool real = h0 + tid < H;
    rv[tid] = real ? lse[(size_t)c * H + h0 + tid] * LOG2E : 0.f;
    rv[HG + tid] = real ? delta[(size_t)c * H + h0 + tid] : 0.f;
  }
  __syncthreads();
  K5W_MARK_INIT();
  if (tid == THREADS - 32) {  // the token's panels, once (heads past H land as zeros)
    mbar_arrive_expect_tx(bar, (BOXES + OBOXES) * Q_BOX);
    for (int b = 0; b < BOXES; ++b) tma_load_3d(sbase + panel_box(b), &tm_q, bar, b * 64, h0, c);
    for (int b = 0; b < OBOXES; ++b)
      tma_load_3d(sbase + panel_box(b) + Q_BOX, &tm_do, bar, b * 64, h0, c);
  }
  const bool one_row = one_valid_slot<THREADS>(irow, T, Sk);  // then ds = 0

  float dqa[WBOXES][8];  // dq^T of the warpgroup's boxes: [64 channels x 16 heads] each
#pragma unroll
  for (int k = 0; k < WBOXES; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) dqa[k][i] = 0.f;
  int visited = 0;

  for (int w0 = 0; w0 < n_tiles; w0 += WIN) {
    const int nw = min(WIN, n_tiles - w0);
    // one bit a tile: does it hold a real index? Warp w builds the words w,
    // w + 8, ... of 32 tiles each, eight tiles' loads in flight, one ballot a
    // tile, and stores each word whole (every thread is past its last read
    // of the previous window's)
    if (w0 > 0) __syncthreads();
    for (int wd = warp; wd < (nw + 31) / 32; wd += THREADS / 32) {
      uint32_t bits = 0;
      for (int b0 = 0; b0 < 32 && wd * 32 + b0 < nw; b0 += 8) {
        int v[8][2];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int t = wd * 32 + b0 + k;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = (w0 + t) * BT + 32 * h + lane;
            v[k][h] = t < nw && j < T ? irow[j] : -1;
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const bool real = (v[k][0] >= 0 && v[k][0] < Sk) || (v[k][1] >= 0 && v[k][1] < Sk);
          if (__ballot_sync(0xffffffffu, real)) bits |= 1u << (b0 + k);
        }
      }
      if (lane == 0) flags[wd] = bits;
    }
    __syncthreads();

    // the kv rows of this thread's rows of window tile t (-1: a sentinel,
    // past T, or no such tile)
    auto row_ids = [&](int t, int (&id)[4]) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = (w0 + t) * BT + grow + 16 * k;
        int v = -1;
        if (t < nw && j < T) {
          v = irow[j];
          if (v < 0 || v >= Sk) v = -1;
        }
        id[k] = v;
      }
    };
    // box b of a tile into its place, one commit group
    auto gather_box = [&](const int (&id)[4], int b) {
      const uint32_t dst = sbase + kv_off + b * KV_BOX + ((part ^ (grow & 7)) << 4);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cp_async16(dst + (grow + 16 * k) * 128,
                   kv + (size_t)(id[k] < 0 ? 0 : id[k]) * DQW + b * 64 + part * 8, id[k] >= 0);
      cp_async_commit();
    };

    int cur = next_tile(flags, -1, nw);
    int nid[4];
    row_ids(cur, nid);
    if (cur < nw) {
#pragma unroll
      for (int k = 0; k < WBOXES; ++k) gather_box(nid, WBOXES * wg + k);
    }
    if (w0 == 0) mbar_wait(bar, 0);
    K5W_MARK(0);

    while (cur < nw) {
      const int j0 = (w0 + cur) * BT;
      const int nxt = next_tile(flags, cur, nw);
      row_ids(nxt, nid);
      // the shared base, opaque to the compiler a tile: the descriptors below
      // are formed where they are used, not kept in registers the dq
      // accumulator needs
      uint32_t sb = sbase;
      asm volatile("" : "+r"(sb));

      // ---- phase 1: [s^T | dp^T] of the warpgroup's channels, box by box as
      // each lands (its own cp.async groups, then the warpgroup's barrier)
      float acc[16];
      const uint32_t kvb = sb + kv_off;
      if (wg == 0) {
#pragma unroll
        for (int k = 0; k < WBOXES; ++k)
          k5w_phase1_box<true>(acc, k, 0, kvb + k * KV_BOX, sb + panel_box(k));
      } else {
#pragma unroll
        for (int k = 0; k < OBOXES - WBOXES; ++k)
          k5w_phase1_box<true>(acc, k, 1, kvb + (WBOXES + k) * KV_BOX, sb + panel_box(WBOXES + k));
#pragma unroll
        for (int k = OBOXES - WBOXES; k < WBOXES; ++k)
          k5w_phase1_box<false>(acc, k, 1, kvb + (WBOXES + k) * KV_BOX, sb + panel_box(WBOXES + k));
      }
      wgmma_wait_all();
      pin(acc);
      K5W_MARK(1);

      // ---- warpgroup 1's partials to warpgroup 0, which adds them and forms
      // p and ds: columns 8 i + 2 (lane % 4) + {0, 1} (i < 2) are s of 16
      // heads, the same columns + 16 their dp
      if (wg == 1) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          xs[v * 128 + wt] = make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
        bar_arrive(3, 256);
      } else {
        const int ja = j0 + lr, jb = ja + 8;
        const int ia = ja < T ? irow[ja] : -1, ib = jb < T ? irow[jb] : -1;
        const bool ra = ia >= 0 && ia < Sk, rb = ib >= 0 && ib < Sk;
        bar_sync(3, 256);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 x = xs[v * 128 + wt];
          acc[4 * v] += x.x;
          acc[4 * v + 1] += x.y;
          acc[4 * v + 2] += x.z;
          acc[4 * v + 3] += x.w;
        }
        const uint32_t p_s = sb + p_off, ds_s = sb + ds_off;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int h = 8 * i + 2 * (lane & 3) + jj;
            const bool hr = h0 + h < H;
            const float l2 = rv[h], dl = rv[HG + h];
            // a masked score is -inf before the exponential, so its p is 0
            const float pa = ex2(ra && hr ? fmaf(acc[4 * i + jj], sl2, -l2) : MASKED);
            const float pb = ex2(rb && hr ? fmaf(acc[4 * i + 2 + jj], sl2, -l2) : MASKED);
            st_pd128(p_s, h, lr, pa);
            st_pd128(p_s, h, lr + 8, pb);
            st_pd128(ds_s, h, lr, one_row ? 0.f : pa * (acc[4 * i + 8 + jj] - dl) * scale);
            st_pd128(ds_s, h, lr + 8, one_row ? 0.f : pb * (acc[4 * i + 10 + jj] - dl) * scale);
          }
        }
        fence_async_smem();
      }
      bar_sync(4, 256);  // p and ds in place
      K5W_MARK(2);

      // ---- phase 2, box by box: dq^T += kvg^T ds^T; dkvg = ds^T q (+ p^T
      // do) into the consumed box, then out by TMA; the freed box takes the
      // next tile's (the last box's after the loop)
#pragma unroll
      for (int k = 0; k < WBOXES; ++k) {
        const int b = WBOXES * wg + k;
        const uint32_t box = kvb + b * KV_BOX;
        float g[32];
        if (b < OBOXES)
          k5w_phase2_products<true>(dqa[k], g, box, sb + ds_off, sb + p_off, sb + panel_box(b));
        else
          k5w_phase2_products<false>(dqa[k], g, box, sb + ds_off, sb + p_off, sb + panel_box(b));
        if (wt == 0) bulk_wait_read();  // the last box's dkvg rows have left it
        bar_sync(1 + wg, 128);          // and every warp is done reading this box
        if (k > 0 && nxt < nw) gather_box(nid, b - 1);
        stage_rows<64>(g, 1.f, 1.f, box, 64, 0, lr, lane);
        fence_async_smem();
        bar_sync(1 + wg, 128);
#ifndef K5W_NO_STORES  // a measurement variant (the bench's --wide --variants): no dkvg rows, a wrong dkv
        if (wt == 0) {
          tma_store_3d(&tm_dkvg, box, b * 64, j0, c);
          bulk_commit();
        }
#endif
      }
      if (wt == 0) bulk_wait_read();
      bar_sync(1 + wg, 128);
      if (nxt < nw) gather_box(nid, WBOXES * wg + WBOXES - 1);
      K5W_MARK(3);
      cur = nxt;
      ++visited;
    }
  }
  if (tiles != nullptr && tid == 0) {  // [C, 2]: visited, candidates
    tiles[2 * c] = visited;
    tiles[2 * c + 1] = n_tiles;
  }

  // ---- dq, rounded once: this thread holds channels lr, lr + 8 of each of
  // the warpgroup's boxes for heads 8 i + 2 (lane % 4) + {0, 1}
#pragma unroll
  for (int k = 0; k < WBOXES; ++k) {
    const int ch = 64 * (WBOXES * wg + k) + lr;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int h = 8 * i + 2 * (lane & 3) + jj;
        if (h0 + h < H) {
          bf16* row = dq + ((size_t)c * H + h0 + h) * DQW + ch;
          row[0] = __float2bfloat16(dqa[k][4 * i + jj]);
          row[8] = __float2bfloat16(dqa[k][4 * i + 2 + jj]);
        }
      }
    }
  }
  K5W_MARK(4);
  if (wt == 0) bulk_wait_all();  // the last TMA stores are complete before the block leaves
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *configured = true;
  return err;
}

// `heads` is the row stride of q, do, out, lse, delta and dq in heads (a
// multiple of 64: the wrapper pads q's heads), `h0` the first head of the
// launch's group of 64
bool widths_ok(int heads, int h0, int dq, int dv) {
  return heads > 0 && heads % H == 0 && h0 >= 0 && h0 < heads && h0 % H == 0 && dq == DQ &&
         dv == DV;
}

// K5a over S tokens; `tiles` (int32 [S, 2]: visited, candidates) or null
int run_fwd(const void* q, const void* kv, const void* indices, void* out, void* lse, int* tiles,
            int S, int Sk, int T, int heads, int h0, int dqw, int dv, float scale, void* stream) {
  if (!widths_ok(heads, h0, dqw, dv) || S < 0 || Sk <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  static bool configured = false;
  cudaError_t err = configure(sparse_mla_fwd_kernel, k5a::BYTES, &configured);
  if (err != cudaSuccess) return (int)err;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq;  // the tokens' q panels: [S * heads, 576] bf16 in boxes of 64 x 64
  if (!matrix_map(&tq, encode, q, DQ, S * heads, 64, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  sparse_mla_fwd_kernel<<<S < sms ? S : sms, k5a::THREADS, k5a::BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      tq, static_cast<const bf16*>(kv), static_cast<const int*>(indices), static_cast<bf16*>(out),
      static_cast<float*>(lse), tiles, S, Sk, T, heads, h0, scale);
  return (int)cudaGetLastError();
}

#ifdef SPARSE_MLA_TIMELINE
// n values of a phase-clock symbol into `dst`, then the symbol zeroed
template <typename Symbol>
int timeline_copy(void* dst, size_t n, const Symbol& symbol, size_t size) {
  const size_t bytes = n * sizeof(unsigned long long);
  if (bytes > size) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyFromSymbol(dst, symbol, bytes);
  void* addr = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&addr, symbol);
  if (err == cudaSuccess) err = cudaMemset(addr, 0, size);
  return (int)err;
}
#endif

// one chunk of C queries: every pointer but kv starts at the chunk's first
// query; `tiles` (int32 [C, 2]: visited, candidates) or null
int run_bwd(const void* q, const void* kv, const void* indices, const void* dout,
            const void* lse, const void* delta, void* dq, void* dkvg, int* tiles, int C, int Sk,
            int T, int heads, int h0, int dqw, int dv, float scale, void* stream) {
  if (!widths_ok(heads, h0, dqw, dv) || C < 0 || Sk <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  static bool configured = false;
  cudaError_t err = configure(sparse_mla_bwd_kernel, k5b::BYTES, &configured);
  if (err != cudaSuccess) return (int)err;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // the token's panels: [C * heads, 576] and [C * heads, 512] bf16 in boxes of 64 x 64
  CUtensorMap tq, tdo;
  if (!matrix_map(&tq, encode, q, DQ, C * heads, 64, CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !matrix_map(&tdo, encode, dout, DV, C * heads, 64, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  sparse_mla_bwd_kernel<<<C < sms ? C : sms, k5b::THREADS, k5b::BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      tq, tdo, static_cast<const bf16*>(kv), static_cast<const int*>(indices),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dq),
      static_cast<float*>(dkvg), tiles, C, Sk, T, heads, h0, scale);
  return (int)cudaGetLastError();
}

// K5a at the wide widths over S tokens (H % 8 == 0, no head padding)
int run_fwd_wide(const void* q, const void* kv, const void* indices, void* out, void* lse,
                 int* tiles, int S, int Sk, int T, int H, float scale, void* stream) {
  if (H <= 0 || H % k5w::HG || S < 0 || Sk <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  static bool configured = false;
  cudaError_t err = configure(sparse_mla_fwd_wide_kernel, k5w::FWD_BYTES, &configured);
  if (err != cudaSuccess) return (int)err;
  sparse_mla_fwd_wide_kernel<<<dim3(S, H / k5w::HG), k5w::THREADS, k5w::FWD_BYTES,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kv), static_cast<const int*>(indices),
      static_cast<bf16*>(out), static_cast<float*>(lse), tiles, S, Sk, T, H, scale);
  return (int)cudaGetLastError();
}

// a row-major [d2, d1, d0] bf16 tensor as a 3-D map (d0, d1, d2) with boxes
// of (64, rows, 1) in the 128-byte swizzle (a box lands as wgmma's
// 128-byte-swizzled tile of `rows` rows); out of range reads give 0 and out of
// range writes are dropped. d0 must be a multiple of 8 (rows on 16 bytes).
bool map3d(CUtensorMap* map, EncodeTiled encode, const void* ptr, int d0, int d1, int d2, int rows,
           CUtensorMapL2promotion promotion) {
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 2, (cuuint64_t)d0 * d1 * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, promotion,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the wide K5b over one chunk of C queries and the group of 16 heads from h0
// (every pointer but kv from the chunk's first query; dkvg [>= C, T, 1152])
int run_bwd_wide(const void* q, const void* kv, const void* indices, const void* dout,
                 const void* lse, const void* delta, void* dq, void* dkvg, int* tiles, int C,
                 int Sk, int T, int H, int h0, float scale, void* stream) {
  using namespace k5bw;
  if (H <= 0 || H % 8 || h0 < 0 || h0 >= H || h0 % HG || C < 0 || Sk <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  static bool configured = false;
  cudaError_t err = configure(sparse_mla_bwd_wide_kernel, BYTES, &configured);
  if (err != cudaSuccess) return (int)err;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // the token's panels: [C, H, 1152] and [C, H, 1024] in boxes of 64 x 16
  // heads; the dkvg rows [C, T, 1152] in boxes of 64 x 64 slots
  CUtensorMap tq, tdo, tdkvg;
  if (!map3d(&tq, encode, q, DQW, H, C, HG, CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !map3d(&tdo, encode, dout, DVW, H, C, HG, CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !map3d(&tdkvg, encode, dkvg, DQW, T, C, BT, CU_TENSOR_MAP_L2_PROMOTION_NONE))
    return (int)cudaErrorInvalidValue;
  sparse_mla_bwd_wide_kernel<<<C, THREADS, BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tdo, tdkvg, static_cast<const bf16*>(kv), static_cast<const int*>(indices),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dq),
      tiles, C, Sk, T, H, h0, scale);
  return (int)cudaGetLastError();
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

extern "C" int sparse_mla_fwd(const void* q, const void* kv, const void* indices, void* out,
                              void* lse, int S, int Sk, int T, int heads, int h0, int dq, int dv,
                              float scale, void* stream) {
  return run_fwd(q, kv, indices, out, lse, nullptr, S, Sk, T, heads, h0, dq, dv, scale, stream);
}

// the same launch, also writing each token's tile counts into `tiles`
// (int32 [S, 2]: tiles of k5a::BT slots visited, candidates)
extern "C" int sparse_mla_fwd_tiles(const void* q, const void* kv, const void* indices, void* out,
                                    void* lse, int S, int Sk, int T, int heads, int h0, int dq,
                                    int dv, float scale, void* stream, void* tiles) {
  return run_fwd(q, kv, indices, out, lse, static_cast<int*>(tiles), S, Sk, T, heads, h0, dq, dv,
                 scale, stream);
}

// K5a's slots a tile, its dynamic shared memory a block, the blocks an SM
// holds at it, and its phase clocks (as K5b's below)
extern "C" int sparse_mla_fwd_tile() { return k5a::BT; }

extern "C" int sparse_mla_fwd_smem() { return k5a::BYTES; }

extern "C" int sparse_mla_fwd_blocks_per_sm() {
  int n = 0;
  if (cudaFuncSetAttribute(sparse_mla_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           k5a::BYTES) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sparse_mla_fwd_kernel, k5a::THREADS,
                                                    k5a::BYTES) != cudaSuccess)
    return -1;
  return n;
}

extern "C" int sparse_mla_fwd_timeline(void* dst, size_t n) {
#ifdef SPARSE_MLA_TIMELINE
  return timeline_copy(dst, n, k5a_timeline, sizeof(k5a_timeline));
#else
  (void)dst;
  (void)n;
  return (int)cudaErrorNotSupported;
#endif
}

extern "C" int sparse_mla_bwd(const void* q, const void* kv, const void* indices,
                              const void* dout, const void* lse, const void* delta, void* dq,
                              void* dkvg, int C, int Sk, int T, int heads, int h0, int dqw,
                              int dv, float scale, void* stream) {
  return run_bwd(q, kv, indices, dout, lse, delta, dq, dkvg, nullptr, C, Sk, T, heads, h0, dqw,
                 dv, scale, stream);
}

// the same launch, also writing each token's tile counts into `tiles`
// (int32 [C, 2]: tiles of 32 slots visited, candidates)
extern "C" int sparse_mla_bwd_tiles(const void* q, const void* kv, const void* indices,
                                    const void* dout, const void* lse, const void* delta, void* dq,
                                    void* dkvg, int C, int Sk, int T, int heads, int h0, int dqw,
                                    int dv, float scale, void* stream, void* tiles) {
  return run_bwd(q, kv, indices, dout, lse, delta, dq, dkvg, static_cast<int*>(tiles), C, Sk, T,
                 heads, h0, dqw, dv, scale, stream);
}

// K5b's dynamic shared memory a block and the blocks an SM holds at it
extern "C" int sparse_mla_bwd_smem() { return k5b::BYTES; }

// the phase clocks of a build with SPARSE_MLA_TIMELINE into `dst` (n values:
// [block][warpgroup][K5B_MARKS + 1]), then zeroed
extern "C" int sparse_mla_bwd_timeline(void* dst, size_t n) {
#ifdef SPARSE_MLA_TIMELINE
  return timeline_copy(dst, n, k5b_timeline, sizeof(k5b_timeline));
#else
  (void)dst;
  (void)n;
  return (int)cudaErrorNotSupported;
#endif
}

extern "C" int sparse_mla_bwd_blocks_per_sm() {
  int n = 0;
  if (cudaFuncSetAttribute(sparse_mla_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           k5b::BYTES) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sparse_mla_bwd_kernel, k5b::THREADS,
                                                    k5b::BYTES) != cudaSuccess)
    return -1;
  return n;
}

// the compiled K5a (kernel 0), K5b (1) or dkv reduction (2), or their wide
// forms (3, 4, 5), as the runtime
// loaded it: attrs = {registers a thread, local memory a thread in bytes
// (spills; 0 when none), static shared memory in bytes, threads a block}
extern "C" int sparse_mla_attributes(int kernel, int* attrs) {
  if (kernel == 0) return attributes(sparse_mla_fwd_kernel, attrs);
  if (kernel == 1) return attributes(sparse_mla_bwd_kernel, attrs);
  if (kernel == 2) return attributes(sparse_mla_dkv_reduce_kernel<DQ, float>, attrs);
  if (kernel == 3) return attributes(sparse_mla_fwd_wide_kernel, attrs);
  if (kernel == 4) return attributes(sparse_mla_bwd_wide_kernel, attrs);
  if (kernel == 5) return attributes(sparse_mla_dkv_reduce_kernel<k5w::DQW, bf16>, attrs);
  return (int)cudaErrorInvalidValue;
}
// dkv [Sk, Dq] f32 += over the slots order[seg[r] .. seg[r + 1]) of dkvg [slots, Dq]:
// f32 rows at Dq 576 (K5b's), bf16 rows at 1152 (the wide K5b's)
extern "C" int sparse_mla_dkv_reduce(const void* dkvg, const void* order, const void* seg,
                                     void* dkv, int Sk, int dqw, void* stream) {
  if ((dqw != DQ && dqw != k5w::DQW) || Sk <= 0) return (int)cudaErrorInvalidValue;
  const long long* o = static_cast<const long long*>(order);
  const int* sg = static_cast<const int*>(seg);
  float* d = static_cast<float*>(dkv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dqw == DQ)
    sparse_mla_dkv_reduce_kernel<DQ, float><<<Sk, reduce_threads<DQ>(), 0, st>>>(
        static_cast<const float*>(dkvg), o, sg, d);
  else
    sparse_mla_dkv_reduce_kernel<k5w::DQW, bf16><<<Sk, reduce_threads<k5w::DQW>(), 0, st>>>(
        static_cast<const bf16*>(dkvg), o, sg, d);
  return (int)cudaGetLastError();
}

// K5a at the wide widths (Dq 1152, Dv 1024), one launch for all H heads;
// `tiles` (int32 [S, 2]: tiles of 16 slots visited, candidates) or null
extern "C" int sparse_mla_fwd_wide(const void* q, const void* kv, const void* indices, void* out,
                                   void* lse, int S, int Sk, int T, int H, float scale,
                                   void* stream, void* tiles) {
  return run_fwd_wide(q, kv, indices, out, lse, static_cast<int*>(tiles), S, Sk, T, H, scale,
                      stream);
}

// the wide K5b over a chunk and the group of 16 heads from h0; `tiles` (int32
// [C, 2]: tiles of 64 slots visited, candidates) or null
extern "C" int sparse_mla_bwd_wide(const void* q, const void* kv, const void* indices,
                                   const void* dout, const void* lse, const void* delta, void* dq,
                                   void* dkvg, int C, int Sk, int T, int H, int h0, float scale,
                                   void* stream, void* tiles) {
  return run_bwd_wide(q, kv, indices, dout, lse, delta, dq, dkvg, static_cast<int*>(tiles), C, Sk,
                      T, H, h0, scale, stream);
}

// the wide forms' slots a tile: K5a's (kernel 0) or K5b's (1)
extern "C" int sparse_mla_wide_tile(int kernel) {
  return kernel == 0 ? k5w::FWD_BT : k5bw::BT;
}

// the wide K5b's heads a launch, its dynamic shared memory a block, the
// blocks an SM holds at it, and its phase clocks (as K5b's above: n values
// [block][warpgroup][K5W_MARKS + 1])
extern "C" int sparse_mla_bwd_wide_heads() { return k5bw::HG; }

extern "C" int sparse_mla_bwd_wide_smem() { return k5bw::BYTES; }

extern "C" int sparse_mla_bwd_wide_blocks_per_sm() {
  int n = 0;
  if (cudaFuncSetAttribute(sparse_mla_bwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           k5bw::BYTES) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sparse_mla_bwd_wide_kernel, k5bw::THREADS,
                                                    k5bw::BYTES) != cudaSuccess)
    return -1;
  return n;
}

extern "C" int sparse_mla_bwd_wide_timeline(void* dst, size_t n) {
#ifdef SPARSE_MLA_TIMELINE
  return timeline_copy(dst, n, k5w_timeline, sizeof(k5w_timeline));
#else
  (void)dst;
  (void)n;
  return (int)cudaErrorNotSupported;
#endif
}
