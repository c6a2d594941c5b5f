// Hopper building blocks shared by the flash-attention kernels
// (flash_attn_fwd.cu: K1; flash_attn_bwd.cu: K2a, K2b) and the decode QKV
// prep (decode_qkv.cu: K3): mbarriers, TMA loads, wgmma shared-memory
// descriptors and products, and the host's tensor maps.
// Everything is in an anonymous namespace: each kernel source gets its own
// copy. ops/_build.py hashes this header with every source, so a change here
// rebuilds every library.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// waits until the phase of parity `parity` has completed; a wait that never
// ends (a pipeline fault) traps after 2^26 tries instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// one box of a 4-D tensor map into shared memory, completion on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of a 1-D tensor map into shared memory, completion on `bar`
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// one box of a 2-D tensor map into shared memory, completion on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both on 16
// bytes) by the bulk copy engine, no tensor map; completion on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A 1-D box must start on 16 bytes, so a flat map's box of n 4-byte elements
// from element `start` (any) is loaded from the aligned element below it,
// FLAT_PAD elements longer, and read from element `start & 3` of the slot.
constexpr int FLAT_PAD = 4;

// bytes of a shared-memory slot for such a box of n elements (128-aligned)
constexpr int flat_slot_bytes(int n) { return ((n + FLAT_PAD) * 4 + 127) / 128 * 128; }

// elements [start, start + n) of a flat map with boxes of n + FLAT_PAD elements
// into the slot at `dst`, completion on `bar`; they begin at element start & 3
__device__ __forceinline__ void tma_load_flat(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int start) {
  tma_load_1d(dst, map, bar, start & ~3);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (K-major: stride = the 1024 bytes between groups of
// 8 rows; MN-major: leading = the bytes between 64-column boxes, stride = the
// 1024 bytes between groups of 8 rows along K)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of wgmma's registers across the wait
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MASKED __int_as_float(0xff800000)  // -inf: the score of a masked entry

__device__ __forceinline__ float ex2(float x) {  // 2^x; -1e30-scale arguments give 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] B[32 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x N] (+)= A[64 x 16] B[N x 16]^T, A and B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 128) {
    wgmma_ss_n128(d, da, db, accumulate);
  } else if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, accumulate);
  } else {
    wgmma_ss_n32(d, da, db, accumulate);
  }
}

// D[64 x N] += A[64 x 16] B[16 x N], A in registers, B MN-major in shared memory.
// N = 256 is two n128 products and N = 192 an n128 and an n64: columns [128,
// N) of B start two 64-column boxes (twice the descriptor's leading byte
// offset) on, and their accumulators are d[64..], where m64nN's own layout
// puts them.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 256 || N == 192) {
    const uint64_t box = (db >> 16) & 0x3FFF;  // the leading byte offset >> 4
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a, db);
    if constexpr (N == 256)
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a, db + 2 * box);
    else
      wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(&d[64]), a, db + 2 * box);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    wgmma_rs_n64(d, a, db);
  }
}

// the byte address of a thread's two bf16 accumulator columns in a swizzled
// tile of `rows` rows: row r, 8-column group i (each box holds 8 groups)
__device__ __forceinline__ uint32_t swizzled(uint32_t base, int rows, int r, int i, int lane) {
  return base + (i / 8) * rows * 128 + r * 128 + (((i % 8) ^ (r % 8)) * 16) + (lane % 4) * 4;
}

// a warpgroup's accumulator [64 rows x HD] as bf16 into the rows [r_base,
// r_base + 64) of a swizzled tile of `rows` rows, this thread's row lr times
// mul0 and row lr + 8 times mul1
template <int HD>
__device__ __forceinline__ void stage_rows(const float (&acc)[HD / 2], float mul0, float mul1,
                                           uint32_t base, int rows, int r_base, int lr, int lane) {
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const uint32_t a = swizzled(base, rows, r_base + lr, i, lane);
    const uint32_t v0 = pack_bf16(acc[4 * i] * mul0, acc[4 * i + 1] * mul0);
    const uint32_t v1 = pack_bf16(acc[4 * i + 2] * mul1, acc[4 * i + 3] * mul1);
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v0) : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a + 8 * 128), "r"(v1) : "memory");
  }
}

// rows [r_base, r_base + 64) of a staged swizzled tile to rows row0 + r of a
// [L, heads, HD] tensor (row stride `stride` elements), 16 bytes a store by the
// warpgroup's 128 threads; rows at or past `valid` are not written
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t stride,
                                           const unsigned char* staged, int rows, int r_base,
                                           int valid) {
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x % 128; idx < 64 * CHUNKS; idx += 128) {
    const int rl = idx / CHUNKS, c = idx % CHUNKS;
    if (rl >= valid) continue;
    const int r = r_base + rl;
    const uint4 val = *reinterpret_cast<const uint4*>(staged + (c / 8) * rows * 128 + r * 128 +
                                                      (((c % 8) ^ (r % 8)) * 16));
    *reinterpret_cast<uint4*>(dst + rl * stride + c * 8) = val;
  }
}

// ---- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime: no -lcuda link
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [batch, len, heads, HD] bf16 as a 4-D map (HD, heads, len, batch) with
// boxes of (64, 1, rows, 1) in the 128-byte swizzle; out of range reads give 0
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int hd, int heads, int len,
                int batch, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)len,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)len * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a row-major [rows, cols] bf16 matrix as a 2-D map (cols, rows) with boxes
// of (64, box_rows) in the 128-byte swizzle (a box lands as wgmma's
// 128-byte-swizzled tile); out of range reads give 0 and touch no memory.
// `cols` must be a multiple of 8 (rows start on 16 bytes).
bool matrix_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int cols, int rows,
                int box_rows, CUtensorMapL2promotion promotion) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, promotion,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a flat 1-D array of n 4-byte elements (segment ids, lse, delta) with boxes
// of `box` elements; out of range reads give 0. A box must start on 16 bytes
// (`tma_load_flat` sees to it); a 2-D map would need the row length a
// multiple of 4.
bool flat_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int n, int box,
              CUtensorMapDataType type) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};  // a 1-D map has none
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t elem[1] = {1};
  return encode(map, type, 1, const_cast<void*>(ptr), dims, strides, boxes, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the card's SM count, read once
cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached;
  return cudaSuccess;
}

// ---- head dims 384 and 512: the plain SIMT form of K1 -----------------------
// Above 256 a 64-row tile's f32 accumulator no longer fits one warpgroup's
// registers and a wgmma ring no longer fits the SM's shared memory, so K1
// runs a simple form at these widths (K2a and K2b have wgmma forms of their
// own, in flash_attn_bwd.cu): small tiles in shared memory (rows of HD + 8
// bf16, 16 bytes of skew, so that 16-byte loads of eight rows at one column
// hit every bank once), f32 dot products and f32 accumulators in registers
// (two adjacent columns a thread), one fixed order of every sum.
namespace wide {

constexpr int THREADS = 256;

template <int HD>
__host__ __device__ constexpr int pitch() {
  return HD + 8;
}

// rows [r0, r0 + n) of head h of a [B, L, heads, HD] bf16 tensor into shared
// rows of pitch<HD>(); rows at or past L are zeros
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int b,
                                          int L, int heads, int h, int r0, int n) {
  constexpr int V = HD / 8;
  for (int i = threadIdx.x; i < n * V; i += THREADS) {
    const int r = i / V, c = i % V, row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < L)
      val = reinterpret_cast<const uint4*>(src + (((size_t)b * L + row) * heads + h) * HD)[c];
    reinterpret_cast<uint4*>(dst + r * pitch<HD>())[c] = val;
  }
}

// the f32 dot product of two shared rows of HD bf16, in one fixed order
template <int HD>
__device__ __forceinline__ float dot_rows(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  float acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < HD / 8; ++c) {
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

// columns d, d + 1 of a shared row as f32
__device__ __forceinline__ float2 pair_at(const __nv_bfloat16* row, int d) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + d));
}

// query row r (segment sr) sees key c (segment sc)
__device__ __forceinline__ bool visible(int r, int c, int sr, int sc, int causal, int window) {
  return sr != 0 && sr == sc && (!causal || r >= c) && (window <= 0 || r - c < window);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// [lo, hi] of the non-zero ids among ids[0, n) (lo > hi when none), through
// two shared ints; every thread of the block calls it
__device__ __forceinline__ void segment_range(const int* ids, int n, int* lo, int* hi) {
  if (threadIdx.x == 0) {
    *lo = 0x7fffffff;
    *hi = -0x7fffffff;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += THREADS)
    if (ids[i] != 0) {
      atomicMin(lo, ids[i]);
      atomicMax(hi, ids[i]);
    }
  __syncthreads();
}

}  // namespace wide

}  // namespace
