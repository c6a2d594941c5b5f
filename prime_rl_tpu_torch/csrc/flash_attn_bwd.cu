// K2a / K2b: packed-segment flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels prime_rl_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` (K2a, the first pallas_call in `_bwd`) and
// `_bwd_dkv_kernel` (K2b, the second). Same contract as the forward (K1,
// flash_attn_fwd.cu): q/do/dq [B, Lq, NH, HD], k/v/dk/dv [B, Lk, NKV, HD]
// bf16; segment ids [B, L] int32 with 0 = padding; lse and delta f32
// [B, NH, Lq], where delta = sum(out * do, -1) minus the lse cotangent (the
// wrapper computes it). With mask = same non-zero segment, (causal)
// row >= col and (window > 0) row - col < window:
//
//   s  = q k^T * scale              p  = mask ? exp(s - lse) : 0
//   dp = do v^T                     ds = bf16(p * (dp - delta))
//   dq = (sum_kv ds k) * scale                                   (K2a)
//   dv = sum_{g, q} bf16(p)^T do    dk = (sum_{g, q} ds^T q) * scale   (K2b)
//
// The mask selects instead of multiplying, so a row that saw no key
// (lse = -1e30: padding, dummy rows) never evaluates exp(s + 1e30): it gives
// dq = 0 and adds nothing to dk/dv whatever `do` holds.
//
// Sliding windows run banded, as in the TPU kernels: K2a's kv-tile loop
// starts at the band's first tile (q0 - window + 1) / BK (`_band_lo`), and
// K2b's q-tile loop stops after the last q tile that reaches its kv tile,
// (k0 + BK + window - 2) / BQ (the transposed band of `_bwd_dkv_kernel`).
// Attention sinks need no input here: the sink is inside the saved lse, and
// its own gradient is a reduction over (lse, delta) that the wrapper does.
// The window is a template flag (WINDOW) besides its value: K2b at head dim
// 128 runs at the 255-register limit, and with the band's arithmetic compiled
// into the dense form it ran 1.5x slower (0.60 against 0.39 ms at B=8, L=512,
// 16/8 heads on an H100).
//
// What bounds them on the H100: like the forward they are compute-bound at
// training lengths (K2a three, K2b four tile products of 2*64*64*HD flops
// per visited tile pair against a few bytes per element), so the tensor
// cores are the resource. This first version uses WMMA bf16 16x16x16 tiles
// with f32 accumulation, 4 warps per block:
//   K2a: one block per (batch, q head, 64-row q tile); each warp owns 16 q
//        rows and keeps its dq accumulator in register fragments while K/V
//        tiles stream through shared memory up to the causal diagonal.
//   K2b: one block per (batch, kv head, 64-row kv tile); each warp owns 16
//        kv rows, computes the TRANSPOSED tiles s^T = k q^T and dp^T = v do^T
//        so that its rows of p^T and ds^T are its own, and keeps dk and dv in
//        register fragments while it loops over the q heads of the GQA group
//        and the q tiles from the diagonal on. One block writes each dk/dv
//        element once: no atomics, so results are the same run after run.
// Tiles above the diagonal are skipped in both. The heavy blocks (late q
// tiles in K2a, early kv tiles in K2b) are scheduled first. wgmma, TMA and
// pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

template <int HD>
struct Smem {
  static constexpr int QLD = HD + 8;  // bf16 row stride of the Q, dO, K, V tiles
  static constexpr int SLD = 64 + 4;  // f32 row stride of the s and dp tiles
  static constexpr int PLD = 64 + 8;  // bf16 row stride of the p and ds tiles
  static constexpr int OLD = HD + 4;  // f32 row stride of the output staging
  static constexpr size_t tile = sizeof(__nv_bfloat16) * 64 * QLD;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + tile;
  static constexpr size_t k_off = do_off + tile;
  static constexpr size_t v_off = k_off + tile;
  // s and dp are adjacent: together they are reused as the f32 staging area
  // [64, OLD] of the epilogue (2 * 64 * 68 >= 64 * (HD + 4) for HD <= 128)
  static constexpr size_t s_off = v_off + tile;
  static constexpr size_t dp_off = s_off + sizeof(float) * 64 * SLD;
  static constexpr size_t ds_off = dp_off + sizeof(float) * 64 * SLD;
  static constexpr size_t lse_off = ds_off + sizeof(__nv_bfloat16) * 64 * PLD;
  static constexpr size_t delta_off = lse_off + sizeof(float) * 64;
  static constexpr size_t sq_off = delta_off + sizeof(float) * 64;
  static constexpr size_t sk_off = sq_off + sizeof(int) * 64;
  // the p tile comes last: only K2b has one, so K2a asks for less (and two of
  // its blocks fit one SM at head dim 128)
  static constexpr size_t p_off = sk_off + sizeof(int) * 64;
  static constexpr size_t bytes_dq = p_off;
  static constexpr size_t bytes_dkv = p_off + sizeof(__nv_bfloat16) * 64 * PLD;
  static_assert(2 * 64 * SLD >= 64 * OLD, "staging area does not fit");
};

// rows [0, 64) of a [64, HD] tile from a [L, heads, HD] tensor (row stride
// heads*HD); rows past `valid` are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int valid, size_t row_stride) {
  constexpr int V8 = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < 64 * V8; i += NTHREADS) {
    const int r = i / V8, c = (i % V8) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Smem<HD>::QLD + c) = val;
  }
}

// this warp's 16 rows of the f32 staging area -> bf16 rows of a
// [L, heads, HD] tensor, times `mul`; rows at or past `valid` are not written
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float* stage, int wrow,
                                           int valid, size_t row_stride, float mul) {
  const int lane = threadIdx.x % 32;
  for (int r = 0; r < 16; ++r) {
    const int row = wrow + r;
    if (row >= valid) break;
#pragma unroll
    for (int t = 0; t < HD / 32; ++t) {
      const int c = lane + 32 * t;
      dst[row * row_stride + c] = __float2bfloat16(stage[row * Smem<HD>::OLD + c] * mul);
    }
  }
}

// [16 x 64] f32 tile = A_w[16 x HD] B[64 x HD]^T, both bf16 tiles of row
// stride QLD, stored to `dst` (row stride SLD) at this warp's rows
template <int HD>
__device__ __forceinline__ void mma_abt(float* dst, const __nv_bfloat16* a_w,
                                        const __nv_bfloat16* b) {
  using S = Smem<HD>;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a_w + kk * 16, S::QLD);
      wmma::load_matrix_sync(fb, b + (n * 16) * S::QLD + kk * 16, S::QLD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(dst + n * 16, acc, S::SLD, wmma::mem_row_major);
  }
}

// acc[HD/16] (16 x HD, f32 fragments) += A_w[16 x 64] B[64 x HD]; A bf16 with
// row stride PLD, B bf16 with row stride QLD
template <int HD>
__device__ __forceinline__ void mma_acc(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[HD / 16],
    const __nv_bfloat16* a_w, const __nv_bfloat16* b) {
  using S = Smem<HD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a_w + kk * 16, S::PLD);
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + (kk * 16) * S::QLD + n * 16, S::QLD);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2a: dq
// ---------------------------------------------------------------------------
template <int HD, bool WINDOW>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Lq, int Lk, int NH, int NKV,
                    float scale, int causal, int window) {
  using S = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + S::q_off);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem + S::do_off);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + S::k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + S::v_off);
  float* Ss = reinterpret_cast<float*>(smem + S::s_off);
  float* dPs = reinterpret_cast<float*>(smem + S::dp_off);
  __nv_bfloat16* dSs = reinterpret_cast<__nv_bfloat16*>(smem + S::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + S::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + S::delta_off);
  int* segq_s = reinterpret_cast<int*>(smem + S::sq_off);
  int* segk_s = reinterpret_cast<int*>(smem + S::sk_off);

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int kvh = h / (NH / NKV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = warp * 16;

  const size_t q_stride = (size_t)NH * HD, kv_stride = (size_t)NKV * HD;
  const size_t q_base = ((size_t)b * Lq + q0) * q_stride + (size_t)h * HD;
  load_tile<HD>(Qs, q + q_base, Lq - q0, q_stride);
  load_tile<HD>(dOs, dout + q_base, Lq - q0, q_stride);
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    const bool in = q0 + r < Lq;
    const size_t idx = ((size_t)b * NH + h) * Lq + q0 + r;
    segq_s[r] = in ? seg_q[(size_t)b * Lq + q0 + r] : 0;
    lse_s[r] = in ? lse[idx] : 0.f;
    delta_s[r] = in ? delta[idx] : 0.f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  int n_tiles = (Lk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  const int j0 = WINDOW ? max(0, q0 - window + 1) / BK : 0;  // the band's first tile

  for (int j = j0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // previous K/V tile fully consumed (and Q/dO loaded)
    const size_t kv_base = ((size_t)b * Lk + k0) * kv_stride + (size_t)kvh * HD;
    load_tile<HD>(Ks, k + kv_base, Lk - k0, kv_stride);
    load_tile<HD>(Vs, v + kv_base, Lk - k0, kv_stride);
    for (int c = threadIdx.x; c < BK; c += NTHREADS)
      segk_s[c] = (k0 + c < Lk) ? seg_kv[(size_t)b * Lk + k0 + c] : 0;
    __syncthreads();

    mma_abt<HD>(Ss + wrow * S::SLD, Qs + wrow * S::QLD, Ks);    // s  = q k^T
    mma_abt<HD>(dPs + wrow * S::SLD, dOs + wrow * S::QLD, Vs);  // dp = do v^T
    __syncwarp();

    // ds over this warp's 16 rows; lane owns columns lane, lane + 32
    for (int r = 0; r < 16; ++r) {
      const int row = wrow + r;
      const int sq = segq_s[row];
      const float l = lse_s[row], dl = delta_s[row];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        const bool ok = (sq != 0) && (sq == segk_s[c]) && (!causal || q0 + row >= k0 + c) &&
                        (!WINDOW || q0 + row - (k0 + c) < window);
        float ds = 0.f;
        if (ok) ds = expf(Ss[row * S::SLD + c] * scale - l) * (dPs[row * S::SLD + c] - dl);
        dSs[row * S::PLD + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    mma_acc<HD>(acc, dSs + wrow * S::PLD, Ks);  // dq += ds k
  }
  __syncthreads();  // every warp is done with s/dp before they become staging

  float* stage = Ss;
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(stage + wrow * S::OLD + n * 16, acc[n], S::OLD, wmma::mem_row_major);
  __syncwarp();
  store_rows<HD>(dq + q_base, stage, wrow, Lq - q0, q_stride, scale);
}

// ---------------------------------------------------------------------------
// K2b: dk, dv
// ---------------------------------------------------------------------------
template <int HD, bool WINDOW>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Lq,
                     int Lk, int NH, int NKV, float scale, int causal, int window) {
  using S = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + S::q_off);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem + S::do_off);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + S::k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + S::v_off);
  float* Sts = reinterpret_cast<float*>(smem + S::s_off);    // s^T  [kv row][q col]
  float* dPts = reinterpret_cast<float*>(smem + S::dp_off);  // dp^T [kv row][q col]
  __nv_bfloat16* Pts = reinterpret_cast<__nv_bfloat16*>(smem + S::p_off);
  __nv_bfloat16* dSts = reinterpret_cast<__nv_bfloat16*>(smem + S::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + S::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + S::delta_off);
  int* segq_s = reinterpret_cast<int*>(smem + S::sq_off);
  int* segk_s = reinterpret_cast<int*>(smem + S::sk_off);

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int k0 = blockIdx.x * BK;  // under the causal mask the first kv tiles are the longest
  const int group = NH / NKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = warp * 16;  // this warp's kv rows

  const size_t q_stride = (size_t)NH * HD, kv_stride = (size_t)NKV * HD;
  const size_t kv_base = ((size_t)b * Lk + k0) * kv_stride + (size_t)kvh * HD;
  load_tile<HD>(Ks, k + kv_base, Lk - k0, kv_stride);
  load_tile<HD>(Vs, v + kv_base, Lk - k0, kv_stride);
  for (int c = threadIdx.x; c < BK; c += NTHREADS)
    segk_s[c] = (k0 + c < Lk) ? seg_kv[(size_t)b * Lk + k0 + c] : 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[HD / 16], dv_acc[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int i_lo = causal ? k0 / BQ : 0;  // q tiles before it see nothing of this kv tile
  // q tiles past the window's reach of this kv tile see nothing of it either
  const int nq = WINDOW ? min((Lq + BQ - 1) / BQ, (k0 + BK - 1 + window - 1) / BQ + 1)
                        : (Lq + BQ - 1) / BQ;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int i = i_lo; i < nq; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // previous Q/dO tile fully consumed (and K/V loaded)
      const size_t q_base = ((size_t)b * Lq + q0) * q_stride + (size_t)h * HD;
      load_tile<HD>(Qs, q + q_base, Lq - q0, q_stride);
      load_tile<HD>(dOs, dout + q_base, Lq - q0, q_stride);
      for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
        const bool in = q0 + r < Lq;
        const size_t idx = ((size_t)b * NH + h) * Lq + q0 + r;
        segq_s[r] = in ? seg_q[(size_t)b * Lq + q0 + r] : 0;
        lse_s[r] = in ? lse[idx] : 0.f;
        delta_s[r] = in ? delta[idx] : 0.f;
      }
      __syncthreads();

      mma_abt<HD>(Sts + wrow * S::SLD, Ks + wrow * S::QLD, Qs);    // s^T  = k q^T
      mma_abt<HD>(dPts + wrow * S::SLD, Vs + wrow * S::QLD, dOs);  // dp^T = v do^T
      __syncwarp();

      // p^T and ds^T over this warp's 16 kv rows; lane owns q columns lane, lane + 32
      for (int r = 0; r < 16; ++r) {
        const int row = wrow + r;
        const int sk = segk_s[row];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int c = lane + 32 * t;
          const int sq = segq_s[c];
          const bool ok = (sq != 0) && (sq == sk) && (!causal || q0 + c >= k0 + row) &&
                          (!WINDOW || q0 + c - (k0 + row) < window);
          float p = 0.f, ds = 0.f;
          if (ok) {
            p = expf(Sts[row * S::SLD + c] * scale - lse_s[c]);
            ds = p * (dPts[row * S::SLD + c] - delta_s[c]);
          }
          Pts[row * S::PLD + c] = __float2bfloat16(p);
          dSts[row * S::PLD + c] = __float2bfloat16(ds);
        }
      }
      __syncwarp();

      mma_acc<HD>(dv_acc, Pts + wrow * S::PLD, dOs);  // dv += p^T do
      mma_acc<HD>(dk_acc, dSts + wrow * S::PLD, Qs);  // dk += ds^T q
    }
  }
  __syncthreads();  // every warp is done with s^T/dp^T before they become staging

  float* stage = Sts;
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(stage + wrow * S::OLD + n * 16, dv_acc[n], S::OLD,
                            wmma::mem_row_major);
  __syncwarp();
  store_rows<HD>(dv + kv_base, stage, wrow, Lk - k0, kv_stride, 1.f);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(stage + wrow * S::OLD + n * 16, dk_acc[n], S::OLD,
                            wmma::mem_row_major);
  __syncwarp();
  store_rows<HD>(dk + kv_base, stage, wrow, Lk - k0, kv_stride, scale);
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *configured = true;
  return err;
}

template <int HD, bool WINDOW>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const int* seg_q, const int* seg_kv, const float* lse, const float* delta,
                      void* dq, int B, int Lq, int Lk, int NH, int NKV, float scale, int causal,
                      int window, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = Smem<HD>::bytes_dq;
  cudaError_t err = configure(flash_bwd_dq_kernel<HD, WINDOW>, smem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, NH, B);
  flash_bwd_dq_kernel<HD, WINDOW><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), seg_q,
      seg_kv, lse, delta, static_cast<__nv_bfloat16*>(dq), Lq, Lk, NH, NKV, scale, causal,
      window);
  return cudaGetLastError();
}

template <int HD, bool WINDOW>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const int* seg_q, const int* seg_kv, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int Lq, int Lk, int NH,
                       int NKV, float scale, int causal, int window, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = Smem<HD>::bytes_dkv;
  cudaError_t err = configure(flash_bwd_dkv_kernel<HD, WINDOW>, smem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((Lk + BK - 1) / BK, NKV, B);
  flash_bwd_dkv_kernel<HD, WINDOW><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), seg_q,
      seg_kv, lse, delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Lq,
      Lk, NH, NKV, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* seg_q, const void* seg_kv, const void* lse,
                                 const void* delta, void* dq, int B, int Lq, int Lk, int NH,
                                 int NKV, int HD, float scale, int causal, int window,
                                 void* stream) {
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_kv);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRT_DQ_CASE(hd, w)                                                                   \
  if (HD == hd && (window > 0) == w)                                                          \
    return launch_dq<hd, w>(q, k, v, dout, sq, sk, l, d, dq, B, Lq, Lk, NH, NKV, scale, causal, \
                            window, st);
  PRT_DQ_CASE(64, false) PRT_DQ_CASE(64, true) PRT_DQ_CASE(128, false) PRT_DQ_CASE(128, true)
#undef PRT_DQ_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* seg_q, const void* seg_kv, const void* lse,
                                  const void* delta, void* dk, void* dv, int B, int Lq, int Lk,
                                  int NH, int NKV, int HD, float scale, int causal, int window,
                                  void* stream) {
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_kv);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRT_DKV_CASE(hd, w)                                                                  \
  if (HD == hd && (window > 0) == w)                                                          \
    return launch_dkv<hd, w>(q, k, v, dout, sq, sk, l, d, dk, dv, B, Lq, Lk, NH, NKV, scale,   \
                             causal, window, st);
  PRT_DKV_CASE(64, false) PRT_DKV_CASE(64, true) PRT_DKV_CASE(128, false) PRT_DKV_CASE(128, true)
#undef PRT_DKV_CASE
  return (int)cudaErrorInvalidValue;
}
