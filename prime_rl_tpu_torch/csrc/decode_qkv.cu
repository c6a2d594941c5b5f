// K3: fused decode-time QKV preparation for Hopper (sm_90a).
//
// Replaces the TPU kernel prime_rl_tpu/ops/decode_qkv.py `_kernel` (pallas_call
// in `decode_qkv_prep`). For S decode tokens: rms-norm of x (f32, then cast
// to bf16 as the TPU kernel casts to the weight dtype) -> q/k/v projections
// computed here with f32 accumulation -> optional bias -> per-head RMS
// qk-norm -> half-split rope with partial rotation and a cos/sin `scaling`
// (YaRN). Bias, qk-norm and rope stay in f32 until the final bf16 store.
//
// What bounds it on the H100: at decode batch sizes (S <= 64 rows against
// D x (NH + 2 NKV) HD weights) the work is the weight read: 6 MB of bf16 for
// Qwen3-0.6B against 0.4 GFLOP, far below the tensor cores' break-even, so
// bytes are the bound. The design reads every weight element exactly once
// per 16-row tile of tokens: one block per (output head, 16-row token tile);
// the block normalises its 16 rows of x into shared memory, streams the
// head's 128 weight columns straight from device memory into WMMA bf16
// fragments (f32 accumulation), and runs bias, qk-norm and rope as the
// epilogue on the f32 tile in shared memory, so nothing between the norm
// and the rope touches device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int ROWS = 16;  // token rows per block
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
decode_qkv_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ norm_w,
                  const __nv_bfloat16* __restrict__ wq, const __nv_bfloat16* __restrict__ wk,
                  const __nv_bfloat16* __restrict__ wv, const __nv_bfloat16* __restrict__ q_bias,
                  const __nv_bfloat16* __restrict__ k_bias, const __nv_bfloat16* __restrict__ v_bias,
                  const __nv_bfloat16* __restrict__ q_norm_w,
                  const __nv_bfloat16* __restrict__ k_norm_w, const int* __restrict__ pos,
                  const float* __restrict__ inv_freq, __nv_bfloat16* __restrict__ q_out,
                  __nv_bfloat16* __restrict__ k_out, __nv_bfloat16* __restrict__ v_out, int S,
                  int D, int NH, int NKV, int rot, float scaling, float eps, int qk_norm) {
  constexpr int ALD = HD + 4;            // f32 accumulator row stride
  constexpr int COLS_PER_WARP = HD / NWARPS;
  constexpr int FRAGS = COLS_PER_WARP / 16;
  static_assert(FRAGS >= 1, "head_dim must be a multiple of 64");
  extern __shared__ __align__(128) unsigned char smem[];
  const int XLD = D + 8;                 // bf16 row stride of the normed x
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* acc_s = reinterpret_cast<float*>(smem + sizeof(__nv_bfloat16) * ROWS * XLD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int head = blockIdx.x;
  const int s0 = blockIdx.y * ROWS;
  // which projection this head belongs to: 0 = q, 1 = k, 2 = v
  const int which = head < NH ? 0 : (head < NH + NKV ? 1 : 2);
  const int hh = which == 0 ? head : (which == 1 ? head - NH : head - NH - NKV);
  const __nv_bfloat16* w = which == 0 ? wq : (which == 1 ? wk : wv);
  const __nv_bfloat16* bias = which == 0 ? q_bias : (which == 1 ? k_bias : v_bias);
  const int ncols = (which == 0 ? NH : NKV) * HD;
  const int col0 = hh * HD;

  // 1) rms-norm of this block's token rows -> bf16 in shared memory
  for (int r = warp; r < ROWS; r += NWARPS) {
    const int row = s0 + r;
    __nv_bfloat16* dst = xs + r * XLD;
    if (row >= S) {
      for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16(0.f);
      continue;
    }
    const __nv_bfloat16* src = x + (size_t)row * D;
    float ss = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float f = __bfloat162float(src[c]);
      ss += f * f;
    }
    const float rstd = rsqrtf(warp_sum(ss) / (float)D + eps);
    for (int c = lane; c < D; c += 32)
      dst[c] = __float2bfloat16(__bfloat162float(src[c]) * rstd * __bfloat162float(norm_w[c]));
  }
  __syncthreads();

  // 2) [16 x D] @ [D x HD] for this head: warp `warp` owns COLS_PER_WARP cols
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FRAGS];
#pragma unroll
  for (int f = 0; f < FRAGS; ++f) wmma::fill_fragment(acc[f], 0.f);
  const __nv_bfloat16* wcol = w + col0 + warp * COLS_PER_WARP;
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, xs + kk, XLD);
#pragma unroll
    for (int f = 0; f < FRAGS; ++f) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, wcol + (size_t)kk * ncols + f * 16, ncols);
      wmma::mma_sync(acc[f], fa, fb, acc[f]);
    }
  }
#pragma unroll
  for (int f = 0; f < FRAGS; ++f)
    wmma::store_matrix_sync(acc_s + warp * COLS_PER_WARP + f * 16, acc[f], ALD,
                            wmma::mem_row_major);
  __syncthreads();

  // 3) epilogue per token row: bias, qk-norm, rope (f32), one bf16 store
  constexpr int EPL = HD / 32;  // columns per lane: lane + 32 * t
  const int r2 = rot / 2;
  for (int r = warp; r < ROWS; r += NWARPS) {
    const int row = s0 + r;
    if (row >= S) break;
    float* arow = acc_s + r * ALD;
    float val[EPL];
#pragma unroll
    for (int t = 0; t < EPL; ++t) {
      const int c = lane + 32 * t;
      val[t] = arow[c] + (bias != nullptr ? __bfloat162float(bias[col0 + c]) : 0.f);
    }
    if (which == 2) {
      __nv_bfloat16* dst = v_out + ((size_t)row * NKV + hh) * HD;
#pragma unroll
      for (int t = 0; t < EPL; ++t) dst[lane + 32 * t] = __float2bfloat16(val[t]);
      continue;
    }
    if (qk_norm) {
      float ss = 0.f;
#pragma unroll
      for (int t = 0; t < EPL; ++t) ss += val[t] * val[t];
      const float rs = rsqrtf(warp_sum(ss) / (float)HD + eps);
      const __nv_bfloat16* nw = which == 0 ? q_norm_w : k_norm_w;
#pragma unroll
      for (int t = 0; t < EPL; ++t) val[t] = val[t] * rs * __bfloat162float(nw[lane + 32 * t]);
    }
#pragma unroll
    for (int t = 0; t < EPL; ++t) arow[lane + 32 * t] = val[t];
    __syncwarp();
    const float p = (float)pos[row];
    __nv_bfloat16* dst = which == 0 ? q_out + ((size_t)row * NH + hh) * HD
                                    : k_out + ((size_t)row * NKV + hh) * HD;
#pragma unroll
    for (int t = 0; t < EPL; ++t) {
      const int c = lane + 32 * t;
      float o = val[t];
      if (c < rot) {
        const bool lo = c < r2;
        const float ang = p * inv_freq[lo ? c : c - r2];
        const float cs = cosf(ang) * scaling, sn = sinf(ang) * scaling;
        const float partner = arow[lo ? c + r2 : c - r2];
        o = lo ? val[t] * cs - partner * sn : val[t] * cs + partner * sn;
      }
      dst[c] = __float2bfloat16(o);
    }
    __syncwarp();
  }
}

template <int HD>
cudaError_t launch(const void* x, const void* norm_w, const void* wq, const void* wk,
                   const void* wv, const void* q_bias, const void* k_bias, const void* v_bias,
                   const void* q_norm_w, const void* k_norm_w, const int* pos,
                   const float* inv_freq, void* q_out, void* k_out, void* v_out, int S, int D,
                   int NH, int NKV, int rot, float scaling, float eps, int qk_norm,
                   cudaStream_t stream) {
  using bf = __nv_bfloat16;
  static size_t configured = 0;  // largest dynamic shared memory opted in so far
  const size_t smem = sizeof(bf) * ROWS * (D + 8) + sizeof(float) * ROWS * (HD + 4);
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_qkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  dim3 grid(NH + 2 * NKV, (S + ROWS - 1) / ROWS);
  decode_qkv_kernel<HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(norm_w), static_cast<const bf*>(wq),
      static_cast<const bf*>(wk), static_cast<const bf*>(wv), static_cast<const bf*>(q_bias),
      static_cast<const bf*>(k_bias), static_cast<const bf*>(v_bias),
      static_cast<const bf*>(q_norm_w), static_cast<const bf*>(k_norm_w), pos, inv_freq,
      static_cast<bf*>(q_out), static_cast<bf*>(k_out), static_cast<bf*>(v_out), S, D, NH, NKV,
      rot, scaling, eps, qk_norm);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_qkv_prep(const void* x, const void* norm_w, const void* wq, const void* wk,
                               const void* wv, const void* q_bias, const void* k_bias,
                               const void* v_bias, const void* q_norm_w, const void* k_norm_w,
                               const void* pos, const void* inv_freq, void* q_out, void* k_out,
                               void* v_out, int S, int D, int NH, int NKV, int HD, int rot,
                               float scaling, float eps, int qk_norm, void* stream) {
  const int* p = static_cast<const int*>(pos);
  const float* f = static_cast<const float*>(inv_freq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 64:
      return launch<64>(x, norm_w, wq, wk, wv, q_bias, k_bias, v_bias, q_norm_w, k_norm_w, p, f,
                        q_out, k_out, v_out, S, D, NH, NKV, rot, scaling, eps, qk_norm, st);
    case 128:
      return launch<128>(x, norm_w, wq, wk, wv, q_bias, k_bias, v_bias, q_norm_w, k_norm_w, p, f,
                         q_out, k_out, v_out, S, D, NH, NKV, rot, scaling, eps, qk_norm, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
