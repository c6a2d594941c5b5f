// K1: packed-segment causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel prime_rl_tpu/ops/flash_attention.py `_fwd_kernel`
// (pallas_call in `_fwd`). Same contract: q [B, Lq, NH, HD], k/v
// [B, Lk, NKV, HD] bf16; segment ids [B, L] int32 with 0 = padding; a query
// attends a key iff seg_q == seg_kv, seg_q != 0, (causal) row >= col and
// (window > 0) row - col < window; GQA maps q head h to kv head h / (NH /
// NKV); online softmax with f32 accumulators; out bf16 [B, Lq, NH, HD] and
// lse f32 [B, NH, Lq]. A row that sees no key (padding, dummy prefill rows)
// gets out 0 and lse -1e30, as the TPU kernel's finalize does.
//
// Sliding window (gpt-oss: 128 tokens on every other layer): the kv-tile
// loop starts at the band's first tile, (q0 - window + 1) / BK, as the TPU
// kernel's grid starts at `_band_lo`; tiles wholly below the band are never
// loaded, so the work grows with L * window and not L^2. Attention sinks
// (one learned logit per q head, f32 [NH]; null = none) join the softmax
// denominator at the finalize, as a virtual key of value 0: m_f = max(m,
// sink), l_f = l e^(m - m_f) + e^(sink - m_f), out = acc e^(m - m_f) / l_f,
// lse = m_f + log l_f. A row that sees no key then gets out 0 and lse = sink.
// The window is a template flag (WINDOW) besides its value, so the dense
// instantiation compiles as it did before windows existed.
//
// What bounds it on the H100: at prefill lengths (64..4096) attention is
// compute-bound (about 4*L*L/2*HD flops per head against 4*L*HD bytes), so the
// tensor cores are the resource. This first version uses WMMA bf16 16x16x16
// tiles with f32 accumulation: one block of 4 warps per (batch, q head, 64-row
// q tile), each warp owning 16 q rows; K/V tiles of 64 rows stream through
// shared memory up to the causal diagonal only (tiles above it are skipped,
// halving the work). The score tile and the output accumulator live in
// shared memory, because the WMMA accumulator layout is opaque and the
// online-softmax rescale is per row. wgmma/TMA pipelining is later work.

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
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Smem {
  static constexpr int QLD = HD + 8;   // bf16 row stride (Q, K, V tiles)
  static constexpr int SLD = BK + 4;   // f32 score row stride
  static constexpr int PLD = BK + 8;   // bf16 prob row stride
  static constexpr int OLD = HD + 4;   // f32 output-accumulator row stride
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(__nv_bfloat16) * BQ * QLD;
  static constexpr size_t v_off = k_off + sizeof(__nv_bfloat16) * BK * QLD;
  static constexpr size_t s_off = v_off + sizeof(__nv_bfloat16) * BK * QLD;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * SLD;
  static constexpr size_t o_off = p_off + sizeof(__nv_bfloat16) * BQ * PLD;
  static constexpr size_t m_off = o_off + sizeof(float) * BQ * OLD;
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t sq_off = l_off + sizeof(float) * BQ;
  static constexpr size_t sk_off = sq_off + sizeof(int) * BQ;
  static constexpr size_t bytes = sk_off + sizeof(int) * BK;
};

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

// rows [0, n) of a [n, HD] tile from a [L, heads, HD] tensor (row stride
// heads*HD); rows past `valid` are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int rows, int valid, size_t row_stride) {
  constexpr int V8 = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * V8; i += NTHREADS) {
    const int r = i / V8, c = (i % V8) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Smem<HD>::QLD + c) = val;
  }
}

template <int HD, bool WINDOW>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, const float* __restrict__ sinks, int Lq, int Lk,
                 int NH, int NKV, float scale, int causal, int window) {
  using S = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + S::q_off);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + S::k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + S::v_off);
  float* Ss = reinterpret_cast<float*>(smem + S::s_off);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + S::p_off);
  float* Os = reinterpret_cast<float*>(smem + S::o_off);
  float* m_s = reinterpret_cast<float*>(smem + S::m_off);
  float* l_s = reinterpret_cast<float*>(smem + S::l_off);
  int* segq_s = reinterpret_cast<int*>(smem + S::sq_off);
  int* segk_s = reinterpret_cast<int*>(smem + S::sk_off);

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = h / (NH / NKV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = warp * 16;  // this warp's first row in the tile

  const size_t q_stride = (size_t)NH * HD, kv_stride = (size_t)NKV * HD;
  load_tile<HD>(Qs, q + ((size_t)b * Lq + q0) * q_stride + (size_t)h * HD, BQ, Lq - q0, q_stride);
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    segq_s[r] = (q0 + r < Lq) ? seg_q[(size_t)b * Lq + q0 + r] : 0;
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  for (int i = threadIdx.x; i < BQ * S::OLD; i += NTHREADS) Os[i] = 0.f;

  int n_tiles = (Lk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  // the band: no row of this tile sees a key below q0 - window + 1
  const int j0 = WINDOW ? max(0, q0 - window + 1) / BK : 0;

  for (int j = j0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // previous tile's K/V/P fully consumed (and Q loaded)
    const size_t kv_base = ((size_t)b * Lk + k0) * kv_stride + (size_t)kvh * HD;
    load_tile<HD>(Ks, k + kv_base, BK, Lk - k0, kv_stride);
    load_tile<HD>(Vs, v + kv_base, BK, Lk - k0, kv_stride);
    for (int c = threadIdx.x; c < BK; c += NTHREADS)
      segk_s[c] = (k0 + c < Lk) ? seg_kv[(size_t)b * Lk + k0 + c] : 0;
    __syncthreads();

    // S[16 x 64] = Q_w K^T
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + wrow * S::QLD + kk * 16, S::QLD);
        wmma::load_matrix_sync(fb, Ks + (n * 16) * S::QLD + kk * 16, S::QLD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + wrow * S::SLD + n * 16, acc, S::SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this warp's 16 rows; lane owns columns lane, lane+32
    for (int r = 0; r < 16; ++r) {
      const int row = wrow + r;
      const int grow = q0 + row;
      const int sq = segq_s[row];
      float s2[2];
      bool ok[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        const int gcol = k0 + c;
        ok[t] = (sq != 0) && (sq == segk_s[c]) && (!causal || grow >= gcol) &&
                (!WINDOW || grow - gcol < window);
        s2[t] = ok[t] ? Ss[row * S::SLD + c] * scale : NEG_INF;
      }
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s2[0], s2[1])));
      float p2[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        p2[t] = ok[t] ? expf(s2[t] - m_new) : 0.f;
        Ps[row * S::PLD + lane + 32 * t] = __float2bfloat16(p2[t]);
      }
      const float psum = warp_sum(p2[0] + p2[1]);
      const float alpha = expf(m_prev - m_new);
#pragma unroll
      for (int t = 0; t < HD / 32; ++t) Os[row * S::OLD + lane + 32 * t] *= alpha;
      __syncwarp();
      if (lane == 0) {
        l_s[row] = l_s[row] * alpha + psum;
        m_s[row] = m_new;
      }
    }
    __syncwarp();

    // O_w[16 x HD] += P_w[16 x 64] V[64 x HD]
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + wrow * S::OLD + n * 16, S::OLD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + wrow * S::PLD + kk * 16, S::PLD);
        wmma::load_matrix_sync(fb, Vs + (kk * 16) * S::QLD + n * 16, S::QLD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Os + wrow * S::OLD + n * 16, acc, S::OLD, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // finalize: out = acc / l (0 for rows that saw no key), lse = m + log l;
  // with a sink, the sink's term joins l first
  for (int r = 0; r < 16; ++r) {
    const int row = wrow + r;
    const int grow = q0 + row;
    if (grow >= Lq) break;
    const float l = l_s[row], m = m_s[row];
    float inv, row_lse;
    if (sinks != nullptr) {
      const float sink = sinks[h];
      const float m_f = fmaxf(m, sink);
      const float alpha = expf(m - m_f);  // rows that saw no key: m = -1e30 -> 0
      const float l_f = l * alpha + expf(sink - m_f);
      inv = alpha / l_f;
      row_lse = m_f + logf(l_f);
    } else {
      inv = l > 0.f ? 1.f / l : 1.f;
      row_lse = l > 0.f ? m + logf(l) : NEG_INF;
    }
    __nv_bfloat16* orow = out + ((size_t)b * Lq + grow) * q_stride + (size_t)h * HD;
#pragma unroll
    for (int t = 0; t < HD / 32; ++t) {
      const int c = lane + 32 * t;
      orow[c] = __float2bfloat16(Os[row * S::OLD + c] * inv);
    }
    if (lane == 0) lse[((size_t)b * NH + h) * Lq + grow] = row_lse;
  }
}

template <int HD, bool WINDOW>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg_q,
                   const int* seg_kv, void* out, float* lse, const float* sinks, int B, int Lq,
                   int Lk, int NH, int NKV, float scale, int causal, int window,
                   cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = Smem<HD>::bytes;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD, WINDOW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((Lq + BQ - 1) / BQ, NH, B);
  flash_fwd_kernel<HD, WINDOW><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg_q, seg_kv, static_cast<__nv_bfloat16*>(out),
      lse, sinks, Lq, Lk, NH, NKV, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const void* seg_q,
                              const void* seg_kv, void* out, void* lse, const void* sinks, int B,
                              int Lq, int Lk, int NH, int NKV, int HD, float scale, int causal,
                              int window, void* stream) {
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_kv);
  float* l = static_cast<float*>(lse);
  const float* snk = static_cast<const float*>(sinks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRT_FWD_CASE(hd, w)                                                                  \
  if (HD == hd && (window > 0) == w)                                                          \
    return launch<hd, w>(q, k, v, sq, sk, out, l, snk, B, Lq, Lk, NH, NKV, scale, causal,      \
                         window, st);
  PRT_FWD_CASE(64, false) PRT_FWD_CASE(64, true) PRT_FWD_CASE(128, false) PRT_FWD_CASE(128, true)
#undef PRT_FWD_CASE
  return (int)cudaErrorInvalidValue;
}
