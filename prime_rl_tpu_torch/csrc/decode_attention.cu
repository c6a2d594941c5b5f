// K4: fused paged decode attention with KV-cache append for Hopper (sm_90a).
//
// Replaces the TPU kernel prime_rl_tpu/ops/decode_attention.py `_kernel`
// (pallas_call in `decode_paged_attention`). For each slot s, with n =
// lengths[s] tokens already cached: store the new token's k/v at position n
// of the slot's paged pool (page page_table[s, n / PS], row n % PS), then
// attend the slot's GQA group of query heads over the n cached tokens plus
// the new one, online softmax in f32, scale hd^-0.5 unless given.
// Pools are [NKV, NP, PS, HD] bf16 and are updated in place.
//
// Sliding window (window > 0; gpt-oss: 128): the window counts the new token,
// so the cached rows attended are [max(n + 1 - window, 0), n); the row loop
// starts there (it may fall inside a page), and rows below it are never read,
// as the TPU kernel skips the blocks below its `b_lo_of`. Attention sinks (f32
// [NH], one learned logit per q head; null = none) join the denominator at the
// finalize, after the new token's term, as a virtual key of value 0.
//
// The append is a plain row store: the TPU kernel's 8-row read-modify-write
// exists only because its memory tiling forbids single-row DMA. The new
// token's contribution is taken from the inputs (registers), so no read in
// this launch depends on the store; other slots never read this slot's
// owned pages. Inactive slots (page-table rows all 0) write into the
// reserved null page 0, whose contents no active slot reads.
//
// What bounds it on the H100: decode attention reads every cached k/v row
// once and does 4*HD flops per row per query head, so it is bound by bytes
// (GQA group 2 for Qwen3-0.6B: ~2 flops per byte). One block of 4 warps per
// (slot, kv head) serves the whole GQA group from one read of each row;
// warps split the slot's tokens (each warp keeps its own running max, sum
// and accumulator in registers, loads UNROLL rows before using them so
// several loads are in flight) and merge through shared memory at the end.
// Split-K over long contexts and cp.async/TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_GROUP = 8;
constexpr int UNROLL = 4;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// EPL consecutive bf16 values (EPL = HD / 32: 4 -> 8 bytes, 2 -> 4 bytes)
template <int EPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
  if constexpr (EPL == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h2[0]), b = __bfloat1622float2(h2[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else {
    const __nv_bfloat162 raw = *reinterpret_cast<const __nv_bfloat162*>(p);
    const float2 a = __bfloat1622float2(raw);
    out[0] = a.x; out[1] = a.y;
  }
}

template <int HD, int G>
__global__ void __launch_bounds__(NTHREADS)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_new,
                   const __nv_bfloat16* __restrict__ v_new, __nv_bfloat16* __restrict__ k_pool,
                   __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ lengths,
                   const int* __restrict__ page_table, const float* __restrict__ sinks,
                   __nv_bfloat16* __restrict__ out, int NH, int NKV, int NP, int PS, int P,
                   float scale, int window) {
  constexpr int EPL = HD / 32;  // head-dim elements per lane: lane*EPL .. +EPL
  __shared__ float sm_m[NWARPS][G];
  __shared__ float sm_l[NWARPS][G];
  __shared__ float sm_acc[NWARPS][G][HD];
  __shared__ float sm_snew[G];

  const int h = blockIdx.x, s = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = lengths[s];
  const int* row_pages = page_table + (size_t)s * P;
  const size_t new_off = ((size_t)s * NKV + h) * HD;

  // append: plain row store of the new token at position n
  {
    const int pidx = min(n / PS, P - 1);
    const size_t dst = (((size_t)h * NP + row_pages[pidx]) * PS + n % PS) * HD;
    for (int c = threadIdx.x; c < HD / 8; c += NTHREADS) {
      reinterpret_cast<uint4*>(k_pool + dst)[c] = reinterpret_cast<const uint4*>(k_new + new_off)[c];
      reinterpret_cast<uint4*>(v_pool + dst)[c] = reinterpret_cast<const uint4*>(v_new + new_off)[c];
    }
  }

  // this lane's slice of every query head of the group (f32)
  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_row<EPL>(q + ((size_t)s * NH + h * G + g) * HD + lane * EPL, qr[g]);

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const size_t head_base = (size_t)h * NP * PS * HD;
  const int lo = window > 0 ? max(n + 1 - window, 0) : 0;  // first cached row in the window
  for (int t0 = lo + warp * UNROLL; t0 < n; t0 += NWARPS * UNROLL) {
    float kr[UNROLL][EPL], vr[UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t < n) {
        const size_t off = head_base + ((size_t)row_pages[t / PS] * PS + t % PS) * HD + lane * EPL;
        load_row<EPL>(k_pool + off, kr[u]);
        load_row<EPL>(v_pool + off, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 + u >= n) break;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d += qr[g][e] * kr[u][e];
        const float sc = warp_sum(d) * scale;
        const float m_new = fmaxf(m[g], sc);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(sc - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * alpha + p * vr[u][e];
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  // the new token's score per query head (every warp computes it; warp 0 stores)
  {
    float kn[EPL];
    load_row<EPL>(k_new + new_off + lane * EPL, kn);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d += qr[g][e] * kn[e];
      d = warp_sum(d) * scale;
      if (warp == 0 && lane == 0) sm_snew[g] = d;
    }
  }
  __syncthreads();

  // merge the warps' partials, fold in the new token, normalise, store
  for (int i = threadIdx.x; i < G * HD; i += NTHREADS) {
    const int g = i / HD, d = i % HD;
    float mm = NEG_INF;
    for (int w = 0; w < NWARPS; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ll = 0.f, aa = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const float c = expf(sm_m[w][g] - mm);
      ll += sm_l[w][g] * c;
      aa += sm_acc[w][g][d] * c;
    }
    const float s_new = sm_snew[g];
    const float m_f = fmaxf(mm, s_new);
    const float alpha = expf(mm - m_f);
    const float p_new = expf(s_new - m_f);
    float l_f = ll * alpha + p_new;
    float a_f = aa * alpha + p_new * __bfloat162float(v_new[new_off + d]);
    if (sinks != nullptr) {
      const float sink = sinks[h * G + g];
      const float m2 = fmaxf(m_f, sink);
      const float c = expf(m_f - m2);
      l_f = l_f * c + expf(sink - m2);
      a_f *= c;
    }
    out[((size_t)s * NH + h * G + g) * HD + d] = __float2bfloat16(a_f / l_f);
  }
}

template <int HD, int G>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
                   void* v_pool, const int* lengths, const int* page_table, const float* sinks,
                   void* out, int S, int NH, int NKV, int NP, int PS, int P, float scale,
                   int window, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  dim3 grid(NKV, S);
  decode_attn_kernel<HD, G><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k_new), static_cast<const bf*>(v_new),
      static_cast<bf*>(k_pool), static_cast<bf*>(v_pool), lengths, page_table, sinks,
      static_cast<bf*>(out), NH, NKV, NP, PS, P, scale, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_paged_attention(const void* q, const void* k_new, const void* v_new,
                                      void* k_pool, void* v_pool, const void* lengths,
                                      const void* page_table, const void* sinks, void* out, int S,
                                      int NH, int NKV, int HD, int NP, int PS, int P, float scale,
                                      int window, void* stream) {
  if (NH % NKV != 0 || NH / NKV > MAX_GROUP) return (int)cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(page_table);
  const float* snk = static_cast<const float*>(sinks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRT_DECODE_CASE(hd, g)                                                              \
  if (HD == hd && NH / NKV == g)                                                             \
    return launch<hd, g>(q, k_new, v_new, k_pool, v_pool, len, tab, snk, out, S, NH, NKV, NP, PS, \
                         P, scale, window, st);
  PRT_DECODE_CASE(64, 1) PRT_DECODE_CASE(64, 2) PRT_DECODE_CASE(64, 4) PRT_DECODE_CASE(64, 8)
  PRT_DECODE_CASE(128, 1) PRT_DECODE_CASE(128, 2) PRT_DECODE_CASE(128, 4) PRT_DECODE_CASE(128, 8)
#undef PRT_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}
