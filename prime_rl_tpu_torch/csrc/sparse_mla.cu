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
//   dkvg = ds^T q, plus bf16(p)^T do on the first Dv channels      (one row per slot)
//   dkv[r] = sum of the dkvg rows of the slots that selected r     (f32, fixed order)
//
// A token that selected nothing gets out 0, lse -5e29, dq 0 and adds nothing to
// dkv. The mask selects before the exponential, so no inf * 0 reaches a sum.
// The kernels take H = 64, Dq = 576, Dv = 512 (the MLA widths: latent 512 +
// rope 64); the wrapper raises for anything else.
//
// What differs from the TPU kernels, on purpose. The TPU version gathers the
// selected rows into a [C, T, Dq] tensor outside the kernel, because a TPU serves
// row gathers by DMA. Here the latent stream of a packed row (4096 x 1152 bytes =
// 4.7 MB) sits in the 50 MB L2, so each block reads the rows it needs by index
// (one row is 1152 contiguous bytes) and the gathered tensor is never written.
// The Dq 576 -> 640 padding, the padding of T and S to block multiples and the
// lax.map over chunks are TPU layout work and are not carried over.
//
// What bounds them on the H100: operations. A token's 64 heads against up to
// 2048 rows of 576 channels is 2*64*T*(576+512) flops forward and
// 2*64*T*(3*576+2*512) backward against 1152 bytes per row read from L2. This
// first version uses WMMA bf16 16x16x16 tiles with f32 accumulation, one block
// of 16 warps per query token, the token's [64, Dq] panel resident in shared
// memory:
//   K5a: tiles of 64 selected rows; s goes through shared memory for the online
//        softmax; the [64, 512] output accumulator stays in register fragments
//        (each warp 16 rows x 128 columns) and is rescaled per row by
//        multiplying with a fragment loaded from a tile whose rows hold the
//        row's factor: two accumulator fragments of one type share one layout.
//   K5b: tiles of 32 selected rows; s and dp through shared memory, p and ds
//        rounded to bf16 there; dq stays in register fragments (16 rows x 144
//        columns a warp); the tile's dkvg rows are written once, in bf16, into a
//        [chunk, T, Dq] buffer.
//   dkv: `sparse_mla_dkv_reduce_kernel` gives every kv row one block that walks
//        the slots that selected it, in the order of a stable sort of the
//        indices made by the wrapper, and sums their dkvg rows in f32: no
//        atomics, so two runs give the same bits. The wrapper runs K5b and the
//        reduction over chunks of queries so that the buffer stays near 1 GB.
// Tiles that hold only sentinels are skipped (the top-k puts them last). wgmma,
// TMA and overlapping the gather with the products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

constexpr int H = 64;    // heads of one query token: the M dimension of every product
constexpr int DQ = 576;  // latent + rope channels of q and kv
constexpr int DV = 512;  // value channels (the latent part)
constexpr int NWARPS = 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

constexpr int QLD = DQ + 8;  // bf16 row stride of the q panel and the kv tile
constexpr int OLD = DV + 8;  // bf16 row stride of the do panel
constexpr int V8 = DQ / 8;   // 16-byte vectors in one kv row

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// one token's [H, COLS] panel (contiguous in device memory) into shared memory
template <int COLS, int LD>
__device__ __forceinline__ void load_panel(bf16* dst, const bf16* src) {
  constexpr int V = COLS / 8;
  for (int i = threadIdx.x; i < H * V; i += NTHREADS) {
    const int r = i / V, c = (i % V) * 8;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * COLS + c);
  }
}

// the BT rows of kv named by idx_s (-1: sentinel, zero-filled and never read)
template <int BT>
__device__ __forceinline__ void gather_tile(bf16* dst, const bf16* __restrict__ kv,
                                            const int* idx_s) {
  for (int i = threadIdx.x; i < BT * V8; i += NTHREADS) {
    const int r = i / V8, c = (i % V8) * 8;
    const int id = idx_s[r];
    uint4 val = make_uint4(0, 0, 0, 0);
    if (id >= 0) val = *reinterpret_cast<const uint4*>(kv + (size_t)id * DQ + c);
    *reinterpret_cast<uint4*>(dst + r * QLD + c) = val;
  }
}

// this tile's slot indices into idx_s; returns the slot's row, or -1 for a
// sentinel, an index out of range or a slot past T
template <int BT>
__device__ __forceinline__ int load_indices(int* idx_s, const int* __restrict__ row_indices,
                                            int j0, int T, int Sk) {
  int my = -1;
  if (threadIdx.x < BT) {
    const int j = j0 + threadIdx.x;
    if (j < T) {
      const int id = row_indices[j];
      if (id >= 0 && id < Sk) my = id;
    }
    idx_s[threadIdx.x] = my;
  }
  return my;
}

// acc = A[16 x 16*K] B^T, A row-major (stride lda), B stored [n][k] (stride ldb)
template <int K>
__device__ __forceinline__ void mma_abt(FragC& acc, const bf16* a, int lda, const bf16* b,
                                        int ldb) {
  wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    FragA fa;
    FragBT fb;
    wmma::load_matrix_sync(fa, a + kk * 16, lda);
    wmma::load_matrix_sync(fb, b + kk * 16, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// 8 consecutive values of this lane's row of a staged 16x16 f32 tile, as bf16
__device__ __forceinline__ void store8(bf16* dst, const float* src, float mul) {
  __align__(16) bf16 pk[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) pk[i] = __float2bfloat16(src[i] * mul);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(pk);
}

// ---------------------------------------------------------------------------
// K5a: forward
// ---------------------------------------------------------------------------
struct FwdSmem {
  static constexpr int BT = 64;       // selected rows per tile
  static constexpr int SLD = BT + 4;  // f32 row stride of the score tile
  static constexpr int PLD = BT + 8;  // bf16 row stride of the probability tile
  static constexpr size_t q_off = 0;
  static constexpr size_t kv_off = q_off + sizeof(bf16) * H * QLD;
  static constexpr size_t s_off = kv_off + sizeof(bf16) * BT * QLD;
  static constexpr size_t p_off = s_off + sizeof(float) * H * SLD;
  static constexpr size_t alpha_off = p_off + sizeof(bf16) * H * PLD;
  static constexpr size_t m_off = alpha_off + sizeof(float) * H * 16;
  static constexpr size_t l_off = m_off + sizeof(float) * H;
  static constexpr size_t idx_off = l_off + sizeof(float) * H;
  static constexpr size_t bytes = idx_off + sizeof(int) * BT;
  // the score tile doubles as the epilogue's staging: one 16x16 f32 tile a warp
  static_assert(sizeof(float) * H * SLD >= sizeof(float) * NWARPS * 256, "staging does not fit");
};

__global__ void __launch_bounds__(NTHREADS)
sparse_mla_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                      const int* __restrict__ indices, bf16* __restrict__ out,
                      float* __restrict__ lse, int S, int Sk, int T, float scale) {
  using M = FwdSmem;
  constexpr int BT = M::BT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + M::q_off);
  bf16* KVs = reinterpret_cast<bf16*>(smem + M::kv_off);
  float* Ss = reinterpret_cast<float*>(smem + M::s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + M::p_off);
  float* AlphaT = reinterpret_cast<float*>(smem + M::alpha_off);  // [H, 16], row r = alpha[r]
  float* m_s = reinterpret_cast<float*>(smem + M::m_off);
  float* l_s = reinterpret_cast<float*>(smem + M::l_off);
  int* idx_s = reinterpret_cast<int*>(smem + M::idx_off);

  const int t = S - 1 - blockIdx.x;  // under a causal selection the late tokens are the longest
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp & 3;   // this warp's 16 heads
  const int cg = warp >> 2;  // its quarter of the columns

  load_panel<DQ, QLD>(Qs, q + (size_t)t * H * DQ);
  if (tid < H) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  FragC o[DV / 64];  // 16 rows x 128 columns of the output
#pragma unroll
  for (int n = 0; n < DV / 64; ++n) wmma::fill_fragment(o[n], 0.f);

  const int* row_indices = indices + (size_t)t * T;
  for (int j0 = 0; j0 < T; j0 += BT) {
    const int my = load_indices<BT>(idx_s, row_indices, j0, T, Sk);
    // also the barrier that ends the previous tile (and the prologue's loads)
    if (!__syncthreads_or(my >= 0)) continue;
    gather_tile<BT>(KVs, kv, idx_s);
    __syncthreads();

    {  // s = q kvg^T: one 16x16 tile a warp
      FragC acc;
      mma_abt<DQ / 16>(acc, Qs + rg * 16 * QLD, QLD, KVs + cg * 16 * QLD, QLD);
      wmma::store_matrix_sync(Ss + rg * 16 * M::SLD + cg * 16, acc, M::SLD, wmma::mem_row_major);
    }
    __syncthreads();

    {  // online softmax: 8 threads a row, 8 columns each
      const int row = tid >> 3, sub = tid & 7;
      float sv[8];
      unsigned ok = 0;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = sub * 8 + c;
        const bool valid = idx_s[col] >= 0;
        ok |= (valid ? 1u : 0u) << c;
        sv[c] = valid ? Ss[row * M::SLD + col] * scale : NEG_INF;
        mx = fmaxf(mx, sv[c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_prev = m_s[row];
      const float m_cur = fmaxf(m_prev, mx);
      const float m_safe = fmaxf(m_cur, 0.5f * NEG_INF);  // rows that saw nothing stay at 0
      const float alpha = expf(m_prev - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = ((ok >> c) & 1u) ? expf(sv[c] - m_safe) : 0.f;
        sum += p;
        Ps[row * M::PLD + sub * 8 + c] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      __syncwarp();  // every lane has read m_s[row] before one of them replaces it
      if (sub == 0) {
        m_s[row] = m_cur;
        l_s[row] = l_s[row] * alpha + sum;
      }
      AlphaT[row * 16 + sub * 2] = alpha;
      AlphaT[row * 16 + sub * 2 + 1] = alpha;
    }
    __syncthreads();

    {  // o = o * alpha + p v
      FragC af;
      wmma::load_matrix_sync(af, AlphaT + rg * 16 * 16, 16, wmma::mem_row_major);
#pragma unroll
      for (int n = 0; n < DV / 64; ++n)
#pragma unroll
        for (int e = 0; e < af.num_elements; ++e) o[n].x[e] *= af.x[e];
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        FragA fa;
        wmma::load_matrix_sync(fa, Ps + rg * 16 * M::PLD + kk * 16, M::PLD);
#pragma unroll
        for (int n = 0; n < DV / 64; ++n) {
          FragB fb;
          wmma::load_matrix_sync(fb, KVs + kk * 16 * QLD + cg * (DV / 4) + n * 16, QLD);
          wmma::mma_sync(o[n], fa, fb, o[n]);
        }
      }
    }
  }
  __syncthreads();  // the last tile is consumed: the score tile becomes staging

  float* stage = Ss + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  const int row = rg * 16 + r;
  const float inv = 1.f / fmaxf(l_s[row], 1e-30f);
  bf16* orow = out + ((size_t)t * H + row) * DV + cg * (DV / 4) + c0;
#pragma unroll
  for (int n = 0; n < DV / 64; ++n) {
    wmma::store_matrix_sync(stage, o[n], 16, wmma::mem_row_major);
    __syncwarp();
    store8(orow + n * 16, stage + r * 16 + c0, inv);
    __syncwarp();
  }
  if (tid < H)
    lse[(size_t)t * H + tid] =
        fmaxf(m_s[tid], 0.5f * NEG_INF) + logf(fmaxf(l_s[tid], 1e-30f));
}

// ---------------------------------------------------------------------------
// K5b: backward (dq and the per-slot dkvg rows of one chunk of queries)
// ---------------------------------------------------------------------------
struct BwdSmem {
  static constexpr int BT = 32;       // selected rows per tile
  static constexpr int SLD = BT + 4;  // f32 row stride of the s and dp tiles
  static constexpr int PLD = BT + 8;  // bf16 row stride of the p and ds tiles
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + sizeof(bf16) * H * QLD;
  static constexpr size_t kv_off = do_off + sizeof(bf16) * H * OLD;
  // s and dp are adjacent: together they are the staging of the dkvg and dq stores
  static constexpr size_t s_off = kv_off + sizeof(bf16) * BT * QLD;
  static constexpr size_t dp_off = s_off + sizeof(float) * H * SLD;
  static constexpr size_t p_off = dp_off + sizeof(float) * H * SLD;
  static constexpr size_t ds_off = p_off + sizeof(bf16) * H * PLD;
  static constexpr size_t lse_off = ds_off + sizeof(bf16) * H * PLD;
  static constexpr size_t delta_off = lse_off + sizeof(float) * H;
  static constexpr size_t idx_off = delta_off + sizeof(float) * H;  // two tiles' indices
  static constexpr size_t bytes = idx_off + sizeof(int) * 2 * BT;
  static_assert(2 * sizeof(float) * H * SLD >= sizeof(float) * NWARPS * 256,
                "staging does not fit");
};

__global__ void __launch_bounds__(NTHREADS)
sparse_mla_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                      const int* __restrict__ indices, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dq, bf16* __restrict__ dkvg, int Sk, int T,
                      float scale) {
  using M = BwdSmem;
  constexpr int BT = M::BT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + M::q_off);
  bf16* dOs = reinterpret_cast<bf16*>(smem + M::do_off);
  bf16* KVs = reinterpret_cast<bf16*>(smem + M::kv_off);
  float* Ss = reinterpret_cast<float*>(smem + M::s_off);
  float* dPs = reinterpret_cast<float*>(smem + M::dp_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + M::p_off);
  bf16* dSs = reinterpret_cast<bf16*>(smem + M::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + M::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + M::delta_off);
  int* idx_s = reinterpret_cast<int*>(smem + M::idx_off);

  const int c = gridDim.x - 1 - blockIdx.x;  // token within the chunk, the longest first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp & 3;   // this warp's 16 heads
  const int cg = warp >> 2;  // its quarter of dq's columns

  load_panel<DQ, QLD>(Qs, q + (size_t)c * H * DQ);
  load_panel<DV, OLD>(dOs, dout + (size_t)c * H * DV);
  if (tid < H) {
    lse_s[tid] = lse[(size_t)c * H + tid];
    delta_s[tid] = delta[(size_t)c * H + tid];
  }
  FragC dq_acc[DQ / 64];  // 16 rows x 144 columns of dq
#pragma unroll
  for (int n = 0; n < DQ / 64; ++n) wmma::fill_fragment(dq_acc[n], 0.f);

  float* stage = Ss + warp * 256;
  const int sr = lane >> 1, sc0 = (lane & 1) * 8;  // this lane's part of a staged tile
  const int* row_indices = indices + (size_t)c * T;
  int it = 0;
  for (int j0 = 0; j0 < T; j0 += BT, ++it) {
    // two index buffers in turn: a warp still storing tile i's dkvg rows reads
    // tile i's indices while the first warps already load tile i + 1's
    int* idx_cur = idx_s + (it & 1) * BT;
    const int my = load_indices<BT>(idx_cur, row_indices, j0, T, Sk);
    // also the barrier that ends the previous tile (and the prologue's loads)
    if (!__syncthreads_or(my >= 0)) continue;
    gather_tile<BT>(KVs, kv, idx_cur);
    __syncthreads();

    {  // warps 0-7: s = q kvg^T; warps 8-15: dp = do v^T; one 16x16 tile each
      const int cf = (warp >> 2) & 1;
      FragC acc;
      if (warp < 8) {
        mma_abt<DQ / 16>(acc, Qs + rg * 16 * QLD, QLD, KVs + cf * 16 * QLD, QLD);
        wmma::store_matrix_sync(Ss + rg * 16 * M::SLD + cf * 16, acc, M::SLD,
                                wmma::mem_row_major);
      } else {
        mma_abt<DV / 16>(acc, dOs + rg * 16 * OLD, OLD, KVs + cf * 16 * QLD, QLD);
        wmma::store_matrix_sync(dPs + rg * 16 * M::SLD + cf * 16, acc, M::SLD,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    {  // p and ds: 8 threads a row, 4 columns each
      const int row = tid >> 3, sub = tid & 7;
      const float l = lse_s[row], dl = delta_s[row];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = sub * 4 + k;
        float p = 0.f, ds = 0.f;
        if (idx_cur[col] >= 0) {
          p = expf(Ss[row * M::SLD + col] * scale - l);
          ds = p * (dPs[row * M::SLD + col] - dl) * scale;
        }
        Ps[row * M::PLD + col] = __float2bfloat16(p);
        dSs[row * M::PLD + col] = __float2bfloat16(ds);
      }
    }
    __syncthreads();

    // dq += ds kvg
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      FragA fa;
      wmma::load_matrix_sync(fa, dSs + rg * 16 * M::PLD + kk * 16, M::PLD);
#pragma unroll
      for (int n = 0; n < DQ / 64; ++n) {
        FragB fb;
        wmma::load_matrix_sync(fb, KVs + kk * 16 * QLD + cg * (DQ / 4) + n * 16, QLD);
        wmma::mma_sync(dq_acc[n], fa, fb, dq_acc[n]);
      }
    }

    // dkvg tile [BT, DQ] = ds^T q (+ p^T do on the first DV columns): its
    // 16x16 tiles are dealt round the warps, staged and written once as bf16
    for (int f = warp; f < (BT / 16) * (DQ / 16); f += NWARPS) {
      const int rg2 = f / (DQ / 16), cf = f % (DQ / 16);
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        FragAT fa;
        FragB fb;
        wmma::load_matrix_sync(fa, dSs + kk * 16 * M::PLD + rg2 * 16, M::PLD);
        wmma::load_matrix_sync(fb, Qs + kk * 16 * QLD + cf * 16, QLD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      if (cf < DV / 16) {
#pragma unroll
        for (int kk = 0; kk < H / 16; ++kk) {
          FragAT fa;
          FragB fb;
          wmma::load_matrix_sync(fa, Ps + kk * 16 * M::PLD + rg2 * 16, M::PLD);
          wmma::load_matrix_sync(fb, dOs + kk * 16 * OLD + cf * 16, OLD);
          wmma::mma_sync(acc, fa, fb, acc);
        }
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      const int jj = rg2 * 16 + sr;
      if (idx_cur[jj] >= 0)  // a sentinel slot's row is never read by the reduction
        store8(dkvg + ((size_t)c * T + j0 + jj) * DQ + cf * 16 + sc0, stage + sr * 16 + sc0,
               1.f);
      __syncwarp();
    }
  }
  __syncthreads();  // the last tile is consumed

  bf16* dqrow = dq + ((size_t)c * H + rg * 16 + sr) * DQ + cg * (DQ / 4) + sc0;
#pragma unroll
  for (int n = 0; n < DQ / 64; ++n) {
    wmma::store_matrix_sync(stage, dq_acc[n], 16, wmma::mem_row_major);
    __syncwarp();
    store8(dqrow + n * 16, stage + sr * 16 + sc0, 1.f);
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// dkv[r] += the dkvg rows of the slots that selected r, in the sorted order
// ---------------------------------------------------------------------------
constexpr int REDUCE_THREADS = 96;  // 72 of them own 8 channels each

__device__ __forceinline__ void add8(float* acc, const uint4& v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS)
sparse_mla_dkv_reduce_kernel(const bf16* __restrict__ dkvg, const long long* __restrict__ order,
                             const int* __restrict__ seg, float* __restrict__ dkv) {
  const int r = blockIdx.x;
  if (threadIdx.x >= V8) return;
  const int col = threadIdx.x * 8;
  const int lo = seg[r], hi = seg[r + 1];
  if (lo >= hi) return;
  float acc[8];
  float* drow = dkv + (size_t)r * DQ + col;
  const float4 a0 = *reinterpret_cast<const float4*>(drow);
  const float4 a1 = *reinterpret_cast<const float4*>(drow + 4);
  acc[0] = a0.x; acc[1] = a0.y; acc[2] = a0.z; acc[3] = a0.w;
  acc[4] = a1.x; acc[5] = a1.y; acc[6] = a1.z; acc[7] = a1.w;
  int s = lo;
  for (; s + 4 <= hi; s += 4) {  // four loads in flight, added in order
    uint4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = *reinterpret_cast<const uint4*>(dkvg + (size_t)order[s + i] * DQ + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) add8(acc, v[i]);
  }
  for (; s < hi; ++s)
    add8(acc, *reinterpret_cast<const uint4*>(dkvg + (size_t)order[s] * DQ + col));
  *reinterpret_cast<float4*>(drow) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(drow + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *configured = true;
  return err;
}

bool widths_ok(int heads, int dq, int dv) { return heads == H && dq == DQ && dv == DV; }

}  // namespace

extern "C" int sparse_mla_fwd(const void* q, const void* kv, const void* indices, void* out,
                              void* lse, int S, int Sk, int T, int heads, int dq, int dv,
                              float scale, void* stream) {
  if (!widths_ok(heads, dq, dv) || S < 0 || Sk <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  static bool configured = false;
  cudaError_t err = configure(sparse_mla_fwd_kernel, FwdSmem::bytes, &configured);
  if (err != cudaSuccess) return (int)err;
  sparse_mla_fwd_kernel<<<S, NTHREADS, FwdSmem::bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kv),
      static_cast<const int*>(indices), static_cast<bf16*>(out), static_cast<float*>(lse), S, Sk,
      T, scale);
  return (int)cudaGetLastError();
}

// one chunk of C queries: every pointer but kv starts at the chunk's first query
extern "C" int sparse_mla_bwd(const void* q, const void* kv, const void* indices,
                              const void* dout, const void* lse, const void* delta, void* dq,
                              void* dkvg, int C, int Sk, int T, int heads, int dqw, int dv,
                              float scale, void* stream) {
  if (!widths_ok(heads, dqw, dv) || C < 0 || Sk <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  static bool configured = false;
  cudaError_t err = configure(sparse_mla_bwd_kernel, BwdSmem::bytes, &configured);
  if (err != cudaSuccess) return (int)err;
  sparse_mla_bwd_kernel<<<C, NTHREADS, BwdSmem::bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kv),
      static_cast<const int*>(indices), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dq),
      static_cast<bf16*>(dkvg), Sk, T, scale);
  return (int)cudaGetLastError();
}

// dkv [Sk, Dq] f32 += over the slots order[seg[r] .. seg[r + 1]) of dkvg [slots, Dq] bf16
extern "C" int sparse_mla_dkv_reduce(const void* dkvg, const void* order, const void* seg,
                                     void* dkv, int Sk, int dqw, void* stream) {
  if (dqw != DQ || Sk <= 0) return (int)cudaErrorInvalidValue;
  sparse_mla_dkv_reduce_kernel<<<Sk, REDUCE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dkvg), static_cast<const long long*>(order),
      static_cast<const int*>(seg), static_cast<float*>(dkv));
  return (int)cudaGetLastError();
}
