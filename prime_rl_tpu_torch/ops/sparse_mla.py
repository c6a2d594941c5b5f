"""DSA sparse MLA attention in plain PyTorch (the port of the JAX package's
``ops/sparse_mla.py``, which is XLA code there, outside any Pallas kernel):
interleaved rope, the indexer's top-k selection and its threshold form, the
chunked-gather sparse attention and the dense causal MLA attention.

All functions take single-row inputs ``[S, ...]``; the families loop over the
packed batch dim. Like the JAX functions they round the products' inputs to
bfloat16 and accumulate in float32, whatever dtype they are given, so the
float32 parity tests compare like with like. The chunked-gather
``sparse_mla_attention`` computes the same function as the hand-written
kernels of ``ops/sparse_mla_kernel.py`` (K5a/K5b) and is the path the tests
hold them against; the families call the kernel module.

Divergences from the JAX package, on purpose:
- ``mla_topk_indices(method="approx")`` is ``jax.lax.approx_max_k``, which
  only the TPU has in hardware: it raises ``NotImplementedError`` here.
- Ties are broken as ``jax.lax.top_k`` breaks them (the lower index first)
  by a stable descending sort, so that the selected set is the same in both
  packages; ``torch.topk`` promises no order among ties, and the masked
  entries all tie at -1e30.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, as float32: the products below multiply
    bfloat16 values and sum in float32, as the JAX functions do."""
    return x.to(torch.bfloat16).float()


def interleaved_rope(x: torch.Tensor, position_ids: torch.Tensor,
                     inv_freq: torch.Tensor) -> torch.Tensor:
    """Interleaved (non-neox) rotary: pairs are (0,1), (2,3), ... and the
    output keeps the de-interleaved [evens', odds'] layout (HF
    apply_rotary_pos_emb_interleave: q and k permute identically, so scores
    are unchanged by the basis).

    x: [S, H, d] or [S, d]; position_ids: [S]; inv_freq: [d//2].
    """
    angles = position_ids[:, None].float() * inv_freq.float()  # [S, d//2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if x.dim() == 3:
        cos, sin = cos[:, None, :], sin[:, None, :]
    xf = x.float()
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    out = torch.cat([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return out.to(x.dtype)


def _indexer_logits(qc, wc, ksc, kec, k_t, pos):
    """[C, Sk] f32 masked indexer logits of one query chunk:
    sum_h w[:, h] * relu(q[:, h] . k), -1e30 outside [ks, ke)."""
    s = torch.matmul(_bf16(qc).transpose(0, 1), k_t)  # [Hi, C, Sk]
    logits = s.relu_().mul_(wc.float().T[:, :, None]).sum(dim=0)
    valid = (pos[None, :] >= ksc[:, None]) & (pos[None, :] < kec[:, None])
    return torch.where(valid, logits, NEG_INF)


@torch.no_grad()
def mla_topk_indices(
    q_idx: torch.Tensor,  # [S, Hi, Di]
    k_idx: torch.Tensor,  # [Sk, Di]
    w: torch.Tensor,  # [S, Hi] per-head weights
    ks: torch.Tensor,  # [S] int first valid K index per query
    ke: torch.Tensor,  # [S] int one-past-last valid K index (causal incl. self)
    topk: int,
    chunk: int = 1024,
    method: str = "exact",
) -> torch.Tensor:
    """[S, topk] int32 selected K indices per query; sentinel = Sk for
    out-of-range / sub-topk slots. Each row's real indices are distinct. The
    whole computation is gradient-free."""
    if method != "exact":
        raise NotImplementedError(
            f"top-k method {method!r}: the approximate top-k (jax.lax.approx_max_k) is TPU "
            "hardware and has no counterpart here; use 'exact'")
    S = q_idx.shape[0]
    Sk = k_idx.shape[0]
    k_eff = min(topk, Sk)
    k_t = _bf16(k_idx).T  # [Di, Sk]
    pos = torch.arange(Sk, dtype=torch.int32, device=k_idx.device)
    out = torch.full((S, topk), Sk, dtype=torch.int32, device=k_idx.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        logits = _indexer_logits(q_idx[sl], w[sl], ks[sl], ke[sl], k_t, pos)
        val, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        val, idx = val[:, :k_eff], idx[:, :k_eff]
        out[sl, :k_eff] = torch.where(val > NEG_INF / 2, idx, Sk).to(torch.int32)
    return out


@torch.no_grad()
def mla_topk_thresholds(
    q_idx: torch.Tensor,  # [S, Hi, Di]
    k_idx: torch.Tensor,  # [Sk, Di]
    w: torch.Tensor,  # [S, Hi]
    ks: torch.Tensor,  # [S]
    ke: torch.Tensor,  # [S]
    topk: int,
    chunk: int = 1024,
) -> torch.Tensor:
    """[S] f32 per-token k-th-largest valid indexer logit: an entry is
    selected iff its logit >= tau and it lies in [ks, ke). Tokens with fewer
    than ``topk`` valid entries get tau = -1e30, selecting exactly the valid
    set (the sentinel-drop semantics)."""
    S = q_idx.shape[0]
    Sk = k_idx.shape[0]
    k_eff = min(topk, Sk)
    k_t = _bf16(k_idx).T
    pos = torch.arange(Sk, dtype=torch.int32, device=k_idx.device)
    out = torch.empty((S,), dtype=torch.float32, device=k_idx.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        logits = _indexer_logits(q_idx[sl], w[sl], ks[sl], ke[sl], k_t, pos)
        kth = torch.topk(logits, k_eff, dim=-1).values[:, -1]
        out[sl] = torch.where(kth > NEG_INF / 2, kth, NEG_INF)
    return out


def sparse_mla_attention(
    q: torch.Tensor,  # [S, H, Dq] (absorbed latent + rope tail)
    kv: torch.Tensor,  # [Sk, Dq] latent KV
    indices: torch.Tensor,  # [S, topk] int, sentinel = Sk
    sm_scale: float,
    v_dim: int,
    chunk: int = 256,
) -> torch.Tensor:
    """[S, H, v_dim]: softmax over each query's top-k gathered latent rows;
    value = the first ``v_dim`` channels of the gathered row (absorbed MLA).
    Differentiable by autograd; the normalised probabilities are rounded to
    kv's dtype before the value product, as the JAX function rounds them."""
    S = q.shape[0]
    Sk = kv.shape[0]
    outs = []
    for c0 in range(0, S, chunk):
        qc, ic = q[c0:c0 + chunk], indices[c0:c0 + chunk].long()
        valid = (ic >= 0) & (ic < Sk)
        kvg = kv[ic.clamp(0, Sk - 1)]  # [C, T, Dq]; a sentinel's row is masked below
        s = torch.einsum("chd,ctd->cht", _bf16(qc), _bf16(kvg)) * sm_scale
        s = torch.where(valid[:, None, :], s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(valid[:, None, :], torch.exp(s - m.clamp(min=NEG_INF / 2)), 0.0)
        p = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
        o = torch.einsum("cht,ctd->chd", p.to(kv.dtype).float(), kvg[..., :v_dim].float())
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=0)


def dense_mla_attention(
    q: torch.Tensor,  # [S, H, Dq]
    kv: torch.Tensor,  # [Sk, Dq]
    segment_ids: torch.Tensor,  # [S] (0 = pad), shared q/k coordinates (Sk == S)
    sm_scale: float,
    v_dim: int,
) -> torch.Tensor:
    """Full causal + segment-masked MLA attention (absorbed form): the
    index_topk >= S limit of the sparse path, and the deepseek_v3 (non-DSA)
    attention."""
    S = q.shape[0]
    pos = torch.arange(S, device=q.device)
    mask = ((pos[:, None] >= pos[None, :])
            & (segment_ids[:, None] == segment_ids[None, :])
            & (segment_ids > 0)[:, None])[:, None, :]  # [S, 1, Sk]
    s = torch.einsum("shd,td->sht", _bf16(q), _bf16(kv)) * sm_scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m.clamp(min=NEG_INF / 2)), 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("sht,td->shd", p.to(kv.dtype).float(), kv[:, :v_dim].float())
    return o.to(q.dtype)
