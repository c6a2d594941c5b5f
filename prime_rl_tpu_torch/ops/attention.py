"""Attention ops for packed sequences (the port of the JAX package's
``ops/attention.py``).

Packed-sequence convention: a batch is ``[B, L]`` of concatenated sequences;
``segment_ids [B, L]`` (int32, 0 = padding) delimit them and position ids
restart per sequence. Attention is causal *within* a segment.

Two implementations with identical semantics:
  - ``xla_attention``: einsum + masked softmax in plain PyTorch; runs
    everywhere and materialises [B, NH, Lq, Lk] scores.
  - ``flash_attention`` (ops/flash_attention.py): the hand-written CUDA
    kernels K1 (forward) and K2a/K2b (backward), used by ``attention()`` for
    CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def segment_mask(seg_q: torch.Tensor, seg_kv: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """[B, Lq] x [B, Lk] -> bool [B, 1, Lq, Lk]; True = attend.

    Padding (segment id 0) attends nowhere and is attended by nothing."""
    valid = (seg_q[:, :, None] == seg_kv[:, None, :]) & (seg_q[:, :, None] != 0)
    if causal:
        lq, lk = seg_q.shape[1], seg_kv.shape[1]
        q_pos = torch.arange(lq, device=seg_q.device)[:, None] + (lk - lq)
        k_pos = torch.arange(lk, device=seg_q.device)[None, :]
        valid = valid & (q_pos >= k_pos)
    return valid[:, None, :, :]


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, L, NKV, HD] -> [B, L, NKV*n_rep, HD] for GQA."""
    if n_rep == 1:
        return x
    b, l, nkv, hd = x.shape
    return x[:, :, :, None, :].expand(b, l, nkv, n_rep, hd).reshape(b, l, nkv * n_rep, hd)


def xla_attention(
    q: torch.Tensor,  # [B, Lq, NH, HD]
    k: torch.Tensor,  # [B, Lk, NKV, HD]
    v: torch.Tensor,  # [B, Lk, NKV, HD]
    segment_ids_q: torch.Tensor,  # [B, Lq] int
    segment_ids_kv: torch.Tensor,  # [B, Lk] int
    causal: bool = True,
    scale: float | None = None,
    window: int = 0,  # sliding window; 0 = full attention
    sinks: torch.Tensor | None = None,  # [NH] learned sink logits (gpt-oss style)
) -> torch.Tensor:
    nh, nkv = q.shape[2], k.shape[2]
    k = repeat_kv(k, nh // nkv)
    v = repeat_kv(v, nh // nkv)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # [B, NH, Lq, Lk] scores in fp32 for a numerically stable softmax
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = segment_mask(segment_ids_q, segment_ids_kv, causal)
    lq, lk = q.shape[1], k.shape[1]
    if window and window > 0:
        q_pos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        k_pos = torch.arange(lk, device=q.device)[None, :]
        mask = mask & (q_pos - k_pos < window)[None, None]
    scores = torch.where(mask, scores, NEG_INF)
    if sinks is not None:
        # sink = a virtual token with learned logit and zero value: it joins
        # the softmax denominator only
        sf = sinks.float()[None, :, None, None]
        m = torch.maximum(scores.amax(dim=-1, keepdim=True), sf)
        p = torch.exp(scores - m)
        probs = (p / (p.sum(dim=-1, keepdim=True) + torch.exp(sf - m))).to(v.dtype)
    else:
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    causal: bool = True,
    scale: float | None = None,
    window: int = 0,
    sinks: torch.Tensor | None = None,
    impl: str = "auto",
    saved=None,
) -> torch.Tensor:
    """Self-attention dispatch (Lq == Lk), differentiable on both routes.

    ``impl`` ``auto``: CUDA tensors go through the flash kernels (K1 forward,
    K2a/K2b backward) at every length, CPU tensors through ``xla_attention``
    and PyTorch's own autograd. ``pallas`` (the JAX package's name for its
    kernel route) forces the flash route, which on the CPU runs the kernels'
    plain versions; ``xla`` forces ``xla_attention``. ``saved`` (an
    ``AttnSaved``) keeps the flash kernel's outputs across a checkpoint's
    recomputation. Context parallelism (the JAX ``mesh`` argument) is not part
    of this slice."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "pallas" or (impl == "auto" and q.is_cuda):
        from prime_rl_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, segment_ids, causal=causal, scale=scale,
                               window=window, sinks=sinks, saved=saved)
    return xla_attention(q, k, v, segment_ids, segment_ids, causal=causal, scale=scale,
                         window=window, sinks=sinks)


def make_segment_ids(seq_lens: list[int], total_len: int) -> np.ndarray:
    """Host helper: seq_lens -> int32 [total_len] segment ids (1-based, 0 pad)."""
    seg = np.zeros(total_len, dtype=np.int32)
    off = 0
    for i, n in enumerate(seq_lens):
        seg[off: off + n] = i + 1
        off += n
    return seg


def make_position_ids(seq_lens: list[int], total_len: int) -> np.ndarray:
    pos = np.zeros(total_len, dtype=np.int32)
    off = 0
    for n in seq_lens:
        pos[off: off + n] = np.arange(n)
        off += n
    return pos
