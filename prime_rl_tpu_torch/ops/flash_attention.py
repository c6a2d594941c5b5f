"""K1: flash-attention forward over packed sequences — the hand-written CUDA
kernel ``csrc/flash_attn_fwd.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``prime_rl_tpu/ops/flash_attention.py`` ``_fwd_kernel``
(the ``pallas_call`` in ``_fwd``). Public entry points keep the JAX
signatures and the ``[B, L, N, D]`` layout: ``flash_attention`` (out) and
``flash_attention_with_lse`` (out, lse ``[B, NH, Lq]``).

Contract: segment 0 is padding; a query attends a key only within its own
segment and (causal) at or before its own position; GQA maps q head h to kv
head ``h // (NH // NKV)``; f32 online softmax; a row that sees no key gets
output 0 and lse -1e30. On the card the kernel takes bf16 q/k/v with head
dim 64 or 128 and no window or sinks (those come with the gpt-oss slice).

What bounds it on the H100 and what the design does about it: see the
source note in ``csrc/flash_attn_fwd.cu`` (compute-bound at prefill lengths;
WMMA bf16 tiles, causal tiles above the diagonal skipped).

For CPU tensors the wrapper runs ``flash_attention_reference``, the plain
version of the same function; for CUDA tensors it launches the kernel or
raises. The backward kernels (K2a/K2b) belong to the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from prime_rl_tpu_torch.ops import _build

NEG_INF = -1e30
KERNEL = "flash_attn_fwd"

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load(KERNEL).flash_attn_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def flash_attention_reference(q, k, v, seg_q, seg_kv, causal: bool, scale: float):
    """Plain version: (out [B, Lq, NH, HD] in q.dtype, lse [B, NH, Lq] f32),
    scores and softmax in f32, rows without any visible key -> 0 / -1e30."""
    nh, nkv = q.shape[2], k.shape[2]
    g = nh // nkv
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    mask = (seg_q[:, :, None] == seg_kv[:, None, :]) & (seg_q[:, :, None] != 0)
    if causal:
        rows = torch.arange(q.shape[1], device=q.device)[:, None]
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = mask & (rows >= cols)
    mask = mask[:, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / torch.where(l > 0, l, 1.0), vf)
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), NEG_INF)[..., 0]
    return out.to(q.dtype), lse


def _fwd_cuda(q, k, v, seg_q, seg_kv, causal: bool, scale: float):
    b, lq, nh, hd = q.shape
    lk, nkv = k.shape[1], k.shape[2]
    if hd not in (64, 128) or nh % nkv:
        raise ValueError(f"flash_attn_fwd takes head_dim 64 or 128 and NH % NKV == 0, "
                         f"got head_dim {hd}, heads {nh}/{nkv}")
    _build.require(q, "q", torch.bfloat16)
    _build.require(k, "k", torch.bfloat16, (b, lk, nkv, hd))
    _build.require(v, "v", torch.bfloat16, (b, lk, nkv, hd))
    _build.require(seg_q, "seg_q", torch.int32, (b, lq))
    _build.require(seg_kv, "seg_kv", torch.int32, (b, lk))
    out = torch.empty_like(q)
    lse = torch.empty((b, nh, lq), dtype=torch.float32, device=q.device)
    fn = _kernel()
    _build.check(KERNEL, fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(),
                            seg_kv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, lq, lk,
                            nh, nkv, hd, float(scale), int(causal), _build.stream_ptr(q)))
    _build.launches[KERNEL] += 1
    return out, lse


def _fwd(q, k, v, seg_q, seg_kv, causal: bool, scale: float | None):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _fwd_cuda(q, k, v, seg_q.to(torch.int32), seg_kv.to(torch.int32), causal, scale)
    return flash_attention_reference(q, k, v, seg_q, seg_kv, causal, scale)


def flash_attention(
    q: torch.Tensor,  # [B, L, NH, HD]
    k: torch.Tensor,  # [B, L, NKV, HD]
    v: torch.Tensor,  # [B, L, NKV, HD]
    segment_ids: torch.Tensor,  # [B, L] int32, 0 = pad
    causal: bool = True,
    scale: float | None = None,
    window: int = 0,
    sinks: torch.Tensor | None = None,
) -> torch.Tensor:
    """Public entry, [B, L, N, D] layout in and out (matches ops.attention)."""
    if window or sinks is not None:
        raise NotImplementedError("sliding windows and attention sinks in K1 come with the "
                                  "gpt-oss slice; this slice ports causal + segments + GQA")
    out, _ = _fwd(q, k, v, segment_ids, segment_ids, causal, scale)
    return out


def flash_attention_with_lse(
    q: torch.Tensor,  # [B, Lq, NH, HD]
    k: torch.Tensor,  # [B, Lkv, NKV, HD]
    v: torch.Tensor,  # [B, Lkv, NKV, HD]
    seg_q: torch.Tensor,  # [B, Lq]
    seg_kv: torch.Tensor,  # [B, Lkv]
    causal: bool = False,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Lq, NH, HD], lse [B, NH, Lq]): partials over different KV
    blocks merge exactly through their lse. ``causal`` compares absolute row
    and column indices, so it only makes sense for the diagonal block."""
    return _fwd(q, k, v, seg_q, seg_kv, causal, scale)
