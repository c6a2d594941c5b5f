"""K3: fused decode-time QKV preparation — the hand-written CUDA kernel
``csrc/decode_qkv.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``prime_rl_tpu/ops/decode_qkv.py`` ``_kernel`` (the
``pallas_call`` in ``decode_qkv_prep``): for S decode tokens, rms-norm ->
q/k/v projections (computed inside the kernel) -> optional bias -> per-head
RMS qk-norm -> half-split rope with partial rotation and a cos/sin
``scaling`` (YaRN). The normed x is cast to the weight dtype before the
product, as the TPU kernel does; bias, qk-norm and rope stay in f32 until
the final cast. The TPU kernel's VMEM budget gate (``fits_vmem``) is a TPU
tile-size concern and has no counterpart here.

What bounds it on the H100 and what the design does about it: see the
source note in ``csrc/decode_qkv.cu`` (bound by the weight read; one block
per (head, 16-token tile), norm in shared memory, qk-norm and rope as the
epilogue).

For CPU tensors ``decode_qkv_prep`` runs ``decode_qkv_prep_reference``; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from prime_rl_tpu_torch.ops import _build

KERNEL = "decode_qkv_prep"
_LIB = "decode_qkv"

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load(_LIB).decode_qkv_prep
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 15 + [i, i, i, i, i, i, f, f, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def decode_qkv_prep_reference(x, norm_w, wq, wk, wv, positions, inv_freq, *, num_heads,
                              num_kv_heads, head_dim, qk_norm=True, q_norm_w=None,
                              k_norm_w=None, q_bias=None, k_bias=None, v_bias=None,
                              rot=None, scaling=1.0, eps=1e-6):
    """Plain version with the kernel's arithmetic: f32 norm, cast of the
    normed x to the weight dtype, f32 products, bias/qk-norm/rope in f32."""
    s = x.shape[0]
    if rot is None:
        rot = 2 * inv_freq.shape[0]
    xf = x.float()
    xn = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * norm_w.float()
    xb = xn.to(wq.dtype).float()
    r2 = rot // 2
    angles = positions.float()[:, None] * inv_freq.float()[None, :]  # [S, R2]
    cos = (torch.cos(angles) * scaling)[:, None, :]
    sin = (torch.sin(angles) * scaling)[:, None, :]

    def head_prep(flat, n_heads, norm, bias):
        h3 = flat.reshape(s, n_heads, head_dim)
        if bias is not None:
            h3 = h3 + bias.float().reshape(1, n_heads, head_dim)
        if qk_norm:
            h3 = h3 * torch.rsqrt(h3.square().mean(-1, keepdim=True) + eps)
            if norm is not None:
                h3 = h3 * norm.float()
        x1, x2 = h3[..., :r2], h3[..., r2:rot]
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return rotated if rot == head_dim else torch.cat([rotated, h3[..., rot:]], dim=-1)

    q = head_prep(xb @ wq.float(), num_heads, q_norm_w, q_bias)
    k = head_prep(xb @ wk.float(), num_kv_heads, k_norm_w, k_bias)
    v = (xb @ wv.float()).reshape(s, num_kv_heads, head_dim)
    if v_bias is not None:
        v = v + v_bias.float().reshape(1, num_kv_heads, head_dim)
    return q.to(x.dtype), k.to(x.dtype), v.to(x.dtype)


def decode_qkv_prep(
    x: torch.Tensor,  # [S, D] hidden states (pre-attn-norm)
    norm_w: torch.Tensor,  # [D]
    wq: torch.Tensor,  # [D, NH*HD]
    wk: torch.Tensor,  # [D, NKV*HD]
    wv: torch.Tensor,
    positions: torch.Tensor,  # [S] int
    inv_freq: torch.Tensor,  # [rot // 2] f32
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    qk_norm: bool = True,
    q_norm_w: torch.Tensor | None = None,  # [HD]
    k_norm_w: torch.Tensor | None = None,
    q_bias: torch.Tensor | None = None,  # flat or per-head bias
    k_bias: torch.Tensor | None = None,
    v_bias: torch.Tensor | None = None,
    rot: int | None = None,
    scaling: float = 1.0,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q [S, NH, HD], k [S, NKV, HD], v [S, NKV, HD]) in x.dtype."""
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
              qk_norm=qk_norm, q_norm_w=q_norm_w, k_norm_w=k_norm_w, q_bias=q_bias,
              k_bias=k_bias, v_bias=v_bias, rot=rot, scaling=scaling, eps=eps)
    if not x.is_cuda:
        return decode_qkv_prep_reference(x, norm_w, wq, wk, wv, positions, inv_freq, **kw)
    s, d = x.shape
    nh, nkv, hd = num_heads, num_kv_heads, head_dim
    if rot is None:
        rot = 2 * inv_freq.shape[0]
    if hd not in (64, 128) or d % 16 or rot % 2 or rot > hd:
        raise ValueError(f"decode_qkv_prep takes head_dim 64 or 128, hidden % 16 == 0 and an "
                         f"even rot <= head_dim; got {hd}, {d}, {rot}")
    bf = torch.bfloat16
    _build.require(x, "x", bf)
    _build.require(norm_w, "norm_w", bf, (d,))
    _build.require(wq, "wq", bf, (d, nh * hd))
    _build.require(wk, "wk", bf, (d, nkv * hd))
    _build.require(wv, "wv", bf, (d, nkv * hd))
    positions = positions.to(torch.int32)
    _build.require(positions, "positions", torch.int32, (s,))
    _build.require(inv_freq, "inv_freq", torch.float32, (rot // 2,))
    biases = (q_bias, k_bias, v_bias)
    if any(b is not None for b in biases) and any(b is None for b in biases):
        raise ValueError("q/k/v biases come together")
    for name, b, n in zip(("q_bias", "k_bias", "v_bias"), biases, (nh, nkv, nkv)):
        if b is not None:
            _build.require(b, name, bf)
            if b.numel() != n * hd:
                raise ValueError(f"{name}: expected {n * hd} values, got {b.numel()}")
    if qk_norm:
        if q_norm_w is None or k_norm_w is None:
            raise ValueError("qk_norm needs q_norm_w and k_norm_w")
        _build.require(q_norm_w, "q_norm_w", bf, (hd,))
        _build.require(k_norm_w, "k_norm_w", bf, (hd,))
    q = torch.empty((s, nh, hd), dtype=bf, device=x.device)
    k = torch.empty((s, nkv, hd), dtype=bf, device=x.device)
    v = torch.empty((s, nkv, hd), dtype=bf, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _kernel()
    _build.check(KERNEL, fn(
        x.data_ptr(), norm_w.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
        ptr(q_bias), ptr(k_bias), ptr(v_bias),
        ptr(q_norm_w) if qk_norm else None, ptr(k_norm_w) if qk_norm else None,
        positions.data_ptr(), inv_freq.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        s, d, nh, nkv, hd, rot, float(scaling), float(eps), int(qk_norm),
        _build.stream_ptr(x)))
    _build.launches[KERNEL] += 1
    return q, k, v
