"""Elementwise/normalization/position ops for the dense path (the port of
the JAX package's ``ops/layers.py``). Same arithmetic and the same places
where values are cast: norms and rope run in float32 and cast back to the
input dtype."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def weight_mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a raw weight [in, out], or for an int8 weight-only record
    ``{"q8": int8 [in, out], "scale": f32 [out]}`` (``sampler/model.
    quantize_params``): the product with the int8 weight cast to x's dtype,
    then the per-column scale in x's dtype, in the JAX package's order."""
    if isinstance(w, dict):
        return torch.matmul(x, w["q8"].to(x.dtype)) * w["scale"].to(x.dtype)
    return torch.matmul(x, w)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 with cast back to input dtype (matches HF Qwen/Llama)."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (mean-subtracting, affine) in fp32 with cast back: the DSA
    indexer's k-norm and the vision tower's norms."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    xf = xf * weight.float()
    if bias is not None:
        xf = xf + bias.float()
    return xf.to(dtype)


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """Inverse frequencies [head_dim//2] (float32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def yarn_rope_parameters(
    head_dim: int,
    theta: float,
    factor: float,
    original_max_pos: int,
    beta_fast: float = 32.0,
    beta_slow: float = 1.0,
    truncate: bool = True,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, float]:
    """YaRN-scaled inverse frequencies + cos/sin attention factor
    (paper 2309.00071; HF ``_compute_yarn_parameters``)."""
    dim = head_dim
    pos_freqs = theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    inv_extrapolation = 1.0 / pos_freqs
    inv_interpolation = 1.0 / (factor * pos_freqs)

    def correction_dim(num_rot):
        return (dim * math.log(original_max_pos / (num_rot * 2 * math.pi))) / (
            2 * math.log(theta))

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    extrapolation_factor = 1.0 - ramp
    inv_freq = (inv_interpolation * (1 - extrapolation_factor)
                + inv_extrapolation * extrapolation_factor)
    attention_factor = 0.1 * math.log(factor) + 1.0 if factor > 1 else 1.0
    return inv_freq, attention_factor


def apply_rope(
    x: torch.Tensor,  # [B, L, N, HD]
    position_ids: torch.Tensor,  # [B, L] int, or [B, L, rot//2] per frequency
    inv_freq: torch.Tensor,  # [rot//2]
    scaling: float = 1.0,  # YaRN attention factor on cos/sin
) -> torch.Tensor:
    """Rotary embedding, half-split layout (HF ``rotate_half``). Partial
    rotary: an ``inv_freq`` shorter than head_dim//2 rotates only the leading
    ``2*len(inv_freq)`` dims; the tail passes through. mRoPE (qwen3_vl):
    ``position_ids`` of [B, L, rot//2] give each frequency its own position
    (its t, h or w grid coordinate), and the angles are elementwise."""
    dtype = x.dtype
    rot = 2 * inv_freq.shape[0]
    hd = x.shape[-1]
    if position_ids.dim() == 3:  # [B, L, rot//2] per-frequency positions
        angles = position_ids.float() * inv_freq.float()
    else:
        angles = position_ids[..., None].float() * inv_freq.float()  # [B, L, rot//2]
    cos = (torch.cos(angles) * scaling)[:, :, None, :]
    sin = (torch.sin(angles) * scaling)[:, :, None, :]
    xf = x.float()
    x_rot, x_pass = xf[..., :rot], xf[..., rot:]
    x1, x2 = x_rot.chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = rotated if rot == hd else torch.cat([rotated, x_pass], dim=-1)
    return out.to(dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def clamped_glu(gate: torch.Tensor, up: torch.Tensor, alpha: float, limit: float) -> torch.Tensor:
    """gpt-oss expert activation: clamp both branches, gated sigmoid(alpha * g)
    with a +1 on the linear branch (HF ``GptOssExperts.forward``)."""
    gate = gate.clamp(max=limit)
    up = up.clamp(-limit, limit)
    return (up + 1.0) * (gate * torch.sigmoid(alpha * gate))
