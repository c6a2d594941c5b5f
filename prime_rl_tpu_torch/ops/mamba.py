"""Segment-aware causal depthwise convolution (the port of
``causal_conv1d`` in the JAX package's ``ops/mamba.py``; Qwen3-Next's
linear-attention layers run it over q|k|v). Plain PyTorch, as it is XLA in
the JAX package. The Mamba-2 SSD of that module waits for the nemotron_h
slice.

The K taps are K shifted multiply-adds, the segment mask applied to each
shifted input, as JAX writes it: no convolution operator, whose backward
(cuDNN's) need not give equal bits from run to run."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv1d(
    x: torch.Tensor,  # [B, L, C]
    weight: torch.Tensor,  # [C, K]: tap k multiplies x[t - K + 1 + k]
    bias: torch.Tensor | None,
    segment_ids: torch.Tensor | None = None,  # [B, L]; taps never cross segments
) -> torch.Tensor:
    """Depthwise causal conv [B, L, C] in x's dtype; a tap that would read
    another segment (or padding) reads 0."""
    _, l, _ = x.shape
    k = weight.shape[1]
    out = x * weight[None, None, :, k - 1]
    for s in range(1, k):
        shifted = F.pad(x, (0, 0, s, 0))[:, :l]
        if segment_ids is not None:
            seg_shift = F.pad(segment_ids, (s, 0))[:, :l]
            same = (seg_shift == segment_ids) & (segment_ids != 0)
            shifted = shifted * same[..., None]
        out = out + shifted * weight[None, None, :, k - 1 - s]
    if bias is not None:
        out = out + bias
    return out
