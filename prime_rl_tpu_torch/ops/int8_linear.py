"""int8-compute product for training (the port of the JAX package's
``ops/int8_linear.py``): ``model.quantized_compute = "int8"`` runs the MLP
projections of the dense families through it.

Both operands are quantized on the fly, the activations per row and the
weight per column (symmetric absmax, codes in [-127, 127]), multiplied as
int8 x int8 -> int32 (``torch._int_mm``: cuBLASLt's int8 product on the card,
a plain integer product on the CPU), and the int32 accumulator is scaled back
to the activations' dtype. The backward is the straight-through estimator in
bfloat16 against the unquantized operands, as in the JAX package.

The product is exact in int32: the worst |acc| at K = 3072 is 127² x 3072 ≈
4.95e7, past float32's 2^24 but far inside int32. ``torch._int_mm`` on the
card takes only M > 16 and K, N multiples of 8; ``int_mm`` pads the operands
with zero rows and columns to meet that, on every device, and slices the
result. A zero row or column changes no absmax, no code and no accumulator,
so the padding is exact. No shape falls back to a float product.

Under the ``selective`` and ``offload_dots`` remat modes (``ops/remat.py``)
the kept products are ``aten.mm`` / ``aten.addmm`` made with gradients on;
this product's ``aten._int_mm`` and its quantize passes run inside the
autograd function's forward, where gradients are off, so they are
recomputed in the backward and none of them is kept.
"""

from __future__ import annotations

import torch

from prime_rl_tpu_torch.ops import _build

_QMAX = 127.0
COUNT = "int_mm"  # the key of ``_build.launches`` that counts ``int_mm``'s products


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127, divided as JAX divides: by a tensor of 127s
    (a fill on amax's device, no host copy), since PyTorch's CUDA division by
    a Python number multiplies by its reciprocal, which rounds some scales
    one ulp away."""
    return torch.clamp(amax, min=1e-8) / torch.full_like(amax, _QMAX)


def quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[.., K] float -> (int8 [.., K], f32 scale [.., 1]), per row symmetric."""
    x = x.float()
    scale = _scale(x.abs().amax(dim=-1, keepdim=True))
    return torch.clamp(torch.round(x / scale), -_QMAX, _QMAX).to(torch.int8), scale


def quant_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (int8 [K, N], f32 scale [1, N]), per column symmetric.
    The codes are laid out column-major (the transpose of a contiguous [N,
    K]): cuBLASLt's int8 product reads that layout about four times faster
    on an H100 than a row-major one. The cast writes them transposed."""
    w = w.float()
    scale = _scale(w.abs().amax(dim=0, keepdim=True))
    codes = torch.clamp(torch.round(w / scale), -_QMAX, _QMAX)
    q = torch.empty((w.shape[1], w.shape[0]), dtype=torch.int8, device=w.device)
    return q.copy_(codes.t()).t(), scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a int8 [M, K] @ b int8 [K, N] -> int32 [M, N] through ``torch._int_mm``,
    the operands padded with zeros to M >= 17 and K, N multiples of 8 (what
    ``torch._int_mm`` takes on the card), the result sliced back. ``b`` goes
    in column-major (copied there if it is not). Each call adds one to
    ``_build.launches[COUNT]``."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m)) if (mp, kp) != (m, k) else a
    bt = b.t()  # [N, K]: contiguous where b is column-major
    if (kp, np_) != (k, n):
        bt = torch.nn.functional.pad(bt, (0, kp - k, 0, np_ - n))
    _build.launches[COUNT] += 1
    out = torch._int_mm(a.contiguous(), bt.contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def int8_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward: x [.., K] @ w [K, N] in int8, out in x's dtype."""
    lead, k = x.shape[:-1], x.shape[-1]
    xq, xs = quant_rows(x.reshape(-1, k))
    wq, ws = quant_cols(w)
    acc = int_mm(xq, wq)
    return ((acc.float() * xs) * ws).to(x.dtype).reshape(*lead, w.shape[1])


class _Int8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return int8_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        bf = torch.bfloat16
        g2 = g.reshape(-1, g.shape[-1]).to(bf)
        gx = (g2 @ w.to(bf).T).to(x.dtype).reshape(x.shape)
        gw = (x.reshape(-1, x.shape[-1]).to(bf).T @ g2).to(w.dtype)
        return gx, gw


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [.., K] @ w [K, N] with an int8 x int8 -> int32 product.

    Forward: per-row / per-column dynamic symmetric quantization; backward:
    bfloat16 against the original operands (straight-through)."""
    return _Int8Matmul.apply(x, w)
