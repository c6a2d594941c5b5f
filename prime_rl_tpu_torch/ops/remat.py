"""The product-keeping remat modes: ``selective`` and ``offload_dots`` (the
JAX package's ``checkpoint_dots_with_no_batch_dims`` and
``offload_dot_with_no_batch_dims`` policies) on ``torch.utils.checkpoint``.

A checkpointed layer runs its forward under ``_KeepDots`` and its backward's
recomputation under ``_ReplayDots`` (the checkpoint's ``context_fn``). Both
are dispatch modes, so they see the aten ops below autograd:

- the products with no batch dims (``aten.mm``, ``aten.addmm``: every ``x @
  W`` projection, the router's, and LoRA's ``x·A`` and ``(x·A)·B``) made with
  gradients enabled are kept, on the device (``selective``) or in the host
  tier (``offload_dots``, ``utils/offload.stash``), and the recomputation
  hands them back in the order they were made instead of running them again;
- everything else is recomputed: the norms, rope, the activations, the
  products with a batch dim (``aten.bmm``, ``aten._grouped_mm``: attention's
  scores, the MoE experts' grouped products, which on the CPU run as a loop of
  ``torch.mm`` inside ``batched_products``) and the attention kernel, which
  writes through raw pointers that no dispatch mode sees: K1 runs twice a
  layer, as the JAX policy recomputes its Pallas call; and int8 compute's
  ``aten._int_mm`` with its quantize passes (``ops/int8_linear.py``), which
  run inside an autograd function's forward, where gradients are off.

The forward and the recomputation issue the same aten ops in the same order
(the same code on the same inputs), which is what pairs a kept product with
its place; each replayed product is checked against the op it stands for
(its name, shape and dtype), so that a recomputation that strays raises
instead of handing a product to the wrong place. Products made under
``no_grad`` (the DSA indexer's scores, which it then changes in place) are
neither kept nor replayed. The checkpoint stops its recomputation once the
backward has what it needs, so a layer's last products (the down
projection's output) are kept though no replay takes them, until the
layer's backward frees its checkpoint.
"""

from __future__ import annotations

import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
_DOTS = (aten.mm.default, aten.addmm.default)
_local = threading.local()


class batched_products:
    """Inside it, ``aten.mm`` calls are the slices of a product with a batch
    dim (the MoE experts' loop on the CPU): the remat modes recompute them."""

    def __enter__(self):
        _local.batched = getattr(_local, "batched", 0) + 1

    def __exit__(self, *exc):
        _local.batched -= 1


def _is_dot(func) -> bool:
    return (func in _DOTS and torch.is_grad_enabled()
            and not getattr(_local, "batched", 0))


def _dot_meta(func, args) -> tuple:
    """(op, shape, dtype) of the product ``func(*args)`` makes: mm(a, b),
    addmm(bias, a, b)."""
    a, b = args[-2], args[-1]
    return func, (a.shape[0], b.shape[1]), a.dtype


class DotsKept:
    """One checkpointed call's kept products: ``contexts`` is its
    ``context_fn``. ``offload`` keeps them in the host tier."""

    def __init__(self, offload: bool = False):
        self.offload = offload
        self.kept: list = []  # (op, shape, dtype, the product or its Stashed)
        self.taken = 0

    def contexts(self):
        return _KeepDots(self), _ReplayDots(self)

    def take(self, meta: tuple) -> torch.Tensor:
        """The next kept product, which must be what ``meta`` (``_dot_meta``
        of the replayed op) describes."""
        i, self.taken = self.taken, self.taken + 1
        if i >= len(self.kept) or self.kept[i][:3] != meta:
            have = "nothing" if i >= len(self.kept) else self.kept[i][:3]
            raise RuntimeError(f"remat replay {i}: the recomputation asks for {meta}, the "
                               f"forward kept {have}")
        item, self.kept[i] = self.kept[i][3], meta + (None,)
        if not self.offload:
            return item.detach()
        if i == 0:  # the layer's products start their copies back together
            for later in self.kept[1:]:
                later[3].prefetch()
        return item.fetch()


class _KeepDots(TorchDispatchMode):
    def __init__(self, kept: DotsKept):
        super().__init__()
        self.dots = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _is_dot(func):
            meta = _dot_meta(func, args)
            if meta[1:] != (tuple(out.shape), out.dtype):
                raise RuntimeError(f"remat: {func} made {tuple(out.shape)} {out.dtype}, "
                                   f"not {meta[1:]}")
            if self.dots.offload:
                from prime_rl_tpu_torch.utils.offload import stash

                self.dots.kept.append(meta + (stash(out),))
            else:
                self.dots.kept.append(meta + (out.detach(),))
        return out


class _ReplayDots(TorchDispatchMode):
    def __init__(self, kept: DotsKept):
        super().__init__()
        self.dots = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dot(func):
            return self.dots.take(_dot_meta(func, args))
        return func(*args, **(kwargs or {}))
