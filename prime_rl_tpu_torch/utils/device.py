"""Device resolution and device-memory reporting (the port's counterpart of
the JAX package's ``utils/jax_env.py`` and ``utils/memory.py``).

The port runs on a CUDA card unless the caller asks for the CPU. Asking for
``cuda`` on a machine without a card raises: nothing falls back to the CPU
behind the caller's back."""

from __future__ import annotations

from typing import Literal

import torch


def resolve_device(device: Literal["cuda", "cpu"] | str = "cuda") -> torch.device:
    """``"cuda"`` (the default) or ``"cpu"`` -> a ``torch.device``. Raises
    ``RuntimeError`` for ``cuda`` when no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was asked for but torch.cuda.is_available() is "
                "False; pass device='cpu' (--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def memory_info(device: torch.device) -> tuple[int, int]:
    """(free, total) bytes of device memory, from ``torch.cuda.mem_get_info``.
    Only defined for CUDA devices."""
    if device.type != "cuda":
        raise ValueError(f"memory_info needs a CUDA device, got {device}")
    free, total = torch.cuda.mem_get_info(device)
    return int(free), int(total)
