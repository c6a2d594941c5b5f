"""Memory observability and the collector gate (the port of the JAX
package's ``utils/memory.py``).

- ``device_memory_stats``: the trainer's card, bytes in use, its limit and
  the peak, under the JAX function's key names (``torch.cuda.memory_stats``
  and ``torch.cuda.mem_get_info``).
- ``dump_memory_profile``: the caching allocator's snapshot (a pickle that
  PyTorch's memory viewer reads), from the history that
  ``record_memory_history`` starts.
- ``GarbageCollection``: Python's automatic collector off, a collection
  every ``interval`` steps instead: a collector pause inside the train loop
  leaves the card idle. ``restore`` turns the collector back on; the trainer
  calls it when ``train`` returns or raises, because the colocated process
  and the tests run ``train`` in interpreters that live on (the JAX trainer
  never restores it).
"""

from __future__ import annotations

import gc
from pathlib import Path

import torch


def device_memory_stats(device: torch.device | str | None = None) -> dict[str, float]:
    """``device{i}/bytes_in_use_gb``, ``device{i}/bytes_limit_gb`` and
    ``device{i}/peak_bytes_gb`` (1e9 bytes) of the card ``device`` (the
    current one by default): the caching allocator's allocated bytes now and
    at their peak, and the card's total memory. Empty for a CPU device (as
    the JAX function is where a device has no memory stats)."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    i = device.index if device.index is not None else torch.cuda.current_device()
    stats = torch.cuda.memory_stats(i)
    _, total = torch.cuda.mem_get_info(i)
    return {
        f"device{i}/bytes_in_use_gb": stats.get("allocated_bytes.all.current", 0) / 1e9,
        f"device{i}/bytes_limit_gb": total / 1e9,
        f"device{i}/peak_bytes_gb": stats.get("allocated_bytes.all.peak", 0) / 1e9,
    }


def record_memory_history(max_entries: int = 100_000) -> None:
    """Start recording the caching allocator's events (what
    ``dump_memory_profile`` writes)."""
    torch.cuda.memory._record_memory_history(max_entries=max_entries)


def dump_memory_profile(path: str | Path) -> Path:
    """Write the allocator's snapshot to ``path`` (a pickle for PyTorch's
    memory viewer) and return it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.memory._dump_snapshot(str(path))
    return path


class GarbageCollection:
    """Disable automatic gc; collect every ``interval`` steps."""

    def __init__(self, interval: int = 50, enable: bool = True):
        self.interval = interval
        self.enable = enable
        if enable:
            gc.disable()
            gc.collect()

    def maybe_collect(self, step: int) -> None:
        if self.enable and self.interval and step % self.interval == 0:
            gc.collect()

    def restore(self) -> None:
        if self.enable:
            gc.enable()
